"""One rank of a gloo world for ``tests/test_torch_batch_split.py``.

Run as a script, one process a rank:

    python tests/_torch_batch_split_rank.py RANK N M PORT PLAN OUT_DIR

It joins a world of N·M ranks through ``launch/mesh.py`` (with M > 1
its data group and its model group) and trains the plan's cases through
``launch/train.py``'s ``run``, with the sharded step factories wrapped
so that the master is split over the data group (``split_batch=True``)
and every master step's draws, loss and grad norm are kept.  A world of
one rank runs each case split and unsplit; a larger one split, the
synchronous case twice.  Worlds of more than one data rank also route
the plan's MoE router logits and run the plan's MoE layer on their
block of its batch (``models/moe.py``, ``route_split``).  What a rank
saw goes to ``OUT_DIR/rank<RANK>.pt``.  It imports only the port.
"""
import functools
import sys

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import collectives
from repro_torch.dist import BatchSplit, batch_block
from repro_torch.launch import mesh
from repro_torch.launch import train as train_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import params_from_jax

MLP_ARGV = ["--smoke", "--device", "cpu", "--examples", "384", "--batch",
            "8", "--score-batch", "48", "--score-shards", "6",
            "--refresh-every", "4", "--steps", "4", "--log-every", "1"]
LM_ARGV = ["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--examples",
           "64", "--seq", "16", "--batch", "8", "--score-batch", "16",
           "--score-shards", "2", "--steps", "1", "--log-every", "1"]
MLP_CASES = {"sync": [], "async": ["--async-scoring", "--swap-every", "2"],
             "stream": ["--stream", "--chunk-size", "64"],
             "fused": ["--mode", "fused", "--probe-every", "2"]}
FACTORIES = {"make_sharded_train_step": 0, "make_sharded_async_steps": 1,
             "make_sharded_streamed_steps": 2}
# where each factory's master step sits in its result, and where the
# master step's metrics sit in the step's result
METRICS_AT = {"make_sharded_train_step": 1, "make_sharded_async_steps": 5,
              "make_sharded_streamed_steps": 6}


class SplitRecorder:
    """While active, the launcher's sharded step factories build the
    split master (``split`` True) or the unsplit one, and every master
    step's metrics are kept in ``mets``."""

    def __init__(self, split: bool):
        self.split, self.mets = split, []

    def __enter__(self):
        self.saved = {k: getattr(train_mod, k) for k in FACTORIES}
        for k, orig in self.saved.items():
            setattr(train_mod, k, self._wrap(k, orig))
        return self

    def __exit__(self, *exc):
        for k, orig in self.saved.items():
            setattr(train_mod, k, orig)

    def _wrap(self, name, orig):
        def make(*a, **kw):
            out = list(orig(*a, split_batch=self.split, **kw))
            at = FACTORIES[name]
            out[at] = self._record(out[at], METRICS_AT[name])
            return tuple(out)
        return make

    def _record(self, step, at):
        @functools.wraps(step)
        def rec(*a, **kw):
            res = step(*a, **kw)
            self.mets.append(res[at])
            return res
        return rec


def train_case(argv, group, mg, split: bool) -> dict:
    """The run's draws, losses and grad norms a step, its data-axis
    all-reduces, and its final params (this rank's shards under a model
    group) and their specs."""
    args = train_mod.parse_args(argv)
    collectives.reset_counts()
    with SplitRecorder(split) as rec:
        result = train_mod.run(args, group=group, model_group=mg)
    return {"all_reduce": collectives.COUNTS["all_reduce"],
            "idx": torch.stack([m.sample_indices for m in rec.mets]),
            "loss": torch.stack([m.loss for m in rec.mets]),
            "grad_norm": torch.stack([m.grad_norm for m in rec.mets]),
            "params": result.state.params,
            "specs": result.built.param_specs}


def moe_cases(plan, group) -> dict:
    """The plan's router logits routed as this rank's block of the
    batch, and the plan's MoE layer on this rank's block of its input."""
    cfg = get_smoke_config("dbrx-132b")
    r = plan["route"]
    rows, seq = r["rows"], r["seq"]
    lo, hi = batch_block(rows, group)
    split = BatchSplit(group, rows)
    routing = moe_mod.route_split(r["logits"][lo * seq:hi * seq], cfg,
                                  split, seq)
    m = plan["moe"]
    lo, hi = batch_block(m["x"].shape[0], group)
    out = moe_mod.moe(params_from_jax(m["params"]), m["x"][lo:hi], cfg,
                      batch_split=BatchSplit(group, m["x"].shape[0]))
    return {"route": routing._asdict(), "y": out.y,
            "dropped_frac": out.dropped_frac}


def main(rank: int, n_data: int, m_size: int, port: int, plan_path: str,
         out_dir: str):
    torch.set_num_threads(1)
    plan = torch.load(plan_path, weights_only=False)
    mesh_argv = ["--mesh", str(n_data)]
    out = {}
    if m_size > 1:
        group, mg = mesh.init_rank(rank, n_data * m_size, port, "gloo",
                                   "cpu", model_parallel=m_size)
        out["lm"] = train_case(LM_ARGV + mesh_argv + [
            "--model-parallel", str(m_size)], group, mg, True)
    else:
        group, mg = mesh.init_rank(rank, n_data, port, "gloo", "cpu"), None
        for case, extra in MLP_CASES.items():
            argv = MLP_ARGV + extra + mesh_argv
            out[case] = train_case(argv, group, None, True)
            if n_data == 1:
                out[f"{case}/unsplit"] = train_case(argv, group, None,
                                                    False)
        out["sync/again"] = train_case(MLP_ARGV + mesh_argv, group, None,
                                       True)
        if n_data == 1:
            out["lm"] = train_case(LM_ARGV + mesh_argv, group, None, False)
        else:
            out["moe"] = moe_cases(plan, group)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         int(sys.argv[4]), sys.argv[5], sys.argv[6])
