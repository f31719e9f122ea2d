"""One rank of a (data, model) gloo world for
``tests/test_torch_mesh_serving.py``.

Run as a script, one process a rank:

    python tests/_torch_mesh_serving_rank.py RANK N M PORT PLAN OUT_DIR

It joins a world of N·M ranks through ``launch/mesh.py`` (its data group
and its model group) and, for every arch of the plan that M splits,
serves the plan's requests through the model-group batcher on its shards
(the launcher's routes: the decode kernel's and flash attention's plain
versions on the CPU) and runs the teacher-forced prefill and decode steps
(the oracles' routes).  It runs ``sharded_decode_attention`` over the
whole world and over a group of one, and in the world of the plan's
``loop_world`` the launcher's ``--mesh 2 --model-parallel 2 --stream
--serve-loop`` run, reading the reference's mesh-loop invariants off its
own rows.  What it saw goes to ``OUT_DIR/rank<RANK>.pt``.  It imports
only the port.
"""
import os
import sys

import torch

from repro_torch.core.importance import ISConfig
from repro_torch.core.weight_store import EMPTY, read_proposal
from repro_torch.dist.sharding import mesh_shape, param_pspecs, shard_tree
from repro_torch.launch import mesh
from repro_torch.models.transformer import transformer_specs
from repro_torch.serving import (ContinuousBatcher, Request,
                                 decode_cache_specs, make_mesh_serving,
                                 sharded_decode_attention)


def admits(cfg, mg) -> bool:
    """Whether the model group splits every present layer type's caches."""
    try:
        decode_cache_specs(cfg, mg)
    except ValueError:
        return False
    return True


def serve_case(spec, group, mg, max_len: int) -> dict:
    """The batcher's tokens for the plan's requests and the teacher-forced
    logits, on this rank's shards."""
    cfg, params = spec["cfg"], spec["params"]
    pspecs = param_pspecs(transformer_specs(cfg), params,
                          mesh_shape(group.size, mg.size))
    shards = shard_tree(params, pspecs, mg.rank, mg.size)
    batcher = ContinuousBatcher(shards, cfg, num_slots=2, max_len=max_len,
                                decode_kernel="pallas", attn_impl="pallas",
                                model_group=mg)
    finished = batcher.run([Request(uid=i, prompt=p, max_new_tokens=spec[
        "new_tokens"]) for i, p in enumerate(spec["prompts"])])
    pre, dec = make_mesh_serving(cfg, max_len, mg)
    prompts = torch.stack(spec["prompts"])
    with torch.no_grad():
        logits, st = pre(shards, prompts, prompts.shape[1])
        out = [logits.clone()]
        for tok in spec["teacher"]:
            logits, st = dec(shards, tok, st, None)
            out.append(logits.clone())
    return {"tokens": {u: list(t) for u, t in finished.items()},
            "logits": torch.stack(out),
            "cache_shapes": {k: tuple(v.shape)
                             for k, v in st.caches.items()}}


def attention_cases(plan, groups) -> dict:
    """``sharded_decode_attention`` over each group of ``groups`` on every
    case of the plan: this rank's slots of the whole cache."""
    out = {}
    for gname, g in groups.items():
        for cname, case in plan["attention"].items():
            k, v = case["k"], case["v"]
            w_loc = k.shape[1] // g.size
            sl = slice(g.rank * w_loc, (g.rank + 1) * w_loc)
            out[(gname, cname)] = sharded_decode_attention(
                case["q"], k[:, sl].contiguous(), v[:, sl].contiguous(),
                case["lengths"], g)
    return out


def loop_case(plan, group, mg) -> dict:
    """The launcher's mesh serve loop on this rank: the reference's
    ``_MESH_LOOP`` invariants read off the rows this rank holds."""
    from repro_torch.launch import train
    args = train.parse_args(plan["loop_argv"])
    result = train.run(args, group=group, model_group=mg)
    built = result.built
    store, chunks = result.state.store, built.pipe.plane.store
    n_live = args.examples
    n = chunks.num_examples
    first = chunks.held_chunks.start * chunks.chunk_size
    q = read_proposal(store, result.state.step,
                      ISConfig(smoothing=args.smoothing))
    rows = {}
    for g in (n_live, n - 1):
        if first <= g < first + store.scored_at.shape[0]:
            rows[g] = (int(store.scored_at[g - first]),
                       float(q[g - first]),
                       chunks.fetch_rows([g])["tokens"][0].clone())
    try:
        chunks.append_chunk()
        grew = None
    except ValueError as e:
        grew = str(e)
    return {"ingested": built.serve.ingest.ingested, "n_live": n_live,
            "n": n, "rows": rows, "growth_refused": grew,
            "empty": EMPTY, "finished": built.serve.batcher.finished}


def main(rank: int, n_data: int, m_size: int, port: int, plan_path: str,
         out_dir: str):
    torch.set_num_threads(1)
    plan = torch.load(plan_path, weights_only=False)
    world = n_data * m_size
    group, mg = mesh.init_rank(rank, world, port, "gloo", "cpu",
                               model_parallel=m_size)
    import torch.distributed as dist
    from repro_torch.dist import DataGroup
    ones = [dist.new_group([r]) for r in range(world)]
    groups = {"world": DataGroup(None, rank, world),
              "one": DataGroup(ones[rank], 0, 1)}
    out = {"attention": attention_cases(plan, groups), "serve": {}}
    for name, spec in plan["models"].items():
        if admits(spec["cfg"], mg):
            out["serve"][name] = serve_case(spec, group, mg,
                                            plan["max_len"])
    if (n_data, m_size) == plan["loop_world"]:
        sys.stdout = open(os.devnull, "w")
        out["loop"] = loop_case(plan, group, mg)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
         int(sys.argv[4]), sys.argv[5], sys.argv[6])
