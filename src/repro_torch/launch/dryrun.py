"""Dry run of one rank of a production world (the port's counterpart of
``src/repro/launch/dryrun.py``).

For every (arch × input shape × world), one rank of the world runs the
real step function of the port, once, on the inputs and state that rank
holds (``launch/shapes.py``), under ``FakeTensorMode`` (shapes and
dtypes, no storage) and on the ``fake`` process-group backend (every
collective returns at once, no message is sent).  ``launch/op_cost.py``
counts what the run dispatched: per-rank FLOPs, the bytes the ops write,
the all-reduce bytes, the argument bytes and the peak of the bytes alive.
The reference lowers and compiles each combination against
``ShapeDtypeStruct``s on 512 forced host devices instead and reads XLA's
memory and cost analyses.

Worlds: the reference's 16×16 mesh is (data, model) = (16, 16), 256
ranks; its 2×16×16 puts the pod axis on data: (32, 16), 512 ranks.  The
rank analysed is rank 0 (data rank 0, model rank 0): every rank of a
world holds the same shapes, as the layouts are even (a batch N does not
divide stays whole on every rank).

Routes, the reference's: train is the ISSGD step with the ``logit_grad``
scorer, plain SGD and a score batch equal to the batch, the norms
sequence-parallel (the launcher's default under a model group); decode
is one ``decode_step`` with ``decode_kernel="ref"``; prefill is
``prefill`` with the ref attention.  Fake CPU tensors take the plain
routes, which need no compiled kernel.

What the train combination leaves out: the draw.  The step's draw ends
in a host read of the drawn indices, which a fake tensor cannot give,
so the master trains on injected indices (``sample_indices``, which the
port's step takes); everything else of the step runs: the scoring pass on
the rank's score slice, the proposal read, the one-owner gathers of the
proposal and the minibatch, the master's IS-scaled loss, its backward
(rematerialised: the configs keep ``remat=True``, the reference's
default, and a train shape's ``loss_chunk`` of 512 checkpoints each
chunk of the loss head), the global grad norm, the update and the trace
monitors.  The port's
master computes the whole minibatch on every data rank
(``core/distributed.py``: the update is the same on every rank), where
the reference's dry run lets XLA split it over the data axes.  The stale
params are a copy of their own (the steady state between refreshes).

Under fake tensors the mamba layers' ref scan, a Python loop of one
step a position (S·~12 dispatched ops a layer), runs as the same
recurrence in closed form over chunks of ``SCAN_CHUNK`` positions
(``_scan_by_chunks``): no matmul either way, so the FLOPs are the same;
its temporaries are (B, chunk, d_inner, d_state) where the loop's are (B,
d_inner, d_state), so a mamba prefill's peak is an upper bound.

Output: one JSON a combination under ``--out`` with the reference's keys
where they apply (``params``, ``active_params``, ``flops_per_device``,
``io_bytes_per_device``, ``collective_bytes_per_device``,
``collective_by_op``, ``memory``: ``argument_bytes`` (train: params,
stale params, the store and the data rows; decode: params and caches,
and the rows' token ids and lengths; prefill: params and the prompt),
``peak_bytes`` and ``temp_bytes`` =
peak − argument), ``fits_80gb`` (peak ≤ 80·10⁹ bytes) and ``ok``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k --smoke
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --multi-pod both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.launch.op_cost import analyze, tensor_bytes
from repro_torch.launch.shapes import (SHAPES, InputShape, arch_for_shape,
                                       decode_caches, local_rows,
                                       prefill_inputs, rank_params,
                                       train_data)

WORLDS = {False: (16, 16), True: (32, 16)}
HBM_BYTES = 80 * 10 ** 9
SCAN_CHUNK = 512


def _scan_by_chunks(u, delta, a, b, c, d, return_state=False,
                    scan_dtype=torch.float32):
    """``kernels/ref.selective_scan_ref``'s recurrence in closed form,
    ``SCAN_CHUNK`` positions at a time: within a chunk h_t = e^{L_t}·(h_0
    + Σ_{k≤t} e^{-L_k}·Δ_k u_k B_k), L the running sum of Δ·A.  Only the
    dry run's fake tensors take it (its exponentials overflow on real
    data)."""
    sd = scan_dtype
    bsz, s, di = u.shape
    af = a.to(sd)
    h = torch.zeros(bsz, di, a.shape[-1], dtype=sd, device=u.device)
    ys = []
    for lo in range(0, s, SCAN_CHUNK):
        dl = delta[:, lo:lo + SCAN_CHUNK].to(sd)
        uu = u[:, lo:lo + SCAN_CHUNK].to(sd)
        la = torch.cumsum(dl[..., None] * af[None, None], dim=1)
        x = (dl * uu)[..., None] * b[:, lo:lo + SCAN_CHUNK, None, :].to(sd)
        hs = torch.exp(la) * (h[:, None]
                              + torch.cumsum(torch.exp(-la) * x, dim=1))
        ys.append(torch.sum(hs * c[:, lo:lo + SCAN_CHUNK, None, :].to(sd),
                            dim=-1))
        h = hs[:, -1]
    y = (torch.cat(ys, dim=1) + u.to(sd) * d.float()[None, None]).to(u.dtype)
    return (y, h) if return_state else y


@contextlib.contextmanager
def fake_world(rank: int, n_data: int, m_size: int):
    """This process as ``rank`` of an (n_data, m_size) world on the
    ``fake`` backend: yields (data group, model group or None)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import mesh_groups
    world = n_data * m_size
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        if m_size > 1:
            yield mesh_groups(rank, world, m_size)
        else:
            from repro_torch.dist import data_axes
            yield data_axes(), None
    finally:
        dist.destroy_process_group()


def build_train(cfg, shape: InputShape, group, mg, device="cpu"):
    """(fn, args) of one ISSGD step on this rank (module docstring)."""
    from repro_torch.core.distributed import make_sharded_train_step
    from repro_torch.core.importance import ISConfig
    from repro_torch.core.issgd import ISSGDConfig, TrainState
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.core.weight_store import init_store
    from repro_torch.models.transformer import per_example_loss
    from repro_torch.optim import sgd, tree_map
    n = 2 * shape.global_batch
    params, specs = rank_params(cfg, group, mg, device=device)
    sp = mg is not None
    opt = sgd(1e-2)           # the paper's optimizer: plain SGD, no state
    tcfg = ISSGDConfig(batch_size=shape.global_batch,
                       score_batch_size=shape.global_batch,
                       refresh_every=8, mode="relaxed",
                       is_cfg=ISConfig(smoothing=1.0))
    step, _ = make_sharded_train_step(
        lambda p, b: per_example_loss(p, cfg, b, model_group=mg,
                                      seq_shard=sp)[0],
        make_lm_scorer(cfg, "logit_grad", model_group=mg, seq_shard=sp),
        opt, tcfg, n, group, model_group=mg, param_specs=specs)
    state = TrainState(params, opt.init(params),
                       tree_map(lambda t: t.clone(), params),
                       init_store(local_rows(n, group), device), 0,
                       torch.Generator(device=device).manual_seed(0))
    data = train_data(cfg, shape, n, group, device)
    idx = torch.arange(shape.global_batch, device=device) * 2 % n
    return (lambda st, dt, i: step(st, dt, sample_indices=i)), (state, data,
                                                                 idx)


def build_decode(cfg, shape: InputShape, group, mg, device="cpu"):
    """(fn, args) of one decode step on this rank's rows."""
    from repro_torch.serving.engine import decode_step
    params, _ = rank_params(cfg, group, mg, device=device)
    state = decode_caches(cfg, shape, group, mg, device)
    toks = torch.zeros_like(state.lengths)

    def fn(params, state, toks):
        with torch.no_grad():
            return decode_step(params, cfg, toks, state, decode_kernel="ref",
                               model_group=mg)
    return fn, (params, state, toks)


def build_prefill(cfg, shape: InputShape, group, mg, device="cpu"):
    """(fn, args) of one prefill of this rank's prompts."""
    from repro_torch.serving.engine import prefill
    params, _ = rank_params(cfg, group, mg, device=device)
    toks, emb = prefill_inputs(cfg, shape, group, device)

    def fn(params, toks, emb):
        with torch.no_grad():
            return prefill(params, cfg, toks, shape.seq_len, embeds=emb,
                           model_group=mg)
    return fn, (params, toks, emb)


BUILDERS = {"train": build_train, "decode": build_decode,
            "prefill": build_prefill}


def config_for(arch: str, shape: InputShape, smoke: bool):
    """(config, shape) of a combination; ``smoke`` is the reduced model on
    the same wiring, the sequence cut to at most 512."""
    if smoke:
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 512))
        return arch_for_shape(configs.get_smoke_config(arch), shape), shape
    return arch_for_shape(configs.get_config(arch), shape), shape


def fake_run(cfg, shape: InputShape, group, mg):
    """(fn, its fake args, Cost): one fake run of the combination's step
    on this rank, the mamba scan in closed form (module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ref
    real_scan = ref.selective_scan_ref
    ref.selective_scan_ref = _scan_by_chunks
    try:
        with FakeTensorMode():
            fn, args = BUILDERS[shape.kind](cfg, shape, group, mg)
            return fn, args, analyze(fn, *args)
    finally:
        ref.selective_scan_ref = real_scan


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: Path | None = None, smoke: bool = False) -> dict:
    """Dry-run one combination on rank 0 of its world; the result (and,
    with ``out_dir``, its JSON file)."""
    cfg, shape = config_for(arch, SHAPES[shape_name], smoke)
    n, m = WORLDS[multi_pod]
    t0 = time.time()
    with fake_world(0, n, m) as (group, mg):
        _, _, cost = fake_run(cfg, shape, group, mg)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": n * m, "layout": {"data": n, "model": m}, "rank": 0,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind, "smoke": smoke,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "num_periods": cfg.num_periods,
        "flops_per_device": cost.flops,
        "io_bytes_per_device": cost.io_bytes,
        "collective_bytes_per_device": cost.collective_bytes,
        "collective_by_op": cost.collective_by_op,
        "memory": {"argument_bytes": cost.argument_bytes,
                   "peak_bytes": cost.peak_bytes,
                   "temp_bytes": cost.peak_bytes - cost.argument_bytes},
        "fits_80gb": cost.peak_bytes <= HBM_BYTES,
        "analyze_s": round(time.time() - t0, 1),
        "ok": True,
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
        (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=2))
    return result


def run_real(arch: str, shape: InputShape, multi_pod: bool,
             device="cuda", smoke: bool = False) -> dict:
    """The same rank's step run for real on ``device`` (the fake backend
    still: collectives do nothing, so only the bytes mean anything): the
    fake run's argument and peak bytes beside the real tensors' bytes and
    the allocator's peak."""
    from torch.utils._pytree import tree_map
    cfg, shape = config_for(arch, shape, smoke)
    n, m = WORLDS[multi_pod]
    with fake_world(0, n, m) as (group, mg):
        fn, fake_args, predicted = fake_run(cfg, shape, group, mg)

        def real(t):
            if not isinstance(t, torch.Tensor):
                return t
            out = torch.empty(t.shape, dtype=t.dtype, device=device)
            if out.is_floating_point():
                return out.normal_(0.0, 0.02)
            return out.zero_()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        args = tree_map(real, fake_args)
        held = torch.cuda.memory_allocated(device) - base
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) - base
        del out, args
        torch.cuda.empty_cache()
    return {"arch": arch, "shape": shape.name, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch, "kind": shape.kind,
            "layout": {"data": n, "model": m},
            "predicted": {"argument_bytes": predicted.argument_bytes,
                          "peak_bytes": predicted.peak_bytes,
                          "flops": predicted.flops},
            "real_argument_bytes": tensor_bytes(fake_args),
            "allocated_argument_bytes": held,
            "max_memory_allocated": peak, "step_s": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="no", choices=["no", "yes", "both"])
    ap.add_argument("--out", default="build/dryrun_torch")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs, same wiring (pipeline check)")
    args = ap.parse_args(argv)
    archs = list(configs.ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"no": [False], "yes": [True], "both": [False, True]}[
        args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
                try:
                    r = run_one(arch, shape, mp, Path(args.out),
                                smoke=args.smoke)
                    mem = r["memory"]
                    print(f"[ok] {tag}: flops/dev={r['flops_per_device']:.3e}"
                          f" coll={r['collective_bytes_per_device']:.3e}B "
                          f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
                          f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
                          f"fits_80gb={r['fits_80gb']} "
                          f"({r['analyze_s']}s)", flush=True)
                except Exception as e:  # noqa: BLE001 — reported, counted
                    failures.append(tag)
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"{len(failures)} FAILURES: {failures}")
        return 1
    print("all dry runs ran")
    return 0


if __name__ == "__main__":
    sys.exit(main())
