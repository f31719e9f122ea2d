#!/usr/bin/env python
"""Time the score sweep and the sq-norm kernels of two checkouts in turns
on one CUDA card.

Usage:  python3 tools/torch_sweep_sqnorm_ab.py OTHER_ROOT [--rounds 20]

OTHER_ROOT is a checkout of another commit (for example the parent,
``git archive HEAD~`` unpacked under the git-ignored ``build/``).  Fresh
processes each build and time one side's
``repro_torch.kernels.per_example_sqnorm`` and
``repro_torch.kernels.flash_attention_bwd`` in turn: OTHER_ROOT, this
checkout, this checkout again, OTHER_ROOT again; each side builds its own
libraries under its own ``build/``.  Each side times, with input sets
rotated past the L2 cache (``chip_smoke.time_cold``: device time from the
profiler, split by kernel name, and wall time from CUDA events):
``per_example_sqnorm_multi`` at ``chip_smoke.py`` phase 5's shape (B = 256,
the five mlp_svhn taps, f32), the single-tap ``per_example_sqnorm`` at
(256, 3072 | 2048) and at the replicated ``fc4`` tap of a
``--model-parallel 4`` MLP step (256, 2048 | 10), and ``attn_score_sweep``
at phase 18's
(dq (16, 512, 32, 128), dk and dv (16, 512, 2, 128), bf16).  Each holds
its results to the plain versions (rtol 1e-5) and two launches to each
other (bitwise).  It prints, per kernel, the faster of each side's two
runs beside the bound and the card line; the last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_SHAPE = (16, 512, 32, 2, 128)      # B, S, H, Hkv, hd: phase 18
RTOL = 1e-5
# the single-tap kernel's shapes: its old timing shape, and the replicated
# fc4 tap of an mlp_svhn step at --model-parallel 4 (its main-path launch)
SINGLE_SHAPES = {"single": (3072, 2048), "single_fc4": (2048, 10)}


def worker(root: str, rounds: int) -> None:
    """Time ``root``'s two kernels; print one JSON line."""
    sys.path.insert(0, REPO)
    import chip_smoke as smoke           # puts this checkout's src on the path
    import torch
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    pes = importlib.import_module("repro_torch.kernels.per_example_sqnorm")
    fab = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
    ref = importlib.import_module("repro_torch.kernels.ref")
    for mod in (pes, fab, ref):
        if not os.path.abspath(mod.__file__).startswith(os.path.abspath(root)):
            raise SystemExit(f"imported {mod.__file__}, not from {root}")
    pes._lib()                           # build before timing
    fab._lib()
    out = {}
    f32 = ((torch.float32, torch.float32),) * len(smoke.MAIN_TAPS)
    per_set = 4 * smoke.MAIN_B * sum(a + b for a, b in smoke.MAIN_TAPS)
    inputs = [smoke.make_taps(smoke.MAIN_B, smoke.MAIN_TAPS, f32, seed=500 + i)
              for i in range(max(2, math.ceil(4 * smoke.L2_BYTES / per_set)))]
    kern = lambda xs, ds: pes.per_example_sqnorm_multi(xs, ds)
    out["sqnorm"], out["sqnorm_wall"], out["sqnorm_split"] = smoke.time_cold(
        kern, inputs, rounds, split=True)
    got, again = kern(*inputs[0]), kern(*inputs[0])
    want = ref.per_example_sqnorm_multi_ref(*inputs[0])
    out["sqnorm_ok"] = bool(torch.equal(got, again) and torch.allclose(
        got, want, rtol=RTOL, atol=0.0))
    del inputs
    for name, widths in SINGLE_SHAPES.items():
        per_set = 4 * smoke.MAIN_B * sum(widths)
        inputs = [smoke.make_taps(smoke.MAIN_B, (widths,), f32[:1],
                                  seed=700 + i)
                  for i in range(max(2, math.ceil(4 * smoke.L2_BYTES
                                                  / per_set)))]
        kern = lambda xs, ds: pes.per_example_sqnorm(xs[0], ds[0])
        out[name], out[f"{name}_wall"], out[f"{name}_split"] = \
            smoke.time_cold(kern, inputs, rounds, split=True)
        got, again = kern(*inputs[0]), kern(*inputs[0])
        want = ref.per_example_sqnorm_ref(inputs[0][0][0], inputs[0][1][0])
        emu = ref.per_example_sqnorm_blocked(inputs[0][0][0],
                                             inputs[0][1][0])
        out[f"{name}_ok"] = bool(
            torch.equal(got, again) and torch.equal(got, emu)
            and torch.allclose(got, want, rtol=RTOL, atol=0.0))
        del inputs
    b, s, h, hkv, hd = SWEEP_SHAPE
    g = torch.Generator(device="cuda").manual_seed(1200)
    sets = [tuple((torch.randn(sh, generator=g, device="cuda") * 1e-2)
                  .to(torch.bfloat16)
                  for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
            for _ in range(2)]                 # 2 × 75.5 MB: L2 cold
    out["sweep"], out["sweep_wall"], out["sweep_split"] = smoke.time_cold(
        fab.attn_score_sweep, sets, rounds, split=True)
    got, again = fab.attn_score_sweep(*sets[0]), fab.attn_score_sweep(*sets[0])
    want = ref.attn_grad_sqnorm_ref(*sets[0])
    out["sweep_ok"] = bool(torch.equal(got, again) and torch.allclose(
        got, want, rtol=RTOL, atol=0.0))
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.other, args.rounds)
        return 0
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    import torch
    if not torch.cuda.is_available():
        print("torch_sweep_sqnorm_ab: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    sides = {"other": args.other, "this": REPO}
    order = list(sides) + list(reversed(sides))
    runs = {side: [] for side in sides}
    for side in order:
        cmd = [sys.executable, os.path.abspath(__file__), sides[side],
               "--rounds", str(args.rounds), "--worker"]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"torch_sweep_sqnorm_ab: the {side} side failed")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    bounds = {"sqnorm": smoke.bound_ms(smoke.MAIN_B, smoke.MAIN_TAPS),
              "sweep": smoke.sweep_bound(*SWEEP_SHAPE, 2),
              **{name: smoke.bound_ms(smoke.MAIN_B, (widths,))
                 for name, widths in SINGLE_SHAPES.items()}}
    bounds["sweep"] = (bounds["sweep"]["bound_ms"], bounds["sweep"]["bound_by"])
    per_kernel = {}
    for name in ("sqnorm", *SINGLE_SHAPES, "sweep"):
        row = {"bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
        for side in sides:
            rs = runs[side]
            best = min(range(len(rs)), key=lambda i: rs[i][name])
            row[f"{side} ms"] = rs[best][name]
            row[f"{side} ms_runs"] = [r[name] for r in rs]
            row[f"{side} wall_ms_runs"] = [r[f"{name}_wall"] for r in rs]
            row[f"{side} split_ms"] = rs[best][f"{name}_split"]
            row[f"{side} ok"] = all(r[f"{name}_ok"] for r in rs)
        per_kernel[name] = row
        us = lambda v: f"{v * 1e3:.2f}"
        print(f"A/B {name}: " + "; ".join(
            f"{side} device {'/'.join(us(v) for v in row[f'{side} ms_runs'])}"
            f" us (wall {'/'.join(us(v) for v in row[f'{side} wall_ms_runs'])}"
            f"), split " + ", ".join(
                f"{k[:48]} {us(v)}" for k, v in row[f"{side} split_ms"].items())
            + f", checks {'ok' if row[f'{side} ok'] else 'FAILED'}"
            for side in sides)
            + f"; bound {us(row['bound_ms'])} us by {row['bound_by']}",
            flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "other": args.other,
                      "order": ", ".join(order),
                      "sweep_shape": list(SWEEP_SHAPE),
                      "per_kernel": per_kernel}), flush=True)
    return 0 if all(per_kernel[n][f"{s} ok"] for n in per_kernel
                    for s in sides) else 1


if __name__ == "__main__":
    sys.exit(main())
