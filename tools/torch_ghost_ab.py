#!/usr/bin/env python
"""Time the ghost-norm kernel of two checkouts in turns on one CUDA card.

Usage:  python3 tools/torch_ghost_ab.py OTHER_ROOT [--rounds 5]

OTHER_ROOT is a checkout of another commit (for example the parent,
``git archive`` unpacked under the git-ignored ``build/``).  Four fresh
processes each build and time one side's ``repro_torch.kernels.ghost_norm``
in turn: OTHER_ROOT, this checkout, this checkout, OTHER_ROOT.  Each times
every distinct call of ``chip_smoke.GHOST_STEPS`` (the seq-64 LM step, the
S = 512 flash-trainer step, the falcon-mamba ghost step) on bf16 x and f32
d, ``symmetric=True`` as the scorer calls it, with inputs past the L2 cache
and CUDA events around a loop of calls (``chip_smoke.time_events``).  It
prints, per call and per step, the faster of each side's two runs beside
``chip_smoke.ghost_bounds`` and the card line; the last line is one JSON
object.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shapes(smoke) -> list[tuple]:
    out = []
    for calls in smoke.GHOST_STEPS.values():
        for _, rows, s, din, dout in calls:
            if (rows, s, din, dout) not in out:
                out.append((rows, s, din, dout))
    return out


def worker(root: str, rounds: int) -> None:
    """Time ``root``'s ghost_norm at every shape; print one JSON line."""
    sys.path.insert(0, REPO)
    import chip_smoke as smoke           # puts this checkout's src on the path
    import torch
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    gn = importlib.import_module("repro_torch.kernels.ghost_norm")
    if not os.path.abspath(gn.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {gn.__file__}, not from {root}")
    gn._lib()                            # build before timing
    ms = {}
    for rows, s, din, dout in shapes(smoke):
        x, d = smoke.gram_inputs(rows, s, din, dout, torch.bfloat16,
                                 torch.float32, seed=800)
        ms[str([rows, s, din, dout])] = smoke.time_events(
            lambda a, b: gn.ghost_norm(a, b, symmetric=True), [(x, d)],
            rounds)
        del x, d
        torch.cuda.empty_cache()
    print(json.dumps(ms), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.other, args.rounds)
        return 0
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    import torch
    if not torch.cuda.is_available():
        print("torch_ghost_ab: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    sides = {"other": args.other, "this": REPO}
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), sides[side],
             "--rounds", str(args.rounds), "--worker"],
            capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"torch_ghost_ab: the {side} side failed")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    per_shape = {}
    for key in runs["this"][0]:
        rows, s, din, dout = json.loads(key)
        b_ms, o_ms = smoke.ghost_bounds(rows, s, din, dout)
        per_shape[key] = {
            "this_ms": min(r[key] for r in runs["this"]),
            "other_ms": min(r[key] for r in runs["other"]),
            "this_ms_runs": [r[key] for r in runs["this"]],
            "other_ms_runs": [r[key] for r in runs["other"]],
            "bound_ms": max(b_ms, o_ms)}
        row = per_shape[key]
        print(f"ghost A/B {key}: this {row['this_ms'] * 1e3:.1f} us, other "
              f"{row['other_ms'] * 1e3:.1f} us, bound "
              f"{row['bound_ms'] * 1e3:.1f} us", flush=True)
    steps = {}
    for step, calls in smoke.GHOST_STEPS.items():
        keys = [str([rows, s, din, dout]) for _, rows, s, din, dout in calls]
        steps[step] = {k: sum(per_shape[key][k] for key in keys)
                       for k in ("this_ms", "other_ms", "bound_ms")}
        steps[step]["calls"] = len(calls)
        print(f"ghost A/B per {step} step ({len(calls)} calls): this "
              f"{steps[step]['this_ms']:.3f} ms, other "
              f"{steps[step]['other_ms']:.3f} ms, bound "
              f"{steps[step]['bound_ms']:.3f} ms", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "other": args.other,
                      "order": "other, this, this, other",
                      "per_call": per_shape, "per_step": steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
