#!/usr/bin/env python
"""Time the selective-scan kernel of two checkouts in turns on one CUDA card.

Usage:  python3 tools/torch_scan_ab.py OTHER_ROOT [--rounds 5] [--pass]

OTHER_ROOT is a checkout of another commit (for example the parent,
``git archive`` unpacked under the git-ignored ``build/``).  Fresh
processes each build and time one side's
``repro_torch.kernels.selective_scan`` in turn: OTHER_ROOT, this checkout,
this checkout again, OTHER_ROOT again.  Each side times the scan at both main-path shapes,
falcon-mamba-7b's full-depth scoring pass (8, 2048, 8192, 16) and its
trainer's scoring pass (16, 256, 8192, 16), in bf16 with falcon-init Δ
(``chip_smoke.scan_inputs``), with input sets rotated past the L2 cache
and CUDA events around a loop of calls (``chip_smoke.time_events``), and
holds its output at the trainer shape to the plain version
(``chip_smoke.scan_check``, phase 19's tolerance), reporting the largest
difference.  With ``--pass`` each side also runs falcon-mamba-7b's
full-depth scoring pass (``chip_smoke.phase_mamba_full_depth``: 64 scans
over 8 × 2048 tokens, two passes timed with CUDA events).  It prints, per
shape, the faster of each side's two runs beside ``chip_smoke.scan_bound``
and the card line; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, S, d_inner, d_state) and the input sets rotated: u, Δ and y of one
# set are 268 MB each at the first shape, 67 MB at the second
SHAPES = {"full-depth pass": ((8, 2048, 8192, 16), 1),
          "trainer": ((16, 256, 8192, 16), 2)}


def worker(root: str, rounds: int, full_pass: bool) -> None:
    """Time ``root``'s scan at every shape, and with ``full_pass`` the
    full-depth scoring pass; print one JSON line."""
    sys.path.insert(0, REPO)
    import chip_smoke as smoke           # puts this checkout's src on the path
    import torch
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    ss = importlib.import_module("repro_torch.kernels.selective_scan")
    ref = importlib.import_module("repro_torch.kernels.ref")
    if not os.path.abspath(ss.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {ss.__file__}, not from {root}")
    ss._lib()                            # build before timing
    out = {}
    bf16 = torch.bfloat16
    for name, ((b, s, di, ds), sets) in SHAPES.items():
        inputs = [smoke.scan_inputs(b, s, di, ds, bf16, seed=2200 + i,
                                    falcon=True) for i in range(sets)]
        with torch.no_grad():
            out[name] = smoke.time_events(ss.selective_scan, inputs, rounds)
            if name == "trainer":
                y = ss.selective_scan(*inputs[0])
                plain = ref.selective_scan_kernel_ref(
                    *[t.float() for t in inputs[0]])
                ok, err = smoke.scan_check(y, plain, bf16)
                out["trainer_within_tolerance"] = ok
                out["trainer_max_abs_err"] = err
        del inputs
        torch.cuda.empty_cache()
    if full_pass:
        train_mod = importlib.import_module("repro_torch.launch.train")
        train_mod.use_full_f32()
        out["pass_ms"] = smoke.phase_mamba_full_depth(train_mod,
                                                      ref)["pass_ms"]
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--pass", dest="full_pass", action="store_true",
                    help="also time the full-depth scoring pass")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.other, args.rounds, args.full_pass)
        return 0
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    import torch
    if not torch.cuda.is_available():
        print("torch_scan_ab: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    sides = {"other": args.other, "this": REPO}
    order = list(sides) + list(reversed(sides))
    runs = {side: [] for side in sides}
    for side in order:
        cmd = [sys.executable, os.path.abspath(__file__), sides[side],
               "--rounds", str(args.rounds), "--worker"]
        if args.full_pass:
            cmd.append("--pass")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"torch_scan_ab: the {side} side failed")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    per_shape = {}
    for name, ((b, s, di, ds), sets) in SHAPES.items():
        bound = smoke.scan_bound(b, s, di, ds, 2)
        row = {"shape": [b, s, di, ds], "input_sets": sets,
               "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
        for side in sides:
            row[f"{side} ms"] = min(r[name] for r in runs[side])
            row[f"{side} ms_runs"] = [r[name] for r in runs[side]]
        per_shape[name] = row
        print(f"scan A/B {name} {(b, s, di, ds)} bf16: " + ", ".join(
            f"{side} {row[f'{side} ms']:.4f} ms" for side in sides)
            + f"; bound {row['bound_ms']:.4f} ms by {row['bound_by']}",
            flush=True)
    info = {side: {
        "trainer_within_tolerance": all(r["trainer_within_tolerance"]
                                        for r in runs[side]),
        "trainer_max_abs_err": max(r["trainer_max_abs_err"]
                                   for r in runs[side])}
        for side in sides}
    if args.full_pass:
        for side in sides:
            info[side]["pass_ms"] = [m for r in runs[side]
                                     for m in r["pass_ms"]]
            print(f"scan A/B full-depth pass, 64 layers, 8 × 2048 tokens: "
                  f"{side} " + ", ".join(
                      f"{m:.1f}" for m in info[side]["pass_ms"]) + " ms",
                  flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "other": args.other,
                      "order": ", ".join(order), "sides": info,
                      "per_shape": per_shape}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
