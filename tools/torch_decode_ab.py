#!/usr/bin/env python
"""Time the flash-decode kernel of two checkouts in turns on one CUDA card.

Usage:  python3 tools/torch_decode_ab.py OTHER_ROOT [--rounds 20]

OTHER_ROOT is a checkout of another commit (for example the parent,
``git archive`` unpacked under the git-ignored ``build/``).  Fresh
processes each build and time one side's
``repro_torch.kernels.decode_attention`` in turn: OTHER_ROOT, this
checkout, this checkout again, OTHER_ROOT again.  Each side times one
decode call at glm4-9b's serving shape (B = 8, 2,112 slots, 32/2 heads,
hd 128, bf16, every slot live: the last step of ``chip_smoke.py`` phase
11) and at a 32k cache, with input sets rotated past the L2 cache: device
time from the profiler and wall time from CUDA events around the eager
loop of calls (``chip_smoke.time_cold``), and holds its
output at the serving shape to the plain version
(``chip_smoke.attn_close``, phase 14's tolerance), reporting the largest
difference.  It prints, per shape, the faster of each side's two runs
beside ``chip_smoke.decode_bound`` and the card line; the last line is
one JSON object.
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
# B, S (all live), H, Hkv, hd
SHAPES = {"serve": (8, 2112, 32, 2, 128), "32k": (8, 32768, 32, 2, 128)}


def worker(root: str, rounds: int) -> None:
    """Time ``root``'s decode kernel at every shape; print one JSON line."""
    sys.path.insert(0, REPO)
    import chip_smoke as smoke           # puts this checkout's src on the path
    import torch
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    ref = importlib.import_module("repro_torch.kernels.ref")
    if not os.path.abspath(da.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {da.__file__}, not from {root}")
    da._lib()                            # build before timing
    out = {}
    for name, (b, s, h, hkv, hd) in SHAPES.items():
        sets = max(1, math.ceil(smoke.L2_BYTES / (b * s * hkv * hd * 2)))
        inputs = []
        for i in range(sets):
            q, k, v = smoke.attn_inputs([(b, h, hd), (b, s, hkv, hd),
                                         (b, s, hkv, hd)], torch.bfloat16,
                                        seed=1010 + i)
            inputs.append((q, k, v, torch.full((b,), s, dtype=torch.int32,
                                                device="cuda")))
        out[name], out[f"{name}_wall"] = smoke.time_cold(
            da.decode_attention, inputs, rounds)
        if name == "serve":
            got = da.decode_attention(*inputs[0])
            ok, err = smoke.attn_close(
                got, ref.decode_attention_kernel_ref(*inputs[0]),
                torch.bfloat16)
            out["serve_within_tolerance"] = ok
            out["serve_max_abs_err"] = err
        del inputs
        torch.cuda.empty_cache()
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
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
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
            raise SystemExit(f"torch_decode_ab: the {side} side failed")
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    per_shape = {}
    for name, (b, s, h, hkv, hd) in SHAPES.items():
        bound = smoke.decode_bound([s] * b, h, hkv, hd, 2)
        row = {"shape": [b, s, h, hkv, hd], "bound_ms": bound["bound_ms"],
               "bound_by": bound["bound_by"]}
        for side in sides:
            row[f"{side} ms"] = min(r[name] for r in runs[side])
            row[f"{side} ms_runs"] = [r[name] for r in runs[side]]
            row[f"{side} wall_ms_runs"] = [r[f"{name}_wall"]
                                           for r in runs[side]]
        per_shape[name] = row
        print(f"decode A/B {name} (B, S, H, Hkv, hd)={(b, s, h, hkv, hd)} "
              f"bf16, device: " + ", ".join(
                  f"{side} {row[f'{side} ms'] * 1e3:.2f} us (wall "
                  + "/".join(f"{w * 1e3:.2f}"
                             for w in row[f"{side} wall_ms_runs"]) + ")"
                  for side in sides)
              + f"; bound {row['bound_ms'] * 1e3:.2f} us by "
              f"{row['bound_by']}", flush=True)
    info = {side: {
        "serve_within_tolerance": all(r["serve_within_tolerance"]
                                      for r in runs[side]),
        "serve_max_abs_err": max(r["serve_max_abs_err"]
                                 for r in runs[side])}
        for side in sides}
    print(card, flush=True)
    print(json.dumps({"card": card, "other": args.other,
                      "order": ", ".join(order), "sides": info,
                      "per_shape": per_shape}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
