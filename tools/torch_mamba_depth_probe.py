#!/usr/bin/env python
"""Peak memory and step time of the PyTorch port's falcon-mamba-7b trainer
as its depth grows, on one CUDA card.

Runs ``repro_torch.launch.train.run`` at falcon-mamba-7b's published
widths with the trainer settings of ``chip_smoke.py``'s phases 20a/b
(relaxed, seq 256, batch 8, score batch 16), once for each depth and leg:
the logit_grad scorer on the scan kernel (``ssm_mode="pallas"``) and the
ghost scorer on the ref scan.  For each it reports the device memory peak
and the median step time (CUDA events, the first step left out); a depth
that does not fit reports ``"oom"``.  From two depths that fit it derives
the peak a layer adds and the deepest model under ``--budget-gib``.

Usage:  python3 tools/torch_mamba_depth_probe.py [--layers 4,8,12]
        [--steps 3] [--budget-gib 70]
Prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402

ARGV = ["--arch", "falcon-mamba-7b", "--mode", "relaxed", "--seq", "256",
        "--batch", "8", "--score-batch", "16", "--examples", "2048",
        "--lr", "0.01", "--refresh-every", "8", "--device", "cuda"]
LEGS = (("logit_grad", "pallas"), ("ghost", "ref"))


def measure(layers: int, strategy: str, ssm_mode: str, steps: int) -> dict:
    """One trainer run at ``layers``: peak GiB and median step ms."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              num_layers=layers)
    args = train_mod.parse_args(ARGV + ["--strategy", strategy, "--steps",
                                        str(steps), "--log-every",
                                        str(steps)])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        result = train_mod.run(args, cfg, ssm_mode=ssm_mode)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return {"oom": True}
    out = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "step_ms": statistics.median(result.step_ms[1:]),
           "step_ms_all": result.step_ms}
    del result
    torch.cuda.empty_cache()
    return out


def main() -> int:
    """Measure every depth and leg, then fit the peak a layer adds."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", default="4,8,12")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--budget-gib", type=float, default=70.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the probe measures the card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    depths = [int(x) for x in args.layers.split(",")]
    report = {"card": card, "argv": ARGV, "steps": args.steps, "legs": {}}
    for strategy, mode in LEGS:
        rows = {}
        for n in depths:
            rows[n] = measure(n, strategy, mode, args.steps)
            print(f"{strategy}/{mode} × {n} layers: {rows[n]}", flush=True)
        fit = sorted(n for n, r in rows.items() if "oom" not in r)
        leg = {"by_layers": rows}
        if len(fit) >= 2:
            lo, hi = fit[0], fit[-1]
            per_layer = (rows[hi]["peak_gib"] - rows[lo]["peak_gib"]) \
                / (hi - lo)
            ms_layer = (rows[hi]["step_ms"] - rows[lo]["step_ms"]) / (hi - lo)
            fixed = rows[lo]["peak_gib"] - per_layer * lo
            leg.update({
                "gib_per_layer": per_layer, "gib_fixed": fixed,
                "ms_per_layer": ms_layer,
                "max_layers_in_budget": int((args.budget_gib - fixed)
                                            // per_layer),
                "full_depth_gib": fixed + per_layer * 64})
        report["legs"][strategy] = leg
    print(card)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
