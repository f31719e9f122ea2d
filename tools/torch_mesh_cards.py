#!/usr/bin/env python
"""Run the sharded planes of the launcher across cards over NCCL, one
rank a card, against the one-device runs of the same flags.

Usage:  python3 tools/torch_mesh_cards.py [--worlds 2,4] [--steps 30]
            [--examples 131072] [--model-parallel M] [--serve-loop]

Needs as many CUDA cards as the largest world.  mlp_svhn at the paper's
width (3072→2048×4→10) with ``--score-shards 4`` runs as one device and
as ``--mesh N`` for each N of ``--worlds``:

  * ``--async-scoring --swap-every 4`` and ``--stream --async-scoring
    --swap-every 4`` (chunks of 1,024, a window of 32 chunks a rank):
    each world's losses (``--metrics-out``, every step, full precision)
    must equal the one-device run's;
  * the largest world saves a gather-free checkpoint after ``--steps``
    − 10 async steps, and one device restores it and runs the last 10:
    the losses must equal the one-device run's last 10;
  * the largest world with ``--adaptive-is --adapt-every 5`` must run
    to its end (the controller's cadence is agreed by an all-reduce at
    every decision; the cadence follows measured times, so no loss is
    compared).

With ``--model-parallel M`` (M > 1) it runs the model-parallel legs
instead: the relaxed trainer, ``--async-scoring --swap-every 4`` and
``--stream --async-scoring`` as ``--model-parallel M`` (M cards) and as
``--mesh N --model-parallel M`` for each N of ``--worlds`` whose N·M
cards the machine has, one rank a card over NCCL.  Sums of M partials
differ from one device's in the last bits (a near-zero gradient's score,
whose p − onehot cancels, by more), one row's CDF boundary moving is
enough to flip a draw, and a diverging run amplifies what differs.  So
only the steps whose draws cannot differ are held to the one-device
run's losses at rtol 1e-4: an async leg's first ``SWAP - 1`` steps,
drawn from the store before its first publish (the relaxed leg draws
from scores at once); every leg's count of steps within that bound and
its step times are reported beside the one-device run's.

With ``--serve-loop`` it runs the serve-loop legs instead: glm4-9b's
smoke config (the launcher has no depth flag), streamed, with the train/
serve loop (``--stream --serve-loop``), as one device, as ``--mesh N``
for each N of ``--worlds`` and, with ``--model-parallel M``, as
``--mesh N --model-parallel M`` where the machine has the N·M cards.
Every data rank serves the same seeded traffic, so each leg must ingest
the one-device run's count of rows; its step times are reported.

Each run is a fresh launcher process.  It prints each run's median step
and quartiles (CUDA events, the launcher's own) and the card line, and
as its last line one JSON object; it exits 1 if any comparison fails.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "mesh_cards")
SWAP = 4                  # the async legs' publish cadence


def launch(tag: str, argv: list) -> dict:
    """One launcher run; its losses and step times."""
    metrics = os.path.join(OUT, f"{tag}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv,
           "--log-every", "1", "--metrics-out", metrics]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       timeout=900, env=dict(
                           os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    if r.returncode:
        sys.exit(f"{tag}: exit {r.returncode}\n{r.stdout[-2000:]}\n"
                 f"{r.stderr[-4000:]}")
    with open(metrics) as f:
        losses = [h["loss"] for h in json.load(f)]
    done = re.search(r"median step ([\d.]+) ms", r.stdout)
    served = re.search(r"serve-loop: ingested (\d+) rows", r.stdout)
    quart = re.search(r"quartiles ([\d.]+)[–-]([\d.]+)", r.stdout)
    out = {"losses": losses, "median_ms": float(done.group(1)),
           "quartiles_ms": ([float(quart.group(1)), float(quart.group(2))]
                            if quart else None),
           "decisions": len(re.findall(r"^controller: ", r.stdout, re.M)),
           "ingested": int(served.group(1)) if served else None}
    print(f"{tag}: {len(losses)} steps, median step {out['median_ms']} ms"
          + (f" (quartiles {out['quartiles_ms']})" if quart else ""),
          flush=True)
    return out


def close_losses(got: list, want: list, rtol: float = 1e-4) -> int:
    """The steps, from the first, whose losses agree within ``rtol``."""
    n = 0
    for a, b in zip(got, want):
        if abs(a - b) > rtol * abs(b):
            break
        n += 1
    return n


def model_parallel_legs(args, base, planes, steps, card) -> int:
    """The ``--model-parallel M`` legs (see the module docstring)."""
    import torch
    m = args.model_parallel
    meshes = [0] + [w for w in (int(x) for x in args.worlds.split(","))
                    if w * m <= torch.cuda.device_count()]
    res, bad = {}, []
    for name, flags in {"relaxed": [], **planes}.items():
        one = launch(f"{name}_one_device", base + flags + steps)
        res[f"{name}_one_device"] = one
        for w in meshes:
            tag = f"{name}_mesh{w}_mp{m}" if w else f"{name}_mp{m}"
            got = launch(tag, base + flags + steps + [
                "--model-parallel", str(m)] + (["--mesh", str(w)] if w
                                               else []))
            got["steps_close"] = close_losses(got["losses"], one["losses"])
            res[tag] = got
            print(f"{tag}: losses within 1e-4 of one device's for "
                  f"{got['steps_close']} of {args.steps} steps", flush=True)
            held = SWAP - 1 if flags else 0
            if got["steps_close"] < min(held, args.steps):
                bad.append(f"{tag}: losses leave one device's after "
                           f"{got['steps_close']} steps, before its "
                           f"first publish")
    for b in bad:
        print(f"FAIL: {b}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": not bad, "card": card, "model_parallel": m,
                      "meshes": meshes,
                      "runs": {k: {kk: v.get(kk) for kk in (
                          "median_ms", "quartiles_ms", "steps_close")}
                          for k, v in res.items()}}))
    return 1 if bad else 0


def serve_loop_legs(args, steps, card) -> int:
    """The ``--serve-loop`` legs (see the module docstring)."""
    import torch
    m = args.model_parallel
    base = ["--arch", "glm4-9b", "--smoke", "--seq", "16", "--batch", "8",
            "--score-batch", "32", "--examples", "1024", "--device", "cuda",
            "--stream", "--serve-loop"]
    one = launch("serve_loop_one_device", base + steps)
    res, bad = {"serve_loop_one_device": one}, []
    worlds = [int(w) for w in args.worlds.split(",")]
    legs = [(f"serve_loop_mesh{w}", ["--mesh", str(w)]) for w in worlds
            if w <= torch.cuda.device_count()]
    if m > 1:
        legs += [(f"serve_loop_mesh{w}_mp{m}", ["--mesh", str(w),
                                                "--model-parallel", str(m)])
                 for w in worlds if w * m <= torch.cuda.device_count()]
    for tag, flags in legs:
        got = res[tag] = launch(tag, base + steps + flags)
        print(f"{tag}: {got['ingested']} rows ingested (one device "
              f"{one['ingested']})", flush=True)
        if not got["ingested"] or got["ingested"] != one["ingested"]:
            bad.append(f"{tag}: {got['ingested']} rows ingested, one device "
                       f"{one['ingested']}")
    for b in bad:
        print(f"FAIL: {b}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": not bad, "card": card, "serve_loop": True,
                      "runs": {k: {kk: v.get(kk) for kk in (
                          "median_ms", "quartiles_ms", "ingested")}
                          for k, v in res.items()}}))
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", default="2,4")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--examples", type=int, default=131072)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="run the model-parallel legs at this M instead")
    ap.add_argument("--serve-loop", action="store_true",
                    help="run the serve-loop legs instead (with "
                    "--model-parallel: also at that M)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    worlds = [int(w) for w in args.worlds.split(",")]
    need = (max(worlds) if args.model_parallel == 1 or args.serve_loop
            else args.model_parallel)
    if need > torch.cuda.device_count():
        sys.exit(f"--worlds {args.worlds} --model-parallel "
                 f"{args.model_parallel} needs {need} cards, this machine "
                 f"has {torch.cuda.device_count()}")
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    base = ["--examples", str(args.examples), "--score-shards", "4",
            "--score-batch", "4096", "--device", "cuda"]
    planes = {"async": ["--async-scoring", "--swap-every", str(SWAP)],
              "stream_async": ["--stream", "--async-scoring",
                               "--swap-every", str(SWAP), "--chunk-size",
                               "1024", "--window-chunks", "32"]}
    steps = ["--steps", str(args.steps)]
    if args.serve_loop:
        return serve_loop_legs(args, steps, card)
    if args.model_parallel > 1:
        return model_parallel_legs(args, base, planes, steps, card)
    res, bad = {}, []
    for name, flags in planes.items():
        one = launch(f"{name}_one_device", base + flags + steps)
        res[f"{name}_one_device"] = one
        for w in worlds:
            got = launch(f"{name}_mesh{w}",
                         base + flags + steps + ["--mesh", str(w)])
            res[f"{name}_mesh{w}"] = got
            if got["losses"] != one["losses"]:
                bad.append(f"{name} --mesh {w}: losses differ from one "
                           f"device")
    w, head = max(worlds), args.steps - 10
    ck = os.path.join(OUT, "ck.npz")
    saved = launch(f"async_mesh{w}_save", base + planes["async"] + [
        "--steps", str(head), "--mesh", str(w), "--save-checkpoint", ck])
    resumed = launch("async_one_device_resume", base + planes["async"] + [
        "--steps", "10", "--restore-checkpoint", ck])
    want = res["async_one_device"]["losses"]
    if saved["losses"] != want[:head] or resumed["losses"] != want[head:]:
        bad.append(f"the --mesh {w} checkpoint does not resume as the "
                   f"one-device run")
    res[f"async_mesh{w}_save"], res["async_one_device_resume"] = (saved,
                                                                 resumed)
    adaptive = launch(f"async_mesh{w}_adaptive", base + planes["async"]
                      + steps + ["--mesh", str(w), "--adaptive-is",
                                 "--adapt-every", "5"])
    res[f"async_mesh{w}_adaptive"] = adaptive
    if adaptive["decisions"] != args.steps // 5:
        bad.append(f"--mesh {w} --adaptive-is: {adaptive['decisions']} "
                   f"decisions, want {args.steps // 5}")
    for b in bad:
        print(f"FAIL: {b}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": not bad, "card": card, "worlds": worlds,
                      "runs": {k: {kk: v[kk] for kk in ("median_ms",
                                                        "quartiles_ms")}
                               for k, v in res.items()}}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
