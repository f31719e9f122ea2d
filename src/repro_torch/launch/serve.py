"""Serving launcher of the PyTorch port: batched prefill + greedy decode.

Serves any arch of the model zoo on the card by default, with random
parameters drawn from ``--seed``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --batch 8 --prompt-len 2048 --steps 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --smoke --device cpu

It prints the prefill time, the decode rate and a sample, as the
reference launcher (``src/repro/launch/serve.py``) does.  A frontend arch
(llava-next-34b, musicgen-medium) gets the reference's stub embeds before
its prompt: ``min(num_frontend_tokens, 8)`` rows (``--frontend-tokens``
sets another count) of N(0, 1)·0.02 drawn from ``--seed + 2``; the
default ``--max-len`` counts them, so the cache holds every position.
On the card the decode loop replays one decode step captured in a CUDA
graph (``serving/engine.py::make_decode_runner``), as the reference jits
it; the warm-up and capture are timed apart from the decode rate.
``--kernel pallas`` (the default here) runs the port's hand-written
kernels through ``kernels/ops.py``: the flash-attention forward in the
prefill and the flash-decode kernel in every decode step, on the GQA
layers (an MLA stack's prefill runs its materialised attention, its
decode the absorbed MLA decode; mamba layers scan with the oracle in the
prefill and step their state in decode; the route taken is printed).
``--kernel ref`` takes the plain route: chunked prefill attention and
the reference's decode oracle.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch.launch.train import use_full_f32
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import init_transformer
from repro_torch.serving.engine import (ServeState, check_servable,
                                       make_decode_runner, prefill,
                                       prefill_attn_impl)


class ServeResult(NamedTuple):
    params: dict
    state: ServeState
    tokens: torch.Tensor     # (B, steps + 1): the prefill's token, then decode
    prefill_route: str       # the prefill attention route taken
    prefill_ms: float        # host clock, device synchronised at both ends
    capture_ms: float        # the decode runner's warm-up and graph capture
    decode_s: float          # host clock over all decode steps, synchronised
    step_ms: list            # each decode step (CUDA events on the card)
    tok_per_s: float
    peak_bytes: int          # device memory peak of prefill + decode (card)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b",
                    help="an arch by name or alias: "
                    + ", ".join(configs.get_config(n).name
                                for n in configs.ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache length (default: every position, the "
                    "frontend's included)")
    ap.add_argument("--frontend-tokens", type=int, default=-1,
                    help="stub embeds before the prompt of a frontend arch "
                    "(default min(num_frontend_tokens, 8), as the "
                    "reference's launcher)")
    ap.add_argument("--kernel", default="pallas", choices=["ref", "pallas"],
                    help="pallas: the port's kernels (flash-attention "
                    "prefill, flash-decode); ref: the plain oracles")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for "
                    "(--device cpu)")
    args = ap.parse_args(argv)
    try:
        check_servable(configs.get_config(args.arch))
    except (KeyError, ValueError) as e:
        ap.error(f"--arch {args.arch}: {e.args[0]}")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: CUDA is not available; the "
                 f"launcher runs on the card unless --device cpu is given")
    return args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def run(args: argparse.Namespace, cfg=None) -> ServeResult:
    """Build params and prompts from ``args`` (``cfg`` overrides the arch's
    config, e.g. a cut depth), prefill and decode ``--steps`` tokens."""
    use_full_f32()
    device = torch.device(args.device)
    cfg = cfg or (configs.get_smoke_config(args.arch) if args.smoke
                  else configs.get_config(args.arch))
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    params = init_transformer(gen(args.seed), cfg, device)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen(args.seed + 1), device=device)
    embeds, n_front = None, 0
    if cfg.frontend != "none":
        n_front = (args.frontend_tokens if args.frontend_tokens >= 0
                   else min(cfg.num_frontend_tokens, 8))
        embeds = (torch.randn(args.batch, n_front, cfg.d_model,
                              generator=gen(args.seed + 2), device=device)
                  .to(dtype_of(cfg)) * 0.02)
    max_len = args.max_len or (n_front + args.prompt_len + args.steps)
    route = prefill_attn_impl(cfg, args.kernel)
    on_cuda = device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)

    _sync(device)
    t0 = time.perf_counter()
    logits, st = prefill(params, cfg, prompt, max_len, embeds=embeds,
                         attn_impl=route)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    front = f" after {n_front} frontend embeds" if n_front else ""
    print(f"prefill: {args.batch}x{args.prompt_len}{front} in "
          f"{prefill_ms / 1e3:.2f}s (attention route {route})", flush=True)

    tok = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    decode = make_decode_runner(params, cfg, st, decode_kernel=args.kernel)
    _sync(device)
    capture_ms = (time.perf_counter() - t0) * 1e3
    outs, marks = [tok], []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
        logits, st = decode(tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
        if on_cuda:
            end.record()
        else:
            end = time.perf_counter()
        marks.append((start, end))
        outs.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    step_ms = ([s.elapsed_time(e) for s, e in marks] if on_cuda
               else [(e - s) * 1e3 for s, e in marks])
    tok_s = args.steps * args.batch / dt if dt > 0 else float("inf")
    tokens = torch.stack(outs, 1)
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    captured = (f"; warm-up and graph capture {capture_ms / 1e3:.2f}s "
                f"before" if on_cuda else "")
    print(f"decode: {args.steps} steps × {args.batch} seqs in {dt:.2f}s "
          f"({tok_s:.1f} tok/s{captured})", flush=True)
    print("sample:", tokens[0][:16].tolist(), flush=True)
    return ServeResult(params, st, tokens, route, prefill_ms, capture_ms, dt,
                       step_ms, tok_s, peak)


def main(argv=None, cfg=None) -> ServeResult:
    args = parse_args(argv)
    result = run(args, cfg)
    if result.step_ms:
        clock = ("CUDA events" if torch.device(args.device).type == "cuda"
                 else "host clock")
        peak = (f", peak device memory {result.peak_bytes / 2**30:.2f} GiB"
                if result.peak_bytes else "")
        print(f"done: median decode step "
              f"{statistics.median(result.step_ms):.3f} ms ({clock}) on "
              f"{args.device}, kernel route {args.kernel}{peak}", flush=True)
    return result


if __name__ == "__main__":
    main()
