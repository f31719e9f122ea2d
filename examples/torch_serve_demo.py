"""Serving demo of the PyTorch port: batched prefill + token-by-token decode
with layer caches (GQA ring buffers / MLA compressed latents / Mamba
states), on a reduced jamba-style hybrid by default: the most
cache-heterogeneous arch of the zoo.  Runs on the card unless
``--device cpu`` is given; there the GQA layers take the port's kernels
(flash attention in the prefill, flash decode in each step) and the
decode steps replay one captured CUDA graph.

  PYTHONPATH=src python examples/torch_serve_demo.py [--arch glm4-9b]
  PYTHONPATH=src python examples/torch_serve_demo.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import init_transformer
from repro_torch.serving.engine import (make_decode_runner, prefill,
                                       prefill_attn_impl)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--arch", default="jamba-v0.1-52b")
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--steps", type=int, default=24)
ap.add_argument("--device", default="cuda",
                help="torch device; the CPU runs only when asked for")
args = ap.parse_args()
device = torch.device(args.device)
if device.type == "cuda" and not torch.cuda.is_available():
    ap.error("CUDA is not available; pass --device cpu to run on the CPU")
gen = lambda seed: torch.Generator(device=device).manual_seed(seed)


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize(device)


cfg = get_smoke_config(args.arch)
print(f"arch={cfg.name}  layers={cfg.num_layers}  period={cfg.period_len()}")
params = init_transformer(gen(0), cfg, device)

prompt = torch.randint(0, cfg.vocab_size, (args.batch, 12), generator=gen(1),
                       device=device)
with torch.no_grad():
    t0 = time.perf_counter()
    logits, st = prefill(params, cfg, prompt, max_len=64,
                         attn_impl=prefill_attn_impl(cfg, "pallas"))
    sync()
    print(f"prefill {args.batch}×12 tokens: {time.perf_counter() - t0:.2f}s")
    print("cache buffers:", {k: (tuple(v.shape), str(v.dtype)[6:])
                             for k, v in list(st.caches.items())[:4]})

    decode = make_decode_runner(params, cfg, st, decode_kernel="pallas")
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = [tok]
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        logits, st = decode(tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
    sync()
    dt = time.perf_counter() - t0
print(f"decoded {args.steps} steps × {args.batch} seqs "
      f"({args.steps * args.batch / dt:.1f} tok/s on {device.type})")
print("generated (seq 0):", torch.stack(out, 1)[0].tolist())
