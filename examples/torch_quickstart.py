"""Quickstart of the PyTorch port: ISSGD in ~40 lines.

Trains the paper's MLP classifier (reduced) on a synthetic
permutation-invariant SVHN clone with distributed-importance-sampling SGD,
and prints the paper's variance monitors as it goes.  Runs on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

With ``--stream`` the dataset lives in host chunks (pinned on the card)
and the device holds only a proposal-aware window of them plus the
sampled minibatch (``data/streaming.py``): the loss trajectory is bitwise
the same.

  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --stream
"""
import argparse

import torch

from repro_torch.core.importance import ISConfig
from repro_torch.core.issgd import (ISSGDConfig, init_train_state,
                                    make_train_step)
from repro_torch.core.scorer import make_mlp_scorer
from repro_torch.data import make_svhn_like
from repro_torch.models.mlp import (MLPConfig, accuracy, init_mlp_classifier,
                                    per_example_loss)
from repro_torch.optim import sgd

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device; the CPU runs only when asked for")
ap.add_argument("--stream", action="store_true",
                help="host-resident chunks behind a device window")
ap.add_argument("--steps", type=int, default=401)
args = ap.parse_args()
device = torch.device(args.device)
if device.type == "cuda" and not torch.cuda.is_available():
    ap.error("CUDA is not available; pass --device cpu to run on the CPU")
gen = lambda seed: torch.Generator(device=device).manual_seed(seed)

# 1. model + data -----------------------------------------------------------
cfg = MLPConfig(input_dim=96, hidden=(256, 256), num_classes=10)
train, test = make_svhn_like(gen(0), n=8192, dim=cfg.input_dim)
params = init_mlp_classifier(gen(1), cfg, device)

# 2. the paper's system: scorer (workers) + IS train step (master) ----------
issgd_cfg = ISSGDConfig(
    batch_size=64,            # master minibatch M
    score_batch_size=512,     # how much the "workers" rescore per step
    refresh_every=8,          # parameter-push period (staleness Δt)
    mode="relaxed",           # the paper's practical algorithm
    is_cfg=ISConfig(smoothing=1.0),   # B.3 additive smoothing
)
opt = sgd(0.02)
pel = lambda p, b: per_example_loss(p, b, cfg)
scorer = make_mlp_scorer(cfg, "ghost")          # exact Prop.-1 grad norms
if args.stream:
    # the driver owns the examples: step() takes no dataset argument
    from repro_torch.data.streaming import make_streamed_issgd
    driver = make_streamed_issgd(pel, scorer, opt, issgd_cfg, train.arrays,
                                 chunk_size=512, window_chunks=4,
                                 device=device)
    step = driver.step
else:
    step = make_train_step(per_example_loss=pel, scorer=scorer,
                           optimizer=opt, cfg=issgd_cfg,
                           num_examples=train.size)

# 3. train -------------------------------------------------------------------
state = init_train_state(params, opt, train.size, device)
for i in range(args.steps):
    state, m = step(state) if args.stream else step(state, train.arrays)
    if i % 50 == 0:
        print(f"step {i:4d}  loss {m.loss.item():.4f}  "
              f"√TrΣ ideal/stale/unif = {m.trace_ideal.item():.2f}/"
              f"{m.trace_stale.item():.2f}/{m.trace_unif.item():.2f}")

print("test accuracy:", accuracy(state.params, test.arrays, cfg).item())
if args.stream:
    s = driver.plane.stats
    print(f"streaming: window hit rate {s.hit_rate:.3f}, "
          f"{s.streamed_rows} scoring rows streamed, {s.swaps} swaps")
