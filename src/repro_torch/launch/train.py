"""ISSGD training launcher of the PyTorch port (one device).

Runs the paper's experiment (mlp_svhn), a dense GQA transformer LM
(glm4-9b, deepseek-7b, internlm2-20b) or the attention-free mamba LM
falcon-mamba-7b on the card by default:

  PYTHONPATH=src python -m repro_torch.launch.train
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \
      --examples 1024 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
      --smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \
      --examples 1024 --device cpu --mode fused --probe-every 8 \
      --save-checkpoint /tmp/ck.npz

It prints the reference launcher's per-step log line
(``src/repro/launch/train.py``) and a closing line with the median step
time.  ``--mode fused`` trains on the closed-form scores of its own
forward and runs the probe step (``make_score_step``) after step i when
i % ``--probe-every`` == 0; ``--restore-checkpoint`` loads a TrainState
(the port's or the reference's npz) before the loop and
``--save-checkpoint`` writes it after.  Flags of the reference launcher that this port does not carry yet
are refused by name.  As in the reference, the attention path of an LM
(``attn_impl``, ``attn_scores``) and the scorer's mamba scan
(``ssm_mode``) are no flags: ``build`` and ``run`` take them as keyword
arguments, e.g. ``run(args, attn_impl="flash", attn_scores="fused")`` or
``run(parse_args(["--arch", "falcon-mamba-7b", "--strategy",
"logit_grad"]), ssm_mode="pallas")``.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import configs
from repro_torch.configs import mlp_svhn
from repro_torch.core.importance import ISConfig
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.issgd import (ISSGDConfig, TrainState,
                                    init_train_state, make_score_step,
                                    make_train_step)
from repro_torch.core.scorer import make_lm_scorer, make_mlp_scorer
from repro_torch.data import make_svhn_like, make_token_dataset
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer
from repro_torch.optim import sgd

SLICE = ("slice 2 of the PyTorch port (single-device mlp_svhn, dense GQA "
         "transformer LMs and mamba LMs)")

# flags of src/repro/launch/train.py this slice does not carry yet
LATER_FLAGS = (
    "--proposal-strategy", "--adaptive-is",
    "--adapt-every", "--index", "--table-dtype", "--score-ttl",
    "--index-chunk-size", "--mesh", "--model-parallel",
    "--sequence-parallel", "--no-sequence-parallel", "--async-scoring",
    "--swap-every", "--no-trace-monitors", "--stream", "--chunk-size",
    "--window-chunks", "--prefetch-every", "--serve-loop", "--serve-slots",
    "--serve-prompt-len", "--serve-max-new", "--serve-rate", "--serve-every",
    "--serve-publish-every", "--serve-decode-steps", "--serve-reserve-chunks",
    "--metrics-out", "--metrics-jsonl", "--metrics-every", "--monitors",
    "--profile-dir", "--profile-steps", "--telemetry-blocking")


class Built(NamedTuple):
    state: TrainState
    step: Callable       # train_step(state, data) -> (state, metrics)
    data: dict
    probe: Optional[Callable]  # fused mode: score_step(state, data) -> state


class TrainResult(NamedTuple):
    state: TrainState
    history: list        # one record per logged step
    step_ms: list        # every step's time (CUDA events on the card)


def use_full_f32() -> None:
    """The reference computes in full f32; TF32 matmuls or convolutions
    would keep ~3 decimal digits and break parity with it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mlp_svhn",
                    help="mlp_svhn, or a ported LM arch by name or alias: "
                    + ", ".join(configs.PORTED))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--score-batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--examples", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--mode", default="relaxed",
                    choices=["relaxed", "exact", "uniform", "fused"])
    ap.add_argument("--strategy", default="ghost",
                    choices=["loss", "logit_grad", "ghost", "ghost_rev",
                             "full"])
    ap.add_argument("--probe-every", type=int, default=8,
                    help="fused mode: run a coverage probe every K steps")
    ap.add_argument("--refresh-every", type=int, default=8)
    ap.add_argument("--staleness-threshold", type=int, default=0)
    ap.add_argument("--smoothing", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--save-checkpoint", default="",
                    help="save the final TrainState here (npz)")
    ap.add_argument("--restore-checkpoint", default="",
                    help="restore a TrainState (the port's or the JAX "
                    "launcher's npz) before training")
    ap.add_argument("--score-shards", type=int, default=0,
                    help="logical scoring shards W (0 = 1 on one device)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for "
                    "(--device cpu)")
    args, unknown = ap.parse_known_args(argv)
    for flag in unknown:
        name = flag.split("=", 1)[0]
        if name in LATER_FLAGS:
            ap.error(f"{name} is a flag of the JAX launcher that {SLICE} "
                     f"does not carry yet")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.arch != "mlp_svhn":
        try:
            configs.resolve(args.arch)
        except (KeyError, NotImplementedError) as e:
            ap.error(f"--arch {args.arch}: {e.args[0]}")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: CUDA is not available; the "
                 f"launcher runs on the card unless --device cpu is given")
    return args


def _generator(device: torch.device):
    return lambda seed: torch.Generator(device=device).manual_seed(seed)


def resolve_config(args: argparse.Namespace, cfg=None):
    """``cfg``, or the config ``args`` names (its smoke size with
    ``--smoke``)."""
    if cfg is not None:
        return cfg
    if args.arch == "mlp_svhn":
        return mlp_svhn.smoke() if args.smoke else mlp_svhn.CONFIG
    return (configs.get_smoke_config(args.arch) if args.smoke
            else configs.get_config(args.arch))


def build_mlp(args: argparse.Namespace, cfg=None, attn_impl: str = "ref",
              attn_scores=None, ssm_mode: str = "ref"):
    """(params, train data, per-example loss, scorer) of the MLP, which
    has neither attention nor mamba layers: ``attn_impl``,
    ``attn_scores`` and ``ssm_mode`` must keep their defaults."""
    if attn_impl != "ref" or attn_scores is not None or ssm_mode != "ref":
        raise ValueError(f"mlp_svhn has no attention or mamba layers; "
                         f"attn_impl={attn_impl!r}, attn_scores="
                         f"{attn_scores!r}, ssm_mode={ssm_mode!r} apply to "
                         f"the LM archs")
    device = torch.device(args.device)
    gen = _generator(device)
    cfg = resolve_config(args, cfg)
    train, _ = make_svhn_like(gen(args.seed), n=args.examples,
                              dim=cfg.input_dim)
    params = mlp_mod.init_mlp_classifier(gen(args.seed + 1), cfg, device)
    return (params, train, lambda p, b: mlp_mod.per_example_loss(p, b, cfg),
            make_mlp_scorer(cfg, args.strategy))


def build_lm(args: argparse.Namespace, cfg=None, attn_impl: str = "ref",
             attn_scores=None, ssm_mode: str = "ref"):
    """(params, train data, per-example loss, scorer) of a transformer LM
    (``src/repro/launch/train.py::build_lm`` on one device).  The master's
    loss runs the ``attn_impl`` attention path and the scorer runs it with
    ``attn_scores``; the master never sees a score tap.  ``ssm_mode``
    reaches the scorer only: the master differentiates its loss, so its
    mamba layers scan with "ref", as in the reference."""
    device = torch.device(args.device)
    gen = _generator(device)
    cfg = resolve_config(args, cfg)
    train = make_token_dataset(gen(args.seed), n=args.examples,
                               seq=args.seq + 1, vocab=cfg.vocab_size)
    params = transformer.init_transformer(gen(args.seed + 1), cfg, device)
    pel = lambda p, b: transformer.per_example_loss(
        p, cfg, b, attn_impl=attn_impl)[0]
    return params, train, pel, make_lm_scorer(
        cfg, args.strategy, ssm_mode=ssm_mode, attn_impl=attn_impl,
        attn_scores=attn_scores)


def fused_objective(args: argparse.Namespace, cfg=None) -> Callable:
    """Fused mode's ``(params, batch) -> (losses, scores)``: one forward
    and the closed-form logit-grad norm of its head."""
    cfg = resolve_config(args, cfg)
    if args.arch == "mlp_svhn":
        return lambda p, b: mlp_mod.per_example_loss_and_score(p, b, cfg)
    return lambda p, b: transformer.per_example_loss_and_score(p, cfg, b)


def build(args: argparse.Namespace, cfg=None, attn_impl: str = "ref",
          attn_scores=None, ssm_mode: str = "ref") -> Built:
    """(state, train_step, data, probe) for ``args``: model, data, step
    and, in fused mode, the probe step (None otherwise).
    ``cfg`` overrides the arch's config (e.g. a cut depth); ``attn_impl``
    ("ref" or "flash") and ``attn_scores`` (None, "fused" or "separate")
    pick an LM's attention path, ``ssm_mode`` ("ref" or "pallas") its
    scorer's mamba scan (``build_lm``)."""
    use_full_f32()
    device = torch.device(args.device)
    builder = build_mlp if args.arch == "mlp_svhn" else build_lm
    params, train, pel, scorer = builder(args, cfg, attn_impl=attn_impl,
                                         attn_scores=attn_scores,
                                         ssm_mode=ssm_mode)
    opt = sgd(args.lr)
    tcfg = ISSGDConfig(
        batch_size=args.batch, score_batch_size=args.score_batch,
        refresh_every=args.refresh_every, mode=args.mode,
        is_cfg=ISConfig(smoothing=args.smoothing,
                        staleness_threshold=args.staleness_threshold),
        score_shards=max(args.score_shards, 1))
    fused = fused_objective(args, cfg) if args.mode == "fused" else None
    step = make_train_step(pel, scorer, opt, tcfg, train.size,
                           fused_score=fused)
    probe = (make_score_step(scorer, tcfg, train.size)
             if args.mode == "fused" else None)
    state = init_train_state(params, opt, train.size, device, seed=args.seed)
    return Built(state, step, train.arrays, probe)


def run(args: argparse.Namespace, cfg=None, attn_impl: str = "ref",
        attn_scores=None, ssm_mode: str = "ref") -> TrainResult:
    """Build from ``args`` (and ``cfg``, ``attn_impl``, ``attn_scores``,
    ``ssm_mode``, see ``build``) and train, logging every ``--log-every``
    steps; restore before the loop and save after it when asked.  A
    step's time covers the train step, not the probe."""
    state, step, data, probe = build(args, cfg, attn_impl=attn_impl,
                                     attn_scores=attn_scores,
                                     ssm_mode=ssm_mode)
    if args.restore_checkpoint:
        state, ck_step = restore_checkpoint(args.restore_checkpoint, state)
        print(f"restored {args.restore_checkpoint} (step {ck_step})",
              flush=True)
    on_cuda = torch.device(args.device).type == "cuda"
    marks = []           # (start, end) CUDA events or host clock pairs
    history = []
    t0 = time.time()
    for i in range(args.steps):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, data)
            end.record()
        else:
            start = time.perf_counter()
            state, m = step(state, data)
            end = time.perf_counter()
        marks.append((start, end))
        if probe is not None and i % args.probe_every == 0:
            state = probe(state, data)
        if i % args.log_every == 0 or i == args.steps - 1:
            # ONE host transfer for everything this step logs
            vals = torch.stack([m.loss, m.grad_norm, m.trace_ideal,
                                m.trace_stale, m.trace_unif,
                                m.ess_frac]).tolist()
            rec = dict(zip(("loss", "grad_norm", "trace_ideal",
                            "trace_stale", "trace_unif", "ess_frac"), vals))
            rec = {"step": i, **rec, "elapsed_s": round(time.time() - t0, 2)}
            history.append(rec)
            print(f"step {i:5d} loss {rec['loss']:.4f} "
                  f"√TrΣ ideal/stale/unif = {rec['trace_ideal']:.3f}/"
                  f"{rec['trace_stale']:.3f}/{rec['trace_unif']:.3f} "
                  f"ess {rec['ess_frac']:.3f}", flush=True)
    if on_cuda:
        torch.cuda.synchronize(args.device)
        step_ms = [s.elapsed_time(e) for s, e in marks]
    else:
        step_ms = [(e - s) * 1e3 for s, e in marks]
    if args.save_checkpoint:
        save_checkpoint(args.save_checkpoint, state, step=state.step)
        print(f"saved checkpoint to {args.save_checkpoint}", flush=True)
    return TrainResult(state, history, step_ms)


def main(argv=None, cfg=None) -> TrainResult:
    args = parse_args(argv)
    result = run(args, cfg)
    if result.step_ms:
        clock = ("CUDA events" if torch.device(args.device).type == "cuda"
                 else "host clock")
        print(f"done: {args.steps} steps on {args.device}, median step "
              f"{statistics.median(result.step_ms):.3f} ms ({clock})",
              flush=True)
    return result


if __name__ == "__main__":
    main()
