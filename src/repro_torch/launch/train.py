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
``--save-checkpoint`` writes it after.

Telemetry: ``--metrics-jsonl`` writes the reference's schema-v1 events
(``tools/metrics_report.py`` renders them), ``--monitors`` adds the
proposal-health monitors to the step, ``--profile-dir`` opens a
``torch.profiler`` window over ``--profile-steps``.  ``--proposal-strategy``
picks a scorer of the strategy zoo, ``--adaptive-is`` lets the controller
gate between uniform and IS sampling, and ``--index``, ``--table-dtype``,
``--score-ttl`` and ``--index-chunk-size`` select the billion-row
sampling structures:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 30 \
      --examples 1024 --device cpu --monitors all --adaptive-is \
      --adapt-every 10 --metrics-jsonl /tmp/run.jsonl
  python tools/metrics_report.py /tmp/run.jsonl

Flags of the reference launcher that this port does not carry yet are
refused by name.  As in the reference, the attention path of an LM
(``attn_impl``, ``attn_scores``) and the scorer's mamba scan
(``ssm_mode``) are no flags: ``build`` and ``run`` take them as keyword
arguments, e.g. ``run(args, attn_impl="flash", attn_scores="fused")`` or
``run(parse_args(["--arch", "falcon-mamba-7b", "--strategy",
"logit_grad"]), ssm_mode="pallas")``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import configs
from repro_torch.configs import mlp_svhn
from repro_torch.core.importance import ISConfig
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.controller import ControllerConfig, ProposalController
from repro_torch.core.issgd import (ISSGDConfig, TrainState,
                                    init_train_state, make_score_step,
                                    make_train_step)
from repro_torch.core.scorer import make_lm_scorer, make_mlp_scorer
from repro_torch.core.strategies import PROPOSALS, make_proposal
from repro_torch.data import make_svhn_like, make_token_dataset
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer
from repro_torch.optim import sgd
from repro_torch.telemetry import EventSink, MonitorSet, NullSink, Telemetry

PORT = ("the PyTorch port (one device: mlp_svhn, the dense GQA transformer "
        "LMs and the mamba LMs)")

# flags of src/repro/launch/train.py the port does not carry yet
LATER_FLAGS = (
    "--mesh", "--model-parallel",
    "--sequence-parallel", "--no-sequence-parallel", "--async-scoring",
    "--swap-every", "--no-trace-monitors", "--stream", "--chunk-size",
    "--window-chunks", "--prefetch-every", "--serve-loop", "--serve-slots",
    "--serve-prompt-len", "--serve-max-new", "--serve-rate", "--serve-every",
    "--serve-publish-every", "--serve-decode-steps", "--serve-reserve-chunks")

# the StepMetrics fields a logged step records, in the reference's order
METRIC_KEYS = ("loss", "grad_norm", "trace_ideal", "trace_stale",
               "trace_unif", "ess_frac")
# monitors whose values are counts
INT_MONITORS = ("empty_rows", "staleness")


class Built(NamedTuple):
    state: TrainState
    step: Callable       # train_step(state, data) -> (state, metrics)
    data: dict
    probe: Optional[Callable]  # fused mode: score_step(state, data) -> state


class TrainResult(NamedTuple):
    state: TrainState
    history: list        # one record per logged step
    step_ms: list        # every step's time (CUDA events on the card)
    decisions: tuple = ()  # the adaptive controller's, in order


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
    ap.add_argument("--proposal-strategy", default="",
                    choices=[""] + list(PROPOSALS),
                    help="proposal strategy of the zoo (core/strategies.py): "
                    "a --strategy name, upper_bound (sqrt(2L), forward "
                    "only), bandit_mixed (loss + logit_grad mixture) or "
                    "null (zero scores, the uniform proposal); empty falls "
                    "back to --strategy")
    ap.add_argument("--adaptive-is", action="store_true",
                    help="start uniform and let the controller "
                    "(core/controller.py) switch to IS when the observed "
                    "trace ratio says it pays (requires --mode relaxed)")
    ap.add_argument("--adapt-every", type=int, default=25,
                    help="controller decision cadence in steps")
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
    ap.add_argument("--index", default="dense", choices=["dense", "tree"],
                    help="stage-1 masses of the draw: 'tree' through the "
                    "mass index (core/mass_index.py, draws bitwise equal "
                    "to 'dense', which reduces them in the draw)")
    ap.add_argument("--table-dtype", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="weight-table storage: bf16 halves it, int8 (a "
                    "per-chunk scale, needs --index-chunk-size) quarters it")
    ap.add_argument("--score-ttl", type=int, default=0,
                    help="decay stale scores toward the uniform floor with "
                    "a half-life of K steps of chunk age (0 = off)")
    ap.add_argument("--index-chunk-size", type=int, default=0,
                    help="chunk rows for the int8 scales and the TTL decay "
                    "(0 = one chunk per logical scoring shard)")
    ap.add_argument("--metrics-out", default="",
                    help="write the logged steps' records here (JSON)")
    ap.add_argument("--metrics-jsonl", default="",
                    help="write schema-v1 telemetry events (spans, metrics, "
                    "monitors) to this JSONL file; tools/metrics_report.py "
                    "renders it")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="cadence in steps of the metrics records "
                    "(0 = --log-every)")
    ap.add_argument("--monitors", default="none",
                    help="proposal-health monitors of the step: 'all', "
                    "'none', or a comma list of ess,entropy,"
                    "max_weight_frac,empty_rows,staleness; they never "
                    "change the trajectory")
    ap.add_argument("--profile-dir", default="",
                    help="write a torch.profiler trace of the "
                    "--profile-steps window into this directory")
    ap.add_argument("--profile-steps", default="2:2",
                    help="profiler window as START:COUNT train steps")
    ap.add_argument("--telemetry-blocking", action="store_true",
                    help="synchronise the card before each span closes "
                    "(the step's device wall clock; off by default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU runs only when asked for "
                    "(--device cpu)")
    args, unknown = ap.parse_known_args(argv)
    for flag in unknown:
        name = flag.split("=", 1)[0]
        if name in LATER_FLAGS:
            ap.error(f"{name} is a flag of the JAX launcher that {PORT} "
                     f"does not carry yet")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    validate_flags(ap, args)
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


def validate_flags(ap: argparse.ArgumentParser,
                   args: argparse.Namespace) -> None:
    """The reference's refusals of flag combinations
    (``src/repro/launch/train.py::validate_flags`` and its telemetry
    checks), on one device."""
    if args.adaptive_is and args.mode != "relaxed":
        ap.error("--adaptive-is requires --mode relaxed (the controller "
                 "gates the relaxed sampler between uniform and IS; the "
                 "other modes have no gate to drive)")
    cs = args.index_chunk_size
    if args.table_dtype == "int8" and (cs <= 0 or args.examples % cs):
        ap.error(f"--table-dtype int8 needs --index-chunk-size > 0 "
                 f"dividing the per-shard rows ({args.examples}); got {cs} "
                 f"(per-chunk scales may not straddle shards)")
    if cs > 0 and args.examples % cs:
        ap.error(f"--index-chunk-size {cs} must divide the per-shard rows "
                 f"({args.examples})")
    try:
        MonitorSet.parse(args.monitors)
    except ValueError as e:
        ap.error(f"--monitors: {e}")
    try:
        profile_window(args)
    except ValueError:
        ap.error(f"--profile-steps must be START:COUNT, got "
                 f"{args.profile_steps!r}")


def profile_window(args: argparse.Namespace) -> tuple[int, int]:
    """(first step, step count) of the profiler window."""
    start, count = map(int, args.profile_steps.split(":"))
    return start, count


def proposal_name(args: argparse.Namespace) -> str:
    """--proposal-strategy, or --strategy when it is unset."""
    return args.proposal_strategy or args.strategy


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
            make_proposal(make_mlp_scorer, cfg, proposal_name(args)))


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
    return params, train, pel, make_proposal(
        make_lm_scorer, cfg, proposal_name(args), ssm_mode=ssm_mode,
        attn_impl=attn_impl, attn_scores=attn_scores)


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
    and, in fused mode, the probe step (None otherwise).  With
    ``--monitors`` the step returns ``(state, metrics, monitors)``; with
    ``--adaptive-is`` it takes the gate, ``step(state, data, use_is)``.
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
        score_shards=max(args.score_shards, 1), index=args.index,
        table_dtype=args.table_dtype, score_ttl=args.score_ttl,
        index_chunk_size=args.index_chunk_size)
    fused = fused_objective(args, cfg) if args.mode == "fused" else None
    step = make_train_step(pel, scorer, opt, tcfg, train.size,
                           fused_score=fused,
                           monitors=MonitorSet.parse(args.monitors),
                           gated=args.adaptive_is)
    probe = (make_score_step(scorer, tcfg, train.size)
             if args.mode == "fused" else None)
    state = init_train_state(params, opt, train.size, device, seed=args.seed,
                             table_dtype=args.table_dtype,
                             index_chunk_size=args.index_chunk_size)
    return Built(state, step, train.arrays, probe)


def open_sink(args: argparse.Namespace):
    """The run's event sink (a NullSink without ``--metrics-jsonl``),
    tapped by the controller with ``--adaptive-is``; (sink, controller
    or None).  The run record carries the reference's keys."""
    if args.metrics_jsonl:
        sink = EventSink(args.metrics_jsonl, run={
            "arch": args.arch, "mode": args.mode, "steps": args.steps,
            "mesh": 0, "model_parallel": 1, "async_scoring": False,
            "stream": False, "serve_loop": False, "swap_every": 1,
            "monitors": list(MonitorSet.parse(args.monitors).names),
            "proposal_strategy": proposal_name(args),
            "adaptive_is": args.adaptive_is, "seed": args.seed,
            "device": args.device})
    else:
        sink = NullSink()
    ctl = None
    if args.adaptive_is:
        ctl = ProposalController(
            ControllerConfig(adapt_every=args.adapt_every))
        # the tap is truthy over a NullSink too: the metrics records the
        # controller folds keep coming, file or no file
        sink = ctl.attach(sink)
    return sink, ctl


class _Profile:
    """The ``--profile-dir`` window: a torch.profiler session over steps
    [start, start + count), its trace written as ``trace.json`` into the
    directory, and the reference's ``profile`` start/stop records."""

    def __init__(self, args: argparse.Namespace, sink):
        self.dir = args.profile_dir
        self.start, self.count = profile_window(args)
        self.device = torch.device(args.device)
        self.sink = sink
        self.prof = None

    def before(self, i: int) -> None:
        if self.dir and i == self.start:
            os.makedirs(self.dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.sink.emit("profile", step=i, action="start", dir=self.dir)

    def after(self, i: int) -> None:
        if self.prof is not None and i == self.start + self.count - 1:
            self.stop(i)

    def stop(self, i: int) -> None:
        """Close the window (if open) once its work has retired."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        self.prof = None
        self.sink.emit("profile", step=i, action="stop")


def run(args: argparse.Namespace, cfg=None, attn_impl: str = "ref",
        attn_scores=None, ssm_mode: str = "ref") -> TrainResult:
    """Build from ``args`` (and ``cfg``, ``attn_impl``, ``attn_scores``,
    ``ssm_mode``, see ``build``) and train, logging every ``--log-every``
    steps and emitting telemetry records every ``--metrics-every``;
    restore before the loop and save after it when asked.  A step's
    time covers the train step, not the probe.  Everything a step logs
    (metrics and monitors) is read from the card in one transfer, on the
    logging steps only."""
    state, step, data, probe = build(args, cfg, attn_impl=attn_impl,
                                     attn_scores=attn_scores,
                                     ssm_mode=ssm_mode)
    if args.restore_checkpoint:
        state, ck_step = restore_checkpoint(args.restore_checkpoint, state)
        print(f"restored {args.restore_checkpoint} (step {ck_step})",
              flush=True)
    sink, ctl = open_sink(args)
    try:
        return _train_loop(args, state, step, data, probe, sink, ctl)
    finally:
        sink.close()


def _train_loop(args, state, step, data, probe, sink, ctl) -> TrainResult:
    tel = Telemetry(sink, every=args.metrics_every or args.log_every,
                    blocking=args.telemetry_blocking)
    profile = _Profile(args, sink)
    on_cuda = torch.device(args.device).type == "cuda"
    marks = []           # (start, end) CUDA events or host clock pairs
    history = []
    t0 = time.time()
    for i in range(args.steps):
        profile.before(i)
        sargs = (state, data, ctl.gate()) if ctl else (state, data)
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = tel.timed("train.step", step, *sargs, step=i)
            end.record()
        else:
            start = time.perf_counter()
            out = tel.timed("train.step", step, *sargs, step=i)
            end = time.perf_counter()
        state, m, *mon = out
        mon = mon[0] if mon else {}
        marks.append((start, end))
        if probe is not None and i % args.probe_every == 0:
            state = probe(state, data)
        profile.after(i)
        log_now = i % args.log_every == 0 or i == args.steps - 1
        emit_now = bool(sink) and (tel.due(i) or i == args.steps - 1)
        if log_now or emit_now:
            # ONE host transfer for everything this step logs
            vals = torch.stack(
                [getattr(m, k).double() for k in METRIC_KEYS]
                + [v.double() for v in mon.values()]).tolist()
            rec = {"step": i, **dict(zip(METRIC_KEYS, vals)),
                   "elapsed_s": round(time.time() - t0, 2)}
            mon_vals = {k: int(v) if k in INT_MONITORS else v
                        for k, v in zip(mon, vals[len(METRIC_KEYS):])}
            if log_now:
                history.append(rec)
                print(f"step {i:5d} loss {rec['loss']:.4f} "
                      f"√TrΣ ideal/stale/unif = {rec['trace_ideal']:.3f}/"
                      f"{rec['trace_stale']:.3f}/{rec['trace_unif']:.3f} "
                      f"ess {rec['ess_frac']:.3f}", flush=True)
            if emit_now:
                sink.emit("metrics", step=i,
                          **{k: v for k, v in rec.items() if k != "step"})
                if mon_vals:
                    sink.emit("monitors", step=i, **mon_vals)
        if ctl is not None:
            # after the step's metrics have been folded into the window
            d = ctl.maybe_decide(i)
            if d is not None:
                print(f"controller: step {i} use_is={d.use_is} "
                      f"reason={d.reason}", flush=True)
    profile.stop(args.steps - 1)    # a window that ran past the end
    if on_cuda:
        torch.cuda.synchronize(args.device)
        step_ms = [s.elapsed_time(e) for s, e in marks]
    else:
        step_ms = [(e - s) * 1e3 for s, e in marks]
    if args.save_checkpoint:
        save_checkpoint(args.save_checkpoint, state, step=state.step)
        print(f"saved checkpoint to {args.save_checkpoint}", flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=2)
    end = {"steps": args.steps, "elapsed_s": round(time.time() - t0, 2)}
    if history:
        end["final_loss"] = history[-1]["loss"]
    sink.emit("run_end", step=args.steps - 1, **end)
    return TrainResult(state, history, step_ms,
                       tuple(ctl.decisions) if ctl else ())


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
