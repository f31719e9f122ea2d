"""ISSGD training launcher of the PyTorch port.

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
      --save-checkpoint build/ck.npz       # after mkdir -p build

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

The asynchronous planes: ``--async-scoring`` runs the scoring pass on a
side CUDA stream beside the master (``core/async_pipeline.py``, the
store published every ``--swap-every`` steps); ``--stream`` keeps the
dataset in host chunks behind a proposal-driven device window
(``data/streaming.py``; bitwise the resident run); ``--serve-loop``
(with ``--stream`` and an LM) decodes traffic against published params
each step and ingests it back into the store (``serving/loop.py``):

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \
      --examples 1024 --device cpu --stream --async-scoring --swap-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
      --smoke --device cpu --steps 6 --examples 256 --seq 16 --batch 8 \
      --score-batch 32 --stream --serve-loop

Sharded execution (``core/distributed.py``): ``--mesh N`` runs the step
on N ranks of a data group, the dataset and the weight store sharded
over them (``launch/mesh.py``; NCCL with rank r on ``cuda:r``, gloo with
``--device cpu``).  It prints the same losses as the one-device run with
``--score-shards N``, and composes with ``--async-scoring``, ``--stream``
(a rank's host store holds only its chunks) and ``--save-checkpoint``
(gather-free: the file restores at any ``--mesh``, or none); under
``--adaptive-is`` every rank applies rank 0's swap cadence
(``rank0_cadence``):

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --mesh 2 \
      --device cpu --steps 8 --examples 1024
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --mesh 2 \
      --device cpu --steps 8 --examples 1024 --stream --async-scoring \
      --swap-every 2 --save-checkpoint build/ck.npz

Model parallelism: ``--model-parallel M`` splits the parameters, their
stale copy and the optimizer state over M model ranks a data rank by
the logical→mesh rules of ``dist/sharding.py`` (head-sharded attention,
ffn-sharded MLP and experts, channel-parallel mamba, a vocab-parallel
embed and unembed; the MLP's layers column-sharded where M divides
their width).  The world is ``--mesh`` N (1 when unset) times M ranks;
the ghost scores are summed over the model group, so every rank draws
the one-device run's draws.  ``--(no-)sequence-parallel`` runs the LM's
RMSNorm segments sequence-parallel (on by default when M > 1, skipped
where M does not divide the sequence).  It composes with every mode,
``--async-scoring``, ``--stream`` and ``--save-checkpoint`` (gather-free
over both axes):

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --mesh 2 \
      --model-parallel 2 --device cpu --steps 8 --examples 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
      --smoke --device cpu --model-parallel 2 --steps 4 --seq 16

Both compose with ``--serve-loop``: every data rank serves the same
seeded traffic through its model group's batcher
(``serving/sharded_decode.py``), and a rank ingests the served rows of
its own chunks, the reserved chunks laid out before the store is split
(an M that a present layer type cannot split exits 1 up front, naming
the config field):

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
      --smoke --device cpu --mesh 2 --model-parallel 2 --stream \
      --serve-loop

As in the reference, the attention path of an LM
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
import sys
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs import mlp_svhn
from repro_torch.core.importance import ISConfig
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.async_pipeline import AsyncPipeline
from repro_torch.core.collectives import psum
from repro_torch.core.controller import ControllerConfig, ProposalController
from repro_torch.core.distributed import (make_sharded_async_steps,
                                          make_sharded_score_step,
                                          make_sharded_streamed_steps,
                                          make_sharded_train_step,
                                          resolve_param_specs,
                                          shard_dataset, shard_train_state,
                                          train_state_specs)
from repro_torch.core.issgd import ISSGDConfig, TrainState, init_train_state
from repro_torch.core.weight_store import (init_store, reserve_tail,
                                           to_buffered)
from repro_torch.core.scorer import make_lm_scorer, make_mlp_scorer
from repro_torch.core.strategies import PROPOSALS, make_proposal
from repro_torch.data import (ChunkedExampleStore, make_svhn_like,
                              make_token_dataset)
from repro_torch.data.streaming import StreamedISSGD, StreamingDataPlane
from repro_torch.dist import DataGroup, axis_info
from repro_torch.dist.sharding import shard_tree
from repro_torch.launch import mesh
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer
from repro_torch.optim import sgd
from repro_torch.serving import (ContinuousBatcher, ServeLoop, TrafficIngest,
                                 decode_cache_specs, make_synthetic_traffic)
from repro_torch.telemetry import EventSink, MonitorSet, NullSink, Telemetry

PORT = "the PyTorch port"

# flags of src/repro/launch/train.py the port does not carry yet: none
LATER_FLAGS = ()

# the StepMetrics fields a logged step records, in the reference's order
METRIC_KEYS = ("loss", "grad_norm", "trace_ideal", "trace_stale",
               "trace_unif", "ess_frac")
# monitors whose values are counts
INT_MONITORS = ("empty_rows", "staleness")


class Built(NamedTuple):
    state: TrainState
    step: Callable       # train_step(state, data) -> (state, metrics)
    data: Optional[dict]  # None when streamed: the plane holds the rows
    probe: Optional[Callable]  # fused mode: score_step(state, data) -> state
    pipe: object = None   # AsyncPipeline or StreamedISSGD, when one runs
    serve: Optional[ServeLoop] = None
    param_specs: object = None  # the params' spec tree under a model group


class TrainResult(NamedTuple):
    state: TrainState
    history: list        # one record per logged step
    step_ms: list        # every step's time (CUDA events on the card)
    decisions: tuple = ()  # the adaptive controller's, in order
    built: Optional[Built] = None


def use_full_f32() -> None:
    """The reference computes in full f32; TF32 matmuls or convolutions
    would keep ~3 decimal digits and break parity with it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mlp_svhn",
                    help="mlp_svhn, or an LM arch by name or alias: "
                    + ", ".join(configs.ARCH_NAMES))
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
                    help="logical scoring shards W (0 = auto: the mesh "
                    "size, 1 on one device)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="run the sharded step on N ranks of a data group "
                    "(launch/mesh.py: NCCL, rank r on cuda:r; gloo with "
                    "--device cpu); 0 = one device")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="split the params, their stale copy and the "
                    "optimizer state over M model ranks a data rank "
                    "(dist/sharding.py; the world is --mesh times M "
                    "ranks; an LM needs M to divide num_heads, "
                    "num_kv_heads and d_inner)")
    ap.add_argument("--sequence-parallel",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="LM with --model-parallel: run the RMSNorm "
                    "segments sequence-parallel (on by default when M > 1 "
                    "and M divides the sequence; both are exact)")
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
    ap.add_argument("--async-scoring", action="store_true",
                    help="run the scoring pass on a side CUDA stream beside "
                    "the master update, over the double-buffered store "
                    "(core/async_pipeline.py; mode relaxed|uniform)")
    ap.add_argument("--swap-every", type=int, default=1,
                    help="async: publish write_buf -> read_buf every K "
                    "steps (the proposal lag is L in [1, K])")
    ap.add_argument("--no-trace-monitors", action="store_true",
                    help="async: skip the fig-4 trace monitors in the "
                    "scoring step (traces log as nan)")
    ap.add_argument("--stream", action="store_true",
                    help="host-resident chunked dataset (pinned on the "
                    "card) behind a proposal-aware device window "
                    "(data/streaming.py); bitwise the resident run, "
                    "composes with --async-scoring")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="examples per host chunk (0 = auto: the largest "
                    "divisor of the example count at most an eighth of it)")
    ap.add_argument("--window-chunks", type=int, default=4,
                    help="device-resident hot chunks")
    ap.add_argument("--prefetch-every", type=int, default=1,
                    help="stage a fresh proposal-ranked window every K "
                    "steps")
    ap.add_argument("--serve-loop", action="store_true",
                    help="close the train/serve loop: a continuous-"
                    "batching decode tick each train step against "
                    "published param snapshots, finished requests "
                    "ingested back into the store (requires --stream and "
                    "an LM arch)")
    ap.add_argument("--serve-slots", type=int, default=2,
                    help="serve loop: concurrent decode slots")
    ap.add_argument("--serve-prompt-len", type=int, default=4,
                    help="serve loop: synthetic-traffic prompt length")
    ap.add_argument("--serve-max-new", type=int, default=4,
                    help="serve loop: tokens generated per request")
    ap.add_argument("--serve-rate", type=int, default=1,
                    help="serve loop: new requests per serve tick")
    ap.add_argument("--serve-every", type=int, default=1,
                    help="serve loop: a serve tick every K train steps")
    ap.add_argument("--serve-publish-every", type=int, default=0,
                    help="serve loop: snapshot the params for serving "
                    "every K serve ticks (0 = --swap-every)")
    ap.add_argument("--serve-decode-steps", type=int, default=2,
                    help="serve loop: lock-step decodes per serve tick")
    ap.add_argument("--serve-reserve-chunks", type=int, default=2,
                    help="serve loop: zero chunks appended up front as "
                    "traffic capacity (reserved rows carry no proposal "
                    "mass until ingested)")
    ap.add_argument("--telemetry-blocking", action="store_true",
                    help="synchronise the card before each span closes "
                    "(the step's device wall clock; off by default). It "
                    "waits for every stream, so it serialises the async "
                    "scoring/master overlap")
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
        except KeyError as e:
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
    if args.async_scoring and args.mode not in ("relaxed", "uniform"):
        ap.error("--async-scoring requires --mode relaxed|uniform (fused "
                 "scores ride the train forward and exact has no separate "
                 "pass to overlap)")
    if args.adaptive_is and args.mode != "relaxed":
        ap.error("--adaptive-is requires --mode relaxed (the controller "
                 "gates the relaxed sampler between uniform and IS; the "
                 "other modes have no gate to drive)")
    if args.stream and args.mode == "exact":
        ap.error("--stream does not support --mode exact (the oracle "
                 "rescores the full dataset each step; keep it resident)")
    if args.swap_every < 1 or args.prefetch_every < 1:
        ap.error("--swap-every and --prefetch-every must be >= 1")
    if args.serve_loop:
        if not args.stream:
            ap.error("--serve-loop requires --stream (served traffic is "
                     "ingested as chunks of the host-resident store)")
        if args.arch == "mlp_svhn":
            ap.error("--serve-loop needs a token arch (the decode service "
                     "generates tokens); pick a transformer --arch")
        if args.mode not in ("relaxed", "fused"):
            ap.error("--serve-loop requires --mode relaxed|fused (uniform "
                     "sampling draws reserved-capacity rows before they "
                     "are ingested; exact is excluded by --stream)")
    if args.table_dtype == "int8" and (args.stream or args.serve_loop):
        ap.error("--table-dtype int8 does not compose with --stream/"
                 "--serve-loop yet (the streamed serving ingest assumes a "
                 "float table); use f32 or bf16 there")
    cs = args.index_chunk_size
    n_local = args.examples // max(args.mesh, 1)
    if args.table_dtype == "int8" and (cs <= 0 or n_local % cs):
        ap.error(f"--table-dtype int8 needs --index-chunk-size > 0 "
                 f"dividing the per-shard rows ({n_local}); got {cs} "
                 f"(per-chunk scales may not straddle shards)")
    if cs > 0 and n_local % cs:
        ap.error(f"--index-chunk-size {cs} must divide the per-shard rows "
                 f"({n_local})")
    try:
        MonitorSet.parse(args.monitors)
    except ValueError as e:
        ap.error(f"--monitors: {e}")
    try:
        profile_window(args)
    except ValueError:
        ap.error(f"--profile-steps must be START:COUNT, got "
                 f"{args.profile_steps!r}")
    validate_model_parallel(ap, args)


def validate_model_parallel(ap: argparse.ArgumentParser,
                            args: argparse.Namespace) -> None:
    """The reference's refusals of ``--model-parallel``: the ``full``
    oracle, and an LM whose heads, kv heads or d_inner M does not divide
    (mlp_svhn's uneven widths replicate with a warning instead).  With
    ``--serve-loop`` the split is refused by ``check_mesh`` instead, with
    the decode caches' message (``decode_cache_specs``)."""
    mp = args.model_parallel
    if mp < 1:
        ap.error(f"--model-parallel must be >= 1, got {mp}")
    if mp == 1:
        return
    if proposal_name(args) == "full":
        ap.error("--strategy full is the per-example-gradient test oracle "
                 "and does not support --model-parallel; use ghost or "
                 "ghost_rev")
    if args.arch == "mlp_svhn" or args.serve_loop:
        return
    try:
        cfg = resolve_config(args)
    except KeyError:
        return              # the unknown arch is refused by parse_args
    specs = cfg.layer_specs()
    has_attn = any(sp.mixer == "attn" for sp in specs)
    has_ssm = any(sp.mixer == "mamba" for sp in specs)
    if has_attn and cfg.num_heads % mp:
        ap.error(f"--model-parallel {mp} does not divide num_heads="
                 f"{cfg.num_heads} of {cfg.name} (attention shards whole "
                 f"heads); pick a degree dividing num_heads or change the "
                 f"config's num_heads")
    if has_attn and cfg.attention == "gqa" and cfg.num_kv_heads % mp:
        ap.error(f"--model-parallel {mp} does not divide num_kv_heads="
                 f"{cfg.num_kv_heads} of {cfg.name} (K/V shard whole "
                 f"heads); pick a degree dividing num_kv_heads or change "
                 f"the config's num_kv_heads")
    if has_ssm and cfg.resolved_d_inner % mp:
        ap.error(f"--model-parallel {mp} does not divide d_inner="
                 f"{cfg.resolved_d_inner} of {cfg.name} (the selective "
                 f"scan is channel-parallel); pick a degree dividing "
                 f"d_inner (config field d_inner, default 2*d_model)")


def data_ranks(args: argparse.Namespace) -> int:
    """N, the data ranks of the world (``--mesh``, 1 when unset)."""
    return max(args.mesh, 1)


def check_mesh(args: argparse.Namespace) -> None:
    """``--mesh``'s and ``--model-parallel``'s refusals, as ValueErrors
    naming the flag, the count or the config field: a world the cards
    cannot hold, rows, shards or served chunks that do not split over the
    data ranks, and with ``--serve-loop`` a model-parallel degree that a
    present layer type's decode caches cannot split."""
    n = data_ranks(args)
    if args.examples % n:
        raise ValueError(f"--examples {args.examples} not divisible by "
                         f"--mesh {args.mesh}")
    if args.score_shards > 1 and args.score_shards % n:
        raise ValueError(f"--score-shards {args.score_shards} must be a "
                         f"multiple of --mesh {args.mesh}")
    if args.serve_loop:
        decode_cache_specs(resolve_config(args),
                           DataGroup(None, 0, args.model_parallel))
        chunks = args.examples // stream_chunk_size(args) + \
            serve_reserve_chunks(args)
        if chunks % n:
            raise ValueError(
                f"--serve-reserve-chunks {args.serve_reserve_chunks} leaves "
                f"{chunks} chunks, not divisible by --mesh {args.mesh}")
    mesh.check_world(n * args.model_parallel, args.device,
                     mesh.default_backend(args.device))


def profile_window(args: argparse.Namespace) -> tuple[int, int]:
    """(first step, step count) of the profiler window."""
    start, count = map(int, args.profile_steps.split(":"))
    return start, count


def proposal_name(args: argparse.Namespace) -> str:
    """--proposal-strategy, or --strategy when it is unset."""
    return args.proposal_strategy or args.strategy


def seq_shard(args: argparse.Namespace) -> bool:
    """Whether an LM's norms run sequence-parallel: under
    ``--model-parallel`` M > 1, unless ``--no-sequence-parallel``."""
    return args.model_parallel > 1 and args.sequence_parallel is not False


def score_row_block(args: argparse.Namespace) -> int:
    """The rows of one logical shard's scoring slice when W > 1, else 0:
    the MLP scorer multiplies that many rows at a time and an LM scorer
    scores that many rows a call, so that a rank holding some of the W
    shards scores them with the bits the one-device run gives them."""
    w = args.score_shards if args.score_shards > 1 else max(args.mesh, 1)
    sb = args.examples if args.mode == "exact" else args.score_batch
    return sb // w if w > 1 else 0


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
              attn_scores=None, ssm_mode: str = "ref", model_group=None):
    """(params, train data, per-example loss, scorer) of the MLP, which
    has neither attention nor mamba layers: ``attn_impl``,
    ``attn_scores`` and ``ssm_mode`` must keep their defaults.  The
    params are whole; the loss and the scorer take a ``model_group``'s
    shards."""
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
    return (params, train,
            lambda p, b: mlp_mod.per_example_loss(p, b, cfg,
                                                  model_group=model_group),
            make_proposal(make_mlp_scorer, cfg, proposal_name(args),
                          row_block=score_row_block(args),
                          model_group=model_group))


def build_lm(args: argparse.Namespace, cfg=None, attn_impl: str = "ref",
             attn_scores=None, ssm_mode: str = "ref", model_group=None):
    """(params, train data, per-example loss, scorer) of a transformer LM
    (``src/repro/launch/train.py::build_lm`` on one device).  The master's
    loss runs the ``attn_impl`` attention path and the scorer runs it with
    ``attn_scores``; the master never sees a score tap.  ``ssm_mode``
    reaches the scorer only: the master differentiates its loss, so its
    mamba layers scan with "ref", as in the reference.  With a
    ``model_group`` both run model-parallel on its shards, the norms
    sequence-parallel unless ``--no-sequence-parallel``."""
    device = torch.device(args.device)
    gen = _generator(device)
    cfg = resolve_config(args, cfg)
    train = make_token_dataset(gen(args.seed), n=args.examples,
                               seq=args.seq + 1, vocab=cfg.vocab_size)
    params = transformer.init_transformer(gen(args.seed + 1), cfg, device)
    sp = model_group is not None and seq_shard(args)
    pel = lambda p, b: transformer.per_example_loss(
        p, cfg, b, attn_impl=attn_impl, model_group=model_group,
        seq_shard=sp)[0]
    return params, train, pel, make_proposal(
        make_lm_scorer, cfg, proposal_name(args), ssm_mode=ssm_mode,
        attn_impl=attn_impl, attn_scores=attn_scores,
        row_block=score_row_block(args), model_group=model_group,
        seq_shard=sp)


def logical_specs(args: argparse.Namespace, cfg=None):
    """The logical axes of the arch's parameters (``dist/sharding.py``)."""
    cfg = resolve_config(args, cfg)
    if args.arch == "mlp_svhn":
        return mlp_mod.mlp_specs(cfg)
    return transformer.transformer_specs(cfg)


def fused_objective(args: argparse.Namespace, cfg=None,
                    model_group=None) -> Callable:
    """Fused mode's ``(params, batch) -> (losses, scores)``: one forward
    and the closed-form logit-grad norm of its head (model-parallel on a
    ``model_group``'s shards)."""
    cfg = resolve_config(args, cfg)
    if args.arch == "mlp_svhn":
        return lambda p, b: mlp_mod.per_example_loss_and_score(
            p, b, cfg, model_group=model_group)
    sp = model_group is not None and seq_shard(args)
    return lambda p, b: transformer.per_example_loss_and_score(
        p, cfg, b, model_group=model_group, seq_shard=sp)


def auto_chunk_size(n: int) -> int:
    """``--chunk-size 0``: the largest divisor of ``n`` that is at most an
    eighth of it (the reference's rule)."""
    return next(c for c in range(max(n // 8, 1), 0, -1) if n % c == 0)


def stream_chunk_size(args: argparse.Namespace) -> int:
    """The host chunk's rows: ``--chunk-size``, or the auto rule over one
    data rank's rows."""
    return args.chunk_size or auto_chunk_size(args.examples
                                              // data_ranks(args))


def serve_reserve_chunks(args: argparse.Namespace) -> int:
    """The zero chunks the serve loop reserves as traffic capacity."""
    return max(args.serve_reserve_chunks, 1) if args.serve_loop else 0


def build(args: argparse.Namespace, cfg=None, attn_impl: str = "ref",
          attn_scores=None, ssm_mode: str = "ref", telemetry=None,
          controller=None, group=None, model_group=None) -> Built:
    """(state, train_step, data, probe, pipe, serve) for ``args``: model,
    data, step and, in fused mode, the probe step (None otherwise).  With
    ``--monitors`` the step returns ``(state, metrics, monitors)``; with
    ``--adaptive-is`` it takes the gate, ``step(state, data, use_is)``.
    ``cfg`` overrides the arch's config (e.g. a cut depth); ``attn_impl``
    ("ref" or "flash") and ``attn_scores`` (None, "fused" or "separate")
    pick an LM's attention path, ``ssm_mode`` ("ref" or "pallas") its
    scorer's mamba scan (``build_lm``).

    With ``--async-scoring`` or ``--stream`` the step drives ``pipe``
    (an AsyncPipeline or a StreamedISSGD, built with ``telemetry`` and,
    under ``--adaptive-is``, the ``controller`` whose gate it reads; the
    step then ignores a passed gate), and ``--serve-loop`` adds
    ``serve``, whose ``ingest_into`` the loop calls after each step.
    A streamed run's ``data`` is None.

    With a data ``group`` (``--mesh``) the step, the probe and the
    pipelines are the sharded ones and ``data`` is this rank's rows (a
    streamed rank's host store holds its chunks alone); the state's
    store is still whole and on the host, for ``run`` to restore into
    and then keep this rank's rows (``shard_train_state``).  With a
    ``model_group`` (``--model-parallel``) the steps are the
    model-parallel ones and ``param_specs`` the params' spec tree; the
    state's params are still whole, for ``run`` to restore into and then
    keep this rank's shards."""
    use_full_f32()
    device = torch.device(args.device)
    builder = build_mlp if args.arch == "mlp_svhn" else build_lm
    params, train, pel, scorer = builder(args, cfg, attn_impl=attn_impl,
                                         attn_scores=attn_scores,
                                         ssm_mode=ssm_mode,
                                         model_group=model_group)
    specs = resolve_param_specs(logical_specs(args, cfg), params,
                                model_group, data_ranks(args))
    mp = dict(model_group=model_group, param_specs=specs)
    opt = sgd(args.lr)
    tcfg = ISSGDConfig(
        batch_size=args.batch, score_batch_size=args.score_batch,
        refresh_every=args.refresh_every, mode=args.mode,
        is_cfg=ISConfig(smoothing=args.smoothing,
                        staleness_threshold=args.staleness_threshold),
        score_shards=max(args.score_shards, 1), index=args.index,
        table_dtype=args.table_dtype, score_ttl=args.score_ttl,
        index_chunk_size=args.index_chunk_size)
    fused = (fused_objective(args, cfg, model_group)
             if args.mode == "fused" else None)
    monitors = MonitorSet.parse(args.monitors)
    state = init_train_state(params, opt, train.size, device, seed=args.seed,
                             table_dtype=args.table_dtype,
                             index_chunk_size=args.index_chunk_size,
                             store_device=device if group is None else "cpu")
    if args.stream:
        return _build_streamed(args, cfg, state, train, pel, scorer, opt,
                               tcfg, fused, monitors, telemetry, controller,
                               group, mp)
    data = shard_dataset(train.arrays, group)
    if args.async_scoring:
        *steps, tcfg = make_sharded_async_steps(
            pel, scorer, opt, tcfg, train.size, group,
            monitor_traces=not args.no_trace_monitors, monitors=monitors,
            gated=args.adaptive_is, **mp)
        _print_mesh(group, tcfg, model_group)
        print(f"async scoring, swap every {args.swap_every}", flush=True)
        pipe = AsyncPipeline(*steps, args.swap_every, telemetry=telemetry,
                             controller=controller)
        return Built(state._replace(store=to_buffered(state.store)),
                     _pipe_step(pipe), data, None, pipe, param_specs=specs)
    step, tcfg = make_sharded_train_step(
        pel, scorer, opt, tcfg, train.size, group, fused_score=fused,
        monitors=monitors, gated=args.adaptive_is, **mp)
    _print_mesh(group, tcfg, model_group)
    probe = (make_sharded_score_step(scorer, tcfg, train.size, group)
             if args.mode == "fused" else None)
    return Built(state, step, data, probe, param_specs=specs)


def _print_mesh(group, tcfg: ISSGDConfig, model_group=None) -> None:
    if group is None:
        return
    if model_group is None:
        print(f"mesh: ({group.size},) over {group.size} devices "
              f"({dist.get_backend(group.pg)}, {tcfg.score_shards} "
              f"scoring shards)", flush=True)
    else:
        n, m = group.size, model_group.size
        print(f"mesh: ({n}, {m}) (data, model) over {n * m} devices "
              f"({dist.get_backend(group.pg)}, {tcfg.score_shards} "
              f"scoring shards)", flush=True)


def _pipe_step(pipe) -> Callable:
    """``pipe.step`` in ``make_train_step``'s form: ``(state, metrics)``
    plus the monitors when the master computes them; a passed gate is the
    controller's, which the pipeline reads itself."""
    def step(state, data, use_is=None):
        state, metrics = pipe.step(state, data)
        if pipe.last_monitors is not None:
            return state, metrics, pipe.last_monitors
        return state, metrics
    return step


def _build_streamed(args, cfg, state, train, pel, scorer, opt, tcfg, fused,
                    monitors, telemetry, controller, group=None,
                    mp=None) -> Built:
    """The ``--stream`` half of ``build``: the host chunk store (pinned on
    the card; over a data group the rank's chunk range alone), the serve
    loop's reserved capacity, the plane and the StreamedISSGD driver.  The
    serve loop's batcher holds this rank's shards on a model group."""
    device = torch.device(args.device)
    n_live = train.size
    rank, world = axis_info(group)
    csize = stream_chunk_size(args)
    # the traffic capacity is laid out before the store is split
    store = ChunkedExampleStore.from_arrays(
        train.arrays, csize, pin_memory=device.type == "cuda",
        shard=(rank, world), reserve_chunks=serve_reserve_chunks(args))
    n_examples = n_live
    if args.serve_loop:
        n_examples = store.num_examples
        state = state._replace(store=reserve_tail(
            init_store(n_examples, device, table_dtype=args.table_dtype,
                       chunk_size=args.index_chunk_size), n_live))
    if args.async_scoring:
        state = state._replace(store=to_buffered(state.store))
    wc = max(1, min(args.window_chunks, len(store.held_chunks)))
    plane = StreamingDataPlane(store, wc, device=device, group=group)
    *steps, tcfg = make_sharded_streamed_steps(
        pel, scorer, opt, tcfg, n_examples, group, csize,
        fused_score=fused, async_mode=args.async_scoring,
        monitor_traces=not args.no_trace_monitors, monitors=monitors,
        gated=args.adaptive_is, **(mp or {}))
    _print_mesh(group, tcfg, (mp or {}).get("model_group"))
    pipe = StreamedISSGD(
        plane, *steps, tcfg, n_examples, async_mode=args.async_scoring,
        swap_every=args.swap_every, prefetch_every=args.prefetch_every,
        telemetry=telemetry, controller=controller)
    serve = None
    if args.serve_loop:
        scfg = resolve_config(args, cfg)
        serve_max_len = args.serve_prompt_len + args.serve_max_new
        mg = (mp or {}).get("model_group")
        params = state.params if mg is None else shard_tree(
            state.params, mp["param_specs"], mg.rank, mg.size)
        batcher = ContinuousBatcher(params, scfg,
                                    num_slots=args.serve_slots,
                                    max_len=serve_max_len,
                                    decode_kernel="pallas",
                                    attn_impl="pallas", model_group=mg)
        serve = ServeLoop(
            batcher,
            TrafficIngest(store, seq_len=args.seq + 1, start_row=n_live,
                          capacity_rows=n_examples - n_live),
            make_synthetic_traffic(scfg.vocab_size, args.serve_prompt_len,
                                   rate=args.serve_rate,
                                   max_new_tokens=args.serve_max_new,
                                   seed=args.seed + 7),
            publish_every=args.serve_publish_every or args.swap_every,
            serve_every=args.serve_every,
            decode_steps=args.serve_decode_steps, telemetry=telemetry,
            join=pipe.join)
        pipe.serve_tick = serve.on_train_step
        print(f"serve-loop: {args.serve_slots} slots, max_len "
              f"{serve_max_len}, {n_examples - n_live} reserved rows",
              flush=True)
    print(f"streaming: {store.num_chunks} chunks x {csize} rows "
          f"host-resident, window {wc} chunks/shard x {world} shard(s)"
          + (f", async swap every {args.swap_every}"
             if args.async_scoring else ""), flush=True)
    return Built(state, _pipe_step(pipe), None,
                 pipe.probe if args.mode == "fused" else None, pipe, serve,
                 (mp or {}).get("param_specs"))


def open_sink(args: argparse.Namespace, group=None):
    """The run's event sink (a NullSink without ``--metrics-jsonl``),
    tapped by the controller with ``--adaptive-is``; (sink, controller
    or None).  The run record carries the reference's keys.  Over a data
    ``group`` the controller applies rank 0's swap cadence
    (``rank0_cadence``)."""
    if args.metrics_jsonl:
        sink = EventSink(args.metrics_jsonl, run={
            "arch": args.arch, "mode": args.mode, "steps": args.steps,
            "mesh": args.mesh, "model_parallel": args.model_parallel,
            "async_scoring": args.async_scoring, "stream": args.stream,
            "serve_loop": args.serve_loop, "swap_every": args.swap_every,
            "monitors": list(MonitorSet.parse(args.monitors).names),
            "proposal_strategy": proposal_name(args),
            "adaptive_is": args.adaptive_is, "seed": args.seed,
            "device": args.device})
    else:
        sink = NullSink()
    ctl = None
    if args.adaptive_is:
        ctl = ProposalController(
            ControllerConfig(adapt_every=args.adapt_every,
                             adapt_swap=args.async_scoring),
            swap_every=args.swap_every,
            agree=(None if group is None
                   else rank0_cadence(group, args.device)))
        # the tap is truthy over a NullSink too: the metrics records the
        # controller folds keep coming, file or no file
        sink = ctl.attach(sink)
    return sink, ctl


def rank0_cadence(group, device) -> Callable[[int], int]:
    """The swap cadence every rank of ``group`` applies: rank 0's, which
    its JSONL records (each rank's controller times its own dispatches,
    while the gate folds replicated metrics and agrees by itself), by
    one all-reduce of rank 0's value against the others' zeros."""
    def agree(swap_every: int) -> int:
        mine = swap_every if group.rank == 0 else 0
        return int(psum(torch.tensor([mine], device=device), group).item())
    return agree


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
        attn_scores=None, ssm_mode: str = "ref",
        group=None, model_group=None) -> TrainResult:
    """Build from ``args`` (and ``cfg``, ``attn_impl``, ``attn_scores``,
    ``ssm_mode``, ``group``, see ``build``) and train, logging every
    ``--log-every`` steps and emitting telemetry records every
    ``--metrics-every``; restore before the loop and save after it when
    asked.  A step's time covers the train step, not the probe or the
    serve loop's ingest.  Everything a step logs (metrics and monitors)
    is read from the card in one transfer, on the logging steps only.
    With a data ``group`` this is one rank of the sharded run: it
    restores on the host and keeps its rows, as the reference restores
    before placement; with a ``model_group`` it then keeps its shards of
    the params, their stale copy and the optimizer state."""
    sink, ctl = open_sink(args, group)
    try:
        tel = Telemetry(sink, every=args.metrics_every or args.log_every,
                        blocking=args.telemetry_blocking)
        built = build(args, cfg, attn_impl=attn_impl,
                      attn_scores=attn_scores, ssm_mode=ssm_mode,
                      telemetry=tel, controller=ctl, group=group,
                      model_group=model_group)
        if args.restore_checkpoint:
            state, ck_step = restore_checkpoint(args.restore_checkpoint,
                                                built.state)
            built = built._replace(state=state)
            print(f"restored {args.restore_checkpoint} (step {ck_step})",
                  flush=True)
        if group is not None:
            built = built._replace(state=shard_train_state(
                built.state, group, torch.device(args.device),
                param_specs=built.param_specs, model_group=model_group))
        return _train_loop(args, built, sink, ctl, tel, group, model_group)
    finally:
        sink.close()


def _train_loop(args, built: Built, sink, ctl, tel, group=None,
                model_group=None) -> TrainResult:
    state, step, data, probe, pipe, serve, specs = built
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
        if serve is not None:
            # finished traffic lands in the store between steps
            state = serve.ingest_into(state)
        if probe is not None and i % args.probe_every == 0:
            state = probe(state, data)
        profile.after(i)
        log_now = i % args.log_every == 0 or i == args.steps - 1
        emit_now = bool(sink) and (tel.due(i) or i == args.steps - 1)
        if log_now or emit_now:
            if pipe is not None:
                pipe.join()     # the traces come from the scoring stream
            # ONE host transfer for everything this step logs
            vals = torch.stack(
                [getattr(m, k).double() for k in METRIC_KEYS]
                + [v.double() for v in mon.values()]).tolist()
            rec = {"step": i, **dict(zip(METRIC_KEYS, vals)),
                   "elapsed_s": round(time.time() - t0, 2)}
            mon_vals = {k: int(v) if k in INT_MONITORS else v
                        for k, v in zip(mon, vals[len(METRIC_KEYS):])}
            if isinstance(pipe, StreamedISSGD):
                rec["stream_hit_rate"] = round(pipe.plane.stats.hit_rate, 4)
            if serve is not None:
                rec["served_rows"] = int(serve.ingest.ingested)
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
                if pipe is not None:
                    pipe.swap_every = d.swap_every
                print(f"controller: step {i} use_is={d.use_is} "
                      f"swap_every={d.swap_every} reason={d.reason}",
                      flush=True)
    if pipe is not None:
        pipe.join()
    profile.stop(args.steps - 1)    # a window that ran past the end
    if on_cuda:
        torch.cuda.synchronize(args.device)
        step_ms = [s.elapsed_time(e) for s, e in marks]
    else:
        step_ms = [(e - s) * 1e3 for s, e in marks]
    if serve is not None:
        print(f"serve-loop: ingested {serve.ingest.ingested} rows "
              f"({serve.ingest.dropped} dropped, "
              f"{len(serve.batcher.finished)} requests finished)",
              flush=True)
    if isinstance(pipe, StreamedISSGD):
        st = pipe.plane.stats
        print(f"streaming stats: window hit rate {st.hit_rate:.3f} "
              f"({st.hits} hits / {st.misses} misses), "
              f"{st.streamed_rows} scoring rows streamed, "
              f"{st.swaps} window swaps", flush=True)
    if args.save_checkpoint:
        # over a data group every rank saves its rows, gather-free; over
        # a model group its chunks of the sharded leaves too
        save_checkpoint(args.save_checkpoint, state, step=state.step,
                        group=group, model_group=model_group,
                        shard_specs=(None if specs is None else
                                     train_state_specs(state, specs)))
        print(f"saved checkpoint to {args.save_checkpoint}", flush=True)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=2)
    end = {"steps": args.steps, "elapsed_s": round(time.time() - t0, 2)}
    if history:
        end["final_loss"] = history[-1]["loss"]
    if isinstance(pipe, StreamedISSGD):
        st = pipe.plane.stats
        end.update(stream_hit_rate=round(st.hit_rate, 4),
                   stream_window_swaps=st.swaps)
    if serve is not None:
        end.update(served_rows=int(serve.ingest.ingested),
                   served_dropped=int(serve.ingest.dropped))
    sink.emit("run_end", step=args.steps - 1, **end)
    return TrainResult(state, history, step_ms,
                       tuple(ctl.decisions) if ctl else (),
                       built._replace(state=state))


def _print_done(args: argparse.Namespace, result: TrainResult) -> None:
    if result.step_ms:
        clock = ("CUDA events" if torch.device(args.device).type == "cuda"
                 else "host clock")
        ms = result.step_ms
        q = statistics.quantiles(ms, n=4) if len(ms) > 1 else ms * 3
        print(f"done: {args.steps} steps on {args.device}, median step "
              f"{statistics.median(ms):.3f} ms (quartiles {q[0]:.3f}–"
              f"{q[2]:.3f}; {clock})", flush=True)


def _mesh_rank(group, device: str, args: argparse.Namespace,
               cfg=None, model_group=None) -> TrainResult:
    """One rank of ``--mesh``/``--model-parallel``: rank 0 alone prints
    and writes the metrics files and the profile; every rank takes part
    in the gather-free save of ``--save-checkpoint``, and under
    ``--adaptive-is`` every rank's controller folds the same replicated
    metrics to the same gate."""
    args = argparse.Namespace(**vars(args))
    args.device = device
    if group.rank or (model_group is not None and model_group.rank):
        sys.stdout = open(os.devnull, "w")
        args.metrics_out = args.metrics_jsonl = args.profile_dir = ""
    result = run(args, cfg, group=group, model_group=model_group)
    _print_done(args, result)
    return result


def main(argv=None, cfg=None) -> Optional[TrainResult]:
    """Parse ``argv`` and train.  ``--mesh 1`` runs its one rank in this
    process and returns its result, a larger world (``--mesh`` N times
    ``--model-parallel`` M ranks) spawns its ranks and returns None."""
    args = parse_args(argv)
    if args.mesh or args.model_parallel > 1:
        check_mesh(args)
        return mesh.run_world(_mesh_rank, data_ranks(args)
                              * args.model_parallel, args.device,
                              args=(args, cfg),
                              model_parallel=args.model_parallel)
    result = run(args, cfg)
    _print_done(args, result)
    return result


if __name__ == "__main__":
    main()
