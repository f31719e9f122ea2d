#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. build    — compile every CUDA source of src/repro_torch/kernels/csrc
                (sm_90a), one nvcc per source, all started together; print
                each build time and the card.
  2. kernels  — the per-example squared-norm kernels against their plain
                PyTorch versions on the card (f32 rtol 1e-5, atol 0: sums
                of up to 3072 squares taken in another order), against
                their exact-order emulator (bitwise), and multi-tap against
                chained single-tap launches (bitwise).
  3. main     — the paper's trainer through the port's entry point at full
                width (mlp_svhn 3072→2048×4→10, relaxed, ghost, 65,536
                resident examples); every logged loss and √TrΣ finite, the
                multi-tap kernel launched once per step, the plain versions
                never called.
  4. parity   — one scoring pass and one master step of mlp_svhn at full
                width on the card and on the CPU (plain versions) from the
                same params, data and injected sample indices; relative
                error ≤ 1e-4.
  5. times    — median step time (CUDA events), kernel vs plain time at the
                main-path shapes with the L2 cache cold, the byte bound, and
                a profiler breakdown of a few steps.
  6. ghost    — the ghost-norm Gram kernel against its plain version on the
                card: the LM path's 8 tap shapes, S = 2048 (several tiles,
                the symmetric skip) and S = 100 (ragged), x/d types f32/f32,
                bf16/bf16 and bf16/f32, symmetric and not; tolerance
                GHOST_TOL × Σ_st |A_st·B_st| per row; two launches bitwise
                equal; the plain Gram against the direct plain version; the
                wrapper refuses bad input.
  7. lm main  — glm4-9b at full width, depth cut to 4 layers, relaxed,
                ghost, through the train entry point: losses and √TrΣ
                finite, ghost_norm called 8 times a step, its plain
                versions never; median step ms and peak memory.
  8. lm parity — glm4-9b at full width, 1 layer, float32: one scoring pass
                and one master step on the card and on the CPU (plain Gram)
                with injected sample indices; relative error ≤ 1e-4.
  9. lm times — ghost_norm vs its plain version (two cuBLAS bmm and a
                reduction) per main-path shape, L2 cold, CUDA events, beside
                the byte and operation bounds; a profiler breakdown of
                LM steps.
Then the card line, the kernels line, and last {"ok": true, "device": ...}.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# --- the main path's scoring shapes: five fc taps of mlp_svhn at B=256
MAIN_B = 256
MAIN_TAPS = ((3072, 2048), (2048, 2048), (2048, 2048), (2048, 2048),
             (2048, 10))
KERNEL_RTOL = 1e-5       # f32 sums of ≤3072 squares in another order
CARD_VS_CPU_RTOL = 1e-4  # full-width f32 matmuls on card vs CPU
MAIN_STEPS = 40
WARMUP_STEPS = 5
# H100 SXM data sheet (hopper-kernels guide §1): HBM rate, f32 non-tensor
# peak, dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2**20
SOURCES = {
    "per_example_sqnorm_multi":
        "src/repro_torch/kernels/csrc/per_example_sqnorm.cu",
    "per_example_sqnorm": "src/repro_torch/kernels/csrc/per_example_sqnorm.cu",
    "ghost_norm": "src/repro_torch/kernels/csrc/ghost_norm.cu",
}
REPLACES = {
    "per_example_sqnorm_multi": "src/repro/kernels/per_example_sqnorm.py:128",
    "per_example_sqnorm": "src/repro/kernels/per_example_sqnorm.py:52",
    "ghost_norm": "src/repro/kernels/ghost_norm.py:73",
}

# --- the LM path: glm4-9b at full width, depth cut to LM_LAYERS
LM_LAYERS = 4
LM_STEPS = 12
LM_WARMUP = 2
LM_ARGV = ["--arch", "glm4-9b", "--mode", "relaxed", "--strategy", "ghost",
           "--seq", "64", "--batch", "32", "--score-batch", "128",
           "--examples", "8192", "--lr", "0.01", "--refresh-every", "8",
           "--device", "cuda"]
LM_SB, LM_S = 128, 64
# its ghost_norm calls a step: (name, rows, S, din, dout); the layer taps
# cover P·B = 4·128 rows, the unembed B = 128 (glm4-9b: d_model 4096,
# 32 heads and 2 KV heads of 128, d_ff 13696, vocab 151552)
GHOST_MAIN = (
    ("wq", LM_LAYERS * LM_SB, LM_S, 4096, 4096),
    ("wk", LM_LAYERS * LM_SB, LM_S, 4096, 256),
    ("wv", LM_LAYERS * LM_SB, LM_S, 4096, 256),
    ("wo", LM_LAYERS * LM_SB, LM_S, 4096, 4096),
    ("w_in", LM_LAYERS * LM_SB, LM_S, 4096, 13696),
    ("w_gate", LM_LAYERS * LM_SB, LM_S, 4096, 13696),
    ("w_out", LM_LAYERS * LM_SB, LM_S, 13696, 4096),
    ("unembed", LM_SB, LM_S, 4096, 151552),
)
# f32 Gram sums over up to 151,552 features and S² (s, t) terms, taken in
# another order than cuBLAS's: the error of a row is held against the
# magnitude of the terms it sums, Σ_st |A_st·B_st| (equal to the value
# when there is no cancellation)
GHOST_TOL = 1e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_state() -> str:
    """SM clock, power draw and temperature now, as nvidia-smi gives them:
    sampled beside a timing window, since a card under load may run
    below its top clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_taps(b, widths, dtypes, seed, device="cuda"):
    """x ~ N(0,1) activations, d ~ N(0,1)·1e-2 gradients, as given dtypes."""
    g = torch.Generator(device=device).manual_seed(seed)
    xs, ds = [], []
    for (din, dout), (xt, dt) in zip(widths, dtypes):
        xs.append(torch.randn(b, din, generator=g, device=device).to(xt))
        ds.append((torch.randn(b, dout, generator=g, device=device)
                   * 1e-2).to(dt))
    return xs, ds


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a−b| over the largest |b| (per tensor)."""
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / scale if scale else 0.0


def phase_build(_build, card: str) -> dict:
    """Compile every csrc/*.cu, one nvcc each, all started together."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))

    def one(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(one, names)))
    for name in names:
        log = _build.library_path(name).with_suffix(".log")
        ptxas = log.read_text().strip() if log.exists() else "(cached build)"
        print(f"build: {name}.cu in {secs[name]:.2f} s on {card} → "
              f"{log.parent}\n{ptxas}", flush=True)
    return secs


def phase_kernels(pes, ref):
    """Kernel vs plain (rtol), vs emulator and multi vs chained (bitwise)."""
    f32, bf16 = torch.float32, torch.bfloat16
    n_main = len(MAIN_TAPS)
    ragged = ((3072, 2048), (2048, 10), (10, 3072))
    cases = [
        ("main", MAIN_B, MAIN_TAPS, ((f32, f32),) * n_main),
        ("ragged_f32", 257, ragged, ((f32, f32),) * 3),
        ("ragged_bf16", 257, ragged, ((bf16, bf16),) * 3),
        ("ragged_mixed", 257, ragged, ((bf16, f32), (f32, bf16), (bf16, f32))),
        ("33_taps", 17, ((40, 24),) * 33, ((f32, f32),) * 33),
    ]
    max_err = {"per_example_sqnorm": 0.0, "per_example_sqnorm_multi": 0.0}
    for ci, (name, b, widths, dtypes) in enumerate(cases):
        xs, ds = make_taps(b, widths, dtypes, seed=100 + ci)
        for with_bias in (True, False):
            tag = f"{name} with_bias={with_bias}"
            singles = []
            for t, (x, d) in enumerate(zip(xs, ds)):
                k = pes.per_example_sqnorm(x, d, with_bias=with_bias)
                p = ref.per_example_sqnorm_ref(x, d, with_bias=with_bias)
                e = ref.per_example_sqnorm_blocked(x, d, with_bias=with_bias)
                torch.cuda.synchronize()
                if not torch.allclose(k, p, rtol=KERNEL_RTOL, atol=0.0):
                    fail(f"per_example_sqnorm {tag} tap {t}: kernel vs "
                         f"plain rel err {rel_err(k, p):.3e}")
                if not torch.equal(k, e):
                    fail(f"per_example_sqnorm {tag} tap {t}: kernel != "
                         f"exact-order emulator")
                if name == "main":
                    max_err["per_example_sqnorm"] = max(
                        max_err["per_example_sqnorm"],
                        (k - p).abs().max().item())
                singles.append(k)
            km = pes.per_example_sqnorm_multi(xs, ds, with_bias=with_bias)
            pm = ref.per_example_sqnorm_multi_ref(xs, ds, with_bias=with_bias)
            em = ref.per_example_sqnorm_multi_blocked(xs, ds,
                                                      with_bias=with_bias)
            chained = singles[0]
            for s in singles[1:]:
                chained = chained + s
            torch.cuda.synchronize()
            if not torch.allclose(km, pm, rtol=KERNEL_RTOL, atol=0.0):
                fail(f"per_example_sqnorm_multi {tag}: kernel vs plain "
                     f"rel err {rel_err(km, pm):.3e}")
            if not torch.equal(km, chained):
                fail(f"per_example_sqnorm_multi {tag}: multi-tap != chained "
                     f"single-tap launches")
            if not torch.equal(km, em):
                fail(f"per_example_sqnorm_multi {tag}: kernel != "
                     f"exact-order emulator")
            if name == "main":
                max_err["per_example_sqnorm_multi"] = max(
                    max_err["per_example_sqnorm_multi"],
                    (km - pm).abs().max().item())
        print(f"kernels: {name} (B={b}, {len(widths)} taps) ok: plain "
              f"rtol {KERNEL_RTOL}, emulator and chained bitwise", flush=True)
    # the wrappers refuse what the kernel does not take
    x, d = make_taps(4, ((8, 8),), ((torch.float32, torch.float32),), 1)
    bad = {"float64": (x[0].double(), d[0]),
           "cpu tap": (x[0], d[0].cpu()),
           "non-contiguous": (x[0][:, ::2], d[0]),
           "batch mismatch": (x[0], d[0][:3])}
    for what, (bx, bd) in bad.items():
        try:
            pes.per_example_sqnorm(bx, bd)
        except (TypeError, ValueError):
            continue
        fail(f"per_example_sqnorm accepted a {what} input")
    print(f"kernels: wrappers refuse {', '.join(bad)}", flush=True)
    return max_err


def phase_main(train_mod, pes, gn, ref):
    """The trainer at full width through its entry point."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts(pes, gn)
    result = run_forbidding_plain(ref, lambda: train_mod.main([
        "--arch", "mlp_svhn", "--mode", "relaxed", "--strategy", "ghost",
        "--batch", "64", "--score-batch", "256", "--examples", "65536",
        "--lr", "0.01", "--refresh-every", "8", "--steps",
        str(MAIN_STEPS), "--device", "cuda"]))
    launches = read_counts(pes, gn)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches["per_example_sqnorm_multi"] != MAIN_STEPS:
        fail(f"per_example_sqnorm_multi launched "
             f"{launches['per_example_sqnorm_multi']} times in "
             f"{MAIN_STEPS} steps")
    keys = ("loss", "grad_norm", "trace_ideal", "trace_stale", "trace_unif")
    for rec in result.history:
        if not all(math.isfinite(rec[k]) for k in keys):
            fail(f"non-finite metrics at step {rec['step']}: {rec}")
    step_ms = statistics.median(result.step_ms[WARMUP_STEPS:])
    print(f"main: {MAIN_STEPS} steps, launches {launches}, loss "
          f"{result.history[0]['loss']:.4f} → {result.history[-1]['loss']:.4f}"
          f", median step {step_ms:.4f} ms, peak memory {peak_gib:.2f} GiB",
          flush=True)
    return launches, step_ms, peak_gib


def phase_parity():
    """One scoring pass + master step, card vs CPU, same inputs."""
    from repro_torch.configs.mlp_svhn import CONFIG as cfg
    from repro_torch.core.issgd import (ISSGDConfig, make_master_pass,
                                        make_scoring_pass)
    from repro_torch.core.scorer import make_mlp_scorer
    from repro_torch.core.weight_store import init_store
    from repro_torch.data import make_svhn_like
    from repro_torch.models.mlp import init_mlp_classifier, per_example_loss
    from repro_torch.optim import sgd, tree_leaves, tree_map

    n = 4096
    train, _ = make_svhn_like(torch.Generator("cuda").manual_seed(11), n=n,
                              dim=cfg.input_dim)
    params = init_mlp_classifier(torch.Generator().manual_seed(12), cfg,
                                 "cpu")
    idx = torch.randint(0, n, (64,),
                        generator=torch.Generator().manual_seed(13))
    tcfg = ISSGDConfig(batch_size=64, score_batch_size=256, refresh_every=8)
    opt = sgd(0.01)
    out = {}
    for dev in ("cuda", "cpu"):
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        p = tree_map(lambda t: t.to(dev), params)
        scoring = make_scoring_pass(make_mlp_scorer(cfg, "ghost"), tcfg, n)
        master = make_master_pass(
            lambda pp, b: per_example_loss(pp, b, cfg), opt, tcfg, n)
        store, fresh, stale = scoring(p, init_store(n, dev), 0, data)
        new_p, _, _, m = master(p, (), p, store, 0, None, data, fresh, stale,
                                sample_indices=idx)
        # the step's update new − old: compared alone, so that the shared
        # old params cannot hide a difference in the gradient
        deltas = tree_map(lambda a, b: a - b, new_p, p)
        out[dev] = {"scores": fresh, "loss": m.loss, "grad_norm": m.grad_norm,
                    **{f"update {i}": t for i, t in
                       enumerate(tree_leaves(deltas))}}
    errs = {}
    for key, ref_val in out["cpu"].items():
        card = out["cuda"][key].cpu()
        if key == "scores":    # elementwise: every score is positive
            errs[key] = ((card - ref_val).abs() / ref_val.abs()).max().item()
        else:
            errs[key] = rel_err(card, ref_val)
    worst = max(errs, key=errs.get)
    print(f"parity: card vs CPU at full width, largest relative error "
          f"{errs[worst]:.3e} ({worst}); scores {errs['scores']:.3e}, loss "
          f"{errs['loss']:.3e}, grad norm {errs['grad_norm']:.3e}", flush=True)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"card vs CPU: {worst} relative error {errs[worst]:.3e} > "
             f"{CARD_VS_CPU_RTOL}")
    return errs


def call_loop(fn, inputs, rounds):
    for _ in range(rounds):
        for args in inputs:
            fn(*args)


def time_events(fn, inputs, rounds):
    """ms per call of fn(*inputs[i]) from CUDA events around a warm loop
    that rotates over the input sets; includes the host's launch gaps."""
    call_loop(fn, inputs, rounds)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call_loop(fn, inputs, rounds)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * len(inputs))


def time_cold(fn, inputs, rounds=20):
    """(device ms, wall ms) per call of fn(*inputs[i]), rotating over input
    sets larger than the L2 cache so every call finds its operands in
    device memory.  Device ms sums the durations of the CUDA kernels the
    profiler traced; wall ms is ``time_events`` of the unprofiled loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = rounds * len(inputs)
    wall_ms = time_events(fn, inputs, rounds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call_loop(fn, inputs, rounds)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    if device_us <= 0:
        fail("the profiler traced no CUDA kernel time")
    return device_us / 1e3 / calls, wall_ms


def bound_ms(b, widths, elem_bytes=4):
    """Least time for the function: bytes (inputs once, f32[B] out once)
    over HBM rate vs 2 flops per input element over the f32 peak."""
    elems = b * sum(din + dout for din, dout in widths)
    t_bytes = (elems * elem_bytes + b * 4) / HBM_BYTES_PER_S
    t_ops = 2 * elems / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def phase_times(pes, ref):
    f32 = ((torch.float32, torch.float32),)
    sets_needed = lambda widths: max(
        2, math.ceil(4 * L2_BYTES / (4 * MAIN_B * sum(a + b for a, b in widths))))
    rows = {}
    for name, widths in (("per_example_sqnorm_multi", MAIN_TAPS),
                         ("per_example_sqnorm", MAIN_TAPS[:1])):
        inputs = [make_taps(MAIN_B, widths, f32 * len(widths), seed=500 + i)
                  for i in range(sets_needed(widths))]
        if name == "per_example_sqnorm_multi":
            kern = lambda xs, ds: pes.per_example_sqnorm_multi(xs, ds)
            plain = lambda xs, ds: ref.per_example_sqnorm_multi_ref(xs, ds)
        else:
            kern = lambda xs, ds: pes.per_example_sqnorm(xs[0], ds[0])
            plain = lambda xs, ds: ref.per_example_sqnorm_ref(xs[0], ds[0])
        # plain, kernel, kernel, plain: compare within one call, in turns
        (p1, pw1), (k1, kw1) = time_cold(plain, inputs), time_cold(kern, inputs)
        (k2, kw2), (p2, pw2) = time_cold(kern, inputs), time_cold(plain, inputs)
        bms, by = bound_ms(MAIN_B, widths)
        rows[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                      "bound_ms": bms, "bound_by": by,
                      "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
                      "wall_ms_runs": [kw1, kw2],
                      "plain_wall_ms_runs": [pw1, pw2]}
        us = lambda a, b: f"{a * 1e3:.2f}/{b * 1e3:.2f} us"
        print(f"times: {name} at B={MAIN_B} taps {list(widths)}, "
              f"{len(inputs)} input sets rotated (L2 cold): device "
              f"kernel {us(k1, k2)}, plain {us(p1, p2)}; wall kernel "
              f"{us(kw1, kw2)}, plain {us(pw1, pw2)}; bound "
              f"{bms * 1e3:.2f} us ({by})", flush=True)
    return rows


def phase_profile(train_mod, argv, cfg=None, steps=8, warm=3, tag="profile"):
    """Device time by kernel over a few steady steps of the run ``argv``
    (with the config override ``cfg``) builds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = train_mod.parse_args(argv)
    state, step, data = train_mod.build(args, cfg)
    for _ in range(warm):
        state, _ = step(state, data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = card_state()
    del state, step, data
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    if not by_name:
        print(f"{tag}: device time not measured (no CUDA events traced)",
              flush=True)
        return None
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    top = [{"kernel": k[:90], "us_per_step": round(us / steps, 2),
            "calls_per_step": c / steps} for k, (us, c) in top]
    print(f"{tag}: {steps} steps, device busy {device_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle share "
          f"{1 - device_ms / wall_ms:.3f}); clock, power, temperature "
          f"after: {after}; top kernels {json.dumps(top)}", flush=True)
    return {"steps": steps, "device_ms": device_ms, "wall_ms": wall_ms,
            "idle_share": 1 - device_ms / wall_ms, "card_after": after,
            "top": top}


# ------------------------------------------------------------ the LM path
def lm_config():
    """glm4-9b at its published widths, depth cut to LM_LAYERS."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("glm4-9b"), num_layers=LM_LAYERS)


def gram_inputs(rows, s, din, dout, x_dtype, d_dtype, seed):
    """x ~ N(0,1) activations, d ~ N(0,1)·1e-2 cotangents on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, s, din, generator=g, device="cuda").to(x_dtype)
    d = (torch.randn(rows, s, dout, generator=g, device="cuda")
         * 1e-2).to(d_dtype)
    return x, d


def gram_error(k, x, d):
    """(largest |kernel − plain| over Σ_st |A_st·B_st|, plain, largest
    absolute difference) for one call's rows."""
    xf, df = x.float(), d.float()
    ga = torch.einsum("bsk,btk->bst", xf, xf)
    gb = torch.einsum("bsk,btk->bst", df, df)
    plain = torch.sum(ga * gb, dim=(1, 2))
    mag = torch.sum((ga * gb).abs(), dim=(1, 2))
    diff = (k - plain).abs()
    return (diff / mag).max().item(), plain, diff.max().item()


def phase_ghost_kernels(gn, ref):
    """The ghost-norm Gram kernel against its plain version."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []   # (tag, rows, S, din, dout, x dtype, d dtype)
    seen = set()
    for name, rows, s, din, dout in GHOST_MAIN:
        if (rows, s, din, dout) not in seen:       # wq = wo, wk = wv, ...
            seen.add((rows, s, din, dout))
            cases.append((f"main {name}", rows, s, din, dout, bf16, f32))
    for xt, dt in ((f32, f32), (bf16, bf16), (bf16, f32)):
        types = f"{str(xt)[6:]}/{str(dt)[6:]}"
        cases += [(f"S=2048 {types}", 2, 2048, 4096, 256, xt, dt),
                  (f"S=2048 {types}", 2, 2048, 4096, 4096, xt, dt),
                  (f"S=100 {types}", 16, 100, 4096, 256, xt, dt),
                  (f"S=100 ragged widths {types}", 8, 100, 300, 77, xt, dt)]
    max_abs = 0.0
    for ci, (tag, rows, s, din, dout, xt, dt) in enumerate(cases):
        x, d = gram_inputs(rows, s, din, dout, xt, dt, seed=700 + ci)
        worst = 0.0
        for symmetric in (True, False):
            k1 = gn.ghost_norm(x, d, symmetric=symmetric)
            k2 = gn.ghost_norm(x, d, symmetric=symmetric)
            torch.cuda.synchronize()
            if not torch.equal(k1, k2):
                fail(f"ghost_norm {tag} {(rows, s, din, dout)} symmetric="
                     f"{symmetric}: two launches differ")
            err, plain, abs_err = gram_error(k1, x, d)
            if not torch.allclose(plain, ref.ghost_norm_ref(x, d),
                                  rtol=1e-5, atol=0):
                fail(f"ghost_norm {tag}: the check's Gram != ghost_norm_ref")
            if err > GHOST_TOL:
                fail(f"ghost_norm {tag} {(rows, s, din, dout)} symmetric="
                     f"{symmetric}: kernel vs plain error {err:.3e} of "
                     f"Σ|A·B| > {GHOST_TOL}")
            worst = max(worst, err)
            if tag.startswith("main"):
                max_abs = max(max_abs, abs_err)
        print(f"ghost: {tag} (R={rows}, S={s}, {din}→{dout}) ok: symmetric "
              f"and not, error ≤ {worst:.2e} of Σ|A·B|, two launches "
              f"bitwise equal", flush=True)
        del x, d
    # the two plain versions agree (the direct one materializes din·dout)
    x, d = gram_inputs(8, 100, 300, 77, f32, f32, seed=690)
    a, b = ref.ghost_norm_ref(x, d), ref.ghost_norm_direct_ref(x, d)
    if not torch.allclose(a, b, rtol=1e-4, atol=0):
        fail(f"ghost_norm_ref vs ghost_norm_direct_ref: rel err "
             f"{rel_err(a, b):.3e}")
    # the wrapper refuses what the kernel does not take
    x, d = gram_inputs(2, 8, 16, 8, f32, f32, seed=691)
    bad = {"float64": (x.double(), d), "cpu d": (x, d.cpu()),
           "non-contiguous": (x[:, :, ::2], d),
           "S mismatch": (x, d[:, :7].contiguous()),
           "rows mismatch": (x, d[:1]), "2-D": (x[0], d[0])}
    before = gn.ghost_norm.launches
    for what, (bx, bd) in bad.items():
        try:
            gn.ghost_norm(bx, bd)
        except (TypeError, ValueError):
            continue
        fail(f"ghost_norm accepted a {what} input")
    if gn.ghost_norm.launches != before:
        fail("a refused ghost_norm call counted a launch")
    print(f"ghost: plain Gram == direct (rtol 1e-4); wrapper refuses "
          f"{', '.join(bad)}", flush=True)
    return max_abs


def reset_counts(pes, gn) -> None:
    pes.per_example_sqnorm.launches = 0
    pes.per_example_sqnorm_multi.launches = 0
    gn.ghost_norm.launches = 0


def read_counts(pes, gn) -> dict:
    return {"per_example_sqnorm_multi": pes.per_example_sqnorm_multi.launches,
            "per_example_sqnorm": pes.per_example_sqnorm.launches,
            "ghost_norm": gn.ghost_norm.launches}


PLAIN_NAMES = ("per_example_sqnorm_ref", "per_example_sqnorm_multi_ref",
               "ghost_norm_ref", "ghost_norm_direct_ref")


def run_forbidding_plain(ref, fn):
    """fn() with every plain version replaced by one that raises."""
    def forbidden(*_a, **_k):
        raise AssertionError("a plain version ran on the CUDA path")
    saved = {n: getattr(ref, n) for n in PLAIN_NAMES}
    for n in PLAIN_NAMES:
        setattr(ref, n, forbidden)
    try:
        return fn()
    finally:
        for n, f in saved.items():
            setattr(ref, n, f)


def phase_lm_main(train_mod, pes, gn, ref):
    """glm4-9b at full width (depth cut) through the train entry point."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(pes, gn)
    result = run_forbidding_plain(ref, lambda: train_mod.main(
        LM_ARGV + ["--steps", str(LM_STEPS), "--log-every", "1"],
        lm_config()))
    launches = read_counts(pes, gn)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches["ghost_norm"] != len(GHOST_MAIN) * LM_STEPS:
        fail(f"ghost_norm called {launches['ghost_norm']} times in "
             f"{LM_STEPS} LM steps; expected {len(GHOST_MAIN)} a step")
    keys = ("loss", "grad_norm", "trace_ideal", "trace_stale", "trace_unif")
    for rec in result.history:
        if not all(math.isfinite(rec[k]) for k in keys):
            fail(f"non-finite LM metrics at step {rec['step']}: {rec}")
    step_ms = statistics.median(result.step_ms[LM_WARMUP:])
    hist = result.history
    del result
    torch.cuda.empty_cache()
    print(f"lm main: glm4-9b × {LM_LAYERS} layers, {LM_STEPS} steps, "
          f"launches {launches}, loss {hist[0]['loss']:.4f} → "
          f"{hist[-1]['loss']:.4f}, median step {step_ms:.3f} ms (CUDA "
          f"events, {LM_WARMUP} warm-up), peak memory {peak_gib:.2f} GiB",
          flush=True)
    return launches, step_ms, peak_gib, hist


def phase_lm_parity():
    """One LM scoring pass + master step at full width, card vs CPU."""
    from repro_torch.core.issgd import (ISSGDConfig, make_master_pass,
                                        make_scoring_pass)
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.core.weight_store import init_store
    from repro_torch.data import make_token_dataset
    from repro_torch.models.transformer import (init_transformer,
                                                per_example_loss)
    from repro_torch.optim import sgd, tree_leaves, tree_map

    cfg = dataclasses.replace(lm_config(), num_layers=1, dtype="float32")
    n, sb, b, seq = 64, 4, 2, 64
    train = make_token_dataset(torch.Generator("cuda").manual_seed(21), n=n,
                               seq=seq + 1, vocab=cfg.vocab_size)
    params = init_transformer(torch.Generator("cuda").manual_seed(22), cfg,
                              "cuda")
    idx = torch.randint(0, n, (b,), generator=torch.Generator().manual_seed(23))
    tcfg = ISSGDConfig(batch_size=b, score_batch_size=sb, refresh_every=8)
    # lr 1: the update new − old stands far above the f32 rounding of the
    # params themselves, so comparing it compares the gradients
    opt = sgd(1.0)
    out = {}
    for dev in ("cuda", "cpu"):
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        p = tree_map(lambda t: t.to(dev), params)
        scoring = make_scoring_pass(make_lm_scorer(cfg, "ghost"), tcfg, n)
        master = make_master_pass(
            lambda pp, bb: per_example_loss(pp, cfg, bb)[0], opt, tcfg, n)
        t0 = time.perf_counter()
        store, fresh, stale = scoring(p, init_store(n, dev), 0, data)
        new_p, _, _, m = master(p, (), p, store, 0, None, data, fresh, stale,
                                sample_indices=idx)
        deltas = tree_map(lambda a, c: (a - c).cpu(), new_p, p)
        out[dev] = {"scores": fresh.cpu(), "loss": m.loss.cpu(),
                    "grad_norm": m.grad_norm.cpu(),
                    **{f"update {i}": t for i, t in
                       enumerate(tree_leaves(deltas))}}
        print(f"lm parity: {dev} pass in {time.perf_counter() - t0:.1f} s",
              flush=True)
        del p, new_p, deltas, data
    errs = {}
    for key, ref_val in out["cpu"].items():
        card = out["cuda"][key]
        if key == "scores":    # elementwise: every score is positive
            errs[key] = ((card - ref_val).abs() / ref_val.abs()).max().item()
        else:
            errs[key] = rel_err(card, ref_val)
    worst = max(errs, key=errs.get)
    print(f"lm parity: glm4-9b full width, 1 layer, f32, card (CUDA Gram "
          f"kernel) vs CPU (plain Gram): largest relative error "
          f"{errs[worst]:.3e} ({worst}); scores {errs['scores']:.3e}, loss "
          f"{errs['loss']:.3e}, grad norm {errs['grad_norm']:.3e}",
          flush=True)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"LM card vs CPU: {worst} relative error {errs[worst]:.3e} > "
             f"{CARD_VS_CPU_RTOL}")
    del params
    torch.cuda.empty_cache()
    return errs


def ghost_bounds(rows, s, din, dout):
    """(bytes ms, operations ms) of ghost_norm on bf16 x and f32 d: inputs
    read once and f32[R] written once over the HBM rate; the operations
    are the two symmetric Grams, S(S+1)·width flops a row each (S(S+1)/2
    entries of one multiply-add per feature): the bf16 x Gram over the
    bf16 tensor-core peak, where it is exact, plus the f32 d Gram over
    the f32 peak."""
    nbytes = rows * s * (din * 2 + dout * 4) + rows * 4
    x_flops = float(s * (s + 1) * din * rows)
    d_flops = float(s * (s + 1) * dout * rows)
    ops_s = x_flops / BF16_TC_FLOP_PER_S + d_flops / F32_FLOP_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3


def phase_ghost_times(gn, ref, rounds=5):
    """ghost_norm vs its plain version at each main-path shape.  Every
    input set is larger than the L2 cache, so one set keeps calls cold.

    Each call keeps the card busy for 0.3 ms or more while the host
    enqueues the next in far less, so CUDA events around a loop of calls
    give the device time.  (The profiler's kernel sum is not used here:
    it has dropped records of these long kernels.)"""
    rows_out = {}
    for name, rows, s, din, dout in GHOST_MAIN:
        if any(r["shape"] == [rows, s, din, dout] for r in rows_out.values()):
            rows_out[name] = next(r for r in rows_out.values()
                                  if r["shape"] == [rows, s, din, dout])
            continue
        x, d = gram_inputs(rows, s, din, dout, torch.bfloat16, torch.float32,
                           seed=800)
        if x.numel() * 2 + d.numel() * 4 < 2 * L2_BYTES:
            fail(f"ghost times {name}: inputs fit in L2")
        kern = lambda a, b: gn.ghost_norm(a, b, symmetric=True)
        plain = lambda a, b: ref.ghost_norm_ref(a, b)
        args = [(x, d)]
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = time_events(plain, args, rounds)
        k1 = time_events(kern, args, rounds)
        k2 = time_events(kern, args, rounds)
        p2 = time_events(plain, args, rounds)
        b_ms, o_ms = ghost_bounds(rows, s, din, dout)
        rows_out[name] = {
            "shape": [rows, s, din, dout], "ms": min(k1, k2),
            "plain_ms": min(p1, p2), "bytes_ms": b_ms, "ops_ms": o_ms,
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
        print(f"lm times: ghost_norm {name} (R={rows}, S={s}, {din}→{dout}, "
              f"bf16 x, f32 d, L2 cold): CUDA events kernel "
              f"{k1 * 1e3:.1f}/{k2 * 1e3:.1f} us, plain (2 bmm + reduce) "
              f"{p1 * 1e3:.1f}/{p2 * 1e3:.1f} us; bound bytes "
              f"{b_ms * 1e3:.1f} us, ops (bf16 x Gram on tensor cores, f32 "
              f"d Gram) {o_ms * 1e3:.1f} us", flush=True)
        del x, d
    step = {k: sum(r[k] for r in rows_out.values())
            for k in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
    step["card_after"] = card_state()
    print(f"lm times: ghost_norm per LM step ({len(GHOST_MAIN)} calls): "
          f"kernel {step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, "
          f"bound bytes {step['bytes_ms']:.3f} ms, ops "
          f"{step['ops_ms']:.3f} ms; clock, power, temperature after: "
          f"{step['card_after']}", flush=True)
    return rows_out, step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.kernels import per_example_sqnorm as pes
    from repro_torch.kernels import ref
    from repro_torch.launch import train as train_mod

    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    train_mod.use_full_f32()
    build_s = phase_build(_build, card)
    lib = pes._lib()
    if lib.pes_threads() != ref.SQNORM_THREADS:
        fail(f"kernel block size {lib.pes_threads()} != emulator's "
             f"{ref.SQNORM_THREADS}")
    gn._lib()

    max_err = phase_kernels(pes, ref)
    max_err["ghost_norm"] = phase_ghost_kernels(gn, ref)
    counts_after_check = read_counts(pes, gn)
    launches, step_ms, peak_gib = phase_main(train_mod, pes, gn, ref)
    errs = phase_parity()
    rows = phase_times(pes, ref)
    prof = phase_profile(train_mod, ["--examples", "65536",
                                     "--device", "cuda"])
    lm_launches, lm_step_ms, lm_peak, lm_hist = phase_lm_main(
        train_mod, pes, gn, ref)
    lm_errs = phase_lm_parity()
    ghost_rows, ghost_step = phase_ghost_times(gn, ref)
    lm_prof = phase_profile(train_mod, LM_ARGV, lm_config(), steps=3,
                            warm=2, tag="lm profile")

    print("times " + json.dumps({
        "card": card, "build_s": build_s, "step_ms_median": step_ms,
        "steps": MAIN_STEPS, "warmup_steps": WARMUP_STEPS,
        "peak_mem_gib": peak_gib,
        "kernel_ms": rows, "library_ms": None,
        "library_note": "no single PyTorch call computes Σ‖x‖²‖d‖²",
        "card_vs_cpu_rel_err": errs, "profile": prof}), flush=True)
    print("lm times " + json.dumps({
        "card": card, "arch": "glm4-9b", "layers": LM_LAYERS,
        "argv": LM_ARGV, "steps": LM_STEPS, "warmup_steps": LM_WARMUP,
        "step_ms_median": lm_step_ms, "peak_mem_gib": lm_peak,
        "losses": [r["loss"] for r in lm_hist],
        "ghost_norm_ms": ghost_rows, "ghost_norm_per_step": ghost_step,
        "library_ms": None,
        "library_note": "no single PyTorch call computes <XXᵀ, DDᵀ>; the "
                        "plain version is two cuBLAS bmm and a reduction",
        "card_vs_cpu_rel_err": lm_errs, "profile": lm_prof}), flush=True)
    main_counts = {"per_example_sqnorm_multi": launches,
                   "per_example_sqnorm": launches,
                   "ghost_norm": lm_launches}
    timing = dict(rows)
    # ghost_norm: the work of one LM step, its 8 calls
    timing["ghost_norm"] = {
        "ms": ghost_step["ms"], "plain_ms": ghost_step["plain_ms"],
        "bound_ms": max(ghost_step["bytes_ms"], ghost_step["ops_ms"]),
        "bound_by": ("bytes" if ghost_step["bytes_ms"] >= ghost_step["ops_ms"]
                     else "operations")}
    kernels = []
    for name in ("per_example_sqnorm_multi", "per_example_sqnorm",
                 "ghost_norm"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": main_counts[name][name],
            "max_abs_err": max_err[name], "ms": timing[name]["ms"],
            "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"],
            "bound_by": timing[name]["bound_by"], "library_ms": None,
            "on_main_path": name != "per_example_sqnorm",
            "timed": ("the 8 calls of one LM step" if name == "ghost_norm"
                      else "one call at the MLP main-path shapes"),
            "phases": {"kernels": counts_after_check[name],
                       "main_mlp": launches[name],
                       "main_lm": lm_launches[name]},
        })
    print(card, flush=True)   # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
