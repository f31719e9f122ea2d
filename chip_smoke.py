#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. build   — compile the CUDA kernels from src/repro_torch/kernels/csrc
               (sm_90a) and print the build time and the card.
  2. kernels — each kernel against its plain PyTorch version on the card
               (f32 rtol 1e-5, atol 0: sums of up to 3072 squares taken in
               another order), against its exact-order emulator (bitwise),
               and multi-tap against chained single-tap launches (bitwise).
  3. main    — the paper's trainer through the port's entry point at full
               width (mlp_svhn 3072→2048×4→10, relaxed, ghost, 65,536
               resident examples); every logged loss and √TrΣ finite, the
               multi-tap kernel launched once per step, the plain versions
               never called.
  4. parity  — one scoring pass and one master step at full width on the
               card and on the CPU (plain versions) from the same params,
               data and injected sample indices; relative error ≤ 1e-4.
  5. times   — median step time (CUDA events), kernel vs plain time at the
               main-path shapes with the L2 cache cold, the byte bound, and
               a profiler breakdown of a few steps.
Then the kernels line, and last {"ok": true, "device": {...}}.
"""
from __future__ import annotations

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
# H100 SXM data sheet (hopper-kernels guide §1): HBM rate, f32 non-tensor peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2**20
SOURCE = "src/repro_torch/kernels/csrc/per_example_sqnorm.cu"
REPLACES = {
    "per_example_sqnorm_multi": "src/repro/kernels/per_example_sqnorm.py:128",
    "per_example_sqnorm": "src/repro/kernels/per_example_sqnorm.py:52",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
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


def phase_main(train_mod, pes, ref):
    """The trainer at full width through its entry point."""
    pes.per_example_sqnorm.launches = 0
    pes.per_example_sqnorm_multi.launches = 0

    def forbidden(*_a, **_k):
        raise AssertionError("a plain version ran on the CUDA path")

    saved = (ref.per_example_sqnorm_ref, ref.per_example_sqnorm_multi_ref)
    ref.per_example_sqnorm_ref = ref.per_example_sqnorm_multi_ref = forbidden
    torch.cuda.reset_peak_memory_stats()
    try:
        result = train_mod.main([
            "--arch", "mlp_svhn", "--mode", "relaxed", "--strategy", "ghost",
            "--batch", "64", "--score-batch", "256", "--examples", "65536",
            "--lr", "0.01", "--refresh-every", "8", "--steps",
            str(MAIN_STEPS), "--device", "cuda"])
    finally:
        ref.per_example_sqnorm_ref, ref.per_example_sqnorm_multi_ref = saved
    launches = {"per_example_sqnorm_multi":
                pes.per_example_sqnorm_multi.launches,
                "per_example_sqnorm": pes.per_example_sqnorm.launches}
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


def time_cold(fn, inputs, rounds=20) -> tuple[float, float]:
    """(device ms, wall ms) per call of fn(*inputs[i]), rotating over input
    sets larger than the L2 cache so every call finds its operands in
    device memory.  Device ms sums the durations of the CUDA kernels the
    profiler traced; wall ms comes from CUDA events around the unprofiled
    loop and includes the host's launch gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = rounds * len(inputs)

    def loop():
        for _ in range(rounds):
            for args in inputs:
                fn(*args)

    loop()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loop()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop()
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
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


def phase_profile(train_mod, steps=8):
    """Device time by kernel over a few steady full-width steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = train_mod.parse_args(["--examples", "65536", "--device", "cuda"])
    state, step, data = train_mod.build(args)
    for _ in range(3):
        state, _ = step(state, data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    if not by_name:
        print("profile: device time not measured (no CUDA events traced)",
              flush=True)
        return None
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    top = [{"kernel": k[:90], "us_per_step": round(us / steps, 2),
            "calls_per_step": c / steps} for k, (us, c) in top]
    print(f"profile: {steps} steps, device busy {device_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle share "
          f"{1 - device_ms / wall_ms:.3f}); top kernels "
          f"{json.dumps(top)}", flush=True)
    return {"steps": steps, "device_ms": device_ms, "wall_ms": wall_ms,
            "idle_share": 1 - device_ms / wall_ms, "top": top}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import per_example_sqnorm as pes
    from repro_torch.launch import train as train_mod

    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    train_mod.use_full_f32()
    t0 = time.perf_counter()
    lib = pes._lib()
    build_s = time.perf_counter() - t0
    log = _build.library_path("per_example_sqnorm").with_suffix(".log")
    ptxas = log.read_text().strip() if log.exists() else "(cached build)"
    print(f"build: per_example_sqnorm.cu in {build_s:.2f} s → {log.parent}"
          f"\n{ptxas}", flush=True)
    if lib.pes_threads() != ref.SQNORM_THREADS:
        fail(f"kernel block size {lib.pes_threads()} != emulator's "
             f"{ref.SQNORM_THREADS}")

    max_err = phase_kernels(pes, ref)
    counts_after_check = {"per_example_sqnorm": pes.per_example_sqnorm.launches,
                          "per_example_sqnorm_multi":
                          pes.per_example_sqnorm_multi.launches}
    launches, step_ms, peak_gib = phase_main(train_mod, pes, ref)
    errs = phase_parity()
    rows = phase_times(pes, ref)
    prof = phase_profile(train_mod)

    print("times " + json.dumps({
        "card": card, "build_s": build_s, "step_ms_median": step_ms,
        "steps": MAIN_STEPS, "warmup_steps": WARMUP_STEPS,
        "peak_mem_gib": peak_gib,
        "kernel_ms": rows, "library_ms": None,
        "library_note": "no single PyTorch call computes Σ‖x‖²‖d‖²",
        "card_vs_cpu_rel_err": errs, "profile": prof}), flush=True)
    kernels = []
    for name in ("per_example_sqnorm_multi", "per_example_sqnorm"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": rows[name]["ms"],
            "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"],
            "bound_by": rows[name]["bound_by"], "library_ms": None,
            "on_main_path": name == "per_example_sqnorm_multi",
            "phases": {"kernels": counts_after_check[name],
                       "main": launches[name]},
        })
    print(card, flush=True)   # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
