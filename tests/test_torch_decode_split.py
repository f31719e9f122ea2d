"""The bf16 flash-decode kernel's arithmetic, argued on the CPU, and the
decode runner that the serving launcher replays on the card.

``decode_tc`` (``kernels/csrc/decode_attention.cu``) runs q·kᵀ and p·v on
the bf16 tensor cores (``mma.sync``) with f32 accumulation: the scale
after the product, an online softmax in base 2, P split in two bf16 parts,
each warp over its own 16-slot tiles, the warps of a block merged in order,
then the splits in order.  ``ref.decode_attention_split_emulation``
repeats that arithmetic and partition; these tests hold it to the plain
version (``ref.decode_attention_kernel_ref``) and to the JAX package's
Pallas kernel in interpret mode at the tolerance ``chip_smoke.py`` holds
the kernel to (rtol 2⁻⁷, atol 1e-5: two f32 results that differ in their
last bits may round to neighbouring bf16 outputs, one bf16 ulp apart), over
the splits the wrapper picks for a 132-SM card and for 3 SMs (fewer, longer
ranges: several tiles a warp).  A CUDA leg (skipped without a card) holds
the kernel to both.

``serving.engine.make_decode_runner`` captures the decode step in a CUDA
graph on the card and runs it eagerly on the CPU; the CPU case checks that
N steps through it equal N ``decode_step`` calls, and the launch-count
bookkeeping it uses on the card.

Inputs are numpy N(0,1) draws from a seed, rounded to bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import \
    decode_attention as j_decode_kernel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.transformer import init_transformer  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ATTN_BF16 = dict(rtol=2 ** -7, atol=1e-5)

# (tag, B, S, H, Hkv, hd, lengths): rep 16 (glm4-9b's heads), rep 6
# (internlm2-20b), rep 1 (MHA, deepseek-7b), hd 32 and 64, a ragged ring;
# rows of length 0 and 1 among them
CASES = [
    ("rep 16", 4, 300, 32, 2, 128, [0, 1, 300, 177]),
    ("rep 6", 2, 200, 48, 8, 128, [199, 64]),
    ("rep 1", 2, 200, 32, 32, 128, [200, 5]),
    ("hd 32", 4, 40, 8, 2, 32, [0, 1, 40, 17]),
    ("hd 64", 2, 64, 4, 1, 64, [64, 0]),
    ("ragged ring", 3, 100, 32, 2, 128, [100, 37, 0]),
]
IDS = [c[0] for c in CASES]


def _inputs(b, s, h, hkv, hd, seed):
    """bf16 q, k, v from numpy N(0,1) draws, and their f32 numpy values."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]
    tensors = [torch.from_numpy(a).bfloat16() for a in arrays]
    return tensors, [t.float().numpy() for t in tensors]


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), **ATTN_BF16)


@pytest.mark.parametrize("num_sms", [132, 3])
@pytest.mark.parametrize("tag,b,s,h,hkv,hd,lens", CASES, ids=IDS)
def test_emulation_meets_the_card_tolerance(tag, b, s, h, hkv, hd, lens,
                                            num_sms):
    (q, k, v), _ = _inputs(b, s, h, hkv, hd, seed=s + h)
    lengths = torch.tensor(lens, dtype=torch.int32)
    chunk, n_split = da.split_plan(b, hkv, s, num_sms)
    got = ref.decode_attention_split_emulation(q, k, v, lengths, chunk)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, ref.decode_attention_kernel_ref(q, k, v, lengths))
    zero = [i for i, n in enumerate(lens) if n == 0]
    assert not got[zero].any()


@pytest.mark.parametrize("tag,b,s,h,hkv,hd,lens", CASES, ids=IDS)
def test_emulation_matches_the_pallas_kernel(tag, b, s, h, hkv, hd, lens):
    """Against the JAX package's kernel in interpret mode, from the same
    bf16 inputs; length-0 rows are zeros in both."""
    (q, k, v), arrays = _inputs(b, s, h, hkv, hd, seed=s + h)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    want = j_decode_kernel(jq, jk, jv, jnp.asarray(lens, jnp.int32),
                           interpret=True)
    chunk, _ = da.split_plan(b, hkv, s, 132)
    got = ref.decode_attention_split_emulation(
        q, k, v, torch.tensor(lens, dtype=torch.int32), chunk)
    _close(got, torch.from_numpy(np.array(want.astype(jnp.float32))))


def test_emulation_takes_the_kernels_partition():
    """Partitions from 32-slot ranges (ten splits, at most one tile a
    warp) to one 320-slot range (several tiles a warp, no split merge)
    agree within the tolerance."""
    (q, k, v), _ = _inputs(4, 300, 32, 2, 128, seed=5)
    lengths = torch.tensor([300, 299, 150, 17], dtype=torch.int32)
    outs = [ref.decode_attention_split_emulation(q, k, v, lengths, chunk)
            for chunk in (32, 96, 320)]
    for got in outs[1:]:
        _close(got, outs[0])


def _cuda_inputs(b, s, h, hkv, hd, lens, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python3 chip_smoke.py)")
    (q, k, v), _ = _inputs(b, s, h, hkv, hd, seed)
    return ([t.cuda() for t in (q, k, v)],
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("tag,b,s,h,hkv,hd,lens", CASES, ids=IDS)
def test_cuda_tensor_core_kernel_matches_emulation_and_plain(
        tag, b, s, h, hkv, hd, lens):
    (q, k, v), lengths = _cuda_inputs(b, s, h, hkv, hd, lens, seed=s + h)
    tc_before = da.decode_attention.tc_launches
    got = da.decode_attention(q, k, v, lengths)
    assert da.decode_attention.tc_launches == tc_before + 1
    chunk, _ = da.split_plan(b, hkv, s, da._num_sms(q.device.index))
    _close(got, ref.decode_attention_split_emulation(q, k, v, lengths, chunk))
    _close(got, ref.decode_attention_kernel_ref(q, k, v, lengths))
    assert torch.equal(got, da.decode_attention(q, k, v, lengths))


# ------------------------------------------------------ the decode runner
@pytest.fixture(scope="module")
def smoke_model():
    cfg = configs.get_smoke_config("glm4-9b")
    params = init_transformer(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, params


@pytest.mark.parametrize("kernel", ["pallas", "ref"])
def test_runner_steps_equal_decode_steps_on_cpu(smoke_model, kernel):
    """N steps through the runner give the logits, lengths and caches of N
    ``decode_step`` calls from the same prefill (teacher-forced tokens)."""
    cfg, params = smoke_model
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 12 + 4)).astype(np.int32))
    with torch.no_grad():
        _, st_a = engine.prefill(params, cfg, toks[:, :12], 24)
        _, st_b = engine.prefill(params, cfg, toks[:, :12], 24)
        runner = engine.make_decode_runner(params, cfg, st_b,
                                           decode_kernel=kernel)
        for i in range(4):
            want, st_a = engine.decode_step(params, cfg, toks[:, 12 + i],
                                            st_a, decode_kernel=kernel)
            got, st_b = runner(toks[:, 12 + i])
            assert torch.equal(got, want), i
    assert st_b.lengths.tolist() == [16] * 3
    assert torch.equal(st_b.lengths, st_a.lengths)
    for name, buf in st_a.caches.items():
        assert torch.equal(st_b.caches[name], buf), name


def test_runner_refuses_an_unknown_kernel_route(smoke_model):
    cfg, params = smoke_model
    st = engine.init_serve_state(cfg, 2, 8, "cpu")
    with pytest.raises(ValueError, match="decode_kernel"):
        engine.make_decode_runner(params, cfg, st, decode_kernel="triton")


def test_launch_counts_take_back_and_replay():
    """The counters a graph replay adds: every wrapper's ``launches`` (and
    ``tc_launches`` / ``scored`` where kept), moved by a delta and back."""
    before = ops.launch_counts()
    names = {(fn.__name__, name) for fn, name in before}
    assert ("decode_attention", "tc_launches") in names
    assert ("flash_attention_bwd", "scored") in names
    assert ("selective_scan", "launches") in names
    delta = {key: 3 for key in before}
    ops.add_launch_counts(delta)
    assert all(ops.launch_counts()[k] == v + 3 for k, v in before.items())
    ops.add_launch_counts({k: -n for k, n in delta.items()})
    assert ops.launch_counts() == before
