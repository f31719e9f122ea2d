"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 1:7 interleave.
[arXiv:2403.19887]

Period structure (8 layers): attention at offset 4 of each block, MoE on
every other layer — matching the published interleave.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
    attn_every=8,
    attn_offset=4,
)


def smoke() -> ModelConfig:
    # 2-layer period preserving the family: l0 = mamba+MLP, l1 = attn+MoE
    return dataclasses.replace(
        CONFIG, name="jamba-v0.1-52b-smoke", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512,
        num_experts=4, num_experts_per_tok=2, ssm_state=8, d_inner=512,
        attn_every=2, attn_offset=1, moe_every=2, moe_offset=1,
        dtype="float32")
