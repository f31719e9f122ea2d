"""falcon-mamba-7b [ssm] — 64L d_model=4096 attn-free d_ff=0 vocab=65024,
ssm_state=16, mamba-1 arch.  [arXiv:2410.05355]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1,            # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,                 # mamba blocks only, no FF sub-layer
    vocab_size=65024,
    attention="none",
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="falcon-mamba-7b-smoke", num_layers=2, d_model=256,
        vocab_size=512, ssm_state=8, d_inner=512, dtype="float32")
