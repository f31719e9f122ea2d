"""deepseek-7b [dense] — 30L d_model=4096 32H (MHA kv=32) d_ff=11008
vocab=102400, llama-arch.  [arXiv:2401.02954]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-7b-smoke", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=8, d_ff=512, vocab_size=512,
        dtype="float32")
