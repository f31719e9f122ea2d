"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048, decoder-only over EnCodec tokens.  [arXiv:2306.05284]

The EnCodec/conditioning frontend is a STUB per the brief: input_specs()
provides `embeds` — precomputed conditioning-frame embeddings of shape
(B, num_frontend_tokens, d_model) prepended to the token stream.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    frontend="audio",
    num_frontend_tokens=64,   # text/melody conditioning stub
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-medium-smoke", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=8, d_ff=512, vocab_size=512,
        num_frontend_tokens=8, dtype="float32")
