"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/SigLIP vision tower + projector is a STUB per the brief:
input_specs() provides `embeds` — anyres patch embeddings of shape
(B, num_frontend_tokens, d_model) prepended to the text tokens.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    num_frontend_tokens=2880,  # anyres: base 576 + 4 tiles × 576
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-next-34b-smoke", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512,
        num_frontend_tokens=16, dtype="float32")
