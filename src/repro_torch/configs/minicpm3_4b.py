"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448, MLA.
[hf:openbmb/MiniCPM3-4B]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="minicpm3-4b-smoke", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=8, d_ff=512, vocab_size=512,
        q_lora_rank=96, kv_lora_rank=64, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, dtype="float32")
