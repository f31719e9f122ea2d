"""Unified architecture config covering all assigned architecture families.

The port's own copy of ``src/repro/models/config.py`` (which imports no
JAX), kept field for field so that parity tests compare like with like.

One frozen dataclass describes dense / MoE / SSM / hybrid / VLM / audio
decoder backbones.  Layer heterogeneity (jamba's 1:7 mamba:attention
interleave, MoE-every-other-layer) is expressed as a *period*: a short list
of layer descriptors that tiles the depth; scan-over-layers runs over
period repetitions so mixed stacks still compile to a single rolled loop.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

AttnKind = Literal["gqa", "mla", "none"]
MixerKind = Literal["attn", "mamba"]
FFKind = Literal["mlp", "moe"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the period: a sequence mixer + a feed-forward."""
    mixer: MixerKind = "attn"
    ff: FFKind = "mlp"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1000
    head_dim: int = 0                   # 0 → d_model // num_heads
    act: str = "silu"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- attention variant ---
    attention: AttnKind = "gqa"
    sliding_window: int = 0             # 0 = full causal; >0 = window size
    # MLA (DeepSeek/MiniCPM3 style multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_every: int = 1                  # a layer is MoE if (i % moe_every == moe_offset)
    moe_offset: int = 0

    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    d_inner: int = 0                    # 0 → 2*d_model
    conv_width: int = 4
    dt_rank: int = 0                    # 0 → ceil(d_model/16)
    attn_every: int = 0                 # hybrid: 1 attention layer per this many
    attn_offset: int = 0

    # --- modality frontend stub (VLM / audio conditioning) ---
    frontend: str = "none"              # none | vision | audio
    num_frontend_tokens: int = 0        # patches / frames prepended as embeds

    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    logits_softcap: float = 0.0
    # chunk size (sequence positions) for the unembed+CE computation; 0 =
    # materialize full (B,S,V) logits (small models / ghost-tap path).
    # Production configs set this so the vocab logits never exist at once.
    loss_chunk: int = 0
    # query-chunk size for attention (flash-style jnp path)
    attn_chunk: int = 512
    # accumulation dtype of the SSM recurrence state (perf knob: bf16
    # halves the scan's HBM traffic at a measured accuracy cost)
    ssm_scan_dtype: str = "float32"
    # lax.scan unroll factor: keeps h in-register across `unroll` steps so
    # the recurrence's HBM round-trips drop ~unroll× (§Perf iteration)
    ssm_scan_unroll: int = 1

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.attn_every == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.attn_every > 0

    def layer_specs(self) -> tuple[LayerSpec, ...]:
        """Descriptor per layer of one period (see module docstring)."""
        period = self.period_len()
        specs = []
        for i in range(period):
            if self.ssm_state > 0:
                if self.attn_every > 0 and i % self.attn_every == self.attn_offset:
                    mixer = "attn"
                else:
                    mixer = "mamba"
            else:
                mixer = "attn"
            if self.num_experts > 0 and i % self.moe_every == self.moe_offset:
                ff = "moe"
            else:
                ff = "mlp"
            specs.append(LayerSpec(mixer=mixer, ff=ff))
        return tuple(specs)

    def period_len(self) -> int:
        """Smallest layer pattern that tiles the stack."""
        import math
        p = 1
        if self.num_experts > 0:
            p = math.lcm(p, self.moe_every)
        if self.attn_every > 0:
            p = math.lcm(p, self.attn_every)
        # mamba-only and dense stacks have period 1
        assert self.num_layers % p == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"period {p}")
        return p

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period_len()

    # --------------------------------------------------------- param count
    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n = 0
        for spec in self.layer_specs():
            if spec.mixer == "attn":
                if self.attention == "mla":
                    qr = self.q_lora_rank or d
                    n += d * qr + qr * self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    n += d * (self.kv_lora_rank + self.qk_rope_dim)
                    n += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                    n += self.num_heads * self.v_head_dim * d
                else:
                    n += d * hd * (self.num_heads + 2 * self.num_kv_heads)
                    n += self.num_heads * hd * d
            else:  # mamba
                di, ds, dtr = self.resolved_d_inner, self.ssm_state, self.resolved_dt_rank
                n += d * 2 * di + di * self.conv_width + di * (dtr + 2 * ds)
                n += dtr * di + di * ds + 2 * di + di * d
            if self.d_ff > 0:
                if spec.ff == "moe":
                    n += self.num_experts * 3 * d * self.d_ff + d * self.num_experts
                else:
                    n += 3 * d * self.d_ff
                n += d  # ln2
            n += d  # ln1
        n *= self.num_periods
        n += n_embed + d  # embeddings + final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        per_expert = 3 * self.d_model * self.d_ff
        n_moe_layers = sum(
            1 for s in self.layer_specs() for _ in [0] if s.ff == "moe"
        ) * self.num_periods
        inactive = (self.num_experts - self.num_experts_per_tok) * per_expert * n_moe_layers
        return full - inactive
