"""Model configurations of the port (own copies of the reference's).

``get_config(name)`` / ``get_smoke_config(name)`` / ``ARCH_NAMES`` follow
``src/repro/configs/__init__.py``, aliases included.  The dense GQA/MHA
SwiGLU archs and the attention-free mamba stack (falcon-mamba-7b) are
ported; the others name the model code they still need.
"""
from __future__ import annotations

import importlib

ARCH_NAMES = (
    "grok_1_314b",
    "deepseek_7b",
    "minicpm3_4b",
    "glm4_9b",
    "musicgen_medium",
    "jamba_v0_1_52b",
    "dbrx_132b",
    "llava_next_34b",
    "internlm2_20b",
    "falcon_mamba_7b",
)

# archs whose model code this port runs: dense attention + SwiGLU MLP, and
# mamba-only stacks
PORTED = ("deepseek_7b", "glm4_9b", "internlm2_20b", "falcon_mamba_7b")

# what each other arch needs before it can run in the port
NEEDS = {
    "grok_1_314b": "MoE",
    "minicpm3_4b": "MLA attention",
    "musicgen_medium": "the audio frontend",
    "jamba_v0_1_52b": "MoE",
    "dbrx_132b": "MoE",
    "llava_next_34b": "the vision frontend",
}

_ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES}
_ALIASES.update({
    "grok-1-314b": "grok_1_314b",
    "deepseek-7b": "deepseek_7b",
    "minicpm3-4b": "minicpm3_4b",
    "glm4-9b": "glm4_9b",
    "musicgen-medium": "musicgen_medium",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "dbrx-132b": "dbrx_132b",
    "llava-next-34b": "llava_next_34b",
    "internlm2-20b": "internlm2_20b",
    "falcon-mamba-7b": "falcon_mamba_7b",
})


def resolve(name: str) -> str:
    """The module name of ``name`` (an arch name or alias); raises
    KeyError for an unknown arch and NotImplementedError for one whose
    model code is not ported yet."""
    key = _ALIASES.get(name, name)
    if key not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    if key not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} needs {NEEDS[key]}, which the PyTorch port "
            f"does not carry yet; ported: "
            f"{', '.join(PORTED)}")
    return key


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{resolve(name)}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke()
