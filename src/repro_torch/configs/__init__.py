"""Model configurations of the port (own copies of the reference's).

``get_config(name)`` / ``get_smoke_config(name)`` / ``ARCH_NAMES`` follow
``src/repro/configs/__init__.py``, aliases included.  Every arch of the
reference is ported: the dense GQA/MHA archs, MLA (minicpm3-4b), the MoE
archs (dbrx-132b, grok-1-314b, jamba-v0.1-52b), the mamba stack
(falcon-mamba-7b) and the frontend-embeds stubs (llava-next-34b,
musicgen-medium).
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
    KeyError for an unknown arch."""
    key = _ALIASES.get(name, name)
    if key not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    return key


def _module(name: str):
    return importlib.import_module(f"repro_torch.configs.{resolve(name)}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke()
