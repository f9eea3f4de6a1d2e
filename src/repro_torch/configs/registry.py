"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

The reference knows ten archs; the port runs only those listed in
``_PORTED``.  Asking for a known arch the port does not run yet raises
``NotImplementedError``; an unknown name raises ``KeyError``, as in the
reference.
"""

from __future__ import annotations

import importlib

_ARCHS = (
    "qwen2_vl_7b",
    "recurrentgemma_2b",
    "dbrx_132b",
    "qwen3_moe_235b_a22b",
    "gemma3_1b",
    "minitron_8b",
    "nemotron_4_15b",
    "qwen2_0_5b",
    "rwkv6_1_6b",
    "seamless_m4t_large_v2",
)

_PORTED = ("rwkv6_1_6b", "recurrentgemma_2b")


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def list_archs() -> tuple[str, ...]:
    """The archs the port runs."""
    return _PORTED


def get_config(name: str):
    mod_name = canonical(name)
    if mod_name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {_ARCHS}")
    if mod_name not in _PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to repro_torch yet; ported: {_PORTED}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
