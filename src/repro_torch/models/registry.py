"""Model registry: family -> module dispatch + arch config lookup.

The port builds the dense and MoE families (``models.transformer``). The
reference's other architectures wait for their families; asking for one
raises a ``NotImplementedError`` that names the ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
import importlib

from .config import ArchConfig

ARCH_IDS = [
    "chatglm3_6b",
    "gemma2_27b",
    "granite_8b",
    "deepseek_7b",
    "granite_moe_1b_a400m",
    "dbrx_132b",
]

_WAITING = "ROADMAP Queue A item 7"

#: reference architectures not ported yet -> what they wait for
UNPORTED_ARCHS = {
    "seamless_m4t_large_v2": f"the encoder-decoder family (models/encdec.py, {_WAITING})",
    "jamba_1p5_large": f"the hybrid family (models/ssm.py, {_WAITING})",
    "qwen2_vl_7b": f"M-RoPE (models/layers.py apply_rope, with qwen2-vl, {_WAITING})",
    "mamba2_370m": f"the SSM family (models/ssm.py, {_WAITING})",
}

_UNPORTED_FAMILIES = {
    "hybrid": "models/ssm.py",
    "ssm": "models/ssm.py",
    "encdec": "models/encdec.py",
}


def get_config(arch_id: str, **overrides) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    if arch_id in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet: it waits for "
            f"{UNPORTED_ARCHS[arch_id]}")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {', '.join(ARCH_IDS)}")
    cfg = importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_module(cfg: ArchConfig):
    """The model implementation module for a config's family."""
    if cfg.family in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet: it waits "
            f"for {_UNPORTED_FAMILIES[cfg.family]} ({_WAITING})")
    if cfg.rope == "mrope":
        raise NotImplementedError(
            f"M-RoPE is not ported to repro_torch yet: it waits for qwen2-vl ({_WAITING})")
    from . import transformer
    return transformer


def list_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
