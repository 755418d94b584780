"""Model registry: family -> module dispatch + arch config lookup.

Every architecture of the reference is here: the encoder-decoder family is
built by ``models.encdec``, the dense, MoE, SSM and hybrid families (and
M-RoPE) by ``models.transformer``.
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
    "seamless_m4t_large_v2",
    "jamba_1p5_large",
    "qwen2_vl_7b",
    "granite_moe_1b_a400m",
    "dbrx_132b",
    "mamba2_370m",
]


def get_config(arch_id: str, **overrides) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    cfg = importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_module(cfg: ArchConfig):
    """The model implementation module for a config's family."""
    from . import encdec, transformer
    return encdec if cfg.family == "encdec" else transformer


def list_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
