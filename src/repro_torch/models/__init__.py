"""repro_torch.models — the model zoo's dense and MoE decoder families.

Ported: ``config`` (``ArchConfig`` whole), ``layers``, ``blocks``, ``moe``
and ``transformer`` for the dense and MoE families (GQA/MHA, full and
partial RoPE, softcaps, sliding windows, sandwich norms, tied and scaled
embeddings, token-choice top-k experts with position-priority capacity, the
pSRAM projection and expert paths), and ``registry``. Still to come from the
reference package: ``ssm``, ``encdec``, M-RoPE and the hybrid family
(ROADMAP Queue A item 7).
"""
from . import transformer
from .config import ArchConfig
from .registry import ARCH_IDS, get_config, get_module, list_configs

__all__ = ["ARCH_IDS", "ArchConfig", "get_config", "get_module", "list_configs",
           "transformer"]
