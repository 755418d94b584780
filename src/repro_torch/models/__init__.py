"""repro_torch.models — the model zoo's dense decoder family.

Ported: ``config`` (``ArchConfig`` whole), ``layers``, ``blocks`` and
``transformer`` for the dense family (GQA/MHA, full and partial RoPE,
softcaps, sliding windows, sandwich norms, tied and scaled embeddings, the
pSRAM projection path), and ``registry``. Still to come from the reference
package: ``moe``, ``ssm``, ``encdec``, M-RoPE and the hybrid family (ROADMAP
Queue A item 7).
"""
from . import transformer
from .config import ArchConfig
from .registry import ARCH_IDS, get_config, get_module, list_configs

__all__ = ["ARCH_IDS", "ArchConfig", "get_config", "get_module", "list_configs",
           "transformer"]
