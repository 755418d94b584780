"""repro_torch.models — the model zoo: every family of the reference.

Ported: ``config`` (``ArchConfig`` whole), ``layers``, ``blocks``, ``moe``,
``ssm``, ``transformer`` (the dense, MoE, SSM and hybrid families: GQA/MHA,
full, partial and M-RoPE, softcaps, sliding windows, sandwich norms, tied
and scaled embeddings, token-choice top-k experts with position-priority
capacity, the chunked SSD scan and its recurrent decode, the pSRAM
projection and expert paths; the training loss and remat), ``encdec`` (the
encoder-decoder family) and ``registry``; the logical-axis specs of the
params and caches (``param_specs``, ``cache_specs``, ``layers.specs_of``)
and the ``dist.sharding.hint`` annotations.
"""
from . import encdec, transformer
from .config import ArchConfig
from .registry import ARCH_IDS, get_config, get_module, list_configs

__all__ = ["ARCH_IDS", "ArchConfig", "encdec", "get_config", "get_module", "list_configs",
           "transformer"]
