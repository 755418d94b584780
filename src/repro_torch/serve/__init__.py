"""repro_torch.serve — batched serving of the dense decoder family.

Ported: ``engine`` (``ServeEngine``, ``make_prefill``, ``make_serve_step``).
Still to come from the reference package, all with ROADMAP Queue A item 8:
``engine.offload_report`` (it prices through ``api.estimate``, which is
ported) and the paged serve loop (``kv_cache``, ``loop``, ``scheduler``,
``traffic``).
"""
from .engine import ServeEngine, make_prefill, make_serve_step

__all__ = ["ServeEngine", "make_prefill", "make_serve_step"]
