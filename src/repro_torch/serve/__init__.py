"""repro_torch.serve — batched serving of the dense decoder family.

Ported: ``engine`` (``ServeEngine``, ``make_prefill``, ``make_serve_step``).
Still to come from the reference package: ``engine.offload_report`` (it
prices through ``api.estimate``, ROADMAP Queue A item 3), the paged serve
loop (``kv_cache``, ``loop``, ``scheduler``, ``traffic``; Queue A item 8).
"""
from .engine import ServeEngine, make_prefill, make_serve_step

__all__ = ["ServeEngine", "make_prefill", "make_serve_step"]
