"""repro_torch.serve — serving every decoder family, batched and live.

A port of ``repro.serve``: ``engine`` (``ServeEngine``, ``make_prefill`` —
dense and ``paged=True`` — ``make_serve_step``, ``offload_report``), the
paged serve loop (``loop``, ``kv_cache``, ``scheduler``, ``traffic``) and
the package's forwarding of the removed adapters' names to ``engine``'s
pointed ``AttributeError``. ``ServeEngine(mesh=, sharding_rules=)`` serves
under ``dist.sharding``: on a mesh of one device, or across the ranks of a
process group (one process a card) with its params and cache as DTensors.
"""
from .engine import ServeEngine, make_prefill, make_serve_step, offload_report
from .kv_cache import PagedCacheConfig, PagedKVManager, gather_cache
from .loop import RequestRecord, ServeLoop, ServeLoopConfig, ServeReport
from .scheduler import BatchPrice, OffloadDecision, OffloadScheduler
from .traffic import Request, TrafficConfig, generate

__all__ = [
    "BatchPrice", "OffloadDecision", "OffloadScheduler", "PagedCacheConfig",
    "PagedKVManager", "Request", "RequestRecord", "ServeEngine", "ServeLoop",
    "ServeLoopConfig", "ServeReport", "TrafficConfig", "gather_cache", "generate",
    "make_prefill", "make_serve_step", "offload_report",
]


def __getattr__(name):
    # forward removed-adapter lookups to engine's pointed AttributeError
    from . import engine

    return getattr(engine, name)
