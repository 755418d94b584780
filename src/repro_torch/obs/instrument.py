"""InstrumentedBackend — the registry-level span wrapper.

Wraps any :class:`~repro_torch.backends.base.Backend` so every protocol call
(``mttkrp`` / ``matmul`` / ``gram`` / ``cost``) records a span named
``backend/<name>/<op>`` carrying workload metadata (shapes, nnz, mode).
Delegation is total: capabilities, config, and any backend-specific
attribute (``compiled``, ``lowering``, ...) read through, so the wrapper is
substitutable anywhere a backend instance is — ``cp_als``, ``api``, the
parity suite. On the card each span covers the device work of the call
(the tracer synchronizes at its edges, :mod:`repro_torch.obs.tracer`).

``backends.get`` auto-wraps constructed backends when tracing is enabled
(see :func:`maybe_instrument`); an already-built instance passed through
``get`` is never wrapped implicitly — wrap explicitly with
``InstrumentedBackend(be)`` to opt in.
"""
from __future__ import annotations

from repro_torch.backends.base import Backend

from . import tracer as _tracer


def _data_meta(data) -> dict:
    """Workload metadata for a span, best-effort and allocation-light; every
    value a plain Python scalar or string."""
    nnz = getattr(data, "nnz", None)
    if nnz is not None:
        return {"nnz": int(nnz), "kind": type(data).__name__}
    shape = getattr(data, "shape", None)
    if shape is not None:
        return {"shape": str(tuple(shape)), "kind": type(data).__name__}
    if isinstance(data, tuple) and len(data) == 3:
        idx = data[0]
        n = getattr(idx, "shape", (None,))[0]
        return {"nnz": None if n is None else int(n), "kind": "coo-triple"}
    return {"kind": type(data).__name__}


class InstrumentedBackend(Backend):
    """A delegating backend wrapper that spans every protocol call.

    Subclasses :class:`~repro_torch.backends.base.Backend` so instrumented
    instances pass anywhere a backend does — including back through
    ``backends.get``'s instance pass-through.
    """

    def __init__(self, inner):
        # no super().__init__: config/name delegate to the wrapped backend
        self._inner = inner
        self._prefix = f"backend/{inner.name}"

    @property
    def inner(self):
        return self._inner

    @property
    def name(self) -> str:
        return self._inner.name

    @property
    def config(self):
        return self._inner.config

    def capabilities(self):
        return self._inner.capabilities()

    def matmul(self, x, w):
        with _tracer.span(f"{self._prefix}/matmul",
                          m=int(x.shape[0]), k=int(x.shape[1]),
                          n=int(w.shape[1])):
            return self._inner.matmul(x, w)

    def mttkrp(self, data, factors, mode: int):
        meta = _data_meta(data)
        meta["mode"] = int(mode)
        meta["rank"] = int(factors[0].shape[-1])
        with _tracer.span(f"{self._prefix}/mttkrp", **meta):
            return self._inner.mttkrp(data, factors, mode)

    def gram(self, f):
        with _tracer.span(f"{self._prefix}/gram",
                          rows=int(f.shape[0]), rank=int(f.shape[-1])):
            return self._inner.gram(f)

    def cost(self, workload):
        with _tracer.span(f"{self._prefix}/cost",
                          workload=type(workload).__name__):
            return self._inner.cost(workload)

    def __getattr__(self, attr):
        # everything else (compiled, lowering, ...) reads through to the
        # wrapped backend
        return getattr(self._inner, attr)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<InstrumentedBackend {self._inner!r}>"


def maybe_instrument(backend):
    """Wrap ``backend`` iff tracing is enabled and it isn't wrapped already —
    the hook ``backends.get`` calls on every backend it constructs."""
    if _tracer.enabled() and not isinstance(backend, InstrumentedBackend):
        return InstrumentedBackend(backend)
    return backend
