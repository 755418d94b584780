"""Backend protocol + registry — the single seam every execution substrate
plugs into.

* :class:`Backend` — the protocol: ``mttkrp(data, factors, mode)``,
  ``matmul(x, w)``, ``cost(workload) -> Estimate``, ``capabilities()``.
* :func:`register` / :func:`get` / :func:`list_backends` — the registry.
  Substrates register under a stable name (``"exact"``, ``"psram-oracle"``,
  ``"psram-scheduled"``, ``"psram-stream"``, ``"hopper"``,
  ``"analytical"``); ``repro_torch.api`` and ``cp_als`` dispatch by that
  name.
* :func:`resolve_config` — the one place a missing ``PsramConfig`` is
  defaulted (to the paper's §V-A operating point,
  ``configs.psram_mttkrp.CONFIG.array``) and *validated*. Backends call it
  at construction.

The registry's standing correctness contract is the parity suite
(tests/test_torch_cp_als.py): every executable backend is compared against
``"exact"`` on shared dense + sparse fixtures, within each backend's
documented numeric envelope (``Capabilities.rel_tol``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core.psram import PsramConfig


class BackendError(Exception):
    """Base class for registry/backend failures."""


class UnknownBackendError(BackendError, KeyError):
    """Asked for a name the registry doesn't hold."""


class CapabilityError(BackendError, NotImplementedError):
    """Asked a backend for an operation its capabilities exclude."""


def resolve_config(config: PsramConfig | None = None) -> PsramConfig:
    """The single defaulting + validation point for array configs.

    ``None`` resolves to the canonical paper operating point —
    ``configs.psram_mttkrp.CONFIG.array`` (256x32 words, 52 channels,
    20 GHz) — and every resolved config is validated, so an out-of-spec
    array (53 wavelengths, zero rows) is rejected at backend construction.
    """
    if config is None:
        from repro_torch.configs.psram_mttkrp import CONFIG

        config = CONFIG.array
    config.validate()
    return config


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What a backend can do, and the numeric envelope it promises.

    ``rel_tol`` is the documented relative-error bound of the backend's
    results against ``"exact"`` on well-conditioned operands — 0.0 means
    bit-identical (up to float reassociation declared by ``bit_exact``);
    lossy backends (8-bit operands + ADC) document the quantization
    envelope the repo's tests have always used (rel < 0.05).
    """

    executes: bool                 # can run MTTKRP numerically
    cost_model: bool               # can price some workload via cost()
    matmul: bool = True            # can run plain matmuls numerically
    dense: bool = True             # accepts dense tensors
    sparse: bool = True            # accepts COO triples / sparse containers
    lossy: bool = False            # quantized numerics (8-bit + ADC)
    bit_exact: bool = True         # deterministic bit-for-bit vs its oracle
    rel_tol: float = 0.0           # documented envelope vs "exact"
    prices: tuple = ()             # workload kinds cost() accepts, out of
                                   # "dense" / "sparse" / "matmul"
    prefers_csf: bool = False      # mttkrp() sorts data into a mode-rooted
                                   # CSF; callers looping over modes should
                                   # pass prebuilt CSFs to avoid resorting
    compiled: bool = False         # running the fused fast mode: same
                                   # arithmetic, reassociated fold
    autotune: bool = False         # chunk shapes come from the autotune
                                   # winner cache; off = deterministic
                                   # heuristic
    description: str = ""


@dataclasses.dataclass(frozen=True)
class Estimate:
    """What ``cost()`` / ``api.estimate`` return: one priced workload.

    ``breakdown`` is always present (the §V utilization terms); ``counts``
    and ``energy`` are present when the backend prices by walking a schedule
    (counted cycles), ``None`` for closed-form models.
    """

    backend: str
    config: PsramConfig
    workload: Any
    breakdown: Any                 # perf_model.SustainedBreakdown
    time_s: float
    counts: Any | None = None      # schedule.CycleCounts
    energy: Any | None = None      # perf_model.EnergyBreakdown

    @property
    def utilization(self) -> float:
        return self.breakdown.utilization

    @property
    def sustained_petaops(self) -> float:
        return self.breakdown.sustained_petaops


class Backend:
    """Protocol base. Construction resolves + validates the array config
    once, so invalid configs fail *here*."""

    name: str = "?"

    def __init__(self, config: PsramConfig | None = None):
        self.config = resolve_config(config)

    # -- protocol ----------------------------------------------------------
    def capabilities(self) -> Capabilities:
        raise NotImplementedError

    def matmul(self, x, w):
        """Compute ``x @ w`` on this substrate."""
        raise CapabilityError(f"backend {self.name!r} does not execute matmul")

    def mttkrp(self, data, factors, mode: int):
        """MTTKRP of ``data`` (dense tensor | COO triple | sparse container)
        against ``factors`` along ``mode``."""
        raise CapabilityError(f"backend {self.name!r} does not execute MTTKRP")

    def cost(self, workload) -> Estimate:
        """Price ``workload`` on this substrate."""
        raise CapabilityError(f"backend {self.name!r} has no cost model")

    def gram(self, f):
        """The ``(R, R)`` Gram ``f.T @ f`` of one factor — the CP-ALS
        normal-equation building block. Single-substrate backends compute
        it locally; a distributed backend overrides it with an all-reduce
        of per-shard partial Grams."""
        return f.T @ f

    # -- shared helpers ----------------------------------------------------
    def _require(self, what: str, ok: bool) -> None:
        if not ok:
            raise CapabilityError(
                f"backend {self.name!r} does not support {what} "
                f"(capabilities: {self.capabilities()})"
            )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} name={self.name!r}>"


_REGISTRY: dict[str, type[Backend]] = {}


def register(name: str) -> Callable[[type[Backend]], type[Backend]]:
    """Class decorator: ``@register("hopper")``."""

    def deco(cls: type[Backend]) -> type[Backend]:
        if not isinstance(name, str) or not name:
            raise ValueError("backend name must be a non-empty string")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def list_backends() -> tuple[str, ...]:
    """Registered backend names, stable order (registration order)."""
    _ensure_builtin()
    return tuple(_REGISTRY)


def get(name: "str | Backend", config: PsramConfig | None = None,
        **kwargs) -> Backend:
    """Construct (or pass through) a backend.

    ``name`` may be a registered name or an already-built :class:`Backend`
    instance (returned as-is; ``config`` must then be None — an instance
    already carries its config). Extra keyword arguments go to the backend
    constructor (e.g. ``compiled=True`` on the two pSRAM schedule backends,
    ``lowering=`` on ``"hopper"``); a backend that doesn't
    take them raises ``TypeError`` — the capability simply doesn't exist
    there.

    When tracing is enabled (``repro_torch.obs``), constructed backends come
    back wrapped in an ``InstrumentedBackend`` that spans every protocol
    call with workload metadata; passed-through instances are never wrapped
    implicitly (the caller owns an instance's identity).
    """
    _ensure_builtin()
    if isinstance(name, Backend):
        if config is not None or kwargs:
            raise ValueError(
                "pass config/constructor options only with a backend *name*; "
                "an instance is already built"
            )
        return name
    if name not in _REGISTRY:
        raise UnknownBackendError(
            f"unknown backend {name!r}; registered: {', '.join(_REGISTRY)}"
        )
    backend = _REGISTRY[name](config, **kwargs)
    from repro_torch.obs.instrument import maybe_instrument

    return maybe_instrument(backend)


def _ensure_builtin() -> None:
    """Import the first-class implementations exactly once (they register on
    import); keeps ``backends.base`` import-light and cycle-free."""
    if "exact" not in _REGISTRY:
        from . import impls  # noqa: F401
