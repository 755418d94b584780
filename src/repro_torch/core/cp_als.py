"""CP-ALS (Algorithm 1 of the paper): Canonical Polyadic Decomposition via
alternating least squares, with MTTKRP as the inner kernel.

Each mode update solves  A_n <- MTTKRP_n(X, factors) @ pinv(hadamard of grams)
followed by column normalization; fit is tracked against ||X||. The MTTKRP
engine is pluggable through the backend registry (``repro_torch.backends``):
pass ``backend="hopper"`` (or ``"exact"``) and the factor updates run on that
substrate, whatever form the data takes (dense tensor, COO triple, or a
``repro_torch.sparse`` container). A bare callable ``fn(x_or_none, factors,
mode)`` is accepted too. Lossy backends get an exact convergence metric via
``exact_fit`` (the factor updates stay on the engine under test; only the
fit inner product is recomputed exactly).

Everything runs on the device of the data handed in. The sweep builds a
**new** factor tensor per update and never writes one in place: the
store-side quantization caches (``kernels.stream_mttkrp.stream_factor_quants``,
``kernels.ops._stored``) key on tensor identity, and an in-place update would
be served stale int8 codes.

Relative to the reference module: tracing spans are left out until ``obs`` is
ported, ``init=`` takes the initial factors as arrays, and ``cp_als_psram``
waits for the ``psram-oracle`` / ``psram-stream`` backends.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import as_device, ieee_f32

from .mttkrp import khatri_rao, mttkrp_dense, mttkrp_sparse
from .psram import PsramConfig


@dataclasses.dataclass
class CPState:
    factors: list[torch.Tensor]  # [(I_n, R)]
    lambdas: torch.Tensor        # (R,) column norms
    fit: float
    iters: int


def init_factors(seed: "int | torch.Generator", shape: tuple[int, ...],
                 rank: int, device="cuda") -> list[torch.Tensor]:
    """Uniform [0, 1) initial factors on ``device``. ``seed`` is an int (a
    fresh generator on ``device`` is seeded with it) or a ``torch.Generator``
    that lives on ``device``."""
    dev = as_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    return [torch.rand((s, rank), generator=gen, device=dev, dtype=torch.float32)
            for s in shape]


def reconstruct(factors: list[torch.Tensor],
                lambdas: torch.Tensor | None = None) -> torch.Tensor:
    """Full tensor from its CP factors (small tensors only)."""
    rank = factors[0].shape[1]
    lam = torch.ones((rank,), device=factors[0].device) if lambdas is None else lambdas
    kr = khatri_rao(factors[1:])                      # (prod I_1.., R)
    mat = (factors[0] * lam) @ kr.T                   # (I_0, prod)
    return mat.reshape([f.shape[0] for f in factors])


def _hadamard_of(grams, skip):
    """Hadamard of precomputed per-factor Grams, skipping ``skip``.

    Mode-ascending product order over ``f.T @ f`` Grams — the ALS loop
    keeps the (R, R) Grams current incrementally (recompute only the mode
    it just updated) instead of re-materializing all N of them N+1 times
    per sweep."""
    out = None
    for d, g in enumerate(grams):
        if d == skip:
            continue
        out = g if out is None else out * g
    return out


def _resolve_backend(backend, config, compiled=False):
    """Turn ``backend`` (registry name | Backend instance | bare callable)
    into ``(callable_fn, registry_backend)`` — exactly one is non-None."""
    from repro_torch import backends as _backends

    if callable(backend) and not isinstance(backend, (str, _backends.Backend)):
        if config is not None:
            raise ValueError(
                "config= has no effect on a bare-callable backend (the "
                "callable closes over its own engine); pass a registry name "
                "or drop config="
            )
        if compiled:
            raise ValueError(
                "compiled= selects a registry backend's fast mode and has "
                "no effect on a bare callable"
            )
        return backend, None
    if compiled:
        if not isinstance(backend, str):
            raise ValueError(
                "compiled= needs a backend *name* (the instance you passed "
                "was already constructed with its own compiled setting)"
            )
        be = _backends.get(backend, config, compiled=True)
    else:
        be = _backends.get(backend, config)
    caps = be.capabilities()
    if not caps.executes:
        raise _backends.CapabilityError(
            f"backend {be.name!r} is cost-only and cannot drive CP-ALS "
            "factor updates; pick an executable backend"
        )
    return None, be


def _csf_cache(get_triple):
    """Per-mode CSF construction over a lazily-materialized COO triple: the
    host-side sort happens once per mode, not once per ALS sweep."""
    state: dict = {}

    def data_for(m: int):
        from repro_torch.sparse.formats import COO, csf_for_mode

        if "coo" not in state:
            idx, vals, shp = get_triple()
            state["coo"] = COO(indices=idx, values=vals, shape=shp)
        if m not in state:
            state[m] = csf_for_mode(state["coo"], m)
        return state[m]

    return data_for


def _initial_factors(init, seed, shape, rank, device) -> list[torch.Tensor]:
    if init is None:
        return init_factors(seed, tuple(shape), rank, device=device)
    if len(init) != len(shape):
        raise ValueError(f"init holds {len(init)} factors for {len(shape)} modes")
    factors = []
    for d, f in enumerate(init):
        # always a new tensor: the caller's array is never aliased or mutated
        t = torch.tensor(np.asarray(f), dtype=torch.float32, device=device) \
            if not isinstance(f, torch.Tensor) \
            else f.detach().to(device=device, dtype=torch.float32, copy=True)
        if tuple(t.shape) != (shape[d], rank):
            raise ValueError(
                f"init[{d}] has shape {tuple(t.shape)}, expected {(shape[d], rank)}")
        factors.append(t)
    return factors


@ieee_f32()
def cp_als(
    x: torch.Tensor | None,
    rank: int,
    n_iter: int = 25,
    seed: "int | torch.Generator" = 0,
    backend=None,
    config: PsramConfig | None = None,
    coo: tuple | None = None,
    sparse=None,
    tol: float = 1e-7,
    exact_fit: bool | None = None,
    csfs: list | None = None,
    compiled: bool = False,
    init: list | None = None,
) -> CPState:
    """Run CP-ALS on ``x`` (dense), ``coo=(indices, values, shape)``, or
    ``sparse`` — any ``repro_torch.sparse.formats`` container (COO/SortedCOO/
    BlockedCOO/CSF). The decomposition runs on the device of that data.

    ``backend`` selects the MTTKRP engine by registry name (``"exact"``,
    ``"hopper"``) — or a prebuilt :class:`~repro_torch.backends.Backend`, or
    a bare callable ``fn(x_or_none, factors, mode) -> (I_mode, R)``;
    ``config`` is its ``PsramConfig`` (default: the paper §V-A array).
    ``None`` keeps the exact default path for the given data form (dense
    einsum / COO scatter-add / streamed CSF).

    ``init`` gives the initial factors as arrays (numpy or tensors, copied);
    otherwise they are drawn uniform from ``seed`` (an int or a
    ``torch.Generator`` on the data's device).

    ``compiled=True`` constructs the named backend with ``compiled=True``
    (the fused fast mode; only meaningful with a backend *name*).

    ``exact_fit`` controls the convergence metric: the inner-product fit
    trick reuses the backend's last-mode MTTKRP, so a *lossy* backend biases
    the reported fit. With ``exact_fit`` (default: on whenever the backend
    is lossy or a callable), the fit inner product is recomputed with the
    exact sparse/dense path each sweep while the factor updates still come
    from the engine under test.

    The Grams, the solve and the fit run in IEEE f32 whatever TF32 setting
    the caller chose (:func:`repro_torch._device.ieee_f32`).
    """
    if backend is None and config is not None:
        raise ValueError(
            "config= selects the backend's array config and needs backend=; "
            "the default exact paths don't touch a PsramConfig"
        )
    if compiled and backend is None:
        raise ValueError(
            "compiled= selects a backend's fast mode and needs backend=; "
            "the default exact paths have no compiled variant"
        )
    callable_fn = be = None
    lossy = None
    if backend is not None:
        callable_fn, be = _resolve_backend(backend, config, compiled)
        lossy = True if callable_fn is not None else be.capabilities().lossy
    # a backend that sorts into a mode-rooted CSF per call must see prebuilt
    # per-mode CSFs, or every sweep re-sorts the nonzeros
    wants_csf = be is not None and be.capabilities().prefers_csf
    if sparse is not None:
        if coo is not None or x is not None:
            raise ValueError("pass exactly one of x / coo / sparse")
        from repro_torch.sparse.formats import CSF, SortedCOO, csf_for_mode
        from repro_torch.sparse.stream import stream_mttkrp

        base = sparse.to_coo() if isinstance(sparse, CSF) else sparse
        # duplicate coordinates are legal in the containers but would corrupt
        # ||X|| (norm of values ≠ norm of the collapsed tensor) and with it
        # the fit and the tol stopping rule — merge them up front
        base = SortedCOO.from_coo(base, getattr(base, "mode_order", None),
                                  dedupe=True)
        shape = tuple(base.shape)
        device = base.device
        norm_x = torch.linalg.norm(base.values)
        # per-mode CSFs are the expensive host-side preprocessing: callers
        # that already built them pass csfs= through; otherwise build lazily
        # on first use and share the cache with the registry backend
        built: dict = {}

        def mode_csf(m):
            if csfs is not None:
                return csfs[m]
            if m not in built:
                built[m] = csf_for_mode(base, m)
            return built[m]

        default_fn = lambda _, fs, m: stream_mttkrp(mode_csf(m), tuple(fs))
        backend_data = mode_csf          # a backend sees the per-mode CSF
    elif coo is not None:
        indices, values, shape = coo
        shape = tuple(shape)
        device = values.device
        norm_x = torch.linalg.norm(values)
        default_fn = lambda _, fs, m: mttkrp_sparse(
            indices, values, tuple(fs), m, shape[m]
        )
        if wants_csf:
            backend_data = _csf_cache(lambda: (indices, values, shape))
        else:
            backend_data = lambda m: (indices, values, shape)
    else:
        if x is None:
            raise ValueError("pass exactly one of x / coo / sparse")
        shape = tuple(x.shape)
        device = x.device
        norm_x = torch.linalg.norm(x)
        default_fn = lambda t, fs, m: mttkrp_dense(t, fs, m)
        if wants_csf:
            from .mttkrp import dense_to_coo

            backend_data = _csf_cache(lambda: (*dense_to_coo(x), shape))
        else:
            backend_data = lambda m: x
    exact_last_mode_fn = default_fn
    if callable_fn is not None:
        fn = callable_fn      # contract: fn(x_or_none, factors, mode)
    elif be is not None:
        fn = lambda _, fs, m: be.mttkrp(backend_data(m), tuple(fs), m)
    else:
        fn = default_fn
    if exact_fit is None:
        # a lossy engine biases the inner-product fit; exact engines don't
        exact_fit = bool(lossy)

    factors = _initial_factors(init, seed, shape, rank, device)
    lam = torch.ones((rank,), device=device)
    prev_fit, fit = -1.0, 0.0
    it = 0
    last = len(shape) - 1
    # per-sweep Gram reuse: each (R, R) Gram changes only when its factor
    # does, so keep them current incrementally. The Gram itself comes from
    # the backend: local ``f.T @ f`` everywhere except a distributed
    # backend, whose override all-reduces per-shard partial Grams.
    gram = be.gram if be is not None else (lambda f: f.T @ f)
    grams = [gram(f) for f in factors]
    for it in range(1, n_iter + 1):
        for mode in range(len(shape)):
            m = fn(x, factors, mode)                      # MTTKRP
            g = _hadamard_of(grams, mode)                 # (R, R)
            a = m @ torch.linalg.pinv(g)
            lam = torch.linalg.norm(a, dim=0).clamp_min(1e-12)
            factors[mode] = a / lam                       # a NEW tensor
            grams[mode] = gram(factors[mode])
        # fit = 1 - ||X - X_hat|| / ||X||, the standard inner-product trick
        g_all = _hadamard_of(grams, skip=-1) * torch.outer(lam, lam)
        # <X, X_hat> needs the final-mode MTTKRP against the *current* other
        # factors — m already is that (they don't change after the last
        # update). A lossy backend's m would bias the metric, so recompute
        # it exactly when asked.
        m_fit = exact_last_mode_fn(x, factors, last) if exact_fit else m
        inner = torch.sum(m_fit * (factors[-1] * lam))
        norm_hat_sq = torch.sum(g_all)
        resid = torch.sqrt(
            torch.clamp_min(norm_x**2 + norm_hat_sq - 2 * inner, 0.0))
        fit = float(1.0 - resid / norm_x)
        if abs(fit - prev_fit) < tol:
            break
        prev_fit = fit
    return CPState(factors=factors, lambdas=lam, fit=fit, iters=it)
