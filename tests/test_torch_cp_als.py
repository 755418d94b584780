"""The first slice of the port as a whole, on the CPU: backend registry,
``api`` facade and CP-ALS, held against ``"exact"`` and against the JAX
reference.

* parity: ``"hopper"`` (plain PyTorch versions on CPU tensors) lands inside
  its documented ``rel_tol`` of ``"exact"`` on a dense-COO-ified and a
  power-law sparse fixture, for every data form;
* registry error paths: unknown names, 4-mode dense data on ``"hopper"``
  (3-mode dense kernels only), ``autotune=True`` (a later slice);
* CP-ALS from the reference's own initial factors (``init=``) reaches the
  reference's ``cp_als(backend="pallas")`` fit within 5e-3 after the same
  number of sweeps.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.sparse import powerlaw_coo as j_powerlaw_coo
from repro_torch import api, backends, convert
from repro_torch.core import cp_als as t_cp
from repro_torch.core.mttkrp import dense_to_coo, mttkrp_dense
from repro_torch.core.psram import PsramConfig
from repro_torch.sparse import COO, csf_for_mode, powerlaw_coo

j_cp = importlib.import_module("repro.core.cp_als")   # the module, not the function

RANK = 5
DENSE_SHAPE = (12, 10, 8)


def _randn(shape, seed):
    return torch.tensor(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.fixture(scope="module")
def dense_fixture():
    x = _randn(DENSE_SHAPE, 0)
    fs = tuple(_randn((s, RANK), d + 1) for d, s in enumerate(DENSE_SHAPE))
    return x, fs


@pytest.fixture(scope="module")
def sparse_fixture():
    coo = powerlaw_coo(7, (40, 30, 20), nnz=1500, rank=3, alpha=1.1, device="cpu")
    fs = tuple(_randn((s, RANK), d + 11) for d, s in enumerate(coo.shape))
    return coo, fs


def _rel(got, want):
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


# ------------------------------------------------------------------- parity

def test_registry_lists_the_ported_backends():
    assert backends.list_backends() == ("exact", "hopper")
    caps = backends.get("hopper").capabilities()
    assert caps.lossy and caps.prefers_csf and caps.compiled and not caps.bit_exact
    assert caps.rel_tol == 0.05 and not caps.autotune
    assert backends.get("exact").capabilities().rel_tol == 0.0
    be = backends.get("hopper")
    assert backends.get(be) is be
    with pytest.raises(ValueError):
        backends.get(be, PsramConfig())


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dense_cooified_mttkrp_parity(mode, dense_fixture):
    """Dense input streams as all-entries COO (what CP-ALS does for a
    backend that prefers CSFs)."""
    x, fs = dense_fixture
    want = mttkrp_dense(x, list(fs), mode)
    np.testing.assert_array_equal(
        backends.get("exact").mttkrp(x, fs, mode).numpy(), want.numpy())
    idx, vals = dense_to_coo(x)
    triple = (idx, vals, tuple(x.shape))
    exact = backends.get("exact").mttkrp(triple, fs, mode)
    np.testing.assert_allclose(exact.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    got = backends.get("hopper").mttkrp(triple, fs, mode)
    assert got.shape == want.shape
    assert _rel(got, want) < backends.get("hopper").capabilities().rel_tol


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("lowering", ["auto", "torch", "ref"])
def test_sparse_mttkrp_parity(mode, lowering, sparse_fixture):
    coo, fs = sparse_fixture
    csf = csf_for_mode(coo, mode)
    want = backends.get("exact").mttkrp(csf, fs, mode)
    got = backends.get("hopper", lowering=lowering).mttkrp(csf, fs, mode)
    assert _rel(got, want) < 0.05
    via_api = api.mttkrp(csf, fs, mode, backend="hopper")
    np.testing.assert_array_equal(
        via_api.numpy(), backends.get("hopper").mttkrp(csf, fs, mode).numpy())


def test_mttkrp_data_forms_agree(sparse_fixture):
    """One workload union: COO triple, container, and CSF hit the same path —
    identical results on the sorted stream."""
    coo, fs = sparse_fixture
    for name in ("exact", "hopper"):
        be = backends.get(name)
        csf = csf_for_mode(coo, 1)
        s = csf.to_coo()
        triple = (s.indices, s.values, tuple(s.shape))
        a = be.mttkrp(csf, fs, 1)
        np.testing.assert_array_equal(a.numpy(), be.mttkrp(triple, fs, 1).numpy())
        np.testing.assert_array_equal(a.numpy(), be.mttkrp(s, fs, 1).numpy())
        np.testing.assert_array_equal(
            a.numpy(), api.execute(api.MTTKRPProblem(csf, fs, 1), backend=name).numpy())
        np.testing.assert_array_equal(
            a.numpy(), api.execute(csf, backend=name, factors=fs, mode=1).numpy())
    with pytest.raises(ValueError):
        api.execute(csf, backend="exact")
    with pytest.raises(ValueError):
        api.execute(api.MTTKRPProblem(csf, fs, 1), factors=fs)
    with pytest.raises(TypeError):
        backends.get("exact").mttkrp("not a tensor", fs, 0)


def test_matmul_parity():
    x, w = _randn((7, 33), 2), _randn((33, 9), 3)
    np.testing.assert_array_equal(api.matmul(x, w, backend="exact").numpy(), (x @ w).numpy())
    assert _rel(api.matmul(x, w, backend="hopper"), x @ w) < 0.05
    cfg = PsramConfig(adc=type(PsramConfig().adc)(bits=10))
    assert _rel(api.matmul(x, w, backend="hopper", config=cfg), x @ w) < 0.05


# -------------------------------------------------------------- error paths

def test_registry_error_paths(dense_fixture):
    x, fs = dense_fixture
    with pytest.raises(backends.UnknownBackendError, match="registered"):
        backends.get("pallas")
    with pytest.raises(KeyError):
        api.mttkrp(x, fs, 0, backend="psram-stream")
    x4 = x[..., None].expand(*x.shape, 2)
    fs4 = (*fs, fs[0][:2])
    for compiled in (True, False):                              # dense: 3-mode kernels only
        be = backends.get("hopper", compiled=compiled)
        assert be.capabilities().compiled is compiled
        with pytest.raises(backends.CapabilityError, match="3-mode"):
            be.mttkrp(x4, fs4, 0)
    with pytest.raises(backends.CapabilityError, match="autotune"):
        backends.get("hopper", autotune=True)
    with pytest.raises(ValueError, match="unknown kernel lowering"):
        backends.get("hopper", lowering="pallas")
    with pytest.raises(TypeError):
        backends.get("exact", compiled=True)
    with pytest.raises(NotImplementedError):
        backends.get("exact").cost(backends.MatmulWorkload(4, 4, 4))
    with pytest.raises(ValueError, match="52"):
        backends.get("hopper", PsramConfig(wavelengths=53))
    assert backends.resolve_config(None) == PsramConfig()
    assert backends.MatmulWorkload(2, 3, 4, repeats=5).macs == 120


def test_lowering_follows_the_tensors_and_the_env(monkeypatch):
    from repro_torch.backends import lowering as low
    cpu = torch.zeros(1)
    assert low.resolve_lowering("auto", cpu) == "torch"
    assert low.resolve_lowering("cuda", cpu) == "cuda"           # resolved names pass through
    with pytest.raises(RuntimeError, match="no kernel lowering"):
        low.resolve_lowering("auto", torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="one device type"):
        low.resolve_lowering("auto")
    with pytest.raises(ValueError, match="unknown kernel lowering"):
        low.resolve_lowering("xla", cpu)
    monkeypatch.setenv(low.ENV_VAR, "ref")
    low._env_override.cache_clear()
    try:
        assert low.resolve_lowering("auto", cpu) == "ref"
        monkeypatch.setenv(low.ENV_VAR, "interpret")
        low._env_override.cache_clear()
        with pytest.raises(ValueError, match="not a resolved lowering"):
            low.resolve_lowering("auto", cpu)
    finally:
        monkeypatch.delenv(low.ENV_VAR)
        low._env_override.cache_clear()


# ------------------------------------------------------------------- CP-ALS

def test_cp_als_exact_recovers_lowrank_dense():
    rng = np.random.default_rng(0)
    fs = [torch.tensor(rng.uniform(size=(s, 3)).astype(np.float32)) for s in (12, 10, 8)]
    x = t_cp.reconstruct(fs)
    st = t_cp.cp_als(x, rank=3, n_iter=200, seed=7)
    assert st.fit > 0.995 and st.factors[0].device.type == "cpu"
    xr = t_cp.reconstruct(st.factors, st.lambdas)
    assert float((x - xr).abs().max()) < 0.05 * float(x.abs().max())


def test_cp_als_builds_new_factor_tensors_and_keeps_init_untouched():
    coo = powerlaw_coo(1, (15, 12, 10), nnz=400, device="cpu")
    init = t_cp.init_factors(3, coo.shape, 4, device="cpu")
    again = t_cp.init_factors(torch.Generator().manual_seed(3), coo.shape, 4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(init, again))
    keep = [f.clone() for f in init]
    st = t_cp.cp_als(None, 4, n_iter=2, sparse=coo, backend="hopper", init=init)
    assert all(torch.equal(a, b) for a, b in zip(init, keep))
    assert all(f is not g for f, g in zip(st.factors, init))
    with pytest.raises(ValueError, match="init"):
        t_cp.cp_als(None, 4, n_iter=1, sparse=coo, init=init[:2])
    with pytest.raises(ValueError):
        t_cp.cp_als(None, 4, sparse=coo, config=PsramConfig())
    with pytest.raises(ValueError):
        t_cp.cp_als(None, 4, sparse=coo, compiled=True)
    with pytest.raises(ValueError):
        t_cp.cp_als(None, 4)


@pytest.mark.parametrize("form", ["sparse", "coo", "dense"])
def test_cp_als_hopper_tracks_exact(form):
    """Factor updates on the lossy engine, exact convergence metric: the fit
    stays within 0.02 of the exact engine's from the same start."""
    if form == "dense":
        x = t_cp.reconstruct([torch.tensor(
            np.random.default_rng(d).uniform(size=(s, 3)).astype(np.float32))
            for d, s in enumerate((10, 8, 6))])
        kw, shape = dict(x=x), tuple(x.shape)
    else:
        coo = powerlaw_coo(2, (30, 24, 18), nnz=1500, rank=3, device="cpu")
        shape = coo.shape
        kw = dict(x=None, sparse=coo) if form == "sparse" else \
            dict(x=None, coo=(coo.indices, coo.values, coo.shape))
    init = t_cp.init_factors(5, shape, 3, device="cpu")
    a = t_cp.cp_als(rank=3, n_iter=6, backend="hopper", init=init, tol=0, **kw)
    b = t_cp.cp_als(rank=3, n_iter=6, backend="exact", init=init, tol=0, **kw)
    c = t_cp.cp_als(rank=3, n_iter=6, init=init, tol=0, **kw)      # default exact path
    assert a.iters == b.iters == 6
    assert abs(a.fit - b.fit) < 0.02
    assert abs(b.fit - c.fit) < 1e-4
    # compiled=True names the same (default) fused mode
    d = t_cp.cp_als(rank=3, n_iter=6, backend="hopper", compiled=True, init=init, tol=0, **kw)
    assert d.fit == a.fit
    # a bare callable is still a backend
    be = backends.get("exact")
    data = kw.get("sparse") or kw.get("coo") or kw["x"]
    e = t_cp.cp_als(rank=3, n_iter=6, init=init, tol=0, exact_fit=False,
                    backend=lambda _, fs, m: be.mttkrp(data, tuple(fs), m), **kw)
    assert abs(e.fit - b.fit) < 1e-4


@pytest.mark.parametrize("n_iter", [3, 8])
def test_cp_als_reaches_the_reference_fit_from_its_initial_factors(n_iter):
    """Both packages start from the reference's ``jax.random`` factors and
    run the same number of sweeps on the same tensor: the port's ``hopper``
    fit within 5e-3 of the reference's ``pallas`` fit, the exact engines
    within 1e-4."""
    key = jax.random.PRNGKey(7)
    j_coo = j_powerlaw_coo(key, (40, 30, 20), nnz=1500, rank=3, alpha=1.1)
    rank = 4
    als_key = jax.random.PRNGKey(11)
    init = [np.asarray(f) for f in j_cp.init_factors(als_key, j_coo.shape, rank)]
    ref = j_cp.cp_als(None, rank, n_iter=n_iter, key=als_key, sparse=j_coo,
                      backend="pallas", tol=0)
    ref_exact = j_cp.cp_als(None, rank, n_iter=n_iter, key=als_key, sparse=j_coo,
                            backend="exact", tol=0)
    t_coo = convert.coo(np.asarray(j_coo.indices), np.asarray(j_coo.values),
                        j_coo.shape, mode_order=j_coo.mode_order, device="cpu")
    got = t_cp.cp_als(None, rank, n_iter=n_iter, sparse=t_coo, backend="hopper",
                      init=convert.factors(init, device="cpu"), tol=0)
    got_exact = t_cp.cp_als(None, rank, n_iter=n_iter, sparse=t_coo, backend="exact",
                            init=init, tol=0)
    assert got.iters == ref.iters == n_iter
    assert abs(got.fit - ref.fit) < 5e-3
    assert abs(got_exact.fit - ref_exact.fit) < 1e-4
    assert isinstance(t_coo, COO) and t_coo.mode_order == (0, 1, 2)


# -------------------------------------------------------------- TF32 pin


def _tf32_state():
    """(matmul, cuDNN) in IEEE f32, as the backends read their switches."""
    b = torch.backends
    if hasattr(b.cuda.matmul, "fp32_precision"):
        return (b.cuda.matmul.fp32_precision == "ieee",
                b.cudnn.conv.fp32_precision == b.cudnn.rnn.fp32_precision == "ieee")
    return not b.cuda.matmul.allow_tf32, not b.cudnn.allow_tf32


def _tf32_snapshot():
    """Every getter of the TF32 settings, a getter that refuses as "refused"."""
    b = torch.backends
    getters = [torch.get_float32_matmul_precision, lambda: b.cuda.matmul.allow_tf32,
               lambda: b.cudnn.allow_tf32]
    if hasattr(b.cuda.matmul, "fp32_precision"):
        getters += [lambda o=o: o.fp32_precision
                    for o in (b.cuda.matmul, b.cudnn.conv, b.cudnn.rnn)]
    out = []
    for get in getters:
        try:
            out.append(get())
        except RuntimeError:
            out.append("refused")
    return out


def _set_tf32(caller):
    """The caller's setting: legacy flags (matmul, cuDNN), a legacy matmul
    precision, or the per-backend switch where this PyTorch has it."""
    b = torch.backends
    if isinstance(caller, tuple):
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = caller
    elif caller == "switch:tf32":
        if hasattr(b.cuda.matmul, "fp32_precision"):
            b.cuda.matmul.fp32_precision = "tf32"
        else:
            b.cuda.matmul.allow_tf32 = True
    else:
        torch.set_float32_matmul_precision(caller)


@pytest.mark.parametrize("caller", [(False, True), (True, True), (True, False),
                                    "medium", "high", "highest", "switch:tf32"])
def test_exact_entry_points_pin_ieee_f32_and_restore_the_callers_setting(caller, dense_fixture):
    """Inside the exact entry points TF32 is off for matmuls and cuDNN; the
    caller's settings come back afterwards exactly as every getter read
    them (a ``"medium"`` stays ``"medium"``), also after an exception."""
    from repro_torch._device import _precision_switches, ieee_f32

    b = torch.backends
    saved = (torch.get_float32_matmul_precision(), b.cudnn.allow_tf32,
             [s.fp32_precision for s in _precision_switches()])
    seen = []
    try:
        _set_tf32(caller)
        want = _tf32_snapshot()
        with ieee_f32():
            seen.append(_tf32_state())
        assert seen == [(True, True)] and _tf32_snapshot() == want
        with pytest.raises(ZeroDivisionError):
            with ieee_f32():
                1 / 0
        assert _tf32_snapshot() == want

        @ieee_f32()
        def probe():
            seen.append(_tf32_state())

        probe()
        probe()
        assert seen[1:] == [(True, True)] * 2 and _tf32_snapshot() == want
        # the exact entry points see TF32 off and leave the caller's setting
        import repro_torch.core.mttkrp as tm
        real = tm.torch.einsum

        def spy(*a, **kw):
            seen.append(_tf32_state())
            return real(*a, **kw)

        x, fs = dense_fixture
        tm.torch.einsum = spy
        try:
            backends.get("exact").mttkrp(x, fs, 0)
            mttkrp_dense(x, list(fs), 1)
        finally:
            tm.torch.einsum = real
        assert seen[3:] == [(True, True)] * 2 and _tf32_snapshot() == want
    finally:
        torch.set_float32_matmul_precision(saved[0])
        b.cudnn.allow_tf32 = saved[1]
        for s, value in zip(_precision_switches(), saved[2]):
            s.fp32_precision = value
