"""State carried across from the reference package.

The reference package's state, handed over as numpy arrays, becomes the
port's containers here — so both packages can compute on identical inputs
(the parity tests do exactly that), and a decomposition begun in one can be
continued in the other. Nothing here imports the reference package: the
caller converts its arrays with ``numpy.asarray`` first.

* :func:`factors` — initial/current CP factors.
* :func:`coo` / :func:`csf` — a COO triple / the fields of a CSF.
* :func:`layout` — a ``(ip, vp, lp, sp, n_seg)`` stream layout.
* :func:`factor_quants` — ``(qs, ss)`` quantized factor codes and scales.
* :func:`dense` — a dense tensor or its unfolding.
* :func:`mttkrp_quants` — the six quantized operands of the dense psram
  MTTKRP ``(qx0, sx, qb, sb, qc, sc)``.
* :func:`segment_blocks` — ``(data, seg_ids)`` blocks of the segment sum.
* :func:`model_params` / :func:`model_cache` — a model's parameters / cache
  (every family), from the reference's pytrees as nested dicts of numpy
  arrays.
* :func:`train_state` — an AdamW state (``optim.init_state``'s layout).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import as_device
from repro_torch.sparse.formats import COO, CSF, SortedCOO


def _tensor(a, dtype, device) -> torch.Tensor:
    """A fresh tensor on ``device`` (never an alias of the caller's array)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=as_device(device))


def factors(arrays, device="cuda") -> list[torch.Tensor]:
    """CP factors ``[(I_n, R)]`` as f32 tensors."""
    return [_tensor(a, torch.float32, device) for a in arrays]


def coo(indices, values, shape, mode_order=None, device="cuda") -> COO:
    """A COO triple as a :class:`COO` — or, with ``mode_order`` (the arrays
    are then trusted to be sorted by it), a :class:`SortedCOO`."""
    if mode_order is None:
        return COO.from_numpy(indices, values, shape, device=device)
    return SortedCOO.from_numpy(indices, values, shape, device=device,
                                mode_order=tuple(int(m) for m in mode_order))


def csf(shape, mode_order, fids, fptr, values, device="cuda") -> CSF:
    """The fields of a reference CSF as the port's :class:`CSF` (validated)."""
    out = CSF(
        shape=tuple(int(s) for s in shape),
        mode_order=tuple(int(m) for m in mode_order),
        fids=tuple(np.asarray(f, dtype=np.int32) for f in fids),
        fptr=tuple(np.asarray(p, dtype=np.int64) for p in fptr),
        values=_tensor(values, torch.float32, device),
    )
    out.validate()
    return out


def layout(ip, vp, lp, sp, n_seg, device="cuda"):
    """A stream layout tuple ``(ip, vp, lp, sp, n_seg)`` with the dtypes the
    fused kernel takes (int32 coordinates / segment ids / rows, f32 values)."""
    return (
        _tensor(ip, torch.int32, device),
        _tensor(vp, torch.float32, device),
        _tensor(lp, torch.int32, device),
        _tensor(sp, torch.int32, device),
        int(n_seg),
    )


def factor_quants(qs, ss, device="cuda"):
    """Quantized stream factors ``(qs, ss)``: int8 codes ``(I_d, R)`` and f32
    per-row scales ``(I_d, 1)`` per mode (the target mode's placeholders are
    carried as they are)."""
    return (
        tuple(_tensor(q, torch.int8, device) for q in qs),
        tuple(_tensor(s, torch.float32, device) for s in ss),
    )


def dense(x, device="cuda") -> torch.Tensor:
    """A dense tensor (or an unfolding ``(I, J*K)``) as an f32 tensor."""
    return _tensor(x, torch.float32, device)


def mttkrp_quants(qx0, sx, qb, sb, qc, sc, device="cuda"):
    """The dense psram MTTKRP's operands ``(qx0, sx, qb, sb, qc, sc)``: int8
    codes of the unfolding and both factors, f32 ``(n, 1)`` per-row scales."""
    codes = [_tensor(q, torch.int8, device) for q in (qx0, qb, qc)]
    scales = [_tensor(s, torch.float32, device) for s in (sx, sb, sc)]
    return codes[0], scales[0], codes[1], scales[1], codes[2], scales[2]


def segment_blocks(data, seg_ids, device="cuda"):
    """The blocked segment sum's operands: ``(B, bn, R)`` f32 chain rows and
    their ``(B, bn)`` int32 block-local segment ids."""
    return _tensor(data, torch.float32, device), _tensor(seg_ids, torch.int32, device)


def _array_tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype (``bfloat16`` arrays, which
    numpy holds as ``ml_dtypes``, carried over bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(as_device(device))
    return torch.from_numpy(np.array(a)).to(as_device(device))


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _array_tensor(tree, device)


def _split_groups(tree, n: int, device):
    """A pytree of stacked ``(G, ...)`` leaves as a list of G pytrees."""
    if isinstance(tree, dict):
        parts = {k: _split_groups(v, n, device) for k, v in tree.items()}
        return [{k: parts[k][g] for k in parts} for g in range(n)]
    a = np.asarray(tree)
    if a.shape[0] != n:
        raise ValueError(f"stacked leaf has {a.shape[0]} groups, expected {n}")
    return [_array_tensor(a[g], device) for g in range(n)]


def model_params(tree, cfg, device="cuda", mesh=None, fsdp: bool = False, rules=None) -> dict:
    """The reference's parameter pytree as the port's params. A decoder LM
    (``{"embed", "blocks", "final_norm"[, "head"]}``, ``blocks`` stacked over
    ``cfg.num_groups``): ``blocks`` becomes a list of per-group dicts. An
    encoder-decoder (``{"frame_proj", "embed", "encoder", "enc_norm",
    "decoder", "final_norm", "head"}``): ``encoder`` / ``decoder``, stacked
    over ``cfg.enc_layers`` / ``cfg.dec_layers``, become lists of per-layer
    dicts. ``{"q", "scale"}`` int8 array words are kept as they are. MoE
    layers carry ``router`` and ``wi`` / ``wg`` / ``wo`` with their expert
    axis (``(E, d, ff)``; stored words with ``(1, 1, ff)`` scales) across
    unchanged; SSM layers their ``in_proj``, ``conv_w``, ``conv_b``,
    ``a_log``, ``d_skip``, ``dt_bias``, ``norm`` and ``out_proj``.

    ``mesh`` (a ``launch.mesh.ModelMesh`` under a process group): the
    leaves are built on the host and each placed by ``cfg``'s param specs
    as a DTensor (``dist.placement``), one leaf on this rank's device at a
    time; ``device`` is then ignored."""
    if mesh is not None and mesh.placed:
        from repro_torch._tree import tree_map
        from repro_torch.dist.placement import distribute
        from repro_torch.dist.sharding import logical_to_spec
        from repro_torch.models.layers import specs_of
        from repro_torch.models.registry import get_module
        here = mesh.local_device()
        return tree_map(lambda t, ax: distribute(t.to(here), mesh, logical_to_spec(
            tuple(ax), t.shape, mesh, fsdp, rules)), model_params(tree, cfg, device="cpu"),
            specs_of(get_module(cfg).param_defs(cfg)))
    stacked = ({"encoder": cfg.enc_layers, "decoder": cfg.dec_layers}
               if cfg.family == "encdec" else {"blocks": cfg.num_groups})
    out = {k: _tree(v, device) for k, v in tree.items() if k not in stacked}
    for k, n in stacked.items():
        out[k] = _split_groups(tree[k], n, device)
    return out


def model_cache(tree, device="cuda") -> list:
    """The reference's stacked cache as the port's list of per-group (or, for
    an encoder-decoder, per-decoder-layer) caches: a decoder LM's
    ``{"layer<i>": {"k", "v"}}`` with ``(G, B, S, Hkv, hd)`` leaves, or
    ``{"state", "conv"}`` for SSM layers; an encoder-decoder's
    ``{"self": {"k", "v"}, "cross": {"k", "v"}}``. Leaves keep their dtypes
    (an SSM state after a prefill is f32)."""
    n = np.asarray(next(iter(next(iter(tree.values())).values()))).shape[0]
    return _split_groups(tree, n, device)


def train_state(tree, device="cuda") -> dict:
    """The reference's AdamW state ``{"master", "m", "v", "step"}`` as the
    port's. The port keeps the reference's layout (per-group leaves stacked
    ``(G, ...)``, a factored second moment as ``{"row", "col"}``), so every
    leaf carries over as it is, dtype included (a bf16 ``m`` bit for bit;
    ``step`` a 0-d int32)."""
    return _tree(tree, device)
