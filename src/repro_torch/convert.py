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
