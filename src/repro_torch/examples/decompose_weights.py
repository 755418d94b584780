"""Weight compression via CP decomposition — the paper's kernel applied to
the LM zoo, executed end-to-end on the pSRAM engine.

Stacked MoE expert weights form a natural 3-mode tensor (experts, d_model,
d_ff). CP-ALS (MTTKRP inner kernel — exactly what the pSRAM array
accelerates) decomposes it **through the backend registry**: over more than
one array the ``"psram-mesh"`` backend shards the nonzero stream across
``--arrays`` arrays on the one device (a launch per shard, partial outputs
added in array order, Grams split and summed); on one array it is
``"psram-stream"``, which the mesh's eager lowering matches bit for bit. We
report compression ratio, reconstruction error, the modeled mesh bill for
the heaviest MTTKRP, and the end-to-end logits drift when the compressed
weights are swapped back into the model.

Run:  python -m repro_torch.examples.decompose_weights [--device cpu]
      python -m repro_torch.examples.decompose_weights --arrays 8
      (--smoke: reduced ranks/iterations)
"""
import argparse

import numpy as np
import torch

from repro_torch import backends
from repro_torch._device import as_device
from repro_torch._tree import tree_map
from repro_torch.core.cp_als import cp_als, reconstruct
from repro_torch.core.perf_model import MeshSparseMTTKRPWorkload
from repro_torch.models.registry import get_config, get_module


def pick_backend(n_arrays: int):
    """psram-mesh across ``n_arrays`` arrays; psram-stream on one."""
    if n_arrays > 1:
        return backends.get("psram-mesh", n_arrays=n_arrays), n_arrays
    return backends.get("psram-stream"), 1


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced ranks/iterations")
    ap.add_argument("--arrays", type=int, default=1,
                    help="pSRAM arrays to span (more than 1: psram-mesh)")
    ap.add_argument("--device", default="cuda",
                    help="where the tensors live (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)

    cfg = get_config("granite_moe_1b_a400m").reduced()
    mod = get_module(cfg)
    params = mod.init(0, cfg, device=dev)

    be, n_arrays = pick_backend(args.arrays)
    print(f"backend: {be.name} ({n_arrays} array(s))")

    layer0 = params["blocks"][0]["layer0"]["mlp"]
    w = layer0["wi"].to(torch.float32)  # (E, d, ff)
    e, d, ff = w.shape
    print(f"decomposing stacked expert tensor {tuple(w.shape)}")
    ranks = (8, 16) if args.smoke else (8, 16, 32)
    n_iter = 10 if args.smoke else 40
    per_rank = []
    for rank in ranks:
        st = cp_als(w, rank=rank, n_iter=n_iter, seed=1, backend=be)
        approx = reconstruct(st.factors, st.lambdas)
        rel = rel_err(approx, w)
        orig = e * d * ff
        comp = rank * (e + d + ff)
        print(f"  rank {rank:3d}: fit={st.fit:.3f} rel_err={rel:.3f} "
              f"compression {orig/comp:6.1f}x")
        per_rank.append({"rank": rank, "fit": st.fit, "rel_err": rel,
                         "compression": orig / comp})

    # what the heaviest MTTKRP costs on the mesh: every weight entry is a
    # nonzero of the mode-0 stream (dense tensors stream as full fibers)
    fibers = np.full((e,), d * ff, dtype=np.int32)
    wl = MeshSparseMTTKRPWorkload(fiber_lengths=fibers, rank=ranks[-1],
                                  n_arrays=n_arrays)
    est = be.cost(wl)
    print(f"modeled mode-0 MTTKRP bill on {n_arrays} array(s): "
          f"{est.counts.total_cycles} cycles, {est.time_s:.3e} s, "
          f"utilization {est.utilization:.4f}")

    # swap the top-rank approximation into the model, measure logits drift
    rank = ranks[-1]
    st = cp_als(w, rank=rank, n_iter=n_iter, seed=1, backend=be)
    approx = reconstruct(st.factors, st.lambdas).to(layer0["wi"].dtype)
    p2 = tree_map(lambda x: x, params)  # new containers, the same leaves
    wi = layer0["wi"].clone()
    wi[:] = approx
    p2["blocks"][0]["layer0"]["mlp"]["wi"] = wi
    gen = torch.Generator()
    gen.manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen).to(dev)
    with torch.no_grad():
        l1 = mod.forward(params, toks, cfg)
        l2 = mod.forward(p2, toks, cfg)
    drift = rel_err(l2.float(), l1.float())
    print(f"end-to-end logits drift with compressed layer-0 experts: {drift:.4f}")
    return {
        "device": str(l2.device), "backend": be.name, "n_arrays": n_arrays,
        "shape": [e, d, ff], "ranks": per_rank, "bill_cycles": est.counts.total_cycles,
        "bill_time_s": est.time_s, "bill_utilization": est.utilization,
        "logits_drift": drift,
    }


if __name__ == "__main__":
    main()
