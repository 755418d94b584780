"""Dry run: every (arch x shape x mesh) cell, traced on ``meta`` or run on the card.

    python -m repro_torch.launch.dryrun --device meta [--arch all] [--shape all] \\
        [--mesh single|multi|both] [--reduced] [--outdir results/dryrun]

The reference lowers and compiles each cell against 512 forced host
devices and reads XLA's memory and cost analyses and its HLO. The port has
no compiler to ask. :func:`lower_cell` with ``device="meta"`` builds the
params, optimizer state, batch and cache as ``meta`` tensors (shapes only),
traces the cell's step once under ``dist.sharding.use_sharding`` and
``FlopCounterMode`` (a second mesh reuses the first's trace: the count
depends on the cell, not the mesh), and prices it (``launch.roofline``): per-device argument, output and alias
bytes from the ``dist.sharding`` spec trees, the counted FLOPs per chip.
A train cell traces one microbatch's forward and backward and multiplies
by ``microbatches``, as the reference multiplies a ``while`` body by its
trip count. On a mesh of several devices the cell is traced a second time
as rank 0 of torch's ``fake`` process group at the mesh's size, its
arguments DTensors on ``meta`` placed by their specs
(``launch.roofline.fake_world``): every collective that trace issues is
priced by the reference's ring model over NVLink (``collective_s``,
``collective_bytes``, ``collective_wire_bytes``, ``by_collective``). The
optimizer update is not in the traced step (as the FLOPs count leaves it
out). What XLA alone can say — temporaries, compile seconds — is ``None``,
each with a ``why``.

``device="cuda"`` (on ``launch.mesh.make_host_mesh(device="cuda")``) runs
the cell's step on the card from seeded tensors and adds ``measured``: the
step's median milliseconds by CUDA events, its peak allocated bytes (the
cell's own: what was allocated before its arguments is subtracted), and
``measured_fraction = ideal_s / measured_s``. The CLI runs on the card by
default (and raises without one); ``--device meta`` asks for the dry run.

On one device a model's ``hint`` only checks its axes against the
tensor's rank; in the collective trace it redistributes the DTensor it is
given, as it does across cards.

``--psram-int8`` train cells are recorded as ``SKIP``: the params hold int8
words, which the reference's ``jax.grad`` refuses with a ``TypeError``, as
the port's train step does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time

import torch

from repro_torch._tree import tree_map
from repro_torch.dist.sharding import estimate_fsdp, tree_shardings, use_sharding
from repro_torch.launch.mesh import chips, make_host_mesh, make_production_mesh
from repro_torch.launch.roofline import analyze_step, count_flops, ideal_seconds, model_flops
from repro_torch.launch.shapes import SHAPES, applicable, dec_len, token_logical_axes, token_specs
from repro_torch.models.layers import as_dtype, shapes_of, specs_of
from repro_torch.models.registry import ARCH_IDS, get_config, get_module
from repro_torch.optim import AdamWConfig, init_state, state_spec_tree, state_structs
from repro_torch.serve.engine import make_prefill, make_serve_step
from repro_torch.train.step import _value_and_grad, make_loss_fn, make_train_step

#: the fields XLA's analyses fill in the reference and nothing fills here
WHY_NULL = {
    "temp_bytes": "no compiler: temporaries are not planned ahead of a run "
                  "(a card run reports its peak_bytes instead)",
    "compile_s": "no compile step: PyTorch runs eagerly",
}


def build_cell(arch: str, shape_name: str, *, overrides=None, exec_overrides=None):
    """``((cfg, shape), "")`` for an applicable cell, else ``(None, why)``:
    the config with the cell's execution settings (chunked attention, remat
    for training)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch, **(overrides or {}))
    ok, why = applicable(cfg, shape)
    if not ok:
        return None, why
    ex = {
        "attention_impl": "chunked",
        "remat": shape.kind == "train",
        **(exec_overrides or {}),
    }
    cfg = dataclasses.replace(cfg, **ex)
    if shape.kind == "train" and cfg.psram_stored_int8:
        try:
            make_train_step(cfg, AdamWConfig())
        except TypeError as e:
            return None, f"TypeError: {e}"
    return (cfg, shape), ""


def _bytes(structs, shardings) -> int:
    """Per-device bytes of a tree of tensors under its shardings."""
    total = []
    tree_map(lambda t, s: total.append(s.shard_bytes(t.shape, t.dtype)), structs, shardings)
    return sum(total)


def _logits_axes(t) -> tuple:
    return ("batch", "vocab") if t.ndim == 2 else ("batch", None, "vocab")


def _cell_inputs(cfg, shape, mesh, use_fsdp, rules, microbatches, opt_cfg, device, seed):
    """The cell's arguments on ``device`` (``meta``: shapes only; else seeded
    values) with their per-device bytes, and the function to trace."""
    mod = get_module(cfg)
    dtype = as_dtype(cfg.dtype)
    meta = torch.device(device).type == "meta"
    pdefs = mod.param_defs(cfg)
    p_specs = specs_of(pdefs)
    params = shapes_of(pdefs, dtype) if meta else mod.init(seed, cfg, device=device)
    batch = token_specs(cfg, shape)
    b_shard = tree_shardings(batch, token_logical_axes(cfg, shape), mesh, use_fsdp, rules)
    if not meta:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        batch = {k: (torch.randint(0, cfg.vocab_size, t.shape, generator=gen, device=device,
                                   dtype=t.dtype) if not t.is_floating_point()
                     else torch.randn(t.shape, generator=gen, device=device).to(t.dtype))
                 for k, t in batch.items()}
    p_shard = tree_shardings(params, p_specs, mesh, use_fsdp, rules)
    args_b = {"params": _bytes(params, p_shard), "batch": _bytes(batch, b_shard)}
    cell = {"params": params, "batch": batch, "p_shard": p_shard}

    if shape.kind == "train":
        ocfg = opt_cfg or AdamWConfig()
        opt = state_structs(params, ocfg) if meta else init_state(params, ocfg)
        o_shard = tree_shardings(opt, state_spec_tree(p_specs, params, ocfg), mesh,
                                 use_fsdp, rules)
        args_b["opt"] = _bytes(opt, o_shard)
        alias = args_b["params"] + args_b["opt"]
        out_b = alias + 3 * 4  # params, state; the metrics' three f32 scalars
        mb = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])[0]
              for k, v in batch.items()}
        loss_fn = make_loss_fn(cfg)
        step = make_train_step(cfg, ocfg, microbatches=microbatches)

        def run():
            """One step from the last step's params (the state updates in place)."""
            out = step(cell["params"], opt, batch)
            cell["params"] = out[0]
            return out

        cell.update(opt=opt, trace=lambda: _value_and_grad(loss_fn, params, mb),
                    repeat=microbatches, run=run, mb=mb,
                    call_with=lambda p, b, c: _value_and_grad(loss_fn, p, b))
        return cell, args_b, out_b, alias

    if shape.kind == "prefill":
        cache_len = dec_len(shape) if cfg.family == "encdec" else shape.seq_len
        fn = make_prefill(cfg, cache_len=cache_len)
        call = ((lambda: fn(params, batch["frames"], batch["tokens"]))
                if cfg.family == "encdec" else (lambda: fn(params, batch["tokens"])))
        c_specs = (mod.cache_specs(cfg, shape.global_batch, cache_len, shape.seq_len)
                   if cfg.family == "encdec"
                   else mod.cache_specs(cfg, shape.global_batch, cache_len))
        cell.update(trace=call, repeat=1, run=call, out_specs=c_specs,
                    call_with=((lambda p, b, c: fn(p, b["frames"], b["tokens"]))
                               if cfg.family == "encdec" else
                               (lambda p, b, c: fn(p, b["tokens"]))))
        return cell, args_b, None, 0

    # decode: one new token against a seq_len cache, at its last position
    if cfg.family == "encdec":
        cargs = (cfg, shape.global_batch, dec_len(shape), shape.seq_len)
    else:
        cargs = (cfg, shape.global_batch, shape.seq_len)
    cdefs = mod.cache_defs(*cargs)
    cache = shapes_of(cdefs, dtype) if meta else mod.init_cache(*cargs, device=device)
    c_shard = tree_shardings(cache, specs_of(cdefs), mesh, False, rules)
    pos_t = torch.empty((), dtype=torch.int32, device=device)
    scalar = tree_shardings(pos_t, (), mesh)
    args_b["cache"] = _bytes(cache, c_shard)
    args_b["scalar"] = scalar.shard_bytes((), torch.int32)
    pos = (dec_len(shape) if cfg.family == "encdec" else shape.seq_len) - 1
    step = make_serve_step(cfg)
    call = lambda: step(params, cache, batch["token"], pos)  # noqa: E731
    cell.update(cache=cache, pos=pos_t, trace=call, repeat=1, run=call,
                out_specs=specs_of(cdefs),
                call_with=lambda p, b, c: step(p, c, b["token"], pos))
    return cell, args_b, None, args_b["cache"]


def _out_bytes(out, out_specs, mesh, rules) -> int:
    """Per-device bytes of a prefill's or decode step's ``(logits, cache)``."""
    logits, cache = out
    lshard = tree_shardings(logits, _logits_axes(logits), mesh, False, rules)
    return (lshard.shard_bytes(logits.shape, logits.dtype)
            + _bytes(cache, tree_shardings(cache, out_specs, mesh, False, rules)))


# a meta cell's one traced pass (FLOPs, FLOPs by op, outputs) by (cfg,
# shape, microbatches):
# neither depends on the mesh, so a second mesh prices the first's trace
_META_TRACES: dict = {}


def _measure(run, repeats: int, base: int, loss=None) -> dict:
    """Median step ms by CUDA events over ``repeats`` runs after one warm
    run, the peak bytes allocated across them less ``base`` (what was
    allocated before the cell's arguments), and (given ``loss``, which reads
    a step's output) each run's loss, the warm run's first."""
    losses = [loss(run())] if loss else []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(repeats):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
        if loss:
            losses.append(loss(out))
        del out
    out = {"step_ms": statistics.median(times), "step_ms_all": times,
           "peak_bytes": int(torch.cuda.max_memory_allocated()) - base,
           "device_bytes_before": base}
    if loss:
        out["losses"] = losses
    return out


def _collective_trace(cfg, shape, mesh, use_fsdp, rules, cell) -> list:
    """The collectives one traced pass of the cell issues on rank 0 of a
    ``fake`` group at ``mesh``'s size, its arguments DTensors on ``meta``
    (``launch.roofline``): ``[(op, operand bytes, group size), ...]``."""
    from repro_torch.dist.placement import distribute_tree
    from repro_torch.launch.roofline import count_collectives, fake_world
    p_specs = specs_of(get_module(cfg).param_defs(cfg))
    batch = cell.get("mb", cell["batch"])
    with fake_world(mesh) as fake:
        params = distribute_tree(cell["params"], p_specs, fake, use_fsdp, rules)
        batch = distribute_tree(batch, token_logical_axes(cfg, shape), fake, use_fsdp, rules)
        cache = cell.get("cache")
        if cache is not None:
            cache = distribute_tree(cache, cell["out_specs"], fake, False, rules)
        with use_sharding(fake, fsdp=use_fsdp, rules=rules):
            _, records = count_collectives(cell["call_with"], params, batch, cache)
    return records


def lower_cell(cfg, shape, mesh, *, microbatches=8, fsdp="auto", rules=None, opt_cfg=None,
               verbose=True, device="meta", seed=0, repeats=5):
    """``(result, cell)``: the cell's priced trace (see the module
    docstring); ``cell`` holds its arguments (``params``, ``batch``, and
    ``opt`` or ``cache``) and the ``run`` that executes one step."""
    training = shape.kind == "train"
    if fsdp == "auto":
        use_fsdp = estimate_fsdp(cfg.param_count(), mesh, training)
    else:
        use_fsdp = fsdp in (True, "on", "true")
    meta = torch.device(device).type == "meta"
    if not training:
        microbatches = 1
    n_chips = chips(mesh)

    t0 = time.time()
    base = 0 if meta else torch.cuda.memory_allocated()
    cell, args_b, out_b, alias = _cell_inputs(cfg, shape, mesh, use_fsdp, rules, microbatches,
                                              opt_cfg, device, seed)
    with use_sharding(mesh, fsdp=use_fsdp, rules=rules):
        key = (cfg, shape, microbatches)
        if meta and key in _META_TRACES:
            flops, by_op, out = _META_TRACES[key]
        else:
            out, flops, by_op = count_flops(cell["trace"])
            if meta:
                _META_TRACES[key] = (flops, by_op, out)
        if out_b is None:
            out_b = _out_bytes(out, cell["out_specs"], mesh, rules)
        del out
        measured = None
        if not meta:
            torch.cuda.synchronize()
            measured = _measure(cell["run"], repeats, base,
                                (lambda out: float(out[2]["loss"])) if training else None)
    collectives = []
    if meta and n_chips > 1:
        collectives = _collective_trace(cfg, shape, mesh, use_fsdp, rules, cell)
    t1 = time.time()

    arg_bytes = sum(args_b.values())
    roof = analyze_step(flops, by_op, chips=n_chips, repeat=cell["repeat"],
                        bytes_per_chip=arg_bytes + out_b - alias, collectives=collectives)
    mf_global = model_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
    mf_per_chip = mf_global / n_chips
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    ideal = ideal_seconds(cfg, shape.kind, shape.seq_len, shape.global_batch, n_chips,
                          sizes.get("model", 16))
    worst = max(roof.compute_s, roof.memory_s, roof.collective_s)
    result = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": "x".join(map(str, mesh.shape)),
        "chips": n_chips,
        "device": str(torch.device(device)),
        "fsdp": bool(use_fsdp),
        "microbatches": microbatches if training else None,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "num_layers": cfg.num_layers,
        "psram_projections": bool(cfg.psram_projections),
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
        "lower_s": round(t1 - t0, 2),
        "compile_s": None,
        "memory": {
            "argument_bytes": arg_bytes,
            "argument_split": args_b,
            "output_bytes": out_b,
            "temp_bytes": None,
            "alias_bytes": alias,
            "per_device_total_gb": round((arg_bytes + out_b - alias) / 1e9, 3),
        },
        "roofline": roof.summary(),
        "model_flops_global": mf_global,
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": (mf_per_chip / roof.dot_flops) if roof.dot_flops else None,
        "ideal_s": ideal,
        "roofline_fraction": (ideal / worst) if worst > 0 else None,
        "why": WHY_NULL,
    }
    if measured is not None:
        measured["measured_fraction"] = ideal / (measured["step_ms"] / 1e3)
        result["measured"] = measured
    if verbose:
        print(_row(result))
    return result, cell


def _row(res) -> str:
    r = res["roofline"]
    frac = res["roofline_fraction"]
    line = (f"OK    {res['arch']:24s} {res['shape']:12s} {res['mesh']:9s} "
            f"mem {res['memory']['per_device_total_gb']:7.2f}GB  "
            f"compute {r['compute_s']*1e3:9.3f}ms memory {r['memory_s']*1e3:9.3f}ms "
            f"coll {r['collective_s']*1e3:9.3f}ms -> {r['dominant']:10s} "
            f"roofline_frac {frac and round(frac, 3)}")
    if "measured" in res:
        m = res["measured"]
        line += (f"  measured {m['step_ms']:.3f}ms peak {m['peak_bytes']/1e9:.2f}GB "
                 f"frac {m['measured_fraction']:.3f}")
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family configs (a fast CPU check)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--fsdp", default="auto")
    ap.add_argument("--attn-impl", default="chunked")
    ap.add_argument("--attn-chunk", type=int, default=512)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--opt-mem", action="store_true",
                    help="memory-reduced optimizer: bf16 m + factored v")
    ap.add_argument("--full-remat", action="store_true",
                    help="nothing_saveable remat policy (min activation memory)")
    ap.add_argument("--seq-shard", action="store_true",
                    help="shard activation sequence dim on the model axis "
                         "when heads/ff could not use it (sequence parallelism)")
    ap.add_argument("--scan-layers", default="true",
                    help="accepted for the reference's flag set; the port loops over groups")
    ap.add_argument("--psram-projections", action="store_true")
    ap.add_argument("--psram-int8", action="store_true",
                    help="stored-int8 projection weights (photonic offload)")
    ap.add_argument("--vocab-pad", type=int, default=1,
                    help="pad vocab to a multiple (256 => shardable on model axis)")
    ap.add_argument("--moe-cf", type=float, default=None,
                    help="override MoE capacity factor")
    ap.add_argument("--probs-bf16", action="store_true",
                    help="bf16 softmax weights (flash numerics)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "meta"],
                    help="meta: the dry run on the production meshes; cuda: run each cell "
                         "on the card's 1x1 mesh")
    ap.add_argument("--outdir", default="results/dryrun")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shape_names = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    if args.device == "meta":
        meshes = [("multi" if m else "single", make_production_mesh(m))
                  for m in {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]]
    else:
        meshes = [("host", make_host_mesh(device="cuda"))]
    os.makedirs(args.outdir, exist_ok=True)

    rows = []
    for mname, mesh in meshes:
        for arch in archs:
            for sname in shape_names:
                ex = {
                    "attention_impl": args.attn_impl,
                    "attn_chunk": args.attn_chunk,
                    "scan_layers": args.scan_layers == "true",
                    "psram_projections": args.psram_projections or args.psram_int8,
                    "psram_stored_int8": args.psram_int8,
                    "vocab_pad_multiple": args.vocab_pad,
                }
                if args.moe_cf is not None:
                    ex["moe_capacity_factor"] = args.moe_cf
                if args.probs_bf16:
                    ex["attn_probs_bf16"] = True
                built, why = build_cell(arch, sname, exec_overrides=ex)
                if built is None:
                    print(f"SKIP  {arch:24s} {sname:12s} {mname}: {why}")
                    rows.append({"arch": arch, "shape": sname, "skipped": why, "mesh": mname})
                    continue
                cfg, shape = built
                if args.reduced:
                    cfg = cfg.reduced()
                if args.no_remat:
                    cfg = dataclasses.replace(cfg, remat=False)
                if args.full_remat:
                    cfg = dataclasses.replace(cfg, remat_policy="nothing")
                rules = {"seq": (("model",), ())} if args.seq_shard else None
                ocfg = AdamWConfig(m_dtype="bfloat16", factored_v=True) if args.opt_mem else None
                try:
                    res, _ = lower_cell(cfg, shape, mesh, rules=rules, opt_cfg=ocfg,
                                        microbatches=args.microbatches, fsdp=args.fsdp,
                                        device=args.device)
                except Exception as e:  # a failing cell is a bug — surface it
                    print(f"FAIL  {arch:24s} {sname:12s}: {type(e).__name__}: {e}")
                    raise
                rows.append(res)
                with open(os.path.join(args.outdir, f"{arch}_{sname}_{mname}.json"), "w") as f:
                    json.dump(res, f, indent=1)
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {len(rows)} cells to {args.outdir}")
    return rows


if __name__ == "__main__":
    main()
