"""Serving launcher: batched request demo against any arch.

    python -m repro_torch.launch.serve --arch granite_8b [--reduced] \\
        [--batch 8] [--prompt-len 16] [--max-new 32] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given (and raises without one).
Weights and prompts are random, from fixed seeds; for the encoder-decoder
family the encoder's stub frames too, ``(batch, 4 * prompt_len, d_model)``
from a seeded ``torch.Generator`` (not JAX's bits). The time is the
``obs.stopwatch("serve/generate")`` around ``generate``, which waits for the
card's queued work on both edges; a ``serve/generate`` span lands in the
trace whenever tracing is on (``REPRO_TORCH_TRACE=1``).
``--model-parallel N`` serves under ``dist.sharding`` on a ``(n // N, N)``
host mesh: with ``--distributed`` (one process a card, under torchrun:
``launch.mesh.init_distributed``) over the world's ranks, the params and
cache placed as DTensors and the tokens replicated; without it over this
process's one device.

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --distributed \\
        --arch dbrx_132b --model-parallel 4 --batch 4
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="build a (data, model) host mesh with this model-"
                         "axis size and serve under use_sharding")
    ap.add_argument("--distributed", action="store_true",
                    help="one process a card: join torchrun's process group")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.distributed:
        from repro_torch.launch.mesh import init_distributed
        init_distributed(args.device)

    import torch

    from repro_torch import obs
    from repro_torch._device import as_device
    from repro_torch.models.layers import as_dtype
    from repro_torch.models.registry import get_config, get_module
    from repro_torch.serve import ServeEngine

    dev = as_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mod = get_module(cfg)
    mesh = None
    if args.model_parallel or args.distributed:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=args.model_parallel or 1, device=dev)
        dev = mesh.local_device()
    if mesh is not None and mesh.placed:
        from repro_torch.dist.placement import init_placed
        params = init_placed(cfg, 0, mesh)    # the one-card draw, each rank its blocks
    else:
        params = mod.init(0, cfg, device=dev)
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.max_new, mesh=mesh,
                      device=None if mesh is not None else dev)
    prompts = torch.randint(2, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev, dtype=torch.int32)
    kwargs = {}
    if cfg.family == "encdec":
        kwargs["frames"] = torch.randn(
            (args.batch, args.prompt_len * 4, cfg.d_model),
            generator=torch.Generator(device=dev).manual_seed(2), device=dev,
        ).to(as_dtype(cfg.dtype))
    gen = torch.Generator(device=dev).manual_seed(3)
    # the obs stopwatch owns the measurement: the printed tok/s summary is
    # sourced from it
    with obs.stopwatch("serve/generate", batch=args.batch,
                       max_new=args.max_new, arch=args.arch) as sw:
        toks = eng.generate(prompts, args.prompt_len, args.max_new,
                            temperature=args.temperature, generator=gen, **kwargs)
    dt = sw.duration_s
    total = args.batch * args.max_new
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s  ({total/dt:.1f} tok/s batched) "
          f"on {dev.type}")
    print("sample:", toks[0][:16].tolist())


if __name__ == "__main__":
    main()
