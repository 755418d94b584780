"""Training launcher: the reference's flags, on one device or one process
a card.

    python -m repro_torch.launch.train --arch granite_8b --reduced \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt [--device cuda|cpu]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --distributed \\
        --arch granite_8b --steps 20 --batch 8 --seq 1024 [--model-parallel N]

Runs on the card unless ``--device cpu`` is given (and raises without
one). Weights are random from a seed; the data is the synthetic Zipf stream
of ``data.pipeline``. ``--model-parallel N`` trains under ``dist.sharding``
on a ``(n // N, N)`` host mesh over the visible devices of ``--device``'s
type, and ``--seq-shard`` lets the leftover model axis land on the sequence
dim. ``--distributed`` joins the process group torchrun describes
(``launch.mesh.init_distributed``: NCCL on the cards, gloo with ``--device
cpu``) and trains on a ``(world // N, N)`` mesh over its ranks (``N`` =
``--model-parallel``, 1 by default: data parallel), FSDP where
``estimate_fsdp`` says so; rank 0 alone prints and writes checkpoints.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry the int8 compression residual across steps "
                         "(EF-SGD; implies --compress-grads semantics)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="build a (data, model) host mesh with this model-"
                         "axis size and train under use_sharding")
    ap.add_argument("--seq-shard", action="store_true",
                    help="let leftover model axis land on the sequence dim")
    ap.add_argument("--distributed", action="store_true",
                    help="one process a card: join torchrun's process group and train "
                         "on a mesh over its ranks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.distributed:
        from repro_torch.launch.mesh import init_distributed
        init_distributed(args.device)

    from repro_torch.data import DataConfig
    from repro_torch.models.registry import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    mesh = None
    if args.model_parallel or args.distributed:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=args.model_parallel or 1, device=args.device)
    trainer = Trainer(
        cfg,
        data_cfg,
        opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        microbatches=args.microbatches,
        compress_grads=args.compress_grads or args.error_feedback,
        error_feedback=args.error_feedback,
        mesh=mesh,
        sharding_rules={"seq": (("model",), ())} if args.seq_shard else None,
        device=None if mesh is not None else args.device,
    )
    quiet = args.distributed and trainer.placed and _rank() != 0
    history = trainer.run(args.steps, log_fn=(lambda *_: None) if quiet else print)
    if not quiet:
        print(f"final loss {history[-1]:.4f} (start {history[0]:.4f}); "
              f"stragglers: {trainer.stragglers}")
    return history


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


if __name__ == "__main__":
    main()
