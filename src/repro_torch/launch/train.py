"""Training launcher: the reference's flags, on one device.

    python -m repro_torch.launch.train --arch granite_8b --reduced \\
        --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given (and raises without
one). Weights are random from a seed; the data is the synthetic Zipf stream
of ``data.pipeline``. The reference's ``--model-parallel``, ``--seq-shard``
and ``--distributed`` train under ``dist.sharding`` on a mesh and come with
ROADMAP Queue A item 9b; here they raise.
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
                    help="a (data, model) mesh with this model-axis size (item 9b)")
    ap.add_argument("--seq-shard", action="store_true",
                    help="let leftover model axis land on the sequence dim (item 9b)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host initialization (item 9b)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    for flag, on in (("--model-parallel", args.model_parallel), ("--seq-shard", args.seq_shard),
                     ("--distributed", args.distributed)):
        if on:
            raise NotImplementedError(f"{flag} trains on a mesh under dist.sharding, which "
                                      "comes with ROADMAP Queue A item 9b")

    from repro_torch.data import DataConfig
    from repro_torch.models.registry import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    trainer = Trainer(
        cfg,
        data_cfg,
        opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        microbatches=args.microbatches,
        compress_grads=args.compress_grads or args.error_feedback,
        error_feedback=args.error_feedback,
        device=args.device,
    )
    history = trainer.run(args.steps)
    print(f"final loss {history[-1]:.4f} (start {history[0]:.4f}); "
          f"stragglers: {trainer.stragglers}")
    return history


if __name__ == "__main__":
    main()
