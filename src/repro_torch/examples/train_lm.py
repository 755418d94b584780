"""End-to-end training run: train a small LM for a few hundred steps with
the full production stack — deterministic data pipeline, AdamW with warmup +
cosine, grad accumulation, async checkpointing with restart, straggler
watchdog.

Run:  python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""
import argparse
import tempfile

from repro_torch._device import as_device
from repro_torch.data import DataConfig
from repro_torch.models.registry import get_config
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)

    cfg = get_config(args.arch).reduced()
    n = cfg.param_count()
    print(f"training reduced {cfg.name}: {n/1e6:.1f}M params")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=16)
    with tempfile.TemporaryDirectory() as ckpt:
        tr = Trainer(
            cfg, data,
            opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
            ckpt_dir=ckpt, ckpt_every=100, microbatches=2, device=dev,
        )
        hist = tr.run(args.steps, log_every=25)
        median_s = sorted(tr.step_times)[len(tr.step_times) // 2]
        print(f"\nloss: {hist[0]:.3f} -> {hist[-1]:.3f} over {args.steps} steps")
        print(f"median step time: {median_s*1e3:.0f} ms; "
              f"stragglers flagged: {len(tr.stragglers)}")
        # simulate a restart: a fresh Trainer must resume from the checkpoint
        tr2 = Trainer(cfg, data, ckpt_dir=ckpt, device=dev)
        print(f"restart test: resumed at step {tr2.start_step} (expected {args.steps})")
        assert tr2.start_step == args.steps, "the restart missed its step"
        device = str(tr2.params["embed"].device)
    return {
        "device": device, "params": n, "steps": args.steps,
        "loss_first": hist[0], "loss_last": hist[-1], "median_step_s": median_s,
        "stragglers": len(tr.stragglers), "resumed_at": tr2.start_step,
    }


if __name__ == "__main__":
    main()
