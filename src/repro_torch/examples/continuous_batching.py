"""Continuous batching under pressure: Poisson vs bursty on a small pool.

The same live engine as ``repro_torch.examples.serve_requests``, but on a
deliberately tight page pool so the interesting machinery fires: bursts
overrun the admission reservation, mid-decode page allocation fails, and the
loop preempts the youngest row (recompute-style — pages recycle, the request
re-enters the queue head). Contrasts a Poisson stream with a bursty
(Markov-modulated) one at the same mean rate: identical offered load, very
different tail latency, preemption count, and fragmentation.

Run:  python -m repro_torch.examples.continuous_batching [--device cpu]
"""
import argparse

from repro_torch._device import as_device
from repro_torch.models.registry import get_config, get_module
from repro_torch.serve import ServeLoop, ServeLoopConfig, TrafficConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)

    cfg = get_config("granite_8b").reduced()
    params = get_module(cfg).init(0, cfg, device=dev)
    # 10 pages x 4 tokens = 40 slots shared by up to 4 rows: long decodes
    # must collide. The speedup is set so the mean wall inter-arrival sits
    # comfortably above one decode step (Poisson = underload) while a
    # 10x burst overruns it (bursty = transient overload, same mean rate).
    lc = ServeLoopConfig(max_batch=4, num_pages=10, page_size=4,
                         speedup=2.0)

    results, out = {}, {}
    for arrival in ("poisson", "bursty"):
        tc = TrafficConfig(
            n_requests=32, seed=11, arrival=arrival, rate_rps=80.0,
            burst_factor=10.0, prompt_min=2, prompt_max=12,
            decode_min=4, decode_max=24, vocab_size=cfg.vocab_size)
        loop = ServeLoop(cfg, params, lc, device=dev)
        # run every shape bucket once first (the library's kernel choices,
        # the hand-written kernels' builds) so the measured run reflects
        # steady state
        loop.warmup(max_prompt=12, max_decode=24)
        rep = loop.run_sync(tc)
        results[arrival] = rep
        s = rep.summary()
        assert s["leaked_pages"] == 0
        print(f"[{arrival:7s}] completed={s['completed']:2d} "
              f"preemptions={s['preemptions']:3d} "
              f"p50={s['p50_latency_s']*1e3:7.1f}ms "
              f"p99={s['p99_latency_s']*1e3:7.1f}ms "
              f"peak_util={s['peak_utilization']:.2f} "
              f"frag={s['mean_fragmentation']:.2f}")
        out[arrival] = s
        # the device of what the loop computed: its paged KV slab
        device = str(loop.slab.device)

    po, bu = results["poisson"], results["bursty"]
    p50x = bu.p50_latency_s / max(po.p50_latency_s, 1e-9)
    p99x = bu.p99_latency_s / max(po.p99_latency_s, 1e-9)
    print(f"\nsame mean rate, different shape: the bursty stream stretched "
          f"p50 {p50x:.1f}x and "
          f"p99 {p99x:.1f}x over "
          f"Poisson (preemptions {bu.preemptions} vs {po.preemptions}) — "
          f"spread-out arrivals mostly wait on pages, a burst waits on the "
          f"queue too; preempted requests recompute from their prompt, "
          f"trading wasted decode work for guaranteed forward progress of "
          f"the oldest row.")
    return {"device": device, **out, "p50_stretch": p50x, "p99_stretch": p99x}


if __name__ == "__main__":
    main()
