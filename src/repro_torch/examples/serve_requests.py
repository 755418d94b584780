"""End-to-end live serving: a request stream through the real engine.

Drives `repro_torch.serve.loop.ServeLoop` — admission queue gated by the
paged KV manager, continuous batching of decode steps (rows join and leave
the batch between steps, each at its own cache position), and the offload
scheduler pricing every batch's projection matmuls on the pSRAM mesh
against the measured host — on a seeded synthetic Poisson stream
(`repro_torch.serve.traffic`). Prints the latency/throughput digest plus the
modeled-vs-measured offload trail, then verifies the pool drained leak-free.

Run:  python -m repro_torch.examples.serve_requests [--device cpu]
      python -m repro_torch.examples.serve_requests --smoke   # asserts a leak-free drain
"""
import argparse

from repro_torch import obs
from repro_torch._device import as_device
from repro_torch.models.registry import get_config, get_module
from repro_torch.serve import (
    OffloadScheduler,
    ServeLoop,
    ServeLoopConfig,
    TrafficConfig,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="fewer requests, asserts a leak-free "
                         "drain and exits nonzero on failure")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--rate", type=float, default=60.0,
                    help="mean arrival rate (requests/s of simulated time)")
    ap.add_argument("--arrival", choices=("poisson", "bursty"),
                    default="poisson")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Perfetto trace of every engine phase")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda raises without a card)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)
    if args.trace:
        obs.enable()

    cfg = get_config("granite_8b").reduced()
    params = get_module(cfg).init(0, cfg, device=dev)
    n = args.requests or (24 if args.smoke else 96)
    tc = TrafficConfig(
        n_requests=n, seed=args.seed, arrival=args.arrival,
        rate_rps=args.rate, prompt_min=2, prompt_max=24,
        decode_min=2, decode_max=16, vocab_size=cfg.vocab_size)
    loop = ServeLoop(
        cfg, params,
        ServeLoopConfig(max_batch=4, num_pages=24, page_size=8,
                        speedup=200.0),
        scheduler=OffloadScheduler(n_arrays=4), device=dev)

    print(f"serving {n} {args.arrival} requests at {args.rate:g} req/s "
          f"(seed {args.seed})...")
    rep = loop.run_sync(tc)
    s = rep.summary()
    print(f"  completed {s['completed']}  rejected {s['rejected']}  "
          f"preemptions {s['preemptions']}")
    print(f"  latency  p50 {s['p50_latency_s']*1e3:7.1f} ms   "
          f"p99 {s['p99_latency_s']*1e3:7.1f} ms")
    print(f"  ttft     p50 {s['p50_ttft_s']*1e3:7.1f} ms   "
          f"p99 {s['p99_ttft_s']*1e3:7.1f} ms")
    print(f"  sustained {s['throughput_rps']:.1f} req/s, "
          f"{s['throughput_tok_s']:.0f} tok/s over {s['duration_s']:.2f} s")
    print(f"  kv pool: peak util {s['peak_utilization']:.2f}, "
          f"mean frag {s['mean_fragmentation']:.2f}, "
          f"leaked pages {s['leaked_pages']}")
    print(f"  offload: {s['offload_fraction']:.0%} of {rep.n_steps} decode "
          f"batches routed to the pSRAM mesh — modeled makespan "
          f"{s['mean_modeled_step_s']*1e9:.1f} ns/step vs measured host "
          f"{s['mean_measured_step_s']*1e6:.0f} us/step")

    if args.trace:
        print(f"  wrote {obs.write_trace(args.trace)} trace events "
              f"to {args.trace}")
    # the smoke contract: everything admitted or rejected explicitly, and
    # the paged pool drains with zero leaked pages
    assert s["leaked_pages"] == 0, "KV pages leaked at drain"
    assert s["completed"] + s["rejected"] == n
    assert s["completed"] > 0 and s["throughput_tok_s"] > 0
    if args.smoke:
        print("smoke OK: drained leak-free")
    # the device of what the loop computed: its paged KV slab
    return {"device": str(loop.slab.device), "requests": n, "n_steps": rep.n_steps, **s}


if __name__ == "__main__":
    main()
