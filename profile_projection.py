"""One rank's row-parallel pSRAM decode projection on one card, profiled.

    python3 profile_projection.py [--src DIR] [--out FILE]

Runs ``chip_smoke.projection_calls``: granite-8b's o and down projections at
a rank's K slice over four cards (8 bf16 rows), called as a served model
calls them (``layers._proj`` on a weight placed row-parallel on a world-1
mesh), under ``torch.profiler``: each call's launches, device time and
CUDA-event time, by operation. The ``repro_torch`` package is the one in
DIR (default: this checkout's ``src``); it builds its own kernels. To
compare two trees on one card, run it against each in turns (A, B, B, A)
in one command. Prints the card's name and power limit, then one JSON
line; exits non-zero where there is no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="the directory that holds the repro_torch package to profile")
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    opts = parser.parse_args(argv)
    src = opts.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"profile_projection: no repro_torch package in {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401  (the package in DIR, before chip_smoke adds this tree's)
    import torch

    if not torch.cuda.is_available():
        print("profile_projection: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    with chip_smoke.world_of_one() as mesh:
        calls = chip_smoke.projection_calls(torch, mesh)
    result = {"src": str(src), "package": str(Path(repro_torch.__file__).parent),
              "projection": calls}
    if opts.out is not None:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(result, indent=1))
    print(chip_smoke.smi_line(), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
