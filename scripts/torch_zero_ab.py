#!/usr/bin/env python3
"""``chip_smoke.py`` phase 17 (e) against a given checkout's ``src/``, for
an A/B of two checkouts on one card: ZeRO-1 and ZeRO-3 over four lanes of
the card against the replicated step, and ZeRO-3 again with the root lane
held back before each lane reduce (``chip_smoke.root_held_back``), so that
work which reads a reduce's sum without waiting for the root's stream reads
it unwritten:

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python scripts/torch_zero_ab.py --src path/to/checkout/src

Run it alternately for the checkouts (A, B, A, B), one process each. It
prints each run's line as phase 17 (e) does (losses, ms a step, whether
losses and params are bitwise the replicated step's, the largest param
difference and the leaves off), then ``ALL BITWISE`` or ``FAILED: ...``.
Exits 0 either way. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the src/ directory of the checkout to run")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke  # first: it puts this checkout's src/ at the front of sys.path

    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch

    print("repro_torch from", repro_torch.__file__, flush=True)
    try:
        chip_smoke.zero_lanes()
        print("ALL BITWISE", flush=True)
    except AssertionError as e:
        print("FAILED:", e, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
