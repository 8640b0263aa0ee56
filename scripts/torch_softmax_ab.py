#!/usr/bin/env python3
"""Time the port's row-softmax kernel at every block_rows it takes, at
``chip_smoke.py`` phase 7's softmax shapes (bf16 64 x 92,416, a 64-row
pack's logits over codeqwen1.5-7b's vocabulary; f32 4096 x 1024 attention
scores) and their tails (bf16 37 x 92,416, f32 37 x 1,000), for an A/B of
two checkouts on one card:

    python scripts/torch_softmax_ab.py --src path/to/checkout/src

Run it alternately for the checkouts on one card (A, B, B, A): each process
builds that checkout's kernels at first use, checks each output against the
plain version (each element within ``chip_smoke.SOFTMAX_RTOL`` of its own
value, plus 1e-6 of its row's largest) and prints one JSON line per shape
with the card, the checkout, and each block_rows' device ms, the median of
ROUNDS timings (``chip_smoke.time_ms``: one CUDA graph replay of 30 calls
between CUDA events, L2 warm), beside ``torch.softmax``'s timed the same
way. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = (((64, 92416), "bfloat16"), ((4096, 1024), "float32"), ((37, 92416), "bfloat16"),
          ((37, 1000), "float32"))
ROUNDS = 7


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the src/ directory of the checkout to time")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of chip_smoke's own src/

    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import softmax as smk

    if not torch.cuda.is_available():
        print("torch_softmax_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def median_ms(fn):
        return statistics.median(cs.time_ms(fn) for _ in range(ROUNDS))

    for (r, c), dtype in SHAPES:
        dt = getattr(torch, dtype)
        x = (torch.randn(r, c, generator=gen, device="cuda") * 4).to(dt)
        want = ref.softmax(x).float()
        rtol = cs.SOFTMAX_RTOL[dtype]
        limit = rtol * want.abs() + 1e-6 * want.abs().amax(-1, keepdim=True)
        ms = {}
        for rows in smk.BLOCK_ROWS:
            got = smk.softmax(x, block_rows=rows).float()
            if not ((got - want).abs() <= limit).all():
                raise AssertionError(f"{r} x {c} {dtype} block_rows={rows}: max_abs_err "
                                     f"{(got - want).abs().max().item()}")
            ms[rows] = median_ms(lambda: smk.softmax(x, block_rows=rows))
        routes = ({rows: smk.route(r, c, dt, rows) for rows in smk.BLOCK_ROWS}
                  if hasattr(smk, "route") else None)
        print(json.dumps({"card": card, "src": str(Path(smk.__file__).resolve().parents[2]),
                          "shape": [r, c], "dtype": dtype, "ms_by_block_rows": ms,
                          "routes": routes, "torch_softmax_ms": median_ms(
                              lambda: torch.softmax(x, -1))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
