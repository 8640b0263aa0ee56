#!/usr/bin/env python3
"""Time the port's Stockham FFT kernel at every block_rows it takes, at
``chip_smoke.py`` phase 8's FFT shapes (f32 [8192, 16384], the paper's
16k-point rows; f32 [65536, 1024]; bf16 [4096, 4096]; f32 [37, 64]) and
through the four-step path (f32 [1024, 32768]), for an A/B of two checkouts
on one card:

    python scripts/torch_fft_ab.py --src path/to/checkout/src

Run it alternately for the checkouts on one card (A, B, B, A): each process
builds that checkout's kernels at first use, checks each output against the
plain version and prints one JSON line per shape with the card, the
checkout, and each block_rows' device ms, the median of ROUNDS timings
(``chip_smoke.time_ms``: one CUDA graph replay of 10 calls between CUDA
events, L2 warm), beside cuFFT's (``torch.fft.fft`` over a complex64 tensor
made beforehand) timed the same way. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = (((8192, 16384), "float32"), ((65536, 1024), "float32"), ((4096, 4096), "bfloat16"),
          ((37, 64), "float32"), ((1024, 32768), "float32"))
ROUNDS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the src/ directory of the checkout to time")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of chip_smoke's own src/

    import torch

    from repro_torch.kernels import fft as ffk
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("torch_fft_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def median_ms(fn):
        return statistics.median(cs.time_ms(fn, reps=10) for _ in range(ROUNDS))

    for (b, n), dtype in SHAPES:
        dt = getattr(torch, dtype)
        re = torch.randn(b, n, generator=gen, device="cuda").to(dt)
        im = torch.randn(b, n, generator=gen, device="cuda").to(dt)
        want = ref.fft(re, im)
        scale = max(w.float().abs().max().item() for w in want)
        tol = 1e-5 if dtype == "float32" else 1e-2
        ms = {}
        for rows in ffk.BLOCK_ROWS:
            if not ffk.fits(n, rows):
                continue
            got = ffk.fft(re, im, block_rows=rows)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            if not err <= tol * scale:
                raise AssertionError(f"[{b}, {n}] {dtype} block_rows={rows}: {err} > {tol} * {scale}")
            ms[rows] = median_ms(lambda: ffk.fft(re, im, block_rows=rows))
        z = torch.complex(re.float(), im.float())
        cufft = median_ms(lambda: torch.fft.fft(z, dim=-1))
        print(json.dumps({"card": card, "src": str(Path(ffk.__file__).resolve().parents[2]),
                          "shape": [b, n], "dtype": dtype, "ms_by_block_rows": ms,
                          "cufft_ms": cufft}), flush=True)
        del re, im, want, z
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
