#!/usr/bin/env python3
"""Time the port's matmul and conv2d kernels for an A/B of two checkouts on
one card: the bf16 matmul at M = 16, 37, 64 and 256 live tokens over
codeqwen1.5-7b's w_in shape (K 4096, N 13440; ``chip_smoke.py``'s MATMUL_M
above 8), the int8-weight matmul (``matmul_q8``: the serving path's GEMV at
M = 1, 4 and 8, and at M = 16, 37 and 64 the body the checkout routes
there) over w_in and the down projection (K 13440, N 4096), the bf16 GEMV
at M = 1, 4 and 8 over both with ``torch.matmul`` timed beside it, and
conv2d at ``chip_smoke.CONV_MAIN`` (bf16 [4, 512, 512, 256] x [3, 3, 256,
256]), each with the kernel's own choice of knobs:

    python scripts/torch_gemm_ab.py --src path/to/checkout/src

``--splits`` times ``matmul_q8`` at M = 16, 37 and 64 over w_in, the down
projection and K = N = 4096 at every forced ``split_k`` of 1, 2, 4, 8 and
16 instead (the K-split rule's sweep).

Run it alternately for two checkouts on one card, one after the other (A, B,
B, A): each process builds that checkout's kernels at first use, then prints
one JSON line with the card, the checkout and the median of ROUNDS timings
(one CUDA graph replay of REPS launches between CUDA events, so host time
between launches is not counted; L2 warm), each output checked against the
plain version first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROUNDS, WARMUP = 7, 3
REPS = {"matmul": 100, "conv2d": 10}
M_TILE = (16, 37, 64, 256)
M_ROWS = (16, 37, 64)  # matmul_q8 above the decode GEMV's 8 rows
K, N = 4096, 13440


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the src/ directory of the checkout to time")
    ap.add_argument("--splits", action="store_true",
                    help="sweep matmul_q8's forced split_k at M 16, 37 and 64 instead")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of chip_smoke's own src/

    import torch

    from repro_torch.kernels import conv2d as cvk
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        print("torch_gemm_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    b = randn(K, N)
    q8 = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.rand(N, generator=gen, device=dev) * 0.01
    # the down projection's weights (K 13440, N 4096)
    b_dn = randn(N, K)
    q8_dn = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
    scale_dn = torch.rand(K, generator=gen, device=dev) * 0.01
    # the serving path's int8 GEMVs first, in a fresh process: timed after the
    # bf16 tiles it read 4% apart between two checkouts whose GEMV is the same
    kernels = {}  # name -> (kernel, plain, kind)
    if args.splits:
        q8_sq = torch.randint(-127, 128, (K, K), generator=gen, device=dev, dtype=torch.int8)
        weights = {"w_in": (q8, scale), "down": (q8_dn, scale_dn),
                   "4096x4096": (q8_sq, scale_dn)}
        for m in M_ROWS:
            for tag, (w, sc) in weights.items():
                a = randn(m, w.shape[0])
                for split_k in (1, 2, 4, 8, 16):
                    kernels[f"matmul_q8 M={m} {tag} split_k={split_k}"] = (
                        lambda a=a, w=w, sc=sc, split_k=split_k: mmk.matmul_q8(
                            a, w, sc, split_k=split_k),
                        lambda a=a, w=w, sc=sc: ref.matmul_q8(a, w, sc), "matmul")
    m_q8 = M_ROWS if args.splits else (1, 4, 8) + M_ROWS  # the kernel's own K splits
    for m in m_q8:
        a = randn(m, K)
        kernels[f"matmul_q8 M={m}"] = (lambda a=a: mmk.matmul_q8(a, q8, scale),
                                       lambda a=a: ref.matmul_q8(a, q8, scale), "matmul")
    for m in m_q8:
        a = randn(m, N)
        kernels[f"matmul_q8 M={m} down"] = (lambda a=a: mmk.matmul_q8(a, q8_dn, scale_dn),
                                            lambda a=a: ref.matmul_q8(a, q8_dn, scale_dn),
                                            "matmul")
    # the bf16 GEMV at decode widths, and cuBLAS beside it (torch.matmul)
    for m in () if args.splits else (1, 4, 8):
        for tag, a, w in ((f"M={m}", randn(m, K), b), (f"M={m} down", randn(m, N), b_dn)):
            kernels[f"matmul {tag}"] = (lambda a=a, w=w: mmk.matmul(a, w),
                                        lambda a=a, w=w: ref.matmul(a, w), "matmul")
            kernels[f"torch.matmul {tag}"] = (lambda a=a, w=w: torch.matmul(a, w),
                                              lambda a=a, w=w: ref.matmul(a, w), "matmul")
    for m in () if args.splits else M_TILE:
        a = randn(m, K)
        kernels[f"matmul M={m}"] = (lambda a=a: mmk.matmul(a, b), lambda a=a: ref.matmul(a, b),
                                    "matmul")
    if not args.splits:
        (xs, ws) = cs.CONV_MAIN
        x, w = randn(*xs), randn(*ws)
        kernels["conv2d CONV_MAIN"] = (lambda: cvk.conv2d(x, w), lambda: ref.conv2d(x, w),
                                       "conv2d")
    out = {}
    for name, (fn, plain, kind) in kernels.items():
        got, want = fn().float(), plain().float()
        if kind == "matmul":
            ok = (got - want).abs().max().item() <= cs.MATMUL_REL_TOL["bfloat16"] * \
                want.abs().max().item()
        else:
            tol = cs.SUITE_TOL["conv2d"]["bfloat16"]
            ok = bool(((got - want).abs() <= tol * (want.abs() + want.pow(2).mean().sqrt())).all())
        if not ok:
            raise AssertionError(f"{name}: the kernel disagrees with its plain version")
        del got, want
        times = [cs.time_ms(fn, reps=REPS[kind], warmup=WARMUP) for _ in range(ROUNDS)]
        out[name] = {"median_ms": statistics.median(times), "rounds_ms": times}
        if name.startswith("matmul_q8"):  # the body this checkout routes M to
            m_ = int(name.split("M=")[1].split()[0])
            out[name]["body"] = mmk.route(m_, K, N, torch.bfloat16, torch.int8)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "src": args.src, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
