#!/usr/bin/env python3
"""Time the port's decode, ragged, paged and GQA flash attention kernels at
the serving path's main shapes (``chip_smoke.py`` phase 2's dense shapes and
timer: codeqwen1.5-7b, bf16, KV=32, G=1, d=128, 4 slots x 1024 positions; a
64-token pack; a 64-token prefill of 32 KV rows; the grouped decode at KV=8,
G=8 over the same slots), decode, ragged and paged
attention over the same cache as int8 rows with their scales (the paged
pool: the cache's rows as 32-position blocks under a reversed table), and
the flat flash attention of phase 7 (32 heads of 1024 tokens, causal) at
each bf16 tile of the checkout, for an A/B of two checkouts on one card:

    python scripts/torch_attention_ab.py --src path/to/checkout/src

Run it alternately for two checkouts on one card, one after the other (A, B,
B, A): each process builds that checkout's kernels at first use, then prints
one JSON line with the card, the checkout and the median of ROUNDS timings of
REPS launches each (one CUDA graph replay between CUDA events, so host time
between launches is not counted; L2 warm). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPS, ROUNDS, WARMUP = 200, 7, 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the src/ directory of the checkout to time")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of chip_smoke's own src/

    import torch

    from repro_torch.dist.compression import quantize_rows
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ragged_attention as rk

    if not torch.cuda.is_available():
        print("torch_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    KV, D = 32, 128

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)

    k, v = randn(cs.SLOTS, cs.S_MAX, KV, D), randn(cs.SLOTS, cs.S_MAX, KV, D)
    q_dec, q_rag = randn(cs.SLOTS, KV, 1, D), randn(len(cs.PACK_SLOTS), KV, 1, D)
    cur, slots, poss = ints(cs.DECODE_POS), ints(cs.PACK_SLOTS), ints(cs.PACK_POS)
    q_pre, k_pre, v_pre = randn(KV, 1, 64, D), randn(KV, 64, D), randn(KV, 64, D)
    q_grp = randn(cs.SLOTS, 8, 8, D)
    k_grp, v_grp = randn(cs.SLOTS, cs.S_MAX, 8, D), randn(cs.SLOTS, cs.S_MAX, 8, D)
    q_api, k_api, v_api = randn(32, 1024, D), randn(32, 1024, D), randn(32, 1024, D)
    (k8, ks), (v8, vs) = quantize_rows(k.float(), torch.int8), quantize_rows(v.float(), torch.int8)
    sc = dict(k_scale=ks, v_scale=vs)
    nb, bs = cs.SLOTS * cs.S_MAX // 32, 32

    def pool(t):  # the cache's rows as pool blocks, in reverse order
        return t.reshape(nb, bs, *t.shape[2:]).flip(0).contiguous()

    tables = (nb - 1 - torch.arange(nb, dtype=torch.int32, device=dev)).reshape(cs.SLOTS, -1)
    pk_, pv_, pk8, pv8 = pool(k), pool(v), pool(k8), pool(v8)
    psc = {n: pool(t) for n, t in sc.items()}
    kernels = {
        "decode_attention": lambda: dk.decode_attention(q_dec, k, v, cur),
        "ragged_attention": lambda: rk.ragged_attention(q_rag, k, v, slots, poss),
        "paged_attention": lambda: pk.paged_attention(q_rag, pk_, pv_, slots, poss, tables),
        "decode_attention_q8": lambda: dk.decode_attention(q_dec, k8, v8, cur, **sc),
        "ragged_attention_q8": lambda: rk.ragged_attention(q_rag, k8, v8, slots, poss, **sc),
        "paged_attention_q8": lambda: pk.paged_attention(q_rag, pk8, pv8, slots, poss, tables,
                                                         **psc),
        "gqa_flash_attention": lambda: fk.gqa_flash_attention(q_pre, k_pre, v_pre),
        # the grouped decode (KV 8, G 8) over the same slots
        "decode_attention G=8": lambda: dk.decode_attention(q_grp, k_grp, v_grp, cur),
    }
    # the tiles a checkout has (a tuple of tiles before they differed by dtype)
    tiles = fk.TILES[torch.bfloat16] if isinstance(fk.TILES, dict) else fk.TILES
    for tq, tk in tiles:
        kernels[f"flash_attention {tq}x{tk}"] = (
            lambda tq=tq, tk=tk: fk.flash_attention(q_api, k_api, v_api, block_q=tq, block_k=tk))
    out = {}
    for name, fn in kernels.items():
        times = [cs.time_ms(fn, reps=REPS, warmup=WARMUP) for _ in range(ROUNDS)]
        out[name] = {"median_ms": statistics.median(times), "rounds_ms": times}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "src": args.src, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
