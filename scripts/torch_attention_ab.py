#!/usr/bin/env python3
"""Time the port's decode, ragged, paged and GQA flash attention kernels at
the serving path's main shapes (``chip_smoke.py`` phase 2's dense shapes and
timer: codeqwen1.5-7b, bf16, KV=32, G=1, d=128, 4 slots x 1024 positions; a
64-token pack; a 64-token prefill of 32 KV rows; the grouped decode at KV=8,
G=8 over the same slots), decode, ragged and paged
attention over the same cache as int8 rows with their scales (the paged
pool: the cache's rows as 32-position blocks under a reversed table), paged
attention at phase 2's paged shapes (phase 5's traffic: an 8-sequence
decode through ``ops.paged_decode_attention`` over a shuffled pool of
32-position blocks, bf16 and int8, and the grouped one at KV=8, G=8 over
16-position blocks; a 64-token pack over the same pools), every ragged
case of phase 2 (``chip_smoke.RAGGED_CASES`` and ``RAGGED_Q8_CASES``: f32
queries, the grouped shape, windows, fp8 and scaled f32 stores; and the
main packs, bf16 and int8, and a 64-token chunk at positions 900-963, at 1,
2 and 4 splits where the checkout's wrapper takes ``splits``), and
the flat flash attention of phase 7 (32 heads of 1024 tokens, causal) at
each bf16 tile of the checkout, and the latent-MQA kernel over phase 2's
64-token pack at minicpm3-4b's widths (latent 256 + rope 32, 40 heads) and
deepseek-v2-lite's (512 + 64, 16 heads), bf16, at 1, 2 and 4 splits too
where the checkout's wrapper takes ``splits``, for an A/B of two checkouts
on one card.
Each kernel's output is digested (sha256 of its bytes), so two checkouts
whose kernels should agree bit for bit can be compared:

    python scripts/torch_attention_ab.py --src path/to/checkout/src

Run it alternately for two checkouts on one card, one after the other (A, B,
B, A): each process builds that checkout's kernels at first use, then prints
one JSON line with the card, the checkout and the median of ROUNDS timings of
REPS launches each (one CUDA graph replay between CUDA events, so host time
between launches is not counted; L2 warm). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
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
    import numpy as np

    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import mla_attention as mk
    from repro_torch.kernels import ops
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
    # phase 2's paged shapes: 8 sequences over a shuffled pool, a decode and a pack
    cur_p = ints(cs.PAGED_CUR)
    # (named apart from the dense pack's slots/poss, which the lambdas above
    # read when they run)
    seqs_p, poss_p = (ints(x) for x in cs.paged_tokens("pack", cs.PAGED_CUR, cs.S_MAX))
    for tag, kv, g, bs, quant in (("", KV, 1, 32, False), (" int8", KV, 1, 32, True),
                                  (" G=8", 8, 8, 16, False)):
        nb, tab = cs.paged_pool_tables(np.random.default_rng(1), cs.PAGED_CUR, bs)
        tab = torch.from_numpy(tab).to(dev)
        pk_p, pv_p = randn(nb + 1, bs, kv, D), randn(nb + 1, bs, kv, D)
        psc_p = {}
        if quant:
            (pk_p, ks_p), (pv_p, vs_p) = (quantize_rows(t.float(), torch.int8)
                                          for t in (pk_p, pv_p))
            psc_p = dict(k_scale=ks_p, v_scale=vs_p)
        qd = randn(len(cs.PAGED_CUR), kv * g, D)
        qp = randn(seqs_p.numel(), kv, g, D)
        kernels[f"paged decode{tag}"] = (
            lambda qd=qd, k_=pk_p, v_=pv_p, t_=tab, s_=psc_p:
            ops.paged_decode_attention(qd, k_, v_, cur_p, t_, **s_))
        kernels[f"paged pack{tag}"] = (
            lambda qp=qp, k_=pk_p, v_=pv_p, t_=tab, s_=psc_p:
            pk.paged_attention(qp, k_, v_, seqs_p, poss_p, t_, **s_))
    # phase 2's ragged cases over the 64-token pack; the main ones at 1, 2
    # and 4 splits where the wrapper takes splits
    params = inspect.signature(rk.ragged_attention).parameters
    for n in ((1, 2, 4) if "splits" in params else ()):
        kernels[f"ragged_attention splits={n}"] = (
            lambda n=n: rk.ragged_attention(q_rag, k, v, slots, poss, splits=n))
        kernels[f"ragged_attention_q8 splits={n}"] = (
            lambda n=n: rk.ragged_attention(q_rag, k8, v8, slots, poss, splits=n, **sc))
    # a 64-token chunk deep in one slot (positions 900-963), every tile's
    # keys past several spans, at the kernel's own and at forced splits
    deep = ints([2] * 64), ints(list(range(900, 964)))
    for n in ((None, 1, 2, 4) if "splits" in params else ()):
        kernels[f"ragged deep chunk splits={n}"] = (
            lambda n=n: rk.ragged_attention(q_rag, k, v, *deep, splits=n))
    cases = [(None, *c) for c in cs.RAGGED_CASES] + list(cs.RAGGED_Q8_CASES)
    for store, kv, g, dname, window in cases:
        dtype = getattr(torch, dname)
        q_c = torch.randn(len(cs.PACK_SLOTS), kv, g, D, generator=gen, device=dev).to(dtype)
        k_c, v_c = (torch.randn(cs.SLOTS, cs.S_MAX, kv, D, generator=gen, device=dev)
                    for _ in "kv")
        sc_c = {}
        if store is None:
            k_c, v_c = k_c.to(dtype), v_c.to(dtype)
        elif store == "f32 rand":
            sc_c = {n: torch.rand(k_c.shape[:-1], generator=gen, device=dev) + 0.5
                    for n in ("k_scale", "v_scale")}
        else:
            kind = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "f32": torch.float32}[store]
            (k_c, ks_c), (v_c, vs_c) = quantize_rows(k_c, kind), quantize_rows(v_c, kind)
            sc_c = dict(k_scale=ks_c, v_scale=vs_c)
        kernels[f"ragged {store or 'plain'} KV={kv} G={g} q={dname} win={window}"] = (
            lambda q_=q_c, k_=k_c, v_=v_c, s_=sc_c, w_=window:
            rk.ragged_attention(q_, k_, v_, slots, poss, window=w_, **s_))
    # the tiles a checkout has (a tuple of tiles before they differed by dtype)
    tiles = fk.TILES[torch.bfloat16] if isinstance(fk.TILES, dict) else fk.TILES
    for tq, tk in tiles:
        kernels[f"flash_attention {tq}x{tk}"] = (
            lambda tq=tq, tk=tk: fk.flash_attention(q_api, k_api, v_api, block_q=tq, block_k=tk))
    # the latent-MQA kernel over phase 2's pack, chip_smoke's scale (a nope
    # width of r / 4)
    mla_splits = (None, 1, 2, 4) if "splits" in inspect.signature(mk.mla_attention).parameters \
        else (None,)
    for tag, r, rope, h in (("minicpm3", 256, 32, 40), ("deepseek", 512, 64, 16)):
        margs = (randn(len(cs.PACK_SLOTS), h, r), randn(len(cs.PACK_SLOTS), h, rope),
                 randn(cs.SLOTS, cs.S_MAX, r), randn(cs.SLOTS, cs.S_MAX, rope), slots, poss)
        for n in mla_splits:
            kw = {} if n is None else {"splits": n}
            kernels[f"mla_attention {tag}" + ("" if n is None else f" splits={n}")] = (
                lambda a=margs, s_=(r // 4 + rope) ** -0.5, kw=kw:
                mk.mla_attention(*a, scale=s_, **kw))
    out = {}
    for name, fn in kernels.items():
        res = fn().contiguous()
        torch.cuda.synchronize()
        digest = hashlib.sha256(res.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]
        times = [cs.time_ms(fn, reps=REPS, warmup=WARMUP) for _ in range(ROUNDS)]
        out[name] = {"median_ms": statistics.median(times), "rounds_ms": times,
                     "sha256": digest}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "src": args.src, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
