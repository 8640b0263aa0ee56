#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

0. device — fail without CUDA; print the card's name and power limit.
1. build — compile the hand-written CUDA kernels from ``csrc/`` (eleven
   sources over the shared Hopper header ``gemm_wgmma.cuh``, twenty-one
   kernel bodies: decode attention (split-KV: the position range split over
   blocks that stream K/V through a cp.async ring, partials merged in split
   order), ragged and paged attention over a plain or a quantized
   store, flash attention (GQA, and flat as a group of one; bf16 on wgmma,
   f32 on CUDA cores), the matmul and int8-weight matmul (the decode GEMV
   on tensor cores, mma.sync over a cp.async ring, for bf16 activations;
   the CUDA-core GEMV for f32 and the tails; the bf16 tile on
   the header's wgmma + TMA mainloop), RMSNorm, row softmax (rows held in
   registers, a row split over a thread-block cluster, and the two-pass
   body), axpy, the partial dot products, the Stockham FFT (radix-16 passes
   in registers, persistent blocks prefetching their next tile by TMA bulk
   copies) and its four-step transposes, and the implicit-GEMM conv2d on
   the same mainloop); print the build's seconds.
2. kernels — each kernel body against its plain PyTorch version on the card,
   at the serving path's shapes (codeqwen1.5-7b: KV=32, G=1, d=128, 4 slots
   x 1024 positions; a 64-token ragged pack; 64- and 37-token prefill; an
   8-sequence paged decode over a fragmented pool with a shared prefix,
   block sizes 16 and 32), plus the GQA shape KV=8, G=8, a sliding window,
   f32 and bf16 queries, int8, fp8 and scaled f32 stores (bf16 queries over
   a scaled f32 store: the identity KV lane of a bf16 model); the matmuls at
   M = 4-256 live tokens over codeqwen's (K, N) and a shape with K and N
   tails, f32 and bf16 activations, each printed with the body it took;
   decode, ragged and paged attention at
   the new (head_dim, group) pairs (16, 1), (16, 4), (80, 2), (128, 5) and
   (128, 12) over bf16 and scaled int8 stores; decode at 1, 2 and 4 forced
   splits beside the kernel's own; GQA flash at every bf16 tile
   and head width. Times each kernel, its plain version and
   a one-call PyTorch yardstick (where one exists) as device time (CUDA events
   around one CUDA-graph replay of 30 calls, so the wrappers' host time is
   not counted), and computes its bound at the card's published peaks.
3. kernel path vs plain path — a small f32 model served greedily through
   ServeEngine on the card and on the CPU, dense, paged with prefix reuse,
   over int8 and fp8 caches, and with int8 weights (dense, and paged +
   prefix over an int8 cache), then the reduced codeqwen1.5-7b and
   qwen3-32b configs (head_dim 16, groups 1 and 4), dense and paged; the
   token streams must be equal.
4. full width — codeqwen1.5-7b, 32 layers, bf16, random weights from a seed,
   4 slots x 1024 positions; about 12 greedy requests whose prompts straddle
   the prefill budget, so fused admissions, ragged packs and decode chunks
   all run; each PR-11 kernel's launch count over this run must be > 0,
   and decode must have run the split body.
5. full width, paged and quantized — the same weights behind (a) a paged
   engine with prefix reuse serving a shared 512-token system prompt, (b)
   the same traffic over an int8 pool of (a)'s bytes, (c) phase 4's traffic
   over a dense int8 cache; in each run the counts are set to 0 just before
   the measured requests and read just after, the kernels that run drives
   must have launched (in (c) the split decode body), the prefix cache must
   hit, and each run's stream must
   agree with ``LM.prefill`` teacher-forced.
6. full width, int8 weights — phase 4's weights quantized on the card
   (``ServeEngine(weight_dtype="int8")``) serving (a) phase 4's traffic on a
   dense bf16 cache and (b) phase 5 (b)'s traffic on the paged int8 pool with
   prefix reuse; in each run ``matmul_q8`` must launch between the counts'
   reset and read (in (a) on the tensor-core GEMV), the stream must agree
   with the quantized model's
   ``LM.prefill`` teacher-forced, and the int8 block stack must take at most
   0.51x the bf16 one's bytes. Prints the int8 model's top-1 agreement with
   the bf16 model at clear margins (not gated).
7. the kernel API and its autotuner — flat flash attention (every tile of
   its dtype: the wgmma body's for bf16, SDPA timed beside each, the
   CUDA-core body's for f32; d = 80 too), RMSNorm and
   softmax at every rows-per-block candidate and the matmul at every
   wgmma tile x K split, against their plain versions at the main shapes
   (codeqwen1.5-7b, bf16: flash BH=32, S=1024, d=128, causal and not;
   RMSNorm 2048 x 4096; softmax 64 x 92,416 and 4096 x 1024 f32; matmul
   M = 4 and 256 over K=4096, N=13440) and ragged tails (S=96, R=37); a
   ``REPRO_AUTOTUNE=1`` sweep of ``ops.matmul`` and ``ops.flash_attention``
   into a JSON cache under build/ that a fresh tuner re-reads without
   measuring, tuned outputs against the default plan's; the four ops driven
   once through ``ops`` between the counts' reset and read (the M = 256
   matmul must launch the wgmma body, the M = 4 one the tensor-core GEMV,
   the 92,416-wide softmax the cluster
   body and the f32 scores the rows body); each new kernel timed beside its
   bound, plain version and library call, the M = 256 matmul as a row of
   its own (``matmul_tile``).
8. the paper's kernel suite — axpy, dotp, the Stockham FFT and conv2d at
   every block / rows / patch candidate against their plain versions at the
   main shapes (axpy and dotp over 2^28-element vectors, axpy also bf16
   [64, 2^22] at alpha 1/3; FFT f32 [8192, 16384], the paper's 16k-point
   rows, f32 [65536, 1024] and bf16 [4096, 4096], and rows past one block
   through the four-step path, f32 [1024, 32768] and [32, 2^20]; conv2d bf16
   [4, 512, 512, 256] x [3, 3, 256, 256], the paper's fconv2d widths, f32
   [2, 128, 128, 64] x [3, 3, 64, 64], and x and w of different dtypes) and
   tails (axpy [3, 1,000,003], dotp over
   1,000,003 elements and dotp_partials [8, 100,003] at every block, FFT
   [37, 64] and N = 2, conv2d with a ragged H and 1 x 1 taps); a
   ``REPRO_AUTOTUNE=1`` sweep of the four ops at their main shapes into
   phase 7's cache, re-read by a fresh tuner; the four ops (and the FFT over
   [1024, 32768] rows, whose five launches count as ``fft_long``) driven
   once through ``ops``
   between the counts' reset and read (conv2d must launch its wgmma body),
   each output held against its plain version; each op timed beside its
   bound, plain version and library call, conv2d on the wgmma body beside
   cuDNN, the FFT's radix-pass body at its three shapes and the four-step
   rows beside cuFFT.
9. a ``{"kernels": [...], "to_port": []}`` JSON line (every row of PERF.md's
   kernel table; the decode, matmul and matmul_q8 rows name the body their
   timed case ran and its launches), then the result line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor core, f32 CUDA core
# max |kernel - plain| allowed: at f32 both compute in f32 and differ only in
# summation order; at bf16 both compute in f32 from the same bf16 inputs and
# round the output once, so they differ by at most ~2 bf16 steps at |x| <= 1
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# max |kernel - plain| / max |plain| allowed for the matmuls (their outputs
# are not bounded by 1): at f32 both sum in f32 in different orders; at bf16
# both sum exact products in f32 and round the output once, so they differ
# by at most one bf16 step (2^-8 relative) of the largest output
MATMUL_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# phase 2's matmul shapes: M live tokens (decode 4-16, packs and admissions
# up to 64, longer prefills), codeqwen's (K, N) of the projections and the
# MLP, and one shape with K and N tails; the main case is a 4-slot decode
# step's w_in / w_gate product
MATMUL_M = (4, 16, 37, 64, 256)
MATMUL_KN = ((4096, 4096), (4096, 13440), (13440, 4096), (4100, 4104))
MATMUL_MAIN = (4, 4096, 13440)
# teacher-forced top-1 agreement floor of phases 4 and 5: a random-weight
# bf16 model over a 92k vocab has top-2 logit gaps of ~0.2 while bf16 logits
# near 4 are spaced 0.03 apart, so near-ties flip between two matmul/attention
# orders; an int8 or fp8 KV cache adds a relative row error of ~0.4% (int8)
# to ~6% (fp8) to every key and value, which flips more near-ties. A wrong
# kernel (wrong rows, wrong scales, wrong table) agrees on ~1/92416 of the
# positions, so 0.5 still separates right from wrong with a wide margin
AGREE_FLOOR = 0.5
# phase 2's dense-cache shapes (also timed by scripts/torch_attention_ab.py):
# 4 slots x 1024 positions; decode at an empty prefix, a non-tile multiple
# and a full slot; a 64-token pack of 40 prompt tokens of slot 1, 16 of slot
# 3 and 8 padding tokens (tok_pos = S_MAX) riding slot 1
SLOTS, S_MAX = 4, 1024
DECODE_POS = [0, 333, 700, S_MAX - 1]
PACK_SLOTS = [1] * 40 + [3] * 16 + [1] * 8
PACK_POS = list(range(0, 40)) + list(range(600, 616)) + [S_MAX] * 8


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between two CUDA events, so the host's time between
    launches (Python wrappers, ctypes) is not counted; L2 warm."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------- phase 2


def check_kernels(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ragged_attention as rk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    results = {}

    def report(name, case, dtype, err, timed=None):
        tol = TOL[str(dtype).split(".")[-1]]
        print(f"  {name:20s} {case:44s} max_abs_err={err:.3e} tol={tol:g}", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} {case}: max_abs_err {err} above {tol}")
        if timed is not None:
            results[name] = dict(timed, max_abs_err=err, tol=tol)

    bf16, f32 = torch.bfloat16, torch.float32
    B, S, cur = SLOTS, S_MAX, DECODE_POS

    # ---- decode attention
    for kv, g, dtype, window, main in [
        (32, 1, bf16, 0, True), (32, 1, f32, 0, False), (8, 8, bf16, 0, False),
        (8, 8, f32, 0, False), (32, 1, bf16, 100, False), (8, 8, f32, 37, False),
    ]:
        q, k, v = randn(B, kv, g, 128, dtype=dtype), randn(B, S, kv, 128, dtype=dtype), \
            randn(B, S, kv, 128, dtype=dtype)
        cl = torch.tensor(cur, dtype=torch.int32, device=dev)
        got = dk.decode_attention(q, k, v, cl, window=window)
        want = ref.decode_attention(q, k, v, cl, window=window)
        err = (got.float() - want.float()).abs().max().item()
        timed = None
        if main:
            n_valid = [min(c, S - 1) + 1 for c in cur]
            by = nbytes(q, q, cl) + sum(n_valid) * kv * 128 * 2 * k.element_size()
            fl = sum(n_valid) * kv * g * 128 * 4
            qs = q  # [B, KV, G, d]: G queries per KV head
            ks, vs = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
            mask = (torch.arange(S, device=dev)[None, :] <= cl[:, None])[:, None, None, :]
            timed = dict(
                ms=time_ms(lambda: dk.decode_attention(q, k, v, cl)),
                plain_ms=time_ms(lambda: ref.decode_attention(q, k, v, cl)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)),
            )
            timed["bound_ms"], timed["bound_by"] = bound(by, fl, dtype)
        report("decode_attention", f"B={B} S={S} KV={kv} G={g} {dtype} win={window}", dtype, err, timed)
        if main:  # the split body at the kernel's own and at forced split counts
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            own = dk.split_count(S, B, kv, g, sms)
            for splits in (1, 2, 4):
                err = (dk.decode_attention(q, k, v, cl, splits=splits).float()
                       - want.float()).abs().max().item()
                span = dk.split_span(S, splits)[0]
                report("decode_attention", f"splits={splits} (span {span}; own {own})", dtype, err)

    # ---- ragged attention: a 64-token pack over 2 slots, as the engine builds it
    ts = torch.tensor(PACK_SLOTS, dtype=torch.int32, device=dev)
    tp = torch.tensor(PACK_POS, dtype=torch.int32, device=dev)
    for kv, g, dtype, window, main in [
        (32, 1, bf16, 0, True), (32, 1, f32, 0, False), (8, 8, bf16, 0, False),
        (8, 8, f32, 0, False), (32, 1, bf16, 100, False), (8, 8, f32, 24, False),
    ]:
        T = ts.numel()
        q, k, v = randn(T, kv, g, 128, dtype=dtype), randn(B, S, kv, 128, dtype=dtype), \
            randn(B, S, kv, 128, dtype=dtype)
        got = rk.ragged_attention(q, k, v, ts, tp, window=window)
        want = ref.ragged_attention(q, k, v, ts, tp, window=window)
        # padding rows (tok_pos = S) are never read: the kernel reads no key
        # for them and writes zeros, the plain version attends the whole slot
        real = tp < S
        err = (got[real].float() - want[real].float()).abs().max().item()
        if got[~real].any():
            raise AssertionError("ragged_attention: padding rows are not zero")
        timed = None
        if main:
            # bytes and flops of the real tokens only: padding reads no key
            rs, rp = ts[real].cpu().numpy(), tp[real].cpu().numpy()
            rows = {}  # union of the valid prefixes per slot
            for s_, p_ in zip(rs, rp):
                rows[s_] = max(rows.get(s_, 0), p_ + 1)
            by = nbytes(q, q, ts, tp) + sum(rows.values()) * kv * 128 * 2 * k.element_size()
            fl = int((rp + 1).sum()) * kv * g * 128 * 4
            valid = ref.ragged_valid_mask(ts, tp, B, S)  # [T, B, S]
            mask = valid.reshape(T, 1, B * S).expand(T, g, B * S).reshape(1, 1, T * g, B * S)
            qs = q.permute(1, 0, 2, 3).reshape(1, kv, T * g, 128)
            ks = k.permute(2, 0, 1, 3).reshape(1, kv, B * S, 128)
            vs = v.permute(2, 0, 1, 3).reshape(1, kv, B * S, 128)
            timed = dict(
                ms=time_ms(lambda: rk.ragged_attention(q, k, v, ts, tp)),
                plain_ms=time_ms(lambda: ref.ragged_attention(q, k, v, ts, tp, valid=valid)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)),
            )
            timed["bound_ms"], timed["bound_by"] = bound(by, fl, dtype)
        report("ragged_attention", f"T={T} S={S} KV={kv} G={g} {dtype} win={window}", dtype, err, timed)

    # ---- GQA flash attention (prefill): B*KV rows, G heads per row
    for bkv, g, s, dtype, main in [
        (32, 1, 64, bf16, True), (32, 1, 37, bf16, False), (32, 1, 64, f32, False),
        (8, 8, 64, bf16, False), (8, 8, 37, f32, False),
    ]:
        q, k, v = randn(bkv, g, s, 128, dtype=dtype), randn(bkv, s, 128, dtype=dtype), \
            randn(bkv, s, 128, dtype=dtype)
        got = fk.gqa_flash_attention(q, k, v)
        want = ref.gqa_flash_attention(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        timed = None
        if main:
            fl = bkv * g * 128 * 4 * sum(i + 1 for i in range(s))
            k4, v4 = k[:, None], v[:, None]  # [BKV, 1, S, d]: G = 1 query head per row
            timed = dict(
                ms=time_ms(lambda: fk.gqa_flash_attention(q, k, v)),
                plain_ms=time_ms(lambda: ref.gqa_flash_attention(q, k, v)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k4, v4, is_causal=True)),
            )
            timed["bound_ms"], timed["bound_by"] = bound(nbytes(q, k, v, q), fl, dtype)
        report("gqa_flash_attention", f"BKV={bkv} G={g} S={s} {dtype}", dtype, err, timed)

    # every bf16 tile of the wgmma body at every head width, the group packed
    # into the query tile (G = 8, a 64-token prefill: the grouped serving
    # shape), and the main shape's time at each tile beside SDPA's
    for tile in fk.TILES[bf16]:
        for d in fk.HEAD_DIMS:
            q, k, v = randn(8, 8, 64, d, dtype=bf16), randn(8, 64, d, dtype=bf16), \
                randn(8, 64, d, dtype=bf16)
            got = fk.gqa_flash_attention(q, k, v, block_q=tile[0], block_k=tile[1])
            err = (got.float() - ref.gqa_flash_attention(q, k, v).float()).abs().max().item()
            report("gqa_flash_attention", f"BKV=8 G=8 S=64 d={d} tile={tile}", bf16, err)
        q, k, v = randn(32, 1, 64, 128, dtype=bf16), randn(32, 64, 128, dtype=bf16), \
            randn(32, 64, 128, dtype=bf16)
        ms = time_ms(lambda: fk.gqa_flash_attention(q, k, v, block_q=tile[0], block_k=tile[1]))
        print(f"  gqa_flash_attention  BKV=32 G=1 S=64 d=128 tile={tile}: ms={ms:.4f} "
              f"(SDPA {results['gqa_flash_attention']['library_ms']:.4f})", flush=True)
    # the f32 CUDA-core body at the same prefill, every tile: its default is
    # the f32 DEFAULT_TILE
    q, k, v = randn(32, 1, 64, 128, dtype=f32), randn(32, 64, 128, dtype=f32), \
        randn(32, 64, 128, dtype=f32)
    for tile in fk.TILES[f32]:
        ms = time_ms(lambda: fk.gqa_flash_attention(q, k, v, block_q=tile[0], block_k=tile[1]))
        mark = " (the f32 default)" if tile == fk.DEFAULT_TILE[f32] else ""
        print(f"  gqa_flash_attention  BKV=32 G=1 S=64 d=128 float32 tile={tile}: "
              f"ms={ms:.4f}{mark}", flush=True)
    torch.cuda.synchronize()
    return results


# phase 2's new domain of the serving attention kernels: (head_dim, group)
# pairs of the reduced configs (16, 1) and (16, 4), zamba2's width 80,
# llama4-scout's group 5 and mistral-large's 12
DOMAIN_PAIRS = ((16, 1), (16, 4), (80, 2), (128, 5), (128, 12))


def check_attention_domain(dev):
    """Phase 2: decode, ragged and paged attention at each DOMAIN_PAIRS (D,
    G), over a bf16 store and over a scaled int8 store under bf16 queries,
    against the plain version (4 KV heads, phase 2's dense slots, pack and
    a pool of the dense cache's rows under a reversed table)."""
    import torch

    from repro_torch.dist.compression import quantize_rows
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ragged_attention as rk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(2)
    bf16 = torch.bfloat16
    tol = TOL["bfloat16"]
    B, S, kv, bs = SLOTS, S_MAX, 4, 32
    cl = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    ts = torch.tensor(PACK_SLOTS, dtype=torch.int32, device=dev)
    tp = torch.tensor(PACK_POS, dtype=torch.int32, device=dev)
    real = tp < S
    nb = B * S // bs
    tables = (nb - 1 - torch.arange(nb, dtype=torch.int32, device=dev)).reshape(B, -1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def pool(t):  # the dense cache's rows as pool blocks, in reverse order
        return t.reshape(nb, bs, *t.shape[2:]).flip(0).contiguous()

    for d, g in DOMAIN_PAIRS:
        for store in ("bf16", "int8"):
            k, v = randn(B, S, kv, d), randn(B, S, kv, d)
            if store == "bf16":
                k, v, sc = k.to(bf16), v.to(bf16), {}
            else:
                (k, ks), (v, vs) = quantize_rows(k, torch.int8), quantize_rows(v, torch.int8)
                sc = dict(k_scale=ks, v_scale=vs)
            q = randn(B, kv, g, d).to(bf16)
            errs = [(dk.decode_attention(q, k, v, cl, **sc).float()
                     - ref.decode_attention(q, k, v, cl, **sc).float()).abs().max().item()]
            qt = randn(ts.numel(), kv, g, d).to(bf16)
            got = rk.ragged_attention(qt, k, v, ts, tp, **sc)
            want = ref.ragged_attention(qt, k, v, ts, tp, **sc)
            errs.append((got[real].float() - want[real].float()).abs().max().item())
            if got[~real].any():
                raise AssertionError(f"ragged_attention d={d} g={g}: padding rows not zero")
            psc = {n: pool(t) for n, t in sc.items()}
            got = pk.paged_attention(qt, pool(k), pool(v), ts, tp, tables, **psc)
            want = ref.paged_ragged_attention(qt, pool(k), pool(v), ts, tp, tables, **psc)
            errs.append((got[real].float() - want[real].float()).abs().max().item())
            print(f"  attention domain d={d:3d} G={g:2d} {store} store, bf16 q: max_abs_err "
                  f"decode {errs[0]:.2e} ragged {errs[1]:.2e} paged {errs[2]:.2e} tol={tol:g}",
                  flush=True)
            if not max(errs) <= tol:
                raise AssertionError(f"attention domain d={d} g={g} {store}: {errs} above {tol}")
    torch.cuda.synchronize()


def check_paged_and_quant_kernels(dev):
    """Phase 2 for the paged kernel and the quantized-store bodies of the
    decode, ragged and paged kernels. Every case is checked and timed; the
    main case of each body (phase 5's shape, bf16 queries) is returned."""
    import torch
    import torch.nn.functional as F

    from repro_torch.dist.compression import quantize_rows
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ragged_attention as rk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(1)
    rs = np.random.default_rng(1)
    results = {}
    bf16, f32 = torch.bfloat16, torch.float32
    # "f32": the identity lane (an f32 store, scales of 1); "f32 rand": an
    # f32 store under random scales. Under bf16 queries both run the
    # bf16-query / scaled-f32-store instantiation
    stores = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "f32": torch.float32}
    no_library = "none: no single PyTorch call attends over int8/fp8 rows with row scales"
    S, D = S_MAX, 128

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def store_kv(shape, store, qdtype):
        """K/V in the model dtype, or quantized rows with their scales."""
        k, v = randn(*shape), randn(*shape)
        if store is None:
            return k.to(qdtype), v.to(qdtype), {}
        if store == "f32 rand":
            scale = [torch.rand(shape[:-1], generator=gen, device=dev) + 0.5 for _ in "kv"]
            return k, v, dict(k_scale=scale[0], v_scale=scale[1])
        k, ks = quantize_rows(k, stores[store])
        v, vs = quantize_rows(v, stores[store])
        return k, v, dict(k_scale=ks, v_scale=vs)

    def key_span(pos, window):
        """The valid key positions of a real token at pos."""
        return range(max(0, pos - window + 1) if window else 0, min(pos, S - 1) + 1)

    def measure(name, case, qdtype, got, want, real, kernel, plain, rows, ops_, row_bytes,
                extra_bytes, library=None, main=False):
        """Check one case against its plain version, time it, print both."""
        tol = TOL[str(qdtype).split(".")[-1]]
        err = (got[real].float() - want[real].float()).abs().max().item()
        if got[~real].any():
            raise AssertionError(f"{name} {case}: padding rows are not zero")
        timed = dict(ms=time_ms(kernel), plain_ms=time_ms(plain), library_ms=None,
                     library=no_library)
        if library is not None:
            timed["library_ms"], timed["library"] = time_ms(library[0]), library[1]
        timed["bound_ms"], timed["bound_by"] = bound(rows * row_bytes + extra_bytes, ops_, qdtype)
        lib = f"{timed['library_ms']:.4f}" if timed["library_ms"] is not None else "none"
        print(f"  {name:20s} {case:52s} err={err:.2e} tol={tol:g} ms={timed['ms']:.4f} "
              f"plain={timed['plain_ms']:.3f} bound={timed['bound_ms']:.5f} library={lib}",
              flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} {case}: max_abs_err {err} above {tol}")
        if main:
            results[name] = dict(timed, max_abs_err=err, tol=tol)

    def kv_row_bytes(k, kv, scaled):
        return kv * (D * k.element_size() + (4 if scaled else 0)) * 2  # K and V

    # ---- paged: an 8-sequence decode over a fragmented pool whose first four
    # sequences share a 512-token prefix (phase 5's traffic), and 64-token packs
    cur = [540, 560, 580, 600, 5, 300, 700, S - 1]

    def pool_tables(bs):
        """(num_blocks, tables): each sequence's blocks drawn from a shuffled
        pool, the shared prefix's blocks named by sequences 0-3; unallocated
        entries hold the sentinel num_blocks (the pool's scratch block)."""
        maxb = S // bs
        nb = len(cur) * maxb
        free = list(rs.permutation(nb))
        shared = [int(free.pop()) for _ in range(512 // bs)]
        tab = np.full((len(cur), maxb), nb, np.int32)
        for i, c in enumerate(cur):
            n = min(c, S - 1) // bs + 1
            own = shared if i < 4 else []
            tab[i, :n] = (own + [int(free.pop()) for _ in range(n - len(own))])[:n]
        return nb, tab

    def paged_sdpa(q, k, v, seqs, poss, tab, nb, bs, window):
        """SDPA over the whole pool, each token masked to its sequence's
        valid rows (softmax ignores key order): one call; the mask is set-up."""
        rowpos = np.full((len(seqs), (nb + 1) * bs), -1, np.int64)
        for t, (sq, ps) in enumerate(zip(seqs, poss)):
            for j, blk in enumerate(tab[sq]):
                if blk < nb:
                    rowpos[t, blk * bs:(blk + 1) * bs] = j * bs + np.arange(bs)
        lo = np.asarray([min(key_span(p_, window), default=S) for p_ in poss])[:, None]
        hi = np.asarray([max(key_span(p_, window), default=-1) for p_ in poss])[:, None]
        mask = torch.from_numpy((rowpos >= lo) & (rowpos <= hi) & (rowpos >= 0)).to(dev)
        mask = mask[:, None, None, :]
        kv = k.shape[2]
        kf = k.reshape((nb + 1) * bs, kv, D).permute(1, 0, 2)[None].expand(len(seqs), -1, -1, -1)
        vf = v.reshape((nb + 1) * bs, kv, D).permute(1, 0, 2)[None].expand(len(seqs), -1, -1, -1)
        return (lambda: F.scaled_dot_product_attention(q, kf, vf, attn_mask=mask),
                "SDPA over the whole pool, masked")

    for name, store, cases in [
        ("paged_attention", None, [
            (32, 1, 32, bf16, 0, "decode", True), (32, 1, 16, f32, 0, "decode", False),
            (8, 8, 16, bf16, 0, "decode", False), (8, 8, 32, f32, 0, "decode", False),
            (32, 1, 32, bf16, 0, "pack", False), (32, 1, 16, bf16, 100, "pack", False),
        ]),
        ("paged_attention_q8", "int8", [
            (32, 1, 32, bf16, 0, "decode", True), (32, 1, 16, f32, 0, "decode", False),
            (8, 8, 16, bf16, 0, "decode", False), (32, 1, 32, bf16, 0, "pack", False),
            (8, 8, 32, f32, 77, "pack", False),
        ]),
        ("paged_attention_q8", "fp8", [
            (32, 1, 32, bf16, 0, "decode", False), (8, 8, 16, f32, 0, "decode", False),
            (32, 1, 16, bf16, 100, "pack", False),
        ]),
        ("paged_attention_q8", "f32", [
            (32, 1, 32, bf16, 0, "decode", False), (32, 1, 32, bf16, 0, "pack", False),
        ]),
        ("paged_attention_q8", "f32 rand", [
            (32, 1, 32, bf16, 0, "decode", False), (8, 8, 16, bf16, 0, "pack", False),
        ]),
    ]:
        for kv, g, bs, dtype, window, kind, main in cases:
            nb, tab_h = pool_tables(bs)
            tab = torch.from_numpy(tab_h).to(dev)
            k, v, scales = store_kv((nb + 1, bs, kv, D), store, dtype)
            if kind == "decode":
                seqs, poss = list(range(len(cur))), cur
            else:  # 40 prompt tokens of seq 6, 16 of seq 1, 8 padding tokens
                seqs = [6] * 40 + [1] * 16 + [6] * 8
                poss = list(range(600, 640)) + list(range(545, 561)) + [S] * 8
            ts = torch.tensor(seqs, dtype=torch.int32, device=dev)
            tp = torch.tensor(poss, dtype=torch.int32, device=dev)
            q = randn(len(seqs), kv, g, D, dtype=dtype)
            counter = "launches_q8" if scales else "launches"
            n0 = getattr(pk, counter)
            got = pk.paged_attention(q, k, v, ts, tp, tab, window=window, **scales)
            if getattr(pk, counter) != n0 + 1:
                raise AssertionError(f"{name}: the wrapper did not count its launch")
            want = ref.paged_ragged_attention(q, k, v, ts, tp, tab, window=window, **scales)
            real = tp < S  # padding rows: zeros from the kernel, never read
            # the bound reads each pool row (and its block's table entry) once
            # however many tokens attend it: the shared prefix counts once
            spans = [(sq, key_span(p_, window)) for sq, p_ in zip(seqs, poss) if p_ < S]
            rows = {(int(tab_h[sq, p_ // bs]), p_ % bs) for sq, sp in spans for p_ in sp}
            n_keys = sum(len(sp) for _, sp in spans)
            extra = nbytes(q, q, ts, tp) + len({blk for blk, _ in rows}) * 4
            plain = (
                (lambda: ref.paged_decode_attention(q, k, v, tp, tab, window=window, **scales))
                if kind == "decode" else
                (lambda: ref.paged_ragged_attention(q, k, v, ts, tp, tab, window=window,
                                                    **scales))
            )
            library = None if scales else paged_sdpa(q, k, v, seqs, poss, tab_h, nb, bs, window)
            measure(name, f"{kind} T={len(seqs)} KV={kv} G={g} bs={bs} {store or dtype} "
                    f"q={str(dtype)[6:]} win={window}", dtype, got, want, real,
                    lambda: pk.paged_attention(q, k, v, ts, tp, tab, window=window, **scales),
                    plain, len(rows), n_keys * kv * g * D * 4, kv_row_bytes(k, kv, bool(scales)),
                    extra, library, main)

    # ---- decode and ragged over a quantized dense cache (phase 5 (c))
    B, dcur = SLOTS, DECODE_POS
    for store, kv, g, dtype, window, main in [
        ("int8", 32, 1, bf16, 0, True), ("int8", 32, 1, f32, 0, False),
        ("fp8", 32, 1, bf16, 0, False), ("int8", 8, 8, bf16, 0, False),
        ("fp8", 8, 8, f32, 0, False), ("int8", 32, 1, bf16, 100, False),
        ("f32", 32, 1, bf16, 0, False), ("f32 rand", 32, 1, bf16, 0, False),
        ("f32 rand", 8, 8, bf16, 0, False),
    ]:
        q = randn(B, kv, g, D, dtype=dtype)
        k, v, scales = store_kv((B, S, kv, D), store, dtype)
        cl = torch.tensor(dcur, dtype=torch.int32, device=dev)
        got = dk.decode_attention(q, k, v, cl, window=window, **scales)
        want = ref.decode_attention(q, k, v, cl, window=window, **scales)
        n_rows = sum(len(key_span(c, window)) for c in dcur)
        measure("decode_attention_q8", f"B={B} S={S} KV={kv} G={g} {store} "
                f"q={str(dtype)[6:]} win={window}", dtype, got, want,
                torch.ones(B, dtype=torch.bool, device=dev),
                lambda: dk.decode_attention(q, k, v, cl, window=window, **scales),
                lambda: ref.decode_attention(q, k, v, cl, window=window, **scales),
                n_rows, n_rows * kv * g * D * 4, kv_row_bytes(k, kv, True), nbytes(q, q, cl),
                main=main)

    slots, poss = PACK_SLOTS, PACK_POS
    ts = torch.tensor(slots, dtype=torch.int32, device=dev)
    tp = torch.tensor(poss, dtype=torch.int32, device=dev)
    for store, kv, g, dtype, window, main in [
        ("int8", 32, 1, bf16, 0, True), ("int8", 32, 1, f32, 0, False),
        ("fp8", 32, 1, bf16, 0, False), ("int8", 8, 8, bf16, 0, False),
        ("fp8", 8, 8, f32, 24, False), ("f32", 32, 1, bf16, 0, False),
        ("f32 rand", 32, 1, bf16, 0, False),
    ]:
        q = randn(len(slots), kv, g, D, dtype=dtype)
        k, v, scales = store_kv((B, S, kv, D), store, dtype)
        got = rk.ragged_attention(q, k, v, ts, tp, window=window, **scales)
        want = ref.ragged_attention(q, k, v, ts, tp, window=window, **scales)
        real = [(s_, p_) for s_, p_ in zip(slots, poss) if p_ < S]
        rows = {(s_, r) for s_, p_ in real for r in key_span(p_, window)}
        n_keys = sum(len(key_span(p_, window)) for _, p_ in real)
        valid = ref.ragged_valid_mask(ts, tp, B, S, window)
        measure("ragged_attention_q8", f"T={len(slots)} S={S} KV={kv} G={g} {store} "
                f"q={str(dtype)[6:]} win={window}", dtype, got, want, tp < S,
                lambda: rk.ragged_attention(q, k, v, ts, tp, window=window, **scales),
                lambda: ref.ragged_attention(q, k, v, ts, tp, window=window, valid=valid,
                                             **scales),
                len(rows), n_keys * kv * g * D * 4, kv_row_bytes(k, kv, True),
                nbytes(q, q, ts, tp), main=main)
    torch.cuda.synchronize()
    return results


def check_matmul_kernels(dev):
    """Phase 2 for ``matmul`` and ``matmul_q8``: every (M, K, N) of
    MATMUL_M x MATMUL_KN at bf16 and f32 activations against the plain
    version, within MATMUL_REL_TOL of max |plain|; all cases timed, the main
    case (MATMUL_MAIN, bf16) of each returned. Yardsticks: ``torch.matmul``
    for ``matmul``; for ``matmul_q8`` ``torch._weight_int8pack_mm`` (one call
    over the int8 weight transposed to [N, K], with bf16 scales) where it runs
    on the card and agrees, with the two-call dequant + ``torch.matmul``
    printed beside it."""
    import torch

    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ref
    from repro_torch.models.quant import quantize_leaf

    gen = torch.Generator(device=dev).manual_seed(2)
    results = {}
    bf16, f32 = torch.bfloat16, torch.float32

    def int8_pack_yardstick(a, q8, scale, want, tol):
        """(fn, label) of the one-call PyTorch int8-weight product, or (None,
        reason) where it does not run on the card or computes another
        function."""
        try:
            w_nk, s = q8.t().contiguous(), scale.to(a.dtype)
            fn = lambda: torch._weight_int8pack_mm(a, w_nk, s)  # noqa: E731
            err = (fn().float() - want.float()).abs().max().item()
        except (RuntimeError, NotImplementedError, TypeError) as e:
            return None, f"none: torch._weight_int8pack_mm does not run here ({type(e).__name__})"
        if not err <= tol:
            return None, f"none: torch._weight_int8pack_mm differs by {err:.3g} (tol {tol:.3g})"
        return fn, "torch._weight_int8pack_mm (int8 [N, K], bf16 scales)"

    for dtype in (bf16, f32):
        dname = str(dtype).split(".")[-1]
        for k, n in MATMUL_KN:
            w = torch.randn(k, n, generator=gen, device=dev)
            leaf = quantize_leaf(w[None], (1,))
            q8, scale = leaf["q8"][0], leaf["scale"][0].reshape(n)
            b = w.to(dtype)
            for m in MATMUL_M:
                a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
                main = (m, k, n) == MATMUL_MAIN and dtype == bf16
                for name, kernel, plain, by in [
                    ("matmul_q8", lambda: mmk.matmul_q8(a, q8, scale),
                     lambda: ref.matmul_q8(a, q8, scale), nbytes(a, q8, scale)),
                    ("matmul", lambda: mmk.matmul(a, b), lambda: ref.matmul(a, b),
                     nbytes(a, b)),
                ]:
                    got, want = kernel(), plain()
                    torch.cuda.synchronize()
                    want_max = want.float().abs().max().item()
                    tol = MATMUL_REL_TOL[dname] * want_max
                    err = (got.float() - want.float()).abs().max().item()
                    timed = dict(ms=time_ms(kernel), plain_ms=time_ms(plain))
                    timed["bound_ms"], timed["bound_by"] = bound(by + m * n * a.element_size(),
                                                                 2 * m * k * n, dtype)
                    extra = ""
                    if name == "matmul":
                        timed["library_ms"] = time_ms(lambda: torch.matmul(a, b))
                        timed["library"] = "torch.matmul"
                    else:
                        fn, timed["library"] = int8_pack_yardstick(a, q8, scale, want, tol)
                        timed["library_ms"] = time_ms(fn) if fn is not None else None
                        if main:
                            two = time_ms(lambda: a @ (q8.to(dtype) * scale.to(dtype)))
                            extra = f" (dequant + torch.matmul, two calls: {two:.4f} ms)"
                    lib = (f"{timed['library_ms']:.4f}" if timed["library_ms"] is not None
                           else "none")
                    body = mmk.route(m, k, n, a.dtype, torch.int8 if name == "matmul_q8"
                                     else b.dtype)
                    print(f"  {name:10s} M={m:<4d} K={k:<6d} N={n:<6d} {dname:8s} {body:8s} "
                          f"rel_err={err / want_max:.2e} "
                          f"tol={MATMUL_REL_TOL[dname]:g} ms={timed['ms']:.4f} "
                          f"plain={timed['plain_ms']:.4f} bound={timed['bound_ms']:.4f} "
                          f"library={lib}{extra}", flush=True)
                    if not err <= tol:
                        raise AssertionError(f"{name} M={m} K={k} N={n} {dname}: max_abs_err "
                                             f"{err} above {tol}")
                    if main:
                        results[name] = dict(timed, max_abs_err=err, tol=tol)
                        if timed["library_ms"] is None:
                            print(f"  {name} yardstick: {timed['library']}")
    torch.cuda.synchronize()
    return results


# ----------------------------------------------------------------- phase 3


def small_model_streams(dev):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = replace(
        get_arch("codeqwen1.5-7b"), name="smoke-small", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=512, vocab_size=256, dtype="float32",
    )
    cpu_model = LM(cfg, device="cpu")
    params_cpu = cpu_model.init(torch.Generator().manual_seed(0))
    params_dev = _tree_to(params_cpu, dev)
    dev_model = LM(cfg, device=dev)
    rng = np.random.default_rng(1)
    lens = (5, 9, 16, 17, 23, 41, 12, 50, 3, 33)  # straddle prefill_budget=16
    prompts = [rng.integers(0, cfg.vocab_size, size=s).astype(np.int32) for s in lens]
    # a 40-token system prompt ahead of short tails: the prefix lane's traffic
    system = rng.integers(0, cfg.vocab_size, size=40).astype(np.int32)
    shared = [np.concatenate([system, p_[:8]]) for p_ in prompts[:6]]
    lanes = [
        ("dense", prompts, {}),
        ("paged + prefix, bs=16", shared + prompts[6:], dict(kv_block_size=16, prefix_cache=True)),
        ("int8 dense", prompts, dict(kv_dtype="int8")),
        ("fp8 paged, bs=16", prompts, dict(kv_dtype="fp8", kv_block_size=16)),
        ("int8 weights, dense", prompts, dict(weight_dtype="int8")),
        ("int8 weights + int8 KV, paged + prefix, bs=16", shared + prompts[6:],
         dict(weight_dtype="int8", kv_dtype="int8", kv_block_size=16, prefix_cache=True)),
    ]

    def serve(model, params, device, reqs, kw):
        eng = ServeEngine(model, params, batch_slots=4, max_len=128, prefill_budget=16,
                          device=device, **kw)
        for i, pr in enumerate(reqs):
            eng.submit(Request(rid=i, prompt=pr, params=SamplingParams(max_new=10)))
        eng.run()
        if eng.paged and eng.prefix is None and eng.pool.free != eng.num_blocks:
            raise AssertionError("blocks leaked")
        hits = eng.prefix.stats().hit_tokens if eng.prefix is not None else None
        return {r.rid: r.generated for r in eng.finished}, hits

    for lane, reqs, kw in lanes:
        on_cpu, hits_cpu = serve(cpu_model, params_cpu, "cpu", reqs, kw)
        on_dev, hits_dev = serve(dev_model, params_dev, dev, reqs, kw)
        if on_dev != on_cpu:
            diff = [rid for rid in on_cpu if on_cpu[rid] != on_dev.get(rid)]
            raise AssertionError(f"{lane}: kernel path and plain path streams differ for rids "
                                 f"{diff}")
        if hits_dev != hits_cpu or hits_dev == 0:
            raise AssertionError(f"{lane}: prefix hits {hits_dev} on the card, {hits_cpu} on CPU")
        extra = f", {hits_dev} prefix hit tokens" if hits_dev is not None else ""
        print(f"  {lane}: {len(on_cpu)} greedy streams identical on the card (kernels) and the "
              f"CPU (plain){extra}", flush=True)

    # the port's reduced configs at head_dim 16 (codeqwen: G = 1; qwen3-32b:
    # G = 4 with qk_norm), in f32: dense, and paged with prefix reuse
    for name in ("codeqwen1.5-7b", "qwen3-32b"):
        rcfg = replace(get_arch(name).reduced(), dtype="float32")
        r_cpu = LM(rcfg, device="cpu")
        r_params = r_cpu.init(torch.Generator().manual_seed(0))
        r_dev, r_params_dev = LM(rcfg, device=dev), _tree_to(r_params, dev)
        r_prompts = [p_ % rcfg.vocab_size for p_ in prompts]
        r_shared = [p_ % rcfg.vocab_size for p_ in shared]
        for lane, reqs, kw in [("dense", r_prompts, {}),
                               ("paged + prefix, bs=16", r_shared + r_prompts[6:],
                                dict(kv_block_size=16, prefix_cache=True))]:
            on_cpu, hits_cpu = serve(r_cpu, r_params, "cpu", reqs, kw)
            on_dev, hits_dev = serve(r_dev, r_params_dev, dev, reqs, kw)
            if on_dev != on_cpu or hits_dev != hits_cpu:
                diff = [rid for rid in on_cpu if on_cpu[rid] != on_dev.get(rid)]
                raise AssertionError(f"{name} reduced, {lane}: streams differ for rids {diff}, "
                                     f"prefix hits {hits_dev} on the card, {hits_cpu} on CPU")
            print(f"  {name} reduced (d_head {rcfg.d_head}, G "
                  f"{rcfg.n_heads // rcfg.n_kv_heads}), {lane}: {len(on_cpu)} greedy streams "
                  f"identical on the card (kernels) and the CPU (plain)", flush=True)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ----------------------------------------------------------------- phase 4


def reset_counts(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters, run: str, expect=None) -> dict:
    """Each counter's launches since reset_counts; raises if a kernel the run
    drives (``expect``, default all) was launched no time."""
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    print(f"  launches during {run}: {launches}")
    for name in expect if expect is not None else launches:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched in {run}")
    return launches


def teacher_forced(model, params, req, dev, label: str) -> float:
    """LM.prefill (flash kernel, unquantized bf16 cache) over prompt +
    generated must predict the engine's stream; returns the agreement."""
    import torch

    seq = np.concatenate([req.prompt, np.asarray(req.generated, np.int32)])
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(seq[None]).to(dev)},
                                  len(seq))
    rows = logits[0, len(req.prompt) - 1: len(seq) - 1].float()
    pred = rows.argmax(-1).cpu().numpy()
    top2 = rows.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    agree = pred == np.asarray(req.generated)
    print(f"  {label}: teacher-forced top-1 agreement {agree.mean():.3f} over {len(agree)} "
          f"positions (floor {AGREE_FLOOR}); top-2 margins at disagreements: "
          f"{np.round(margin[~agree], 3).tolist()}")
    if agree.mean() < AGREE_FLOOR:
        raise AssertionError(f"{label}: teacher-forced agreement below the floor")
    return float(agree.mean())


def check_finished(reqs, max_new, vocab) -> None:
    for r in reqs:
        if r.finish_reason != "length" or len(r.generated) != max_new:
            raise AssertionError(f"rid {r.rid}: {r.finish_reason}, {len(r.generated)} tokens")
        if not all(0 <= t < vocab for t in r.generated):
            raise AssertionError(f"rid {r.rid}: token out of range")


def print_stats(stats, extra: str = "") -> None:
    print(f"  {stats.total_requests} requests, {stats.total_tokens} decode tokens in "
          f"{stats.wall_seconds:.3f} s: {stats.tokens_per_sec:.1f} tok/s; TTFT p50 "
          f"{stats.ttft_p50 * 1e3:.1f} ms p99 {stats.ttft_p99 * 1e3:.1f} ms; TPOT p50 "
          f"{stats.tpot_p50 * 1e3:.2f} ms; peak residents {stats.peak_residents}{extra}",
          flush=True)


def full_width(dev, counters):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = get_arch("codeqwen1.5-7b")
    model = LM(cfg)  # device=None: the card
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}, "
          f"{cfg.num_params() / 1e9:.2f}B params, init {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(model, params, batch_slots=4, max_len=1024, prefill_budget=64)
    eng.prewarm()
    max_new = 32
    reqs = [
        Request(rid=i, prompt=p_, params=SamplingParams(max_new=max_new))
        for i, p_ in enumerate(phase4_prompts(cfg))
    ]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    launches = read_counts(counters, "phase 4")
    check_finished(reqs, max_new, cfg.vocab_size)
    peak = torch.cuda.max_memory_allocated()
    print_stats(stats, f"; peak memory {peak / 2**30:.2f} GiB")
    teacher_forced(model, params, reqs[5], dev, "dense bf16")
    decode_step_profile(eng, cfg, dev)
    return launches, model, params


def phase4_prompts(cfg):
    rng = np.random.default_rng(2)
    lens = (5, 700, 37, 130, 64, 300, 12, 513, 65, 200, 48, 90)  # 7 of 12 above the budget
    return [rng.integers(0, cfg.vocab_size, size=s).astype(np.int32) for s in lens]


# ----------------------------------------------------------------- phase 5


def shared_traffic(cfg):
    """Phase 5's shared-prefix traffic: (warm-up prompt, 12 prompts) — a
    512-token system prompt ahead of 8 tails of 16-64 tokens, and 4 unshared
    prompts of 5-700 tokens."""
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab_size, size=512).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
             for n in (16, 40, 64, 23, 57, 31, 48, 20)]
    unshared = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                for n in (5, 700, 130, 333)]
    warm = np.concatenate([system, rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)])
    return warm, [np.concatenate([system, t]) for t in tails] + unshared


def serve_shared(dev, model, params, counters, label, expect, **kw):
    """Serve the shared-prefix traffic on a paged engine with prefix reuse
    (block size 32); the counts are set to 0 just before the 12 measured
    requests and read just after. Returns (the run's launches, its readings,
    the engine's params)."""
    import torch

    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = model.cfg
    max_new, bs = 32, 32
    floor_ms = kw.pop("floor_ms", None)
    warm, shared_prompts = shared_traffic(cfg)
    eng = ServeEngine(model, params, batch_slots=kw.pop("batch_slots"), max_len=1024,
                      prefill_budget=64, kv_block_size=bs, prefix_cache=True, **kw)
    eng.prewarm()
    # the warm-up request registers the system prompt's 16 blocks
    eng.submit(Request(rid=100, prompt=warm, params=SamplingParams(max_new=max_new)))
    eng.run()
    hits0 = eng.prefix.stats().hit_tokens
    reqs = [Request(rid=i, prompt=p_, params=SamplingParams(max_new=max_new))
            for i, p_ in enumerate(shared_prompts)]
    reset_counts(counters)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    launches = read_counts(counters, f"({label})", expect)
    check_finished(reqs, max_new, cfg.vocab_size)
    hits = eng.prefix.stats().hit_tokens - hits0
    peak_blocks = stats.kv_bytes_resident // eng.pool.bytes_per_block
    print(f"  ({label}) {eng.num_blocks} blocks of {bs} ({eng.pool.bytes_per_block} bytes "
          f"each, {eng.num_blocks * eng.pool.bytes_per_block / 2**30:.2f} GiB), "
          f"{eng.B} slots: prefix hit tokens {hits}, peak used blocks {peak_blocks}, peak "
          f"kv_bytes_resident {stats.kv_bytes_resident}")
    print_stats(stats)
    if hits <= 0:
        raise AssertionError(f"({label}) the prefix cache never hit")
    agree = teacher_forced(model, eng.params, reqs[1], dev, f"({label})")
    # a decode step with live requests: the shared prompts, all decoding
    live = [eng.submit(Request(rid=300 + i, prompt=p_, params=SamplingParams(max_new=64)))
            for i, p_ in enumerate(shared_prompts[:eng.B])]
    while eng._prefilling or eng.waiting:
        eng.step()
    step = decode_step_profile(eng, cfg, dev, f"({label}) decode step", floor_ms=floor_ms)
    for h in live:
        h.cancel()
    eng.run()
    out = dict(num_blocks=eng.num_blocks, bytes_per_block=eng.pool.bytes_per_block,
               hit_tokens=hits, peak_blocks=peak_blocks, peak_residents=stats.peak_residents,
               kv_bytes_resident=stats.kv_bytes_resident, tok_s=stats.tokens_per_sec,
               ttft_p50_ms=stats.ttft_p50 * 1e3, ttft_p99_ms=stats.ttft_p99 * 1e3,
               tpot_p50_ms=stats.tpot_p50 * 1e3, agreement=agree, decode_step=step)
    qparams = eng.params
    del eng
    torch.cuda.empty_cache()
    return launches, out, qparams


def paged_and_quantized(dev, model, params, counters):
    """Full-width serving on the paged pool with prefix reuse, then the same
    traffic over an int8 pool of the same bytes, then phase 4's traffic over
    a dense int8 cache. Returns each kernel's launches summed over the three
    measured runs (counts set to 0 just before each, read just after it) and
    the end-to-end readings."""
    import torch

    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = model.cfg
    max_new, bs = 32, 32
    runs = []  # each measured run's launches

    # (a) bf16 pool at byte parity with a dense 8 x 1024 cache: 256 blocks
    la, a, _ = serve_shared(dev, model, params, counters, "a: paged bf16 + prefix",
                            ["paged_attention"], batch_slots=8)
    # (b) int8 pool of (a)'s bytes, twice the slots
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    int8_block = L * bs * KV * (hd + 4) * 2
    lb, b, _ = serve_shared(dev, model, params, counters, "b: paged int8 + prefix",
                            ["paged_attention_q8"], batch_slots=16, kv_dtype="int8",
                            num_blocks=a["num_blocks"] * a["bytes_per_block"] // int8_block)
    runs += [la, lb]
    if b["bytes_per_block"] != int8_block:
        raise AssertionError(f"int8 block bytes {b['bytes_per_block']} != {int8_block}")
    print(f"  peak residents: (a) {a['peak_residents']}, (b) {b['peak_residents']}; pool "
          f"blocks (a) {a['num_blocks']}, (b) {b['num_blocks']} at the same bytes")

    # (c) phase 4's traffic over a dense int8 cache
    eng = ServeEngine(model, params, batch_slots=4, max_len=1024, prefill_budget=64,
                      kv_dtype="int8")
    eng.prewarm()
    reqs = [Request(rid=i, prompt=p_, params=SamplingParams(max_new=max_new))
            for i, p_ in enumerate(phase4_prompts(cfg))]
    reset_counts(counters)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    runs.append(read_counts(counters, "(c: dense int8)",
                            ["decode_attention_q8", "ragged_attention_q8",
                             "decode_attention_q8_split"]))
    check_finished(reqs, max_new, cfg.vocab_size)
    print(f"  (c: dense int8) kv_bytes_resident {stats.kv_bytes_resident}")
    print_stats(stats)
    c_agree = teacher_forced(model, params, reqs[5], dev, "(c: dense int8)")
    decode_step_profile(eng, cfg, dev, "(c: dense int8) decode step")
    c = dict(kv_bytes_resident=stats.kv_bytes_resident, tok_s=stats.tokens_per_sec,
             ttft_p50_ms=stats.ttft_p50 * 1e3, ttft_p99_ms=stats.ttft_p99 * 1e3,
             tpot_p50_ms=stats.tpot_p50 * 1e3, peak_residents=stats.peak_residents,
             agreement=c_agree)
    del eng
    torch.cuda.empty_cache()
    launches = {name: sum(run[name] for run in runs) for name in counters}
    print(f"  launches during phase 5's three measured runs: {launches}")
    return launches, {"a": a, "b": b, "c": c}


# ----------------------------------------------------------------- phase 6


def top1_vs_dense(model, params, qparams, seq, dev) -> dict:
    """Top-1 agreement of the int8-weight model's prefill logits with the
    bf16 model's over ``seq``, at the positions where the bf16 model's top-2
    margin is clear (> 0.05) — the quality number
    tests/test_quant_serving.py gates on the CPU; printed, not gated here."""
    import torch

    toks = {"tokens": torch.from_numpy(seq[None]).to(dev)}
    with torch.no_grad():
        dense, _ = model.prefill(params, toks, len(seq))
        quant, _ = model.prefill(qparams, toks, len(seq))
    dense, quant = dense[0].float(), quant[0].float()
    top2 = dense.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0.05
    same = dense.argmax(-1) == quant.argmax(-1)
    out = dict(clear=int(clear.sum()), positions=len(seq),
               agree_clear=float(same[clear].float().mean()) if clear.any() else float("nan"),
               agree_all=float(same.float().mean()))
    print(f"  int8 vs bf16 weights, prefill over {len(seq)} tokens: top-1 agreement "
          f"{out['agree_clear']:.3f} at the {out['clear']} clear-margin positions (> 0.05), "
          f"{out['agree_all']:.3f} at all (not gated)")
    return out


def int8_weights(dev, model, params, counters, num_blocks_b: int):
    """Phase 6: int8-weight serving at full width. (a) phase 4's traffic on a
    dense bf16 cache, (b) phase 5 (b)'s traffic on a paged int8 pool of
    ``num_blocks_b`` blocks with prefix reuse; each engine quantizes phase 4's
    weights on the card. Returns the launches summed over the two measured
    runs and the readings."""
    import torch

    from repro_torch.common import pytree_bytes
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = model.cfg
    max_new = 32
    dense_bytes = pytree_bytes(params["blocks"])
    head_bytes = pytree_bytes(params["embed"].get("head"))

    def resident(label, qparams) -> dict:
        q_bytes = pytree_bytes(qparams["blocks"])
        ratio = q_bytes / dense_bytes
        print(f"  ({label}) resident params['blocks']: int8 {q_bytes} bytes, bf16 {dense_bytes} "
              f"bytes, ratio {ratio:.4f}")
        if ratio > 0.51:
            raise AssertionError(f"({label}) int8 block stack {ratio:.4f}x the bf16 one")
        return dict(blocks_bytes=q_bytes, blocks_bytes_bf16=dense_bytes, ratio=ratio)

    # (a) phase 4's traffic, dense bf16 cache
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, batch_slots=4, max_len=1024, prefill_budget=64,
                      weight_dtype="int8")
    torch.cuda.synchronize()
    print(f"  quantized {cfg.n_layers} layers on the card in {time.perf_counter() - t0:.2f} s")
    eng.prewarm()
    reqs = [Request(rid=i, prompt=p_, params=SamplingParams(max_new=max_new))
            for i, p_ in enumerate(phase4_prompts(cfg))]
    reset_counts(counters)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    la = read_counts(counters, "(a: int8 weights, dense bf16 KV)",
                     ["matmul_q8", "matmul_q8_gemv_tc", "decode_attention", "ragged_attention",
                      "gqa_flash_attention"])
    check_finished(reqs, max_new, cfg.vocab_size)
    print_stats(stats)
    a = resident("a", eng.params)
    a.update(tok_s=stats.tokens_per_sec, ttft_p50_ms=stats.ttft_p50 * 1e3,
             ttft_p99_ms=stats.ttft_p99 * 1e3, tpot_p50_ms=stats.tpot_p50 * 1e3,
             peak_residents=stats.peak_residents, kv_bytes_resident=stats.kv_bytes_resident,
             agreement=teacher_forced(model, eng.params, reqs[5], dev, "(a: int8 weights)"))
    seq = np.concatenate([reqs[5].prompt, np.asarray(reqs[5].generated, np.int32)])
    a["vs_bf16"] = top1_vs_dense(model, params, eng.params, seq, dev)
    floor_ms = (a["blocks_bytes"] + head_bytes) / HBM_BYTES_PER_S * 1e3
    a["decode_step"] = decode_step_profile(eng, cfg, dev, "(a: int8 weights) decode step",
                                           floor_ms=floor_ms)
    del eng
    torch.cuda.empty_cache()

    # (b) phase 5 (b)'s traffic: paged int8 KV + prefix, 16 slots — fully quantized
    lb, b, qparams = serve_shared(dev, model, params, counters,
                                  "b: int8 weights, paged int8 KV + prefix",
                                  ["matmul_q8", "paged_attention_q8"], batch_slots=16,
                                  kv_dtype="int8", num_blocks=num_blocks_b, weight_dtype="int8",
                                  floor_ms=floor_ms)
    b.update(resident("b", qparams))
    del qparams
    torch.cuda.empty_cache()
    launches = {name: la[name] + lb[name] for name in counters}
    print(f"  launches during phase 6's two measured runs: {launches}")
    return launches, {"a": a, "b": b}


def decode_step_profile(eng, cfg, dev, label: str = "decode step", steps: int = 8,
                        floor_ms=None) -> dict:
    """Where a decode step goes: wall time per step of an 8-step chunk over
    the engine's current slots (all slots decoding, or the live ones of a
    paged engine, through its block tables), the device's busy time per step
    from the profiler, and the kernels that take it. ``floor_ms`` is the
    step's weight-read floor (default: every bf16 parameter once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if eng.paged:  # the live slots only: released rows read the scratch block
        active = torch.tensor([r is not None for r in eng.slot_req], dtype=torch.int32,
                              device=dev)
    else:
        active = torch.ones(eng.B, dtype=torch.int32, device=dev)
    btab = eng._flush_btab()

    def chunk():
        eng._tick_fn(eng._last_tok, eng._cur_len, active, steps, btab)
        torch.cuda.synchronize()

    chunk()
    t0 = time.perf_counter()
    chunk()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk()
    # kernel rows carry the device time; op rows repeat it as their children's
    kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in kernels) / 1e3 / steps
    if floor_ms is None:
        floor_ms = cfg.num_params() * 2 / HBM_BYTES_PER_S * 1e3
    n_kernels = sum(r[1] for r in kernels) // steps
    print(f"  {label} ({int(active.sum())} slots decoding): wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms (idle share {1 - busy_ms / wall_ms:.2f}), "
          f"{n_kernels} kernels; weight-read floor {floor_ms:.2f} ms")
    for us, n, key in sorted(kernels, reverse=True)[:8]:
        print(f"    {us / 1e3 / steps:7.3f} ms/step  {n // steps:4d} calls/step  {key[:80]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=n_kernels, floor_ms=floor_ms)


# ----------------------------------------------------------------- phase 7

# the kernel API's main shapes (codeqwen1.5-7b, bf16): one prompt's 32 heads
# of 1024 tokens for flat flash attention; a 2048-token prefill's d_model for
# RMSNorm; a 64-row pack's logits over the vocabulary and f32 attention-score
# rows for softmax; a 4-slot decode step's w_in and a prefill-sized M = 256
# for the matmul. Ragged tails: S = 96, R = 37
FLASH_MAIN = (32, 1024, 128)  # BH, S, d
RMSNORM_MAIN = (2048, 4096)
SOFTMAX_MAIN = (64, 92416)
SOFTMAX_SCORES = (4096, 1024)
MATMUL_API = (MATMUL_MAIN, (256, 4096, 13440))
# the kernel API's tolerances. At f32 both sides compute in f32 in different
# orders; at bf16 both compute in f32 from the same inputs and round the
# output once, so they differ by a bf16 step or two. RMSNorm: |kernel -
# plain| <= tol * (|plain| + rms(plain)), the floor at the output's own
# scale. Flash attention: tol * (|plain| + max|plain row|): the plain version
# rounds p to bf16 before P.V (as the JAX oracle does), an error of a bf16
# step of the row's terms p.v, which an element that cancels can fall far
# below (S = 1024, row 1: |plain| 0.009 beside a row max of 2.4). Softmax: each element
# against its own value, |kernel - plain| <= rtol * |plain| + 1e-6 * max|plain
# row|, rtol one or two output roundings, and every row sums to 1 within
# rtol: nearly every element of a 92,416-wide row is far below the largest,
# and a floor at the row's scale would let a dropped or mis-scaled chunk pass
API_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
SOFTMAX_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def kernel_api(dev, counters):
    """Phase 7: the kernel API (``ops.flash_attention``, ``ops.rmsnorm``,
    ``ops.softmax``, ``ops.matmul``) and its autotuner on the card.

    (a) every candidate configuration of flat flash attention, RMSNorm,
    softmax and the matmul's K split against the plain version, at the main
    shapes and the ragged tails, each candidate timed; (b) a sweep of the
    four ops at their main shapes into a JSON cache under build/
    (``REPRO_AUTOTUNE=1``), every candidate of the sweep launching, a fresh
    tuner on that file hitting without a measure, and the tuned outputs equal
    to the default plan's; (c) the counts set to
    0, the four ops driven once through ``ops`` at the main shapes with the
    tuned plans, the counts read; (d) each op's time beside its bound, plain
    version and library call. Returns (timed rows, launches)."""
    import os

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import rmsnorm as rnk
    from repro_torch.kernels import softmax as smk

    gen = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    worst = {}  # op -> (its rule, the largest share of the limit an element used)

    def held(name, case, got, want, tol):
        """max |got - want|, after checking it everywhere against the op's
        rule (see API_TOL and SOFTMAX_RTOL)."""
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        if name == "softmax":
            limit = tol * want.abs() + 1e-6 * want.abs().amax(-1, keepdim=True)
            rule = f"{tol} * |plain| + 1e-6 * max|plain row|"
            sums = got.double().sum(-1)
            if not ((sums - 1).abs() <= tol).all():
                raise AssertionError(f"{name} {case}: row sums {sums.min().item()} to "
                                     f"{sums.max().item()}, not 1 within {tol}")
        elif name == "flash_attention":
            limit = tol * (want.abs() + want.abs().amax(-1, keepdim=True))
            rule = f"{tol} * (|plain| + max|plain row|)"
        else:
            limit = tol * (want.abs() + want.pow(2).mean().sqrt())
            rule = f"{tol} * (|plain| + rms(plain))"
        bad = diff > limit
        if bad.any() or not torch.isfinite(got).all():
            raise AssertionError(f"{name} {case}: {int(bad.sum())} elements outside {rule}, "
                                 f"max_abs_err {diff.max().item()}")
        used = (diff / limit).max().item()
        if used >= worst.get(name, ("", -1.0))[1]:
            worst[name] = (rule, used)
        return diff.max().item()

    def tol_of(name, dtype):
        return (SOFTMAX_RTOL if name == "softmax" else API_TOL)[dname(dtype)]

    def dname(dtype):
        return str(dtype).split(".")[-1]

    # ---- (a) every candidate against the plain version
    bh, s, d = FLASH_MAIN
    # bf16 runs the wgmma body at its tiles, f32 the CUDA-core body at its own
    flash_cases = [(bh, s, s, d, causal, bf16) for causal in (True, False)] + [
        (bh, 96, 96, d, True, bf16), (bh, s, s, 80, True, bf16), (8, 96, 96, 16, True, f32),
        (8, 80, 130, 64, False, f32), (8, 80, 130, 80, True, f32)]
    cand_ms = {}
    for b_, sq, sk, d_, causal, dtype in flash_cases:
        q, k, v = randn(b_, sq, d_, dtype=dtype), randn(b_, sk, d_, dtype=dtype), \
            randn(b_, sk, d_, dtype=dtype)
        want = ref.flash_attention(q[None], k[None], v[None], causal=causal)[0]
        sdpa = ""
        if dtype == bf16 and sq == s:  # the main shapes: SDPA beside every tile
            sdpa = " SDPA={:.4f}".format(time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=causal)))
        for tile in fk.TILES[dtype]:
            run = lambda: fk.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                             block_q=tile[0], block_k=tile[1])
            case = f"BH={b_} Sq={sq} Sk={sk} d={d_} causal={causal} {dname(dtype)} tile={tile}"
            err = held("flash_attention", case, run(), want, API_TOL[dname(dtype)])
            ms = time_ms(run)
            cand_ms[("flash_attention", b_, sq, sk, d_, causal, dtype, tile)] = ms
            print(f"  flash_attention   {case:60s} err={err:.2e} ms={ms:.4f}{sdpa}", flush=True)
    row_cases = [
        ("rmsnorm", RMSNORM_MAIN, bf16, bf16), ("rmsnorm", (37, 4096), bf16, bf16),
        ("rmsnorm", (37, 4100), f32, f32), ("rmsnorm", (37, 4096), bf16, f32),
        ("softmax", SOFTMAX_MAIN, bf16, None), ("softmax", SOFTMAX_SCORES, f32, None),
        ("softmax", (37, 92416), bf16, None), ("softmax", (37, 1000), f32, None),
    ]
    for name, (r, c), dtype, wdtype in row_cases:
        x = randn(r, c, dtype=dtype, scale=4.0)
        w = randn(c, dtype=wdtype) if wdtype is not None else None
        want = ref.rmsnorm(x, w) if w is not None else ref.softmax(x)
        for rows in rnk.BLOCK_ROWS:
            if w is not None:
                run = lambda: rnk.rmsnorm(x, w, block_rows=rows)  # noqa: E731
            else:
                run = lambda: smk.softmax(x, block_rows=rows)  # noqa: E731
            case = f"R={r} C={c} {dname(dtype)} w={dname(wdtype) if w is not None else '-'} " \
                   f"block_rows={rows}"
            if w is None:
                case += f" ({smk.route(r, c, dtype, rows)})"
            err = held(name, case, run(), want, tol_of(name, dtype))
            ms = time_ms(run)
            cand_ms[(name, r, c, dtype, rows)] = ms
            print(f"  {name:17s} {case:60s} err={err:.2e} ms={ms:.4f}", flush=True)
    for m, k, n in MATMUL_API:
        a, b = randn(m, k), randn(k, n)
        want = ref.matmul(a, b)
        tol = MATMUL_REL_TOL["bfloat16"] * want.float().abs().max().item()
        body = mmk.route(m, k, n, bf16, bf16)
        for cfg in autotune.candidates("matmul", bf16):
            run = lambda: mmk.matmul(a, b, **cfg)  # noqa: E731
            case = (f"M={m} K={k} N={n} bfloat16 {body} tile={cfg['block_m']}x{cfg['block_n']} "
                    f"split_k={cfg['split_k']}")
            err = (run().float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"matmul {case}: max_abs_err {err} above {tol}")
            ms = time_ms(run)
            cand_ms[("matmul", m, k, n, tuple(cfg.values()))] = ms
            print(f"  matmul            {case:60s} err={err:.2e} ms={ms:.4f}", flush=True)

    for name, (rule, used) in worst.items():
        print(f"  {name}: every candidate within {rule}; the worst element used "
              f"{used:.3f} of its limit at its dtype's tol")

    # ---- (b) the autotuner: sweep into a fresh cache, read it back
    cache = ROOT / "build" / "chip_smoke_autotune.json"
    cache.unlink(missing_ok=True)
    saved = {key: os.environ.get(key) for key in ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE")}
    os.environ.update(REPRO_AUTOTUNE="1", REPRO_AUTOTUNE_CACHE=str(cache))
    autotune.set_tuner(None)  # the next op builds the tuner from the environment
    try:
        tuner = autotune.get_tuner()
        if not (tuner.sweep and tuner.path == str(cache)):
            raise AssertionError("the tuner did not take REPRO_AUTOTUNE / REPRO_AUTOTUNE_CACHE")
        q, k, v = (randn(1, bh, s, d) for _ in range(3))
        mm_in = [(randn(m, k_), randn(k_, n)) for m, k_, n in MATMUL_API]
        x_rms, w_rms = randn(*RMSNORM_MAIN, scale=4.0), randn(RMSNORM_MAIN[1])
        x_sm, x_sc = randn(*SOFTMAX_MAIN, scale=4.0), randn(*SOFTMAX_SCORES, dtype=f32,
                                                            scale=4.0)
        swept = [("flash_attention", (bh, s, d), bf16, lambda: ops.flash_attention(q, k, v))] + [
            ("matmul", tuple(a.shape) + (b.shape[1],), bf16, lambda a=a, b=b: ops.matmul(a, b))
            for a, b in mm_in] + [
            ("rmsnorm", RMSNORM_MAIN, bf16, lambda: ops.rmsnorm(x_rms, w_rms)),
            ("softmax", SOFTMAX_MAIN, bf16, lambda: ops.softmax(x_sm)),
            ("softmax", SOFTMAX_SCORES, f32, lambda: ops.softmax(x_sc))]
        tuned = {}
        for op, shape, dtype, call in swept:
            n0 = tuner.sweeps_run
            call()
            torch.cuda.synchronize()
            if tuner.sweeps_run != n0 + 1:
                raise AssertionError(f"{op} {shape}: no sweep ran on a cold cache")
            log = ", ".join(f"{cfg}: {sec * 1e3:.4f} ms" if err is None else f"{cfg}: {err}"
                            for cfg, sec, err in tuner.last_sweep)
            tuned[(op, shape)] = tuner.lookup(op, shape, dtype, "cuda")
            print(f"  sweep {op} {shape} {dname(dtype)}: {log}; winner {tuned[(op, shape)]} "
                  f"(default {autotune.default(op, dtype)})", flush=True)
            failed = [(cfg, err) for cfg, _, err in tuner.last_sweep if err is not None]
            if failed or len(tuner.last_sweep) != len(autotune.candidates(op, dtype)):
                raise AssertionError(f"{op} {shape}: candidates failed in the sweep: {failed}")
        print(f"  sweeps_run {tuner.sweeps_run}, cache {cache.relative_to(ROOT)}: "
              f"{len(json.loads(cache.read_text()))} entries")
        fresh = autotune.Autotuner(str(cache), sweep=True)
        asked = []
        for op, shape, dtype, _ in swept:
            got = fresh.get(op, shape, dtype, "cuda", measure=lambda cfg: asked.append(cfg) or 0.0)
            if got != tuned[(op, shape)]:
                raise AssertionError(f"{op} {shape}: a fresh tuner read {got}, "
                                     f"the sweep stored {tuned[(op, shape)]}")
        if asked or fresh.sweeps_run:
            raise AssertionError(f"a fresh tuner on the cache measured again: {asked}")
        print(f"  a fresh Autotuner on the cache: {len(swept)} hits, sweeps_run 0")
        tile = fk.DEFAULT_TILE[bf16]
        err = held("flash_attention", "tuned vs default plan", ops.flash_attention(q, k, v),
                   ops.flash_attention(q, k, v, block_q=tile[0], block_k=tile[1]),
                   API_TOL["bfloat16"])
        print(f"  ops.flash_attention tuned plan vs default: max_abs_err {err:.2e}")
        for name, call, x_, dtype in [
                ("rmsnorm", lambda **kw: ops.rmsnorm(x_rms, w_rms, **kw), x_rms, bf16),
                ("softmax", lambda **kw: ops.softmax(x_sm, **kw), x_sm, bf16),
                ("softmax", lambda **kw: ops.softmax(x_sc, **kw), x_sc, f32)]:
            err = held(name, "tuned vs default plan", call(), call(block_rows=0),
                       tol_of(name, dtype))
            print(f"  ops.{name} {tuple(x_.shape)} tuned plan vs default: max_abs_err {err:.2e}")
        for a, b in mm_in:
            want = ops.matmul(a, b, **autotune.default("matmul", bf16))
            tol = MATMUL_REL_TOL["bfloat16"] * want.float().abs().max().item()
            err = (ops.matmul(a, b).float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"matmul M={a.shape[0]}: tuned vs default {err} above {tol}")
            print(f"  ops.matmul M={a.shape[0]} tuned plan vs default: max_abs_err {err:.2e} "
                  f"(tol {tol:.3g})")

        # ---- (c) the kernel API's main path, counted
        reset_counts(counters)
        outs = [ops.flash_attention(q, k, v), ops.flash_attention(q, k, v, causal=False),
                ops.rmsnorm(x_rms, w_rms), ops.softmax(x_sm), ops.softmax(x_sc)] + [
            ops.matmul(a, b) for a, b in mm_in]
        torch.cuda.synchronize()
        launches = read_counts(counters, "phase 7 (the kernel API at its main shapes)")
        for o in outs:
            if not torch.isfinite(o).all():
                raise AssertionError("the kernel API gave a non-finite output")
        plans = {(op, shape): ops._blocks(op, shape, dt) for op, shape, dt in [
            ("flash_attention", FLASH_MAIN, bf16), ("rmsnorm", RMSNORM_MAIN, bf16),
            ("softmax", SOFTMAX_MAIN, bf16), ("softmax", SOFTMAX_SCORES, f32)] + [
            ("matmul", shape, bf16) for shape in MATMUL_API]}
        print(f"  plans at the main shapes: {plans}")
        # the vocabulary's logits are the only call of the run that may take
        # the cluster body, the f32 scores the only one that may take the rows
        bodies = {shape: smk.route(*shape, dt, plans[("softmax", shape)]["block_rows"])
                  for shape, dt in ((SOFTMAX_MAIN, bf16), (SOFTMAX_SCORES, f32))}
        print(f"  softmax bodies at the main shapes: {bodies}")
        if bodies != {SOFTMAX_MAIN: "cluster", SOFTMAX_SCORES: "rows"} or \
                launches["softmax_cluster"] != 1 or launches["softmax_rows"] != 1:
            raise AssertionError(f"softmax: the main shape must run the cluster body and the "
                                 f"scores the rows body once each, got {bodies}, cluster "
                                 f"{launches['softmax_cluster']}, rows {launches['softmax_rows']}")
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        autotune.set_tuner(None)

    # ---- (d) each op at its main shape: time, bound, plain, library
    results = {}
    fl = 4 * d * bh * sum(i + 1 for i in range(s))  # causal: key j <= query i
    qf, kf, vf = q[0], k[0], v[0]
    cfg = plans[("flash_attention", FLASH_MAIN)]
    results["flash_attention"] = dict(
        ms=time_ms(lambda: fk.flash_attention(qf, kf, vf, block_q=cfg["block_q"],
                                              block_k=cfg["block_k"])),
        plain_ms=time_ms(lambda: ref.flash_attention(q, k, v)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        library="torch.nn.functional.scaled_dot_product_attention (causal)", config=cfg,
        max_abs_err=held("flash_attention", "main", outs[0], ref.flash_attention(q, k, v),
                         API_TOL["bfloat16"]))
    results["flash_attention"]["bound_ms"], results["flash_attention"]["bound_by"] = bound(
        nbytes(q, k, v, q), fl, bf16)
    rows = plans[("rmsnorm", RMSNORM_MAIN)]["block_rows"]
    results["rmsnorm"] = dict(
        ms=time_ms(lambda: rnk.rmsnorm(x_rms, w_rms, block_rows=rows)),
        plain_ms=time_ms(lambda: ref.rmsnorm(x_rms, w_rms)),
        library_ms=time_ms(lambda: F.rms_norm(x_rms, (RMSNORM_MAIN[1],), w_rms, 1e-6)),
        library="torch.nn.functional.rms_norm", config={"block_rows": rows},
        max_abs_err=held("rmsnorm", "main", outs[2], ref.rmsnorm(x_rms, w_rms),
                         API_TOL["bfloat16"]))
    results["rmsnorm"]["bound_ms"], results["rmsnorm"]["bound_by"] = bound(
        nbytes(x_rms, w_rms, x_rms), 3 * x_rms.numel(), bf16)
    rows = plans[("softmax", SOFTMAX_MAIN)]["block_rows"]
    results["softmax"] = dict(
        ms=time_ms(lambda: smk.softmax(x_sm, block_rows=rows)),
        plain_ms=time_ms(lambda: ref.softmax(x_sm)),
        library_ms=time_ms(lambda: torch.softmax(x_sm, -1)),
        library="torch.softmax", config={"block_rows": rows},
        max_abs_err=held("softmax", "main", outs[3], ref.softmax(x_sm), SOFTMAX_RTOL["bfloat16"]))
    results["softmax"]["bound_ms"], results["softmax"]["bound_by"] = bound(
        nbytes(x_sm, x_sm), 4 * x_sm.numel(), bf16)
    for name, t in results.items():
        t["tol"] = tol_of(name, bf16)
        print(f"  {name:17s} main shape, plan {t['config']}: ms={t['ms']:.4f} "
              f"bound={t['bound_ms']:.5f} ({t['bound_by']}) plain={t['plain_ms']:.4f} "
              f"library={t['library_ms']:.4f} ({t['library']})", flush=True)
    # beside them: the non-causal flash, the f32 score rows, the tuned matmuls
    nc = time_ms(lambda: fk.flash_attention(qf, kf, vf, causal=False, block_q=cfg["block_q"],
                                            block_k=cfg["block_k"]))
    err = held("flash_attention", "main, non-causal", outs[1],
               ref.flash_attention(q, k, v, causal=False), API_TOL["bfloat16"])
    print(f"  flash_attention non-causal, plan {cfg}: err={err:.2e} ms={nc:.4f} "
          f"bound={bound(nbytes(q, k, v, q), 2 * fl, bf16)[0]:.5f} "
          f"SDPA={time_ms(lambda: F.scaled_dot_product_attention(q, k, v)):.4f}")
    rows = plans[("softmax", SOFTMAX_SCORES)]["block_rows"]
    err = held("softmax", "scores, f32", outs[4], ref.softmax(x_sc), SOFTMAX_RTOL["float32"])
    print(f"  softmax R={SOFTMAX_SCORES[0]} C={SOFTMAX_SCORES[1]} f32, block_rows {rows}: "
          f"err={err:.2e} ms={time_ms(lambda: smk.softmax(x_sc, block_rows=rows)):.4f} "
          f"bound={bound(nbytes(x_sc, x_sc), 4 * x_sc.numel(), f32)[0]:.5f} "
          f"torch.softmax={time_ms(lambda: torch.softmax(x_sc, -1)):.4f}")
    for (m, k_, n), (a, b) in zip(MATMUL_API, mm_in):
        plan = plans[("matmul", (m, k_, n))]
        print(f"  matmul M={m} K={k_} N={n} bf16 ({mmk.route(m, k_, n, bf16, bf16)}): tuned "
              f"{plan} {cand_ms[('matmul', m, k_, n, tuple(plan.values()))]:.4f} ms, default "
              f"{cand_ms[('matmul', m, k_, n, (0, 0, 0))]:.4f} ms, bound "
              f"{bound(nbytes(a, b) + m * n * 2, 2 * m * k_ * n, bf16)[0]:.5f}, torch.matmul "
              f"{time_ms(lambda: torch.matmul(a, b)):.4f}")
    # the M = 256 matmul on the wgmma tile: a row of its own
    (m, k_, n), (a, b) = MATMUL_API[1], mm_in[1]
    plan = plans[("matmul", (m, k_, n))]
    want = ref.matmul(a, b)
    tol = MATMUL_REL_TOL["bfloat16"] * want.float().abs().max().item()
    results["matmul_tile"] = dict(
        ms=time_ms(lambda: mmk.matmul(a, b, **plan)), plain_ms=time_ms(lambda: ref.matmul(a, b)),
        library_ms=time_ms(lambda: torch.matmul(a, b)), library="torch.matmul", config=plan,
        max_abs_err=(outs[-1].float() - want.float()).abs().max().item(), tol=tol)
    if not results["matmul_tile"]["max_abs_err"] <= tol:
        raise AssertionError(f"matmul M={m} through ops: max_abs_err "
                             f"{results['matmul_tile']['max_abs_err']} above {tol}")
    results["matmul_tile"]["bound_ms"], results["matmul_tile"]["bound_by"] = bound(
        nbytes(a, b) + m * n * 2, 2 * m * k_ * n, bf16)
    t = results["matmul_tile"]
    print(f"  matmul_tile       M={m} K={k_} N={n}, plan {plan}: ms={t['ms']:.4f} "
          f"bound={t['bound_ms']:.5f} ({t['bound_by']}) plain={t['plain_ms']:.4f} "
          f"library={t['library_ms']:.4f} (torch.matmul)", flush=True)
    torch.cuda.synchronize()
    return results, launches


# ----------------------------------------------------------------- phase 8

# the paper's kernel suite at one card's size: axpy and dotp over vectors of
# 2^28 elements (1 GiB each in f32), axpy also over bf16 [64, 2^22] at alpha
# 1/3 (an alpha bf16 rounds); the FFT at the paper's 16,384-point rows
# (benchmarks/common.py), 8,192 of them, beside 65,536 f32 rows of 1,024 and
# 4,096 bf16 rows of 4,096; conv2d at the paper's fconv2d widths (C = O =
# 256, 3 x 3 taps) over four 512 x 512 bf16 images, and an f32 case. Tails:
# axpy [3, 1,000,003], dotp over 1,000,003 elements and dotp_partials
# [8, 100,003] at each block, FFT rows [37, 64] and N = 2, conv2d with a
# ragged H and with 1 x 1 taps
SUITE_N = 2**28
AXPY_BF16 = (64, 2**22)
FFT_MAIN = (8192, 16384)
FFT_CASES = (FFT_MAIN, (65536, 1024), (4096, 4096), (37, 64), (8, 2))
# rows longer than a block (the four-step path): 2^15 and 2^20 points, 2^25
# elements each (128 MiB of f32 per plane)
FFT_LONG = ((1024, 32768), (32, 2**20))
CONV_MAIN = ((4, 512, 512, 256), (3, 3, 256, 256))
CONV_CASES = (CONV_MAIN, ((2, 128, 128, 64), (3, 3, 64, 64)), ((2, 13, 9, 4), (3, 3, 4, 8)),
              ((1, 8, 8, 4), (1, 1, 4, 4)))
# the suite's tolerances (tests/test_torch_suite.py holds the same rules).
# axpy: each element within one unit in the last place of its dtype — the
# kernel's fma and the plain version's float64 sum round once alike, but at
# a double-rounding tie of the f64 sum. dotp: within 1e-5 * sum |x_i y_i|,
# f32 sums in different orders (the result itself cancels: ~1.6e4 against
# ~2e8 at 2^28 normals). FFT: max |kernel - plain| / max |plain| below 1e-5
# at f32 (the JAX test's bound; the kernel's Stockham stages against cuFFT,
# both f32) and 1e-2 at bf16 (an output rounding, 2^-8, of the largest).
# conv2d: |kernel - plain| <= tol * (|plain| + rms(plain)), 1e-5 at f32 (sums
# in other orders) and 1e-2 at bf16 (one output rounding).
SUITE_TOL = {"dotp": 1e-5, "fft": {"float32": 1e-5, "bfloat16": 1e-2},
             "conv2d": {"float32": 1e-5, "bfloat16": 1e-2}}
SUITE_REPS = 10  # calls per timed graph: each main-shape call takes a millisecond or more


def kernel_suite(dev, counters):
    """Phase 8: the paper's kernel suite (``ops.axpy``, ``ops.dotp``,
    ``ops.fft``, ``ops.conv2d``) on the card.

    (a) every candidate of each kernel against its plain version at the main
    shapes and the tails, each timed; (b) a ``REPRO_AUTOTUNE=1`` sweep of the
    four ops at their main shapes into phase 7's cache file, every candidate
    launching (or, for the FFT, refused where its rows do not fit a block),
    and a fresh tuner on that file hitting without a measure; (c) the counts
    set to 0, the four ops driven once through ``ops`` at the main shapes
    with the tuned plans, the counts read, each output held against its
    plain version; (d) each op's time beside its bound, plain version and
    one library call. Returns (timed rows, launches)."""
    import os

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels import axpy as axk
    from repro_torch.kernels import conv2d as cvk
    from repro_torch.kernels import dotp as dpk
    from repro_torch.kernels import fft as ffk

    gen = torch.Generator(device=dev).manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def dname(dtype):
        return str(dtype).split(".")[-1]

    worst = {}  # "op dtype" -> (its rule, the largest share of the limit an element used)

    def held(name, case, got, want, *operands):
        """max |got - want| after checking it against the op's rule (see
        SUITE_TOL); ``operands`` are dotp's x and y."""
        if isinstance(got, tuple):  # the FFT's (re, im): one scale for both
            scale = max(w.float().abs().max().item() for w in want)
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            tol = SUITE_TOL["fft"][dname(want[0].dtype)]
            rule = f"{tol} * max|plain|"
            if not err <= tol * scale or not all(torch.isfinite(g).all() for g in got):
                raise AssertionError(f"{name} {case}: max_abs_err {err} outside {rule} "
                                     f"(max|plain| {scale})")
            used = err / (tol * scale)
        else:
            diff = (got.float() - want.float()).abs()
            if name == "axpy":
                w = want.float().abs()
                limit = 2.0 ** (torch.floor(torch.log2(torch.where(w == 0, 2.0**-126, w)))
                                - (23 if want.dtype == f32 else 7))
                rule = "one unit in the last place of the plain output"
            elif name == "dotp":
                x, y = operands
                limit = SUITE_TOL["dotp"] * (x.float() * y.float()).abs().sum().item()
                rule = "1e-5 * sum |x y|"
            else:
                tol = SUITE_TOL["conv2d"][dname(want.dtype)]
                w = want.float()
                limit = tol * (w.abs() + w.pow(2).mean().sqrt())
                rule = f"{tol} * (|plain| + rms(plain))"
            bad = diff > limit
            if bad.any() or not torch.isfinite(got.float()).all():
                raise AssertionError(f"{name} {case}: {int(bad.sum())} elements outside {rule}, "
                                     f"max_abs_err {diff.max().item()}")
            err = diff.max().item()
            used = (diff / limit).max().item()
        key = f"{name} {dname((want[0] if isinstance(want, tuple) else want).dtype)}"
        if used >= worst.get(key, ("", -1.0))[1]:
            worst[key] = (rule, used)
        return err

    def candidates(name, case, knob, values, run, want, *operands, skip=lambda v: False):
        for v in values:
            if skip(v):
                continue
            fn = lambda v=v: run(v)  # noqa: E731
            err = held(name, f"{case} {knob}={v}", fn(), want, *operands)
            ms = time_ms(fn, reps=SUITE_REPS)
            print(f"  {name:7s} {case:44s} {knob}={v:<6d} err={err:.2e} ms={ms:.4f}", flush=True)

    # ---- (a) every candidate against the plain version, op by op
    for shape, dtype, alpha in [((1, SUITE_N), f32, 2.5), (AXPY_BF16, bf16, 1 / 3),
                                ((3, 1000003), f32, 1 / 3), ((3, 1000003), bf16, 2.5)]:
        x, y = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
        want = ref.axpy(alpha, x, y)
        candidates("axpy", f"{list(shape)} {dname(dtype)} alpha={alpha:.4g}", "block", axk.BLOCK,
                   lambda b: axk.axpy(alpha, x, y, block=b), want)
        del x, y, want
    for shape, dtype in [((1, SUITE_N), f32), ((1, SUITE_N), bf16), ((1, 1000003), f32),
                         ((8, 100003), bf16), ((8, 100003), f32)]:
        x, y = randn(*shape, dtype=dtype), randn(*shape, dtype=dtype)
        candidates("dotp", f"{list(shape)} {dname(dtype)}", "block", dpk.BLOCK,
                   lambda b: dpk.dotp(x, y, block=b), ref.dotp(x, y), x, y)
        if shape[0] > 1:  # the partials' layout: [R, cdiv(C, block)] at each block
            for b in dpk.BLOCK:
                eff = b or dpk.auto_block(*shape, torch.cuda.get_device_properties(dev)
                                          .multi_processor_count)
                got, want = dpk.dotp_partials(x, y, block=b), ref.dotp_partials(x, y, eff)
                mag = ref.dotp_partials(x.abs(), y.abs(), eff)
                if got.shape != (shape[0], -(-shape[1] // eff)) or \
                        not ((got - want).abs() <= SUITE_TOL["dotp"] * mag).all():
                    raise AssertionError(f"dotp_partials {shape} block={b}: {tuple(got.shape)}, "
                                         f"max_abs_err {(got - want).abs().max().item()}")
            print(f"  dotp_partials {list(shape)} {dname(dtype)}: [R, cdiv(C, block)] at every "
                  f"block, each partial within 1e-5 * its sum |x y|")
        del x, y
    for (b, n), dtype in [(FFT_CASES[0], f32), (FFT_CASES[1], f32), (FFT_CASES[2], bf16),
                          (FFT_CASES[3], f32), (FFT_CASES[4], f32), (FFT_CASES[3], bf16),
                          (FFT_LONG[0], f32), (FFT_LONG[1], f32), ((3, 2**17), bf16)]:
        re, im = randn(b, n, dtype=dtype), randn(b, n, dtype=dtype)
        candidates("fft", f"[{b}, {n}] {dname(dtype)}", "block_rows", ffk.BLOCK_ROWS,
                   lambda r: ffk.fft(re, im, block_rows=r), ref.fft(re, im),
                   skip=lambda r: not ffk.fits(n, r))
        for r in ffk.BLOCK_ROWS:
            if not ffk.fits(n, r):  # refused, not run
                try:
                    ffk.fft(re, im, block_rows=r)
                except ValueError:
                    continue
                raise AssertionError(f"fft N={n}: block_rows {r} does not fit, yet ran")
        del re, im
    torch.backends.cudnn.allow_tf32 = False  # the plain conv in full f32
    # x and w of one dtype, then mixed (the FMA tile widens each to f32 and
    # writes x's dtype)
    for (xs, ws), dtype, wdtype in [
            (CONV_CASES[0], bf16, bf16), (CONV_CASES[1], f32, f32), (CONV_CASES[2], f32, f32),
            (CONV_CASES[2], bf16, bf16), (CONV_CASES[3], bf16, bf16), (CONV_CASES[1], bf16, f32),
            (CONV_CASES[2], f32, bf16)]:
        x, w = randn(*xs, dtype=dtype), randn(*ws, dtype=wdtype)
        candidates("conv2d", f"{list(xs)} x {list(ws)} {dname(dtype)} x {dname(wdtype)} w",
                   "block_h", cvk.BLOCK_H, lambda h: cvk.conv2d(x, w, block_h=h), ref.conv2d(x, w))
        del x, w
    torch.cuda.empty_cache()
    for name, (rule, used) in worst.items():
        print(f"  {name}: every candidate within {rule}; the worst element used {used:.3f} of its "
              f"limit")

    # ---- (b) the autotuner: sweep the main shapes into phase 7's cache, read it back
    cache = ROOT / "build" / "chip_smoke_autotune.json"
    saved = {key: os.environ.get(key) for key in ("REPRO_AUTOTUNE", "REPRO_AUTOTUNE_CACHE")}
    os.environ.update(REPRO_AUTOTUNE="1", REPRO_AUTOTUNE_CACHE=str(cache))
    autotune.set_tuner(None)
    results = {}
    try:
        tuner = autotune.get_tuner()
        if not (tuner.sweep and tuner.path == str(cache)):
            raise AssertionError("the tuner did not take REPRO_AUTOTUNE / REPRO_AUTOTUNE_CACHE")
        vx, vy = randn(SUITE_N), randn(SUITE_N)
        re, im = randn(*FFT_MAIN), randn(*FFT_MAIN)
        cx, cw = randn(*CONV_MAIN[0], dtype=bf16), randn(*CONV_MAIN[1], dtype=bf16)
        main = {  # op -> (cache key shape, dtype, the ops call)
            "axpy": ((1, SUITE_N), f32, lambda: ops.axpy(1 / 3, vx, vy)),
            "dotp": ((1, SUITE_N), f32, lambda: ops.dotp(vx, vy)),
            "fft": (FFT_MAIN, f32, lambda: ops.fft(re, im)),
            "conv2d": (CONV_MAIN[0], bf16, lambda: ops.conv2d(cx, cw)),
        }
        tuned = {}
        for op, (shape, dtype, call) in main.items():
            n0 = tuner.sweeps_run
            call()
            torch.cuda.synchronize()
            if tuner.sweeps_run != n0 + 1:
                raise AssertionError(f"{op} {shape}: no sweep ran on a cold cache")
            log = ", ".join(f"{cfg}: {sec * 1e3:.4f} ms" if err is None else f"{cfg}: {err}"
                            for cfg, sec, err in tuner.last_sweep)
            tuned[op] = tuner.lookup(op, shape, dtype, "cuda")
            print(f"  sweep {op} {shape} {dname(dtype)}: {log}; winner {tuned[op]} "
                  f"(default {autotune.default(op, dtype)})", flush=True)
            # only the FFT's rows that do not fit a block may fail, and they must
            failed = [cfg for cfg, _, err in tuner.last_sweep if err is not None]
            refused = [cfg for cfg in autotune.CANDIDATES[op]
                       if op == "fft" and not ffk.fits(shape[1], cfg["block_rows"])]
            if failed != refused or len(tuner.last_sweep) != len(autotune.CANDIDATES[op]):
                raise AssertionError(f"{op} {shape}: candidates failed in the sweep: {failed}")
        # rows past a block: the four-step path, whose only candidate is block_rows 0
        lre, lim = randn(*FFT_LONG[0]), randn(*FFT_LONG[0])
        ops.fft(lre, lim)
        torch.cuda.synchronize()
        log = ", ".join(f"{cfg}: {sec * 1e3:.4f} ms" if err is None else f"{cfg}: refused"
                        for cfg, sec, err in tuner.last_sweep)
        print(f"  sweep fft {FFT_LONG[0]} float32: {log}", flush=True)
        if tuner.lookup("fft", FFT_LONG[0], f32, "cuda") != {"block_rows": 0}:
            raise AssertionError("fft: a row past a block must plan block_rows 0")
        fresh = autotune.Autotuner(str(cache), sweep=True)
        asked = []
        for op, (shape, dtype, _) in main.items():
            got = fresh.get(op, shape, dtype, "cuda", measure=lambda cfg: asked.append(cfg) or 0.0)
            if got != tuned[op]:
                raise AssertionError(f"{op}: a fresh tuner read {got}, the sweep stored "
                                     f"{tuned[op]}")
        if asked or fresh.sweeps_run:
            raise AssertionError(f"a fresh tuner on the cache measured again: {asked}")
        print(f"  a fresh Autotuner on the cache: {len(main)} hits, sweeps_run 0; cache "
              f"{cache.relative_to(ROOT)}: {len(json.loads(cache.read_text()))} entries")

        # ---- (c) the suite's main path, counted
        reset_counts(counters)
        outs = {op: call() for op, (_, _, call) in main.items()}
        outs["fft_long"] = ops.fft(lre, lim)
        torch.cuda.synchronize()
        launches = read_counts(counters, "phase 8 (the kernel suite at its main shapes)")
        # one four-step call at 2^15 points: three transposes and two row passes
        if launches["fft_long"] != 5:
            raise AssertionError(f"fft_long: {launches['fft_long']} launches counted for one "
                                 "four-step call, 5 made")
        plans = {op: ops._blocks(op, shape, dtype) for op, (shape, dtype, _) in main.items()}
        plans["fft_long"] = ops._blocks("fft", FFT_LONG[0], f32)
        print(f"  plans at the main shapes: {plans}")
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        autotune.set_tuner(None)

    # ---- (d) each op at its main shape: its output held, time, bound, plain, library
    def row(name, out, want, kernel, plain, library, lib_name, nbytes_, flops, dtype,
            *operands):
        t = dict(max_abs_err=held(name, "main, through ops", out, want, *operands),
                 ms=time_ms(kernel, reps=SUITE_REPS), plain_ms=time_ms(plain, reps=SUITE_REPS),
                 library_ms=time_ms(library, reps=SUITE_REPS), library=lib_name,
                 config=plans[name],
                 tol=(SUITE_TOL[name.split("_")[0]][dname(dtype)] if name.startswith(("fft", "conv"))
                      else SUITE_TOL.get(name, "1 ulp")))
        t["bound_ms"], t["bound_by"] = bound(nbytes_, flops, dtype)
        print(f"  {name:7s} main shape, plan {t['config']}: ms={t['ms']:.4f} "
              f"bound={t['bound_ms']:.5f} ({t['bound_by']}) plain={t['plain_ms']:.4f} "
              f"library={t['library_ms']:.4f} ({lib_name})", flush=True)
        results[name] = t

    n = SUITE_N
    blk = plans["axpy"]["block"]
    row("axpy", outs["axpy"], ref.axpy(1 / 3, vx, vy),
        lambda: axk.axpy(1 / 3, vx[None], vy[None], block=blk), lambda: ref.axpy(1 / 3, vx, vy),
        lambda: torch.add(vy, vx, alpha=1 / 3), "torch.add(y, x, alpha=a)",
        nbytes(vx, vy, vx), 2 * n, f32)
    blk = plans["dotp"]["block"]
    row("dotp", outs["dotp"], ref.dotp(vx, vy), lambda: dpk.dotp(vx[None], vy[None], block=blk),
        lambda: ref.dotp(vx, vy), lambda: torch.dot(vx, vy), "torch.dot", nbytes(vx, vy) + 4,
        2 * n, f32, vx, vy)
    del vx, vy, outs["axpy"], outs["dotp"]
    torch.cuda.empty_cache()
    rows_ = plans["fft"]["block_rows"]
    b, n_ = FFT_MAIN
    z = torch.complex(re, im)
    tw = ffk.twiddles(n_, re.device)
    row("fft", outs["fft"], ref.fft(re, im), lambda: ffk.fft(re, im, block_rows=rows_),
        lambda: ref.fft(re, im), lambda: torch.fft.fft(z, dim=-1),
        "torch.fft.fft (cuFFT) over a complex64 tensor made beforehand",
        2 * nbytes(re, im) + nbytes(tw), 5 * b * n_ * int(np.log2(n_)), f32)
    del re, im, z, outs["fft"]
    torch.cuda.empty_cache()
    b, n_ = FFT_LONG[0]
    z = torch.complex(lre, lim)
    row("fft_long", outs["fft_long"], ref.fft(lre, lim), lambda: ffk.fft(lre, lim),
        lambda: ref.fft(lre, lim), lambda: torch.fft.fft(z, dim=-1),
        "torch.fft.fft (cuFFT) over a complex64 tensor made beforehand",
        2 * nbytes(lre, lim), 5 * b * n_ * int(np.log2(n_)), f32)
    del lre, lim, z, outs["fft_long"]
    torch.cuda.empty_cache()
    for (b, n_), dtype in ((FFT_CASES[0], f32), (FFT_CASES[1], f32), (FFT_CASES[2], bf16),
                           (FFT_LONG[0], f32)):
        fre, fim = randn(b, n_, dtype=dtype), randn(b, n_, dtype=dtype)
        z = torch.complex(fre.float(), fim.float())
        print(f"  fft [{b}, {n_}] {dname(dtype)}, the kernel's own block_rows: "
              f"ms={time_ms(lambda: ffk.fft(fre, fim), reps=SUITE_REPS):.4f} bound="
              f"{bound(2 * nbytes(fre, fim), 5 * b * n_ * int(np.log2(n_)), f32)[0]:.5f} "
              f"cuFFT={time_ms(lambda: torch.fft.fft(z, dim=-1), reps=SUITE_REPS):.4f}",
              flush=True)
        del fre, fim, z
    torch.cuda.empty_cache()
    bh = plans["conv2d"]["block_h"]
    (bb, hh, ww, cc), (kh, kw, _, oo) = CONV_MAIN
    m = bb * (hh - kh + 1) * (ww - kw + 1)
    x_cl = cx.permute(0, 3, 1, 2)  # NHWC storage = NCHW in channels_last
    w_cl = cw.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)  # OIHW, channels_last
    row("conv2d", outs["conv2d"], ref.conv2d(cx, cw), lambda: cvk.conv2d(cx, cw, block_h=bh),
        lambda: ref.conv2d(cx, cw), lambda: F.conv2d(x_cl, w_cl),
        "torch.nn.functional.conv2d (cuDNN), bf16 channels_last",
        nbytes(cx, cw) + m * oo * 2, 2 * m * oo * kh * kw * cc, bf16)
    del cx, cw, x_cl, w_cl, outs
    for name, (rule, used) in worst.items():
        print(f"  {name}: the worst element of phase 8 used {used:.3f} of its limit ({rule})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results, launches


# -------------------------------------------------------------------- main


def main() -> int:
    import torch

    # the port comes from this checkout's src/: without it nothing runs
    from repro_torch.kernels import _build
    from repro_torch.kernels import axpy as axk
    from repro_torch.kernels import conv2d as cvk
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import dotp as dpk
    from repro_torch.kernels import fft as ffk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ragged_attention as rk
    from repro_torch.kernels import rmsnorm as rnk
    from repro_torch.kernels import softmax as smk

    phase("0 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    phase("1 build")
    t0 = time.perf_counter()
    _build.load()
    print(f"  built {_build.library_path().relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    log = (_build.library_path().parent / "ptxas.log").read_text()
    regs = [int(w.split()[0]) for w in log.split("Used ")[1:]]
    spills = sum(int(line.split(" bytes spill stores")[0].split()[-1])
                 for line in log.splitlines() if "bytes spill stores" in line)
    print(f"  ptxas: {len(regs)} kernel instantiations ({len(_build.SIGNATURES)} C entry "
          f"points), max {max(regs)} registers, {spills} bytes spill stores")
    lines = log.splitlines()
    for i, line in enumerate(lines[:-1]):  # name the kernels that spill
        if "Function properties for" in line and "bytes spill stores" in lines[i + 1]:
            n = int(lines[i + 1].split(" bytes spill stores")[0].split()[-1])
            if n:
                print(f"    {n} bytes spill stores in {line.split('for ')[-1].strip()[:160]}")

    phase("2 kernels vs plain on the card")
    timed = check_kernels(dev)
    timed.update(check_paged_and_quant_kernels(dev))
    timed.update(check_matmul_kernels(dev))
    check_attention_domain(dev)

    phase("3 kernel path vs plain path, end to end, f32")
    small_model_streams(dev)

    phase("4 full width codeqwen1.5-7b")
    counters4 = {"decode_attention": (dk, "launches"), "ragged_attention": (rk, "launches"),
                 "gqa_flash_attention": (fk, "launches"),
                 "decode_attention_split": (dk, "launches_split")}
    launches, model, params = full_width(dev, counters4)

    phase("5 full width, paged + prefix and quantized KV")
    counters5 = {"paged_attention": (pk, "launches"), "paged_attention_q8": (pk, "launches_q8"),
                 "decode_attention_q8": (dk, "launches_q8"),
                 "ragged_attention_q8": (rk, "launches_q8"),
                 "decode_attention_q8_split": (dk, "launches_split")}
    launches5, serving = paged_and_quantized(dev, model, params, counters5)
    launches.update(launches5)

    phase("6 full width, int8 weights")
    # one name for the split decode body's count (phase 4's), whichever store runs it
    counters6 = {"matmul_q8": (mmk, "launches_q8"), "matmul": (mmk, "launches"),
                 "matmul_q8_gemv_tc": (mmk, "launches_gemv_tc"), **counters4,
                 **{k: v for k, v in counters5.items() if k != "decode_attention_q8_split"}}
    launches6, serving6 = int8_weights(dev, model, params, counters6,
                                       serving["b"]["num_blocks"])
    # no serving path calls matmul (the dense projections are torch.matmul, as
    # the JAX package's are XLA's): its launches are phase 7's
    launches.update(matmul_q8=launches6["matmul_q8"],
                    matmul_q8_gemv_tc=launches6["matmul_q8_gemv_tc"])
    serving["int8_weights"] = serving6
    print(json.dumps({"serving": serving}))

    phase("7 kernel API and autotuner")
    counters7 = {"flash_attention": (fk, "launches_flat"), "rmsnorm": (rnk, "launches"),
                 "softmax": (smk, "launches"), "softmax_cluster": (smk, "launches_cluster"),
                 "softmax_rows": (smk, "launches_rows"), "matmul": (mmk, "launches"),
                 "matmul_tile": (mmk, "launches_wgmma"),
                 "matmul_gemv_tc": (mmk, "launches_gemv_tc")}
    timed7, launches7 = kernel_api(dev, counters7)
    timed.update(timed7)
    launches.update(launches7)

    phase("8 the paper's kernel suite")
    del model, params  # phase 4's weights: nothing after phase 6 reads them
    torch.cuda.empty_cache()
    counters8 = {"axpy": (axk, "launches"), "dotp": (dpk, "launches"),
                 "fft": (ffk, "launches"), "fft_long": (ffk, "launches_long"),
                 "conv2d": (cvk, "launches"), "conv2d_wgmma": (cvk, "launches_wgmma")}
    timed8, launches8 = kernel_suite(dev, counters8)
    timed.update(timed8)
    launches.update(launches8)

    phase("9 the kernel table")
    # the pl.pallas_call line of each TPU kernel, as in PERF.md's kernel table
    sources = {
        "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:186"),
        "ragged_attention": ("ragged_attention.cu", "src/repro/kernels/ragged_attention.py:253"),
        "gqa_flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:197"),
        "paged_attention": ("paged_attention.cu", "src/repro/kernels/ragged_attention.py:342"),
        "paged_attention_q8": ("paged_attention.cu", "src/repro/kernels/ragged_attention.py:342"),
        "decode_attention_q8": ("decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:186"),
        "ragged_attention_q8": ("ragged_attention.cu",
                                "src/repro/kernels/ragged_attention.py:253"),
        "matmul_q8": ("matmul.cu", "src/repro/kernels/matmul.py:100"),
        "matmul": ("matmul.cu", "src/repro/kernels/matmul.py:138"),
        "matmul_tile": ("matmul.cu", "src/repro/kernels/matmul.py:138"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:126"),
        "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:34"),
        "softmax": ("softmax.cu", "src/repro/kernels/softmax.py:29"),
        "axpy": ("axpy.cu", "src/repro/kernels/axpy.py:36"),
        "dotp": ("dotp.cu", "src/repro/kernels/dotp.py:38"),
        "fft": ("fft.cu", "src/repro/kernels/fft.py:64"),
        "fft_long": ("fft.cu", "src/repro/kernels/fft.py:64"),
        "conv2d": ("conv2d.cu", "src/repro/kernels/conv2d.py:77"),
    }
    # PERF.md's row of each kernel
    rows = {"decode_attention": 1, "ragged_attention": 2, "gqa_flash_attention": 3,
            "decode_attention_q8": 4, "ragged_attention_q8": 5, "paged_attention": 6,
            "paged_attention_q8": 6, "flash_attention": 7, "matmul": 8, "matmul_tile": 8,
            "matmul_q8": 9,
            "rmsnorm": 10, "softmax": 11, "axpy": 12, "dotp": 13, "fft": 14, "fft_long": 14,
            "conv2d": 15}
    kernels = []
    for name, (src, tpu) in sources.items():
        t = timed[name]
        kernels.append({
            "name": name, "row": rows[name], "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            # one line under both names that readers of this JSON look up
            "replaces": tpu, "tpu_kernel": tpu, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "tol": t["tol"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
        if t.get("library"):
            kernels[-1]["library"] = t["library"]
        if name in counters7:  # no serving path calls the kernel API's ops
            kernels[-1]["launched_in"] = "phase 7: the kernel API at its main shapes"
            kernels[-1]["config"] = t.get("config", {"block_m": 0, "block_n": 0, "split_k": 0})
        if name in counters8:
            kernels[-1]["launched_in"] = "phase 8: the kernel suite at its main shapes"
            kernels[-1]["config"] = t["config"]
        if name == "conv2d":  # of its launches, those of the wgmma body
            kernels[-1]["launches_wgmma"] = launches["conv2d_wgmma"]
        if name == "softmax":  # of its launches, those of the cluster and rows bodies
            kernels[-1]["launches_cluster"] = launches["softmax_cluster"]
            kernels[-1]["launches_rows"] = launches["softmax_rows"]
        # the body each row's timed case ran, and its launches on the main path
        if name in ("decode_attention", "decode_attention_q8"):
            kernels[-1]["body"] = "split"
            kernels[-1]["launches_split"] = launches[f"{name}_split"]
        if name in ("matmul_q8", "matmul"):  # the timed case: M = 4
            kernels[-1]["body"] = "gemv_tc"
            kernels[-1]["launches_gemv_tc"] = launches[f"{name}_gemv_tc"]
        if name == "matmul_tile":
            kernels[-1]["body"] = "wgmma"
    print(json.dumps({"kernels": kernels, "to_port": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
