#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

0. device — fail without CUDA; print the card's name and power limit.
1. build — compile the hand-written CUDA kernels from ``csrc/`` (fourteen
   sources over the shared headers ``gemm_wgmma.cuh`` and
   ``split_attention.cuh``: the latent-MQA ragged attention of multi-head
   latent attention ((token, head) rows in 64-row tiles on wgmma with
   TMA-landed latent stages and split-KV spans at bf16, CUDA cores at f32),
   and twenty-one kernel bodies: decode, ragged and
   paged attention over a plain or a quantized store (one split-KV body: the
   position range split over blocks that stream K/V through a cp.async
   ring, partials merged in split order; ragged and paged packs in tiles of
   tokens that share the staged rows), flash attention (GQA, and flat as a group of one; bf16 on wgmma,
   f32 on CUDA cores), the matmul and int8-weight matmul (the decode GEMV
   on tensor cores, mma.sync over a cp.async ring, for bf16 activations, and
   its multi-row form for int8 weights at 9-64 rows;
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
   a scaled f32 store: the identity KV lane of a bf16 model), paged at
   block sizes 8, 16 and 32, G 4 and 12, a pack whose tiles span two
   sequences, and the split paged body over D 16-128 x G 1/4/8/12 x bs
   8/16/32 with and without a window; the matmuls at M = 4-256 live tokens
   (9 and 65 the edges of the multi-row GEMV) over codeqwen's (K, N) and a
   shape with K and N tails, f32 and bf16 activations, each printed with
   the body it took;
   decode, ragged and paged attention at
   the new (head_dim, group) pairs (16, 1), (16, 4), (80, 2), (128, 5) and
   (128, 12) over bf16 and scaled int8 stores; decode and the ragged pack
   at 1, 2 and 4 forced splits beside the kernel's own, and a ragged pack of
   decode singletons; GQA flash at every bf16 tile
   and head width; a paged pack of a prompt's first 40 tokens over fp8 rows
   (P's remainder in a second mma); the latent-MQA kernel at minicpm3-4b's
   widths (latent 256 + rope 32, 40 heads, bf16), deepseek-v2-lite's (512
   + 64, 16 heads, bf16) and the reduced configs' (32 + 8, 4 heads, f32)
   over the 64-token pack, a pack of decode singletons, one mostly and one
   all of padding, a pack whose tiles cross two slots and a 128-token
   bucket, the bf16 serving pack at 1, 2 and 4 forced splits, and at the
   domain's edges (1 and 64 heads, f32 at the wide widths), and its refusal
   of another width; the verify packs of speculative decoding (T = B·(K+1):
   12 and 36 over 4 dense slots and the paged pool, 144 over 16 paged
   sequences; tiles crossing slots, rows past a slot's depth as padding) on
   the ragged and paged kernels, bf16 and f32 queries, G 1 and 4, bf16 and
   int8 stores. Times each kernel, its plain version and
   a one-call PyTorch yardstick (where one exists) as device time (CUDA events
   around one CUDA-graph replay of 30 calls, so the wrappers' host time is
   not counted), and computes its bound at the card's published peaks.
3. kernel path vs plain path — a small f32 model served greedily through
   ServeEngine on the card and on the CPU, dense, paged with prefix reuse,
   over int8 and fp8 caches, and with int8 weights (dense, and paged +
   prefix over an int8 cache), then the reduced codeqwen1.5-7b and
   qwen3-32b configs (head_dim 16, groups 1 and 4), dense and paged, and
   the reduced minicpm3-4b (MLA, its packs on the latent-MQA kernel), and
   the mixture-of-experts family: reduced llama4-scout-17b-a16e (GQA G 4,
   top-1 of 4 experts + 1 shared) dense, paged with prefix reuse and with
   int8 weights, and reduced deepseek-v2-lite-16b (MoE + MLA); the token
   streams must be equal. Then the PRNG on the card (keys, bits and
   uniforms bitwise the CPU's, gumbel within 4 float32 steps) and the
   sampler at smode 2 over a 92,416-wide vocabulary (the CPU's tokens), and
   the reduced codeqwen1.5-7b and qwen3-32b configs serving mixed greedy /
   seeded / top-k-top-p / biased traffic on the card without speculation,
   with the n-gram and the draft-model drafter, dense and paged: every
   stream must equal the CPU's without speculation. Then the reduced
   codeqwen1.5-7b config through ``ServeCluster`` (2 slots, max_len 64,
   mixed traffic of tenants a and b): split over [cuda:0, cuda:0] (two
   replicas, two streams, one copy of the weights) with a cancel from
   another thread mid-run, merge over [cuda:0], a mid-stream SPLIT -> MERGE
   switch and the warm switch back, and split with the n-gram drafter:
   every stream must equal the CPU single engine's.
4. full width — codeqwen1.5-7b, 32 layers, bf16, random weights from a seed,
   4 slots x 1024 positions; about 12 greedy requests whose prompts straddle
   the prefill budget, so fused admissions, ragged packs and decode chunks
   all run; each PR-11 kernel's launch count over this run must be > 0,
   and decode and every ragged launch must have run the split body.
5. full width, paged and quantized — the same weights behind (a) a paged
   engine with prefix reuse serving a shared 512-token system prompt, (b)
   the same traffic over an int8 pool of (a)'s bytes, (c) phase 4's traffic
   over a dense int8 cache; in each run the counts are set to 0 just before
   the measured requests and read just after, the kernels that run drives
   must have launched (in (c) the split decode body, and every ragged
   launch on the split body; in (a) and (b) every
   paged launch on the split body, decodes and packs counted apart, both
   run), the prefix cache must hit, and each run's stream must
   agree with ``LM.prefill`` teacher-forced.
6. full width, int8 weights — phase 4's weights quantized on the card
   (``ServeEngine(weight_dtype="int8")``) serving (a) phase 4's traffic on a
   dense bf16 cache and (b) phase 5 (b)'s traffic on the paged int8 pool with
   prefix reuse; in each run ``matmul_q8`` must launch between the counts'
   reset and read, every launch on a tensor-core GEMV (``gemv_tc`` at M <= 8,
   ``gemv_tc_rows`` above, which both runs must launch) and none on
   ``mma_pipe``, the stream must agree
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
9. full width, multi-head latent attention — minicpm3-4b, 62 layers, bf16,
   random weights from a seed (phase 4's weights freed), phase 4's traffic
   on its dense latent cache (4 slots x 1024 positions); the latent-MQA
   kernel's launches between the counts' reset and read, and those of its
   wgmma body, must be > 0 and equal the MLA packed-attention calls, every
   request must finish, and the stream agree with ``LM.prefill``
   teacher-forced; prints peak memory, tok/s, TTFT, TPOT and a decode-step
   profile.
10. (run after phase 6, while phase 4's weights are resident) full width,
   sampled and speculated serving — phase 4's prompt lengths made
   repetitive, 4 slots x 1024 positions: (a) three each of greedy,
   temperature 0.8, top-k 40 / top-p 0.9 and greedy with a logit bias that
   bans the prompt's first greedy token, run twice (the greedy requests at
   top-k 1 and temperature 1 the second time: the other streams must be
   bitwise equal, and every top-k 1 draw must take a largest logit) and at
   max_chunk 1 (agreement printed); a decode step at smode 2 and 0 and the
   sampler alone profiled; (b) the n-gram drafter on the same traffic: drafts
   proposed and accepted, every verify dispatch one ragged launch a layer,
   greedy streams teacher-forced; a verify dispatch profiled; (c) a 1-layer
   truncation of the target as the draft model: its catch-ups on the ragged
   kernel, its rolls on the decode kernel; (d) phase 5 (a)'s paged + prefix
   traffic with the n-gram drafter, every verify dispatch on the paged
   kernel. Prints tok/s, TTFT, TPOT and the acceptance of each run.
12. (run after phase 10, on phase 4's weights) full width, the split/merge
   serving cluster — the perfmodel's host constants measured (host time a
   launch over 2,000 empty launches; a two-thread barrier + synchronize);
   phase 4's 12 prompts, tenants a / b, four seeded at temperature 0.8, 32
   new tokens, 4 slots x 1024 a replica: a single engine, then (a) split over
   [cuda:0, cuda:0] (two controller threads, two streams, one copy of the
   weights) and a steady decode step of one replica and of both at once
   profiled (the union of kernel time over both streams), (b) [cuda:0]
   switching SPLIT -> MERGE once half the requests have arrived, then back
   and forth warm, (c) ``run_controlled`` under
   ``ReconfigController.for_cluster`` over 8 prompts of 600-700 tokens then
   24 of 5-40 (decisions printed, not gated), (d) two replicas with replica
   1's controller stalled 14 s under a 10 s dead_after: exactly one must be
   declared dead and every request finish; each replica's longest iteration
   is printed. In each run the decode, ragged and flash kernels must launch
   between the counts' reset and read, and every stream agree with
   ``LM.prefill`` teacher-forced (greedy: its argmax; seeded: the same
   draw); greedy streams are compared with phase 4's (printed). Prints tok/s,
   TTFT, TPOT and the NVML idle share of each run, and each switch's cost.
13. (run after phase 9) full width, the mixture-of-experts family on phase
   4's traffic, each model freed before the next: (a) deepseek-v2-lite-16b
   whole (27 layers, the first dense at ff 10944, 64 routed experts top-6 +
   2 shared at ff 1408, MLA 512 + 64 x 16 heads, bf16, ~31.4 GB of random
   weights from a seed), every pack on the latent-MQA kernel (launches ==
   MLA packed calls); (b) llama4-scout-17b-a16e at 4 of its 48 layers (the
   one cut: 48 layers do not fit one card), every width full (G 5, D 128,
   16 experts top-1, 1 shared), bf16, on the decode, ragged and flash
   kernels; (c) (b)'s weights quantized to int8 on the card (``matmul_q8``
   on the projections and the shared expert). Each prints parameters,
   bytes and the decode step's weight-read floor (every expert is read:
   the dense [E, C] dispatch), tok/s, TTFT, TPOT, a decode step's wall
   against device time with the expert ``bmm``s' share, and the kept share
   of (token, k) entries by route (decode must keep all); each run's
   kernels must launch, its streams agree with ``LM.prefill``
   teacher-forced, (a) and (b) hold a 64-token pack's logits through the
   kernels against the plain path on the card (``PACK_REL_TOL``), and two
   identical runs of (a) and of (b) must give equal streams.
11. a ``{"kernels": [...], "to_port": []}`` JSON line (every row of PERF.md's
   kernel table; the decode, ragged, paged, matmul and matmul_q8 rows name the body
   their timed case ran and its launches; paged packs and matmul_q8 at M = 16
   have entries of their own; the ragged row adds phase 10's verify and draft
   catch-up launches, the paged pack row its paged verify launches, the
   decode row the draft's roll launches; the decode, ragged, flash,
   matmul_q8 and latent-MQA rows phase 13's launches as ``launches_moe``),
   then the result line.

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
# up to 64, longer prefills; 9 and 65 the edges of the multi-row GEMV),
# codeqwen's (K, N) of the projections and the MLP, and one shape with K and
# N tails; the main case is a 4-slot decode step's w_in / w_gate product, and
# the multi-row GEMV's (matmul_q8 above 8 rows) a 16-slot step's
MATMUL_M = (4, 9, 16, 37, 64, 65, 256)
MATMUL_KN = ((4096, 4096), (4096, 13440), (13440, 4096), (4100, 4104))
MATMUL_MAIN = (4, 4096, 13440)
MATMUL_ROWS_MAIN = (16, 4096, 13440)
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
# phase 2's paged sequences (phase 5's traffic: the first four share a
# 512-token prefix), their positions in table rows of S_MAX
PAGED_CUR = [540, 560, 580, 600, 5, 300, 700, S_MAX - 1]
# the paged body's launch counts, decode (one token a tile) and pack apart:
# every paged launch of phases 5 and 6 is one of them
PAGED_SPLIT = ("paged_attention_split_decode", "paged_attention_split_pack")
DECODE_POS = [0, 333, 700, S_MAX - 1]
PACK_SLOTS = [1] * 40 + [3] * 16 + [1] * 8
PACK_POS = list(range(0, 40)) + list(range(600, 616)) + [S_MAX] * 8
# phase 2's ragged cases over that pack (also timed by
# scripts/torch_attention_ab.py), the first of each list the main one:
# (KV, G, query dtype, window) over a plain store, and (store, KV, G, query
# dtype, window) over a scaled one ("f32": the identity lane, scales of 1;
# "f32 rand": an f32 store under random scales)
RAGGED_CASES = [(32, 1, "bfloat16", 0), (32, 1, "float32", 0), (8, 8, "bfloat16", 0),
                (8, 8, "float32", 0), (32, 1, "bfloat16", 100), (8, 8, "float32", 24)]
RAGGED_Q8_CASES = [("int8", 32, 1, "bfloat16", 0), ("int8", 32, 1, "float32", 0),
                   ("fp8", 32, 1, "bfloat16", 0), ("int8", 8, 8, "bfloat16", 0),
                   ("fp8", 8, 8, "float32", 24), ("f32", 32, 1, "bfloat16", 0),
                   ("f32 rand", 32, 1, "bfloat16", 0)]
# a ragged pack of decode singletons, one token from each of 4 slots
SINGLE_POS = [1023, 0, 511, 700]


def paged_pool_tables(rs, cur, bs: int, s_max: int = S_MAX) -> tuple[int, np.ndarray]:
    """(num_blocks, tables) of phase 2's paged pool for sequences at ``cur``
    in table rows of ``s_max`` positions: each sequence's blocks drawn from a
    pool shuffled by ``rs``, the shared 512-token prefix's blocks named by
    sequences 0-3; unallocated entries hold the sentinel num_blocks (the
    pool's scratch block)."""
    maxb = s_max // bs
    nb = len(cur) * maxb
    free = list(rs.permutation(nb))
    shared = [int(free.pop()) for _ in range(512 // bs)]
    tab = np.full((len(cur), maxb), nb, np.int32)
    for i, c in enumerate(cur):
        n = min(c, s_max - 1) // bs + 1
        own = shared if i < 4 else []
        tab[i, :n] = (own + [int(free.pop()) for _ in range(n - len(own))])[:n]
    return nb, tab


def paged_tokens(kind: str, cur, s_max: int) -> tuple[list, list]:
    """(tok_seq, tok_pos) of phase 2's paged cases over the sequences at
    ``cur``: a decode (one token per sequence at its cur), a 64-token pack (40
    prompt tokens of sequence 6, 16 of sequence 1, 8 padding tokens at
    s_max), "pack0": the same pack with sequence 6's tokens at positions
    0-39 (a prompt's first chunk: tokens with one to 40 keys, whose outputs
    are nearly V rows), or "pack2": 37 tokens of sequence 6 and 19 of
    sequence 1, so a tile of 8 (and at G <= 4 one of 2) spans both, and 8
    padding tokens."""
    if kind == "decode":
        return list(range(len(cur))), list(cur)
    if kind == "pack0":  # 40 tokens at positions 0-39 of sequence 6: one to 40 keys each
        return [6] * 40 + [1] * 16 + [6] * 8, list(range(40)) + list(range(545, 561)) + [s_max] * 8
    n6 = 40 if kind == "pack" else 37
    seqs = [6] * n6 + [1] * (56 - n6) + [6] * 8
    return seqs, list(range(600, 600 + n6)) + list(range(545, 601 - n6)) + [s_max] * 8


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
    real = tp < S
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def ragged_err(got, want, real, case):
        # padding rows (tok_pos = S) are never read: the kernel reads no key
        # for them and writes zeros, the plain version attends the whole slot
        if got[~real].any():
            raise AssertionError(f"ragged_attention {case}: padding rows are not zero")
        return (got[real].float() - want[real].float()).abs().max().item()

    for kv, g, dname, window in RAGGED_CASES:
        dtype, main = getattr(torch, dname), (kv, g, dname, window) == RAGGED_CASES[0]
        T = ts.numel()
        q, k, v = randn(T, kv, g, 128, dtype=dtype), randn(B, S, kv, 128, dtype=dtype), \
            randn(B, S, kv, 128, dtype=dtype)
        n0 = rk.launches_split
        got = rk.ragged_attention(q, k, v, ts, tp, window=window)
        if rk.launches_split != n0 + 1:
            raise AssertionError("ragged_attention: the wrapper did not count its launch")
        want = ref.ragged_attention(q, k, v, ts, tp, window=window)
        err = ragged_err(got, want, real, "")
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
        if main:  # the split body at the kernel's own and at forced split counts
            tt, _, own = rk.plan(S, T, kv, g, sms, rk.one_token_tiles(dtype, dtype))
            for splits in (1, 2, 4):
                err = ragged_err(rk.ragged_attention(q, k, v, ts, tp, splits=splits), want, real,
                                 f"splits={splits}")
                span = dk.split_span(S, splits)[0]
                report("ragged_attention", f"splits={splits} (span {span}; own {own}, "
                       f"{tt} tokens a tile)", dtype, err)
            # a pack of decode singletons, one token from each slot
            ts1 = torch.arange(B, dtype=torch.int32, device=dev)
            tp1 = torch.tensor(SINGLE_POS, dtype=torch.int32, device=dev)
            q1 = randn(B, kv, g, 128, dtype=dtype)
            err = ragged_err(rk.ragged_attention(q1, k, v, ts1, tp1),
                             ref.ragged_attention(q1, k, v, ts1, tp1), tp1 < S, "singletons")
            report("ragged_attention", f"T={B} singletons of {B} slots at {SINGLE_POS}", dtype,
                   err)

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


# phase 2's speculative verify packs: each slot's rows [last token, draft_1
# .. draft_K] at (slot, cl + j), slot-major, T = B·(K+1) exactly (not a T
# bucket: tiles of 8 tokens cross slots and the last tile is partial); rows
# past a slot's depth and a whole idle slot carry (slot 0, the position
# sentinel), as the engine's verify tick builds them. 4 slots at K 2 and 8
# (T 12, 36) over the dense cache and the paged pool; 16 paged sequences at K
# 8 (T 144)
VERIFY_CUR = {4: [700, 5, 333, 1000],
              16: [540, 560, 580, 600, 5, 300, 700, 1000, 37, 64, 129, 250, 413, 800, 901, 2]}
VERIFY_DEPTHS = {(4, 2): [2, 1, 2, -1], (4, 8): [8, 3, 0, 5],
                 (16, 8): [8, 8, 0, 3, 5, 8, 1, 2, -1, 8, 7, 6, 8, 4, 2, 8]}


def verify_rows(cur, depths, k, s_max):
    """(tok_slot, tok_pos) of a verify pack: slot i's rows j <= depth at
    cur + j, the rest (and slots of depth -1: not decoding) at (0, s_max)."""
    slots, poss = [], []
    for i, (c, d) in enumerate(zip(cur, depths)):
        for j in range(k + 1):
            live = j <= d
            slots.append(i if live else 0)
            poss.append(c + j if live else s_max)
    return slots, poss


def check_verify_packs(dev):
    """Phase 2 for the verify packs of speculative decoding: the ragged
    kernel over the dense cache (4 slots x 1024 positions) and the paged
    kernel over a fragmented pool (blocks of 32), bf16 and f32 queries, KV 32
    / G 1 (codeqwen) and KV 8 / G 4, against the plain version; padding rows
    must be zero. The bf16 KV 32 cases are timed beside their plain
    versions."""
    import torch

    from repro_torch.dist.compression import quantize_rows
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ragged_attention as rk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(7)
    rs = np.random.default_rng(7)
    D, bs = 128, 32

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def check(name, case, got, want, real, dtype, kernel=None, plain=None):
        tol = TOL[str(dtype).split(".")[-1]]
        if got[~real].any():
            raise AssertionError(f"{name} {case}: padding rows are not zero")
        err = (got[real].float() - want[real].float()).abs().max().item()
        timing = ""
        if kernel is not None:
            timing = f" ms={time_ms(kernel):.4f} plain={time_ms(plain):.3f}"
        print(f"  {name:20s} {case:52s} err={err:.2e} tol={tol:g}{timing}", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} {case}: max_abs_err {err} above {tol}")

    for (b, kk), depths in VERIFY_DEPTHS.items():
        cur = VERIFY_CUR[b]
        seqs, poss = verify_rows(cur, depths, kk, S_MAX)
        ts = torch.tensor(seqs, dtype=torch.int32, device=dev)
        tp = torch.tensor(poss, dtype=torch.int32, device=dev)
        real, t = tp < S_MAX, len(seqs)
        # the pool's tables cover each sequence's verify rows
        nb, tab_h = paged_pool_tables(rs, [min(c + kk, S_MAX - 1) for c in cur], bs)
        tab = torch.from_numpy(tab_h).to(dev)
        for kv, g, dtype, store in [(32, 1, torch.bfloat16, None), (32, 1, torch.float32, None),
                                    (8, 4, torch.bfloat16, None), (32, 1, torch.bfloat16, "int8")]:
            q = randn(t, kv, g, D, dtype=dtype)
            case = f"verify B={b} K={kk} T={t} KV={kv} G={g} {store or str(dtype)[6:]}"
            main = kv == 32 and dtype == torch.bfloat16 and store is None
            sc = {}
            if b == 4:  # the dense cache
                k, v = randn(b, S_MAX, kv, D, dtype=dtype), randn(b, S_MAX, kv, D, dtype=dtype)
                if store:
                    k, ks = quantize_rows(k.float(), torch.int8)
                    v, vs = quantize_rows(v.float(), torch.int8)
                    sc = dict(k_scale=ks, v_scale=vs)
                n0 = rk.launches_split
                got = rk.ragged_attention(q, k, v, ts, tp, **sc)
                if rk.launches_split != n0 + 1:
                    raise AssertionError("ragged_attention: the verify pack was not counted")
                want = ref.ragged_attention(q, k, v, ts, tp, **sc)
                check("ragged_attention", case, got, want, real, dtype,
                      *((lambda: rk.ragged_attention(q, k, v, ts, tp),
                         lambda: ref.ragged_attention(q, k, v, ts, tp)) if main else ()))
            k, v = randn(nb + 1, bs, kv, D, dtype=dtype), randn(nb + 1, bs, kv, D, dtype=dtype)
            if store:
                k, ks = quantize_rows(k.float(), torch.int8)
                v, vs = quantize_rows(v.float(), torch.int8)
                sc = dict(k_scale=ks, v_scale=vs)
            n0 = pk.launches_split_pack
            got = pk.paged_attention(q, k, v, ts, tp, tab, **sc)
            if pk.launches_split_pack != n0 + 1:
                raise AssertionError("paged_attention: the verify pack was not counted")
            want = ref.paged_ragged_attention(q, k, v, ts, tp, tab, **sc)
            check("paged_attention", case + f" bs={bs}", got, want, real, dtype,
                  *((lambda: pk.paged_attention(q, k, v, ts, tp, tab),
                     lambda: ref.paged_ragged_attention(q, k, v, ts, tp, tab)) if main else ()))
    torch.cuda.synchronize()


def check_paged_split(dev):
    """Phase 2 for the split paged body over its domain: every head width,
    G 1, 4, 8 and 12, blocks of 8, 16 and 32 positions, with and without a
    window, over a bf16 pool and a scaled int8 one under bf16 queries (4 KV
    heads, phase 2's paged pool and tables at each block size): a decode
    (one token a tile) and a pack whose tiles span two sequences, with
    padding tokens, each against the plain version; padding rows must be
    zero."""
    import torch

    from repro_torch.dist.compression import quantize_rows
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(4)
    rs = np.random.default_rng(4)
    bf16, kv, S = torch.bfloat16, 4, S_MAX
    tol = TOL["bfloat16"]
    cur = PAGED_CUR
    worst = 0.0
    for bs in (8, 16, 32):
        nb, tab_h = paged_pool_tables(rs, cur, bs)
        tab = torch.from_numpy(tab_h).to(dev)
        for d in (16, 32, 64, 80, 128):
            for store in ("bf16", "int8"):
                k, v = (torch.randn(nb + 1, bs, kv, d, generator=gen, device=dev) for _ in "kv")
                if store == "bf16":
                    k, v, sc = k.to(bf16), v.to(bf16), {}
                else:
                    (k, ks), (v, vs) = quantize_rows(k, torch.int8), quantize_rows(v, torch.int8)
                    sc = dict(k_scale=ks, v_scale=vs)
                for g in (1, 4, 8, 12):
                    for window in (0, 100):
                        for kind in ("decode", "pack2"):
                            seqs, poss = paged_tokens(kind, cur, S)
                            ts = torch.tensor(seqs, dtype=torch.int32, device=dev)
                            tp = torch.tensor(poss, dtype=torch.int32, device=dev)
                            q = torch.randn(len(seqs), kv, g, d, generator=gen,
                                            device=dev).to(bf16)
                            got = pk.paged_attention(q, k, v, ts, tp, tab, window=window,
                                                     decode=kind == "decode", **sc)
                            want = ref.paged_ragged_attention(q, k, v, ts, tp, tab,
                                                              window=window, **sc)
                            real = tp < S
                            if got[~real].any():
                                raise AssertionError(f"paged split {kind} bs={bs} d={d} g={g}: "
                                                     "padding rows are not zero")
                            err = (got[real].float() - want[real].float()).abs().max().item()
                            worst = max(worst, err)
                            if not err <= tol:
                                raise AssertionError(
                                    f"paged split {kind} bs={bs} d={d} g={g} {store} "
                                    f"win={window}: max_abs_err {err} above {tol}")
    torch.cuda.synchronize()
    print(f"  paged split body: decode and a pack with tiles across two sequences at d "
          f"16-128 x G 1/4/8/12 x bs 8/16/32 x window 0/100 x bf16/int8 pools, worst "
          f"max_abs_err {worst:.2e} tol={tol:g}", flush=True)


# phase 2's latent-MQA cases (kv_lora_rank, rope_head_dim, heads, dtype), the
# first the main one: minicpm3-4b's widths, deepseek-v2-lite's, the reduced
# configs' (f32, as served); then the domain's edges (head chunks of 1, 2 and
# 4 blocks, a single head, f32 at the wide widths)
MLA_CASES = [(256, 32, 40, "bfloat16"), (512, 64, 16, "bfloat16"), (32, 8, 4, "float32"),
             (256, 32, 64, "bfloat16"), (512, 64, 64, "bfloat16"), (32, 8, 64, "bfloat16"),
             (256, 32, 1, "bfloat16"), (256, 32, 40, "float32"), (512, 64, 16, "float32"),
             (32, 8, 4, "bfloat16")]
MLA_TIMED = 3  # the first three are timed beside their bound, plain version and SDPA
# phase 2's latent-MQA packs (slots, positions) beyond the serving pack: a
# tile whose rows cross two slots at every head count (slot 0's chunk meets
# slot 2's), a 128-token bucket (a 96-token chunk, a 16-token one, 8
# singletons and 8 padding tokens), and a pack that is all padding
MLA_CROSS = ([0, 0, 0, 2, 2, 2, 2, 2, 1, 3], [500, 501, 502, 100, 101, 102, 103, 104, 900, 1023])
MLA_BUCKET = ([2] * 96 + [0] * 16 + [1, 3, 1, 3, 0, 2, 1, 3] + [2] * 8,
              list(range(300, 396)) + list(range(16)) + [1023, 17, 511, 800, 700, 250, 3, 64]
              + [S_MAX] * 8)
MLA_SPLITS = (1, 2, 4)  # forced split counts of the bf16 serving pack


def check_mla_kernels(dev):
    """Phase 2 for the latent-MQA kernel (``csrc/mla_attention.cu``): each of
    MLA_CASES over phase 2's 64-token pack (4 slots x 1024 positions, 8
    padding tokens), a pack of decode singletons, a pack that is mostly
    padding, MLA_CROSS, MLA_BUCKET and a pack that is all padding, and the
    bf16 cases' serving pack at MLA_SPLITS forced splits, against
    ``ref.mla_ragged_attention``; padding rows must be zero and every bf16
    call must run the wgmma body. The latent rows are N(0, 1), as after
    kv_norm. The first MLA_TIMED cases are timed beside their bound, plain
    version and SDPA over K = [ckv | krope] broadcast to the H heads, V =
    ckv, under the full-cross mask (row 2's yardstick); the main case is
    returned."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mla_attention as mk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(3)
    B, S = SLOTS, S_MAX
    results = {}
    packs = {
        "pack": (PACK_SLOTS, PACK_POS),
        "singletons": (list(range(B)), SINGLE_POS),
        "padding": ([2, 2, 0, 2, 2, 2, 0, 2], [S, 5, S, 6, S, S, 1000, S]),
        "cross": MLA_CROSS,
        "bucket128": MLA_BUCKET,
        "allpad": ([0, 1, 2, 3] * 2, [S] * 7 + [S + 100]),
    }
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (r, rope, h, dname) in enumerate(MLA_CASES):
        dtype = getattr(torch, dname)
        tol = TOL[dname]
        scale = (r // 4 + rope) ** -0.5  # a nope width of r / 4, as minicpm3's 64 of 256
        ckv = torch.randn(B, S, r, generator=gen, device=dev).to(dtype)
        krope = torch.randn(B, S, rope, generator=gen, device=dev).to(dtype)
        for kind, (slots, poss) in packs.items():
            ts = torch.tensor(slots, dtype=torch.int32, device=dev)
            tp = torch.tensor(poss, dtype=torch.int32, device=dev)
            t = ts.numel()
            q_eff = torch.randn(t, h, r, generator=gen, device=dev).to(dtype)
            q_rope = torch.randn(t, h, rope, generator=gen, device=dev).to(dtype)
            bf16 = dtype == torch.bfloat16
            n0 = (mk.launches, mk.launches_wgmma)
            got = mk.mla_attention(q_eff, q_rope, ckv, krope, ts, tp, scale=scale)
            if (mk.launches, mk.launches_wgmma) != (n0[0] + 1, n0[1] + bf16):
                raise AssertionError("mla_attention: the wrapper did not count its launch")
            want = ref.mla_ragged_attention(q_eff, q_rope, ckv, krope, ts, tp, scale=scale)
            real = tp < S
            if got[~real].any():
                raise AssertionError(f"mla_attention {kind} r={r} h={h}: padding rows not zero")
            err = (got[real].float() - want[real].float()).abs().max().item() if real.any() \
                else 0.0
            rows, blocks, span, n = mk.plan(t, h, S, dtype, sms)
            line = (f"  mla_attention        {kind:10s} T={t} r={r} rope={rope} H={h} {dname} "
                    f"({blocks} x {rows} rows, {n} x {span} positions) max_abs_err={err:.3e} "
                    f"tol={tol:g}")
            if i < MLA_TIMED and kind == "pack":
                # bytes of the real tokens only, each slot's valid prefix once
                rs, rp = ts[real].cpu().numpy(), tp[real].cpu().numpy()
                rows = {}
                for s_, p_ in zip(rs, rp):
                    rows[s_] = max(rows.get(s_, 0), p_ + 1)
                by = (nbytes(q_eff, q_rope, q_eff, ts, tp)
                      + sum(rows.values()) * (r + rope) * ckv.element_size())
                fl = int((rp + 1).sum()) * h * (2 * (r + rope) + 2 * r)
                valid = ref.ragged_valid_mask(ts, tp, B, S)
                qs = torch.cat([q_eff, q_rope], -1).permute(1, 0, 2)[None].contiguous()
                ks = torch.cat([ckv, krope], -1).reshape(1, 1, B * S, r + rope).expand(
                    1, h, B * S, r + rope).contiguous()
                vs = ckv.reshape(1, 1, B * S, r).expand(1, h, B * S, r).contiguous()
                mask = valid.reshape(1, 1, t, B * S)
                timed = dict(
                    ms=time_ms(lambda: mk.mla_attention(q_eff, q_rope, ckv, krope, ts, tp,
                                                        scale=scale)),
                    plain_ms=time_ms(lambda: ref.mla_ragged_attention(
                        q_eff, q_rope, ckv, krope, ts, tp, scale=scale, valid=valid)),
                    library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask, scale=scale)),
                    library="SDPA over [ckv | krope] broadcast to the heads, full-cross mask",
                )
                timed["bound_ms"], timed["bound_by"] = bound(by, fl, dtype)
                line += (f" ms={timed['ms']:.4f} plain={timed['plain_ms']:.3f} "
                         f"bound={timed['bound_ms']:.5f} ({timed['bound_by']}) "
                         f"SDPA={timed['library_ms']:.4f}")
                if i == 0:
                    results["mla_attention"] = dict(timed, max_abs_err=err, tol=tol)
            print(line, flush=True)
            if not err <= tol:
                raise AssertionError(f"mla_attention {kind} r={r} h={h} {dname}: max_abs_err "
                                     f"{err} above {tol}")
            if kind == "pack" and bf16:  # the serving pack at forced split counts
                for n in MLA_SPLITS:
                    got = mk.mla_attention(q_eff, q_rope, ckv, krope, ts, tp, scale=scale,
                                           splits=n)
                    if got[~real].any():
                        raise AssertionError(f"mla_attention splits={n} r={r} h={h}: padding "
                                             "rows not zero")
                    err = (got[real].float() - want[real].float()).abs().max().item()
                    span = mk.plan(t, h, S, dtype, sms, n)[2]
                    print(f"  mla_attention        splits={n} (span {span}) r={r} H={h} "
                          f"max_abs_err={err:.3e} tol={tol:g}", flush=True)
                    if not err <= tol:
                        raise AssertionError(f"mla_attention splits={n} r={r} h={h}: "
                                             f"max_abs_err {err} above {tol}")
    # a width outside the domain is refused before the C call
    try:
        mk.mla_attention(*(torch.zeros(1, 4, w, dtype=torch.bfloat16, device=dev)
                           for w in (64, 8)),
                         torch.zeros(1, 8, 64, dtype=torch.bfloat16, device=dev),
                         torch.zeros(1, 8, 8, dtype=torch.bfloat16, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev), scale=1.0)
    except ValueError as e:
        print(f"  mla_attention        refuses r=64: {e}", flush=True)
    else:
        raise AssertionError("mla_attention took a width outside its domain")
    torch.cuda.synchronize()
    return results


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

    def store_kv(shape, store, qdtype, v_gain=1.0):
        """K/V in the model dtype, or quantized rows with their scales; V
        rows drawn from N(0, v_gain^2)."""
        k, v = randn(*shape), randn(*shape) * v_gain
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
                extra_bytes, library=None, main=None):
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
        if main:  # True: the results key is the name; a str: that key
            results[name if main is True else main] = dict(timed, max_abs_err=err, tol=tol)

    def kv_row_bytes(k, kv, scaled):
        return kv * (D * k.element_size() + (4 if scaled else 0)) * 2  # K and V

    # ---- paged: an 8-sequence decode over a fragmented pool whose first four
    # sequences share a 512-token prefix (phase 5's traffic), and 64-token packs
    cur = PAGED_CUR

    def pool_tables(bs):
        return paged_pool_tables(rs, cur, bs)

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

    # each case: (KV, G, bs, query dtype, window, kind, the results key of a
    # main case or None); "pack2": a pack whose tile of 8 (2 at G <= 4)
    # tokens spans two sequences
    for name, store, cases in [
        ("paged_attention", None, [
            (32, 1, 32, bf16, 0, "decode", "paged_attention"),
            (32, 1, 16, f32, 0, "decode", None), (32, 1, 8, bf16, 0, "decode", None),
            (8, 8, 16, bf16, 0, "decode", None), (8, 8, 32, f32, 0, "decode", None),
            (8, 4, 8, bf16, 0, "decode", None), (8, 12, 16, bf16, 50, "decode", None),
            (32, 1, 32, bf16, 0, "pack", "paged_attention_pack"),
            (32, 1, 16, bf16, 100, "pack", None), (32, 1, 8, bf16, 0, "pack2", None),
            (8, 4, 16, bf16, 0, "pack2", None), (8, 12, 32, f32, 30, "pack2", None),
        ]),
        ("paged_attention_q8", "int8", [
            (32, 1, 32, bf16, 0, "decode", "paged_attention_q8"),
            (32, 1, 16, f32, 0, "decode", None), (8, 8, 16, bf16, 0, "decode", None),
            (32, 1, 32, bf16, 0, "pack", "paged_attention_q8_pack"),
            (8, 8, 32, f32, 77, "pack", None), (32, 1, 8, bf16, 60, "pack2", None),
            (8, 4, 16, bf16, 0, "pack2", None),
        ]),
        ("paged_attention_q8", "fp8", [
            (32, 1, 32, bf16, 0, "decode", None), (8, 8, 16, f32, 0, "decode", None),
            (32, 1, 16, bf16, 100, "pack", None),
            # P's remainder (kMmaSplitP): V rows of N(0, 1.5^2), so that
            # the outputs of tokens with a few keys reach 4-8, where a bf16
            # step is 0.031 and one rounding of P (2^-9 of a V row) crosses
            # one (PagedTable before kMmaSplitP: 0.031 off, past 0.02)
            (32, 1, 32, bf16, 0, "pack0", None),
        ]),
        ("paged_attention_q8", "f32", [
            (32, 1, 32, bf16, 0, "decode", None), (32, 1, 32, bf16, 0, "pack", None),
        ]),
        ("paged_attention_q8", "f32 rand", [
            (32, 1, 32, bf16, 0, "decode", None), (8, 8, 16, bf16, 0, "pack", None),
        ]),
    ]:
        for kv, g, bs, dtype, window, kind, key in cases:
            nb, tab_h = pool_tables(bs)
            tab = torch.from_numpy(tab_h).to(dev)
            k, v, scales = store_kv((nb + 1, bs, kv, D), store, dtype,
                                    1.5 if kind == "pack0" else 1.0)
            seqs, poss = paged_tokens(kind, cur, S)
            ts = torch.tensor(seqs, dtype=torch.int32, device=dev)
            tp = torch.tensor(poss, dtype=torch.int32, device=dev)
            q = randn(len(seqs), kv, g, D, dtype=dtype)
            decode = kind == "decode"
            counters = ("launches_q8" if scales else "launches",
                        "launches_split_decode" if decode else "launches_split_pack")
            n0 = [getattr(pk, c_) for c_ in counters]
            got = pk.paged_attention(q, k, v, ts, tp, tab, window=window, decode=decode,
                                     **scales)
            if [getattr(pk, c_) for c_ in counters] != [n_ + 1 for n_ in n0]:
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
                if decode else
                (lambda: ref.paged_ragged_attention(q, k, v, ts, tp, tab, window=window,
                                                    **scales))
            )
            library = None if scales else paged_sdpa(q, k, v, seqs, poss, tab_h, nb, bs, window)
            measure(name, f"{kind} T={len(seqs)} KV={kv} G={g} bs={bs} {store or dtype} "
                    f"q={str(dtype)[6:]} win={window}", dtype, got, want, real,
                    lambda: pk.paged_attention(q, k, v, ts, tp, tab, window=window,
                                               decode=decode, **scales),
                    plain, len(rows), n_keys * kv * g * D * 4, kv_row_bytes(k, kv, bool(scales)),
                    extra, library, key)

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
    for store, kv, g, dname, window in RAGGED_Q8_CASES:
        dtype = getattr(torch, dname)
        main = (store, kv, g, dname, window) == RAGGED_Q8_CASES[0]
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
                rows_main = (m, k, n) == MATMUL_ROWS_MAIN and dtype == bf16
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
                        if main or rows_main:
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
                    if main or (rows_main and name == "matmul_q8"):
                        key = name if main else "matmul_q8_rows"
                        results[key] = dict(timed, max_abs_err=err, tol=tol, body=body)
                        if timed["library_ms"] is None:
                            print(f"  {key} yardstick: {timed['library']}")
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

    # reduced minicpm3-4b (MLA: latent 32 + rope 8, 4 heads), f32, on its
    # dense latent cache: the packs on the latent-MQA kernel at (32, 8, H 4)
    from repro_torch.kernels import mla_attention as mk

    rcfg = get_arch("minicpm3-4b").reduced()
    r_cpu = LM(rcfg, device="cpu")
    r_params = r_cpu.init(torch.Generator().manual_seed(0))
    r_dev, r_params_dev = LM(rcfg, device=dev), _tree_to(r_params, dev)
    r_prompts = [p_ % rcfg.vocab_size for p_ in prompts]
    on_cpu, _ = serve(r_cpu, r_params, "cpu", r_prompts, {})
    n0 = mk.launches
    on_dev, _ = serve(r_dev, r_params_dev, dev, r_prompts, {})
    if on_dev != on_cpu or mk.launches == n0:
        diff = [rid for rid in on_cpu if on_cpu[rid] != on_dev.get(rid)]
        raise AssertionError(f"minicpm3-4b reduced: streams differ for rids {diff}; "
                             f"{mk.launches - n0} latent-MQA launches")
    print(f"  minicpm3-4b reduced (MLA, latent {rcfg.mla.kv_lora_rank} + rope "
          f"{rcfg.mla.rope_head_dim}, {rcfg.n_heads} heads): {len(on_cpu)} greedy streams "
          f"identical on the card ({mk.launches - n0} latent-MQA launches) and the CPU (plain)",
          flush=True)

    # the mixture-of-experts family, f32: reduced llama4-scout-17b-a16e (GQA,
    # G 4, top-1 of 4 experts + 1 shared) dense, paged with prefix reuse and
    # with int8 weights (the shared expert on matmul_q8, the expert stacks
    # read through qweight), and reduced deepseek-v2-lite-16b (MoE + MLA:
    # top-2 of 4 + 2 shared after a dense first layer, its packs on the
    # latent-MQA kernel); capacity drops, where a pack's bucket makes them,
    # must fall on the same entries on both
    from repro_torch.kernels import matmul as mmk
    from repro_torch.models import moe as moe_mod

    for name, lanes_moe in (
        ("llama4-scout-17b-a16e",
         [("dense", prompts, {}),
          ("paged + prefix, bs=16", shared + prompts[6:], dict(kv_block_size=16,
                                                               prefix_cache=True)),
          ("int8 weights, dense", prompts, dict(weight_dtype="int8"))]),
        ("deepseek-v2-lite-16b", [("dense", prompts, {})]),
    ):
        rcfg = get_arch(name).reduced()
        r_cpu = LM(rcfg, device="cpu")
        r_params = r_cpu.init(torch.Generator().manual_seed(0))
        r_dev, r_params_dev = LM(rcfg, device=dev), _tree_to(r_params, dev)
        for lane, reqs, kw in lanes_moe:
            reqs = [p_ % rcfg.vocab_size for p_ in reqs]
            on_cpu, hits_cpu = serve(r_cpu, r_params, "cpu", reqs, kw)
            n0 = (mk.launches, mmk.launches_q8)
            kept = moe_kept(moe_mod)
            with kept:
                on_dev, hits_dev = serve(r_dev, r_params_dev, dev, reqs, kw)
            n_mla, n_q8 = mk.launches - n0[0], mmk.launches_q8 - n0[1]
            if on_dev != on_cpu or hits_dev != hits_cpu:
                diff = [rid for rid in on_cpu if on_cpu[rid] != on_dev.get(rid)]
                raise AssertionError(f"{name} reduced, {lane}: streams differ for rids {diff}, "
                                     f"prefix hits {hits_dev} on the card, {hits_cpu} on CPU")
            if (rcfg.mla is not None) != (n_mla > 0) or ("weight_dtype" in kw) != (n_q8 > 0):
                raise AssertionError(f"{name} reduced, {lane}: {n_mla} latent-MQA and {n_q8} "
                                     "matmul_q8 launches")
            print(f"  {name} reduced (MoE {rcfg.moe.n_routed} experts top-{rcfg.moe.top_k} + "
                  f"{rcfg.moe.n_shared} shared, {'MLA' if rcfg.mla else 'GQA G 4'}), {lane}: "
                  f"{len(on_cpu)} greedy streams identical on the card and the CPU (plain); "
                  f"kept entries {kept.summary()}; {n_mla} latent-MQA, {n_q8} matmul_q8 launches",
                  flush=True)


class moe_kept:
    """Context manager over ``models.moe.moe_dispatch``: while active, every
    dispatch's (token, k) entries and kept entries are added up under the
    engine route that made it (``route``, set by :meth:`wrap`: "admission",
    "pack", "decode"; "other" outside an engine dispatch). The kept counts
    stay on the device until :meth:`read`."""

    def __init__(self, moe_mod):
        self.moe_mod = moe_mod
        self.route = "other"
        self.calls: dict = {}

    def __enter__(self):
        inner = self.moe_mod.moe_dispatch
        self._inner = inner

        def spy(router, cfg, x_flat, aux=True):
            d = inner(router, cfg, x_flat, aux)
            n, kept = self.calls.get(self.route, (0, []))
            kept.append(d.keep.sum())
            self.calls[self.route] = (n + d.keep.numel(), kept)
            return d

        self.moe_mod.moe_dispatch = spy
        return self

    def __exit__(self, *exc):
        self.moe_mod.moe_dispatch = self._inner

    def wrap(self, eng) -> None:
        """Label the dispatches of ``eng``'s routes (instance attributes
        shadowing the engine's methods)."""
        for attr, route in (("_admit_fn", "admission"), ("_packed_fn", "pack"),
                            ("_tick_fn", "decode")):
            fn = getattr(eng, attr)

            def labelled(*a, _fn=fn, _route=route, **kw):
                self.route = _route
                try:
                    return _fn(*a, **kw)
                finally:
                    self.route = "other"

            setattr(eng, attr, labelled)

    def unwrap(self, eng) -> None:
        for attr in ("_admit_fn", "_packed_fn", "_tick_fn"):
            eng.__dict__.pop(attr, None)

    def read(self) -> dict:
        """{route: (entries, kept, kept share)}."""
        import torch

        out = {}
        for route, (n, kept) in self.calls.items():
            k = int(torch.stack(kept).sum()) if kept else 0
            out[route] = (n, k, k / max(n, 1))
        return out

    def summary(self) -> str:
        return ", ".join(f"{r} {k}/{n} ({share:.4f})" for r, (n, k, share) in self.read().items())


def mixed_params(i: int, max_new: int, ban: int, boost: int):
    """Phase 3's and 10's mixed traffic, by rid mod 4: greedy; temperature
    0.8, seeded; top-k 40 and top-p 0.9 at temperature 1, seeded; greedy with
    a logit bias that bans ``ban`` and lifts ``boost`` by 3."""
    from repro_torch.serve import SamplingParams

    kind = i % 4
    if kind == 0:
        return SamplingParams(max_new=max_new)
    if kind == 1:
        return SamplingParams(max_new=max_new, temperature=0.8, seed=1000 + i)
    if kind == 2:
        return SamplingParams(max_new=max_new, temperature=1.0, top_k=40, top_p=0.9,
                              seed=2000 + i)
    return SamplingParams(max_new=max_new, logit_bias=((ban, -1e9), (boost, 3.0)))


def repetitive_prompts(lens, vocab: int, seed: int) -> list:
    """Prompts of ``lens`` tokens, each a random pattern of 2-12 tokens
    repeated, with one token in 16 replaced at random: traffic the n-gram
    drafter can match."""
    rng = np.random.default_rng(seed)
    out = []
    for s in lens:
        p_ = np.resize(rng.integers(0, vocab, size=int(rng.integers(2, 13))), s)
        hit = rng.random(s) < 1 / 16
        p_[hit] = rng.integers(0, vocab, size=int(hit.sum()))
        out.append(p_.astype(np.int32))
    return out


def sampled_streams(dev):
    """Phase 3's sampled and speculated lanes: the PRNG and the sampler on
    the card against the CPU, then the reduced codeqwen1.5-7b and qwen3-32b
    configs (f32) serving mixed seeded traffic on the card without
    speculation, with the n-gram and the draft-model drafter, dense and paged
    with prefix reuse: every stream must equal the CPU's without
    speculation."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve import prng
    from repro_torch.serve import sampling as smp

    # the PRNG: keys, bits and uniforms bitwise, gumbel within 4 float32
    # steps of max(|g|, 1) (torch's CUDA log against its CPU log)
    rng = np.random.default_rng(3)
    v = 92416
    seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, size=16).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 4096, size=16).astype(np.int32))
    kc = prng.fold_in(prng.key(seeds), pos)
    kg = prng.fold_in(prng.key(seeds.to(dev)), pos.to(dev))
    tiny = float(torch.finfo(torch.float32).tiny)
    same = (torch.equal(torch.stack(kg, -1).cpu(), torch.stack(kc, -1))
            and torch.equal(prng.random_bits(kg, v).cpu(), prng.random_bits(kc, v))
            and torch.equal(prng.uniform(kg, v, tiny).cpu().view(torch.int32),
                            prng.uniform(kc, v, tiny).view(torch.int32)))
    g, gc = prng.gumbel(kg, v).cpu(), prng.gumbel(kc, v)
    steps = ((g - gc).abs() / torch.from_numpy(
        np.spacing(np.maximum(gc.abs().numpy(), 1.0).astype(np.float32)))).max().item()
    print(f"  prng: 16 keys x {v} draws: keys, bits and uniforms bitwise equal card vs CPU: "
          f"{same}; gumbel within {steps:.1f} float32 steps (bound 4)", flush=True)
    if not same or steps > 4:
        raise AssertionError("prng: the card's draws differ from the CPU's")
    # the sampler at smode 2 over the vocabulary, card vs CPU
    logits = torch.from_numpy(rng.normal(size=(16, v)).astype(np.float32) * 4)
    temps = torch.full((16,), 0.8)
    temps[0] = 0.0
    top_k = torch.tensor([0, 40] * 8, dtype=torch.int32)
    top_p = torch.tensor([0.9, 1.0] * 8)
    btok = torch.full((16, smp.MAX_LOGIT_BIAS), smp._BIAS_PAD, dtype=torch.int32)
    bval = torch.zeros(16, smp.MAX_LOGIT_BIAS)
    btok[:, 0], bval[:, 0] = 5, -1e9
    args = (logits, temps, top_k, top_p, seeds, pos, btok, bval)
    want = smp.fused_sample(*args, smode=2)
    got = smp.fused_sample(*[a.to(dev) for a in args], smode=2).cpu()
    print(f"  fused_sample smode 2, 16 x {v}: card == CPU: {torch.equal(got, want)}", flush=True)
    if not torch.equal(got, want):
        raise AssertionError("fused_sample: the card's draws differ from the CPU's")

    lens = (5, 9, 16, 17, 23, 41, 12, 50, 3, 33)
    for name in ("codeqwen1.5-7b", "qwen3-32b"):
        rcfg = replace(get_arch(name).reduced(), dtype="float32")
        r_cpu = LM(rcfg, device="cpu")
        r_params = r_cpu.init(torch.Generator().manual_seed(0))
        r_dev, r_params_dev = LM(rcfg, device=dev), _tree_to(r_params, dev)
        prompts = repetitive_prompts(lens, rcfg.vocab_size, seed=4)
        system = prompts[5][:32]  # a shared 32-token prefix for the paged lanes
        prompts = [np.concatenate([system, p_]) if i % 3 == 0 else p_
                   for i, p_ in enumerate(prompts)]

        def serve(model, params, device, **kw):
            eng = ServeEngine(model, params, batch_slots=4, max_len=128, prefill_budget=16,
                              seed=5, device=device, **kw)
            for i, pr in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=pr, params=mixed_params(i, 10, 7, 11)))
            stats = eng.run()
            return {r.rid: r.generated for r in eng.finished}, stats

        want, _ = serve(r_cpu, r_params, "cpu")
        if any(7 in want[i] for i in want if i % 4 == 3):
            raise AssertionError(f"{name} reduced: a banned token was sampled")
        for lane, kw in [("sampled, dense", {}), ("ngram, dense", dict(speculate="ngram")),
                         ("draft, dense", dict(speculate="draft")),
                         ("ngram, paged + prefix", dict(speculate="ngram", kv_block_size=16,
                                                        prefix_cache=True)),
                         ("draft, paged", dict(speculate="draft", kv_block_size=16))]:
            got, stats = serve(r_dev, r_params_dev, dev, **kw)
            if got != want:
                diff = {rid: (want[rid], got.get(rid)) for rid in want if want[rid] != got.get(rid)}
                raise AssertionError(f"{name} reduced, {lane}: streams differ from the CPU's "
                                     f"without speculation: {diff}")
            if "speculate" in kw and stats.spec_accepted <= 0:
                raise AssertionError(f"{name} reduced, {lane}: no draft was accepted")
            spec = (f", {stats.spec_ticks} verify ticks, {stats.spec_proposed} drafts proposed, "
                    f"{stats.spec_accepted} accepted" if "speculate" in kw else "")
            print(f"  {name} reduced, {lane}: {len(got)} mixed greedy / seeded streams on the "
                  f"card equal the CPU's without speculation{spec}", flush=True)


def cluster_streams(dev):
    """Phase 3's cluster lanes: the reduced codeqwen1.5-7b config (f32, 2
    slots, max_len 64) serving mixed greedy / seeded / biased traffic of
    tenants a and b through ``ServeCluster`` on the card: split over two
    replicas on one card (two streams, two controller threads) with a
    cancel from another thread mid-run, merge over the card, a mid-stream
    SPLIT -> MERGE switch and the warm switch back, and split with the
    n-gram drafter. Every stream must equal the CPU single engine's (the
    cancelled one a prefix of its own)."""
    import threading

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.modes import Mode
    from repro_torch.models import LM
    from repro_torch.serve import Request, ServeCluster, ServeEngine

    rcfg = replace(get_arch("codeqwen1.5-7b").reduced(), dtype="float32")
    r_cpu = LM(rcfg, device="cpu")
    r_params = r_cpu.init(torch.Generator().manual_seed(0))
    r_dev, r_params_dev = LM(rcfg, device=dev), _tree_to(r_params, dev)
    lens = (5, 9, 16, 17, 23, 41, 12, 50, 3, 33)
    prompts = repetitive_prompts(lens, rcfg.vocab_size, seed=6)
    kw = dict(batch_slots=2, max_len=64, prefill_budget=16, seed=5)

    def reqs():
        return [Request(rid=i, prompt=pr, params=mixed_params(i, 10, 7, 11), tenant="ab"[i % 2])
                for i, pr in enumerate(prompts)]

    eng = ServeEngine(r_cpu, r_params, device="cpu", **kw)
    for r in reqs():
        eng.submit(r)
    eng.run()
    want = {r.rid: r.generated for r in eng.finished}

    def check(lane, cl, stats, cut=()):
        got = {r.rid: r for r in cl.finished}
        bad = [rid for rid in want if rid not in cut and got[rid].generated != want[rid]]
        bad += [rid for rid in cut if got[rid].generated != want[rid][: len(got[rid].generated)]]
        if bad or len(got) != len(want):
            raise AssertionError(f"cluster, {lane}: streams differ from the CPU's for rids {bad}")
        cancelled = [rid for rid in cut if got[rid].finish_reason == "cancelled"]
        print(f"  cluster, {lane}: {len(got)} mixed streams on the card equal the CPU single "
              f"engine's (mode {stats.mode}, {len(stats.reconfigures)} reconfigures"
              f"{', cancelled mid-run: ' + str(cancelled) if cut else ''}"
              f"{', %d verify ticks' % stats.spec_ticks if stats.spec_ticks else ''})",
              flush=True)

    cl = ServeCluster(r_dev, r_params_dev, devices=[dev, dev], **kw)
    cl.prewarm(sampling=True)
    handles = {r.rid: cl.submit(r) for r in reqs()}
    timer = threading.Timer(0.05, handles[4].cancel)
    timer.start()
    try:
        stats = cl.run()
    finally:
        timer.cancel()
        timer.join()
    streams = {e.backend.stream for e in cl.engines}
    shared = cl.engines[0].params is cl.engines[1].params
    if (dev.type == "cuda" and len(streams) != 2) or not shared:
        raise AssertionError("split replicas on one card must own two streams and share weights")
    check("split over [cuda:0, cuda:0]", cl, stats, cut=(4,))
    cl = ServeCluster(r_dev, r_params_dev, mode=Mode.MERGE, devices=[dev], **kw)
    for r in reqs():
        cl.submit(r)
    check("merge over [cuda:0]", cl, cl.run())
    cl = ServeCluster(r_dev, r_params_dev, devices=[dev], **kw)
    stats = cl.run(arrivals=[(0.02 * i, r) for i, r in enumerate(reqs())],
                   reconfigure_schedule=[(0.06, Mode.MERGE), (0.15, Mode.SPLIT)])
    if [r.cached for r in stats.reconfigures] != [False, True]:
        raise AssertionError(f"cluster: switches {stats.reconfigures}, want cold then warm")
    check("[cuda:0], SPLIT -> MERGE mid-stream, warm switch back", cl, stats)
    cl = ServeCluster(r_dev, r_params_dev, devices=[dev, dev], speculate="ngram", **kw)
    for r in reqs():
        cl.submit(r)
    stats = cl.run()
    if stats.spec_ticks <= 0:
        raise AssertionError("cluster, ngram: no verify tick ran")
    check("split over [cuda:0, cuda:0], n-gram drafter", cl, stats)


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


def ragged_counts() -> tuple[int, int, int]:
    """The ragged wrapper's (plain, q8, split body) launch counts."""
    from repro_torch.kernels import ragged_attention as rk

    return rk.launches, rk.launches_q8, rk.launches_split


def ragged_all_split(before, run: str) -> None:
    """Every ragged launch since ``before`` (a ragged_counts()) ran on the
    split body, and there was one: split == plain + q8 > 0."""
    plain, q8, split = (a - b for a, b in zip(ragged_counts(), before))
    print(f"  {run}: {plain} plain + {q8} scaled ragged launches, {split} on the split body")
    if split <= 0 or split != plain + q8:
        raise AssertionError(f"{run}: {plain} + {q8} ragged launches, {split} on the split body")


def teacher_forced(model, params, req, dev, label: str, floor: float = AGREE_FLOOR) -> float:
    """LM.prefill (flash kernel, unquantized bf16 cache) over prompt +
    generated must predict the engine's stream (at least ``floor`` of its
    tokens); returns the agreement."""
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
          f"positions (floor {floor}); top-2 margins at disagreements: "
          f"{np.round(margin[~agree], 3).tolist()[:8]}")
    if agree.mean() < floor:
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
    ragged0 = ragged_counts()
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    launches = read_counts(counters, "phase 4")
    ragged_all_split(ragged0, "phase 4")
    check_finished(reqs, max_new, cfg.vocab_size)
    peak = torch.cuda.max_memory_allocated()
    print_stats(stats, f"; peak memory {peak / 2**30:.2f} GiB")
    teacher_forced(model, params, reqs[5], dev, "dense bf16")
    decode_step_profile(eng, cfg, dev)
    return launches, model, params, {r.rid: r.generated for r in reqs}


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
    paged = launches["paged_attention"] + launches["paged_attention_q8"]
    split = sum(launches[c_] for c_ in PAGED_SPLIT)
    if split != paged:
        raise AssertionError(f"({label}) {paged} paged launches, {split} of them on the split "
                             "body")
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
                            ["paged_attention", *PAGED_SPLIT], batch_slots=8)
    # (b) int8 pool of (a)'s bytes, twice the slots
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    int8_block = L * bs * KV * (hd + 4) * 2
    lb, b, _ = serve_shared(dev, model, params, counters, "b: paged int8 + prefix",
                            ["paged_attention_q8", *PAGED_SPLIT], batch_slots=16,
                            kv_dtype="int8",
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
    ragged0 = ragged_counts()
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    runs.append(read_counts(counters, "(c: dense int8)",
                            ["decode_attention_q8", "ragged_attention_q8",
                             "decode_attention_q8_split", "ragged_attention_q8_split"]))
    ragged_all_split(ragged0, "(c: dense int8)")
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
    # the paged body's launches per store (a: bf16, b: int8) and per tile
    for store, run in (("paged_attention", la), ("paged_attention_q8", lb)):
        launches[f"{store}_decode"] = run["paged_attention_split_decode"]
        launches[f"{store}_pack"] = run["paged_attention_split_pack"]
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

    def q8_bodies(label, run) -> None:
        """Every matmul_q8 launch of a serving run (M <= 64) on a tensor-core
        GEMV: gemv_tc at M <= 8, the multi-row body above; none on mma_pipe."""
        gemv = run["matmul_q8_gemv_tc"] + run["matmul_q8_rows"]
        if run["matmul_q8_mma_pipe"] or gemv != run["matmul_q8"]:
            raise AssertionError(f"({label}) {run['matmul_q8']} matmul_q8 launches: "
                                 f"{run['matmul_q8_gemv_tc']} gemv_tc, {run['matmul_q8_rows']} "
                                 f"gemv_tc_rows, {run['matmul_q8_mma_pipe']} mma_pipe")

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
                     ["matmul_q8", "matmul_q8_gemv_tc", "matmul_q8_rows", "decode_attention",
                      "ragged_attention", "gqa_flash_attention"])
    q8_bodies("a", la)
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
                                  ["matmul_q8", "matmul_q8_rows", "paged_attention_q8",
                                   *PAGED_SPLIT], batch_slots=16,
                                  kv_dtype="int8", num_blocks=num_blocks_b, weight_dtype="int8",
                                  floor_ms=floor_ms)
    q8_bodies("b", lb)
    b.update(resident("b", qparams))
    del qparams
    torch.cuda.empty_cache()
    launches = {name: la[name] + lb[name] for name in counters}
    print(f"  launches during phase 6's two measured runs: {launches}")
    return launches, {"a": a, "b": b}


def decode_step_profile(eng, cfg, dev, label: str = "decode step", steps: int = 8,
                        floor_ms=None, smode: int = 0, moe_mod=None) -> dict:
    """Where a decode step goes: wall time per step of an 8-step chunk over
    the engine's current slots (all slots decoding, or the live ones of a
    paged engine, through its block tables), the device's busy time per step
    from the profiler, and the kernels that take it. ``floor_ms`` is the
    step's weight-read floor (default: every bf16 parameter once); ``smode``
    the sampler variant each step draws with (the live slots' rows). With
    ``moe_mod`` (``models.moe``), the device time of the expert products
    (the ``aten::bmm`` calls inside ``moe._experts``) is read too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if eng.paged:  # the live slots only: released rows read the scratch block
        active = torch.tensor([r is not None for r in eng.slot_req], dtype=torch.int32,
                              device=dev)
    else:
        active = torch.ones(eng.B, dtype=torch.int32, device=dev)
    btab = eng._flush_btab()
    sp = eng._slot_sampler([i for i, r in enumerate(eng.slot_req) if r is not None])[1]

    def chunk():
        eng._tick_fn(eng._last_tok, eng._cur_len, active, steps, btab, sp, smode)
        torch.cuda.synchronize()

    chunk()
    t0 = time.perf_counter()
    chunk()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    experts = moe_mod._experts if moe_mod is not None else None
    if experts is not None:
        def spanned(*a, **kw):
            with torch.profiler.record_function("moe.experts"):
                return experts(*a, **kw)

        moe_mod._experts = spanned
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk()
    finally:
        if experts is not None:
            moe_mod._experts = experts
    # kernel rows carry the device time; op rows repeat it as their children's
    # (the "moe.experts" span is a range on the device's timeline, not a kernel)
    kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and e.key != "moe.experts"]
    busy_ms = sum(r[0] for r in kernels) / 1e3 / steps
    if floor_ms is None:
        floor_ms = cfg.num_params() * 2 / HBM_BYTES_PER_S * 1e3
    n_kernels = sum(r[1] for r in kernels) // steps
    print(f"  {label} ({int(active.sum())} slots decoding): wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms (idle share {1 - busy_ms / wall_ms:.2f}), "
          f"{n_kernels} kernels; weight-read floor {floor_ms:.2f} ms")
    for us, n, key in sorted(kernels, reverse=True)[:8]:
        print(f"    {us / 1e3 / steps:7.3f} ms/step  {n // steps:4d} calls/step  {key[:80]}")
    out = dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=n_kernels, floor_ms=floor_ms)
    if experts is not None:
        bmm_us, n_bmm = 0.0, 0
        for e in prof.events():
            if e.name != "aten::bmm":
                continue
            up = e.cpu_parent
            while up is not None and up.name != "moe.experts":
                up = up.cpu_parent
            if up is not None:
                bmm_us += e.device_time_total
                n_bmm += 1
        out.update(expert_bmm_ms=bmm_us / 1e3 / steps, expert_bmms=n_bmm // steps)
        print(f"    the expert products: {out['expert_bmm_ms']:.3f} ms/step of device time in "
              f"{out['expert_bmms']} aten::bmm calls/step")
        if n_bmm == 0:
            raise AssertionError(f"{label}: no expert product in the profile")
    return out


# ---------------------------------------------------------------- phase 10


def count_calls(obj, name: str, counter, per_call: list, steps=None) -> None:
    """Wrap ``obj.<name>`` so that each call appends how far ``counter()``
    moved during it (and, with ``steps``, the call's own step count from its
    arguments) to ``per_call``."""
    orig = getattr(obj, name)

    def wrapped(*args, **kw):
        n0 = counter()
        out = orig(*args, **kw)
        per_call.append((counter() - n0, steps(*args, **kw) if steps else 1))
        return out

    setattr(obj, name, wrapped)


def spec_step_profile(eng, cfg, dev, label: str, depth_k: int = 8) -> dict:
    """One verify dispatch of a speculating engine over its decoding slots at
    depth ``depth_k`` (each slot's last token repeated as its drafts), wall
    against device-busy time from the profiler; the dispatch's results are
    discarded (its K/V rows lie past every committed length)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    b, w = eng.B, depth_k + 1
    pack = np.zeros((3, b * w + b), np.int32)
    pack[2, : b * w] = eng.max_len
    slots = [i for i, r in enumerate(eng.slot_req) if r is not None and r.generated]
    for i in slots:
        cl = int(eng.slot_len[i])
        pack[0, i * w: (i + 1) * w] = eng.slot_req[i].generated[-1]
        pack[1, i * w: (i + 1) * w] = i
        pack[2, i * w: (i + 1) * w] = cl + np.arange(w)
        pack[:, b * w + i] = (depth_k, 1, cl)
    smode, sp = eng._slot_sampler(slots)
    btab = eng._flush_btab()

    def verify():
        eng._spec_fn(eng._last_tok, eng._cur_len, eng._put(pack.copy()), depth_k, btab, sp,
                     smode)
        torch.cuda.synchronize()

    verify()
    t0 = time.perf_counter()
    verify()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        verify()
    # (the "moe.experts" span is a range on the device's timeline, not a kernel)
    kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and e.key != "moe.experts"]
    busy_ms = sum(r[0] for r in kernels) / 1e3
    n_kernels = sum(r[1] for r in kernels)
    print(f"  {label} ({len(slots)} slots x {w} rows, T {b * w}, smode {smode}): wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.2f}), {n_kernels} kernels", flush=True)
    for us, n, key in sorted(kernels, reverse=True)[:6]:
        print(f"    {us / 1e3:7.3f} ms  {n:4d} calls  {key[:80]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=n_kernels, t=b * w)


def sampler_profile(dev, v: int, b: int = 4, smodes=(0, 1, 2)) -> dict:
    """The fused sampler alone over ``b`` rows of ``v`` logits at each of
    ``smodes``: device time (30 calls in one CUDA graph) and kernels a call
    (the profiler over 10 calls); smode 2 is the threefry draw, the bias
    lanes, the sort and the cumsum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import sampling as smp

    gen = torch.Generator(device=dev).manual_seed(9)
    logits = torch.randn(b, v, generator=gen, device=dev).to(torch.bfloat16)
    rows = smp.param_rows([smp.SamplingParams(temperature=1.0, top_k=40, top_p=0.9, seed=i,
                                              logit_bias=((3, 1.0),)) for i in range(b)],
                          list(range(b)))
    spf, spi, btok, bval = (torch.from_numpy(a).to(dev) for a in rows)
    pos = torch.arange(b, dtype=torch.int32, device=dev) + 700
    out = {}
    for sm in smodes:
        def call():
            return smp.fused_sample(logits, spf[0], spi[0], spf[1], spi[1], pos, btok, bval,
                                    smode=sm)
        ms = time_ms(call)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0) / 10
        out[sm] = dict(ms=ms, kernels=n)
        print(f"  fused_sample smode {sm}, {b} x {v}: {ms:.4f} ms device, {n:g} kernels a call",
              flush=True)
    return out


def full_width_sampling(dev, model, params) -> dict:
    """Phase 10: sampled and speculated serving at full width on phase 4's
    weights (4 slots x 1024, bf16), phase 4's prompt lengths made repetitive:
    (a) the mixed traffic of ``mixed_params`` (three each of greedy,
    temperature, top-k/top-p and biased greedy), run twice (the second with
    the greedy requests at top-k 1, temperature 1) and at max_chunk 1; (b)
    the same traffic with the n-gram drafter, every verify dispatch on the
    ragged kernel; (c) with a 1-layer truncation of the target as the draft
    model, its catch-ups on the ragged kernel and its rolls on the decode
    kernel; (d) phase 5 (a)'s paged + prefix traffic with the n-gram drafter,
    every verify dispatch on the paged kernel. Returns its readings."""
    import torch

    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ragged_attention as rk
    from repro_torch.serve import Request, SamplingParams, ServeEngine, SpeculateConfig
    from repro_torch.serve import engine as engine_mod

    cfg = model.cfg
    max_new, boost = 32, 1234
    lens = (5, 700, 37, 130, 64, 300, 12, 513, 65, 200, 48, 90)  # phase 4's
    prompts = repetitive_prompts(lens, cfg.vocab_size, seed=10)
    bans = {}  # a biased request bans its prompt's first greedy token
    for i in range(3, len(prompts), 4):
        with torch.no_grad():
            lg, _ = model.prefill(params, {"tokens": torch.from_numpy(prompts[i][None]).to(dev)},
                                  len(prompts[i]))
        bans[i] = int(lg[0, -1].float().argmax())
    out: dict = {}

    def params_for(i, top1=False):
        if top1 and i % 4 == 0:
            return SamplingParams(max_new=max_new, temperature=1.0, top_k=1, seed=3000 + i)
        return mixed_params(i, max_new, bans.get(i, 0), boost)

    def serve(**kw):
        eng = ServeEngine(model, params, batch_slots=4, max_len=1024, prefill_budget=64, seed=11,
                          **kw)
        eng.prewarm(sampling=True)
        return eng

    def drain(eng, label, top1=False, prompts_=prompts, params_=None):
        reqs = [Request(rid=i, prompt=p_, params=params_ or params_for(i, top1))
                for i, p_ in enumerate(prompts_)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run()
        check_finished(reqs, max_new, cfg.vocab_size)
        spec = (f"; {stats.spec_ticks} verify ticks, {stats.spec_proposed} drafts proposed, "
                f"{stats.spec_accepted} accepted (acceptance {stats.spec_acceptance:.3f}), "
                f"{stats.total_tokens / max(stats.spec_ticks, 1):.2f} tokens a tick"
                if eng.spec is not None else "")
        print(f"  {label}:", flush=True)
        print_stats(stats, spec)
        out[label] = dict(tok_s=stats.tokens_per_sec, ttft_p50_ms=stats.ttft_p50 * 1e3,
                          ttft_p99_ms=stats.ttft_p99 * 1e3, tpot_p50_ms=stats.tpot_p50 * 1e3,
                          spec_ticks=stats.spec_ticks, spec_proposed=stats.spec_proposed,
                          spec_accepted=stats.spec_accepted,
                          spec_acceptance=stats.spec_acceptance)
        return {r.rid: r.generated for r in reqs}, reqs, stats

    def agreement(a, b, rids):
        n = sum(len(a[r]) for r in rids)
        return sum(int(x == y) for r in rids for x, y in zip(a[r], b[r])) / n

    kinds = {k: [i for i in range(len(prompts)) if i % 4 == k] for k in range(4)}
    seeded = kinds[1] + kinds[2]

    # (a) mixed sampling, run twice
    eng = serve()
    run1, reqs1, _ = drain(eng, "(a) mixed sampling, run 1")
    for i, ban in bans.items():
        if ban in run1[i]:
            raise AssertionError(f"(a) rid {i}: the banned token {ban} was sampled")
    print(f"  (a) banned tokens {sorted(bans.values())} never sampled; the boosted token "
          f"{boost} drawn {sum(run1[i].count(boost) for i in bans)} times in "
          f"{len(bans) * max_new}", flush=True)
    # a sampled decode step, and the sampler alone
    live = [eng.submit(Request(rid=400 + i, prompt=prompts[i], params=params_for(i)))
            for i in (1, 2, 5, 6)]
    while eng._prefilling or eng.waiting:
        eng.step()
    out["sampled_step"] = decode_step_profile(eng, cfg, dev, "(a) decode step, smode 2",
                                              smode=2)
    out["greedy_step"] = decode_step_profile(eng, cfg, dev, "(a) decode step, smode 0")
    for h in live:
        h.cancel()
    eng.run()
    out["sampler"] = sampler_profile(dev, cfg.vocab_size)
    out["sampler_verify"] = sampler_profile(dev, cfg.vocab_size, 36, (2,))  # T 36
    # run 2: the greedy requests at top-k 1, temperature 1; each such draw is
    # checked to take a largest logit of the row it was drawn from
    top1 = {"draws": 0, "ties": 0, "bad": 0}
    orig = engine_mod.fused_sample

    def checked(logits, temps=None, top_k=None, *args, smode=0):
        got = orig(logits, temps, top_k, *args, smode=smode)
        if smode == 2:  # the variant that reads top_k (smode 1 draws every row unmasked)
            rows = (top_k == 1) & (temps > 0)
            if bool(rows.any()):
                lf = logits.float()[rows]
                mx = lf.max(-1).values
                took = lf.gather(1, got[rows].long()[:, None])[:, 0]
                top1["draws"] += int(rows.sum())
                top1["bad"] += int((took != mx).sum())
                top1["ties"] += int(((lf == mx[:, None]).sum(-1) > 1).sum())
        return got

    engine_mod.fused_sample = checked
    try:
        run2, _, _ = drain(eng, "(a) run 2, greedy requests at top-k 1", top1=True)
    finally:
        engine_mod.fused_sample = orig
    same = [i for i in run1 if i % 4 and run1[i] != run2[i]]
    if same:
        raise AssertionError(f"(a) rids {same}: streams differ between two runs")
    eq1 = all(run1[i] == run2[i] for i in kinds[0])
    print(f"  (a) the 9 other streams bitwise equal run to run; top-k 1 at temperature 1: "
          f"{top1['draws']} draws, {top1['bad']} off a row's largest logit, {top1['ties']} at a "
          f"tie for it; its streams equal the greedy ones: {eq1} (agreement "
          f"{agreement(run1, run2, kinds[0]):.3f})", flush=True)
    if top1["bad"] or top1["draws"] == 0 or (top1["ties"] == 0 and not eq1):
        raise AssertionError("(a) top-k 1 at temperature 1 is not the greedy draw")
    out["top1"] = dict(top1, equal=eq1)
    del eng
    eng = serve(max_chunk=1)
    run3, _, _ = drain(eng, "(a) run 3, max_chunk 1")
    a_chunk = agreement(run1, run3, seeded)
    print(f"  (a) seeded streams at max_chunk 1 against 8: agreement {a_chunk:.3f} "
          f"({sum(run1[i] == run3[i] for i in seeded)} of {len(seeded)} streams equal); all: "
          f"{agreement(run1, run3, list(run1)):.3f}", flush=True)
    out["chunk_agreement"] = a_chunk
    del eng

    def verify_counts(eng, counter):
        per = []
        count_calls(eng, "_spec_fn", counter, per)
        return per

    def check_verify(per, stats, counter_name, label):
        bad = [n for n, _ in per if n != cfg.n_layers]
        print(f"  {label}: {len(per)} verify dispatches, {counter_name} launches per dispatch "
              f"{sorted({n for n, _ in per})} (the model's {cfg.n_layers} layers)", flush=True)
        if len(per) != stats.spec_ticks or not per or bad:
            raise AssertionError(f"{label}: verify dispatches not all on {counter_name}")

    def greedy_gate(reqs, label):
        return [teacher_forced(model, params, reqs[i], dev, f"{label} rid {i}")
                for i in kinds[0]]

    # (b) the n-gram drafter
    eng = serve(speculate="ngram")
    per = verify_counts(eng, lambda: rk.launches_split)
    run_b, reqs_b, stats_b = drain(eng, "(b) n-gram speculation")
    check_verify(per, stats_b, "ragged (split body)", "(b)")
    launched = {"ragged_verify": sum(n for n, _ in per)}
    if stats_b.spec_proposed <= 0 or stats_b.spec_accepted <= 0:
        raise AssertionError("(b) no draft proposed or accepted")
    out["(b) n-gram speculation"]["teacher_forced"] = greedy_gate(reqs_b, "(b)")
    print(f"  (b) agreement with (a)'s streams without speculation: greedy "
          f"{agreement(run1, run_b, kinds[0]):.3f}, seeded {agreement(run1, run_b, seeded):.3f},"
          f" biased {agreement(run1, run_b, kinds[3]):.3f}; equal streams "
          f"{sum(run1[i] == run_b[i] for i in run1)} of {len(run1)}", flush=True)
    out["(b) n-gram speculation"]["agreement"] = agreement(run1, run_b, list(run1))
    live = [eng.submit(Request(rid=400 + i, prompt=prompts[i], params=params_for(i)))
            for i in (1, 2, 5, 6)]
    while eng._prefilling or eng.waiting:
        eng.step()
    out["verify_step"] = spec_step_profile(eng, cfg, dev, "(b) verify dispatch, depth 8")
    for h in live:
        h.cancel()
    eng.run()
    del eng

    # (c) the draft-model drafter: a 1-layer truncation of the target
    eng = serve(speculate=SpeculateConfig(mode="draft", draft_layers=1))
    per = verify_counts(eng, lambda: rk.launches_split)
    catches, rolls = [], []
    count_calls(eng.drafter, "_catch", lambda: rk.launches_split, catches)
    count_calls(eng.drafter, "_roll", lambda: dk.launches_split, rolls,
                steps=lambda tok, cl, act, n_steps: n_steps)
    run_c, reqs_c, stats_c = drain(eng, "(c) draft-model speculation")
    check_verify(per, stats_c, "ragged (split body)", "(c)")
    launched["ragged_verify"] += sum(n for n, _ in per)
    launched["ragged_draft_catchup"] = sum(n for n, _ in catches)
    launched["decode_draft_roll"] = sum(n for n, _ in rolls)
    # what the draft could be accepted at: its own teacher-forced top-1
    # agreement with the target's greedy streams
    d_agree = [teacher_forced(eng.drafter.model, eng.drafter.params, reqs_c[i], dev,
                              f"(c) the 1-layer draft on rid {i}", floor=0.0)
               for i in kinds[0]]
    bad = [c for c in catches if c[0] != 1] + [r_ for r_ in rolls if r_[0] != r_[1]]
    print(f"  (c) drafter: {len(catches)} catch-ups, each one ragged launch (its 1 layer); "
          f"{len(rolls)} rolls of {sum(r_[1] for r_ in rolls)} steps, "
          f"{sum(r_[0] for r_ in rolls)} decode launches", flush=True)
    if not catches or not rolls or bad:
        raise AssertionError(f"(c) drafter launches off the ragged / decode kernels: {bad[:4]}")
    out["(c) draft-model speculation"]["teacher_forced"] = greedy_gate(reqs_c, "(c)")
    print(f"  (c) agreement with (a)'s streams without speculation: "
          f"{agreement(run1, run_c, list(run1)):.3f}; with (b)'s: "
          f"{agreement(run_b, run_c, list(run1)):.3f}", flush=True)
    out["(c) draft-model speculation"]["agreement"] = agreement(run1, run_c, list(run1))
    out["(c) draft-model speculation"]["draft_teacher_forced"] = d_agree
    del eng

    # (d) phase 5 (a)'s paged + prefix traffic, n-gram drafter
    warm, shared_prompts = shared_traffic(cfg)
    eng = ServeEngine(model, params, batch_slots=8, max_len=1024, prefill_budget=64,
                      kv_block_size=32, prefix_cache=True, speculate="ngram", seed=11)
    eng.prewarm(sampling=True)
    eng.submit(Request(rid=100, prompt=warm, params=SamplingParams(max_new=max_new)))
    eng.run()
    hits0 = eng.prefix.stats().hit_tokens
    per = verify_counts(eng, lambda: pk.launches_split_pack)
    _, reqs_d, stats_d = drain(eng, "(d) paged + prefix, n-gram speculation",
                               prompts_=shared_prompts, params_=SamplingParams(max_new=max_new))
    check_verify(per, stats_d, "paged (split pack body)", "(d)")
    launched["paged_verify"] = sum(n for n, _ in per)
    out["launches"] = launched
    print(f"  phase 10's launches on the speculative paths: {launched}", flush=True)
    hits = eng.prefix.stats().hit_tokens - hits0
    print(f"  (d) prefix hit tokens {hits}", flush=True)
    if hits <= 0:
        raise AssertionError("(d) the prefix cache never hit")
    out["(d) paged + prefix, n-gram speculation"]["teacher_forced"] = teacher_forced(
        model, params, reqs_d[1], dev, "(d)")
    del eng
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 12


def teacher_forced_sampled(model, params, req, dev, label: str,
                           floor: float = AGREE_FLOOR) -> float:
    """The seeded-stream form of ``teacher_forced``: LM.prefill's logits over
    prompt + generated, drawn again with the request's own sampler row at
    each token's PRNG position (``fused_sample``, the seed folded with the
    position), must give at least ``floor`` of its tokens."""
    import torch

    from repro_torch.serve import sampling as smp

    seq = np.concatenate([req.prompt, np.asarray(req.generated, np.int32)])
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(seq[None]).to(dev)},
                                  len(seq))
    rows = logits[0, len(req.prompt) - 1: len(seq) - 1].float()
    n = rows.shape[0]
    spf, spi, btok, bval = smp.param_rows([req.params] * n, [req.params.seed] * n)
    pos = torch.arange(len(req.prompt) - 1, len(seq) - 1, dtype=torch.int32)
    args = [torch.from_numpy(a).to(dev) for a in (spf[0], spi[0], spf[1], spi[1])]
    drawn = smp.fused_sample(rows, *args, pos.to(dev), torch.from_numpy(btok).to(dev),
                             torch.from_numpy(bval).to(dev), smode=req.params.smode)
    agree = float((drawn.cpu().numpy() == np.asarray(req.generated)).mean())
    print(f"  {label}: teacher-forced seeded agreement {agree:.3f} over {n} positions "
          f"(floor {floor})")
    if agree < floor:
        raise AssertionError(f"{label}: teacher-forced agreement below the floor")
    return agree


class BusySampler:
    """The card's busy share over a run from NVML: ``nvidia-smi`` samples
    ``utilization.gpu`` (the share of its sample period, 1/6 to 1 s, in
    which a kernel ran) every 100 ms in a process of its own until
    ``stop()``, which returns the mean idle share (None where the query
    gives nothing: not measured)."""

    def __init__(self, dev):
        import threading

        self.samples: list[float] = []
        self.proc = None
        if dev.type != "cuda":
            return
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.samples.append(float(line.strip()))
            except ValueError:
                pass

    def stop(self):
        if self.proc is None:
            return None
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=5)
        if not self.samples:
            return None
        return 1.0 - float(np.mean(self.samples)) / 100.0


def host_overheads(dev) -> dict:
    """The perfmodel's host constants on this card: ``launch_overhead``, the
    host time of one launch over 2,000 empty kernels (``torch.cuda._sleep(0)``)
    queued back to back, and ``barrier_overhead``, one round of a two-thread
    barrier and ``torch.cuda.synchronize`` on an idle card (mean of 500)."""
    import threading

    import torch

    for _ in range(200):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        torch.cuda._sleep(0)
    launch = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    rounds, bar = 500, threading.Barrier(2)
    took = []

    def worker(timed: bool):
        bar.wait()
        t0 = time.perf_counter()
        for _ in range(rounds):
            bar.wait()
            torch.cuda.synchronize()
        bar.wait()
        if timed:
            took.append((time.perf_counter() - t0) / rounds)

    other = threading.Thread(target=worker, args=(False,))
    other.start()
    worker(True)
    other.join()
    print(f"  host overheads: launch {launch * 1e6:.2f} us (2,000 empty launches), barrier + "
          f"synchronize {took[0] * 1e6:.2f} us (two threads, 500 rounds)", flush=True)
    return dict(launch_overhead_s=launch, barrier_overhead_s=took[0])


def replica_step_profile(engines, dev, steps: int = 8) -> dict:
    """A steady decode step of 4 slots on one replica alone, then on every
    replica at once (each from its own thread, on its own stream): wall per
    step (the slowest thread's), the card's busy time per step from the
    profiler (the union of kernel intervals over both streams) and the idle
    share. The replicas are idle; their dummy steps write cache rows nothing
    reads."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    def chunk(e):
        with e.backend.scope():
            act = torch.ones(e.B, dtype=torch.int32, device=dev)
            e._tick_fn(e._last_tok, e._cur_len, act, steps, e._flush_btab(), e._sp0, 0)
            torch.cuda.current_stream(dev).synchronize()

    def together(group):
        bar = threading.Barrier(len(group) + 1)

        def go(e):
            bar.wait()
            chunk(e)

        threads = [threading.Thread(target=go, args=(e,)) for e in group]
        for t in threads:
            t.start()
        bar.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        return (time.perf_counter() - t0) * 1e3 / steps

    out = {}
    for label, group in (("1 replica", engines[:1]), (f"{len(engines)} replicas", engines)):
        together(group)
        wall = together(group)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            together(group)
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, -1.0
        for a, b in spans:  # the union of the kernels' intervals (us)
            if b > end:
                busy += b - max(a, end)
                end = b
        if not spans:
            raise AssertionError("replica_step_profile: the profiler saw no kernel")
        busy_ms = busy / 1e3 / steps
        out[label] = dict(wall_ms=wall, busy_ms=busy_ms, idle_share=1 - busy_ms / wall,
                          kernels=len(spans) // steps)
        print(f"  decode step, {label} x 4 slots: wall {wall:.2f} ms, device busy {busy_ms:.2f} "
              f"ms (union over streams), idle share {1 - busy_ms / wall:.2f}, "
              f"{len(spans) // steps} kernels a step", flush=True)
    return out


def cluster_traffic(cfg, max_new: int = 32):
    """Phase 12's traffic: phase 4's 12 prompts, tenants a / b alternating,
    rids 1, 4, 7 and 10 seeded at temperature 0.8, the others greedy."""
    from repro_torch.serve import Request, SamplingParams

    return [Request(rid=i, prompt=p_, tenant="ab"[i % 2], params=SamplingParams(
                max_new=max_new, **(dict(temperature=0.8, seed=3000 + i) if i % 3 == 1 else {})))
            for i, p_ in enumerate(phase4_prompts(cfg))]


def cluster_checks(model, params, dev, reqs, phase4: dict, label: str) -> dict:
    """Every stream finished and teacher-forced (greedy: argmax; seeded: the
    same draw), greedy streams against phase 4's single engine (printed,
    not gated: a bf16 near-tie may round apart in another batch mix)."""
    check_finished(reqs, reqs[0].params.max_new, model.cfg.vocab_size)
    agree = []
    for r in reqs:
        tag = f"{label} rid {r.rid}"
        if r.params.temperature > 0:
            agree.append(teacher_forced_sampled(model, params, r, dev, tag))
        else:
            agree.append(teacher_forced(model, params, r, dev, tag))
    same = [r.rid for r in reqs if r.params.temperature == 0 and r.rid in phase4
            and r.generated == phase4[r.rid][: len(r.generated)]]
    greedy = [r for r in reqs if r.params.temperature == 0 and r.rid in phase4]
    tok = [np.mean(np.asarray(r.generated) == np.asarray(phase4[r.rid][: len(r.generated)]))
           for r in greedy]
    print(f"  {label}: teacher-forced min {min(agree):.3f}; greedy streams equal to phase 4's: "
          f"{len(same)} of {len(greedy)}, token agreement {np.mean(tok) if tok else 1.0:.3f}",
          flush=True)
    return dict(teacher_forced_min=min(agree), phase4_equal=len(same), phase4_greedy=len(greedy),
                phase4_token_agreement=float(np.mean(tok)) if tok else 1.0)


def cluster_row(label: str, stats, idle) -> dict:
    idle_s = f"{idle:.3f}" if idle is not None else "not measured"
    print(f"  {label}: {stats.total_requests} requests, {stats.total_tokens} decode tokens in "
          f"{stats.wall_seconds:.3f} s: {stats.tokens_per_sec:.1f} tok/s; TTFT p50 "
          f"{stats.ttft_p50 * 1e3:.1f} ms p99 {stats.ttft_p99 * 1e3:.1f} ms; TPOT p50 "
          f"{stats.tpot_p50 * 1e3:.2f} ms; device idle share {idle_s} (NVML)", flush=True)
    return dict(tok_s=stats.tokens_per_sec, ttft_p50_ms=stats.ttft_p50 * 1e3,
                ttft_p99_ms=stats.ttft_p99 * 1e3, tpot_p50_ms=stats.tpot_p50 * 1e3,
                wall_s=stats.wall_seconds, idle_share=idle)


STALL_S, DEAD_AFTER_S = 14.0, 10.0  # phase 12 (d): replica 1's stall, the watchdog's verdict


def full_width_cluster(dev, model, params, phase4: dict, counters, max_len: int = 1024) -> dict:
    """Phase 12: the split/merge serving cluster at full width on phase 4's
    weights (bf16, 4 slots x ``max_len`` a replica). A single engine, then
    (a) split over [cuda:0, cuda:0] (two replicas, two controller threads,
    two streams, one copy of the weights), (b) a cluster over [cuda:0]
    switching SPLIT -> MERGE once half the requests have arrived and
    switching back warm, (c) ``run_controlled`` under
    ``ReconfigController.for_cluster`` over 8 long prompts then 24 short
    ones (its decisions printed, not gated), (d) two replicas with an
    injected controller stall: exactly one must be declared dead and every
    request finish. In each run the decode, ragged and flash kernels must launch and
    every stream agree with ``LM.prefill`` teacher-forced."""
    import threading

    from repro_torch.core.modes import Mode
    from repro_torch.serve import (
        FailurePolicy,
        ReconfigController,
        Request,
        SamplingParams,
        ServeCluster,
        ServeEngine,
    )

    cfg = model.cfg
    out: dict = {"host": host_overheads(dev)} if dev.type == "cuda" else {}
    kw = dict(batch_slots=4, max_len=max_len, prefill_budget=64)
    runs: dict = {}

    def measured(label, go, reqs):
        reset_counts(counters)
        busy = BusySampler(dev)
        try:
            stats = go()
        finally:
            idle = busy.stop()
        runs[label] = dict(launches=read_counts(counters, f"phase 12 {label}"),
                           **cluster_row(label, stats, idle),
                           **cluster_checks(model, params, dev, reqs, phase4, label))
        return stats

    # the single engine on the same traffic
    eng = ServeEngine(model, params, device=dev, **kw)
    eng.prewarm(sampling=True)
    reqs = cluster_traffic(cfg)

    def single():
        for r in reqs:
            eng.submit(r)
        return eng.run()

    measured("single engine", single, reqs)
    del eng

    # (a) split: two replicas on one card
    cl = ServeCluster(model, params, devices=[dev, dev], **kw)
    if cl.engines[0].params is not cl.engines[1].params:
        raise AssertionError("phase 12 (a): the replicas must share one copy of the weights")
    cl.prewarm(sampling=True)
    reqs = cluster_traffic(cfg)

    def split():
        for r in reqs:
            cl.submit(r)
        return cl.run()

    measured("(a) split [cuda:0, cuda:0]", split, reqs)
    runs["(a) split [cuda:0, cuda:0]"]["assigned"] = list(cl.router.assigned)
    if dev.type == "cuda":
        out["step_profile"] = replica_step_profile(cl.engines, dev)
    del cl

    # (b) SPLIT -> MERGE once half the requests have arrived, then back warm
    cl = ServeCluster(model, params, devices=[dev], **kw)
    cl.prewarm(sampling=True)
    reqs = cluster_traffic(cfg)
    gap = 0.4
    t_half = gap * (len(reqs) // 2 - 1) + gap / 2

    def switched():
        return cl.run(arrivals=[(gap * i, r) for i, r in enumerate(reqs)],
                      reconfigure_schedule=[(t_half, Mode.MERGE)])

    stats = measured("(b) [cuda:0] split -> merge", switched, reqs)
    reports = list(stats.reconfigures) + [cl.reconfigure(Mode.SPLIT), cl.reconfigure(Mode.MERGE)]
    for rep in reports:
        print(f"  (b) {rep}")
    if [r.cached for r in reports] != [False, True, True]:
        raise AssertionError(f"phase 12 (b): switches {reports}, want cold, warm, warm")
    out["reconfigure"] = [dict(from_mode=r.from_mode, to_mode=r.to_mode, cached=r.cached,
                               seconds=r.seconds, drain_s=r.drain_seconds,
                               place_s=r.place_seconds, bytes=r.bytes_moved) for r in reports]
    del cl

    # (c) the closed control loop over 8 long prompts, then 24 short ones
    rng = np.random.default_rng(12)
    lens = [int(x) for x in rng.integers(600, 701, size=8)] + \
        [int(x) for x in rng.integers(5, 41, size=24)]
    reqs = [Request(rid=100 + i, prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    tenant="ab"[i % 2], params=SamplingParams(max_new=16))
            for i, n in enumerate(lens)]
    arrivals = [(0.05 * i if i < 8 else 2.0 + 0.1 * (i - 8), r) for i, r in enumerate(reqs)]
    cl = ServeCluster(model, params, devices=[dev, dev], **kw)
    cl.prewarm()
    inner = ReconfigController.for_cluster(cl, interval_s=0.5)
    log = []

    class Logged:  # the controller, its every observation and decision kept
        interval_s = inner.interval_s

        def observe(self, sample, *, warm_target=False):
            d = inner.observe(sample, warm_target=warm_target)
            log.append(dict(t=round(sample.t, 3), mode=sample.mode, arrivals=sample.n_requests,
                            queue=sample.queue_depth,
                            decision=None if d is None else dict(
                                mode=str(d.mode), win_s=d.predicted_win_s,
                                cost_s=d.switch_cost_s)))
            return d

        def note_switched(self, t, report=None):
            inner.note_switched(t, report)

    stats = measured("(c) run_controlled [cuda:0, cuda:0]",
                     lambda: cl.run_controlled(arrivals, controller=Logged()), reqs)
    for entry in log:
        print(f"    control window {entry}")
    out["controlled"] = dict(windows=len(log), decisions=[e for e in log if e["decision"]],
                             mode=stats.mode, reconfigures=len(stats.reconfigures))
    del cl

    # (d) a controller stall on replica 1: declared dead, its requests re-homed.
    # dead_after must exceed the longest iteration a live replica takes: two
    # replicas at full width run iterations of up to ~3 s (a batch's first
    # admissions, both threads launching), so a 3 s verdict can declare the
    # survivor dead too, and with no replica left its requests are never served
    stamps: dict = {0: [], 1: []}
    lock = threading.Lock()

    def stall(idx: int) -> None:
        with lock:
            stamps[idx].append(time.perf_counter())
            n = sum(t is not None for t in stamps[idx])
        if idx == 1 and n == 12:
            time.sleep(STALL_S)

    cl = ServeCluster(model, params, devices=[dev, dev], **kw, failure=FailurePolicy(
        straggler_after=1.0, dead_after=DEAD_AFTER_S, poll=0.05, tick_hook=stall))
    cl.prewarm(sampling=True)
    for i, e in enumerate(cl.engines):  # mark where each run of a replica starts
        def run(*a, _run=e.run, _i=i, **k):
            with lock:
                stamps[_i].append(None)
            return _run(*a, **k)
        e.run = run
    reqs = cluster_traffic(cfg)

    def dying():
        for r in reqs:
            cl.submit(r)
        stats = cl.run()
        # the longest iteration of each replica within one of its runs (not
        # the idle time before the survivor's drain of re-homed work;
        # replica 1's stall excluded: no beat follows it)
        with lock:
            longest = {i: max((b - a for a, b in zip(s, s[1:]) if a and b), default=0.0)
                       for i, s in stamps.items()}
            ticks = {i: sum(t is not None for t in s) for i, s in stamps.items()}
        hung = [r.rid for r in reqs if r.finish_reason is None]
        print(f"  (d) dead replicas {stats.dead_replicas}, re-homed {stats.rehomed}, stragglers "
              f"{stats.stragglers}, replica ticks {ticks}, longest iteration (s) "
              f"{ {i: round(v, 3) for i, v in longest.items()} } against dead_after "
              f"{DEAD_AFTER_S} s", flush=True)
        if stats.dead_replicas != 1 or stats.rehomed < 1 or hung:
            raise AssertionError(
                f"phase 12 (d): one replica must die and its requests re-home and finish: "
                f"{stats.dead_replicas} dead, {stats.rehomed} re-homed, unfinished rids {hung}, "
                f"longest iterations {longest} s against dead_after {DEAD_AFTER_S} s")
        out["death"] = dict(dead=stats.dead_replicas, rehomed=stats.rehomed,
                            stragglers=stats.stragglers, ticks=ticks,
                            longest_iteration_s=longest, dead_after_s=DEAD_AFTER_S)
        return stats

    measured("(d) replica 1 stalled", dying, reqs)
    del cl
    out["runs"] = runs
    return out


# ----------------------------------------------------------------- phase 9


def full_width_mla(dev, counters):
    """Phase 9: minicpm3-4b (multi-head latent attention: latent 256 + rope
    32, 40 heads) at full width and depth, bf16, random weights from a seed,
    serving phase 4's traffic on its dense latent cache (4 slots x 1024):
    fused admissions (the expanded prefill in plain torch), ragged packs (the
    latent-MQA kernel) and decode chunks (the absorbed decode in plain
    torch). The kernel's launches between the counts' reset and read, and
    its wgmma body's, must be > 0 and equal ``mla_packed``'s calls (no pack
    took the plain version or another body); every request must finish and
    the stream agree with ``LM.prefill`` teacher-forced."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.models import mla as mla_mod
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = get_arch("minicpm3-4b")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"MLA latent {cfg.mla.kv_lora_rank} + rope {cfg.mla.rope_head_dim}, {cfg.dtype}, "
          f"{cfg.num_params() / 1e9:.2f}B params, init {time.perf_counter() - t0:.1f} s")
    eng = ServeEngine(model, params, batch_slots=4, max_len=1024, prefill_budget=64)
    eng.prewarm()
    max_new = 32
    reqs = [Request(rid=i, prompt=p_, params=SamplingParams(max_new=max_new))
            for i, p_ in enumerate(phase4_prompts(cfg))]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    mla_mod.packed_calls = 0
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    launches = read_counts(counters, "phase 9")
    calls = mla_mod.packed_calls
    print(f"  {launches['mla_attention']} latent-MQA launches, "
          f"{launches['mla_attention_wgmma']} on the wgmma body, for {calls} MLA "
          f"packed-attention calls ({calls // cfg.n_layers} packs x {cfg.n_layers} layers)")
    if not launches["mla_attention"] == launches["mla_attention_wgmma"] == calls:
        raise AssertionError(f"phase 9: {launches['mla_attention']} latent-MQA launches "
                             f"({launches['mla_attention_wgmma']} on the wgmma body) for "
                             f"{calls} MLA packed-attention calls")
    check_finished(reqs, max_new, cfg.vocab_size)
    peak = torch.cuda.max_memory_allocated()
    print_stats(stats, f"; peak memory {peak / 2**30:.2f} GiB; KV (latent) "
                f"{eng.kv_bytes_resident() / 2**20:.1f} MiB")
    teacher_forced(model, params, reqs[5], dev, "minicpm3-4b dense bf16")
    decode_step_profile(eng, cfg, dev, label="minicpm3-4b decode step")
    return launches


# ---------------------------------------------------------------- phase 13

# one packed step through the kernels against the same step with every
# kernel call on its plain version (kernels/ref.py), on the card, bf16: the
# relative Frobenius error of the live rows' logits. Each layer's attention
# differs by about one bf16 rounding (2^-8) between the two, and a residual
# stack of random layers carries that forward (an MoE layer can also swap
# near-tied experts): predicted 0.02-0.1 at full depth. A wrong kernel (wrong
# rows, slots or scale) gives logits uncorrelated with the plain ones, ~1.4
PACK_REL_TOL = 0.25


def plain_kernels():
    """Context manager: every ``kernels.ops`` call takes its plain version in
    ``kernels/ref.py`` on the card (the device check answers "not CUDA")."""
    import contextlib

    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def cm():
        on_cuda = ops._on_cuda
        ops._on_cuda = lambda t: False
        try:
            yield
        finally:
            ops._on_cuda = on_cuda

    return cm()


def pack_vs_plain(model, params, cache, dev, label: str, moe_mod) -> dict:
    """Phase 2's 64-token pack (40 tokens of slot 1 at 0-39, 16 of slot 3 at
    600-615, 8 of padding) through ``LM.packed_step`` over the engine's
    cache, with the kernels and then with every kernel on its plain version;
    the live rows' logits within ``PACK_REL_TOL``."""
    import torch

    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, 64).astype(np.int32)).to(dev)
    slot = torch.tensor(PACK_SLOTS, dtype=torch.int32, device=dev)
    pos = torch.tensor(PACK_POS, dtype=torch.int32, device=dev)
    live = pos < S_MAX
    kept = moe_kept(moe_mod)
    with torch.no_grad():
        with kept:
            kern, _ = model.packed_step(params, cache, toks, slot, pos)
        with plain_kernels():
            plain, _ = model.packed_step(params, cache, toks, slot, pos)
    a, b = kern[live].float(), plain[live].float()
    rel = float((a - b).norm() / b.norm())
    out = dict(rel_err=rel, max_abs_err=float((a - b).abs().max()),
               top1=float((a.argmax(-1) == b.argmax(-1)).float().mean()),
               logit_rms=float(b.pow(2).mean().sqrt()), kept=kept.read()["other"])
    print(f"  {label} a 64-token pack (56 live rows), kernels vs plain on the card: relative "
          f"error {rel:.4f} (tolerance {PACK_REL_TOL}), max |diff| {out['max_abs_err']:.4f} of "
          f"logit rms {out['logit_rms']:.3f}, top-1 agreement {out['top1']:.3f}; kept entries "
          f"{out['kept'][1]}/{out['kept'][0]}")
    if not rel <= PACK_REL_TOL:
        raise AssertionError(f"{label}: the pack's logits through the kernels are {rel:.4f} "
                             "from the plain path's")
    return out


def moe_serve(dev, model, params, counters, label: str, expect, moe_mod, smi: str,
              **kw) -> tuple[dict, dict, object]:
    """Phase 4's traffic (4 slots x 1024, prefill_budget 64, 12 greedy
    requests of 5-700 prompt tokens, 32 new tokens) on a new engine; counts
    set to 0 just before and read just after (``expect`` must have
    launched); the kept share of (token, k) entries per route; every request
    finished and teacher-forced; a decode step profiled with the expert
    products timed, against the weight-read floor of the engine's params
    (every weight once: the dense [E, C] dispatch reads every expert).
    Returns (launches, readings, engine)."""
    import torch

    from repro_torch.common import pytree_bytes
    from repro_torch.models import mla as mla_mod
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = model.cfg
    max_new = 32
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, batch_slots=4, max_len=S_MAX, prefill_budget=64, **kw)
    eng.prewarm()
    setup_s = time.perf_counter() - t0
    reqs = [Request(rid=i, prompt=p_, params=SamplingParams(max_new=max_new))
            for i, p_ in enumerate(phase4_prompts(cfg))]
    kept = moe_kept(moe_mod)
    kept.wrap(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    mla_mod.packed_calls = 0  # after the prewarm's dispatches
    with kept:
        for r in reqs:
            eng.submit(r)
        stats = eng.run()
    launches = read_counts(counters, f"phase 13 {label}", expect)
    mla_calls = mla_mod.packed_calls
    kept.unwrap(eng)
    check_finished(reqs, max_new, cfg.vocab_size)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label} [{smi}]", end="")
    print_stats(stats, f"; peak memory {peak / 2**30:.2f} GiB; engine built and prewarmed in "
                f"{setup_s:.1f} s")
    shares = kept.read()
    print(f"  {label} kept (token, k) entries: {kept.summary()}")
    if shares["decode"][2] != 1.0:  # 4 slots: C = T, nothing may drop
        raise AssertionError(f"{label}: a decode step dropped entries")
    out = dict(tok_s=stats.tokens_per_sec, ttft_p50_ms=stats.ttft_p50 * 1e3,
               ttft_p99_ms=stats.ttft_p99 * 1e3, tpot_p50_ms=stats.tpot_p50 * 1e3,
               peak_gib=peak / 2**30, kept={r: v[2] for r, v in shares.items()},
               streams={r.rid: list(r.generated) for r in reqs}, mla_packed_calls=mla_calls)
    # the teacher: LM.prefill of the whole sequence routes its T tokens in
    # one call, so at the model's capacity factor its experts drop entries
    # that the engine's small calls kept (capacity follows the call's T; the
    # engine kept the shares above). The teacher runs the same weights at a
    # capacity of T (capacity factor E / k: nothing drops), the function the
    # engine computed wherever it dropped nothing
    from repro_torch.models import LM

    m = cfg.moe
    nodrop = LM(replace(cfg, moe=replace(m, capacity_factor=m.n_routed / m.top_k)), device=dev)
    seq = np.concatenate([reqs[5].prompt, np.asarray(reqs[5].generated, np.int32)])
    whole = moe_kept(moe_mod)
    with whole, torch.no_grad():
        model.prefill(eng.params, {"tokens": torch.from_numpy(seq[None]).to(dev)}, len(seq))
    n, k, share = whole.read()["other"]
    print(f"  {label} LM.prefill of request 5's {len(seq)} tokens in one call at capacity factor "
          f"{m.capacity_factor} keeps {k}/{n} entries ({share:.4f}); the teacher below keeps all")
    out["prefill_kept"] = share
    out["agreement"] = teacher_forced(nodrop, eng.params, reqs[5], dev, label)
    out["bytes"] = pytree_bytes(eng.params)
    out["floor_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3
    out["decode_step"] = decode_step_profile(eng, cfg, dev, f"{label} decode step",
                                             floor_ms=out["floor_ms"], moe_mod=moe_mod)
    return launches, out, eng


def twice_equal(model, params, label: str, prompts, max_new: int, **kw) -> None:
    """Two identical runs on fresh engines give equal greedy streams (the
    deterministic combine: no atomics in the expert sums)."""
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    runs = []
    for _ in range(2):
        eng = ServeEngine(model, params, batch_slots=4, max_len=S_MAX, prefill_budget=64, **kw)
        reqs = [Request(rid=i, prompt=p_, params=SamplingParams(max_new=max_new))
                for i, p_ in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append([list(r.generated) for r in reqs])
        del eng
    if runs[0] != runs[1]:
        diff = [i for i, (a, b) in enumerate(zip(*runs)) if a != b]
        raise AssertionError(f"{label}: two identical runs differ at requests {diff}")
    print(f"  {label}: two identical runs of {len(prompts)} requests x {max_new} tokens give "
          "equal streams")


def full_width_moe(dev, counters, smi: str) -> tuple[dict, dict]:
    """Phase 13: the mixture-of-experts family at full width on phase 4's
    traffic. (a) deepseek-v2-lite-16b (27 layers, the first dense at ff
    10944, 64 routed experts top-6 + 2 shared at ff 1408, MLA 512 + 64 x 16
    heads, bf16, ~31.4 GB of random weights from a seed; nothing cut): every
    pack on the latent-MQA kernel (launches == MLA packed calls); (b)
    llama4-scout-17b-a16e at 4 of its 48 layers (the only cut: 48 layers are
    ~108 B parameters, more than one card holds at bf16 or int8), every
    width full (d 5120, 40 heads over 8 KV heads: G 5, D 128, 16 experts
    top-1 at capacity factor 1.5, 1 shared, vocab 202,048), bf16: decode,
    ragged and flash kernels at G 5; (c) (b)'s weights quantized to int8 on
    the card (the attention projections and the shared expert on
    matmul_q8, the expert stacks read through qweight). Each model is freed
    before the next loads. Returns ({case: its launches}, readings)."""
    import torch

    from repro_torch.common import pytree_bytes
    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.models import moe as moe_mod

    def floor(nb: int) -> float:
        return nb / HBM_BYTES_PER_S * 1e3

    out = {}
    # ---- (a) deepseek-v2-lite-16b, whole
    cfg = get_arch("deepseek-v2-lite-16b")
    m = cfg.moe
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nb = pytree_bytes(params)
    print(f"  (a) {cfg.name} [{smi}]: {cfg.n_layers} layers ({cfg.first_k_dense} dense at ff "
          f"{cfg.dense_ff}), d_model {cfg.d_model}, {m.n_routed} routed experts top-{m.top_k} + "
          f"{m.n_shared} shared at ff {m.expert_ff}, MLA latent {cfg.mla.kv_lora_rank} + rope "
          f"{cfg.mla.rope_head_dim} x {cfg.n_heads} heads, {cfg.dtype}: "
          f"{cfg.num_params() / 1e9:.3f}B params ({cfg.num_active_params() / 1e9:.3f}B active a "
          f"token), {nb} bytes ({nb / 1e9:.2f} GB), init {time.perf_counter() - t0:.1f} s; "
          "nothing cut")
    print(f"  (a) weight-read floor of a decode step: the dense [E, C] dispatch reads every "
          f"expert, so every weight once: {nb / 1e9:.2f} GB -> {floor(nb):.2f} ms at 3.35 TB/s")
    la, a, eng = moe_serve(dev, model, params, counters, "(a)",
                           ["mla_attention", "mla_attention_wgmma"], moe_mod, smi)
    calls = a["mla_packed_calls"]
    print(f"  (a) {la['mla_attention']} latent-MQA launches, {la['mla_attention_wgmma']} on the "
          f"wgmma body, for {calls} MLA packed-attention calls")
    if not la["mla_attention"] == la["mla_attention_wgmma"] == calls:
        raise AssertionError(f"(a): {la['mla_attention']} latent-MQA launches for {calls} MLA "
                             "packed-attention calls")
    a["pack_vs_plain"] = pack_vs_plain(model, params, eng.cache, dev, "(a)", moe_mod)
    del eng
    prompts = phase4_prompts(cfg)
    twice_equal(model, params, "(a)", [prompts[i] for i in (0, 2, 3, 6)], 16)
    a.update(params=cfg.num_params())
    out["a"] = a
    del model, params
    torch.cuda.empty_cache()

    # ---- (b) llama4-scout-17b-a16e at 4 of 48 layers, bf16
    full = get_arch("llama4-scout-17b-a16e")
    cfg = replace(full, n_layers=4)
    m = cfg.moe
    model = LM(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    nb = pytree_bytes(params)
    print(f"  (b) {cfg.name} [{smi}]: REDUCED to {cfg.n_layers} of {full.n_layers} layers "
          f"(depth only: {full.num_params() / 1e9:.1f}B params at 48 layers do not fit one "
          f"card); every width full: d_model {cfg.d_model}, {cfg.n_heads} heads over "
          f"{cfg.n_kv_heads} KV heads (G {cfg.n_heads // cfg.n_kv_heads}, D {cfg.head_dim}), "
          f"{m.n_routed} routed experts top-{m.top_k} (capacity factor {m.capacity_factor}) + "
          f"{m.n_shared} shared at ff {m.expert_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{cfg.num_params() / 1e9:.3f}B params, {nb} bytes ({nb / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.1f} s; weight-read floor {floor(nb):.2f} ms")
    expect = ["decode_attention", "ragged_attention", "gqa_flash_attention",
              "decode_attention_split", "ragged_attention_split"]
    ragged0 = ragged_counts()
    lb, b, eng = moe_serve(dev, model, params, counters, "(b)", expect, moe_mod, smi)
    ragged_all_split(ragged0, "phase 13 (b)")
    b["pack_vs_plain"] = pack_vs_plain(model, params, eng.cache, dev, "(b)", moe_mod)
    del eng
    twice_equal(model, params, "(b)", phase4_prompts(cfg), 32)
    b.update(params=cfg.num_params(), layers=cfg.n_layers, layers_full=full.n_layers)
    out["b"] = b

    # ---- (c) (b)'s weights quantized to int8 on the card
    q_expect = expect + ["matmul_q8", "matmul_q8_gemv_tc", "matmul_q8_rows"]
    lc, c, eng = moe_serve(dev, model, params, counters, "(c)", q_expect, moe_mod, smi,
                           weight_dtype="int8")
    print(f"  (c) int8 weights [{smi}]: {c['bytes']} bytes resident for the quantized model "
          f"({c['bytes'] / nb:.3f} of bf16: the embeddings and head stay bf16)")
    c["vs_bf16"] = top1_vs_dense(model, params, eng.params, np.concatenate(
        [phase4_prompts(cfg)[5], np.asarray(b["streams"][5], np.int32)]), dev)
    out["c"] = c
    del eng, model, params
    torch.cuda.empty_cache()
    for case in out.values():
        case.pop("streams", None)
    launches = {"a": la, "b": lb, "c": lc}
    print(f"  launches during phase 13: {launches}")
    return launches, out


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
    from repro_torch.kernels import mla_attention as mk
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
    timed.update(check_mla_kernels(dev))
    check_attention_domain(dev)
    check_paged_split(dev)
    check_verify_packs(dev)

    phase("3 kernel path vs plain path, end to end, f32")
    small_model_streams(dev)
    sampled_streams(dev)
    cluster_streams(dev)

    phase("4 full width codeqwen1.5-7b")
    counters4 = {"decode_attention": (dk, "launches"), "ragged_attention": (rk, "launches"),
                 "gqa_flash_attention": (fk, "launches"),
                 "decode_attention_split": (dk, "launches_split"),
                 "ragged_attention_split": (rk, "launches_split")}
    launches, model, params, phase4_streams = full_width(dev, counters4)

    phase("5 full width, paged + prefix and quantized KV")
    counters5 = {"paged_attention": (pk, "launches"), "paged_attention_q8": (pk, "launches_q8"),
                 "paged_attention_split_decode": (pk, "launches_split_decode"),
                 "paged_attention_split_pack": (pk, "launches_split_pack"),
                 "decode_attention_q8": (dk, "launches_q8"),
                 "ragged_attention_q8": (rk, "launches_q8"),
                 "decode_attention_q8_split": (dk, "launches_split"),
                 "ragged_attention_q8_split": (rk, "launches_split")}
    launches5, serving = paged_and_quantized(dev, model, params, counters5)
    launches.update(launches5)

    phase("6 full width, int8 weights")
    # one name for the split decode body's count (phase 4's), whichever store runs it
    counters6 = {"matmul_q8": (mmk, "launches_q8"), "matmul": (mmk, "launches"),
                 "matmul_q8_gemv_tc": (mmk, "launches_gemv_tc"),
                 "matmul_q8_rows": (mmk, "launches_gemv_tc_rows"),
                 "matmul_q8_mma_pipe": (mmk, "launches_mma_pipe"), **counters4,
                 **{k: v for k, v in counters5.items()
                    if k not in ("decode_attention_q8_split", "ragged_attention_q8_split")}}
    launches6, serving6 = int8_weights(dev, model, params, counters6,
                                       serving["b"]["num_blocks"])
    # no serving path calls matmul (the dense projections are torch.matmul, as
    # the JAX package's are XLA's): its launches are phase 7's
    launches.update(matmul_q8=launches6["matmul_q8"],
                    matmul_q8_gemv_tc=launches6["matmul_q8_gemv_tc"],
                    matmul_q8_rows=launches6["matmul_q8_rows"],
                    matmul_q8_mma_pipe=launches6["matmul_q8_mma_pipe"])
    serving["int8_weights"] = serving6
    print(json.dumps({"serving": serving}))

    phase("10 full width, sampled and speculated serving (phase 4's weights)")
    sampling = full_width_sampling(dev, model, params)
    print(json.dumps({"sampling": sampling}, default=float))

    phase("12 full width, the split/merge serving cluster (phase 4's weights)")
    counters12 = {"decode_attention": (dk, "launches"), "ragged_attention": (rk, "launches"),
                  "gqa_flash_attention": (fk, "launches")}
    cluster = full_width_cluster(dev, model, params, phase4_streams, counters12)
    print(json.dumps({"cluster": cluster}, default=float))

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
    torch.cuda.empty_cache()

    phase("9 full width minicpm3-4b (multi-head latent attention)")
    counters9 = {"mla_attention": (mk, "launches"),
                 "mla_attention_wgmma": (mk, "launches_wgmma")}
    launches.update(full_width_mla(dev, counters9))

    phase("13 full width MoE: deepseek-v2-lite-16b, llama4-scout-17b-a16e at 4 of 48 layers")
    torch.cuda.empty_cache()
    counters13 = {"mla_attention": (mk, "launches"),
                  "mla_attention_wgmma": (mk, "launches_wgmma"), **counters4,
                  **{k: v for k, v in counters6.items() if k.startswith("matmul_q8")}}
    moe_launches, moe = full_width_moe(dev, counters13, smi)
    print(json.dumps({"moe": moe}, default=float))

    phase("11 the kernel table")
    # the pl.pallas_call line of each TPU kernel, as in PERF.md's kernel table
    sources = {
        "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:186"),
        "ragged_attention": ("ragged_attention.cu", "src/repro/kernels/ragged_attention.py:253"),
        # the same TPU kernel as latent MQA (src/repro/kernels/ops.py:392)
        "mla_attention": ("mla_attention.cu", "src/repro/kernels/ragged_attention.py:253"),
        "gqa_flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:197"),
        "paged_attention": ("paged_attention.cu", "src/repro/kernels/ragged_attention.py:342"),
        "paged_attention_q8": ("paged_attention.cu", "src/repro/kernels/ragged_attention.py:342"),
        "paged_attention_pack": ("paged_attention.cu",
                                 "src/repro/kernels/ragged_attention.py:342"),
        "paged_attention_q8_pack": ("paged_attention.cu",
                                    "src/repro/kernels/ragged_attention.py:342"),
        "decode_attention_q8": ("decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:186"),
        "ragged_attention_q8": ("ragged_attention.cu",
                                "src/repro/kernels/ragged_attention.py:253"),
        "matmul_q8": ("matmul.cu", "src/repro/kernels/matmul.py:100"),
        "matmul_q8_rows": ("matmul.cu", "src/repro/kernels/matmul.py:100"),
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
            "paged_attention_q8": 6, "paged_attention_pack": 6, "paged_attention_q8_pack": 6,
            "flash_attention": 7, "matmul": 8, "matmul_tile": 8, "matmul_q8": 9,
            "matmul_q8_rows": 9,
            "rmsnorm": 10, "softmax": 11, "axpy": 12, "dotp": 13, "fft": 14, "fft_long": 14,
            "conv2d": 15, "mla_attention": 16}
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
        if name in ("decode_attention", "decode_attention_q8", "ragged_attention",
                    "ragged_attention_q8"):
            kernels[-1]["body"] = "split"
            kernels[-1]["launches_split"] = launches[f"{name}_split"]
        if name in ("matmul_q8", "matmul"):  # the timed case: M = 4
            kernels[-1]["body"] = "gemv_tc"
            kernels[-1]["launches_gemv_tc"] = launches[f"{name}_gemv_tc"]
        if name == "matmul_q8":  # of its serving launches, those above 8 rows
            kernels[-1]["launches_gemv_tc_rows"] = launches["matmul_q8_rows"]
            kernels[-1]["launches_mma_pipe"] = launches["matmul_q8_mma_pipe"]
        if name == "matmul_q8_rows":  # the timed case: M = 16, on the multi-row GEMV
            kernels[-1]["body"] = t["body"]
        if name in ("paged_attention", "paged_attention_q8"):  # the timed case: a decode
            kernels[-1]["body"] = "split"
            kernels[-1]["launches_split_decode"] = launches[f"{name}_decode"]
            kernels[-1]["launches_split_pack"] = launches[f"{name}_pack"]
        if name in ("paged_attention_pack", "paged_attention_q8_pack"):  # a 64-token pack
            kernels[-1]["body"] = "split"
        if name == "matmul_tile":
            kernels[-1]["body"] = "wgmma"
        # phase 10's launches on the speculative paths (not in "launches")
        if name == "ragged_attention":
            kernels[-1]["launches_verify"] = sampling["launches"]["ragged_verify"]
            kernels[-1]["launches_draft_catchup"] = sampling["launches"]["ragged_draft_catchup"]
        if name == "paged_attention_pack":
            kernels[-1]["launches_verify"] = sampling["launches"]["paged_verify"]
        if name == "decode_attention":
            kernels[-1]["launches_draft_roll"] = sampling["launches"]["decode_draft_roll"]
        if name == "mla_attention":  # the timed case: minicpm3-4b's widths, phase 2's pack
            kernels[-1]["body"] = "wgmma"
            kernels[-1]["launches_wgmma"] = launches["mla_attention_wgmma"]
            kernels[-1]["launched_in"] = "phase 9: full-width minicpm3-4b serving"
        # phase 13's launches on the MoE path (not in "launches"): (a)
        # deepseek-v2-lite on the latent-MQA kernel, (b) + (c) llama4-scout's
        # GQA routes, (c) its int8 weights
        moe_rows = {"mla_attention": ("a",), "decode_attention": ("b", "c"),
                    "ragged_attention": ("b", "c"), "gqa_flash_attention": ("b", "c"),
                    "matmul_q8": ("c",)}
        if name in moe_rows:
            kernels[-1]["launches_moe"] = sum(moe_launches[c][name] for c in moe_rows[name])
    print(json.dumps({"kernels": kernels, "to_port": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
