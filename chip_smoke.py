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
   int8 stores; decode attention (B 4 x 1024, KV 32) and GQA flash attention
   (BKV 32, S 512 timed; S 37, 300 and 700, tails of the tile, held) at
   zamba2-2.7b's shared-block width, D 80, G 1, bf16; and decode, ragged,
   flash and paged (decode and pack) at one lane's shard of phase 12 (b)'s
   merged engine, 16 KV heads.
   Times each kernel, its plain version and
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
   switch and the warm switch back, split with the n-gram drafter, and
   merge over [cuda:0, cuda:0] (one tensor-parallel engine over two lanes),
   dense and paged with prefix reuse: every stream must equal the CPU single
   engine's; then ``repro_torch.launch.serve`` in merge mode over
   ``--devices cuda:0,cuda:0`` (8 requests). Then the state-space
   families: reduced falcon-mamba-7b (Mamba1, packs one slot wide, no
   attention kernel), reduced zamba2-2.7b (Mamba2 + the shared attention
   block, on the legacy tier: flash and decode kernels) and reduced
   codeqwen1.5-7b with ``unified=False``; every stream must equal the CPU's.
4. full width — codeqwen1.5-7b, 32 layers, bf16, random weights from a seed,
   4 slots x 1024 positions; about 12 greedy requests whose prompts straddle
   the prefill budget, so fused admissions, ragged packs and decode chunks
   all run; each PR-11 kernel's launch count over this run must be > 0,
   and decode and every ragged launch must have run the split body.
   Phases 4, 5, 6, 9, 13 and 14 serve ``SERVE_NEW`` (16) new tokens a
   request.
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
   repetitive (8 of its 12 lengths, the 700 among them, 16 new tokens),
   4 slots x 1024
   positions: (a) two each of greedy,
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
   traffic (its 8 shared-prefix prompts and 2 unshared ones) with the
   n-gram drafter, every verify dispatch on the paged kernel. Prints tok/s,
   TTFT, TPOT and the acceptance of each run.
12. (run after phase 10, on phase 4's weights) full width, the split/merge
   serving cluster — the perfmodel's host constants measured (host time a
   launch over 2,000 empty launches; a two-thread barrier + synchronize);
   8 of phase 4's 12 prompts, tenants a / b, two seeded at temperature 0.8,
   16 new tokens, 4 slots x 1024 a replica: a single engine, then (a) split over
   [cuda:0, cuda:0] (two controller threads, two streams, one copy of the
   weights) and a steady decode step of one replica and of both at once
   profiled (the union of kernel time over both streams), (b) [cuda:0,
   cuda:0] switching SPLIT (two replicas) -> MERGE (one tensor-parallel
   engine over two lanes of the card, 16 KV heads a lane) once half the
   requests have arrived, then back and forth warm: decode, ragged and
   flash must launch on both lanes, one decode step's logits of the merged
   engine stay within ``MERGED_REL_TOL`` of the single engine's, and the
   merged decode step is profiled (wall, device, launches, the lane
   collectives' device ms); bytes placed and switch seconds printed; then
   the merged weights behind a paged pool with prefix reuse serve 4 of the
   prompts, the paged kernel on both lanes, (c) ``run_controlled`` under
   ``ReconfigController.for_cluster`` over 4 prompts of 600-700 tokens then
   12 of 5-40 (decisions printed, not gated; it may commit MERGE over the
   two lanes), (d) two replicas with replica
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
   identical runs of (a) and of (b) (4 requests x 16 tokens) must give
   equal streams.
14. (run after phase 13) full width, the state-space families whole on
   phase 4's traffic, each model freed before the next: (a)
   falcon-mamba-7b (64 Mamba1 layers, d 4096, d_inner 8192, N 16, ~14 GB
   bf16 of random weights from a seed) on the unified engine, packs one slot
   wide, every admission on the pack tier: no attention kernel may launch;
   (b) zamba2-2.7b (54 Mamba2 layers, d 2560, 80 SSM heads x 64, N 64, the
   weight-tied attention + MLP block at 32 heads x D 80 after every 6th
   layer, ~4.7 GB) on the legacy tier: each admission's exact-length
   prefill on the flash kernel, every decode launch on the split decode
   body, no ragged launch. Each prints parameters, bytes, the decode
   step's weight-read floor (zamba2: the shared block read 9 times), tok/s,
   TTFT, TPOT, a decode step's wall against device time; each stream must
   agree with ``LM.prefill`` teacher-forced, and two identical runs of 4
   requests x 16 tokens give equal streams.
15. (run after phase 14) the paper's split/merge fabric over lanes of one
   card (``core/``, ``dist/{sharding,collectives}.py``; a lane is a device
   and a stream of its own): (a) ``SpatzformerCluster`` views over 2 and 4
   lanes and ``surviving_cluster(0)``; (b) the sync harness at [4096, 4096]
   over 2 lanes, 4 rounds — fft2d (torch.fft), fft2d through the
   hand-written FFT (``ops.fft``) and the f32 matmul chain — ``run_merged``
   (the corner turn on the device) against ``run_split_staged`` (through the
   host), each held against a plain on-device oracle, best seconds and
   SM/MM, and a profile of the merged program with no device-to-host copy
   or host sync; (c) ``MixedScheduler`` over 2 lanes: 8 x each of matmul,
   conv2d, fft, dotp, axpy and softmax through ``ops`` (phase 8's shapes,
   matmul bf16 4096^3, softmax [32768, 4096] bf16; each task's rows over
   its view's lanes, the two-lane outputs held against the one-lane ones)
   beside coremark at 20, 100 and 400 iterations: MERGE, SPLIT with scalar
   work, SPLIT vector-only; makespans, lane times, SM/MM; every one of the
   six kernels must launch; (d) ``switch_mode`` SPLIT -> MERGE -> SPLIT five
   times with a ~2 GB param tree (codeqwen1.5-7b at 1 of 32 layers) over 4
   lanes in pods of (data 1, model 2), values bit-equal after every switch,
   median latency, ``bytes_moved``, GB/s and the bytes copied between
   lanes; (e) ``ring_rs_matmul`` / ``ring_ag_matmul`` over 2 and 4 lanes at
   M = K = N = 4096 f32 against ``torch.matmul``.
16. (run after phase 15) training on the card (``LM.forward``, ``train/``,
   ``data/``, ``ckpt/``, ``launch/train.py``, the int8 ring over lanes): (a)
   codeqwen1.5-7b at full width and 4 of its 32 layers (1.69 B params), bf16,
   remat per block, chunked attention at 512, batch 2 x 2048 from the
   corpus, the same batch every step: 2 warm steps, 6 timed at grad_accum 1
   (wall, tok/s, model TFLOP/s), peak memory, one step profiled (device
   busy and idle share, kernel time by kind; raises on no device event),
   forward + backward against the update on CUDA events, 2 steps at
   grad_accum 2; the loss must be finite and fall; (b) one f32 step of
   reduced codeqwen1.5-7b and deepseek-v2-lite-16b (MoE aux) on the card
   against the CPU from one init (loss, aux, lr, grad_norm, params:
   ``params_close``); (c) an async save at step 3 while step 4 runs (reduced
   codeqwen1.5-7b widened to ~180 MB of state; fails unless the writer is
   still busy when step 4 ends), a restore into fresh state, the resumed
   losses against the straight run's;
   (d) ``python -m repro_torch.launch.train --reduced`` for 12 steps, then
   ``--resume`` to 16, each exiting 0; (e) three compressed-DP steps over
   [cuda:0, cuda:0] against two CPU lanes; (f) (a)'s model, params and
   batch over four lanes of cuda:0 (``SpatzformerCluster(n_pods=1,
   devices=[cuda:0] * 4).pod_info(0)``: data 2 x model 2): the first
   step's loss against one lane's forward loss on the same params and batch
   (bf16, ``TRAIN_LANES_LOSS_TOL``) and its grad norm against one lane's
   (``TRAIN_LANES_GNORM_TOL``), 1 warm step and 5 timed (median wall,
   tok/s), peak memory (of the warm step, which places the one-lane state,
   and of the timed steps), one step profiled (busy time as the union of kernel
   intervals over the lanes' streams, idle share, kernels a step, the lane
   collectives' device ms: forward spans, their autograd backward and the
   grad reduction), the loss finite and falling over the 6 steps, every
   replica of every block bitwise equal; (g) reduced codeqwen1.5-7b widened
   to ``CKPT_WIDTHS`` (f32, every matmul leaf sharded) over the same four
   lanes against one lane for 3 steps at grad_accum 1 and 2 (metrics,
   ``params_close``, replicas equal), ``launch.train`` over four lanes of
   the card in-process and ``--resume``, then each ``examples/torch_*.py``'s
   ``main(argv)`` at a tiny size on the card. No hand-written kernel may
   launch in (a)-(g)'s training (every wrapper's counts stay 0); the
   examples serve, and their launches are printed.
17. (run after phase 16) embeds, the windowed prefill and the dry run:
   (a) musicgen-large whole (48 layers, d 2048, bf16) on one lane: a
   prefill of 512 positions and 16 decode steps on the embedding rows of a
   token stream, bitwise the token path's (the flash and decode kernels'
   launches read between the counts' reset and read), the same over
   [cuda:0, cuda:0] on the merged view within ``MERGED_REL_TOL`` of one
   lane, and seeded random embeds through the prefill against
   ``LM.forward``; (b) codeqwen1.5-7b at 4 layers with a sliding window of
   1024, S 4096: the prefill's logits and cache bitwise ``LM.forward``'s and
   each layer's projected (k, v), no flash launch; (c) the dry run on the
   production 16 x 16 mesh of placeholder lanes: codeqwen1.5-7b
   ``prefill_32k`` / ``decode_32k`` and musicgen-large ``decode_32k`` ok,
   qwen3-32b ``decode_32k`` refused naming ROADMAP Queue 1 item 7, each
   record printed; (d) the dry run on one placeholder lane against the card
   for phase 16 (a)'s train step and a forward of 1 x 8192 (codeqwen1.5-7b
   at 4 layers): argument bytes equal, counted FLOPs equal to
   ``FlopCounterMode`` on the card, the peak within ``DRYRUN_PEAK_TOL`` of
   ``max_memory_allocated``; (e) ZeRO-1 and ZeRO-3 over four lanes of the
   card (TP off) against the replicated step, codeqwen1.5-7b at
   ``ZERO_LAYERS`` layer, 2 steps, and ZeRO-3 again with the root lane's
   stream held back before each lane reduce (``root_held_back``): losses
   and params bitwise, ms a step.
11. a ``{"kernels": [...], "to_port": []}`` JSON line (every row of PERF.md's
   kernel table; the decode, ragged, paged, matmul and matmul_q8 rows name the body
   their timed case ran and its launches; paged packs and matmul_q8 at M = 16
   have entries of their own; the ragged row adds phase 10's verify and draft
   catch-up launches, the paged pack row its paged verify launches, the
   decode row the draft's roll launches; the decode, ragged, flash,
   matmul_q8 and latent-MQA rows phase 13's launches as ``launches_moe``;
   the decode and flash rows phase 14 (b)'s launches as ``launches_hybrid``
   and their phase 2 readings at zamba2's shapes as ``zamba2_shape``; the
   matmul, softmax, axpy, dotp, fft and conv2d rows phase 15 (c)'s
   launches as ``launches_fabric``; the decode, ragged, flash and paged rows
   phase 12 (b)'s merged launches on each lane as ``launches_merged`` and
   their phase 2 readings at a lane's shard as ``lane_shape``; the decode
   and flash rows phase 17 (a)'s launches as ``launches_embeds``), then the
   result line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
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
# one lane's KV heads in the merged engine over two lanes of one card (phase
# 12 (b)): codeqwen1.5-7b's 32 over 2; phase 2 times rows 1-3 and 6 there too
LANE_KV = 16
# teacher-forced top-1 agreement floor of phases 4 and 5: a random-weight
# bf16 model over a 92k vocab has top-2 logit gaps of ~0.2 while bf16 logits
# near 4 are spaced 0.03 apart, so near-ties flip between two matmul/attention
# orders; an int8 or fp8 KV cache adds a relative row error of ~0.4% (int8)
# to ~6% (fp8) to every key and value, which flips more near-ties. A wrong
# kernel (wrong rows, wrong scales, wrong table) agrees on ~1/92416 of the
# positions, so 0.5 still separates right from wrong with a wide margin
AGREE_FLOOR = 0.5
# new tokens a request in phases 4, 5, 6, 9, 13 and 14, cut to keep the
# whole script inside its time
SERVE_NEW = 16
# decode steps a profile of decode_step_profile spans (its wall: a chunk of
# 8 steps); the profiler's parse of each step's ~2,500-7,100 launches takes
# host time the whole script has to spare
PROFILE_STEPS = 1
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

    results, sub = {}, {"zamba2": {}, "lane": {}}

    def report(name, case, dtype, err, timed=None, tag="main"):
        tol = TOL[str(dtype).split(".")[-1]]
        print(f"  {name:20s} {case:44s} max_abs_err={err:.3e} tol={tol:g}", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} {case}: max_abs_err {err} above {tol}")
        if timed is not None:
            print(f"  {'':20s} {tag}: ms={timed['ms']:.4f} plain={timed['plain_ms']:.4f} "
                  f"SDPA={timed['library_ms']:.4f} bound={timed['bound_ms']:.5f} "
                  f"({timed['bound_by']})", flush=True)
            if tag == "main":
                results[name] = dict(timed, max_abs_err=err, tol=tol)
            else:
                sub[tag][name] = dict(timed, shape=case, max_abs_err=err, tol=tol)

    bf16, f32 = torch.bfloat16, torch.float32
    B, S, cur = SLOTS, S_MAX, DECODE_POS

    # ---- decode attention; tag "main" is the row's timed case, "zamba2"
    # zamba2-2.7b's shared block (32 heads = KV heads at D 80, G 1), timed
    # as a sub-row of its own, and "lane" one lane's shard of the merged
    # engine over two lanes (16 of codeqwen's 32 KV heads)
    for kv, g, d, dtype, window, tag in [
        (32, 1, 128, bf16, 0, "main"), (32, 1, 128, f32, 0, None), (8, 8, 128, bf16, 0, None),
        (8, 8, 128, f32, 0, None), (32, 1, 128, bf16, 100, None), (8, 8, 128, f32, 37, None),
        (32, 1, 80, bf16, 0, "zamba2"), (LANE_KV, 1, 128, bf16, 0, "lane"),
    ]:
        main = tag == "main"
        q, k, v = randn(B, kv, g, d, dtype=dtype), randn(B, S, kv, d, dtype=dtype), \
            randn(B, S, kv, d, dtype=dtype)
        cl = torch.tensor(cur, dtype=torch.int32, device=dev)
        got = dk.decode_attention(q, k, v, cl, window=window)
        want = ref.decode_attention(q, k, v, cl, window=window)
        err = (got.float() - want.float()).abs().max().item()
        timed = None
        if tag:
            n_valid = [min(c, S - 1) + 1 for c in cur]
            by = nbytes(q, q, cl) + sum(n_valid) * kv * d * 2 * k.element_size()
            fl = sum(n_valid) * kv * g * d * 4
            qs = q  # [B, KV, G, d]: G queries per KV head
            ks, vs = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
            mask = (torch.arange(S, device=dev)[None, :] <= cl[:, None])[:, None, None, :]
            timed = dict(
                ms=time_ms(lambda: dk.decode_attention(q, k, v, cl)),
                plain_ms=time_ms(lambda: ref.decode_attention(q, k, v, cl)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)),
            )
            timed["bound_ms"], timed["bound_by"] = bound(by, fl, dtype)
        report("decode_attention", f"B={B} S={S} KV={kv} G={g} d={d} {dtype} win={window}",
               dtype, err, timed, tag)
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

    for kv, g, dname, window in RAGGED_CASES + [(LANE_KV, 1, "bfloat16", 0)]:
        dtype, main = getattr(torch, dname), (kv, g, dname, window) == RAGGED_CASES[0]
        tag = "main" if main else "lane" if kv == LANE_KV else None
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
        if tag:
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
        report("ragged_attention", f"T={T} S={S} KV={kv} G={g} {dtype} win={window}", dtype, err,
               timed, tag or "main")
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

    # ---- GQA flash attention (prefill): B*KV rows, G heads per row. zamba2's
    # admissions prefill at each prompt's exact length (phase 4's 5-700
    # tokens) at D 80: timed at 512, held at tails of the 64-row tile too
    for bkv, g, s, d, dtype, tag in [
        (32, 1, 64, 128, bf16, "main"), (32, 1, 37, 128, bf16, None),
        (32, 1, 64, 128, f32, None), (8, 8, 64, 128, bf16, None), (8, 8, 37, 128, f32, None),
        (32, 1, 512, 80, bf16, "zamba2"), (32, 1, 37, 80, bf16, None),
        (32, 1, 300, 80, bf16, None), (32, 1, 700, 80, bf16, None),
        (LANE_KV, 1, 64, 128, bf16, "lane"),
    ]:
        q, k, v = randn(bkv, g, s, d, dtype=dtype), randn(bkv, s, d, dtype=dtype), \
            randn(bkv, s, d, dtype=dtype)
        got = fk.gqa_flash_attention(q, k, v)
        want = ref.gqa_flash_attention(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        timed = None
        if tag:
            fl = bkv * g * d * 4 * sum(i + 1 for i in range(s))
            k4, v4 = k[:, None], v[:, None]  # [BKV, 1, S, d]: G = 1 query head per row
            timed = dict(
                ms=time_ms(lambda: fk.gqa_flash_attention(q, k, v)),
                plain_ms=time_ms(lambda: ref.gqa_flash_attention(q, k, v)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k4, v4, is_causal=True)),
            )
            timed["bound_ms"], timed["bound_by"] = bound(nbytes(q, k, v, q), fl, dtype)
        report("gqa_flash_attention", f"BKV={bkv} G={g} S={s} d={d} {dtype}", dtype, err, timed,
               tag)

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
    results.update(sub)
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
            (LANE_KV, 1, 32, bf16, 0, "decode", "paged_attention_lane"),
            (LANE_KV, 1, 32, bf16, 0, "pack", "paged_attention_pack_lane"),
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

    # the state-space families, f32: reduced falcon-mamba-7b (Mamba1 on the
    # unified engine, packs one slot wide: no attention kernel), reduced
    # zamba2-2.7b (Mamba2 + the shared attention block at d_head 16, G 1, on
    # the legacy tier: admissions on the flash kernel, decode on the decode
    # kernel) and reduced codeqwen1.5-7b on the legacy tier (unified=False)
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ragged_attention as rk

    for name, kw in (("falcon-mamba-7b", {}), ("zamba2-2.7b", {}),
                     ("codeqwen1.5-7b", dict(unified=False))):
        rcfg = get_arch(name).reduced()
        r_cpu = LM(rcfg, device="cpu")
        r_params = r_cpu.init(torch.Generator().manual_seed(0))
        r_dev, r_params_dev = LM(rcfg, device=dev), _tree_to(r_params, dev)
        reqs = [p_ % rcfg.vocab_size for p_ in prompts]
        on_cpu, _ = serve(r_cpu, r_params, "cpu", reqs, kw)
        n0 = (dk.launches, fk.launches, rk.launches)
        on_dev, _ = serve(r_dev, r_params_dev, dev, reqs, kw)
        n_dec, n_flash, n_rag = (a - b for a, b in zip((dk.launches, fk.launches, rk.launches),
                                                       n0))
        attention = rcfg.family != "ssm"
        if on_dev != on_cpu:
            diff = [rid for rid in on_cpu if on_cpu[rid] != on_dev.get(rid)]
            raise AssertionError(f"{name} reduced ({kw or 'default tier'}): streams differ for "
                                 f"rids {diff}")
        if n_rag or (n_dec > 0) != attention or (n_flash > 0) != attention:
            raise AssertionError(f"{name} reduced: {n_dec} decode, {n_flash} flash, {n_rag} "
                                 "ragged launches")
        tier = "unified, packs one slot wide" if rcfg.family == "ssm" else "legacy tier"
        print(f"  {name} reduced ({rcfg.family}, {tier}): {len(on_cpu)} greedy streams "
              f"identical on the card and the CPU (plain); {n_dec} decode, {n_flash} flash, "
              f"{n_rag} ragged launches", flush=True)


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
    SPLIT -> MERGE switch and the warm switch back, split with the n-gram
    drafter, and merge over [cuda:0, cuda:0] — one tensor-parallel engine
    over two lanes — dense and paged with prefix reuse. Every stream must
    equal the CPU single engine's (the cancelled one a prefix of its own).
    Then ``repro_torch.launch.serve.main`` once: ``--reduced --cluster-mode
    merge --devices cuda:0,cuda:0``, 8 requests."""
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
    # tensor-parallel merge over two lanes of the card: heads, MLP width and
    # vocabulary split, dense and paged with prefix reuse
    for lane, extra in (("merge over [cuda:0, cuda:0] (two lanes)", {}),
                        ("merge over [cuda:0, cuda:0], paged + prefix",
                         dict(kv_block_size=8, prefix_cache=True))):
        cl = ServeCluster(r_dev, r_params_dev, mode=Mode.MERGE, devices=[dev, dev], **kw, **extra)
        back = cl.engines[0].backend
        if back.describe() != "sharded:model=2,devices=2" or (
                dev.type == "cuda" and len({ln.stream for ln in back.lanes}) != 2):
            raise AssertionError(f"cluster, {lane}: not two lanes of their own ({back.describe()})")
        cl.prewarm(sampling=True)
        for r in reqs():
            cl.submit(r)
        check(lane, cl, cl.run())
    # the serving launcher, merge over two lanes of the card
    from repro_torch.launch import serve as launch

    target = launch.main(["--arch", "codeqwen1.5-7b", "--reduced", "--cluster-mode", "merge",
                          "--devices", f"{dev},{dev}", "--requests", "8", "--max-new", "8"])
    done = [r for r in target.finished if r.finish_reason == "length" and len(r.generated) == 8]
    if target.engines[0].backend.describe() != "sharded:model=2,devices=2" or len(done) != 8:
        raise AssertionError(f"launch.serve merge: {len(done)} of 8 requests finished, over "
                             f"{target.engines[0].backend.describe()}")


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
    max_new = SERVE_NEW
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
    max_new, bs = SERVE_NEW, 32
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
    max_new, bs = SERVE_NEW, 32
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
    max_new = SERVE_NEW
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
                        floor_ms=None, smode: int = 0, moe_mod=None, lanes=False) -> dict:
    """Where a decode step goes: wall time per step of an 8-step chunk over
    the engine's current slots (all slots decoding, or the live ones of a
    paged engine, through its block tables), the device's busy time per step
    from a profile of PROFILE_STEPS steps, and the kernels that take it. ``floor_ms`` is the
    step's weight-read floor (default: every bf16 parameter once); ``smode``
    the sampler variant each step draws with (the live slots' rows). With
    ``moe_mod`` (``models.moe``), the device time of the expert products
    (the ``aten::bmm`` calls inside ``moe._experts``) is read too; with
    ``lanes`` (a merged engine), the device time of the lane collectives
    (``dist.collectives``: the partial sums and the logits' gather on the
    controller lane) and the kernels' launches on each lane's stream."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import collectives

    if eng.paged:  # the live slots only: released rows read the scratch block
        active = torch.tensor([r is not None for r in eng.slot_req], dtype=torch.int32,
                              device=dev)
    else:
        active = torch.ones(eng.B, dtype=torch.int32, device=dev)
    btab = eng._flush_btab()
    sp = eng._slot_sampler([i for i, r in enumerate(eng.slot_req) if r is not None])[1]

    def chunk(n=steps):
        eng._tick_fn(eng._last_tok, eng._cur_len, active, n, btab, sp, smode)
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
    coll = {}
    if lanes:  # each collective inside a span of its own name
        for name in ("lane_reduce", "lane_gather", "lane_broadcast"):
            coll[name] = getattr(collectives, name)

            def spanned_coll(*a, _fn=coll[name], _name=name, **kw):
                with torch.profiler.record_function(f"lane.{_name}"):
                    return _fn(*a, **kw)

            setattr(collectives, name, spanned_coll)
    t_prof = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk(PROFILE_STEPS)
    finally:
        if experts is not None:
            moe_mod._experts = experts
        for name, fn in coll.items():
            setattr(collectives, name, fn)
    # kernel rows carry the device time; op rows repeat it as their children's
    # (the "moe.experts" span is a range on the device's timeline, not a kernel)
    kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and e.key != "moe.experts" and not e.key.startswith("lane.")]
    if not kernels:
        raise AssertionError(f"{label}: the profiler recorded no device event")
    busy_ms = sum(r[0] for r in kernels) / 1e3 / PROFILE_STEPS
    if floor_ms is None:
        floor_ms = cfg.num_params() * 2 / HBM_BYTES_PER_S * 1e3
    n_kernels = sum(r[1] for r in kernels) // PROFILE_STEPS
    print(f"  {label} ({int(active.sum())} slots decoding): wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms (idle share {1 - busy_ms / wall_ms:.2f}), "
          f"{n_kernels} kernels; weight-read floor {floor_ms:.2f} ms (profile of "
          f"{PROFILE_STEPS} steps read in {time.perf_counter() - t_prof:.1f} s)")
    for us, n, key in sorted(kernels, reverse=True)[:8]:
        print(f"    {us / 1e3 / PROFILE_STEPS:7.3f} ms/step  {n // PROFILE_STEPS:4d} "
              f"calls/step  {key[:80]}")
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
        out.update(expert_bmm_ms=bmm_us / 1e3 / PROFILE_STEPS, expert_bmms=n_bmm // PROFILE_STEPS)
        print(f"    the expert products: {out['expert_bmm_ms']:.3f} ms/step of device time in "
              f"{out['expert_bmms']} aten::bmm calls/step")
        if n_bmm == 0:
            raise AssertionError(f"{label}: no expert product in the profile")
    if lanes:
        # the ops called directly inside each collective's span: their device
        # time is the collective's (on one card a broadcast is an event only)
        per = {}
        for e in prof.events():
            up = e.cpu_parent
            if up is not None and up.name.startswith("lane.") and e.device_type != \
                    torch.autograd.DeviceType.CUDA:
                ms, n = per.get(up.name, (0.0, 0))
                per[up.name] = (ms + e.device_time_total / 1e3, n + 1)
        out["collectives_ms"] = {k: v[0] / PROFILE_STEPS for k, v in per.items()}
        out["collective_ops"] = {k: v[1] // PROFILE_STEPS for k, v in per.items()}
        print(f"    the lane collectives a step: "
              f"{sum(out['collectives_ms'].values()):.3f} ms of device time "
              f"{ {k: round(v, 4) for k, v in out['collectives_ms'].items()} } in "
              f"{out['collective_ops']} ops")
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
               and e.key != "moe.experts" and not e.key.startswith("lane.")]
    if not kernels:
        raise AssertionError(f"{label}: the profiler recorded no device event")
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
        if not n:
            raise AssertionError(f"fused_sample smode {sm}: the profiler recorded no device event")
        out[sm] = dict(ms=ms, kernels=n)
        print(f"  fused_sample smode {sm}, {b} x {v}: {ms:.4f} ms device, {n:g} kernels a call",
              flush=True)
    return out


# phase 10's traffic: 8 of phase 4's prompt lengths (the 513-, 65-, 48- and
# 12-token prompts left out; the 700 keeps verify and draft catch-up reaching
# the third 256-position span), 16 new tokens each
PHASE10_LENS = (5, 300, 37, 130, 64, 200, 700, 90)
PHASE10_NEW = 16


def full_width_sampling(dev, model, params) -> dict:
    """Phase 10: sampled and speculated serving at full width on phase 4's
    weights (4 slots x 1024, bf16), phase 4's prompt lengths made repetitive:
    (a) the mixed traffic of ``mixed_params`` (two each of greedy,
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
    max_new, boost = PHASE10_NEW, 1234
    prompts = repetitive_prompts(PHASE10_LENS, cfg.vocab_size, seed=10)
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
    print(f"  (a) the {len(run1) - len(kinds[0])} other streams bitwise equal run to run; "
          f"top-k 1 at temperature 1: "
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
    # the 8 shared-prefix prompts and 2 unshared ones (5 and 130 tokens)
    _, reqs_d, stats_d = drain(eng, "(d) paged + prefix, n-gram speculation",
                               prompts_=shared_prompts[:8] + [shared_prompts[8],
                                                              shared_prompts[10]],
                               params_=SamplingParams(max_new=max_new))
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


# phase 12's traffic: 8 of phase 4's prompts (the 700- and 513-token ones and
# two others left out), 16 new tokens each
CLUSTER_RIDS = (0, 2, 3, 4, 5, 6, 9, 10)
CLUSTER_NEW = 16


def cluster_traffic(cfg):
    """Phase 12's traffic: phase 4's prompts ``CLUSTER_RIDS`` under their
    rids, tenants a / b alternating, rids 4 and 10 seeded at temperature 0.8,
    the others greedy."""
    from repro_torch.serve import Request, SamplingParams

    prompts = phase4_prompts(cfg)
    return [Request(rid=i, prompt=prompts[i], tenant="ab"[i % 2], params=SamplingParams(
                max_new=CLUSTER_NEW,
                **(dict(temperature=0.8, seed=3000 + i) if i % 3 == 1 else {})))
            for i in CLUSTER_RIDS]


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


# phase 12 (b): one decode step's logits of the merged engine (two lanes,
# bf16) against the single engine's, max |diff| over the largest |logit|.
# Each lane rounds its partial attention and MLP products to bf16 before the
# sum (one more rounding a sublayer than one engine's matmul), and the
# residual carries those roundings through 64 sublayers: a few 2^-9 steps of
# a logit, far under 5% of the largest; a head or a block on the wrong lane
# moves the logits by their own scale
MERGED_REL_TOL = 0.05


def streams_counted(dev, counts: dict):
    """A context in which each call of the serving attention ops (decode,
    ragged, flash, paged) adds one to ``counts[(name, raw stream)]``: the
    stream the call was queued on, so a lane's launches read apart."""
    import contextlib

    import torch

    from repro_torch.kernels import ops

    names = {"decode_attention": "decode_attention", "ragged_attention": "ragged_attention",
             "gqa_flash_attention": "gqa_flash_attention",
             "paged_decode_attention": "paged_attention",
             "paged_ragged_attention": "paged_attention"}

    @contextlib.contextmanager
    def scope():
        saved = {a: getattr(ops, a) for a in names}

        def wrap(attr):
            def call(*a, **kw):
                key = (names[attr], torch.cuda.current_stream(dev).cuda_stream)
                counts[key] = counts.get(key, 0) + 1
                return saved[attr](*a, **kw)
            return call

        for a in names:
            setattr(ops, a, wrap(a))
        try:
            yield counts
        finally:
            for a, fn in saved.items():
                setattr(ops, a, fn)

    return scope() if dev.type == "cuda" else contextlib.nullcontext(counts)


def merged_vs_single(model, params, merged, dev) -> dict:
    """One decode step after a 64-token prefill of 2 prompts through the
    merged engine's model and params (two lanes) and through the single
    engine's: the logits within ``MERGED_REL_TOL`` of the largest, and the
    argmax agreement printed."""
    import torch

    rng = np.random.default_rng(29)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, size=(2, 64))
                            .astype(np.int32)).to(dev)
    cur = torch.full((2,), 64, dtype=torch.int32, device=dev)
    outs = []
    with torch.no_grad():
        for m, p in ((model, params), (merged.model, merged.params)):
            logits, cache = m.prefill(p, {"tokens": toks}, 128)
            nxt = outs[0][0] if outs else logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            step, _ = m.decode_step(p, cache, {"tokens": nxt}, cur)
            outs.append((nxt, logits[:, -1].float(), step[:, 0].float()))
            del cache
    res = {}
    for label, i in (("prefill", 1), ("decode", 2)):
        want, got = outs[0][i], outs[1][i]
        res[f"{label}_rel"] = ((got - want).abs().max() / want.abs().max()).item()
        res[f"{label}_argmax_equal"] = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"  (b) merged vs single, one prefill row and one decode step a prompt (2 prompts): "
          f"max |diff| / max |logit| {res['prefill_rel']:.4f} / {res['decode_rel']:.4f} "
          f"(tolerance {MERGED_REL_TOL}); argmax equal {res['prefill_argmax_equal']} / "
          f"{res['decode_argmax_equal']} of 2", flush=True)
    if not max(res["prefill_rel"], res["decode_rel"]) <= MERGED_REL_TOL:
        raise AssertionError(f"phase 12 (b): merged logits off the single engine's: {res}")
    return res


def merged_paged(merged, model, params, dev, counters, reqs) -> dict:
    """The merged engine's placed weights (no copy: they stay where they are)
    behind a paged pool with prefix reuse: 4 of phase 12's prompts, the
    paged kernels on both lanes (16 KV heads each), every stream
    teacher-forced."""
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    eng = ServeEngine(merged.model, merged.params, backend=merged.backend, batch_slots=4,
                      max_len=1024, kv_block_size=32, prefix_cache=True, prefill_budget=64)
    if any(a is not b for a, b in zip(eng.params["blocks"]["attn"]["wq"].shards,
                                      merged.params["blocks"]["attn"]["wq"].shards)):
        raise AssertionError("phase 12 (b) paged: the merged weights were copied")
    reqs = [Request(rid=r.rid, prompt=r.prompt, params=SamplingParams(max_new=CLUSTER_NEW))
            for r in reqs]
    counts: dict = {}
    reset_counts(counters)
    with streams_counted(dev, counts):
        for r in reqs:
            eng.submit(r)
        stats = eng.run()
    lanes = [lane.stream.cuda_stream for lane in merged.backend.lanes] if dev.type == "cuda" \
        else []
    per_lane = [counts.get(("paged_attention", st), 0) for st in lanes]
    print_stats(stats, f"; paged launches on the two lanes {per_lane}")
    check_finished(reqs, CLUSTER_NEW, model.cfg.vocab_size)
    agree = [teacher_forced(model, params, r, dev, f"(b) merged paged rid {r.rid}") for r in reqs]
    if dev.type == "cuda" and min(per_lane) <= 0:
        raise AssertionError("phase 12 (b) paged: the paged kernel must launch on both lanes")
    return dict(tok_s=stats.tokens_per_sec, paged_launches=per_lane,
                teacher_forced_min=min(agree))


# phase 12 (d): replica 1's stall, the watchdog's verdict (near three times the
# longest iteration a live replica took: 2.9-3.5 s), and the replica tick it
# stalls at (16 new tokens a request: an earlier tick than 32 would need)
STALL_S, DEAD_AFTER_S, STALL_TICK = 14.0, 10.0, 6



def full_width_cluster(dev, model, params, phase4: dict, counters, max_len: int = 1024) -> dict:
    """Phase 12: the split/merge serving cluster at full width on phase 4's
    weights (bf16, 4 slots x ``max_len`` a replica). A single engine, then
    (a) split over [cuda:0, cuda:0] (two replicas, two controller threads,
    two streams, one copy of the weights), (b) a cluster over [cuda:0]
    switching SPLIT -> MERGE once half the requests have arrived and
    switching back warm, (c) ``run_controlled`` under
    ``ReconfigController.for_cluster`` over 4 long prompts then 12 short
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

    # (b) [cuda:0, cuda:0]: SPLIT (two replicas) -> MERGE (one tensor-parallel
    # engine over two lanes, 16 KV heads a lane) once half the requests have
    # arrived, then back and forth warm
    cl = ServeCluster(model, params, devices=[dev, dev], **kw)
    cl.prewarm(sampling=True)
    reqs = cluster_traffic(cfg)
    gap = 0.4
    t_half = gap * (len(reqs) // 2 - 1) + gap / 2
    per_stream = {}  # (kernel, raw stream) -> launches through ops in the run

    def switched():
        return cl.run(arrivals=[(gap * i, r) for i, r in enumerate(reqs)],
                      reconfigure_schedule=[(t_half, Mode.MERGE)])

    with streams_counted(dev, per_stream):
        stats = measured("(b) [cuda:0, cuda:0] split -> merge", switched, reqs)
    merged = cl.engines[0]
    if cl.mode is not Mode.MERGE or merged.backend.describe() != "sharded:model=2,devices=2":
        raise AssertionError(f"phase 12 (b): the merged fabric is {merged.backend.describe()}")
    lanes = [lane.stream.cuda_stream for lane in merged.backend.lanes] \
        if dev.type == "cuda" else []
    out["merged_launches"] = {name: [per_stream.get((name, st), 0) for st in lanes]
                              for name in ("decode_attention", "ragged_attention",
                                           "gqa_flash_attention")}
    print(f"  (b) launches on the merged engine's two lanes: {out['merged_launches']}")
    if lanes and any(min(n) <= 0 for n in out["merged_launches"].values()):
        raise AssertionError("phase 12 (b): decode, ragged and flash must launch on both lanes")
    reports = list(stats.reconfigures) + [cl.reconfigure(Mode.SPLIT), cl.reconfigure(Mode.MERGE)]
    for rep in reports:
        print(f"  (b) {rep}")
    if [r.cached for r in reports] != [False, True, True]:
        raise AssertionError(f"phase 12 (b): switches {reports}, want cold, warm, warm")
    out["reconfigure"] = [dict(from_mode=r.from_mode, to_mode=r.to_mode, cached=r.cached,
                               seconds=r.seconds, drain_s=r.drain_seconds,
                               place_s=r.place_seconds, bytes=r.bytes_moved) for r in reports]
    out["merged_vs_single"] = merged_vs_single(model, params, merged, dev)
    if dev.type == "cuda":
        out["merged_step"] = decode_step_profile(
            merged, cfg, dev, "(b) merged decode step, two lanes", lanes=True)
    out["merged_paged"] = merged_paged(merged, model, params, dev, counters, reqs[:4])
    del cl, merged

    # (c) the closed control loop over 4 long prompts, then 12 short ones
    rng = np.random.default_rng(12)
    lens = [int(x) for x in rng.integers(600, 701, size=4)] + \
        [int(x) for x in rng.integers(5, 41, size=12)]
    reqs = [Request(rid=100 + i, prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    tenant="ab"[i % 2], params=SamplingParams(max_new=16))
            for i, n in enumerate(lens)]
    arrivals = [(0.05 * i if i < 4 else 2.0 + 0.1 * (i - 4), r) for i, r in enumerate(reqs)]
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
        if idx == 1 and n == STALL_TICK:
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
    max_new = SERVE_NEW
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
    """Phase 4's prompts (4 slots x 1024, prefill_budget 64, 12 greedy
    requests of 5-700 prompt tokens, ``SERVE_NEW`` new tokens) on a new
    engine; counts set to 0 just before and read just after (``expect`` must have
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
    max_new = SERVE_NEW
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
    twice_equal(model, params, "(b)", [prompts[i] for i in (0, 2, 3, 6)], 16)
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


# ---------------------------------------------------------------- phase 14


def ssm_serve(dev, model, params, counters, label: str, expect, smi: str,
              floor_bytes: int) -> tuple[dict, dict]:
    """Phase 4's traffic (4 slots x 1024, prefill_budget 64, 12 greedy
    requests of 5-700 prompt tokens, ``SERVE_NEW`` new tokens) on a new engine at the
    family's default tier; counts set to 0 just before and read just after
    (``expect`` must have launched); every request finished and
    teacher-forced; a decode step profiled against the weight-read floor of
    ``floor_bytes``; two identical runs of four requests equal. Returns
    (launches, readings)."""
    import torch

    from repro_torch.common import pytree_bytes
    from repro_torch.serve import Request, SamplingParams, ServeEngine

    cfg = model.cfg
    max_new = SERVE_NEW
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, batch_slots=4, max_len=S_MAX, prefill_budget=64)
    eng.prewarm()
    setup_s = time.perf_counter() - t0
    reqs = [Request(rid=i, prompt=p_, params=SamplingParams(max_new=max_new))
            for i, p_ in enumerate(phase4_prompts(cfg))]
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    launches = read_counts(counters, f"phase 14 {label}", expect)
    check_finished(reqs, max_new, cfg.vocab_size)
    peak = torch.cuda.max_memory_allocated()
    state = eng.kv_bytes_resident()
    tier = "unified, packs one slot wide" if eng.unified else "legacy prefill+insert tier"
    print(f"  {label} [{smi}] ({tier})", end="")
    print_stats(stats, f"; peak memory {peak / 2**30:.2f} GiB; cache {state / 1e6:.1f} MB; "
                f"engine built and prewarmed in {setup_s:.1f} s")
    floor_ms = floor_bytes / HBM_BYTES_PER_S * 1e3
    out = dict(tok_s=stats.tokens_per_sec, ttft_p50_ms=stats.ttft_p50 * 1e3,
               ttft_p99_ms=stats.ttft_p99 * 1e3, tpot_p50_ms=stats.tpot_p50 * 1e3,
               peak_gib=peak / 2**30, cache_bytes=state, unified=eng.unified,
               bytes=pytree_bytes(eng.params), floor_ms=floor_ms)
    out["agreement"] = teacher_forced(model, eng.params, reqs[5], dev, label)
    out["decode_step"] = decode_step_profile(eng, cfg, dev, f"{label} decode step",
                                             floor_ms=floor_ms)
    del eng
    twice_equal(model, params, label, [phase4_prompts(cfg)[i] for i in (0, 2, 3, 6)], 16)
    return launches, out


def full_width_ssm(dev, counters, smi: str) -> tuple[dict, dict]:
    """Phase 14: the state-space families whole, at full width, on phase 4's
    traffic, each model freed before the next: (a) falcon-mamba-7b (64
    Mamba1 layers, d 4096, d_inner 8192, N 16, ~14 GB bf16 of random weights
    from a seed; nothing cut) on the unified engine, packs one slot wide: it
    reaches no attention kernel; (b) zamba2-2.7b (54 Mamba2 layers, d 2560,
    80 SSM heads of 64 at N 64, the shared attention + MLP block at 32 heads
    x D 80, G 1, run after every 6th layer: 9 times; ~4.7 GB; nothing cut)
    on the legacy tier: each admission's prefill at the prompt's exact length
    on the flash kernel, every decode launch on the split decode body.
    Returns ({case: its launches}, readings)."""
    import torch

    from repro_torch.common import pytree_bytes
    from repro_torch.configs import get_arch
    from repro_torch.models import LM

    out, launches = {}, {}
    for case, name in (("a", "falcon-mamba-7b"), ("b", "zamba2-2.7b")):
        cfg = get_arch(name)
        s = cfg.ssm
        model = LM(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        nb = pytree_bytes(params)
        floor_bytes = nb
        desc = (f"{cfg.n_layers} {s.variant} layers, d_model {cfg.d_model}, d_inner "
                f"{s.expand * cfg.d_model}, state {s.state}")
        if cfg.family == "hybrid":
            # the shared block's weights are read once per invocation
            n_inv = cfg.n_layers // cfg.shared_attn_every
            shared = pytree_bytes(params["shared"])
            floor_bytes = nb + (n_inv - 1) * shared
            desc += (f", {s.expand * cfg.d_model // s.head_dim} SSM heads of {s.head_dim}; the "
                     f"shared attention + MLP block ({cfg.n_heads} heads over {cfg.n_kv_heads} "
                     f"KV heads, D {cfg.head_dim}, ff {cfg.d_ff}: {shared / 1e9:.3f} GB) after "
                     f"every {cfg.shared_attn_every} layers, {n_inv} times")
        print(f"  ({case}) {cfg.name} [{smi}]: {desc}, vocab {cfg.vocab_size}, {cfg.dtype}: "
              f"{cfg.num_params() / 1e9:.3f}B params, {nb} bytes ({nb / 1e9:.2f} GB), init "
              f"{time.perf_counter() - t0:.1f} s; nothing cut; weight-read floor of a decode "
              f"step {floor_bytes / 1e9:.2f} GB -> "
              f"{floor_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s", flush=True)
        expect = [] if cfg.family == "ssm" else [
            "decode_attention", "decode_attention_split", "gqa_flash_attention"]
        launches[case], out[case] = ssm_serve(dev, model, params, counters, f"({case})", expect,
                                              smi, floor_bytes)
        la = launches[case]
        if cfg.family == "ssm" and any(la.values()):
            raise AssertionError(f"({case}) {name} launched an attention kernel: {la}")
        if cfg.family == "hybrid" and (la["ragged_attention"]
                                       or la["decode_attention"] != la["decode_attention_split"]):
            raise AssertionError(f"({case}) {name}: decode launches off the split body, or a "
                                 f"pack on the legacy tier: {la}")
        out[case].update(params=cfg.num_params())
        del model, params
        torch.cuda.empty_cache()
    print(f"  launches during phase 14: {launches}")
    return launches, out


# ---------------------------------------------------------------- phase 15

# the sync harness's input, [4096, 4096]: 128 MiB of complex64 for the FFT,
# 64 MiB of f32 for the matmul chain; SYNC_ROUNDS rounds of each
SYNC_N = 4096
SYNC_ROUNDS = 4
SYNC_REPEATS = 2  # timed runs of each mode after its warm-up; the best is kept
# max |mode - oracle| / max |oracle| allowed for the sync harness: f32 FFTs
# and f32 products summed in other orders (per-lane blocks against the whole)
# differ by ~1e-6 of the largest value after four rounds; a wrong exchange
# is off by O(1)
SYNC_TOL = 1e-4
# the mixed queue: 8 x each of the paper's six kernels through the port's
# ops, at phase 8's shapes (matmul bf16 4096^3, softmax [32768, 4096] bf16);
# the scalar queue: one coremark at each of the JAX benchmark's load points
MIXED_REPS = 8
MIXED_MATMUL = 4096
MIXED_SOFTMAX = (32768, 4096)
CM_LOADS = (20, 100, 400)
# a merged (2-lane) result of each op against its one-lane (pod 0) result:
# the same kernels over the same rows; the matmul's and dotp's splits may
# sum in other orders at another M or length
MIXED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SWITCHES = 5  # SPLIT -> MERGE -> SPLIT round trips of phase 15 (d)
RING_N = 4096  # M = K = N of the ring matmuls, f32
RING_LANES = (2, 4)
RING_TOL = 2e-4  # max |ring - torch.matmul| / max |torch.matmul| (the JAX test's rtol)


def _held(name: str, got, want, tol: float) -> float:
    """max |got - want| / max |want|, raising past ``tol`` or on a non-finite
    value."""
    import torch

    got, want = got.to(want.device), want
    scale = want.abs().max().item()
    err = (got - want).abs().max().item() / scale
    if not err <= tol or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max |err| / max |ref| = {err} outside {tol}")
    return err


def fabric_views(dev) -> dict:
    """Phase 15 (a): the cluster's views over two and four lanes of one card."""
    import torch

    from repro_torch.core import SpatzformerCluster

    out = {}
    for lanes in (2, 4):
        cl = SpatzformerCluster(n_pods=2, devices=[dev] * lanes)
        mi, si = cl.merge_info(), cl.split_infos()
        surv = cl.surviving_cluster(0)
        streams = {lane.stream for lane in cl.merged_mesh.lanes}
        if torch.device(dev).type == "cuda" and (None in streams or len(streams) != lanes):
            raise AssertionError(f"{lanes} lanes on one card share streams")
        row = dict(pod_shape=list(cl.pod_shape),
                   merge=[mi.n_devices, mi.data_size, mi.model_size],
                   split=[[i.n_devices, i.data_size, i.model_size] for i in si],
                   surviving=[surv.n_pods, surv.n_devices, surv.pod_info(0).n_devices])
        if (mi.n_devices, len(si), surv.n_devices) != (lanes, 2, lanes // 2):
            raise AssertionError(f"views over {lanes} lanes: {row}")
        print(f"  (a) {cl}: merge (lanes, data, model) {row['merge']}, split {row['split']}, "
              f"surviving_cluster(0) (pods, lanes, pod 0's lanes) {row['surviving']}; "
              f"{lanes} streams of their own", flush=True)
        out[f"lanes{lanes}"] = row
    return out


def sync_fft_input() -> np.ndarray:
    """Phase 15 (b)'s FFT input, [SYNC_N, SYNC_N] complex64 from a seed."""
    rng = np.random.default_rng(15)
    shape = (SYNC_N, SYNC_N)
    return (rng.standard_normal(shape, np.float32)
            + 1j * rng.standard_normal(shape, np.float32)).astype(np.complex64)


def merged_profile(device: str = "cuda") -> dict:
    """A torch-profiler count over run_merged's fft2d program (SYNC_ROUNDS
    rounds over two lanes of the card, after a warm run): its device
    events, its device-to-host copies, and the host syncs inside the
    program's span (the profiler synchronizes the device itself when it
    stops, after the span)."""
    import torch

    from repro_torch.core import SpatzformerCluster, fft2d_kernel, run_merged
    from repro_torch.dist.sharding import Mesh, NamedSharding, P, device_put

    dev = torch.device(device)
    cl = SpatzformerCluster(n_pods=2, devices=[dev, dev])
    x = sync_fft_input()
    _, _, program = run_merged(fft2d_kernel(rounds=SYNC_ROUNDS), x, cl, repeats=0)
    sh = NamedSharding(Mesh(cl.merged_mesh.lanes, ("fab",)), P("fab", None))
    xd = device_put(torch.from_numpy(x), sh)
    sh.mesh.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("merged_rounds"):
            program(xd)
        sh.mesh.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == "merged_rounds")
    dtoh = [e.name for e in events if "DtoH" in e.name or "Device -> Host" in e.name]
    syncs = [e.name for e in events if span.start <= e.time_range.start <= span.end
             and ("_local_scalar_dense" in e.name or "Synchronize" in e.name)]
    cuda = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return dict(profile_dtoh=len(dtoh), profile_syncs=len(syncs),
                profile_device_events=len(cuda), dtoh=dtoh, syncs=syncs)


def merged_profile_in_a_fresh_process() -> dict:
    """:func:`merged_profile` in a new process (``python3 -c``): run late in
    this script's process (after phases 2-14, on an H100), the same profile
    held no device event at all for the ~4 ms program, so the count showed
    nothing there. Raises unless it shows device events, no device-to-host
    copy and no host sync."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import json, chip_smoke; print(json.dumps(chip_smoke.merged_profile()))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"the merged profile's process failed:\n{out.stderr[-4000:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    dtoh, syncs = row.pop("dtoh"), row.pop("syncs")
    print(f"  (b) run_merged fft2d profiled (a fresh process): {row['profile_device_events']} "
          f"device events, {len(dtoh)} device-to-host copies, {len(syncs)} host syncs between "
          f"its first and last round", flush=True)
    if dtoh or syncs or not row["profile_device_events"]:
        raise AssertionError(f"run_merged: device-to-host copies {dtoh}, syncs {syncs}, "
                             f"{row['profile_device_events']} device events")
    return row


def fabric_sync(dev, smi: str) -> dict:
    """Phase 15 (b): the two-phase sync harness at [4096, 4096] over two
    lanes of one card — fft2d (torch.fft, the JAX package's jnp.fft), the
    same rounds through the hand-written FFT (ops.fft), and the f32 matmul
    chain — merged (one controller, the corner turn on the device) against
    split-staged (the host-mediated corner turn); each held against a plain
    on-device oracle of the whole. A profile of the merged program counts
    its device-to-host copies."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import (SpatzformerCluster, TwoPhaseKernel, fft2d_kernel,
                                  matmul_chain_kernel, run_merged, run_split_staged)
    from repro_torch.kernels import ops

    cl = SpatzformerCluster(n_pods=2, devices=[dev, dev])
    n = SYNC_N
    xc = sync_fft_input()
    xr = np.random.default_rng(16).standard_normal((n, n), np.float32)
    w1 = torch.randn(n, n, generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev) / n**0.5
    w2 = torch.randn(n, n, generator=torch.Generator(device=dev).manual_seed(2),
                     device=dev) / n**0.5

    def kernel_fft(x):  # a phase through the hand-written Stockham FFT (row 14)
        re, im = ops.fft(x.real.contiguous(), x.imag.contiguous())
        return torch.complex(re, im)

    def fft_oracle(x):
        for _ in range(SYNC_ROUNDS):
            x = torch.fft.fft2(x)
        return x

    def chain_oracle(x):
        for _ in range(SYNC_ROUNDS):
            x = (F.gelu(x @ w1, approximate="tanh").T @ w2).T
        return x

    cases = (("fft2d", fft2d_kernel(rounds=SYNC_ROUNDS), xc, fft_oracle),
             ("fft2d_kernel", TwoPhaseKernel("fft2d_kernel", kernel_fft, kernel_fft,
                                             SYNC_ROUNDS), xc, fft_oracle),
             ("matmul_chain", matmul_chain_kernel(w1, w2, rounds=SYNC_ROUNDS), xr, chain_oracle))
    out = {}
    for name, kernel, x, oracle in cases:
        want = oracle(torch.from_numpy(x).to(dev))
        ym, tm, _ = run_merged(kernel, x, cl, repeats=SYNC_REPEATS)
        ys, ts = run_split_staged(kernel, x, cl, repeats=SYNC_REPEATS)
        row = dict(merged_s=tm, split_s=ts, sm_over_mm=ts / tm,
                   merged_err=_held(f"{name} merged", torch.from_numpy(ym), want, SYNC_TOL),
                   split_err=_held(f"{name} split", torch.from_numpy(ys), want, SYNC_TOL),
                   modes_err=_held(f"{name} merged vs split", torch.from_numpy(ym),
                                   torch.from_numpy(ys).to(dev), SYNC_TOL))
        del want
        if name == "fft2d":  # the merged program's device-to-host copies between rounds
            row.update(merged_profile_in_a_fresh_process())
            # the same profile in this process, printed, not held: late in the script's
            # process it once recorded no device event (PERF.md section 7)
            row["profile_device_events_here"] = merged_profile()["profile_device_events"]
            print(f"  (b) the same profile in this process: "
                  f"{row['profile_device_events_here']} device events", flush=True)
        print(f"  (b) {name} [{n}, {n}] {x.dtype}, {SYNC_ROUNDS} rounds [{smi}]: merged "
              f"{tm:.6f} s, split-staged {ts:.6f} s (best of {SYNC_REPEATS}), SM/MM "
              f"{ts / tm:.3f}; max |err| / max |oracle|: merged {row['merged_err']:.3g}, split "
              f"{row['split_err']:.3g}, merged vs split {row['modes_err']:.3g} (tol {SYNC_TOL})",
              flush=True)
        out[name] = row
        torch.cuda.empty_cache()
    return out


def fabric_mixed(dev, counters, smi: str) -> tuple[dict, dict]:
    """Phase 15 (c): the mixed scalar-vector scheduler over two lanes of one
    card. The vector queue is MIXED_REPS x each of the paper's six kernels
    through ``ops`` (matmul, conv2d, fft, dotp, axpy, softmax), each task
    sharding its rows over the lanes of the view it receives; the scalar
    queue one coremark at each of CM_LOADS. MERGE and SPLIT with scalar work
    at each load, then SPLIT vector-only. Returns (readings, launches)."""
    import torch

    from repro_torch.core import (Mode, MixedScheduler, ScalarTask, SpatzformerCluster,
                                  VectorTask, coremark)
    from repro_torch.dist.sharding import P, device_put
    from repro_torch.kernels import ops

    cl = SpatzformerCluster(n_pods=2, devices=[dev, dev])
    gen = torch.Generator(device=dev).manual_seed(16)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    mm, sm = MIXED_MATMUL, MIXED_SOFTMAX
    whole = {"matmul": (randn(mm, mm, dtype=bf16), randn(mm, mm, dtype=bf16)),
             "conv2d": (randn(*CONV_MAIN[0], dtype=bf16), randn(*CONV_MAIN[1], dtype=bf16)),
             "fft": (randn(*FFT_MAIN), randn(*FFT_MAIN)),
             "vec": (randn(SUITE_N), randn(SUITE_N)),
             "softmax": (randn(*sm, dtype=bf16),)}
    replicated = {"matmul": 1, "conv2d": 1}  # the operand every lane holds whole
    placed = {}

    def inputs(key, info):
        """``key``'s operands on ``info``'s lanes: rows over every lane, the
        weight of a matmul or conv2d whole on each; placed once per view."""
        if (key, id(info.mesh)) not in placed:
            rows = info.named(P(tuple(info.mesh.axis_names)))
            placed[key, id(info.mesh)] = [
                device_put(t, info.named(P()) if i == replicated.get(key) else rows)
                for i, t in enumerate(whole[key])]
        return placed[key, id(info.mesh)]

    def per_lane(key, info, fn):
        ops_ = inputs(key, info)
        outs = []
        for i, lane in enumerate(info.mesh.lanes):
            with lane.use():
                outs.append(fn(*(o.shards[i] for o in ops_)))
        return outs

    def dotp(info):
        parts = per_lane("vec", info, ops.dotp)
        first = info.mesh.lanes[0]
        with first.use():  # the lanes' partial dots summed on the first lane
            for lane, p in zip(info.mesh.lanes, parts):
                first.wait_for(lane)
                first.keep(p)
            return torch.stack(parts).sum()

    tasks = {"matmul": lambda info: per_lane("matmul", info, ops.matmul),
             "conv2d": lambda info: per_lane("conv2d", info, ops.conv2d),
             "fft": lambda info: per_lane("fft", info, ops.fft),
             "dotp": dotp,
             "axpy": lambda info: per_lane("vec", info, lambda x, y: ops.axpy(0.5, x, y)),
             "softmax": lambda info: per_lane("softmax", info, ops.softmax)}
    # warm-up on every view (places the operands, plans, first launches), and
    # each op's merged (2-lane) output against its pod-0 (1-lane) one
    views = {"merged": cl.merge_info(), "pod0": cl.pod_info(0), "pod1": cl.pod_info(1)}
    res = {}
    for label, info in views.items():
        for name, fn in tasks.items():
            res[label, name] = fn(info)
        info.mesh.synchronize()

    def whole_of(r):  # a task's per-lane outputs as one tensor
        if isinstance(r, torch.Tensor):
            return r.reshape(1)
        return torch.cat([torch.complex(*p) if isinstance(p, tuple) else p for p in r])

    errs = {}
    for name in tasks:
        g, w = whole_of(res["merged", name]), whole_of(res["pod0", name])
        if name == "dotp":  # f32 sums in other orders: within 1e-5 * sum |x_i y_i| (phase 8)
            x, y = whole["vec"]
            scale = (x * y).abs().sum().item()
            errs[name] = abs(g.item() - w.item()) / scale
            if not errs[name] <= SUITE_TOL["dotp"]:
                raise AssertionError(f"(c) dotp over two lanes vs one: {errs[name]} of "
                                     f"sum |x y| outside {SUITE_TOL['dotp']}")
            continue
        tol = MIXED_TOL["bfloat16" if g.dtype == bf16 else "float32"]
        if g.dtype == bf16:
            g, w = g.float(), w.float()
        errs[name] = _held(f"(c) {name} over two lanes vs one", g, w, tol)
    print(f"  (c) merged (2-lane) vs one-lane outputs, max |err| / max |ref|: {errs}", flush=True)

    def digest(outs):  # one f32 sum of each output tensor, kept on the device
        outs = [outs] if isinstance(outs, torch.Tensor) else outs
        return torch.stack([t.float().sum() for o in outs
                            for t in (o if isinstance(o, tuple) else (o,))])

    ref = {(label, name): digest(res[label, name]) for label in ("pod0", "pod1")
           for name in tasks}
    # the digests read the lanes' outputs on this thread's stream: let them finish before
    # the outputs go back to the lanes' streams, whose next tasks may reuse that memory
    torch.cuda.synchronize(dev)
    del res

    def discard(fn):  # a timed task keeps nothing of its outputs
        def task(info):
            fn(info)
        return task

    queue = [VectorTask(f"{name}{i}", discard(fn)) for i in range(MIXED_REPS)
             for name, fn in tasks.items()]
    sched = MixedScheduler(cl)
    runs = {}
    reset_counts(counters)
    for load in CM_LOADS:
        for mode in (Mode.MERGE, Mode.SPLIT):
            rep = sched.run(mode, queue, [ScalarTask(f"coremark{load}",
                                                     lambda n=load: coremark(n).checksum)])
            runs[f"{mode}_{load}"] = rep
    runs["split_vector_only"] = sched.run(Mode.SPLIT, queue)
    launches = read_counts(counters, "phase 15 (c) (the mixed scheduler's seven runs)")
    # two controller threads launching the hand-written ops at once (one per
    # pod, each on its lane's stream) give the bits one thread gave
    pair = [VectorTask(name, lambda info, fn=fn: digest(fn(info))) for name, fn in tasks.items()
            for _ in range(2)]
    rep = sched.run(Mode.SPLIT, pair)
    for r in rep.records:
        pod = r.lane.split("/")[1]
        if not torch.equal(r.result, ref[pod, r.name]):
            raise AssertionError(f"(c) {r.name} on {r.lane} beside the other controller: "
                                 f"{r.result.tolist()} != {ref[pod, r.name].tolist()}")
    print(f"  (c) two controllers at once: {len(rep.records)} outputs bitwise one thread's",
          flush=True)
    out = {"errors": errs, "runs": {}}
    for key, rep in runs.items():
        lanes = sorted({r.lane for r in rep.records})
        row = dict(makespan=rep.makespan, lanes={ln: rep.lane_time(ln) for ln in lanes},
                   vector_s=rep.kind_time("vector"), scalar_s=rep.kind_time("scalar"),
                   records=len(rep.records))
        out["runs"][key] = row
        print(f"  (c) {key:18s} [{smi}]: makespan {rep.makespan:.4f} s; lanes "
              + ", ".join(f"{ln} {t:.4f} s" for ln, t in row["lanes"].items())
              + f"; {row['records']} records", flush=True)
        if row["records"] != len(queue) + (0 if key == "split_vector_only" else 1):
            raise AssertionError(f"(c) {key}: {row['records']} records")
    out["mm_speedup"] = {}  # SM makespan / MM makespan at each scalar load
    for load in CM_LOADS:
        ratio = out["runs"][f"split_{load}"]["makespan"] / out["runs"][f"merge_{load}"]["makespan"]
        out["mm_speedup"][load] = ratio
        print(f"  (c) coremark {load}: SM/MM makespan {ratio:.3f}", flush=True)
    del placed, whole
    torch.cuda.empty_cache()
    return out, launches


def fabric_switch(dev, smi: str) -> dict:
    """Phase 15 (d): ``switch_mode`` SPLIT -> MERGE -> SPLIT SWITCHES times
    with a live, param-shaped state: codeqwen1.5-7b's tree cut to 1 of 32
    layers (widths full; bf16 random weights from a seed, ~1.98 GB), over
    four lanes of one card in two pods of (data 1, model 2), resharded
    between pod 0's view and the merged view by ``param_shardings``. Values
    bit-equal after every switch."""
    import torch

    from repro_torch.common import pytree_bytes
    from repro_torch.configs import get_arch
    from repro_torch.core import Mode, SpatzformerCluster, switch_mode
    from repro_torch.dist.sharding import device_put, gather, param_shardings, tree_map_with_path
    from repro_torch.models import LM

    cfg = replace(get_arch("codeqwen1.5-7b"), n_layers=1)
    params = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(17))
    nb = pytree_bytes(params)
    cl = SpatzformerCluster(n_pods=2, pod_shape=(1, 2), devices=[dev] * 4)
    state = device_put(params, param_shardings(params, cl.pod_info(0)))
    cl.merged_mesh.synchronize()

    def shards(tree):
        out = []
        tree_map_with_path(lambda _, v: out.extend(v.shards), tree)
        return out

    reps = {"merge": [], "split": []}
    copied = {"merge": [], "split": []}
    for _ in range(SWITCHES):
        for mode in (Mode.MERGE, Mode.SPLIT):
            before = {id(t) for t in shards(state)}
            state, rep = switch_mode(cl, mode, state)
            copied[str(mode)].append(sum(t.numel() * t.element_size() for t in shards(state)
                                         if id(t) not in before))
            reps[str(mode)].append(rep)
            leaves = []
            tree_map_with_path(lambda p, v: leaves.append((p, v)), state)
            bad = [p for p, v in leaves if not torch.equal(gather(v), _at(params, p))]
            if bad or rep.bytes_moved != nb:
                raise AssertionError(f"(d) switch to {mode}: leaves {bad} differ, bytes_moved "
                                     f"{rep.bytes_moved} of {nb}")
    out = {"bytes_moved": nb, "tree": f"codeqwen1.5-7b at 1 of 32 layers, {nb} bytes"}
    for mode, rs in reps.items():
        secs = sorted(r.seconds for r in rs)
        med = float(np.median(secs))
        out[mode] = dict(median_s=med, seconds=secs, gbytes_per_sec=nb / 1e9 / med,
                         bytes_copied=copied[mode])
        print(f"  (d) to {mode} [{smi}]: median {med:.6f} s of {len(rs)} (min {secs[0]:.6f}, "
              f"max {secs[-1]:.6f}); bytes_moved {nb} -> {nb / 1e9 / med:.1f} GB/s; bytes "
              f"copied between lanes {copied[mode][0]} (the rest kept on their lanes); values "
              f"bit-equal after every switch", flush=True)
    del state, params
    torch.cuda.empty_cache()
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def fabric_ring(dev, smi: str) -> dict:
    """Phase 15 (e): the ring matmuls over 2 and 4 lanes of one card at
    M = K = N = 4096 f32 against torch.matmul of the whole."""
    import torch

    from repro_torch.dist.collectives import ring_ag_matmul, ring_rs_matmul
    from repro_torch.dist.sharding import Mesh, NamedSharding, P, device_put, gather, lanes_for

    gen = torch.Generator(device=dev).manual_seed(18)
    n = RING_N
    a = torch.randn(n, n, generator=gen, device=dev)
    w = torch.randn(n, n, generator=gen, device=dev)
    want = a @ w
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        a @ w
    sync()
    out = {"matmul_s": (time.perf_counter() - t0) / 3}
    for p in RING_LANES:
        mesh = Mesh(lanes_for([dev] * p), ("model",))

        def put(t, spec):
            return device_put(t, NamedSharding(mesh, spec))

        for name, fn, specs in (("rs", ring_rs_matmul, (P(None, "model"), P("model", None))),
                                ("ag", ring_ag_matmul, (P("model", None), P(None, "model")))):
            x, wx = put(a, specs[0]), put(w, specs[1])
            y = fn(x, wx, "model")
            err = _held(f"(e) ring_{name}_matmul over {p} lanes", gather(y), want, RING_TOL)
            best = float("inf")
            for _ in range(3):
                mesh.synchronize()
                t0 = time.perf_counter()
                fn(x, wx, "model")
                mesh.synchronize()
                best = min(best, time.perf_counter() - t0)
            out[f"{name}{p}"] = dict(s=best, err=err)
            print(f"  (e) ring_{name}_matmul {n}^3 f32 over {p} lanes [{smi}]: best {best:.6f} s "
                  f"(torch.matmul of the whole {out['matmul_s']:.6f} s); max |err| / max |ref| "
                  f"{err:.3g} (tol {RING_TOL})", flush=True)
            del x, wx, y
    torch.cuda.empty_cache()
    return out


def fabric_counters() -> dict:
    """Phase 15's launch counters: the six paper kernels of (c)'s queue."""
    from repro_torch.kernels import axpy, conv2d, dotp, fft, matmul, softmax

    return {"matmul": (matmul, "launches"), "conv2d": (conv2d, "launches"),
            "fft": (fft, "launches"), "dotp": (dotp, "launches"),
            "axpy": (axpy, "launches"), "softmax": (softmax, "launches")}


def fabric_alone() -> int:
    """Phase 15 alone, after the card check and the build, as :func:`main`
    runs them; prints the ``{"fabric": ...}`` line. Raises where phase 15
    fails.

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.fabric_alone())"
    """
    from repro_torch.kernels import _build

    setup = card_setup()
    if setup is None:
        return 1
    dev, smi = setup
    phase("1 build")
    t0 = time.perf_counter()
    _build.load()
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    phase("15 the split/merge fabric over lanes of one card")
    fabric, _ = full_fabric(dev, fabric_counters(), smi)
    print(json.dumps({"fabric": fabric}, default=float))
    phase("done")
    return 0


def full_fabric(dev, counters, smi: str) -> tuple[dict, dict]:
    """Phase 15: the paper's split/merge fabric over lanes of one card (a)
    views, (b) the sync harness, (c) the mixed scheduler, (d) live-state
    reconfiguration, (e) the ring matmuls. Returns (readings, (c)'s
    launches)."""
    out = {"views": fabric_views(dev), "sync": fabric_sync(dev, smi)}
    out["mixed"], launches = fabric_mixed(dev, counters, smi)
    out["switch"] = fabric_switch(dev, smi)
    out["ring"] = fabric_ring(dev, smi)
    return out, launches


# ---------------------------------------------------------------- phase 16

# (a): codeqwen1.5-7b at full width, 4 of its 32 layers, bf16, remat per
# block, chunked attention at 512; batch 2 x 2048 from the corpus, the same
# batch every step (the loss must fall on it); 2 warm steps, 6 timed at
# grad_accum 1, 2 at grad_accum 2
TRAIN_LAYERS = 4
TRAIN_B, TRAIN_S = 2, 2048
TRAIN_WARM, TRAIN_TIMED, TRAIN_ACCUM_STEPS = 2, 6, 2
# (b), (e): one f32 step (three for (e)) of a reduced config on the card
# against the CPU from the same params. Loss, aux and the learning rate: f32
# sums in other orders, 1e-5 relative. grad_norm: 1e-4 relative (the same
# sums, squared and added over every leaf). Params: ``params_close``.
TRAIN_REL_TOL = 1e-5
TRAIN_NORM_TOL = 1e-4
TRAIN_LR = 1e-3
# (c): reduced codeqwen1.5-7b at these widths, f32: 15 M params, ~180 MB
# of params and moments for the async writer, whose write outlasts a step
CKPT_WIDTHS = dict(d_model=512, d_ff=1408, vocab_size=8192, n_heads=8, n_kv_heads=8,
                   d_head=64)
# (f): (a) over four lanes of the card, (data 2, model 2); 1 warm step, 5
# timed. The first step's loss and grad norm against one lane's on the same
# params and batch: the lanes sum each layer's attention and MLP partial
# products (each rounded to bf16) where one lane rounds one product. The
# loss: 1e-4 relative (3.1e-6 measured on an H100, PERF.md); the grad norm,
# a sum over bf16 grads taken in other orders: one bf16 rounding, 2^-9
TRAIN_LANES = 4
TRAIN_LANES_TIMED = 5
TRAIN_LANES_LOSS_TOL = 1e-4
TRAIN_LANES_GNORM_TOL = 2.0 ** -9


def kernel_launch_counts() -> dict:
    """Every launch counter of every hand-written kernel's wrapper: a
    training run must leave them all at 0."""
    from repro_torch.kernels import (axpy, conv2d, decode_attention, dotp, fft,
                                     flash_attention, matmul, mla_attention,
                                     paged_attention, ragged_attention, rmsnorm, softmax)

    mods = (axpy, conv2d, decode_attention, dotp, fft, flash_attention, matmul, mla_attention,
            paged_attention, ragged_attention, rmsnorm, softmax)
    return {f"{m.__name__.split('.')[-1]}.{a}": (m, a) for m in mods for a in dir(m)
            if a.startswith("launches") and isinstance(getattr(m, a), int)}


def params_close(got, want, lr: float, steps: int, label: str) -> dict:
    """Params after ``steps`` AdamW steps on the card against the CPU's.
    Each element moves about lr a step; an element whose gradient is
    rounding noise (the two devices sum in other orders) may take its step
    with either sign, so a difference up to 2 · lr · steps is possible
    there. Elements within 1e-6 of their leaf's scale hold; the rest must
    be under 2% of all and within 2 · lr · steps."""
    from repro_torch.common.tree import leaves

    n_off = n = 0
    worst = 0.0
    for a, b in zip(leaves(got), leaves(want), strict=True):
        d = (a.detach().float().cpu() - b.detach().float().cpu()).abs()
        n_off += int((d > 1e-6 * max(float(b.abs().max()), 1.0)).sum())
        n += d.numel()
        worst = max(worst, float(d.max()))
    res = dict(max_abs=worst, off_share=n_off / n)
    if worst > 2 * lr * steps or n_off > 0.02 * n:
        raise AssertionError(f"{label}: params off the CPU's: {res}")
    return res


def metrics_close(got: dict, want: dict, label: str, norm_tol: float = TRAIN_NORM_TOL) -> None:
    for k in ("loss", "aux", "lr", "grad_norm"):
        a, b = float(got[k]), float(want[k])
        tol = norm_tol if k == "grad_norm" else TRAIN_REL_TOL
        if abs(a - b) > tol * abs(b) + 1e-7:
            raise AssertionError(f"{label}: {k} {a} on the card, {b} on the CPU")


def train_step_profile(step_fn, state, batch, wall_ms: float, label: str) -> dict:
    """One train step under the profiler: the device's busy time (kernel
    time) against ``wall_ms`` (the timed steps' median)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state[0], state[1], _ = step_fn(state[0], state[1], batch)
        torch.cuda.synchronize()
    kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        raise AssertionError(f"{label}: the profiler recorded no device event")
    busy_ms = sum(r[0] for r in kernels) / 1e3
    n = sum(r[1] for r in kernels)
    # kernel time by kind, from the kernels' names
    kinds = {"gemm": 0.0, "elementwise": 0.0, "reduce": 0.0, "other": 0.0}
    for us, _, key in kernels:
        k = key.lower()
        kind = ("gemm" if any(w in k for w in ("gemm", "nvjet", "xmma", "cutlass", "cublas"))
                else "elementwise" if "elementwise" in k else "reduce" if "reduce" in k
                else "other")
        kinds[kind] += us / 1e3
    print(f"  {label}: device busy {busy_ms:.1f} ms of a {wall_ms:.1f} ms step (idle share "
          f"{1 - busy_ms / wall_ms:.3f}), {n} kernels; by kind (ms) "
          f"{ {k: round(v, 1) for k, v in kinds.items()} }")
    for us, cnt, key in sorted(kernels, reverse=True)[:8]:
        print(f"    {us / 1e3:8.2f} ms  {cnt:5d} calls  {key[:80]}")
    return dict(busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms, kernels=n, kinds_ms=kinds,
                top=[(key[:60], us / 1e3) for us, _, key in sorted(kernels, reverse=True)[:5]])


def train_full_width(dev, smi: str) -> dict:
    """(a) full-width codeqwen1.5-7b at 4 layers: step wall, tokens/s, peak
    memory, idle share and model TFLOP/s, the loss falling on one batch."""
    import torch

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import LM
    from repro_torch.train import (adamw_init, adamw_update, make_loss_fn, make_train_step,
                                   value_and_grad, warmup_cosine)

    cfg = replace(get_arch("codeqwen1.5-7b"), n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params)
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in corpus.batch(0).items()}
    torch.cuda.synchronize()
    n_params = cfg.num_params()
    tokens = TRAIN_B * TRAIN_S
    # 6·N·tokens over the matmul params (the input table is a gather), plus
    # attention's QK^T and PV at every score (the chunked path masks, it
    # does not skip): 3 x 4·B·S²·H·hd a layer
    n_mm = n_params - cfg.vocab_size * cfg.d_model
    flops = 6 * n_mm * tokens + 12 * cfg.n_layers * TRAIN_B * TRAIN_S ** 2 * cfg.n_heads \
        * cfg.head_dim
    print(f"  {cfg.name} at {cfg.n_layers} of 32 layers: {n_params / 1e9:.3f}B params, "
          f"{cfg.dtype}, remat {cfg.remat}, {cfg.attn_impl} attention at {cfg.attn_chunk}, "
          f"batch {TRAIN_B} x {TRAIN_S}; init {time.perf_counter() - t0:.1f} s; "
          f"{flops / 1e12:.2f} TFLOP a step (model)")
    tcfg = TrainConfig(lr=3e-4, warmup_steps=TRAIN_WARM, total_steps=100)
    step = make_train_step(model, tcfg)
    state = [params, opt]

    def run(fn, label):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state[0], state[1], m = fn(state[0], state[1], batch)
        loss = float(m["loss"])  # waits for the step
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        print(f"  {label}: {ms:8.1f} ms, {tokens / ms * 1e3:9.0f} tok/s, "
              f"{flops / ms / 1e9:6.1f} TFLOP/s, loss {loss:.4f} gnorm "
              f"{float(m['grad_norm']):.3f} lr {float(m['lr']):.2e}", flush=True)
        return ms, loss

    for i in range(TRAIN_WARM):
        run(step, f"warm step {i + 1}")
    torch.cuda.reset_peak_memory_stats(dev)
    timed = [run(step, f"step {TRAIN_WARM + i + 1}") for i in range(TRAIN_TIMED)]
    peak1 = torch.cuda.max_memory_allocated(dev)
    losses = [loss for _, loss in timed]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 16 (a): the loss did not fall on one batch: {losses}")
    walls = sorted(ms for ms, _ in timed)
    wall = walls[len(walls) // 2]
    prof = train_step_profile(step, state, batch, wall, "one step at grad_accum 1")
    # the step's two parts on the device's clock: forward + backward, the update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    _, grads = value_and_grad(make_loss_fn(model), state[0], batch)
    ev[1].record()
    adamw_update(grads, state[1], state[0], tcfg, warmup_cosine(tcfg))
    ev[2].record()
    torch.cuda.synchronize()
    del grads
    parts = dict(fwd_bwd_ms=ev[0].elapsed_time(ev[1]), update_ms=ev[1].elapsed_time(ev[2]))
    print(f"  forward + backward {parts['fwd_bwd_ms']:.1f} ms, AdamW update "
          f"{parts['update_ms']:.1f} ms (CUDA events)")
    step2 = make_train_step(model, replace(tcfg, grad_accum=2))
    torch.cuda.reset_peak_memory_stats(dev)
    accum = [run(step2, f"grad_accum 2 step {i + 1}") for i in range(TRAIN_ACCUM_STEPS)]
    peak2 = torch.cuda.max_memory_allocated(dev)
    wall2 = min(ms for ms, _ in accum)
    out = dict(model=cfg.name, layers=cfg.n_layers, params=n_params, batch=TRAIN_B,
               seq=TRAIN_S, dtype=cfg.dtype, flops_per_step=flops, step_ms=[ms for ms, _ in timed],
               median_ms=wall, tok_s=tokens / wall * 1e3, tflops=flops / wall / 1e9,
               peak_gb=peak1 / 1e9, losses=losses, idle_share=prof["idle_share"],
               busy_ms=prof["busy_ms"], kernels_per_step=prof["kernels"], top=prof["top"],
               kinds_ms=prof["kinds_ms"], **parts,
               accum2_ms=[ms for ms, _ in accum], accum2_tok_s=tokens / wall2 * 1e3,
               accum2_peak_gb=peak2 / 1e9, card=smi)
    print(f"  ({smi}) median step {wall:.1f} ms: {out['tok_s']:.0f} tok/s, "
          f"{out['tflops']:.1f} model TFLOP/s, peak {out['peak_gb']:.2f} GB (grad_accum 2: "
          f"{wall2:.1f} ms, peak {out['accum2_peak_gb']:.2f} GB); idle share "
          f"{prof['idle_share']:.3f}; losses {[round(x, 4) for x in losses]}")
    del state, params, opt, batch
    torch.cuda.empty_cache()
    return out


def tree_to(tree, dev):
    from repro_torch.common.tree import tree_map

    return tree_map(lambda t: t.to(dev, copy=True), tree)


def _reduced_pair(name: str, dev):
    """(model on the card, model on the CPU, params on each: one init)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import LM

    cfg = get_arch(name).reduced()
    cpu = LM(cfg, device="cpu")
    p_cpu = cpu.init(torch.Generator().manual_seed(1))
    return LM(cfg, device=dev), cpu, tree_to(p_cpu, dev), p_cpu


def train_parity(dev) -> dict:
    """(b) one f32 train step of reduced codeqwen1.5-7b and reduced
    deepseek-v2-lite-16b (MoE aux) on the card against the CPU."""
    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.train import adamw_init, make_train_step

    out = {}
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    for name in ("codeqwen1.5-7b", "deepseek-v2-lite-16b"):
        m_dev, m_cpu, p_dev, p_cpu = _reduced_pair(name, dev)
        batch = SyntheticCorpus(DataConfig(m_cpu.cfg.vocab_size, 64, 4, seed=3)).batch(0)
        res = []
        for model, p, d in ((m_dev, p_dev, dev), (m_cpu, p_cpu, "cpu")):
            b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            p, _, m = make_train_step(model, tcfg)(p, adamw_init(p), b)
            res.append((p, m))
        (pd, md), (pc, mc) = res
        metrics_close(md, mc, f"phase 16 (b) {name}")
        close = params_close(pd, pc, TRAIN_LR, 1, f"phase 16 (b) {name}")
        out[name] = dict(loss=float(md["loss"]), loss_cpu=float(mc["loss"]),
                         aux=float(md["aux"]), aux_cpu=float(mc["aux"]),
                         grad_norm=float(md["grad_norm"]), grad_norm_cpu=float(mc["grad_norm"]),
                         **close)
        print(f"  {name} reduced f32, one step, card vs CPU: {out[name]}")
    return out


def train_checkpoint(dev) -> dict:
    """(c) an async save at step 3 while step 4 runs, a restore into fresh
    state, and the resumed losses against the straight run's. The model is
    reduced codeqwen1.5-7b widened to ``CKPT_WIDTHS`` (f32), so that the
    writer has ~180 MB to put on disk while step 4 takes milliseconds: the
    phase fails unless the writer is still alive when step 4 has ended."""
    import shutil
    import tempfile

    import torch

    from repro_torch.ckpt import Checkpointer
    from repro_torch.common import pytree_bytes
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import LM
    from repro_torch.train import adamw_init, make_train_step

    model = LM(replace(get_arch("codeqwen1.5-7b").reduced(), **CKPT_WIDTHS), device=dev)
    init = lambda seed: model.init(torch.Generator(device=dev).manual_seed(seed))
    params = init(1)
    corpus = SyntheticCorpus(DataConfig(model.cfg.vocab_size, 64, 4, seed=4))
    batch = lambda i: {k: torch.from_numpy(v).to(dev) for k, v in corpus.batch(i).items()}
    step = make_train_step(model, TrainConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=6))
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ck = Checkpointer(d)
        opt = adamw_init(params)
        nbytes = pytree_bytes((params, opt))
        straight, handle, writing = [], None, None
        for i in range(6):
            params, opt, m = step(params, opt, batch(i))
            straight.append(float(m["loss"]))  # float() waits for the step's end
            if i == 2:
                handle = ck.save(3, (params, opt))  # snapshot taken; written while step 4 runs
            elif i == 3:
                writing = handle.thread.is_alive()
        handle.wait()
        fresh = init(2)  # any state of the right structure
        (params, opt), at = ck.restore((fresh, adamw_init(fresh)))
        resumed = []
        for i in range(at, 6):
            params, opt, m = step(params, opt, batch(i))
            resumed.append(float(m["loss"]))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight[3:]))
    print(f"  {nbytes} bytes of state; straight {straight}; resumed from step {at}: {resumed} "
          f"(max rel diff {worst:.2e}; the writer still busy when step 4 ended: {writing})")
    if not writing:
        raise AssertionError("phase 16 (c): the save at step 3 was written before step 4 "
                             "ended, so it did not overlap step 4")
    if at != 3 or worst > TRAIN_REL_TOL:
        raise AssertionError(f"phase 16 (c): resumed {resumed} vs straight {straight[3:]}")
    return dict(state_bytes=nbytes, straight=straight, resumed=resumed, max_rel=worst,
                writer_overlapped=writing)


def train_launcher() -> dict:
    """(d) ``python -m repro_torch.launch.train`` on the card, then
    ``--resume`` to 16 steps: both exit 0, the second resumes at 12."""
    import os
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "codeqwen1.5-7b",
            "--reduced", "--batch", "4", "--seq", "64", "--ckpt-dir", d, "--log-every", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    try:
        for label, extra in (("run", ["--steps", "12"]), ("resume", ["--steps", "16", "--resume"])):
            t = time.perf_counter()
            r = subprocess.run(base + extra, env=env, capture_output=True, text=True, timeout=300)
            secs = time.perf_counter() - t
            print(f"  launch.train {label} (exit {r.returncode}, {secs:.1f} s):")
            for line in r.stdout.strip().splitlines():
                print(f"    {line}")
            if r.returncode != 0:
                raise AssertionError(f"phase 16 (d): launch.train {label} failed:\n{r.stderr[-3000:]}")
            out[label] = dict(seconds=secs, last=r.stdout.strip().splitlines()[-2])
        if "resumed from step 12" not in r.stdout:
            raise AssertionError("phase 16 (d): the second run did not resume at step 12")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


def train_compressed_dp(dev) -> dict:
    """(e) three compressed-DP steps over the lanes [cuda:0, cuda:0] against
    the same over two CPU lanes, reduced codeqwen1.5-7b, f32."""
    import torch

    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.configs import TrainConfig
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.dist.sharding import Mesh, NamedSharding, P, device_put, gather, lanes_for
    from repro_torch.train import adamw_init, make_compressed_dp_train_step

    m_dev, m_cpu, _, p_cpu = _reduced_pair("codeqwen1.5-7b", dev)
    corpus = SyntheticCorpus(DataConfig(m_cpu.cfg.vocab_size, 64, 4, seed=6))
    tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    runs = {}
    for label, model, devices in (("card", m_dev, [dev, dev]), ("cpu", m_cpu, ["cpu", "cpu"])):
        mesh = Mesh(lanes_for(devices), ("data",))
        rep = NamedSharding(mesh, P())
        o = adamw_init(p_cpu)
        params = device_put(p_cpu, rep)
        opt = device_put(o, rep)
        ef = device_put(o.mu, rep)
        step = make_compressed_dp_train_step(model, tcfg, mesh)
        ms = []
        for i in range(3):
            params, opt, ef, m = step(params, opt, ef, corpus.batch(i))
            ms.append({k: float(v) for k, v in m.items()})
        lanes_equal = all(torch.equal(leaf.shards[0], leaf.shards[1]) for leaf in leaves(params))
        runs[label] = (tree_map(gather, params), ms, lanes_equal)
    (pd, md, eq_d), (pc, mc, _) = runs["card"], runs["cpu"]
    if not eq_d:
        raise AssertionError("phase 16 (e): the two lanes' params differ")
    for a, b in zip(md, mc):  # the int8 ring: grad_norm to the quantum's share
        metrics_close(a, b, "phase 16 (e)", norm_tol=1e-3)
    close = params_close(pd, pc, TRAIN_LR, 3, "phase 16 (e)")
    print(f"  3 steps over [cuda:0, cuda:0] vs two CPU lanes: losses {[m['loss'] for m in md]} "
          f"vs {[m['loss'] for m in mc]}; params {close}")
    return dict(losses=[m["loss"] for m in md], losses_cpu=[m["loss"] for m in mc], **close)


def _replicas_equal(tree, label: str) -> int:
    """Raise unless every lane that holds a block of a leaf holds the same
    bits; returns how many leaves have a block on two or more lanes."""
    import torch

    from repro_torch.common.tree import leaves

    n = 0
    for x in leaves(tree):
        groups: dict = {}
        for t, block in zip(x.shards, x.sharding.blocks(x.shape)):
            groups.setdefault(block, []).append(t)
        for ts in groups.values():
            if not all(torch.equal(ts[0], t) for t in ts[1:]):
                raise AssertionError(f"{label}: replicas of a {tuple(x.shape)} leaf differ")
        n += any(len(ts) > 1 for ts in groups.values())
    return n


def lane_step_profile(step_fn, state, batch, wall_ms: float, label: str) -> dict:
    """One lane train step under the profiler: the card's busy time as the
    union of kernel intervals over the lanes' streams, the idle share
    against ``wall_ms``, kernels a step, and the lane collectives' device
    time: the ops inside each collective's span in the forward, inside its
    autograd backward (``_BroadcastBackward`` etc.) and inside the step's
    grad reduction and grad norm (``train.step.reduce_grads`` /
    ``lane_grad_norm``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import collectives
    from repro_torch.train import step as step_mod

    saved = {}

    def span(mod, name, tag):
        fn = saved[(mod, name)] = getattr(mod, name)

        def spanned(*a, **kw):
            with torch.profiler.record_function(tag):
                return fn(*a, **kw)

        setattr(mod, name, spanned)

    for name in ("lane_reduce", "lane_gather", "lane_broadcast"):
        span(collectives, name, f"lane.{name}")
    span(step_mod, "reduce_grads", "lane.reduce_grads")
    span(step_mod, "lane_grad_norm", "lane.grad_norm")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state[0], state[1], _ = step_fn(state[0], state[1], batch)
            torch.cuda.synchronize()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError(f"{label}: the profiler recorded no device event")
    busy, end = 0.0, -1.0
    for a, b in spans:  # the union of the kernels' intervals (us)
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    per: dict = {}
    for e in events:  # each op directly inside a span or a backward node, once
        up = e.cpu_parent
        if (up is None or e.device_type == torch.autograd.DeviceType.CUDA
                or e.name.startswith("lane.")):
            continue
        key = (up.name if up.name.startswith("lane.") else
               next((f"backward.{k}" for k in ("_Broadcast", "_Reduce", "_Gather")
                     if up.name.startswith("autograd::engine::evaluate_function")
                     and f"{k}Backward" in up.name), None))
        if key is not None:
            ms, n = per.get(key, (0.0, 0))
            per[key] = (ms + e.device_time_total / 1e3, n + 1)
    coll = {k: round(v[0], 3) for k, v in per.items()}
    out = dict(busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms, kernels=len(spans),
               collectives_ms=coll, collectives_total_ms=sum(v[0] for v in per.values()),
               collective_ops={k: v[1] for k, v in per.items()})
    print(f"  {label}: device busy {busy_ms:.1f} ms (union over the lanes' streams) of a "
          f"{wall_ms:.1f} ms step (idle share {out['idle_share']:.3f}), {len(spans)} kernels; "
          f"the lane collectives {out['collectives_total_ms']:.2f} ms of device time {coll} "
          f"in {out['collective_ops']} ops")
    return out


def train_lanes_full_width(dev, smi: str) -> dict:
    """(f) (a)'s model, params and batch over four lanes of the card, (data
    2, model 2): the first loss against one lane's, timing, memory, a
    profile, the loss falling, the replicas equal."""
    import torch

    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import SpatzformerCluster
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models import LM
    from repro_torch.train import (adamw_init, global_norm, make_loss_fn, make_train_step,
                                   value_and_grad)

    cfg = replace(get_arch("codeqwen1.5-7b"), n_layers=TRAIN_LAYERS)
    info = SpatzformerCluster(n_pods=1, devices=[dev] * TRAIN_LANES).pod_info(0)
    one = LM(cfg, device=dev)
    params = one.init(torch.Generator(device=dev).manual_seed(0))
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in corpus.batch(0).items()}
    (ref_loss, _), grads = value_and_grad(make_loss_fn(one), params, batch)
    ref_loss, ref_gnorm = float(ref_loss), float(global_norm(grads))
    del grads
    torch.cuda.empty_cache()
    # the step places the one-lane state on the lanes at its first call
    state = [params, adamw_init(params)]
    del params
    step = make_train_step(one, TrainConfig(lr=3e-4, warmup_steps=TRAIN_WARM, total_steps=100),
                           mesh_info=info)
    tokens = TRAIN_B * TRAIN_S
    print(f"  {cfg.name} at {cfg.n_layers} layers, {cfg.dtype}, over {info.mesh.shape} lanes "
          f"of {dev}; one lane's loss and grad norm on these params and batch {ref_loss:.5f}, "
          f"{ref_gnorm:.5f}", flush=True)
    runs, gnorm0 = [], None
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(1 + TRAIN_LANES_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state[0], state[1], m = step(state[0], state[1], batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        runs.append((ms, loss))
        gnorm0 = float(m["grad_norm"]) if i == 0 else gnorm0
        print(f"  {'warm' if i == 0 else 'timed'} step {i + 1}: {ms:8.1f} ms, "
              f"{tokens / ms * 1e3:9.0f} tok/s, loss {loss:.5f} gnorm "
              f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.2e}", flush=True)
        if i == 0:  # the warm step also held the one-lane state it placed
            peak_warm = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [loss for _, loss in runs]
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    rel_g = abs(gnorm0 - ref_gnorm) / abs(ref_gnorm)
    if rel > TRAIN_LANES_LOSS_TOL or rel_g > TRAIN_LANES_GNORM_TOL:
        raise AssertionError(f"phase 16 (f): first loss / grad norm {losses[0]}, {gnorm0} over "
                             f"the lanes, {ref_loss}, {ref_gnorm} on one lane (rel {rel:.2e} / "
                             f"{rel_g:.2e} > {TRAIN_LANES_LOSS_TOL} / {TRAIN_LANES_GNORM_TOL})")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 16 (f): the loss did not fall on one batch: {losses}")
    walls = sorted(ms for ms, _ in runs[1:])
    wall = walls[len(walls) // 2]
    prof = lane_step_profile(step, state, batch, wall, "one step over four lanes")
    replicated = _replicas_equal(tuple(state), "phase 16 (f)")
    out = dict(model=cfg.name, layers=cfg.n_layers, lanes=dict(info.mesh.shape), batch=TRAIN_B,
               seq=TRAIN_S, step_ms=[ms for ms, _ in runs], median_ms=wall,
               tok_s=tokens / wall * 1e3, peak_gb=peak / 1e9, peak_warm_gb=peak_warm / 1e9,
               losses=losses, one_lane_loss=ref_loss, first_loss_rel=rel,
               first_grad_norm=gnorm0, one_lane_grad_norm=ref_gnorm, first_grad_norm_rel=rel_g,
               leaves_with_replicas=replicated, card=smi, **prof)
    print(f"  ({smi}) median step {wall:.1f} ms over {TRAIN_LANES} lanes: {out['tok_s']:.0f} "
          f"tok/s, peak {out['peak_gb']:.2f} GB (the warm step, placing the state: "
          f"{out['peak_warm_gb']:.2f} GB); first loss {losses[0]:.5f} vs one lane "
          f"{ref_loss:.5f} (rel {rel:.2e}), grad norm {gnorm0:.5f} vs {ref_gnorm:.5f} (rel "
          f"{rel_g:.2e}); {replicated} leaves with replicas, all equal")
    del state, batch
    torch.cuda.empty_cache()
    return out


def train_lanes_parity(dev) -> dict:
    """(g) part 1: the widened reduced codeqwen (f32, every matmul leaf
    sharded) over four lanes of the card against one lane of the card, 3
    steps at grad_accum 1 and 2."""
    import torch

    from repro_torch.common.tree import tree_map
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.core import SpatzformerCluster
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.dist.sharding import gather
    from repro_torch.models import LM
    from repro_torch.train import adamw_init, make_train_step

    cfg = replace(get_arch("codeqwen1.5-7b").reduced(), **CKPT_WIDTHS)
    info = SpatzformerCluster(n_pods=1, devices=[dev] * TRAIN_LANES).pod_info(0)
    init = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(5))
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, 64, 8, seed=7))
    out = {}
    for accum in (1, 2):
        tcfg = TrainConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10, grad_accum=accum)
        res = []
        for view in (info, None):
            p = tree_map(lambda t: t.clone(), init)
            o = adamw_init(p)
            step = make_train_step(LM(cfg, device=dev), tcfg, mesh_info=view)
            ms = []
            for i in range(3):
                b = {k: torch.from_numpy(v).to(dev) for k, v in corpus.batch(i).items()}
                p, o, m = step(p, o, b)
                ms.append({k: float(v) for k, v in m.items()})
            res.append((p, o, ms))
        (pl, ol, ml), (p1, _, m1) = res
        for a, b in zip(ml, m1):
            metrics_close(a, b, f"phase 16 (g) accum {accum}")
        replicated = _replicas_equal((pl, ol), f"phase 16 (g) accum {accum}")
        close = params_close(tree_map(gather, pl), p1, TRAIN_LR, 3,
                             f"phase 16 (g) accum {accum}")
        out[f"accum{accum}"] = dict(losses=[m["loss"] for m in ml],
                                    losses_one_lane=[m["loss"] for m in m1],
                                    grad_norms=[m["grad_norm"] for m in ml],
                                    grad_norms_one_lane=[m["grad_norm"] for m in m1],
                                    leaves_with_replicas=replicated, **close)
        print(f"  widened f32 over (data 2, model 2) vs one lane, grad_accum {accum}: "
              f"{out[f'accum{accum}']}", flush=True)
    return out


def train_lanes_launcher(dev) -> dict:
    """(g) part 2: ``launch.train`` over four lanes of the card, in-process:
    8 steps, then ``--resume`` to 12 onto the same placement."""
    import shutil
    import tempfile

    from repro_torch.launch import train as launch_train

    d = tempfile.mkdtemp(prefix="chip_smoke_train_lanes_")
    base = ["--arch", "codeqwen1.5-7b", "--reduced", "--batch", "8", "--seq", "64",
            "--ckpt-dir", d, "--log-every", "4", "--ckpt-every", "4", "--pods", "1",
            "--devices", ",".join([str(dev)] * TRAIN_LANES)]
    try:
        first = launch_train.main(base + ["--steps", "8"])
        again = launch_train.main(base + ["--steps", "12", "--resume"])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if again["start_step"] != 8 or not all(np.isfinite(first["losses"] + again["losses"])):
        raise AssertionError(f"phase 16 (g): launch.train over lanes: {first} then {again}")
    return dict(losses=first["losses"], resumed_at=again["start_step"],
                resumed_losses=again["losses"])


EXAMPLES = {
    "torch_quickstart": ["--seq", "16"],
    "torch_train_lm": ["--steps", "12", "--batch", "4", "--seq", "32"],
    "torch_serve_batch": ["--requests", "5", "--max-new", "6"],
    "torch_mixed_workload_demo": ["--rows", "256", "--cols", "128", "--fft", "256"],
    "torch_elastic_restart": [],
    "torch_dual_tenant": ["--steps", "2", "--max-new", "4"],
}


def run_examples(dev) -> dict:
    """(g) part 3: each ``examples/torch_*.py``'s ``main(argv)`` on the card at
    a tiny size, over two lanes of it (quickstart, train_lm, serve_batch
    also on one)."""
    import importlib.util
    import tempfile

    two = ["--devices", f"{dev},{dev}"]
    out = {}
    for name, args in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        extra = ["--ckpt-dir", tempfile.mkdtemp(prefix="chip_smoke_ex_")] \
            if name == "torch_train_lm" else []
        for lanes in ((["--device", str(dev)], two) if name in (
                "torch_quickstart", "torch_train_lm", "torch_serve_batch") else (two,)):
            t = time.perf_counter()
            res = mod.main(args + extra + lanes)
            label = f"{name} {' '.join(lanes)}"
            out[label] = dict(seconds=time.perf_counter() - t)
            print(f"  {label}: {time.perf_counter() - t:.1f} s", flush=True)
            if name == "torch_quickstart" and not res["finite"]:
                raise AssertionError(f"phase 16 (g): {label}: a non-finite forward")
            if name == "torch_train_lm" and not res["final_loss"] < res["first_loss"]:
                raise AssertionError(f"phase 16 (g): {label}: the loss did not fall: {res}")
            if name == "torch_mixed_workload_demo" and not res.get("fft_agree"):
                raise AssertionError(f"phase 16 (g): {label}: the staged FFT disagrees")
            if name == "torch_elastic_restart" and res["steps"] != 25:
                raise AssertionError(f"phase 16 (g): {label}: {res}")
            extra = []
    return out


def full_training(dev, smi: str) -> dict:
    """Phase 16: training on the card, (a)-(g). No hand-written kernel may
    launch in the process while (a)-(g) train (the launcher of (d) runs in
    its own); the examples of (g), which serve, come after that check."""
    counts = kernel_launch_counts()
    reset_counts(counts)
    out = {}
    for key, label, fn in (("full_width", "(a) full width", lambda: train_full_width(dev, smi)),
                           ("parity", "(b) card vs CPU", lambda: train_parity(dev)),
                           ("checkpoint", "(c) checkpoint", lambda: train_checkpoint(dev)),
                           ("launcher", "(d) launch.train", train_launcher),
                           ("compressed_dp", "(e) compressed DP over lanes",
                            lambda: train_compressed_dp(dev)),
                           ("lanes_full_width", "(f) full width over four lanes",
                            lambda: train_lanes_full_width(dev, smi)),
                           ("lanes_parity", "(g) f32 over four lanes vs one",
                            lambda: train_lanes_parity(dev)),
                           ("lanes_launcher", "(g) launch.train over four lanes",
                            lambda: train_lanes_launcher(dev))):
        t = time.perf_counter()
        print(f"  -- {label}", flush=True)
        out[key] = fn()
        out[key + "_seconds"] = time.perf_counter() - t
    launched = {k: getattr(m, a) for k, (m, a) in counts.items() if getattr(m, a)}
    print(f"  kernel launches during phase 16's training: {launched or 'none'}")
    if launched:
        raise AssertionError(f"phase 16: the training path launched kernels: {launched}")
    t = time.perf_counter()
    print("  -- (g) the examples", flush=True)
    out["examples"] = run_examples(dev)
    out["examples_seconds"] = time.perf_counter() - t
    launched = {k: getattr(m, a) for k, (m, a) in counts.items() if getattr(m, a)}
    print(f"  kernel launches by the examples: {launched}")
    return out


def train_alone() -> int:
    """Phase 16 alone, after the card check (no kernel build up front: the
    training path launches none; the examples of (g), which serve, build
    the kernels at their first launch); prints the ``{"train": ...}`` line.

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.train_alone())"
    """
    setup = card_setup()
    if setup is None:
        return 1
    dev, smi = setup
    phase("16 training on the card")
    print(json.dumps({"train": full_training(dev, smi)}, default=float))
    phase("done")
    return 0


# ---------------------------------------------------------------- phase 17

# (a) musicgen-large whole (48 layers, d 2048, bf16): a prefill of EMBED_S
# positions, then EMBED_STEPS decode steps. Its seeded random embeds through
# the prefill (the flash kernel) against LM.forward (chunked plain attention)
# on the same embeds: bf16 sums in two orders, held at the merged engine's
# tolerance (MERGED_REL_TOL of the largest logit)
EMBED_S, EMBED_STEPS = 512, 16
# (b) codeqwen1.5-7b at 4 layers with a sliding window
WINDOW, WINDOW_S = 1024, 4096
# (d) the dry run on one placeholder lane against the card: its peak within
# this share of the card's (the caching allocator rounds each block up)
DRYRUN_PEAK_TOL = 0.10
# (e) ZeRO over four lanes of the card against the replicated step:
# codeqwen1.5-7b at ZERO_LAYERS of its 32 layers, widths full (the
# replicated step holds four copies of params and f32 moments: at 4 layers
# ~82 GB), batch ZERO_B x ZERO_S, 2 steps each
ZERO_LAYERS, ZERO_B, ZERO_S, ZERO_STEPS = 1, 4, 512, 2
# (e) ZeRO-3 once more with the root lane's stream held back by this many
# cycles (~20 ms at the H100's 1.98 GHz) before each lane reduce: a
# consumer that does not wait for the root's sum then reads it unwritten
ZERO_HOLD_CYCLES = 4 * 10**7
# (c) the production cells run on meta, and what each must record
DRYRUN_CELLS = (("codeqwen1.5-7b", "prefill_32k", True), ("codeqwen1.5-7b", "decode_32k", True),
                ("musicgen-large", "decode_32k", True), ("qwen3-32b", "decode_32k", False))


def _layer(params, i: int):
    from repro_torch.common.tree import tree_map

    return tree_map(lambda t: t[i], params["blocks"])


def embeds_serving(dev, counters) -> dict:
    """(a) musicgen-large whole, one lane: prefill + decode steps on the
    embedding rows of a token stream bitwise equal to the token path; the
    same on the merged view over [cuda:0, cuda:0] within MERGED_REL_TOL;
    seeded random embeds through prefill against LM.forward."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import device_put, serve_param_shardings, serving_mesh_info
    from repro_torch.models import LM

    cfg = get_arch("musicgen-large")
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    tab = params["embed"]["tok"]
    rng = np.random.default_rng(17)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, EMBED_S + EMBED_STEPS))
                            .astype(np.int32)).to(dev)

    def batch(t, embeds: bool) -> dict:
        return {"embeds": tab[t.long()]} if embeds else {"tokens": t}

    def run(m, p, embeds: bool):
        with torch.no_grad():
            logits, cache = m.prefill(p, batch(toks[:, :EMBED_S], embeds), EMBED_S + EMBED_STEPS)
            out = [logits[:, -1].float()]
            for t in range(EMBED_STEPS):
                cur = torch.full((1,), EMBED_S + t, dtype=torch.int32, device=dev)
                step, cache = m.decode_step(p, cache, batch(toks[:, EMBED_S + t:EMBED_S + t + 1],
                                                            embeds), cur)
                out.append(step[:, 0].float())
        return torch.stack(out)

    reset_counts(counters)
    want = run(model, params, False)
    got = run(model, params, True)
    torch.cuda.synchronize()
    launches = read_counts(counters, "phase 17 (a): prefill + decode, tokens then embeds")
    if not torch.equal(got, want):
        raise AssertionError(f"phase 17 (a): embeds off the token path by "
                             f"{(got - want).abs().max().item()}")
    info = serving_mesh_info([dev, dev])
    merged_p = device_put(params, serve_param_shardings(params, info))
    merged = run(LM(cfg, mesh_info=info), merged_p, True)
    del merged_p
    merged_rel = ((merged - got).abs().max() / got.abs().max()).item()
    e = torch.randn((1, EMBED_S, cfg.d_model), generator=torch.Generator().manual_seed(17)).to(
        dev, torch.bfloat16)
    with torch.no_grad():
        pre = model.prefill(params, {"embeds": e}, EMBED_S)[0].float()
        fwd = model.forward(params, {"embeds": e})[0].float()
    fwd_rel = ((pre - fwd).abs().max() / fwd.abs().max()).item()
    res = dict(bitwise=True, steps=EMBED_STEPS, prefill=EMBED_S, merged_rel=merged_rel,
               forward_rel=fwd_rel, launches=launches)
    print(f"  (a) {cfg.name} whole ({cfg.num_params() / 1e9:.2f}B, bf16): prefill {EMBED_S} + "
          f"{EMBED_STEPS} decode steps on embeds bitwise the token path's; merged over "
          f"[{dev}, {dev}] max |diff| / max |logit| {merged_rel:.4f}; random embeds, prefill vs "
          f"forward {fwd_rel:.4f} (tolerance {MERGED_REL_TOL})", flush=True)
    if not max(merged_rel, fwd_rel) <= MERGED_REL_TOL:
        raise AssertionError(f"phase 17 (a): {res}")
    del params, tab
    torch.cuda.empty_cache()
    return res


def windowed_prefill(dev, fk) -> dict:
    """(b) codeqwen1.5-7b at 4 layers with a sliding window: the prefill's
    logits against LM.forward's and its cache against each layer's
    projected (k, v) along forward's residual; no flash launch."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import LM
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import apply_rope, rms_norm

    cfg = replace(get_arch("codeqwen1.5-7b"), n_layers=4, sliding_window=WINDOW)
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(18))
    toks = torch.from_numpy(np.random.default_rng(18).integers(0, cfg.vocab_size, (1, WINDOW_S))
                            .astype(np.int32)).to(dev)
    flash0 = fk.launches
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, WINDOW_S)
        fwd = model.forward(params, {"tokens": toks})[0]
        torch.cuda.synchronize()
        if fk.launches != flash0:
            raise AssertionError("phase 17 (b): a windowed prefill launched the flash kernel")
        pos = torch.arange(WINDOW_S, dtype=torch.int32, device=dev)
        x = params["embed"]["tok"][toks.long()]
        kv_diff = 0.0
        for li in range(cfg.n_layers):
            blk = _layer(params, li)
            _, k, v = attn._project(blk["attn"], cfg, rms_norm(x, blk["norm1"], cfg.norm_eps))
            k = apply_rope(k, pos[None], cfg.rope_theta)
            kv_diff = max(kv_diff, (cache["k"][li] - k).abs().max().item(),
                          (cache["v"][li] - v).abs().max().item())
            x = model._dense_block(blk, x, pos)
    logit_diff = (logits.float() - fwd.float()).abs().max().item()
    res = dict(window=WINDOW, seq=WINDOW_S, logits_max_abs_diff=logit_diff,
               kv_max_abs_diff=kv_diff, bitwise=logit_diff == 0 and kv_diff == 0)
    print(f"  (b) {cfg.name} at 4 layers, window {WINDOW}, S {WINDOW_S}: prefill vs forward "
          f"logits max |diff| {logit_diff}, cache vs projected (k, v) {kv_diff} (both chunked, "
          f"no flash launch)", flush=True)
    if not res["bitwise"]:
        raise AssertionError(f"phase 17 (b): the windowed prefill is off forward's: {res}")
    del params, cache
    torch.cuda.empty_cache()
    return res


def dryrun_production() -> dict:
    """(c) the dry run's cells on the production 16 x 16 mesh of placeholder
    lanes: each record printed, ok where the port runs the cell, else
    ``ok: false`` naming ROADMAP Queue 1 item 7."""
    from repro_torch.launch import dryrun

    out = {}
    for arch, shape, ok in DRYRUN_CELLS:
        try:
            rec = dryrun.lower_cell(arch, shape, False)
            rec.pop("lane_mem")
        except NotImplementedError as e:
            rec = dryrun.failed(arch, shape, "16x16", e)
        print("  " + json.dumps(rec), flush=True)
        if rec["ok"] != ok or (not ok and "ROADMAP Queue 1 item 7" not in rec["error"]):
            raise AssertionError(f"phase 17 (c): {arch}/{shape}: {rec}")
        out[f"{arch}/{shape}"] = rec
    return out


def dryrun_vs_card(dev, smi: str) -> dict:
    """(d) codeqwen1.5-7b at 4 layers on one placeholder lane against the
    card: phase 16 (a)'s train step (B 2, S 2048, bf16) and a forward of B 1,
    S 8192 — argument bytes equal to the state placed on the card, counted
    FLOPs equal to FlopCounterMode's on the card, the peak within
    DRYRUN_PEAK_TOL of max_memory_allocated over the step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.common.tree import leaves
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.dist.sharding import Mesh, lane_grid, lanes_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_info_for
    from repro_torch.models import LM
    from repro_torch.train import adamw_init, make_train_step

    cfg = replace(get_arch("codeqwen1.5-7b"), n_layers=TRAIN_LAYERS)
    mesh = Mesh(lane_grid(lanes_for(["meta"]), (1, 1)), ("data", "model"))
    plan = dryrun.Plan(cfg, mesh_info_for(mesh))  # phase 16 (a)'s step: TP, grad_accum 1
    shapes = {"train": ShapeConfig("train_2k", TRAIN_S, TRAIN_B, "train"),
              "forward": ShapeConfig("forward_8k", 8192, 1, "prefill")}
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    out = {}
    for key, shape in shapes.items():
        rec = dryrun.run_cell(cfg, shape, mesh, plan=plan)
        rec.pop("lane_mem")
        if key == "train":
            opt = adamw_init(params)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     SyntheticCorpus(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
                     .batch(0).items()}
            step = make_train_step(model, TrainConfig())
            state = [params, opt]
            args = leaves((params, opt, batch))

            def run():
                state[0], state[1], m = step(state[0], state[1], batch)
                return m
            run()  # warm: the first checkpointed backward's one-time work
        else:
            batch = {"tokens": torch.zeros((1, 8192), dtype=torch.int32, device=dev)}
            args = leaves((params, batch))

            def run():
                with torch.no_grad():
                    return model.forward(params, batch)
        arg_bytes = sum(t.numel() * t.element_size() for t in args)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        res = run()
        torch.cuda.synchronize()
        card_temp = torch.cuda.max_memory_allocated(dev) - before
        del res
        with FlopCounterMode(display=False) as fc:
            res = run()
            torch.cuda.synchronize()
        del res
        card_peak = arg_bytes + card_temp
        dry = rec["mem"]
        row = dict(record=rec, card_argument_bytes=arg_bytes, card_temp_bytes=card_temp,
                   card_peak_bytes=card_peak, card_flops=fc.get_total_flops(),
                   flops_diff=rec["counted_flops"] - fc.get_total_flops(),
                   peak_rel=dry["peak_bytes"] / card_peak - 1)
        print(f"  (d) {key} ({shape.global_batch} x {shape.seq_len}, {cfg.n_layers} layers, "
              f"bf16; {smi}): argument bytes {dry['argument_bytes']} dry run / {arg_bytes} card; "
              f"counted FLOPs {rec['counted_flops']} / {fc.get_total_flops()} (difference "
              f"{row['flops_diff']}: no hand-written kernel on this path); peak "
              f"{dry['peak_bytes'] / 1e9:.3f} / {card_peak / 1e9:.3f} GB ({row['peak_rel']:+.3%}; "
              f"temp {dry['temp_bytes'] / 1e9:.3f} / {card_temp / 1e9:.3f}); trace "
              f"{rec['trace_s']} s", flush=True)
        if (dry["argument_bytes"] != arg_bytes or row["flops_diff"] != 0
                or abs(row["peak_rel"]) > DRYRUN_PEAK_TOL or dry["unclaimed_bytes"]):
            raise AssertionError(f"phase 17 (d) {key}: {row}")
        out[key] = row
        if key == "train":
            del state, opt, step
        del batch, args
    del params
    torch.cuda.empty_cache()
    return out


def zero_lanes_in_a_fresh_process() -> dict:
    """(e) in a new process, with cuBLAS's workspace fixed
    (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, so no product's algorithm depends
    on the workspace it finds free) and the replicated state's ~50 GB
    kept out of this process's allocator."""
    import os

    out = subprocess.run(
        [sys.executable, "-c",
         "import json, chip_smoke; print(json.dumps(chip_smoke.zero_lanes()))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    print(out.stdout.rsplit("\n", 2)[0], flush=True)
    if out.returncode != 0:
        raise AssertionError(f"phase 17 (e) failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def root_held_back(cycles: int):
    """Every lane reduce (``dist.collectives._reduce``: a broadcast's
    backward, the step's metrics) first queues ``cycles`` of sleep on its
    root lane's stream, so work that reads the sum without waiting for that
    stream reads it unwritten."""
    import torch

    from repro_torch.dist import collectives

    plain = collectives._reduce

    def held(parts, lanes):
        if lanes[0].stream is not None:
            with torch.cuda.stream(lanes[0].stream):
                torch.cuda._sleep(cycles)
        return plain(parts, lanes)

    collectives._reduce = held
    try:
        yield
    finally:
        collectives._reduce = plain


def zero_lanes(dev="cuda") -> dict:
    """(e) ZeRO-1 and ZeRO-3 over four lanes of the card (TP off: one lane a
    row) against the replicated step on the same lanes, and ZeRO-3 again
    with the root lane held back (:func:`root_held_back`): losses and params
    bitwise equal over ZERO_STEPS steps; ms a step. Raises after every run,
    naming each that differs."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.dist.sharding import Mesh, MeshInfo, gather, lane_grid, lanes_for
    from repro_torch.models import LM
    from repro_torch.train import adamw_init, make_train_step

    cfg = replace(get_arch("codeqwen1.5-7b"), n_layers=ZERO_LAYERS)
    init = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(19))
    corpus = SyntheticCorpus(DataConfig(cfg.vocab_size, ZERO_S, ZERO_B, seed=19))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in corpus.batch(i).items()}
               for i in range(ZERO_STEPS)]
    out, ref, off = {}, None, []
    for key, zero, hold in (("none", "none", 0), ("zero1", "zero1", 0), ("zero3", "zero3", 0),
                            ("zero3_held", "zero3", ZERO_HOLD_CYCLES)):
        info = MeshInfo(Mesh(lane_grid(lanes_for([dev] * 4), (2, 2)), ("data", "model")),
                        batch_axes=("data", "model"), tp_enabled=False, zero=zero)
        p = tree_map(lambda t: t.clone(), init)
        o = adamw_init(p)
        step = make_train_step(LM(cfg, device=dev), TrainConfig(lr=3e-4, warmup_steps=2,
                                                                total_steps=100), mesh_info=info)
        losses, ms = [], []
        with root_held_back(hold) if hold else contextlib.nullcontext():
            for b in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                p, o, m = step(p, o, b)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
        whole = [gather(x) for x in leaves(p)]
        del p, o, step
        torch.cuda.empty_cache()
        if ref is None:
            ref = (losses, whole)
            equal, diff, n_off = True, 0.0, 0
        else:
            same = [torch.equal(a, b) for a, b in zip(whole, ref[1])]
            equal = losses == ref[0] and all(same)
            diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(whole, ref[1]))
            n_off = same.count(False)
        out[key] = dict(losses=losses, step_ms=ms, bitwise=equal, max_abs_diff=diff,
                        leaves_off=n_off, hold_cycles=hold)
        held = f"; the root held back {hold} cycles a reduce" if hold else ""
        print(f"  (e) {key}: losses {losses}, ms a step {[round(x, 1) for x in ms]} (the first "
              f"places the state{held}), params and losses bitwise the replicated step's: "
              f"{equal} (max |diff| {diff}, {n_off} of {len(whole)} leaves off)", flush=True)
        if not equal:
            off.append(key)
        del whole
    del init, ref
    torch.cuda.empty_cache()
    if off:
        raise AssertionError(f"phase 17 (e): {off} off the replicated step")
    return out


def full_dryrun(dev, smi: str, counters, fk) -> dict:
    """Phase 17: embeds on the serving calls, the windowed prefill, the dry
    run and ZeRO over lanes, (a)-(e)."""
    out = {}
    for key, label, fn in (("embeds", "(a) embeds on prefill / decode_step",
                            lambda: embeds_serving(dev, counters)),
                           ("window", "(b) windowed prefill", lambda: windowed_prefill(dev, fk)),
                           ("production", "(c) the dry run on the 16 x 16 mesh", dryrun_production),
                           ("vs_card", "(d) the dry run against the card",
                            lambda: dryrun_vs_card(dev, smi)),
                           ("zero", "(e) ZeRO-1 / ZeRO-3 over four lanes",
                            zero_lanes_in_a_fresh_process)):
        t = time.perf_counter()
        print(f"  -- {label}", flush=True)
        out[key] = fn()
        out[key + "_seconds"] = time.perf_counter() - t
    return out


def dryrun_alone() -> int:
    """Phase 17 alone, after the card check and the kernels' build; prints
    the ``{"dryrun": ...}`` line.

        python3 -c "import sys, chip_smoke; sys.exit(chip_smoke.dryrun_alone())"
    """
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    setup = card_setup()
    if setup is None:
        return 1
    dev, smi = setup
    t = time.perf_counter()
    _build.load()
    print(f"  built in {time.perf_counter() - t:.1f} s", flush=True)
    phase("17 embeds, windowed prefill and the dry run")
    t = time.perf_counter()
    counters = {"gqa_flash_attention": (fk, "launches"), "decode_attention": (dk, "launches")}
    print(json.dumps({"dryrun": full_dryrun(dev, smi, counters, fk)}, default=float))
    print(f"  phase 17: {time.perf_counter() - t:.1f} s")
    phase("done")
    return 0


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


def card_setup():
    """Phase 0: the card, TF32 off, and the card's name and power limit as
    ``nvidia-smi`` gives them, printed. Returns (device, that line), or None
    without a CUDA device."""
    import torch

    phase("0 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return torch.device("cuda"), smi


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

    setup = card_setup()
    if setup is None:
        return 1
    dev, smi = setup

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
    hybrid_shapes = timed.pop("zamba2")  # rows 1 and 3 at zamba2-2.7b's shapes
    lane_shapes = timed.pop("lane")  # rows 1-3 at one lane's shard of the merged engine
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

    phase("14 full width state-space: falcon-mamba-7b (unified), zamba2-2.7b (legacy tier)")
    ssm_launches, ssm = full_width_ssm(dev, counters4, smi)
    print(json.dumps({"ssm": ssm}, default=float))

    phase("15 the split/merge fabric over lanes of one card")
    fabric, fabric_launches = full_fabric(dev, fabric_counters(), smi)
    print(json.dumps({"fabric": fabric}, default=float))

    phase("16 training on the card")
    print(json.dumps({"train": full_training(dev, smi)}, default=float))

    phase("17 embeds, windowed prefill and the dry run")
    t17 = time.perf_counter()
    counters17 = {"gqa_flash_attention": (fk, "launches"), "decode_attention": (dk, "launches")}
    dry = full_dryrun(dev, smi, counters17, fk)
    print(json.dumps({"dryrun": dry}, default=float))
    print(f"  phase 17: {time.perf_counter() - t17:.1f} s", flush=True)

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
        # phase 14 (b)'s launches (zamba2-2.7b's shared attention block: its
        # admissions on flash, every decode launch on the split body), and
        # each row timed at zamba2's shapes in phase 2
        if name in dry["embeds"]["launches"]:  # phase 17 (a): musicgen-large on embeds
            kernels[-1]["launches_embeds"] = dry["embeds"]["launches"][name]
        if name in fabric_launches:  # phase 15 (c): the mixed scheduler's vector queue
            kernels[-1]["launches_fabric"] = fabric_launches[name]
        if name in hybrid_shapes:
            kernels[-1]["launches_hybrid"] = ssm_launches["b"][name]
            kernels[-1]["zamba2_shape"] = hybrid_shapes[name]
        # phase 12 (b)'s merged engine over two lanes of the card: each lane's
        # launches (a list in lane order) and the row timed in phase 2 at one
        # lane's shard (16 KV heads)
        if name in cluster["merged_launches"]:
            kernels[-1]["launches_merged"] = cluster["merged_launches"][name]
            kernels[-1]["lane_shape"] = lane_shapes[name]
        if name == "paged_attention":
            kernels[-1]["launches_merged"] = cluster["merged_paged"]["paged_launches"]
        if f"{name}_lane" in timed:
            kernels[-1]["lane_shape"] = timed[f"{name}_lane"]
    print(json.dumps({"kernels": kernels, "to_port": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
