#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

0. device — fail without CUDA; print the card's name and power limit.
1. build — compile the three hand-written CUDA kernels from ``csrc/``.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the serving path's shapes (codeqwen1.5-7b: KV=32, G=1, d=128, 4 slots x
   1024 positions; a 64-token ragged pack; 64- and 37-token prefill), plus
   the GQA shape KV=8, G=8, a sliding window, f32 and bf16. Times each
   kernel, its plain version and a one-call PyTorch yardstick with CUDA
   events, and computes its bound at the card's published peaks.
3. kernel path vs plain path — a small f32 model served greedily through
   ServeEngine on the card and on the CPU; the token streams must be equal.
4. full width — codeqwen1.5-7b, 32 layers, bf16, random weights from a seed,
   4 slots x 1024 positions; about 12 greedy requests whose prompts straddle
   the prefill budget, so fused admissions, ragged packs and decode chunks
   all run; each kernel's launch count over this run must be > 0.
5. a ``{"kernels": [...]}`` JSON line, then the result line.

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
# teacher-forced top-1 agreement floor of phase 4: a random-weight bf16 model
# over a 92k vocab has top-2 logit gaps of ~0.2 while bf16 logits near 4 are
# spaced 0.03 apart, so near-ties flip between two matmul/attention orders;
# a wrong kernel agrees on ~1/92416 of the positions
AGREE_FLOOR = 0.5


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
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
    B, S = 4, 1024
    cur = [0, 333, 700, S - 1]  # empty prefix, non-tile multiple, full slot

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

    # ---- ragged attention: a 64-token pack over 2 slots, as the engine builds it
    def pack(s_max):
        slots = [1] * 40 + [3] * 16 + [1] * 8  # 8 padding tokens ride pack_slots[0]
        poss = list(range(0, 40)) + list(range(600, 616)) + [s_max] * 8
        return (torch.tensor(slots, dtype=torch.int32, device=dev),
                torch.tensor(poss, dtype=torch.int32, device=dev))

    for kv, g, dtype, window, main in [
        (32, 1, bf16, 0, True), (32, 1, f32, 0, False), (8, 8, bf16, 0, False),
        (8, 8, f32, 0, False), (32, 1, bf16, 100, False), (8, 8, f32, 24, False),
    ]:
        ts, tp = pack(S)
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
    rng = np.random.default_rng(1)
    lens = (5, 9, 16, 17, 23, 41, 12, 50, 3, 33)  # straddle prefill_budget=16
    prompts = [rng.integers(0, cfg.vocab_size, size=s).astype(np.int32) for s in lens]

    def serve(model, params, device):
        eng = ServeEngine(model, params, batch_slots=4, max_len=128, prefill_budget=16,
                          device=device)
        for i, pr in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=pr, params=SamplingParams(max_new=10)))
        eng.run()
        return {r.rid: r.generated for r in eng.finished}

    on_cpu = serve(cpu_model, params_cpu, "cpu")
    on_dev = serve(LM(cfg, device=dev), params_dev, dev)
    if on_dev != on_cpu:
        diff = [rid for rid in on_cpu if on_cpu[rid] != on_dev.get(rid)]
        raise AssertionError(f"kernel path and plain path streams differ for rids {diff}")
    print(f"  {len(on_cpu)} greedy streams identical on the card (kernels) and the CPU (plain)")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ----------------------------------------------------------------- phase 4


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
    rng = np.random.default_rng(2)
    lens = (5, 700, 37, 130, 64, 300, 12, 513, 65, 200, 48, 90)  # 7 of 12 above the budget
    max_new = 32
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=s).astype(np.int32),
                params=SamplingParams(max_new=max_new))
        for i, s in enumerate(lens)
    ]
    torch.cuda.reset_peak_memory_stats()
    for mod in counters.values():
        mod.launches = 0
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    launches = {name: mod.launches for name, mod in counters.items()}
    print(f"  launches during the run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    for r in reqs:
        if r.finish_reason != "length" or len(r.generated) != max_new:
            raise AssertionError(f"rid {r.rid}: {r.finish_reason}, {len(r.generated)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"rid {r.rid}: token out of range")
    peak = torch.cuda.max_memory_allocated()
    print(f"  {stats.total_requests} requests, {stats.total_tokens} decode tokens in "
          f"{stats.wall_seconds:.3f} s: {stats.tokens_per_sec:.1f} tok/s; TTFT p50 "
          f"{stats.ttft_p50 * 1e3:.1f} ms p99 {stats.ttft_p99 * 1e3:.1f} ms; TPOT p50 "
          f"{stats.tpot_p50 * 1e3:.2f} ms; peak memory {peak / 2**30:.2f} GiB")

    # teacher-forced check: LM.prefill (flash kernel) over prompt + generated
    # must predict the engine's stream (packs + decode kernel)
    r = reqs[5]
    seq = np.concatenate([r.prompt, np.asarray(r.generated, np.int32)])
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(seq[None]).to(dev)},
                                  len(seq))
    rows = logits[0, len(r.prompt) - 1: len(seq) - 1].float()
    pred = rows.argmax(-1).cpu().numpy()
    top2 = rows.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    agree = pred == np.asarray(r.generated)
    print(f"  teacher-forced top-1 agreement {agree.mean():.3f} over {len(agree)} positions "
          f"(floor {AGREE_FLOOR}); top-2 margins at disagreements: "
          f"{np.round(margin[~agree], 3).tolist()}")
    if agree.mean() < AGREE_FLOOR:
        raise AssertionError("teacher-forced agreement below the floor")

    decode_step_profile(eng, cfg, dev)
    return launches, stats, peak


def decode_step_profile(eng, cfg, dev, steps: int = 8) -> None:
    """Where a decode step (all 4 slots decoding) goes: wall time per step
    of an 8-step chunk, the device's busy time per step from the profiler,
    and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    active = torch.ones(eng.B, dtype=torch.int32, device=dev)

    def chunk():
        eng._tick_fn(eng._last_tok, eng._cur_len, active, steps)
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
    print(f"  decode step: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.2f}), {sum(r[1] for r in kernels) // steps} "
          f"kernels; weight-read floor {cfg.num_params() * 2 / HBM_BYTES_PER_S * 1e3:.2f} ms")
    for us, n, key in sorted(kernels, reverse=True)[:8]:
        print(f"    {us / 1e3 / steps:7.3f} ms/step  {n // steps:4d} calls/step  {key[:80]}")


# -------------------------------------------------------------------- main


def main() -> int:
    import torch

    # the port comes from this checkout's src/: without it nothing runs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ragged_attention as rk

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
    print(f"  ptxas: {len(regs)} kernels, max {max(regs)} registers, {spills} bytes spill stores")

    phase("2 kernels vs plain on the card")
    timed = check_kernels(dev)

    phase("3 kernel path vs plain path, end to end, f32")
    small_model_streams(dev)

    phase("4 full width codeqwen1.5-7b")
    counters = {"decode_attention": dk, "ragged_attention": rk, "gqa_flash_attention": fk}
    launches, _, _ = full_width(dev, counters)

    # the pl.pallas_call line of each TPU kernel, as in PERF.md's kernel table
    sources = {
        "decode_attention": ("decode_attention.cu", "src/repro/kernels/decode_attention.py:186"),
        "ragged_attention": ("ragged_attention.cu", "src/repro/kernels/ragged_attention.py:253"),
        "gqa_flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:197"),
    }
    kernels = []
    for name, (src, tpu) in sources.items():
        t = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            # one line under both names that readers of this JSON look up
            "replaces": tpu, "tpu_kernel": tpu, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "tol": t["tol"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
