#!/usr/bin/env python3
"""Time the latent-MQA kernel's bf16 body (``csrc/mla_attention.cu``) of a
checkout, and read one block's timeline from an instrumented copy of it.

Both modes build a copy of the checkout's ``repro_torch`` under
``build/mla_timeline/<tag>/src`` whose ``csrc/`` holds ``mla_attention.cu``
alone (and whose ``_build.SIGNATURES`` names its one entry), so a build takes
seconds, not the whole library's minutes:

    python scripts/torch_mla_timeline.py --src src --time
    python scripts/torch_mla_timeline.py --src src --timeline

``--time`` prints one JSON line: ptxas' registers and spills of the MLA
kernels, then, over 4 slots x 1024 positions, phase 2's 64-token pack at
minicpm3-4b's widths (latent 256 + rope 32, 40 heads), deepseek-v2-lite's
(512 + 64, 16 heads) and the reduced 32 + 8 at 4 heads, a 64-token chunk at
positions 900-963 and 4 singletons, each at the plan's split count and at 1,
2 and 4: the median of ``--rounds`` CUDA-graph timings (``chip_smoke.time_ms``,
100 calls), the max error against the plain version and the sha256 of the
output. Run it for two checkouts in turns (A, B, B, A) to compare them.

``--timeline`` instruments the copy: every block stamps its entry and exit
(%globaltimer), and one chosen block its events in SM cycles (clock64): the
token table read, the Q tile landed, each stage's wait, S, softmax and P V,
its refill, the warpgroups' exchange, the ticket and, for the block that
merges, the wait for the other partials, the weights, the sums and the
store. The instrumentation is a set of text patches of the kernel: each one
must apply, or the script stops and names it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

HEADER = """
__device__ unsigned long long g_dbg[8192];
__device__ int g_tgt[2];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct DbgExit {
  int b;
  __device__ ~DbgExit() { if (threadIdx.x == 0) g_dbg[1024 + b] = gtime(); }
};
#define DBG(i) do { if (is_tgt) g_dbg[2048 + (i)] = clock64(); } while (0)
"""

ENTRIES = """
extern "C" int repro_mla_dbg_set(int tx, int ty) {
  int v[2] = {tx, ty};
  static unsigned long long z[8192] = {};
  cudaMemcpyToSymbol(repro::mla::g_dbg, z, sizeof(z));
  return cudaMemcpyToSymbol(repro::mla::g_tgt, v, sizeof(v));
}
extern "C" int repro_mla_dbg_get(void* host) {
  cudaDeviceSynchronize();
  return cudaMemcpyFromSymbol(host, repro::mla::g_dbg, 8192 * 8);
}
"""

# (anchor in the kernel, text to put before it, or after it with a leading "+")
PATCHES = [
    ("  const int s = blockIdx.y, splits = gridDim.y;\n  const int M = T * H;",
     "  const int bid_ = blockIdx.y * gridDim.x + blockIdx.x;\n"
     "  if (tid == 0) g_dbg[bid_] = gtime();\n"
     "  DbgExit dbg_exit_{bid_};\n"
     "  const bool is_tgt_blk = blockIdx.x == g_tgt[0] && blockIdx.y == g_tgt[1];\n"
     "  bool is_tgt = is_tgt_blk && (tid & 127) == 0;\n"
     "  DBG(0);\n"),
    ("  if (s >= max(n_live, 1) || n_live == 0) {", "  DBG(1);\n"),
    ("  int it = 0;\n  for (int i = 0; i < tn; ++i) {", "  DBG(2);\n"),
    ("      const uint8_t* kt = ring + st * W::kTile;", "      if (it < 16) DBG(3 + 4 * it);\n"),
    ("+      fence_operand(sc);", "      if (it < 16) DBG(4 + 4 * it);\n"),
    ("      // ---- O += P V, V this", "      if (it < 16) DBG(5 + 4 * it);\n"),
    ("      mbar_arrive(&empty[st]);", "      if (it < 16) DBG(6 + 4 * it);\n"),
    ("+        load_stage(st, li, lp);", "        if (it < 16) DBG(80 + it);\n"),
    ("  // the threads whose o holds", "  DBG(69);\n"),
    ("  if (n_live == 1) {  // out = O / l", "  DBG(70);\n"),
    ("    return;\n  }\n\n  // a ticket first", "    DBG(73);\n"),
    ("+  if (tid == 0) last = atomicAdd(ticket, 1) == n_live - 1;\n  __syncthreads();",
     "  DBG(71);\n"),
    ("  if (tid == 0) {  // every other live split",
     "  if (tid == 0 && blockIdx.x == g_tgt[0]) g_dbg[2048 + 97] = clock64();\n"),
    ("  // the merge in split order",
     "  const bool is_mrg = blockIdx.x == g_tgt[0] && tid == 0;\n"
     "  if (is_mrg) g_dbg[2048 + 90] = clock64();\n"
     "  if (is_mrg) g_dbg[2048 + 95] = blockIdx.y;\n"
     "  if (is_mrg) g_dbg[2048 + 96] = clock64() - g_dbg[2048 + 97];\n"),
    ("  constexpr int kItems = (R / 8) * 128, kU = 8;",
     "  if (is_mrg) g_dbg[2048 + 91] = clock64();\n"),
    ("  __syncthreads();\n  store_out();\n  if (tid == 0) *ticket",
     "  if (is_mrg) g_dbg[2048 + 92] = clock64();\n"),
    ("  if (tid == 0) *ticket = *published = 0;", "  if (is_mrg) g_dbg[2048 + 93] = clock64();\n"),
]


def instrument(text: str) -> str:
    text = text.replace("namespace repro {\nnamespace mla {\n",
                        "namespace repro {\nnamespace mla {\n" + HEADER, 1)
    for anchor, add in PATCHES:
        after = anchor.startswith("+")
        key = anchor[1:] if after else anchor
        if text.count(key) != 1:
            raise SystemExit(f"torch_mla_timeline: the kernel no longer has one {key!r}")
        text = text.replace(key, key + "\n" + add.rstrip("\n") if after else add + key)
    return text + ENTRIES


def make_copy(src: Path, tag: str, timeline: bool) -> Path:
    dst = ROOT / "build" / "mla_timeline" / tag / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(src / "repro_torch", dst / "repro_torch")
    csrc = dst / "repro_torch" / "kernels" / "csrc"
    for p in csrc.glob("*.cu"):
        if p.name != "mla_attention.cu":
            p.unlink()
    build = dst / "repro_torch" / "kernels" / "_build.py"
    b = build.read_text().replace("\nRESTYPES = {", "\nSIGNATURES = {'repro_mla_attention': "
                                  "SIGNATURES['repro_mla_attention']}\nRESTYPES = {", 1)
    build.write_text(b)
    if timeline:
        cu = csrc / "mla_attention.cu"
        cu.write_text(instrument(cu.read_text()))
    return dst


def cases(cs):
    """(tag, r, rope, heads, slots, positions) over 4 slots x S_MAX."""
    return [("minicpm3", 256, 32, 40, cs.PACK_SLOTS, cs.PACK_POS),
            ("deepseek", 512, 64, 16, cs.PACK_SLOTS, cs.PACK_POS),
            ("r32h4", 32, 8, 4, cs.PACK_SLOTS, cs.PACK_POS),
            ("minicpm3-deep", 256, 32, 40, [2] * 64, list(range(900, 964))),
            ("minicpm3-singles", 256, 32, 40, [0, 1, 2, 3], cs.SINGLE_POS)]


def operands(torch, dev, gen, cs, r, rope, h, slots, poss):
    bf = torch.bfloat16
    t = len(slots)
    return (torch.randn(t, h, r, generator=gen, device=dev).to(bf),
            torch.randn(t, h, rope, generator=gen, device=dev).to(bf),
            torch.randn(cs.SLOTS, cs.S_MAX, r, generator=gen, device=dev).to(bf),
            torch.randn(cs.SLOTS, cs.S_MAX, rope, generator=gen, device=dev).to(bf),
            torch.tensor(slots, dtype=torch.int32, device=dev),
            torch.tensor(poss, dtype=torch.int32, device=dev))


def time_mode(cs, torch, mk, ref, rounds: int) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for tag, r, rope, h, slots, poss in cases(cs):
        args = operands(torch, dev, gen, cs, r, rope, h, slots, poss)
        scale = (r // 4 + rope) ** -0.5
        want = ref.mla_ragged_attention(*args, scale=scale)
        real = args[5] < cs.S_MAX
        for n in (None, 1, 2, 4):
            def fn(n=n):
                return mk.mla_attention(*args, scale=scale, splits=n)
            got = fn()
            torch.cuda.synchronize()
            times = [cs.time_ms(fn, reps=100, warmup=10) for _ in range(rounds)]
            res[f"{tag} splits={n}"] = dict(
                ms=statistics.median(times),
                err=(got[real].float() - want[real].float()).abs().max().item(),
                padding_zero=not got[~real].any(),
                sha256=hashlib.sha256(
                    got.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16])
    return res


def timeline_mode(cs, torch, mk, lib) -> None:
    import numpy as np

    lib.repro_mla_dbg_set.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_mla_dbg_get.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    buf = np.zeros(8192, dtype=np.uint64)
    # the tiles of slot 3's tokens at 600-615 (40 heads: tile 30; 16: tile 12;
    # 4: tiles 2, 3) and a short tile
    targets = {"minicpm3": [(30, 0), (30, 1), (30, 2), (5, 0)], "deepseek": [(12, 0), (12, 2)],
               "r32h4": [(3, 0), (2, 0)]}
    for tag, r, rope, h, slots, poss in cases(cs)[:3]:
        args = operands(torch, dev, gen, cs, r, rope, h, slots, poss)
        _, tiles, span, n = mk.plan(len(slots), h, cs.S_MAX, torch.bfloat16, 132)
        print(f"== {tag}: r={r} H={h}, {tiles} tiles x {n} splits (span {span})")
        for tx, ty in targets[tag]:
            mk.mla_attention(*args, scale=0.1)
            torch.cuda.synchronize()
            lib.repro_mla_dbg_set(tx, ty)
            mk.mla_attention(*args, scale=0.1)
            lib.repro_mla_dbg_get(buf.ctypes.data)
            nb = tiles * n
            ent, ext = buf[:nb].astype(np.int64), buf[1024:1024 + nb].astype(np.int64)
            t0 = ent[ent > 0].min()
            dur = ext - ent
            longest = [(int(b % tiles), int(b // tiles), round(float(dur[b]) / 1e3, 2))
                       for b in np.argsort(-dur)[:4]]
            print(f"  kernel span {(ext.max() - t0) / 1e3:.2f} us; longest blocks (x, y, us): "
                  f"{longest}")
            d = buf[2048:2048 + 128].astype(np.int64)

            def ev(i, d=d):
                return int(d[i] - d[0]) if d[i] else None
            print(f"  block ({tx}, {ty}) cycles: token table {ev(1)}, Q landed {ev(2)}")
            for it in range(16):
                if d[3 + 4 * it]:
                    print(f"    stage {it}: data {ev(3 + 4 * it)} S {ev(4 + 4 * it)} "
                          f"softmax {ev(5 + 4 * it)} PV {ev(6 + 4 * it)} refilled {ev(80 + it)}")
            print(f"    exchange {ev(69)} ticket {ev(71)} stored (one split) {ev(73)}")
            if d[90]:
                print(f"    merging block y={d[95]}: wait {d[96]} weights {d[91] - d[90]} "
                      f"sums {d[92] - d[91]} store {d[93] - d[92]} cycles")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src", help="the src/ directory of the checkout")
    ap.add_argument("--tag", default=None, help="the copy's name under build/mla_timeline/")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--time", action="store_true")
    mode.add_argument("--timeline", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    tag = args.tag or ("timeline" if args.timeline else src.parent.name or "src")
    copy = make_copy(src, tag, args.timeline)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src/ first: the copy goes ahead of it

    sys.path.insert(0, str(copy))
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import mla_attention as mk

    if not mk.__file__.startswith(str(copy)):
        raise SystemExit(f"torch_mla_timeline: imported {mk.__file__}, not the copy")
    if not torch.cuda.is_available():
        print("torch_mla_timeline: no CUDA device", file=sys.stderr)
        return 1
    lib = _build.load()
    log = (_build.library_path().parent / "ptxas.log").read_text().splitlines()
    regs = [line.strip() for line in log if "Used" in line or "spill stores" in line]
    if args.timeline:
        print("\n".join(regs[-12:]))
        timeline_mode(cs, torch, mk, lib)
        return 0
    card = torch.cuda.get_device_name(0)
    print(json.dumps({"card": card, "src": args.src, "ptxas": regs[-12:],
                      "kernels": time_mode(cs, torch, mk, ref, args.rounds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
