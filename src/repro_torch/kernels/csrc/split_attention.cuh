// The split-KV body of the serving attention kernels: decode against the
// dense cache (decode_attention.cu), ragged packs against the dense cache
// (ragged_attention.cu) and paged attention, decode and packs, against the
// block-paged pool (paged_attention.cu). Each defines a row policy (which
// sequence a token reads, its key range, and where position p of that
// sequence lives) and its C entry point; the kernel and its launch are
// shared here.
//
// The design: split-KV attention (flash-decoding). The grid is (tiles, KV,
// chunks x splits). A tile is TT consecutive tokens (one for decode; for a
// ragged or paged pack 8 at G = 1, 2 at G <= 4, 1 at G >= 5), a chunk 1, 4
// or 8 rows of the group (the domain of attention_common.cuh), so a block
// holds TT x GC <= 8 query rows, each a (token, group row) pair with its own
// key range; split s owns the positions [s * span, (s + 1) * span), span a
// multiple of 256 picked from host values only
// (kernels/decode_attention.py::split_count, ragged_attention.py::plan). A
// block streams the keys its rows need through a ring of 2 to 8 stages in
// about 64 KB of dynamic shared memory (16-byte cp.async copies, zero-filled
// past the range, ~8 KB of K and V rows a stage, so a block keeps up to ~56
// KB in flight; a policy may shape its tensor-core rows' ring apart: ragged
// stages 64 positions in 104 KB), and every staged K/V row serves all the
// block's rows: the tokens of a pack tile read their sequence's prefix once.
// Its warps take a stage's keys a few at a time, each warp keeping its own
// online softmax (m, l, acc) for the block's rows in registers; a key
// outside a row's range weighs 0 for that row, a row scale is folded into
// the math (s = ks * (q . k) / sqrt(D), acc += (p * vs) * v), and no
// dequantized row is stored. Two row engines do the products: LaneRows, in
// f32 on the CUDA cores, four keys a warp, a key row spread over the lanes
// (lane i holds elements [i*N, i*N + N), N = 1, 2 or 4 by D, so a row is one
// coalesced warp-wide read; four dot products summed over the warp in one
// transposing butterfly, warp_sum4: 10 shuffles where four warp_sums take
// 20), for up to 4 rows, f32 queries or stores, and the dense decode; and
// MmaRows, 16 keys a warp on mma.sync m16n8k16 (S = Q K^T and O = P V with
// the 8 rows as M), for 8 rows of bf16 queries over a bf16, int8 or fp8
// store of a policy that asks for them (kMmaRows: ragged and paged), where
// LaneRows' shuffles would take 8 times a decode's per key (details at
// MmaRows). A tile whose tokens belong to two sequences runs one pass per
// sequence (the engine builds a pack sequence by sequence, so such tiles are
// rare): a pass stages the union of its tokens' ranges, and the other
// tokens' rows weigh every key 0. The warps merge through shared memory into
// the block's partial (m, l, acc[D]) per row. With one split that partial is
// normalised and stored; otherwise it goes to f32 scratch (the caller's
// torch.empty, per call) and the last block of its (tile, head, chunk) to
// arrive (an atomic ticket in per-(device, stream) counters it leaves zero)
// merges the partials in split order, so the result does not depend on
// timing. A split past a row's range writes the empty partial (m = -1e30, l
// = 0; a block with no key in its span writes it at once, without merging
// its warps); a row whose range is empty in every split gets zeros, as the
// TPU kernel writes. No host sync, allocation or memset per call, and the
// grid comes from host values only: the launch can be captured in a CUDA
// graph.
//
// A paged policy loads the block-table entries of a pass into shared
// memory once (kTableWords at a time, so a span of any length takes
// windows of (kTableWords - 1) * bs positions or more) and addresses every
// stage's copies from them; the sentinel entry (past the pool) is clamped
// to its last block, and the position bounds keep such keys out of every
// range.
//
// Measured on an H100 (scripts/torch_attention_ab.py and variants of
// decode_attention.cu): eight warps beat four by 9% and the butterfly took
// another 5% off the int8 store, so the warps' arithmetic, not only the
// bytes, sets the time; a deeper ring (96 KB) or larger stages (16 KB)
// changed nothing. A 64-token pack on LaneRows (8 rows a block) took 0.160
// ms against a decode's 0.042 over the same pool: its shuffles, not its
// bytes, bound it. A dense ragged pack on the tensor-core rows took 0.0357
// ms on 32-position stages in 64 KB and 0.0253 on 64-position stages in 104
// KB (four warps a stage, two blocks an SM), one span each; the merge that
// issues a split's loads for all of a thread's outputs together, and blocks
// with no key that skip their warps' merge, took the dense decode at G = 8
// from 0.0326 to 0.0295 with the same bits.
#pragma once

#include "attention_common.cuh"
#include "gemm_wgmma.cuh"
#include "mma_common.cuh"

namespace repro {
namespace splitkv {

constexpr int kWarps = 8;                   // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kU = 4;                       // rows a warp takes per sub-step (warp_sum4's)
constexpr int kSubRows = kWarps * kU;       // rows of the block per sub-step
constexpr int kRingBytes = 65536;           // shared memory the K/V ring aims at
constexpr int kStageTarget = 8192;          // bytes of K and V rows a stage aims at
constexpr int kTableWords = 256;            // block-table entries a paged window holds

// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

// The warp sums of four values a lane, all four to every lane: a
// transposing butterfly (two of the four rows kept over lanes 16 apart, one
// over lanes 8 apart, the last eight lanes summed, then broadcast), 10
// shuffles where four warp_sums take 20.
__device__ __forceinline__ void warp_sum4(const float (&v)[4], float (&out)[4]) {
  const int lane = threadIdx.x & 31;
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float a0 = hi16 ? v[2] : v[0], a1 = hi16 ? v[3] : v[1];
  a0 += __shfl_xor_sync(0xffffffffu, hi16 ? v[0] : v[2], 16);
  a1 += __shfl_xor_sync(0xffffffffu, hi16 ? v[1] : v[3], 16);
  float x = (hi8 ? a1 : a0) + __shfl_xor_sync(0xffffffffu, hi8 ? a0 : a1, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);  // row lane >> 3, summed over the warp
#pragma unroll
  for (int u = 0; u < 4; ++u) out[u] = __shfl_sync(0xffffffffu, x, 8 * u);
}

// The ring of one (store type, scaled, head width): kRows positions a stage
// (K rows, then V rows, then with kScaled their K and V scales; kMinRows at
// least), kStages stages in kBudget bytes of dynamic shared memory (two
// stages at least). A staged row takes kStride bytes: its own, or with kPad
// one 16-byte chunk more where that makes the stride an odd number of
// chunks, so that the eight rows an ldmatrix reads fall in eight different
// groups of four banks (the tensor-core rows read their fragments so).
template <typename TS, bool kScaled, int D, bool kPad, int kMinRows = kSubRows,
          int kBudget = kRingBytes>
struct Ring {
  static constexpr int kRow = D * static_cast<int>(sizeof(TS));  // bytes of a K or V row
  static constexpr int kStride = kPad && kRow / 16 % 2 == 0 ? kRow + 16 : kRow;
  static constexpr int kFit = kStageTarget / (2 * kRow) / kSubRows * kSubRows;
  static constexpr int kRows = kFit > kMinRows ? kFit : kMinRows;
  static constexpr int kStageBytes = kRows * (2 * kStride + (kScaled ? 8 : 0));
  static constexpr int kFitStages = kBudget / kStageBytes;
  static constexpr int kStages = kFitStages > 8 ? 8 : kFitStages < 2 ? 2 : kFitStages;
  static_assert(kRow % 16 == 0, "a row is whole 16-byte copies");
  static_assert(kStages * kStageBytes <= 227 * 1024, "the ring fits a block's shared memory");
};

// Whether a block of NR rows takes its products on the tensor cores
// (MmaRows): 8 rows (a pack tile, or a group chunk of 8) of bf16 queries
// over a bf16, int8 or fp8 store, all of which bf16 holds exactly, under a
// policy with kMmaRows (ragged and paged). An f32 query or store keeps f32
// products (LaneRows), and the dense decode (DenseSlots) keeps LaneRows'
// arithmetic.
template <typename TQ, typename TS, int NR, typename Policy>
__host__ __device__ constexpr bool use_mma() {
  return NR == 8 && Policy::kMmaRows && std::is_same_v<TQ, __nv_bfloat16> &&
         !std::is_same_v<TS, float>;
}

// The ring of a block's rows and their P precision: the defaults, or for
// the tensor-core rows the policy's own (kMmaStageRows positions a stage at
// least, kMmaRingBytes, kMmaSplitP: MmaRows' kSplitP).
template <typename Policy, bool kMma>
struct MmaTraits {
  static constexpr int kMinRows = kSubRows;
  static constexpr int kBytes = kRingBytes;
  static constexpr bool kSplitP = false;
};
template <typename Policy>
struct MmaTraits<Policy, true> {
  static constexpr int kMinRows = Policy::kMmaStageRows;
  static constexpr int kBytes = Policy::kMmaRingBytes;
  static constexpr bool kSplitP = Policy::kMmaSplitP;
};
template <typename TQ, typename TS, bool kScaled, int D, int NR, typename Policy,
          bool kMma = use_mma<TQ, TS, NR, Policy>()>
using BlockRing = Ring<TS, kScaled, D, kMma, MmaTraits<Policy, kMma>::kMinRows,
                       MmaTraits<Policy, kMma>::kBytes>;

// Bytes between two of MmaRows' staged query rows (D bf16): an odd number
// of 16-byte chunks, so that an ldmatrix of 8 rows meets no bank conflict.
__host__ __device__ constexpr int q_stride(int D) {
  return D * 2 / 16 % 2 == 0 ? D * 2 + 16 : D * 2;
}

// Shared memory of a block: the ring, which the warps' partial states of
// its NR rows reuse (the first `ring` bytes), then MmaRows' 8 staged query
// rows, then a paged policy's table window.
template <typename TQ, typename TS, bool kScaled, int D, int NR, typename Policy>
struct SmemLayout {
  static constexpr bool kMma = use_mma<TQ, TS, NR, Policy>();
  static constexpr int kWidth = 32 * (D <= 32 ? 1 : D <= 64 ? 2 : 4);
  static constexpr int kMerge = (2 * kWarps * NR + kWarps * NR * kWidth) * 4;
  static constexpr int kRing = BlockRing<TQ, TS, kScaled, D, NR, Policy>::kStages *
                               BlockRing<TQ, TS, kScaled, D, NR, Policy>::kStageBytes;
  static constexpr int kQ = kRing > kMerge ? kRing : kMerge;  // where the queries start
  static constexpr int kTable = kQ + (kMma ? 8 * q_stride(D) : 0);
  static constexpr int kBytes = kTable + (Policy::kTable ? kTableWords * 4 : 0);
};

// Blocks an SM must hold: three for one row a block (a decode at G = 1, 64
// to 80 registers a thread; left free, ptxas took 91 for the dense int8
// decode and 108 for the paged one, two blocks an SM, 18% slower) and for
// the tensor-core rows over a bf16 store, two over int8 or fp8 (whose
// widening spills more at three), and never more than the SM's 228 KB of
// shared memory holds; the others take the registers they need
// (scripts/torch_attention_ab.py over variants, H100).
template <typename TQ, typename TS, bool kScaled, int D, int NR, typename Policy>
struct MinBlocks {
  static constexpr int kAsked = NR == 1 ? 3 : !use_mma<TQ, TS, NR, Policy>() ? 1
                                : sizeof(TS) == 1 ? 2 : 3;
  static constexpr int kFit =
      228 * 1024 / (SmemLayout<TQ, TS, kScaled, D, NR, Policy>::kBytes + 1024 + 128);
  static constexpr int kValue = kAsked < kFit ? kAsked : kFit;
};

// A staged key's validity for a token of the pass: inside [lo, hi]. With one
// token a tile the stage starts at the pass's lo, so only hi is checked.
template <int TT>
__device__ __forceinline__ bool key_ok(int p, int lo, int hi) {
  return (TT == 1 || p >= lo) && p <= hi;
}

// The block's NR rows on the CUDA cores, in f32: each warp takes kKeys = 4
// staged keys a sub-step, lane i holds elements [i*N, i*N + N) of a row
// (lanes past a row of D = 16 or 80 hold a zero query and read the row's
// first elements), and each row's four dot products are summed over
// the warp by warp_sum4; every row keeps its online softmax (m, l, acc) in
// registers.
template <typename TQ, typename TS, bool kScaled, int D, int GC, int TT>
struct LaneRows {
  static constexpr int NR = GC * TT;
  static constexpr int N = D <= 32 ? 1 : D <= 64 ? 2 : 4;
  static constexpr int kKeys = kU;
  static_assert(D % N == 0 && D <= 32 * N, "a row must fit a warp's lanes");
  float qr[NR][N], m[NR], l[NR], acc[NR][N];
  int col;
  bool active;

  // q_at(r): the offset of row r's query; the other rows' states start empty
  template <typename QRow>
  __device__ __forceinline__ void init(const TQ* __restrict__ q, const QRow& q_at,
                                       unsigned char*) {
    const int lane = threadIdx.x & 31;
    active = D == 32 * N || lane * N < D;
    col = active ? lane * N : 0;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      load_vec<N>(q + q_at(r) + col, qr[r]);
#pragma unroll
      for (int e = 0; e < N; ++e) qr[r][e] = active ? qr[r][e] : 0.f;
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[r][e] = 0.f;
    }
  }

  // keys r0 .. r0 + 3 of a stage (K rows at sk, V rows at sv, kStride bytes
  // apart; scales at sks, svs), at positions tb + r0 .. (tb the stage's
  // first); rlo/rhi: each token's bounds in this pass
  template <int kStride>
  __device__ __forceinline__ void step(const unsigned char* sk, const unsigned char* sv,
                                       const float* sks, const float* svs, int r0, int tb,
                                       const int (&rlo)[TT], const int (&rhi)[TT],
                                       float scale) {
    float kr[kU][N], vr[kU][N], ks[kU], vs[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      load_vec<N>(reinterpret_cast<const TS*>(sk + (r0 + u) * kStride) + col, kr[u]);
      load_vec<N>(reinterpret_cast<const TS*>(sv + (r0 + u) * kStride) + col, vr[u]);
      ks[u] = kScaled ? sks[r0 + u] : 1.f;
      vs[u] = kScaled ? svs[r0 + u] : 1.f;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int ti = r / GC;
      if (TT > 1 && rlo[ti] > rhi[ti]) continue;  // another sequence's token: nothing here
      bool ok[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) ok[u] = key_ok<TT>(tb + r0 + u, rlo[ti], rhi[ti]);
      float part[kU], sc[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        part[u] = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) part[u] += qr[r][e] * kr[u][e];
      }
      warp_sum4(part, sc);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        sc[u] *= scale;
        if constexpr (kScaled) sc[u] *= ks[u];
      }
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u]);
      const float corr = expf(m[r] - mx);
      float p[kU], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        p[u] = ok[u] ? expf(sc[u] - mx) : 0.f;
        psum += p[u];
        if constexpr (kScaled) p[u] *= vs[u];  // the V row's scale rides on its weight
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float a = acc[r][e] * corr;
#pragma unroll
        for (int u = 0; u < kU; ++u) a += p[u] * vr[u][e];
        acc[r][e] = a;
      }
      m[r] = mx;
    }
  }

  // this warp's states into [warp][NR] (m, l) and [warp][NR][kWidth] (acc)
  __device__ __forceinline__ void stash(float* sm_m, float* sm_l, float* sm_acc,
                                        int kWidth) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (lane == 0) {
        sm_m[warp * NR + r] = m[r];
        sm_l[warp * NR + r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < N; ++e) sm_acc[(warp * NR + r) * kWidth + lane * N + e] = acc[r][e];
    }
  }
};

// bf16x2 of the two fp8 e4m3 bytes at bits [7:0] and [23:16] of w, exactly
// (every e4m3 value is a bf16): the pair widened through f32.
__device__ __forceinline__ uint32_t f8_bf16x2(uint32_t w) {
  const __nv_fp8x2_storage_t pair =
      static_cast<__nv_fp8x2_storage_t>(__byte_perm(w, 0u, 0x7620) & 0xFFFFu);
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// bf16x2 of the bytes at bits [7:0] and [23:16] of a word of int8 or fp8
// store elements.
template <typename TS>
__device__ __forceinline__ uint32_t byte_pair_bf16x2(uint32_t w) {
  if constexpr (std::is_same_v<TS, int8_t>) {
    return i8_bf16x2(w);
  } else {
    return f8_bf16x2(w);
  }
}

// The block's 8 rows on the tensor cores (use_mma): each warp takes kKeys =
// 16 staged keys a sub-step. S = Q K^T on mma.sync m16n8k16 with the rows
// as M (8 of the 16 live, the others zero), two n8 tiles of keys and D / 16
// k-steps: Q's A fragments are built once; K^T's B fragments are ldmatrix
// loads of the staged K rows (bf16: two k-rows of a key a register; int8
// and fp8: a register holds dims 4t .. 4t + 3 of key g, widened to bf16 as
// the pairs (4t, 4t + 2) and (4t + 1, 4t + 3), and Q's fragments take its
// dims in that order). Lane (g, t) then holds row g's scores at keys 2t, 2t
// + 1, 2t + 8, 2t + 9: its online softmax (m over the quad of lanes of row
// g, l as this lane's share), with the row scales folded as in LaneRows.
// O += P V on m16n8k16 with the rows as M, 16 keys as K and D / 8 n8 tiles
// of dims: P's A fragments are the softmax weights of S's accumulators
// (times the V row scales) rounded to bf16 (the flash-attention register
// reuse), V's B fragments ldmatrix .trans loads of the staged V rows (int8
// and fp8: a register holds keys 2t, 2t + 1 of dims 2g, 2g + 1, so one
// matrix feeds the tiles of even and of odd dims). With kSplitP a second
// mma adds P's remainder past bf16, so P V is as exact as f32 math: one
// rounding of P is 2^-9 of the output, a bf16 step of it where a token has
// few keys and its output is as large as a V row (a ragged pack's first
// prompt tokens), which the plain version does not round.
template <typename TS, bool kScaled, int D, int GC, int TT, bool kSplitP>
struct MmaRows {
  static constexpr int NR = GC * TT;
  static constexpr int kKeys = 16;
  static constexpr int KS = D / 16;  // k-steps of S; 16-dim chunks of O
  static constexpr bool kBytes = sizeof(TS) == 1;
  static_assert(NR == 8 && D % 16 == 0, "8 rows of whole 16-dim chunks");
  static constexpr int kQStride = q_stride(D);
  const unsigned char* sq;     // the 8 query rows, staged (init)
  float m, l, acc[2 * KS][2];  // row g's accumulators (rows 8-15 of the m16 tiles: mma_16816_top)
  int lo, hi;                  // row g's token's bounds in the current pass

  // The block stages its 8 query rows at sq_ once (read after the pass's
  // first barrier), so the A fragments of Q cost one ldmatrix.x2 a k-step
  // and no registers between steps. Over an int8 or fp8 store each 16-dim
  // chunk is stored even dims first, so that a lane's registers hold dims
  // (4t, 4t + 2) and (4t + 1, 4t + 3), K's order.
  template <typename QRow>
  __device__ __forceinline__ void init(const __nv_bfloat16* __restrict__ q, const QRow& q_at,
                                       unsigned char* sq_) {
    for (int x = threadIdx.x; x < 8 * D; x += kThreads) {
      const int r = x / D, d = x % D, c = d % 16;
      const int col = kBytes ? d - c + (c % 2 ? 8 : 0) + c / 2 : d;
      reinterpret_cast<__nv_bfloat16*>(sq_ + r * kQStride)[col] = q[q_at(r) + d];
    }
    sq = sq_;
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) acc[j][0] = acc[j][1] = 0.f;
  }

  // row g's token's bounds in a pass
  __device__ __forceinline__ void bind(const int (&rlo)[TT], const int (&rhi)[TT]) {
    const int g = (threadIdx.x & 31) >> 2;
    lo = 1;
    hi = 0;
#pragma unroll
    for (int i = 0; i < TT; ++i)
      if (g / GC == i) {
        lo = rlo[i];
        hi = rhi[i];
      }
  }

  template <int kStride>
  __device__ __forceinline__ void step(const unsigned char* sk, const unsigned char* sv,
                                       const float* sks, const float* svs, int r0, int tb,
                                       const int (&)[TT], const int (&)[TT], float scale) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int i8 = lane & 7, j4 = lane >> 3;  // this lane's row of its ldmatrix matrix, and which
    float sacc[2][2] = {};                   // [key tile][accumulator of row g]
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t qa[2];  // Q's A fragment registers 0 and 2 (rows 0-7), dims 16 s .. + 15
      ldsm_x2(qa, sq + i8 * kQStride + (16 * s + 8 * (j4 & 1)) * 2);
      const uint32_t a[4] = {qa[0], 0u, qa[1], 0u};
      uint32_t b[2][2];  // [key tile][register]
      if constexpr (kBytes) {  // matrix j: keys 8j .. 8j + 7, bytes 16 s .. 16 s + 15
        uint32_t r[2];
        ldsm_x2(r, sk + (r0 + 8 * (j4 & 1) + i8) * kStride + 16 * s);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          b[j][0] = byte_pair_bf16x2<TS>(r[j]);
          b[j][1] = byte_pair_bf16x2<TS>(r[j] >> 8);
        }
      } else {  // matrix j: keys 8 (j >> 1) .. + 7, dims 16 s + 8 (j & 1) .. + 7
        uint32_t r[4];
        ldsm_x4(r, sk + (r0 + 8 * (j4 >> 1) + i8) * kStride + (16 * s + 8 * (j4 & 1)) * 2);
        b[0][0] = r[0];
        b[0][1] = r[1];
        b[1][0] = r[2];
        b[1][1] = r[3];
      }
      mma_16816_top(sacc[0], a, b[0]);
      mma_16816_top(sacc[1], a, b[1]);
    }
    // row g's scores at keys 8j + 2t + e
    float sc[2][2], mx = m;
    bool ok[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = r0 + 8 * j + 2 * t + e;
        ok[j][e] = key_ok<TT>(tb + key, lo, hi);
        sc[j][e] = sacc[j][e] * scale;
        if constexpr (kScaled) sc[j][e] *= sks[key];
        if (ok[j][e]) mx = fmaxf(mx, sc[j][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m - mx);
    float p[2][2], psum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[j][e] = ok[j][e] ? expf(sc[j][e] - mx) : 0.f;
        psum += p[j][e];
        if constexpr (kScaled) p[j][e] *= svs[r0 + 8 * j + 2 * t + e];
      }
    l = l * corr + psum;
    m = mx;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      acc[j][0] *= corr;
      acc[j][1] *= corr;
    }
    const uint32_t pa[4] = {pack_bf16x2(p[0][0], p[0][1]), 0u, pack_bf16x2(p[1][0], p[1][1]),
                            0u};
    uint32_t pl[4] = {0u, 0u, 0u, 0u};  // P - bf16(P), with kSplitP
    if constexpr (kSplitP) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[2 * j]));
        pl[2 * j] = pack_bf16x2(p[j][0] - h.x, p[j][1] - h.y);
      }
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {  // dims 16 s .. 16 s + 15: two n8 tiles
      uint32_t b[2][2];  // [tile][register]
      if constexpr (kBytes) {  // matrix j: keys 8j .. + 7, bytes 16 s .. + 15; even, odd dims
        uint32_t r[2];
        ldsm_x2_trans(r, sv + (r0 + 8 * (j4 & 1) + i8) * kStride + 16 * s);
        b[0][0] = byte_pair_bf16x2<TS>(r[0]);
        b[0][1] = byte_pair_bf16x2<TS>(r[1]);
        b[1][0] = byte_pair_bf16x2<TS>(r[0] >> 8);
        b[1][1] = byte_pair_bf16x2<TS>(r[1] >> 8);
      } else {  // matrix j: keys 8 (j & 1) .. + 7, dims 16 s + 8 (j >> 1) .. + 7
        uint32_t r[4];
        ldsm_x4_trans(r, sv + (r0 + 8 * (j4 & 1) + i8) * kStride + (16 * s + 8 * (j4 >> 1)) * 2);
        b[0][0] = r[0];
        b[0][1] = r[1];
        b[1][0] = r[2];
        b[1][1] = r[3];
      }
      mma_16816_top(acc[2 * s], pa, b[0]);
      mma_16816_top(acc[2 * s + 1], pa, b[1]);
      if constexpr (kSplitP) {
        mma_16816_top(acc[2 * s], pl, b[0]);
        mma_16816_top(acc[2 * s + 1], pl, b[1]);
      }
    }
  }

  // the dims of accumulators 0 and 1 of tile j at lane (g, t)
  __device__ __forceinline__ int dim(int j, int t) const {
    if constexpr (kBytes) return 16 * (j >> 1) + 4 * t + (j & 1);  // and + 2
    return 8 * j + 2 * t;                                          // and + 1
  }

  __device__ __forceinline__ void stash(float* sm_m, float* sm_l, float* sm_acc,
                                        int kWidth) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
    float ll = l;
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    if (t == 0) {
      sm_m[warp * NR + g] = m;
      sm_l[warp * NR + g] = ll;
    }
    float* row = sm_acc + (warp * NR + g) * kWidth;
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      const int d = dim(j, t);
      row[d] = acc[j][0];
      row[d + (kBytes ? 2 : 1)] = acc[j][1];
    }
  }

  static __device__ __forceinline__ uint32_t pack_bf16x2(float lo_, float hi_) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo_, hi_);
    return *reinterpret_cast<const uint32_t*>(&b);
  }
};

// A row policy (DenseSlots in decode_attention.cu, RaggedSlots in
// ragged_slots.cuh, PagedTable in paged_table.cuh) names, for token t,
// seq(t) (the sequence it reads),
// range(t, window, &lo, &hi) (its key range), and for a sequence's keys
// row(seq, p, stab, base) (the cache row of position p: its K/V rows and
// scales sit at row * KV + h). With kTable true the policy reads its rows
// through a window of table entries in shared memory: bind(seq, lo, hi,
// stab) loads those of positions lo..hi and returns the first's index
// (base), and window_end(lo, hi) is the last position from lo that one
// window of kTableWords entries covers; with kTable false bind does nothing
// and window_end(lo, hi) is hi. kMmaRows says whether its 8-row blocks over
// bf16 queries take MmaRows (use_mma).

// One block per (tile x of TT tokens, KV head h, chunk c of the group,
// split s): the partials of its rows, (token t0 + i, group row c * GC + j)
// for i < TT and j < GC, over the keys of the span [s * span, (s + 1) *
// span) in each row's range; gridDim.z = chunks * splits. q, out: [T, KV,
// G, D]; K/V rows and scales of a cache row r at r * KV + h. ws: [T, KV,
// G, splits, D] partial sums, then [T, KV, G, splits, 2] (m, l); counters:
// one ticket per (x, h, c). Both are unused when splits == 1.
template <typename TQ, typename TS, bool kScaled, int D, int GC, int TT, typename Policy>
__global__ void __launch_bounds__(kThreads,
                                  (MinBlocks<TQ, TS, kScaled, D, GC * TT, Policy>::kValue))
split_kernel(const TQ* __restrict__ q, const TS* __restrict__ k, const TS* __restrict__ v,
             const float* __restrict__ k_scale, const float* __restrict__ v_scale,
             const Policy pol, TQ* __restrict__ out, float* __restrict__ ws,
             int* __restrict__ counters, int T, int KV, int G, int window, int span) {
  constexpr int NR = GC * TT;  // the block's rows
  constexpr bool kMma = use_mma<TQ, TS, NR, Policy>();
  using R = BlockRing<TQ, TS, kScaled, D, NR, Policy>;
  using Rows = std::conditional_t<kMma,
                                  MmaRows<TS, kScaled, D, GC, TT, MmaTraits<Policy, kMma>::kSplitP>,
                                  LaneRows<TQ, TS, kScaled, D, GC, TT>>;
  static_assert(NR <= 8, "a block holds at most 8 rows");
  static_assert(R::kRows % Rows::kKeys == 0, "a stage is whole sub-steps of a warp");
  using Layout = SmemLayout<TQ, TS, kScaled, D, NR, Policy>;
  constexpr int kWidth = Layout::kWidth;  // LaneRows' widest row
  constexpr int kChunksRow = R::kRow / 16;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];  // Layout::kBytes
  int* stab = reinterpret_cast<int*>(smem + Layout::kTable);
  __shared__ int last;

  const int h = blockIdx.y;
  const int chunks = (G + GC - 1) / GC;
  const int splits = gridDim.z / chunks;
  const int c = blockIdx.z / splits, s = blockIdx.z % splits;
  const int g0 = c * GC, gn = min(GC, G - g0);
  const int t0 = blockIdx.x * TT, tn = min(TT, T - t0);
  const int warp = threadIdx.x >> 5;
  const float scale = rsqrtf(static_cast<float>(D));
  // row r = i * GC + j is (token t0 + i, group row g0 + j); rows past the
  // tile or the group read the tile's first row and are never stored
  auto row_ok = [&](int r) { return r / GC < tn && r % GC < gn; };
  auto q_row = [&](int r) {
    const int i = row_ok(r) ? r / GC : 0, j = row_ok(r) ? r % GC : 0;
    return ((static_cast<int64_t>(t0 + i) * KV + h) * G + g0 + j);
  };

  Rows rows;
  rows.init(q, [&](int r) { return q_row(r) * D; }, smem + Layout::kQ);

  const TS* kh = k + h * D;
  const TS* vh = v + h * D;
  const int64_t stride = static_cast<int64_t>(KV) * D;
  // one pass over the keys plo..phi of sequence sq, for the tile's tokens
  // bounded by rlo/rhi (empty for another sequence's)
  auto pass = [&](int sq, int plo, int phi, const int (&rlo)[TT], const int (&rhi)[TT]) {
    if constexpr (kMma) rows.bind(rlo, rhi);
    for (int wlo = plo; wlo <= phi;) {
      const int whi = pol.window_end(wlo, phi);
      const int base = pol.bind(sq, wlo, whi, stab);
      if constexpr (Policy::kTable) __syncthreads();  // the window's entries are in
      const int n_stages = (whi - wlo + R::kRows) / R::kRows;
      // stage i holds positions wlo + i * kRows .. + kRows - 1 (zeros past whi)
      auto load_stage = [&](int st, int si) {
        unsigned char* sbase = smem + st * R::kStageBytes;
        const int p0 = wlo + si * R::kRows;
        for (int x = threadIdx.x; x < 2 * R::kRows * kChunksRow; x += kThreads) {
          const int which = x / (R::kRows * kChunksRow);  // 0: K, 1: V
          const int r = (x / kChunksRow) % R::kRows, cc = x % kChunksRow;
          const bool ok = p0 + r <= whi;
          const TS* src = (which ? vh : kh) + pol.row(sq, ok ? p0 + r : wlo, stab, base) * stride +
                          cc * (16 / static_cast<int>(sizeof(TS)));
          cp_async16(sbase + (which * R::kRows + r) * R::kStride + cc * 16, src, ok);
        }
        if constexpr (kScaled) {
          for (int x = threadIdx.x; x < 2 * R::kRows; x += kThreads) {
            const int which = x / R::kRows, r = x % R::kRows;
            const bool ok = p0 + r <= whi;
            const float* src = (which ? v_scale : k_scale) +
                               pol.row(sq, ok ? p0 + r : wlo, stab, base) * KV + h;
            cp_async4(sbase + 2 * R::kRows * R::kStride + x * 4, src, ok);
          }
        }
      };

#pragma unroll
      for (int p = 0; p < R::kStages - 1; ++p) {
        if (p < n_stages) load_stage(p, p);
        cp_async_commit();
      }
      for (int si = 0; si < n_stages; ++si) {
        cp_async_wait<R::kStages - 2>();  // stage si has landed (this thread's copies)
        __syncthreads();                  // ... and everyone's; stage si - 1 is free
        const int nxt = si + R::kStages - 1;
        if (nxt < n_stages) load_stage(nxt % R::kStages, nxt);
        cp_async_commit();
        const unsigned char* sk = smem + (si % R::kStages) * R::kStageBytes;
        const unsigned char* sv = sk + R::kRows * R::kStride;
        const float* sks = reinterpret_cast<const float*>(sk + 2 * R::kRows * R::kStride);
        const float* svs = sks + R::kRows;
        const int tb = wlo + si * R::kRows;  // the position of the stage's row 0
        for (int r0 = warp * Rows::kKeys; r0 < R::kRows && tb + r0 <= whi;
             r0 += kWarps * Rows::kKeys)
          rows.template step<R::kStride>(sk, sv, sks, svs, r0, tb, rlo, rhi, scale);
      }
      cp_async_wait<0>();
      // the ring (and a table window) are free again before the next window
      // or the tile's next pass refills them
      if constexpr (Policy::kTable || TT > 1) __syncthreads();
      wlo = whi + 1;
    }
  };

  // whether a row of the block has a key in this span (the same in every
  // thread); a block with none skips its warps' merge
  bool any = false;
  if constexpr (TT == 1) {
    int lo, hi;
    pol.range(t0, window, &lo, &hi);
    lo = max(lo, s * span);
    hi = min(hi, s * span + span - 1);
    const int rlo[1] = {lo}, rhi[1] = {hi};
    any = lo <= hi;
    if (any) pass(pol.seq(t0), lo, hi, rlo, rhi);
  } else {
    __shared__ int tok_seq[TT], tok_lo[TT], tok_hi[TT];  // the tile's tokens in this span
    if (threadIdx.x < TT) {
      const int i = threadIdx.x;
      int lo = 1, hi = 0, sq = -1;
      if (i < tn) {
        sq = pol.seq(t0 + i);
        pol.range(t0 + i, window, &lo, &hi);
        lo = max(lo, s * span);
        hi = min(hi, s * span + span - 1);
      }
      tok_seq[i] = sq;
      tok_lo[i] = lo;
      tok_hi[i] = hi;
    }
    __syncthreads();
    for (int i = 0; i < tn; ++i) any |= tok_lo[i] <= tok_hi[i];
    // a pass per sequence, at the first of the tile's tokens with keys here
#pragma unroll 1
    for (int i = 0; i < tn; ++i) {
      const int sq = tok_seq[i];
      if (tok_lo[i] > tok_hi[i]) continue;
      bool seen = false;
      for (int j = 0; j < i; ++j) seen |= tok_lo[j] <= tok_hi[j] && tok_seq[j] == sq;
      if (seen) continue;
      int rlo[TT], rhi[TT], plo = tok_lo[i], phi = tok_hi[i];
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        const bool mine = tok_lo[j] <= tok_hi[j] && tok_seq[j] == sq;
        rlo[j] = mine ? tok_lo[j] : 1;
        rhi[j] = mine ? tok_hi[j] : 0;
        if (mine) {
          plo = min(plo, rlo[j]);
          phi = max(phi, rhi[j]);
        }
      }
      pass(sq, plo, phi, rlo, rhi);
    }
  }

  // the warps' states meet in shared memory (the ring's, free after the
  // last barrier); a row with no key here leaves every warp's state empty,
  // and a block with no key at all skips the meeting: its rows' zeros or,
  // split, their empty partials (m = -1e30, l = 0, sums 0)
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][NR]
  float* sm_l = sm_m + kWarps * NR;              // [kWarps][NR]
  float* sm_acc = sm_l + kWarps * NR;            // [kWarps][NR][kWidth]
  if (any) {
    __syncthreads();
    rows.stash(sm_m, sm_l, sm_acc, kWidth);
    __syncthreads();
  }
  const int64_t rows_total = static_cast<int64_t>(T) * KV * G;
  float* ws_ml = ws + rows_total * splits * D;  // after the sums
  for (int idx = threadIdx.x; idx < NR * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    if (!row_ok(r)) continue;
    float mm = kNegInf, ll = 0.f, aa = 0.f;
    if (any) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * NR + r]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(sm_m[w * NR + r] - mm);
        ll += sm_l[w * NR + r] * e;
        aa += sm_acc[(w * NR + r) * kWidth + d] * e;
      }
    }
    if (splits == 1) {
      store_f32(out + q_row(r) * D + d, aa / fmaxf(ll, 1e-30f));
      continue;
    }
    const int64_t row = q_row(r) * splits + s;
    ws[row * D + d] = aa;
    if (d == 0) {
      ws_ml[row * 2] = mm;
      ws_ml[row * 2 + 1] = ll;
    }
  }
  if (splits == 1) return;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  int* ticket = counters + (static_cast<int64_t>(blockIdx.x) * KV + h) * chunks + c;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each thread's kPer (row, dim) outputs at once, the loads of a split
  // issued together: the latency of a split, not of a split per output;
  // sums in split order, so the result does not depend on timing
  constexpr int kPer = (NR * D + kThreads - 1) / kThreads;
  int64_t row[kPer];
  int dd[kPer];
  float mm[kPer], ll[kPer], aa[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    row[i] = q_row(idx / D) * splits;  // rows past the tile read its first row's
    dd[i] = idx % D;
    mm[i] = kNegInf;
    ll[i] = aa[i] = 0.f;
  }
#pragma unroll 4
  for (int z = 0; z < splits; ++z)
#pragma unroll
    for (int i = 0; i < kPer; ++i) mm[i] = fmaxf(mm[i], __ldcg(ws_ml + (row[i] + z) * 2));
#pragma unroll 4
  for (int z = 0; z < splits; ++z) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float mz = __ldcg(ws_ml + (row[i] + z) * 2);
      const float lz = __ldcg(ws_ml + (row[i] + z) * 2 + 1);
      const float az = __ldcg(ws + (row[i] + z) * D + dd[i]);
      const float e = expf(mz - mm[i]);
      ll[i] += lz * e;
      aa[i] += az * e;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / D;
    if (idx < NR * D && row_ok(r))
      store_f32(out + q_row(r) * D + dd[i], aa[i] / fmaxf(ll[i], 1e-30f));
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next launch
}

// Launches split_kernel over a grid of (tiles of the T tokens, KV heads,
// chunks of the group x splits) for the instantiated (query, store, scaled)
// combination (dispatch_types), head width D and chunk GC (1 for G = 1, 4
// for G up to 4, else 8), a tile of one token (kPack false) or of 8 / GC
// (kPack true; its launch takes G <= 4, since a chunk of 8 is a tile of one
// token, the kPack false launch's). S: the positions of a sequence; span: positions per split
// (splits = ceil(S / span)); ws: f32 scratch of T * KV * G * splits * (D +
// 2) elements and counters: int32 zeros, one per (tile, KV head, chunk),
// left zero; both may be null when splits == 1. Returns cudaGetLastError()
// after the launch, -1 for a (D, G) outside the domain or a grid past its
// limits, -2 for an unsupported combination of types and scales, -3 for
// missing scratch.
template <bool kPack, typename Policy>
int launch_split(const void* q, const void* k, const void* v, const void* k_scale,
                 const void* v_scale, const Policy& pol, void* out, void* ws, void* counters,
                 int T, int S, int KV, int G, int D, int window, int span, int qdtype,
                 int sdtype, void* stream) {
  if (G < 1 || G > kMaxGroup || span < 1) return -1;
  const int gc = G == 1 ? 1 : G <= 4 ? 4 : 8;
  const int tt = kPack ? 8 / gc : 1;
  const int chunks = (G + gc - 1) / gc;
  const int splits = S > span ? (S + span - 1) / span : 1;
  if (static_cast<int64_t>(chunks) * splits > 65535 || KV > 65535) return -1;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return -3;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + tt - 1) / tt, KV, chunks * splits);
  return dispatch_types(qdtype, sdtype, k_scale != nullptr, [&](auto tq, auto ts, auto sc) {
    using TQ = typename decltype(tq)::type;
    using TS = typename decltype(ts)::type;
    constexpr bool kScaled = decltype(sc)::value;
#define REPRO_CASE(DD, GG)                                                                    \
  if constexpr (!kPack || GG < 8) {                                                           \
  if (D == DD && gc == GG) {                                                                  \
    constexpr int kTT = kPack ? 8 / GG : 1;                                                   \
    constexpr int kBytes = SmemLayout<TQ, TS, kScaled, DD, GG * kTT, Policy>::kBytes;         \
    auto* kernel = split_kernel<TQ, TS, kScaled, DD, GG, kTT, Policy>;                        \
    static bool raised[64];                                                                   \
    const cudaError_t err = raise_smem(kernel, kBytes, raised);                               \
    if (err != cudaSuccess) return static_cast<int>(err);                                     \
    kernel<<<grid, kThreads, kBytes, st>>>(                                                   \
        static_cast<const TQ*>(q), static_cast<const TS*>(k), static_cast<const TS*>(v),      \
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), pol,          \
        static_cast<TQ*>(out), static_cast<float*>(ws), static_cast<int*>(counters), T, KV,   \
        G, window, span);                                                                     \
    return static_cast<int>(cudaGetLastError());                                              \
  }                                                                                           \
  }
    REPRO_CASE(16, 1) REPRO_CASE(16, 4) REPRO_CASE(16, 8)
    REPRO_CASE(32, 1) REPRO_CASE(32, 4) REPRO_CASE(32, 8)
    REPRO_CASE(64, 1) REPRO_CASE(64, 4) REPRO_CASE(64, 8)
    REPRO_CASE(80, 1) REPRO_CASE(80, 4) REPRO_CASE(80, 8)
    REPRO_CASE(128, 1) REPRO_CASE(128, 4) REPRO_CASE(128, 8)
#undef REPRO_CASE
    return -1;
  });
}

}  // namespace splitkv
}  // namespace repro
