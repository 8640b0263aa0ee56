// Batched single-token GQA decode attention against the dense KV cache, over
// a plain (f32/bf16) or a quantized (int8/fp8 rows + f32 row scales) store.
//
// Replaces the TPU kernels repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel, and _decode_kernel_q8 for the quantized store): q [B, KV,
// G, D], cache k/v [B, S_max, KV, D], cur_len [B] int32, and for a quantized
// store k_scale/v_scale [B, S_max, KV] f32; key t of slot b is valid iff t <=
// cur_len[b] (and t > cur_len[b] - window when window > 0). Returns [B, KV,
// G, D] in q's dtype.
//
// What bounds it on the H100: the K/V bytes of the valid prefix (plus 8 bytes
// of scales per key and head when quantized). Per slot and head it reads 2 *
// (cur_len + 1) rows of D elements and does 4 * G * D flops per key, far below
// the ~295 flops per byte where tensor cores would become the limit, so the
// kernel is a streaming read; an int8 or fp8 store halves the bytes of bf16.
// At the serving shape (4 slots, 32 KV heads, G = 1) one block per (slot,
// head) is 128 blocks on 132 SMs, too few bytes in flight to stream at the
// HBM rate.
//
// The design: split-KV decode (flash-decoding). The TPU grid's S axis
// (block_s = 256) comes back as a grid axis: the grid is (B, KV, chunks x
// splits), where a chunk is 1, 4 or 8 rows of the group (the domain of
// attention_common.cuh) and split s owns the positions [s * span, (s + 1) *
// span), span a multiple of 256 that kernels/decode_attention.py::split_count
// picks from host values only (S_max, B, KV, G, the SM count) so that the
// blocks fill at least two waves. A block streams its keys through a ring of
// 2 to 8 stages in about 64 KB of dynamic shared memory (16-byte cp.async
// copies, zero-filled past the range, ~8 KB of K and V rows a stage, so a
// block keeps up to ~56 KB in flight), and its eight warps take a stage's
// rows four at a time with attend_rows' lane layout and f32 math: lane i
// holds elements [i*N, i*N + N) of a row, the four rows' dot products are
// summed over the warp in one transposing butterfly (warp_sum4: 10
// shuffles where four warp_sums take 20), each warp keeps its own online
// softmax (m, l, acc) for the chunk's query rows in registers, a row scale
// is folded into the math (s = ks * (q . k) / sqrt(D), acc += (p * vs) *
// v), and no dequantized row is stored. The warps merge through shared
// memory into the block's partial (m, l, acc[D]). With one split that
// partial is normalised and stored; otherwise it goes to f32 scratch (the
// caller's torch.empty, per call) and the last block of its (slot, head,
// chunk) to arrive (an atomic ticket in per-(device, stream) counters it
// leaves zero) merges the partials in split order, so the result does not
// depend on timing. A split past cur_len[b] or before the window reads no
// key and writes the empty partial (m = -1e30, l = 0). A range that is
// empty in every split writes zeros, as the TPU kernel does. No host sync,
// allocation or memset per call, and the grid comes from host values only:
// the launch can be captured in a CUDA graph.
//
// Measured on an H100 (scripts/torch_attention_ab.py and variants of this
// file): eight warps beat four by 9% and the butterfly took another 5% off
// the int8 store, so the warps' arithmetic, not only the bytes, sets the
// time; a deeper ring (96 KB) or larger stages (16 KB) changed nothing.

#include "attention_common.cuh"
#include "gemm_wgmma.cuh"
#include "mma_common.cuh"

namespace {

using repro::kNegInf;

constexpr int kWarps = 8;                   // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kU = 4;                       // rows a warp takes per sub-step (warp_sum4's)
constexpr int kSubRows = kWarps * kU;       // rows of the block per sub-step
constexpr int kRingBytes = 65536;           // shared memory the K/V ring aims at
constexpr int kStageTarget = 8192;          // bytes of K and V rows a stage aims at

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
// (K rows, then V rows, then with kScaled their K and V scales), kStages
// stages in kRingBytes of dynamic shared memory (two stages at least).
template <typename TS, bool kScaled, int D>
struct Ring {
  static constexpr int kRow = D * static_cast<int>(sizeof(TS));  // bytes of a K or V row
  static constexpr int kFit = kStageTarget / (2 * kRow) / kSubRows * kSubRows;
  static constexpr int kRows = kFit > kSubRows ? kFit : kSubRows;
  static constexpr int kStageBytes = kRows * (2 * kRow + (kScaled ? 8 : 0));
  static constexpr int kFitStages = kRingBytes / kStageBytes;
  static constexpr int kStages = kFitStages > 8 ? 8 : kFitStages < 2 ? 2 : kFitStages;
  static_assert(kRow % 16 == 0, "a row is whole 16-byte copies");
  static_assert(kStages * kStageBytes <= 227 * 1024, "the ring fits a block's shared memory");
};

// Shared memory of a block: the ring, which the warps' partial states reuse.
template <typename TS, bool kScaled, int D, int GC>
constexpr int split_smem_bytes() {
  constexpr int kWidth = 32 * (D <= 32 ? 1 : D <= 64 ? 2 : 4);
  constexpr int kMerge = (2 * kWarps * GC + kWarps * GC * kWidth) * 4;
  constexpr int kRing = Ring<TS, kScaled, D>::kStages * Ring<TS, kScaled, D>::kStageBytes;
  return kRing > kMerge ? kRing : kMerge;
}

// One block per (slot b, KV head h, chunk c of the group, split s): the
// partial of the chunk's rows over the keys [s * span, (s + 1) * span) of
// the slot's valid range; gridDim.z = chunks * splits. ws: [B, KV, G,
// splits, D] partial sums, then [B, KV, G, splits, 2] (m, l); counters: one
// ticket per (b, h, c). Both are unused when splits == 1.
template <typename TQ, typename TS, bool kScaled, int D, int GC>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TS* __restrict__ k, const TS* __restrict__ v,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ cur_len, TQ* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int B, int S, int KV,
                    int G, int window, int span) {
  using R = Ring<TS, kScaled, D>;
  constexpr int N = D <= 32 ? 1 : D <= 64 ? 2 : 4;
  static_assert(D % N == 0 && D <= 32 * N, "a row must fit a warp's lanes");
  constexpr int kWidth = 32 * N;  // the widest row a lane layout of N holds
  constexpr int kChunksRow = R::kRow / 16;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];  // split_smem_bytes()
  __shared__ int last;

  const int b = blockIdx.x, h = blockIdx.y;
  const int chunks = (G + GC - 1) / GC;
  const int splits = gridDim.z / chunks;
  const int c = blockIdx.z / splits, s = blockIdx.z % splits;
  const int g0 = c * GC, gn = min(GC, G - g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool active = D == 32 * N || lane * N < D;
  const int col = active ? lane * N : 0;
  const float scale = rsqrtf(static_cast<float>(D));
  int lo, hi;
  repro::key_range(cur_len[b], S, window, &lo, &hi);
  lo = max(lo, s * span);
  hi = min(hi, s * span + span - 1);
  const int64_t bh = static_cast<int64_t>(b) * KV + h;
  const int64_t qo = (bh * G + g0) * D;  // the chunk's first row of q and out

  float qr[GC][N];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    repro::load_vec<N>(q + qo + (g < gn ? g : 0) * D + col, qr[g]);
#pragma unroll
    for (int i = 0; i < N; ++i) qr[g][i] = active ? qr[g][i] : 0.f;
  }
  float m[GC], l[GC], acc[GC][N];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  if (lo <= hi) {
    const TS* kh = k + h * D;
    const TS* vh = v + h * D;
    const int64_t row0 = static_cast<int64_t>(b) * S;  // cache row of position 0
    const int64_t stride = static_cast<int64_t>(KV) * D;
    const int n_stages = (hi - lo + R::kRows) / R::kRows;
    // stage i holds positions lo + i * kRows .. + kRows - 1 (zeros past hi)
    auto load_stage = [&](int st, int i) {
      unsigned char* base = smem + st * R::kStageBytes;
      const int t0 = lo + i * R::kRows;
      for (int x = threadIdx.x; x < 2 * R::kRows * kChunksRow; x += kThreads) {
        const int which = x / (R::kRows * kChunksRow);  // 0: K, 1: V
        const int r = (x / kChunksRow) % R::kRows, cc = x % kChunksRow;
        const bool ok = t0 + r <= hi;
        const TS* src = (which ? vh : kh) + (row0 + (ok ? t0 + r : lo)) * stride +
                        cc * (16 / static_cast<int>(sizeof(TS)));
        repro::cp_async16(base + (which * R::kRows + r) * R::kRow + cc * 16, src, ok);
      }
      if constexpr (kScaled) {
        for (int x = threadIdx.x; x < 2 * R::kRows; x += kThreads) {
          const int which = x / R::kRows, r = x % R::kRows;
          const bool ok = t0 + r <= hi;
          const float* src = (which ? v_scale : k_scale) + (row0 + (ok ? t0 + r : lo)) * KV + h;
          cp_async4(base + 2 * R::kRows * R::kRow + x * 4, src, ok);
        }
      }
    };

#pragma unroll
    for (int p = 0; p < R::kStages - 1; ++p) {
      if (p < n_stages) load_stage(p, p);
      repro::cp_async_commit();
    }
    for (int i = 0; i < n_stages; ++i) {
      repro::cp_async_wait<R::kStages - 2>();  // stage i has landed (this thread's copies)
      __syncthreads();                         // ... and everyone's; stage i - 1 is free
      const int nxt = i + R::kStages - 1;
      if (nxt < n_stages) load_stage(nxt % R::kStages, nxt);
      repro::cp_async_commit();
      const unsigned char* base = smem + (i % R::kStages) * R::kStageBytes;
      const TS* sk = reinterpret_cast<const TS*>(base);
      const TS* sv = reinterpret_cast<const TS*>(base + R::kRows * R::kRow);
      const float* sks = reinterpret_cast<const float*>(base + 2 * R::kRows * R::kRow);
      const float* svs = sks + R::kRows;
      const int tb = lo + i * R::kRows;  // the position of the stage's row 0
      for (int r0 = warp * kU; r0 < R::kRows && tb + r0 <= hi; r0 += kSubRows) {
        float kr[kU][N], vr[kU][N], ks[kU], vs[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          repro::load_vec<N>(sk + (r0 + u) * D + col, kr[u]);
          repro::load_vec<N>(sv + (r0 + u) * D + col, vr[u]);
          ks[u] = kScaled ? sks[r0 + u] : 1.f;
          vs[u] = kScaled ? svs[r0 + u] : 1.f;
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          float part[kU], sc[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            part[u] = 0.f;
#pragma unroll
            for (int e = 0; e < N; ++e) part[u] += qr[g][e] * kr[u][e];
          }
          warp_sum4(part, sc);
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            sc[u] *= scale;
            if constexpr (kScaled) sc[u] *= ks[u];
          }
          float mx = m[g];
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (tb + r0 + u <= hi) mx = fmaxf(mx, sc[u]);
          const float corr = expf(m[g] - mx);
          float p[kU], psum = 0.f;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            p[u] = (tb + r0 + u <= hi) ? expf(sc[u] - mx) : 0.f;
            psum += p[u];
            if constexpr (kScaled) p[u] *= vs[u];  // the V row's scale rides on its weight
          }
          l[g] = l[g] * corr + psum;
#pragma unroll
          for (int e = 0; e < N; ++e) {
            float a = acc[g][e] * corr;
#pragma unroll
            for (int u = 0; u < kU; ++u) a += p[u] * vr[u][e];
            acc[g][e] = a;
          }
          m[g] = mx;
        }
      }
    }
    repro::cp_async_wait<0>();
  }

  // the warps' states meet in shared memory (the ring's, free after this
  // barrier); an empty range leaves every warp's state empty
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(smem);  // [kWarps][GC]
  float* sm_l = sm_m + kWarps * GC;              // [kWarps][GC]
  float* sm_acc = sm_l + kWarps * GC;            // [kWarps][GC][kWidth]
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm_m[warp * GC + g] = m[g];
      sm_l[warp * GC + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) sm_acc[(warp * GC + g) * kWidth + lane * N + e] = acc[g][e];
  }
  __syncthreads();
  float* ws_ml = ws + static_cast<int64_t>(B) * KV * G * splits * D;  // after the sums
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * GC + g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm_m[w * GC + g] - mm);
      ll += sm_l[w * GC + g] * e;
      aa += sm_acc[(w * GC + g) * kWidth + d] * e;
    }
    if (splits == 1) {
      repro::store_f32(out + qo + idx, aa / fmaxf(ll, 1e-30f));
      continue;
    }
    const int64_t row = (bh * G + g0 + g) * splits + s;
    ws[row * D + d] = aa;
    if (d == 0) {
      ws_ml[row * 2] = mm;
      ws_ml[row * 2 + 1] = ll;
    }
  }
  if (splits == 1) return;
  __threadfence();  // this block's partial is visible before its ticket
  __syncthreads();
  int* ticket = counters + bh * chunks + c;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    const int64_t row = (bh * G + g0 + g) * splits;
    float mm = kNegInf;
    for (int z = 0; z < splits; ++z) mm = fmaxf(mm, __ldcg(ws_ml + (row + z) * 2));
    float ll = 0.f, aa = 0.f;
    for (int z = 0; z < splits; ++z) {  // in split order: the sum does not depend on timing
      const float e = expf(__ldcg(ws_ml + (row + z) * 2) - mm);
      ll += __ldcg(ws_ml + (row + z) * 2 + 1) * e;
      aa += __ldcg(ws + (row + z) * D + d) * e;
    }
    repro::store_f32(out + qo + idx, aa / fmaxf(ll, 1e-30f));
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next launch
}

}  // namespace

// qdtype: the type of q and out; sdtype: the K/V store (repro::DType codes).
// k_scale/v_scale: null for an unscaled store. span: positions per split
// (kernels/decode_attention.py::split_span), so splits = ceil(S / span); ws:
// f32 scratch of B * KV * G * splits * (D + 2) elements and counters: int32
// zeros, one per (slot, KV head, chunk of the group), left zero — both may
// be null when splits == 1. Returns cudaGetLastError() after the launch, -1
// for a (D, G) outside the domain or a grid past its limits, -2 for an
// unsupported combination of types and scales, -3 for missing scratch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale,
                                      const void* cur_len, void* ws, void* counters, void* out,
                                      int B, int S, int KV, int G, int D, int window, int span,
                                      int qdtype, int sdtype, void* stream) {
  if (G < 1 || G > repro::kMaxGroup || span < 1) return -1;
  const int gc = G == 1 ? 1 : G <= 4 ? 4 : 8;
  const int chunks = (G + gc - 1) / gc;
  const int splits = S > span ? (S + span - 1) / span : 1;
  if (static_cast<int64_t>(chunks) * splits > 65535 || KV > 65535) return -1;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return -3;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, KV, chunks * splits);
  return repro::dispatch_types(qdtype, sdtype, k_scale != nullptr, [&](auto tq, auto ts, auto sc) {
    using TQ = typename decltype(tq)::type;
    using TS = typename decltype(ts)::type;
    constexpr bool kScaled = decltype(sc)::value;
#define REPRO_CASE(DD, GG)                                                                    \
  if (D == DD && gc == GG) {                                                                  \
    constexpr int kBytes = split_smem_bytes<TS, kScaled, DD, GG>();                           \
    auto* kernel = decode_split_kernel<TQ, TS, kScaled, DD, GG>;                              \
    static bool raised[64];                                                                   \
    const cudaError_t err = repro::raise_smem(kernel, kBytes, raised);                        \
    if (err != cudaSuccess) return static_cast<int>(err);                                     \
    kernel<<<grid, kThreads, kBytes, st>>>(                                                   \
        static_cast<const TQ*>(q), static_cast<const TS*>(k), static_cast<const TS*>(v),      \
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),               \
        static_cast<const int*>(cur_len), static_cast<TQ*>(out), static_cast<float*>(ws),     \
        static_cast<int*>(counters), B, S, KV, G, window, span);                              \
    return static_cast<int>(cudaGetLastError());                                              \
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
