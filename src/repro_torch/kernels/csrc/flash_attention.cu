// Flash attention: flat and GQA prefill, causal or not.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel) and ::gqa_flash_attention (_gqa_flash_kernel), both over
// _flash_tile_body and _online_softmax_update: q [BKV, G, Sq, D], k/v
// [BKV, Sk, D]; query i sees key j iff j < Sk (the kv_len tail mask) and,
// when causal, j <= i (top-left aligned, also when Sq != Sk). Returns
// [BKV, G, Sq, D]. The flat op is G = 1 with one grid row per (batch, head).
// D is 16, 32, 64, 80 or 128.
//
// What bounds it on the H100: at the prompt lengths the engine prefills
// (buckets up to the prefill budget, 64 tokens by default) the bytes of q, k,
// v and out; for long prompts (the kernel API's S = 1024) the 4 * Sq * Sk / 2
// * D flops per head, which only tensor cores (wgmma) can deliver at the
// card's rate.
//
// bf16: wgmma on Hopper's tensor cores (flash_wgmma_kernel). A block holds
// BQ = 64 or 128 rows of the [G * Sq, D] query matrix of one KV head (the G
// heads of the group packed into M, row g * Sq + i at position i), so every
// K/V tile is loaded once for the whole group and a short prefill still
// fills the 64-row tile. Each 64 rows are one consumer warpgroup:
// - S = Q K^T with wgmma m64nBKk16 (bf16 in, f32 accumulate), Q and the
//   K tile read from shared memory through K-major descriptors;
// - the online softmax runs on the accumulator fragments in registers
//   (exp2 with log2(e) folded into the scale); a row's max and sum reduce
//   over the four threads that share it, the sum only once at the end;
// - P is rounded to bf16 in registers, where the accumulator's layout is
//   already the A-operand layout of O += P V (wgmma m64nDk16, A from
//   registers), and the V tile is read through a transposed (MN-major)
//   descriptor. O stays in f32 registers; 1/l is applied at the end.
// Q and the K/V tiles sit in shared memory in the 128-byte-swizzled layout
// the descriptors name (rows of 64 columns; D = 80 and 128 take two such
// column blocks, D = 16 and 32 one, partly used). A producer warp loads them
// with TMA (3-D tensor maps [heads][rows][D], boxes of 64 columns, zero-
// filled past Sk, the group's rows or D) into rings of two K and two V
// stages; mbarriers count each stage's bytes in (full) and the consumers'
// reads out (empty), so later tiles land while one is computed and no block
// barrier runs in the key loop. Within a warpgroup the loop is software-
// pipelined: tile k's S = Q K^T and tile k - 1's O += P V are issued
// together, the softmax of tile k runs once S is done while P V still
// occupies the tensor cores, and a K stage is released as soon as its S is
// read. With causal, the key loop stops at the
// block's last query position and only tiles that cross the diagonal or
// the Sk tail are masked; the causal blocks with the most tiles start first.
// The tile (block_q, block_k) = (BQ, BK) is the autotuner's knob: (64, 64),
// (64, 128), (128, 64) or (128, 128); (64, 64) is the serving default.
//
// f32: CUDA cores (flash_kernel): wgmma would read f32 as TF32, whose ten
// mantissa bits the f32 tolerances do not allow. One block per (B*KV row,
// query head g, BQ-row Q tile), the TPU grid's K axis a loop inside the
// block that stops at the causal diagonal. Each BK-key K/V tile is staged
// in shared memory (rows padded by one word so the per-lane dot products hit
// distinct banks); each warp owns 4 query rows, lane c scores keys c, c +
// 32, ... of the tile, and the online softmax runs in f32 registers. Lane c
// owns output columns c, c + 32, ... (lanes past D idle in P.V at D = 16 and
// 80). Tiles: (16, 32), (32, 32), (32, 64) and (64, 64), the serving default;
// tiles above the 48 KB of static shared memory take dynamic shared memory.
// Ping-pong consumer warpgroups and persistent blocks are later work.

#include <climits>

#include "attention_common.cuh"
#include "gemm_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::fence_operand;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_addr;
using repro::smem_desc;
using repro::tma_load;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_rs;
using repro::wgmma_ss;
using repro::wgmma_wait;

// ------------------------------------------------------ f32: CUDA cores

constexpr int kRowsPerWarp = 4;

template <int D, int BQ, int BK>
struct Tiles {
  float q[BQ][D];
  float k[BK][D + 1];
  float v[BK][D + 1];
};

// Static shared memory where the tiles fit its 48 KB, dynamic shared memory
// above: with dynamic shared memory the (16, 32) tile ran 13% slower at the
// engine's 64-token prefill (0.0184 against 0.0163 ms,
// scripts/torch_attention_ab.py, H100 SXM).
template <int D, int BQ, int BK>
constexpr bool kStaticTiles = sizeof(Tiles<D, BQ, BK>) <= 48 * 1024;

template <int D, int BQ, int BK>
__device__ __forceinline__ Tiles<D, BQ, BK>& tiles() {
  if constexpr (kStaticTiles<D, BQ, BK>) {
    __shared__ Tiles<D, BQ, BK> t;
    return t;
  } else {
    extern __shared__ float4 dyn[];
    return *reinterpret_cast<Tiles<D, BQ, BK>*>(dyn);
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(BQ / kRowsPerWarp * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int G, int Sq, int Sk, int causal) {
  constexpr int kThreads = BQ / kRowsPerWarp * 32;
  constexpr int NK = BK / 32;         // keys per lane per tile
  constexpr int NC = (D + 31) / 32;   // output columns per lane
  Tiles<D, BQ, BK>& t = tiles<D, BQ, BK>();
  auto& qs = t.q;
  auto& ks = t.k;
  auto& vs = t.v;

  const int bkv = blockIdx.x, g = blockIdx.y, q0 = blockIdx.z * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t qo_base = ((static_cast<int64_t>(bkv) * G + g) * Sq) * D;
  const T* kb = k + static_cast<int64_t>(bkv) * Sk * D;
  const T* vb = v + static_cast<int64_t>(bkv) * Sk * D;
  const float scale = rsqrtf(static_cast<float>(D));

  for (int idx = threadIdx.x; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qs[r][c] = q0 + r < Sq ? repro::to_f32(q[qo_base + static_cast<int64_t>(q0 + r) * D + c]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = repro::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[rr][i] = 0.f;
  }

  // keys past the last query row of this tile are masked for every row
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const bool ok = k0 + r < Sk;
      const int64_t off = static_cast<int64_t>(k0 + r) * D + c;
      ks[r][c] = ok ? repro::to_f32(kb[off]) : 0.f;
      vs[r][c] = ok ? repro::to_f32(vb[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float s[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) s[j] = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) {
        const float qc = qs[r][c];
#pragma unroll
        for (int j = 0; j < NK; ++j) s[j] += qc * ks[lane + 32 * j][c];
      }
      float tile_max = repro::kNegInf;
      bool valid[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int key = k0 + lane + 32 * j;
        s[j] *= scale;
        valid[j] = key < Sk && (!causal || key <= q0 + r);
        if (valid[j]) tile_max = fmaxf(tile_max, s[j]);
      }
      const float m_new = fmaxf(m[rr], repro::warp_max(tile_max));
      float p[NK], p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        p[j] = valid[j] ? expf(s[j] - m_new) : 0.f;
        p_sum += p[j];
      }
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + repro::warp_sum(p_sum);
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[rr][i] *= corr;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll 8
        for (int c = 0; c < 32; ++c) {
          const float pc = __shfl_sync(0xffffffffu, p[j], c);
#pragma unroll
          for (int i = 0; i < NC; ++i)
            if (D % 32 == 0 || lane + 32 * i < D) acc[rr][i] += pc * vs[32 * j + c][lane + 32 * i];
        }
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (D % 32 == 0 || lane + 32 * i < D)
        repro::store_f32(out + qo_base + static_cast<int64_t>(row) * D + lane + 32 * i,
                         acc[rr][i] * inv);
  }
}

template <typename T, int D, int BQ, int BK>
int launch_tile(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
                int Sk, int causal, cudaStream_t stream) {
  constexpr int kSmem = kStaticTiles<D, BQ, BK> ? 0 : sizeof(Tiles<D, BQ, BK>);
  auto kernel = flash_kernel<T, D, BQ, BK>;
  if (kSmem > 0) {
    static bool raised[64] = {};  // once per device and instantiation
    const cudaError_t err = repro::raise_smem(kernel, kSmem, raised);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(BKV, G, (Sq + BQ - 1) / BQ);
  kernel<<<grid, BQ / kRowsPerWarp * 32, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), G, Sq, Sk, causal);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- bf16: wgmma

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D, int BQ, int BK>
struct WgTiles {
  static constexpr int kBlocks = (D + 63) / 64;  // 64-column blocks of a row
  static constexpr int kQ = kBlocks * BQ * 128;  // bytes of the Q tile
  static constexpr int kKV = kBlocks * BK * 128;  // bytes of one K or V stage
  static constexpr int kStages = 2;
  // Q, the K ring, the V ring, the barriers, and room to align the base to
  // 1024 bytes (the 128-byte swizzle's atom)
  static constexpr int kBytes = kQ + 2 * kStages * kKV + 1024 + 1024;
  static constexpr int kConsumers = BQ * 2;  // one warpgroup of 128 threads per 64 rows
  static constexpr int kThreads = kConsumers + 32;  // and one producer warp
};

// The tensor maps of q [BKV, M, D], k and v [BKV, Sk, D]: boxes of 64
// columns x BQ (q) or BK (k, v) rows of one head, 128-byte swizzled as the
// wgmma descriptors read them, zero-filled past the rows or columns.
struct Maps {
  CUtensorMap q, k, v;
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(WgTiles<D, BQ, BK>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ out, int G, int Sq,
                   int Sk, int causal) {
  using Tl = WgTiles<D, BQ, BK>;
  constexpr int kS = Tl::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sk = sq + Tl::kQ;
  uint8_t* sv = sk + kS * Tl::kKV;
  // per stage: K landed, V landed, K read by every consumer, V read likewise
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sv + kS * Tl::kKV);
  uint64_t* full_v = full_k + kS;
  uint64_t* empty_k = full_v + kS;
  uint64_t* empty_v = empty_k + kS;
  uint64_t* q_full = empty_v + kS;

  const int tid = threadIdx.x;
  const int M = G * Sq;  // the group's query rows, g * Sq + i
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the most key tiles first
  const int m_hi = min(m0 + BQ, M) - 1;
  const bool wraps = m0 / Sq != m_hi / Sq;
  const int min_i = wraps ? 0 : m0 % Sq, max_i = wraps ? Sq - 1 : m_hi % Sq;
  const int k_end = causal ? min(Sk, max_i + 1) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int bkv = blockIdx.y;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], Tl::kConsumers);
      mbar_init(&empty_v[s], Tl::kConsumers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= Tl::kConsumers) {
    // the producer warp: one lane keeps the K and V rings full with TMA loads
    if (tid == Tl::kConsumers) {
      mbar_expect_tx(q_full, Tl::kQ);
      for (int b = 0; b < Tl::kBlocks; ++b)
        tma_load(sq + b * BQ * 128, &maps.q, q_full, 64 * b, m0, bkv);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kS, round = ((it / kS) & 1) ^ 1;  // the first round passes
        mbar_wait(&empty_k[st], round);
        mbar_expect_tx(&full_k[st], Tl::kKV);
        for (int b = 0; b < Tl::kBlocks; ++b)
          tma_load(sk + st * Tl::kKV + b * BK * 128, &maps.k, &full_k[st], 64 * b, it * BK, bkv);
        mbar_wait(&empty_v[st], round);
        mbar_expect_tx(&full_v[st], Tl::kKV);
        for (int b = 0; b < Tl::kBlocks; ++b)
          tma_load(sv + st * Tl::kKV + b * BK * 128, &maps.v, &full_v[st], 64 * b, it * BK, bkv);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows wg * 64 .. wg * 64 + 63 of the
  // tile. This thread's two rows (the accumulator layout: warp w holds rows
  // 16w .. 16w + 15, lane l rows l / 4 and l / 4 + 8, and columns
  // 8j + 2 (l % 4) + {0, 1} of every 8-column block j)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const int pos[2] = {(m0 + r0) % Sq, (m0 + r0 + 8) % Sq};
  const int col = 2 * (lane & 3);
  const float scale = rsqrtf(static_cast<float>(D)) * 1.4426950408889634f;  // log2(e) / sqrt(D)

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float s[BK / 2];
  uint32_t pa[BK / 16][4];

  // S = Q K^T of tile it, issued (not waited for)
  auto issue_s = [&](int it) {
    const uint8_t* kt = sk + (it % kS) * Tl::kKV;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int koff = (kk & 3) * 32;  // the 16-column step inside column block kk / 4
      const uint64_t da = smem_desc(sq + (kk >> 2) * BQ * 128 + wg * 64 * 128 + koff, 16, 1024);
      const uint64_t db = smem_desc(kt + (kk >> 2) * BK * 128 + koff, 16, 1024);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile it, P from `p` (registers), issued (not waited for)
  auto issue_pv = [&](int it, const uint32_t (&p)[BK / 16][4]) {
    const uint8_t* vt = sv + (it % kS) * Tl::kKV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, p[kk], smem_desc(vt + kk * 16 * 128, BK * 128, 1024));
    wgmma_commit();
  };
  // the online softmax of tile it's scores s: the running max and sum move
  // on, P goes to `p` as bf16 A fragments, corr is O's rescale
  auto softmax = [&](int it, uint32_t (&p)[BK / 16][4], float (&corr)[2]) {
    const int k0 = it * BK;
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > min_i);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * h + e];
          x *= scale;
          if (masked) {
            const int key = k0 + 8 * j + col + e;
            if (key >= Sk || (causal && key > pos[h])) x = -INFINITY;
          }
          mx[h] = fmaxf(mx[h], x);
        }
      }
    }
    float base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      base[h] = mx[h] == -INFINITY ? 0.f : mx[h];  // a row with no key yet
      corr[h] = exp2f(m_run[h] - base[h]);
      m_run[h] = mx[h];
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(s[4 * j + 2 * h] - base[h]);
        const float p1 = exp2f(s[4 * j + 2 * h + 1] - base[h]);
        l_run[h] += p0 + p1;
        // column block j is half (j % 2) of the 16-key step j / 2: registers
        // 0 and 1 (rows r, r + 8) of its first 8 keys, 2 and 3 of its second
        p[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
      }
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };

  // The key loop, software-pipelined within the warpgroup: tile it's S =
  // Q K^T and tile it - 1's O += P V run on the tensor cores while this
  // thread's softmax of tile it waits only for the first; O is rescaled
  // once the second is done. A K stage is released when its S is read, a V
  // stage when its P V is.
  float corr[2];
  mbar_wait(q_full, 0);
  mbar_wait(&full_k[0], 0);
  issue_s(0);
  wgmma_wait<0>();
  fence_operand(s);
  mbar_arrive(&empty_k[0]);
  softmax(0, pa, corr);
  for (int it = 1; it < n_tiles; ++it) {
    mbar_wait(&full_k[it % kS], (it / kS) & 1);
    issue_s(it);
    mbar_wait(&full_v[(it - 1) % kS], ((it - 1) / kS) & 1);
    issue_pv(it - 1, pa);
    wgmma_wait<1>();  // S of tile it (groups retire in order)
    fence_operand(s);
    mbar_arrive(&empty_k[it % kS]);
    uint32_t pn[BK / 16][4];
    softmax(it, pn, corr);
    wgmma_wait<0>();  // P V of tile it - 1: pa and o are free
    fence_operand(o);
    fence_operand(pa);
    mbar_arrive(&empty_v[(it - 1) % kS]);
    rescale(corr);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pn[kk][r];
  }
  mbar_wait(&full_v[(n_tiles - 1) % kS], ((n_tiles - 1) / kS) & 1);
  issue_pv(n_tiles - 1, pa);
  wgmma_wait<0>();
  fence_operand(o);
  fence_operand(pa);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = out + (static_cast<int64_t>(bkv) * M + m) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// A [heads][rows][D] bf16 tensor as boxes of 64 columns x `box_rows` rows.
bool make_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return repro::encode_map(map, ptr, 3, dims, strides, box);
}

template <int D, int BQ, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
                 int Sk, int causal, cudaStream_t stream) {
  using Tl = WgTiles<D, BQ, BK>;
  auto kernel = flash_wgmma_kernel<D, BQ, BK>;
  static bool raised[64] = {};  // the attribute, once per device and instantiation
  const cudaError_t err = repro::raise_smem(kernel, Tl::kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t M = static_cast<int64_t>(G) * Sq;
  const int64_t m_tiles = (M + BQ - 1) / BQ;
  if (M > INT_MAX || BKV > 65535) return -1;
  Maps maps;
  if (!make_map(&maps.q, q, D, static_cast<int>(M), BKV, BQ) ||
      !make_map(&maps.k, k, D, Sk, BKV, BK) || !make_map(&maps.v, v, D, Sk, BKV, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m_tiles), BKV);
  kernel<<<grid, Tl::kThreads, Tl::kBytes, stream>>>(maps, static_cast<bf16*>(out), G, Sq, Sk,
                                                     causal);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dispatch

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int BKV, int G, int Sq,
             int Sk, int causal, int block_q, int block_k, int dtype, cudaStream_t st) {
#define REPRO_TILE(BQ, BK)                                                                  \
  if (block_q == BQ && block_k == BK)                                                       \
    return launch_tile<float, D, BQ, BK>(q, k, v, out, BKV, G, Sq, Sk, causal, st);
#define REPRO_WG(BQ, BK)                                                                    \
  if (block_q == BQ && block_k == BK)                                                       \
    return launch_wgmma<D, BQ, BK>(q, k, v, out, BKV, G, Sq, Sk, causal, st);
  if (dtype == repro::kF32) {
    REPRO_TILE(16, 32) REPRO_TILE(32, 32) REPRO_TILE(32, 64) REPRO_TILE(64, 64)
  } else {
    REPRO_WG(64, 64) REPRO_WG(64, 128) REPRO_WG(128, 64) REPRO_WG(128, 128)
  }
#undef REPRO_WG
#undef REPRO_TILE
  return -1;  // tile not instantiated for this dtype
}

}  // namespace

// dtype: 0 = float32 (CUDA cores; tiles (16, 32), (32, 32), (32, 64), (64,
// 64)), 1 = bfloat16 (wgmma; tiles (64, 64), (64, 128), (128, 64), (128,
// 128)). D: 16, 32, 64, 80 or 128. Returns cudaGetLastError() after the
// launch, -1 for an unsupported D, tile or shape, -2 for an unsupported dtype.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int BKV, int G, int Sq, int Sk, int D, int causal,
                                     int block_q, int block_k, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != repro::kF32 && dtype != repro::kBF16) return -2;
#define REPRO_CASE(DD)                                                                      \
  if (D == DD)                                                                              \
    return launch_d<DD>(q, k, v, out, BKV, G, Sq, Sk, causal, block_q, block_k, dtype, st);
  REPRO_CASE(16) REPRO_CASE(32) REPRO_CASE(64) REPRO_CASE(80) REPRO_CASE(128)
#undef REPRO_CASE
  return -1;  // D not instantiated
}
