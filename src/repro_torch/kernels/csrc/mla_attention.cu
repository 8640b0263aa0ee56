// Packed ragged attention in MLA latent space: a flat [T] token batch —
// prefill chunks and decode singletons of any slots mixed — against the
// compressed latent cache of multi-head latent attention (minicpm3-4b,
// deepseek-v2-lite), as one shared "head" for every query head (latent MQA).
//
// Replaces the TPU kernel repro/kernels/ragged_attention.py::ragged_attention
// (_ragged_kernel, pl.pallas_call at :253) as repro/kernels/ops.py::
// mla_ragged_attention drives it (:392): there the keys are concat(ckv,
// krope) and the values concat(ckv, 0), both materialised in HBM on every
// call, and the query is pre-scaled to cancel the kernel's D^-0.5. Here:
//   out[t, h, :] = softmax_p((q_eff[t, h] . ckv[s, p] + q_rope[t, h] .
//                  krope[s, p]) * scale) . ckv[s, p]
// over p <= tok_pos[t], s = tok_slot[t] (a GLOBAL cache row), reading ckv
// [B, S, r] and krope [B, S, rope] in place (no concatenated copy) and
// taking scale directly. q_eff [T, H, r], q_rope [T, H, rope], out [T, H, r],
// all in one dtype (f32 or bf16) with the cache. A padding token (tok_pos >=
// S) reads nothing and comes out as zeros (the TPU kernel and the plain
// version attend the whole slot there; nothing reads those rows).
//
// What bounds it on the H100: the bytes of q_eff, q_rope and out (H heads of
// r + rope + r elements a token) and of the latent rows of the real tokens'
// prefixes — a few MB at minicpm3's pack, a microsecond; the operations
// (2 (2r + rope) H flops a key and token) bound it only past ~300 keys a
// token at bf16.
//
// The design (simple first: mma.sync and cp.async, not yet wgmma and TMA):
// one block per (token, chunk of heads). The query heads of a token are the rows
// of the block's tile — up to 16 x MT of them (48 for minicpm3's 40 heads,
// 16 for deepseek's 16), the rows past H zero and never stored — so one
// staged latent row serves every head, and V is the first r lanes of that
// same staged row: each key position is loaded once, K and V together. The
// rows [r | rope] of the token's prefix stream through a ring of cp.async
// stages (64 positions a stage at bf16, 32 at f32, two to four stages in at
// most ~200 KB). A stage runs in three steps with a barrier between:
// S = Q K^T into shared memory (bf16: mma.sync m16n8k16, each warp one n8
// tile of keys over every m16 tile of rows; f32: two rows and one key a
// thread on the CUDA cores), the online softmax of each row by one warp
// (its (m, l) kept in the warp's registers, the rescale factor and P
// published to shared memory), then O += P V (bf16: each warp a strip of
// n8 tiles of dims over every row tile, P's A fragments by ldmatrix and V's
// B fragments by ldmatrix.trans of the staged rows; P split as bf16(P) plus
// bf16(P - bf16(P)) in two mmas, as exact as f32 math: one rounding of P put
// the dense ragged pack 0.031 off its plain version at tokens with few keys,
// whose outputs are V rows; f32: two rows and r/32 dims a thread). The row
// width D = r + rope need not be a multiple of 16 (D 40 at the reduced
// configs): at bf16 the staged rows are padded to whole 16-dim k-steps with
// zeros that no copy overwrites.
#include "attention_common.cuh"
#include "gemm_wgmma.cuh"
#include "mma_common.cuh"

namespace repro {
namespace mla {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemBudget = 200 * 1024;  // the ring and the tile's buffers

// The shapes of one instantiation: T the element type of q, the cache and
// out; R, ROPE the latent and rope widths; MT the m16 row tiles of a block
// (bf16; the f32 rows are 16, MT = 1).
template <typename T, int R, int ROPE, int MT>
struct Shape {
  static constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;
  static constexpr int D = R + ROPE;
  static constexpr int kDPad = kMma ? (D + 15) / 16 * 16 : D;  // whole k-steps at bf16
  static constexpr int HC = 16 * MT;                            // rows of a block
  static constexpr int KR = kMma ? 64 : 32;                     // positions a stage
  static constexpr int kEl = static_cast<int>(sizeof(T));
  static constexpr int kCL = R * kEl / 16, kCR = ROPE * kEl / 16;  // 16-byte copies of a row
  static constexpr int kC = kCL + kCR;
  static constexpr int kCPad = kDPad * kEl / 16;  // chunks of a padded row
  // an odd number of 16-byte chunks a staged row: the 8 rows an ldmatrix (or
  // a quarter warp's float4 loads) reads fall in 8 different bank groups
  static constexpr int kStride = kCPad % 2 == 0 ? kCPad * 16 + 16 : kCPad * 16;
  static constexpr int kStage = KR * kStride;
  static constexpr int kSStride = KR + 4;  // f32 scores (P at f32) a row
  static constexpr int kPStride = KR + 8;  // bf16 P a row: 9 chunks at KR 64
  static constexpr int kQ = HC * kStride;
  static constexpr int kS = HC * kSStride * 4;
  static constexpr int kP = kMma ? 2 * HC * kPStride * 2 : 0;  // bf16(P) and its remainder
  static constexpr int kFixed = kQ + kS + kP + 2 * HC * 4;     // + rescale, 1 / l a row
  static constexpr int kFit = (kSmemBudget - kFixed) / kStage;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static constexpr int kBytes = kStages * kStage + kFixed;
  static_assert(kStages >= 2, "two stages fit");
  static_assert(R % 32 == 0 && (R * kEl) % 16 == 0 && (ROPE * kEl) % 16 == 0, "whole copies");
  static_assert(kMma || MT == 1, "the f32 rows are one tile of 16");
  static_assert(HC % kWarps == 0, "each warp owns HC / 8 rows' softmax");
};

template <typename T, int R, int ROPE, int MT>
__global__ void __launch_bounds__(kThreads, 1)
mla_kernel(const T* __restrict__ q_eff, const T* __restrict__ q_rope, const T* __restrict__ ckv,
           const T* __restrict__ krope, const int* __restrict__ tok_slot,
           const int* __restrict__ tok_pos, T* __restrict__ out, int S, int H, float scale) {
  using Sh = Shape<T, R, ROPE, MT>;
  constexpr int HC = Sh::HC, KR = Sh::KR, kStride = Sh::kStride, NST = Sh::kStages;
  constexpr int kRowsW = HC / kWarps;  // softmax rows a warp
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sq = smem + NST * Sh::kStage;
  float* ss = reinterpret_cast<float*>(sq + Sh::kQ);
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<unsigned char*>(ss) +
                                                       Sh::kS);
  __nv_bfloat16* pl = ph + HC * Sh::kPStride;
  float* s_corr = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ss) + Sh::kS +
                                           Sh::kP);
  float* s_linv = s_corr + HC;

  const int t = blockIdx.x, h0 = blockIdx.y * HC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int lo, hi;
  token_key_range(tok_pos[t], S, 0, &lo, &hi);
  if (lo > hi) {  // a padding token: zeros, no key read
    for (int x = tid; x < HC * R; x += kThreads) {
      const int h = h0 + x / R;
      if (h < H) store_f32(out + (static_cast<int64_t>(t) * H + h) * R + x % R, 0.f);
    }
    return;
  }
  const int64_t slot = tok_slot[t];

  // the zero lanes of the padded rows (D 40 at bf16), which no copy writes
  if constexpr (Sh::kCPad > Sh::kC) {
    constexpr int kPad = Sh::kCPad - Sh::kC;
    for (int x = tid; x < (NST * KR + HC) * kPad; x += kThreads) {
      const int row = x / kPad, cc = Sh::kC + x % kPad;
      unsigned char* p = row < NST * KR ? smem + (row / KR) * Sh::kStage + (row % KR) * kStride
                                        : sq + (row - NST * KR) * kStride;
      *reinterpret_cast<uint4*>(p + cc * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the block's query rows [q_eff | q_rope], rows past H zero
  for (int x = tid; x < HC * Sh::kC; x += kThreads) {
    const int row = x / Sh::kC, cc = x % Sh::kC, h = h0 + row;
    const bool ok = h < H;
    const int64_t qr = static_cast<int64_t>(t) * H + (ok ? h : 0);
    const unsigned char* src =
        cc < Sh::kCL ? reinterpret_cast<const unsigned char*>(q_eff + qr * R) + cc * 16
                     : reinterpret_cast<const unsigned char*>(q_rope + qr * ROPE) +
                           (cc - Sh::kCL) * 16;
    cp_async16(sq + row * kStride + cc * 16, src, ok);
  }
  cp_async_commit();

  // stage i holds positions lo + i * KR .. + KR - 1 of the slot (zeros past hi)
  const int n_stages = (hi - lo + KR) / KR;
  auto load_stage = [&](int st, int si) {
    unsigned char* base = smem + st * Sh::kStage;
    const int p0 = lo + si * KR;
    for (int x = tid; x < KR * Sh::kC; x += kThreads) {
      const int r = x / Sh::kC, cc = x % Sh::kC;
      const bool ok = p0 + r <= hi;
      const int64_t row = slot * S + (ok ? p0 + r : lo);
      const unsigned char* src =
          cc < Sh::kCL ? reinterpret_cast<const unsigned char*>(ckv + row * R) + cc * 16
                       : reinterpret_cast<const unsigned char*>(krope + row * ROPE) +
                             (cc - Sh::kCL) * 16;
      cp_async16(base + r * kStride + cc * 16, src, ok);
    }
  };

  float m_run[kRowsW], l_run[kRowsW];  // rows warp + 8 i: the same in every lane of the warp
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  const int g = lane >> 2, tq = lane & 3;
  // bf16: this warp's n8 tiles of dims [warp * kNPW, + kNPW) over every row tile;
  // f32: rows warp and warp + 8, dims lane + 32 c
  constexpr int kNT = R / 8, kNPW = (kNT + kWarps - 1) / kWarps;
  constexpr int kA0 = Sh::kMma ? MT : 2, kA1 = Sh::kMma ? kNPW : R / 32, kA2 = Sh::kMma ? 4 : 1;
  float acc[kA0][kA1][kA2];  // bf16: [row tile][n8 tile][accumulator]; f32: [row][dim / 32][1]
#pragma unroll
  for (int a = 0; a < kA0; ++a)
#pragma unroll
    for (int b = 0; b < kA1; ++b)
#pragma unroll
      for (int c = 0; c < kA2; ++c) acc[a][b][c] = 0.f;

#pragma unroll
  for (int p = 0; p < NST - 1; ++p) {
    if (p < n_stages) load_stage(p, p);
    cp_async_commit();
  }
  for (int si = 0; si < n_stages; ++si) {
    cp_async_wait<NST - 2>();  // stage si (and the queries) have landed (this thread's copies)
    __syncthreads();           // ... and everyone's; stage si - 1 is free
    const int nxt = si + NST - 1;
    if (nxt < n_stages) load_stage(nxt % NST, nxt);
    cp_async_commit();
    const unsigned char* sk = smem + (si % NST) * Sh::kStage;
    const int tb = lo + si * KR;  // the position of the stage's row 0

    // ---- S = Q K^T * scale into ss [HC][kSStride]
    if constexpr (Sh::kMma) {
      float sacc[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) sacc[m][0] = sacc[m][1] = sacc[m][2] = sacc[m][3] = 0.f;
#pragma unroll 2
      for (int s = 0; s < Sh::kDPad / 16; ++s) {
        uint32_t b[2];  // keys 8 warp .. + 7; dims 16 s .. + 7, then + 8 .. + 15
        ldsm_x2(b, sk + (8 * warp + (lane & 7)) * kStride + (16 * s + 8 * ((lane >> 3) & 1)) * 2);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          ldsm_x4(a, sq + (16 * m + (lane & 15)) * kStride + (16 * s + 8 * (lane >> 4)) * 2);
          mma_16816(sacc[m], a, b);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int col = 8 * warp + 2 * tq;
        *reinterpret_cast<float2*>(ss + (16 * m + g) * Sh::kSStride + col) =
            make_float2(sacc[m][0] * scale, sacc[m][1] * scale);
        *reinterpret_cast<float2*>(ss + (16 * m + g + 8) * Sh::kSStride + col) =
            make_float2(sacc[m][2] * scale, sacc[m][3] * scale);
      }
    } else {
      const float* kr = reinterpret_cast<const float*>(sk + lane * kStride);
      const float* q0 = reinterpret_cast<const float*>(sq + warp * kStride);
      const float* q1 = reinterpret_cast<const float*>(sq + (warp + 8) * kStride);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int d = 0; d < Sh::D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
        const float4 x = *reinterpret_cast<const float4*>(q0 + d);
        const float4 y = *reinterpret_cast<const float4*>(q1 + d);
        a0 += x.x * k4.x + x.y * k4.y + x.z * k4.z + x.w * k4.w;
        a1 += y.x * k4.x + y.y * k4.y + y.z * k4.z + y.w * k4.w;
      }
      ss[warp * Sh::kSStride + lane] = a0 * scale;
      ss[(warp + 8) * Sh::kSStride + lane] = a1 * scale;
    }
    __syncthreads();

    // ---- the online softmax of each row, one warp a row; keys past hi weigh 0
#pragma unroll
    for (int i = 0; i < kRowsW; ++i) {
      const int row = warp + kWarps * i;
      constexpr int kPer = KR / 32;  // keys a lane
      float sc[kPer], mx = kNegInf;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int key = lane + 32 * e;
        sc[e] = ss[row * Sh::kSStride + key];
        if (tb + key <= hi) mx = fmaxf(mx, sc[e]);
      }
      const bool live = h0 + row < H;  // a padded row keeps P = 0 and its zero sums
      const float m_new = fmaxf(m_run[i], warp_max(mx));
      const float corr = live ? expf(m_run[i] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int key = lane + 32 * e;
        const float p = live && tb + key <= hi ? expf(sc[e] - m_new) : 0.f;
        psum += p;
        if constexpr (Sh::kMma) {
          const __nv_bfloat16 hb = __float2bfloat16(p);
          ph[row * Sh::kPStride + key] = hb;
          pl[row * Sh::kPStride + key] = __float2bfloat16(p - __bfloat162float(hb));
        } else {
          ss[row * Sh::kSStride + key] = p;  // P in place of its score
        }
      }
      l_run[i] = l_run[i] * corr + warp_sum(psum);
      m_run[i] = m_new;
      if (lane == 0) s_corr[row] = corr;
    }
    __syncthreads();

    // ---- O = O * corr + P V, V the first R lanes of the staged rows
    if constexpr (Sh::kMma) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float c0 = s_corr[16 * m + g], c1 = s_corr[16 * m + g + 8];
#pragma unroll
        for (int j = 0; j < kNPW; ++j) {
          acc[m][j][0] *= c0;
          acc[m][j][1] *= c0;
          acc[m][j][2] *= c1;
          acc[m][j][3] *= c1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk) {
        if (tb + 16 * kk > hi) break;  // keys past hi: P = 0 (the same in every warp)
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int off = (16 * m + (lane & 15)) * Sh::kPStride + 16 * kk + 8 * (lane >> 4);
          ldsm_x4(ah[m], ph + off);
          ldsm_x4(al[m], pl + off);
        }
#pragma unroll
        for (int j = 0; j < kNPW; ++j) {
          const int nt = warp * kNPW + j;
          if (nt >= kNT) break;  // R 32: four tiles, warps 4-7 idle
          uint32_t b[2];  // keys 16 kk .. + 7, then + 8 .. + 15; dims 8 nt .. + 7
          ldsm_x2_trans(b, sk + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kStride +
                               nt * 16);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_16816(acc[m][j], ah[m], b);
            mma_16816(acc[m][j], al[m], b);
          }
        }
      }
    } else {
      const float c0 = s_corr[warp], c1 = s_corr[warp + 8];
#pragma unroll
      for (int c = 0; c < R / 32; ++c) {
        acc[0][c][0] *= c0;
        acc[1][c][0] *= c1;
      }
      const int nk = min(KR, hi - tb + 1);
      for (int j = 0; j < nk; ++j) {
        const float p0 = ss[warp * Sh::kSStride + j], p1 = ss[(warp + 8) * Sh::kSStride + j];
        const float* vr = reinterpret_cast<const float*>(sk + j * kStride);
#pragma unroll
        for (int c = 0; c < R / 32; ++c) {
          const float v = vr[lane + 32 * c];
          acc[0][c][0] += p0 * v;
          acc[1][c][0] += p1 * v;
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- out = O / l, the live rows only
#pragma unroll
  for (int i = 0; i < kRowsW; ++i)
    if (lane == 0) s_linv[warp + kWarps * i] = 1.f / fmaxf(l_run[i], 1e-30f);
  __syncthreads();
  T* ot = out + static_cast<int64_t>(t) * H * R;
  if constexpr (Sh::kMma) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = 16 * m + g + 8 * half, h = h0 + row;
        if (h >= H) continue;
        const float li = s_linv[row];
#pragma unroll
        for (int j = 0; j < kNPW; ++j) {
          const int nt = warp * kNPW + j;
          if (nt >= kNT) break;
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[m][j][2 * half] * li,
                                                         acc[m][j][2 * half + 1] * li);
          *reinterpret_cast<__nv_bfloat162*>(ot + static_cast<int64_t>(h) * R + 8 * nt + 2 * tq) =
              v;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp + 8 * i, h = h0 + row;
      if (h >= H) continue;
      const float li = s_linv[row];
#pragma unroll
      for (int c = 0; c < R / 32; ++c)
        store_f32(ot + static_cast<int64_t>(h) * R + lane + 32 * c, acc[i][c][0] * li);
    }
  }
}

template <typename T, int R, int ROPE, int MT>
int launch(const void* q_eff, const void* q_rope, const void* ckv, const void* krope,
           const void* tok_slot, const void* tok_pos, void* out, int T_, int S, int H,
           float scale, cudaStream_t st) {
  using Sh = Shape<T, R, ROPE, MT>;
  auto* kernel = mla_kernel<T, R, ROPE, MT>;
  static bool raised[64];
  const cudaError_t err = raise_smem(kernel, Sh::kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(T_, (H + Sh::HC - 1) / Sh::HC);
  kernel<<<grid, kThreads, Sh::kBytes, st>>>(
      static_cast<const T*>(q_eff), static_cast<const T*>(q_rope), static_cast<const T*>(ckv),
      static_cast<const T*>(krope), static_cast<const int*>(tok_slot),
      static_cast<const int*>(tok_pos), static_cast<T*>(out), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mla
}  // namespace repro

// q_eff [T, H, R], q_rope [T, H, ROPE], ckv [B, S, R], krope [B, S, ROPE],
// out [T, H, R], all of dtype (repro::DType: f32 or bf16); tok_slot/tok_pos
// [T] int32, tok_slot a global cache row. mt: the m16 row tiles of a block
// (bf16: 1 to 4 at R 32, 1 to 3 at R 256, 1 at R 512; f32: 1), the heads
// running in chunks of 16 * mt (kernels/mla_attention.py::plan). Returns
// cudaGetLastError() after the launch, -1 for a (R, ROPE, mt) or H outside
// the instantiated domain, -2 for another dtype.
extern "C" int repro_mla_attention(const void* q_eff, const void* q_rope, const void* ckv,
                                   const void* krope, const void* tok_slot, const void* tok_pos,
                                   void* out, int T, int S, int H, int R, int ROPE, int mt,
                                   float scale, int dtype, void* stream) {
  using namespace repro::mla;
  if (T < 1 || S < 1 || H < 1 || H > 64) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MLA(TT, RR, PP, MM)                                                      \
  if (R == RR && ROPE == PP && mt == MM)                                               \
    return launch<TT, RR, PP, MM>(q_eff, q_rope, ckv, krope, tok_slot, tok_pos, out, T, S, H, \
                                  scale, st);
  if (dtype == repro::kBF16) {
    using bf16 = __nv_bfloat16;
    REPRO_MLA(bf16, 32, 8, 1) REPRO_MLA(bf16, 32, 8, 2) REPRO_MLA(bf16, 32, 8, 3)
    REPRO_MLA(bf16, 32, 8, 4)
    REPRO_MLA(bf16, 256, 32, 1) REPRO_MLA(bf16, 256, 32, 2) REPRO_MLA(bf16, 256, 32, 3)
    REPRO_MLA(bf16, 512, 64, 1)
    return -1;
  }
  if (dtype == repro::kF32) {
    REPRO_MLA(float, 32, 8, 1) REPRO_MLA(float, 256, 32, 1) REPRO_MLA(float, 512, 64, 1)
    return -1;
  }
#undef REPRO_MLA
  return -2;
}
