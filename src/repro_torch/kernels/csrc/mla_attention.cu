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
// What bounds it on the H100: counted as the bound counts it, the bytes —
// q_eff, q_rope and out (H heads of r + rope + r elements a token) and the
// latent rows of the real tokens' prefixes, each once: a few MB, about a
// microsecond at phase 2's pack; the operations (2 (2r + rope) H flops a
// key and token) only past ~300 keys a token at bf16. What sets the time
// is the longest chain of stages one SM walks and what one SM moves through
// L2 (~30 bytes a cycle measured): a tile's Q and its latent stages in, and
// the partials of a split tile out and back in to be merged.
//
// bf16 (mla_wgmma_kernel, every served width): the rows of the launch are
// the (token, head) pairs of [T * H], flattened, and a block owns a tile of
// 64 consecutive rows, one wgmma M: minicpm3's 40 heads put 1.6 tokens in a
// tile, so a chunk's tokens share every staged latent row. Each row masks
// the keys by its own token's position; a tile whose rows belong to several
// slots runs one pass per slot over the union of its tokens' ranges. Thread
// 0 lands the tile's [q_eff | q_rope] rows and the first 64-position latent
// stages [ckv | krope] by TMA (2-D maps over [T * H, r] and [T * H, rope],
// 3-D maps over [B, S, r] and [B, S, rope]; boxes of 64 columns, 128-byte
// swizzled, zero-filled past the rope width, the rows and the slot) into a
// ring of 2-4 stages guarded by full and empty mbarriers; V is the first r
// lanes of the staged row, so a position is landed once. Two consumer
// warpgroups, and no producer warp, so each thread may hold 255 registers:
// at r <= 256 they take alternate stages, each with its own online softmax
// and accumulator over all of V's columns, merged through shared memory at
// the end, and each refills the slots it frees; at r 512 (an accumulator of
// 512 columns is 256 registers) each takes half of V's columns over every
// stage. A warpgroup runs S = Q K^T as wgmma m64n64k16 over D = r + rope
// (18 k-steps at minicpm3, 36 at deepseek) from K-major descriptors, the
// online softmax on the accumulator fragments (a row's max and sum over the
// four threads that share it; no S or P in shared memory), and O += P V as
// wgmma with A from registers and V through an MN-major descriptor (N 256,
// or 32 at r 32), P's remainder bf16(P - bf16(P)) in a second wgmma into
// the same accumulator: one rounding of P put a pack's few-key tokens 0.031
// off the plain version (PRs 21-22). The output is staged in shared memory
// and stored in whole 16-byte rows. Split-KV: split s owns positions [s *
// span, (s + 1) * span), span a multiple of 256 from host values only
// (kernels/mla_attention.py::plan), so the longest prefix walks span / 64
// stages. The live splits of a tile are a prefix of them (every key range
// starts at 0): a block past them exits at once, and a tile with one live
// split writes its output directly. Otherwise each live block takes an
// atomic ticket (the per-(device, stream) counters of _checks.tickets, left
// zero): the blocks before the last write their partial (m, l, acc[r]) to
// f32 scratch (the caller's torch.empty, per call) and count it, and the
// last keeps its own in shared memory, waits for the count and merges the
// partials in split order, so the result does not depend on timing. No host
// sync, allocation or memset per call: the launch can be captured in a CUDA
// graph.
//
// Measured on an H100 (scripts/torch_mla_timeline.py: --time on copies of
// this kernel, --timeline on it): a stage takes a warpgroup ~5,000 cycles
// (S 1,600-2,000, softmax 1,300-1,500, P V 1,600-2,000), and two warpgroups
// on alternate stages overlap, where one beside a producer warp took 0.0232
// ms at phase 2's pack (0.0183 now); a producer warp beside two warpgroups
// capped ptxas at 168 registers (348 bytes spilled at r 512); the merge's
// sums run at the SM's L2 rate (~19 bytes a cycle), so the last block keeps
// its own partial. Taking turns at the tensor cores (0.0220 ms) and
// prefetching the tensor maps (0.0183) did not help.
//
// f32 (mla_f32_kernel, the reduced configs): CUDA cores, where wgmma would
// read f32 as TF32. One block per (token, chunk of 16 heads); the heads are
// the rows of the block, a staged latent row serves all of them, and the
// rows [r | rope] of the token's prefix stream through a cp.async ring of
// 32-position stages: S with two rows and one key a thread, the online
// softmax by one warp a row, P V with two rows and r / 32 dims a thread.
#include <climits>

#include "attention_common.cuh"
#include "gemm_wgmma.cuh"
#include "mma_common.cuh"

namespace repro {
namespace mla {

// ------------------------------------------------------- bf16: wgmma + TMA

constexpr int kRows = 64;           // (token, head) rows of a tile: one wgmma M
constexpr int kKeys = 64;           // positions of a latent stage
constexpr int kBox = kRows * 128;   // one 64-column box of 64 rows, 128-byte swizzled
constexpr int kSmemMax = 227 * 1024;
constexpr int kThreadsWg = 256;     // two consumer warpgroups
constexpr int kMaxSplits = 16;      // splits of a launch (kernels/mla_attention.py::MAX_SPLITS)

template <int R, int ROPE>
struct Wg {
  static constexpr int kLat = (R + 63) / 64;     // 64-column blocks of ckv (r 32: one, half used)
  static constexpr int kBlocks = kLat + 1;       // and one of krope (rope <= 64 columns used)
  static constexpr int kTile = kBlocks * kBox;   // bytes of the Q tile, and of one stage
  // r <= 256: the two warpgroups take alternate stages, each with its own
  // softmax state over all of V's columns; r 512: each takes half of V's
  // columns over every stage (512 columns are 256 accumulator registers)
  static constexpr bool kAlt = R <= 256;
  static constexpr int kN = kAlt ? R : R / 2;    // V columns of a warpgroup's accumulator
  static constexpr int kRelease = kAlt ? 128 : 256;  // arrivals that free a stage
  // the barriers and the tile's token table ([4][kRows] ints)
  static constexpr int kTables = 1024 + 4 * kRows * 4;
  static constexpr int kFit = (kSmemMax - 1024 - kTables - kTile) / kTile;
  static constexpr int kStages = kFit >= 4 ? 4 : 2;  // even: a slot keeps one warpgroup
  // room to align the base to 1024 bytes (the swizzle's atom), Q, the ring, the tables
  static constexpr int kBytes = 1024 + (1 + kStages) * kTile + kTables;
  static constexpr int kLatSteps = R / 16;             // k16 steps of q_eff . ckv
  static constexpr int kRopeSteps = (ROPE + 15) / 16;  // and of q_rope . krope
  // the epilogue, over Q and the ring: warpgroup 1's state (kAlt), or the
  // last block's own partial (m, l, O) and the merge's weights; then the
  // tile's bf16 rows
  static constexpr int kXchg = (R / 8 + 1) * 128 * 16;
  static constexpr int kOut = kXchg + kMaxSplits * 128 * 8 + 128 * 8;
  static constexpr int kOutStride = 2 * R + 16;  // bytes of an output row, staged
  static_assert(kOut + kRows * kOutStride <= (1 + kStages) * kTile, "the epilogue fits");
  static_assert(kXchg % 1024 == 0, "the weights start aligned");
  static_assert(R % 32 == 0 && ROPE % 8 == 0 && ROPE <= 64, "whole 16-byte rows, one rope box");
  static_assert(kN == 32 || kN == 256, "wgmma_rs's N");
  static_assert(kStages >= 2, "two stages fit");
};

// The tensor maps of q_eff [T * H, r], q_rope [T * H, rope], ckv [B, S, r]
// and krope [B, S, rope].
struct Maps {
  CUtensorMap q, qr, kv, kr;
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A split's partial of a tile, in the accumulators' order so that writes
// and reads are whole float4 rows of 128 threads: [R / 8 column blocks c]
// [128 threads t][4] (thread t's columns 8 c + 2 (t % 4) + {0, 1} of rows
// r(t) and r(t) + 8; r 512: warpgroup w's blocks after w * 32), the tile's
// (tile, split) blocks one after another, then (m of r(t), m of r(t) + 8,
// l, l) per (tile, split, t).
template <int R>
__device__ __forceinline__ int64_t part_base(int tile, int z, int splits) {
  return (static_cast<int64_t>(tile) * splits + z) * (16 * R);
}
template <int R>
__device__ __forceinline__ int64_t ml_base(int tile, int z, int splits, int tiles) {
  return static_cast<int64_t>(tiles) * splits * (16 * R) +
         (static_cast<int64_t>(tile) * splits + z) * 128;
}

template <int R, int ROPE>
__global__ void __launch_bounds__(kThreadsWg, 1)
mla_wgmma_kernel(const __grid_constant__ Maps maps, const int* __restrict__ tok_slot,
                 const int* __restrict__ tok_pos, float4* __restrict__ ws,
                 int* __restrict__ counters, __nv_bfloat16* __restrict__ out, int T, int S, int H,
                 int span, float scale_log2) {
  using W = Wg<R, ROPE>;
  constexpr int NS = W::kStages, kN = W::kN;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = sq + W::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * W::kTile);
  uint64_t* empty = full + NS;
  uint64_t* q_full = empty + NS;
  int* t_slot = reinterpret_cast<int*>(sq + (1 + NS) * W::kTile + 1024);
  int* t_hi = t_slot + kRows;   // a token's last key in this split, -1 for none
  int* t_top = t_hi + kRows;    // its last key in any split, -1 for a padding token
  int* p_hi = t_top + kRows;    // at the first token of a slot with keys here: the pass's last key

  const int tid = threadIdx.x;
  const int s = blockIdx.y, splits = gridDim.y;
  const int M = T * H;  // < 2^31 (the host checks)
  const int m0 = blockIdx.x * kRows;
  const int t0 = m0 / H;
  const int tn = (min(m0 + kRows, M) - 1) / H - t0 + 1;  // the tile's tokens, <= 64
  const int k_lo = s * span, k_end = k_lo + span - 1;

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], W::kRelease);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < tn) {
    int lo, hi;  // lo is 0 for every real token
    token_key_range(tok_pos[t0 + tid], S, 0, &lo, &hi);
    t_slot[tid] = tok_slot[t0 + tid];
    t_top[tid] = lo <= hi ? hi : -1;
    t_hi[tid] = lo <= hi && hi >= k_lo ? min(hi, k_end) : -1;
  }
  __syncthreads();
  if (tid < tn) {
    // the first token of a slot with keys in this split opens the slot's
    // pass, over the union of its tokens' keys here
    int ph = t_hi[tid];
    for (int j = 0; j < tn && ph >= 0; ++j)
      if (t_slot[j] == t_slot[tid] && t_hi[j] >= 0) ph = j < tid ? -1 : max(ph, t_hi[j]);
    p_hi[tid] = ph;
  }
  int top = -1;
  for (int j = 0; j < tn; ++j) top = max(top, t_top[j]);
  // the live splits: 0 .. n_live - 1 (every key range starts at 0)
  const int n_live = top < 0 ? 0 : top / span + 1;
  if (tid == 0 && s < n_live) {  // the tile's [q_eff | q_rope] rows, while the passes are found
    mbar_expect_tx(q_full, W::kTile);
#pragma unroll
    for (int b = 0; b < W::kLat; ++b) tma_load(sq + b * kBox, &maps.q, q_full, 64 * b, m0);
    tma_load(sq + W::kLat * kBox, &maps.qr, q_full, 0, m0);
  }
  __syncthreads();
  if (s >= max(n_live, 1) || n_live == 0) {
    if (n_live == 0 && s == 0)  // a tile of padding tokens: zeros, from split 0
      for (int x = tid; x < kRows * (R / 8); x += kThreadsWg) {
        const int m = m0 + x / (R / 8);
        if (m < M)
          *reinterpret_cast<uint4*>(out + static_cast<int64_t>(m) * R + 8 * (x % (R / 8))) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    return;  // no key of the tile in this span
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = tid & 127;
  // this thread's two rows of the tile (the accumulator layout: warp w holds
  // rows 16 w .. 16 w + 15, lane l rows l / 4 and l / 4 + 8, and columns 8 j
  // + 2 (l % 4) + {0, 1} of every 8-column block j)
  const int r0 = warp * 16 + (lane >> 2), col = 2 * (lane & 3);

  // a cursor over the block's stages, pass by pass: (first token of the
  // pass, position of the stage's row 0); false past the last stage
  auto next_stage = [&](int& i, int& p0) -> bool {
    if (i >= 0) {
      p0 += kKeys;
      if (p0 <= p_hi[i]) return true;
    }
    for (++i; i < tn; ++i)
      if (p_hi[i] >= 0) {
        p0 = k_lo;
        return true;
      }
    return false;
  };
  auto load_stage = [&](int st, int i, int p0) {
    mbar_expect_tx(&full[st], W::kTile);
    uint8_t* dst = ring + st * W::kTile;
#pragma unroll
    for (int b = 0; b < W::kLat; ++b)
      tma_load(dst + b * kBox, &maps.kv, &full[st], 64 * b, p0, t_slot[i]);
    tma_load(dst + W::kLat * kBox, &maps.kr, &full[st], 0, p0, t_slot[i]);
  };
  // thread 0 lands the first NS stages; then the leader of each warpgroup
  // (kAlt; r 512: thread 0) refills every slot its warpgroup frees with the
  // stage NS later, its cursor NS + wg stages in (kAlt: two a refill)
  int li = -1, lp = 0;
  if (tid == 0)
    for (int n = 0; n < NS && next_stage(li, lp); ++n) load_stage(n, li, lp);
  const bool leader = W::kAlt ? t == 0 : tid == 0;
  bool lok = false;
  if (leader) {
    li = -1;
    lok = true;
    for (int n = 0; n <= NS + (W::kAlt ? wg : 0) && lok; ++n) lok = next_stage(li, lp);
  }

  float o[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float sc[kKeys / 2];
  uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];
  int rslot[2], rhi[2];  // each row's slot and last key in this split
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    const int ti = m < M ? m / H - t0 : 0;
    rslot[h] = t_slot[ti];
    rhi[h] = m < M ? t_hi[ti] : -1;
  }
  mbar_wait(q_full, 0);
  int it = 0;
  for (int i = 0; i < tn; ++i) {
    const int phi = p_hi[i];
    if (phi < 0) continue;
    const int slot = t_slot[i];
    // keys past hi weigh 0 for the row; every key for another slot's row
    const int hi[2] = {rslot[0] == slot ? rhi[0] : -1, rslot[1] == slot ? rhi[1] : -1};
    for (int p0 = k_lo; p0 <= phi; p0 += kKeys, ++it) {
      if (W::kAlt && (it & 1) != wg) continue;  // the other warpgroup's stage
      const int st = it % NS;
      mbar_wait(&full[st], (it / NS) & 1);
      const uint8_t* kt = ring + st * W::kTile;

      // ---- S = Q K^T over [q_eff | q_rope] . [ckv | krope]
#pragma unroll
      for (int x = 0; x < kKeys / 2; ++x) sc[x] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W::kLatSteps; ++kk) {
        const int off = (kk >> 2) * kBox + (kk & 3) * 32;
        wgmma_ss<kKeys>(sc, smem_desc(sq + off, 16, 1024), smem_desc(kt + off, 16, 1024),
                        kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < W::kRopeSteps; ++kk) {
        const int off = W::kLat * kBox + kk * 32;
        wgmma_ss<kKeys>(sc, smem_desc(sq + off, 16, 1024), smem_desc(kt + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);

      // ---- the online softmax on the fragments (log2 domain), P as
      // bf16(P) and its remainder in A-fragment order
      const bool edge = p0 + kKeys - 1 > min(hi[0], hi[1]);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            x *= scale_log2;
            if (edge && p0 + 8 * j + col + e > hi[h]) x = -INFINITY;
            mx[h] = fmaxf(mx[h], x);
          }
      float base[2], corr[2];
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
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0v = exp2f(sc[4 * j + 2 * h] - base[h]);
          const float p1v = exp2f(sc[4 * j + 2 * h + 1] - base[h]);
          l_run[h] += p0v + p1v;
          const __nv_bfloat162 hb = __floats2bfloat162_rn(p0v, p1v);
          const __nv_bfloat162 lb = __floats2bfloat162_rn(p0v - __low2float(hb),
                                                          p1v - __high2float(hb));
          // column block j is half (j % 2) of the 16-key step j / 2
          ph[j >> 1][(j & 1) * 2 + h] = bf16x2_bits(hb);
          pl[j >> 1][(j & 1) * 2 + h] = bf16x2_bits(lb);
        }
      if (corr[0] != 1.f || corr[1] != 1.f) {  // a row's max moved
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
      }

      // ---- O += P V, V this warpgroup's columns of the staged ckv rows;
      // a 16-key step past the pass's last key has P = 0 in every row
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        if (p0 + 16 * kk > phi) break;
        const uint64_t vd = smem_desc(kt + (W::kAlt ? 0 : wg * (kN / 64) * kBox) + kk * 16 * 128,
                                      kBox, 1024);
        wgmma_rs<kN>(o, ph[kk], vd);
        wgmma_rs<kN>(o, pl[kk], vd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(o);
      fence_operand(ph);
      fence_operand(pl);
      mbar_arrive(&empty[st]);
      if (lok) {  // the leader refills the slot with the stage NS later
        mbar_wait(&empty[st], (it / NS) & 1);
        load_stage(st, li, lp);
        lok = next_stage(li, lp);
        if (W::kAlt && lok) lok = next_stage(li, lp);
      }
    }
  }
  float lsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lsum[h] = l_run[h] + __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
  }
  __syncthreads();  // both warpgroups are past the ring and Q: the epilogue's now

  float4* x4 = reinterpret_cast<float4*>(sq);
  if constexpr (W::kAlt) {  // warpgroup 0 takes over warpgroup 1's (m, l, O)
    if (wg == 1) {
#pragma unroll
      for (int c = 0; c < kN / 8; ++c)
        x4[c * 128 + t] = make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
      x4[(kN / 8) * 128 + t] = make_float4(m_run[0], m_run[1], lsum[0], lsum[1]);
    }
    __syncthreads();
    if (wg == 0) {
      const float4 ml = x4[(kN / 8) * 128 + t];
      const float mo[2] = {ml.x, ml.y}, lo[2] = {ml.z, ml.w};
      float eo[2], ex[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mm = fmaxf(m_run[h], mo[h]);
        const float b = mm == -INFINITY ? 0.f : mm;
        eo[h] = exp2f(m_run[h] - b);
        ex[h] = exp2f(mo[h] - b);
        lsum[h] = lsum[h] * eo[h] + lo[h] * ex[h];
        m_run[h] = mm;
      }
#pragma unroll
      for (int c = 0; c < kN / 8; ++c) {
        const float4 v = x4[c * 128 + t];
        o[4 * c] = o[4 * c] * eo[0] + v.x * ex[0];
        o[4 * c + 1] = o[4 * c + 1] * eo[0] + v.y * ex[0];
        o[4 * c + 2] = o[4 * c + 2] * eo[1] + v.z * ex[1];
        o[4 * c + 3] = o[4 * c + 3] * eo[1] + v.w * ex[1];
      }
    }
  }
  // the threads whose o holds a part of the tile's result, and its columns
  const bool owner = !W::kAlt || wg == 0;
  const int cbase = W::kAlt ? 0 : wg * kN;
  uint8_t* so = sq + W::kOut;  // the tile's output rows, bf16, kOutStride bytes apart
  auto store_out = [&]() {  // every thread: the staged rows to out, 16 bytes at a time
#pragma unroll 4
    for (int x = tid; x < kRows * (R / 8); x += kThreadsWg) {
      const int row = x / (R / 8), c = x % (R / 8);
      if (m0 + row < M)
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(m0 + row) * R + 8 * c) =
            *reinterpret_cast<const uint4*>(so + row * W::kOutStride + c * 16);
    }
  };
  if (n_live == 1) {  // out = O / l
    if (owner) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float inv = 1.f / fmaxf(lsum[h], 1e-30f);
        uint8_t* row = so + (r0 + 8 * h) * W::kOutStride + (cbase + col) * 2;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + 16 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
    }
    __syncthreads();
    store_out();
    return;
  }

  // a ticket first: the blocks before the last publish their partial (m, l,
  // O unnormalised) to ws and count it in `published`; the last keeps its
  // own in shared memory, waits for theirs and merges
  const int tile = blockIdx.x, tiles = gridDim.x;
  int* ticket = counters + tile;
  int* published = counters + tiles + tile;
  __shared__ int last;
  if (tid == 0) last = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  float4* own = x4;  // the last block's partial, in ws's order
  if (owner) {
    float4* dst = last ? own + (cbase / 8) * 128 + t
                       : ws + part_base<R>(tile, s, splits) + (cbase / 8) * 128 + t;
#pragma unroll
    for (int c = 0; c < kN / 8; ++c)
      dst[c * 128] = make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
    if (wg == 0) {
      const float4 ml = make_float4(m_run[0] == -INFINITY ? kNegInf : m_run[0],
                                    m_run[1] == -INFINITY ? kNegInf : m_run[1], lsum[0], lsum[1]);
      if (last)
        own[(R / 8) * 128 + t] = ml;
      else
        ws[ml_base<R>(tile, s, splits, tiles) + t] = ml;
    }
  }
  if (!last) {
    __threadfence();  // the partial is visible before it is counted
    __syncthreads();
    if (tid == 0) atomicAdd(published, 1);
    return;
  }
  if (tid == 0) {  // every other live split has taken its ticket and is writing: wait for it
    const long long c0 = clock64();
    while (ld_acquire(published) < n_live - 1)
      if (clock64() - c0 > (1ll << 32)) __trap();
  }
  __syncthreads();
  __threadfence();

  // the merge in split order: each row's weights exp(m_z - M) and 1 / L
  // first, then every thread takes float4 items of the partials, kU at a
  // time, the loads of four splits issued together (per-SM L2 bandwidth,
  // not arithmetic, sets the merge's time)
  constexpr int kZ = 4;
  float2* wts = reinterpret_cast<float2*>(sq + W::kXchg);  // [z][t]
  float2* linv = wts + kMaxSplits * 128;                  // [t]
  if (tid < 128) {
    float mm[2] = {kNegInf, kNegInf}, ll[2] = {0.f, 0.f};
    for (int z0 = 0; z0 < n_live; z0 += kZ) {
      float4 v[kZ];
#pragma unroll
      for (int u = 0; u < kZ; ++u) {
        const int z = z0 + u;
        v[u] = z == s ? own[(R / 8) * 128 + tid]
               : z < n_live ? __ldcg(ws + ml_base<R>(tile, z, splits, tiles) + tid)
                            : make_float4(kNegInf, kNegInf, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kZ; ++u) {  // the running (max, sum) of each row over the splits
        const float n0 = fmaxf(mm[0], v[u].x), n1 = fmaxf(mm[1], v[u].y);
        ll[0] = ll[0] * exp2f(mm[0] - n0) + v[u].z * exp2f(v[u].x - n0);
        ll[1] = ll[1] * exp2f(mm[1] - n1) + v[u].w * exp2f(v[u].y - n1);
        mm[0] = n0;
        mm[1] = n1;
        if (z0 + u < n_live) wts[(z0 + u) * 128 + tid] = make_float2(v[u].x, v[u].y);
      }
    }
    for (int z = 0; z < n_live; ++z) {
      const float2 m = wts[z * 128 + tid];
      wts[z * 128 + tid] = make_float2(exp2f(m.x - mm[0]), exp2f(m.y - mm[1]));
    }
    linv[tid] = make_float2(1.f / fmaxf(ll[0], 1e-30f), 1.f / fmaxf(ll[1], 1e-30f));
  }
  __syncthreads();
  constexpr int kItems = (R / 8) * 128, kU = 8;
  for (int x0 = tid; x0 < kItems; x0 += kThreadsWg * kU) {
    float4 a[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < n_live; z0 += kZ) {
      float4 v[kZ][kU];
#pragma unroll
      for (int zz = 0; zz < kZ; ++zz) {
        const int z = z0 + zz;
        const float4* src = z == s ? own : ws + part_base<R>(tile, min(z, n_live - 1), splits);
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int x = x0 + u * kThreadsWg;
          v[zz][u] = x >= kItems || z >= n_live ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : z == s                   ? src[x]
                                                : __ldcg(src + x);
        }
      }
#pragma unroll
      for (int zz = 0; zz < kZ; ++zz) {
        if (z0 + zz >= n_live) break;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float2 w = wts[(z0 + zz) * 128 + ((x0 + u * kThreadsWg) & 127)];
          a[u].x += v[zz][u].x * w.x;
          a[u].y += v[zz][u].y * w.x;
          a[u].z += v[zz][u].z * w.y;
          a[u].w += v[zz][u].w * w.y;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int x = x0 + u * kThreadsWg;
      if (x >= kItems) continue;
      const int tt = x & 127, c = x >> 7;  // item (c, t): rows r(t), r(t) + 8, columns 8 c + ..
      const int row = (tt >> 5) * 16 + ((tt & 31) >> 2);
      const float2 il = linv[tt];
      uint8_t* p = so + row * W::kOutStride + (8 * c + 2 * (tt & 3)) * 2;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a[u].x * il.x, a[u].y * il.x);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * W::kOutStride) =
          __floats2bfloat162_rn(a[u].z * il.y, a[u].w * il.y);
    }
  }
  __syncthreads();
  store_out();
  if (tid == 0) *ticket = *published = 0;  // ready for the next launch
}

// A bf16 tensor of `rank` <= 3 dimensions (innermost first, in elements) as
// boxes of 64 columns x 64 rows (x 1), 128-byte swizzled.
bool make_map(CUtensorMap* map, const void* ptr, int rank, uint64_t d0, uint64_t d1,
              uint64_t d2) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, kRows, 1};
  return encode_map(map, ptr, rank, dims, strides, box);
}

template <int R, int ROPE>
int launch_wgmma(const void* q_eff, const void* q_rope, const void* ckv, const void* krope,
                 const int* tok_slot, const int* tok_pos, void* ws, int* counters, void* out,
                 int T, int B, int S, int H, int span, float scale, cudaStream_t st) {
  using W = Wg<R, ROPE>;
  auto* kernel = mla_wgmma_kernel<R, ROPE>;
  const int64_t M = static_cast<int64_t>(T) * H;
  const int64_t splits = (S + static_cast<int64_t>(span) - 1) / span;
  if (M > INT_MAX - kRows || span < 1 || splits > kMaxSplits) return -1;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return -3;
  static bool raised[64];
  const cudaError_t err = raise_smem(kernel, W::kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps maps;
  if (!make_map(&maps.q, q_eff, 2, R, M, 1) || !make_map(&maps.qr, q_rope, 2, ROPE, M, 1) ||
      !make_map(&maps.kv, ckv, 3, R, S, B) || !make_map(&maps.kr, krope, 3, ROPE, S, B))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((M + kRows - 1) / kRows), static_cast<unsigned>(splits));
  kernel<<<grid, kThreadsWg, W::kBytes, st>>>(
      maps, tok_slot, tok_pos, static_cast<float4*>(ws), counters,
      static_cast<__nv_bfloat16*>(out), T, S, H, span, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ f32: CUDA cores

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 16;  // rows of a block: a chunk of heads
constexpr int kF32Keys = 32;  // positions a stage
constexpr int kSmemBudget = 200 * 1024;

template <int R, int ROPE>
struct F32 {
  static constexpr int D = R + ROPE;
  static constexpr int kCL = R * 4 / 16, kCR = ROPE * 4 / 16;  // 16-byte copies of a row
  static constexpr int kC = kCL + kCR;
  // an odd number of 16-byte chunks a staged row: a quarter warp's float4
  // loads of 8 rows fall in 8 different bank groups
  static constexpr int kStride = kC % 2 == 0 ? kC * 16 + 16 : kC * 16;
  static constexpr int kStage = kF32Keys * kStride;
  static constexpr int kSStride = kF32Keys + 4;  // scores (P in place) a row
  static constexpr int kQ = kHeads * kStride;
  static constexpr int kS = kHeads * kSStride * 4;
  static constexpr int kFixed = kQ + kS + 2 * kHeads * 4;  // + rescale, 1 / l a row
  static constexpr int kFit = (kSmemBudget - kFixed) / kStage;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static constexpr int kBytes = kStages * kStage + kFixed;
  static_assert(kStages >= 2, "two stages fit");
  static_assert(R % 32 == 0 && ROPE % 4 == 0, "whole copies");
};

template <int R, int ROPE>
__global__ void __launch_bounds__(kThreads, 1)
mla_f32_kernel(const float* __restrict__ q_eff, const float* __restrict__ q_rope,
               const float* __restrict__ ckv, const float* __restrict__ krope,
               const int* __restrict__ tok_slot, const int* __restrict__ tok_pos,
               float* __restrict__ out, int S, int H, float scale) {
  using F = F32<R, ROPE>;
  constexpr int KR = kF32Keys, kStride = F::kStride, NST = F::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sq = smem + NST * F::kStage;
  float* ss = reinterpret_cast<float*>(sq + F::kQ);
  float* s_corr = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ss) + F::kS);
  float* s_linv = s_corr + kHeads;

  const int t = blockIdx.x, h0 = blockIdx.y * kHeads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int lo, hi;
  token_key_range(tok_pos[t], S, 0, &lo, &hi);
  if (lo > hi) {  // a padding token: zeros, no key read
    for (int x = tid; x < kHeads * R; x += kThreads) {
      const int h = h0 + x / R;
      if (h < H) out[(static_cast<int64_t>(t) * H + h) * R + x % R] = 0.f;
    }
    return;
  }
  const int64_t slot = tok_slot[t];

  // the block's query rows [q_eff | q_rope], rows past H zero
  for (int x = tid; x < kHeads * F::kC; x += kThreads) {
    const int row = x / F::kC, cc = x % F::kC, h = h0 + row;
    const bool ok = h < H;
    const int64_t qr = static_cast<int64_t>(t) * H + (ok ? h : 0);
    const unsigned char* src =
        cc < F::kCL ? reinterpret_cast<const unsigned char*>(q_eff + qr * R) + cc * 16
                    : reinterpret_cast<const unsigned char*>(q_rope + qr * ROPE) +
                          (cc - F::kCL) * 16;
    cp_async16(sq + row * kStride + cc * 16, src, ok);
  }
  cp_async_commit();

  // stage i holds positions lo + i * KR .. + KR - 1 of the slot (zeros past hi)
  const int n_stages = (hi - lo + KR) / KR;
  auto load_stage = [&](int st, int si) {
    unsigned char* base = smem + st * F::kStage;
    const int p0 = lo + si * KR;
    for (int x = tid; x < KR * F::kC; x += kThreads) {
      const int r = x / F::kC, cc = x % F::kC;
      const bool ok = p0 + r <= hi;
      const int64_t row = slot * S + (ok ? p0 + r : lo);
      const unsigned char* src =
          cc < F::kCL ? reinterpret_cast<const unsigned char*>(ckv + row * R) + cc * 16
                      : reinterpret_cast<const unsigned char*>(krope + row * ROPE) +
                            (cc - F::kCL) * 16;
      cp_async16(base + r * kStride + cc * 16, src, ok);
    }
  };

  // rows warp and warp + 8: their (m, l) the same in every lane of the warp,
  // and dims lane + 32 c of their sums
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float acc[2][R / 32];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < R / 32; ++c) acc[a][c] = 0.f;

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
    const unsigned char* sk = smem + (si % NST) * F::kStage;
    const int tb = lo + si * KR;  // the position of the stage's row 0

    // ---- S = Q K^T * scale into ss [16][kSStride]: key lane, rows warp, warp + 8
    {
      const float* kr = reinterpret_cast<const float*>(sk + lane * kStride);
      const float* q0 = reinterpret_cast<const float*>(sq + warp * kStride);
      const float* q1 = reinterpret_cast<const float*>(sq + (warp + 8) * kStride);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int d = 0; d < F::D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
        const float4 x = *reinterpret_cast<const float4*>(q0 + d);
        const float4 y = *reinterpret_cast<const float4*>(q1 + d);
        a0 += x.x * k4.x + x.y * k4.y + x.z * k4.z + x.w * k4.w;
        a1 += y.x * k4.x + y.y * k4.y + y.z * k4.z + y.w * k4.w;
      }
      ss[warp * F::kSStride + lane] = a0 * scale;
      ss[(warp + 8) * F::kSStride + lane] = a1 * scale;
    }
    __syncthreads();

    // ---- the online softmax of each row, one warp a row; keys past hi weigh 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp + kWarps * i;
      const bool key_ok = tb + lane <= hi;
      const float sc = ss[row * F::kSStride + lane];
      const bool live = h0 + row < H;  // a padded row keeps P = 0 and its zero sums
      const float m_new = fmaxf(m_run[i], warp_max(key_ok ? sc : kNegInf));
      const float corr = live ? expf(m_run[i] - m_new) : 1.f;
      const float p = live && key_ok ? expf(sc - m_new) : 0.f;
      ss[row * F::kSStride + lane] = p;  // P in place of its score
      l_run[i] = l_run[i] * corr + warp_sum(p);
      m_run[i] = m_new;
      if (lane == 0) s_corr[row] = corr;
    }
    __syncthreads();

    // ---- O = O * corr + P V, V the first R lanes of the staged rows
    const float c0 = s_corr[warp], c1 = s_corr[warp + 8];
#pragma unroll
    for (int c = 0; c < R / 32; ++c) {
      acc[0][c] *= c0;
      acc[1][c] *= c1;
    }
    const int nk = min(KR, hi - tb + 1);
    for (int j = 0; j < nk; ++j) {
      const float p0 = ss[warp * F::kSStride + j], p1 = ss[(warp + 8) * F::kSStride + j];
      const float* vr = reinterpret_cast<const float*>(sk + j * kStride);
#pragma unroll
      for (int c = 0; c < R / 32; ++c) {
        const float v = vr[lane + 32 * c];
        acc[0][c] += p0 * v;
        acc[1][c] += p1 * v;
      }
    }
  }
  cp_async_wait<0>();

  // ---- out = O / l, the live rows only
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (lane == 0) s_linv[warp + kWarps * i] = 1.f / fmaxf(l_run[i], 1e-30f);
  __syncthreads();
  float* ot = out + static_cast<int64_t>(t) * H * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp + 8 * i, h = h0 + row;
    if (h >= H) continue;
    const float li = s_linv[row];
#pragma unroll
    for (int c = 0; c < R / 32; ++c)
      ot[static_cast<int64_t>(h) * R + lane + 32 * c] = acc[i][c] * li;
  }
}

template <int R, int ROPE>
int launch_f32(const void* q_eff, const void* q_rope, const void* ckv, const void* krope,
               const int* tok_slot, const int* tok_pos, void* out, int T, int S, int H,
               float scale, cudaStream_t st) {
  auto* kernel = mla_f32_kernel<R, ROPE>;
  static bool raised[64];
  const cudaError_t err = raise_smem(kernel, F32<R, ROPE>::kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(T, (H + kHeads - 1) / kHeads);
  kernel<<<grid, kThreads, F32<R, ROPE>::kBytes, st>>>(
      static_cast<const float*>(q_eff), static_cast<const float*>(q_rope),
      static_cast<const float*>(ckv), static_cast<const float*>(krope), tok_slot, tok_pos,
      static_cast<float*>(out), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mla
}  // namespace repro

// q_eff [T, H, R], q_rope [T, H, ROPE], ckv [B, S, R], krope [B, S, ROPE],
// out [T, H, R], all of dtype (repro::DType: f32 or bf16); tok_slot/tok_pos
// [T] int32, tok_slot a global cache row. bf16 (the wgmma body): span the
// positions a split (a multiple of 64; splits = ceil(S / span) <= 16), ws
// f32 scratch of tiles * splits * (64 R + 512) elements (tiles = ceil(T * H
// / 64)) and counters int32 zeros, two per tile, left zero (both may be
// null at one split); f32 (the CUDA-core body): span, ws and counters
// unused. Returns cudaGetLastError() after the launch, -1 for a (R, ROPE),
// H or shape outside the instantiated domain, -2 for another dtype, -3 for
// missing scratch.
extern "C" int repro_mla_attention(const void* q_eff, const void* q_rope, const void* ckv,
                                   const void* krope, const void* tok_slot, const void* tok_pos,
                                   void* ws, void* counters, void* out, int T, int B, int S,
                                   int H, int R, int ROPE, int span, float scale, int dtype,
                                   void* stream) {
  using namespace repro::mla;
  if (T < 1 || B < 1 || S < 1 || H < 1 || H > 64) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ts = static_cast<const int*>(tok_slot);
  const int* tp = static_cast<const int*>(tok_pos);
  if (dtype == repro::kBF16) {
#define REPRO_MLA(RR, PP)                                                                     \
  if (R == RR && ROPE == PP)                                                                  \
    return launch_wgmma<RR, PP>(q_eff, q_rope, ckv, krope, ts, tp, ws,                        \
                                static_cast<int*>(counters), out, T, B, S, H, span, scale, st);
    REPRO_MLA(32, 8) REPRO_MLA(256, 32) REPRO_MLA(512, 64)
#undef REPRO_MLA
    return -1;
  }
  if (dtype == repro::kF32) {
#define REPRO_MLA(RR, PP)                                                                     \
  if (R == RR && ROPE == PP)                                                                  \
    return launch_f32<RR, PP>(q_eff, q_rope, ckv, krope, ts, tp, out, T, S, H, scale, st);
    REPRO_MLA(32, 8) REPRO_MLA(256, 32) REPRO_MLA(512, 64)
#undef REPRO_MLA
    return -1;
  }
  return -2;
}
