// The dense cache's row policy of a ragged pack, for split_attention.cuh's
// body: shared by ragged_attention.cu (one token a tile, and packs at G >=
// 5) and ragged_pack.cu (packs at G <= 4: 8 / GC tokens a tile), which
// compile apart so that nvcc builds the two sets of instantiations side by
// side.
#pragma once

#include "split_attention.cuh"

namespace repro {
namespace splitkv {

// Token t of a pack over the dense cache: cache slot tok_slot[t] (a GLOBAL
// cache row) at position tok_pos[t], key p at cache row tok_slot[t] * S + p.
// A padding token (tok_pos >= S) gets the empty range: it reads nothing and
// comes out as zeros. 8-row blocks over bf16 queries take the tensor cores.
struct RaggedSlots {
  static constexpr bool kTable = false;
  static constexpr bool kMmaRows = true;
  static constexpr int kMmaStageRows = 2 * kSubRows;  // four warps' sub-steps a stage
  static constexpr int kMmaRingBytes = 104 * 1024;    // 3 bf16 stages at D = 128
  static constexpr bool kMmaSplitP = true;  // P V as exact as f32 math (MmaRows)
  const int* __restrict__ tok_slot;
  const int* __restrict__ tok_pos;
  int S;
  __device__ __forceinline__ int seq(int t) const { return tok_slot[t]; }
  __device__ __forceinline__ void range(int t, int window, int* lo, int* hi) const {
    token_key_range(tok_pos[t], S, window, lo, hi);
  }
  __device__ __forceinline__ int window_end(int, int hi) const { return hi; }
  __device__ __forceinline__ int bind(int, int, int, int*) const { return 0; }
  __device__ __forceinline__ int64_t row(int seq, int p, const int*, int) const {
    return static_cast<int64_t>(seq) * S + p;
  }
};

// The pack launch of ragged_pack.cu: launch_split<true> over RaggedSlots for
// G <= 4 (arguments and returns as launch_split).
int launch_ragged_pack(const void* q, const void* k, const void* v, const void* k_scale,
                       const void* v_scale, const RaggedSlots& slots, void* out, void* ws,
                       void* counters, int T, int S, int KV, int G, int D, int window, int span,
                       int qdtype, int sdtype, void* stream);

}  // namespace splitkv
}  // namespace repro
