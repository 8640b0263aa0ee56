// The paged pool's row policy of split_attention.cuh's body, shared by
// paged_attention.cu (decode tiles, and packs at G >= 5, one token a tile)
// and paged_pack.cu (packs at G <= 4: 8 / GC tokens a tile), which compile
// apart so that nvcc builds the two sets of instantiations side by side.
#pragma once

#include "split_attention.cuh"

namespace repro {
namespace splitkv {

// Token t of the paged pool: table row tok_seq[t] at position tok_pos[t]
// (a padding token, at max_blocks * bs or past it, reads nothing); key p of
// a row at offset p % bs of pool block tables[row, p / bs], the sentinel
// (NB and past it) clamped to NB - 1.
struct PagedTable {
  static constexpr bool kTable = true;
  static constexpr bool kMmaRows = true;
  static constexpr int kMmaStageRows = kSubRows;  // the tensor-core rows' ring: the defaults
  static constexpr int kMmaRingBytes = kRingBytes;
  static constexpr bool kMmaSplitP = true;  // P V as exact as f32 math (MmaRows), as ragged
  const int* __restrict__ tok_seq;
  const int* __restrict__ tok_pos;
  const int* __restrict__ tables;
  int NB, bs, max_blocks;
  __device__ __forceinline__ int seq(int t) const { return tok_seq[t]; }
  __device__ __forceinline__ void range(int t, int window, int* lo, int* hi) const {
    token_key_range(tok_pos[t], max_blocks * bs, window, lo, hi);
  }
  // the last position of the window that starts at lo: kTableWords entries
  __device__ __forceinline__ int window_end(int lo, int hi) const {
    return min(hi, (lo / bs + kTableWords) * bs - 1);
  }
  // entries lo / bs .. hi / bs of row seq into stab; returns lo / bs
  __device__ __forceinline__ int bind(int seq, int lo, int hi, int* stab) const {
    const int base = lo / bs, n = hi / bs - base + 1;
    const int* row = tables + static_cast<int64_t>(seq) * max_blocks + base;
    for (int i = threadIdx.x; i < n; i += kThreads) stab[i] = min(row[i], NB - 1);
    return base;
  }
  __device__ __forceinline__ int64_t row(int, int p, const int* stab, int base) const {
    const int i = p / bs;
    return static_cast<int64_t>(stab[i - base]) * bs + (p - i * bs);
  }
};

// The pack launch of paged_pack.cu: launch_split<true> over PagedTable for
// G <= 4 (arguments and returns as launch_split).
int launch_paged_pack(const void* q, const void* k, const void* v, const void* k_scale,
                      const void* v_scale, const PagedTable& table, void* out, void* ws,
                      void* counters, int T, int S, int KV, int G, int D, int window, int span,
                      int qdtype, int sdtype, void* stream);

}  // namespace splitkv
}  // namespace repro
