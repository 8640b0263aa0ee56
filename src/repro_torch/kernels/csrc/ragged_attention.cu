// Packed variable-length (ragged) attention: a flat [T] token batch — prefill
// chunks and decode singletons of any slots mixed — against the dense cache.
//
// Replaces the TPU kernel repro/kernels/ragged_attention.py::ragged_attention
// (_ragged_kernel): q [T, KV, G, D], cache k/v [B, S_max, KV, D], per-token
// descriptors tok_slot/tok_pos [T] int32; key p of slot tok_slot[t] is valid
// iff p <= tok_pos[t] (and p > tok_pos[t] - window when window > 0). The
// tokens' own K/V were scattered into the cache before the call. Padding
// tokens carry tok_pos >= S_max: nothing reads their output rows, so their
// key range is empty and they come out as zeros without touching the cache
// (the TPU kernel and the plain version attend the whole slot there).
// Returns [T, KV, G, D].
//
// tok_slot holds GLOBAL cache rows. The JAX model gathers the pack's P slots
// into a sub-cache and passes local indices; reading the full cache at
// pack_slots[local] is the same result without the gather copy.
//
// What bounds it on the H100: the K/V bytes of each real token's valid
// prefix. Tokens of one prefill chunk share their slot's rows, so the bytes
// the function must move are the union of those prefixes; this simple kernel
// reads them once per token and leans on the 50 MB L2 for the reuse.
//
// Simple design: one block per (packed token, KV head), each block reading
// its own (slot, pos) — the TPU kernel's scalar-prefetched index map becomes
// two loads at block start — then the same in-block loop over the valid key
// range as the decode kernel (attention_common.cuh). Sharing K/V tiles
// between the tokens of a chunk is later work.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ tok_slot,
                        const int* __restrict__ tok_pos, T* __restrict__ out, int S, int KV,
                        int window) {
  constexpr int U = G >= 4 ? 2 : 4;
  const int t = blockIdx.x, h = blockIdx.y;
  const int slot = tok_slot[t];
  const int pos = tok_pos[t];
  int lo = 1, hi = 0;  // padding: empty range
  if (pos < S) repro::key_range(pos, S, window, &lo, &hi);
  const int64_t row_stride = static_cast<int64_t>(KV) * D;
  const int64_t cache_off =
      static_cast<int64_t>(slot) * S * row_stride + static_cast<int64_t>(h) * D;
  const int64_t q_off = (static_cast<int64_t>(t) * KV + h) * G * D;
  repro::attend_rows<T, D, G, kWarps, U>(q + q_off, k + cache_off, v + cache_off, row_stride,
                                         lo, hi, out + q_off);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tok_slot,
           const void* tok_pos, void* out, int T_, int S, int KV, int G, int D, int window,
           cudaStream_t stream) {
  const dim3 grid(T_, KV);
#define REPRO_CASE(DD, GG)                                                             \
  if (D == DD && G == GG) {                                                            \
    ragged_attention_kernel<T, DD, GG><<<grid, kWarps * 32, 0, stream>>>(              \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),  \
        static_cast<const int*>(tok_slot), static_cast<const int*>(tok_pos),           \
        static_cast<T*>(out), S, KV, window);                                          \
    return static_cast<int>(cudaGetLastError());                                       \
  }
  REPRO_CASE(64, 1) REPRO_CASE(64, 2) REPRO_CASE(64, 4) REPRO_CASE(64, 8)
  REPRO_CASE(128, 1) REPRO_CASE(128, 2) REPRO_CASE(128, 4) REPRO_CASE(128, 8)
#undef REPRO_CASE
  return -1;  // (D, G) not instantiated
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, -1 for an unsupported (D, G), -2 for an unsupported dtype.
extern "C" int repro_ragged_attention(const void* q, const void* k, const void* v,
                                      const void* tok_slot, const void* tok_pos, void* out,
                                      int T, int S, int KV, int G, int D, int window, int dtype,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, tok_slot, tok_pos, out, T, S, KV, G, D, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, tok_slot, tok_pos, out, T, S, KV, G, D, window, st);
  return -2;
}
