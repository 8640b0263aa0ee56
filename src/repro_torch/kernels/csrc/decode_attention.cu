// Batched single-token GQA decode attention against the dense KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel): q [B, KV, G, D], cache k/v [B, S_max, KV, D], cur_len [B]
// int32; key t of slot b is valid iff t <= cur_len[b] (and t > cur_len[b] -
// window when window > 0). Returns [B, KV, G, D].
//
// What bounds it on the H100: the K/V bytes of the valid prefix. Per slot
// and head it reads 2 * (cur_len + 1) * D elements and does 4 * G * D flops
// per key, far below the ~295 flops per byte where bf16 tensor cores would
// become the limit, so the kernel is a streaming read.
//
// Simple design: one block per (slot, KV head) with the G query rows of the
// group held in registers, so the cache is never expanded G-fold. The TPU
// grid's sequential S axis becomes a loop inside the block over the valid
// range only (no tile past cur_len or before the window is read). Eight warps
// split that range; each keeps NW*U coalesced row loads in flight and its own
// online softmax in f32, merged once at the end (attention_common.cuh).
// Split-K across blocks, cp.async/TMA pipelining and tensor cores are later
// work.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cur_len,
                        T* __restrict__ out, int S, int KV, int window) {
  constexpr int U = G >= 4 ? 2 : 4;
  const int b = blockIdx.x, h = blockIdx.y;
  int lo, hi;
  repro::key_range(cur_len[b], S, window, &lo, &hi);
  const int64_t row_stride = static_cast<int64_t>(KV) * D;
  const int64_t cache_off = static_cast<int64_t>(b) * S * row_stride + static_cast<int64_t>(h) * D;
  const int64_t q_off = (static_cast<int64_t>(b) * KV + h) * G * D;
  repro::attend_rows<T, D, G, kWarps, U>(q + q_off, k + cache_off, v + cache_off, row_stride,
                                         lo, hi, out + q_off);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cur_len, void* out,
           int B, int S, int KV, int G, int D, int window, cudaStream_t stream) {
  const dim3 grid(B, KV);
#define REPRO_CASE(DD, GG)                                                             \
  if (D == DD && G == GG) {                                                            \
    decode_attention_kernel<T, DD, GG><<<grid, kWarps * 32, 0, stream>>>(              \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),  \
        static_cast<const int*>(cur_len), static_cast<T*>(out), S, KV, window);        \
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
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* cur_len, void* out, int B, int S, int KV,
                                      int G, int D, int window, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, cur_len, out, B, S, KV, G, D, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, cur_len, out, B, S, KV, G, D, window, st);
  return -2;
}
