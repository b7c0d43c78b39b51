// Shared helpers of the port's CUDA kernels (built by ops/_build.py).
//
// Element types travel from Python as integer codes (ops/_build.py
// DTYPE_CODES): 0 = float32, 1 = bfloat16, 2 = float16. Conversions to and
// from float go through the CUDA intrinsics only; int8 KV payloads convert
// exactly.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// A build for one case (chip_smoke.py's planted faults) may keep only the
// instantiations that case launches: -DPTT_ONLY_DTYPE=<code> one element
// type, -DPTT_ONLY_WIDTH=<64|128|192> one head-dim tile width of the
// attention kernels. The dispatch of what is left out returns
// cudaErrorNotSupported. A build without them has every instantiation.
#if defined(PTT_ONLY_DTYPE)
#define PTT_BUILT_DTYPE(code) ((code) == PTT_ONLY_DTYPE)
#else
#define PTT_BUILT_DTYPE(code) 1
#endif
#if defined(PTT_ONLY_WIDTH)
#define PTT_BUILT_WIDTH(w) ((w) == PTT_ONLY_WIDTH)
#else
#define PTT_BUILT_WIDTH(w) 1
#endif

namespace ptt {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a bf16 cast in JAX/PyTorch
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// Sum of `v` over the whole block, returned to every thread. blockDim.x is
// a multiple of 32 and at most 1024; `red` holds 32 floats of shared
// memory. Every thread adds the per-warp partials in the same order, so
// all threads hold the identical value.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // an earlier call may still be reading `red`
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) total += red[w];
  return total;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ptt
