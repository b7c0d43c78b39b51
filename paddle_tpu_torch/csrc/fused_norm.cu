// Fused LayerNorm / RMSNorm forward over the last axis, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py:107 `_fwd_kernel` (reached
// through `_norm_fwd` :146 from `layer_norm_fwd` :338 and `rms_norm_fwd`
// :328). Same arithmetic: f32 statistics whatever the input type, the
// two-pass centred variance for LayerNorm (the one-pass E[x^2] - E[x]^2 form
// cancels in f32 when |mean| >> std), optional f32-upcast weight and bias,
// output in x's type, and f32 `rstd` (plus `mean` for LayerNorm) per row for
// the backward the training slice adds.
//
// Bound on an H100: memory. The function must read the [R, N] input once
// and write the [R, N] output once, plus the [N] weight and bias and the
// per-row stats: bytes = 2*R*N*sizeof(T) + 2*N*sizeof(TW) + R*4*(1 or 2),
// against 3.35 TB/s of HBM; it does ~8 operations per element, far below
// the card's arithmetic rate. At the serving decode shape (R = 16 rows,
// N = 2048, bf16) that is about 0.13 MB, 0.04 us: the launch itself costs
// more than the bytes.
//
// Design against that bound: one block per row of the contiguous [R, N]
// view. The row is read from HBM exactly once, upcast to f32 into shared
// memory; the two reductions (mean, then the centred sum of squares) and the
// output pass read it back from shared memory, so HBM sees one read and one
// write per element. Neighbouring threads touch neighbouring elements, so
// every global access is coalesced. A row wider than the shared memory a
// block may hold (N > ~58k on Hopper) is read again from global memory (L2)
// for the later passes instead of failing. The TPU kernel's lane padding to
// 128 and its autotuned row block are TPU tiling artifacts and are not
// carried over: any N works, odd widths included.
#include "common.cuh"

namespace {

template <typename T, typename TW, bool kLN>
__global__ void norm_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                                const TW* __restrict__ b, T* __restrict__ out,
                                float* __restrict__ rstd_out,
                                float* __restrict__ mean_out, int n, float eps,
                                bool cache_row) {
  extern __shared__ float row[];  // [n] f32 copy of this row when cache_row
  __shared__ float red[32];
  const long long r = blockIdx.x;
  const T* xr = x + r * n;
  T* outr = out + r * n;
  const float inv_n = 1.f / static_cast<float>(n);

  float mean = 0.f;  // RMSNorm: no centring
  if (kLN) {
    float s = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = ptt::to_f32(xr[i]);
      if (cache_row) row[i] = v;
      s += v;
    }
    mean = ptt::block_sum(s, red) * inv_n;
  }
  // each thread re-reads only the elements it cached itself: no barrier
  // is needed between the passes for `row`
  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v;
    if (kLN) {
      v = cache_row ? row[i] : ptt::to_f32(xr[i]);
    } else {
      v = ptt::to_f32(xr[i]);
      if (cache_row) row[i] = v;
    }
    const float c = v - mean;
    ss += c * c;
  }
  const float rstd = rsqrtf(ptt::block_sum(ss, red) * inv_n + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = cache_row ? row[i] : ptt::to_f32(xr[i]);
    float o = (v - mean) * rstd;
    if (w != nullptr) o *= ptt::to_f32(w[i]);
    if (b != nullptr) o += ptt::to_f32(b[i]);
    outr[i] = ptt::from_f32<T>(o);
  }
  if (threadIdx.x == 0) {
    rstd_out[r] = rstd;
    if (kLN) mean_out[r] = mean;
  }
}

template <typename T, typename TW>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   void* rstd, void* mean, long long rows, int n, float eps,
                   bool ln, cudaStream_t stream) {
  // 1..4 elements per thread, a multiple of 32 threads, at most 1024
  int threads = ((n + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t row_bytes = static_cast<size_t>(n) * sizeof(float);
  const bool cache_row = row_bytes + 32 * sizeof(float) <= static_cast<size_t>(max_smem);
  const size_t smem = cache_row ? row_bytes : 0;
  auto kernel = ln ? norm_fwd_kernel<T, TW, true> : norm_fwd_kernel<T, TW, false>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<const TW*>(b),
      static_cast<T*>(out), static_cast<float*>(rstd), static_cast<float*>(mean), n,
      eps, cache_row);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_w(int w_dtype, const void* x, const void* w, const void* b,
                       void* out, void* rstd, void* mean, long long rows, int n,
                       float eps, bool ln, cudaStream_t stream) {
  switch (w_dtype) {
    case ptt::kF32: return launch<T, float>(x, w, b, out, rstd, mean, rows, n, eps, ln, stream);
    case ptt::kBF16: return launch<T, __nv_bfloat16>(x, w, b, out, rstd, mean, rows, n, eps, ln, stream);
    case ptt::kF16: return launch<T, __half>(x, w, b, out, rstd, mean, rows, n, eps, ln, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x [rows, n] contiguous; w, b [n] or null (same dtype when both given);
// out [rows, n] in x's dtype; rstd [rows] f32; mean [rows] f32 (LayerNorm
// only, may be null for RMSNorm). kind: 1 = LayerNorm, 0 = RMSNorm.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_norm_fwd(const void* x, const void* w, const void* b, void* out,
                            void* rstd, void* mean, long long rows, int n, float eps,
                            int x_dtype, int w_dtype, int kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = kind == 1;
  switch (x_dtype) {
    case ptt::kF32: return dispatch_w<float>(w_dtype, x, w, b, out, rstd, mean, rows, n, eps, ln, s);
    case ptt::kBF16: return dispatch_w<__nv_bfloat16>(w_dtype, x, w, b, out, rstd, mean, rows, n, eps, ln, s);
    case ptt::kF16: return dispatch_w<__half>(w_dtype, x, w, b, out, rstd, mean, rows, n, eps, ln, s);
  }
  return cudaErrorInvalidValue;
}
