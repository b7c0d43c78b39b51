// Fused LayerNorm / RMSNorm over the last axis, forward and dx, for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py:107 `_fwd_kernel` (reached
// through `_norm_fwd` :146 from `layer_norm_fwd` :338 and `rms_norm_fwd`
// :328) and :196 `_bwd_kernel` (pallas_call :239, reached through
// `_norm_bwd_dx` :221 from the custom VJP `_fused_norm_vjp_bwd` :274).
// Same arithmetic: f32 statistics whatever the input type, the two-pass
// centred variance for LayerNorm (the one-pass E[x^2] - E[x]^2 form cancels
// in f32 when |mean| >> std), optional f32-upcast weight and bias, output in
// x's type, and f32 `rstd` (plus `mean` for LayerNorm) per row, which the
// dx kernel reads back: with g = dy * w and x_hat = (x - mean) * rstd,
// LayerNorm dx = rstd * (g - mean(g) - x_hat * mean(g * x_hat)) and RMSNorm
// dx = rstd * (g - x_hat * mean(g * x_hat)). dweight and dbias stay torch
// reductions in the caller, as they are jnp reductions in the JAX package.
//
// Bound on an H100: memory. The forward must read the [R, N] input once and
// write the [R, N] output once, plus the [N] weight and bias and the per-row
// stats: bytes = 2*R*N*sizeof(T) + 2*N*sizeof(TW) + R*4*(1 or 2). The dx
// kernel reads x and dy and writes dx: 3*R*N*sizeof(T) + N*sizeof(TW) +
// R*4*(1 or 2). Both do ~10 operations per element, far below the card's
// arithmetic rate, against 3.35 TB/s of HBM. At the serving decode shape
// (R = 16, N = 2048, bf16) the forward moves 0.13 MB, 0.04 us: the launch
// costs more. At the training shape under O2 (R = 8192, N = 2048, f32) the
// forward moves 134 MB (0.040 ms) and dx 201 MB (0.060 ms).
//
// Design against that bound: one block per row of the contiguous [R, N]
// view. The forward reads the row from HBM exactly once, upcast to f32 into
// shared memory; the two reductions (mean, then the centred sum of squares)
// and the output pass read it back from shared memory. The dx kernel reads
// x and dy once, keeps g and x_hat in shared memory for its two row sums
// and the output pass. So HBM sees each element once per read and write.
// Neighbouring threads touch neighbouring elements, so every global access
// is coalesced. A row wider than the shared memory a block may hold (N >
// ~58k in the forward, ~29k in dx) is read again from global memory (L2)
// instead of failing. The TPU kernel's lane padding to 128 and its
// autotuned row block are TPU tiling artifacts and are not carried over: any
// N works, odd widths included.
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

template <typename T, typename TW, bool kLN>
__global__ void norm_bwd_dx_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                                   const T* __restrict__ dy, const float* __restrict__ rstd_in,
                                   const float* __restrict__ mean_in, T* __restrict__ dx, int n,
                                   bool cache_row) {
  extern __shared__ float cache[];  // [2n]: g then x_hat, f32, when cache_row
  __shared__ float red[32];
  float* g_s = cache;
  float* xh_s = cache + n;
  const long long r = blockIdx.x;
  const T* xr = x + r * n;
  const T* dyr = dy + r * n;
  T* dxr = dx + r * n;
  const float rstd = rstd_in[r];
  const float mean = kLN ? mean_in[r] : 0.f;
  const float inv_n = 1.f / static_cast<float>(n);

  float s1 = 0.f, s2 = 0.f;  // sum(g), sum(g * x_hat)
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float g = ptt::to_f32(dyr[i]);
    if (w != nullptr) g *= ptt::to_f32(w[i]);
    const float xh = (ptt::to_f32(xr[i]) - mean) * rstd;
    if (cache_row) {
      g_s[i] = g;
      xh_s[i] = xh;
    }
    s1 += g;
    s2 += g * xh;
  }
  const float c1 = kLN ? ptt::block_sum(s1, red) * inv_n : 0.f;
  const float c2 = ptt::block_sum(s2, red) * inv_n;
  // each thread re-reads only the elements it cached itself
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float g, xh;
    if (cache_row) {
      g = g_s[i];
      xh = xh_s[i];
    } else {
      g = ptt::to_f32(dyr[i]);
      if (w != nullptr) g *= ptt::to_f32(w[i]);
      xh = (ptt::to_f32(xr[i]) - mean) * rstd;
    }
    dxr[i] = ptt::from_f32<T>(rstd * (g - c1 - xh * c2));
  }
}

template <typename T, typename TW>
cudaError_t launch_dx(const void* x, const void* w, const void* dy, const void* rstd,
                      const void* mean, void* dx, long long rows, int n, bool ln,
                      cudaStream_t stream) {
  int threads = ((n + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t row_bytes = 2 * static_cast<size_t>(n) * sizeof(float);
  const bool cache_row = row_bytes + 32 * sizeof(float) <= static_cast<size_t>(max_smem);
  const size_t smem = cache_row ? row_bytes : 0;
  auto kernel = ln ? norm_bwd_dx_kernel<T, TW, true> : norm_bwd_dx_kernel<T, TW, false>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<const T*>(dy),
      static_cast<const float*>(rstd), static_cast<const float*>(mean), static_cast<T*>(dx), n,
      cache_row);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dx_w(int w_dtype, const void* x, const void* w, const void* dy,
                          const void* rstd, const void* mean, void* dx, long long rows, int n,
                          bool ln, cudaStream_t stream) {
  switch (w_dtype) {
    case ptt::kF32: return launch_dx<T, float>(x, w, dy, rstd, mean, dx, rows, n, ln, stream);
    case ptt::kBF16: return launch_dx<T, __nv_bfloat16>(x, w, dy, rstd, mean, dx, rows, n, ln, stream);
    case ptt::kF16: return launch_dx<T, __half>(x, w, dy, rstd, mean, dx, rows, n, ln, stream);
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

// x, dy [rows, n] contiguous in one dtype; w [n] or null; rstd [rows] f32;
// mean [rows] f32 (LayerNorm only); dx [rows, n] in x's dtype. kind: 1 =
// LayerNorm, 0 = RMSNorm. Returns cudaGetLastError() after the launch.
extern "C" int ptt_norm_bwd_dx(const void* x, const void* w, const void* dy, const void* rstd,
                               const void* mean, void* dx, long long rows, int n, int x_dtype,
                               int w_dtype, int kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = kind == 1;
  switch (x_dtype) {
    case ptt::kF32: return dispatch_dx_w<float>(w_dtype, x, w, dy, rstd, mean, dx, rows, n, ln, s);
    case ptt::kBF16: return dispatch_dx_w<__nv_bfloat16>(w_dtype, x, w, dy, rstd, mean, dx, rows, n, ln, s);
    case ptt::kF16: return dispatch_dx_w<__half>(w_dtype, x, w, dy, rstd, mean, dx, rows, n, ln, s);
  }
  return cudaErrorInvalidValue;
}
