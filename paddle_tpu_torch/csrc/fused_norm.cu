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
// Design against that bound (the forward): a group of threads owns a row
// and holds it in registers, 16 elements a thread, so the group is
// ceil(N / 16) threads rounded up to a warp (128 at N = 2048, 256 at 4096,
// 64 at 1024) and a CTA of 256 threads holds several groups at small N.
// Each thread reads its elements once with 16-byte loads that do not
// allocate in L1 (`ld.global.nc.L1::no_allocate`), neighbouring threads on
// neighbouring 16 bytes; the mean (summed as x - x[0], so a row far from
// 0 loses no bits to its offset) and then the centred sum of squares come
// from those registers, each reduced by shuffles within a warp and one
// exchange across the group's warps in shared memory behind a barrier of
// the group alone (`bar.sync` with the group's thread count); the output
// leaves with 16-byte streaming stores (`st.global.cs`). The grid holds
// as many CTAs as fit the card at once, each looping over rows, so the
// weight and bias are read once a CTA into registers. A row whose base is
// not on a 16-byte line (N not a multiple of 4 f32 or 8 bf16 elements)
// moves element by element, and a scalar tail takes its last N % 4 (or
// % 8) elements. Rows wider than 16 x 512 elements keep one block a row
// (`norm_fwd_kernel`): the row read from HBM once into shared memory, the
// two reductions and the output pass reading it back.
//
// The dx kernel (`norm_bwd_dx_rows_kernel`) has the forward's layout, from
// a launch plan the wrapper computes (`ops.fused_norm.dx_plan`: the route,
// the group's threads, 16 elements a thread, the rows a CTA): a thread
// loads its columns of x and dy with 16-byte non-allocating loads, forms
// g = dy * w and x_hat in registers (the weight read once a CTA), and
// sums both sum(g) and sum(g * x_hat) in one pass; the pair is reduced
// together, shuffles within each warp and ONE exchange across the group's
// warps behind the group's barrier, so a row costs one barrier. Before
// that exchange each thread issues the loads of its next row (the CTA
// loop's next) into a second register set, with the row's rstd and mean,
// so bytes stay in flight across the barrier and the stores. dx leaves by
// 16-byte streaming stores. The scalar route (a pointer off the 16-byte
// line, or N % (16 / itemsize) != 0) runs the same kernel with element
// loads and stores, the row's last N % V elements as its scalar tail.
// Rows wider than 8192 elements keep `norm_bwd_dx_kernel`, one block a
// row, g and x_hat kept in shared memory for its two block sums and the
// output pass. A row wider than the shared memory a block may hold (N >
// ~58k in the wide forward, ~29k in the wide dx) is read again from
// global memory (L2) instead of failing. The TPU kernel's lane padding to
// 128 and its autotuned row block are TPU tiling artifacts and are not
// carried over: any N works, odd widths included.
#include <atomic>

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

// ------------------------------------------- the forward, a row in registers

constexpr int kRowElems = 16;        // elements of a row a thread holds
constexpr int kRowMaxThreads = 512;  // threads of a row group at most: N <= 8192
constexpr int kRowCta = 256;         // threads of a CTA that holds several groups
constexpr int kDxElems = 16;         // elements of a row a dx thread holds

__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void store_stream(void* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// 16 bytes of T as floats and back, in registers: 4 f32, or 8 bf16 or f16
// (rounded to nearest even on the way out, as ptt::from_f32)
template <typename T>
struct Pack16;

template <>
struct Pack16<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&v)[kVec]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&y)[kVec]) {
    return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]), __float_as_uint(y[2]),
                      __float_as_uint(y[3]));
  }
};

template <typename H>  // __nv_bfloat16 or __half
struct Pack16Half {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&v)[kVec]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = to_f32(static_cast<unsigned short>(u[i] & 0xffffu));
      v[2 * i + 1] = to_f32(static_cast<unsigned short>(u[i] >> 16));
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&y)[kVec]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u[i] = static_cast<uint32_t>(bits(y[2 * i])) |
             (static_cast<uint32_t>(bits(y[2 * i + 1])) << 16);
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
  __device__ __forceinline__ static float to_f32(unsigned short s);
  __device__ __forceinline__ static unsigned short bits(float f);
};

template <>
__device__ __forceinline__ float Pack16Half<__nv_bfloat16>::to_f32(unsigned short s) {
  return __bfloat162float(__ushort_as_bfloat16(s));
}
template <>
__device__ __forceinline__ unsigned short Pack16Half<__nv_bfloat16>::bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16(f));
}
template <>
__device__ __forceinline__ float Pack16Half<__half>::to_f32(unsigned short s) {
  return __half2float(__ushort_as_half(s));
}
template <>
__device__ __forceinline__ unsigned short Pack16Half<__half>::bits(float f) {
  return __half_as_ushort(__float2half(f));
}

template <>
struct Pack16<__nv_bfloat16> : Pack16Half<__nv_bfloat16> {};
template <>
struct Pack16<__half> : Pack16Half<__half> {};

// Sum of `v` over the row group's `gsize` threads (a multiple of 32),
// returned to each of them: shuffles within each warp, then the group's
// warps through red[slot] (two slots of 16 floats, used in turn, so a
// slot is written again only after every thread of the group passed the
// barrier of the other one) behind a barrier of the group alone.
__device__ __forceinline__ float group_sum(float v, float* red, int gsize, int group,
                                           int& slot) {
  v = ptt::warp_sum(v);
  const int gw = gsize / 32;
  if (gw == 1) return v;
  float* r = red + slot * 16;
  slot ^= 1;
  if (threadIdx.x % 32 == 0) r[threadIdx.x / 32] = v;
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(gsize) : "memory");
  float total = 0.f;
  for (int w = 0; w < gw; ++w) total += r[group * gw + w];
  return total;
}

// This thread's columns of the weight or bias `p` (`none` where p is null
// or past n), as the rows of T lay them out: access j covers kVec columns
// from (t + j gsize) kVec. 16-byte loads where p's element is T's size and
// its base is on a 16-byte line; element loads otherwise.
template <typename T, typename TW, int kNv, int kVec>
__device__ __forceinline__ void load_cols(const TW* p, int n, int gsize, int t, float none,
                                          float (&out)[kNv][kVec]) {
  const bool vec = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    const int c0 = (t + j * gsize) * kVec;
    if constexpr (sizeof(TW) == sizeof(T)) {
      if (p != nullptr && vec && c0 + kVec <= n) {
        Pack16<TW>::unpack(load_stream(p + c0), out[j]);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      out[j][e] = p != nullptr && c0 + e < n ? ptt::to_f32(p[c0 + e]) : none;
  }
}

// Rows of n <= 16 * gsize elements, a group of gsize threads a row,
// blockDim.x / gsize groups a CTA, the CTAs looping over the rows.
template <typename T, typename TW, bool kLN>
__global__ void __launch_bounds__(kRowMaxThreads)
norm_fwd_rows_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                     const TW* __restrict__ b, T* __restrict__ out,
                     float* __restrict__ rstd_out, float* __restrict__ mean_out, long long rows,
                     int n, float eps, int gsize) {
  constexpr int kVec = Pack16<T>::kVec;    // elements of a 16-byte access
  constexpr int kNv = kRowElems / kVec;    // 16-byte accesses a thread
  __shared__ float red[2 * 16];
  const int per_cta = blockDim.x / gsize;
  const int group = threadIdx.x / gsize, t = threadIdx.x % gsize;
  const float inv_n = 1.f / static_cast<float>(n);
  // this thread's columns: access j covers [c0, c0 + kVec), c0 = (t + j gsize) kVec
  float wr[kNv][kVec], br[kNv][kVec];
  load_cols<T>(w, n, gsize, t, 1.f, wr);
  load_cols<T>(b, n, gsize, t, 0.f, br);
  int slot = 0;
  const long long stride = static_cast<long long>(gridDim.x) * per_cta;
  for (long long r = static_cast<long long>(blockIdx.x) * per_cta + group; r < rows;
       r += stride) {
    const T* xr = x + r * n;
    T* outr = out + r * n;
    const bool vec =
        ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(outr)) & 15) == 0;
    float v[kNv][kVec];
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int c0 = (t + j * gsize) * kVec;
      if (c0 + kVec <= n) {
        if (vec) {
          Pack16<T>::unpack(load_stream(xr + c0), v[j]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[j][e] = ptt::to_f32(xr[c0 + e]);
        }
      } else {  // the scalar tail: the row's last n % kVec elements, zeros past n
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          v[j][e] = c0 + e < n ? ptt::to_f32(xr[c0 + e]) : 0.f;
      }
    }
    float mean = 0.f;  // RMSNorm: no centring
    if (kLN) {
      const float x0 = ptt::to_f32(xr[0]);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kNv; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if ((t + j * gsize) * kVec + e < n) s += v[j][e] - x0;
      mean = x0 + group_sum(s, red, gsize, group, slot) * inv_n;
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kNv; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if ((t + j * gsize) * kVec + e < n) {
          const float c = v[j][e] - mean;
          ss += c * c;
        }
    const float rstd = rsqrtf(group_sum(ss, red, gsize, group, slot) * inv_n + eps);
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int c0 = (t + j * gsize) * kVec;
      if (c0 >= n) continue;
      float y[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        y[e] = (v[j][e] - mean) * rstd;
        if (w != nullptr) y[e] *= wr[j][e];
        if (b != nullptr) y[e] += br[j][e];
      }
      if (c0 + kVec <= n && vec) {
        store_stream(outr + c0, Pack16<T>::pack(y));
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (c0 + e < n) outr[c0 + e] = ptt::from_f32<T>(y[e]);
      }
    }
    if (t == 0) {
      rstd_out[r] = rstd;
      if (kLN) mean_out[r] = mean;
    }
  }
}

// What a launch reads of the card, once a process (its cards are alike:
// the library is built for sm_90a alone): SMs and the shared memory a
// block may opt into.
struct Card {
  int sms = 0, max_smem = 0;
};

const Card& card() {
  static const Card c = [] {
    Card k;
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&k.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return k;
  }();
  return c;
}

// The CTAs of `threads` threads of `kernel` that the card holds at once,
// into `ctas`; the CTAs an SM holds are read once a process into `fit`.
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int threads, std::atomic<int>& fit, long long& ctas) {
  int per_sm = fit.load(std::memory_order_relaxed);
  if (per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (err != cudaSuccess) return err;
    per_sm = per_sm < 1 ? 1 : per_sm;
    fit.store(per_sm, std::memory_order_relaxed);
  }
  ctas = static_cast<long long>(card().sms) * per_sm;
  return cudaSuccess;
}

// threads of the row group that holds a row of n elements in registers
int row_group(int n) { return ((n + kRowElems - 1) / kRowElems + 31) / 32 * 32; }

template <typename T, typename TW>
cudaError_t launch_rows(const void* x, const void* w, const void* b, void* out, void* rstd,
                        void* mean, long long rows, int n, float eps, bool ln,
                        cudaStream_t stream) {
  const int gsize = row_group(n);
  // several rows a CTA, unless the rows are too few to reach every SM
  const int per_cta =
      gsize >= kRowCta || rows <= card().sms ? 1 : kRowCta / gsize;
  const int threads = per_cta * gsize;
  auto kernel = ln ? norm_fwd_rows_kernel<T, TW, true> : norm_fwd_rows_kernel<T, TW, false>;
  static std::atomic<int> fit[2][kRowMaxThreads / 32 + 1];  // per layout and CTA size
  long long most = 0;
  const cudaError_t err = resident_ctas(kernel, threads, fit[ln][threads / 32], most);
  if (err != cudaSuccess) return err;
  const long long groups = (rows + per_cta - 1) / per_cta;
  const unsigned grid = static_cast<unsigned>(groups < most ? groups : most);
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<const TW*>(b),
      static_cast<T*>(out), static_cast<float*>(rstd), static_cast<float*>(mean), rows, n, eps,
      gsize);
  return cudaGetLastError();
}

// Rows wider than the register design: one block a row.
template <typename T, typename TW>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   void* rstd, void* mean, long long rows, int n, float eps,
                   bool ln, cudaStream_t stream) {
  if (n > 0 && row_group(n) <= kRowMaxThreads)
    return launch_rows<T, TW>(x, w, b, out, rstd, mean, rows, n, eps, ln, stream);
  // 1..4 elements per thread, a multiple of 32 threads, at most 1024
  int threads = ((n + 3) / 4 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t row_bytes = static_cast<size_t>(n) * sizeof(float);
  const bool cache_row =
      row_bytes + 32 * sizeof(float) <= static_cast<size_t>(card().max_smem);
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

// ----------------------------------------------------- dx, a row in registers

// Sums of `a` and `b` over the row group's `gsize` threads (a multiple of
// 32), returned to each of them: shuffles of the pair within each warp,
// then ONE exchange of the group's warps' pairs through red[slot] (two
// slots of 16 pairs, used in turn, as in group_sum) behind a barrier of
// the group alone.
__device__ __forceinline__ float2 group_sum2(float a, float b, float2* red, int gsize,
                                             int group, int& slot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int gw = gsize / 32;
  if (gw == 1) return make_float2(a, b);
  float2* r = red + slot * 16;
  slot ^= 1;
  if (threadIdx.x % 32 == 0) r[threadIdx.x / 32] = make_float2(a, b);
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(gsize) : "memory");
  float2 total = make_float2(0.f, 0.f);
  for (int w = 0; w < gw; ++w) {
    const float2 p = r[group * gw + w];
    total.x += p.x;
    total.y += p.y;
  }
  return total;
}

// A row's x and dy in one thread's columns, as raw 16-byte words (access
// j covers kVec columns from (t + j gsize) kVec), with the row's rstd and
// mean: what the dx kernel holds of its current row and prefetches of the
// next one.
template <int kNv>
struct DxRow {
  uint4 x[kNv], dy[kNv];
  float rstd, mean;
};

// Issues the loads of row r into `row`: 16-byte loads on the rows route
// (`vec`), element loads packed into the words (exactly) on the scalar
// one; past n, zeros.
template <typename T, bool kLN, int kNv>
__device__ __forceinline__ void load_dx_row(const T* x, const T* dy, const float* rstd,
                                            const float* mean, long long r, int n, int gsize,
                                            int t, bool vec, DxRow<kNv>& row) {
  constexpr int kVec = Pack16<T>::kVec;
  const T* xr = x + r * n;
  const T* dyr = dy + r * n;
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    const int c0 = (t + j * gsize) * kVec;
    if (vec && c0 + kVec <= n) {
      row.x[j] = load_stream(xr + c0);
      row.dy[j] = load_stream(dyr + c0);
      continue;
    }
    float a[kVec], b[kVec];
    if (c0 + kVec <= n) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        a[e] = ptt::to_f32(xr[c0 + e]);
        b[e] = ptt::to_f32(dyr[c0 + e]);
      }
    } else {  // the scalar tail: the row's last n % kVec elements, zeros past n
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const bool in = c0 + e < n;
        a[e] = in ? ptt::to_f32(xr[c0 + e]) : 0.f;
        b[e] = in ? ptt::to_f32(dyr[c0 + e]) : 0.f;
      }
    }
    row.x[j] = Pack16<T>::pack(a);
    row.dy[j] = Pack16<T>::pack(b);
  }
  row.rstd = rstd[r];
  row.mean = kLN ? mean[r] : 0.f;
}

// Rows of n <= kDxElems * gsize elements, a group of gsize threads a row,
// blockDim.x / gsize groups a CTA, the CTAs looping over the rows; `vec`:
// the rows route (every row on the 16-byte line, n % kVec == 0), else the
// scalar one.
template <typename T, typename TW, bool kLN>
__global__ void __launch_bounds__(kRowMaxThreads)
norm_bwd_dx_rows_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                        const T* __restrict__ dy, const float* __restrict__ rstd_in,
                        const float* __restrict__ mean_in, T* __restrict__ dx, long long rows,
                        int n, int gsize, bool vec) {
  constexpr int kVec = Pack16<T>::kVec;   // elements of a 16-byte access
  constexpr int kNv = kDxElems / kVec;    // 16-byte accesses a thread
  __shared__ float2 red[2 * 16];
  const int per_cta = blockDim.x / gsize;
  const int group = threadIdx.x / gsize, t = threadIdx.x % gsize;
  const float inv_n = 1.f / static_cast<float>(n);
  float wr[kNv][kVec];
  load_cols<T>(w, n, gsize, t, 1.f, wr);
  int slot = 0;
  const long long stride = static_cast<long long>(gridDim.x) * per_cta;
  long long r = static_cast<long long>(blockIdx.x) * per_cta + group;
  DxRow<kNv> cur, next;
  if (r < rows) load_dx_row<T, kLN>(x, dy, rstd_in, mean_in, r, n, gsize, t, vec, cur);
  for (; r < rows; r += stride) {
    // the next row's loads go out before this row's exchange and stores
    if (r + stride < rows)
      load_dx_row<T, kLN>(x, dy, rstd_in, mean_in, r + stride, n, gsize, t, vec, next);
    const float rstd = cur.rstd, mean = cur.mean;
    // sum(g) and sum(g * x_hat) in one pass; columns past n hold g = 0
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      float xv[kVec], dv[kVec];
      Pack16<T>::unpack(cur.x[j], xv);
      Pack16<T>::unpack(cur.dy[j], dv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float g = dv[e] * wr[j][e];
        s1 += g;
        s2 += g * ((xv[e] - mean) * rstd);
      }
    }
    const float2 s = group_sum2(s1, s2, red, gsize, group, slot);
    const float c1 = kLN ? s.x * inv_n : 0.f, c2 = s.y * inv_n;
    T* dxr = dx + r * n;
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const int c0 = (t + j * gsize) * kVec;
      if (c0 >= n) continue;
      float xv[kVec], dv[kVec], y[kVec];
      Pack16<T>::unpack(cur.x[j], xv);
      Pack16<T>::unpack(cur.dy[j], dv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float g = dv[e] * wr[j][e];
        const float xh = (xv[e] - mean) * rstd;
        y[e] = rstd * (g - c1 - xh * c2);
      }
      if (vec && c0 + kVec <= n) {
        store_stream(dxr + c0, Pack16<T>::pack(y));
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (c0 + e < n) dxr[c0 + e] = ptt::from_f32<T>(y[e]);
      }
    }
    cur = next;
  }
}

// The dx routes of `ops.fused_norm.dx_plan`.
enum DxRoute { kDxRows = 0, kDxScalar = 1, kDxWide = 2 };

template <typename T, typename TW>
cudaError_t launch_dx(const void* x, const void* w, const void* dy, const void* rstd,
                      const void* mean, void* dx, long long rows, int n, bool ln, int route,
                      int gsize, int elems, int per_cta, cudaStream_t stream) {
  if (route == kDxWide) {  // one block of gsize threads a row
    if (gsize < 32 || gsize > 1024 || gsize % 32 != 0) return cudaErrorInvalidValue;
    const size_t row_bytes = 2 * static_cast<size_t>(n) * sizeof(float);
    const bool cache_row =
        row_bytes + 32 * sizeof(float) <= static_cast<size_t>(card().max_smem);
    const size_t smem = cache_row ? row_bytes : 0;
    auto kernel = ln ? norm_bwd_dx_kernel<T, TW, true> : norm_bwd_dx_kernel<T, TW, false>;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    kernel<<<static_cast<unsigned>(rows), gsize, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<const T*>(dy),
        static_cast<const float*>(rstd), static_cast<const float*>(mean), static_cast<T*>(dx),
        n, cache_row);
    return cudaGetLastError();
  }
  const int threads = per_cta * gsize;
  if ((route != kDxRows && route != kDxScalar) || elems != kDxElems || gsize % 32 != 0 ||
      gsize < 32 || static_cast<long long>(gsize) * kDxElems < n || per_cta < 1 ||
      threads > kRowMaxThreads)
    return cudaErrorInvalidValue;
  auto kernel = ln ? norm_bwd_dx_rows_kernel<T, TW, true> : norm_bwd_dx_rows_kernel<T, TW, false>;
  static std::atomic<int> fit[2][kRowMaxThreads / 32 + 1];  // per layout and CTA size
  long long most = 0;
  const cudaError_t err = resident_ctas(kernel, threads, fit[ln][threads / 32], most);
  if (err != cudaSuccess) return err;
  const long long groups = (rows + per_cta - 1) / per_cta;
  const unsigned grid = static_cast<unsigned>(groups < most ? groups : most);
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<const T*>(dy),
      static_cast<const float*>(rstd), static_cast<const float*>(mean), static_cast<T*>(dx), rows,
      n, gsize, route == kDxRows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dx_w(int w_dtype, const void* x, const void* w, const void* dy,
                          const void* rstd, const void* mean, void* dx, long long rows, int n,
                          bool ln, int route, int gsize, int elems, int per_cta,
                          cudaStream_t stream) {
  switch (w_dtype) {
    case ptt::kF32:
      return launch_dx<T, float>(x, w, dy, rstd, mean, dx, rows, n, ln, route, gsize, elems,
                                 per_cta, stream);
    case ptt::kBF16:
      return launch_dx<T, __nv_bfloat16>(x, w, dy, rstd, mean, dx, rows, n, ln, route, gsize,
                                         elems, per_cta, stream);
    case ptt::kF16:
      return launch_dx<T, __half>(x, w, dy, rstd, mean, dx, rows, n, ln, route, gsize, elems,
                                  per_cta, stream);
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
// LayerNorm, 0 = RMSNorm. route, gsize, elems, per_cta: the launch of
// `ops.fused_norm.dx_plan` (route 0 rows, 1 scalar: gsize threads a row,
// elems (16) elements a thread, per_cta rows a CTA; 2 wide: one block of
// gsize threads a row); this side only sizes the grid, from occupancy.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_norm_bwd_dx(const void* x, const void* w, const void* dy, const void* rstd,
                               const void* mean, void* dx, long long rows, int n, int x_dtype,
                               int w_dtype, int kind, int route, int gsize, int elems,
                               int per_cta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = kind == 1;
  switch (x_dtype) {
    case ptt::kF32:
      return dispatch_dx_w<float>(w_dtype, x, w, dy, rstd, mean, dx, rows, n, ln, route, gsize,
                                  elems, per_cta, s);
    case ptt::kBF16:
      return dispatch_dx_w<__nv_bfloat16>(w_dtype, x, w, dy, rstd, mean, dx, rows, n, ln, route,
                                          gsize, elems, per_cta, s);
    case ptt::kF16:
      return dispatch_dx_w<__half>(w_dtype, x, w, dy, rstd, mean, dx, rows, n, ln, route, gsize,
                                   elems, per_cta, s);
  }
  return cudaErrorInvalidValue;
}
