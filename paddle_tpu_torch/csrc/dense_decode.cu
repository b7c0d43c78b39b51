// Dense-cache decode attention for Hopper (sm_90a), split over the
// sequence (flash decoding).
//
// Replaces the dense form of paddle_tpu/ops/pallas/decode_attention.py:50
// `_decode_kernel`, reached through `dense_decode_attention` :332 (the
// MMHA path): one query token per row against [B, Hkv, S_max, D] caches,
// GQA with g = H / Hkv query heads per kv head, the first min(lengths[b],
// S_max) tokens of row b valid. Its semantics stay: NEG_INF = -1e30, the
// softmax in f32, the output acc / (l == 0 ? 1 : l) in q's type, so a row
// of length 0 writes zeros. The paged forms stay in decode_attention.cu.
//
// Bound on an H100: memory. Every valid token's K and V row is read once
// (2 * sum(min(lengths, S_max)) * Hkv * D * sizeof(T) bytes, plus q, out
// and the lengths) at 3.35 TB/s; 4 D operations per (token, query head)
// are two orders of magnitude under the card's ridge point. At the MMHA
// shape (B 16, 16 heads of 128, S_max 2048, lengths 1 to 2048, bf16) that
// is 0.0401 ms.
//
// Design: the sequence is cut into chunks of `chunk` tokens (the wrapper
// fixes it from D, the dtype and S_max: ops/decode_attention.py
// `dense_chunk`), so the grid fills several waves of the card whatever the
// lengths, where one CTA per (row, kv head) left 256 CTAs (64 at g = 4)
// walking up to 2048 tokens each while most SMs sat idle. Two kernels:
//   1. decode_split_kernel<T>, grid (chunk, kv head, row), 128 threads. A
//      CTA whose chunk starts at or past its row's length exits at once.
//      The chunk's valid K and V rows come in by cp.async, 16 bytes a
//      thread, K and V in two groups, so the scores start when K has
//      landed while V is still in flight. Scores of all g query heads: a
//      row is split over 16-byte pieces of lanes (16 lanes a row at D 128
//      in bf16), so a warp scores 32 / lanes tokens at once, summed by
//      shuffles within the row's lanes. The chunk's softmax runs one warp
//      a head (m = max, l = sum exp(s - m)); P V runs threads across
//      (16-byte piece of D, token group) for four heads at a time, the
//      token groups summed through shared memory over K's rows. The CTA
//      writes its f32 partial m, l and unnormalised acc to the workspace.
//   2. decode_combine_kernel<T>, one CTA per (row, query head): over the
//      chunks that hold tokens, M = max m_i, w_i = exp(m_i - M), out =
//      sum w_i acc_i / (sum w_i l_i, or 1 where that is 0). A row of
//      length 0 has no such chunk and writes exact zeros.
// Shared memory: K and V of a chunk (32 KB each at 128 tokens of D 128 in
// bf16), q and the scores in f32: three CTAs an SM.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // paddle_tpu/ops/pallas/flash_attention.py NEG_INF
constexpr int kSplitThreads = 128;
constexpr int kCombineThreads = 128;
constexpr int kHeadsAtOnce = 4;  // query heads of a P V pass

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // until at most N groups are in flight
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes of the region that holds K, then the P V partials
__host__ __device__ inline size_t k_region(int chunk, int D, int elem, int n_tg) {
  const size_t k = static_cast<size_t>(chunk) * D * elem;
  const size_t red = static_cast<size_t>(n_tg) * kHeadsAtOnce * D * sizeof(float);
  return k > red ? k : red;
}

// The partials of chunk blockIdx.x of kv head blockIdx.y of row blockIdx.z
// into ws [B, Hkv * g, n_chunks, D + 2] f32: acc [0, D), m at D, l at D + 1.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ lengths,
                        float* __restrict__ ws, int Hkv, int g, int D, int s_max, int chunk,
                        int n_chunks, float scale) {
  constexpr int kE = 16 / sizeof(T);  // elements of a 16-byte piece
  const int ci = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int length = min(lengths[b], s_max);
  const int c0 = ci * chunk;
  if (c0 >= length) return;                // no token of the row in this chunk
  const int nv = min(chunk, length - c0);  // its valid tokens

  const int pieces = D / kE;  // 16-byte pieces of a row
  const int n_tg = kSplitThreads / pieces;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t k_bytes = k_region(chunk, D, sizeof(T), n_tg);
  T* k_s = reinterpret_cast<T*>(smem);             // [chunk][D]
  float* red = reinterpret_cast<float*>(smem);     // then [n_tg][kHeadsAtOnce][D]
  T* v_s = reinterpret_cast<T*>(smem + k_bytes);   // [chunk][D]
  float* q_s = reinterpret_cast<float*>(smem + k_bytes + static_cast<size_t>(chunk) * D * sizeof(T));
  float* sc = q_s + g * D;                         // [g][chunk] scores, then probabilities

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long kv_off = ((static_cast<long long>(b) * Hkv + h) * s_max + c0) * D;
  const int n_vec = nv * pieces;
  for (int i = tid; i < n_vec; i += kSplitThreads) cp_async16(k_s + i * kE, kc + kv_off + i * kE);
  cp_async_commit();
  for (int i = tid; i < n_vec; i += kSplitThreads) cp_async16(v_s + i * kE, vc + kv_off + i * kE);
  cp_async_commit();
  const long long head0 = (static_cast<long long>(b) * Hkv + h) * g;  // first query head
  for (int i = tid; i < g * D; i += kSplitThreads) q_s[i] = ptt::to_f32(q[head0 * D + i]);
  cp_async_wait<1>();  // this thread's K pieces
  __syncthreads();

  // scores s[j, t] = q_j . k_t * scale: lpr lanes a row, 32 / lpr rows a warp
  int lpr = 1;
  while (lpr < pieces && lpr < 32) lpr *= 2;
  const int per_warp = 32 / lpr, sub = lane % lpr;
  for (int t0 = warp * per_warp; t0 < nv; t0 += (kSplitThreads / 32) * per_warp) {
    const int t = t0 + lane / lpr;
    for (int j = 0; j < g; ++j) {
      float part = 0.f;
      if (t < nv)
        for (int c = sub; c < pieces; c += lpr) {
          const uint4 raw = *reinterpret_cast<const uint4*>(k_s + t * D + c * kE);
          const T* kt = reinterpret_cast<const T*>(&raw);
          const float* qj = q_s + j * D + c * kE;
#pragma unroll
          for (int e = 0; e < kE; ++e) part += qj[e] * ptt::to_f32(kt[e]);
        }
      for (int o = lpr / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (sub == 0 && t < nv) sc[j * chunk + t] = part * scale;
    }
  }
  __syncthreads();

  // the chunk's softmax, one warp a head: m, p = exp(s - m), l = sum p
  float* part0 = ws + head0 * n_chunks * (D + 2) + static_cast<long long>(ci) * (D + 2);
  const long long head_stride = static_cast<long long>(n_chunks) * (D + 2);
  for (int j = warp; j < g; j += kSplitThreads / 32) {
    float mx = kNegInf;
    for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, sc[j * chunk + t]);
    mx = ptt::warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < nv; t += 32) {
      const float pr = expf(sc[j * chunk + t] - mx);
      sc[j * chunk + t] = pr;
      sum += pr;
    }
    sum = ptt::warp_sum(sum);
    if (lane == 0) {
      part0[j * head_stride + D] = mx;
      part0[j * head_stride + D + 1] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc[j, d] = sum_t p[j, t] v[t, d]: thread (token group tg, piece pc)
  const int pc = tid % pieces, tg = tid / pieces;
  for (int j0 = 0; j0 < g; j0 += kHeadsAtOnce) {
    float a[kHeadsAtOnce][kE];
#pragma unroll
    for (int jj = 0; jj < kHeadsAtOnce; ++jj)
#pragma unroll
      for (int e = 0; e < kE; ++e) a[jj][e] = 0.f;
    if (tg < n_tg) {
      for (int t = tg; t < nv; t += n_tg) {
        const uint4 raw = *reinterpret_cast<const uint4*>(v_s + t * D + pc * kE);
        const T* vt = reinterpret_cast<const T*>(&raw);
        float vf[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e) vf[e] = ptt::to_f32(vt[e]);
#pragma unroll
        for (int jj = 0; jj < kHeadsAtOnce; ++jj) {
          if (j0 + jj >= g) break;
          const float pr = sc[(j0 + jj) * chunk + t];
#pragma unroll
          for (int e = 0; e < kE; ++e) a[jj][e] += pr * vf[e];
        }
      }
#pragma unroll
      for (int jj = 0; jj < kHeadsAtOnce; ++jj)
#pragma unroll
        for (int e = 0; e < kE; ++e) red[(tg * kHeadsAtOnce + jj) * D + pc * kE + e] = a[jj][e];
    }
    __syncthreads();
    const int nj = min(kHeadsAtOnce, g - j0);
    for (int i = tid; i < nj * D; i += kSplitThreads) {
      const int jj = i / D, d = i - jj * D;
      float s = 0.f;
      for (int u = 0; u < n_tg; ++u) s += red[(u * kHeadsAtOnce + jj) * D + d];
      part0[(j0 + jj) * head_stride + d] = s;
    }
    __syncthreads();  // the next pass overwrites red
  }
}

// the weight of a chunk whose running max is m, against the row's max
__device__ __forceinline__ float chunk_weight(float m, float top) { return expf(m - top); }

// out [B, H, D] from the partials of the chunks that hold tokens; one CTA
// per (row, query head)
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_combine_kernel(const float* __restrict__ ws, const int* __restrict__ lengths,
                          T* __restrict__ out, int H, int D, int s_max, int chunk,
                          int n_chunks) {
  const int bh = blockIdx.x, b = bh / H;
  const int length = min(lengths[b], s_max);
  const int n = length > 0 ? (length + chunk - 1) / chunk : 0;
  const float* w = ws + static_cast<long long>(bh) * n_chunks * (D + 2);
  float top = kNegInf;
  for (int i = 0; i < n; ++i) top = fmaxf(top, w[i * (D + 2) + D]);
  float l = 0.f;
  for (int i = 0; i < n; ++i) l += chunk_weight(w[i * (D + 2) + D], top) * w[i * (D + 2) + D + 1];
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += chunk_weight(w[i * (D + 2) + D], top) * w[i * (D + 2) + d];
    out[static_cast<long long>(bh) * D + d] = ptt::from_f32<T>(acc / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
cudaError_t launch_dense(const void* q, const void* kc, const void* vc, const void* lengths,
                         void* ws, void* out, int B, int Hkv, int g, int D, int s_max, int chunk,
                         float scale, cudaStream_t st) {
  constexpr int kE = 16 / sizeof(T);
  if (D < kE || D % kE || D / kE > kSplitThreads || chunk < 1) return cudaErrorInvalidValue;
  const int n_chunks = (s_max + chunk - 1) / chunk;
  if (n_chunks > 0) {
    const int n_tg = kSplitThreads / (D / kE);
    const size_t smem = k_region(chunk, D, sizeof(T), n_tg) +
                        static_cast<size_t>(chunk) * D * sizeof(T) +
                        static_cast<size_t>(g) * (D + chunk) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    decode_split_kernel<T><<<dim3(n_chunks, Hkv, B), kSplitThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
        static_cast<const int*>(lengths), static_cast<float*>(ws), Hkv, g, D, s_max, chunk,
        n_chunks, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  decode_combine_kernel<T><<<B * Hkv * g, kCombineThreads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const int*>(lengths), static_cast<T*>(out),
      Hkv * g, D, s_max, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

// Dense-cache decode. q [B, Hkv*g, D]; kc, vc [B, Hkv, s_max, D] of q's
// type (code `dtype`); lengths int32 [B] (valid tokens including the
// current one, clamped to s_max); ws f32 [B, Hkv*g, ceil(s_max / chunk),
// D + 2], the partials; out like q. All contiguous; D * sizeof(T) a
// multiple of 16 and at most 2 KB. Returns cudaGetLastError() after the
// launches.
extern "C" int ptt_dense_decode_attention(const void* q, const void* kc, const void* vc,
                                          const void* lengths, void* ws, void* out, int B,
                                          int Hkv, int g, int D, int s_max, int chunk,
                                          float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_dense<float>(q, kc, vc, lengths, ws, out, B, Hkv, g, D, s_max, chunk,
                                 scale, s);
    case ptt::kBF16:
      return launch_dense<__nv_bfloat16>(q, kc, vc, lengths, ws, out, B, Hkv, g, D, s_max,
                                         chunk, scale, s);
    case ptt::kF16:
      return launch_dense<__half>(q, kc, vc, lengths, ws, out, B, Hkv, g, D, s_max, chunk,
                                  scale, s);
  }
  return cudaErrorInvalidValue;
}
