// Paged decode attention (one query token per row) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py:50 `_decode_kernel`
// in its paged, full-precision form (reached through `_run_decode` :118
// from `paged_decode_attention` :192). Same semantics: GQA with g = H/Hkv
// query heads per KV head; a page is skipped when it starts at or past the
// row's length or its block-table entry is negative; the last page is
// masked per slot; NEG_INF = -1e30; the online softmax runs in f32 with
// alpha = exp(m_prev - m_new); the output is acc / (l == 0 ? 1 : l) in q's
// type, so a row with no valid token writes zeros, never NaN. The int8
// variant with per-(page, head) scales and the dense-cache variant are
// later work.
//
// Bound on an H100: memory. Decode reads every valid cached token's K and
// V row once and does 4*D operations per (token, query head) against them:
// bytes = 2*sum(lengths)*Hkv*D*sizeof(T) + q + out + tables + lengths, at
// 3.35 TB/s, while the arithmetic intensity (about g operations per byte)
// is two orders of magnitude under the card's ridge point.
//
// Design against that bound: one CTA per (batch row, KV head). The TPU
// kernel's sequential page grid axis, which carried m/l/acc in VMEM
// scratch, becomes a loop over the row's pages inside the CTA, with m, l and
// acc in shared memory. The CTA reads its own block-table entries and
// length (Hopper has no scalar prefetch) and stops at the first page past
// the length, so a page is read from HBM only if it holds valid tokens, and
// only its valid slots are read. Scores: one warp per cached token, lanes
// across D (coalesced row reads, a shuffle reduction), all g query heads of
// the group against the row while it sits in L1. P.V: threads across
// (head, D), so each V row is read by neighbouring threads. Making it fast
// (cp.async/TMA double buffering, split-K over pages for small batches) is
// later work.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // paddle_tpu/ops/pallas/flash_attention.py NEG_INF
constexpr int kThreads = 128;

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                                    const T* __restrict__ vc,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ lengths,
                                    T* __restrict__ out, int Hkv, int g, int D,
                                    int ps, int P, float scale) {
  extern __shared__ float smem[];
  const int gD = g * D;
  float* q_s = smem;          // [g, D] query heads of this group, f32
  float* acc = q_s + gD;      // [g, D] running P.V
  float* sc = acc + gD;       // [g, ps] scores, then probabilities
  float* m_s = sc + g * ps;   // [g] running max
  float* l_s = m_s + g;       // [g] running denominator
  float* alpha_s = l_s + g;   // [g] this page's rescale factor

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // q is [B, Hkv * g, D]: the g heads of KV head h are contiguous
  const long long qo = (static_cast<long long>(b) * Hkv + h) * gD;
  for (int i = tid; i < gD; i += blockDim.x) {
    q_s[i] = ptt::to_f32(q[qo + i]);
    acc[i] = 0.f;
  }
  for (int j = tid; j < g; j += blockDim.x) {
    m_s[j] = kNegInf;
    l_s[j] = 0.f;
  }
  const int length = lengths[b];
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const int base = p * ps;
    if (base >= length) break;  // this page and every later one is empty
    const int page = tables[static_cast<long long>(b) * P + p];
    if (page < 0) continue;     // unused block-table entry
    const int nv = min(ps, length - base);  // valid slots of this page
    const long long po = (static_cast<long long>(page) * Hkv + h) * ps * D;
    const T* kp = kc + po;
    const T* vp = vc + po;

    // scores s[j, t] = q_j . k_t * scale, one warp per slot t
    for (int t = warp; t < nv; t += n_warps) {
      const T* kt = kp + static_cast<long long>(t) * D;
      for (int j = 0; j < g; ++j) {
        float part = 0.f;
        for (int d = lane; d < D; d += 32) part += q_s[j * D + d] * ptt::to_f32(kt[d]);
        part = ptt::warp_sum(part);
        if (lane == 0) sc[j * ps + t] = part * scale;
      }
    }
    __syncthreads();

    // online softmax over this page, one warp per query head
    for (int j = warp; j < g; j += n_warps) {
      float mx = kNegInf;
      for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, sc[j * ps + t]);
      mx = ptt::warp_max(mx);
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nv; t += 32) {
        const float pr = expf(sc[j * ps + t] - m_new);
        sc[j * ps + t] = pr;
        sum += pr;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[j] = alpha;
        l_s[j] = alpha * l_s[j] + sum;
        m_s[j] = m_new;
      }
    }
    __syncthreads();

    // acc[j, d] = acc[j, d] * alpha_j + sum_t p[j, t] * v[t, d]
    for (int i = tid; i < gD; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      float a = acc[i] * alpha_s[j];
      for (int t = 0; t < nv; ++t) {
        a += sc[j * ps + t] * ptt::to_f32(vp[static_cast<long long>(t) * D + d]);
      }
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < gD; i += blockDim.x) {
    const float l = l_s[i / D];
    out[qo + i] = ptt::from_f32<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* tables,
                   const void* lengths, void* out, int B, int Hkv, int g, int D,
                   int ps, int P, float scale, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(g) * D + static_cast<size_t>(g) * ps + 3 * g)
                      * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  paged_decode_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), Hkv, g, D, ps, P, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hkv*g, D]; kc, vc [n_pages, Hkv, ps, D]; tables int32 [B, P];
// lengths int32 [B] (valid tokens including the current one); out like q.
// All contiguous, q/kc/vc/out of one element type. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_paged_decode_attention(const void* q, const void* kc, const void* vc,
                                          const void* tables, const void* lengths,
                                          void* out, int B, int Hkv, int g, int D, int ps,
                                          int P, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32: return launch<float>(q, kc, vc, tables, lengths, out, B, Hkv, g, D, ps, P, scale, s);
    case ptt::kBF16: return launch<__nv_bfloat16>(q, kc, vc, tables, lengths, out, B, Hkv, g, D, ps, P, scale, s);
    case ptt::kF16: return launch<__half>(q, kc, vc, tables, lengths, out, B, Hkv, g, D, ps, P, scale, s);
  }
  return cudaErrorInvalidValue;
}
