// Paged decode attention (one query token per row) for Hopper (sm_90a):
// full precision and int8 pages.
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py:50 `_decode_kernel`,
// reached through `_run_decode` :118 in its two paged forms, one template
// `decode_tile_kernel<T, KV>` (T the query's type, KV the cache's):
// - full precision (`paged_decode_attention` :192): <T, T>;
// - int8 with per-(page, head) f32 scales (`kv_scales=`, the
//   `quantized=True` grid of :177): <T, int8_t>.
// Its dense-cache form (`dense_decode_attention` :332, the MMHA path) is
// dense_decode.cu's kernel pair, split over the sequence.
// Same semantics in both: GQA with g = H/Hkv query heads per KV head;
// a page is skipped when it starts at or past the row's length, or when
// its block-table entry is negative; the last one is masked per slot; NEG_INF = -1e30; the online softmax runs in f32 with
// alpha = exp(m_prev - m_new); the output is acc / (l == 0 ? 1 : l) in q's
// type, so a row with no valid token writes zeros, never NaN. The int8 form
// dequantizes per page: JAX multiplies K and V by the page's scale before
// the products; here the scale is factored out of q.k and of p.v (the same
// function, one multiply per page instead of one per element).
//
// Bound on an H100: memory. Decode reads every valid cached token's K and
// V row once and does 4*D operations per (token, query head) against them:
// bytes = 2*sum(lengths)*Hkv*D*sizeof(KV) (+ 8 bytes of scales per int8
// page and head read) + q + out + tables + lengths, at 3.35 TB/s, while
// the arithmetic intensity (about g operations per byte, 2g for int8) is
// two orders of magnitude under the card's ridge point.
//
// Design against that bound: one CTA per (batch row, KV head). The TPU
// kernel's sequential page grid axis, which carried m/l/acc in VMEM
// scratch, becomes a loop over the row's pages inside the CTA, with m, l
// and acc in shared memory. The CTA reads its own block-table entries and
// length (Hopper has no scalar prefetch) and stops at the first page past
// the length, so a page is read from HBM only if it holds valid tokens, and
// only its valid slots are read. It first stages the page's valid K and V
// rows (they are contiguous) in shared memory, 16 bytes a thread, then
// works from there. Scores: one warp per cached token, lanes across D (a
// shuffle reduction), all g query heads of the group against the row. P.V:
// threads across (head, D), so neighbouring threads read neighbouring
// elements of a V row. Making them fast (cp.async/TMA double buffering,
// split-K over pages for small batches, as dense_decode.cu splits the
// dense cache) is later work.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // paddle_tpu/ops/pallas/flash_attention.py NEG_INF
constexpr int kThreads = 128;

// tile = ps, the loop runs over the P = n_tiles block-table entries of row
// b, page `page` of KV head h is the contiguous [ps, D] block at element
// (page * Hkv + h) * ps * D, and for int8 pages k_scale/v_scale
// [n_pages, Hkv] hold its dequant scales (payload * scale; null for
// full-precision pages). D * sizeof(KV) must be a multiple of 16 and the
// caches 16-byte aligned (the wrapper checks both).
template <typename T, typename KV>
__global__ void decode_tile_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                                   const KV* __restrict__ vc,
                                   const float* __restrict__ k_scale,
                                   const float* __restrict__ v_scale,
                                   const int* __restrict__ tables,
                                   const int* __restrict__ lengths,
                                   T* __restrict__ out, int Hkv, int g, int D, int tile,
                                   int n_tiles, float scale) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int tD = tile * D;
  const int gD = g * D;
  KV* k_s = reinterpret_cast<KV*>(tile_smem);  // [tile, D] this tile's K rows
  KV* v_s = k_s + tD;                           // [tile, D] its V rows
  float* q_s = reinterpret_cast<float*>(v_s + tD);  // [g, D] query heads, f32
  float* acc = q_s + gD;      // [g, D] running P.V
  float* sc = acc + gD;       // [g, tile] scores, then probabilities
  float* m_s = sc + g * tile; // [g] running max
  float* l_s = m_s + g;       // [g] running denominator
  float* alpha_s = l_s + g;   // [g] this tile's rescale factor

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

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

  for (int p = 0; p < n_tiles; ++p) {
    const int base = p * tile;
    if (base >= length) break;  // this tile and every later one is empty
    float ks = 1.f, vs = 1.f;   // dequant scales (int8 pages only)
    const int page = tables[static_cast<long long>(b) * n_tiles + p];
    if (page < 0) continue;     // unused block-table entry
    const long long ph = static_cast<long long>(page) * Hkv + h;
    const long long off = ph * tD;  // element offset of the page's first row
    if (k_scale != nullptr) {
      ks = k_scale[ph];
      vs = v_scale[ph];
    }
    const int nv = min(tile, length - base);  // valid rows of this tile

    // stage the nv valid rows of K and V, 16 bytes a thread
    const int n_vec = static_cast<int>(static_cast<long long>(nv) * D * sizeof(KV) / 16);
    const uint4* kg = reinterpret_cast<const uint4*>(kc + off);
    const uint4* vg = reinterpret_cast<const uint4*>(vc + off);
    uint4* k4 = reinterpret_cast<uint4*>(k_s);
    uint4* v4 = reinterpret_cast<uint4*>(v_s);
    for (int i = tid; i < n_vec; i += blockDim.x) {
      k4[i] = kg[i];
      v4[i] = vg[i];
    }
    __syncthreads();

    // scores s[j, t] = (q_j . k_t) * ks * scale, one warp per row t
    const float s_scale = ks * scale;
    for (int t = warp; t < nv; t += n_warps) {
      const KV* kt = k_s + t * D;
      for (int j = 0; j < g; ++j) {
        float part = 0.f;
        for (int d = lane; d < D; d += 32) part += q_s[j * D + d] * ptt::to_f32(kt[d]);
        part = ptt::warp_sum(part);
        if (lane == 0) sc[j * tile + t] = part * s_scale;
      }
    }
    __syncthreads();

    // online softmax over this tile, one warp per query head
    for (int j = warp; j < g; j += n_warps) {
      float mx = kNegInf;
      for (int t = lane; t < nv; t += 32) mx = fmaxf(mx, sc[j * tile + t]);
      mx = ptt::warp_max(mx);
      const float m_prev = m_s[j];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nv; t += 32) {
        const float pr = expf(sc[j * tile + t] - m_new);
        sc[j * tile + t] = pr;
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

    // acc[j, d] = acc[j, d] * alpha_j + vs * sum_t p[j, t] * v[t, d]
    for (int i = tid; i < gD; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      float pv = 0.f;
      for (int t = 0; t < nv; ++t) pv += sc[j * tile + t] * ptt::to_f32(v_s[t * D + d]);
      acc[i] = acc[i] * alpha_s[j] + vs * pv;
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and sc
  }

  for (int i = tid; i < gD; i += blockDim.x) {
    const float l = l_s[i / D];
    out[qo + i] = ptt::from_f32<T>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, typename KV>
cudaError_t launch_tile(const void* q, const void* kc, const void* vc, const void* k_scale,
                        const void* v_scale, const void* tables, const void* lengths,
                        void* out, int B, int Hkv, int g, int D, int tile, int n_tiles,
                        float scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(tile) * D * sizeof(KV)
                      + (2 * static_cast<size_t>(g) * D + static_cast<size_t>(g) * tile + 3 * g)
                        * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_tile_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_tile_kernel<T, KV><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kc), static_cast<const KV*>(vc),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<T*>(out),
      Hkv, g, D, tile, n_tiles, scale);
  return cudaGetLastError();
}

}  // namespace

// Paged full-precision decode. q [B, Hkv*g, D]; kc, vc [n_pages, Hkv, ps, D]
// of q's type (code `dtype`); tables int32 [B, P]; lengths int32 [B]
// (valid tokens including the current one); out like q. All contiguous;
// D * sizeof(T) a multiple of 16. Returns cudaGetLastError() after the
// launch.
extern "C" int ptt_paged_decode_attention(const void* q, const void* kc, const void* vc,
                                          const void* tables, const void* lengths,
                                          void* out, int B, int Hkv, int g, int D, int ps,
                                          int P, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_tile<float, float>(q, kc, vc, nullptr, nullptr, tables, lengths, out, B,
                                       Hkv, g, D, ps, P, scale, s);
    case ptt::kBF16:
      return launch_tile<__nv_bfloat16, __nv_bfloat16>(
          q, kc, vc, nullptr, nullptr, tables, lengths, out, B, Hkv, g, D, ps, P, scale, s);
    case ptt::kF16:
      return launch_tile<__half, __half>(q, kc, vc, nullptr, nullptr, tables, lengths, out, B,
                                         Hkv, g, D, ps, P, scale, s);
  }
  return cudaErrorInvalidValue;
}

// Paged int8 decode. q [B, Hkv*g, D] (f32, bf16 or f16, code `dtype`);
// kc, vc int8 [n_pages, Hkv, ps, D]; k_scale, v_scale f32 [n_pages, Hkv];
// tables int32 [B, P]; lengths int32 [B] (valid tokens including the
// current one); out like q. All contiguous; D a multiple of 16. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_paged_decode_attention_q8(const void* q, const void* kc, const void* vc,
                                             const void* k_scale, const void* v_scale,
                                             const void* tables, const void* lengths,
                                             void* out, int B, int Hkv, int g, int D, int ps,
                                             int P, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_tile<float, int8_t>(q, kc, vc, k_scale, v_scale, tables, lengths, out, B,
                                        Hkv, g, D, ps, P, scale, s);
    case ptt::kBF16:
      return launch_tile<__nv_bfloat16, int8_t>(q, kc, vc, k_scale, v_scale, tables, lengths,
                                                out, B, Hkv, g, D, ps, P, scale, s);
    case ptt::kF16:
      return launch_tile<__half, int8_t>(q, kc, vc, k_scale, v_scale, tables, lengths, out, B,
                                         Hkv, g, D, ps, P, scale, s);
  }
  return cudaErrorInvalidValue;
}
