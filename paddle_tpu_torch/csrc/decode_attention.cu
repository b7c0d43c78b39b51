// Paged decode attention (one query token per row) for Hopper (sm_90a):
// full precision and int8 pages, split over chunks of pages and combined
// in the same launch.
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py:50 `_decode_kernel`,
// reached through `_run_decode` :118 in its two paged forms, one template
// `paged_split_kernel<T, KV>` (T the query's type, KV the cache's):
// - full precision (`paged_decode_attention` :192): <T, T>;
// - int8 with per-(page, head) f32 scales (`kv_scales=`, the
//   `quantized=True` grid of :177): <T, int8_t>.
// Its dense-cache form (`dense_decode_attention` :332, the MMHA path) is
// dense_decode.cu's kernel pair.
// Same semantics in both: GQA with g = H/Hkv query heads per KV head; a
// page is skipped when it starts at or past the row's length, or when its
// block-table entry is negative; the last one is masked per slot; tokens
// past P * ps are not attended (the JAX grid has P pages); NEG_INF =
// -1e30; the softmax runs in f32; the output is acc / (l == 0 ? 1 : l) in
// q's type, so a row with no readable token writes zeros, never NaN. The
// int8 form dequantizes per page: JAX multiplies K and V by the page's
// scale before the products; here a token's score takes its own page's
// k_scale and its probability its own page's v_scale (the same function,
// one multiply per token instead of one per element).
//
// Bound on an H100: memory. Decode reads every valid cached token's K and
// V row once and does 4*D operations per (token, query head) against them:
// bytes = 2*sum(lengths)*Hkv*D*sizeof(KV) (+ 8 bytes of scales per int8
// page and head read) + q + out + tables + lengths, at 3.35 TB/s, while
// the arithmetic intensity (about g operations per byte, 2g for int8) is
// two orders of magnitude under the card's ridge point: no tensor cores.
// What matters is the bytes in flight on each SM.
//
// Design: grid (kv head, row, chunk), 128 threads. A chunk is `ppc` pages
// (the wrapper's ops/decode_attention.py `paged_chunk_pages`: the most
// pages whose K and V rows take at most 32 KB of shared memory, 2 at page
// 32 and D 128 in bf16, 4 in int8), so that a long row is read by several
// SMs at once, where one CTA per (row, kv head) walked a row's pages in
// order while most SMs sat idle. The chunk axis is the slowest, and is cut
// to kGridCtas CTAs a launch: a CTA then takes every n_z-th chunk of its
// row (a batch of short rows would otherwise launch a CTA for every chunk
// of its block table, each finding its chunk past the length).
//   1. Loads. Lane s of warp 0 reads the table entry of the chunk's page s;
//      a page with an entry >= 0 and nv > 0 rows before the length comes in
//      by one bulk async copy of those nv contiguous rows per operand
//      (`cp.async.bulk` with an mbarrier, no tensor map) into the page's
//      own slot of shared memory. K's copies complete on one barrier and
//      V's on another, so the scores start when K has landed while V is
//      still in flight. A row's first chunk (live unless the row is empty)
//      starts its whole pages before the length is known, so a decode
//      tick's one-page rows wait for one memory latency, not two; warp 1
//      reads the int8 scales and warps 2-3 q meanwhile.
//   2. Scores: lpt lanes a token (1 for a full chunk, more for a short
//      row's few tokens, summed by shuffles), a token's row read in 16-byte
//      pieces rotated by token so that neighbouring rows fall on other
//      banks, every query head of the group scored against it. The chunk's
//      softmax runs one warp a head. P V: threads across (16-byte piece,
//      token group), the token groups' partials summed through shared
//      memory laid out piece-fastest (no bank conflicts). A token that is
//      not read (a slot past its page's valid rows, or a page with entry
//      -1) scores -inf: its probability is 0 and its row is never touched.
//      int8 rows are widened by a byte permute and an add.
//   3. The combine, in the same launch. A row whose tokens fit one chunk
//      is written by that chunk's CTA: out = acc / l. Otherwise each chunk
//      writes its f32 partial (m, l, unnormalised acc) to the workspace
//      [B, H, n_chunks, D + 2] (dense_decode.cu's layout), fences, and adds
//      one to the arrival counter of its (row, kv head); the CTA that
//      brings it to the row's live-chunk count ceil(min(length, P * ps) /
//      (ppc * ps)) reads every partial after a fence, writes out = sum w_i
//      acc_i / (sum w_i l_i, or 1 where that is 0), w_i = exp(m_i - max
//      m), and resets the counter to 0, so the next call (or a CUDA graph
//      replay) starts from zero without a memset. No CTA waits on another.
// A CTA whose first chunk starts at or past min(length, P * ps) exits at
// once (the CTA of chunk 0 of a row with no live chunk writes its zeros); a
// live chunk whose pages are all -1 writes m = NEG_INF, l = 0, acc = 0 and
// arrives like any other.
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // paddle_tpu/ops/pallas/flash_attention.py NEG_INF
constexpr int kPagedThreads = 128;
constexpr int kPagedWarps = kPagedThreads / 32;
constexpr int kHeadsAtOnce = 4;  // query heads of a score pass
// CTAs a launch aims at, at most: about 1.6 waves of an H100 at five CTAs
// an SM (the register bound below). On the card a cap of 2048 took the
// decode ticks' one-page rows 30% longer, their CTAs queueing behind ones
// that only found their chunk past the length (PERF.md).
constexpr int kGridCtas = 1024;

// query heads of a P V pass: their accumulators (16 / kv_size floats a
// head) take 32 registers or fewer
__host__ __device__ constexpr int pv_heads(int kv_size) {
  return 2 * kv_size < kHeadsAtOnce ? 2 * kv_size : kHeadsAtOnce;
}

// Byte offsets of a CTA's shared memory: K's slots (their region reused
// for the P V partials), V's slots, q in f32, the scores, m and l of each
// head, the combine's m (then weight) and l of each (head, chunk), each
// slot's int8 scales, valid rows and page, two mbarriers and two flags.
struct PagedSmem {
  size_t v, q, sc, ml, cw, ks, vs, nv, page, bar, total;
};

__host__ __device__ inline PagedSmem paged_smem(int ps, int ppc, int D, int kv_size, int g,
                                                int n_chunks) {
  const int n_tg = kPagedThreads / (D * kv_size / 16);
  const size_t span = static_cast<size_t>(ppc) * ps;
  const size_t k = span * D * kv_size;
  const size_t red = static_cast<size_t>(n_tg) *
                     (min(g, pv_heads(kv_size)) * D + D * kv_size / 16) * sizeof(float);
  PagedSmem s;
  s.v = ((k > red ? k : red) + 15) & ~static_cast<size_t>(15);  // V's copies: 16-byte aligned
  s.q = s.v + k;
  s.sc = s.q + static_cast<size_t>(g) * D * sizeof(float);
  s.ml = s.sc + static_cast<size_t>(g) * span * sizeof(float);
  s.cw = s.ml + 2 * static_cast<size_t>(g) * sizeof(float);
  s.ks = s.cw + 2 * static_cast<size_t>(g) * n_chunks * sizeof(float);
  s.vs = s.ks + ppc * sizeof(float);
  s.nv = s.vs + ppc * sizeof(float);
  s.page = s.nv + ppc * sizeof(int);
  s.bar = (s.page + ppc * sizeof(int) + 7) & ~static_cast<size_t>(7);
  s.total = s.bar + 2 * sizeof(uint64_t) + 2 * sizeof(int);
  return s;
}

// the kE = 16 / sizeof(KV) elements of a 16-byte piece of a cache row as
// floats; an int8 byte b becomes the float whose bits are 0x4B000000 |
// (b ^ 0x80), which is 2^23 + 128 + b, minus 2^23 + 128: exact, with a
// byte permute and an add instead of an integer conversion
template <typename KV>
__device__ __forceinline__ void piece_f32(const KV* p, float (&f)[16 / sizeof(KV)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<KV, int8_t>::value) {
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                           raw.w ^ 0x80808080u};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      f[e] = __uint_as_float(__byte_perm(w[e / 4], 0x4B000000u, 0x7650 + e % 4)) - 8388736.f;
  } else {
    const KV* v = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int e = 0; e < 16 / static_cast<int>(sizeof(KV)); ++e) f[e] = ptt::to_f32(v[e]);
  }
}

// the weight of a chunk whose max is m, against the row's max
__device__ __forceinline__ float chunk_weight(float m, float top) { return expf(m - top); }

// kv head blockIdx.x of row blockIdx.y; the CTA takes chunks blockIdx.z,
// blockIdx.z + gridDim.z, ... of the row (gridDim.z <= n_chunks, so that a
// batch of short rows does not launch a CTA per chunk that only finds its
// chunk past the length; the chunk is the slowest axis, so every row's
// first chunk is scheduled before any second one). Page `page` of KV head
// h is the contiguous [ps, D] block at element (page * Hkv + h) * ps * D;
// for int8 pages k_scale/v_scale [n_pages, Hkv] hold its dequant scales
// (payload * scale; null for full-precision pages). D * sizeof(KV) must be
// a multiple of 16 and the caches 16-byte aligned (the wrapper checks
// both). arrivals [B, Hkv] are zero on entry and on exit.
template <typename T, typename KV>
__global__ void __launch_bounds__(kPagedThreads, 5)
    paged_split_kernel(const T* __restrict__ q, const KV* __restrict__ kc,
                       const KV* __restrict__ vc, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ tables,
                       const int* __restrict__ lengths, float* __restrict__ ws,
                       int* __restrict__ arrivals, T* __restrict__ out, int Hkv, int g, int D,
                       int ps, int P, int ppc, int n_chunks, float scale) {
  constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  constexpr int kE = 16 / sizeof(KV);  // elements of a 16-byte piece
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = ppc * ps;  // tokens of a chunk
  const int raw_length = lengths[b];
  // the first chunk's first 32 table entries, read beside the length (not
  // after it), by warp 0 for the copies and by warp 1 for the int8 scales
  const int* row_table = tables + static_cast<long long>(b) * P;
  const int n_entries = min(ppc, P - static_cast<int>(blockIdx.z) * ppc);
  const int first_page =
      warp < 2 && lane < n_entries ? row_table[blockIdx.z * ppc + lane] : -1;
  const long long head0 = (static_cast<long long>(b) * Hkv + h) * g;  // first query head

  extern __shared__ __align__(128) unsigned char smem[];
  const PagedSmem L = paged_smem(ps, ppc, D, sizeof(KV), g, n_chunks);
  KV* k_s = reinterpret_cast<KV*>(smem);          // [ppc][ps][D], slot s = page s
  float* red = reinterpret_cast<float*>(smem);    // then the P V partials
  KV* v_s = reinterpret_cast<KV*>(smem + L.v);    // [ppc][ps][D]
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);  // [g][span] scores, then probabilities
  float* ml = reinterpret_cast<float*>(smem + L.ml);  // m [g], l [g]
  float* ks_s = reinterpret_cast<float*>(smem + L.ks);  // k_scale * scale per slot
  float* vs_s = reinterpret_cast<float*>(smem + L.vs);
  int* nv_s = reinterpret_cast<int*>(smem + L.nv);      // valid rows per slot, 0 for -1
  int* pg_s = reinterpret_cast<int*>(smem + L.page);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);  // K, V
  int* flags = reinterpret_cast<int*>(smem + L.bar + 2 * sizeof(uint64_t));  // loaded, last

  // Before the length is known: the CTA of a row's first chunk, live unless
  // the row is empty, starts the whole pages of its table entries (a
  // decode tick's short rows then wait for one memory latency, not two);
  // the other warps bring in q (in f32) and the int8 scales.
  const bool early = blockIdx.z == 0 && n_entries <= 32;
  uint32_t early_bytes = 0;
  if (warp == 0) {
    if (lane == 0) {
      sm90::mbar_init(&bars[0], 1);
      sm90::mbar_init(&bars[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (early) {
      const bool take = lane < n_entries && first_page >= 0;
      early_bytes = take ? static_cast<uint32_t>(ps) * D * sizeof(KV) : 0u;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) early_bytes += __shfl_xor_sync(0xffffffffu, early_bytes, o);
      if (lane == 0 && early_bytes != 0) {
        sm90::mbar_expect_tx(&bars[0], early_bytes);
        sm90::mbar_expect_tx(&bars[1], early_bytes);
      }
      __syncwarp();
      if (take) {
        const long long at = (static_cast<long long>(first_page) * Hkv + h) * ps * D;
        sm90::bulk_load(k_s + static_cast<long long>(lane) * ps * D, kc + at,
                        ps * D * sizeof(KV), &bars[0]);
        sm90::bulk_load(v_s + static_cast<long long>(lane) * ps * D, vc + at,
                        ps * D * sizeof(KV), &bars[1]);
      }
    }
  } else if (warp == 1) {
    if (kQ8 && early && lane < n_entries && first_page >= 0) {
      ks_s[lane] = k_scale[static_cast<long long>(first_page) * Hkv + h] * scale;
      vs_s[lane] = v_scale[static_cast<long long>(first_page) * Hkv + h];
    }
  } else {
    for (int i = tid - 64; i < g * D; i += kPagedThreads - 64)
      q_s[i] = ptt::to_f32(q[head0 * D + i]);
  }

  const int length = max(0, min(raw_length, P * ps));
  const int live = (length + span - 1) / span;
  if (static_cast<int>(blockIdx.z) >= live) {
    if (blockIdx.z == 0)  // the row has no token to read
      for (int i = tid; i < g * D; i += kPagedThreads)
        out[head0 * D + i] = ptt::from_f32<T>(0.f);
    if (warp == 0 && early_bytes != 0) {  // the copies land before the CTA leaves
      sm90::mbar_wait(&bars[0], 0);
      sm90::mbar_wait(&bars[1], 0);
    }
    return;
  }

  const long long head_stride = static_cast<long long>(n_chunks) * (D + 2);
  const int pieces = D / kE;
  // pieces is a power of two at the usual head dims: a shift and a mask then
  const bool pow2 = (pieces & (pieces - 1)) == 0;
  const int p_shift = __ffs(pieces) - 1;
  const int pc = pow2 ? tid & (pieces - 1) : tid % pieces;
  const int tg = pow2 ? tid >> p_shift : tid / pieces, n_tg = kPagedThreads / pieces;
  constexpr int kPV = pv_heads(sizeof(KV));
  const int hs = min(g, kPV);
  const int red_stride = hs * D + pieces;  // a token group's partials, padded: no bank conflicts
  uint32_t phase = 0;                   // of the barriers: flips with every chunk loaded
  for (int ci = blockIdx.z, first = 1; ci < live; ci += gridDim.z, first = 0) {
    const int nt = min(span, length - ci * span);  // the chunk's tokens before the length
    const int n_slots = (nt + ps - 1) / ps;        // its pages that start before the length
    const int* table = row_table + static_cast<long long>(ci) * ppc;
    const bool started = first && early;           // its pages already on their way

    // 1. one bulk copy per page and operand, lane s of warp 0 for slot s (of
    // the rows before the length; the first chunk's whole pages started
    // above); warp 1 reads the int8 scales meanwhile
    if (warp == 0) {
      uint32_t bytes = 0;
      for (int s = lane; s < n_slots; s += 32) {
        const int page = first && s < 32 ? first_page : table[s];
        const int nv = page < 0 ? 0 : min(ps, nt - s * ps);
        nv_s[s] = nv;
        pg_s[s] = page;
        bytes += static_cast<uint32_t>(nv) * D * sizeof(KV);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
      if (started) bytes = early_bytes;
      if (lane == 0) {
        flags[0] = bytes != 0;
        if (bytes != 0 && !started) {
          sm90::mbar_expect_tx(&bars[0], bytes);
          sm90::mbar_expect_tx(&bars[1], bytes);
        }
      }
      __syncwarp();
      if (!started) {
        for (int s = lane; s < n_slots; s += 32)
          if (nv_s[s] > 0)
            sm90::bulk_load(k_s + static_cast<long long>(s) * ps * D,
                            kc + (static_cast<long long>(pg_s[s]) * Hkv + h) * ps * D,
                            nv_s[s] * D * sizeof(KV), &bars[0]);
        for (int s = lane; s < n_slots; s += 32)
          if (nv_s[s] > 0)
            sm90::bulk_load(v_s + static_cast<long long>(s) * ps * D,
                            vc + (static_cast<long long>(pg_s[s]) * Hkv + h) * ps * D,
                            nv_s[s] * D * sizeof(KV), &bars[1]);
      }
    } else if (kQ8 && warp == 1 && !started) {
      for (int s = lane; s < n_slots; s += 32) {
        const int page = first && s < 32 ? first_page : table[s];
        if (page >= 0) {
          ks_s[s] = k_scale[static_cast<long long>(page) * Hkv + h] * scale;
          vs_s[s] = v_scale[static_cast<long long>(page) * Hkv + h];
        }
      }
    }
    __syncthreads();
    // a chunk whose pages are all holes loads nothing, and still writes its
    // empty partial and arrives
    const bool loaded = flags[0] != 0;
    if (loaded) sm90::mbar_wait(&bars[0], phase);

    // 2. scores s[j, t] = q_j . k_t * scale (* the page's k_scale): lpt
    // lanes a token, lpt the most that the chunk's nt tokens leave the
    // CTA's threads (1 for a full chunk; a short row's few tokens are
    // spread over more lanes, summed by shuffles), each row read in 16-byte
    // pieces rotated by token, so that neighbouring tokens' rows fall on
    // other banks; the query heads four at a time
    int lpt_shift = 0;  // lpt = 1 << lpt_shift
    while ((1 << lpt_shift) < pieces && lpt_shift < 5 && (2 << lpt_shift) * nt <= kPagedThreads)
      ++lpt_shift;
    const int lpt = 1 << lpt_shift, sub = tid & (lpt - 1);
    for (int t0 = 0; t0 < nt; t0 += kPagedThreads >> lpt_shift) {
      const int t = t0 + (tid >> lpt_shift);
      const int s = static_cast<unsigned>(t) / static_cast<unsigned>(ps);
      const bool ok = t < nt && t - s * ps < nv_s[s];
      const float s_scale = kQ8 ? (ok ? ks_s[s] : 0.f) : scale;
      const KV* kt = k_s + t * D;
      for (int j0 = 0; j0 < g; j0 += kHeadsAtOnce) {
        float dot[kHeadsAtOnce] = {0.f, 0.f, 0.f, 0.f};
        if (ok) {
          int c = pow2 ? (t * lpt + sub) & (pieces - 1) : (t * lpt + sub) % pieces;
          for (int i = sub; i < pieces; i += lpt) {
            float kf[kE];
            piece_f32(kt + c * kE, kf);
#pragma unroll
            for (int jj = 0; jj < kHeadsAtOnce; ++jj) {
              if (j0 + jj >= g) break;
              const float4* qj = reinterpret_cast<const float4*>(q_s + (j0 + jj) * D + c * kE);
#pragma unroll
              for (int e = 0; e < kE / 4; ++e) {
                const float4 qv = qj[e];
                dot[jj] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] + qv.z * kf[4 * e + 2] +
                           qv.w * kf[4 * e + 3];
              }
            }
            c += lpt;
            if (c >= pieces) c -= pieces;
          }
        }
#pragma unroll
        for (int jj = 0; jj < kHeadsAtOnce; ++jj) {
          if (j0 + jj >= g) break;
          for (int o = lpt / 2; o > 0; o >>= 1)
            dot[jj] += __shfl_xor_sync(0xffffffffu, dot[jj], o);
          if (sub == 0 && t < nt) sc[(j0 + jj) * span + t] = ok ? dot[jj] * s_scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // the chunk's softmax, one warp a head: m, p = exp(s - m), l = sum p
    float* part0 = ws + head0 * head_stride + static_cast<long long>(ci) * (D + 2);
    for (int j = warp; j < g; j += kPagedWarps) {
      float mx = kNegInf;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, sc[j * span + t]);
      mx = ptt::warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float pr = expf(sc[j * span + t] - mx);
        sc[j * span + t] = pr;
        sum += pr;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        ml[j] = mx;
        ml[g + j] = sum;
        if (live > 1) {
          part0[j * head_stride + D] = mx;
          part0[j * head_stride + D + 1] = sum;
        }
      }
    }
    if (loaded) sm90::mbar_wait(&bars[1], phase);
    phase ^= loaded;
    __syncthreads();

    // acc[j, d] = sum_t p[j, t] (* the page's v_scale) v[t, d]: thread
    // (token group tg, piece pc), over each slot's valid rows
    for (int j0 = 0; j0 < g; j0 += kPV) {
      float a[kPV][kE];
#pragma unroll
      for (int jj = 0; jj < kPV; ++jj)
#pragma unroll
        for (int e = 0; e < kE; ++e) a[jj][e] = 0.f;
      if (tg < n_tg) {
        for (int s = 0; s < n_slots; ++s) {
          const float vsc = kQ8 ? vs_s[s] : 1.f;
          for (int r = tg; r < nv_s[s]; r += n_tg) {
            const int t = s * ps + r;
            float vf[kE];
            piece_f32(v_s + t * D + pc * kE, vf);
#pragma unroll
            for (int jj = 0; jj < kPV; ++jj) {
              if (j0 + jj >= g) break;
              const float pr = kQ8 ? sc[(j0 + jj) * span + t] * vsc : sc[(j0 + jj) * span + t];
#pragma unroll
              for (int e = 0; e < kE; ++e) a[jj][e] += pr * vf[e];
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < kPV; ++jj) {
          if (j0 + jj >= g) break;
#pragma unroll
          for (int e = 0; e < kE; ++e)
            red[tg * red_stride + (jj * kE + e) * pieces + pc] = a[jj][e];
        }
      }
      __syncthreads();
      const int nj = min(kPV, g - j0);
      for (int i = tid; i < nj * D; i += kPagedThreads) {  // i = (jj, e, pc)
        const int jj = i / D, r = i - jj * D;
        const int e = pow2 ? r >> p_shift : r / pieces, d = (r - e * pieces) * kE + e;
        float acc = 0.f;
#pragma unroll 4
        for (int u = 0; u < n_tg; ++u) acc += red[u * red_stride + i];
        if (live == 1) {  // the row's only chunk: out = acc / l
          const float l = ml[g + j0 + jj];
          out[(head0 + j0 + jj) * D + d] = ptt::from_f32<T>(acc / (l == 0.f ? 1.f : l));
        } else {
          part0[(j0 + jj) * head_stride + d] = acc;
        }
      }
      if (live == 1 && j0 + kPV >= g) return;  // the row is written
      // the next pass overwrites red, the next chunk's copies K and V: this
      // chunk's reads and writes of them (the generic proxy) come first
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }

    // 3. arrive; the last chunk of the (row, kv head) to arrive combines.
    // A CTA's own later chunk has not arrived before its earlier one, so
    // the last arrival is its last chunk.
    __threadfence();  // this chunk's partial is visible before its arrival
    __syncthreads();
    int* arrived = arrivals + static_cast<long long>(b) * Hkv + h;
    if (tid == 0) flags[1] = atomicAdd(arrived, 1) == live - 1;
    __syncthreads();
    if (!flags[1]) continue;
    __threadfence();  // every other chunk's partial is read after its arrival
    if (tid == 0) *arrived = 0;  // all live chunks are in: ready for the next call

    // every live chunk's m and l of the group's heads, read at once
    const float* w = ws + head0 * head_stride;
    float* cw = reinterpret_cast<float*>(smem + L.cw);  // [g][n_chunks]: m, then the weight
    float* cl = cw + g * n_chunks;                      // [g][n_chunks]: l
    for (int i = tid; i < g * live; i += kPagedThreads) {
      const int j = i / live, c = i - j * live;
      cw[j * n_chunks + c] = __ldcg(w + j * head_stride + c * (D + 2) + D);
      cl[j * n_chunks + c] = __ldcg(w + j * head_stride + c * (D + 2) + D + 1);
    }
    __syncthreads();
    // a warp a head: M = max m, w_c = exp(m_c - M), L = sum w_c l_c
    for (int j = warp; j < g; j += kPagedWarps) {
      float top = kNegInf;
      for (int c = lane; c < live; c += 32) top = fmaxf(top, cw[j * n_chunks + c]);
      top = ptt::warp_max(top);
      float l = 0.f;
      for (int c = lane; c < live; c += 32) {
        const float wc = chunk_weight(cw[j * n_chunks + c], top);
        cw[j * n_chunks + c] = wc;
        l += wc * cl[j * n_chunks + c];
      }
      l = ptt::warp_sum(l);
      if (lane == 0) ml[g + j] = l;
    }
    __syncthreads();
    // out = sum w_c acc_c / (L, or 1 where that is 0)
    for (int i = tid; i < g * D; i += kPagedThreads) {
      const int j = i / D, d = i - j * D;
      const float* wj = w + j * head_stride + d;
      float acc = 0.f;
#pragma unroll 4
      for (int c = 0; c < live; ++c) acc += cw[j * n_chunks + c] * __ldcg(wj + c * (D + 2));
      const float l = ml[g + j];
      out[(head0 + j) * D + d] = ptt::from_f32<T>(acc / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, typename KV>
cudaError_t launch_paged(const void* q, const void* kc, const void* vc, const void* k_scale,
                         const void* v_scale, const void* tables, const void* lengths, void* ws,
                         void* arrivals, void* out, int B, int Hkv, int g, int D, int ps, int P,
                         int ppc, float scale, cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(KV);
  if (D < kE || D % kE || D / kE > kPagedThreads || ps < 1 || ppc < 1)
    return cudaErrorInvalidValue;
  const int n_chunks = P > ppc ? (P + ppc - 1) / ppc : 1;
  // CTAs a (row, kv head): every chunk its own CTA, unless the grid would
  // pass kGridCtas; then each takes every n_z-th chunk
  const int n_z = max(1, min(n_chunks, kGridCtas / max(1, B * Hkv)));
  const size_t smem = paged_smem(ps, ppc, D, sizeof(KV), g, n_chunks).total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_split_kernel<T, KV><<<dim3(Hkv, B, n_z), kPagedThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kc), static_cast<const KV*>(vc),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(lengths), static_cast<float*>(ws),
      static_cast<int*>(arrivals), static_cast<T*>(out), Hkv, g, D, ps, P, ppc, n_chunks, scale);
  return cudaGetLastError();
}

}  // namespace

// Paged full-precision decode. q [B, Hkv*g, D]; kc, vc [n_pages, Hkv, ps, D]
// of q's type (code `dtype`); tables int32 [B, P]; lengths int32 [B]
// (valid tokens including the current one); ws f32 [B, Hkv*g,
// max(1, ceil(P / ppc)), D + 2], the partials; arrivals int32 [B * Hkv],
// zero on entry and left zero; out like q. All contiguous; D * sizeof(T)
// a multiple of 16 and at most 2 KB; ppc pages a chunk. Returns
// cudaGetLastError() after the launch.
extern "C" int ptt_paged_decode_attention(const void* q, const void* kc, const void* vc,
                                          const void* tables, const void* lengths, void* ws,
                                          void* arrivals, void* out, int B, int Hkv, int g,
                                          int D, int ps, int P, int ppc, float scale, int dtype,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_paged<float, float>(q, kc, vc, nullptr, nullptr, tables, lengths, ws,
                                        arrivals, out, B, Hkv, g, D, ps, P, ppc, scale, s);
    case ptt::kBF16:
      return launch_paged<__nv_bfloat16, __nv_bfloat16>(q, kc, vc, nullptr, nullptr, tables,
                                                        lengths, ws, arrivals, out, B, Hkv, g,
                                                        D, ps, P, ppc, scale, s);
    case ptt::kF16:
      return launch_paged<__half, __half>(q, kc, vc, nullptr, nullptr, tables, lengths, ws,
                                          arrivals, out, B, Hkv, g, D, ps, P, ppc, scale, s);
  }
  return cudaErrorInvalidValue;
}

// Paged int8 decode. q [B, Hkv*g, D] (f32, bf16 or f16, code `dtype`);
// kc, vc int8 [n_pages, Hkv, ps, D]; k_scale, v_scale f32 [n_pages, Hkv];
// tables, lengths, ws, arrivals and out as above. All contiguous; D a
// multiple of 16 and at most 2048. Returns cudaGetLastError() after the
// launch.
extern "C" int ptt_paged_decode_attention_q8(const void* q, const void* kc, const void* vc,
                                             const void* k_scale, const void* v_scale,
                                             const void* tables, const void* lengths, void* ws,
                                             void* arrivals, void* out, int B, int Hkv, int g,
                                             int D, int ps, int P, int ppc, float scale,
                                             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_paged<float, int8_t>(q, kc, vc, k_scale, v_scale, tables, lengths, ws,
                                         arrivals, out, B, Hkv, g, D, ps, P, ppc, scale, s);
    case ptt::kBF16:
      return launch_paged<__nv_bfloat16, int8_t>(q, kc, vc, k_scale, v_scale, tables, lengths,
                                                 ws, arrivals, out, B, Hkv, g, D, ps, P, ppc,
                                                 scale, s);
    case ptt::kF16:
      return launch_paged<__half, int8_t>(q, kc, vc, k_scale, v_scale, tables, lengths, ws,
                                          arrivals, out, B, Hkv, g, D, ps, P, ppc, scale, s);
  }
  return cudaErrorInvalidValue;
}
