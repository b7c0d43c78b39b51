// Varlen (packed-sequence) attention forward, dQ and dK/dV for Hopper
// (sm_90a).
//
// Replaces the varlen kernels of paddle_tpu/ops/pallas/masked_flash.py:
//   - `_vl_fwd_kernel` :442 (pallas_call :616, entry
//     `varlen_flash_attention_fwd` :758): O and the f32 row LSE of
//     softmax(Q K^T * scale) V over the pairs `_vl_keep` :428 keeps;
//   - `_vl_bwd_dq_kernel` :490 (pallas_call :680): dQ = dS K;
//   - `_vl_bwd_dkv_kernel` :529 (pallas_call :695): dV = P^T dO and
//     dK = dS^T Q, of the kv heads (the g query heads of a kv head summed,
//     as `_varlen_vjp_bwd` does at :719-721).
// q [Tq, H, D] and k/v [Tk, Hkv, D] hold packed documents; the wrapper
// (ops/masked_flash.py) derives each token's segment from cu_seqlens as the
// JAX entry does (:765-769). Query row r keeps key c iff both lie in the
// same segment s and, when causal, pos_q >= pos_k, i.e. r - cu_q[s] >=
// c - cu_k[s]: causal is top-left within each segment, also when a q
// segment and its k segment differ in length. A row that keeps no key (its
// k segment is empty) gets zeros and LSE = +inf, so its gradients are
// exactly 0 (the JAX kernel gives O = 0 and zero gradients there too).
//
// Packed [T, H, D] is the B = 1 case of the kernels' [B, S, H, D]
// strides, so the kernels are the port's shared attention kernels under
// the policy `Varlen` below. Which kernel runs which dtype:
//   - bfloat16 and float16: the forward of flash_fwd_sm90.cuh and the dQ and dK/dV of
//     flash_bwd_sm90.cuh (wgmma fed by TMA, 128 x 128 tiles; the [1, T, H,
//     D] view is a 4-d tensor map, so nothing is copied); dK/dV come out
//     as the kv heads' f32 [Tk, Hkv, D];
//   - float32: the CUDA-core tile kernels of flash_tiles.cuh; dK/dV one
//     f32 slice per query head [Tk, H, D], which the caller sums.
// Numerics: the bf16 backward rounds P and dS to bf16 before its second
// and third products (dV = P^T dO, dK = dS^T Q, dQ = dS K); every sum is
// f32. The JAX varlen kernels keep P and dS in f32 (masked_flash.py
// :506-521, :546-566), while JAX's flashmask kernel casts dS to k's dtype
// (:172): the port's bf16 varlen gradients differ from the JAX varlen
// kernel's by that rounding.
// Bound at the main path (a pack of 8192 tokens in LLaMA-7B heads, 32 query
// heads over 8 kv heads of 128, causal): operations, counted over the
// pairs the segments keep; forward 4 D, dQ 6 D, dK/dV 8 D operations a
// pair at 989 TFLOP/s (bf16): 0.187, 0.280 and 0.374 ms.
//
// Design against the TPU kernels: they walk every (q block, kv block) of
// the pack and guard their matmuls with `jnp.any(keep)`, so a q block of an
// 8192-token pack visits all 128 kv blocks, and dK/dV is written per query
// head. Here every bf16 kernel reads a class per (128-row q tile, 128-key
// kv tile) that `varlen_classes_kernel`, launched by the forward's entry
// just before it, derives from per-kv-tile min/max of the keys' segment
// ranges (the same rule in torch ops is ops/masked_flash.py
// `varlen_tile_classes_plain`); the backward reuses the forward's table.
// A tile no row of the q tile can see is skipped (never loaded), a tile
// every row sees whole runs no predicate, a tile across a document edge or
// on a causal diagonal applies keep() to its score fragment. The forward
// and dQ loops end at the last key of the q tile's 64-row `qrange`s; a
// dK/dV CTA (128 keys of one kv head) walks the 64-row q steps from its
// first key's first q row to the largest `krange` end of its two 64-key
// halves, for each of the g query heads, and writes the kv head's dK and
// dV once, with no atomics; the dK/dV CTAs launch in the order
// `varlen_dkv_order_kernel` derives from the classes, the key tiles with
// the most q tiles not skipped first. The float32 kernels give each 64-row q tile
// the key range of the segments it touches (from the first key of its
// first segment to, causal, the last key its last row can see) and each
// key tile the q-row range of its segments, loop over that range only,
// and inside it skip a tile with no kept pair by a CTA-wide vote. Each key
// carries its segment's q-row range and the offset cu_q - cu_k, so the
// keep test needs no per-row data.
#include <climits>

#include "flash_bwd_sm90.cuh"

namespace {

struct Varlen {
  static constexpr bool kVote = true;
  const int* kinfo;   // [3, Skv]: per key its segment's first q row, one past
                      // its last q row, and cu_q[s] - cu_k[s]
  const int* qrange;  // [2, n q tiles]: per q tile, first key, one past last
  const int* krange;  // [2, n k tiles]: per key tile, first q row, one past last
  int n_qt, n_kt;     // 64-row q tiles, 64-key k tiles
  // the sm90 kernels' tile classes, [ceil(Tq / 128), ceil(Tk / 128)]
  // uint8 (null for the float32 kernels)
  const uint8_t* cls;
  int n_ct;           // 128-key kv tiles
  // the sm90 dK/dV's CTA order, [n_ct] int32 (`varlen_dkv_order_kernel`;
  // null elsewhere)
  const int* order;

  struct Key {
    int lo, hi, off;
  };

  __device__ __forceinline__ Key key(const Problem& p, int, int, int col) const {
    if (col >= p.Skv) return {0, 0, 0};
    return {kinfo[col], kinfo[p.Skv + col], kinfo[2 * p.Skv + col]};
  }
  __device__ __forceinline__ bool keep(const Problem& p, int row, int col, const Key& k) const {
    return row >= k.lo && row < k.hi && (!p.causal || row >= col + k.off);
  }
  __device__ __forceinline__ float bias(const Key&) const { return 0.f; }
  __device__ __forceinline__ bool has_bias() const { return false; }
  __device__ __forceinline__ int first_kv_tile(const Problem&, int q0) const {
    return qrange[q0 / kTile] / kTile;
  }
  __device__ __forceinline__ int kv_tiles(const Problem&, int q0) const {
    return (qrange[n_qt + q0 / kTile] + kTile - 1) / kTile;
  }
  // the sm90 forward and dQ: the kv tiles of bn keys up to the last key
  // that the 64-row tiles of the q tile [q0, q0 + bm) visit; those before
  // their first key are skipped by their class
  __device__ __forceinline__ int kv_tiles(const Problem&, int q0, int bm, int bn) const {
    int end = 0;
    for (int t = q0 / kTile; t < min((q0 + bm) / kTile, n_qt); ++t)
      end = max(end, qrange[n_qt + t]);
    return (end + bn - 1) / bn;
  }
  __device__ __forceinline__ int tile_class(const Problem&, int, int, int q0, int k0, int bm,
                                            int bn) const {
    const int c = cls[(q0 / bm) * n_ct + k0 / bn];
    return c;
  }
  // The first 64-row q tile that sees the 64-key tile at k0. The sm90
  // dK/dV reads it for a CTA of 128 keys (k0) and for each warpgroup's 64
  // (key0 = k0 + 64): segments are in order, so a later key's first row
  // is never earlier, and the first 64 keys' first row is the CTA's.
  __device__ __forceinline__ int first_q_tile(const Problem&, int k0) const {
    return krange[k0 / kTile] / kTile;
  }
  __device__ __forceinline__ int q_tiles(const Problem&, int k0) const {
    return (krange[n_kt + k0 / kTile] + kTile - 1) / kTile;
  }
  // the sm90 dK/dV: the 64-row q tiles up to the last row that sees any
  // key of [k0, k0 + bn), the largest `krange` end of its 64-key tiles (a
  // document that starts in the second half is seen by rows past the
  // first half's end)
  __device__ __forceinline__ int q_tiles(const Problem&, int k0, int bn) const {
    int end = 0;
    for (int t = k0 / kTile; t < min((k0 + bn) / kTile, n_kt); ++t)
      end = max(end, krange[n_kt + t]);
    return (end + kTile - 1) / kTile;
  }
  __device__ __forceinline__ int key_tile(int z) const { return order[z]; }
};

Varlen make_varlen(const void* kinfo, const void* qrange, const void* krange, int Tq, int Tk,
                   const void* cls = nullptr, const void* order = nullptr) {
  return Varlen{static_cast<const int*>(kinfo), static_cast<const int*>(qrange),
                static_cast<const int*>(krange), (Tq + kTile - 1) / kTile,
                (Tk + kTile - 1) / kTile, static_cast<const uint8_t*>(cls),
                (Tk + sm90::kBN - 1) / sm90::kBN, static_cast<const int*>(order)};
}

// The class of each (kBM-row q tile, kBN-key kv tile) of a pack, one
// block of kBN threads a kv tile: the min and max over the tile's keys of
// their segment's first q row (lo), one past its last (hi) and, causal,
// the first row that sees them (c + off), then for each q tile's rows
// [r0, r1), r1 clamped to Tq: skipped where r1 <= min lo, r0 >= max hi or
// (causal) r1 - 1 < min(c + off); full where max lo <= r0, r1 <= min hi,
// (causal) r0 >= max(c + off) and no key of the tile is past Tk; partial
// otherwise. cls [ceil(Tq / kBM), gridDim.x] uint8.
__global__ void __launch_bounds__(sm90::kBN)
varlen_classes_kernel(const int* __restrict__ kinfo, uint8_t* __restrict__ cls, int Tq, int Tk,
                      int causal) {
  constexpr int kWarps = sm90::kBN / 32;
  __shared__ int red[6][kWarps];
  const int c = blockIdx.x * sm90::kBN + threadIdx.x;
  // min lo, min hi, min first row, then the negated maxima
  int v[6] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  if (c < Tk) {
    const int lo = kinfo[c], hi = kinfo[Tk + c], first = c + kinfo[2 * Tk + c];
    v[0] = lo, v[1] = hi, v[2] = first, v[3] = -lo, v[4] = -hi, v[5] = -first;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int m = __reduce_min_sync(0xffffffffu, v[i]);
    if (threadIdx.x % 32 == 0) red[i][threadIdx.x / 32] = m;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    v[i] = red[i][0];
    for (int w = 1; w < kWarps; ++w) v[i] = min(v[i], red[i][w]);
  }
  const int lo_min = v[0], hi_min = v[1], first_min = v[2];
  const int lo_max = -v[3], hi_max = -v[4], first_max = -v[5];
  const bool pad = (blockIdx.x + 1) * sm90::kBN > Tk;
  const int nq = (Tq + sm90::kBM - 1) / sm90::kBM;
  for (int t = threadIdx.x; t < nq; t += blockDim.x) {
    const int r0 = t * sm90::kBM, r1 = min(r0 + sm90::kBM, Tq);
    bool skip = r1 <= lo_min || r0 >= hi_max;
    bool full = lo_max <= r0 && r1 <= hi_min && !pad;
    if (causal) {
      skip = skip || r1 - 1 < first_min;
      full = full && r0 >= first_max;
    }
    cls[static_cast<long long>(t) * gridDim.x + blockIdx.x] =
        skip ? kSkipTile : (full ? kFullTile : kPartialTile);
  }
}

// The order of the sm90 dK/dV's CTAs: the kv tiles by their count of q
// tiles that the classes cls [n_qt, n_ct] do not skip, most first, ties by
// index. A CTA's time grows with that count (the first key tiles of a long
// document see all its rows), so the longest CTAs start first and the
// short ones fill the last wave. One block; work in shared memory.
constexpr int kOrderThreads = 1024;
__global__ void __launch_bounds__(kOrderThreads)
varlen_dkv_order_kernel(const uint8_t* __restrict__ cls, int* __restrict__ order, int n_qt,
                        int n_ct) {
  extern __shared__ int work[];  // [n_ct]
  for (int t = threadIdx.x; t < n_ct; t += blockDim.x) {
    int n = 0;
    for (int i = 0; i < n_qt; ++i) n += cls[static_cast<long long>(i) * n_ct + t] != kSkipTile;
    work[t] = n;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_ct; t += blockDim.x) {
    int rank = 0;
    for (int u = 0; u < n_ct; ++u) rank += work[u] > work[t] || (work[u] == work[t] && u < t);
    order[rank] = t;
  }
}

cudaError_t launch_classes(const void* kinfo, void* cls, int Tq, int Tk, int causal,
                           cudaStream_t stream) {
  const int nk = (Tk + sm90::kBN - 1) / sm90::kBN;
  if (Tq <= 0 || nk == 0) return cudaSuccess;
  varlen_classes_kernel<<<nk, sm90::kBN, 0, stream>>>(static_cast<const int*>(kinfo),
                                                      static_cast<uint8_t*>(cls), Tq, Tk, causal);
  return cudaGetLastError();
}

}  // namespace

// kinfo [3, Tk] int32 contiguous (see `Varlen`); writes cls
// [ceil(Tq / 128), ceil(Tk / 128)] uint8 contiguous, the `TileClass` of
// each tile of the bf16 forward (what ptt_varlen_fwd derives before it
// runs). Returns cudaGetLastError() after the launch.
extern "C" int ptt_varlen_tile_classes(const void* kinfo, void* cls, int Tq, int Tk,
                                       int causal, void* stream) {
  return launch_classes(kinfo, cls, Tq, Tk, causal, static_cast<cudaStream_t>(stream));
}

// q [Tq, H, D], k/v [Tk, Hkv, D] in one dtype (float32, bfloat16 or float16) with
// unit d stride and D <= 192; `strides` holds 12 element strides: (b, s, h)
// of q, k, v and dO (here a copy of q's), b unused (B = 1). kinfo [3, Tk],
// qrange [2, ceil(Tq / 64)] and krange [2, ceil(Tk / 64)] int32 contiguous
// (see `Varlen`). bfloat16 and float16 write the tile classes into cls
// [ceil(Tq / 128), ceil(Tk / 128)] uint8 contiguous (as
// ptt_varlen_tile_classes) and runs the sm90 forward on them (q, k, v as
// run_fwd_sm90 takes them); float32 ignores cls. out
// [Tq, H, D] contiguous in q's dtype; lse [H, Tq] f32. Returns
// cudaGetLastError() after the launches, or the error of a tensor map's
// encode.
extern "C" int ptt_varlen_fwd(const void* q, const void* k, const void* v, const void* kinfo,
                              const void* qrange, const void* krange, void* cls,
                              void* out, void* lse, int H, int Hkv, int Tq, int Tk, int D,
                              const long long* strides, float scale, int causal, int dtype,
                              void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, 1, H, Hkv, Tq, Tk, D, scale, causal, strides, q, k, v,
                                 nullptr);
  if (dtype != ptt::kF32) {
    if (cls == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = launch_classes(kinfo, cls, Tq, Tk, causal,
                                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return run_fwd_sm90(dtype, p, make_varlen(kinfo, qrange, krange, Tq, Tk, cls), q, k, v, out, lse,
                        stream);
  }
  return run_fwd_f32(p, make_varlen(kinfo, qrange, krange, Tq, Tk), q, k, v, out, lse, stream);
}

// As ptt_varlen_fwd, plus dout (strided like q, strides 9..11; in
// 16 bits as run_fwd_sm90 takes q), lse and delta = rowsum(dO * O)
// [H, Tq] f32, and (16-bit) the forward's tile classes cls
// [ceil(Tq / 128), ceil(Tk / 128)] uint8 contiguous; writes dq
// [Tq, H, D] contiguous in q's dtype.
extern "C" int ptt_varlen_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* kinfo, const void* qrange, const void* krange,
                                 const void* cls, const void* dout, const void* lse,
                                 const void* delta, void* dq, int H, int Hkv, int Tq, int Tk,
                                 int D, const long long* strides, float scale, int causal,
                                 int dtype, void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, 1, H, Hkv, Tq, Tk, D, scale, causal, strides, q, k, v,
                                 dout);
  if (dtype != ptt::kF32) {
    if (cls == nullptr) return cudaErrorInvalidValue;
    return run_bwd_sm90(dtype, p, make_varlen(kinfo, qrange, krange, Tq, Tk, cls), q, k, v, dout, lse,
                        delta, dq, nullptr, nullptr, stream);
  }
  return run_dq(dtype, p, make_varlen(kinfo, qrange, krange, Tq, Tk), q, k, v, dout, lse,
                delta, dq, stream);
}

// As ptt_varlen_bwd_dq, plus (16-bit) order, an int32 [ceil(Tk / 128)]
// workspace the entry fills with the dK/dV CTAs' order
// (`varlen_dkv_order_kernel`) before the dK/dV kernel reads it; writes dk,
// dv contiguous f32: in 16 bits the kv heads' gradients [Tk, Hkv, D], in
// float32 one slice per query head [Tk, H, D] (the caller sums the g heads
// of a kv head).
extern "C" int ptt_varlen_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* kinfo, const void* qrange, const void* krange,
                                  const void* cls, void* order, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int H,
                                  int Hkv, int Tq, int Tk, int D, const long long* strides,
                                  float scale, int causal, int dtype, void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, 1, H, Hkv, Tq, Tk, D, scale, causal, strides, q, k, v,
                                 dout);
  if (dtype != ptt::kF32) {
    if (cls == nullptr || order == nullptr) return cudaErrorInvalidValue;
    const int n_qt = (Tq + sm90::kBM - 1) / sm90::kBM, n_ct = (Tk + sm90::kBN - 1) / sm90::kBN;
    const cudaError_t err = launch(varlen_dkv_order_kernel, dim3(1), kOrderThreads,
                                   n_ct * sizeof(int), static_cast<cudaStream_t>(stream),
                                   static_cast<const uint8_t*>(cls), static_cast<int*>(order),
                                   n_qt, n_ct);
    if (err != cudaSuccess) return err;
    return run_bwd_sm90(dtype, p, make_varlen(kinfo, qrange, krange, Tq, Tk, cls, order), q, k, v,
                        dout, lse, delta, nullptr, dk, dv, stream);
  }
  return run_dkv(dtype, p, make_varlen(kinfo, qrange, krange, Tq, Tk), q, k, v, dout, lse,
                 delta, dk, dv, stream);
}
