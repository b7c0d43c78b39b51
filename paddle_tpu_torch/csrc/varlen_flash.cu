// Varlen (packed-sequence) attention forward, dQ and dK/dV for Hopper
// (sm_90a).
//
// Replaces the varlen kernels of paddle_tpu/ops/pallas/masked_flash.py:
//   - `_vl_fwd_kernel` :442 (pallas_call :616, entry
//     `varlen_flash_attention_fwd` :758): O and the f32 row LSE of
//     softmax(Q K^T * scale) V over the pairs `_vl_keep` :428 keeps;
//   - `_vl_bwd_dq_kernel` :490 (pallas_call :680): dQ;
//   - `_vl_bwd_dkv_kernel` :529 (pallas_call :695): dK, dV per query head
//     in f32 (the caller group-sums them for GQA, :719-721).
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
// the policy `Varlen` below: the bfloat16 forward is flash_fwd_sm90.cuh's
// (wgmma fed by TMA, 128 x 128 tiles: the [1, T, H, D] view is a 4-d
// tensor map, so nothing is copied), the float32 forward and both
// backwards flash_tiles.cuh's (CUDA cores in float32, WMMA in bfloat16).
// Bound at the main path (a pack of 8192 tokens in LLaMA-7B heads, 32 query
// heads over 8 kv heads of 128, causal): operations, counted over the
// pairs the segments keep; forward 4 D, dQ 6 D, dK/dV 8 D operations a
// pair at 989 TFLOP/s (bf16): 0.187 ms for the forward.
//
// Design against the TPU kernel: the TPU kernel walks every (q block, kv
// block) of the pack and guards its matmuls with `jnp.any(keep)`, so a q
// block of an 8192-token pack visits all 128 kv blocks. Here the bf16
// forward reads a class per (128-row q tile, 128-key kv tile) that
// `varlen_classes_kernel`, launched just before it by the same entry,
// derives from per-kv-tile min/max of the keys' segment ranges (the same
// rule in torch ops is ops/masked_flash.py `varlen_tile_classes_plain`):
// a tile no row of the q tile can see is skipped (never loaded), a tile
// every row sees whole runs no predicate, a tile across a document edge or
// on a causal diagonal applies keep() to its score fragment. Its loop ends at
// the last key of the q tile's 64-row `qrange`s. The float32 forward and
// the WMMA backward give each 64-row q tile the key range of the segments
// it touches (from the first key of its first segment to, causal, the last
// key its last row can see) and each key tile the q-row range of its
// segments, loop over that range only, and inside it skip a tile with no
// kept pair by a CTA-wide vote. Each key carries its segment's q-row range
// and the offset cu_q - cu_k, so the keep test needs no per-row data.
#include <climits>

#include "flash_fwd_sm90.cuh"

namespace {

struct Varlen {
  static constexpr bool kVote = true;
  const int* kinfo;   // [3, Skv]: per key its segment's first q row, one past
                      // its last q row, and cu_q[s] - cu_k[s]
  const int* qrange;  // [2, n q tiles]: per q tile, first key, one past last
  const int* krange;  // [2, n k tiles]: per key tile, first q row, one past last
  int n_qt, n_kt;     // 64-row q tiles, 64-key k tiles
  // the sm90 forward's tile classes, [ceil(Tq / 128), ceil(Tk / 128)]
  // uint8 (null for the float32 and backward kernels)
  const uint8_t* cls;
  int n_ct;           // 128-key kv tiles

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
  // the sm90 forward: the kv tiles of bn keys up to the last key that the
  // 64-row tiles of the q tile [q0, q0 + bm) visit; those before their
  // first key are skipped by their class
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
  __device__ __forceinline__ int first_q_tile(const Problem&, int k0) const {
    return krange[k0 / kTile] / kTile;
  }
  __device__ __forceinline__ int q_tiles(const Problem&, int k0) const {
    return (krange[n_kt + k0 / kTile] + kTile - 1) / kTile;
  }
};

Varlen make_varlen(const void* kinfo, const void* qrange, const void* krange, int Tq, int Tk,
                   const void* cls = nullptr) {
  return Varlen{static_cast<const int*>(kinfo), static_cast<const int*>(qrange),
                static_cast<const int*>(krange), (Tq + kTile - 1) / kTile,
                (Tk + kTile - 1) / kTile, static_cast<const uint8_t*>(cls),
                (Tk + sm90::kBN - 1) / sm90::kBN};
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

// q [Tq, H, D], k/v [Tk, Hkv, D] in one dtype (float32 or bfloat16) with
// unit d stride and D <= 128; `strides` holds 12 element strides: (b, s, h)
// of q, k, v and dO (here a copy of q's), b unused (B = 1). kinfo [3, Tk],
// qrange [2, ceil(Tq / 64)] and krange [2, ceil(Tk / 64)] int32 contiguous
// (see `Varlen`). bfloat16 writes the tile classes into cls
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
  if (dtype == ptt::kBF16) {
    if (cls == nullptr) return cudaErrorInvalidValue;
    const cudaError_t err = launch_classes(kinfo, cls, Tq, Tk, causal,
                                           static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return run_fwd_sm90(p, make_varlen(kinfo, qrange, krange, Tq, Tk, cls), q, k, v, out, lse,
                        stream);
  }
  return run_fwd_f32(p, make_varlen(kinfo, qrange, krange, Tq, Tk), q, k, v, out, lse, stream);
}

// As ptt_varlen_fwd, plus dout (strided like q, strides 9..11), lse and
// delta = rowsum(dO * O) [H, Tq] f32; writes dq [Tq, H, D] contiguous in
// q's dtype.
extern "C" int ptt_varlen_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* kinfo, const void* qrange, const void* krange,
                                 const void* dout, const void* lse, const void* delta, void* dq,
                                 int H, int Hkv, int Tq, int Tk, int D,
                                 const long long* strides, float scale, int causal, int dtype,
                                 void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, 1, H, Hkv, Tq, Tk, D, scale, causal, strides, q, k, v,
                                 dout);
  return run_dq(dtype, p, make_varlen(kinfo, qrange, krange, Tq, Tk), q, k, v, dout, lse,
                delta, dq, stream);
}

// As ptt_varlen_bwd_dq; writes dk, dv [Tk, H, D] contiguous f32, one slice
// per query head (the caller sums the g heads of a kv head).
extern "C" int ptt_varlen_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* kinfo, const void* qrange, const void* krange,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int H, int Hkv, int Tq, int Tk, int D,
                                  const long long* strides, float scale, int causal,
                                  int dtype, void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, 1, H, Hkv, Tq, Tk, D, scale, causal, strides, q, k, v,
                                 dout);
  return run_dkv(dtype, p, make_varlen(kinfo, qrange, krange, Tq, Tk), q, k, v, dout, lse,
                 delta, dk, dv, stream);
}
