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
// Packed [T, H, D] is the B = 1 case of the tile kernels' [B, S, H, D]
// strides, so the kernels are those of flash_tiles.cuh (bf16 tensor-core
// and f32 CUDA-core forms described there) under the policy `Varlen` below,
// and nothing is copied or padded. Bound at the main path (a pack of 8192
// tokens in LLaMA-7B heads, 32 query heads over 8 kv heads of 128, causal):
// operations, counted over the pairs the segments keep; forward 4 D, dQ
// 6 D, dK/dV 8 D operations a pair at 989 TFLOP/s (bf16).
//
// Design against the TPU kernel: the TPU kernel walks every (q block, kv
// block) of the pack and guards its matmuls with `jnp.any(keep)`, so a q
// block of an 8192-token pack visits all 128 kv blocks. Here the wrapper
// gives each 64-row q tile the key range of the segments it touches (from
// the first key of its first segment to, causal, the last key its last row
// can see) and each key tile the q-row range of its segments, and the
// kernels loop over that range only; inside it a CTA-wide vote skips a
// tile with no kept pair (segment edges, above a segment's diagonal).
// Each key carries its segment's q-row range and the offset cu_q - cu_k,
// so the keep test needs no per-row data.
#include "flash_tiles.cuh"

namespace {

struct Varlen {
  static constexpr bool kVote = true;
  const int* kinfo;   // [3, Skv]: per key its segment's first q row, one past
                      // its last q row, and cu_q[s] - cu_k[s]
  const int* qrange;  // [2, n q tiles]: per q tile, first key, one past last
  const int* krange;  // [2, n k tiles]: per key tile, first q row, one past last
  int n_qt, n_kt;

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
  __device__ __forceinline__ int first_kv_tile(const Problem&, int q0) const {
    return qrange[q0 / kTile] / kTile;
  }
  __device__ __forceinline__ int kv_tiles(const Problem&, int q0) const {
    return (qrange[n_qt + q0 / kTile] + kTile - 1) / kTile;
  }
  __device__ __forceinline__ int first_q_tile(const Problem&, int k0) const {
    return krange[k0 / kTile] / kTile;
  }
  __device__ __forceinline__ int q_tiles(const Problem&, int k0) const {
    return (krange[n_kt + k0 / kTile] + kTile - 1) / kTile;
  }
};

Varlen make_varlen(const void* kinfo, const void* qrange, const void* krange, int Tq, int Tk) {
  return Varlen{static_cast<const int*>(kinfo), static_cast<const int*>(qrange),
                static_cast<const int*>(krange), (Tq + kTile - 1) / kTile,
                (Tk + kTile - 1) / kTile};
}

}  // namespace

// q [Tq, H, D], k/v [Tk, Hkv, D] in one dtype (float32 or bfloat16) with
// unit d stride and D <= 128; `strides` holds 12 element strides: (b, s, h)
// of q, k, v and dO (here a copy of q's), b unused (B = 1). kinfo [3, Tk],
// qrange [2, ceil(Tq / 64)] and krange [2, ceil(Tk / 64)] int32 contiguous
// (see `Varlen`). out [Tq, H, D] contiguous in q's dtype; lse [H, Tq] f32.
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_varlen_fwd(const void* q, const void* k, const void* v, const void* kinfo,
                              const void* qrange, const void* krange, void* out, void* lse,
                              int H, int Hkv, int Tq, int Tk, int D, const long long* strides,
                              float scale, int causal, int dtype, void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, 1, H, Hkv, Tq, Tk, D, scale, causal, strides, q, k, v,
                                 nullptr);
  return run_fwd(dtype, p, make_varlen(kinfo, qrange, krange, Tq, Tk), q, k, v, out, lse,
                 stream);
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
