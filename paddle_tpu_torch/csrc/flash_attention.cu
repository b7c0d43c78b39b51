// Flash attention forward, dQ and dK/dV for Hopper (sm_90a).
//
// Replaces three kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   - `_fwd_kernel` :127 (pallas_call :282, entry `flash_attention_fwd` :719):
//     O = softmax(Q K^T * scale [+ key bias]) V and the f32 row
//     log-sum-exp, causal (bottom-right aligned: key c is visible to query r
//     iff c <= r + Skv - Sq) or full, GQA by kv head h / g;
//   - `_bwd_dq_kernel` :332 (pallas_call :528): dQ from the LSE;
//   - `_bwd_dkv_kernel` :406 (pallas_call :557): dV, dK per expanded query
//     head, in f32.
// The kernels are the tile kernels of flash_tiles.cuh (their bound and
// design are described there) under the mask policy `CausalBias` below;
// the bf16 forward is flash_fwd_sm90.cuh's wgmma kernel, whose partial
// tiles are the causal diagonal and a ragged last kv tile. A row that sees
// no key (causal with Sq > Skv, or every key biased to -1e30) gets zeros
// and LSE = +inf.
#include "flash_fwd_sm90.cuh"

namespace {

// Bottom-right causal masking and an optional additive f32 per-key bias
// [B, Skv] (a padding mask). Causal tiles past a q tile's last visible
// column are never visited, so no vote is needed.
struct CausalBias {
  static constexpr bool kVote = false;
  const float* kbias;  // [B, Skv] or null

  struct Key {
    float bias;
  };

  __device__ __forceinline__ Key key(const Problem& p, int b, int, int col) const {
    return {(kbias != nullptr && col < p.Skv) ? kbias[(long long)b * p.Skv + col] : 0.f};
  }
  __device__ __forceinline__ bool keep(const Problem& p, int row, int col, const Key&) const {
    return row < p.Sq && col < p.Skv && (!p.causal || col <= row + p.Skv - p.Sq);
  }
  __device__ __forceinline__ float bias(const Key& k) const { return k.bias; }
  __device__ __forceinline__ bool has_bias() const { return kbias != nullptr; }
  // all kv tiles, or for causal those up to the last column the q tile's
  // last row can see
  __device__ __forceinline__ int kv_tiles(const Problem& p, int q0, int bm = kTile,
                                          int bn = kTile) const {
    int n = (p.Skv + bn - 1) / bn;
    if (p.causal) {
      const int last_row = min(q0 + bm, p.Sq) - 1;
      const int last_col = last_row + p.Skv - p.Sq;
      n = last_col < 0 ? 0 : min(n, last_col / bn + 1);
    }
    return n;
  }
  // full where every column is real and, causal, visible to the tile's
  // first row; partial otherwise (the diagonal, a ragged last kv tile)
  __device__ __forceinline__ int tile_class(const Problem& p, int, int, int q0, int k0, int,
                                            int bn) const {
    const bool full = k0 + bn <= p.Skv && (!p.causal || k0 + bn - 1 <= q0 + p.Skv - p.Sq);
    return full ? kFullTile : kPartialTile;
  }
  // for causal, the q tile holding row k0 - (Skv - Sq) on
  __device__ __forceinline__ int first_q_tile(const Problem& p, int k0) const {
    if (!p.causal) return 0;
    const int first = k0 - (p.Skv - p.Sq);
    return first <= 0 ? 0 : first / kTile;
  }
  __device__ __forceinline__ int first_kv_tile(const Problem&, int) const { return 0; }
  __device__ __forceinline__ int q_tiles(const Problem& p, int) const {
    return (p.Sq + kTile - 1) / kTile;
  }
};

}  // namespace

// q [B, Sq, H, D], k/v [B, Skv, Hkv, D] in one dtype (float32 or bfloat16)
// with unit d stride and D <= 128; `strides` holds 12 element strides:
// (b, s, h) of q, k, v and dO (here a copy of q's). bfloat16 runs the sm90
// kernel, which takes only what a TMA map describes (see run_fwd_sm90).
// kbias [B, Skv] f32 or null. out [B, Sq, H, D] contiguous in q's dtype;
// lse [B, H, Sq] f32. Returns cudaGetLastError() after the launch, or the
// error of a tensor map's encode.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v, const void* kbias,
                             void* out, void* lse, int B, int H, int Hkv, int Sq, int Skv,
                             int D, const long long* strides, float scale, int causal,
                             int dtype, void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, B, H, Hkv, Sq, Skv, D, scale, causal, strides, q, k, v,
                                 nullptr);
  const CausalBias m{static_cast<const float*>(kbias)};
  if (dtype == ptt::kBF16) return run_fwd_sm90(p, m, q, k, v, out, lse, stream);
  return run_fwd_f32(p, m, q, k, v, out, lse, stream);
}

// As ptt_flash_fwd, plus dout (strided like q, strides 9..11), lse and
// delta = rowsum(dO * O) [B, H, Sq] f32; writes dq [B, Sq, H, D] contiguous
// in q's dtype.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* kbias,
                                const void* dout, const void* lse, const void* delta, void* dq,
                                int B, int H, int Hkv, int Sq, int Skv, int D,
                                const long long* strides, float scale, int causal, int dtype,
                                void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, B, H, Hkv, Sq, Skv, D, scale, causal, strides, q, k, v,
                                 dout);
  const CausalBias m{static_cast<const float*>(kbias)};
  return run_dq(dtype, p, m, q, k, v, dout, lse, delta, dq, stream);
}

// As ptt_flash_bwd_dq; writes dk, dv [B, Skv, H, D] contiguous f32, one
// slice per query head (the caller sums the g heads of a kv head).
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* kbias,
                                 const void* dout, const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int H, int Hkv, int Sq, int Skv, int D,
                                 const long long* strides, float scale, int causal, int dtype,
                                 void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, B, H, Hkv, Sq, Skv, D, scale, causal, strides, q, k, v,
                                 dout);
  const CausalBias m{static_cast<const float*>(kbias)};
  return run_dkv(dtype, p, m, q, k, v, dout, lse, delta, dk, dv, stream);
}
