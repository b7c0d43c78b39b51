// Flash attention forward, dQ and dK/dV for Hopper (sm_90a).
//
// Replaces three kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   - `_fwd_kernel` :127 (pallas_call :282, entry `flash_attention_fwd` :719):
//     O = softmax(Q K^T * scale [+ key bias]) V and the f32 row
//     log-sum-exp, causal (bottom-right aligned: key c is visible to query r
//     iff c <= r + Skv - Sq) or full, GQA by kv head h / g;
//   - `_bwd_dq_kernel` :332 (pallas_call :528): dQ from the LSE;
//   - `_bwd_dkv_kernel` :406 (pallas_call :557): dV, dK in f32 (the TPU
//     kernel writes one slice per expanded query head, which `_bwd` sums).
// All three run under the mask policy `CausalBias` below. bfloat16 and float16 run the
// Hopper kernels: the forward of flash_fwd_sm90.cuh and the dQ and dK/dV of
// flash_bwd_sm90.cuh (wgmma fed by TMA, 128 x 128 tiles; dK/dV of a kv head
// written once, the g query heads summed in registers). Their partial tiles
// are the causal diagonal, a ragged last kv tile and a ragged last q tile or
// step; the key bias is added on every tile. float32 runs the CUDA-core tile
// kernels of flash_tiles.cuh (dK/dV one slice per query head, summed by the
// caller). A row that sees no key (causal with Sq > Skv, or every key biased
// to -1e30) gets zeros, LSE = +inf and exactly zero gradients.
//
// Bound on an H100: operations, 4 D (forward), 6 D (dQ) and 8 D (dK/dV) per
// visible (row, key) pair at 989 TFLOP/s (bf16 dense): at the gpt3_1p3b
// step's shape (B 4, S 2048, 16 heads of 128, causal) 0.0695, 0.104 and
// 0.139 ms. The bytes (Q, K, V, dO once, dQ in bf16, dK/dV of the kv heads in
// f32) take a few tens of microseconds at 3.35 TB/s.
#include "flash_bwd_sm90.cuh"

namespace {

// Bottom-right causal masking and an optional additive f32 per-key bias
// [B, Skv] (a padding mask). Causal tiles past a q tile's last visible
// column are never visited, so no vote is needed, and no tile is skipped.
// `tile_class` ignores the tile's height: "full" is tested against its first
// row q0, which holds for any height, so the sm90 dK/dV kernel's 64-row q
// steps (q0 = t * 64, bm = 128) read their own class (FlashMask reads its
// 128-row table there, conservative for either half). `first_q_tile` and
// `q_tiles` count 64-row tiles (kTile), the sm90 backward's q step.
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
  // the sm90 dK/dV's CTA of bn keys: the same
  __device__ __forceinline__ int q_tiles(const Problem& p, int k0, int) const {
    return q_tiles(p, k0);
  }
  // the sm90 dK/dV: CTAs in key-tile order, the lowest keys (seen by the
  // most causal q steps) first
  __device__ __forceinline__ int key_tile(int z) const { return z; }
};

}  // namespace

// q [B, Sq, H, D], k/v [B, Skv, Hkv, D] in one dtype (float32, bfloat16 or float16)
// with unit d stride and D <= 192; `strides` holds 12 element strides:
// (b, s, h) of q, k, v and dO (here a copy of q's). bfloat16 and float16 run the sm90
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
  if (dtype != ptt::kF32) return run_fwd_sm90(dtype, p, m, q, k, v, out, lse, stream);
  return run_fwd_f32(p, m, q, k, v, out, lse, stream);
}

// As ptt_flash_fwd, plus dout (strided like q, strides 9..11; in 16 bits
// as run_fwd_sm90 takes q), lse and delta = rowsum(dO * O) [B, H, Sq] f32;
// writes dq [B, Sq, H, D] contiguous in q's dtype.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* kbias,
                                const void* dout, const void* lse, const void* delta, void* dq,
                                int B, int H, int Hkv, int Sq, int Skv, int D,
                                const long long* strides, float scale, int causal, int dtype,
                                void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, B, H, Hkv, Sq, Skv, D, scale, causal, strides, q, k, v,
                                 dout);
  const CausalBias m{static_cast<const float*>(kbias)};
  if (dtype != ptt::kF32)
    return run_bwd_sm90(dtype, p, m, q, k, v, dout, lse, delta, dq, nullptr, nullptr, stream);
  return run_dq(dtype, p, m, q, k, v, dout, lse, delta, dq, stream);
}

// As ptt_flash_bwd_dq; writes dk, dv contiguous f32: in 16 bits the kv
// heads' gradients [B, Skv, Hkv, D], in float32 one slice per query head
// [B, Skv, H, D] (the caller sums the g heads of a kv head).
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* kbias,
                                 const void* dout, const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int H, int Hkv, int Sq, int Skv, int D,
                                 const long long* strides, float scale, int causal, int dtype,
                                 void* stream) {
  if (!supported(dtype)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, B, H, Hkv, Sq, Skv, D, scale, causal, strides, q, k, v,
                                 dout);
  const CausalBias m{static_cast<const float*>(kbias)};
  if (dtype != ptt::kF32)
    return run_bwd_sm90(dtype, p, m, q, k, v, dout, lse, delta, nullptr, dk, dv, stream);
  return run_dkv(dtype, p, m, q, k, v, dout, lse, delta, dk, dv, stream);
}
