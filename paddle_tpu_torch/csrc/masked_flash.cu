// Flashmask attention forward, dQ and dK/dV for Hopper (sm_90a).
//
// Replaces the flashmask kernels of paddle_tpu/ops/pallas/masked_flash.py:
//   - `_fm_fwd_kernel` :77 (pallas_call :253, entry `flashmask_attention_fwd`
//     :408): O and the f32 row LSE of softmax(Q K^T * scale) V over the
//     pairs that `_flashmask_keep` :46 keeps;
//   - `_fm_bwd_dq_kernel` :138 (pallas_call :291): dQ;
//   - `_fm_bwd_dkv_kernel` :182 (pallas_call :311): dK, dV of the kv heads
//     in f32 (the g query heads of a kv head summed, as `_fm_bwd` does).
// The mask: per key column c, the indices idx[b, hm, :, c] (hm = h / (H /
// Hm), n = 1, 2 or 4 of them) name the query rows that are MASKED OUT:
//   causal n = 1: rows >= start;  causal n = 2: rows in [start, end);
//   non-causal n = 2: rows >= LTS or < UTE;
//   non-causal n = 4: rows in [LTS, LTE) or in [UTS, UTE);
// and causal is top-left (col <= row), not the bottom-right alignment of
// flash_attention.cu: the two agree only when Sq == Skv. A row that keeps
// no key gets zeros and LSE = +inf (the JAX kernel gives -1e30 there; its
// recomputed P is 0 either way), so its gradients are exactly 0.
//
// bfloat16 and float16 run the Hopper kernels under the mask policy `FlashMask`
// below: the forward of flash_fwd_sm90.cuh, the dQ and dK/dV of
// flash_bwd_sm90.cuh (wgmma fed by TMA). float32 runs the CUDA-core tile
// kernels of flash_tiles.cuh. Bound at the LLaMA-7B-shape training step
// (B 4, S 2048, 32 query heads of 128 over 8 kv heads, causal, the trivial
// mask): operations, 2.69e8 visible pairs x 32 heads; forward 4 D, dQ 6 D,
// dK/dV 8 D operations a pair at 989 TFLOP/s: 0.139, 0.209, 0.278 ms.
//
// Design against the TPU kernel: the bf16 kernels read a class per
// (128-row q tile, 128-key kv tile) that the wrapper derives on the device
// from per-kv-tile min/max of each index row (ops/masked_flash.py
// `flashmask_tile_classes`, FlashMask's block skip; the forward computes
// it once and the backward reuses it): a skipped tile is never loaded, a
// full one evaluates no predicate, a partial one applies keep() to its
// score fragment. The f32 kernels load the n index rows of a 64-key tile
// (coalesced, [B, Hm, n, Skv] int32) next to K and V, evaluate the keep
// predicate per element where the TPU kernel builds a [bq, bk] mask on the
// VPU, and skip a tile whose keep-mask is empty by a CTA-wide vote
// (`any_kept`, __syncthreads_or) where the TPU kernel guards its matmuls
// with `needed & jnp.any(keep)`. Tiles above the causal diagonal are never
// visited.
#include "flash_bwd_sm90.cuh"

namespace {

struct FlashMask {
  static constexpr bool kVote = true;
  const int* idx;  // [B, Hm, n, Skv] int32
  int Hm, n;
  // the sm90 kernels' tile classes, [B, Hm, n_qt, n_kt] uint8 (null for
  // the f32 kernels)
  const uint8_t* cls;
  int n_qt, n_kt;

  struct Key {  // a key column's indices; unused ones 0
    int i0, i1, i2, i3;
  };

  __device__ __forceinline__ Key key(const Problem& p, int b, int h, int col) const {
    Key k{0, 0, 0, 0};
    if (col < p.Skv) {
      const int hm = h / (p.H / Hm);
      const int* c = idx + ((long long)(b * Hm + hm) * n) * p.Skv + col;
      k.i0 = c[0];
      if (n > 1) k.i1 = c[p.Skv];
      if (n > 2) {
        k.i2 = c[2 * p.Skv];
        k.i3 = c[3 * p.Skv];
      }
    }
    return k;
  }
  __device__ __forceinline__ bool keep(const Problem& p, int row, int col, const Key& k) const {
    if (row >= p.Sq || col >= p.Skv) return false;
    bool masked;
    if (p.causal) {
      if (col > row) return false;
      masked = n == 1 ? row >= k.i0 : (row >= k.i0 && row < k.i1);
    } else if (n == 2) {
      masked = row >= k.i0 || row < k.i1;
    } else {
      masked = (row >= k.i0 && row < k.i1) || (row >= k.i2 && row < k.i3);
    }
    return !masked;
  }
  __device__ __forceinline__ float bias(const Key&) const { return 0.f; }
  __device__ __forceinline__ bool has_bias() const { return false; }
  // causal: the kv tiles up to the q tile's last row (top-left diagonal)
  __device__ __forceinline__ int kv_tiles(const Problem& p, int q0, int bm = kTile,
                                          int bn = kTile) const {
    const int n_kv = (p.Skv + bn - 1) / bn;
    if (!p.causal) return n_kv;
    const int last_row = min(q0 + bm, p.Sq) - 1;
    return min(n_kv, last_row / bn + 1);
  }
  __device__ __forceinline__ int tile_class(const Problem& p, int b, int h, int q0, int k0,
                                            int bm, int bn) const {
    const int c = cls[((b * Hm + h / (p.H / Hm)) * n_qt + q0 / bm) * n_kt + k0 / bn];
    return c;
  }
  // causal: the q tile holding row k0 on
  __device__ __forceinline__ int first_q_tile(const Problem& p, int k0) const {
    return p.causal ? k0 / kTile : 0;
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

bool mask_ok(int Hm, int H, int n, int causal) {
  return Hm >= 1 && H % Hm == 0 && (causal ? (n == 1 || n == 2) : (n == 2 || n == 4));
}

// the policy of the sm90 kernels: the indices and the tile classes
// [B, Hm, ceil(Sq / 128), ceil(Skv / 128)]
FlashMask sm90_mask(const void* idx, const void* cls, int Hm, int n, int Sq, int Skv) {
  return {static_cast<const int*>(idx), Hm, n, static_cast<const uint8_t*>(cls),
          (Sq + sm90::kBM - 1) / sm90::kBM, (Skv + sm90::kBN - 1) / sm90::kBN};
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Skv, Hkv, D] in one dtype (float32, bfloat16 or float16)
// with unit d stride and D <= 192; `strides` holds 12 element strides:
// (b, s, h) of q, k, v and dO (here a copy of q's). idx [B, Hm, n, Skv]
// int32 contiguous, H a multiple of Hm, n 1 or 2 when causal, 2 or 4
// otherwise. bfloat16 and float16 run the sm90 kernel (q, k, v as run_fwd_sm90 takes
// them) and reads cls [B, Hm, ceil(Sq / 128), ceil(Skv / 128)] uint8
// contiguous, the `TileClass` of each tile (float32 ignores it). out
// [B, Sq, H, D] contiguous in q's dtype; lse [B, H, Sq] f32. Returns
// cudaGetLastError() after the launch, or the error of a tensor map's
// encode.
extern "C" int ptt_flashmask_fwd(const void* q, const void* k, const void* v, const void* idx,
                                 const void* cls, void* out, void* lse, int B, int H, int Hkv,
                                 int Hm, int n, int Sq, int Skv, int D,
                                 const long long* strides, float scale, int causal, int dtype,
                                 void* stream) {
  if (!supported(dtype) || !mask_ok(Hm, H, n, causal)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, B, H, Hkv, Sq, Skv, D, scale, causal, strides, q, k, v,
                                 nullptr);
  if (dtype != ptt::kF32) {
    if (cls == nullptr) return cudaErrorInvalidValue;
    return run_fwd_sm90(dtype, p, sm90_mask(idx, cls, Hm, n, Sq, Skv), q, k, v, out, lse, stream);
  }
  const FlashMask m{static_cast<const int*>(idx), Hm, n};
  return run_fwd_f32(p, m, q, k, v, out, lse, stream);
}

// As ptt_flashmask_fwd, plus dout (strided like q, strides 9..11; in
// 16 bits as run_fwd_sm90 takes q), lse and delta = rowsum(dO * O)
// [B, H, Sq] f32, and (16-bit) the forward's tile classes cls; writes dq
// [B, Sq, H, D] contiguous in q's dtype.
extern "C" int ptt_flashmask_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* idx, const void* cls, const void* dout,
                                    const void* lse, const void* delta, void* dq, int B, int H,
                                    int Hkv, int Hm, int n, int Sq, int Skv, int D,
                                    const long long* strides, float scale, int causal,
                                    int dtype, void* stream) {
  if (!supported(dtype) || !mask_ok(Hm, H, n, causal)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, B, H, Hkv, Sq, Skv, D, scale, causal, strides, q, k, v,
                                 dout);
  if (dtype != ptt::kF32) {
    if (cls == nullptr) return cudaErrorInvalidValue;
    return run_bwd_sm90(dtype, p, sm90_mask(idx, cls, Hm, n, Sq, Skv), q, k, v, dout, lse, delta, dq,
                        nullptr, nullptr, stream);
  }
  const FlashMask m{static_cast<const int*>(idx), Hm, n};
  return run_dq(dtype, p, m, q, k, v, dout, lse, delta, dq, stream);
}

// As ptt_flashmask_bwd_dq; writes dk, dv contiguous f32: in 16 bits the
// kv heads' gradients [B, Skv, Hkv, D], in float32 one slice per query
// head [B, Skv, H, D] (the caller sums the g heads of a kv head).
extern "C" int ptt_flashmask_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* idx, const void* cls, const void* dout,
                                     const void* lse, const void* delta, void* dk, void* dv,
                                     int B, int H, int Hkv, int Hm, int n, int Sq, int Skv,
                                     int D, const long long* strides, float scale, int causal,
                                     int dtype, void* stream) {
  if (!supported(dtype) || !mask_ok(Hm, H, n, causal)) return cudaErrorInvalidValue;
  const Problem p = make_problem(dtype, B, H, Hkv, Sq, Skv, D, scale, causal, strides, q, k, v,
                                 dout);
  if (dtype != ptt::kF32) {
    if (cls == nullptr) return cudaErrorInvalidValue;
    return run_bwd_sm90(dtype, p, sm90_mask(idx, cls, Hm, n, Sq, Skv), q, k, v, dout, lse, delta,
                        nullptr, dk, dv, stream);
  }
  const FlashMask m{static_cast<const int*>(idx), Hm, n};
  return run_dkv(dtype, p, m, q, k, v, dout, lse, delta, dk, dv, stream);
}
