// The float32 tile kernels of flash attention for Hopper (sm_90a), on the
// CUDA cores: forward, dQ and dK/dV, each templated on a mask policy (see
// below) so that one set of kernels serves three families of TPU kernels:
//   - flash_attention.cu: paddle_tpu/ops/pallas/flash_attention.py's
//     `_fwd_kernel` :127, `_bwd_dq_kernel` :332 and `_bwd_dkv_kernel` :406
//     (bottom-right causal, an additive key bias);
//   - masked_flash.cu: paddle_tpu/ops/pallas/masked_flash.py's flashmask
//     `_fm_fwd_kernel` :77, `_fm_bwd_dq_kernel` :138 and
//     `_fm_bwd_dkv_kernel` :182 (per-column masked row ranges, top-left
//     causal, empty tiles skipped);
//   - varlen_flash.cu: the same file's varlen `_vl_fwd_kernel` :442,
//     `_vl_bwd_dq_kernel` :490 and `_vl_bwd_dkv_kernel` :529 (packed
//     segments, causal top-left within a segment, a tile range per
//     segment span).
// Every bfloat16 pass of the three runs the Hopper kernels of
// flash_fwd_sm90.cuh (forward) and flash_bwd_sm90.cuh (dQ, dK/dV) under
// the same policies; this file also holds what those share: `Problem`,
// the policies' interface, `TileClass`, `launch` and `make_problem`.
// What they compute:
//   - forward: O = softmax(Q K^T * scale + mask) V and the f32 row
//     log-sum-exp, GQA by kv head h / g;
//   - dQ = dS K with P recomputed from the LSE, dS = P * (dO V^T - delta) *
//     scale, delta = rowsum(dO*O);
//   - dV = P^T dO, dK = dS^T Q per expanded query head, in f32 (the caller
//     group-sums them for GQA).
// The softmax is the exact running-max form (the JAX package's
// PADDLE_TPU_FLASH_SAFE_SOFTMAX=1 kernel), not its default unshifted
// exp(min(s, 60)) form: the two agree wherever every logit is below 60. A
// row that sees no key gets zeros and LSE = +inf, so its recomputed P, and
// with it every gradient through it, is exactly 0; a running max at or
// below -5e29 counts as "no key seen".
//
// Bound on an H100: operations, 4 D (forward), 6 D (dQ) and 8 D (dK/dV)
// per visible pair at the f32 CUDA-core rate (67 TFLOP/s).
//
// Tile widths: 64, 128 and 192 columns (a head dim up to kMaxHeadDim,
// zero-filled past D). At 192 a [64, 192] f32 operand tile takes 49 KB:
// the forward holds three (165 KB with the score tile), dQ four (214 KB);
// dK/dV's four and two score tiles would take 231 KB, above the 227 KB a
// block may have, so at that width its P^T and dS^T share one tile, dS^T
// kept in registers until dV's product has read P^T. The kernels' launch
// bounds name one block an SM (what their shared memory allows at 128 and
// 192): without it ptxas held the f32 varlen forward at 192 to 128
// registers and spilled.
//
// Design: one CTA per (64-row tile, head, batch). The TPU kernels'
// sequential kv (or q) grid axis, which carried m/l/acc in VMEM scratch,
// becomes a loop over tiles inside the CTA; tiles that no row of the CTA
// can see (the policy's tile range) are never visited, and under a policy
// with `kVote` a tile whose keep-mask is empty is skipped after a CTA-wide
// vote, the TPU kernels' `needed & jnp.any(keep)`. dK/dV need no atomics:
// their CTA owns a 64-key tile and loops over every q tile that can see it.
// Each tile is read from HBM once into shared memory (through the
// [B, S, H, D] strides, 16 bytes a thread where the layout allows, with the
// ragged edge and any head dim below 64 or 128 zero-filled: no transpose
// and no padded copy in HBM), then reused by 64 rows. The products are
// register-tiled FMA in full f32 (no TF32), 256 threads: every thread owns
// 2 rows x 8 columns of the 64x64 score tile (columns cg + 8j, so the 8
// threads of a row group read 8 consecutive smem rows and no two hit the
// same bank) and 2 rows x D/8 columns of the output; the row softmax
// reduces over the 8 lanes of a row group with shuffles and rescales its
// own accumulator in registers.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;                  // rows and columns of a score tile
constexpr int kRpt = 2;                    // rows per thread
constexpr int kCg = 8;                     // column groups (threads per row group)
constexpr int kThreads = (kTile / kRpt) * kCg;  // 256
constexpr int kCols = kTile / kCg;         // score columns per thread
constexpr int kLdp = kTile + 4;            // f32 row stride of P / dS tiles
constexpr float kEmpty = -5e29f;           // running max at or below: no key seen
constexpr int kMaxHeadDim = 192;           // the widest tile width (three 64-column panels)

using bf16 = __nv_bfloat16;  // an sm90 kernel operand type (sm90.cuh adds f16)

// smem row stride of a [64, DT] operand tile in elements: 16 extra bytes
// keep rows 16-byte aligned and put consecutive rows 4 banks apart
template <typename T, int DT>
struct Ld {
  static constexpr int value = DT + 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float group_max(float v) {  // over the 8 lanes of a row group
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// dst[r][d] = src[(row0 + r) * row_stride + d] for r < 64, d < DT; zero
// where row0 + r >= n_rows or d >= D. Neighbouring threads read
// neighbouring d: coalesced; with `vec` (D, the strides and the base a
// multiple of 16 bytes) 16 bytes at a time.
template <typename T, int DT, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int n_rows,
                                          int D, bool vec) {
  constexpr int LD = Ld<T, DT>::value;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    for (int idx = threadIdx.x; idx < kTile * DT / kVec; idx += NT) {
      const int r = idx / (DT / kVec), d = (idx % (DT / kVec)) * kVec;
      const int gr = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < n_rows && d < D) v = *reinterpret_cast<const uint4*>(src + gr * row_stride + d);
      *reinterpret_cast<uint4*>(dst + r * LD + d) = v;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kTile * DT; idx += NT) {
    const int r = idx / DT, d = idx % DT;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < n_rows && d < D) v = ptt::to_f32(src[gr * row_stride + d]);
    dst[r * LD + d] = ptt::from_f32<T>(v);
  }
}

// acc[i][j] += sum_d A[rg*kRpt + i][d] * B[cg + kCg*j][d]   (A B^T)
template <typename T, int DT>
__device__ __forceinline__ void mm_nt(const T* A, const T* B, float (&acc)[kRpt][kCols],
                                      int rg, int cg) {
  constexpr int LD = Ld<T, DT>::value;
#pragma unroll 2
  for (int d = 0; d < DT; d += 4) {
    float4 a[kRpt], b[kCols];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) a[i] = load4(A + (rg * kRpt + i) * LD + d);
#pragma unroll
    for (int j = 0; j < kCols; ++j) b[j] = load4(B + (cg + kCg * j) * LD + d);
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][4*jj + e] += sum_k P[rg*kRpt + i][k] * B[k][cg*4 + 32*jj + e]   (P B)
template <typename T, int DT>
__device__ __forceinline__ void mm_nn(const float* P, const T* B,
                                      float (&acc)[kRpt][DT / 8], int rg, int cg) {
  constexpr int LD = Ld<T, DT>::value;
  constexpr int NJ = DT / 32;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) p[i] = load4(P + (rg * kRpt + i) * kLdp + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 b = load4(B + (k + kk) * LD + cg * 4 + 32 * jj);
#pragma unroll
        for (int i = 0; i < kRpt; ++i) {
          const float pv = kk == 0 ? p[i].x : kk == 1 ? p[i].y : kk == 2 ? p[i].z : p[i].w;
          acc[i][4 * jj + 0] = fmaf(pv, b.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pv, b.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pv, b.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pv, b.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

struct Strides {  // element strides of a [B, S, H, D] view (d stride is 1)
  long long b, s, h;
};

struct Problem {
  int B, H, g, Sq, Skv, D;
  float scale;
  bool causal;
  bool vec;            // 16-byte tile loads (see load_tile)
  Strides q, k, v, o;  // o: dO in the backward kernels
};

// A mask policy M says which (query row, key) pairs a kernel sees. It
// provides:
//   - `M::Key`, what a thread holds about one key column (loaded once per
//     kv tile into shared memory, or once per CTA into registers where a
//     CTA owns the key tile), and `Key key(p, b, h, col)` that loads it;
//   - `bool keep(p, row, col, key)`: the pair is seen;
//   - `float bias(key)`: added to every logit of the column;
//   - `int first_kv_tile(p, q0)` and `int kv_tiles(p, q0)`: the kv tiles a
//     q tile at q0 visits, [first_kv_tile, kv_tiles) (flash and flashmask
//     visit a prefix; varlen the range of the segments the q tile touches);
//     the sm90 kernels take the tile sizes too, `kv_tiles(p, q0, bm, bn)`,
//     for their 128 x 128 tiles (64 by default);
//   - `int first_q_tile(p, k0)` and `int q_tiles(p, k0)`: the q tiles that
//     can see key tile k0, [first_q_tile, q_tiles);
//   - `kVote`: whether a tile whose keep-mask is empty is skipped after a
//     CTA-wide vote (`any_kept`), for masks whose empty tiles the tile
//     ranges above do not exclude.
// The sm90 kernels (the forward, dQ and dK/dV of all three) also read
//   - `int tile_class(p, b, h, q0, k0, bm, bn)`: a `TileClass` of the
//     (q tile, kv tile): skipped (no pair kept; never loaded), full (every
//     pair of real rows and columns kept: no predicate) or partial (keep()
//     on every element); the dK/dV kernel asks it of 64-row q steps
//     (q0 = t * 64, bm = 128);
//   - `int q_tiles(p, k0, bn)`: the end of the 64-row q tiles that can
//     see any key of [k0, k0 + bn), the dK/dV kernel's CTA;
//   - `int key_tile(z)`: the 128-key tile of the dK/dV CTA launched z-th;
//   - `bool has_bias()`: whether bias() is added on every tile.
// flash_attention.cu holds the flash policy (bottom-right causal plus a
// key bias), masked_flash.cu the flashmask column ranges, varlen_flash.cu
// the packed segments of varlen attention.

enum TileClass { kSkipTile = 0, kPartialTile = 1, kFullTile = 2 };

// The CTA-wide vote of the skip: true if any thread holds a kept pair.
__device__ __forceinline__ bool any_kept(bool mine) {
  return __syncthreads_or(mine) != 0;
}

template <typename T, int DT>
constexpr size_t operand_bytes() {
  return static_cast<size_t>(kTile) * Ld<T, DT>::value * sizeof(T);
}

// ---------------------------------------------------------------- forward

template <typename T, int DT, class M>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(Problem p, M mask, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = Ld<T, DT>::value;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kTile * LD;
  T* Vs = Ks + kTile * LD;
  float* Ps = reinterpret_cast<float*>(Vs + kTile * LD);  // [64][kLdp]
  auto* keys = reinterpret_cast<typename M::Key*>(Ps + kTile * kLdp);  // [64]

  const int tid = threadIdx.x, rg = tid / kCg, cg = tid % kCg;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  const T* qp = q + b * p.q.b + h * p.q.h;
  const T* kp = k + b * p.k.b + hk * p.k.h;
  const T* vp = v + b * p.v.b + hk * p.v.h;
  load_tile<T, DT, kThreads>(Qs, qp, p.q.s, q0, p.Sq, p.D, p.vec);

  float m[kRpt], l[kRpt], acc[kRpt][DT / 8];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DT / 8; ++e) acc[i][e] = 0.f;
  }

  const int n_kv = mask.kv_tiles(p, q0);
  for (int t = mask.first_kv_tile(p, q0); t < n_kv; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    load_tile<T, DT, kThreads>(Ks, kp, p.k.s, k0, p.Skv, p.D, p.vec);
    load_tile<T, DT, kThreads>(Vs, vp, p.v.s, k0, p.Skv, p.D, p.vec);
    if (tid < kTile) keys[tid] = mask.key(p, b, h, k0 + tid);
    __syncthreads();

    if constexpr (M::kVote) {
      bool mine = false;
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = cg + kCg * j;
          mine |= mask.keep(p, q0 + rg * kRpt + i, k0 + c, keys[c]);
        }
      if (!any_kept(mine)) continue;
    }

    float s[kRpt][kCols];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    mm_nt<T, DT>(Qs, Ks, s, rg, cg);

#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = q0 + rg * kRpt + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + kCg * j;
        const float x = mask.keep(p, row, k0 + c, keys[c]) ? s[i][j] * p.scale + mask.bias(keys[c]) : -INFINITY;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing seen yet: no NaN
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = expf(s[i][j] - m_use);
        s[i][j] = e;
        rs += e;
      }
      l[i] = l[i] * alpha + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DT / 8; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < kCols; ++j) Ps[(rg * kRpt + i) * kLdp + cg + kCg * j] = s[i][j];
    }
    __syncthreads();
    mm_nn<T, DT>(Ps, Vs, acc, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = q0 + rg * kRpt + i;
    if (row >= p.Sq) continue;
    const bool empty = !(m[i] > kEmpty) || l[i] == 0.f;
    const float inv = empty ? 0.f : 1.f / l[i];
    T* orow = out + (((long long)b * p.Sq + row) * p.H + h) * p.D;
#pragma unroll
    for (int jj = 0; jj < DT / 32; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = cg * 4 + 32 * jj + e;
        if (d < p.D) orow[d] = ptt::from_f32<T>(acc[i][4 * jj + e] * inv);
      }
    if (cg == 0)
      lse[((long long)b * p.H + h) * p.Sq + row] = empty ? INFINITY : m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------- dQ

template <typename T, int DT, class M>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(Problem p, M mask, const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = Ld<T, DT>::value;
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kTile * LD;
  T* Ks = dOs + kTile * LD;
  T* Vs = Ks + kTile * LD;
  float* dSs = reinterpret_cast<float*>(Vs + kTile * LD);  // [64][kLdp]
  auto* keys = reinterpret_cast<typename M::Key*>(dSs + kTile * kLdp);  // [64]

  const int tid = threadIdx.x, rg = tid / kCg, cg = tid % kCg;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  const T* kp = k + b * p.k.b + hk * p.k.h;
  const T* vp = v + b * p.v.b + hk * p.v.h;
  load_tile<T, DT, kThreads>(Qs, q + b * p.q.b + h * p.q.h, p.q.s, q0, p.Sq, p.D, p.vec);
  load_tile<T, DT, kThreads>(dOs, dout + b * p.o.b + h * p.o.h, p.o.s, q0, p.Sq, p.D, p.vec);

  float lse_r[kRpt], delta_r[kRpt], acc[kRpt][DT / 8];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = q0 + rg * kRpt + i;
    const long long at = ((long long)b * p.H + h) * p.Sq + row;
    lse_r[i] = row < p.Sq ? lse[at] : INFINITY;
    delta_r[i] = row < p.Sq ? delta[at] : 0.f;
#pragma unroll
    for (int e = 0; e < DT / 8; ++e) acc[i][e] = 0.f;
  }

  const int n_kv = mask.kv_tiles(p, q0);
  for (int t = mask.first_kv_tile(p, q0); t < n_kv; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, DT, kThreads>(Ks, kp, p.k.s, k0, p.Skv, p.D, p.vec);
    load_tile<T, DT, kThreads>(Vs, vp, p.v.s, k0, p.Skv, p.D, p.vec);
    if (tid < kTile) keys[tid] = mask.key(p, b, h, k0 + tid);
    __syncthreads();

    if constexpr (M::kVote) {
      bool mine = false;
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = cg + kCg * j;
          mine |= mask.keep(p, q0 + rg * kRpt + i, k0 + c, keys[c]);
        }
      if (!any_kept(mine)) continue;
    }

    float s[kRpt][kCols], dp[kRpt][kCols];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<T, DT>(Qs, Ks, s, rg, cg);
    mm_nt<T, DT>(dOs, Vs, dp, rg, cg);
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int row = q0 + rg * kRpt + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + kCg * j;
        const float pr = mask.keep(p, row, k0 + c, keys[c]) ? expf(s[i][j] * p.scale + mask.bias(keys[c]) - lse_r[i]) : 0.f;
        dSs[(rg * kRpt + i) * kLdp + c] = pr * (dp[i][j] - delta_r[i]) * p.scale;
      }
    }
    __syncthreads();
    mm_nn<T, DT>(dSs, Ks, acc, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = q0 + rg * kRpt + i;
    if (row >= p.Sq) continue;
    T* drow = dq + (((long long)b * p.Sq + row) * p.H + h) * p.D;
#pragma unroll
    for (int jj = 0; jj < DT / 32; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = cg * 4 + 32 * jj + e;
        if (d < p.D) drow[d] = ptt::from_f32<T>(acc[i][4 * jj + e]);
      }
  }
}

// ---------------------------------------------------------------- dK, dV

template <typename T, int DT, class M>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(Problem p, M mask, const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = Ld<T, DT>::value;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kTile * LD;
  T* Qs = Vs + kTile * LD;
  T* dOs = Qs + kTile * LD;
  // at the widest tiles P^T and dS^T share one tile (see the note above)
  constexpr bool kOneScoreTile = DT > 128;
  float* Pt = reinterpret_cast<float*>(dOs + kTile * LD);  // [64 keys][kLdp] P^T
  float* dSt = Pt + (kOneScoreTile ? 0 : kTile * kLdp);     // [64 keys][kLdp] dS^T
  float* lse_s = dSt + kTile * kLdp;                        // [64]
  float* delta_s = lse_s + kTile;                           // [64]

  const int tid = threadIdx.x, rg = tid / kCg, cg = tid % kCg;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  load_tile<T, DT, kThreads>(Ks, k + b * p.k.b + hk * p.k.h, p.k.s, k0, p.Skv, p.D, p.vec);
  load_tile<T, DT, kThreads>(Vs, v + b * p.v.b + hk * p.v.h, p.v.s, k0, p.Skv, p.D, p.vec);
  const T* qp = q + b * p.q.b + h * p.q.h;
  const T* op = dout + b * p.o.b + h * p.o.h;

  typename M::Key kk[kRpt];
  float dk_acc[kRpt][DT / 8], dv_acc[kRpt][DT / 8];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    kk[i] = mask.key(p, b, h, k0 + rg * kRpt + i);
#pragma unroll
    for (int e = 0; e < DT / 8; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }

  // the q tiles that can see this key tile
  const int n_q = mask.q_tiles(p, k0);
  for (int t = mask.first_q_tile(p, k0); t < n_q; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile<T, DT, kThreads>(Qs, qp, p.q.s, q0, p.Sq, p.D, p.vec);
    load_tile<T, DT, kThreads>(dOs, op, p.o.s, q0, p.Sq, p.D, p.vec);
    if (tid < kTile) {
      const int row = q0 + tid;
      const long long at = ((long long)b * p.H + h) * p.Sq + row;
      lse_s[tid] = row < p.Sq ? lse[at] : INFINITY;
      delta_s[tid] = row < p.Sq ? delta[at] : 0.f;
    }
    __syncthreads();

    if constexpr (M::kVote) {
      bool mine = false;
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          mine |= mask.keep(p, q0 + cg + kCg * j, k0 + rg * kRpt + i, kk[i]);
      if (!any_kept(mine)) continue;
    }

    float s[kRpt][kCols], dp[kRpt][kCols];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<T, DT>(Ks, Qs, s, rg, cg);   // s[i][j] = K[key i] . Q[row j]
    mm_nt<T, DT>(Vs, dOs, dp, rg, cg); // dp[i][j] = V[key i] . dO[row j]
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int key = k0 + rg * kRpt + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cg + kCg * j;
        const float pr = mask.keep(p, q0 + c, key, kk[i]) ? expf(s[i][j] * p.scale + mask.bias(kk[i]) - lse_s[c]) : 0.f;
        Pt[(rg * kRpt + i) * kLdp + c] = pr;
        const float ds = pr * (dp[i][j] - delta_s[c]) * p.scale;
        if constexpr (kOneScoreTile)
          dp[i][j] = ds;
        else
          dSt[(rg * kRpt + i) * kLdp + c] = ds;
      }
    }
    __syncthreads();
    mm_nn<T, DT>(Pt, dOs, dv_acc, rg, cg);
    if constexpr (kOneScoreTile) {
      __syncthreads();  // every thread's reads of P^T are done
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) dSt[(rg * kRpt + i) * kLdp + cg + kCg * j] = dp[i][j];
      __syncthreads();
    }
    mm_nn<T, DT>(dSt, Qs, dk_acc, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int key = k0 + rg * kRpt + i;
    if (key >= p.Skv) continue;
    const long long base = (((long long)b * p.Skv + key) * p.H + h) * p.D;
#pragma unroll
    for (int jj = 0; jj < DT / 32; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = cg * 4 + 32 * jj + e;
        if (d < p.D) {
          dk[base + d] = dk_acc[i][4 * jj + e];
          dv[base + d] = dv_acc[i][4 * jj + e];
        }
      }
  }
}

// ---------------------------------------------------------------- launch

template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t st,
                   Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

constexpr size_t kF = sizeof(float);
constexpr size_t kSf = kTile * kLdp * kF;  // an f32 score tile

// The forward on the CUDA cores (float32)
template <int DT, class M>
cudaError_t launch_fwd_f32(const Problem& p, const M& m, const void* q, const void* k,
                           const void* v, void* out, float* lse, cudaStream_t st) {
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  constexpr size_t kKeys = kTile * sizeof(typename M::Key);
  return launch(flash_fwd_kernel<float, DT, M>, grid, kThreads,
                3 * operand_bytes<float, DT>() + kSf + kKeys, st, p, m,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(out), lse);
}

// The backward passes on the CUDA cores (float32; every bfloat16 backward
// is flash_bwd_sm90.cuh's)
template <int DT, class M>
cudaError_t launch_dq(int dtype, const Problem& p, const M& m, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse, const float* delta,
                      void* dq, cudaStream_t st) {
  if (dtype != ptt::kF32) return cudaErrorInvalidValue;
  const dim3 grid((p.Sq + kTile - 1) / kTile, p.H, p.B);
  constexpr size_t kKeys = kTile * sizeof(typename M::Key);
  return launch(flash_dq_kernel<float, DT, M>, grid, kThreads,
                4 * operand_bytes<float, DT>() + kSf + kKeys, st, p, m,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
                static_cast<float*>(dq));
}

template <int DT, class M>
cudaError_t launch_dkv(int dtype, const Problem& p, const M& m, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse, const float* delta,
                       float* dk, float* dv, cudaStream_t st) {
  if (dtype != ptt::kF32) return cudaErrorInvalidValue;
  const dim3 grid((p.Skv + kTile - 1) / kTile, p.H, p.B);
  constexpr size_t kScores = (DT > 128 ? 1 : 2) * kSf;  // P^T and dS^T (flash_dkv_kernel)
  return launch(flash_dkv_kernel<float, DT, M>, grid, kThreads,
                4 * operand_bytes<float, DT>() + kScores + 2 * kTile * kF, st, p, m,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, dk,
                dv);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// `st`: the 12 element strides (b, s, h) of q, k, v and dO. Tiles load 16
// bytes a thread when D, every stride and every base pointer allow it.
Problem make_problem(int dtype, int B, int H, int Hkv, int Sq, int Skv, int D, float scale,
                     int causal, const long long* st, const void* q, const void* k,
                     const void* v, const void* dout) {
  Problem p;
  p.B = B;
  p.H = H;
  p.g = H / Hkv;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.scale = scale;
  p.causal = causal != 0;
  p.q = {st[0], st[1], st[2]};
  p.k = {st[3], st[4], st[5]};
  p.v = {st[6], st[7], st[8]};
  p.o = {st[9], st[10], st[11]};
  const int vec = dtype == ptt::kF32 ? 4 : 8;
  p.vec = D % vec == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
          (dout == nullptr || aligned16(dout));
  for (int i = 0; i < 12; ++i) p.vec = p.vec && st[i] % vec == 0;
  return p;
}

bool supported(int dtype) {
  return dtype == ptt::kF32 || dtype == ptt::kBF16 || dtype == ptt::kF16;
}

// The three float32 passes at the head dim's tile width (64, 128 or 192), for
// the entry points of flash_attention.cu, masked_flash.cu and
// varlen_flash.cu.
template <class M>
cudaError_t run_fwd_f32(const Problem& p, const M& m, const void* q, const void* k,
                        const void* v, void* out, void* lse, void* stream) {
  if (p.D > kMaxHeadDim) return cudaErrorInvalidValue;
#if PTT_BUILT_DTYPE(0)
  float* l = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.D <= 64) {
#if PTT_BUILT_WIDTH(64)
    return launch_fwd_f32<64>(p, m, q, k, v, out, l, st);
#endif
  } else if (p.D <= 128) {
#if PTT_BUILT_WIDTH(128)
    return launch_fwd_f32<128>(p, m, q, k, v, out, l, st);
#endif
  } else {
#if PTT_BUILT_WIDTH(192)
    return launch_fwd_f32<192>(p, m, q, k, v, out, l, st);
#endif
  }
#endif
  return cudaErrorNotSupported;
}

template <class M>
cudaError_t run_dq(int dtype, const Problem& p, const M& m, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse, const void* delta,
                   void* dq, void* stream) {
  if (p.D > kMaxHeadDim) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#if PTT_BUILT_DTYPE(0)
  if (p.D <= 64) {
#if PTT_BUILT_WIDTH(64)
    return launch_dq<64>(dtype, p, m, q, k, v, dout, l, dl, dq, st);
#endif
  } else if (p.D <= 128) {
#if PTT_BUILT_WIDTH(128)
    return launch_dq<128>(dtype, p, m, q, k, v, dout, l, dl, dq, st);
#endif
  } else {
#if PTT_BUILT_WIDTH(192)
    return launch_dq<192>(dtype, p, m, q, k, v, dout, l, dl, dq, st);
#endif
  }
#endif
  return cudaErrorNotSupported;
}

template <class M>
cudaError_t run_dkv(int dtype, const Problem& p, const M& m, const void* q, const void* k,
                    const void* v, const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* k_out = static_cast<float*>(dk);
  float* v_out = static_cast<float*>(dv);
  if (p.D > kMaxHeadDim) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#if PTT_BUILT_DTYPE(0)
  if (p.D <= 64) {
#if PTT_BUILT_WIDTH(64)
    return launch_dkv<64>(dtype, p, m, q, k, v, dout, l, dl, k_out, v_out, st);
#endif
  } else if (p.D <= 128) {
#if PTT_BUILT_WIDTH(128)
    return launch_dkv<128>(dtype, p, m, q, k, v, dout, l, dl, k_out, v_out, st);
#endif
  } else {
#if PTT_BUILT_WIDTH(192)
    return launch_dkv<192>(dtype, p, m, q, k, v, dout, l, dl, k_out, v_out, st);
#endif
  }
#endif
  return cudaErrorNotSupported;
}

}  // namespace
