// Grouped (ragged) GEMM of the MoE experts for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/grouped_gemm.py `_gg_kernel` :110
// (pallas_call :149, entry `grouped_matmul` :234): out[r] = lhs[r] @
// rhs[r / R] over a uniform-stride layout, lhs [E*R, K] with group e owning
// rows [e*R, (e+1)*R) of which the first sizes[e] are live, rhs [E, K, N]
// (or, for the backward's dlhs, [E, N, K] read transposed: `_gmm_bwd` :186
// runs the same kernel against the swapped weights), accumulation in f32,
// the output in the input dtype. Semantics, pinned to the row tile BM = 64:
// a row tile whose first row is at or past its group's live count writes
// zeros (never garbage) and does no product; every row of a tile that holds
// at least one live row is computed. Unlike the TPU kernel, BM need not
// divide R: a group's last tile stops at the group's own end (R), never
// runs into the next group's rows, so `row_stride`'s strides of 16 k work.
//
// Bound on an H100: operations. At the gpt3_moe rung (8 experts, 8192
// tokens, top-2, capacity 1229, R = 1280) a call multiplies ~9-10 k live
// rows of [.., 1024] by [1024, 4096] (or of [.., 4096] by [4096, 1024]):
// 2 * rows * K * N ~ 8e10 operations against ~100 MB of operands, 0.08 ms
// at 989 TFLOP/s in bf16 against 0.03 ms at 3.35 TB/s.
//
// Two forms, chosen by the dtype:
//   - bf16 and f16 (the training path): grouped_gemm_sm90.cuh's persistent
//     wgmma kernel fed by TMA, 128 x 128 tiles (its own notes);
//   - f32: register-tiled FMA on the CUDA cores in full f32 (no TF32), one
//     CTA per (64-row tile, 64-column tile), 256 threads of 4 x 4 outputs,
//     K in steps of 16; `sizes` is read from device memory by each CTA (the
//     TPU kernel's scalar prefetch), a dead tile writes zeros and exits.
// Neither syncs with the host.
#include <stdint.h>

#include "common.cuh"
#include "grouped_gemm_sm90.cuh"

namespace {

constexpr int BM = 64;           // row tile: the unit of "computed rows"
constexpr int BNF = 64;          // f32 column tile
constexpr int BKF = 16;          // f32 depth per stage
constexpr int kF32Threads = 256;

struct Args {
  const void* lhs;
  const void* rhs;
  const int* sizes;
  void* out;
  int R, K, N, tiles;  // tiles: row tiles per group, ceil(R / BM)
};

// The tile of this CTA: group, first row in the group, its rows, first
// output row and column.
struct Tile {
  int g, off, rows, n0;
  long long row0;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int bn) {
  Tile t;
  t.g = blockIdx.y / a.tiles;
  t.off = (blockIdx.y % a.tiles) * BM;
  t.rows = min(BM, a.R - t.off);
  t.row0 = (long long)t.g * a.R + t.off;
  t.n0 = blockIdx.x * bn;
  return t;
}

// A dead tile: zeros, the TPU kernel's `live <= off` branch.
__device__ __forceinline__ bool dead_tile(const Args& a, const Tile& t, int bn) {
  if (a.sizes[t.g] > t.off) return false;
  const int ncols = min(bn, a.N - t.n0);
  float* out = static_cast<float*>(a.out);
  for (int i = threadIdx.x; i < t.rows * ncols; i += blockDim.x)
    out[(t.row0 + i / ncols) * a.N + t.n0 + i % ncols] = 0.f;
  return true;
}

template <bool kTrans>
__global__ void __launch_bounds__(kF32Threads) gg_f32_kernel(Args a) {
  __shared__ float As[BKF][BM + 4];   // [k][row]
  __shared__ float Bs[BKF][BNF + 4];  // [k][col]
  const Tile t = tile_of(a, BNF);
  if (dead_tile(a, t, BNF)) return;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* A = static_cast<const float*>(a.lhs) + t.row0 * a.K;
  const float* B = static_cast<const float*>(a.rhs) + (long long)t.g * a.K * a.N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += BKF) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = tid + kF32Threads * e;
      const int r = i / BKF, kk = i % BKF;  // A: 16 consecutive k of a row
      As[kk][r] = (r < t.rows && k0 + kk < a.K) ? A[(long long)r * a.K + k0 + kk] : 0.f;
      if (kTrans) {  // rhs [E, N, K]: 16 consecutive k of an output column
        const int c = i / BKF, n = t.n0 + c;
        Bs[kk][c] = (n < a.N && k0 + kk < a.K) ? B[(long long)n * a.K + k0 + kk] : 0.f;
      } else {  // rhs [E, K, N]: 64 consecutive n of a row k
        const int k = i / BNF, c = i % BNF, n = t.n0 + c;
        Bs[k][c] = (n < a.N && k0 + k < a.K) ? B[(long long)(k0 + k) * a.N + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKF; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row >= t.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = t.n0 + tx + 16 * j;
      if (n < a.N) out[(t.row0 + row) * a.N + n] = acc[i][j];
    }
  }
}

}  // namespace

// out [E*R, N] = the grouped product of lhs [E*R, K] and rhs [E, K, N]
// (trans = 0) or rhs [E, N, K] read transposed (trans = 1), all contiguous
// in one dtype (float32, bfloat16 or float16; the 16-bit types 16-byte
// aligned with K and N multiples of 8); sizes [E] int32 on the device, the live rows of each
// group. Returns cudaGetLastError() after the launch.
extern "C" int ptt_grouped_gemm(const void* lhs, const void* rhs, const void* sizes, void* out,
                                int E, int R, int K, int N, int trans, int dtype,
                                void* stream) {
  if ((dtype != ptt::kF32 && dtype != ptt::kBF16 && dtype != ptt::kF16) || E < 1 || R < 1 ||
      K < 0 || N < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sz = static_cast<const int*>(sizes);
  if (dtype == ptt::kBF16) {
#if PTT_BUILT_DTYPE(1)
    return sm90::launch_gg<bf16>(lhs, rhs, sz, out, E, R, K, N, trans, st);
#else
    return cudaErrorNotSupported;
#endif
  }
  if (dtype == ptt::kF16) {
#if PTT_BUILT_DTYPE(2)
    return sm90::launch_gg<sm90::f16>(lhs, rhs, sz, out, E, R, K, N, trans, st);
#else
    return cudaErrorNotSupported;
#endif
  }
#if !PTT_BUILT_DTYPE(0)
  return cudaErrorNotSupported;
#endif
  const int tiles = (R + BM - 1) / BM;
  if ((long long)E * tiles > 65535) return cudaErrorInvalidValue;
  const Args a{lhs, rhs, sz, out, R, K, N, tiles};
  const dim3 grid((N + BNF - 1) / BNF, E * tiles);
  if (trans)
    gg_f32_kernel<true><<<grid, kF32Threads, 0, st>>>(a);
  else
    gg_f32_kernel<false><<<grid, kF32Threads, 0, st>>>(a);
  return cudaGetLastError();
}
