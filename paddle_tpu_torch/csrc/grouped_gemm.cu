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
// Design: one CTA per (64-row tile, N tile); `sizes` is read from device
// memory by each CTA (the TPU kernel's scalar prefetch), so the caller
// never syncs with the host. A dead tile writes zeros and exits. Two forms,
// chosen by the dtype:
//   - bf16 (the training path): the tensor cores through WMMA 16x16x16
//     fragments (mma.sync) with f32 accumulation; a 64 x 128 output tile,
//     4 warps of 32 x 64; the K loop stages 64 x 32 A and 32 x 128 B tiles
//     in two shared-memory buffers, the next tile's loads (16 bytes a
//     thread where K and N allow, zero-filled at the ragged edges) in
//     flight in registers while the current one is multiplied. Transposed
//     weights load as a [128 n][32 k] tile and enter as col-major B
//     fragments, so the weights are never copied.
//   - f32: register-tiled FMA on the CUDA cores in full f32 (no TF32), a
//     64 x 64 output tile, 256 threads of 4 x 4 outputs, K in steps of 16.
// wgmma, TMA and a persistent schedule over the live tiles are later work.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;           // row tile: the unit of "computed rows"
constexpr int BN = 128;          // bf16 column tile
constexpr int BK = 32;           // bf16 depth per stage
constexpr int kTcThreads = 128;  // 4 warps, 2 x 2, each 32 rows x 64 columns
constexpr int LDA = BK + 8;      // smem row stride of the [BM][BK] A tile
constexpr int LDB = BN + 8;      // of a [BK][BN] B tile
constexpr int LDBT = BK + 8;     // of a [BN][BK] B tile (transposed weights)
constexpr int BNF = 64;          // f32 column tile
constexpr int BKF = 16;          // f32 depth per stage
constexpr int kF32Threads = 256;

struct Args {
  const void* lhs;
  const void* rhs;
  const int* sizes;
  void* out;
  int R, K, N, tiles;  // tiles: row tiles per group, ceil(R / BM)
  bool vec_a, vec_b;   // 16-byte loads of lhs rows, of rhs rows
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
template <typename T>
__device__ __forceinline__ bool dead_tile(const Args& a, const Tile& t, int bn) {
  if (a.sizes[t.g] > t.off) return false;
  const int ncols = min(bn, a.N - t.n0);
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < t.rows * ncols; i += blockDim.x)
    out[(t.row0 + i / ncols) * a.N + t.n0 + i % ncols] = ptt::from_f32<T>(0.f);
  return true;
}

// 8 consecutive bf16 of row r from column c of a row-major [n_rows, n_cols]
// matrix with row stride ld; zero outside it.
__device__ __forceinline__ uint4 load8(const bf16* base, long long ld, int r, int c, int n_rows,
                                       int n_cols, bool vec) {
  if (r < n_rows && vec && c + 8 <= n_cols)
    return *reinterpret_cast<const uint4*>(base + r * ld + c);
  uint4 v;
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = (r < n_rows && c + i < n_cols) ? base[r * ld + c + i] : __float2bfloat16(0.f);
  return v;
}

template <bool kTrans>
__global__ void __launch_bounds__(kTcThreads) gg_tc_kernel(Args a) {
  constexpr int kB = kTrans ? BN * LDBT : BK * LDB;
  __shared__ __align__(128) bf16 As[2][BM * LDA];
  __shared__ __align__(128) bf16 Bs[2][kB];
  __shared__ __align__(128) float stage[kTcThreads / 32][16 * 16];

  const Tile t = tile_of(a, BN);
  if (dead_tile<bf16>(a, t, BN)) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 64;  // the warp's rows, columns
  const bf16* A = static_cast<const bf16*>(a.lhs) + t.row0 * a.K;
  const bf16* B = static_cast<const bf16*>(a.rhs) + (long long)t.g * a.K * a.N;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wm::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2], rb[4];  // the next stage's A and B chunks, in flight
  auto gload = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + kTcThreads * e;  // A: 4 chunks of 8 a row
      ra[e] = load8(A, a.K, i / 4, k0 + (i % 4) * 8, t.rows, a.K, a.vec_a);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = tid + kTcThreads * e;
      if (kTrans)  // B^T tile [BN n][BK k]: rhs [E, N, K]
        rb[e] = load8(B, a.K, t.n0 + i / 4, k0 + (i % 4) * 8, a.N, a.K, a.vec_b);
      else  // B tile [BK k][BN n]: rhs [E, K, N]
        rb[e] = load8(B, a.N, k0 + i / 16, t.n0 + (i % 16) * 8, a.K, a.N, a.vec_b);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + kTcThreads * e;
      *reinterpret_cast<uint4*>(&As[buf][(i / 4) * LDA + (i % 4) * 8]) = ra[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = tid + kTcThreads * e;
      if (kTrans)
        *reinterpret_cast<uint4*>(&Bs[buf][(i / 4) * LDBT + (i % 4) * 8]) = rb[e];
      else
        *reinterpret_cast<uint4*>(&Bs[buf][(i / 16) * LDB + (i % 16) * 8]) = rb[e];
    }
  };

  const int nk = (a.K + BK - 1) / BK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) gload((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wm::load_matrix_sync(fa[i], &As[buf][(wr + 16 * i) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kTrans) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> fb;
          wm::load_matrix_sync(fb, &Bs[buf][(wc + 16 * j) * LDBT + kk], LDBT);
#pragma unroll
          for (int i = 0; i < 2; ++i) wm::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        } else {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
          wm::load_matrix_sync(fb, &Bs[buf][kk * LDB + wc + 16 * j], LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i) wm::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    }
    // the other buffer's last readers passed the previous barrier
    if (kt + 1 < nk) sstore(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each 16 x 16 fragment through the warp's f32 staging tile
  bf16* out = static_cast<bf16*>(a.out);
  float* st = stage[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wm::store_matrix_sync(st, acc[i][j], 16, wm::mem_row_major);
      __syncwarp();
      const int row = wr + 16 * i + r;
      const int col = t.n0 + wc + 16 * j + c0;
      if (row < t.rows) {
        bf16* o = out + (t.row0 + row) * a.N;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < a.N) o[col + e] = __float2bfloat16(st[r * 16 + c0 + e]);
      }
      __syncwarp();
    }
}

template <bool kTrans>
__global__ void __launch_bounds__(kF32Threads) gg_f32_kernel(Args a) {
  __shared__ float As[BKF][BM + 4];   // [k][row]
  __shared__ float Bs[BKF][BNF + 4];  // [k][col]
  const Tile t = tile_of(a, BNF);
  if (dead_tile<float>(a, t, BNF)) return;
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// out [E*R, N] = the grouped product of lhs [E*R, K] and rhs [E, K, N]
// (trans = 0) or rhs [E, N, K] read transposed (trans = 1), all contiguous
// in one dtype (float32 or bfloat16); sizes [E] int32 on the device, the
// live rows of each group. Returns cudaGetLastError() after the launch.
extern "C" int ptt_grouped_gemm(const void* lhs, const void* rhs, const void* sizes, void* out,
                                int E, int R, int K, int N, int trans, int dtype,
                                void* stream) {
  if ((dtype != ptt::kF32 && dtype != ptt::kBF16) || E < 1 || R < 1 || K < 0 || N < 1)
    return cudaErrorInvalidValue;
  const int tiles = (R + BM - 1) / BM;
  if ((long long)E * tiles > 65535) return cudaErrorInvalidValue;
  Args a{lhs, rhs, static_cast<const int*>(sizes), out, R, K, N, tiles, false, false};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) {
    const dim3 grid((N + BNF - 1) / BNF, E * tiles);
    if (trans)
      gg_f32_kernel<true><<<grid, kF32Threads, 0, st>>>(a);
    else
      gg_f32_kernel<false><<<grid, kF32Threads, 0, st>>>(a);
    return cudaGetLastError();
  }
  a.vec_a = K % 8 == 0 && aligned16(lhs);
  a.vec_b = (trans ? K : N) % 8 == 0 && aligned16(rhs);
  const dim3 grid((N + BN - 1) / BN, E * tiles);
  if (trans)
    gg_tc_kernel<true><<<grid, kTcThreads, 0, st>>>(a);
  else
    gg_tc_kernel<false><<<grid, kTcThreads, 0, st>>>(a);
  return cudaGetLastError();
}
