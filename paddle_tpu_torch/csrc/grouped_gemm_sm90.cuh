// The 16-bit grouped GEMM of the MoE experts for Hopper (sm_90a): wgmma fed
// by TMA over a persistent list of 128 x 128 output tiles, one source for
// both element types T (bf16 and f16, `sm90.cuh`'s `Elem<T>`).
//
// Replaces, for bfloat16 and float16 inputs, paddle_tpu/ops/pallas/grouped_gemm.py
// `_gg_kernel` :110 (pallas_call :149): out[r] = lhs[r] @ rhs[r / R] over
// the uniform-stride layout, lhs [E*R, K], rhs [E, K, N] (the forward) or
// [E, N, K] read transposed (the backward's dlhs, `_gmm_bwd` :182), f32
// accumulation, the output in T. Float32 keeps grouped_gemm.cu's
// CUDA-core kernel. The semantics are pinned to 64-row units (BM of
// ops/grouped_gemm.py): a unit whose first row is at or past its group's
// live count is zero and multiplies nothing; every row of a unit that holds
// a live row is computed; nothing is ever written past a group's R rows.
//
// Bound on an H100: operations, 2 * (computed rows) * K * N at 989 TFLOP/s
// (bf16 and f16 dense)
// (0.0869 ms at the gpt3_moe rung's [10240, 1024] x [8, 1024, 4096]),
// against ~100 MB of operands (0.03 ms at 3.35 TB/s).
//
// Design (against the WMMA kernel it replaced: 4 warps of mma.sync, one
// stage of loads in flight through registers, one CTA per 64 x 128 tile):
//   1. Products on wgmma. A CTA tile is 128 rows x 128 columns, two
//      consumer warpgroups of one 64-row unit each (a 64 x 128 f32
//      accumulator, 64 registers a thread). lhs is the K-major A operand;
//      dlhs's rhs [E, N, K] is a K-major B (`wgmma_ss_n128`), the forward's
//      rhs [E, K, N] an MN-major B read through the transpose bit
//      (`wgmma_ss_n128_t`): the weights are never copied.
//   2. TMA and a ring. lhs is a tensor map over [E, R, K] and rhs over
//      [E, K, N] (or [E, N, K]), so a box never crosses into the next
//      group: rows past R read as zeros. One producer thread keeps a
//      four-stage ring of 64-deep K slices (A 128 x 64, B 64 x 128, 32 KB
//      a stage, 128-byte swizzled) in flight on mbarriers; each consumer
//      warpgroup keeps one k step of products in flight (wait_group 1)
//      and frees the stage before it.
//   3. Persistent schedule. About one CTA an SM walks the tile list
//      (group, column tile, row tile; row tiles innermost, so the CTAs in
//      flight share a group's A rows and B columns in L2) and reads
//      `sizes` from device memory: nothing syncs with the host. A tile
//      whose two units are dead loads nothing and writes zeros; a dead
//      unit of a live tile writes zeros and issues no product. The
//      producer runs ahead into the next tile while the consumers store.
//   4. The epilogue rounds the accumulator to T into the warpgroup's own
//      32 KB staging tile (same swizzle) and writes 16-byte pieces of its
//      rows, up to the group's R and the output's N.
// Shared memory: 4 stages of 32 KB and the 32 KB staging tile, 160 KB; one
// CTA of 384 threads an SM (setmaxnreg: 40 registers for the producer, 232
// for the consumers).
#pragma once

#include "sm90.cuh"

namespace {
namespace sm90 {

constexpr int kGgUnit = 64;     // rows of a semantic unit and of a warpgroup
constexpr int kGgRows = 128;    // rows of a tile: two units
constexpr int kGgCols = 128;    // columns of a tile
constexpr int kGgDepth = 64;    // K of a stage: one 128-byte panel
constexpr int kGgStages = 4;
constexpr int kGgThreads = 384; // warpgroup 0 loads, 1 and 2 compute
constexpr int kGgA = kGgRows * 128;               // [128 rows][64 k]
constexpr int kGgB = kGgCols * 128;               // [n][64 k], or [n / 64][64 k][64 n]
constexpr int kGgPanel = kGgDepth * 128;          // one [64 k][64 n] panel of B
constexpr int kGgStage = kGgA + kGgB;
constexpr int kGgOut = kGgRows * kGgCols * 2;     // the 16-bit staging tile
constexpr int kGgBars = kGgStages * kGgStage + kGgOut;
constexpr size_t kGgSmem = kGgBars + 2 * kGgStages * 8 + 1024;

template <class T>
struct GgProblem {
  const int* sizes;  // [E] live rows of each group, on the device
  T* out;            // [E * R, N]
  int R, K, N;
  int row_tiles, col_tiles, tiles;  // 128-row tiles a group, column tiles, all
};

// rows [off, off + 64) of group g hold a live row
__device__ __forceinline__ bool unit_live(const int* sizes, int g, int off) {
  return sizes[g] > off;
}

struct GgTile {
  int g, r0, n0;      // group, first row in the group, first column
  bool live0, live1;  // the two 64-row units
};

template <class T>
__device__ __forceinline__ GgTile gg_tile(const GgProblem<T>& p, int t) {
  GgTile x;
  const int per_group = p.row_tiles * p.col_tiles;
  x.g = t / per_group;
  const int rest = t - x.g * per_group;
  x.n0 = (rest / p.row_tiles) * kGgCols;
  x.r0 = (rest % p.row_tiles) * kGgRows;
  x.live0 = unit_live(p.sizes, x.g, x.r0);
  x.live1 = x.r0 + kGgUnit < p.R && unit_live(p.sizes, x.g, x.r0 + kGgUnit);
  return x;
}

// The loads of every live tile of this CTA, K slice by K slice, into the
// ring; one thread.
template <class T, bool kTrans>
__device__ __forceinline__ void gg_produce(const CUtensorMap* amap, const CUtensorMap* bmap,
                                           const GgProblem<T>& p, unsigned char* smem,
                                           uint64_t* full, uint64_t* empty) {
  prefetch_map(amap);
  prefetch_map(bmap);
  const int nk = (p.K + kGgDepth - 1) / kGgDepth;
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const GgTile x = gg_tile(p, t);
    if (!x.live0 && !x.live1) continue;  // a dead tile loads nothing
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int st = it % kGgStages, round = it / kGgStages;
      if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
      unsigned char* a_s = smem + st * kGgStage;
      unsigned char* b_s = a_s + kGgA;
      const int k0 = ks * kGgDepth;
      mbar_expect_tx(&full[st], kGgStage);
      tma_load(a_s, amap, &full[st], k0, 0, x.r0, x.g);
      if (kTrans) {  // rhs [E, N, K]: kGgCols rows of n, 64 of k each
        tma_load(b_s, bmap, &full[st], k0, 0, x.n0, x.g);
      } else {  // rhs [E, K, N]: 64 rows of k, 64-column panels of n
#pragma unroll
        for (int c = 0; c < kGgCols / kPanel; ++c)
          tma_load(b_s + c * kGgPanel, bmap, &full[st], x.n0 + c * kPanel, 0, k0, x.g);
      }
    }
  }
}

// acc (+)= the k step kk (16 deep) of A at a (a descriptor) and B at b
template <class T, bool kTrans>
__device__ __forceinline__ void gg_mma(float (&acc)[kGgCols / 2], uint64_t a, uint32_t b, int kk) {
  if (kTrans)
    wgmma_ss_n128<T>(acc, a, smem_desc(b + kk * 32, 16, 1024), 1);
  else  // 16 rows of k: 2048 bytes; the panels kGgPanel apart
    wgmma_ss_n128_t<T>(acc, a, smem_desc(b + kk * 2048, kGgPanel, 1024), 1);
}

// One consumer warpgroup: unit cw (rows [r0 + 64 cw, + 64)) of every tile
// of this CTA. Thread (warp w, lane) holds rows 16 w + lane / 4 (+8) and,
// of each 8 columns, columns 2 (lane % 4) and +1 (flash_fwd_sm90.cuh's
// fragment layout).
template <class T, bool kTrans>
__device__ __forceinline__ void gg_consume(const GgProblem<T>& p, int cw, unsigned char* smem,
                                           uint64_t* full, uint64_t* empty) {
  const int tid = threadIdx.x - 128 * (cw + 1), warp = tid / 32, lane = tid % 32;
  const int r_a = 16 * warp + lane / 4;  // row within the unit; r_a + 8 the other
  const int col_off = 2 * (lane % 4);
  const int nk = (p.K + kGgDepth - 1) / kGgDepth;
  const uint32_t base = smem_u32(smem);
  unsigned char* stage = smem + kGgStages * kGgStage + cw * (kGgOut / 2);  // [panel][64][128 B]
  int it = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const GgTile x = gg_tile(p, t);
    const bool live = cw ? x.live1 : x.live0;
    const int row0 = x.r0 + kGgUnit * cw;     // the unit's first row in its group
    const int rows = min(kGgUnit, p.R - row0);  // its rows (none past R)
    float acc[kGgCols / 2];
#pragma unroll
    for (int i = 0; i < kGgCols / 2; ++i) acc[i] = 0.f;
    if (x.live0 || x.live1) {
      int prev = 0;
      for (int ks = 0; ks < nk; ++ks, ++it) {
        const int st = it % kGgStages;
        mbar_wait(&full[st], (it / kGgStages) & 1);
        if (live) {
          const uint32_t a = base + st * kGgStage + cw * kGgUnit * 128;
          const uint32_t b = base + st * kGgStage + kGgA;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kGgDepth / 16; ++kk)
            gg_mma<T, kTrans>(acc, smem_desc(a + kk * 32, 16, 1024), b, kk);
          wgmma_commit();
          wgmma_wait_1();  // the previous k step's products are done
          fence_regs(acc);
        }
        if (ks > 0) {  // this warp is done with the previous stage
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = st;
      }
      if (live) {
        wgmma_wait_all();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }

    T* out = p.out + ((long long)x.g * p.R + row0) * p.N + x.n0;
    if (live) {  // T rows into the staging tile, then 16-byte pieces out
      const int swz = r_a & 7;  // r_a and r_a + 8 share it
#pragma unroll
      for (int j = 0; j < kGgCols / 8; ++j) {
        unsigned char* at = stage + (j / 8) * kGgUnit * 128 + (((j % 8) ^ swz) * 16) + 2 * col_off;
        *reinterpret_cast<uint32_t*>(at + r_a * 128) = pack2<T>(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(at + (r_a + 8) * 128) =
            pack2<T>(acc[4 * j + 2], acc[4 * j + 3]);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      for (int i = tid; i < kGgUnit * kGgCols / 8; i += 128) {
        const int r = i / (kGgCols / 8), ch = i % (kGgCols / 8);
        if (r < rows && x.n0 + ch * 8 < p.N)
          *reinterpret_cast<uint4*>(out + (long long)r * p.N + ch * 8) =
              *reinterpret_cast<const uint4*>(stage + (ch / 8) * kGgUnit * 128 + r * 128 +
                                              (((ch % 8) ^ (r & 7)) * 16));
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");  // staging free again
    } else {  // a dead unit: zeros
      for (int i = tid; i < kGgUnit * kGgCols / 8; i += 128) {
        const int r = i / (kGgCols / 8), ch = i % (kGgCols / 8);
        if (r < rows && x.n0 + ch * 8 < p.N)
          *reinterpret_cast<uint4*>(out + (long long)r * p.N + ch * 8) = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

template <class T, bool kTrans>
__global__ void __launch_bounds__(kGgThreads, 1)
gg_sm90_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
               GgProblem<T> p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGgBars);
  uint64_t* empty = full + kGgStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one branch per role, never rejoined (setmaxnreg needs it)
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(40));
    if (threadIdx.x == 0) gg_produce<T, kTrans>(&amap, &bmap, p, smem, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(232));
    gg_consume<T, kTrans>(p, threadIdx.x / 128 - 1, smem, full, empty);
  }
}

// lhs [E * R, K] and rhs [E, K, N] (trans = false) or [E, N, K] (true), of T,
// contiguous, 16-byte aligned, K and N multiples of 8 (the wrapper pads);
// out [E * R, N] of T; sizes [E] int32 on the device.
template <class T>
cudaError_t launch_gg(const void* lhs, const void* rhs, const int* sizes, void* out, int E, int R,
                      int K, int N, bool trans, cudaStream_t st) {
  if (K % 8 || N % 8) return cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  cudaError_t err = encode<T>(&amap, lhs, E, R, 1, K, Strides{(long long)R * K, K, K}, kGgRows);
  if (err == cudaSuccess)
    err = trans ? encode<T>(&bmap, rhs, E, N, 1, K, Strides{(long long)N * K, K, K}, kGgCols)
                : encode<T>(&bmap, rhs, E, K, 1, N, Strides{(long long)K * N, N, N}, kGgDepth);
  if (err != cudaSuccess) return err;
  const int row_tiles = (R + kGgRows - 1) / kGgRows, col_tiles = (N + kGgCols - 1) / kGgCols;
  const long long tiles = (long long)E * row_tiles * col_tiles;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const GgProblem<T> p{sizes, static_cast<T*>(out), R, K, N, row_tiles, col_tiles, (int)tiles};
  const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms));
  return trans ? launch(gg_sm90_kernel<T, true>, grid, kGgThreads, kGgSmem, st, amap, bmap, p)
               : launch(gg_sm90_kernel<T, false>, grid, kGgThreads, kGgSmem, st, amap, bmap, p);
}

}  // namespace sm90
}  // namespace
