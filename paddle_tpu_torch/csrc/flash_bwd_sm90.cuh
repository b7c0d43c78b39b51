// The 16-bit attention backward for Hopper (sm_90a): dQ and dK/dV on wgmma
// fed by TMA, templated on the element type T (bf16 or f16) and the mask
// policy as the forward (flash_fwd_sm90.cuh) is, and reading the forward's
// 128 x 128 tile classes.
//
// Replaces, for bfloat16 and float16 inputs, six TPU kernels (float32 keeps the
// CUDA-core `flash_dq_kernel` and `flash_dkv_kernel` of flash_tiles.cuh):
//   - paddle_tpu/ops/pallas/masked_flash.py `_fm_bwd_dq_kernel` :138
//     (pallas_call :291): dQ = dS K;
//   - paddle_tpu/ops/pallas/masked_flash.py `_fm_bwd_dkv_kernel` :182
//     (pallas_call :311): dV = P^T dO and dK = dS^T Q;
// under masked_flash.cu's `FlashMask` (top-left causal and the per-column
// row ranges of `FlashMask::keep`);
//   - paddle_tpu/ops/pallas/flash_attention.py `_bwd_dq_kernel` :332
//     (pallas_call :528) and `_bwd_dkv_kernel` :406 (pallas_call :557);
// under flash_attention.cu's `CausalBias` (bottom-right causal, whose
// offset Skv - Sq need not be a multiple of a tile, and an additive key
// bias read on every tile); and
//   - paddle_tpu/ops/pallas/masked_flash.py `_vl_bwd_dq_kernel` :490
//     (pallas_call :680) and `_vl_bwd_dkv_kernel` :529 (pallas_call :695);
// under varlen_flash.cu's `Varlen` (packed documents, top-left causal
// within each). P = exp(S - LSE) is
// recomputed from the forward's f32 LSE and dS = P (dO V^T - delta) scale,
// delta = rowsum(dO O) in f32; P and dS are rounded to T before their
// products (as the TPU flash kernels cast p and ds to the operand type; the
// TPU varlen kernels keep them in f32), every sum is f32. A row that keeps no key has LSE = +inf: its P, dS and dQ are
// exactly 0. GQA: query head h reads kv head h / g (and the policy's mask
// head).
//
// Bound on an H100: operations at 989 TFLOP/s (bf16 and f16 dense), dQ 6 D and
// dK/dV 8 D per kept (row, key) pair: 0.209 and 0.278 ms at the LLaMA-7B
// step's shape (masked_flash.cu), 0.104 and 0.139 ms at the gpt3_1p3b
// step's (flash_attention.cu), 0.280 and 0.374 ms at the varlen pack's
// (varlen_flash.cu).
//
// Design (against the WMMA kernels it replaced: 64 x 64 tiles, score tiles
// through shared memory, synchronous loads, a CTA vote to skip a tile):
//   1. Products on wgmma (sm90.cuh) from 64-column 128-byte-swizzled
//      panels loaded by TMA. The score products are SS from K-major panels
//      (dQ: S = Q K^T and dP = dO V^T, m64n128k16; dK/dV: S^T = K Q^T and
//      dP^T = V dO^T, m64n64k16); the gradient products are RS m64n64k16
//      with T dS or P as the register A operand and the row-major tile
//      (K, dO, Q) read MN-major through the transpose bit. No operand is
//      transposed in HBM.
//   2. Scores stay in registers: P and dS are formed on the accumulator
//      fragments (exp2f, log2(e) folded into the scale and the LSE) and
//      packed to T pairs in the A-fragment layout, an m64 accumulator's
//      own, k step by k step. No score tile goes through shared memory.
//   3. Two warpgroups of 64 rows (keys) each compute; a two-stage ring of
//      TMA loads on mbarriers feeds them. There is no producer warp: the
//      kernels hold more registers than a 384-thread kernel may
//      (kBwdThreads), so thread 0 issues the first loads and the last of
//      the 8 warps to finish a step refills that step's stage, and
//      neither warpgroup waits for the other to load.
//   4. Tile classes, not a vote: a (128-row q tile, 128-key kv tile) that
//      the forward's table classes skipped is never loaded, a full one
//      runs no predicate, a partial one applies keep() to the fragment.
//   5. dK/dV of a kv head: a CTA owns 128 keys of one kv head (64 a
//      warpgroup), loads K and V once and loops over the g query heads of
//      that kv head and, for each, the 64-row q steps that can see the
//      keys, up to the policy's `q_tiles(p, k0, kBN)` over all 128 keys
//      (a step reads the class of the 128-row tile that holds it,
//      conservative for either half; a warpgroup skips the steps whose
//      rows all precede its keys). Each step brings Q and dO through the
//      ring, and each lane reads two rows' LSE and delta, which the quads
//      fetch by shuffles. S^T and dP^T put a key in each accumulator row,
//      so P^T and dS^T are the A operands of dV += P^T dO and
//      dK += dS^T Q. The CTA writes its kv head's f32 dK and dV once: no
//      atomics, the same bits every run, and g times fewer bytes than a
//      slice per query head. The policy orders the CTAs (`key_tile`): flash
//      and flashmask launch the lowest key tiles first, which the most q
//      steps see under causality; varlen the key tiles with the most q
//      tiles not skipped, so the longest CTAs of a pack's documents do not
//      land in the last wave.
//   6. dQ: a CTA owns 128 q rows of a head (64 a warpgroup), loads Q and
//      dO once and streams the visited K/V tiles (K and V on their own
//      barriers, so S starts before V lands); dQ += dS K takes the whole
//      128-key tile (S and dP 64 registers each beside 64 of dQ at
//      D = 128). dQ leaves in T through the warpgroup's Q rows with
//      16-byte stores, as the forward's epilogue does. The last q tiles
//      (the longest causal rows) launch first.
// Shared memory: dQ 192 KB at D = 128 (Q, dO, two K/V stages), dK/dV
// 128 KB (K, V, two Q/dO stages); half that at D <= 64. One CTA an SM.
//
// The 192 width (three panels, D in 129..192):
//   - dQ walks each 128-key tile in two 64-key halves, each a ring stage
//     (the forward's `kSub`): S 32 + dP 32 + dQ 96 registers, 192 KB;
//   - dK/dV would hold dK 96 + dV 96 + S^T 32 + dP^T 32 registers a thread,
//     above the 255 a thread may have. So two CTAs share a (kv head, key
//     tile), blockIdx.x = 2 hk + part: part 0 computes S^T and dP^T and
//     writes dK (176 registers of products), part 1 computes S^T alone and
//     writes dV and loads no V. That is 6 D + 4 D = 10 D operations a pair
//     against 8 D: 1.25 times the products of one pass, and Q and dO read
//     twice. Shared memory stays 192 KB (K, V, two Q/dO stages).
#pragma once

#include "flash_fwd_sm90.cuh"

namespace {
namespace sm90 {

constexpr int kStep = 64;  // q rows of a dK/dV step
// Two warpgroups that compute and load, no producer warp: ptxas holds a
// 384-thread kernel (the forward's three warpgroups) to 168 registers a
// thread whatever setmaxnreg asks later, and both kernels hold more (dK,
// dV, S^T and dP^T; dQ, S and dP of a 128-key tile). A 256-thread kernel
// may use 255.
constexpr int kBwdThreads = 256;
static_assert(kStep == kTile, "a dK/dV q step is the policies' q tile (first_q_tile)");

// acc[c] += A B over K rows of B: A fragments of T, K / 16 k steps; B the
// rows at b_addr of [panel][b_rows][64] tiles, read MN-major (panel c:
// columns 64 c ..)
template <class T, int DT, int K>
__device__ __forceinline__ void rs_rows(float (&acc)[DT / kPanel][32],
                                        const uint32_t (&a)[K / 16][4], uint32_t b_addr,
                                        int b_rows) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)  // 16 rows of B: 2048 bytes
#pragma unroll
    for (int c = 0; c < DT / kPanel; ++c)
      wgmma_rs_n64_t<T>(acc[c], a[kk], smem_desc(b_addr + c * b_rows * 128 + kk * 2048, 1024, 1024));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// ---------------------------------------------------------------- dQ

template <int DT>
struct DqLayout {  // Q, dO, the K ring, the V ring, barriers (the forward's tiles)
  static constexpr int kQ = Layout<DT>::kQ;
  static constexpr int kKV = Layout<DT>::kKV;
  static constexpr int kK = 2 * kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBars = kV + kStages * kKV;  // q_full, k_full[], v_full[], done[]
  static constexpr size_t kSmem = kBars + (1 + 2 * kStages) * 8 + kStages * 4 + 1024;
};

// The ring steps of a dQ CTA (kv tiles, or their 64-key halves at the 192
// width), in order: advances t to the next step of [t, n) that the classes
// do not skip; false past the last.
template <int DT, class M>
__device__ __forceinline__ bool seek_tile(const Problem& p, const M& mask, int b, int h, int q0,
                                          int n, int& t) {
  for (; t < n; ++t)
    if (sub_class<DT>(p, mask, b, h, q0, t) != kSkipTile) return true;
  return false;
}

// K and V of ring step t (keys [t kSub, + kSub)) into ring stage st by TMA,
// each on its own barrier (S starts before V lands); one thread
template <int DT>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        unsigned char* smem, uint64_t* k_full, uint64_t* v_full,
                                        int st, int b, int hk, int t) {
  using L = DqLayout<DT>;
  constexpr int kN = Layout<DT>::kSub;
  mbar_expect_tx(&k_full[st], L::kKV);
#pragma unroll
  for (int c = 0; c < DT / kPanel; ++c)
    tma_load(smem + L::kK + st * L::kKV + c * kN * 128, kmap, &k_full[st], c * kPanel, hk,
             t * kN, b);
  mbar_expect_tx(&v_full[st], L::kKV);
#pragma unroll
  for (int c = 0; c < DT / kPanel; ++c)
    tma_load(smem + L::kV + st * L::kKV + c * kN * 128, vmap, &v_full[st], c * kPanel, hk,
             t * kN, b);
}

// One warpgroup (threads 128 cw ..) of the dQ kernel: rows [q0 + 64 cw,
// + 64), in the forward's fragment layout (flash_fwd_sm90.cuh `consume`).
// The loads as in dK/dV: the last of the 8 warps to finish a kv tile
// refills its stage with the tile kStages ahead.
template <class T, int DT, class M>
__device__ __forceinline__ void dq_consume(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                           const Problem& p, const M& mask, int b, int h, int q0,
                                           int n_kv, int cw, unsigned char* smem,
                                           uint64_t* q_full, uint64_t* k_full, uint64_t* v_full,
                                           unsigned* done, const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           T* __restrict__ dq) {
  using L = DqLayout<DT>;
  constexpr int kPanels = DT / kPanel;
  constexpr int kN = Layout<DT>::kSub;  // keys of a step
  const int tid = threadIdx.x - 128 * cw, warp = tid / 32, lane = tid % 32;
  const int r_a = 16 * warp + lane / 4;  // row within the warpgroup's 64; r_a + 8 the other
  const int row0 = q0 + 64 * cw, row_a = row0 + r_a, row_b = row_a + 8;
  const int col_off = 2 * (lane % 4);
  const bool active = row0 < p.Sq;  // uniform over the warpgroup
  const int hk = h / p.g;

  // the current step t and the one kStages ahead tl, the prologue's loads
  // by thread 0
  const int n = n_kv * Layout<DT>::kHalves;
  int t = 0;
  bool more = seek_tile<DT>(p, mask, b, h, q0, n, t);
  int tl = t;
  bool ahead = more;
  for (int s = 0; s < kStages && ahead; ++s) {
    if (threadIdx.x == 0) load_kv<DT>(kmap, vmap, smem, k_full, v_full, s, b, hk, tl);
    ++tl;
    ahead = seek_tile<DT>(p, mask, b, h, q0, n, tl);
  }

  const float sl2 = p.scale * kLog2e;
  const long long at = ((long long)b * p.H + h) * p.Sq;
  const float lse_a = row_a < p.Sq ? lse[at + row_a] * kLog2e : INFINITY;
  const float lse_b = row_b < p.Sq ? lse[at + row_b] * kLog2e : INFINITY;
  const float dl_a = row_a < p.Sq ? delta[at + row_a] : 0.f;
  const float dl_b = row_b < p.Sq ? delta[at + row_b] : 0.f;
  float acc[kPanels][32];
#pragma unroll
  for (int c = 0; c < kPanels; ++c) zero(acc[c]);
  const uint32_t q_addr = smem_u32(smem) + 64 * cw * 128;
  const uint32_t o_addr = q_addr + L::kQ;
  mbar_wait(q_full, 0);

  for (int it = 0; more; ++it) {
    const int k0 = t * kN;
    const int cls = sub_class<DT>(p, mask, b, h, q0, t);
    const bool partial = cls == kPartialTile;
    const int st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const uint32_t k_addr = smem_u32(smem) + L::kK + st * L::kKV;
    const uint32_t v_addr = smem_u32(smem) + L::kV + st * L::kKV;
    mbar_wait(&k_full[st], phase);
    if (active) {
      float s[kN / 2], dp[kN / 2];
      zero(s);
      fence_regs(s);
      wgmma_fence();
      ss_rows<T, DT, kN>(s, q_addr, kBM, k_addr, kN);  // S = Q K^T, while V lands
      wgmma_commit();
      mbar_wait(&v_full[st], phase);
      zero(dp);
      fence_regs(dp);
      wgmma_fence();
      ss_rows<T, DT, kN>(dp, o_addr, kBM, v_addr, kN);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // dS, packed k step by k step as it is formed; the predicate on
      // partial tiles only
      uint32_t ds[kN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + col_off + e;
            float bias = 0.f;
            bool keep_a = true, keep_b = true;
            if (partial || mask.has_bias()) {
              const typename M::Key key = mask.key(p, b, h, col);
              bias = mask.bias(key) * kLog2e;
              if (partial) {
                keep_a = mask.keep(p, row_a, col, key);
                keep_b = mask.keep(p, row_b, col, key);
              }
            }
            const float pa = keep_a ? exp2f(fmaf(s[4 * j + e], sl2, bias - lse_a)) : 0.f;
            const float pb = keep_b ? exp2f(fmaf(s[4 * j + 2 + e], sl2, bias - lse_b)) : 0.f;
            s[4 * j + e] = pa * (dp[4 * j + e] - dl_a) * p.scale;
            s[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl_b) * p.scale;
          }
        ds[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
        ds[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        ds[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        ds[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }

#pragma unroll
      for (int c = 0; c < kPanels; ++c) fence_regs(acc[c]);
      wgmma_fence();
      rs_rows<T, DT, kN>(acc, ds, k_addr, kN);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kPanels; ++c) fence_regs(acc[c]);
    } else {
      mbar_wait(&v_full[st], phase);
    }
    // the last of the 8 warps done with the stage refills it
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[st], 1u) % 8 == 7 && ahead)
        load_kv<DT>(kmap, vmap, smem, k_full, v_full, st, b, hk, tl);
    }
    if (ahead) {
      ++tl;
      ahead = seek_tile<DT>(p, mask, b, h, q0, n, tl);
    }
    ++t;
    more = seek_tile<DT>(p, mask, b, h, q0, n, t);
  }

  if (!active) return;
  // dQ into this warpgroup's own rows of the Q tile (its products read
  // them last), in the 128-byte swizzle, then 16-byte rows out
  unsigned char* stage = smem + 64 * cw * 128;
  const int swz = r_a & 7;  // r_a and r_a + 8 share it
#pragma unroll
  for (int c = 0; c < kPanels; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned char* to = stage + c * kBM * 128 + ((j ^ swz) * 16) + 2 * col_off;
      *reinterpret_cast<uint32_t*>(to + r_a * 128) = pack2<T>(acc[c][4 * j], acc[c][4 * j + 1]);
      *reinterpret_cast<uint32_t*>(to + (r_a + 8) * 128) =
          pack2<T>(acc[c][4 * j + 2], acc[c][4 * j + 3]);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  constexpr int kChunks = DT / 8;  // 16-byte chunks of a row
  for (int i = tid; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, ch = i % kChunks, row = row0 + r;
    if (row < p.Sq && ch * 8 < p.D)
      *reinterpret_cast<uint4*>(dq + (((long long)b * p.Sq + row) * p.H + h) * p.D + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + (ch / 8) * kBM * 128 + r * 128 +
                                          (((ch % 8) ^ (r & 7)) * 16));
  }
}

template <class T, int DT, class M>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap omap, Problem p, M mask,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq) {
  using L = DqLayout<DT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  unsigned* done = reinterpret_cast<unsigned*>(v_full + kStages);  // warps done, cumulative

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // the longest causal rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_kv = mask.kv_tiles(p, q0, kBM, kBN);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&omap);
    mbar_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
    for (int c = 0; c < DT / kPanel; ++c) {
      tma_load(smem + c * kBM * 128, &qmap, q_full, c * kPanel, h, q0, b);
      tma_load(smem + L::kQ + c * kBM * 128, &omap, q_full, c * kPanel, h, q0, b);
    }
  }
  __syncthreads();
  dq_consume<T, DT>(&kmap, &vmap, p, mask, b, h, q0, n_kv, threadIdx.x / 128, smem, q_full, k_full,
                 v_full, done, lse, delta, dq);
}

// ---------------------------------------------------------------- dK, dV

template <int DT>
struct DkvLayout {  // bytes of the dynamic shared memory, from a 1024-aligned base
  static constexpr int kPanels = DT / kPanel;
  static constexpr int kParts = DT > 128 ? 2 : 1;     // CTAs of a (kv head, key tile)
  static constexpr int kKV = kPanels * kBN * 128;     // K or V: [panel][kBN][64]
  static constexpr int kQ = kPanels * kStep * 128;    // one Q or dO stage: [panel][kStep][64]
  static constexpr int kQs = 2 * kKV;                 // Q stages, after K and V
  static constexpr int kOs = kQs + kStages * kQ;   // dO stages
  static constexpr int kBars = kOs + kStages * kQ; // kv_full, full[stage], done[stage]
  static constexpr size_t kSmem = kBars + (1 + kStages) * 8 + kStages * 4 + 1024;
};

// The steps of a dK/dV CTA, in order: for each query head h of [h, h1)
// the 64-row q steps t of [t, n_q) whose 128 x 128 tile is not skipped.
// Advances (h, t) to the next step at or after it; false past the last.
template <class M>
__device__ __forceinline__ bool seek_step(const Problem& p, const M& mask, int b, int k0,
                                          int h1, int t0, int n_q, int& h, int& t) {
  for (; h < h1; ++h, t = t0)
    for (; t < n_q; ++t)
      if (mask.tile_class(p, b, h, t * kStep, k0, kBM, kBN) != kSkipTile) return true;
  return false;
}

// Q and dO of step (h, t) into ring stage st by TMA (one thread)
template <int DT>
__device__ __forceinline__ void load_step(const CUtensorMap* qmap, const CUtensorMap* omap,
                                          unsigned char* smem, uint64_t* full, int st, int b,
                                          int h, int t) {
  using L = DkvLayout<DT>;
  mbar_expect_tx(&full[st], 2 * L::kQ);
#pragma unroll
  for (int c = 0; c < L::kPanels; ++c) {
    tma_load(smem + L::kQs + st * L::kQ + c * kStep * 128, qmap, &full[st], c * kPanel, h,
             t * kStep, b);
    tma_load(smem + L::kOs + st * L::kQ + c * kStep * 128, omap, &full[st], c * kPanel, h,
             t * kStep, b);
  }
}

// One consumer warpgroup (threads 128 cw ..) of the dK/dV kernel: keys
// [k0 + 64 cw, + 64). Thread (warp w, lane) holds keys 16 w + lane / 4
// (+8) of S^T and dP^T, and of each 8 q rows of a step rows 2 (lane % 4)
// and +1. The loads need no producer: the last of the 8 warps to finish a
// step refills its stage with the step kStages ahead, so a warpgroup
// never waits for the other to load. Each lane reads two rows' LSE and
// delta of a step, which the quads fetch by shuffles. `Part` says what
// the CTA writes: both (kDkDv), or at the 192 width dK alone (kDkOnly) or
// dV alone (kDvOnly, which needs neither V nor dP^T).
enum DkvPart { kDkDv = 0, kDkOnly = 1, kDvOnly = 2 };

template <class T, int DT, class M, int Part>
__device__ __forceinline__ void dkv_consume(const CUtensorMap* qmap, const CUtensorMap* omap,
                                            const Problem& p, const M& mask, int b, int hk,
                                            int h0, int h1, int k0, int cw, unsigned char* smem,
                                            uint64_t* kv_full, uint64_t* full, unsigned* done,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            float* __restrict__ dk, float* __restrict__ dv) {
  using L = DkvLayout<DT>;
  constexpr int kPanels = L::kPanels;
  constexpr bool kDk = Part != kDvOnly, kDv = Part != kDkOnly;
  const int tid = threadIdx.x - 128 * cw, warp = tid / 32, lane = tid % 32;
  const int r_a = 16 * warp + lane / 4;
  const int key0 = k0 + 64 * cw, key_a = key0 + r_a, key_b = key_a + 8;
  const int col_off = 2 * (lane % 4);
  const bool active = key0 < p.Skv;  // uniform over the warpgroup
  const float sl2 = p.scale * kLog2e;
  const int t0 = mask.first_q_tile(p, k0), n_q = mask.q_tiles(p, k0, kBN);
  const int t_wg = mask.first_q_tile(p, key0);  // the first q step that sees these keys

  // the current step (h, t) and the one kStages ahead (hl, tl), the
  // prologue's loads by thread 0
  int h = h0, t = t0;
  bool more = seek_step(p, mask, b, k0, h1, t0, n_q, h, t);
  int hl = h, tl = t;
  bool ahead = more;
  for (int s = 0; s < kStages && ahead; ++s) {
    if (threadIdx.x == 0) load_step<DT>(qmap, omap, smem, full, s, b, hl, tl);
    ++tl;
    ahead = seek_step(p, mask, b, k0, h1, t0, n_q, hl, tl);
  }

  float dka[kPanels][32], dva[kPanels][32];
#pragma unroll
  for (int c = 0; c < kPanels; ++c) {
    if constexpr (kDk) zero(dka[c]);
    if constexpr (kDv) zero(dva[c]);
  }
  const uint32_t base = smem_u32(smem);
  const uint32_t k_addr = base + 64 * cw * 128, v_addr = base + L::kKV + 64 * cw * 128;
  mbar_wait(kv_full, 0);

  for (int it = 0; more; ++it) {
    const int st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const int q0 = t * kStep;
    const int cls = mask.tile_class(p, b, h, q0, k0, kBM, kBN);
    const bool partial = cls == kPartialTile;
    // LSE (log2 units) and delta of rows q0 + lane and q0 + 32 + lane
    const long long at = ((long long)b * p.H + h) * p.Sq + q0 + lane;
    const bool in_lo = q0 + lane < p.Sq, in_hi = q0 + 32 + lane < p.Sq;
    const float l_lo = in_lo ? lse[at] * kLog2e : INFINITY;
    const float l_hi = in_hi ? lse[at + 32] * kLog2e : INFINITY;
    const float d_lo = in_lo ? delta[at] : 0.f, d_hi = in_hi ? delta[at + 32] : 0.f;
    mbar_wait(&full[st], phase);
    if (active && t >= t_wg) {
      const uint32_t q_addr = base + L::kQs + st * L::kQ, o_addr = base + L::kOs + st * L::kQ;
      float s[32], dp[32];
      zero(s);
      fence_regs(s);
      if constexpr (kDk) {
        zero(dp);
        fence_regs(dp);
      }
      wgmma_fence();
      ss_rows<T, DT, kStep>(s, k_addr, kBN, q_addr, kStep);  // S^T = K Q^T
      if constexpr (kDk) ss_rows<T, DT, kStep>(dp, v_addr, kBN, o_addr, kStep);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if constexpr (kDk) fence_regs(dp);

      // P^T and dS^T, packed k step by k step as they are formed; the
      // keys' indices (and the predicate) on partial tiles only
      typename M::Key ka{}, kb{};
      float bias_a = 0.f, bias_b = 0.f;
      if (partial || mask.has_bias()) {
        ka = mask.key(p, b, h, key_a);
        kb = mask.key(p, b, h, key_b);
        bias_a = mask.bias(ka) * kLog2e;
        bias_b = mask.bias(kb) * kLog2e;
      }
      uint32_t pt[4][4], dst[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + col_off + e, row = q0 + c;
            const float l2 = __shfl_sync(0xffffffffu, j < 4 ? l_lo : l_hi, c % 32);
            const float dl = kDk ? __shfl_sync(0xffffffffu, j < 4 ? d_lo : d_hi, c % 32) : 0.f;
            const bool keep_a = !partial || mask.keep(p, row, key_a, ka);
            const bool keep_b = !partial || mask.keep(p, row, key_b, kb);
            const float pa = keep_a ? exp2f(fmaf(s[4 * j + e], sl2, bias_a - l2)) : 0.f;
            const float pb = keep_b ? exp2f(fmaf(s[4 * j + 2 + e], sl2, bias_b - l2)) : 0.f;
            s[4 * j + e] = pa;
            s[4 * j + 2 + e] = pb;
            if constexpr (kDk) {
              dp[4 * j + e] = pa * (dp[4 * j + e] - dl) * p.scale;
              dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl) * p.scale;
            }
          }
        if constexpr (kDv) {
          pt[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
          pt[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
          pt[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
          pt[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
        }
        if constexpr (kDk) {
          dst[kk][0] = pack2<T>(dp[8 * kk], dp[8 * kk + 1]);
          dst[kk][1] = pack2<T>(dp[8 * kk + 2], dp[8 * kk + 3]);
          dst[kk][2] = pack2<T>(dp[8 * kk + 4], dp[8 * kk + 5]);
          dst[kk][3] = pack2<T>(dp[8 * kk + 6], dp[8 * kk + 7]);
        }
      }

#pragma unroll
      for (int c = 0; c < kPanels; ++c) {
        if constexpr (kDk) fence_regs(dka[c]);
        if constexpr (kDv) fence_regs(dva[c]);
      }
      wgmma_fence();
      if constexpr (kDv) rs_rows<T, DT, kStep>(dva, pt, o_addr, kStep);   // dV += P^T dO
      if constexpr (kDk) rs_rows<T, DT, kStep>(dka, dst, q_addr, kStep);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < kPanels; ++c) {
        if constexpr (kDk) fence_regs(dka[c]);
        if constexpr (kDv) fence_regs(dva[c]);
      }
    }
    // the last of the 8 warps done with the stage refills it
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[st], 1u) % 8 == 7 && ahead)
        load_step<DT>(qmap, omap, smem, full, st, b, hl, tl);
    }
    if (ahead) {
      ++tl;
      ahead = seek_step(p, mask, b, k0, h1, t0, n_q, hl, tl);
    }
    ++t;
    more = seek_step(p, mask, b, k0, h1, t0, n_q, h, t);
  }

  if (!active) return;
  // the kv head's f32 rows of [B, Skv, Hkv, D], 8 bytes a store
  const int Hkv = p.H / p.g;
  const long long row_a = (((long long)b * p.Skv + key_a) * Hkv + hk) * p.D;
  const long long row_b = (((long long)b * p.Skv + key_b) * Hkv + hk) * p.D;
#pragma unroll
  for (int c = 0; c < kPanels; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * kPanel + 8 * j + col_off;
      if (col >= p.D) continue;
      if (key_a < p.Skv) {
        if constexpr (kDk)
          *reinterpret_cast<float2*>(dk + row_a + col) = make_float2(dka[c][4 * j], dka[c][4 * j + 1]);
        if constexpr (kDv)
          *reinterpret_cast<float2*>(dv + row_a + col) = make_float2(dva[c][4 * j], dva[c][4 * j + 1]);
      }
      if (key_b < p.Skv) {
        if constexpr (kDk)
          *reinterpret_cast<float2*>(dk + row_b + col) =
              make_float2(dka[c][4 * j + 2], dka[c][4 * j + 3]);
        if constexpr (kDv)
          *reinterpret_cast<float2*>(dv + row_b + col) =
              make_float2(dva[c][4 * j + 2], dva[c][4 * j + 3]);
      }
    }
}

template <class T, int DT, class M>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap, Problem p, M mask,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv) {
  using L = DkvLayout<DT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kv_full + 1;
  unsigned* done = reinterpret_cast<unsigned*>(full + kStages);  // warps done, cumulative

  constexpr int kParts = DkvLayout<DT>::kParts;
  const int hk = blockIdx.x / kParts, b = blockIdx.y;
  const bool dv_only = kParts == 2 && blockIdx.x % 2 == 1;  // needs no V
  const int h0 = hk * p.g, h1 = h0 + p.g;  // the query heads of kv head hk
  const int k0 = mask.key_tile(blockIdx.z) * kBN;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&omap);
    mbar_expect_tx(kv_full, (dv_only ? 1 : 2) * L::kKV);
#pragma unroll
    for (int c = 0; c < L::kPanels; ++c) {
      tma_load(smem + c * kBN * 128, &kmap, kv_full, c * kPanel, hk, k0, b);
      if (!dv_only)
        tma_load(smem + L::kKV + c * kBN * 128, &vmap, kv_full, c * kPanel, hk, k0, b);
    }
  }
  __syncthreads();
  const int cw = threadIdx.x / 128;
  if constexpr (kParts == 1)
    dkv_consume<T, DT, M, kDkDv>(&qmap, &omap, p, mask, b, hk, h0, h1, k0, cw, smem, kv_full, full,
                              done, lse, delta, dk, dv);
  else if (dv_only)
    dkv_consume<T, DT, M, kDvOnly>(&qmap, &omap, p, mask, b, hk, h0, h1, k0, cw, smem, kv_full,
                                full, done, lse, delta, dk, dv);
  else
    dkv_consume<T, DT, M, kDkOnly>(&qmap, &omap, p, mask, b, hk, h0, h1, k0, cw, smem, kv_full,
                                full, done, lse, delta, dk, dv);
}

// ---------------------------------------------------------------- host

template <class T, int DT, class M>
cudaError_t launch_bwd(const Problem& p, const M& m, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta, void* dq,
                       float* dk, float* dv, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap, omap;
  const int Hkv = p.H / p.g;
  const int rows = dq != nullptr ? kBM : kStep;  // a dQ CTA's rows or a dK/dV step's
  const int keys = dq != nullptr ? Layout<DT>::kSub : kBN;  // a dQ ring step's or a dK/dV CTA's
  cudaError_t err = encode<T>(&qmap, q, p.B, p.Sq, p.H, p.D, p.q, rows);
  if (err == cudaSuccess) err = encode<T>(&kmap, k, p.B, p.Skv, Hkv, p.D, p.k, keys);
  if (err == cudaSuccess) err = encode<T>(&vmap, v, p.B, p.Skv, Hkv, p.D, p.v, keys);
  if (err == cudaSuccess) err = encode<T>(&omap, dout, p.B, p.Sq, p.H, p.D, p.o, rows);
  if (err != cudaSuccess) return err;
  if (dq != nullptr)
    return launch(flash_bwd_dq_sm90_kernel<T, DT, M>, dim3(p.H, p.B, (p.Sq + kBM - 1) / kBM),
                  kBwdThreads, DqLayout<DT>::kSmem, st, qmap, kmap, vmap, omap, p, m, lse, delta,
                  static_cast<T*>(dq));
  return launch(flash_bwd_dkv_sm90_kernel<T, DT, M>,
                dim3(Hkv * DkvLayout<DT>::kParts, p.B, (p.Skv + kBN - 1) / kBN),
                kBwdThreads, DkvLayout<DT>::kSmem, st, qmap, kmap, vmap, omap, p, m, lse, delta,
                dk, dv);
}

template <class T, class M>
cudaError_t run_bwd(const Problem& p, const M& m, const void* q, const void* k, const void* v,
                    const void* dout, const float* l, const float* dl, void* dq, float* dk,
                    float* dv, cudaStream_t st) {
  if (p.D <= 64) {
#if PTT_BUILT_WIDTH(64)
    return launch_bwd<T, 64>(p, m, q, k, v, dout, l, dl, dq, dk, dv, st);
#endif
  } else if (p.D <= 128) {
#if PTT_BUILT_WIDTH(128)
    return launch_bwd<T, 128>(p, m, q, k, v, dout, l, dl, dq, dk, dv, st);
#endif
  } else {
#if PTT_BUILT_WIDTH(192)
    return launch_bwd<T, 192>(p, m, q, k, v, dout, l, dl, dq, dk, dv, st);
#endif
  }
  return cudaErrorNotSupported;
}

}  // namespace sm90

// The 16-bit backward of flash_attention.cu, masked_flash.cu and
// varlen_flash.cu: q, k, v and dout (strides p.o) of `dtype` as
// run_fwd_sm90 takes them; lse and delta [B, H, Sq] f32 contiguous. dQ: dq
// [B, Sq, H, D] contiguous in `dtype`. dK/dV (dq null): dk, dv
// [B, Skv, H / g, D] contiguous f32, the kv heads' gradients.
template <class M>
cudaError_t run_bwd_sm90(int dtype, const Problem& p, const M& m, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, void* stream) {
  if (p.D % 8 != 0 || p.D > kMaxHeadDim) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* k_out = static_cast<float*>(dk);
  float* v_out = static_cast<float*>(dv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#if PTT_BUILT_DTYPE(1)
  if (dtype == ptt::kBF16)
    return sm90::run_bwd<bf16>(p, m, q, k, v, dout, l, dl, dq, k_out, v_out, st);
#endif
#if PTT_BUILT_DTYPE(2)
  if (dtype == ptt::kF16)
    return sm90::run_bwd<sm90::f16>(p, m, q, k, v, dout, l, dl, dq, k_out, v_out, st);
#endif
  return dtype == ptt::kBF16 || dtype == ptt::kF16 ? cudaErrorNotSupported
                                                   : cudaErrorInvalidValue;
}

}  // namespace
