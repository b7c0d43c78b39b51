// The 16-bit attention forward for Hopper (sm_90a): one mainloop on wgmma
// fed by TMA, instantiated under three mask policies and for both 16-bit
// element types T (bf16 and f16, `sm90.cuh`'s `Elem<T>`).
//
// Replaces, for bfloat16 and float16 inputs, two TPU kernels (float32 keeps the
// CUDA-core `flash_fwd_kernel` of flash_tiles.cuh):
//   - paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` :127
//     (pallas_call :282), under flash_attention.cu's `CausalBias`
//     (bottom-right causal, an optional f32 key bias on every tile);
//   - paddle_tpu/ops/pallas/masked_flash.py `_fm_fwd_kernel` :77
//     (pallas_call :253), under masked_flash.cu's `FlashMask` (top-left
//     causal and the per-column row ranges of `FlashMask::keep`).
// O = softmax(Q K^T * scale + mask) V in T and the f32 row LSE, the
// exact running-max softmax, GQA by kv head h / g; a row that keeps no key
// gets O = 0 and LSE = +inf (running max at or below kEmpty, or l == 0).
// P is rounded to T before P V, as the TPU kernel casts p to the operand
// type; m and l stay in f32.
//
// Bound on an H100: operations, 4 D per kept (row, key) pair at 989 TFLOP/s
// (bf16 and f16 dense). At the training shapes (B 4, S 2048, heads of 128, causal)
// that is 0.0695 ms for flash's 16 heads and 0.139 ms for the LLaMA step's
// 32; at the dense engine's decode (Sq = 1) the K/V stream sets it: bytes
// at 3.35 TB/s.
//
// Design (against the WMMA forward this replaced, item by item):
//   1. Products on wgmma. A CTA owns kBM = 128 query rows, 64 per consumer
//      warpgroup. S = Q K^T is m64n128k16 from two shared-memory
//      descriptors; O += P V is m64n64k16 per 64-column panel of the head
//      dim, with P as the register A operand and V read MN-major through
//      the descriptor's transpose bit (no transposed copy).
//   2. No shared-memory round trips in the loop. The softmax runs on the S
//      accumulator fragments: a thread holds 2 rows x 32 keys, the row max
//      is reduced over the 4 lanes of a quad by shuffles, each thread keeps
//      its partial row sums (reduced once, at the end). P is packed to T
//      pairs in registers in the A-fragment layout (an m64 accumulator's
//      layout is the A operand's). O stays in registers; its rescale is one
//      multiply a fragment.
//   3. TMA and a ring. Q, K and V are tensor maps over the strided
//      [B, S, H, D] views, 128-byte swizzled in 64-column panels (the
//      layout the descriptors name); out-of-bounds boxes zero-fill the
//      ragged S edge and a head dim below the panel. One producer thread
//      loads Q once and keeps kStages = 2 K/V stages in flight on
//      mbarriers (K and V on separate barriers, so S starts before V
//      lands); consumers free a stage with one arrival a warp.
//   4. Occupancy. 160 KB of shared memory at D = 128 (80 KB at D <= 64,
//      144 KB at the 192 width),
//      one CTA of 384 threads an SM, 128 rows in flight; setmaxnreg gives
//      the consumers 232 registers and the producer 40.
//   5. Tiles are classified before any predicate runs: skipped (never
//      loaded), full (no predicate) or partial (the policy's keep() on the
//      S fragment). Flash's partial tiles are its causal diagonal and a
//      ragged last kv tile; flashmask reads a class a (q tile, kv tile)
//      that the wrapper derives on the device from per-tile min/max of the
//      index rows (ops/masked_flash.py `flashmask_tile_classes`), so under
//      the LLaMA step's trivial index only the diagonal evaluates it.
// The epilogue normalises O by 1/l in registers, stages the T rows in
// the warpgroup's own rows of the Q tile (same swizzle) and writes them
// with 16-byte stores; output layout [B, Sq, H, D] contiguous, as before.
//
// Tiles: 128 query rows (two m64 warpgroups) by 128 keys (S is one
// m64n128 product a k step) at the head-dim widths 64 and 128 (zero-filled
// past D); a consumer thread holds 64 S, 64 O (D = 128) and 32 packed P
// registers, within ptxas's budget without spills. Q and two K/V stages
// take 160 KB at D = 128, so one CTA runs an SM.
// The third width, 192 (three panels, D in 129..192: the diffusion UNet's
// heads of 160), keeps the 128-key tiles of the policies and their classes
// but walks each in two 64-key halves, each a stage of the ring (`kSub`):
// 128 keys would need 48 + 2 x 96 = 240 KB and 64 S + 96 O + 32 P
// registers, above the SM's 227 KB and the 168 registers ptxas gives a
// 384-thread kernel; 64-key halves (S an m64n64 product) take 48 + 2 x 48
// = 144 KB and 32 S + 96 O + 16 P. A half that starts past Skv is never
// loaded.
#pragma once

#include "sm90.cuh"

namespace {
namespace sm90 {

constexpr int kBM = 128;     // query rows of a CTA: two consumer warpgroups of 64
constexpr int kBN = 128;     // keys of a kv tile
constexpr int kStages = 2;   // K/V stages in shared memory
constexpr int kThreads = 384;  // warpgroup 0 loads, 1 and 2 compute
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;

template <int DT>
struct Layout {  // bytes of the dynamic shared memory, from a 1024-aligned base
  static constexpr int kPanels = DT / kPanel;
  static constexpr int kSub = DT > 128 ? 64 : kBN;  // keys of a ring stage
  static constexpr int kHalves = kBN / kSub;        // stages of a kv tile
  static constexpr int kQ = kPanels * kBM * 128;    // [panel][kBM][64]
  static constexpr int kKV = kPanels * kSub * 128;  // one K or V stage: [panel][kSub][64]
  static constexpr int kBars = kQ + 2 * kStages * kKV;
  static constexpr size_t kSmem = kBars + (1 + 3 * kStages) * 8 + 1024;
};

__device__ __forceinline__ float quad_max(float v) {  // over the 4 lanes holding a row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// d (+)= A B^T over DT columns, N = 64 or 128: A the 64 rows at a_addr of
// [panel][a_rows][64] tiles, B the N rows at b_addr of [panel][b_rows][64]
// tiles, both K-major
template <class T, int DT, int N>
__device__ __forceinline__ void ss_rows(float (&d)[N / 2], uint32_t a_addr, int a_rows,
                                        uint32_t b_addr, int b_rows) {
#pragma unroll
  for (int ks = 0; ks < DT / 16; ++ks) {  // panel ks / 4, 32 bytes a k step inside it
    const uint64_t a = smem_desc(a_addr + (ks / 4) * a_rows * 128 + (ks % 4) * 32, 16, 1024);
    const uint64_t b = smem_desc(b_addr + (ks / 4) * b_rows * 128 + (ks % 4) * 32, 16, 1024);
    if constexpr (N == 128)
      wgmma_ss_n128<T>(d, a, b, ks > 0);
    else
      wgmma_ss_n64<T>(d, a, b, ks > 0);
  }
}

// The class of ring step u, keys [u kSub, (u + 1) kSub): its kv tile's,
// skipped where it starts past Skv
template <int DT, class M>
__device__ __forceinline__ int sub_class(const Problem& p, const M& mask, int b, int h, int q0,
                                         int u) {
  using L = Layout<DT>;
  if (u * L::kSub >= p.Skv) return kSkipTile;
  return mask.tile_class(p, b, h, q0, (u / L::kHalves) * kBN, kBM, kBN);
}

// The loads: Q once, then the K and V boxes of every visited kv tile into
// the ring, each stage reused once both consumer warpgroups freed it.
template <int DT, class M>
__device__ __forceinline__ void produce(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const Problem& p, const M& mask,
                                        int b, int h, int q0, int n_kv, unsigned char* q_s,
                                        unsigned char* k_s, unsigned char* v_s, uint64_t* q_full,
                                        uint64_t* k_full, uint64_t* v_full, uint64_t* empty) {
  using L = Layout<DT>;
  const int hk = h / p.g;
  prefetch_map(qmap);
  prefetch_map(kmap);
  prefetch_map(vmap);
  mbar_expect_tx(q_full, L::kQ);
#pragma unroll
  for (int c = 0; c < L::kPanels; ++c)
    tma_load(q_s + c * kBM * 128, qmap, q_full, c * kPanel, h, q0, b);
  int it = 0;
  for (int u = 0; u < n_kv * L::kHalves; ++u) {
    if (sub_class<DT>(p, mask, b, h, q0, u) == kSkipTile) continue;
    const int st = it % kStages, round = it / kStages;
    ++it;
    if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
    mbar_expect_tx(&k_full[st], L::kKV);
#pragma unroll
    for (int c = 0; c < L::kPanels; ++c)
      tma_load(k_s + st * L::kKV + c * L::kSub * 128, kmap, &k_full[st], c * kPanel, hk,
               u * L::kSub, b);
    mbar_expect_tx(&v_full[st], L::kKV);
#pragma unroll
    for (int c = 0; c < L::kPanels; ++c)
      tma_load(v_s + st * L::kKV + c * L::kSub * 128, vmap, &v_full[st], c * kPanel, hk,
               u * L::kSub, b);
  }
}

// One consumer warpgroup: rows [q0 + 64 cw, q0 + 64 cw + 64). Thread
// (warp w, lane) holds rows 16 w + lane / 4 (+8) and, of each 8 columns of
// an accumulator, columns 2 (lane % 4) and +1: element 4 j + e of an
// accumulator is row +8 * (e / 2), column 8 j + 2 (lane % 4) + e % 2.
template <class T, int DT, class M>
__device__ __forceinline__ void consume(const Problem& p, const M& mask, int b, int h, int q0,
                                        int n_kv, int cw, unsigned char* q_s,
                                        const unsigned char* k_s, const unsigned char* v_s,
                                        uint64_t* q_full, uint64_t* k_full, uint64_t* v_full,
                                        uint64_t* empty, T* __restrict__ out,
                                        float* __restrict__ lse) {
  using L = Layout<DT>;
  constexpr int kN = L::kSub;  // keys of a step
  const int tid = threadIdx.x - 128 * (cw + 1), warp = tid / 32, lane = tid % 32;
  const int r_a = 16 * warp + lane / 4;  // row within the warpgroup's 64; r_a + 8 the other
  const int row_a = q0 + 64 * cw + r_a, row_b = row_a + 8;
  const int col_off = 2 * (lane % 4);
  const bool active = q0 + 64 * cw < p.Sq;  // uniform over the warpgroup
  const float sl2 = p.scale * kLog2e;       // logits in log2 units: exp2 throughout

  float o[L::kPanels][32];
#pragma unroll
  for (int c = 0; c < L::kPanels; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const uint32_t q_addr = smem_u32(q_s) + 64 * cw * 128;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  mbar_wait(q_full, 0);

  int it = 0;
  for (int u = 0; u < n_kv * L::kHalves; ++u) {
    const int k0 = u * kN;
    const int cls = sub_class<DT>(p, mask, b, h, q0, u);
    if (cls == kSkipTile) continue;
    const int st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    ++it;
    mbar_wait(&k_full[st], phase);
    if (active) {
      float s[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
      ss_rows<T, DT, kN>(s, q_addr, kBM, k_addr + st * L::kKV, kN);  // S = Q K^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // logits in log2 units; the predicate on partial tiles only
      if (cls == kPartialTile || mask.has_bias()) {
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + col_off + e;
            const typename M::Key key = mask.key(p, b, h, col);
            const float bias = mask.bias(key) * kLog2e;
            float xa = fmaf(s[4 * j + e], sl2, bias), xb = fmaf(s[4 * j + 2 + e], sl2, bias);
            if (cls == kPartialTile) {
              if (!mask.keep(p, row_a, col, key)) xa = -INFINITY;
              if (!mask.keep(p, row_b, col, key)) xb = -INFINITY;
            }
            s[4 * j + e] = xa;
            s[4 * j + 2 + e] = xb;
          }
      } else {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) s[i] *= sl2;
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;  // nothing seen yet: no NaN
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        s[4 * j] = exp2f(s[4 * j] - mu_a);
        s[4 * j + 1] = exp2f(s[4 * j + 1] - mu_a);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - mu_b);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - mu_b);
        rs_a += s[4 * j] + s[4 * j + 1];
        rs_b += s[4 * j + 2] + s[4 * j + 3];
      }
      l_a = l_a * al_a + rs_a;  // this thread's share of the row sum
      l_b = l_b * al_b + rs_b;
#pragma unroll
      for (int c = 0; c < L::kPanels; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j] *= al_a;
          o[c][4 * j + 1] *= al_a;
          o[c][4 * j + 2] *= al_b;
          o[c][4 * j + 3] *= al_b;
        }
      uint32_t pa[kN / 16][4];  // P in T: the A fragment of k step kk
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        pa[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }

      mbar_wait(&v_full[st], phase);
#pragma unroll
      for (int c = 0; c < L::kPanels; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)  // 16 keys: 2048 bytes of V rows
#pragma unroll
        for (int c = 0; c < L::kPanels; ++c)
          wgmma_rs_n64_t<T>(o[c], pa[kk],
                         smem_desc(v_addr + st * L::kKV + c * kN * 128 + kk * 2048, 1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < L::kPanels; ++c) fence_regs(o[c]);
    } else {
      mbar_wait(&v_full[st], phase);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  if (!active) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const bool e_a = !(m_a > kEmpty * kLog2e) || l_a == 0.f;
  const bool e_b = !(m_b > kEmpty * kLog2e) || l_b == 0.f;
  const auto inverse = [&](float l, bool empty) { return empty ? 0.f : 1.f / l; };
  const float inv_a = inverse(l_a, e_a), inv_b = inverse(l_b, e_b);
  // O into this warpgroup's own rows of the Q tile (its last product read
  // them), in the 128-byte swizzle, then 16-byte rows out
  unsigned char* stage = q_s + 64 * cw * 128;
  const int swz = r_a & 7;  // r_a and r_a + 8 share it
#pragma unroll
  for (int c = 0; c < L::kPanels; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned char* at = stage + c * kBM * 128 + ((j ^ swz) * 16) + 2 * col_off;
      *reinterpret_cast<uint32_t*>(at + r_a * 128) =
          pack2<T>(o[c][4 * j] * inv_a, o[c][4 * j + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(at + (r_a + 8) * 128) =
          pack2<T>(o[c][4 * j + 2] * inv_b, o[c][4 * j + 3] * inv_b);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  constexpr int kChunks = DT / 8;  // 16-byte chunks of a row
  for (int i = tid; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, ch = i % kChunks, row = q0 + 64 * cw + r;
    if (row < p.Sq && ch * 8 < p.D)
      *reinterpret_cast<uint4*>(out + (((long long)b * p.Sq + row) * p.H + h) * p.D + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + (ch / 8) * kBM * 128 + r * 128 +
                                          (((ch % 8) ^ (r & 7)) * 16));
  }
  if (lane % 4 == 0) {
    float* lrow = lse + ((long long)b * p.H + h) * p.Sq;
    if (row_a < p.Sq) lrow[row_a] = e_a ? INFINITY : (m_a + log2f(l_a)) * kLn2;
    if (row_b < p.Sq) lrow[row_b] = e_b ? INFINITY : (m_b + log2f(l_b)) * kLn2;
  }
}

template <class T, int DT, class M>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, Problem p, M mask,
                      T* __restrict__ out, float* __restrict__ lse) {
  using L = Layout<DT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* q_s = smem;
  unsigned char* k_s = smem + L::kQ;  // [stage][panel][kSub][64]
  unsigned char* v_s = k_s + kStages * L::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // the longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_kv = mask.kv_tiles(p, q0, kBM, kBN);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one branch per role, never rejoined (setmaxnreg needs it)
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0)
      produce<DT>(&qmap, &kmap, &vmap, p, mask, b, h, q0, n_kv, q_s, k_s, v_s, q_full, k_full,
                  v_full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<T, DT>(p, mask, b, h, q0, n_kv, threadIdx.x / 128 - 1, q_s, k_s, v_s, q_full, k_full,
                v_full, empty, out, lse);
  }
}

template <class T, int DT, class M>
cudaError_t launch_fwd(const Problem& p, const M& m, const void* q, const void* k, const void* v,
                       void* out, float* lse, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap;
  const int Hkv = p.H / p.g;
  constexpr int kSub = Layout<DT>::kSub;
  cudaError_t err = encode<T>(&qmap, q, p.B, p.Sq, p.H, p.D, p.q, kBM);
  if (err == cudaSuccess) err = encode<T>(&kmap, k, p.B, p.Skv, Hkv, p.D, p.k, kSub);
  if (err == cudaSuccess) err = encode<T>(&vmap, v, p.B, p.Skv, Hkv, p.D, p.v, kSub);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBM - 1) / kBM, p.H, p.B);
  return launch(flash_fwd_sm90_kernel<T, DT, M>, grid, kThreads, Layout<DT>::kSmem, st, qmap,
                kmap, vmap, p, m, static_cast<T*>(out), lse);
}

template <class T, class M>
cudaError_t run_fwd(const Problem& p, const M& m, const void* q, const void* k, const void* v,
                    void* out, float* lse, cudaStream_t st) {
  if (p.D <= 64) {
#if PTT_BUILT_WIDTH(64)
    return launch_fwd<T, 64>(p, m, q, k, v, out, lse, st);
#endif
  } else if (p.D <= 128) {
#if PTT_BUILT_WIDTH(128)
    return launch_fwd<T, 128>(p, m, q, k, v, out, lse, st);
#endif
  } else {
#if PTT_BUILT_WIDTH(192)
    return launch_fwd<T, 192>(p, m, q, k, v, out, lse, st);
#endif
  }
  return cudaErrorNotSupported;
}

}  // namespace sm90

// The 16-bit forward of flash_attention.cu, masked_flash.cu and
// varlen_flash.cu: q, k, v of `dtype` (ptt::kBF16 or ptt::kF16, one for
// all three) with a unit d stride, D a multiple of 8
// and at most kMaxHeadDim (192), every base
// pointer 16-byte aligned and every stride of a dim longer than 1 a
// multiple of 8 elements (what a TMA map takes; the wrappers copy other
// views). out [B, Sq, H, D] contiguous in `dtype`, lse [B, H, Sq] f32.
template <class M>
cudaError_t run_fwd_sm90(int dtype, const Problem& p, const M& m, const void* q, const void* k,
                         const void* v, void* out, void* lse, void* stream) {
  if (p.D % 8 != 0 || p.D > kMaxHeadDim) return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#if PTT_BUILT_DTYPE(1)
  if (dtype == ptt::kBF16) return sm90::run_fwd<bf16>(p, m, q, k, v, out, l, st);
#endif
#if PTT_BUILT_DTYPE(2)
  if (dtype == ptt::kF16) return sm90::run_fwd<sm90::f16>(p, m, q, k, v, out, l, st);
#endif
  return dtype == ptt::kBF16 || dtype == ptt::kF16 ? cudaErrorNotSupported
                                                   : cudaErrorInvalidValue;
}

}  // namespace
