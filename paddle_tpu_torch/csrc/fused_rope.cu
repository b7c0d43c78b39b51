// Rotary position embedding on 1-3 tensors in one launch, for Hopper (sm_90a).
//
// Replaces `_rope_kernel` of paddle_tpu/ops/pallas/fused_rope.py:90
// (pallas_call :138, entry `apply_fused_rope` :215): every tensor x
// [B, S, H_t, D] of the call gets, for each pair (x_a, x_b) of a head,
//   x_a' = x_a c - x_b s,   x_b' = x_b c + x_a s
// with c, s the half-width f32 tables [Bt, S, D/2] (Bt = 1: one table for
// every batch row; Bt = B: a table per row, as at decode) at the pair's
// (row, position, frequency). The pairing is neox (x_j, x_{j+D/2}) or
// interleaved (x_{2j}, x_{2j+1}). The backward is this kernel with the sin
// table negated (`sin_sign` = -1): the rotation is orthogonal.
//
// Bound on an H100: bytes. At the training shape (q [4, 2048, 32, 128] and
// k [4, 2048, 8, 128] in bf16, tables [4, 2048, 64] f32) it reads and
// writes 167.8 MB of activations and reads 4.2 MB of tables: 0.051 ms at
// 3.35 TB/s; a handful of flops per byte.
//
// Design: one block per token row (b, s) and threads (j, y), j over the
// D/2 frequencies: each thread reads c and s once and applies them to its
// pair in every head y, y + blockDim.y, ... of every tensor of the call
// (q and k together, as the TPU kernel sweeps all of them in one grid).
// Neighbouring threads touch neighbouring elements, so every load and store
// is coalesced, and the only integer division is the row's (b, s). The
// TPU kernel's lane rolls with sign-folded full-width tables work around
// Mosaic's lane slicing; the card indexes the pair directly and reads the
// half-width tables, half the table bytes. Products and sums round once
// each (no fused multiply-add), as the plain PyTorch version does, so the
// two agree bit for bit on identical tables.
#include <stdint.h>

#include "common.cuh"

namespace {

struct RopeArgs {
  const void* x[3];
  void* out[3];
  int heads[3];
  int n;          // tensors in the call
  int S, D, half;
  int table_b;    // 1 or B
  int interleaved;
  float sin_sign;
  const float* cos;
  const float* sin;
};

template <typename T>
__global__ void rope_kernel(RopeArgs a) {
  const int j = threadIdx.x, y = threadIdx.y, ny = blockDim.y;
  const int row = blockIdx.x;  // b * S + s
  const int b = row / a.S, s = row - b * a.S;
  const long long tab = (static_cast<long long>(a.table_b > 1 ? b : 0) * a.S + s) * a.half + j;
  const float c = a.cos[tab];
  const float sn = a.sin_sign * a.sin[tab];
  const int off_a = a.interleaved ? 2 * j : j;
  const int off_b = a.interleaved ? 2 * j + 1 : j + a.half;
  for (int t = 0; t < a.n; ++t) {
    const int H = a.heads[t];
    const long long base = static_cast<long long>(row) * H * a.D;
    const T* x = static_cast<const T*>(a.x[t]) + base;
    T* o = static_cast<T*>(a.out[t]) + base;
    for (int h = y; h < H; h += ny) {
      const int ia = h * a.D + off_a, ib = h * a.D + off_b;
      const float xa = ptt::to_f32(x[ia]), xb = ptt::to_f32(x[ib]);
      o[ia] = ptt::from_f32<T>(__fsub_rn(__fmul_rn(xa, c), __fmul_rn(xb, sn)));
      o[ib] = ptt::from_f32<T>(__fadd_rn(__fmul_rn(xb, c), __fmul_rn(xa, sn)));
    }
  }
}

}  // namespace

// x0..x2 / out0..out2: n (1-3) contiguous [B, S, heads_i, D] tensors of one
// dtype (float32, bfloat16 or float16) and their outputs (unused slots
// null); cos, sin: contiguous f32 [table_b, S, D / 2], table_b 1 or B.
// D even, D / 2 <= 1024. Returns cudaGetLastError() after the launch.
extern "C" int ptt_rope(const void* x0, const void* x1, const void* x2, void* out0,
                        void* out1, void* out2, int n, int h0, int h1, int h2, int B,
                        int S, int D, const void* cos, const void* sin, int table_b,
                        int interleaved, float sin_sign, int dtype, void* stream) {
  if (n < 1 || n > 3 || D % 2 != 0 || D / 2 > 1024 || B * S <= 0) return cudaErrorInvalidValue;
  RopeArgs a;
  const void* xs[3] = {x0, x1, x2};
  void* outs[3] = {out0, out1, out2};
  const int hs[3] = {h0, h1, h2};
  for (int i = 0; i < 3; ++i) {
    a.x[i] = xs[i];
    a.out[i] = outs[i];
    a.heads[i] = hs[i];
  }
  a.n = n;
  a.S = S;
  a.D = D;
  a.half = D / 2;
  a.table_b = table_b;
  a.interleaved = interleaved;
  a.sin_sign = sin_sign;
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  // 256 threads a block (at least one row of frequencies): D / 2 lanes times
  // as many heads as fit
  const int ny = a.half >= 256 ? 1 : 256 / a.half;
  const dim3 block(a.half, ny);
  const dim3 grid(B * S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32: rope_kernel<float><<<grid, block, 0, st>>>(a); break;
    case ptt::kBF16: rope_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(a); break;
    case ptt::kF16: rope_kernel<__half><<<grid, block, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
