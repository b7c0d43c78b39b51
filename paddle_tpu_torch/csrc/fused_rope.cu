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
// 3.35 TB/s, six flops a pair. At a decode tick (16 rows of one token,
// 32 + 32 heads) the bytes take 0.16 us, so the launch and one chain of
// memory latencies set its time.
//
// Design: the heads of the call form one axis (q's, then k's, then v's),
// cut into chunks of `hpt` heads; a chunk may cross from one tensor into
// the next. A thread owns V consecutive pairs of one (token, chunk):
//  - V = 16 / sizeof(T) (8 in bf16/f16, 4 in f32): each head is two
//    16-byte loads (neox: x_j.. and x_{j+D/2}..; interleaved: two
//    consecutive vectors) and two 16-byte stores; its V cos and V sin
//    entries come as float4 loads once and stay in registers across the
//    chunk's heads. A warp's load moves 512 bytes, where one 2-byte
//    element a thread moved 64.
//  - V = 1, the scalar route of the same template, where vectors do not
//    fit: D/2 not a multiple of 16 / sizeof(T), or a base pointer off the
//    16-byte line (a contiguous view at an odd offset).
// The thread loads its next head before it rotates and stores the current
// one, so two heads' loads (64 bytes in bf16) are in flight a thread. That
// and a few hundred resident threads an SM cover the memory latency:
// six flops a pair and a straight stream want neither tensor cores nor
// TMA, and plain vector loads keep each element's rounding in our hands.
// The grid is planned in Python (`ops.fused_rope.rope_plan`): at many
// tokens a block holds every chunk of a few tokens (the tables of a token
// are read from L1 by its chunks) and a thread walks about four heads; at
// a few tokens (decode) each thread takes one head and the heads spread
// over about one CTA an SM. Products and sums round once each
// (__fmul_rn / __fsub_rn / __fadd_rn: no fused multiply-add), as the
// plain PyTorch version does, so the two agree bit for bit on identical
// tables. Offsets are 64-bit.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

struct RopeArgs {
  const void* x0;
  const void* x1;
  const void* x2;
  void* o0;
  void* o1;
  void* o2;
  int h0, h1, h2;  // heads of each tensor (0 past the call's tensors)
  int tokens;      // B * S
  int S, D, half;
  int table_b;     // 1 or B
  int hpt;         // heads a thread walks (a chunk of the heads axis)
  int chunks;      // chunks a token: ceil((h0 + h1 + h2) / hpt)
  float sin_sign;
  const float* cos;
  const float* sin;
};

// What a thread loads of one half of a head: 16 bytes, or one element on
// the scalar route.
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : (i == 1 ? u.y : (i == 2 ? u.z : u.w));
}
__device__ __forceinline__ void set_word(uint4& u, int i, uint32_t w) {
  if (i == 0) u.x = w;
  else if (i == 1) u.y = w;
  else if (i == 2) u.z = w;
  else u.w = w;
}

// a 2-byte element's bits (the low 16 of `b`) as f32, and f32 rounded to
// nearest even into those bits: the conversions of ptt::to_f32 / from_f32
template <typename T> __device__ __forceinline__ float bits_f32(uint32_t b);
template <> __device__ __forceinline__ float bits_f32<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float bits_f32<__half>(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}
template <typename T> __device__ __forceinline__ uint32_t f32_bits(float v);
template <> __device__ __forceinline__ uint32_t f32_bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
template <> __device__ __forceinline__ uint32_t f32_bits<__half>(float v) {
  return __half_as_ushort(__float2half(v));
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float* f) {
  if constexpr (V == 1) {
    f[0] = ptt::to_f32(r);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(word(r, i));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bits_f32<T>(word(r, i) & 0xffffu);
      f[2 * i + 1] = bits_f32<T>(word(r, i) >> 16);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr (V == 1) {
    *p = ptt::from_f32<T>(f[0]);
  } else {
    uint4 r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4)
        set_word(r, i, __float_as_uint(f[i]));
      else
        set_word(r, i, f32_bits<T>(f[2 * i]) | (f32_bits<T>(f[2 * i + 1]) << 16));
    }
    *reinterpret_cast<uint4*>(p) = r;
  }
}

template <int V>
__device__ __forceinline__ void load_table(const float* p, float* f) {
  if constexpr (V == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      f[i] = q.x;
      f[i + 1] = q.y;
      f[i + 2] = q.z;
      f[i + 3] = q.w;
    }
  }
}

__device__ __forceinline__ int heads_of(const RopeArgs& a, int t) {
  return t == 0 ? a.h0 : (t == 1 ? a.h1 : a.h2);
}

// Element offset of this thread's first vector in head h of tensor t at
// token r.
__device__ __forceinline__ long long head_offset(const RopeArgs& a, int t, int h, int r,
                                                 int lane_off) {
  return (static_cast<long long>(r) * heads_of(a, t) + h) * a.D + lane_off;
}

// Both halves of this thread's pairs in head h of tensor t: x_a's vector
// and x_b's (the second half, neox; the next 16 bytes, interleaved).
template <typename T, int V, bool kIL>
__device__ __forceinline__ void load_head(const RopeArgs& a, int t, int h, int r,
                                          int lane_off, Raw<T, V>& ra, Raw<T, V>& rb) {
  const void* base = t == 0 ? a.x0 : (t == 1 ? a.x1 : a.x2);
  const T* xp = static_cast<const T*>(base) + head_offset(a, t, h, r, lane_off);
  ra = *reinterpret_cast<const Raw<T, V>*>(xp);
  rb = *reinterpret_cast<const Raw<T, V>*>(xp + (kIL ? V : a.half));
}

template <typename T, int V, bool kIL>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256) rope_kernel(const RopeArgs a) {
  const int r = blockIdx.x * blockDim.z + threadIdx.z;  // token b * S + s
  const int c = blockIdx.y * blockDim.y + threadIdx.y;  // chunk of the heads axis
  if (r >= a.tokens || c >= a.chunks) return;
  const int lane = threadIdx.x;  // pairs lane * V .. lane * V + V - 1
  const int lane_off = kIL ? 2 * lane * V : lane * V;
  const int trow = a.table_b > 1 ? r : r % a.S;
  const long long tab = static_cast<long long>(trow) * a.half + lane * V;
  float cs[V], sn[V];
  load_table<V>(a.cos + tab, cs);
  load_table<V>(a.sin + tab, sn);
#pragma unroll
  for (int i = 0; i < V; ++i) sn[i] = a.sin_sign * sn[i];  // exact: +-1

  // the chunk's first head: tensor t, head h in it
  const int g0 = c * a.hpt;
  const int n = min(a.hpt, a.h0 + a.h1 + a.h2 - g0);
  int t = g0 >= a.h0 + a.h1 ? 2 : (g0 >= a.h0 ? 1 : 0);
  int h = g0 - (t == 0 ? 0 : (t == 1 ? a.h0 : a.h0 + a.h1));
  Raw<T, V> ra, rb, na, nb;
  load_head<T, V, kIL>(a, t, h, r, lane_off, ra, rb);
  for (int k = 0; k < n; ++k) {
    const int tc = t, hc = h;
    if (k + 1 < n) {  // the next head's loads go out before this head's stores
      ++h;
      if (h == heads_of(a, t)) {  // the chunk crosses into the next tensor
        ++t;
        h = 0;
      }
      load_head<T, V, kIL>(a, t, h, r, lane_off, na, nb);
    }
    float e[2 * V];  // x_a's vector, then x_b's
    unpack<T, V>(ra, e);
    unpack<T, V>(rb, e + V);
    float o[2 * V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int ia = kIL ? 2 * i : i, ib = kIL ? 2 * i + 1 : V + i;
      const float xa = e[ia], xb = e[ib];
      o[ia] = __fsub_rn(__fmul_rn(xa, cs[i]), __fmul_rn(xb, sn[i]));
      o[ib] = __fadd_rn(__fmul_rn(xb, cs[i]), __fmul_rn(xa, sn[i]));
    }
    void* obase = tc == 0 ? a.o0 : (tc == 1 ? a.o1 : a.o2);
    T* op = static_cast<T*>(obase) + head_offset(a, tc, hc, r, lane_off);
    store<T, V>(op, o);
    store<T, V>(op + (kIL ? V : a.half), o + V);
    if (k + 1 < n) {
      ra = na;
      rb = nb;
    }
  }
}

template <typename T, int V>
cudaError_t launch(const RopeArgs& a, bool interleaved, dim3 grid, dim3 block, cudaStream_t st) {
  if (interleaved)
    rope_kernel<T, V, true><<<grid, block, 0, st>>>(a);
  else
    rope_kernel<T, V, false><<<grid, block, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x0..x2 / out0..out2: n (1-3) contiguous [B, S, heads_i, D] tensors of one
// dtype (float32, bfloat16 or float16), each with heads_i > 0, and their
// outputs (unused slots null, their heads 0); cos, sin: contiguous f32
// [table_b, S, D / 2], table_b 1 or B. D even, D / 2 <= 1024. The plan
// (`ops.fused_rope.rope_plan`): vec pairs a thread (16 / itemsize, every
// pointer on the 16-byte line and D / 2 a multiple of it; or 1), hpt heads
// a thread in `chunks` chunks a token, block (bx = D / 2 / vec lanes, by
// chunks, bz tokens), grid (gx over the tokens, gy over the chunks).
// Returns cudaGetLastError() after the launch.
extern "C" int ptt_rope(const void* x0, const void* x1, const void* x2, void* out0,
                        void* out1, void* out2, int n, int h0, int h1, int h2, int B,
                        int S, int D, const void* cos, const void* sin, int table_b,
                        int interleaved, float sin_sign, int dtype, int vec, int hpt,
                        int chunks, int bx, int by, int bz, int gx, int gy, void* stream) {
  const int itemsize = dtype == ptt::kF32 ? 4 : 2;
  const int heads = h0 + h1 + h2;
  const long long tokens = static_cast<long long>(B) * S;
  if (n < 1 || n > 3 || D % 2 != 0 || D / 2 > 1024 || tokens <= 0 || tokens > INT32_MAX ||
      h0 <= 0 || (n > 1) != (h1 > 0) || (n > 2) != (h2 > 0) || (vec != 1 && vec != 16 / itemsize) ||
      (D / 2) % vec != 0 || bx * vec != D / 2 || hpt < 1 || chunks != (heads + hpt - 1) / hpt ||
      by < 1 || bz < 1 || bz > 64 || bx * by * bz > (vec == 1 ? 1024 : 256) ||
      static_cast<long long>(gx) * bz < tokens || static_cast<long long>(gy) * by < chunks)
    return cudaErrorInvalidValue;
  RopeArgs a;
  a.x0 = x0;
  a.x1 = x1;
  a.x2 = x2;
  a.o0 = out0;
  a.o1 = out1;
  a.o2 = out2;
  a.h0 = h0;
  a.h1 = h1;
  a.h2 = h2;
  a.tokens = static_cast<int>(tokens);
  a.S = S;
  a.D = D;
  a.half = D / 2;
  a.table_b = table_b;
  a.hpt = hpt;
  a.chunks = chunks;
  a.sin_sign = sin_sign;
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  const dim3 grid(gx, gy), block(bx, by, bz);
  const bool il = interleaved != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return vec == 1 ? launch<float, 1>(a, il, grid, block, st) : launch<float, 4>(a, il, grid, block, st);
    case ptt::kBF16:
      return vec == 1 ? launch<__nv_bfloat16, 1>(a, il, grid, block, st)
                      : launch<__nv_bfloat16, 8>(a, il, grid, block, st);
    case ptt::kF16:
      return vec == 1 ? launch<__half, 1>(a, il, grid, block, st) : launch<__half, 8>(a, il, grid, block, st);
    default:
      return cudaErrorInvalidValue;
  }
}
