// Device primitives of the port's Hopper (sm_90a) kernels, shared by the
// attention forward (flash_fwd_sm90.cuh), the attention backward
// (flash_bwd_sm90.cuh), the grouped GEMM (grouped_gemm_sm90.cuh) and the
// paged decode (decode_attention.cu):
// mbarriers whose waits trap instead of hanging, TMA loads of 4-d tensor
// maps and their host-side encoding, bulk copies of contiguous bytes
// (no tensor map), wgmma shared-memory descriptors of
// 128-byte-swizzled tiles, and the wgmma products the kernels issue:
//   - SS, both operands K-major in shared memory: m64n128k16
//     (`wgmma_ss_n128`) and m64n64k16 (`wgmma_ss_n64`);
//   - SS with B read MN-major through the transpose bit: m64n128k16
//     (`wgmma_ss_n128_t`, the grouped GEMM's row-major weights);
//   - RS, A in registers in an m64 accumulator's fragment layout, B read
//     MN-major through the transpose bit: m64n64k16 (`wgmma_rs_n64_t`).
// Each product and the register pack and the TMA map take the element
// type T of the 16-bit operands, bf16 or f16 (`Elem<T>`): wgmma reads both
// at one rate from one fragment and shared-memory layout, so the kernels
// are one source for both and differ in the instruction's type suffixes,
// the two-float pack and the map's data type only.
// The tiles are 64-column (128-byte) panels of 16-bit rows: a K-major
// operand's k step moves its descriptor 32 bytes inside the swizzle atom;
// an MN-major operand's 16-row k step moves it 2048 bytes, and its
// descriptor's leading byte offset is the stride between its 64-column
// panels (the N extent past one swizzle atom).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encode function comes
                   // from cudaGetDriverEntryPoint, so nothing links -lcuda

#include <type_traits>

#include "flash_tiles.cuh"

namespace {
namespace sm90 {

using f16 = __half;  // beside flash_tiles.cuh's bf16

constexpr int kPanel = 64;   // 16-bit columns of one 128-byte swizzled panel
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kHangCycles = 1ll << 34;  // a lost arrival traps, never hangs

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P;\nmbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// one box of a 4-d tensor map, coordinates innermost first, into shared
// memory; completes `bytes` on the barrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes of global memory into shared memory, the bulk
// copy without a tensor map (both addresses 16-byte aligned, `bytes` a
// multiple of 16); completes `bytes` on the barrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (byte offsets lbo, sbo; the swizzle atoms are 8 rows of 128 bytes,
// 1024-aligned).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// until at most one committed group is still in flight
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The wgmma products, each a macro over the type suffix TY ("bf16" or
// "f16", a string literal pasted into the instruction) that the templates
// below pick from T.
#define PTT_OUT32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PTT_OUT64(d)                                                                        \
  PTT_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),          \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PTT_REGS32                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define PTT_REGS64                                                                          \
  PTT_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
             "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// m64n128k16 from two shared-memory descriptors; TB the transpose bit of B
#define PTT_SS_N128(TY, TB)                                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" PTT_REGS64     \
               "}, %64, %65, p, 1, 1, 0, " TB ";\n}\n"                                      \
               : PTT_OUT64(d)                                                               \
               : "l"(a), "l"(b), "r"(scale_d))
// m64n64k16 from two K-major shared-memory descriptors
#define PTT_SS_N64(TY)                                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" PTT_REGS32      \
               "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                           \
               : PTT_OUT32(d)                                                               \
               : "l"(a), "l"(b), "r"(scale_d))
// m64n64k16, A in registers, B MN-major through the transpose bit
#define PTT_RS_N64_T(TY)                                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" PTT_REGS32      \
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
               : PTT_OUT32(d)                                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <class T>
constexpr bool kIsF16 = std::is_same<T, f16>::value;

// d[64] (+)= A B^T over k = 16: A [64 x 16] and B [128 x 16], both K-major
// 128-byte-swizzled tiles of T in shared memory (descriptors a, b);
// scale_d = 0 overwrites d.
template <class T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  if constexpr (kIsF16<T>)
    PTT_SS_N128("f16", "0");
  else
    PTT_SS_N128("bf16", "0");
}

// d[64] (+)= A B over k = 16: A [64 x 16] a K-major and B [16 x 128] an
// MN-major (row-major [k][n]) 128-byte-swizzled tile of T in shared memory
// (descriptors a, b; b's leading byte offset steps between its two
// 64-column panels); scale_d = 0 overwrites d.
template <class T>
__device__ __forceinline__ void wgmma_ss_n128_t(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
  if constexpr (kIsF16<T>)
    PTT_SS_N128("f16", "1");
  else
    PTT_SS_N128("bf16", "1");
}

// d[32] (+)= A B^T over k = 16: A [64 x 16] and B [64 x 16], both K-major
// 128-byte-swizzled tiles of T in shared memory (descriptors a, b);
// scale_d = 0 overwrites d.
template <class T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kIsF16<T>)
    PTT_SS_N64("f16");
  else
    PTT_SS_N64("bf16");
}

// d[32] += A B over k = 16: A [64 x 16] of T in registers (an m64
// accumulator's fragment layout, packed in pairs by `pack2<T>`), B
// [16 x 64] an MN-major (transposed) 128-byte-swizzled tile in shared
// memory (descriptor b).
template <class T>
__device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  if constexpr (kIsF16<T>)
    PTT_RS_N64_T("f16");
  else
    PTT_RS_N64_T("bf16");
}

#undef PTT_SS_N128
#undef PTT_SS_N64
#undef PTT_RS_N64_T
#undef PTT_REGS64
#undef PTT_REGS32
#undef PTT_OUT64
#undef PTT_OUT32

// The 16-bit element types: the pack of two floats (round to nearest even)
// into the 32-bit register of an A fragment or a staged output pair (the
// low half is `lo`), and the data type of a tensor map over them.
template <class T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <>
struct Elem<f16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <class T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return Elem<T>::pack(lo, hi);
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up at run time
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A map of the view [B, S, Hx, D] of T (element strides st, unit d
// stride) as dims (D, Hx, S, B), boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzled; out-of-bounds elements read as zero. The stride
// of a dim of size 1 is never used and is replaced by a valid one.
template <class T>
cudaError_t encode(CUtensorMap* map, const void* base, int B, int S, int Hx, int D,
                   const Strides& st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const long long sh = Hx > 1 ? st.h : D, ss = S > 1 ? st.s : (long long)Hx * D;
  const long long sb = B > 1 ? st.b : (long long)S * Hx * D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hx, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, Elem<T>::kMap, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace
