// Hopper (sm_90a) building blocks of B13's tensor-core kernels
// (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu): mbarriers, TMA
// tile and bulk loads, wgmma shared-memory descriptors and the wgmma
// products at n = 32, 64, 128 (both operands in shared memory) and n =
// 64, 128, 256 (A from registers), and the host-side tensor-map encoder.
//
// Accumulator fragment of m64nN (per thread of a warpgroup; warp w,
// lane = 4 g + t): element r holds row 16 w + g + 8 ((r >> 1) & 1) and
// column 8 (r >> 2) + 2 t + (r & 1).  The bf16 pairs of the fragment's
// columns 16 kk .. 16 kk + 15 (elements 8 kk .. 8 kk + 7) are the A
// fragment of the k-step kk of a product that takes it from registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 1 << 20;    // + CUresult of a failed encode

// ---- barriers and copies --------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one box of a 4-D (hd, s, heads, b) tensor map at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ``bytes`` contiguous bytes (16-byte aligned both ends, a multiple of 16)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
// K-major operand: the start steps 32 bytes a k-step inside a 64-column
// box; lbo unused (16), sbo = 1024 between 8-row groups.  MN-major
// (transposed) operand: lbo steps between 64-column boxes, sbo = 1024
// between 8-row groups of the k dim.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence / wait around it
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define SM90_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define SM90_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define SM90_OUT8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_OUT32 SM90_OUT8(0), SM90_OUT8(8), SM90_OUT8(16), SM90_OUT8(24)
#define SM90_OUT64                                                       \
  SM90_OUT32, SM90_OUT8(32), SM90_OUT8(40), SM90_OUT8(48), SM90_OUT8(56)
#define SM90_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"
#define SM90_OUT16 SM90_OUT8(0), SM90_OUT8(8)
#define SM90_OUT128                                                      \
  SM90_OUT64, SM90_OUT8(64), SM90_OUT8(72), SM90_OUT8(80), SM90_OUT8(88), \
      SM90_OUT8(96), SM90_OUT8(104), SM90_OUT8(112), SM90_OUT8(120)

// d (+)= A.B, m64nNk16 (N = 2 x the accumulator's length), A and B
// K-major in shared memory
template <int R>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(R == 16 || R == 32 || R == 64, "m64n32, m64n64 or m64n128");
  if constexpr (R == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_D16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : SM90_OUT16
        : "l"(da), "l"(db), "r"(accumulate));
  } else if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : SM90_OUT32
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : SM90_OUT64
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d += A.B, m64nNk16, A (bf16 pairs) from registers, B MN-major
// (transposed) in shared memory
template <int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[R], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  static_assert(R == 32 || R == 64 || R == 128,
                "m64n64, m64n128 or m64n256");
  if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : SM90_OUT32
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  } else if constexpr (R == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : SM90_OUT64
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_D128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : SM90_OUT128
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  }
}

// ---- arithmetic -----------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (nothing is linked).
// It needs a current context, which a thread that has made no runtime
// call yet lacks: PyTorch's autograd worker thread, where the
// backward of a graph whose first CUDA work is B13's backward runs.
// cudaFree(nullptr), once a thread, binds the current device's primary
// context (not capturable: the package captures a graph only of calls a
// thread has already made, as benchmarks/wrapper_cost.py's graph_us).
cudaError_t encoder(EncodeTiled* fn) {
  static thread_local bool bound = false;
  if (!bound) {
    const cudaError_t e = cudaFree(nullptr);
    if (e != cudaSuccess) return e;
    bound = true;
  }
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a bf16 tensor [batch, heads, rows, hd] given by its element strides
// (batch, head, row), as a 4-D map (hd, rows, heads, batch) of boxes of
// 64 columns (128 bytes: the widest the 128-byte swizzle takes) x
// ``box_rows`` rows, swizzled; rows past the end read as zeros
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
           int batch, int heads, int rows, const int64_t* strides,
           int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

}  // namespace
