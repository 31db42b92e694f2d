// Hopper (sm_90a) building blocks shared by the bf16 flash-attention
// kernels of flash_fwd.cu and flash_bwd.cu: the PTX of asynchronous copies
// and warpgroup products (namespace sm90), swizzled bf16 tiles filled
// through a ring of cp.async stages, and the products whose A operand is a
// register fragment.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// PTX of Hopper's asynchronous copies and warpgroup products.
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (8 bf16) of row r in a [ROWS][D] bf16
// tile.  The tile is D/64 panels of [ROWS][64], each row 128 bytes, with
// the 128-byte swizzle (chunk XOR row % 8) of wgmma's B128 layout, so a
// panel is a stack of 1024-byte swizzle atoms of 8 rows.
template <int ROWS>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes from global to shared memory; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a B128-swizzled operand at shared address `addr`.
// K-major (k contiguous): 8-row atoms 1024 bytes apart, a k step of 16
// adds 32 bytes to addr within the panel.  MN-major (m or n contiguous):
// 8-row (k) atoms 1024 bytes apart, 64-column panels `panel` bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr,
                                                 uint32_t panel) {
  return sw128_desc(addr, panel);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special function unit; a result below 2^-126 flushes to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving register reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// (a, b) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi): hi + lo
// keeps 16 significant bits where bf16 alone keeps 8
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// D[64 x N] (+)= A B in fp32: A from shared memory (ss) or from registers
// (rs, the m64k16 fragment of 4 bf16 pairs a thread holds), B from shared
// memory, K-major for ss and MN-major for rs.  accumulate == 0 ignores D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace sm90

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;     // rows of a bf16 block: two warpgroups of 64
constexpr int BN = 64;      // rows of a streamed bf16 tile
constexpr int WG_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// Start 16-byte async copies of rows [row0, row0 + ROWS) of one (batch,
// head) slice into a swizzled tile at `dst`; rows at or past `valid` are
// zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int64_t row_stride, int row0,
                                          int valid) {
  for (int i = threadIdx.x; i < ROWS * D / 8; i += WG_THREADS) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r < valid;
    sm90::cp_async16(dst + sm90::tile_off<ROWS>(r, c),
                     ok ? src + (int64_t)(row0 + r) * row_stride + c * 8 : src,
                     ok);
  }
}

// The ring of streamed tiles: tile t sits in stage t % (number of stages).
// Every iteration commits one group of copies (empty ones too), so with one
// group left in flight tile t has landed; the barrier after that wait is
// passed only by threads done with tile t - 1, so the copies of tile t + 2
// issued after it may take tile t - 1's stage (three stages) or, where a
// product of tile t - 1 may still run, tile t - 2's (four).
__device__ __forceinline__ void ring_wait() {
  sm90::cp_async_wait<1>();
  sm90::fence_async_smem();
  __syncthreads();
}

// Fragment layout of a 64 x N fp32 accumulator over a warpgroup: element i
// of a thread sits at row (warp % 4) * 16 + lane / 4 + 8 * ((i / 2) % 2) and
// column (i / 4) * 8 + (lane % 4) * 2 + i % 2.  Elements 8 kk .. 8 kk + 7,
// packed in pairs, are the A fragment of k step kk of a product over N.
// The kernels' elementwise steps take std::true_type where a tile needs
// masks (a key past Sk, the causal diagonal or, in the backward, a padded
// row), else std::false_type.

// acc[64 x D] += A[64 x 64] B[64 x D] over four k steps of 16: A as register
// fragments, B a row-major tile of 64 rows read MN-major
template <int D>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[4][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = sm90::mnmajor_desc(b + kk * 16 * 128, BN * 128);
    if constexpr (D == 64)
      sm90::wgmma_rs_n64(acc, a[kk], desc, 1);
    else
      sm90::wgmma_rs_n128(acc, a[kk], desc, 1);
  }
}

// Launch with `smem` bytes of dynamic shared memory; the launch's error.
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const Args& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
