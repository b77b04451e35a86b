// Warpgroup (wgmma), mbarrier and TMA helpers for the attention kernels on Hopper
// (sm_90a): flash_attention_lane.cu (the forward: K1, K4, K5) and
// flash_attention_lane_bwd.cu (the backward: K1b, K4b, K5b), device and host side.
//
// Two shared-memory tile layouts, R rows by the head dim D in {16, 32, 64}, bf16:
// - swizzled, as TMA writes a 64 x D box with a D * 2-byte swizzle (desc_sw_k,
//   desc_sw_mn);
// - the unswizzled "core matrix" layout (desc_mn; the dq kernel packs the scaled
//   tiles so): the 8 x 8 block (rows 8rb..8rb+7, columns 8cb..8cb+7) is 128
//   contiguous bytes, row r8 of the block at byte 16 r8, and block (rb, cb) starts at
//   byte 128 (rb D/8 + cb).
// A swizzled tile serves as a K-major operand (rows are M or N, the head dim is K) and
// as an MN-major one (rows are K, the head dim is N), so the kernels never transpose a
// tile.
//
// A warpgroup is 4 warps (128 threads); warp w of it owns rows 16w..16w+15 of a
// 64-row product. In an m64nN fp32 accumulator (float[N/2]) element 4i + e
// belongs to row g + 8 (e >> 1) and column 8i + 2 t4 + (e & 1) of the warp's
// 16 rows, with g = lane / 4, t4 = lane % 4: the mma.sync c-fragment layout per
// n8 block, so an accumulator converts to the A-from-registers operand of the
// next product without a shuffle.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element strides of a (B, T, H, D) tensor's batch, sequence and head dims.
struct Strides {
  int sb, st, sh;
};

// byte offset of core matrix (rb, cb) in a tile with D columns
template <int D>
__host__ __device__ constexpr int cm_offset(int rb, int cb) {
  return 128 * (rb * (D / 8) + cb);
}

// wgmma shared-memory matrix descriptor with the layout bits clear (no swizzle):
// start address, leading (K-direction) and stride (M/N-direction) byte offsets.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// MN-major operand in a core-matrix tile (rows are K, the head dim is N), k16 step
// kk: rows 16kk..16kk+15
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return desc(static_cast<const char*>(tile) + cm_offset<D>(2 * kk, 0), 128 * (D / 8), 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across an asynchronous
// wgmma: the registers are "changed" here, after the wait (CUTLASS's
// warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define MDT_ACC8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 fp32) (+)= A (64 x 16, smem) @ B (64 x 16, smem)^T, both K-major;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : MDT_ACC8(0), MDT_ACC8(8), MDT_ACC8(16), MDT_ACC8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N fp32) += A (64 x 16 bf16, registers) @ B (16 x N, smem, MN-major: the
// transpose flag set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : MDT_ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : MDT_ACC8(0), MDT_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MDT_ACC8(0), MDT_ACC8(8), MDT_ACC8(16), MDT_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef MDT_ACC8

// The A operand of the k16 step kc (columns 16kc..16kc+15) from a 64 x 64
// accumulator, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&p)[32], int kc) {
  a[0] = pack_bf16(p[8 * kc + 0], p[8 * kc + 1]);
  a[1] = pack_bf16(p[8 * kc + 2], p[8 * kc + 3]);
  a[2] = pack_bf16(p[8 * kc + 4], p[8 * kc + 5]);
  a[3] = pack_bf16(p[8 * kc + 6], p[8 * kc + 7]);
}

// mbarrier helpers (shared memory, CTA scope): init with an arrival count, arrive,
// and wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

// One thread arrives on `bar` and adds `bytes` to the transaction count its phase
// waits for; a bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory then counts them off as they land.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Swizzled tiles, as TMA writes a 64 x D bf16 box with a D * 2-byte swizzle (128,
// 64 or 32 bytes for D = 64, 32, 16): rows of D * 2 bytes, the 16-byte chunks of a
// row permuted within each 8-row group. The tile must sit on an 8 * D * 2-byte
// boundary. K-major (rows are M or N, k16 step kk) and MN-major (rows are K, the
// head dim is N, k16 step kk: rows 16 kk..16 kk + 15) descriptors.
template <int D>
__device__ __forceinline__ uint64_t desc_sw_k(const void* tile, int kk) {
  constexpr uint64_t kLayout = D == 64 ? 1 : D == 32 ? 2 : 3;
  return desc(static_cast<const char*>(tile) + 32 * kk, 16, 8 * D * 2) | (kLayout << 62);
}
template <int D>
__device__ __forceinline__ uint64_t desc_sw_mn(const void* tile, int kk) {
  constexpr uint64_t kLayout = D == 64 ? 1 : D == 32 ? 2 : 3;
  return desc(static_cast<const char*>(tile) + kk * 16 * D * 2, 16, 8 * D * 2) | (kLayout << 62);
}

// TMA: the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map (a
// __grid_constant__ kernel parameter) into shared memory, counted off `bar`.
__device__ __forceinline__ void tma_load4(void* dst, const void* map, int c0, int c1, int c2,
                                          int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// 2^x on the special-function unit (flush-to-zero; x = -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host side

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over a (B, T, H, D) bf16 tensor with element strides st: 64-row boxes
// of one (batch, head), swizzled by D * 2 bytes; rows past T read as zeros.
inline int make_map(CUtensorMap* map, const void* ptr, int b, int t, int h, int d, Strides st) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st.sh * 2, (cuuint64_t)st.st * 2,
                                 (cuuint64_t)st.sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)d, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = d == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : d == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Lets `kernel` take `bytes` of dynamic shared memory (above the 48 KB default).
template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace
