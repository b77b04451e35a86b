// Tile helpers shared by the attention kernels for Hopper (sm_90a):
// flash_attention_lane.cu (forward: K1, K4 and K5's forward) and flash_attention.cu
// (K5's dq and dk/dv passes); flash_attention_lane_bwd.cu (K1b, K4b) takes the
// shared-memory address, bf16 packing and stride helpers through attention_wgmma.cuh.
//
// Tiles are 64 rows (queries or keys) by the head dim D in {16, 32, 64}, bf16, in
// shared memory with a row stride of D + 8 elements (16-byte aligned rows, and
// ldmatrix reads of eight rows fall into distinct banks). A block is 4 warps; warp
// w owns rows 16w..16w+15 of a tile. Products are mma.sync m16n8k16 bf16 with fp32
// accumulators; in a c fragment (float[4]) element e belongs to row g + 8 (e >> 1)
// and column 2 t4 + (e & 1) of its 16 x 8 tile, with g = lane / 4, t4 = lane % 4.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;  // rows per tile (queries or keys)
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0+64) of one (batch, head) slice into a 64 x (D+8) tile;
// rows at or past `rows` are zero-filled and never read from device memory.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          int row0, int rows, int row_stride, int tid) {
  constexpr int LD = D + 8, CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = tid; i < kT * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(dst + r * LD + c, ok ? base + (int64_t)row * row_stride + c : base, ok);
  }
}

// A fragments (16 rows x D, D/16 k16 steps) of a warp's 16 rows of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4], const __nv_bfloat16* tile,
                                       int row0, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(f[kk], tile + (row0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
}

// c[8][4] = A (this warp's 16 rows, k = head dim) @ B^T, B a 64 x D tile whose
// rows are the n index and whose columns are the head dim.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int mat = lane >> 3;
      const int n = np * 16 + (mat >> 1) * 8 + (lane & 7);
      uint32_t bf[4];
      ldmatrix_x4(bf, b + n * LD + kk * 16 + (mat & 1) * 8);
      mma_bf16(c[2 * np], a[kk], bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// acc[D/8][4] += P (16 x 64 from c-fragment registers, rounded to bf16, k = tile
// rows) @ B, B a 64 x D tile whose rows are the k index.
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&p)[8][4],
                                       const __nv_bfloat16* b, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kc * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
    }
  }
}

// Element strides of a (B, T, H, D) tensor's batch, sequence and head dims.
struct Strides {
  int sb, st, sh;
};

}  // namespace
