// The warp-specialized wgmma GEMM behind the EC-MoE expert feed-forward kernels on
// Hopper (sm_90a): moe_ffn.cu (the forward, K2/K3) and moe_ffn_bwd.cu (the backward,
// K2b/K3b) instantiate it with their operands and epilogues. Device and host side;
// the wgmma fences, mbarriers and TMA loads come from attention_wgmma.cuh.
//
// One block computes one 128 x BN tile of C = A @ B for one expert:
// - warpgroup 0 gives its registers away (setmaxnreg) and one of its threads streams
//   the k-blocks (64 deep) of A and B by TMA into a ring of stages in shared memory,
//   as deep as 192 KB allows (4 stages of 48 KB, or 6 at 128-wide tiles), each
//   stage refilled once the consumers have marked it empty (mbarriers for full and
//   empty); the tile coordinates of a box come from a multiply and a shift, not a
//   division (a division per box made the one producer thread the bound);
// - warpgroups 1 and 2 each own 64 rows of the tile and run wgmma m64nBNk16 from the
//   ring, the fp32 accumulator (BN / 2 floats a thread) in registers; the products of
//   k-block j are issued before k-block j - 1's stage is released;
// - the epilogue rounds the accumulator to bf16 (through the GELU, or with the GELU's
//   derivative against a tile it loads), writes it into the now idle ring in the
//   128-byte swizzled layout, and TMA stores it, each consumer warpgroup its own 64
//   rows.
// Every tile is written by one block after a fixed-order sum over all of its
// k-blocks: no atomics, no split K, the result is bitwise repeatable.
//
// Operands. Every matrix is a 4-D tensor map (cols, k, e, n) over bf16, with the
// columns contiguous: row r of expert e's matrix lies at (r % k, e, r / k), which
// covers sample-major rows (n, e, k, d), expert-major rows (e, m, d) (n = 1, k = m),
// the (e, m, f) hidden scratch and the weights (e, d, f) / (e, f, d) (n = 1). A box
// is 64 columns (128 bytes, swizzled by 128 bytes) by `box` rows (16, 32 or 64): rows
// of one run, or 64 / k whole runs of one expert where k divides 64 (the stage-1
// dispatch's k = 16), so that no box straddles the end of a run. Rows past the
// matrix are read as zeros and not stored (TMA's bounds), which makes the ragged
// edges (m = 48, m = 1040) and the row sums of the weight gradients exact.
// A tile in shared memory is a set of slabs, each 64 columns by R rows of 128 bytes:
// - K-major (rows are M or N, columns are K): one slab of 128 (A) or BN (B) rows;
//   k16 step kk starts 32 kk bytes in, 8-row groups 1024 bytes apart;
// - MN-major (rows are K, columns are M or N): 128 / 64 (A) or BN / 64 (B) slabs of
//   64 rows, 8192 bytes apart (the descriptor's leading offset); k16 step kk starts
//   2048 kk bytes in, 8-row groups 1024 bytes apart.
// A consumer warpgroup's 64 rows of A start 8192 bytes into the A tile either way.

#pragma once

#include <math.h>

#include "attention_wgmma.cuh"

namespace {

constexpr int kBM = 128;            // rows of a tile: two consumer warpgroups of 64
constexpr int kBK = 64;             // depth of a k-block: one 128-byte swizzle row
constexpr int kGemmThreads = 384;   // the producer warpgroup and two consumers
constexpr int kRingBytes = 196608;  // the ring (192 KB); the epilogue reuses it
constexpr int kSlabRow = 128;       // bytes of one swizzled row of 64 bf16

// A bf16 matrix as its TMA map sees it (see the header note).
struct Mat {
  CUtensorMap map;
  int k;          // rows of one run
  int box;        // rows of one box
  uint32_t mul;   // r / k == umulhi(r, mul) >> shift for 0 <= r < 2^31 (no division:
  int shift;      // the producer thread computes these for every box it loads)
};

// (r % k, r / k): the run and row-in-run coordinates of row r of `m`
__device__ __forceinline__ int2 row_coords(const Mat& m, int r) {
  const int q = __umulhi(static_cast<uint32_t>(r), m.mul) >> m.shift;
  return make_int2(r - q * m.k, q);
}

// The epilogues.
enum Epi {
  kStore = 0,     // C0 = bf16(acc)
  kGelu = 1,      // C0 = bf16(gelu(bf16(acc))): the forward's hidden
  kGeluGrad = 2,  // acc = dh, a = the bf16 tile of C1 at the same place (loaded):
                  // C0 = bf16(gelu'(a) dh), C1 = bf16(gelu(a)) over a
  kTwo = 3,       // blocks [0, tiles of C0) store C0 = bf16(A0 @ B0), the rest C1 =
                  // bf16(A1 @ B1)
};

// A launch's operands and tile grid: A0 @ B0 (kTwo: the block's output o picks
// A[o] @ B[o]); outputs c[0], c[1]. Output o has tm[o] x tn[o] tiles per expert,
// over ne experts; blocks walk the N tiles fastest, then M, then experts.
struct GemmArgs {
  Mat a[2], b[2], c[2];
  int nk;  // k-blocks
  int tm[2], tn[2];
  int ne;
};

#define MDT_ACC8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128 fp32) += A (64 x 16) @ B (16 x 128), both from shared memory; TA / TB
// set: the operand is MN-major (its M or N index contiguous), else K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : MDT_ACC8(0), MDT_ACC8(8), MDT_ACC8(16), MDT_ACC8(24),
        MDT_ACC8(32), MDT_ACC8(40), MDT_ACC8(48), MDT_ACC8(56)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256 fp32) += A (64 x 16) @ B (16 x 256), both from shared memory; TA / TB
// set: the operand is MN-major (its M or N index contiguous), else K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : MDT_ACC8(0), MDT_ACC8(8), MDT_ACC8(16), MDT_ACC8(24),
        MDT_ACC8(32), MDT_ACC8(40), MDT_ACC8(48), MDT_ACC8(56),
        MDT_ACC8(64), MDT_ACC8(72), MDT_ACC8(80), MDT_ACC8(88),
        MDT_ACC8(96), MDT_ACC8(104), MDT_ACC8(112), MDT_ACC8(120)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


#undef MDT_ACC8

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_ss_n256<TA, TB>(d, da, db);
  else
    wgmma_ss_n128<TA, TB>(d, da, db);
}

// Descriptor of a 128-byte-swizzled tile at `p`: K-major (leading offset unused) or
// MN-major (slabs 8192 bytes apart); 8-row groups 1024 bytes apart.
template <int MN>
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return desc(p, MN ? 64 * kSlabRow : 16, 8 * kSlabRow) | (1ull << 62);
}

// k16 step kk of a tile: 32 bytes along a K-major row, 16 rows down an MN-major slab.
template <int MN>
__device__ __forceinline__ const unsigned char* k16(const unsigned char* tile, int kk) {
  return tile + (MN ? 16 * kSlabRow * kk : 32 * kk);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// generic-proxy writes to shared memory become visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbar_wait that gives up after 2^26 polls (seconds): a miscounted barrier then
// faults the launch (an error the wrapper reports) instead of hanging the card.
__device__ __forceinline__ void wait_bar(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

// The rows x (64 ncol) region of `m` at (row0, col0) of expert e into shared memory
// at dst, slab c (columns col0 + 64 c..) `stride` rows after slab c - 1, one box
// (m.box rows) at a time.
__device__ __forceinline__ void load_tile(unsigned char* dst, const Mat& m, int row0, int rows,
                                          int col0, int ncol, int stride, int e, uint64_t* bar) {
  for (int c = 0; c < ncol; ++c)
    for (int j = 0; j < rows; j += m.box) {
      const int2 rc = row_coords(m, row0 + j);
      tma_load4(dst + (c * stride + j) * kSlabRow, &m.map, col0 + 64 * c, rc.x, e, rc.y, bar);
    }
}

// The 64 rows x (64 ncol) tile of shared memory at src (ncol slabs of `stride` rows)
// to rows row0.. and columns col0.. of expert e's `m`; rows past the matrix are
// dropped. Waits until the copies have completed.
__device__ __forceinline__ void store_tile(const unsigned char* src, int stride, const Mat& m,
                                           int row0, int col0, int ncol, int e) {
  for (int c = 0; c < ncol; ++c)
    for (int j = 0; j < 64; j += m.box) {
      const int2 rc = row_coords(m, row0 + j);
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(&m.map)),
          "r"(smem_addr(src + (c * stride + j) * kSlabRow)), "r"(col0 + 64 * c), "r"(rc.x),
          "r"(e), "r"(rc.y)
          : "memory");
    }
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The forward's activation: bf16(a), then erf GELU in fp32.
__device__ __forceinline__ float gelu_of_bf16(float a) {
  a = __bfloat162float(__float2bfloat16_rn(a));
  return a * 0.5f * (1.0f + erff(a * 0.70710678118654752f));
}

template <int BN, int EPI>
struct GemmShape {
  static constexpr int kA = kBM * kBK * 2;  // bytes of an A tile
  static constexpr int kB = BN * kBK * 2;   // bytes of a B tile
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = kRingBytes / kStage;
  static constexpr int kOut = kBM * BN * 2;  // bytes of a bf16 output tile
  static constexpr int kSmem = kStages * kStage + (2 * kStages + 1) * 8;
  static_assert(kStages >= 2, "a ring of two stages at least");
  static_assert((EPI == kGeluGrad ? 3 : 1) * kOut <= kRingBytes, "the epilogue fits the ring");
};

// C = A @ B per tile (see the header note). TA / TB: A / B is MN-major. Grid: one
// block per output tile, 384 threads, one block an SM.
template <int BN, bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1) moe_gemm_kernel(const __grid_constant__ GemmArgs p) {
  using S = GemmShape<BN, EPI>;
  extern __shared__ __align__(1024) unsigned char smem[];
  auto* full = reinterpret_cast<uint64_t*>(smem + S::kStages * S::kStage);
  uint64_t* empty = full + S::kStages;
  uint64_t* loaded = empty + S::kStages;  // kGeluGrad: the epilogue's a tile

  // the block's output (kTwo: 0 or 1) and tile
  int t = blockIdx.x, out = 0;
  if (EPI == kTwo && t >= p.tm[0] * p.tn[0] * p.ne) {
    t -= p.tm[0] * p.tn[0] * p.ne;
    out = 1;
  }
  const int tn = p.tn[out], tm = p.tm[out];
  const int e = t / (tm * tn);
  const int m0 = (t / tn) % tm * kBM, n0 = t % tn * BN;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);  // each consumer warp
    }
    mbar_init(loaded, 1);
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread streams the k-blocks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      const Mat& a = p.a[out];
      const Mat& b = p.b[out];
      for (int kb = 0; kb < p.nk; ++kb) {
        const int s = kb % S::kStages;
        if (kb >= S::kStages) wait_bar(&empty[s], (kb / S::kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], S::kStage);
        unsigned char* at = smem + s * S::kStage;
        if (TA)
          load_tile(at, a, kb * kBK, kBK, m0, kBM / 64, kBK, e, &full[s]);
        else
          load_tile(at, a, m0, kBM, kb * kBK, 1, kBM, e, &full[s]);
        if (TB)
          load_tile(at + S::kA, b, kb * kBK, kBK, n0, BN / 64, kBK, e, &full[s]);
        else
          load_tile(at + S::kA, b, n0, BN, kb * kBK, 1, BN, e, &full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows 64 cw..64 cw + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kb = 0; kb < p.nk; ++kb) {
      const int s = kb % S::kStages;
      wait_bar(&full[s], (kb / S::kStages) & 1);
      const unsigned char* at = smem + s * S::kStage + cw * 64 * kSlabRow;
      const unsigned char* bt = smem + s * S::kStage + S::kA;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<BN, TA, TB>(acc, desc_sw128<TA>(k16<TA>(at, kk)), desc_sw128<TB>(k16<TB>(bt, kk)));
      wgmma_commit();
      wgmma_wait<1>();  // k-block kb - 1's products have landed: release its stage
      fence_regs(acc);
      __syncwarp();
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(kb - 1) % S::kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- epilogue: both consumers are done with the ring. Output o's tile is staged
    // at o * kOut (slab c at c * 16 KB, row rr at 128 rr, the 16-byte chunks of a row
    // permuted by rr % 8 as TMA's 128-byte swizzle has them); kGeluGrad's a tile is
    // loaded by TMA at 2 kOut in the same layout.
    named_barrier(1, 2 * 128);
    unsigned char* a_tile = smem + 2 * S::kOut;
    if constexpr (EPI == kGeluGrad) {
      if (tid == 128) {
        mbar_arrive_expect_tx(loaded, S::kOut);
        load_tile(a_tile, p.c[1], m0, kBM, n0, BN / 64, kBM, e, loaded);
      }
      wait_bar(loaded, 0);
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = cw * 64 + warp * 16 + g + 8 * h;
        const int off = (i / 8) * kBM * kSlabRow + rr * kSlabRow + (((i % 8) ^ g) << 4) + 4 * t4;
        const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if constexpr (EPI == kGelu) {
          *reinterpret_cast<uint32_t*>(smem + off) = pack_bf16(gelu_of_bf16(v0), gelu_of_bf16(v1));
        } else if constexpr (EPI == kGeluGrad) {
          const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a_tile + off));
          const float x[2] = {a.x, a.y}, dh[2] = {v0, v1};
          float dv[2], hv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float cdf = 0.5f * (1.0f + erff(x[j] * 0.70710678118654752f));
            const float pdf = expf(-0.5f * x[j] * x[j]) * 0.3989422804014327f;
            dv[j] = (cdf + x[j] * pdf) * dh[j];
            hv[j] = x[j] * cdf;
          }
          *reinterpret_cast<uint32_t*>(smem + off) = pack_bf16(dv[0], dv[1]);
          *reinterpret_cast<uint32_t*>(smem + S::kOut + off) = pack_bf16(hv[0], hv[1]);
        } else {
          *reinterpret_cast<uint32_t*>(smem + off) = pack_bf16(v0, v1);
        }
      }
    fence_async_shared();
    named_barrier(2 + cw, 128);  // this warpgroup's rows are staged
    if ((tid & 127) == 0) {
      constexpr int kOuts = EPI == kGeluGrad ? 2 : 1;
#pragma unroll
      for (int o = 0; o < kOuts; ++o)
        store_tile(smem + o * S::kOut + cw * 64 * kSlabRow, kBM, p.c[EPI == kTwo ? out : o],
                   m0 + cw * 64, n0, BN / 64, e);
    }
  }
}

// ---- host side

// A map over `ptr`, a bf16 (n, ne, k, cols) array, boxes of 64 columns x `box` rows,
// swizzled by 128 bytes; elements outside read as zeros and are not written. Where
// there are several runs and k < box (k = 16 or 32), a box spans box / k runs.
inline int make_mat(Mat* m, const void* ptr, int cols, int k, int ne, int n, int box) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)k, (cuuint64_t)ne, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * k * 2,
                                 (cuuint64_t)cols * k * ne * 2};
  const int run = n == 1 || box <= k ? box : k;
  const cuuint32_t boxd[4] = {64, (cuuint32_t)run, 1, (cuuint32_t)(box / run)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(&m->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  m->k = k;
  m->box = box;
  int log2k = 0;  // ceil(log2 k); k >= 16
  while ((1 << log2k) < k) ++log2k;
  m->mul = static_cast<uint32_t>(((1ull << (31 + log2k)) + k - 1) / k);
  m->shift = log2k - 1;
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Rows of a box over runs of k rows (k a multiple of 16): 64 when there is one run,
// when 64 divides k, or when k divides 64 (the box spans runs); else 32 or 16,
// whichever divides k, so that no box straddles the end of a run.
inline int row_box(int k, int n) {
  if (n == 1 || k % 64 == 0 || 64 % k == 0) return 64;
  return k % 32 == 0 ? 32 : 16;
}

// One launch of moe_gemm_kernel<...> over every tile of its outputs.
template <int BN, bool TA, bool TB, int EPI>
int launch_gemm(const GemmArgs& args, cudaStream_t stream) {
  using S = GemmShape<BN, EPI>;
  static const int attr = allow_smem(moe_gemm_kernel<BN, TA, TB, EPI>, S::kSmem);
  if (attr != 0) return attr;
  int blocks = args.tm[0] * args.tn[0] * args.ne;
  if (EPI == kTwo) blocks += args.tm[1] * args.tn[1] * args.ne;
  if (blocks == 0 || args.nk == 0) return static_cast<int>(cudaErrorInvalidValue);
  moe_gemm_kernel<BN, TA, TB, EPI><<<blocks, kGemmThreads, S::kSmem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
