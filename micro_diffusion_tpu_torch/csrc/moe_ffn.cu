// Fused EC-MoE expert feed-forward, forward, for Hopper (sm_90a).
//
// Replaces: micro_diffusion_tpu/ops/moe_ffn.py:_fwd_kernel (the Pallas TPU
// kernel behind moe_ffn / _moe_ffn_pallas, forward only: K2), and the same
// kernel body under _em_fwd (moe_ffn_expert_major, the `gather` dispatch's
// expert-major rows: K3), through the entry point moe_ffn_em_fwd below.
//
// Contract, per expert e and each of its rows x (moe_ffn.py:65-68, 83-85):
//   a   = x @ w1[e]                      fp32 accumulation
//   a   = bf16(a)                        rounded to bf16 before the activation
//   h   = bf16(gelu_exact(a))            erf GELU in fp32 (erff)
//   out = h @ w2[e]                      fp32 accumulation, stored as bf16
// xg (n, e, k, d), w1 (e, d, f), w2 (e, f, d), out (n, e, k, d), all bf16 and
// contiguous. Expert e's rows are the n runs of k rows at xg[:, e]; the kernel
// computes those offsets itself, with no gather on the host. The (rows, f)
// hidden never reaches device memory: it lives in registers and a 32 x 64
// shared-memory tile.
//
// Bound on this card: 4*n*e*k*d*f FLOPs against 2*(2*n*e*k*d + 2*e*d*f) bytes.
// At the MicroDiT-XL shapes (n=8, k=64, d=1024, f up to 3840) that is ~500
// FLOP/byte, above the H100's ~295 FLOP/byte ridge: the bound is the tensor
// cores (989 TFLOP/s bf16).
//
// Design: the TPU kernel kept an (S*k, d) fp32 accumulator in up to 100 MB of
// VMEM. Here a block owns a small row tile (32 rows of one expert) and the
// whole d-wide fp32 accumulator lives in registers, split across 8 warps: warp
// w owns columns [64*c + 8*w, 64*c + 8*w + 8) of every 64-column chunk c, i.e.
// 32 rows x d/8 columns, d/2 floats per thread (128 at d = 1024). The block
// walks f in 64-wide chunks; for each chunk it computes a = X @ w1[:, chunk]
// (32 x 64, the warps split it 2 x 4), applies the contract's roundings and GELU
// into shared memory, then accumulates h @ w2[chunk, :] into the registers.
// No FLOP is recomputed (option "small row tile" of the design note; the
// alternative, d-column slabs, would redo x @ w1 once per slab). The cost is
// that each block streams its expert's full w1 and w2 once per 32 rows, from
// L2 (the blocks of one expert run together, so device memory sees the
// weights about once per call). Weight tiles (64 x 64 bf16) stream through a
// 4-stage cp.async ring; the row tile X (32 x d) is loaded once.
// Products are mma.sync m16n8k16 bf16 with fp32 accumulators.
//
// Grid: (ceil(n*k/32), e); block: 256 threads; d a multiple of 128, <= 1024;
// f a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;        // rows per block
constexpr int kT = 64;         // weight tile edge
constexpr int kLDT = kT + 8;   // shared row stride (bf16) for 64-wide tiles
constexpr int kStages = 4;     // weight-tile ring depth
constexpr int kThreads = 256;  // 8 warps

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

// The contract's activation: round the fp32 product to bf16, exact GELU in fp32.
__device__ __forceinline__ float act(float a) {
  a = __bfloat162float(__float2bfloat16_rn(a));
  return a * 0.5f * (1.0f + erff(a * 0.70710678118654752f));
}

template <int NDC>  // d / 64
__global__ void __launch_bounds__(kThreads, 1)
    moe_ffn_fwd_kernel(const __nv_bfloat16* __restrict__ xg, const __nv_bfloat16* __restrict__ w1,
                       const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out,
                       int n, int ne, int k, int f) {
  constexpr int D = NDC * kT;
  constexpr int LDX = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kBM x LDX
  __nv_bfloat16* hs = xs + kBM * LDX;                               // kBM x kLDT
  __nv_bfloat16* ws = hs + kBM * kLDT;                              // kStages x kT x kLDT

  const int e = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int m = n * k;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // Expert e's row r lives at xg[r / k, e, r % k, :].
  auto row_offset = [&](int r) -> int64_t {
    return ((int64_t)(r / k) * ne + e) * (int64_t)k * D + (int64_t)(r % k) * D;
  };

  for (int i = tid; i < kBM * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = row0 + r;
    const bool ok = row < m;
    cp_async16(xs + r * LDX + c, ok ? xg + row_offset(row) + c : xg, ok);
  }

  // Tile stream: for each 64-wide f chunk fc, NDC tiles w1[e][64*dc:+64, 64*fc:+64]
  // then NDC tiles w2[e][64*fc:+64, 64*dc:+64].
  const int nfc = f / kT;
  const int ntiles = nfc * 2 * NDC;
  const __nv_bfloat16* w1e = w1 + (int64_t)e * D * f;
  const __nv_bfloat16* w2e = w2 + (int64_t)e * f * D;
  auto load_w = [&](int tt) {
    const int fc = tt / (2 * NDC), r = tt % (2 * NDC);
    const __nv_bfloat16* src;
    int ld;
    if (r < NDC) {
      src = w1e + (int64_t)(r * kT) * f + fc * kT;
      ld = f;
    } else {
      src = w2e + (int64_t)(fc * kT) * D + (r - NDC) * kT;
      ld = D;
    }
    __nv_bfloat16* dst = ws + (tt % kStages) * kT * kLDT;
#pragma unroll
    for (int i = tid; i < kT * 8; i += kThreads) {
      const int rr = i >> 3, cc = (i & 7) * 8;
      cp_async16(dst + rr * kLDT + cc, src + (int64_t)rr * ld + cc, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_w(s);
    cp_async_commit();  // group 0 also carries the X rows
  }
  // Wait for tile tt, then refill the slot that tile tt-1 used.
  auto next_tile = [&](int tt) -> const __nv_bfloat16* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (tt + kStages - 1 < ntiles) load_w(tt + kStages - 1);
    cp_async_commit();
    return ws + (tt % kStages) * kT * kLDT;
  };

  float acc[NDC][2][4];
#pragma unroll
  for (int dc = 0; dc < NDC; ++dc)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) acc[dc][mi][0] = acc[dc][mi][1] = acc[dc][mi][2] = acc[dc][mi][3] = 0.f;

  const int arow = (warp >> 2) * 16;  // GEMM1: this warp's 16 rows ...
  const int acol = (warp & 3) * 16;   // ... and 16 hidden columns of the chunk
  int tt = 0;
  for (int fc = 0; fc < nfc; ++fc) {
    float a[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) a[nt][0] = a[nt][1] = a[nt][2] = a[nt][3] = 0.f;
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc, ++tt) {
      const __nv_bfloat16* w = next_tile(tt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4], bf[4];
        ldmatrix_x4(af, xs + (arow + (lane & 15)) * LDX + dc * kT + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4_trans(bf, w + (kk * 16 + (lane & 15)) * kLDT + acol + (lane >> 4) * 8);
        mma_bf16(a[0], af, bf[0], bf[1]);
        mma_bf16(a[1], af, bf[2], bf[3]);
      }
    }
    // h = bf16(gelu(bf16(a))) into shared memory; read after the next barrier.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = arow + g + hf * 8, c = acol + nt * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(hs + r * kLDT + c) =
            pack_bf16(act(a[nt][2 * hf]), act(a[nt][2 * hf + 1]));
      }

    uint32_t hfrag[2][4][4];  // [m16 half][k16 step] A fragments of h
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc, ++tt) {
      const __nv_bfloat16* w = next_tile(tt);
      if (dc == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldmatrix_x4(hfrag[mi][kk], hs + (mi * 16 + (lane & 15)) * kLDT + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t bf[4];  // k16 steps 2kp and 2kp+1 of this warp's 8 columns
        ldmatrix_x4_trans(bf, w + (kp * 32 + lane) * kLDT + warp * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[dc][mi], hfrag[mi][2 * kp], bf[0], bf[1]);
          mma_bf16(acc[dc][mi], hfrag[mi][2 * kp + 1], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + mi * 16 + g + hf * 8;
      if (row < m) {
        __nv_bfloat16* orow = out + row_offset(row);
#pragma unroll
        for (int dc = 0; dc < NDC; ++dc)
          *reinterpret_cast<uint32_t*>(orow + dc * kT + warp * 8 + 2 * t4) =
              pack_bf16(acc[dc][mi][2 * hf], acc[dc][mi][2 * hf + 1]);
      }
    }
}

template <int NDC>
int launch(const void* xg, const void* w1, const void* w2, void* out, int n, int e, int k,
           int f, cudaStream_t stream) {
  constexpr int D = NDC * kT;
  const int smem = (kBM * (D + 8) + kBM * kLDT + kStages * kT * kLDT) * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(moe_ffn_fwd_kernel<NDC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((n * k + kBM - 1) / kBM, e);
  moe_ffn_fwd_kernel<NDC><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xg), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<__nv_bfloat16*>(out), n, e, k, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a d the
// kernel is not instantiated for (a multiple of 128 up to 1024).
extern "C" int moe_ffn_fwd(const void* xg, const void* w1, const void* w2, void* out, int n,
                           int e, int k, int d, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 128: return launch<2>(xg, w1, w2, out, n, e, k, f, s);
    case 256: return launch<4>(xg, w1, w2, out, n, e, k, f, s);
    case 384: return launch<6>(xg, w1, w2, out, n, e, k, f, s);
    case 512: return launch<8>(xg, w1, w2, out, n, e, k, f, s);
    case 640: return launch<10>(xg, w1, w2, out, n, e, k, f, s);
    case 768: return launch<12>(xg, w1, w2, out, n, e, k, f, s);
    case 896: return launch<14>(xg, w1, w2, out, n, e, k, f, s);
    case 1024: return launch<16>(xg, w1, w2, out, n, e, k, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3: expert-major rows xg (e, m, d) -> out (e, m, d). Expert e's row r is at
// xg[e, r, :], which is the sample-major layout with n = 1 and k = m: the same
// kernel, with (int64) row offsets e * m * d + r * d. Grid (ceil(m/32), e).
extern "C" int moe_ffn_em_fwd(const void* xg, const void* w1, const void* w2, void* out, int e,
                              int m, int d, int f, void* stream) {
  return moe_ffn_fwd(xg, w1, w2, out, 1, e, m, d, f, stream);
}
