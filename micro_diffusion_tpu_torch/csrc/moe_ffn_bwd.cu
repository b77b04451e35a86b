// Fused EC-MoE expert feed-forward, backward, for Hopper (sm_90a).
//
// Replaces: micro_diffusion_tpu/ops/moe_ffn.py:_dxdw_kernel, _dx_kernel and
// _dw_kernel (the Pallas TPU kernels behind moe_ffn's backward rule, which all
// compute one function).
//
// Contract, per expert e and each of its rows x with output cotangent do:
//   a   = bf16(x @ w1[e])                      recomputed, fp32 accumulation
//   dh  = do @ w2[e]^T                         fp32
//   da  = bf16(gelu'(a) * dh),  gelu'(a) = Phi(a) + a * phi(a)   (erff, expf)
//   h   = bf16(gelu(a))
//   dx  = bf16(da @ w1[e]^T)
//   dw1 = x^T @ da,  dw2 = h^T @ do            fp32 over all rows, stored bf16
// xg, do, dx (n, e, k, d); w1, dw1 (e, d, f); w2, dw2 (e, f, d); all bf16 and
// contiguous. Expert e's row r lives at xg[r / k, e, r % k, :]; the kernels
// compute those offsets themselves.
//
// Why two kernels. On the TPU the fused pass keeps an expert's whole (m, d) row
// set in up to 100 MB of VMEM, so dw needs no cross-block sum. On the H100 a
// block holds 227 KB, and dw1/dw2 are sums over every row of the expert:
//   pass 1 (moe_bwd_dx_kernel) is the forward kernel's structure: 32 rows of one
//     expert per block, the d-wide fp32 dx accumulator in registers across 8
//     warps, f streamed in 64-wide chunks. Per chunk it recomputes a and dh,
//     forms da and h, accumulates dx += da @ w1^T, and writes da and h (bf16,
//     (e, m, f)) to a scratch buffer.
//   pass 2 (moe_bwd_dw_kernel) is a tiled GEMM C[e] = A[e]^T B[e] over the
//     expert's rows, launched twice: dw1 = x^T da and dw2 = h^T do. Each block
//     owns a 64 x 64 tile of C in fp32 registers and streams 32-row chunks of A
//     and B through a double-buffered cp.async ring.
// The work is the contract's 5 products (a, dh, dx, dw1, dw2), none repeated;
// the price is the da/h round trip through device memory (4 * m * f bytes per
// expert), which the TPU's whole-row-set VMEM avoided.
//
// Bound on this card: 5 * 2 * m * d * f FLOPs per expert against the bytes of
// x, do, w1, w2 read and dx, dw1, dw2 written; at the MicroDiT-XL stage-1 shapes
// (m = 4096, d = 1024) that is > 1000 FLOP/byte: the tensor cores bound it.
// Products are mma.sync m16n8k16 bf16 with fp32 accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;        // rows per dx block
constexpr int kT = 64;         // weight tile edge
constexpr int kLDT = kT + 8;   // shared row stride (bf16) for 64-wide tiles
constexpr int kStages = 4;     // weight-tile ring depth
constexpr int kThreads = 256;  // 8 warps (dx pass)
constexpr int kGK = 32;        // rows per dw chunk
constexpr int kGThreads = 128; // 4 warps (dw pass)

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

// Offset of expert e's row r in a sample-major (n, e, k, width) array.
__device__ __forceinline__ int64_t sample_major(int r, int e, int ne, int k, int width) {
  return (((int64_t)(r / k) * ne + e) * k + (r % k)) * width;
}

// -------------------------------------------------------------- pass 1: dx

template <int NDC>  // d / 64
__global__ void __launch_bounds__(kThreads, 1)
    moe_bwd_dx_kernel(const __nv_bfloat16* __restrict__ xg, const __nv_bfloat16* __restrict__ w1,
                      const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ da_out,
                      __nv_bfloat16* __restrict__ h_out, int n, int ne, int k, int f) {
  constexpr int D = NDC * kT;
  constexpr int LDX = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kBM x LDX
  __nv_bfloat16* dos = xs + kBM * LDX;                              // kBM x LDX
  __nv_bfloat16* das = dos + kBM * LDX;                             // kBM x kLDT
  __nv_bfloat16* ws = das + kBM * kLDT;                             // kStages x kT x kLDT

  const int e = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int m = n * k;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  for (int i = tid; i < kBM * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = row0 + r;
    const bool ok = row < m;
    const int64_t off = ok ? sample_major(row, e, ne, k, D) + c : 0;
    cp_async16(xs + r * LDX + c, xg + off, ok);
    cp_async16(dos + r * LDX + c, dout + off, ok);
  }

  // Tile stream, per 64-wide f chunk fc: NDC tiles w1[e][64dc:+64, 64fc:+64] (for
  // a), NDC tiles w2[e][64fc:+64, 64dc:+64] (for dh), the NDC w1 tiles again (dx).
  const int nfc = f / kT;
  const int ntiles = nfc * 3 * NDC;
  const __nv_bfloat16* w1e = w1 + (int64_t)e * D * f;
  const __nv_bfloat16* w2e = w2 + (int64_t)e * f * D;
  auto load_w = [&](int tt) {
    const int fc = tt / (3 * NDC), r = tt % (3 * NDC);
    const __nv_bfloat16* src;
    int ld;
    if (r < NDC || r >= 2 * NDC) {
      src = w1e + (int64_t)((r % NDC) * kT) * f + fc * kT;
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
    cp_async_commit();  // group 0 also carries the x and do rows
  }
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

  const int arow = (warp >> 2) * 16;  // a / dh: this warp's 16 rows ...
  const int acol = (warp & 3) * 16;   // ... and 16 hidden columns of the chunk
  int tt = 0;
  for (int fc = 0; fc < nfc; ++fc) {
    float a[2][4], dh[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[nt][i] = dh[nt][i] = 0.f;
    // a = x @ w1[:, chunk]
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
    // dh = do @ w2[chunk, :]^T; the w2 tile is [f][d], i.e. B stored n-major
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc, ++tt) {
      const __nv_bfloat16* w = next_tile(tt);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t af[4], bf[4];
        const int mat = lane >> 3;
        ldmatrix_x4(af, dos + (arow + (lane & 15)) * LDX + dc * kT + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(bf, w + (acol + (mat >> 1) * 8 + (lane & 7)) * kLDT + kk * 16 + (mat & 1) * 8);
        mma_bf16(dh[0], af, bf[0], bf[1]);
        mma_bf16(dh[1], af, bf[2], bf[3]);
      }
    }
    // da = bf16(gelu'(a) * dh) into shared memory (read after the next barrier),
    // da and h = bf16(gelu(a)) to the scratch rows
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = arow + g + hf * 8, c = acol + nt * 8 + 2 * t4;
        float dv[2], hv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = __bfloat162float(__float2bfloat16_rn(a[nt][2 * hf + j]));
          const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
          const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
          dv[j] = (cdf + x * pdf) * dh[nt][2 * hf + j];
          hv[j] = x * cdf;
        }
        const uint32_t dpk = pack_bf16(dv[0], dv[1]);
        *reinterpret_cast<uint32_t*>(das + r * kLDT + c) = dpk;
        const int row = row0 + r;
        if (row < m) {
          const int64_t off = ((int64_t)e * m + row) * f + fc * kT + c;
          *reinterpret_cast<uint32_t*>(da_out + off) = dpk;
          *reinterpret_cast<uint32_t*>(h_out + off) = pack_bf16(hv[0], hv[1]);
        }
      }

    // dx += da @ w1[:, chunk]^T; the w1 tile is [d][f], i.e. B stored n-major
    uint32_t dafrag[2][4][4];  // [m16 half][k16 step] A fragments of da
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc, ++tt) {
      const __nv_bfloat16* w = next_tile(tt);
      if (dc == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldmatrix_x4(dafrag[mi][kk], das + (mi * 16 + (lane & 15)) * kLDT + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t bf[4];  // k16 steps 2kp and 2kp+1 of this warp's 8 d columns
        ldmatrix_x4(bf, w + (warp * 8 + (lane & 7)) * kLDT + kp * 32 + (lane >> 3) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[dc][mi], dafrag[mi][2 * kp], bf[0], bf[1]);
          mma_bf16(acc[dc][mi], dafrag[mi][2 * kp + 1], bf[2], bf[3]);
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
        __nv_bfloat16* orow = dx + sample_major(row, e, ne, k, D);
#pragma unroll
        for (int dc = 0; dc < NDC; ++dc)
          *reinterpret_cast<uint32_t*>(orow + dc * kT + warp * 8 + 2 * t4) =
              pack_bf16(acc[dc][mi][2 * hf], acc[dc][mi][2 * hf + 1]);
      }
    }
}

// -------------------------------------------------------------- pass 2: dw

// Rows of one expert's operand: sample-major (n, e, k, width) when k > 0,
// expert-major (e, m, width) when k == 0.
struct Rows {
  const __nv_bfloat16* base;
  int width, k;
};

__device__ __forceinline__ const __nv_bfloat16* row_ptr(const Rows& o, int r, int e, int ne,
                                                        int m) {
  if (o.k > 0) return o.base + sample_major(r, e, ne, o.k, o.width);
  return o.base + ((int64_t)e * m + r) * o.width;
}

// C[e] (M x N, row-major, bf16) = sum over the expert's m rows of A[r]^T B[r],
// A rows M wide, B rows N wide. Grid (N/64, M/64, e); 4 warps, warp w owns rows
// 16w..16w+15 of the block's 64 x 64 tile of C. m is a multiple of 16.
__global__ void __launch_bounds__(kGThreads)
    moe_bwd_dw_kernel(Rows a, Rows b, __nv_bfloat16* __restrict__ c, int m, int ne, int M,
                      int N) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kGK * kLDT];  // [row][m]
  __shared__ __align__(16) __nv_bfloat16 bs[2][kGK * kLDT];  // [row][n]
  const int e = blockIdx.z, n0 = blockIdx.x * kT, m0 = blockIdx.y * kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  auto load = [&](int chunk, int buf) {
#pragma unroll
    for (int i = tid; i < kGK * 8; i += kGThreads) {
      const int rr = i >> 3, cc = (i & 7) * 8;
      const int r = chunk * kGK + rr;
      const bool ok = r < m;
      cp_async16(as[buf] + rr * kLDT + cc, ok ? row_ptr(a, r, e, ne, m) + m0 + cc : a.base, ok);
      cp_async16(bs[buf] + rr * kLDT + cc, ok ? row_ptr(b, r, e, ne, m) + n0 + cc : b.base, ok);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int nchunks = (m + kGK - 1) / kGK;
  load(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < nchunks) load(ch + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kGK / 16; ++ks) {
      // A^T fragment: A is stored [k = row][m], so a transposing ldmatrix
      uint32_t af[4];
      const int mat = lane >> 3;
      ldmatrix_x4_trans(af, as[buf] + (ks * 16 + (lane & 7) + (mat >> 1) * 8) * kLDT +
                                warp * 16 + (mat & 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];  // B stored [k = row][n]
        ldmatrix_x4_trans(bf, bs[buf] + (ks * 16 + (lane & 15)) * kLDT + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    __nv_bfloat16* crow = c + ((int64_t)e * M + m0 + warp * 16 + g + hf * 8) * N + n0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(crow + nt * 8 + 2 * t4) =
          pack_bf16(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
  }
}

template <int NDC>
int launch_dx(const void* xg, const void* w1, const void* w2, const void* dout, void* dx,
              void* da, void* h, int n, int e, int k, int f, cudaStream_t stream) {
  constexpr int D = NDC * kT;
  const int smem = (2 * kBM * (D + 8) + kBM * kLDT + kStages * kT * kLDT) * 2;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(moe_bwd_dx_kernel<NDC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((n * k + kBM - 1) / kBM, e);
  moe_bwd_dx_kernel<NDC><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xg), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(da),
      static_cast<__nv_bfloat16*>(h), n, e, k, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// da_scratch and h_scratch are (e, n*k, f) bf16 each. Launches the dx pass and
// the two dw GEMMs on `stream`; returns the first launch error, else
// cudaGetLastError(); cudaErrorInvalidValue for a d the dx pass is not
// instantiated for (a multiple of 128 up to 1024).
extern "C" int moe_ffn_bwd(const void* xg, const void* w1, const void* w2, const void* dout,
                           void* dx, void* dw1, void* dw2, void* da_scratch, void* h_scratch,
                           int n, int e, int k, int d, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (d) {
    case 128: err = launch_dx<2>(xg, w1, w2, dout, dx, da_scratch, h_scratch, n, e, k, f, s); break;
    case 256: err = launch_dx<4>(xg, w1, w2, dout, dx, da_scratch, h_scratch, n, e, k, f, s); break;
    case 384: err = launch_dx<6>(xg, w1, w2, dout, dx, da_scratch, h_scratch, n, e, k, f, s); break;
    case 512: err = launch_dx<8>(xg, w1, w2, dout, dx, da_scratch, h_scratch, n, e, k, f, s); break;
    case 640: err = launch_dx<10>(xg, w1, w2, dout, dx, da_scratch, h_scratch, n, e, k, f, s); break;
    case 768: err = launch_dx<12>(xg, w1, w2, dout, dx, da_scratch, h_scratch, n, e, k, f, s); break;
    case 896: err = launch_dx<14>(xg, w1, w2, dout, dx, da_scratch, h_scratch, n, e, k, f, s); break;
    case 1024: err = launch_dx<16>(xg, w1, w2, dout, dx, da_scratch, h_scratch, n, e, k, f, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int m = n * k;
  const auto* x = static_cast<const __nv_bfloat16*>(xg);
  const auto* go = static_cast<const __nv_bfloat16*>(dout);
  const auto* da = static_cast<const __nv_bfloat16*>(da_scratch);
  const auto* h = static_cast<const __nv_bfloat16*>(h_scratch);
  // dw1 (e, d, f) = x^T da
  moe_bwd_dw_kernel<<<dim3(f / kT, d / kT, e), kGThreads, 0, s>>>(
      Rows{x, d, k}, Rows{da, f, 0}, static_cast<__nv_bfloat16*>(dw1), m, e, d, f);
  cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  // dw2 (e, f, d) = h^T do
  moe_bwd_dw_kernel<<<dim3(d / kT, f / kT, e), kGThreads, 0, s>>>(
      Rows{h, f, 0}, Rows{go, d, k}, static_cast<__nv_bfloat16*>(dw2), m, e, f, d);
  return static_cast<int>(cudaGetLastError());
}
