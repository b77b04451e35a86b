// Non-causal multi-head attention forward, head_dim 16, 32 or 64, any head count,
// for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels that compute one function:
//   micro_diffusion_tpu/ops/flash_attention_lane.py:_fwd_kernel (K1: head_dim 64,
//     two heads packed side by side in 128 lanes; the packing was a TPU device
//     and is not carried over), and
//   micro_diffusion_tpu/ops/flash_attention_bh.py:_fwd_kernel (K4, 'flash_bh': the
//     head_dims the lane kernel does not take, MicroDiT-Tiny at D = 32 and Micro
//     at D = 16, at Tq >= 512 under 'auto').
// One kernel templated on D serves both: ops/flash_attention_lane.py and
// ops/flash_attention_bh.py call the one entry point and count their own launches.
//
// Contract (the TPU kernel's): s = q k^T in fp32 (unscaled),
//   e = exp2((s - rowmax(s)) * scale * log2(e)), l = rowsum(e) in fp32,
//   out = (bf16(e) @ v, fp32 accumulation) / l, stored as bf16.
// The TPU kernel holds one (batch, head)'s whole K and V in VMEM. Here the row
// max and row sum are kept online across key tiles (flash-attention rescaling
// of the fp32 accumulator), so e is cast to bf16 against the running max rather
// than the final one: the same function up to one bf16 rounding of each e.
//
// Layout: q (B, Tq, H, D), k/v (B, Tk, H, D), out (B, Tq, H, D), bf16, read and
// written through their (batch, seq, head) strides; the head dim is contiguous.
// The JAX wrapper's (B*H, T, D) transposes were a TPU relayout and are not
// carried over: k and v are read as strided views of the packed projections.
//
// Bound on this card: per (batch, head) 4*Tq*Tk*D FLOPs against 2*D*(2*Tq + 2*Tk)
// bytes, Tq*Tk/(Tq+Tk) FLOP/byte: 128 for 256px self-attention (T = 256) and
// 59-72 for cross-attention (Tk = 77), below the H100's ~295 FLOP/byte ridge
// (bytes, 3.35 TB/s); 512 at Tq = Tk = 1024, so 512px self-attention is bound by
// the tensor cores (989 TFLOP/s bf16). At
// D = 32 a 64 x 64 score tile costs 2 * 64 * 64 * 32 MMA FLOPs against 4096
// exp2s: the softmax's special-function and fp32 work, not the MMAs, is what
// this simple kernel spends its time on.
// Design: each block reads its 64-query tile once and streams the (batch,
// head)'s K/V tiles of 64 keys with cp.async double buffering; scores,
// probabilities and the partial output stay in registers (mma.sync m16n8k16
// bf16, fp32 accumulators), so only q, k, v and out touch device memory.
// Ragged Tk (77 caption tokens) is zero-filled in shared memory and masked to
// -inf before the row max; ragged Tq rows are zero-filled and not written.
//
// Grid: (ceil(Tq/64), H, B); block: 4 warps, each owning 16 query rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per tile
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
  for (int i = tid; i < kBN * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const int row = row0 + r;
    const bool ok = row < rows;
    cp_async16(dst + r * LD + c, ok ? base + (int64_t)row * row_stride + c : base, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int tq,
                       int tk, int qsb, int qst, int qsh, int ksb, int kst, int ksh, int vsb,
                       int vst, int vsh, int osb, int ost, int osh, float c) {
  constexpr int LD = D + 8;   // shared row stride (bf16): 16-byte aligned rows
  constexpr int KS = D / 16;  // k16 steps over the head dim
  constexpr int NT = D / 8;   // n8 tiles of the output
  __shared__ __align__(16) __nv_bfloat16 qs[kBM * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[2][kBN * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kBN * LD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2;

  const __nv_bfloat16* qb = q + (int64_t)b * qsb + (int64_t)h * qsh;
  const __nv_bfloat16* kb = k + (int64_t)b * ksb + (int64_t)h * ksh;
  const __nv_bfloat16* vb = v + (int64_t)b * vsb + (int64_t)h * vsh;

  load_tile<D>(qs, qb, qt * kBM, tq, qst, tid);
  load_tile<D>(ks[0], kb, 0, tk, kst, tid);
  load_tile<D>(vs[0], vb, 0, tk, vst, tid);
  cp_async_commit();

  const int ntiles = (tk + kBN - 1) / kBN;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  uint32_t qf[KS][4];

  for (int j = 0; j < ntiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntiles) {
      load_tile<D>(ks[buf ^ 1], kb, (j + 1) * kBN, tk, kst, tid);
      load_tile<D>(vs[buf ^ 1], vb, (j + 1) * kBN, tk, vst, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n8 tiles).
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int mat = lane >> 3;
        const int key = np * 16 + (mat >> 1) * 8 + (lane & 7);
        uint32_t bf[4];
        ldmatrix_x4(bf, ks[buf] + key * LD + kk * 16 + (mat & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    const int key0 = j * kBN;
    if (key0 + kBN > tk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + nt * 8 + 2 * t4 + (e & 1) >= tk) s[nt][e] = -INFINITY;
    }

    // Online softmax; half 0 is row g (elements 0,1), half 1 is row g+8 (2,3).
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m_run[hf];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f((m_run[hf] - mx) * c);
      m_run[hf] = mx;
      float lsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = exp2f((s[nt][2 * hf] - mx) * c);
        const float p1 = exp2f((s[nt][2 * hf + 1] - mx) * c);
        s[nt][2 * hf] = p0;
        s[nt][2 * hf + 1] = p1;
        lsum += p0 + p1;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][2 * hf] *= alpha;
        acc[nt][2 * hf + 1] *= alpha;
      }
      l_run[hf] = l_run[hf] * alpha + lsum;
    }

    // O += bf16(E) V: E is the A operand straight from the score registers.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs[buf] + (kc * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = qt * kBM + warp * 16 + g + hf * 8;
    if (row < tq) {
      __nv_bfloat16* orow = o + (int64_t)b * osb + (int64_t)row * ost + (int64_t)h * osh;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * t4) =
            pack_bf16(acc[nt][2 * hf] * inv, acc[nt][2 * hf + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int tq, int tk, int h,
           int qsb, int qst, int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh,
           int osb, int ost, int osh, float c, cudaStream_t stream) {
  dim3 grid((tq + kBM - 1) / kBM, h, b);
  attn_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), tq, tk, qsb, qst,
      qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head_dim the kernel is not instantiated for.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int b, int tq, int tk, int h, int d, int qsb, int qst,
                                   int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh,
                                   int osb, int ost, int osh, float scale, void* stream) {
  // scale * log2(e), folded into the exp2 multiplier (m is taken on the unscaled s)
  const float c = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, b, tq, tk, h, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, c, s);
    case 32: return launch<32>(q, k, v, o, b, tq, tk, h, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, c, s);
    case 64: return launch<64>(q, k, v, o, b, tq, tk, h, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
