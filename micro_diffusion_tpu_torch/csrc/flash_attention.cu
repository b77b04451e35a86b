// Tiled flash attention backward with the saved row logsumexp ('flash_bthd', K5),
// head_dim 16, 32 or 64, any head count, for Hopper (sm_90a).
//
// Replaces the backward of micro_diffusion_tpu/ops/flash_attention.py
// (`_bwd_rule` :235): its two Pallas TPU kernels `_dq_kernel` :140 and
// `_dkv_kernel` :172, and the delta reduction it leaves to XLA. The forward
// (`_fwd_kernel` :76) is flash_attention_lane.cu's kernel, which writes the row
// logsumexp when asked.
//
// Contract (the TPU kernels'), per (batch, head), from the forward's bf16 `out`
// and fp32 `lse` (natural log of the row sum of exp(s), s = q k^T * scale):
//   delta = rowsum(fp32(do) * fp32(out))
//   p     = exp(s - lse)                        (the exact probabilities)
//   dp    = do @ v^T (fp32: bf16 products, exact in fp32)
//   ds    = bf16(p * (dp - delta) * scale)
//   dq    = ds @ k,   dk = ds^T @ q,   dv = bf16(p)^T @ do   (fp32 sums, stored bf16)
//
// Design. Two kernels, as on the TPU, each tiled 64 x 64 over both sequences:
//   attn_lse_dq_kernel, one block per 64-query tile: a prologue computes delta
//     for the tile's rows from do and out (fused here; the TPU left it to XLA)
//     and stores it for the second kernel, then one sweep over the key tiles
//     recomputes s and dp, forms ds and accumulates dq in registers.
//   attn_lse_dkdv_kernel, one block per 64-key tile: k and v stay in registers
//     as A fragments while the block sweeps the query tiles, recomputing s^T and
//     dp^T; dk and dv accumulate in registers.
// The saved logsumexp makes every probability exact on first sight, so each
// kernel sweeps the other sequence once (K1b/K4b, which save nothing, sweep twice
// in their dq pass). The work is 7 products of 2*Tq*Tk*D (s and dp in both
// kernels) for the contract's 5; a fused one-kernel backward with an atomic dq
// would do 5.
//
// Bound on this card: 5 products of 2*Tq*Tk*D FLOPs per (batch, head) against
// 2*D*(4*Tq + 4*Tk) + 4*Tq bytes (q, do, out, dq; k, v, dk, dv; lse) read or
// written once: at Tq = Tk = 256, D = 64 about 156 FLOP/byte (bytes, under the
// ~295 FLOP/byte ridge of 989 TFLOP/s over 3.35 TB/s), at 1024 about 625
// (operations).
//
// Layout: q, do, out (B, Tq, H, D) and k, v (B, Tk, H, D) bf16 through their
// (batch, seq, head) strides, head dim contiguous; dq, dk, dv written through
// theirs; lse and delta (B, H, Tq) fp32 contiguous. Ragged lengths: keys past Tk
// and queries past Tq are zero-filled in shared memory and get p = 0, so they add
// nothing; their rows are not stored.

#include <math.h>

#include "attention_tiles.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// dq pass. Grid (ceil(Tq/64), H, B); warp w owns query rows 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_lse_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                       float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int tq, int tk,
                       Strides qs_, Strides ks_, Strides vs_, Strides os_, Strides dos_,
                       Strides dqs_, float c, float scale) {
  constexpr int LD = D + 8, NT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 dos[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kT * LD];
  __shared__ float lse_s[kT], delta_s[kT];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * kT;

  const __nv_bfloat16* qb = q + (int64_t)b * qs_.sb + (int64_t)h * qs_.sh;
  const __nv_bfloat16* dob = dout + (int64_t)b * dos_.sb + (int64_t)h * dos_.sh;
  const __nv_bfloat16* ob = out + (int64_t)b * os_.sb + (int64_t)h * os_.sh;
  const __nv_bfloat16* kb = k + (int64_t)b * ks_.sb + (int64_t)h * ks_.sh;
  const __nv_bfloat16* vb = v + (int64_t)b * vs_.sb + (int64_t)h * vs_.sh;
  const int64_t row_base = ((int64_t)b * gridDim.y + h) * tq;  // (B, H, Tq) index of row 0

  load_tile<D>(qs, qb, q0, tq, qs_.st, tid);
  load_tile<D>(dos, dob, q0, tq, dos_.st, tid);
  cp_async_commit();

  // delta = rowsum(do * out) in fp32, one row at a time per warp (the lanes split
  // the head dim), read straight from device memory while the tiles arrive
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < tq) {
      const __nv_bfloat16* orow = ob + (int64_t)row * os_.st;
      const __nv_bfloat16* drow = dob + (int64_t)row * dos_.st;
      for (int i = lane; i < D; i += 32)
        acc += __bfloat162float(drow[i]) * __bfloat162float(orow[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = row < tq ? lse[row_base + row] : 0.f;
      if (row < tq) delta[row_base + row] = acc;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, qs, warp * 16, lane);
  load_a<D>(df, dos, warp * 16, lane);
  float lse2[2], dl[2];  // lse * log2(e) and delta of rows g and g + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lse2[hf] = lse_s[warp * 16 + g + hf * 8] * kLog2e;
    dl[hf] = delta_s[warp * 16 + g + hf * 8];
  }

  float acc[NT][4], s[8][4], dp[8][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int ntiles = (tk + kT - 1) / kT;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<D>(ks, kb, j * kT, tk, ks_.st, tid);
    load_tile<D>(vs, vb, j * kT, tk, vs_.st, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    mma_abt<D>(s, qf, ks, lane);   // s = q k^T (unscaled)
    mma_abt<D>(dp, df, vs, lane);  // dp = do v^T
    const int key0 = j * kT;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const bool ok = key0 + nt * 8 + 2 * t4 + (e & 1) < tk;
        const float p = ok ? exp2f(s[nt][e] * c - lse2[hf]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[hf]) * scale;  // ds, rounded to bf16 by mma_pb
      }
    mma_pb<D>(acc, s, ks, lane);  // dq += ds @ k
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + warp * 16 + g + hf * 8;
    if (row < tq) {
      __nv_bfloat16* o = dq + (int64_t)b * dqs_.sb + (int64_t)row * dqs_.st + (int64_t)h * dqs_.sh;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(o + nt * 8 + 2 * t4) =
            pack_bf16(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  }
}

// dk/dv pass. Grid (ceil(Tk/64), H, B); warp w owns key rows 16w..16w+15 of the
// tile; the fragments hold s^T (rows = keys, columns = queries).
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_lse_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int tq, int tk, Strides qs_,
                         Strides ks_, Strides vs_, Strides dos_, Strides dks_, Strides dvs_,
                         float c, float scale) {
  constexpr int LD = D + 8, NT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 qs[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 dos[kT * LD];
  __shared__ float lse2_s[kT], dl_s[kT];

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2;

  const __nv_bfloat16* qb = q + (int64_t)b * qs_.sb + (int64_t)h * qs_.sh;
  const __nv_bfloat16* dob = dout + (int64_t)b * dos_.sb + (int64_t)h * dos_.sh;
  const __nv_bfloat16* kb = k + (int64_t)b * ks_.sb + (int64_t)h * ks_.sh;
  const __nv_bfloat16* vb = v + (int64_t)b * vs_.sb + (int64_t)h * vs_.sh;
  const int64_t row_base = ((int64_t)b * gridDim.y + h) * tq;

  load_tile<D>(ks, kb, kt * kT, tk, ks_.st, tid);
  load_tile<D>(vs, vb, kt * kT, tk, vs_.st, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, ks, warp * 16, lane);
  load_a<D>(vf, vs, warp * 16, lane);

  float dk_acc[NT][4], dv_acc[NT][4], s[8][4], dp[8][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int ntiles = (tq + kT - 1) / kT;
  for (int i = 0; i < ntiles; ++i) {
    const int q0 = i * kT;
    __syncthreads();  // the previous query tile is no longer read
    load_tile<D>(qs, qb, q0, tq, qs_.st, tid);
    load_tile<D>(dos, dob, q0, tq, dos_.st, tid);
    cp_async_commit();
    if (tid < kT) {
      const bool ok = q0 + tid < tq;
      lse2_s[tid] = ok ? lse[row_base + q0 + tid] * kLog2e : 0.f;
      dl_s[tid] = ok ? delta[row_base + q0 + tid] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    mma_abt<D>(s, kf, qs, lane);    // s^T = k q^T
    mma_abt<D>(dp, vf, dos, lane);  // dp^T = v do^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t4 + (e & 1);
        const bool ok = q0 + col < tq;
        const float p = ok ? exp2f(s[nt][e] * c - lse2_s[col]) : 0.f;
        s[nt][e] = p;                                     // p^T, rounded to bf16 by mma_pb
        dp[nt][e] = p * (dp[nt][e] - dl_s[col]) * scale;  // ds^T, rounded by mma_pb
      }
    mma_pb<D>(dv_acc, s, dos, lane);  // dv += bf16(p)^T @ do
    mma_pb<D>(dk_acc, dp, qs, lane);  // dk += ds^T @ q
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = kt * kT + warp * 16 + g + hf * 8;
    if (key < tk) {
      __nv_bfloat16* ok_ = dk + (int64_t)b * dks_.sb + (int64_t)key * dks_.st + (int64_t)h * dks_.sh;
      __nv_bfloat16* ov = dv + (int64_t)b * dvs_.sb + (int64_t)key * dvs_.st + (int64_t)h * dvs_.sh;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<uint32_t*>(ok_ + nt * 8 + 2 * t4) =
            pack_bf16(dk_acc[nt][2 * hf], dk_acc[nt][2 * hf + 1]);
        *reinterpret_cast<uint32_t*>(ov + nt * 8 + 2 * t4) =
            pack_bf16(dv_acc[nt][2 * hf], dv_acc[nt][2 * hf + 1]);
      }
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int b, tq, tk, h;
  Strides qs, ks, vs, os, ds, dqs, dks, dvs;
  float c, scale;
};

template <int D>
int launch(const Args& a, cudaStream_t s) {
  attn_lse_dq_kernel<D><<<dim3((a.tq + kT - 1) / kT, a.h, a.b), kThreads, 0, s>>>(
      a.q, a.k, a.v, a.out, a.dout, a.lse, a.delta, a.dq, a.tq, a.tk, a.qs, a.ks, a.vs, a.os,
      a.ds, a.dqs, a.c, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_lse_dkdv_kernel<D><<<dim3((a.tk + kT - 1) / kT, a.h, a.b), kThreads, 0, s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.tq, a.tk, a.qs, a.ks, a.vs, a.ds,
      a.dks, a.dvs, a.c, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements, 3 per tensor (batch, seq, head), in the order q, k, v,
// out, do, dq, dk, dv; lse is the forward's (b, h, tq) fp32, delta fp32 scratch of
// the same size that the dq kernel fills for the dk/dv kernel. Launches both
// kernels on `stream`; returns cudaGetLastError() after each (the first failure),
// or cudaErrorInvalidValue for a head_dim they are not instantiated for.
extern "C" int flash_attention_lse_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int b, int tq,
                                       int tk, int h, int d, const int* strides, float scale,
                                       void* stream) {
  const int* st = strides;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(out),
         static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
         static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dq),
         static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), b, tq, tk, h,
         Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
         Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
         Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
         Strides{st[18], st[19], st[20]}, Strides{st[21], st[22], st[23]},
         static_cast<float>(static_cast<double>(scale) * 1.4426950408889634), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
