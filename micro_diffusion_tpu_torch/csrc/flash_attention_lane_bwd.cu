// Non-causal multi-head attention backward, head_dim 16, 32 or 64, any head count,
// for Hopper (sm_90a).
//
// Replaces the backward kernels of the same two Pallas TPU kernels as
// flash_attention_lane.cu (one function, two TPU layouts):
//   micro_diffusion_tpu/ops/flash_attention_lane.py:_bwd_kernel (K1b, head_dim 64)
//   micro_diffusion_tpu/ops/flash_attention_bh.py:_bwd_kernel (K4b, 'flash_bh').
//
// Contract (the TPU kernel's), per (batch, head), nothing saved from the forward
// but q, k, v: the row statistics are recomputed and every 1/l rides a (T, D)
// tile, never the (Tq, Tk) one.
//   s = q k^T (fp32), e = exp2((s - rowmax) * scale * log2(e)), inv_l = 1/rowsum(e)
//   dv   = bf16(e)^T @ bf16(do * inv_l)
//   dp   = do @ v^T (fp32),  delta = rowsum(e * dp) * inv_l
//   ds_u = bf16(e * (dp - delta))
//   dq   = (ds_u @ k) * (scale * inv_l)
//   dk   = ds_u^T @ bf16(q * scale * inv_l)
// All products are bf16 x bf16 with fp32 accumulation (mma.sync m16n8k16);
// dq, dk, dv are stored as bf16.
//
// Layout: q, do (B, Tq, H, D) and k, v (B, Tk, H, D) bf16, read through their
// (batch, seq, head) strides, head dim contiguous; dq, dk, dv written through
// theirs. No (B*H, T, D) relayout.
//
// Why two kernels. The TPU kernels holds one head's whole q, k, v in VMEM; at
// T = 1024 the (Tq, Tk) fp32 score tile alone is 4 MB, far over the 227 KB of
// shared memory a block may use, so the work is tiled over keys and queries,
// and the row statistics must be complete before ds exists:
//   pass 1 (attn_bwd_dq_kernel), one block per 64-query tile: sweep the key
//     tiles once for the row max, l and sum(e * dp) (online), store (max, inv_l,
//     delta) per row to a small fp32 scratch, then sweep again for ds_u and dq.
//   pass 2 (attn_bwd_dkdv_kernel), one block per 64-key tile: dk and dv stay
//     in registers while the block loops over the query tiles, recomputing s^T,
//     e^T and dp^T from the stored statistics.
// e is recomputed with the exact row max, so the function is the contract's;
// only the summation order of l and delta differs from a one-shot row sum.
//
// Bound on this card: per (batch, head) 5 products of 2*Tq*Tk*D FLOPs against
// 2*D*(3*Tq + 4*Tk) bytes; 10*Tq*Tk*D / (2*D*(3Tq + 4Tk)) FLOP/byte is 183 at
// Tq = Tk = 256 and ~100 for the cross-attention at Tk = 77 (bytes), 731 at
// Tq = Tk = 1024 (tensor cores). This design recomputes s and dp in both passes (9 products of work
// for the contract's 5) and, at D = 32, spends more on the fp32 softmax work
// of each 64 x 64 tile than on its MMAs: simple first.
//
// Ragged lengths: keys past Tk are zero-filled in shared memory and masked (to
// -inf in pass 1, e = 0 in pass 2); queries past Tq are zero-filled and get
// e = 0 and zero statistics, so they add nothing to dk and dv.

#include <math.h>

#include "attention_tiles.cuh"

namespace {

// Pass 1: row statistics and dq. Grid (ceil(Tq/64), H, B); warp w owns query
// rows 16w..16w+15 of the tile; half hf of a c fragment is row g + 8 hf.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                          float* __restrict__ stats, int tq, int tk, int nh, Strides qs_,
                          Strides ks_, Strides vs_, Strides dos_, Strides dqs_, float c,
                          float scale) {
  constexpr int LD = D + 8, NT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 qs[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 dos[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kT * LD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const __nv_bfloat16* qb = q + (int64_t)b * qs_.sb + (int64_t)h * qs_.sh;
  const __nv_bfloat16* dob = dout + (int64_t)b * dos_.sb + (int64_t)h * dos_.sh;
  const __nv_bfloat16* kb = k + (int64_t)b * ks_.sb + (int64_t)h * ks_.sh;
  const __nv_bfloat16* vb = v + (int64_t)b * vs_.sb + (int64_t)h * vs_.sh;

  load_tile<D>(qs, qb, qt * kT, tq, qs_.st, tid);
  load_tile<D>(dos, dob, qt * kT, tq, dos_.st, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, qs, warp * 16, lane);
  load_a<D>(df, dos, warp * 16, lane);

  const int ntiles = (tk + kT - 1) / kT;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
  float s[8][4], dp[8][4];

  // sweep 1: row max, l = sum(e), sum(e * dp), online across key tiles
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(ks, kb, j * kT, tk, ks_.st, tid);
    load_tile<D>(vs, vb, j * kT, tk, vs_.st, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    mma_abt<D>(s, qf, ks, lane);
    mma_abt<D>(dp, df, vs, lane);
    const int key0 = j * kT;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + nt * 8 + 2 * t4 + (e & 1) >= tk) s[nt][e] = -INFINITY;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m_run[hf];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f((m_run[hf] - mx) * c);
      m_run[hf] = mx;
      float ls = 0.f, ds = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          const float p = exp2f((s[nt][e] - mx) * c);
          ls += p;
          ds += p * dp[nt][e];
        }
      l_run[hf] = l_run[hf] * alpha + ls;
      d_run[hf] = d_run[hf] * alpha + ds;
    }
  }

  float m_row[2], inv_l[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf], dd = d_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    dd += __shfl_xor_sync(0xffffffffu, dd, 2);
    m_row[hf] = m_run[hf];
    inv_l[hf] = 1.f / l;
    delta[hf] = dd * inv_l[hf];
    const int row = qt * kT + warp * 16 + g + hf * 8;
    if (t4 == 0 && row < tq) {
      const int64_t plane = (int64_t)gridDim.z * nh * tq;
      const int64_t idx = ((int64_t)b * nh + h) * tq + row;
      stats[idx] = m_row[hf];
      stats[plane + idx] = inv_l[hf];
      stats[2 * plane + idx] = delta[hf];
    }
  }

  // sweep 2: ds_u = bf16(e * (dp - delta)); dq += ds_u @ k
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();
    load_tile<D>(ks, kb, j * kT, tk, ks_.st, tid);
    load_tile<D>(vs, vb, j * kT, tk, vs_.st, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    mma_abt<D>(s, qf, ks, lane);
    mma_abt<D>(dp, df, vs, lane);
    const int key0 = j * kT;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const bool ok = key0 + nt * 8 + 2 * t4 + (e & 1) < tk;
        const float p = ok ? exp2f((s[nt][e] - m_row[hf]) * c) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta[hf]);  // rounded to bf16 by mma_pb
      }
    mma_pb<D>(acc, s, ks, lane);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float cb = scale * inv_l[hf];
    const int row = qt * kT + warp * 16 + g + hf * 8;
    if (row < tq) {
      __nv_bfloat16* out = dq + (int64_t)b * dqs_.sb + (int64_t)row * dqs_.st + (int64_t)h * dqs_.sh;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(out + nt * 8 + 2 * t4) =
            pack_bf16(acc[nt][2 * hf] * cb, acc[nt][2 * hf + 1] * cb);
    }
  }
}

// Pass 2: dk and dv. Grid (ceil(Tk/64), H, B); warp w owns key rows 16w..16w+15
// of the tile; fragments hold s^T (rows = keys, columns = queries).
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            const float* __restrict__ stats, int tq, int tk, int nh,
                            Strides qs_, Strides ks_, Strides vs_, Strides dos_, Strides dks_,
                            Strides dvs_, float c, float scale) {
  constexpr int LD = D + 8, NT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 qs[kT * LD];   // q, then bf16(q * scale * inv_l)
  __shared__ __align__(16) __nv_bfloat16 dos[kT * LD];  // do, then bf16(do * inv_l)
  __shared__ float m_s[kT], il_s[kT], dl_s[kT];

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, g = lane >> 2;

  const __nv_bfloat16* qb = q + (int64_t)b * qs_.sb + (int64_t)h * qs_.sh;
  const __nv_bfloat16* dob = dout + (int64_t)b * dos_.sb + (int64_t)h * dos_.sh;
  const __nv_bfloat16* kb = k + (int64_t)b * ks_.sb + (int64_t)h * ks_.sh;
  const __nv_bfloat16* vb = v + (int64_t)b * vs_.sb + (int64_t)h * vs_.sh;
  const int64_t plane = (int64_t)gridDim.z * nh * tq;
  const float* st = stats + ((int64_t)b * nh + h) * tq;

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
    __syncthreads();  // the previous tile's scaled q / do are no longer read
    load_tile<D>(qs, qb, q0, tq, qs_.st, tid);
    load_tile<D>(dos, dob, q0, tq, dos_.st, tid);
    cp_async_commit();
    if (tid < kT) {
      const bool ok = q0 + tid < tq;
      m_s[tid] = ok ? st[q0 + tid] : 0.f;
      il_s[tid] = ok ? st[plane + q0 + tid] : 0.f;
      dl_s[tid] = ok ? st[2 * plane + q0 + tid] : 0.f;
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
        const int key = kt * kT + warp * 16 + g + (e >> 1) * 8;
        const bool ok = (q0 + col < tq) && (key < tk);
        const float p = ok ? exp2f((s[nt][e] - m_s[col]) * c) : 0.f;
        s[nt][e] = p;                             // e^T, rounded to bf16 by mma_pb
        dp[nt][e] = p * (dp[nt][e] - dl_s[col]);  // ds_u^T, rounded by mma_pb
      }
    __syncthreads();  // every warp is done reading raw q and do
    for (int idx = tid; idx < kT * D; idx += kThreads) {
      const int r = idx / D, cc = idx % D;
      const float cb = scale * il_s[r];
      qs[r * LD + cc] = __float2bfloat16_rn(__bfloat162float(qs[r * LD + cc]) * cb);
      dos[r * LD + cc] = __float2bfloat16_rn(__bfloat162float(dos[r * LD + cc]) * il_s[r]);
    }
    __syncthreads();
    mma_pb<D>(dv_acc, s, dos, lane);   // dv += bf16(e)^T @ bf16(do * inv_l)
    mma_pb<D>(dk_acc, dp, qs, lane);   // dk += ds_u^T @ bf16(q * scale * inv_l)
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

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* dout, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
           float* stats, int b, int tq, int tk, int h, Strides qs, Strides ks, Strides vs,
           Strides ds, Strides dqs, Strides dks, Strides dvs, float c, float scale,
           cudaStream_t s) {
  attn_bwd_dq_kernel<D><<<dim3((tq + kT - 1) / kT, h, b), kThreads, 0, s>>>(
      q, k, v, dout, dq, stats, tq, tk, h, qs, ks, vs, ds, dqs, c, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<D><<<dim3((tk + kT - 1) / kT, h, b), kThreads, 0, s>>>(
      q, k, v, dout, dk, dv, stats, tq, tk, h, qs, ks, vs, ds, dks, dvs, c, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements; stats is fp32 scratch of 3 * b * h * tq floats.
// Launches both passes on `stream`; returns cudaGetLastError() after them, or
// cudaErrorInvalidValue for a head_dim the kernels are not instantiated for.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, void* stats,
                                   int b, int tq, int tk, int h, int d, int qsb, int qst, int qsh,
                                   int ksb, int kst, int ksh, int vsb, int vst, int vsh, int dsb,
                                   int dst, int dsh, int dqsb, int dqst, int dqsh, int dksb,
                                   int dkst, int dksh, int dvsb, int dvst, int dvsh, float scale,
                                   void* stream) {
  const float c = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dp = static_cast<const __nv_bfloat16*>(dout);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* sp = static_cast<float*>(stats);
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh}, ds{dsb, dst, dsh};
  const Strides dqs{dqsb, dqst, dqsh}, dks{dksb, dkst, dksh}, dvs{dvsb, dvst, dvsh};
  switch (d) {
    case 16: return launch<16>(qp, kp, vp, dp, dqp, dkp, dvp, sp, b, tq, tk, h, qs, ks, vs, ds, dqs, dks, dvs, c, scale, s);
    case 32: return launch<32>(qp, kp, vp, dp, dqp, dkp, dvp, sp, b, tq, tk, h, qs, ks, vs, ds, dqs, dks, dvs, c, scale, s);
    case 64: return launch<64>(qp, kp, vp, dp, dqp, dkp, dvp, sp, b, tq, tk, h, qs, ks, vs, ds, dqs, dks, dvs, c, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
