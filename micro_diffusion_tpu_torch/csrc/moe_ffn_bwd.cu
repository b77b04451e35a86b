// Fused EC-MoE expert feed-forward, backward, for Hopper (sm_90a).
//
// Replaces: micro_diffusion_tpu/ops/moe_ffn.py:_dxdw_kernel :124, _dx_kernel :95
// and _dw_kernel :183 (the Pallas TPU kernels behind moe_ffn's backward rule, which
// all compute one function: K2b), and the same kernel bodies under _em_bwd :458
// (moe_ffn_expert_major's backward, expert-major rows: K3's backward), through the
// entry point moe_ffn_em_bwd below.
//
// Contract, per expert e and each of its rows x with output cotangent do:
//   a   = bf16(x @ w1[e])                      recomputed, fp32 accumulation
//   dh  = do @ w2[e]^T                         fp32
//   da  = bf16(gelu'(a) * dh),  gelu'(a) = Phi(a) + a * phi(a)   (erff, expf)
//   h   = bf16(gelu(a))
//   dx  = bf16(da @ w1[e]^T)
//   dw1 = x^T @ da,  dw2 = h^T @ do            fp32 over all rows, stored bf16
// xg, do, dx (n, e, k, d); w1, dw1 (e, d, f); w2, dw2 (e, f, d); all bf16 and
// contiguous. Expert e's rows are the n runs of k rows at xg[:, e], addressed in place
// by the TMA maps (moe_gemm.cuh).
//
// Bound on this card: the 5 products, 10 n e k d f FLOPs, against 2 (3 n e k d + 4 e
// d f) bytes of x, do, dx and the weights and their gradients: > 1000 FLOP/byte at the
// MicroDiT-XL shapes (m = n k = 4096, d = 1024), so the tensor cores bound it (0.782
// ms at f = 2304).
//
// Design: four wgmma GEMM launches (moe_gemm.cuh: TMA rings, a producer warpgroup
// and two consumer warpgroups, 128 x 256 output tiles), the contract's 5 products
// and none repeated:
//   (a) a = bf16(x @ w1[e]) (K = d) into the h half of the (e, n k, f) scratch;
//   (b) dh = do @ w2[e]^T (K = d; w2's rows are the product's N: a K-major B); its
//       epilogue loads the tile's a by TMA, forms da = bf16(gelu'(a) dh) and h =
//       bf16(gelu(a)) in registers, and writes da to the scratch's other half and h
//       over a;
//   (c) dx = bf16(da @ w1[e]^T) (K = f; w1 a K-major B);
//   (d) dw1 = x^T da and dw2 = h^T do in one launch, a grid over both outputs' tiles
//       (K = the expert's rows, MN-major operands on both sides). Each tile is summed
//       over all of its expert's rows inside one block, in a fixed order: no split K,
//       no atomics, the gradients are bitwise repeatable.
// The TPU's fused pass kept an expert's rows in VMEM; here a, da and h go through
// device memory: seven (e, m, f) bf16 transfers (a, da and h written; a read once, da
// twice, h once), 1.06 GB at m = 4096, f = 2304, or 0.32 ms at 3.35 TB/s.
//
// Shapes: k and m multiples of 16 (rows past the end read as zeros, not stored), d a
// multiple of 128 (256-wide tiles for dx and the weight gradients where 256 divides
// d, else 128), f a multiple of 256.

#include "moe_gemm.cuh"

namespace {

// (c) and (d) at one tile width
template <int BN>
int launch_dx_dw(GemmArgs& gc, GemmArgs& gd, int d, int f, cudaStream_t s) {
  gc.tn[0] = d / BN;
  int err = launch_gemm<BN, false, false, kStore>(gc, s);
  if (err != 0) return err;
  gd.tn[0] = f / BN, gd.tn[1] = d / BN;
  return launch_gemm<BN, true, true, kTwo>(gd, s);
}

}  // namespace

// da_scratch and h_scratch are (e, n*k, f) bf16 each. Launches the four GEMMs on
// `stream`; returns the first launch error, else cudaGetLastError();
// cudaErrorInvalidValue for a shape off the grid above.
extern "C" int moe_ffn_bwd(const void* xg, const void* w1, const void* w2, const void* dout,
                           void* dx, void* dw1, void* dw2, void* da_scratch, void* h_scratch,
                           int n, int e, int k, int d, int f, void* stream) {
  if (n < 1 || e < 1 || k < 16 || k % 16 || d < 128 || d % 128 || f < 256 || f % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n * k, box = row_box(k, n), tm = (m + kBM - 1) / kBM;
  Mat x, go, gx, w1m, w2m, da, h, g1, g2;
  int err = make_mat(&x, xg, d, k, e, n, box);
  if (err == 0) err = make_mat(&go, dout, d, k, e, n, box);
  if (err == 0) err = make_mat(&gx, dx, d, k, e, n, box);
  if (err == 0) err = make_mat(&w1m, w1, f, d, e, 1, 64);
  if (err == 0) err = make_mat(&w2m, w2, d, f, e, 1, 64);
  if (err == 0) err = make_mat(&da, da_scratch, f, m, e, 1, 64);
  if (err == 0) err = make_mat(&h, h_scratch, f, m, e, 1, 64);
  if (err == 0) err = make_mat(&g1, dw1, f, d, e, 1, 64);
  if (err == 0) err = make_mat(&g2, dw2, d, f, e, 1, 64);
  if (err != 0) return err;

  // (a) a = x w1 into h's place, (b) dh = do w2^T -> da, h
  GemmArgs ga = {}, gb = {};
  ga.a[0] = x, ga.b[0] = w1m, ga.c[0] = h;
  ga.nk = d / kBK, ga.tm[0] = tm, ga.tn[0] = f / 256, ga.ne = e;
  err = launch_gemm<256, false, true, kStore>(ga, s);
  if (err != 0) return err;
  gb.a[0] = go, gb.b[0] = w2m, gb.c[0] = da, gb.c[1] = h;
  gb.nk = d / kBK, gb.tm[0] = tm, gb.tn[0] = f / 256, gb.ne = e;
  err = launch_gemm<256, false, false, kGeluGrad>(gb, s);
  if (err != 0) return err;

  // (c) dx: da a K-major A, w1 (rows d, columns f) a K-major B
  GemmArgs gc = {};
  gc.a[0] = da, gc.b[0] = w1m, gc.c[0] = gx;
  gc.nk = f / kBK, gc.tm[0] = tm, gc.ne = e;
  // (d) dw1 (d x f) = x^T da, dw2 (f x d) = h^T do
  GemmArgs gd = {};
  gd.a[0] = x, gd.b[0] = da, gd.c[0] = g1, gd.a[1] = h, gd.b[1] = go, gd.c[1] = g2;
  gd.nk = (m + kBK - 1) / kBK, gd.tm[0] = d / kBM, gd.tm[1] = f / kBM, gd.ne = e;
  return d % 256 == 0 ? launch_dx_dw<256>(gc, gd, d, f, s) : launch_dx_dw<128>(gc, gd, d, f, s);
}

// K3's backward: expert-major xg, dout, dx (e, m, d), scratch (e, m, f) each: the
// sample-major layout with n = 1 and k = m (m up to 8192 on the 512px path).
extern "C" int moe_ffn_em_bwd(const void* xg, const void* w1, const void* w2, const void* dout,
                              void* dx, void* dw1, void* dw2, void* da_scratch, void* h_scratch,
                              int e, int m, int d, int f, void* stream) {
  return moe_ffn_bwd(xg, w1, w2, dout, dx, dw1, dw2, da_scratch, h_scratch, 1, e, m, d, f,
                     stream);
}
