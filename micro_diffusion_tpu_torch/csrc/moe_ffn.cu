// Fused EC-MoE expert feed-forward, forward, for Hopper (sm_90a).
//
// Replaces: micro_diffusion_tpu/ops/moe_ffn.py:_fwd_kernel :74 (the Pallas TPU
// kernel behind moe_ffn, sample-major rows: K2), and the same kernel body under
// _em_fwd :439 (moe_ffn_expert_major, the `gather` dispatch's expert-major rows:
// K3), through the entry point moe_ffn_em_fwd below.
//
// Contract, per expert e and each of its rows x (moe_ffn.py:65-68, 83-85):
//   a   = x @ w1[e]                      fp32 accumulation
//   a   = bf16(a)                        rounded to bf16 before the activation
//   h   = bf16(gelu_exact(a))            erf GELU in fp32 (erff)
//   out = h @ w2[e]                      fp32 accumulation, stored as bf16
// xg (n, e, k, d), w1 (e, d, f), w2 (e, f, d), out (n, e, k, d), all bf16 and
// contiguous. Expert e's rows are the n runs of k rows at xg[:, e]; the TMA maps
// address them in place (moe_gemm.cuh), with no gather on the host.
//
// Bound on this card: 4 n e k d f FLOPs against 2 (2 n e k d + 2 e d f) bytes of x,
// out and the weights. At the MicroDiT-XL 512px shapes (e = 8, m = n k = 4096, d =
// 1024, f 768 to 3840) that is ~500 FLOP/byte, above the H100's ~295 FLOP/byte ridge:
// the tensor cores bound it (989 TFLOP/s bf16; 0.313 ms at f = 2304).
//
// Design: two wgmma GEMMs (moe_gemm.cuh: TMA rings, a producer warpgroup and two
// consumer warpgroups, 128 x 256 output tiles), the hidden between them in an
// (e, n k, f) bf16 scratch that the wrapper allocates:
//   GEMM1  hidden = bf16(gelu(bf16(x @ w1[e])))   K = d, the roundings and the GELU
//                                                  in the epilogue, in registers
//   GEMM2  out    = bf16(hidden @ w2[e])          K = f
// x and the hidden are K-major A operands, w1 and w2 MN-major B operands (read as
// stored, no transpose). The TPU kernel kept the (rows, f) hidden on the chip (100 MB
// of VMEM); on an SM that forces a 32-row tile whose blocks stream the expert's whole
// w1 and w2 from L2 once per 32 rows (~9.7 GB of L2 traffic per stage-4 call). The
// hidden's round trip instead costs 2 e m f 2 bytes written and read: 302 MB at f =
// 2304, which with x, out and the weights (210 MB) is 0.153 ms at 3.35 TB/s, under
// half the tensor-core bound, so the unfused pair stays compute-bound.
//
// Shapes: k and m multiples of 16 (rows past the end read as zeros, not stored), d a
// multiple of 128 (GEMM2's tiles are 256 wide where 256 divides d, else 128), f a
// multiple of 256.

#include "moe_gemm.cuh"

// hidden: (e, n k, f) bf16 scratch, written by GEMM1 and read by GEMM2. Launches
// both GEMMs on `stream`; returns the first launch error, else cudaGetLastError();
// cudaErrorInvalidValue for a shape off the grid above.
extern "C" int moe_ffn_fwd(const void* xg, const void* w1, const void* w2, void* out, void* hidden,
                           int n, int e, int k, int d, int f, void* stream) {
  if (n < 1 || e < 1 || k < 16 || k % 16 || d < 128 || d % 128 || f < 256 || f % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n * k, box = row_box(k, n), tm = (m + kBM - 1) / kBM;
  GemmArgs g1 = {}, g2 = {};
  int err = make_mat(&g1.a[0], xg, d, k, e, n, box);
  if (err == 0) err = make_mat(&g1.b[0], w1, f, d, e, 1, 64);
  if (err == 0) err = make_mat(&g1.c[0], hidden, f, m, e, 1, 64);
  if (err == 0) err = make_mat(&g2.a[0], hidden, f, m, e, 1, 64);
  if (err == 0) err = make_mat(&g2.b[0], w2, d, f, e, 1, 64);
  if (err == 0) err = make_mat(&g2.c[0], out, d, k, e, n, box);
  if (err != 0) return err;
  g1.nk = d / kBK, g1.tm[0] = tm, g1.tn[0] = f / 256, g1.ne = e;
  err = launch_gemm<256, false, true, kGelu>(g1, s);
  if (err != 0) return err;
  g2.nk = f / kBK, g2.tm[0] = tm, g2.ne = e;
  if (d % 256 == 0) {
    g2.tn[0] = d / 256;
    return launch_gemm<256, false, true, kStore>(g2, s);
  }
  g2.tn[0] = d / 128;
  return launch_gemm<128, false, true, kStore>(g2, s);
}

// K3: expert-major rows xg (e, m, d) -> out (e, m, d), hidden (e, m, f). Expert e's
// row r is at xg[e, r, :], the sample-major layout with n = 1 and k = m.
extern "C" int moe_ffn_em_fwd(const void* xg, const void* w1, const void* w2, void* out,
                              void* hidden, int e, int m, int d, int f, void* stream) {
  return moe_ffn_fwd(xg, w1, w2, out, hidden, 1, e, m, d, f, stream);
}
