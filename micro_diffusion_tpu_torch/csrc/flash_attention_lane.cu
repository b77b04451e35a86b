// Non-causal multi-head attention forward, head_dim 16, 32 or 64, any head count,
// for Hopper (sm_90a).
//
// Replaces three Pallas TPU forward kernels:
//   micro_diffusion_tpu/ops/flash_attention_lane.py:_fwd_kernel :58 (K1: head_dim 64,
//     two heads packed side by side in 128 lanes; the packing was a TPU device
//     and is not carried over),
//   micro_diffusion_tpu/ops/flash_attention_bh.py:_fwd_kernel :22 (K4, 'flash_bh': the
//     head_dims the lane kernel does not take, MicroDiT-Tiny at D = 32 and Micro
//     at D = 16, at Tq >= 512 under 'auto'), which compute one function, and
//   micro_diffusion_tpu/ops/flash_attention.py:_fwd_kernel :76 (K5, 'flash_bthd'), the
//     same function that also saves the row logsumexp for its backward: given an
//     lse pointer, the kernel writes lse = rowmax(s) * scale + log(l) in fp32,
//     (B, H, Tq) contiguous.
// Given a stats pointer, the kernel also writes what the backward
// (flash_attention_lane_bwd.cu, K1b/K4b) reads: the row max m of the unscaled s and
// 1/l, fp32, (2, B, H, Tq) contiguous. The samplers (no gradient) pass neither.
// One kernel templated on D serves all three: ops/flash_attention_lane.py,
// ops/flash_attention_bh.py and ops/flash_attention.py call the one entry point and
// count their own launches. K5's contract normalises before the cast,
// out = bf16(e / l) @ v; the online form below casts e against the running max and
// divides at the end, so for K5 too the kernel is the contract up to one bf16
// rounding of each probability.
//
// Contract (the TPU kernel's): s = q k^T in fp32 (unscaled),
//   e = exp2((s - rowmax(s)) * scale * log2(e)), l = rowsum(e) in fp32,
//   out = (bf16(e) @ v, fp32 accumulation) / l, stored as bf16.
// The TPU kernel holds one (batch, head)'s whole K and V in VMEM. Here the row
// max and row sum are kept online across key tiles (flash-attention rescaling
// of the fp32 accumulator), so e is cast to bf16 against the running max rather
// than the final one: the same function up to one bf16 rounding of each e. The
// exponent is one FFMA, s * c - m * c with c = scale * log2(e), before ex2.approx.
//
// Layout: q (B, Tq, H, D), k/v (B, Tk, H, D), out (B, Tq, H, D), bf16, read and
// written through their (batch, seq, head) strides; the head dim is contiguous.
// The JAX wrapper's (B*H, T, D) transposes were a TPU relayout and are not
// carried over: k and v are read as strided views of the packed projections
// (TMA tensor maps over them, attention_wgmma.cuh make_map).
//
// Bound on this card: per (batch, head) 4*Tq*Tk*D FLOPs against 2*D*(2*Tq + 2*Tk)
// bytes, Tq*Tk/(Tq+Tk) FLOP/byte: 128 for 256px self-attention (T = 256) and
// 59-72 for cross-attention (Tk = 77), below the H100's ~295 FLOP/byte ridge
// (bytes, 3.35 TB/s); 512 at Tq = Tk = 1024, so 512px self-attention is bound by
// the tensor cores (989 TFLOP/s bf16). Beside them the softmax needs one ex2 per
// score on the special-function unit (16 per clock per SM): at D = 64 about as long
// as the two products take on the tensor cores, at D = 32 twice as long.
//
// Design: warp specialized, one block per 64 query rows, three blocks an SM. The
// block's producer warp loads its q tile once and streams the (batch, head)'s k and
// v tiles of 64 keys by TMA through a 4-stage ring (full and empty mbarriers),
// swizzled by D * 2 bytes, the layout wgmma reads. Its consumer warpgroup computes
// s = q k^T by wgmma with both operands in shared memory, turns e from the fp32
// accumulator into bf16 A operands in registers, and adds e v by wgmma with A from
// registers and v as an MN-major operand. The products and the softmax overlap: the
// consumer issues tile j's s = q k^T and tile j-1's o += e v together,
// exponentiates tile j while o += e v runs, and only then rescales o by the new row
// max. Three such blocks an SM keep the tensor cores and the special-function unit
// busy while one block waits on the other; blocks of two consumer warpgroups, and
// tiles of 128 keys, were slower at every path shape (PERF.md section 6). Scores,
// probabilities and the partial output stay in registers, so only q, k, v and out
// (and lse or the stats) touch device memory.
// Ragged Tk (77 caption tokens): TMA zero-fills keys past Tk, which are masked to
// -inf before the row max (a zero score can be a row's max); query rows past Tq
// arrive as zeros and are not stored.

#include <math.h>

#include "attention_wgmma.cuh"

namespace {

constexpr int kBN = 64;      // keys per tile
constexpr int kStages = 4;   // depth of the k/v ring
constexpr int kBlocks = 3;   // blocks an SM: at most 136 registers a thread, 3 x 72 KB at D = 64

// Dynamic shared memory (byte offsets): the block's q tile, the ring (stage s: k,
// then v), the barriers (full[kStages], empty[kStages], q loaded). Every tile sits
// on a 1024-byte boundary, as the swizzle needs.
template <int D>
struct FwdSmem {
  static constexpr int kTile = 64 * D * 2;  // one q, k or v tile
  static constexpr int q = 0;
  static constexpr int ring = round_up(kTile, 1024);
  static constexpr int stage = 2 * kTile;
  static constexpr int bars = ring + kStages * stage;
  static constexpr int bytes = bars + (2 * kStages + 1) * 8;
};

// Grid (ceil(Tq / 64), H, B), 160 threads: warpgroup 0 consumes (it owns the
// block's 64 query rows), warp 4 produces.
template <int D>
__global__ void __launch_bounds__(160, kBlocks)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                    int tq, int tk, Strides os_, float c, float* __restrict__ lse,
                    float* __restrict__ stats) {
  using L = FwdSmem<D>;
  constexpr int NS = kBN / 2;   // score accumulator registers
  constexpr int KC = kBN / 16;  // k16 steps of o += e v
  extern __shared__ __align__(1024) unsigned char smem[];
  auto* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y, nb = gridDim.z;
  const int tid = threadIdx.x;
  const int row0 = blk * 64;
  const int nk = (tk + kBN - 1) / kBN;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128);
    }
    mbar_init(qbar, 1);
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- the producer warp: one thread issues every load
    if (tid == 128) {
      mbar_arrive_expect_tx(qbar, L::kTile);
      tma_load4(smem + L::q, &q_map, 0, h, row0, b, qbar);
      for (int j = 0; j < nk; ++j) {
        const int st = j % kStages;
        unsigned char* base = smem + L::ring + st * L::stage;
        if (j >= kStages) mbar_wait(&empty[st], (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], 2 * L::kTile);
        tma_load4(base, &k_map, 0, h, j * kBN, b, &full[st]);
        tma_load4(base + L::kTile, &v_map, 0, h, j * kBN, b, &full[st]);
      }
    }
  } else {
    // ---- the consumer warpgroup
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const unsigned char* qw = smem + L::q;
    float acc[D / 2], s[NS];
    uint32_t a[KC][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];

    // s = q k_j^T, issued and committed (not waited for)
    auto issue_s = [&](int j) {
      const unsigned char* kt = smem + L::ring + (j % kStages) * L::stage;
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_sw_k<D>(qw, kk), desc_sw_k<D>(kt, kk), kk > 0);
      wgmma_commit();
    };
    // o += e_j v_j with e_j in a, issued and committed
    auto issue_o = [&](int j) {
      const unsigned char* vt = smem + L::ring + (j % kStages) * L::stage + L::kTile;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) wgmma_rs<D>(acc, a[kc], desc_sw_mn<D>(vt, kc));
      wgmma_commit();
    };
    // tile j's scores in s -> e in s (fp32), the running max and sum, alpha: the
    // factor that takes o and l from the old max to the new one
    auto softmax = [&](int j) {
      const int key0 = j * kBN;
      if (key0 + kBN > tk) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          if (key0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= tk) s[i] = -INFINITY;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = m_run[hf];
#pragma unroll
        for (int n8 = 0; n8 < NS / 4; ++n8)
          mx = fmaxf(mx, fmaxf(s[4 * n8 + 2 * hf], s[4 * n8 + 2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[hf] = ex2((m_run[hf] - mx) * c);
        m_run[hf] = mx;
        const float mc = mx * c;
        float sum = 0.f;
#pragma unroll
        for (int n8 = 0; n8 < NS / 4; ++n8) {
          const float p0 = ex2(fmaf(s[4 * n8 + 2 * hf], c, -mc));
          const float p1 = ex2(fmaf(s[4 * n8 + 2 * hf + 1], c, -mc));
          s[4 * n8 + 2 * hf] = p0;
          s[4 * n8 + 2 * hf + 1] = p1;
          sum += p0 + p1;
        }
        l_run[hf] = l_run[hf] * alpha[hf] + sum;
      }
    };

    mbar_wait(qbar, 0);
    fence_regs(s);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) acc_to_a(a[kc], s, kc);

    for (int j = 1; j < nk; ++j) {
      // tile j's scores and tile j-1's o += e v in flight together
      fence_regs(s);
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
      issue_s(j);
      issue_o(j - 1);
      wgmma_wait<1>();  // s has landed; o += e v may still run
      fence_regs(s);
      softmax(j);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(a);
      mbar_arrive(&empty[(j - 1) % kStages]);  // the consumer is done with tile j-1
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) acc_to_a(a[kc], s, kc);
    }
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
    issue_o(nk - 1);
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = l_run[hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = row0 + warp * 16 + g + 8 * hf;
      if (row < tq) {
        const int64_t idx = ((int64_t)b * nh + h) * tq + row;
        if (lse != nullptr && t4 == 0)  // natural log of the scaled scores' sum
          lse[idx] = (m_run[hf] * c + log2f(l)) * 0.6931471805599453f;
        if (stats != nullptr && t4 == 0) {
          stats[idx] = m_run[hf];
          stats[(int64_t)nb * nh * tq + idx] = inv;
        }
        __nv_bfloat16* orow = o + (int64_t)b * os_.sb + (int64_t)row * os_.st + (int64_t)h * os_.sh;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8)
          *reinterpret_cast<uint32_t*>(orow + 8 * n8 + 2 * t4) =
              pack_bf16(acc[4 * n8 + 2 * hf] * inv, acc[4 * n8 + 2 * hf + 1] * inv);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int tq, int tk, int h,
           Strides qs, Strides ks, Strides vs, Strides os, float c, float* lse, float* stats,
           cudaStream_t stream) {
  constexpr int bytes = FwdSmem<D>::bytes;
  static const int attr = allow_smem(attn_fwd_kernel<D>, bytes);
  if (attr != 0) return attr;
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, b, tq, h, D, qs);
  if (err == 0) err = make_map(&km, k, b, tk, h, D, ks);
  if (err == 0) err = make_map(&vm, v, b, tk, h, D, vs);
  if (err != 0) return err;
  attn_fwd_kernel<D><<<dim3((tq + 63) / 64, h, b), 160, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), tq, tk, os, c, lse, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements; lse is null or fp32 of b * h * tq floats, stats null or
// fp32 of 2 * b * h * tq floats (m, then 1/l). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head_dim the
// kernel is not instantiated for.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int b, int tq, int tk, int h, int d, int qsb, int qst,
                                   int qsh, int ksb, int kst, int ksh, int vsb, int vst, int vsh,
                                   int osb, int ost, int osh, float scale, void* lse_out,
                                   void* stats_out, void* stream) {
  // scale * log2(e), folded into the exponent's FFMA (m is taken on the unscaled s)
  if (tk < 1) return static_cast<int>(cudaErrorInvalidValue);  // no key to attend to
  const float c = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  float* stats = static_cast<float*>(stats_out);
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh}, os{osb, ost, osh};
  switch (d) {
    case 16: return launch<16>(q, k, v, o, b, tq, tk, h, qs, ks, vs, os, c, lse, stats, s);
    case 32: return launch<32>(q, k, v, o, b, tq, tk, h, qs, ks, vs, os, c, lse, stats, s);
    case 64: return launch<64>(q, k, v, o, b, tq, tk, h, qs, ks, vs, os, c, lse, stats, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
