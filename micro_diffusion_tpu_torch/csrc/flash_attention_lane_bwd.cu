// Non-causal multi-head attention backward from the forward's saved row values,
// head_dim 16, 32 or 64, any head count, for Hopper (sm_90a).
//
// Replaces the backward kernels of the three Pallas TPU attention kernels whose
// forward flash_attention_lane.cu replaces:
//   micro_diffusion_tpu/ops/flash_attention_lane.py:_bwd_kernel :80 (K1b, head_dim 64)
//   micro_diffusion_tpu/ops/flash_attention_bh.py:_bwd_kernel :48 (K4b, 'flash_bh'),
//     one function in two TPU layouts, from the row statistics (the stats form), and
//   micro_diffusion_tpu/ops/flash_attention.py:_dq_kernel :140 and _dkv_kernel :172
//     (K5b, 'flash_bthd', under `_bwd_rule` :235 with the delta it leaves to XLA),
//     from the row logsumexp (the lse form).
//
// Contract of the stats form (the TPU kernels'), per (batch, head), with m the row
// max of the unscaled s = q k^T and inv_l = 1 / rowsum(e) saved by the forward
// (flash_attention_lane.cu's `stats` output):
//   e    = exp2((s - m) * scale * log2(e))      (fp32; the forward's e exactly)
//   dv   = bf16(e)^T @ bf16(do * inv_l)
//   dp   = do @ v^T (fp32)
//   ds_u = bf16(e * (dp - delta))
//   dq   = (ds_u @ k) * (scale * inv_l)
//   dk   = ds_u^T @ bf16(q * scale * inv_l)
// with one departure: delta = rowsum(fp32(do) * fp32(out)) from the forward's bf16
// out, where the TPU kernel sums rowsum(e * dp) * inv_l. The two are equal up to
// out's bf16 roundings (K5b's contract takes its delta so).
// Contract of the lse form (K5b's), from the row logsumexp lse of the scaled scores:
//   p = exp(s * scale - lse),  ds = bf16(p * (dp - delta) * scale)
//   dq = ds @ k,  dk = ds^T @ q,  dv = bf16(p)^T @ do
// Both are one computation with per-row values (LSE is a template parameter):
//   form   exponent offset mc   q_s                      do_s              ds factor  dq factor
//   stats  m scale log2(e)      bf16(q * scale * inv_l)  bf16(do * inv_l)  1          scale inv_l
//   lse    lse log2(e)          q                        do                scale      1
// with e = exp2(s * scale * log2(e) - mc), ds = bf16(e (dp - delta) * ds factor),
// dv = bf16(e)^T do_s, dk = ds^T q_s, dq = (ds k) * dq factor. All products are bf16
// x bf16 with fp32 accumulation; dq, dk, dv are stored as bf16.
//
// Layout: q, do, out (B, Tq, H, D) and k, v (B, Tk, H, D) bf16, read through their
// (batch, seq, head) strides, head dim contiguous; dq, dk, dv written through
// theirs. stats (2, B, H, Tq) fp32: m, inv_l; or lse (B, H, Tq) fp32.
//
// Design: two kernels, one sweep each, deterministic (no atomics: every output
// element is written by one thread after a fixed-order sum). Products are wgmma
// on 64-row warpgroup tiles; 7 products of 2 Tq Tk D (s and dp in both kernels)
// for the contract's 5; one exp2 per score in each kernel, the scale folded into
// one FFMA before ex2.approx. Tiles of q, do, k and v come by TMA (4-D tensor maps
// over (D, H, T, B), built on the host per call from the strides, rows past T
// zero-filled) into 3-stage rings in dynamic shared memory, swizzled by D * 2 bytes,
// the layout wgmma reads them in; mbarriers count the bytes in.
//   attn_bwd_dq_kernel, one block per 64 NW query rows (NW warpgroups, 2 blocks an
//     SM): a prologue computes delta for its rows from do and out, and writes
//     each row's part of its packed query tile for the second kernel (mc and
//     delta, and in the stats form the scaled copies q_s and do_s; once per row,
//     not once per key block); then one sweep over the key tiles, which thread 0
//     streams by TMA two stages ahead: s and dp (q and do resident), e and ds in
//     registers, dq += ds @ k with ds the A operand straight from the registers.
//   attn_bwd_dkdv_kernel, one block per 64 NW keys (128 at every Tk over 64), warp
//     specialized: a producer warp loads k and v, then fills each stage (the q and
//     do tiles by TMA, the packed tile by one bulk copy: all of it in the stats
//     form, only mc and delta in the lse form, whose q_s and do_s are the stage's q
//     and do tiles) once the consumers have marked it empty; the NW consumer
//     warpgroups (k and v resident, dk and dv in registers) compute s^T and dp^T,
//     then dv += bf16(e)^T @ do_s and dk += ds^T @ q_s with e^T and ds^T as register
//     A operands. Neither role waits on a block-wide barrier inside the sweep.
// The packed scaled tiles sit in wgmma's unswizzled core-matrix layout
// (attention_wgmma.cuh).
//
// Bound on this card: per (batch, head) the function's 5 products of 2 Tq Tk D
// FLOPs against 2 D (3 Tq + 4 Tk) bytes (K5b also reads out and lse: 2 D (4 Tq +
// 4 Tk) + 4 Tq): bytes at T = 256 (~156-183 FLOP/byte under the ~295 ridge) and for
// the Tk = 77 cross-attention, tensor cores at T = 1024 (625-731 FLOP/byte). At
// D <= 32 the two exp2 per score (the special-function unit, 16 per clock per SM)
// cost about as much as the 7 products on the tensor cores.
// Neither bound is reached: each consumer warpgroup runs its tile as one dependent
// chain (products, wait, exponentials, products, wait), so the tensor cores idle
// while it exponentiates (PERF.md section 7).
//
// Ragged lengths: rows past Tq or Tk arrive as zeros (TMA's fill; the packed rows
// are written as zeros). Keys past Tk get e = 0 in the dq kernel (a zero-filled
// key would give exp2(-mc), which overflows for a row whose max is far below 0);
// in the dk/dv kernel they only reach their own dk, dv rows, which are not stored.
// Query rows past Tq carry zero per-row values and zero q and do rows, so they add
// nothing to dk, dv.

#include <math.h>

#include "attention_wgmma.cuh"

namespace {

constexpr int kTile = 64;   // rows of the streamed sequence per stage
constexpr int kStages = 3;  // depth of the rings

// Dynamic shared memory of the dq kernel (byte offsets): resident q and do tiles of
// 64 NW rows and the ring of k and v tiles, all swizzled as TMA writes them; the
// per-row values; the barriers (full[kStages], then q/do loaded).
template <int D, int NW>
struct DqSmem {
  static constexpr int kRows = 64 * NW;
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int q = 0;
  static constexpr int dout = kRows * D * 2;
  static constexpr int ring = 2 * kRows * D * 2;  // stage s: k, then v
  static constexpr int rowf = ring + kStages * 2 * kTileBytes;
  static constexpr int bars = rowf + 3 * kRows * 4;  // after m c, delta, scale * inv_l
  static constexpr int bytes = bars + (kStages + 1) * 8;
};

// One 64-row query tile as the dq kernel packs it for the dk/dv kernel, in device
// memory and in a ring stage alike (byte offsets): q_s = bf16(q * scale * inv_l) and
// do_s = bf16(do * inv_l) as core-matrix tiles, then m * scale * log2(e) and delta
// per row. Rows past Tq are zero.
template <int D>
struct Packed {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int qs = 0, dos = kTileBytes;
  static constexpr int mc = 2 * kTileBytes, delta = mc + kTile * 4;
  static constexpr int bytes = delta + kTile * 4;  // 256 D + 512
  static_assert(bytes % 16 == 0, "bulk copies move multiples of 16 bytes");
};

// Dynamic shared memory of the dk/dv kernel: resident k and v tiles of 64 NW rows
// (swizzled), the ring of stages (the q and do tiles, swizzled, then a packed
// tile), the barriers (full[], empty[], then k/v loaded).
template <int D, int NW>
struct DkvSmem {
  static constexpr int kRows = 64 * NW;
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int k = 0;
  static constexpr int v = kRows * D * 2;
  static constexpr int ring = 2 * kRows * D * 2;
  static constexpr int q = 0, dout = kTileBytes, packed = 2 * kTileBytes;  // in a stage
  static constexpr int stage = round_up(packed + Packed<D>::bytes, 1024);
  static constexpr int bars = ring + kStages * stage;
  static constexpr int bytes = bars + (2 * kStages + 1) * 8;
};

// dq pass. Grid (ceil(Tq / (64 NW)), H, B), 128 NW threads, two blocks an SM;
// warpgroup wg owns query rows 64 wg..64 wg + 63 of the block. Thread 0 issues the
// TMA loads: q and do once, the k and v tiles kStages - 1 ahead.
template <int D, int NW, bool LSE>
__global__ void __launch_bounds__(128 * NW, 2)
    attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ out,
                       const __nv_bfloat16* __restrict__ dout, const float* __restrict__ rowv,
                       __nv_bfloat16* __restrict__ dq, unsigned char* __restrict__ packed,
                       int tq, int tk, Strides qs_, Strides os_, Strides dos_, Strides dqs_,
                       float c, float scale) {
  using L = DqSmem<D, NW>;
  using P = Packed<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* qt = smem + L::q;
  unsigned char* dot = smem + L::dout;
  auto* rowf = reinterpret_cast<float*>(smem + L::rowf);
  auto* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* qbar = full + kStages;

  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y, nb = gridDim.z;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blk * L::kRows;
  const int64_t bh = (int64_t)b * nh + h;
  const int nk = (tk + kTile - 1) / kTile;

  auto load_kv = [&](int j) {  // thread 0: k and v tile j into its stage
    unsigned char* st = smem + L::ring + (j % kStages) * 2 * L::kTileBytes;
    mbar_arrive_expect_tx(&full[j % kStages], 2 * L::kTileBytes);
    tma_load4(st, &k_map, 0, h, j * kTile, b, &full[j % kStages]);
    tma_load4(st + L::kTileBytes, &v_map, 0, h, j * kTile, b, &full[j % kStages]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(qbar, 1);
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(qbar, 2 * L::kRows * D * 2);
    for (int w = 0; w < NW; ++w) {
      tma_load4(qt + w * L::kTileBytes, &q_map, 0, h, row0 + w * kTile, b, qbar);
      tma_load4(dot + w * L::kTileBytes, &do_map, 0, h, row0 + w * kTile, b, qbar);
    }
    for (int j = 0; j < kStages - 1 && j < nk; ++j) load_kv(j);
  }

  // Prologue, two threads per row, half the head dim each: delta = rowsum(do * out);
  // the row's part of its packed query tile for the dk/dv kernel (q_s and do_s in
  // the stats form, mc and delta; zeros past Tq up to the tile's end); the per-row
  // values this kernel keeps (mc, delta and dq's factor).
  {
    constexpr int HALF = D / 2;
    const int r = tid >> 1, half = tid & 1, row = row0 + r;
    const int nq = (tq + kTile - 1) / kTile;
    float mc_r = 0.f, il = 0.f, dq_f = 0.f, dsum = 0.f;
    uint4 qs4[HALF / 8], ds4[HALF / 8];
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) qs4[i] = ds4[i] = make_uint4(0, 0, 0, 0);
    if (row < tq) {
      if constexpr (LSE) {
        mc_r = rowv[bh * tq + row] * kLog2e;
        dq_f = 1.f;
      } else {
        const float m = rowv[bh * tq + row];
        il = rowv[(int64_t)nb * nh * tq + bh * tq + row];
        mc_r = m * c;
        dq_f = scale * il;
      }
      const float cq = scale * il;
      const __nv_bfloat16* qr = q + (int64_t)b * qs_.sb + (int64_t)row * qs_.st +
                                (int64_t)h * qs_.sh + half * HALF;
      const __nv_bfloat16* dr = dout + (int64_t)b * dos_.sb + (int64_t)row * dos_.st +
                                (int64_t)h * dos_.sh + half * HALF;
      const __nv_bfloat16* orow = out + (int64_t)b * os_.sb + (int64_t)row * os_.st +
                                  (int64_t)h * os_.sh + half * HALF;
#pragma unroll
      for (int i = 0; i < HALF / 8; ++i) {
        const uint4 q4 = *reinterpret_cast<const uint4*>(qr + 8 * i);
        const uint4 d4 = *reinterpret_cast<const uint4*>(dr + 8 * i);
        const uint4 o4 = *reinterpret_cast<const uint4*>(orow + 8 * i);
        const auto* qe = reinterpret_cast<const __nv_bfloat162*>(&q4);
        const auto* de = reinterpret_cast<const __nv_bfloat162*>(&d4);
        const auto* oe = reinterpret_cast<const __nv_bfloat162*>(&o4);
        auto* qo = reinterpret_cast<__nv_bfloat162*>(&qs4[i]);
        auto* dso = reinterpret_cast<__nv_bfloat162*>(&ds4[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 qf = __bfloat1622float2(qe[e]), df = __bfloat1622float2(de[e]);
          const float2 of = __bfloat1622float2(oe[e]);
          dsum += df.x * of.x;
          dsum += df.y * of.y;
          qo[e] = __floats2bfloat162_rn(qf.x * cq, qf.y * cq);
          dso[e] = __floats2bfloat162_rn(df.x * il, df.y * il);
        }
      }
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if (row < nq * kTile) {
      unsigned char* tile = packed + (bh * nq + row / kTile) * P::bytes;
      const int rt = row % kTile;
      if constexpr (!LSE) {
#pragma unroll
        for (int i = 0; i < HALF / 8; ++i) {
          const int off = cm_offset<D>(rt / 8, half * (HALF / 8) + i) + 16 * (rt % 8);
          *reinterpret_cast<uint4*>(tile + P::qs + off) = qs4[i];
          *reinterpret_cast<uint4*>(tile + P::dos + off) = ds4[i];
        }
      }
      if (half == 0) {
        reinterpret_cast<float*>(tile + P::mc)[rt] = mc_r;
        reinterpret_cast<float*>(tile + P::delta)[rt] = dsum;
      }
    }
    if (half == 0) {
      rowf[r] = mc_r;
      rowf[L::kRows + r] = dsum;
      rowf[2 * L::kRows + r] = dq_f;
    }
  }
  __syncthreads();

  const float ds_f = LSE ? scale : 1.f;  // factor on ds before its bf16 rounding
  float mc[2], dl[2], cb[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = wg * 64 + warp * 16 + g + 8 * hf;
    mc[hf] = rowf[r];
    dl[hf] = rowf[L::kRows + r];
    cb[hf] = rowf[2 * L::kRows + r];
  }
  const unsigned char* qw = qt + wg * L::kTileBytes;  // this warpgroup's 64 rows
  const unsigned char* dow = dot + wg * L::kTileBytes;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t a[4][4];
  mbar_wait(qbar, 0);

  for (int j = 0; j < nk; ++j) {
    __syncthreads();  // everyone is done with tile j - 1, whose stage is refilled next
    if (tid == 0 && j + kStages - 1 < nk) load_kv(j + kStages - 1);
    mbar_wait(&full[j % kStages], (j / kStages) & 1);
    const unsigned char* kt = smem + L::ring + (j % kStages) * 2 * L::kTileBytes;
    const unsigned char* vt = kt + L::kTileBytes;

    // s = q k^T, dp = do v^T for this warpgroup's 64 rows x 64 keys
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_sw_k<D>(qw, kk), desc_sw_k<D>(kt, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_sw_k<D>(dow, kk), desc_sw_k<D>(vt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // s has landed; dp may still be in flight
    fence_regs(s);

    // e = 2^(s c - m c) while dp finishes; keys past Tk get e = 0
    const int key0 = j * kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      float p = ex2(fmaf(s[i], c, -mc[hf]));
      if (key0 + kTile > tk && key0 + 8 * (i >> 2) + 2 * t4 + (i & 1) >= tk) p = 0.f;
      s[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // ds = e (dp - delta) ds_f
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * ds_f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a(a[kc], s, kc);

    // dq += ds @ k
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<D>(acc, a[kc], desc_sw_mn<D>(kt, kc));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + wg * 64 + warp * 16 + g + 8 * hf;
    if (row < tq) {
      __nv_bfloat16* o = dq + (int64_t)b * dqs_.sb + (int64_t)row * dqs_.st + (int64_t)h * dqs_.sh;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(o + 8 * i + 2 * t4) =
            pack_bf16(acc[4 * i + 2 * hf] * cb[hf], acc[4 * i + 2 * hf + 1] * cb[hf]);
    }
  }
}

// dk/dv pass. Grid (ceil(Tk / (64 NW)), H, B), 128 (NW + 1) threads: warpgroups
// 0..NW-1 consume (warpgroup wg owns key rows 64 wg..64 wg + 63 of the block; the
// accumulators hold s^T, rows keys, columns queries); the last warpgroup produces
// and hands its registers to the consumers (setmaxnreg): one thread loads k and v
// (TMA), then each stage of the ring (the q and do tiles by TMA, the packed tile by
// one bulk copy) once the consumers have marked it empty.
// Neither role waits on a block-wide barrier inside the sweep.
template <int D, int NW, bool LSE>
__global__ void __launch_bounds__(128 * (NW + 1), 1)
    attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const unsigned char* __restrict__ packed,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int tq,
                         int tk, Strides dks_, Strides dvs_, float c, float scale) {
  using L = DkvSmem<D, NW>;
  using P = Packed<D>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* kt = smem + L::k;
  unsigned char* vt = smem + L::v;
  auto* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_ready = empty + kStages;

  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int key0 = blk * L::kRows;
  const int nq = (tq + kTile - 1) / kTile;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128 * NW);
    }
    mbar_init(kv_ready, 1);
  }
  __syncthreads();

  if (wg == NW) {
    // ---- the producer warpgroup: its registers go to the consumers; one thread works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 128 * NW) {
      mbar_arrive_expect_tx(kv_ready, 2 * L::kRows * D * 2);
      for (int w = 0; w < NW; ++w) {
        tma_load4(kt + w * L::kTileBytes, &k_map, 0, h, key0 + w * kTile, b, kv_ready);
        tma_load4(vt + w * L::kTileBytes, &v_map, 0, h, key0 + w * kTile, b, kv_ready);
      }
      // the stats form brings the whole packed tile, the lse form its per-row values
      constexpr int from = LSE ? P::mc : 0;
      const unsigned char* src = packed + ((int64_t)b * nh + h) * nq * P::bytes + from;
      for (int i = 0; i < nq; ++i) {
        const int st = i % kStages;
        unsigned char* base = smem + L::ring + st * L::stage;
        if (i >= kStages) mbar_wait(&empty[st], (i / kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], 2 * L::kTileBytes + P::bytes - from);
        tma_load4(base + L::q, &q_map, 0, h, i * kTile, b, &full[st]);
        tma_load4(base + L::dout, &do_map, 0, h, i * kTile, b, &full[st]);
        bulk_copy_g2s(base + L::packed + from, src + (int64_t)i * P::bytes, P::bytes - from,
                      &full[st]);
      }
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NW == 2 ? 232 : 240) : "memory");
    const int g = lane >> 2, t4 = lane & 3;
    const float ds_f = LSE ? scale : 1.f;
    const unsigned char* kw = kt + wg * L::kTileBytes;  // this warpgroup's 64 keys
    const unsigned char* vw = vt + wg * L::kTileBytes;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float s[32], dp[32];
    uint32_t ae[4][4], ads[4][4];
    mbar_wait(kv_ready, 0);

    for (int i = 0; i < nq; ++i) {
      mbar_wait(&full[i % kStages], (i / kStages) & 1);
      const unsigned char* base = smem + L::ring + (i % kStages) * L::stage;
      const unsigned char* pk = base + L::packed;
      const float* mcs = reinterpret_cast<const float*>(pk + P::mc);
      const float* dls = reinterpret_cast<const float*>(pk + P::delta);

      // s^T = k q^T, dp^T = v do^T for this warpgroup's 64 keys x 64 queries
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_sw_k<D>(kw, kk), desc_sw_k<D>(base + L::q, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_sw_k<D>(vw, kk), desc_sw_k<D>(base + L::dout, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // s^T has landed; dp^T may still be in flight
      fence_regs(s);

      // e^T (the columns are queries: their m c and delta from the stage)
      float2 m2[8], d2[8];
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        m2[n8] = *reinterpret_cast<const float2*>(mcs + 8 * n8 + 2 * t4);
        d2[n8] = *reinterpret_cast<const float2*>(dls + 8 * n8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * n8 + e] = ex2(fmaf(s[4 * n8 + e], c, -((e & 1) ? m2[n8].y : m2[n8].x)));
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) acc_to_a(ae[kc], s, kc);

      // dv += bf16(e)^T @ do_s, while ds^T = e^T (dp^T - delta) ds_f is formed; in the
      // lse form do_s and q_s are the stage's do and q tiles themselves
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<D>(dv_acc, ae[kc], LSE ? desc_sw_mn<D>(base + L::dout, kc)
                                             : desc_mn<D>(pk + P::dos, kc));
      wgmma_commit();
      wgmma_wait<1>();  // dp^T has landed
      fence_regs(dp);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * n8 + e] =
              s[4 * n8 + e] * (dp[4 * n8 + e] - ((e & 1) ? d2[n8].y : d2[n8].x)) * ds_f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) acc_to_a(ads[kc], dp, kc);

      // dk += ds^T @ q_s
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<D>(dk_acc, ads[kc], LSE ? desc_sw_mn<D>(base + L::q, kc)
                                              : desc_mn<D>(pk + P::qs, kc));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(ae);
      fence_regs(ads);
      mbar_arrive(&empty[i % kStages]);  // this warpgroup is done with the stage
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key0 + wg * 64 + warp * 16 + g + 8 * hf;
      if (key < tk) {
        __nv_bfloat16* ok_ = dk + (int64_t)b * dks_.sb + (int64_t)key * dks_.st + (int64_t)h * dks_.sh;
        __nv_bfloat16* ov = dv + (int64_t)b * dvs_.sb + (int64_t)key * dvs_.st + (int64_t)h * dvs_.sh;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8) {
          *reinterpret_cast<uint32_t*>(ok_ + 8 * n8 + 2 * t4) =
              pack_bf16(dk_acc[4 * n8 + 2 * hf], dk_acc[4 * n8 + 2 * hf + 1]);
          *reinterpret_cast<uint32_t*>(ov + 8 * n8 + 2 * t4) =
              pack_bf16(dv_acc[4 * n8 + 2 * hf], dv_acc[4 * n8 + 2 * hf + 1]);
        }
      }
    }
  }
}

template <int D, int NWQ, int NWK, bool LSE>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* rowv,
           __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, unsigned char* packed,
           int b, int tq, int tk, int h, const Strides* st, float c, float scale,
           cudaStream_t s) {
  constexpr int dq_bytes = DqSmem<D, NWQ>::bytes, kv_bytes = DkvSmem<D, NWK>::bytes;
  static const int attr = allow_smem(attn_bwd_dq_kernel<D, NWQ, LSE>, dq_bytes) |
                          allow_smem(attn_bwd_dkdv_kernel<D, NWK, LSE>, kv_bytes);
  if (attr != 0) return attr;
  CUtensorMap qm, dom, km, vm;
  int err = make_map(&qm, q, b, tq, h, D, st[0]);
  if (err == 0) err = make_map(&dom, dout, b, tq, h, D, st[4]);
  if (err == 0) err = make_map(&km, k, b, tk, h, D, st[1]);
  if (err == 0) err = make_map(&vm, v, b, tk, h, D, st[2]);
  if (err != 0) return err;
  attn_bwd_dq_kernel<D, NWQ, LSE><<<dim3((tq + 64 * NWQ - 1) / (64 * NWQ), h, b), 128 * NWQ,
                               dq_bytes, s>>>(qm, dom, km, vm, q, out, dout, rowv, dq, packed,
                                              tq, tk, st[0], st[3], st[4], st[5], c, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  attn_bwd_dkdv_kernel<D, NWK, LSE><<<dim3((tk + 64 * NWK - 1) / (64 * NWK), h, b),
                                 128 * (NWK + 1), kv_bytes, s>>>(qm, dom, km, vm, packed, dk, dv,
                                                                tq, tk, st[6], st[7], c, scale);
  return static_cast<int>(cudaGetLastError());
}

// One warpgroup per block where the resident sequence fits one 64-row tile, two
// otherwise.
template <int D, bool LSE>
int launch_d(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
             const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* rowv,
             __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, unsigned char* packed,
             int b, int tq, int tk, int h, const Strides* st, float c, float scale,
             cudaStream_t s) {
  if (tq <= 64 && tk <= 64)
    return launch<D, 1, 1, LSE>(q, k, v, out, dout, rowv, dq, dk, dv, packed, b, tq, tk, h, st, c, scale, s);
  if (tq <= 64)
    return launch<D, 1, 2, LSE>(q, k, v, out, dout, rowv, dq, dk, dv, packed, b, tq, tk, h, st, c, scale, s);
  if (tk <= 64)
    return launch<D, 2, 1, LSE>(q, k, v, out, dout, rowv, dq, dk, dv, packed, b, tq, tk, h, st, c, scale, s);
  return launch<D, 2, 2, LSE>(q, k, v, out, dout, rowv, dq, dk, dv, packed, b, tq, tk, h, st, c, scale, s);
}

}  // namespace

// Strides: 24 ints, the (batch, seq, head) element strides of q, k, v, out, do, dq,
// dk, dv. stats: the forward's (2, b, h, tq) fp32 (m, inv_l). packed: scratch of
// b * h * ceil(tq / 64) * (256 d + 512) bytes, 16-byte aligned (the dq kernel's
// packed query tiles for the dk/dv kernel). Launches both kernels on `stream`;
// returns cudaGetLastError() after them, or cudaErrorInvalidValue for a head_dim
// the kernels are not instantiated for.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const void* rowv,
                                   void* dq, void* dk, void* dv, void* packed, int b,
                                   int tq, int tk, int h, int d, const int* strides, float scale,
                                   int lse_form, void* stream) {
  const float c = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* sp = static_cast<const float*>(rowv);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* pp = static_cast<unsigned char*>(packed);
  switch (d) {
    case 16:
      return lse_form ? launch_d<16, true>(qp, kp, vp, op, dop, sp, dqp, dkp, dvp, pp, b, tq, tk, h, st, c, scale, s)
                      : launch_d<16, false>(qp, kp, vp, op, dop, sp, dqp, dkp, dvp, pp, b, tq, tk, h, st, c, scale, s);
    case 32:
      return lse_form ? launch_d<32, true>(qp, kp, vp, op, dop, sp, dqp, dkp, dvp, pp, b, tq, tk, h, st, c, scale, s)
                      : launch_d<32, false>(qp, kp, vp, op, dop, sp, dqp, dkp, dvp, pp, b, tq, tk, h, st, c, scale, s);
    case 64:
      return lse_form ? launch_d<64, true>(qp, kp, vp, op, dop, sp, dqp, dkp, dvp, pp, b, tq, tk, h, st, c, scale, s)
                      : launch_d<64, false>(qp, kp, vp, op, dop, sp, dqp, dkp, dvp, pp, b, tq, tk, h, st, c, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
