// Fused LayerNorm + adaLN modulate, forward, for Hopper (sm_90a).
//
// Replaces: micro_diffusion_tpu/ops/adaln.py:_kernel (the Pallas TPU kernel behind
// layernorm_modulate, forward only; its VJP is the autograd of the plain
// composition, which the wrapper keeps).
//
// Contract, per row x of length D (adaln.py:22-33, _reference :57-67):
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D        fp32
//   y = (x - mean) * rsqrt(var + eps)                      fp32
//   y = y * w                                              fp32, when a weight is given
//   y = y * (1 + scale[b]) + shift[b]                      fp32
//   out = bf16(y)                                          the one rounding
// This is not the unfused LayerNorm of models/layers.py, which rounds y to bf16
// before the modulate and again after it.
// x, out: (rows, D) bf16 contiguous, rows = B*T, row r belongs to sample r / T;
// shift, scale: (B, D) bf16, row b at element offset b * stride (the adaLN chunks
// are strided views of one (B, 6D) projection); w: (D,) fp32 or null.
//
// Bound on this card: bytes. Per row it reads 2D bytes of x and writes 2D bytes of
// out; shift, scale and w are read again for every row but stay in L2 (T rows per
// sample). About 10 fp32 operations per element against 4 bytes, far below the
// ridge. At 3.35 TB/s the XL stage-1 mixer call (256, 256, 768) takes >= 60 us.
//
// Design: the TPU kernel held one sample's (T, D) slab in VMEM. Here one warp owns
// one row and holds it in registers: D <= 1024 is at most 4 16-byte vectors of 8
// bf16 per lane. Two warp-shuffle reductions give the mean and then the centred
// sum of squares, as the contract computes var (no one-pass E[x^2] - mean^2). The
// row is read once and written once; no shared memory. 8 rows per 256-thread block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // rows per block
constexpr int kVec = 8;     // bf16 per 16-byte vector
constexpr int kMaxVec = 4;  // vectors per lane: D <= 32 * 4 * 8 = 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__global__ void __launch_bounds__(kWarps * 32)
layernorm_modulate_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                          const __nv_bfloat16* __restrict__ shift,
                          const __nv_bfloat16* __restrict__ scale,
                          __nv_bfloat16* __restrict__ out, long long rows, int t, int d,
                          long long shift_stride, long long scale_stride, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = d / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);

  float v[kMaxVec][kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      unpack8(__ldg(xr + c), v[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += v[i][j];
    }
  }
  const float inv_d = 1.f / static_cast<float>(d);
  const float mean = warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[i][j] -= mean;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);

  const long long b = row / t;
  const uint4* sh = reinterpret_cast<const uint4*>(shift + b * shift_stride);
  const uint4* sc = reinterpret_cast<const uint4*>(scale + b * scale_stride);
  const float4* wv = reinterpret_cast<const float4*>(w);
  uint4* o = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = lane + 32 * i;
    if (c >= nvec) continue;
    float fs[kVec], fc[kVec], y[kVec];
    unpack8(__ldg(sh + c), fs);
    unpack8(__ldg(sc + c), fc);
#pragma unroll
    for (int j = 0; j < kVec; ++j) y[j] = v[i][j] * rstd;
    if (w != nullptr) {
      const float4 w0 = __ldg(wv + 2 * c), w1 = __ldg(wv + 2 * c + 1);
      y[0] *= w0.x; y[1] *= w0.y; y[2] *= w0.z; y[3] *= w0.w;
      y[4] *= w1.x; y[5] *= w1.y; y[6] *= w1.z; y[7] *= w1.w;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) y[j] = y[j] * (1.f + fc[j]) + fs[j];
    o[c] = pack8(y);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue for a D the
// kernel does not take (a multiple of 8 up to 1024) or a non-positive T.
extern "C" int layernorm_modulate_fwd(const void* x, const void* w, const void* shift,
                                      const void* scale, void* out, long long rows, int t,
                                      int d, long long shift_stride, long long scale_stride,
                                      float eps, void* stream) {
  if (d <= 0 || d % kVec != 0 || d > 32 * kMaxVec * kVec || t <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  layernorm_modulate_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const __nv_bfloat16*>(shift), static_cast<const __nv_bfloat16*>(scale),
      static_cast<__nv_bfloat16*>(out), rows, t, d, shift_stride, scale_stride, eps);
  return static_cast<int>(cudaGetLastError());
}
