// Device-cache codec kernel for Hopper (sm_90a), plain C interface bound
// with ctypes from waternet_tpu_torch/ops/kernels.py. It runs on the
// caller's stream, allocates nothing and does not synchronise; the
// launcher returns cudaGetLastError() so the wrapper can raise on a launch
// CUDA refused.
//
// dct8_dequant_idct_kernel
//   Replaces the TPU kernel dct8_dequant_idct (waternet_tpu/ops/
//   pallas_kernels.py:330 _dct8_kernel, pallas_call at :351, public :366):
//   out = (coef * quant) @ M for every 8x8 block-channel, with coef (NB, 16)
//   int8 zonal DCT coefficients, quant (16,) f32, M the (16, 64) f32
//   kept-coefficients -> pixels matrix; out (NB, 64) f32, level-shifted.
//   Bound: bytes. Per block-channel it reads 16 B and writes 256 B and does
//   2 * 16 * 64 flops, far below the card's ratio of flops to bytes.
//   Design: the TPU kernel walks 512-block chunks so they fit VMEM; here
//   M (4 KB) and quant sit in shared memory, and 16 threads share one
//   block-channel: each loads its 16 coefficients as one 16-byte load (the
//   group's loads of one address are served once) and computes 4 of the 64
//   outputs, written as one float4, so a warp stores two whole 256-byte
//   blocks, coalesced.
//   Rounding: the plain version (ops/kernels.py dct8_dequant_idct_plain)
//   rounds deq = coef * q once, then sums the 16 products in k order, one
//   rounded op at a time. The kernel does the same with __fmul_rn and
//   __fadd_rn, which nvcc never contracts into an FMA, so the two agree
//   bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kZone2 = 16;           // kept coefficients per block
constexpr int kQuads = 64 / 4;       // float4 outputs per block
constexpr int kDctThreads = 256;
constexpr int kBlocksPerCta = kDctThreads / kQuads;

// Coefficient k of the 16 int8 values packed little-endian in ``r``,
// sign-extended, as float.
__device__ __forceinline__ float coef_at(const int4& r, int k) {
  const int w = k < 4 ? r.x : k < 8 ? r.y : k < 12 ? r.z : r.w;
  const int shifted = (int)((unsigned)w << (24 - 8 * (k & 3)));
  return (float)(shifted >> 24);
}

__global__ void __launch_bounds__(kDctThreads)
dct8_dequant_idct_kernel(const int4* __restrict__ coef,
                         const float* __restrict__ quant,
                         const float4* __restrict__ idct_m,
                         float4* __restrict__ out, int nb) {
  __shared__ float4 s_m[kZone2][kQuads];
  __shared__ float s_q[kZone2];

  const int t = threadIdx.x;
  s_m[t / kQuads][t % kQuads] = idct_m[t];  // 256 float4: one per thread
  if (t < kZone2) s_q[t] = quant[t];
  __syncthreads();

  const int q = t % kQuads;
  const long long blk = (long long)blockIdx.x * kBlocksPerCta + t / kQuads;
  if (blk >= nb) return;
  const int4 c = coef[blk];

  float d = __fmul_rn(coef_at(c, 0), s_q[0]);
  float4 m = s_m[0][q];
  float4 acc = make_float4(__fmul_rn(d, m.x), __fmul_rn(d, m.y),
                           __fmul_rn(d, m.z), __fmul_rn(d, m.w));
#pragma unroll
  for (int k = 1; k < kZone2; ++k) {
    d = __fmul_rn(coef_at(c, k), s_q[k]);
    m = s_m[k][q];
    acc.x = __fadd_rn(acc.x, __fmul_rn(d, m.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(d, m.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(d, m.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(d, m.w));
  }
  out[blk * kQuads + q] = acc;
}

}  // namespace

extern "C" int waternet_dct8_dequant_idct(const void* coef, const void* quant,
                                          const void* idct_m, void* out, int nb,
                                          void* stream) {
  if (nb <= 0) return 0;
  const int blocks = (nb + kBlocksPerCta - 1) / kBlocksPerCta;
  dct8_dequant_idct_kernel<<<blocks, kDctThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)coef, (const float*)quant, (const float4*)idct_m,
      (float4*)out, nb);
  return (int)cudaGetLastError();
}
