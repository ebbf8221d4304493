// Device-cache codec kernels for Hopper (sm_90a), plain C interface bound
// with ctypes from waternet_tpu_torch/ops/kernels.py. They run on the
// caller's stream, allocate nothing and do not synchronise; each launcher
// returns the launch's cudaError (0 on success) so the wrapper can raise on
// a launch CUDA refused.
//
// Both kernels replace the TPU kernel dct8_dequant_idct (waternet_tpu/ops/
// pallas_kernels.py:330 _dct8_kernel, pallas_call at :351, public :366):
// (coef * quant) @ M for every 8x8 block-channel, with coef (NB, 16) int8
// zonal DCT coefficients, quant (16,) f32 and M the (16, 64) f32
// kept-coefficients -> pixels matrix. They share the product
// (dequant_idct_quad) and differ in their epilogue:
//
// dct8_dequant_idct_kernel
//   The TPU kernel's own contract: out (NB, 64) f32, level-shifted.
//   Bound: bytes (16 B read and 256 B written per block-channel against
//   2 * 16 * 64 flops, by the data sheet's rates).
//
// dct8_decode_u8_kernel
//   The whole dct8 decode of data/codec.py: the gathered (B, nby, nbx, C,
//   16) payload -> (B, height, width, C) uint8 in image layout, cropped,
//   rintf(acc + 128) clamped to [0, 255], the arithmetic of
//   torch.clamp(torch.round(img + 128), 0, 255). On the TPU, XLA fused this
//   epilogue into the decode; in eager PyTorch it was five more passes over
//   the f32 blocks (relayout copy, +128, round, clamp, cast). Bound: 16 B
//   read and 64 B written per block-channel, so here the 2 * 16 * 64 flops
//   bound it a little more than the bytes do.
//
// Design: the TPU kernel walks 512-block chunks so they fit VMEM, and the
// MXU does the product. Here the sum must round in k order, one op at a
// time (no FMA, no tensor cores), so every output costs 16 multiplies and
// 15 adds issued one lane-instruction each, and little else may be added.
// Each CTA stages M (4 KB) and quant in shared memory once, every thread
// copies its 16 float4 of M into registers, and a grid-stride loop keeps
// the CTA alive across many block-channels, so the staging and its barrier
// are paid once per CTA, not once per 16 block-channels; at ~120
// registers a thread, two 256-thread CTAs fit an SM, and the grid is that
// many. 16 threads share one block-channel: each loads the 16
// coefficients as one 16-byte load (the group's loads of one address are
// served once; the next block-channel's load is issued before the current
// one is computed, the first one before the staging) and computes 4 of
// the 64 outputs. The 16 dequantized coefficients coef_k * q_k are
// computed once per block-channel, one per thread, and shared through
// shared memory between two 16-lane warp barriers, not 16 times over (the
// int8-to-float conversion runs at an eighth of the FP32 rate). The f32
// kernel stores its 4 outputs as one float4, so a warp writes two whole
// 256-byte blocks. The uint8 kernel takes one (image, block-row) per loop
// step: it writes the 8 x nbx*8 x C strip into shared memory (rows 16
// bytes off a multiple of 128 apart, so a block's 8 rows use different
// banks), then stores the strip's rows that lie inside the crop with
// coalesced V-byte stores (V = 16 where the row pitch width * C and the
// output's address allow it, else 8, 4, 2 or 1), so nothing is written
// twice and no f32 intermediate reaches device memory.
// Rounding: the plain version (ops/kernels.py dct8_dequant_idct_plain)
// rounds deq = coef * q once, then sums the 16 products in k order, one
// rounded op at a time. The kernels do the same with __fmul_rn and
// __fadd_rn, which nvcc never contracts into an FMA, so they agree bit for
// bit; the uint8 epilogue adds 128 with __fadd_rn and rounds with rintf
// (half to even, as torch.round).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kZone2 = 16;           // kept coefficients per block
constexpr int kQuads = 64 / 4;       // float4 outputs per block
constexpr int kDctThreads = 256;
constexpr int kDctCtasPerSm = 2;  // M in registers: ~120 registers a thread
constexpr int kBlocksPerPass = kDctThreads / kQuads;  // block-channels per CTA step

struct DctTables {
  float4 m[kZone2][kQuads];
  float q[kZone2];
};

__device__ __forceinline__ void stage_tables(DctTables& s, const float4* __restrict__ idct_m,
                                             const float* __restrict__ quant) {
  const int t = threadIdx.x;
  s.m[t / kQuads][t % kQuads] = idct_m[t];  // 256 float4: one per thread
  if (t < kZone2) s.q[t] = quant[t];
  __syncthreads();
}

// Coefficient k of the 16 int8 values packed little-endian in ``r``,
// sign-extended, as float.
__device__ __forceinline__ float coef_at(const int4& r, int k) {
  const int w = k < 4 ? r.x : k < 8 ? r.y : k < 12 ? r.z : r.w;
  const int shifted = (int)((unsigned)w << (24 - 8 * (k & 3)));
  return (float)(shifted >> 24);
}

// This thread's columns of M: m[k] = M[k][4q .. 4q+3], for every k. They
// stay in registers for the whole grid-stride loop.
__device__ __forceinline__ void load_m(float4 (&m)[kZone2], const DctTables& s, int q) {
#pragma unroll
  for (int k = 0; k < kZone2; ++k) m[k] = s.m[k][q];
}

// Outputs 4q .. 4q+3 (row q / 2, columns 4 (q % 2) .. +3 of the 8x8 block)
// of the block-channel whose coefficients are ``c``: deq_k = coef_k * q_k,
// then sum_k deq_k * M[k], in k order, every op rounded once. The 16
// threads of the group (lanes ``group`` of the warp) call it together;
// thread q dequantizes coefficient q into ``deq``, the group's 16 floats
// in shared memory, and every thread reads all 16 back.
__device__ __forceinline__ float4 dequant_idct_quad(const int4& c, const float4 (&m)[kZone2],
                                                    float quant_q, float* deq,
                                                    unsigned group, int q) {
  deq[q] = __fmul_rn(coef_at(c, q), quant_q);
  __syncwarp(group);
  float d[kZone2];
#pragma unroll
  for (int i = 0; i < kZone2 / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(deq)[i];
    d[4 * i] = v.x; d[4 * i + 1] = v.y; d[4 * i + 2] = v.z; d[4 * i + 3] = v.w;
  }
  __syncwarp(group);  // every thread has read deq: the group may rewrite it

  float4 acc = make_float4(__fmul_rn(d[0], m[0].x), __fmul_rn(d[0], m[0].y),
                           __fmul_rn(d[0], m[0].z), __fmul_rn(d[0], m[0].w));
#pragma unroll
  for (int k = 1; k < kZone2; ++k) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(d[k], m[k].x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(d[k], m[k].y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(d[k], m[k].z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(d[k], m[k].w));
  }
  return acc;
}

// The group of 16 lanes this thread belongs to, as a warp mask.
__device__ __forceinline__ unsigned group_mask() {
  return 0xffffu << (threadIdx.x & 16);
}

// clamp(rint(acc + 128), 0, 255) as a byte. The float v is a whole number
// in [0, 255], so v + 2^23 is exact and its low byte is v: the add stands
// in for a float-to-int conversion, which runs at an eighth of its rate.
__device__ __forceinline__ uint8_t to_u8(float acc) {
  const float v = fminf(fmaxf(rintf(__fadd_rn(acc, 128.0f)), 0.0f), 255.0f);
  return (uint8_t)__float_as_uint(__fadd_rn(v, 8388608.0f));
}

__global__ void __launch_bounds__(kDctThreads, kDctCtasPerSm)
dct8_dequant_idct_kernel(const int4* __restrict__ coef,
                         const float* __restrict__ quant,
                         const float4* __restrict__ idct_m,
                         float4* __restrict__ out, int nb) {
  __shared__ DctTables s;
  __shared__ float4 s_deq[kDctThreads / 4];
  const long long step = (long long)gridDim.x * kBlocksPerPass;
  long long blk = (long long)blockIdx.x * kBlocksPerPass + threadIdx.x / kQuads;
  int4 c = blk < nb ? coef[blk] : make_int4(0, 0, 0, 0);  // in flight while staging
  stage_tables(s, idct_m, quant);

  const int q = threadIdx.x % kQuads;
  float* deq = reinterpret_cast<float*>(s_deq) + (threadIdx.x / kQuads) * kZone2;
  const unsigned group = group_mask();
  float4 m[kZone2];
  load_m(m, s, q);
  const float quant_q = s.q[q];
  while (blk < nb) {
    const long long next = blk + step;
    const int4 c_next = next < nb ? coef[next] : make_int4(0, 0, 0, 0);
    out[blk * kQuads + q] = dequant_idct_quad(c, m, quant_q, deq, group, q);
    c = c_next;
    blk = next;
  }
}

template <int V> struct Store;
template <> struct Store<16> { using T = uint4; };
template <> struct Store<8> { using T = uint2; };
template <> struct Store<4> { using T = unsigned int; };
template <> struct Store<2> { using T = unsigned short; };
template <> struct Store<1> { using T = uint8_t; };

// Rows [0, rows) of the strip, ``row_bytes`` each, to ``dst`` at pitch
// ``row_bytes``, V bytes a store.
template <int V>
__device__ __forceinline__ void store_strip(uint8_t* __restrict__ dst,
                                            const uint8_t* __restrict__ strip,
                                            int pitch, int rows, int row_bytes) {
  using T = typename Store<V>::T;
  const int per_row = row_bytes / V;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = i - r * per_row;
    reinterpret_cast<T*>(dst + (size_t)r * row_bytes)[c] =
        reinterpret_cast<const T*>(strip + r * pitch)[c];
  }
}

template <int V>
__global__ void __launch_bounds__(kDctThreads, kDctCtasPerSm)
dct8_decode_u8_kernel(const int4* __restrict__ coef, const float* __restrict__ quant,
                      const float4* __restrict__ idct_m, uint8_t* __restrict__ out,
                      int units, int nby, int nbx, int ch, int height, int width,
                      int pitch) {
  __shared__ DctTables s;
  __shared__ float4 s_deq[kDctThreads / 4];
  extern __shared__ uint4 s_strip_raw[];  // 8 rows of ``pitch`` bytes
  uint8_t* strip = reinterpret_cast<uint8_t*>(s_strip_raw);
  const int row_blocks = nbx * ch;   // block-channels per block-row
  const int j0 = threadIdx.x / kQuads;
  int unit = blockIdx.x;
  int4 c = unit < units && j0 < row_blocks ? coef[(size_t)unit * row_blocks + j0]
                                           : make_int4(0, 0, 0, 0);  // in flight while staging
  stage_tables(s, idct_m, quant);

  const int q = threadIdx.x % kQuads;
  float* deq = reinterpret_cast<float*>(s_deq) + (threadIdx.x / kQuads) * kZone2;
  const unsigned group = group_mask();
  float4 m[kZone2];
  load_m(m, s, q);
  const float quant_q = s.q[q];
  const int r_in = q >> 1;           // this thread's row of the 8x8 block
  const int c_in = (q & 1) * 4;      // and its first column
  const int row_bytes = width * ch;  // bytes of one cropped image row
  for (; unit < units; unit += gridDim.x) {
    const int img = unit / nby;
    const int by = unit - img * nby;
    const int4* src = coef + (size_t)unit * row_blocks;
    for (int j = j0; j < row_blocks; j += kBlocksPerPass) {
      // Prefetch this group's next block-channel: the next of this
      // block-row, else the first of this CTA's next one.
      const int next = j + kBlocksPerPass;
      const int next_unit = unit + (int)gridDim.x;
      int4 c_next = make_int4(0, 0, 0, 0);
      if (next < row_blocks) c_next = src[next];
      else if (next_unit < units) c_next = coef[(size_t)next_unit * row_blocks + j0];
      const float4 a = dequant_idct_quad(c, m, quant_q, deq, group, q);
      const int bx = j / ch;
      uint8_t* d = strip + r_in * pitch + (bx * 8 + c_in) * ch + (j - bx * ch);
      d[0] = to_u8(a.x);
      d[ch] = to_u8(a.y);
      d[2 * ch] = to_u8(a.z);
      d[3 * ch] = to_u8(a.w);
      c = c_next;
    }
    __syncthreads();
    const int rows = min(8, height - by * 8);
    if (rows > 0)
      store_strip<V>(out + ((size_t)img * height + by * 8) * row_bytes, strip, pitch,
                     rows, row_bytes);
    __syncthreads();  // the strip is rewritten by the next step
  }
}

// Index of width ``v`` in {16, 8, 4, 2, 1}, or -1.
int width_index(int v) {
  switch (v) {
    case 16: return 0;
    case 8: return 1;
    case 4: return 2;
    case 2: return 3;
    case 1: return 4;
    default: return -1;
  }
}

}  // namespace

extern "C" int waternet_dct8_dequant_idct(const void* coef, const void* quant,
                                          const void* idct_m, void* out, int nb,
                                          int ctas, void* stream) {
  if (nb <= 0) return 0;
  if (ctas <= 0 || (uintptr_t)coef % 16 || (uintptr_t)idct_m % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  dct8_dequant_idct_kernel<<<ctas, kDctThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)coef, (const float*)quant, (const float4*)idct_m, (float4*)out, nb);
  return (int)cudaGetLastError();
}

// ``pitch``: the strip's row pitch in shared memory, a multiple of 16 no
// smaller than nbx * 8 * ch. ``vec``: the store width, which must divide
// width * ch and the output's address.
extern "C" int waternet_dct8_decode_u8(const void* coef, const void* quant,
                                       const void* idct_m, void* out, int b, int nby,
                                       int nbx, int ch, int height, int width,
                                       int pitch, int vec, int ctas, void* stream) {
  using Fn = void (*)(const int4*, const float*, const float4*, uint8_t*, int, int, int,
                      int, int, int, int);
  const Fn fns[] = {dct8_decode_u8_kernel<16>, dct8_decode_u8_kernel<8>,
                    dct8_decode_u8_kernel<4>, dct8_decode_u8_kernel<2>,
                    dct8_decode_u8_kernel<1>};
  const int i = width_index(vec);
  const int units = b * nby;
  if (units <= 0 || height <= 0 || width <= 0) return 0;
  if (i < 0 || ctas <= 0 || height > nby * 8 || width > nbx * 8 || pitch % 16 ||
      pitch < nbx * 8 * ch || (width * ch) % vec || (uintptr_t)out % vec ||
      (uintptr_t)coef % 16 || (uintptr_t)idct_m % 16)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(kDctThreads);
  cfg.dynamicSmemBytes = (size_t)8 * pitch;
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, fns[i], (const int4*)coef, (const float*)quant,
                           (const float4*)idct_m, (uint8_t*)out, units, nby, nbx, ch,
                           height, width, pitch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
