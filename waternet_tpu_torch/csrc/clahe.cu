// CLAHE kernels for Hopper (sm_90a), plain C interface bound with ctypes
// from waternet_tpu_torch/ops/kernels.py. All three take the whole batch and
// run on the caller's stream; none allocates or synchronises. Each
// launcher returns cudaGetLastError() so the wrapper can raise on a launch
// CUDA refused.
//
// clahe_tile_lut_kernel
//   Replaces the TPU kernel tile_lut (waternet_tpu/ops/pallas_kernels.py:133
//   _lut_kernel, pallas_call at :180). Per (image, tile): 256-bin histogram
//   -> OpenCV's integer clip and excess redistribution -> inclusive CDF ->
//   LUT = clip(rint(cdf * scale), 0, 255), the arithmetic of
//   waternet_tpu/ops/clahe.py:275-288.
//   Bound: bytes. It reads each uint8 of the padded L plane once and writes
//   1 KB per tile. Design: one CTA per tile reads its pixels with strides
//   straight from the (N, hp, wp) plane (no transposed, padded (T, A) copy
//   as the TPU path builds), each warp counts into its own shared-memory
//   histogram to spread atomic contention on smooth tiles, and the clip,
//   scan and LUT run in the same CTA, so the histogram never leaves shared
//   memory. The TPU grid's chunk-to-chunk carry becomes the CTA's own loop.
//
// clahe_tile_histogram_kernel
//   Replaces the TPU kernel tile_histogram (pallas_kernels.py:71
//   _hist_kernel, pallas_call at :94, public :106): per (image, tile), the
//   256-bin histogram as int32. The TPU kernel sums a (2048, 256) one-hot
//   compare matrix per chunk of a transposed, -1-padded (T, A) copy; here
//   it is phase 1 of clahe_tile_lut_kernel, the same __device__ function
//   (tile_bin_count), reading the padded (N, hp, wp) plane with strides.
//   Bound: bytes (1 B read per pixel, 1 KB written per tile). No path of
//   either package calls it; luts_from_hist over its output equals
//   tile_lut, which chip_smoke.py checks.
//
// clahe_lut_planes_kernel
//   Replaces the TPU kernel clahe_lut_planes (pallas_kernels.py:229
//   _interp_kernel, pallas_call at :256). For every pixel of the padded L
//   plane, the value of its four surrounding tile LUTs (quadrants 11, 12,
//   21, 22) at that pixel's level: four (N, hp, wp) f32 planes. The
//   bilinear blend stays outside, in plain torch, as in the JAX package.
//   Bound: bytes (1 B read, 16 B written per pixel). Design: the TPU
//   gathers with a one-hot matmul; here each CTA stages its image's LUTs
//   (ty * tx * 1 KB, 64 KB for the 8x8 grid, dynamic shared memory) and
//   gathers from shared memory, writing each plane with coalesced stores.
//   Per-row and per-column tile indices come from the host (numpy float32,
//   the arithmetic of clahe.py:328-340), so no float coordinate math runs
//   here and nvcc's FMA contraction cannot move a tile boundary.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kLutThreads = kBins;  // one thread per bin in the finaliser
constexpr int kLutWarps = kLutThreads / 32;
constexpr int kPlaneThreads = 256;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Phase 1 of both tile kernels: the 256-bin histogram of tile ``tile``
// (image * ty * tx + tile_row * tx + tile_col) of the padded plane. Every
// one of the CTA's kLutThreads threads calls it and gets the count of bin
// threadIdx.x. Each warp counts into its own shared-memory histogram
// (smooth tiles put many equal values in one warp), then the per-warp
// counts are summed.
__device__ __forceinline__ int tile_bin_count(const uint8_t* __restrict__ l,
                                              int hp, int wp, int ty, int tx,
                                              int tile) {
  __shared__ int hist[kLutWarps][kBins];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int img = tile / (ty * tx);
  const int tile_row = (tile / tx) % ty;
  const int tile_col = tile % tx;
  const int th = hp / ty;
  const int tw = wp / tx;

#pragma unroll
  for (int w = 0; w < kLutWarps; ++w) hist[w][t] = 0;
  __syncthreads();

  const uint8_t* base = l + (size_t)img * hp * wp +
                        (size_t)tile_row * th * wp + (size_t)tile_col * tw;
  for (int r = warp; r < th; r += kLutWarps) {
    const uint8_t* row = base + (size_t)r * wp;
    for (int c = lane; c < tw; c += 32) atomicAdd(&hist[warp][row[c]], 1);
  }
  __syncthreads();

  int h = 0;
#pragma unroll
  for (int w = 0; w < kLutWarps; ++w) h += hist[w][t];
  return h;
}

__global__ void __launch_bounds__(kLutThreads)
clahe_tile_histogram_kernel(const uint8_t* __restrict__ l, int* __restrict__ hist,
                            int hp, int wp, int ty, int tx) {
  const int tile = blockIdx.x;
  hist[(size_t)tile * kBins + threadIdx.x] = tile_bin_count(l, hp, wp, ty, tx, tile);
}

__global__ void __launch_bounds__(kLutThreads)
clahe_tile_lut_kernel(const uint8_t* __restrict__ l, float* __restrict__ luts,
                      int hp, int wp, int ty, int tx, int clip, float scale) {
  __shared__ int warp_totals[kLutWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tile = blockIdx.x;  // image * ty * tx + tile_row * tx + tile_col
  const int h = tile_bin_count(l, hp, wp, ty, tx, tile);

  // Excess over the clip limit, summed over all bins.
  const int ws = warp_sum(max(h - clip, 0));
  if (lane == 0) warp_totals[warp] = ws;
  __syncthreads();
  int excess = 0;
#pragma unroll
  for (int w = 0; w < kLutWarps; ++w) excess += warp_totals[w];
  __syncthreads();  // warp_totals is reused by the scan below

  // excess / 256 to every bin; the residual to bins k * stride, k < residual.
  const int residual = excess % kBins;
  const int stride = max(kBins / max(residual, 1), 1);
  const int inc = (residual > 0 && t % stride == 0 && t / stride < residual);
  const int val = min(h, clip) + excess / kBins + inc;

  // Block-inclusive scan over the 256 bins.
  const int incl = warp_inclusive_scan(val, lane);
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  int cdf = incl;
  for (int w = 0; w < warp; ++w) cdf += warp_totals[w];

  // rintf rounds half to even, as jnp.round and cvRound do.
  const float v = rintf((float)cdf * scale);
  luts[(size_t)tile * kBins + t] = fminf(fmaxf(v, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kPlaneThreads)
clahe_lut_planes_kernel(const float* __restrict__ luts,
                        const uint8_t* __restrict__ l,
                        const int* __restrict__ y1, const int* __restrict__ y2,
                        const int* __restrict__ x1, const int* __restrict__ x2,
                        float* __restrict__ out, int n, int hp, int wp, int ty,
                        int tx, int rows_per_block) {
  extern __shared__ float4 s_raw[];
  float* s_lut = reinterpret_cast<float*>(s_raw);

  const int img = blockIdx.y;
  const int n_lut4 = ty * tx * kBins / 4;
  const float4* src = reinterpret_cast<const float4*>(luts) + (size_t)img * n_lut4;
  for (int i = threadIdx.x; i < n_lut4; i += blockDim.x) s_raw[i] = src[i];
  __syncthreads();

  const size_t plane = (size_t)n * hp * wp;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, hp);
  for (int r = r0; r < r1; ++r) {
    const float* lut_a = s_lut + (size_t)y1[r] * tx * kBins;
    const float* lut_b = s_lut + (size_t)y2[r] * tx * kBins;
    const size_t row = ((size_t)img * hp + r) * wp;
    for (int c = threadIdx.x; c < wp; c += blockDim.x) {
      const int v = l[row + c];
      const int c1 = x1[c] * kBins + v;
      const int c2 = x2[c] * kBins + v;
      out[row + c] = lut_a[c1];
      out[plane + row + c] = lut_a[c2];
      out[2 * plane + row + c] = lut_b[c1];
      out[3 * plane + row + c] = lut_b[c2];
    }
  }
}

}  // namespace

extern "C" int waternet_clahe_tile_lut(const void* l, void* luts, int n, int hp,
                                       int wp, int ty, int tx, int clip,
                                       float scale, void* stream) {
  const int blocks = n * ty * tx;
  clahe_tile_lut_kernel<<<blocks, kLutThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)l, (float*)luts, hp, wp, ty, tx, clip, scale);
  return (int)cudaGetLastError();
}

extern "C" int waternet_clahe_tile_histogram(const void* l, void* hist, int n,
                                             int hp, int wp, int ty, int tx,
                                             void* stream) {
  const int blocks = n * ty * tx;
  clahe_tile_histogram_kernel<<<blocks, kLutThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)l, (int*)hist, hp, wp, ty, tx);
  return (int)cudaGetLastError();
}

extern "C" int waternet_clahe_lut_planes(const void* luts, const void* l,
                                         const void* y1, const void* y2,
                                         const void* x1, const void* x2,
                                         void* out, int n, int hp, int wp,
                                         int ty, int tx, int rows_per_block,
                                         void* stream) {
  const int smem = ty * tx * kBins * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      clahe_lut_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((hp + rows_per_block - 1) / rows_per_block, n);
  clahe_lut_planes_kernel<<<grid, kPlaneThreads, smem, (cudaStream_t)stream>>>(
      (const float*)luts, (const uint8_t*)l, (const int*)y1, (const int*)y2,
      (const int*)x1, (const int*)x2, (float*)out, n, hp, wp, ty, tx,
      rows_per_block);
  return (int)cudaGetLastError();
}
