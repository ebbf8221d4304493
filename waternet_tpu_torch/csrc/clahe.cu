// CLAHE kernels for Hopper (sm_90a), plain C interface bound with ctypes
// from waternet_tpu_torch/ops/kernels.py. All three take the whole batch and
// run on the caller's stream; none allocates or synchronises. Each
// launcher returns the launch's cudaError (0 on success) so the wrapper can
// raise on a launch CUDA refused.
//
// clahe_tile_lut_kernel<V>
//   Replaces the TPU kernel tile_lut (waternet_tpu/ops/pallas_kernels.py:133
//   _lut_kernel, pallas_call at :180). Per (image, tile): 256-bin histogram
//   -> OpenCV's integer clip and excess redistribution -> inclusive CDF ->
//   LUT = clip(rint(cdf * scale), 0, 255), the arithmetic of
//   waternet_tpu/ops/clahe.py:275-288.
//   Bound: bytes. It reads each uint8 of the padded L plane once and writes
//   1 KB per tile; the histogram never leaves the SMs.
//   Design: a batch with fewer tiles than the card has SMs (one 723x1001
//   image: 64 tiles) would leave most SMs idle with one CTA per tile, so
//   there a thread block cluster of K CTAs (K in {2, 4, 8}, launched with
//   cudaLaunchKernelEx and cudaLaunchAttributeClusterDimension) shares
//   each tile; a batch that already fills the card (4 x 1080p: 256 tiles;
//   the training planes) runs one CTA per tile (K = 1), launched without
//   the cluster attribute, since every split adds a cluster barrier and a
//   wait for the slowest peer. Each CTA reads its share of the tile's
//   flattened (row, vector-column) pairs with V-byte loads (V in {16, 8, 4,
//   2, 1}, the widest that divides the tile width, the row pitch and the
//   plane's address; so a 240-byte tile row is 15 lanes of 16 bytes, not
//   240 lanes of 1), four loads in flight per lane, and counts each byte
//   into its warp's shared-memory histogram (smooth tiles put many equal
//   values in one warp). The CTA folds its warps' histograms into one;
//   with K > 1, after cluster.sync() rank 0 sums the K histograms through
//   distributed shared memory (map_shared_rank), and a second
//   cluster.sync() keeps the peers' shared memory alive until it has.
//   Rank 0 alone runs the clip, redistribution, scan and LUT. What is left
//   between this kernel and its bound is the launch and the per-CTA chain
//   (clear, load, count, fold, finalise), not the atomics.
//   Integer counts do not depend on the order of the sums, so the LUTs are
//   the same bits at every K and V. The wrapper (ops/kernels.py tile_plan)
//   picks K and V.
//
// clahe_tile_histogram_kernel<V>
//   Replaces the TPU kernel tile_histogram (pallas_kernels.py:71
//   _hist_kernel, pallas_call at :94, public :106): per (image, tile), the
//   256-bin histogram as int32. The TPU kernel sums a (2048, 256) one-hot
//   compare matrix per chunk of a transposed, -1-padded (T, A) copy; here
//   it is phase 1 of clahe_tile_lut_kernel, the same __device__ function
//   (tile_bin_count) under the same cluster launch, reading the padded
//   (N, hp, wp) plane in place; rank 0 writes the summed histogram.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kLutThreads = kBins;  // one thread per bin in the finaliser
constexpr int kLutWarps = kLutThreads / 32;
constexpr int kLoadsInFlight = 4;   // vector loads issued per lane before counting
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

// V bytes of the plane as one load: the vector type, and its bytes counted.
template <int V> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned int; };
template <> struct Vec<2> { using T = unsigned short; };
template <> struct Vec<1> { using T = unsigned char; };

__device__ __forceinline__ void count_word(int* h, unsigned w, int nbytes) {
#pragma unroll
  for (int i = 0; i < nbytes; ++i) atomicAdd(&h[(w >> (8 * i)) & 0xffu], 1);
}

template <int V>
__device__ __forceinline__ void count_vec(int* h, const typename Vec<V>::T& v) {
  if constexpr (V == 16) {
    count_word(h, v.x, 4); count_word(h, v.y, 4);
    count_word(h, v.z, 4); count_word(h, v.w, 4);
  } else if constexpr (V == 8) {
    count_word(h, v.x, 4); count_word(h, v.y, 4);
  } else {
    count_word(h, (unsigned)v, V);
  }
}

// The tile this CTA works on: clusters are K consecutive CTAs along x.
__device__ __forceinline__ int cluster_tile() {
  return blockIdx.x / cg::this_cluster().num_blocks();
}

// Phase 1 of both tile kernels: the 256-bin histogram of this cluster's
// tile (image * ty * tx + tile_row * tx + tile_col) of the padded plane.
// Every thread of every CTA of the cluster calls it; on rank 0, thread t
// gets the tile's count of bin t (other ranks get their own share).
template <int V>
__device__ __forceinline__ int tile_bin_count(const uint8_t* __restrict__ l,
                                              int hp, int wp, int ty, int tx) {
  using T = typename Vec<V>::T;
  __shared__ int hist[kLutWarps][kBins];

  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int tile = cluster_tile();
  const int img = tile / (ty * tx);
  const int tile_row = (tile / tx) % ty;
  const int tile_col = tile % tx;
  const int th = hp / ty;
  const int tw = wp / tx;

  // This CTA's share of the tile's flattened (row, vector-column) pairs.
  const int per_row = tw / V;
  const int total = th * per_row;
  const int share = (total + k - 1) / k;
  const int begin = rank * share;
  const int end = min(begin + share, total);
  const uint8_t* base = l + (size_t)img * hp * wp +
                        (size_t)tile_row * th * wp + (size_t)tile_col * tw;
#pragma unroll
  for (int w = 0; w < kLutWarps; ++w) hist[w][t] = 0;
  __syncthreads();

  int* h = hist[warp];
  for (int i0 = begin + t; i0 < end; i0 += kLoadsInFlight * kLutThreads) {
    T v[kLoadsInFlight];
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      const int i = i0 + u * kLutThreads;
      if (i < end) {
        const int r = i / per_row;
        const int c = i - r * per_row;
        v[u] = __ldg(reinterpret_cast<const T*>(base + (size_t)r * wp) + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadsInFlight; ++u) {
      if (i0 + u * kLutThreads < end) count_vec<V>(h, v[u]);
    }
  }
  __syncthreads();

  // Fold the warps' histograms into hist[0]: thread t owns column t.
  int count = 0;
#pragma unroll
  for (int w = 0; w < kLutWarps; ++w) count += hist[w][t];
  if (k == 1) return count;  // a cluster of one: the CTA's count is the tile's
  hist[0][t] = count;
  cluster.sync();  // every CTA's hist[0] is written and visible to the cluster
  if (rank == 0) {
    for (int r = 1; r < k; ++r) count += cluster.map_shared_rank(&hist[0][0], r)[t];
  }
  cluster.sync();  // rank 0 has read its peers: their shared memory may go
  return count;
}

template <int V>
__global__ void __launch_bounds__(kLutThreads)
clahe_tile_histogram_kernel(const uint8_t* __restrict__ l, int* __restrict__ hist,
                            int hp, int wp, int ty, int tx) {
  const int h = tile_bin_count<V>(l, hp, wp, ty, tx);
  if (cg::this_cluster().block_rank() != 0) return;
  hist[(size_t)cluster_tile() * kBins + threadIdx.x] = h;
}

template <int V>
__global__ void __launch_bounds__(kLutThreads)
clahe_tile_lut_kernel(const uint8_t* __restrict__ l, float* __restrict__ luts,
                      int hp, int wp, int ty, int tx, int clip, float scale) {
  __shared__ int warp_totals[kLutWarps];

  const int h = tile_bin_count<V>(l, hp, wp, ty, tx);
  if (cg::this_cluster().block_rank() != 0) return;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tile = cluster_tile();

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

// One cluster of k CTAs per tile, k * tiles CTAs in all. Refuses a
// vector width that does not divide the tile width, the row pitch and the
// plane's address, and a cluster size other than 1, 2, 4 or 8.
template <typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), const void* l, int n, int hp, int wp,
                 int ty, int tx, int k, int vec, void* stream, Args... args) {
  if ((k != 1 && k != 2 && k != 4 && k != 8) || ty <= 0 || tx <= 0 || hp % ty ||
      wp % tx || (wp / tx) % vec || wp % vec || (uintptr_t)l % vec)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * ty * tx * k));
  cfg.blockDim = dim3(kLutThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // K = 1 launches without the attribute: each CTA is then a cluster of
  // one by itself, and the launch skips the cluster scheduling it does not
  // need (~1 us of a ~9 us launch at T1's planes on the H100).
  cfg.numAttrs = k > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)l, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Index of vector width ``vec`` in {16, 8, 4, 2, 1}, or -1.
int width_index(int vec) {
  switch (vec) {
    case 16: return 0;
    case 8: return 1;
    case 4: return 2;
    case 2: return 3;
    case 1: return 4;
    default: return -1;
  }
}

}  // namespace

extern "C" int waternet_clahe_tile_lut(const void* l, void* luts, int n, int hp,
                                       int wp, int ty, int tx, int clip,
                                       float scale, int cluster, int vec,
                                       void* stream) {
  using Fn = void (*)(const uint8_t*, float*, int, int, int, int, int, float);
  const Fn fns[] = {clahe_tile_lut_kernel<16>, clahe_tile_lut_kernel<8>,
                    clahe_tile_lut_kernel<4>, clahe_tile_lut_kernel<2>,
                    clahe_tile_lut_kernel<1>};
  const int i = width_index(vec);
  if (i < 0) return (int)cudaErrorInvalidValue;
  return launch_tiles(fns[i], l, n, hp, wp, ty, tx, cluster, vec, stream, (float*)luts,
                      hp, wp, ty, tx, clip, scale);
}

extern "C" int waternet_clahe_tile_histogram(const void* l, void* hist, int n,
                                             int hp, int wp, int ty, int tx,
                                             int cluster, int vec, void* stream) {
  using Fn = void (*)(const uint8_t*, int*, int, int, int, int);
  const Fn fns[] = {clahe_tile_histogram_kernel<16>, clahe_tile_histogram_kernel<8>,
                    clahe_tile_histogram_kernel<4>, clahe_tile_histogram_kernel<2>,
                    clahe_tile_histogram_kernel<1>};
  const int i = width_index(vec);
  if (i < 0) return (int)cudaErrorInvalidValue;
  return launch_tiles(fns[i], l, n, hp, wp, ty, tx, cluster, vec, stream, (int*)hist, hp,
                      wp, ty, tx);
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
