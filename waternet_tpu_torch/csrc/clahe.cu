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
// clahe_lut_planes_kernel<V>
//   Replaces the TPU kernel clahe_lut_planes (pallas_kernels.py:229
//   _interp_kernel, pallas_call at :256). For every pixel of the padded L
//   plane, the value of its four surrounding tile LUTs (quadrants 11, 12,
//   21, 22) at that pixel's level: four (N, hp, wp) f32 planes. Public and
//   held against the JAX kernel; the main path takes clahe_lut_blend.
//   Bound: bytes (1 B read, 16 B written per pixel, plus the LUTs).
//
// clahe_lut_blend_kernel<V>
//   The same TPU kernel with CLAHE's epilogue fused: the bilinear blend of
//   the four lookups in the eager op order of ops/clahe.py,
//   (p11*(1-xa) + p12*xa)*(1-ya) + (p21*(1-xa) + p22*xa)*ya, one rounding
//   per op (__fsub_rn/__fmul_rn/__fadd_rn, so nvcc contracts nothing into
//   an FMA), then rintf (half to even) and clamp to [0, 255], stored only
//   for the kept (N, h, w) pixels. Bound: bytes (1 B read, 4 B written per
//   kept pixel, plus the LUTs).
//
//   Design of both (band_lookup, the phase they share): the row tile
//   indices (y1, y2) are constant over bands of rows (the cells of
//   waternet_tpu/ops/clahe.py:317-340). The host cuts each band into
//   strips (ops/kernels.py lut_blend_plan) and launches one CTA per (strip,
//   image), so a CTA stages only the two tile rows of LUTs its band reads
//   (2 * tx KB: 16 KB at the 8x8 grid; one when y1 == y2 at the edges),
//   not the whole image's, and gathers from shared memory. Strips hold at
//   least 1,024 pixels, so staging costs at most 16 B per pixel, read from
//   L2 (the image's LUTs are 64 KB). Each thread takes V consecutive
//   pixels a step, consecutive lanes consecutive steps (V in {4, 2, 1},
//   the widest that divides the row widths and the addresses): one V-byte
//   load of the plane, 16-byte loads of the column indices and weights,
//   and one float4 store per output plane, so a warp reads 128 and writes
//   512 contiguous bytes. (16 pixels a thread took 110-128 registers, two
//   CTAs per SM, and spread a warp's stores 64 B apart: slower.
//   Prefetching the next step's loads raised the 4-pixel blend from 40 to
//   64 registers and was slower at 1080p.) The data-dependent gathers
//   conflict in shared memory's banks; that is inherent to the lookup, and
//   costs little here (chip_smoke.py times the blend on a constant and on
//   a uniform random plane). Per-row and per-column tile indices and the
//   blend weights come from the host (numpy float32, the arithmetic of
//   clahe.py:328-340), so no float coordinate math runs here and nvcc's
//   FMA contraction cannot move a tile boundary. A row whose indices are
//   not its strip's band (indices other than the plan was made from)
//   reads its LUTs from global memory instead: slower, the same values.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 256;
constexpr int kLutThreads = kBins;  // one thread per bin in the finaliser
constexpr int kLutWarps = kLutThreads / 32;
constexpr int kLoadsInFlight = 4;   // vector loads issued per lane before counting
constexpr int kStripThreads = 256;
constexpr int kStaticSmem = 48 * 1024;  // above this, dynamic smem needs an opt-in

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

// V consecutive bytes of the plane at p (V-byte aligned), one load.
template <int V>
__device__ __forceinline__ void load_bytes(const uint8_t* p, int (&v)[V]) {
  const unsigned u = __ldg(reinterpret_cast<const typename Vec<V>::T*>(p));
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = (u >> (8 * j)) & 0xffu;
}

__device__ __forceinline__ void from_bits(unsigned u, int& out) { out = (int)u; }
__device__ __forceinline__ void from_bits(unsigned u, float& out) { out = __uint_as_float(u); }

// V consecutive 4-byte words (int32 indices, f32 weights) at p: one 16-byte
// load for V = 4 (p is then 16-byte aligned).
template <int V, typename T>
__device__ __forceinline__ void load_words(const T* p, T (&out)[V]) {
  if constexpr (V == 4) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    from_bits(u.x, out[0]); from_bits(u.y, out[1]);
    from_bits(u.z, out[2]); from_bits(u.w, out[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = __ldg(p + j);
  }
}

// V consecutive floats to p: a float4 store for V = 4, float2 for V = 2.
template <int V>
__device__ __forceinline__ void store_floats(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The lookup phase of both interpolation kernels. CTA (strip, image)
// stages the LUTs of the two tile rows its strip's band reads, then walks
// the strip's flattened (row, V-pixel column) steps over columns [0, cols),
// consecutive lanes on consecutive steps, and hands each to emit(r, c, q),
// q[k][j] being quadrant k's (11, 12, 21, 22) LUT value at pixel (r, c + j).
// strips[i] .. strips[i + 1] are the rows of strip i.
template <int V, typename Emit>
__device__ __forceinline__ void band_lookup(const float* __restrict__ luts,
                                            const uint8_t* __restrict__ l,
                                            const int* __restrict__ strips,
                                            const int* __restrict__ y1,
                                            const int* __restrict__ y2,
                                            const int* __restrict__ x1,
                                            const int* __restrict__ x2, int hp,
                                            int wp, int ty, int tx, int cols,
                                            Emit emit) {
  extern __shared__ float4 s_raw[];
  const float* s_lut = reinterpret_cast<const float*>(s_raw);

  const int img = blockIdx.y;
  const int r0 = strips[blockIdx.x];
  const int r1 = strips[blockIdx.x + 1];
  const int band_a = __ldg(y1 + r0);
  const int band_b = __ldg(y2 + r0);
  const int row_lut = tx * kBins;  // floats of one tile row of LUTs
  const float* img_luts = luts + (size_t)img * ty * row_lut;
  const float4* src = reinterpret_cast<const float4*>(img_luts);
  const int staged = band_a == band_b ? 1 : 2;
  const int row4 = row_lut / 4;
  for (int i = threadIdx.x; i < staged * row4; i += kStripThreads) {
    const int k = i >= row4;
    s_raw[i] = __ldg(src + (size_t)(k ? band_b : band_a) * row4 + (i - k * row4));
  }
  const float* s_a = s_lut;
  const float* s_b = s_lut + (staged - 1) * row_lut;
  __syncthreads();

  const int per_row = cols / V;
  const int total = (r1 - r0) * per_row;
  for (int i = threadIdx.x; i < total; i += kStripThreads) {
    const int dr = i / per_row;
    const int r = r0 + dr;
    const int c = (i - dr * per_row) * V;
    int v[V], xl[V], xh[V];
    load_bytes<V>(l + ((size_t)img * hp + r) * wp + c, v);
    load_words<V>(x1 + c, xl);
    load_words<V>(x2 + c, xh);
    float q[4][V];
    const int ra = __ldg(y1 + r);
    const int rb = __ldg(y2 + r);
    if (ra == band_a && rb == band_b) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int ca = xl[j] * kBins + v[j];
        const int cb = xh[j] * kBins + v[j];
        q[0][j] = s_a[ca];
        q[1][j] = s_a[cb];
        q[2][j] = s_b[ca];
        q[3][j] = s_b[cb];
      }
    } else {
      const float* g_a = img_luts + (size_t)ra * row_lut;
      const float* g_b = img_luts + (size_t)rb * row_lut;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int ca = xl[j] * kBins + v[j];
        const int cb = xh[j] * kBins + v[j];
        q[0][j] = __ldg(g_a + ca);
        q[1][j] = __ldg(g_a + cb);
        q[2][j] = __ldg(g_b + ca);
        q[3][j] = __ldg(g_b + cb);
      }
    }
    emit(r, c, q);
  }
}

template <int V>
__global__ void __launch_bounds__(kStripThreads)
clahe_lut_planes_kernel(const float* __restrict__ luts,
                        const uint8_t* __restrict__ l,
                        const int* __restrict__ strips,
                        const int* __restrict__ y1, const int* __restrict__ y2,
                        const int* __restrict__ x1, const int* __restrict__ x2,
                        float* __restrict__ out, int n, int hp, int wp, int ty,
                        int tx) {
  const size_t plane = (size_t)n * hp * wp;
  const int img = blockIdx.y;
  band_lookup<V>(luts, l, strips, y1, y2, x1, x2, hp, wp, ty, tx, wp,
                 [&](int r, int c, const float (&q)[4][V]) {
                   float* o = out + ((size_t)img * hp + r) * wp + c;
#pragma unroll
                   for (int k = 0; k < 4; ++k) store_floats<V>(o + k * plane, q[k]);
                 });
}

template <int V>
__global__ void __launch_bounds__(kStripThreads)
clahe_lut_blend_kernel(const float* __restrict__ luts,
                       const uint8_t* __restrict__ l,
                       const int* __restrict__ strips,
                       const int* __restrict__ y1, const int* __restrict__ y2,
                       const int* __restrict__ x1, const int* __restrict__ x2,
                       const float* __restrict__ ya, const float* __restrict__ xa,
                       float* __restrict__ out, int hp, int wp, int ty, int tx,
                       int h, int w) {
  const int img = blockIdx.y;
  band_lookup<V>(luts, l, strips, y1, y2, x1, x2, hp, wp, ty, tx, w,
                 [&](int r, int c, const float (&q)[4][V]) {
                   const float wy = __ldg(ya + r);
                   const float wy1 = __fsub_rn(1.0f, wy);
                   float wx[V], res[V];
                   load_words<V>(xa + c, wx);
#pragma unroll
                   for (int j = 0; j < V; ++j) {
                     const float wx1 = __fsub_rn(1.0f, wx[j]);
                     const float top =
                         __fadd_rn(__fmul_rn(q[0][j], wx1), __fmul_rn(q[1][j], wx[j]));
                     const float bot =
                         __fadd_rn(__fmul_rn(q[2][j], wx1), __fmul_rn(q[3][j], wx[j]));
                     const float b = __fadd_rn(__fmul_rn(top, wy1), __fmul_rn(bot, wy));
                     // rintf rounds half to even, as torch.round.
                     res[j] = fminf(fmaxf(rintf(b), 0.0f), 255.0f);
                   }
                   store_floats<V>(out + ((size_t)img * h + r) * w + c, res);
                 });
}

// One CTA of kStripThreads per (strip, image), with the two tile rows of
// LUTs in dynamic shared memory. Refuses an empty or misaligned launch.
template <typename... Params, typename... Args>
int launch_strips(void (*kernel)(Params...), int n_strips, int n, int tx, void* stream,
                  Args... args) {
  if (n_strips <= 0 || n <= 0 || tx <= 0) return (int)cudaErrorInvalidValue;
  const int smem = 2 * tx * kBins * (int)sizeof(float);
  if (smem > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)n_strips, (unsigned)n), kStripThreads, smem,
           (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// True when V-pixel steps (V in {4, 2, 1}) over ``cols`` columns keep every
// access aligned:
// V bytes of the plane (pitch wp) and V floats of the output (pitch cols),
// the output's address aligned to its vector stores.
bool strip_vec_ok(int vec, int cols, int wp, const void* l, const void* out,
                  const void* luts) {
  const int store_align = 4 * vec;
  return cols % vec == 0 && wp % vec == 0 && (uintptr_t)l % vec == 0 &&
         (uintptr_t)out % store_align == 0 && (uintptr_t)luts % 16 == 0;
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
                                         const void* strips, int n_strips,
                                         const void* y1, const void* y2,
                                         const void* x1, const void* x2,
                                         void* out, int n, int hp, int wp,
                                         int ty, int tx, int vec, void* stream) {
  using Fn = void (*)(const float*, const uint8_t*, const int*, const int*, const int*,
                      const int*, const int*, float*, int, int, int, int, int);
  const Fn fns[] = {clahe_lut_planes_kernel<4>, clahe_lut_planes_kernel<2>,
                    clahe_lut_planes_kernel<1>};
  const int i = width_index(vec) - 2;  // 4, 2, 1 -> 0, 1, 2
  if (i < 0 || !strip_vec_ok(vec, wp, wp, l, out, luts)) return (int)cudaErrorInvalidValue;
  return launch_strips(fns[i], n_strips, n, tx, stream, (const float*)luts,
                       (const uint8_t*)l, (const int*)strips, (const int*)y1,
                       (const int*)y2, (const int*)x1, (const int*)x2, (float*)out, n, hp,
                       wp, ty, tx);
}

extern "C" int waternet_clahe_lut_blend(const void* luts, const void* l,
                                        const void* strips, int n_strips,
                                        const void* y1, const void* y2,
                                        const void* x1, const void* x2,
                                        const void* ya, const void* xa, void* out,
                                        int n, int hp, int wp, int ty, int tx, int h,
                                        int w, int vec, void* stream) {
  using Fn = void (*)(const float*, const uint8_t*, const int*, const int*, const int*,
                      const int*, const int*, const float*, const float*, float*, int,
                      int, int, int, int, int);
  const Fn fns[] = {clahe_lut_blend_kernel<4>, clahe_lut_blend_kernel<2>,
                    clahe_lut_blend_kernel<1>};
  const int i = width_index(vec) - 2;  // 4, 2, 1 -> 0, 1, 2
  if (i < 0 || h > hp || w > wp || !strip_vec_ok(vec, w, wp, l, out, luts) ||
      (vec == 4 && (uintptr_t)xa % 16))
    return (int)cudaErrorInvalidValue;
  return launch_strips(fns[i], n_strips, n, tx, stream, (const float*)luts,
                       (const uint8_t*)l, (const int*)strips, (const int*)y1,
                       (const int*)y2, (const int*)x1, (const int*)x2, (const float*)ya,
                       (const float*)xa, (float*)out, hp, wp, ty, tx, h, w);
}
