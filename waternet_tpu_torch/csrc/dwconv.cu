// Depthwise 3x3 convolution kernel for Hopper (sm_90a), plain C interface
// bound with ctypes from waternet_tpu_torch/ops/kernels.py. It runs on the
// caller's stream, allocates nothing and does not synchronise; the launcher
// returns the launch's cudaError (0 on success) so the wrapper can raise on
// a launch CUDA refused.
//
// dwconv3x3_kernel<T, Epi, Vec>
//   Restormer's depthwise 3x3 convolutions: stride 1, zero padding 1, no
//   bias, over a contiguous NCHW x (N, C, H, W), T bf16 or float32, with one
//   of two epilogues:
//     identity   y (N, C, H, W):  y_c = T(conv(x_c, w_c)), MDTA's qkv_dwconv;
//     gelu_gate  y (N, C/2, H, W), h = C/2:  y_j = T(g_j * b_j) with
//                a_j = T(conv(x_j, w_j)), b_j = T(conv(x_{j+h}, w_{j+h})),
//                g_j = T(gelu(a_j)): GDFN's dwconv, chunk and F.gelu(x1) * x2.
//   Replaces no TPU kernel: Restormer runs only in the port. It replaces
//   ATen's and cuDNN's NCHW depthwise kernels and, for the gate, ATen's GELU
//   and product passes, which wrote 2h planes to read them straight back.
//   Rounding: every sum is float32 over the 9 taps (fmaf, top row first,
//   left to right), with each weight rounded to T as autocast casts it; the
//   identity rounds once, to T. The gate rounds as the eager path does: both
//   convolutions to T, GELU of that in float32 as ATen's exact form computes
//   it, v * 0.5f * (1 + erff(v * M_SQRT1_2)) (the accurate erff, never
//   --use_fast_math, never the tanh form), rounded to T, then the product
//   rounded to T (for bf16 one rounded bf16 multiply: the product of two
//   bf16 values is exact in float32, so it is ATen's float product
//   rounded). So the gate's bytes are the eager gate's over the identity's.
//   Bound: bytes. Each output takes 9 FMAs (18 for the gate's, plus a
//   GELU of ~34 instructions) against 2 * sizeof(T) (3 * sizeof(T)) bytes of
//   input and output, far below the ~295 operations a byte where bf16
//   compute would bound; the gate's GELU still makes it issue-bound on the
//   H100 (its instructions fill ~3/4 of the issue slots at ~3/4 of the
//   bytes bound), so its warps are held to 128 registers for occupancy.
//   Design: a warp takes one output plane, a band of `rows` rows and a
//   segment of 240 columns. Its lane L holds the 8 columns at
//   segment * 240 - 8 + 8 L of a row (16 bytes for bf16) and lanes 1..30
//   write theirs: lanes 0 and 31 bring the segment's halo columns, which a
//   lane takes from its neighbours with two warp shuffles; no load crosses a
//   row, and 240 columns divide every width of a 1080p pyramid. Vec: the
//   warp streams the band's input rows through a ring of kStages rows in
//   shared memory with cp.async (kStages - 1 rows in flight, each lane
//   copying and reading back only its own 16 bytes), so each input byte is
//   read once but for the band's two halo rows and the segments' halo packs
//   (L1 and L2 hits of the neighbouring warps' copies). Each row read adds
//   its taps to the sums of the three output rows it feeds and finishes
//   the one above (push form: two rows of sums live, no window of inputs).
//   Rows and columns outside the plane read as 0 (the padding).
//   Vec = false is the same walk with one element a load and a store, each
//   masked: for a width that is not a multiple of 8 or an address that is
//   not 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 8;                 // columns a lane loads and writes along a row
constexpr int kSegCols = 30 * kCols;     // columns a warp writes: lanes 1..30
constexpr int kStages = 5;               // ring rows a warp streams through (Vec)
constexpr int kIdentity = 0;
constexpr int kGeluGate = 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// ATen's GELU (GeluType::None) as its CUDA kernel computes it in float.
__device__ __forceinline__ float gelu(float v) {
  constexpr float kAlpha = M_SQRT1_2;
  return v * 0.5f * (1.0f + erff(v * kAlpha));
}

template <typename T>
struct alignas(16) Cols {
  T v[kCols];
};

// The kCols columns from `col` of row `i` of `plane`, one element a load,
// 0 outside the plane.
template <typename T>
__device__ __forceinline__ void fetch(Cols<T>& c, const T* __restrict__ plane, int i, bool row_ok,
                                      int col, int w) {
  const T* row = plane + (long long)(row_ok ? i : 0) * w;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int x = col + j;
    c.v[j] = (row_ok && x >= 0 && x < w) ? row[x] : from_float<T>(0.0f);
  }
}

// A fetched row into floats, with the column left of the lane's first and
// right of its last from the neighbouring lanes. Every lane of the warp
// takes part.
template <typename T>
__device__ __forceinline__ void widen(float (&f)[kCols + 2], const Cols<T>& c) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) f[j + 1] = to_float(c.v[j]);
  f[0] = __shfl_up_sync(kFull, f[kCols], 1);
  f[kCols + 1] = __shfl_down_sync(kFull, f[1], 1);
}

// Row r's three taps of dy into the kCols sums it feeds: the sums of the
// output row below r (dy = 0), at r (1) or above r (2). Each sum takes its
// taps top row first, left to right, from 0 (start), one fmaf each.
template <bool Start>
__device__ __forceinline__ void taps(float (&acc)[kCols], const float (&row)[kCols + 2],
                                     const float (&k)[9], int dy) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    float s = Start ? 0.0f : acc[j];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) s = fmaf(k[3 * dy + dx], row[j + dx], s);
    acc[j] = s;
  }
}

// Two values rounded to T (round to nearest even), as T: a bf16 pair in one
// conversion.
template <typename T>
__device__ __forceinline__ void pack2(T* o, float u, float v) {
  o[0] = from_float<T>(u);
  o[1] = from_float<T>(v);
}
template <>
__device__ __forceinline__ void pack2<__nv_bfloat16>(__nv_bfloat16* o, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(u, v);
}

// Two values rounded to T and widened back, in place.
template <typename T>
__device__ __forceinline__ void round2(float& u, float& v) {
  T o[2];
  pack2<T>(o, u, v);
  u = to_float(o[0]);
  v = to_float(o[1]);
}

template <typename T, int Epi, bool Vec>
__device__ __forceinline__ void store(T* __restrict__ row, const float (&acc)[Epi + 1][kCols], int col,
                                      int w, bool writes) {
  Cols<T> o;
#pragma unroll
  for (int j = 0; j < kCols; j += 2) {
    if (Epi == kIdentity) {
      pack2<T>(&o.v[j], acc[0][j], acc[0][j + 1]);
    } else {
      float a0 = acc[0][j], a1 = acc[0][j + 1];
      round2<T>(a0, a1);
      if constexpr (sizeof(T) == 2) {
        // bf16 x bf16 is exact in float32, so ATen's float product rounded
        // to bf16 is one rounded bf16 multiply.
        const __nv_bfloat162 g = __floats2bfloat162_rn(gelu(a0), gelu(a1));
        const __nv_bfloat162 b = __floats2bfloat162_rn(acc[Epi][j], acc[Epi][j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&o.v[j]) = __hmul2(g, b);
      } else {
        pack2<T>(&o.v[j], gelu(a0) * acc[Epi][j], gelu(a1) * acc[Epi][j + 1]);
      }
    }
  }
  if (!writes) return;
  if (Vec) {
    constexpr int kN = sizeof(Cols<T>) / 16;
    uint4* dst = reinterpret_cast<uint4*>(row + col);
    const uint4* src = reinterpret_cast<const uint4*>(&o);
#pragma unroll
    for (int k = 0; k < kN; ++k) dst[k] = src[k];
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (col + j < w) row[col + j] = o.v[j];
  }
}

// Vec: the ring a warp streams its input rows through, kStages rows of P
// planes, each lane's 16-byte packs at [lane] (no bank conflicts).
template <typename T, int P>
struct Ring {
  uint4 v[kStages][P][sizeof(Cols<T>) / 16][32];
};

// 16 bytes from global to shared memory, asynchronously; zeros for !ok.
__device__ __forceinline__ void cp_async16(uint4* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// x: (n, c, h, w); y: (n, c / P, h, w) with P = 1 (identity) or 2 (gate);
// wt: (c, 9) float32. Task t (one a warp): segment t % segs, band
// (t / segs) % bands, output plane t / (segs * bands).
// The gate's kernel is held to 128 registers a thread (8 CTAs, 16 warps an
// SM): its GELU is issue-bound, and more warps hide more of its latency.
template <typename T, int Epi, bool Vec>
__global__ void __launch_bounds__(kThreads, Epi == kGeluGate ? 8 : 1)
    dwconv3x3_kernel(const T* __restrict__ x, const float* __restrict__ wt, T* __restrict__ y,
                     int c, int h, int w, int rows, int bands, int segs, long long tasks) {
  constexpr int P = Epi + 1;  // input planes an output plane reads
  constexpr int kN = sizeof(Cols<T>) / 16;
  __shared__ Ring<T, P> rings[kWarps];
  const long long task = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= tasks) return;  // the whole warp: tasks are per warp
  Ring<T, P>& ring = rings[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  const int seg = (int)(task % segs);
  const long long rest = task / segs;
  const int r0 = (int)(rest % bands) * rows;
  const long long p = rest / bands;
  const int oc = c / P;
  const long long frame = p / oc;
  const int ch = (int)(p % oc);
  const long long hw = (long long)h * w;
  const T* src[P];
  float k[P][9];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int cq = ch + q * oc;
    src[q] = x + (frame * c + cq) * hw;
#pragma unroll
    for (int t = 0; t < 9; ++t) k[q][t] = round_to<T>(wt[cq * 9 + t]);
  }
  T* dst = y + p * hw;
  const int r1 = min(r0 + rows, h);
  const int nt = r1 - r0 + 2;  // input rows r0 - 1 .. r1
  const int col = seg * kSegCols - kCols + lane * kCols;
  const bool writes = lane >= 1 && lane <= 30 && col < w;
  const bool in_row = col >= 0 && col < w;

  // Vec: issue() starts the copy of the next input row into the ring, one
  // commit group a row (an empty one past the band, so the waits count
  // alike), kStages - 1 rows ahead of the one taken.
  int issued = 0, slot = 0, stage = 0;  // slot: issued % kStages
  long long off = (long long)(r0 - 1) * w + col;  // of input row r0 - 1 + issued
  auto issue = [&]() {
    const int i = r0 - 1 + issued;
    const bool ok = issued < nt && in_row && i >= 0 && i < h;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const uint4* g = reinterpret_cast<const uint4*>(src[q] + (ok ? off : 0));
#pragma unroll
      for (int kk = 0; kk < kN; ++kk) cp_async16(&ring.v[slot][q][kk][lane], g + (ok ? kk : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    ++issued;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    off += w;
  };
  if (Vec)
    for (int u = 0; u < kStages - 1; ++u) issue();

  // The walk takes input rows r0 - 1 + t, t = 0 .. nt - 1. Row t finishes
  // the sums of output row t - 1 (its taps below, then the store), adds to
  // those of row t and starts those of row t + 1, in sum slots (t - 1) % 3,
  // t % 3, (t + 1) % 3 (output row t is image row r0 + t - 1). The loop
  // takes 3 rows a step, so every slot is known when compiling and no sum
  // moves between registers; sums past the band are made and not stored.
  float acc[3][P][kCols] = {};
  for (int t0 = 0; t0 < nt; t0 += 3) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int t = t0 + u;
      if (t >= nt) break;
      const int i = r0 - 1 + t;
      if (Vec) {
        issue();
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");  // row t is in
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        Cols<T> raw;
        if (Vec) {
#pragma unroll
          for (int kk = 0; kk < kN; ++kk) reinterpret_cast<uint4*>(&raw)[kk] = ring.v[stage][q][kk][lane];
        } else {
          fetch(raw, src[q], i, i >= 0 && i < h, col, w);
        }
        float row[kCols + 2];
        widen(row, raw);
        taps<false>(acc[(u + 2) % 3][q], row, k[q], 2);
        taps<false>(acc[u][q], row, k[q], 1);
        taps<true>(acc[(u + 1) % 3][q], row, k[q], 0);
      }
      stage = stage + 1 == kStages ? 0 : stage + 1;
      if (t >= 2) store<T, Epi, Vec>(dst + (long long)(i - 1) * w, acc[(u + 2) % 3], col, w, writes);
    }
  }
}

template <typename T, int Epi>
int launch(const void* x, const float* wt, void* y, int c, int h, int w, int rows, int vec,
           long long ctas, int bands, int segs, long long tasks, cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (vec)
    dwconv3x3_kernel<T, Epi, true>
        <<<(unsigned)ctas, kThreads, 0, stream>>>(xs, wt, ys, c, h, w, rows, bands, segs, tasks);
  else
    dwconv3x3_kernel<T, Epi, false>
        <<<(unsigned)ctas, kThreads, 0, stream>>>(xs, wt, ys, c, h, w, rows, bands, segs, tasks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, c, h, w) contiguous, bf16 (x_bf16) or f32; weight: (c, 9) f32, each
// rounded to x's type; y: (n, c, h, w), or (n, c / 2, h, w) for gate = 1
// (c even); rows: output rows a warp takes; vec: 1 for 16-byte accesses (w a
// multiple of 8, x and y 16-byte aligned), 0 for one element at a time.
extern "C" int waternet_dwconv3x3(const void* x, const float* weight, void* y, int x_bf16, int gate,
                                  int n, int c, int h, int w, int rows, int vec, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  if (rows <= 0 || (gate != 0 && gate != 1) || (gate && c % 2) || (vec != 0 && vec != 1) ||
      (vec && (w % kCols || (uintptr_t)x % 16 || (uintptr_t)y % 16)))
    return (int)cudaErrorInvalidValue;
  const int bands = (h + rows - 1) / rows;
  const int segs = (w + kSegCols - 1) / kSegCols;
  const long long tasks = (long long)n * (c / (gate + 1)) * bands * segs;
  const long long ctas = (tasks + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return gate ? launch<__nv_bfloat16, kGeluGate>(x, weight, y, c, h, w, rows, vec, ctas, bands, segs, tasks, s)
                : launch<__nv_bfloat16, kIdentity>(x, weight, y, c, h, w, rows, vec, ctas, bands, segs, tasks, s);
  return gate ? launch<float, kGeluGate>(x, weight, y, c, h, w, rows, vec, ctas, bands, segs, tasks, s)
              : launch<float, kIdentity>(x, weight, y, c, h, w, rows, vec, ctas, bands, segs, tasks, s);
}
