// Convolution epilogue kernel for Hopper (sm_90a), plain C interface bound
// with ctypes from waternet_tpu_torch/ops/kernels.py. It runs on the
// caller's stream, allocates nothing and does not synchronise; the launcher
// returns the launch's cudaError (0 on success) so the wrapper can raise on
// a launch CUDA refused.
//
// conv_bias_act_kernel<T, Act, V>
//   A convolution's bias add and activation, in place, on its output y
//   (N, C, H, W) held in channels-last memory (C innermost), T bf16 or
//   float32:  y = act(T(float(y) + float(T(b[c])))),  act ReLU or sigmoid.
//   Replaces no TPU kernel: XLA fused the bias and activation into its
//   convolutions. PyTorch's cuDNN path adds the bias in a broadcast pass of
//   its own after every convolution and the activation in another, so each
//   output crosses device memory four times; here it crosses twice.
//   Rounding: ATen's bias add reads the bias in the output's dtype (bf16
//   under autocast), adds in float and rounds to T; relu and sigmoid then
//   read that T. The kernel takes the bias in f32 and rounds it to T once,
//   as a thread reads it into registers, adds with __fadd_rn, rounds the sum to T, and applies the activation in
//   float: ReLU as ATen's clamp_min (NaN kept, else fmaxf), sigmoid as
//   ATen's 1 / (1 + expf(-v)), IEEE division and the accurate expf
//   (never --use_fast_math or __expf), then rounds to T. So the result is
//   the bytes of add_ followed by relu/sigmoid.
//   Bound: bytes, with no reuse: every element is read once and written
//   once (2 * sizeof(T) bytes against a handful of float operations; the
//   sigmoid's expf and division only at C = 3).
//   Design: the tensor is walked flat, V elements (16 bytes, 8 bf16 or 4
//   f32) a thread a step, with kUnroll steps' loads issued before any is
//   computed, over a grid-stride loop of a grid sized to the SMs. The
//   channel of an element is its flat index mod C, so any C takes 16-byte
//   accesses, C = 3 included: a pack may span pixels. The wrapper makes
//   the grid's stride a whole number of pixels (ctas * threads * V a
//   multiple of C), so every pack a thread takes starts at the same
//   channel, and the thread reads its V bias values, rounded to T, into
//   registers once. A tensor whose address is not 16-byte aligned takes
//   V = 1; the n mod V elements past the last whole pack are done one a
//   thread at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kRelu = 0;
constexpr int kSigmoid = 1;

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

template <int Act>
__device__ __forceinline__ float activate(float v) {
  if (Act == kRelu) return isnan(v) ? v : fmaxf(v, 0.0f);
  return 1.0f / (1.0f + expf(-v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int Act, int V>
__device__ __forceinline__ void apply(Pack<T, V>& p, const float* b) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float s = round_to<T>(__fadd_rn(to_float(p.v[j]), b[j]));
    p.v[j] = from_float<T>(activate<Act>(s));
  }
}


template <typename T, int Act, int V>
__global__ void __launch_bounds__(kThreads)
    conv_bias_act_kernel(T* y, const float* __restrict__ bias, int c, long long n) {
  const long long nv = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;  // stride * V % c == 0
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float b[V];
  const int ch = (int)((first * V) % c);
#pragma unroll
  for (int j = 0; j < V; ++j) b[j] = round_to<T>(bias[(ch + j) % c]);
  Pack<T, V>* p = reinterpret_cast<Pack<T, V>*>(y);
  long long i = first;
  for (; i + (kUnroll - 1) * stride < nv; i += kUnroll * stride) {
    Pack<T, V> r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = p[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      apply<T, Act, V>(r[u], b);
      p[i + u * stride] = r[u];
    }
  }
  for (; i < nv; i += stride) {
    Pack<T, V> r = p[i];
    apply<T, Act, V>(r, b);
    p[i] = r;
  }
  const long long t = nv * V + first;  // the n mod V elements past the last pack
  if (t < n) {
    Pack<T, 1> r;
    r.v[0] = y[t];
    const float bt = round_to<T>(bias[t % c]);
    apply<T, Act, 1>(r, &bt);
    y[t] = r.v[0];
  }
}

template <typename T, int Act>
int launch(void* y, const float* bias, int c, long long n, int vec, int ctas, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (vec == kV)
    conv_bias_act_kernel<T, Act, kV>
        <<<ctas, kThreads, 0, stream>>>(static_cast<T*>(y), bias, c, n);
  else if (vec == 1)
    conv_bias_act_kernel<T, Act, 1>
        <<<ctas, kThreads, 0, stream>>>(static_cast<T*>(y), bias, c, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// y: n elements of (N, C, H, W) channels-last, bf16 (y_bf16) or f32, in
// place; bias: c f32 values, each rounded to y's type; act: 0 ReLU, 1 sigmoid;
// vec: 16 / sizeof(T) (y 16-byte aligned) or 1; ctas: the grid, with
// ctas * 256 * vec a multiple of c.
extern "C" int waternet_conv_bias_act(void* y, const float* bias, int y_bf16, int act, int c,
                                      long long n, int vec, int ctas, void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || ctas <= 0 || (act != kRelu && act != kSigmoid) ||
      (vec > 1 && (uintptr_t)y % 16) || (long long)ctas * kThreads * vec % c)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (y_bf16)
    return act == kRelu ? launch<__nv_bfloat16, kRelu>(y, bias, c, n, vec, ctas, s)
                        : launch<__nv_bfloat16, kSigmoid>(y, bias, c, n, vec, ctas, s);
  return act == kRelu ? launch<float, kRelu>(y, bias, c, n, vec, ctas, s)
                      : launch<float, kSigmoid>(y, bias, c, n, vec, ctas, s);
}
