// Shared device helpers for the fused serving sublayers.
//
// Conventions of every kernel in this directory:
//   * the residual stream x / y is float32, token-major [tokens, C];
//   * big weight matrices arrive in torch nn.Linear layout [out, in], in the
//     compute dtype W (float or __nv_bfloat16);
//   * small vectors (biases, adaLN chunks, bias key/value) arrive as V
//     (float or __nv_bfloat16) and are widened to float on load;
//   * every sum is float32. With W = bf16 the matmul operands are rounded
//     to bf16 first (round-to-nearest-even), which is exactly what the JAX
//     kernels' `astype(dt)` does; with W = float nothing is rounded, and
//     the tensor-core products take each operand as a split TF32 pair
//     (mma_tile.cuh), f32-exact to about 2^-21 of a product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mdgen {

constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round a float to the operand dtype W (identity for float).
template <typename W> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Store a float as O (round-to-nearest-even for bf16).
template <typename O> __device__ __forceinline__ O from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[c] = rnd_W(LN(x)[c] * (1 + scale[c]) + shift[c]) for one token, one
// warp per call, stored as O (float, or W itself). LN has no affine;
// two-pass mean / variance, eps 1e-6.
template <typename W, typename V, typename O = float>
__device__ __forceinline__ void ln_modulate(const float* __restrict__ x,
                                            const V* __restrict__ shift,
                                            const V* __restrict__ scale,
                                            O* __restrict__ out, int C) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += x[c];
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = x[c] - mu;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / C + 1e-6f);
  for (int c = lane; c < C; c += 32) {
    const float h = (x[c] - mu) * inv * (1.f + to_f(scale[c])) + to_f(shift[c]);
    out[c] = from_f<O>(rnd<W>(h));
  }
}

// Rotate one head's vector in place (GPT-NeoX half rotation, ESM tables):
// v[i] <- v[i] cos[i] - v[i+half] sin[i], v[i+half] <- v[i+half] cos + v[i] sin.
// sin/cos point at the table row of this position ([hd] each).
__device__ __forceinline__ void rope_pair(float* v, int i, int half,
                                          const float* sin, const float* cos) {
  const float a = v[i], b = v[i + half];
  v[i] = a * cos[i] - b * sin[i];
  v[i + half] = b * cos[i + half] + a * sin[i + half];
}

// Set the dynamic shared memory limit of a kernel once per process.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) done = true;
  return e;
}

}  // namespace mdgen
