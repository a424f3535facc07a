// Shared device helpers for the fused serving sublayers.
//
// Conventions of every kernel in this directory:
//   * the residual stream x / y is float32, token-major [tokens, C];
//   * big weight matrices arrive in torch nn.Linear layout [out, in], in the
//     compute dtype W (float or __nv_bfloat16);
//   * small vectors (biases, adaLN chunks, bias key/value) arrive as V
//     (float or __nv_bfloat16) and are widened to float on load;
//   * every sum is a float32 FMA chain on CUDA cores. With W = bf16 the
//     matmul operands are rounded to bf16 first (round-to-nearest-even),
//     which is exactly what the JAX kernels' `astype(dt)` does; with
//     W = float nothing is rounded and no TF32 is involved.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mdgen {

constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr int kRows = 16;          // tokens per GEMM tile (rows of A)
constexpr int kColTile = 128;      // output columns per GEMM pass
constexpr int kKTile = 16;         // reduction depth staged per pass
constexpr int kWsStride = kColTile + 1;
constexpr int kGemmThreads = 256;  // gemm16 assumes exactly this block size
constexpr int kWsFloats = kKTile * kWsStride;

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

// Block GEMM over one tile of kRows rows:
//   acc(r, n) = sum_k A[r * lda + k] * Wrow(n)[k],   r < kRows, n < N,
// then epi(r, n, acc) for every output. A is float in shared memory (already
// rounded to W where the semantics ask for it; rows past the valid count
// must hold finite values). Wrow(n) returns a pointer to the K weights of
// output n (one row of an [out, in] matrix). Ws is kWsFloats of shared
// scratch. Each pass stages a [kKTile x kColTile] weight tile in shared
// memory (coalesced along k); each thread then owns a 4 x 2 block of
// outputs. Must be called by all kGemmThreads threads of the block.
template <typename W, typename RowPtr, typename Epi>
__device__ __forceinline__ void gemm16(const float* __restrict__ A, int lda, int K,
                                       int N, RowPtr wrow, float* __restrict__ Ws,
                                       Epi epi) {
  const int tid = threadIdx.x;
  const int rg = tid >> 6;  // rows 4*rg .. 4*rg+3 (warp-uniform)
  const int cg = tid & 63;  // columns cg and cg + 64 of the tile
  for (int n0 = 0; n0 < N; n0 += kColTile) {
    float acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKTile) {
      __syncthreads();  // the previous tile is consumed
      for (int e = tid; e < kKTile * kColTile; e += kGemmThreads) {
        const int nn = e / kKTile, kk = e % kKTile;
        const int n = n0 + nn, k = k0 + kk;
        Ws[kk * kWsStride + nn] = (n < N && k < K) ? to_f(wrow(n)[k]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(kKTile, K - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float w0 = Ws[kk * kWsStride + cg];
        const float w1 = Ws[kk * kWsStride + cg + 64];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = A[(rg * 4 + i) * lda + k0 + kk];
          acc[i][0] = fmaf(a, w0, acc[i][0]);
          acc[i][1] = fmaf(a, w1, acc[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + cg + 64 * j;
        if (n < N) epi(rg * 4 + i, n, acc[i][j]);
      }
  }
  __syncthreads();
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
