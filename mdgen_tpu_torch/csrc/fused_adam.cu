// The train step's optimizer pass over every parameter tensor: the
// gradients' global norm (sum_squares_kernel) and one fused clip, Adam
// (AdamW) and EMA update (fused_adam_kernel).
//
// Replaces no TPU kernel: the JAX package's optimizer is optax
// (clip_by_global_norm, then adam or adamw) and an EMA tree_map, which XLA
// fuses on its own. The port's eager loop (ops/fused_optim.py:
// fused_adam_plain) launches some 30 small kernels a parameter tensor, each
// issued from the host; this pass is two launches a step.
//
// What bounds it on an H100: bytes. A 4AA step (34.15M f32 parameters)
// reads g twice (norm, apply) and p, mu, nu and the EMA once, and writes p,
// mu, nu and the EMA once: 1.37 GB, 0.41 ms at 3.35 TB/s (1.09 GB, 0.33 ms
// without an EMA). Each element is a few dozen flops, far under the ridge.
//
// Design:
//   * the tensors travel by value in a __grid_constant__ table (pointers,
//     sizes, the first block of each), up to kMaxTensors a launch, so no
//     host-to-device copy precedes a launch;
//   * each tensor is cut into chunks of `chunk` elements, one block a
//     chunk; a block finds its tensor by a binary search of the table;
//   * 16-byte loads and stores where every pointer of a tensor is 16-byte
//     aligned, 4-byte ones otherwise, and a masked tail;
//   * sum of squares: f32 within a thread (chunk / 256 elements), f64
//     across the threads and blocks; each block writes its partial, and the
//     last block of the launch to finish (an integer counter, which that
//     block resets) sums every partial in index order: no float atomics,
//     and the same bits from run to run;
//   * the bias corrections 1 - b1^count and 1 - b2^count are read from
//     device memory (two floats the host fills before each launch), so a
//     CUDA graph that captured the launch applies each replay's own step;
//   * apply: each element's clip, Adam and EMA in registers, in the f32
//     operations and order of the eager loop, each rounded as PyTorch's
//     elementwise kernels round it (the _rn intrinsics, so nvcc contracts
//     nothing into an FMA): given the same norm, p, mu, nu and the EMA are
//     bit-equal to fused_adam_plain's on the card.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace mdgen {

constexpr int kOptThreads = 256;
#if CUDART_VERSION >= 12010
constexpr int kMaxTensors = 256;  // kernel parameters up to 32 KB (CUDA 12.1 and later)
#else
constexpr int kMaxTensors = 48;  // within 4 KB of kernel parameters
#endif

struct SumTable {
  const float* x[kMaxTensors];
  long long n[kMaxTensors];
  int first[kMaxTensors + 1];  // first block of each tensor; first[count]: the grid
  int count, chunk;
};

struct AdamTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* mu[kMaxTensors];
  float* nu[kMaxTensors];
  float* ema[kMaxTensors];  // null without an EMA
  long long n[kMaxTensors];
  int first[kMaxTensors + 1];
  int count, chunk;
};

// The eager loop's Python scalars, each rounded to f32 as PyTorch rounds a
// scalar operand; the step's bias corrections come from device memory.
struct AdamScalars {
  float clip;      // the global norm the gradients are clipped to
  float c1, b1;    // 1 - b1, b1
  float c2, b2;    // 1 - b2, b2
  float eps, wd, neg_lr;
  float ema_d, ema_c;  // decay, 1 - decay
};

// The tensor whose chunks hold block b: the last i with first[i] <= b (so a
// tensor of no elements, which owns no block, is skipped).
template <typename Table>
__device__ __forceinline__ int tensor_of_block(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The block's sum of v, in a fixed order; valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kOptThreads / 32; ++w) s += warp_sums[w];
  return s;
}

// partials[offset + block] = the block's sum of squares. With a counter
// (the last launch of a call), the launch's last block to finish writes
// out[0] = the sum of partials[0, total) and out[1] = its square root.
__global__ void __launch_bounds__(kOptThreads)
sum_squares_kernel(const __grid_constant__ SumTable t, double* __restrict__ partials, int offset,
                   int total, unsigned* counter, float* __restrict__ out) {
  __shared__ double warp_sums[kOptThreads / 32];
  __shared__ bool last;
  const int i = tensor_of_block(t, blockIdx.x);
  const long long start = (long long)(blockIdx.x - t.first[i]) * t.chunk;
  const int len = (int)min((long long)t.chunk, t.n[i] - start);
  const float* x = t.x[i] + start;
  float acc = 0.f;
  int done = 0;
  if (aligned16(x)) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int n4 = len >> 2;
    for (int k = threadIdx.x; k < n4; k += kOptThreads) {
      const float4 v = x4[k];
      acc = fmaf(v.x, v.x, acc);
      acc = fmaf(v.y, v.y, acc);
      acc = fmaf(v.z, v.z, acc);
      acc = fmaf(v.w, v.w, acc);
    }
    done = n4 << 2;
  }
  for (int k = done + threadIdx.x; k < len; k += kOptThreads) acc = fmaf(x[k], x[k], acc);
  const double s = block_sum((double)acc, warp_sums);
  if (threadIdx.x == 0) {
    partials[offset + blockIdx.x] = s;
    last = false;
    if (counter != nullptr) {
      __threadfence();  // the partial is visible before the count says so
      last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (!last) return;
  double v = 0.0;
  for (int k = threadIdx.x; k < total; k += kOptThreads) v += __ldcg(partials + k);
  const double all = block_sum(v, warp_sums);
  if (threadIdx.x == 0) {
    const float sum = (float)all;
    out[0] = sum;
    out[1] = __fsqrt_rn(sum);
    *counter = 0u;  // ready for the next call
  }
}

// The eager loop on one element, operation by operation:
//   g = where(norm < clip, g, (g / norm) * clip)
//   mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g**2 + b2 * nu
//   u = (mu / bc1) / (sqrt(nu / bc2) + eps);  [u = u + wd * p]
//   p = p + (-lr) * u
__device__ __forceinline__ void adam_element(float g, float& p, float& m, float& v,
                                             const AdamScalars& s, float bc1, float bc2,
                                             float norm, bool keep) {
  if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), s.clip);
  m = __fadd_rn(__fmul_rn(s.c1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.c2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), s.eps));
  if (s.wd != 0.f) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, u));
}

// ema = ema * d + (1 - d) * p, with p the updated parameter
__device__ __forceinline__ float ema_element(float e, float p, const AdamScalars& s) {
  return __fadd_rn(__fmul_rn(e, s.ema_d), __fmul_rn(s.ema_c, p));
}

template <bool kEma>
__global__ void __launch_bounds__(kOptThreads)
fused_adam_kernel(const __grid_constant__ AdamTable t, const AdamScalars s,
                  const float* __restrict__ norm_ptr, const float* __restrict__ bc) {
  const int i = tensor_of_block(t, blockIdx.x);
  const long long start = (long long)(blockIdx.x - t.first[i]) * t.chunk;
  const int len = (int)min((long long)t.chunk, t.n[i] - start);
  float* p = t.p[i] + start;
  const float* g = t.g[i] + start;
  float* mu = t.mu[i] + start;
  float* nu = t.nu[i] + start;
  float* e = kEma ? t.ema[i] + start : nullptr;
  const float norm = *norm_ptr;
  const bool keep = norm < s.clip;
  const float bc1 = bc[0], bc2 = bc[1];
  int done = 0;
  if (aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu) && aligned16(e)) {
    const int n4 = len >> 2;
    for (int k = threadIdx.x; k < n4; k += kOptThreads) {
      const float4 gv = reinterpret_cast<const float4*>(g)[k];
      float4 pv = reinterpret_cast<float4*>(p)[k];
      float4 mv = reinterpret_cast<float4*>(mu)[k];
      float4 vv = reinterpret_cast<float4*>(nu)[k];
      adam_element(gv.x, pv.x, mv.x, vv.x, s, bc1, bc2, norm, keep);
      adam_element(gv.y, pv.y, mv.y, vv.y, s, bc1, bc2, norm, keep);
      adam_element(gv.z, pv.z, mv.z, vv.z, s, bc1, bc2, norm, keep);
      adam_element(gv.w, pv.w, mv.w, vv.w, s, bc1, bc2, norm, keep);
      reinterpret_cast<float4*>(p)[k] = pv;
      reinterpret_cast<float4*>(mu)[k] = mv;
      reinterpret_cast<float4*>(nu)[k] = vv;
      if (kEma) {
        float4 ev = reinterpret_cast<float4*>(e)[k];
        ev.x = ema_element(ev.x, pv.x, s);
        ev.y = ema_element(ev.y, pv.y, s);
        ev.z = ema_element(ev.z, pv.z, s);
        ev.w = ema_element(ev.w, pv.w, s);
        reinterpret_cast<float4*>(e)[k] = ev;
      }
    }
    done = n4 << 2;
  }
  for (int k = done + threadIdx.x; k < len; k += kOptThreads) {
    float pk = p[k], mk = mu[k], vk = nu[k];
    adam_element(g[k], pk, mk, vk, s, bc1, bc2, norm, keep);
    p[k] = pk;
    mu[k] = mk;
    nu[k] = vk;
    if (kEma) e[k] = ema_element(e[k], pk, s);
  }
}

// first[] of n tensors cut into chunks; false when a size or the grid is out
// of range.
template <typename Table>
static bool fill_table(Table& t, const long long* numel, int n, int chunk) {
  if (n < 1 || n > kMaxTensors || chunk < 4 || chunk % 4 != 0) return false;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0) return false;
    t.n[i] = numel[i];
    t.first[i] = (int)blocks;
    blocks += (numel[i] + chunk - 1) / chunk;
    if (blocks > 0x7fffffffLL) return false;
  }
  t.first[n] = (int)blocks;
  t.count = n;
  t.chunk = chunk;
  return true;
}

}  // namespace mdgen

// The most tensors one launch takes.
extern "C" int mdgen_opt_max_tensors() { return mdgen::kMaxTensors; }

// One launch over n tensors (ptrs[n], f32, contiguous): each block's sum of
// squares to partials[offset + block]. With a counter (zero on entry; the
// call's last launch), the last block writes out[0] = sum(partials[0,
// total)) and out[1] = its root, and zeroes the counter.
extern "C" int mdgen_sum_squares(const long long* ptrs, const long long* numel, int n,
                                 int chunk, double* partials, int offset, int total,
                                 unsigned* counter, float* out, void* stream) {
  using namespace mdgen;
  SumTable t;
  if (!fill_table(t, numel, n, chunk)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) t.x[i] = reinterpret_cast<const float*>(ptrs[i]);
  const int blocks = t.first[n];
  if (blocks == 0 || offset + blocks > total) return (int)cudaErrorInvalidValue;
  sum_squares_kernel<<<blocks, kOptThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, partials, offset, total, counter, out);
  return (int)cudaGetLastError();
}

// One launch over n tensors: ptrs holds five rows of n pointers (p, g, mu,
// nu, ema; the last row is ignored without an EMA), scalars the 10 floats of
// AdamScalars in order, norm the device's global norm of the gradients and
// bc the device's two bias corrections (1 - b1^count, 1 - b2^count).
extern "C" int mdgen_fused_adam(const long long* ptrs, const long long* numel, int n, int chunk,
                                const float* norm, const float* bc, const float* scalars, int ema,
                                void* stream) {
  using namespace mdgen;
  AdamTable t;
  if (!fill_table(t, numel, n, chunk)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    t.p[i] = reinterpret_cast<float*>(ptrs[i]);
    t.g[i] = reinterpret_cast<const float*>(ptrs[n + i]);
    t.mu[i] = reinterpret_cast<float*>(ptrs[2 * n + i]);
    t.nu[i] = reinterpret_cast<float*>(ptrs[3 * n + i]);
    t.ema[i] = ema ? reinterpret_cast<float*>(ptrs[4 * n + i]) : nullptr;
  }
  static_assert(sizeof(AdamScalars) == 10 * sizeof(float), "AdamScalars is 10 packed floats");
  AdamScalars s;
  memcpy(&s, scalars, sizeof s);
  const int blocks = t.first[n];
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (ema) fused_adam_kernel<true><<<blocks, kOptThreads, 0, st>>>(t, s, norm, bc);
  else fused_adam_kernel<false><<<blocks, kOptThreads, 0, st>>>(t, s, norm, bc);
  return (int)cudaGetLastError();
}
