// Flash attention over [N, S, d] (N = batch x other axis x heads), forward
// and FlashAttention-2 backward:
//   o   = softmax(q k^T + bias) v           (q arrives pre-scaled)
//   lse = m + log(max(l, 1e-30))            (per query row)
//   dq  = sum_k ds k,   dk = sum_q ds q,   dv = sum_q p dO,   dbias = sum_q ds
//   with p = exp(s - lse), ds = p (dO v^T - delta), delta = rowsum(dO o).
//
// Replaces the TPU kernels of mdgen_tpu/ops/flash_attention.py:
//   flash_fwd_kernel (lse == nullptr)  <- _flash_attention_tpu / _flash_kernel
//   flash_fwd_kernel (lse != nullptr)  <- _flash_fwd_tpu / _flash_fwd_lse_kernel
//   flash_bwd_dq_kernel                <- _flash_bwd_tpu / _flash_bwd_dq_kernel
//   flash_bwd_dkv_kernel               <- _flash_bwd_tpu / _flash_bwd_dkv_kernel
//
// What bounds them on an H100: at the 4AA training shape (N = 8 x 4 x 16 =
// 512, Tq = 1000, Tk = 1001, d = 24) one forward is 4 N Tq Tk d = 49 GFLOP
// over 74 MB of f32 operands, dq 6 N Tq Tk d = 74 GFLOP and dk/dv 8 N Tq
// Tk d = 98 GFLOP: compute-bound. Here every product is an f32 FMA on CUDA cores
// (67 TFLOP/s peak), the simple first design; tensor cores (mma.sync /
// wgmma with d padded to 32), TMA and pipelining are later work.
//
// Design: the TPU grid walked (n, q block) in order with whole K/V rows in
// VMEM. Here one block of kTile threads owns kTile rows of one n (queries
// for the forward and dq, keys for dk/dv: the FA2 split, so no atomics);
// each thread keeps its row's vectors and accumulators in registers and
// the block streams the other side through shared memory in tiles of kTile
// rows (2 x 64 x 24 x 4 B = 12 KB at d = 24). Head widths are padded to a
// compile-time D (16, 24, 32 or 64) with zeros, which changes no sum.
//
// Semantics kept from the JAX kernels:
//   * the running max starts at finfo(f32).min, not -inf, and a masked key
//     carries bias finfo.min, so s stays finite and an all-masked tile gives
//     exp(0) terms that the first valid key's rescale wipes out, as there;
//   * the ragged edge is masked, not padded: keys past Tk and queries past
//     Tq are skipped, which is what JAX's padding gives (bias finfo.min on
//     padded keys, zero dO on padded queries) whenever a row has a valid key;
//   * inputs (f32 or bf16) are widened to f32; p stays f32 in P.V; o, dq,
//     dk and dv are rounded to the input dtype once, at the end; lse and
//     dbias are f32.
#include "common.cuh"

namespace mdgen {

constexpr int kTile = 64;   // rows per block, and rows per streamed tile
constexpr int kChunk = 16;  // keys per online-softmax rescale in the forward

__device__ __forceinline__ void from_f(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// Row `row` of a [rows, d] matrix into registers, zero-padded to D.
template <int D, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int row, int d,
                                         bool valid, float (&dst)[D]) {
#pragma unroll
  for (int c = 0; c < D; ++c)
    dst[c] = (valid && c < d) ? to_f(src[(size_t)row * d + c]) : 0.f;
}

// Rows [r0, r0 + rows) of a [*, d] matrix into a [kTile, D] f32 tile in
// shared memory; columns past d and rows past `rows` are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0, int rows,
                                          int d, float* __restrict__ dst) {
  for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    dst[e] = (r < rows && c < d) ? to_f(src[(size_t)(r0 + r) * d + c]) : 0.f;
  }
}

// a . b with a in registers and b a 16-byte aligned row in shared memory.
template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float* __restrict__ b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    const float4 w = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(a[c], w.x, s);
    s = fmaf(a[c + 1], w.y, s);
    s = fmaf(a[c + 2], w.z, s);
    s = fmaf(a[c + 3], w.w, s);
  }
  return s;
}

// acc += w * b, b a 16-byte aligned row in shared memory.
template <int D>
__device__ __forceinline__ void axpy(float w, const float* __restrict__ b, float (&acc)[D]) {
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + c);
    acc[c] = fmaf(w, x.x, acc[c]);
    acc[c + 1] = fmaf(w, x.y, acc[c + 1]);
    acc[c + 2] = fmaf(w, x.z, acc[c + 2]);
    acc[c + 3] = fmaf(w, x.w, acc[c + 3]);
  }
}

// grid (N, ceil(Tq / kTile)), kTile threads: one query row per thread.
template <typename T, int D>
__global__ void __launch_bounds__(kTile)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int d) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  __shared__ float bs[kTile];
  const int n = blockIdx.x;
  const int i = blockIdx.y * kTile + threadIdx.x;
  const bool active = i < Tq;
  const T* kn = k + (size_t)n * Tk * d;
  const T* vn = v + (size_t)n * Tk * d;
  const float* bn = bias + (size_t)n * Tk;

  float qr[D], acc[D];
  load_row<D>(q + (size_t)n * Tq * d, i, d, active, qr);
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    const int nk = min(kTile, Tk - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(kn, k0, nk, d, ks);
    load_tile<D>(vn, k0, nk, d, vs);
    if (threadIdx.x < nk) bs[threadIdx.x] = bn[k0 + threadIdx.x];
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        s[jj] = j < nk ? dot<D>(qr, ks + j * D) + bs[j] : kNegInf;
        if (j < nk) m_new = fmaxf(m_new, s[jj]);
      }
      const float scale = expf(m - m_new);
      l *= scale;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= scale;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j < nk) {
          const float p = expf(s[jj] - m_new);
          l += p;
          axpy<D>(p, vs + j * D, acc);
        }
      }
      m = m_new;
    }
  }
  if (!active) return;
  const float l_safe = fmaxf(l, 1e-30f);
  T* on = o + ((size_t)n * Tq + i) * d;
#pragma unroll
  for (int c = 0; c < D; ++c)
    if (c < d) from_f(acc[c] / l_safe, on + c);
  if (lse != nullptr) lse[(size_t)n * Tq + i] = m + logf(l_safe);
}

// grid (N, ceil(Tq / kTile)), kTile threads: one query row per thread,
// streaming K / V / bias tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kTile)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Tq, int Tk,
                    int d) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  __shared__ float bs[kTile];
  const int n = blockIdx.x;
  const int i = blockIdx.y * kTile + threadIdx.x;
  const bool active = i < Tq;
  const T* kn = k + (size_t)n * Tk * d;
  const T* vn = v + (size_t)n * Tk * d;
  const float* bn = bias + (size_t)n * Tk;

  float qr[D], dor[D], acc[D];
  load_row<D>(q + (size_t)n * Tq * d, i, d, active, qr);
  load_row<D>(dout + (size_t)n * Tq * d, i, d, active, dor);
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  const float lse_i = active ? lse[(size_t)n * Tq + i] : 0.f;
  const float delta_i = active ? delta[(size_t)n * Tq + i] : 0.f;

  for (int k0 = 0; k0 < Tk; k0 += kTile) {
    const int nk = min(kTile, Tk - k0);
    __syncthreads();
    load_tile<D>(kn, k0, nk, d, ks);
    load_tile<D>(vn, k0, nk, d, vs);
    if (threadIdx.x < nk) bs[threadIdx.x] = bn[k0 + threadIdx.x];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(dot<D>(qr, ks + j * D) + bs[j] - lse_i);
      const float ds = p * (dot<D>(dor, vs + j * D) - delta_i);
      axpy<D>(ds, ks + j * D, acc);
    }
  }
  if (!active) return;
  T* dqn = dq + ((size_t)n * Tq + i) * d;
#pragma unroll
  for (int c = 0; c < D; ++c)
    if (c < d) from_f(acc[c], dqn + c);
}

// grid (N, ceil(Tk / kTile)), kTile threads: one key row per thread,
// streaming q / dO / lse / delta tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kTile)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dbias, int Tq, int Tk, int d) {
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];
  const int n = blockIdx.x;
  const int j = blockIdx.y * kTile + threadIdx.x;
  const bool active = j < Tk;
  const T* qn = q + (size_t)n * Tq * d;
  const T* don = dout + (size_t)n * Tq * d;

  float kr[D], vr[D], dkr[D], dvr[D];
  load_row<D>(k + (size_t)n * Tk * d, j, d, active, kr);
  load_row<D>(v + (size_t)n * Tk * d, j, d, active, vr);
#pragma unroll
  for (int c = 0; c < D; ++c) dkr[c] = dvr[c] = 0.f;
  const float b = active ? bias[(size_t)n * Tk + j] : 0.f;
  float db = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += kTile) {
    const int nq = min(kTile, Tq - q0);
    __syncthreads();
    load_tile<D>(qn, q0, nq, d, qs);
    load_tile<D>(don, q0, nq, d, dos);
    if (threadIdx.x < nq) {
      ls[threadIdx.x] = lse[(size_t)n * Tq + q0 + threadIdx.x];
      dls[threadIdx.x] = delta[(size_t)n * Tq + q0 + threadIdx.x];
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < nq; ++r) {
      const float p = expf(dot<D>(kr, qs + r * D) + b - ls[r]);
      axpy<D>(p, dos + r * D, dvr);
      const float ds = p * (dot<D>(vr, dos + r * D) - dls[r]);
      axpy<D>(ds, qs + r * D, dkr);
      db += ds;
    }
  }
  if (!active) return;
  T* dkn = dk + ((size_t)n * Tk + j) * d;
  T* dvn = dv + ((size_t)n * Tk + j) * d;
#pragma unroll
  for (int c = 0; c < D; ++c)
    if (c < d) {
      from_f(dkr[c], dkn + c);
      from_f(dvr[c], dvn + c);
    }
  dbias[(size_t)n * Tk + j] = db;
}

// Everything one launch needs; each entry point fills what its kernel reads.
struct FlashArgs {
  const void *q, *k, *v, *dout;
  const float *bias, *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float *lse_out, *dbias;
  int N, Tq, Tk, d;
};

inline dim3 grid_for(int N, int rows) { return dim3(N, (rows + kTile - 1) / kTile); }

template <typename T, int D>
cudaError_t run_fwd(const FlashArgs& a, cudaStream_t s) {
  flash_fwd_kernel<T, D><<<grid_for(a.N, a.Tq), kTile, 0, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias, (T*)a.o, a.lse_out, a.Tq,
      a.Tk, a.d);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dq(const FlashArgs& a, cudaStream_t s) {
  flash_bwd_dq_kernel<T, D><<<grid_for(a.N, a.Tq), kTile, 0, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias, (const T*)a.dout, a.lse_in,
      a.delta, (T*)a.dq, a.Tq, a.Tk, a.d);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkv(const FlashArgs& a, cudaStream_t s) {
  flash_bwd_dkv_kernel<T, D><<<grid_for(a.N, a.Tk), kTile, 0, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias, (const T*)a.dout, a.lse_in,
      a.delta, (T*)a.dk, (T*)a.dv, a.dbias, a.Tq, a.Tk, a.d);
  return cudaGetLastError();
}

// RUN<T, D> for the input dtype and the smallest padded width D >= d;
// d outside 1..64 is refused.
#define MDGEN_FLASH_DISPATCH(RUN)                                  \
  do {                                                              \
    if (a.d <= 0 || a.d > 64) return cudaErrorInvalidValue;         \
    if (bf16) {                                                     \
      if (a.d <= 16) return RUN<__nv_bfloat16, 16>(a, s);           \
      if (a.d <= 24) return RUN<__nv_bfloat16, 24>(a, s);           \
      if (a.d <= 32) return RUN<__nv_bfloat16, 32>(a, s);           \
      return RUN<__nv_bfloat16, 64>(a, s);                          \
    }                                                               \
    if (a.d <= 16) return RUN<float, 16>(a, s);                     \
    if (a.d <= 24) return RUN<float, 24>(a, s);                     \
    if (a.d <= 32) return RUN<float, 32>(a, s);                     \
    return RUN<float, 64>(a, s);                                    \
  } while (0)

}  // namespace mdgen

// q [N, Tq, d], k / v [N, Tk, d] (f32, or bf16 when bf16 != 0), bias [N, Tk]
// f32 -> o [N, Tq, d] in the input dtype; lse [N, Tq] f32 when not null.
extern "C" int mdgen_flash_fwd(const void* q, const void* k, const void* v,
                               const float* bias, void* o, float* lse, int N, int Tq,
                               int Tk, int d, int bf16, void* stream) {
  using namespace mdgen;
  const auto s = static_cast<cudaStream_t>(stream);
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.o = o, a.lse_out = lse;
  a.N = N, a.Tq = Tq, a.Tk = Tk, a.d = d;
  MDGEN_FLASH_DISPATCH(run_fwd);
}

// + dout [N, Tq, d] in the input dtype, lse / delta [N, Tq] f32 -> dq.
extern "C" int mdgen_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const float* bias, const void* dout, const float* lse,
                                  const float* delta, void* dq, int N, int Tq, int Tk,
                                  int d, int bf16, void* stream) {
  using namespace mdgen;
  const auto s = static_cast<cudaStream_t>(stream);
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout, a.lse_in = lse;
  a.delta = delta, a.dq = dq, a.N = N, a.Tq = Tq, a.Tk = Tk, a.d = d;
  MDGEN_FLASH_DISPATCH(run_dq);
}

// The same inputs -> dk, dv [N, Tk, d] in the input dtype, dbias [N, Tk] f32.
extern "C" int mdgen_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const float* bias, const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv, float* dbias,
                                   int N, int Tq, int Tk, int d, int bf16, void* stream) {
  using namespace mdgen;
  const auto s = static_cast<cudaStream_t>(stream);
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout, a.lse_in = lse;
  a.delta = delta, a.dk = dk, a.dv = dv, a.dbias = dbias;
  a.N = N, a.Tq = Tq, a.Tk = Tk, a.d = d;
  MDGEN_FLASH_DISPATCH(run_dkv);
}
