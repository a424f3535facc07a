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
//   flash_bwd_kernel<.., kDkv = false>  <- _flash_bwd_tpu / _flash_bwd_dq_kernel
//   flash_bwd_kernel<.., kDkv = true>   <- _flash_bwd_tpu / _flash_bwd_dkv_kernel
//
// What bounds them on an H100: at the 4AA training shape (N = 8 x 4 x 16 =
// 512, Tq = 1000, Tk = 1001, d = 24) one forward is 4 N Tq Tk d = 49 GFLOP
// over 74 MB of f32 operands, dq 6 N Tq Tk d = 74 GFLOP and dk/dv 8 N Tq
// Tk d = 98 GFLOP: compute-bound, even on the tensor cores.
//
// The TPU grid walked (n, q block) in order with whole K/V rows in VMEM.
// Here a block owns 64 rows of one n (queries for the forward and dq, keys
// for dk/dv: the FA2 split, so no atomics) and streams the other side
// through shared memory in tiles of 64 rows.
//
// Forward (kernels 4, 5): one thread per query row, every product an f32
// FMA on CUDA cores (67 TFLOP/s); head widths padded to 16, 24, 32 or 64.
//
// Backward (kernels 6, 7), on the tensor cores with mma.sync: a block is 4
// warps of 16 own rows. Its own two operands (q, dO for dq; k, v for dk/dv)
// stay in shared memory for the whole loop; the streamed pair comes in by
// cp.async through a ring of two stages, the next tile in flight while the
// current one multiplies. Per tile a warp computes S = X U^T and dP = Y W^T
// with WarpMma (the streamed rows as [n][k], no transpose), then P and dS in
// its registers, which are the A operand of dQ += dS K, or of dV += P^T dO
// and dK += dS^T q (WarpMmaAccA, the streamed tile read transposed). bf16
// operands run m16n8k16 fed by ldmatrix, with P and dS kept in f32 as the
// JAX kernels keep them: each enters as a pair of bf16 fragments, hi + lo,
// two MMAs where FA2 rounds to bf16 and takes one; f32 operands run split
// TF32 (three TF32 products per f32 one), f32-exact to about 2^-21 of a
// product. The reduction over d is padded
// with zeros to a whole k step (8 for TF32, 16 for bf16), which changes no
// sum; outputs take d rounded up to 8. dbias sums in each thread's
// registers and then across the quad in a fixed order: no atomics,
// bit-deterministic. Row strides of D + 4 floats (D + 8 bf16) keep both
// read orders of a tile free of bank conflicts.
//
// Semantics kept from the JAX kernels:
//   * the running max starts at finfo(f32).min, not -inf, and a masked key
//     carries bias finfo.min, so s stays finite and an all-masked tile gives
//     exp(0) terms that the first valid key's rescale wipes out, as there;
//   * the ragged edge is masked, not padded: keys past Tk and queries past
//     Tq are skipped, which is what JAX's padding gives (bias finfo.min on
//     padded keys, zero dO on padded queries) whenever a row has a valid key;
//   * inputs (f32 or bf16) are widened to f32 (the forward's p stays f32
//     in P.V); every sum is f32; o, dq, dk and dv are rounded to the input
//     dtype once, at the end; lse and dbias are f32.
//   * the backward gives p = 0 explicitly to keys past Tk and queries past
//     Tq, whose zero-filled rows would otherwise give exp(b - lse).
#include "mma_tile.cuh"

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

// -- backward (kernels 6 and 7) -------------------------------------------------

constexpr int kBwdRows = 64;  // own rows of a block (16 a warp), rows of a streamed tile
constexpr int kBwdWarps = kBwdRows / 16;
constexpr int kBwdStages = 2;
// The kernels run about ten instructions per MMA, so instruction throughput
// bounds them: split_tf32's half-ulp split (3 instructions an operand, where
// cvt.rna takes about 5) made dq 1.41x and dk/dv 1.42x faster in f32, and 4
// blocks an SM (at most 128 registers a thread) 1.08x and 1.05x more, at
// the recipe shape on an H100 at 700 W. At 128 registers outputs 48 or 64
// wide spill, and so do bf16 outputs 32 wide (P and dS enter as two
// fragments each): they take 2 blocks an SM.
template <typename T, int DN>
constexpr int kBwdMinBlocks = DN <= (sizeof(T) == 2 ? 24 : 32) ? 4 : 2;

// Shared memory of a backward block: the own rows X, Y; then per stage the
// streamed rows U, W and two f32 vectors over the streamed rows (lse and
// delta for dk/dv, the key bias for dq). Every part starts on 16 bytes.
template <typename T, int D> struct BwdSmem {
  static constexpr int ld = D + smem_pad<T>();
  static constexpr int tile = kBwdRows * ld;  // elements
  static constexpr size_t stage_bytes = 2 * tile * sizeof(T) + 2 * kBwdRows * sizeof(float);
  static constexpr size_t bytes = 2 * tile * sizeof(T) + kBwdStages * stage_bytes;
};

// Rows [r0, r0 + rows) of a [*, d] matrix into a [kBwdRows][D + pad] tile;
// rows past `rows` and columns past d are zero. With vec, 16-byte cp.async
// copies (d * sizeof(T) % 16 == 0 and src on 16 bytes); else element by
// element through registers (any d, any alignment).
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int r0, int rows,
                                           int d, bool vec) {
  if (vec) {
    stage_rows<T, kBwdRows, D>(
        dst, [&](int r) -> const T* { return r < rows ? src + (size_t)(r0 + r) * d : nullptr; },
        src, 0, d);
    return;
  }
  constexpr int ld = BwdSmem<T, D>::ld;
  for (int i = threadIdx.x; i < kBwdRows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r < rows && c < d) ? src[(size_t)(r0 + r) * d + c] : from_f<T>(0.f);
  }
}

// grid (N, ceil(own rows / 64)), 4 warps. kDkv false: dq, own rows queries
// (X = q, Y = dO), streamed keys (U = k, W = v, vector: bias). kDkv true:
// dk, dv, dbias, own rows keys (X = k, Y = v), streamed queries (U = q,
// W = dO, vectors: lse, delta). D: the reduction over d padded to a k step;
// DN: output columns, d rounded up to 8.
template <typename T, int D, int DN, bool kDkv>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks<T, DN>)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ out1, T* __restrict__ out2, float* __restrict__ dbias, int Tq,
                 int Tk, int d, int vec) {
  using S = BwdSmem<T, D>;
  constexpr int ld = S::ld, NT = kBwdRows / 8, NO = DN / 8;
  static_assert(DN <= D && DN % 8 == 0, "output tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ys = xs + S::tile;
  auto stage = [&](int s) { return smem_raw + 2 * S::tile * sizeof(T) + s * S::stage_bytes; };

  const int n = blockIdx.x, row0 = blockIdx.y * kBwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int own_total = kDkv ? Tk : Tq, cols_total = kDkv ? Tq : Tk;
  const size_t q_off = (size_t)n * Tq * d, k_off = (size_t)n * Tk * d;
  const T* X = kDkv ? k + k_off : q + q_off;
  const T* Y = kDkv ? v + k_off : dout + q_off;
  const T* U = kDkv ? q + q_off : k + k_off;
  const T* W = kDkv ? dout + q_off : v + k_off;
  const float* lse_n = lse + (size_t)n * Tq;
  const float* delta_n = delta + (size_t)n * Tq;
  const float* bias_n = bias + (size_t)n * Tk;

  stage_tile<T, D>(xs, X, row0, min(kBwdRows, own_total - row0), d, vec);
  stage_tile<T, D>(ys, Y, row0, min(kBwdRows, own_total - row0), d, vec);
  auto load = [&](int it) {
    const int c0 = it * kBwdRows, nc = min(kBwdRows, cols_total - c0);
    unsigned char* st = stage(it % kBwdStages);
    T* us = reinterpret_cast<T*>(st);
    float* cv = reinterpret_cast<float*>(us + 2 * S::tile);
    stage_tile<T, D>(us, U, c0, nc, d, vec);
    stage_tile<T, D>(us + S::tile, W, c0, nc, d, vec);
    for (int i = threadIdx.x; i < kBwdRows; i += blockDim.x) {
      const bool ok = i < nc;
      const int c = ok ? c0 + i : 0;
      if constexpr (kDkv) {
        cp_async4(cv + i, lse_n + c, ok);
        cp_async4(cv + kBwdRows + i, delta_n + c, ok);
      } else {
        cp_async4(cv + i, bias_n + c, ok);
      }
    }
  };

  // this thread's own rows g and g + 8 of the warp: validity, and the row
  // terms (dk/dv: the key's bias; dq: the query's lse and delta)
  bool row_ok[2];
  float row_b[2], row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + g + 8 * h;
    row_ok[h] = r < own_total;
    row_b[h] = kDkv && row_ok[h] ? bias_n[r] : 0.f;
    row_lse[h] = !kDkv && row_ok[h] ? lse_n[r] : 0.f;
    row_delta[h] = !kDkv && row_ok[h] ? delta_n[r] : 0.f;
  }

  float o1[NO][4], o2[NO][4], db[2] = {0.f, 0.f};  // dk or dq; dv; dbias
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o1[j][i] = o2[j][i] = 0.f;

  const int ntiles = (cols_total + kBwdRows - 1) / kBwdRows;
  load(0);
  cp_async_commit();  // the own rows and the first tile
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile it has landed
    __syncthreads();
    const T* us = reinterpret_cast<const T*>(stage(it % kBwdStages));
    const T* ws = us + S::tile;
    const float* cv = reinterpret_cast<const float*>(ws + S::tile);
    const int nc = min(kBwdRows, cols_total - it * kBwdRows);

    float s[1][NT][4], dp[1][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[0][j][i] = dp[0][j][i] = 0.f;
    WarpMma<T, 1, NT, D>::run(s, xs + warp * 16 * ld, ld, us, ld);   // S (or S^T)
    WarpMma<T, 1, NT, D>::run(dp, ys + warp * 16 * ld, ld, ws, ld);  // dP (or dP^T)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
        const int h = i >> 1, c = j * 8 + 2 * t + (i & 1);
        float x, dl;
        if constexpr (kDkv) {
          x = s[0][j][i] + row_b[h] - cv[c];  // (s + b) - lse, as the JAX kernel
          dl = cv[kBwdRows + c];
        } else {
          x = s[0][j][i] + cv[c] - row_lse[h];
          dl = row_delta[h];
        }
        const float p = (c < nc && row_ok[h]) ? __expf(x) : 0.f;
        const float ds = p * (dp[0][j][i] - dl);
        s[0][j][i] = p;
        dp[0][j][i] = ds;
        if constexpr (kDkv) db[h] += ds;
      }
    if constexpr (kDkv) WarpMmaAccA<T, NT, NO>::run(o2, s[0], ws, ld);  // dV += P^T dO
    WarpMmaAccA<T, NT, NO>::run(o1, dp[0], us, ld);  // dK += dS^T q, or dQ += dS k
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (kDkv) {  // the quad's four column sums, in a fixed order
      db[h] += __shfl_xor_sync(0xffffffffu, db[h], 1);
      db[h] += __shfl_xor_sync(0xffffffffu, db[h], 2);
    }
    if (!row_ok[h]) continue;
    const size_t r = (size_t)n * own_total + row0 + warp * 16 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        if (c >= d) continue;
        out1[r * d + c] = from_f<T>(o1[j][2 * h + e]);
        if constexpr (kDkv) out2[r * d + c] = from_f<T>(o2[j][2 * h + e]);
      }
    if (kDkv && t == 0) dbias[r] = db[h];
  }
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

inline bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int D, int DN, bool kDkv>
cudaError_t run_bwd(const FlashArgs& a, cudaStream_t s) {
  static_assert(kTile == kBwdRows, "one grid for both directions");
  constexpr size_t bytes = BwdSmem<T, D>::bytes;
  static bool smem_set = false;
  auto kernel = flash_bwd_kernel<T, D, DN, kDkv>;
  cudaError_t e = allow_smem(kernel, bytes, smem_set);
  if (e != cudaSuccess) return e;
  const int vec = (a.d * sizeof(T)) % 16 == 0 && on16(a.q) && on16(a.k) && on16(a.v) &&
                  on16(a.dout);
  kernel<<<grid_for(a.N, kDkv ? a.Tk : a.Tq), kBwdWarps * 32, bytes, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias, (const T*)a.dout, a.lse_in,
      a.delta, (T*)(kDkv ? a.dk : a.dq), (T*)a.dv, a.dbias, a.Tq, a.Tk, a.d, vec);
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

// The backward for the input dtype, its output width DN (d rounded up to 8,
// then to 16, 24, 32, 48 or 64) and the reduction D (DN rounded up to a
// TF32 k8 step, or to a bf16 k16 step).
template <bool kDkv>
cudaError_t run_bwd_for(const FlashArgs& a, bool bf16, cudaStream_t s) {
  using B = __nv_bfloat16;
  if (a.d <= 0 || a.d > 64) return cudaErrorInvalidValue;
  if (bf16) {
    if (a.d <= 8) return run_bwd<B, 16, 8, kDkv>(a, s);
    if (a.d <= 16) return run_bwd<B, 16, 16, kDkv>(a, s);
    if (a.d <= 24) return run_bwd<B, 32, 24, kDkv>(a, s);
    if (a.d <= 32) return run_bwd<B, 32, 32, kDkv>(a, s);
    if (a.d <= 48) return run_bwd<B, 48, 48, kDkv>(a, s);
    return run_bwd<B, 64, 64, kDkv>(a, s);
  }
  if (a.d <= 8) return run_bwd<float, 8, 8, kDkv>(a, s);
  if (a.d <= 16) return run_bwd<float, 16, 16, kDkv>(a, s);
  if (a.d <= 24) return run_bwd<float, 24, 24, kDkv>(a, s);
  if (a.d <= 32) return run_bwd<float, 32, 32, kDkv>(a, s);
  if (a.d <= 48) return run_bwd<float, 48, 48, kDkv>(a, s);
  return run_bwd<float, 64, 64, kDkv>(a, s);
}

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
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout, a.lse_in = lse;
  a.delta = delta, a.dq = dq, a.N = N, a.Tq = Tq, a.Tk = Tk, a.d = d;
  return run_bwd_for<false>(a, bf16 != 0, static_cast<cudaStream_t>(stream));
}

// The same inputs -> dk, dv [N, Tk, d] in the input dtype, dbias [N, Tk] f32.
extern "C" int mdgen_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const float* bias, const void* dout, const float* lse,
                                   const float* delta, void* dk, void* dv, float* dbias,
                                   int N, int Tq, int Tk, int d, int bf16, void* stream) {
  using namespace mdgen;
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.dout = dout, a.lse_in = lse;
  a.delta = delta, a.dk = dk, a.dv = dv, a.dbias = dbias;
  a.N = N, a.Tq = Tq, a.Tk = Tk, a.d = d;
  return run_bwd_for<true>(a, bf16 != 0, static_cast<cudaStream_t>(stream));
}
