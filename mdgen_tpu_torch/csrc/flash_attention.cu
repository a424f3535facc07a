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
// All four run on the tensor cores with mma.sync: a block is 4 warps of 16
// own rows. Its own operands (q for the forward; q, dO for dq; k, v for
// dk/dv) stay in shared memory for the whole loop; the streamed pair (k, v;
// or q, dO) and its f32 row vectors come in by cp.async through a ring of
// two stages, the next tile in flight while the current one multiplies. Per
// tile a warp computes S = X U^T (and for the backward dP = Y W^T) with
// WarpMma (the streamed rows as [n][k], no transpose), then P (and dS) in
// its registers, which are the A operand of O += P V, dQ += dS K, or of
// dV += P^T dO and dK += dS^T q (WarpMmaAccA, the streamed tile read
// transposed). bf16 operands run m16n8k16 fed by ldmatrix, with P and dS
// kept in f32 as the JAX kernels keep them: each enters as a pair of bf16
// fragments, hi + lo, two MMAs where FA2 rounds to bf16 and takes one; f32
// operands run split TF32 (three TF32 products per f32 one), f32-exact to
// about 2^-21 of a product. The reduction over d is padded with zeros to a
// whole k step (8 for TF32, 16 for bf16), which changes no sum; outputs take
// d rounded up to 8. Every sum runs in a fixed order (dbias and the
// forward's l per thread, then across the quad): no atomics,
// bit-deterministic. Row strides of D + 4 floats (D + 8 bf16) keep both
// read orders of a tile free of bank conflicts.
//
// The forward (kernels 4, 5): 4 N Tq Tk d = 49 GFLOP at the recipe shape,
// 0.29 ms at split TF32's 165 TFLOP/s, 0.048 ms at bf16's 989; but it also
// takes one exp per (query, key) pair, 5.1e8 of them, and the SFU's ex2
// does 16 a clock on each of 132 SMs, about 3.9e12 a second: 0.12 to 0.14
// ms for the exps alone. With bf16 operands the softmax, not the MMAs, sets
// the floor. So each score costs one ex2 and no more (__expf: a multiply
// and ex2.approx; expf would add a range reduction of some ten
// instructions), the running max and l are rescaled once per 64-key tile
// (two exps a thread per tile, not one per key), the quad reduces the max
// with two shuffles and l once, at the end, and 4 warps a block and 4 to
// 5 blocks an SM keep the SFU busy while other warps multiply. In f32,
// split TF32 takes three MMAs a product and each warp splits its operands
// itself (about 950 instructions a warp per 64-key tile, counted from the
// source): as in the backward, instruction throughput rather than the MMAs
// is the likely limit (an inference: no stall counters were read). Measured at the
// recipe shape on an H100 at 700 W: 1.23 ms in f32, 0.68 ms with bf16
// operands; keeping P in f32 (hi + lo) costs 0.045 ms of the 0.68 (a build
// of the kernel with P in bf16, timed against this one).
//
// Semantics kept from the JAX kernels:
//   * the running max starts at finfo(f32).min, not -inf, and a masked key
//     carries bias finfo.min, so s stays finite and an all-masked tile gives
//     exp(0) terms that the first valid key's rescale wipes out, as there
//     (m and m_new stay finite, so m - m_new is never NaN, and __expf gives
//     0 for it at the first valid key after masked ones);
//   * the ragged edge is masked, not padded: keys past Tk and queries past
//     Tq are skipped, which is what JAX's padding gives (bias finfo.min on
//     padded keys, zero dO on padded queries) whenever a row has a valid key;
//     keys past Tk, whose zero-filled rows would otherwise give exp(b - m) or
//     exp(b - lse), get p = 0 explicitly, and so do queries past Tq in the
//     backward;
//   * inputs (f32 or bf16) are widened to f32 (p stays f32 in P V); every
//     sum is f32; o, dq, dk and dv are rounded to the input dtype once, at
//     the end; lse and dbias are f32.
#include "flash_tile.cuh"

namespace mdgen {

// -- forward (kernels 4 and 5) --------------------------------------------------

// The forward keeps S (32 floats) and O (DN / 2) in registers across a tile:
// 4 blocks an SM (at most 128 registers a thread) for every width, none of
// which spills. At the recipe shape 2 blocks an SM made f32 1.07x slower
// and 6 (80 registers, spills) bf16 1.03x slower, on an H100 at 700 W.
constexpr int kFwdMinBlocks = 4;

// grid (N, ceil(Tq / 64)), 4 warps, each owning 16 queries; keys streamed in
// tiles of 64 (U = k, W = v, vector: the key bias). D: the reduction over d
// padded to a k step; DN: output columns, d rounded up to 8.
template <typename T, int D, int DN>
__global__ void __launch_bounds__(kFlashWarps * 32, kFwdMinBlocks)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
                 int Tq, int Tk, int d, int vec) {
  using S = FlashSmem<T, D>;
  constexpr int ld = S::ld, NT = kFlashRows / 8, NO = DN / 8;
  static_assert(DN <= D && DN % 8 == 0, "output tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);

  const int n = blockIdx.x, row0 = blockIdx.y * kFlashRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* kn = k + (size_t)n * Tk * d;
  const T* vn = v + (size_t)n * Tk * d;
  const float* bias_n = bias + (size_t)n * Tk;

  stage_tile<T, D>(qs, q + (size_t)n * Tq * d, row0, min(kFlashRows, Tq - row0), d, vec);
  auto load = [&](int it) {
    stage_streamed<T, D>(S::stage(smem_raw, 1, it % kFlashStages), kn, vn, bias_n, nullptr, it,
                         Tk, d, vec);
  };

  // rows g and g + 8 of the warp's 16 (h = 0, 1): running max, this
  // thread's part of l (its columns 2t, 2t + 1 of each n8 tile), and O
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int ntiles = (Tk + kFlashRows - 1) / kFlashRows;
  load(0);
  cp_async_commit();  // the own rows and the first tile
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile it has landed
    __syncthreads();
    const T* ks = reinterpret_cast<const T*>(S::stage(smem_raw, 1, it % kFlashStages));
    const T* vs = ks + S::tile;
    const float* bs = reinterpret_cast<const float*>(vs + S::tile);
    const int nc = min(kFlashRows, Tk - it * kFlashRows);

    float s[1][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[0][j][i] = 0.f;
    WarpMma<T, 1, NT, D>::run(s, qs + warp * 16 * ld, ld, ks, ld);

    // s + bias, and the row max over the tile's valid keys: this thread's
    // 16 values, then the quad's (lanes 4g .. 4g + 3 hold the same rows)
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
        const int h = i >> 1, c = j * 8 + 2 * t + (i & 1);
        s[0][j][i] += bs[c];
        if (c < nc) m_new[h] = fmaxf(m_new[h], s[0][j][i]);
      }
    float scale[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      scale[h] = __expf(m[h] - m_new[h]);
      l[h] *= scale[h];
      m[h] = m_new[h];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= scale[i >> 1];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, c = j * 8 + 2 * t + (i & 1);
        const float p = c < nc ? __expf(s[0][j][i] - m[h]) : 0.f;
        l[h] += p;
        s[0][j][i] = p;
      }
    WarpMmaAccA<T, NT, NO>::run(acc, s[0], vs, ld);  // O += P V
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);  // the quad's four parts, in a fixed order
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = row0 + warp * 16 + g + 8 * h;
    if (r >= Tq) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    T* on = o + ((size_t)n * Tq + r) * d;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        if (c < d) on[c] = from_f<T>(acc[j][2 * h + e] / l_safe);
      }
    if (lse != nullptr && t == 0) lse[(size_t)n * Tq + r] = m[h] + logf(l_safe);
  }
}

// -- backward (kernels 6 and 7) -------------------------------------------------

// The kernels run about ten instructions per MMA, so instruction throughput
// bounds them: split_tf32's half-ulp split (3 instructions an operand, where
// cvt.rna takes about 5) made dq 1.41x and dk/dv 1.42x faster in f32, and 4
// blocks an SM (at most 128 registers a thread) 1.08x and 1.05x more, at
// the recipe shape on an H100 at 700 W. At 128 registers outputs 48 or 64
// wide spill, and so do bf16 outputs 32 wide (P and dS enter as two
// fragments each): they take 2 blocks an SM.
template <typename T, int DN>
constexpr int kBwdMinBlocks = DN <= (sizeof(T) == 2 ? 24 : 32) ? 4 : 2;

// grid (N, ceil(own rows / 64)), 4 warps. kDkv false: dq, own rows queries
// (X = q, Y = dO), streamed keys (U = k, W = v, vector: bias). kDkv true:
// dk, dv, dbias, own rows keys (X = k, Y = v), streamed queries (U = q,
// W = dO, vectors: lse, delta). D: the reduction over d padded to a k step;
// DN: output columns, d rounded up to 8.
template <typename T, int D, int DN, bool kDkv>
__global__ void __launch_bounds__(kFlashWarps * 32, kBwdMinBlocks<T, DN>)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ out1, T* __restrict__ out2, float* __restrict__ dbias, int Tq,
                 int Tk, int d, int vec) {
  using S = FlashSmem<T, D>;
  constexpr int ld = S::ld, NT = kFlashRows / 8, NO = DN / 8;
  static_assert(DN <= D && DN % 8 == 0, "output tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ys = xs + S::tile;

  const int n = blockIdx.x, row0 = blockIdx.y * kFlashRows;
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

  stage_tile<T, D>(xs, X, row0, min(kFlashRows, own_total - row0), d, vec);
  stage_tile<T, D>(ys, Y, row0, min(kFlashRows, own_total - row0), d, vec);
  auto load = [&](int it) {
    stage_streamed<T, D>(S::stage(smem_raw, 2, it % kFlashStages), U, W,
                         kDkv ? lse_n : bias_n, kDkv ? delta_n : nullptr, it, cols_total, d,
                         vec);
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

  const int ntiles = (cols_total + kFlashRows - 1) / kFlashRows;
  load(0);
  cp_async_commit();  // the own rows and the first tile
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile it has landed
    __syncthreads();
    const T* us = reinterpret_cast<const T*>(S::stage(smem_raw, 2, it % kFlashStages));
    const T* ws = us + S::tile;
    const float* cv = reinterpret_cast<const float*>(ws + S::tile);
    const int nc = min(kFlashRows, cols_total - it * kFlashRows);

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
          dl = cv[kFlashRows + c];
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

// -- launch -----------------------------------------------------------------------

// Everything one launch needs; each entry point fills what its kernel reads.
struct FlashArgs {
  const void *q, *k, *v, *dout;
  const float *bias, *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float *lse_out, *dbias;
  int N, Tq, Tk, d;
};

inline dim3 grid_for(int N, int rows) { return dim3(N, (rows + kFlashRows - 1) / kFlashRows); }

// Whole rows of 16 bytes, every operand on 16 bytes: cp.async copies.
template <typename T> int vec_rows(const FlashArgs& a) {
  return (a.d * sizeof(T)) % 16 == 0 && on16(a.q) && on16(a.k) && on16(a.v) && on16(a.dout);
}

struct RunFwd {
  template <typename T, int D, int DN> static cudaError_t run(const FlashArgs& a, cudaStream_t s) {
    constexpr size_t bytes = FlashSmem<T, D>::bytes(1);
    static bool smem_set = false;
    auto kernel = flash_fwd_kernel<T, D, DN>;
    cudaError_t e = allow_smem(kernel, bytes, smem_set);
    if (e != cudaSuccess) return e;
    kernel<<<grid_for(a.N, a.Tq), kFlashWarps * 32, bytes, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias, (T*)a.o, a.lse_out, a.Tq, a.Tk,
        a.d, vec_rows<T>(a));
    return cudaGetLastError();
  }
};

template <bool kDkv> struct RunBwd {
  template <typename T, int D, int DN> static cudaError_t run(const FlashArgs& a, cudaStream_t s) {
    constexpr size_t bytes = FlashSmem<T, D>::bytes(2);
    static bool smem_set = false;
    auto kernel = flash_bwd_kernel<T, D, DN, kDkv>;
    cudaError_t e = allow_smem(kernel, bytes, smem_set);
    if (e != cudaSuccess) return e;
    kernel<<<grid_for(a.N, kDkv ? a.Tk : a.Tq), kFlashWarps * 32, bytes, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, a.bias, (const T*)a.dout, a.lse_in,
        a.delta, (T*)(kDkv ? a.dk : a.dq), (T*)a.dv, a.dbias, a.Tq, a.Tk, a.d, vec_rows<T>(a));
    return cudaGetLastError();
  }
};

}  // namespace mdgen

// q [N, Tq, d], k / v [N, Tk, d] (f32, or bf16 when bf16 != 0), bias [N, Tk]
// f32 -> o [N, Tq, d] in the input dtype; lse [N, Tq] f32 when not null.
extern "C" int mdgen_flash_fwd(const void* q, const void* k, const void* v,
                               const float* bias, void* o, float* lse, int N, int Tq,
                               int Tk, int d, int bf16, void* stream) {
  using namespace mdgen;
  FlashArgs a{};
  a.q = q, a.k = k, a.v = v, a.bias = bias, a.o = o, a.lse_out = lse;
  a.N = N, a.Tq = Tq, a.Tk = Tk, a.d = d;
  return run_for<RunFwd>(a, d, bf16 != 0, static_cast<cudaStream_t>(stream));
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
  return run_for<RunBwd<false>>(a, d, bf16 != 0, static_cast<cudaStream_t>(stream));
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
  return run_for<RunBwd<true>>(a, d, bf16 != 0, static_cast<cudaStream_t>(stream));
}
