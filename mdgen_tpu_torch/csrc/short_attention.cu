// Attention over a short axis with its backward: the residue attention of
// the train step (RoPEAttention over axis 2 and the IPA tower's 3-D call),
// each (b, t) row's L <= 16 residues plus the learned bias key, in float32.
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA's
// einsums, and the port's dense route runs it as cuBLAS batched products of
// 4 x hd by hd x 5 matrices (one per row and head) with permute copies, the
// cat of the bias key and value, RoPE and the softmax around them, forward
// and backward: some 30 launches a layer. The forward half is the attention
// of kernel 1 (fused_l_sublayer.cu) read from a projection that is already
// made; the backward is new.
//
// What bounds it on an H100: bytes. With L + 1 <= 17 keys a query does a few
// hundred multiply-adds against the 4 hd bytes of each of q, k, v and o it
// touches. Forward: read q, k and v straight from the packed qkv projection
// [rows, L, 3C] and write o [rows, L, C]; backward: read qkv and dO, write
// one packed dqkv [rows, L, 3C] for the projection's backward. At the 4AA
// step (8,000 rows of L = 4, C = 384, f32) that is 4 x 49.2 MB forward and
// 7 x 49.2 MB backward a layer: 59 us and 103 us at 3.35 TB/s.
//
// Design:
//   * a block takes a tile of rows (16 tokens: 4 rows of 4 residues) and a
//     group of G heads (GW = G hd <= 128 columns; a wider head stays on the
//     model's dense route), so that each token's q, k, v (and dO) of the
//     group are contiguous runs of global memory; grid (tiles, head groups);
//     a thread a column (a warp multiple, at most 128 threads);
//   * the tile comes into shared memory by cp.async, 16 bytes a copy where
//     the rows allow it, every copy in flight at once; then one pass scales
//     q by hd^-0.5 and ropes q and k at their residue's position (the ESM
//     tables of ops.rope_tables); the bias key, roped at position L, and
//     bias_v sit after the tile's keys and values;
//   * forward: the logits per (token, head, key) (finfo.min where the key
//     mask is 0; the bias key is always kept), the f32 softmax per (token,
//     head), P.V per (column, token); nothing is saved but the operands
//     (the backward recomputes the softmax from qkv);
//   * backward: the logits and dP = dO.V per (token, head, key), then P and
//     dS = P (dP - rowsum(P dP)) per (token, head), then per channel pair
//     dq = dS K and dk = dS^T Q with RoPE's transpose (and the q scale)
//     applied before the store, and per column pair dv = P^T dO;
//   * the gradients of bias_k and bias_v: each block sums its tiles' rows in
//     a fixed order into partials [row blocks, 2, C] (a block walking tiles
//     blockIdx.x, + gridDim.x, ...); a second launch sums the partials in a
//     fixed order (32 strided runs, then the runs in order) and applies
//     RoPE's transpose at position L. No atomics: the same bits from run to
//     run.
// Every sum is float32 (no TF32, no tensor cores), launched on the caller's
// stream, with no allocation and no host synchronisation.
#include <stdint.h>

#include "mma_tile.cuh"

namespace mdgen {

constexpr int kShortMaxL = 16;  // residues; keys are L + 1 with the bias key
// the most columns of a head group, so the widest head (SHORT_ATTN_MAX_HEAD_DIM
// in ops), and the most threads a block
constexpr int kShortGroupWidth = 128;

struct ShortShape {
  int rows, T, L, H, hd, G;  // G heads a block
  int rb;                    // rows a tile
  int ld;                    // the stride of a staged token's row: G hd + 4
  long long mb, mt, ml;      // the key mask's strides in elements (batch, frame, residue)
  int use_rope, vec;         // vec: every staged run is 16-byte aligned
  float q_scale;
};

// Heads a block: the most that divide H and fit kShortGroupWidth columns.
inline int short_heads_per_block(int H, int hd) {
  int G = 1;
  for (int g = 1; g <= H; ++g)
    if (H % g == 0 && g * hd <= kShortGroupWidth) G = g;
  return G;
}

inline int short_threads(const ShortShape& s) {
  return min(kShortGroupWidth, (s.G * s.hd + 31) / 32 * 32);
}

// Shared memory, in floats: q, k, v [TB + 1][ld] (the bias key and value in
// k's and v's last row) and, backward, dO [TB][ld]; then the logits or P
// [TB][G][L + 1] and, backward, dP or dS [TB][G][L + 1] and the bias
// accumulators [2 G hd].
inline size_t short_smem(const ShortShape& s, bool bwd) {
  const size_t TB = (size_t)s.rb * s.L, GW = (size_t)s.G * s.hd, K = s.L + 1;
  size_t f = (3 * (TB + 1) + (bwd ? TB : 0)) * s.ld + TB * s.G * K;
  if (bwd) f += TB * s.G * K + 2 * GW;
  return f * sizeof(float);
}

__device__ __forceinline__ bool key_kept(const float* mask, const ShortShape& s, int row, int j) {
  if (mask == nullptr || j == s.L) return true;
  const int b = row / s.T, t = row % s.T;
  return mask[b * s.mb + t * s.mt + j * s.ml] > 0.f;
}

// The transpose of RoPE's rotation of the pair (i, i + half) (rope_pair,
// common.cuh) at the position of the tables cs, sn, applied to a gradient v
// in place.
__device__ __forceinline__ void rope_transpose(float* v, const float* cs, const float* sn, int i,
                                               int half) {
  const float a = v[0] * cs[i] + v[1] * sn[i + half];
  v[1] = v[1] * cs[i + half] - v[0] * sn[i];
  v[0] = a;
}

// Stage the tile's ntok tokens (from row row0) of the head group into
// shared memory: q, k, v from qkv and, with dout, dO, each into its array
// dst[part] of rows of ld floats; then scale q and rope q and k. cp.async
// copies of 16 bytes where every run is aligned (s.vec), else of 4.
__device__ __forceinline__ void stage_tile(const float* __restrict__ qkv,
                                           const float* __restrict__ dout,
                                           const float* __restrict__ sin_t,
                                           const float* __restrict__ cos_t, const ShortShape& s,
                                           int row0, int ntok, int c0, float* const* dst) {
  const int L = s.L, hd = s.hd, half = hd / 2, GW = s.G * hd, C = s.H * hd, ld = s.ld;
  const int parts = dout != nullptr ? 4 : 3;
  const int w = s.vec ? 4 : 1, runs = GW / w, per_tok = parts * runs;
  const size_t tok0 = (size_t)row0 * L;
  for (int p = threadIdx.x; p < ntok * per_tok; p += blockDim.x) {
    const int tok = p / per_tok, part = (p % per_tok) / runs, c = (p % runs) * w;
    const float* src = part < 3 ? qkv + (tok0 + tok) * 3 * C + part * C
                                : dout + (tok0 + tok) * C;
    float* d = dst[part] + tok * ld + c;
    if (s.vec) cp_async16(d, src + c0 + c, true);
    else cp_async4(d, src + c0 + c, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // q scaled, then q and k roped at the token's residue position: one
  // (part, head, channel pair) a thread, every token
  for (int p = threadIdx.x; p < GW; p += blockDim.x) {
    const int part = p / (GW / 2), pc = p % (GW / 2), i = pc % half;
    float* v = dst[part] + (pc / half) * hd;
    for (int tok = 0; tok < ntok; ++tok, v += ld) {
      if (part == 0) {
        v[i] *= s.q_scale;
        v[i + half] *= s.q_scale;
      }
      const int l = tok % L;  // the residue's position
      if (s.use_rope) rope_pair(v, i, half, sin_t + l * hd, cos_t + l * hd);
    }
  }
}

// The bias key (roped at position L) and value of the head group, at row
// TB of the staged keys and values.
__device__ __forceinline__ void stage_bias(const float* __restrict__ bias_k,
                                           const float* __restrict__ bias_v,
                                           const float* __restrict__ sin_t,
                                           const float* __restrict__ cos_t, const ShortShape& s,
                                           int c0, float* kb, float* vb) {
  const int hd = s.hd, half = hd / 2, GW = s.G * hd;
  for (int p = threadIdx.x; p < GW / 2; p += blockDim.x) {
    const int i = p % half, hl = p / half, c = c0 + hl * hd;
    float* k = kb + hl * hd;
    k[i] = bias_k[c + i];
    k[i + half] = bias_k[c + i + half];
    if (s.use_rope) rope_pair(k, i, half, sin_t + s.L * hd, cos_t + s.L * hd);
    vb[hl * hd + i] = bias_v[c + i];
    vb[hl * hd + i + half] = bias_v[c + i + half];
  }
}

// The row of key j for the tile's row rr: the row's residues, then the bias
// key at TB.
__device__ __forceinline__ int key_slot(int rr, int j, int L, int TB) {
  return j < L ? rr * L + j : TB;
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float acc = 0.f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// The logits of the tile's (token, head, key) triples into lg [TB][G][K]
// (finfo.min for a masked key) and, with dos, dP = dO . v into dp.
__device__ __forceinline__ void logits(const ShortShape& s, int row0, int ntok,
                                       const float* __restrict__ mask, const float* qs,
                                       const float* ks, const float* vs, const float* dos,
                                       float* lg, float* dp) {
  const int L = s.L, K = L + 1, hd = s.hd, G = s.G, TB = s.rb * L, ld = s.ld;
  for (int p = threadIdx.x; p < ntok * G * K; p += blockDim.x) {
    const int j = p % K, hl = (p / K) % G, tok = p / (K * G), rr = tok / L;
    const int kv = key_slot(rr, j, L, TB) * ld + hl * hd;
    const float l = dot(qs + tok * ld + hl * hd, ks + kv, hd);
    lg[p] = key_kept(mask, s, row0 + rr, j) ? l : kNegInf;
    if (dos != nullptr) dp[p] = dot(dos + tok * ld + hl * hd, vs + kv, hd);
  }
}

// Softmax in place over each of the n (token, head) rows of K logits in
// lg; with dp, dS = P (dP - sum_j P dP) in place of dP.
__device__ __forceinline__ void softmax(int n, int K, float* lg, float* dp) {
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float* l = lg + p * K;
    float m = l[K - 1];
    for (int j = 0; j < K - 1; ++j) m = fmaxf(m, l[j]);
    float z = 0.f;
    for (int j = 0; j < K; ++j) {
      l[j] = expf(l[j] - m);
      z += l[j];
    }
    const float inv = 1.f / z;
    float delta = 0.f;
    for (int j = 0; j < K; ++j) {
      l[j] *= inv;
      if (dp != nullptr) delta = fmaf(l[j], dp[p * K + j], delta);
    }
    if (dp != nullptr)
      for (int j = 0; j < K; ++j) dp[p * K + j] = l[j] * (dp[p * K + j] - delta);
  }
}

__global__ void __launch_bounds__(kShortGroupWidth)
short_attn_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                      const float* __restrict__ bias_k, const float* __restrict__ bias_v,
                      const float* __restrict__ sin_t, const float* __restrict__ cos_t,
                      float* __restrict__ o, const ShortShape s) {
  const int L = s.L, K = L + 1, hd = s.hd, G = s.G, GW = G * hd, C = s.H * hd, ld = s.ld;
  const int TB = s.rb * L, c0 = blockIdx.y * GW;
  const int row0 = blockIdx.x * s.rb, ntok = min(s.rb, s.rows - row0) * L;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + (TB + 1) * ld;
  float* vs = ks + (TB + 1) * ld;
  float* P = vs + (TB + 1) * ld;
  float* const dst[3] = {qs, ks, vs};

  stage_bias(bias_k, bias_v, sin_t, cos_t, s, c0, ks + TB * ld, vs + TB * ld);
  stage_tile(qkv, nullptr, sin_t, cos_t, s, row0, ntok, c0, dst);
  __syncthreads();
  logits(s, row0, ntok, mask, qs, ks, vs, nullptr, P, nullptr);
  __syncthreads();
  softmax(ntok * G, K, P, nullptr);
  __syncthreads();
  // P.V: one column a thread, every token
  for (int col = threadIdx.x; col < GW; col += blockDim.x) {
    const int hl = col / hd;
    float* out = o + (size_t)row0 * L * C + c0 + col;
    for (int tok = 0; tok < ntok; ++tok, out += C) {
      const float* p = P + (tok * G + hl) * K;
      const int rr = tok / L;
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc = fmaf(p[j], vs[key_slot(rr, j, L, TB) * ld + col], acc);
      *out = acc;
    }
  }
}

__global__ void __launch_bounds__(kShortGroupWidth)
short_attn_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                      const float* __restrict__ mask, const float* __restrict__ bias_k,
                      const float* __restrict__ bias_v, const float* __restrict__ sin_t,
                      const float* __restrict__ cos_t, float* __restrict__ dqkv,
                      float* __restrict__ partials, const ShortShape s) {
  const int L = s.L, K = L + 1, hd = s.hd, half = hd / 2, G = s.G, GW = G * hd;
  const int C = s.H * hd, ld = s.ld, TB = s.rb * L, c0 = blockIdx.y * GW;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + (TB + 1) * ld;
  float* vs = ks + (TB + 1) * ld;
  float* dos = vs + (TB + 1) * ld;
  float* P = dos + TB * ld;      // logits, then probabilities [TB][G][K]
  float* dS = P + TB * G * K;    // dP, then dS [TB][G][K]
  float* acc = dS + TB * G * K;  // d(roped bias_k) [GW], d(bias_v) [GW]
  float* const dst[4] = {qs, ks, vs, dos};

  stage_bias(bias_k, bias_v, sin_t, cos_t, s, c0, ks + TB * ld, vs + TB * ld);
  for (int p = threadIdx.x; p < 2 * GW; p += blockDim.x) acc[p] = 0.f;
  const int tiles = (s.rows + s.rb - 1) / s.rb;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * s.rb, ntok = min(s.rb, s.rows - row0) * L;
    __syncthreads();  // the last tile's readers are done
    stage_tile(qkv, dout, sin_t, cos_t, s, row0, ntok, c0, dst);
    __syncthreads();
    logits(s, row0, ntok, mask, qs, ks, vs, dos, P, dS);
    __syncthreads();
    softmax(ntok * G, K, P, dS);
    __syncthreads();

    // p < GW / 2: dq = dS K and dk = dS^T Q for a channel pair, RoPE's
    // transpose, the store; p >= GW / 2: dv = P^T dO for that pair
    float* drow = dqkv + (size_t)row0 * L * 3 * C + c0;
    for (int p = threadIdx.x; p < GW; p += blockDim.x) {
      const int pc = p % (GW / 2), hl = pc / half, i = pc % half, hc = hl * hd;
      const bool qk = p < GW / 2;
      float* out = drow + hc + i;
      for (int tok = 0; tok < ntok; ++tok, out += 3 * C) {
        const int rr = tok / L, l = tok % L;
        float a[2] = {0.f, 0.f}, b[2] = {0.f, 0.f};
        for (int r = 0; r < L; ++r) {  // over the row's queries: dk or dv
          const int qt = rr * L + r, e = (qt * G + hl) * K + l;
          const float* x = (qk ? qs : dos) + qt * ld + hc;
          const float g = qk ? dS[e] : P[e];
          b[0] = fmaf(g, x[i], b[0]);
          b[1] = fmaf(g, x[i + half], b[1]);
        }
        if (!qk) {
          out[2 * C] = b[0];
          out[2 * C + half] = b[1];
          continue;
        }
        const float* gq = dS + (tok * G + hl) * K;
        for (int j = 0; j < K; ++j) {  // dq over the row's keys and the bias key
          const float* k = ks + key_slot(rr, j, L, TB) * ld + hc;
          a[0] = fmaf(gq[j], k[i], a[0]);
          a[1] = fmaf(gq[j], k[i + half], a[1]);
        }
        if (s.use_rope) {  // the transpose of q' = q cos + rotate_half(q) sin
          rope_transpose(a, cos_t + l * hd, sin_t + l * hd, i, half);
          rope_transpose(b, cos_t + l * hd, sin_t + l * hd, i, half);
        }
        out[0] = a[0] * s.q_scale;
        out[half] = a[1] * s.q_scale;
        out[C] = b[0];
        out[C + half] = b[1];
      }
    }
    // the bias key's and value's gradients over the tile, in token order
    for (int col = threadIdx.x; col < GW; col += blockDim.x) {
      const int hl = col / hd;
      float gk = acc[col], gv = acc[GW + col];
      for (int tok = 0; tok < ntok; ++tok) {
        const int e = (tok * G + hl) * K + L;
        gk = fmaf(dS[e], qs[tok * ld + col], gk);
        gv = fmaf(P[e], dos[tok * ld + col], gv);
      }
      acc[col] = gk;
      acc[GW + col] = gv;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < GW; p += blockDim.x) {
    partials[((size_t)blockIdx.x * 2) * C + c0 + p] = acc[p];
    partials[((size_t)blockIdx.x * 2 + 1) * C + c0 + p] = acc[GW + p];
  }
}

constexpr int kBiasLanes = 32, kBiasRuns = 32;

// d bias_k, d bias_v [C]: block (32 channel pairs, 32 runs). Run y sums
// the partials of row blocks y, y + 32, ... in order; then the 32 runs are
// summed in order, and RoPE's transpose at position L is applied to the key.
__global__ void __launch_bounds__(kBiasLanes * kBiasRuns)
short_attn_bias_grad_kernel(const float* __restrict__ partials, int n, int C, int hd, int L,
                            int use_rope, const float* __restrict__ sin_t,
                            const float* __restrict__ cos_t, float* __restrict__ dbias_k,
                            float* __restrict__ dbias_v) {
  __shared__ float runs[4][kBiasRuns][kBiasLanes + 1];
  const int half = hd / 2, x = threadIdx.x, y = threadIdx.y;
  const int p = blockIdx.x * kBiasLanes + x;  // the channel pair
  const bool live = p < C / 2;
  const int i = live ? p % half : 0, c = live ? (p / half) * hd + i : 0;
  float v[4] = {0.f, 0.f, 0.f, 0.f};  // the key's gradient at c, c + half; the value's
  if (live) {
#pragma unroll 4
    for (int b = y; b < n; b += kBiasRuns) {
      const float* pk = partials + (size_t)b * 2 * C + c;
      v[0] += pk[0];
      v[1] += pk[half];
      v[2] += pk[C];
      v[3] += pk[C + half];
    }
  }
  for (int q = 0; q < 4; ++q) runs[q][y][x] = v[q];
  __syncthreads();
  if (y != 0 || !live) return;
  for (int q = 0; q < 4; ++q) {
    v[q] = 0.f;
    for (int r = 0; r < kBiasRuns; ++r) v[q] += runs[q][r][x];
  }
  if (use_rope) rope_transpose(v, cos_t + L * hd, sin_t + L * hd, i, half);
  dbias_k[c] = v[0];
  dbias_k[c + half] = v[1];
  dbias_v[c] = v[2];
  dbias_v[c + half] = v[3];
}

inline bool is_aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

static cudaError_t short_shape(ShortShape& s, const float* qkv, const float* dout, int rows,
                               int T, int L, int H, int hd, int rb, long long mb, long long mt,
                               long long ml, int use_rope, float q_scale, bool bwd) {
  if (rows < 1 || T < 1 || L < 1 || L > kShortMaxL || H < 1 || hd < 2 || hd % 2 ||
      hd > kShortGroupWidth || rb < 1)
    return cudaErrorInvalidValue;
  const int G = short_heads_per_block(H, hd), C = H * hd;
  const bool vec = (G * hd) % 4 == 0 && C % 4 == 0 && is_aligned16(qkv) &&
                   (dout == nullptr || is_aligned16(dout));
  s = ShortShape{rows, T, L, H, hd, G, rb, G * hd + 4, mb, mt, ml, use_rope, vec ? 1 : 0,
                 q_scale};
  return short_smem(s, bwd) > kMaxSmem ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace mdgen

// o [rows, L, C] from qkv [rows, L, 3C] (C = H hd; rows = B T of T frames);
// mask: null, or the key mask read at b mb + t mt + l ml.
extern "C" int mdgen_short_attn_fwd(const float* qkv, const float* mask, const float* bias_k,
                                    const float* bias_v, const float* sin_t, const float* cos_t,
                                    float* o, int rows, int T, int L, int H, int hd, int rb,
                                    long long mb, long long mt, long long ml, int use_rope,
                                    float q_scale, void* stream) {
  using namespace mdgen;
  ShortShape s;
  cudaError_t e = short_shape(s, qkv, nullptr, rows, T, L, H, hd, rb, mb, mt, ml, use_rope,
                              q_scale, false);
  if (e != cudaSuccess) return e;
  static bool smem_set = false;  // the card's whole limit at once: a later call may need more
  const size_t smem = short_smem(s, false);
  e = allow_smem(short_attn_fwd_kernel, smem > 48 * 1024 ? kMaxSmem : smem, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((rows + rb - 1) / rb, H / s.G);
  short_attn_fwd_kernel<<<grid, short_threads(s), smem, static_cast<cudaStream_t>(stream)>>>(
      qkv, mask, bias_k, bias_v, sin_t, cos_t, o, s);
  return cudaGetLastError();
}

// dqkv [rows, L, 3C] and d bias_k, d bias_v [C] from dout [rows, L, C];
// partials: scratch [n_blocks, 2, C] (n_blocks row blocks, each walking
// every n_blocks-th tile of rb rows).
extern "C" int mdgen_short_attn_bwd(const float* qkv, const float* dout, const float* mask,
                                    const float* bias_k, const float* bias_v,
                                    const float* sin_t, const float* cos_t, float* dqkv,
                                    float* dbias_k, float* dbias_v, float* partials,
                                    int n_blocks, int rows, int T, int L, int H, int hd, int rb,
                                    long long mb, long long mt, long long ml, int use_rope,
                                    float q_scale, void* stream) {
  using namespace mdgen;
  ShortShape s;
  cudaError_t e = short_shape(s, qkv, dout, rows, T, L, H, hd, rb, mb, mt, ml, use_rope,
                              q_scale, true);
  if (e != cudaSuccess) return e;
  if (n_blocks < 1) return cudaErrorInvalidValue;
  static bool smem_set = false;  // the card's whole limit at once: a later call may need more
  const size_t smem = short_smem(s, true);
  e = allow_smem(short_attn_bwd_kernel, smem > 48 * 1024 ? kMaxSmem : smem, smem_set);
  if (e != cudaSuccess) return e;
  auto st = static_cast<cudaStream_t>(stream);
  short_attn_bwd_kernel<<<dim3(n_blocks, H / s.G), short_threads(s), smem, st>>>(
      qkv, dout, mask, bias_k, bias_v, sin_t, cos_t, dqkv, partials, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int pairs = H * hd / 2;
  short_attn_bias_grad_kernel<<<(pairs + kBiasLanes - 1) / kBiasLanes,
                                dim3(kBiasLanes, kBiasRuns), 0, st>>>(
      partials, n_blocks, H * hd, hd, L, use_rope, sin_t, cos_t, dbias_k, dbias_v);
  return cudaGetLastError();
}
