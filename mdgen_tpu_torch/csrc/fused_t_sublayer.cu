// Fused frame-attention sublayer:
//   y = x + gate * out_proj(Attn_T(modulate(LN(x), shift, scale)))
// attending, for each (b, l), over the T frames plus the learned bias token
// (roped at position T). A residue whose mask is 0 has no valid frame key,
// so its queries attend to the bias token alone.
//
// Replaces the TPU kernel mdgen_tpu/ops/fused_t_block.py:fused_t_sublayer
// (Pallas body _fused_t_kernel / _t_sublayer_math). As there, the Q.K^T,
// P.V and bias-logit operands are rounded to the compute dtype W.
//
// What bounds it on an H100: at the serving shape (B*L = 4 residues, T =
// 100 frames, C = 384, 16 heads of 24, bf16 operands) one call moves 2.4 MB
// (1.2 MB of bf16 weights, 1.2 MB of f32 x and y): 0.72 us at 3.35 TB/s;
// its 0.47 GFLOP of projections and 0.06 GFLOP of attention take 0.54 us at
// 989 TFLOP/s. So bytes bound it, and in practice launch latency and the L2
// traffic of the tiles. At T = 1000 (the sampling path of a run trained at
// the recipe's frame count) the attention grows with T^2 and operations
// bound it (about 11 us with every residue valid).
//
// The TPU ran one program per (b, l) holding its [T, 3C] qkv in VMEM; a
// Hopper block has at most 227 KB of shared memory, and 4 programs would
// leave 128 SMs idle. So the work is split across the card and onto the
// tensor cores, in three launches built from the tiles of kernels 1 and 4:
//   A. frame_qkv_kernel, block = (32 tokens in [B, T, L] order, a group of
//      2 heads; 12 warps), 13 x 8 = 104 blocks at the serving shape:
//      qkv_project (mma_tile.cuh, as kernel 1's first launch: LN + modulate
//      once per block into a resident tile rounded to W, the heads' q, k
//      and v columns in one GEMM pass, + bias, q scale, RoPE at the frame
//      position t = (tok / L) % T), then q, k and v rounded to W (the JAX
//      kernel rounds exactly these operands, so nothing is lost) into a
//      scratch in the flash layout [3][B*L*H][T][hd];
//   B. frame_attn_kernel, grid (B*L*H, ceil(T / 64)), 4 warps of 16
//      queries (flash_tile.cuh, as kernel 4): K (and V) tiles of 64 frames
//      through two cp.async stages, S = Q K^T by WarpMma, O += P V by
//      WarpMmaAccA. Two passes over the key tiles: the first takes the row
//      maximum over the frame keys and the bias logit, the second p = exp(s
//      - m) against that final maximum, z = sum p from the unrounded p, and
//      num = sum rnd_W(p) v, P entering the bf16 MMA as one fragment
//      rounded to nearest even (JAX: p.astype(dt)); an online softmax would
//      round p against a running maximum, another result. The bias token
//      stays out of the MMAs, in f32: lb = rnd_W(q) . rnd_W(rope_T(bias_k))
//      per row, pb = exp(lb - m), z += pb, num += pb bias_v, none rounded.
//      A masked residue runs no key tile (m = lb, out = bias_v exactly, as
//      the JAX kernel's finfo.min logits give); keys past T get p = 0. The
//      output num / z, rounded to W, goes to ao [B*T*L, C] at columns
//      h*hd.. (0.3 MB in bf16 at the serving shape: it stays in L2);
//   C. gated_out_proj_kernel (mma_tile.cuh, as kernels 1 and 3): out-proj
//      of ao, + out_b, y = x + gate * (.).
// No sum crosses blocks: no atomics, and the result is deterministic.
#include "flash_tile.cuh"

namespace mdgen {

constexpr int kMaxHd = 64;  // the widest head of the attention tiles

// grid (ceil(B*T*L / 32), H / G): q, k, v of 32 tokens and G heads, rounded
// to W, into qkv [3][B*L*H][T][hd].
template <typename W, typename V>
__global__ void __launch_bounds__(QkvGemm<W>::kThreads, 1)
frame_qkv_kernel(const float* __restrict__ x, const V* __restrict__ shift,
                 const V* __restrict__ scale, const W* __restrict__ qkv_w,
                 const V* __restrict__ qkv_b, const float* __restrict__ sin_t,
                 const float* __restrict__ cos_t, W* __restrict__ qkv, int n_tok, int T, int L,
                 int C, int H, int G, int use_rope, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = C / H, GW = G * hd, QW = 3 * GW;
  const int tok0 = blockIdx.x * kQkvBM, used = min(kQkvBM, n_tok - tok0);
  const int h0 = blockIdx.y * G;
  const float* qs = qkv_project<W, V>(
      smem_raw, x, shift, scale, qkv_w, qkv_b, sin_t, cos_t, tok0, used, T * L, C, hd, h0, G,
      use_rope, q_scale, [&](int tok) { return tok / L % T; });
  const size_t plane = (size_t)n_tok * C;  // one of q, k, v: [B*L*H][T][hd]
  for (int p = threadIdx.x; p < used * QW; p += blockDim.x) {
    const int r = p / QW, n = p % QW, seg = n / GW, hl = n % GW / hd, d = n % hd;
    const int tok = tok0 + r, bt = tok / L, l = tok % L, b = bt / T, t = bt % T;
    qkv[seg * plane + ((((size_t)b * L + l) * H + h0 + hl) * T + t) * hd + d] = from_f<W>(qs[p]);
  }
}

// S and O stay in registers across a tile, as in the flash forward: 4
// blocks an SM (at most 128 registers a thread).
constexpr int kFrameMinBlocks = 4;

// grid (B*L*H, ceil(T / 64)), 4 warps, each owning 16 queries of one (b, l,
// h); key tiles of 64 frames (U = k, W = v; the stages' f32 vectors unused).
// D: the reduction over hd padded to a k step; DN: output columns, hd
// rounded up to 8.
template <typename W, typename V, int D, int DN>
__global__ void __launch_bounds__(kFlashWarps * 32, kFrameMinBlocks)
frame_attn_kernel(const W* __restrict__ qkv, const float* __restrict__ mask,
                  const V* __restrict__ bias_k, const V* __restrict__ bias_v,
                  const float* __restrict__ sin_t, const float* __restrict__ cos_t,
                  W* __restrict__ ao, int T, int L, int H, int hd, int use_rope, int vec) {
  using S = FlashSmem<W, D>;
  constexpr int ld = S::ld, NT = kFlashRows / 8, NO = DN / 8;
  static_assert(DN <= D && DN % 8 == 0 && DN <= kMaxHd, "output tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float kbs[kMaxHd];
  W* qs = reinterpret_cast<W*>(smem_raw);

  const int n = blockIdx.x, row0 = blockIdx.y * kFlashRows;  // n = (b L + l) H + h
  const int h = n % H, bl = n / H, b = bl / L, res = bl % L, C = H * hd, half = hd / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t plane = (size_t)gridDim.x * T * hd;
  const W* qn = qkv + (size_t)n * T * hd;
  const W* kn = qn + plane;
  const W* vn = kn + plane;
  // the residue mask is constant across frames: a masked residue runs no tile
  const int ntiles = mask[bl] > 0.f ? (T + kFlashRows - 1) / kFlashRows : 0;
  const int steps = 2 * ntiles;  // pass 1: K tiles, the row max; pass 2: K and V

  stage_tile<W, D>(qs, qn, row0, min(kFlashRows, T - row0), hd, vec);
  cp_async_commit();
  auto load = [&](int it) {
    W* ks = reinterpret_cast<W*>(S::stage(smem_raw, 1, it % kFlashStages));
    const int k0 = it % ntiles * kFlashRows, nk = min(kFlashRows, T - k0);
    stage_tile<W, D>(ks, kn, k0, nk, hd, vec);
    if (it >= ntiles) stage_tile<W, D>(ks + S::tile, vn, k0, nk, hd, vec);
  };
  if (steps > 0) load(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {  // the bias key, roped at position T
    const int c = h * hd + i;
    float kb = to_f(bias_k[c]);
    if (use_rope) {
      const float* s = sin_t + (size_t)T * hd;
      const float* co = cos_t + (size_t)T * hd;
      kb = i < half ? kb * co[i] - to_f(bias_k[c + half]) * s[i]
                    : kb * co[i] + to_f(bias_k[c - half]) * s[i];
    }
    kbs[i] = rnd<W>(kb);
  }
  cp_async_wait<1>();  // the q rows have landed
  __syncthreads();

  // rows g and g + 8 of the warp's 16 (hh = 0, 1): the bias logit, the
  // row max, this thread's part of z (its columns 2t, 2t + 1 of each n8
  // tile), and num
  float lb[2], m[2], z[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const W* qr = qs + (warp * 16 + g + 8 * hh) * ld;
    float dot = 0.f;
    for (int d = 0; d < hd; ++d) dot = fmaf(to_f(qr[d]), kbs[d], dot);
    lb[hh] = m[hh] = dot;
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile it has landed
    __syncthreads();
    const W* ks = reinterpret_cast<const W*>(S::stage(smem_raw, 1, it % kFlashStages));
    const int nk = min(kFlashRows, T - it % ntiles * kFlashRows);

    float s[1][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[0][j][i] = 0.f;
    WarpMma<W, 1, NT, D>::run(s, qs + warp * 16 * ld, ld, ks, ld);

    if (it < ntiles) {  // pass 1: the max over the tile's valid keys
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
          const int c = j * 8 + 2 * t + (i & 1);
          if (c < nk) m[i >> 1] = fmaxf(m[i >> 1], s[0][j][i]);
        }
      if (it == ntiles - 1) {  // the quad's max (lanes 4g .. 4g + 3 hold the same rows)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
        }
      }
    } else {  // pass 2: p against the final max; z from p, num from rnd_W(p)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = j * 8 + 2 * t + (i & 1);
          const float p = c < nk ? __expf(s[0][j][i] - m[i >> 1]) : 0.f;
          z[i >> 1] += p;
          s[0][j][i] = p;
        }
      WarpMmaAccA<W, NT, NO, true>::run(acc, s[0], ks + S::tile, ld);  // num += P V
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    z[hh] += __shfl_xor_sync(0xffffffffu, z[hh], 1);  // the quad's four parts, in a fixed order
    z[hh] += __shfl_xor_sync(0xffffffffu, z[hh], 2);
    const int r = row0 + warp * 16 + g + 8 * hh;
    if (r >= T) continue;
    const float pb = __expf(lb[hh] - m[hh]);
    const float zr = z[hh] + pb;
    W* out = ao + ((size_t)(b * T + r) * L + res) * C + h * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        if (c < hd) out[c] = from_f<W>((acc[j][2 * hh + e] + pb * to_f(bias_v[h * hd + c])) / zr);
      }
  }
}

struct FrameAttnArgs {
  const void *qkv, *bias_k, *bias_v;
  const float *mask, *sin_t, *cos_t;
  void* ao;
  int N, T, L, H, hd, use_rope;
};

template <typename V> struct RunFrameAttn {
  template <typename W, int D, int DN>
  static cudaError_t run(const FrameAttnArgs& a, cudaStream_t s) {
    constexpr size_t bytes = FlashSmem<W, D>::bytes(1);
    static bool smem_set = false;
    auto kernel = frame_attn_kernel<W, V, D, DN>;
    cudaError_t e = allow_smem(kernel, bytes, smem_set);
    if (e != cudaSuccess) return e;
    // whole rows of 16 bytes on 16 bytes: cp.async copies
    const int vec = (a.hd * sizeof(W)) % 16 == 0 && on16(a.qkv);
    kernel<<<dim3(a.N, (a.T + kFlashRows - 1) / kFlashRows), kFlashWarps * 32, bytes, s>>>(
        (const W*)a.qkv, a.mask, (const V*)a.bias_k, (const V*)a.bias_v, a.sin_t, a.cos_t,
        (W*)a.ao, a.T, a.L, a.H, a.hd, a.use_rope, vec);
    return cudaGetLastError();
  }
};

template <typename W, typename V>
static cudaError_t launch_t(const float* x, float* y, const void* shift,
                            const void* scale, const void* gate, const float* mask,
                            const void* qkv_w, const void* qkv_b, const void* bias_k,
                            const void* bias_v, const void* out_w, const void* out_b,
                            const float* sin_t, const float* cos_t, void* qkv, void* ao, int B,
                            int T, int L, int C, int H, int use_rope, float q_scale,
                            cudaStream_t stream) {
  const int hd = C / H, G = qkv_heads_per_block(H);
  const size_t smem = qkv_smem<W>(C, G * hd);
  if (C % H != 0 || hd % 2 != 0 || hd > kMaxHd || C % 8 != 0 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  auto kernel = frame_qkv_kernel<W, V>;
  cudaError_t e = allow_smem(kernel, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int n_tok = B * T * L;
  kernel<<<dim3((n_tok + kQkvBM - 1) / kQkvBM, H / G), QkvGemm<W>::kThreads, smem, stream>>>(
      x, (const V*)shift, (const V*)scale, (const W*)qkv_w, (const V*)qkv_b, sin_t, cos_t,
      (W*)qkv, n_tok, T, L, C, H, G, use_rope, q_scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const FrameAttnArgs a{qkv, bias_k, bias_v, mask, sin_t, cos_t, ao, B * L * H, T, L, H, hd,
                        use_rope};
  e = run_for<RunFrameAttn<V>>(a, hd, sizeof(W) == 2, stream);
  if (e != cudaSuccess) return e;
  return launch_gated_out_proj<W, V>((const W*)ao, out_w, out_b, gate, x, y, n_tok, T * L, C, C,
                                     stream);
}

}  // namespace mdgen

// qkv: scratch [3, B*L*H, T, C/H] and ao: scratch [B*T*L, C], both in the
// operand dtype (allocated by the caller).
extern "C" int mdgen_fused_t_sublayer(
    const float* x, float* y, const void* shift, const void* scale,
    const void* gate, const float* mask, const void* qkv_w, const void* qkv_b,
    const void* bias_k, const void* bias_v, const void* out_w, const void* out_b,
    const float* sin_t, const float* cos_t, void* qkv, void* ao, int B, int T, int L, int C,
    int H, int use_rope, float q_scale, int w_bf16, int v_bf16, void* stream) {
  using namespace mdgen;
  using bf = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
#define MDGEN_T_ARGS x, y, shift, scale, gate, mask, qkv_w, qkv_b, bias_k, bias_v, \
    out_w, out_b, sin_t, cos_t, qkv, ao, B, T, L, C, H, use_rope, q_scale, s
  if (w_bf16 && v_bf16) return launch_t<bf, bf>(MDGEN_T_ARGS);
  if (w_bf16) return launch_t<bf, float>(MDGEN_T_ARGS);
  if (v_bf16) return launch_t<float, bf>(MDGEN_T_ARGS);
  return launch_t<float, float>(MDGEN_T_ARGS);
#undef MDGEN_T_ARGS
}
