// Fused residue-attention sublayer:
//   y = x + gate * out_proj(Attn_L(modulate(LN(x), shift, scale)))
// attending over the L residues of each (b, t) row plus the learned bias
// token (always attendable, roped at position L).
//
// Replaces the TPU kernel mdgen_tpu/ops/fused_block.py:fused_l_sublayer
// (Pallas body _fused_kernel / _sublayer_math). The TPU kernel's constant
// rotation matrix R and head selector E only worked around Mosaic's lane
// layout; here rotate_half is done by index and the per-head reductions
// run over each head's channels directly.
//
// What bounds it on an H100: at the serving shape (B*T = 100 rows of L = 4
// tokens, C = 384, 16 heads, bf16 operands) one call moves 2.4 MB (1.2 MB of
// bf16 weights, 1.2 MB of f32 x and y): 0.72 us at 3.35 TB/s; its 0.47
// GFLOP of projections take 0.48 us at 989 TFLOP/s, and the attention
// itself is tiny (5 keys per query). So bytes bound it, and in practice
// launch latency and the L2 traffic of the tiles.
//
// One block per 16 tokens, as in the first CUDA port of this sublayer,
// gives 25 blocks on 132 SMs, each streaming both whole weight matrices
// through an f32 FMA loop on CUDA cores. This design splits the work across
// the card and onto the tensor cores (mma_tile.cuh), in two launches:
//   A. block = (32 tokens as whole (b, t) rows, a group of 2 heads; 12
//      warps), 13 x 8 = 104 blocks at the serving shape, one wave: the
//      first weight stages are issued, then LN + modulate of its rows (x
//      staged in shared memory by cp.async; recomputed per block) into a
//      resident tile, rounded to the operand dtype; the q, k and v columns
//      of its heads (3 x 48 rows of qkv_w: all its attention needs, one GEMM
//      pass), + bias, in f32; q scale and RoPE (up to here qkv_project of
//      mma_tile.cuh, shared with kernel 2); one thread per (token, head,
//      key) for the logits, then one per (token, head, channel) for the f32
//      softmax over the row's L keys and the bias token and the weighted
//      values; the output, rounded to the operand dtype, goes to ao
//      [tokens, C] (0.3 MB in bf16: it stays in L2).
//   B. gated_out_proj_kernel, block = (32 tokens, 32 output columns; 8
//      warps), 156 blocks: out-proj over its 32 rows of out_w, + out_b,
//      y = x + gate * (.).
// No sum crosses blocks: no atomics, and the result is deterministic.
#include "mma_tile.cuh"

namespace mdgen {

constexpr int kMaxL = 16;  // the model's gate for the fused path

// Shared memory of launch A: qkv_project's (mma_tile.cuh), then the roped
// bias keys [G hd] and the logits [BM][G][kMaxL + 1].
template <typename W>
inline size_t l_attn_smem(int C, int G, int hd) {
  return qkv_smem<W>(C, G * hd) + sizeof(float) * (G * hd + kQkvBM * G * (kMaxL + 1));
}

template <typename W, typename V>
__global__ void __launch_bounds__(QkvGemm<W>::kThreads, 1)
l_attn_kernel(const float* __restrict__ x, const V* __restrict__ shift,
              const V* __restrict__ scale, const float* __restrict__ mask,
              const W* __restrict__ qkv_w, const V* __restrict__ qkv_b,
              const V* __restrict__ bias_k, const V* __restrict__ bias_v,
              const float* __restrict__ sin_t, const float* __restrict__ cos_t,
              W* __restrict__ ao, int n_rows, int T, int L, int C, int H, int G, int use_rope,
              float q_scale) {
  const int hd = C / H, half = hd / 2, GW = G * hd, QW = 3 * GW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kbs = reinterpret_cast<float*>(smem_raw + qkv_smem<W>(C, GW));
  float* lg = kbs + GW;
  const int tile_tok = kQkvBM / L * L;
  const int tok0 = blockIdx.x * tile_tok, n_tok = n_rows * L;
  const int used = min(tile_tok, n_tok - tok0);
  const int tok_per_batch = T * L;
  const int h0 = blockIdx.y * G;

  for (int c = threadIdx.x; c < GW; c += blockDim.x) {  // the bias keys, roped at position L
    const int i = c % hd, gc = h0 * hd + c;
    const float v = to_f(bias_k[gc]);
    if (!use_rope) {
      kbs[c] = v;
    } else {
      const float* s = sin_t + L * hd;
      const float* co = cos_t + L * hd;
      kbs[c] = i < half ? v * co[i] - to_f(bias_k[gc + half]) * s[i]
                        : v * co[i] + to_f(bias_k[gc - half]) * s[i];
    }
  }
  // q, k, v of the block's heads, RoPE at the token's residue position (the
  // barriers inside also publish kbs)
  const float* qkv = qkv_project<W, V>(smem_raw, x, shift, scale, qkv_w, qkv_b, sin_t, cos_t,
                                       tok0, used, tok_per_batch, C, hd, h0, G, use_rope,
                                       q_scale, [&](int tok) { return tok % L; });

  // one thread per (token, head, key): the logit against the row's L keys
  // (finfo.min where masked) and, as key L, the bias key
  for (int p = threadIdx.x; p < used * G * (L + 1); p += blockDim.x) {
    const int j = p % (L + 1), rh = p / (L + 1), r = rh / G, hl = rh % G;
    const float* q = qkv + r * QW + hl * hd;
    const float* k = j < L ? qkv + (r - r % L + j) * QW + GW + hl * hd : kbs + hl * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(q[d], k[d], acc);
    const int b = (tok0 + r) / tok_per_batch;
    lg[rh * (kMaxL + 1) + j] = j == L || mask[b * L + j] > 0.f ? acc : kNegInf;
  }
  __syncthreads();

  // one thread per (token, head, channel): f32 softmax over the L keys and
  // the bias token, then the weighted sum of values, rounded to W
  for (int p = threadIdx.x; p < used * G * hd; p += blockDim.x) {
    const int d = p % hd, rh = p / hd, r = rh / G, hl = rh % G;
    const float* l = lg + rh * (kMaxL + 1);
    const float* v = qkv + (r - r % L) * QW + 2 * GW + hl * hd + d;
    float m = l[L];
    for (int j = 0; j < L; ++j) m = fmaxf(m, l[j]);
    float z = 0.f, num = 0.f;
    for (int j = 0; j < L; ++j) {
      const float e = expf(l[j] - m);
      z += e;
      num = fmaf(e, v[j * QW], num);
    }
    const float pb = expf(l[L] - m);
    z += pb;
    num += pb * to_f(bias_v[(h0 + hl) * hd + d]);
    ao[(size_t)(tok0 + r) * C + (h0 + hl) * hd + d] = from_f<W>(num / z);
  }
}

template <typename W, typename V>
static cudaError_t launch_l(const float* x, float* y, const void* shift,
                            const void* scale, const void* gate, const float* mask,
                            const void* qkv_w, const void* qkv_b, const void* bias_k,
                            const void* bias_v, const void* out_w, const void* out_b,
                            const float* sin_t, const float* cos_t, void* ao, int B, int T,
                            int L, int C, int H, int use_rope, float q_scale,
                            cudaStream_t stream) {
  const int G = qkv_heads_per_block(H);
  const size_t smem = l_attn_smem<W>(C, G, C / H);
  if (L < 1 || L > kMaxL || C % H != 0 || (C / H) % 2 != 0 || C % 8 != 0 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  auto kernel = l_attn_kernel<W, V>;
  cudaError_t e = allow_smem(kernel, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int n_rows = B * T, rows_per_block = kQkvBM / L;
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, H / G);
  kernel<<<grid, QkvGemm<W>::kThreads, smem, stream>>>(
      x, (const V*)shift, (const V*)scale, mask, (const W*)qkv_w, (const V*)qkv_b,
      (const V*)bias_k, (const V*)bias_v, sin_t, cos_t, (W*)ao, n_rows, T, L, C, H, G,
      use_rope, q_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_gated_out_proj<W, V>((const W*)ao, out_w, out_b, gate, x, y, n_rows * L, T * L,
                                     C, C, stream);
}

}  // namespace mdgen

// ao: scratch [B*T*L, C] in the operand dtype (allocated by the caller).
extern "C" int mdgen_fused_l_sublayer(
    const float* x, float* y, const void* shift, const void* scale,
    const void* gate, const float* mask, const void* qkv_w, const void* qkv_b,
    const void* bias_k, const void* bias_v, const void* out_w, const void* out_b,
    const float* sin_t, const float* cos_t, void* ao, int B, int T, int L, int C, int H,
    int use_rope, float q_scale, int w_bf16, int v_bf16, void* stream) {
  using namespace mdgen;
  using bf = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
#define MDGEN_L_ARGS x, y, shift, scale, gate, mask, qkv_w, qkv_b, bias_k, bias_v, \
    out_w, out_b, sin_t, cos_t, ao, B, T, L, C, H, use_rope, q_scale, s
  if (w_bf16 && v_bf16) return launch_l<bf, bf>(MDGEN_L_ARGS);
  if (w_bf16) return launch_l<bf, float>(MDGEN_L_ARGS);
  if (v_bf16) return launch_l<float, bf>(MDGEN_L_ARGS);
  return launch_l<float, float>(MDGEN_L_ARGS);
#undef MDGEN_L_ARGS
}
