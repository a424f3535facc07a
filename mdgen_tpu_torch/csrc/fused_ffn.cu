// Fused MLP sublayer: y = x + gate * fc2(gelu(fc1(modulate(LN(x), shift, scale)))).
//
// Replaces the TPU kernel mdgen_tpu/ops/fused_ffn.py:fused_ffn_sublayer
// (Pallas body _ffn_kernel / _ffn_math).
//
// What bounds it on an H100: at the serving shape (B*T*L = 400 tokens,
// C = 384, hidden 1536, bf16 operands) one call moves 3.6 MB (2.36 MB of
// bf16 weights, 1.23 MB of f32 x and y): 1.1 us at 3.35 TB/s; its 0.94
// GFLOP take 0.95 us at 989 TFLOP/s. So bytes bound it, and in practice
// launch latency and the L2 traffic of the tiles.
//
// One block per 16 tokens, as in the first CUDA port of this sublayer,
// gives 25 blocks on 132 SMs, each streaming both whole weight matrices
// through an f32 FMA loop on CUDA cores. This design splits the work across
// the card and onto the tensor cores (mma_tile.cuh), in two launches:
//   A. block = (32 tokens, 192 hidden columns; 16 warps), 13 x 8 = 104
//      blocks at the serving shape, one wave: the first weight stages are
//      issued, then LN + modulate of its 32 rows (x staged in shared memory
//      by cp.async; recomputed per block, 384 values a row) into a resident
//      tile, rounded to the operand dtype; fc1 over its 192 rows of w1; +
//      b1, exact gelu (erff), rounded to the operand dtype into hid
//      [tokens, 4C] (1.2 MB in bf16: it stays in L2).
//   B. gated_out_proj_kernel, block = (32 tokens, 32 output columns; 8
//      warps), 156 blocks: fc2 over its 32 rows of w2, + b2,
//      y = x + gate * (.).
// Each block reads only its slice of a weight matrix; no sum crosses
// blocks, so there are no atomics and the result is deterministic.
#include "mma_tile.cuh"

namespace mdgen {

constexpr int kFfnBM = 32;   // tokens per block
constexpr int kFfnBN = 192;  // hidden columns per block (launch A)

// 16 warps (2 x 8, each 16 x 24); 4 stages of bf16 tiles 64 deep (111 KB),
// 3 of f32 tiles 32 deep (83 KB)
template <typename W>
using FfnUpGemm = TileGemm<W, kFfnBM, kFfnBN, 2, 8, 1, true, sizeof(W) == 2 ? 4 : 3>;

// shared memory of launch A: the stages, the resident A, the x rows
template <typename W>
inline size_t ffn_up_smem(int C) {
  return FfnUpGemm<W>::smem_bytes + sizeof(W) * kFfnBM * resident_ld<W>(C) +
         sizeof(float) * kFfnBM * C;
}

template <typename W, typename V>
__global__ void __launch_bounds__(FfnUpGemm<W>::kThreads, 1)
ffn_up_kernel(const float* __restrict__ x, const V* __restrict__ shift,
              const V* __restrict__ scale, const W* __restrict__ w1,
              const V* __restrict__ b1, W* __restrict__ hid, int n_tok, int tok_per_batch,
              int C, int Hd) {
  using G = FfnUpGemm<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = resident_ld<W>(C);
  W* stages = reinterpret_cast<W*>(smem_raw);
  W* As = reinterpret_cast<W*>(smem_raw + G::smem_bytes);
  float* xs = reinterpret_cast<float*>(smem_raw + G::smem_bytes + sizeof(W) * kFfnBM * lda);
  const int tok0 = blockIdx.x * kFfnBM, n_valid = min(kFfnBM, n_tok - tok0);
  const int c0 = blockIdx.y * kFfnBN;
  stage_x_rows(xs, x, tok0, n_valid, C);
  G::run(
      As, lda, nullptr, [&](int n) { return w1 + (size_t)(c0 + n) * C; }, w1, C,
      min(kFfnBN, Hd - c0), stages,
      [&] {  // LN + modulate while the first weight stages are in flight
        cp_async_wait<G::kStagesAhead>();
        __syncthreads();
        ln_modulate_rows<W, V>(xs, shift, scale, tok0, n_valid, tok_per_batch, C, kFfnBM, As,
                               lda);
      },
      [&](int r, int n, float acc) {
        if (r >= n_valid) return;
        const float h = acc + to_f(b1[c0 + n]);
        hid[(size_t)(tok0 + r) * Hd + c0 + n] =
            from_f<W>(0.5f * h * (1.f + erff(h * 0.70710678118654752f)));
      });
}

template <typename W, typename V>
static cudaError_t launch_ffn(const float* x, float* y, const void* shift,
                              const void* scale, const void* gate, const void* w1,
                              const void* b1, const void* w2, const void* b2, void* hid,
                              int n_tok, int tok_per_batch, int C, int Hd,
                              cudaStream_t stream) {
  const size_t smem = ffn_up_smem<W>(C);
  if (C % 8 != 0 || Hd % 8 != 0 || smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool smem_set = false;
  auto kernel = ffn_up_kernel<W, V>;
  cudaError_t e = allow_smem(kernel, smem, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((n_tok + kFfnBM - 1) / kFfnBM, (Hd + kFfnBN - 1) / kFfnBN);
  kernel<<<grid, FfnUpGemm<W>::kThreads, smem, stream>>>(x, (const V*)shift, (const V*)scale,
                                              (const W*)w1, (const V*)b1, (W*)hid, n_tok,
                                              tok_per_batch, C, Hd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_gated_out_proj<W, V>((const W*)hid, w2, b2, gate, x, y, n_tok, tok_per_batch,
                                     Hd, C, stream);
}

}  // namespace mdgen

// hid: scratch [n_tok, Hd] in the operand dtype (allocated by the caller).
extern "C" int mdgen_fused_ffn_sublayer(
    const float* x, float* y, const void* shift, const void* scale,
    const void* gate, const void* w1, const void* b1, const void* w2,
    const void* b2, void* hid, int n_tok, int tok_per_batch, int C, int Hd, int w_bf16,
    int v_bf16, void* stream) {
  using namespace mdgen;
  using bf = __nv_bfloat16;
  auto s = static_cast<cudaStream_t>(stream);
#define MDGEN_FFN_ARGS x, y, shift, scale, gate, w1, b1, w2, b2, hid, n_tok, tok_per_batch, \
    C, Hd, s
  if (w_bf16 && v_bf16) return launch_ffn<bf, bf>(MDGEN_FFN_ARGS);
  if (w_bf16) return launch_ffn<bf, float>(MDGEN_FFN_ARGS);
  if (v_bf16) return launch_ffn<float, bf>(MDGEN_FFN_ARGS);
  return launch_ffn<float, float>(MDGEN_FFN_ARGS);
#undef MDGEN_FFN_ARGS
}
