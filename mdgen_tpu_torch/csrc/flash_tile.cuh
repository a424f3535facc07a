// The block layout of the tensor-core attention kernels: the flash kernels
// (4 to 7, flash_attention.cu) and the frame attention of kernel 2
// (fused_t_sublayer.cu). A block owns 64 rows of one n (4 warps of 16) and
// streams the other side through shared memory in tiles of 64 rows, through
// a ring of two cp.async stages.
#pragma once

#include "mma_tile.cuh"

namespace mdgen {

constexpr int kFlashRows = 64;  // own rows of a block (16 a warp), rows of a streamed tile
constexpr int kFlashWarps = kFlashRows / 16;
constexpr int kFlashStages = 2;

// Shared memory of a block: `own` tiles of own rows (q for the forward; two
// for the backward); then per stage the
// streamed rows U, W and two f32 vectors over the streamed rows (the key
// bias for the forward and dq; lse and delta for dk/dv). Every part starts
// on 16 bytes.
template <typename T, int D> struct FlashSmem {
  static constexpr int ld = D + smem_pad<T>();
  static constexpr int tile = kFlashRows * ld;  // elements
  static constexpr size_t stage_bytes =
      2 * tile * sizeof(T) + 2 * kFlashRows * sizeof(float);
  static constexpr size_t bytes(int own) {
    return own * tile * sizeof(T) + kFlashStages * stage_bytes;
  }
  __device__ static unsigned char* stage(unsigned char* base, int own, int s) {
    return base + own * tile * sizeof(T) + s * stage_bytes;
  }
};

// Rows [r0, r0 + rows) of a [*, d] matrix into a [kFlashRows][D + pad]
// tile; rows past `rows` and columns past d are zero, in every call. With
// vec, 16-byte cp.async copies (d * sizeof(T) % 16 == 0 and src on 16
// bytes); else element by element through registers (any d, any alignment).
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int r0, int rows,
                                           int d, bool vec) {
  if (vec) {
    stage_rows<T, kFlashRows, D>(
        dst, [&](int r) -> const T* { return r < rows ? src + (size_t)(r0 + r) * d : nullptr; },
        src, 0, d);
    return;
  }
  constexpr int ld = FlashSmem<T, D>::ld;
  for (int i = threadIdx.x; i < kFlashRows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ld + c] = (r < rows && c < d) ? src[(size_t)(r0 + r) * d + c] : from_f<T>(0.f);
  }
}

// Streamed tile `it` (rows [64 it, 64 it + 64) of `total`) into stage st:
// the rows of U and W, and of the f32 vectors v0 and (unless null) v1;
// zero past `total`.
template <typename T, int D>
__device__ __forceinline__ void stage_streamed(unsigned char* st, const T* U, const T* W,
                                               const float* v0, const float* v1, int it,
                                               int total, int d, bool vec) {
  using S = FlashSmem<T, D>;
  const int c0 = it * kFlashRows, nc = min(kFlashRows, total - c0);
  T* us = reinterpret_cast<T*>(st);
  float* cv = reinterpret_cast<float*>(us + 2 * S::tile);
  stage_tile<T, D>(us, U, c0, nc, d, vec);
  stage_tile<T, D>(us + S::tile, W, c0, nc, d, vec);
  for (int i = threadIdx.x; i < kFlashRows; i += blockDim.x) {
    const bool ok = i < nc;
    const int c = ok ? c0 + i : 0;
    cp_async4(cv + i, v0 + c, ok);
    if (v1 != nullptr) cp_async4(cv + kFlashRows + i, v1 + c, ok);
  }
}

inline bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// R::run<T, D, DN>(a, s) for the operand dtype (bf16 when bf16, else f32),
// the output width DN (d rounded up to 8, then to 16, 24, 32, 48 or 64) and
// the reduction D (DN rounded up to a TF32 k8 step, or to a bf16 k16 step);
// d outside 1..64 is refused.
template <typename R, typename A>
cudaError_t run_for(const A& a, int d, bool bf16, cudaStream_t s) {
  using B = __nv_bfloat16;
  if (d <= 0 || d > 64) return cudaErrorInvalidValue;
  if (bf16) {
    if (d <= 8) return R::template run<B, 16, 8>(a, s);
    if (d <= 16) return R::template run<B, 16, 16>(a, s);
    if (d <= 24) return R::template run<B, 32, 24>(a, s);
    if (d <= 32) return R::template run<B, 32, 32>(a, s);
    if (d <= 48) return R::template run<B, 48, 48>(a, s);
    return R::template run<B, 64, 64>(a, s);
  }
  if (d <= 8) return R::template run<float, 8, 8>(a, s);
  if (d <= 16) return R::template run<float, 16, 16>(a, s);
  if (d <= 24) return R::template run<float, 24, 24>(a, s);
  if (d <= 32) return R::template run<float, 32, 32>(a, s);
  if (d <= 48) return R::template run<float, 48, 48>(a, s);
  return R::template run<float, 64, 64>(a, s);
}

}  // namespace mdgen
