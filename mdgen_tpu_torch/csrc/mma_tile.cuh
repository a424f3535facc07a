// Tensor-core tile GEMM for the serving sublayers (kernels 1 to 3: TileGemm,
// the q/k/v projection of kernels 1 and 2, the gated out-projection of all
// three), and the warp products of the attention kernels (the flash kernels
// 4 to 7 and kernel 2's frame attention: WarpMma, WarpMmaAccA).
//
// A block of WARPS_M x WARPS_N x WARPS_K warps computes, per pass, a
// [BM, BN] tile of
//   acc(r, n) = sum_k A(r, k) * W(n, k)
// with A row-major [rows, K] and W in nn.Linear layout [out, in]: K is
// contiguous, which is already the "col" B operand of mma.sync, so no
// transpose. Both operands are of the compute dtype W:
//   * bf16: mma.sync.m16n8k16 bf16 x bf16 -> f32, fragments loaded with
//     ldmatrix. The products of bf16 values are exact in f32.
//   * f32: split TF32 on mma.sync.m16n8k8. Each operand is x = big + small
//     with big = tf32(x) and small = x - big (split_tf32); the tile accumulates
//     a_small*b_big + a_big*b_small + a_big*b_big and drops a_small*b_small
//     (about 2^-22 of the product), the 3xTF32 of PyTorch's memory-efficient
//     attention. Plain TF32 keeps 10 mantissa bits, too few for the f32
//     serving path's 1e-4 parity.
// mma.sync and not wgmma: at the serving shape (400 tokens) a 64-row wgmma
// tile would leave 7 token tiles; 32-row tiles of mma.sync give 100 to 160
// blocks a launch, and at these sizes launch latency and L2 traffic bound
// the kernels, not the MMA rate.
//
// Tiles come into shared memory with cp.async (16 bytes a copy) through a
// ring of STAGES stages of BK columns: the next stages' copies are in
// flight while the current one multiplies. At these sizes one warp per
// scheduler leaves every latency exposed, so blocks run 8 to 16 warps;
// where the output tile is too small for that, WARPS_K groups of warps take
// alternate k16 (or k8) steps of each stage and are summed through shared
// memory at the end, in a fixed order. Every sum runs in a fixed order (no
// atomics, no split-K across blocks), so results are bit-deterministic.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace mdgen {

// Reduction depth of one stage: 64 bf16 (128 bytes a row) or 32 floats, so
// a stage's copies are large enough to keep the L2 busy; resident A tiles
// are padded to whole stages of the deepest.
template <typename W> __host__ __device__ constexpr int gemm_bk() {
  return sizeof(W) == 2 ? 64 : 32;
}
constexpr int kMaxBK = 64;

// Row stride (elements) of shared tiles. A pad of 16 bytes (bf16) puts the
// 8 rows one ldmatrix phase reads on distinct banks; a pad of 4 floats (f32)
// makes the stride 4 mod 32 banks, so the scalar fragment loads of a warp
// hit 32 distinct banks.
template <typename W> __host__ __device__ constexpr int smem_pad() {
  return sizeof(W) == 2 ? 8 : 4;
}
template <typename W> __host__ __device__ constexpr int copy_elems() {
  return 16 / (int)sizeof(W);
}
template <typename W, int BK> __host__ __device__ constexpr int tile_ld() {
  return BK + smem_pad<W>();
}
// stride of an A tile held whole in shared memory: K in whole stages, + pad
template <typename W> __host__ __device__ inline int resident_ld(int K) {
  return (K + kMaxBK - 1) / kMaxBK * kMaxBK + smem_pad<W>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; with valid false nothing is read and
// the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4-byte async copy (one float), zero-filled when valid is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
// Transposed: lane (g, t) gets rows 2t, 2t+1 of column g of each 8x8 matrix.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// Two floats as a bf16 pair, lo in the low half (round-to-nearest-even).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small, both TF32 (x - big is exact in f32), in three
// instructions: big by two integer operations (add half a tf32 ulp, drop the
// 13 low bits), and small handed over as it is, since the tensor core takes
// a tf32 operand's top 19 bits: small loses at most 2^-10 of itself, about
// 2^-21 of x. Two cvt.rna take about ten instructions (SASS), which the
// flash backward, bound by instruction throughput, paid for
// (flash_attention.cu).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Two floats as bf16 pairs, x = hi + lo: hi the top 16 bits of x after
// adding half a bf16 ulp, lo = x - hi (exact in f32) rounded to bf16, so the
// pair holds x to about 2^-17 of itself. Low halves from x0.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t h0 = (__float_as_uint(x0) + 0x8000u) & 0xffff0000u;
  const uint32_t h1 = (__float_as_uint(x1) + 0x8000u) & 0xffff0000u;
  hi = __byte_perm(h0, h1, 0x7632);
  lo = pack_bf16x2(x0 - __uint_as_float(h0), x1 - __uint_as_float(h1));
}

// One warp's [MT*16, NT*8] tile over KSPAN columns. A: the warp's first row
// and column, row-major with stride lda; B: the warp's first column n and
// first k as a [n][k] tile with stride ldb (both in shared memory).
template <typename W, int MT, int NT, int KSPAN> struct WarpMma;

template <int MT, int NT, int KSPAN> struct WarpMma<__nv_bfloat16, MT, NT, KSPAN> {
  static_assert(KSPAN % 16 == 0, "k16 steps");
  __device__ __forceinline__ static void run(float (&acc)[MT][NT][4], const __nv_bfloat16* A,
                                             int lda, const __nv_bfloat16* B, int ldb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < KSPAN; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
      // x4: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), lane l gives a row of matrix l / 8
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], A + (mt * 16 + (lane & 15)) * lda + kk + (lane >> 4) * 8);
      // x2: n 0-7 at k 0-7 and at k 8-15 (lanes 16-31 repeat valid addresses)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ldmatrix_x2(b[nt], B + (nt * 8 + (lane & 7)) * ldb + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }
};

template <int MT, int NT, int KSPAN> struct WarpMma<float, MT, NT, KSPAN> {
  static_assert(KSPAN % 8 == 0, "k8 steps");
  __device__ __forceinline__ static void run(float (&acc)[MT][NT][4], const float* A, int lda,
                                             const float* B, int ldb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KSPAN; kk += 8) {
      uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        const float* p = A + (mt * 16 + g) * lda + kk + t;
        split_tf32(p[0], ab[mt][0], as[mt][0]);
        split_tf32(p[8 * lda], ab[mt][1], as[mt][1]);
        split_tf32(p[4], ab[mt][2], as[mt][2]);
        split_tf32(p[8 * lda + 4], ab[mt][3], as[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // b0 (k t, n g), b1 (k t+4, n g)
        const float* p = B + (nt * 8 + g) * ldb + kk + t;
        split_tf32(p[0], bb[nt][0], bs[nt][0]);
        split_tf32(p[4], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(acc[mt][nt], as[mt], bb[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
          mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
        }
    }
  }
};

// out[16, NT*8] += A[16, KT*8] . B, where A is a warp's row of KT accumulator
// tiles as WarpMma<W, 1, KT, ...> leaves them (FA2's P or dS, kept in
// registers) and B is row-major [k][n] in shared memory with stride ldb:
// read transposed against WarpMma's [n][k], so no copy of the tile is made.
// ROUND_A: A is rounded to W once, as the reference rounds it (kernel 2's P).
template <typename W, int KT, int NT, bool ROUND_A = false> struct WarpMmaAccA;

// bf16: accumulator tiles 2kk and 2kk+1 are exactly the A fragment of one
// k16 step. A stays f32, as the flash kernels' reference keeps p and ds: it
// enters as the pair hi + lo of split_bf16x2, two MMAs a step; with ROUND_A
// it is rounded to bf16 (to nearest even, as astype does) and enters once.
// B comes through ldmatrix.trans.
template <int KT, int NT, bool ROUND_A> struct WarpMmaAccA<__nv_bfloat16, KT, NT, ROUND_A> {
  static_assert(KT % 2 == 0, "k16 steps");
  __device__ __forceinline__ static void run(float (&out)[NT][4], const float (&a)[KT][4],
                                             const __nv_bfloat16* B, int ldb) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      uint32_t hi[4], lo[4];
      if constexpr (ROUND_A) {
        hi[0] = pack_bf16x2(a[2 * kk][0], a[2 * kk][1]);
        hi[1] = pack_bf16x2(a[2 * kk][2], a[2 * kk][3]);
        hi[2] = pack_bf16x2(a[2 * kk + 1][0], a[2 * kk + 1][1]);
        hi[3] = pack_bf16x2(a[2 * kk + 1][2], a[2 * kk + 1][3]);
      } else {
        split_bf16x2(a[2 * kk][0], a[2 * kk][1], hi[0], lo[0]);
        split_bf16x2(a[2 * kk][2], a[2 * kk][3], hi[1], lo[1]);
        split_bf16x2(a[2 * kk + 1][0], a[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16x2(a[2 * kk + 1][2], a[2 * kk + 1][3], hi[3], lo[3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];  // lanes 0-7: k rows 0-7, lanes 8-15: rows 8-15 (16-31 repeat)
        ldmatrix_x2_trans(b, B + (kk * 16 + (lane & 15)) * ldb + nt * 8);
        if constexpr (!ROUND_A) mma_bf16(out[nt], lo, b);
        mma_bf16(out[nt], hi, b);
      }
    }
  }
};

// f32, split TF32: the accumulator holds columns (2t, 2t+1) where the A
// fragment of m16n8k8 wants (t, t+4). A sum over k does not care about the
// order of k, so each k8 step takes logical k t as column 2t and t+4 as
// 2t+1, and B's rows are read in that same order: no shuffles. Rounding to
// f32 is the identity, so ROUND_A changes nothing.
template <int KT, int NT, bool ROUND_A> struct WarpMmaAccA<float, KT, NT, ROUND_A> {
  __device__ __forceinline__ static void run(float (&out)[NT][4], const float (&a)[KT][4],
                                             const float* B, int ldb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ab[4], as[4];
      split_tf32(a[kk][0], ab[0], as[0]);  // (g, 2t)
      split_tf32(a[kk][2], ab[1], as[1]);  // (g+8, 2t)
      split_tf32(a[kk][1], ab[2], as[2]);  // (g, 2t+1)
      split_tf32(a[kk][3], ab[3], as[3]);  // (g+8, 2t+1)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* p = B + (kk * 8 + 2 * t) * ldb + nt * 8 + g;
        uint32_t bb[2], bs[2];
        split_tf32(p[0], bb[0], bs[0]);
        split_tf32(p[ldb], bb[1], bs[1]);
        mma_tf32(out[nt], as, bb);
        mma_tf32(out[nt], ab, bs);
        mma_tf32(out[nt], ab, bb);
      }
    }
  }
};

// Copy columns [k0, k0 + BK) of R rows into a [R][tile_ld] stage. rowp(r)
// points at row r's first element, or is nullptr past the valid rows; such
// rows, and columns at or past K, are zero-filled (K % copy_elems == 0).
// `any` is a valid address for the copies that read nothing.
template <typename W, int R, int BK, typename RowPtr>
__device__ __forceinline__ void stage_rows(W* dst, RowPtr rowp, const W* any, int k0, int K) {
  constexpr int kPerRow = BK / copy_elems<W>();
  static_assert(kPerRow * copy_elems<W>() == BK, "whole 16-byte copies");
  for (int i = threadIdx.x; i < R * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow, c = (i % kPerRow) * copy_elems<W>();
    const W* src = rowp(r);
    const bool ok = src != nullptr && k0 + c < K;
    cp_async16(dst + r * tile_ld<W, BK>() + c, ok ? src + k0 + c : any, ok);
  }
}

// Block GEMM: for n0 = 0, BN, ... < N, the [BM, BN] tile at columns n0 is
// accumulated over all K and handed to epi(r, n, acc) for r < BM, n < N.
// A_RES: A is resident in shared memory ([BM][lda], zero past K); else A is
// streamed with W from arow(r) (global row pointers, nullptr past the valid
// rows). wrow(n) is the global row pointer of output column n. `stages`
// holds smem_bytes of shared memory. pre() runs once, after the first
// stages' copies are issued and before the first multiply (a resident A is
// written there, while the weights are in flight). Called by all kThreads
// threads of the block.
template <typename W, int BM, int BN, int WARPS_M, int WARPS_N, int WARPS_K, bool A_RES,
          int STAGES, int BK = gemm_bk<W>()>
struct TileGemm {
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N * WARPS_K;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N, KSPAN = BK / WARPS_K;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(MT * 16 == WTM && NT * 8 == WTN && MT > 0 && NT > 0, "warp tile");
  static_assert(KSPAN * WARPS_K == BK && BK <= kMaxBK, "k groups");
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static constexpr int kARows = A_RES ? 0 : BM;
  static constexpr int kStageElems = (kARows + BN) * tile_ld<W, BK>();
  static constexpr size_t smem_bytes = (size_t)STAGES * kStageElems * sizeof(W);
  static constexpr int kStagesAhead = STAGES - 1;  // stages issued before the first multiply
  static_assert((WARPS_K - 1) * BM * BN * sizeof(float) <= smem_bytes, "k-group sums fit");

  template <typename ARow, typename WRow, typename Pre, typename Epi>
  __device__ __forceinline__ static void run(const W* As, int lda, ARow arow, WRow wrow,
                                             const W* any, int K, int N, W* stages, Pre pre,
                                             Epi epi) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wk = warp / (WARPS_M * WARPS_N), wmn = warp % (WARPS_M * WARPS_N);
    const int wm = wmn / WARPS_N, wn = wmn % WARPS_N;
    const int nk = (K + BK - 1) / BK;
    constexpr int ld = tile_ld<W, BK>();
    for (int n0 = 0; n0 < N; n0 += BN) {
      auto load = [&](int kt) {
        W* st = stages + (kt % STAGES) * kStageElems;
        if constexpr (!A_RES) stage_rows<W, BM, BK>(st, arow, any, kt * BK, K);
        stage_rows<W, BN, BK>(
            st + kARows * ld,
            [&](int r) -> const W* { return n0 + r < N ? wrow(n0 + r) : nullptr; }, any,
            kt * BK, K);
      };
#pragma unroll
      for (int s = 0; s < kStagesAhead; ++s) {
        if (s < nk) load(s);
        cp_async_commit();  // empty groups keep the count uniform
      }
      if (n0 == 0) pre();
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's copies)
        __syncthreads();              // ... everyone's; and stage kt-1 is consumed
        if (kt + kStagesAhead < nk) load(kt + kStagesAhead);
        cp_async_commit();
        const W* st = stages + (kt % STAGES) * kStageElems;
        const int k_off = wk * KSPAN;
        const W* a = A_RES ? As + wm * WTM * lda + kt * BK + k_off : st + wm * WTM * ld + k_off;
        WarpMma<W, MT, NT, KSPAN>::run(acc, a, A_RES ? lda : ld,
                                       st + (kARows + wn * WTN) * ld + k_off, ld);
      }
      cp_async_wait<0>();
      __syncthreads();  // the stages are free: they hold the k groups' sums
      if constexpr (WARPS_K > 1) {
        float* red = reinterpret_cast<float*>(stages);
        constexpr int kPerWarp = MT * NT * 4 * 32;
        if (wk > 0) {
          float* dst = red + ((wk - 1) * WARPS_M * WARPS_N + wmn) * kPerWarp + lane;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i) dst[((mt * NT + nt) * 4 + i) * 32] = acc[mt][nt][i];
        }
        __syncthreads();
        if (wk == 0) {
#pragma unroll 1
          for (int j = 1; j < WARPS_K; ++j) {  // k groups in order: deterministic
            const float* src = red + ((j - 1) * WARPS_M * WARPS_N + wmn) * kPerWarp + lane;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[mt][nt][i] += src[((mt * NT + nt) * 4 + i) * 32];
          }
        }
      }
      if (wk == 0) {
        const int g = lane >> 2, t = lane & 3;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              // c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
              const int r = wm * WTM + mt * 16 + g + (i >> 1) * 8;
              const int n = n0 + wn * WTN + nt * 8 + 2 * t + (i & 1);
              if (n < N) epi(r, n, acc[mt][nt][i]);
            }
      }
      if constexpr (WARPS_K > 1) __syncthreads();  // the sums are read before a refill
    }
  }
};

// Issue (and commit as one group) the copies of the block's x rows into xs
// ([BM][C] f32, rows past n_valid left alone); C % 4 == 0 and x 16-byte
// aligned. Committed before the GEMM's first stages, so pre() can wait for
// it alone with cp_async_wait<kStagesAhead>.
__device__ __forceinline__ void stage_x_rows(float* xs, const float* __restrict__ x, int tok0,
                                             int n_valid, int C) {
  const int per_row = C / 4;
  for (int i = threadIdx.x; i < n_valid * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 4;
    cp_async16(xs + r * C + c, x + (size_t)(tok0 + r) * C + c, true);
  }
  cp_async_commit();
}

// The resident A of a launch from the staged x rows: row r < n_valid is
// rnd_W(modulate(LN(x[tok0 + r]))) stored as W (the rounding the JAX
// kernel's astype does), every other element of the [BM][lda] tile 0. One
// warp per row, reading x from shared memory.
template <typename W, typename V>
__device__ __forceinline__ void ln_modulate_rows(const float* xs, const V* __restrict__ shift,
                                                 const V* __restrict__ scale, int tok0,
                                                 int n_valid, int tok_per_batch, int C, int BM,
                                                 W* A, int lda) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < BM; r += blockDim.x >> 5) {
    W* row = A + r * lda;
    int c0 = 0;
    if (r < n_valid) {
      const int b = (tok0 + r) / tok_per_batch;
      ln_modulate<W, V, W>(xs + r * C, shift + (size_t)b * C, scale + (size_t)b * C, row, C);
      c0 = C;
    }
    for (int c = c0 + lane; c < lda; c += 32) row[c] = from_f<W>(0.f);
  }
}

// The q/k/v projection that opens the attention sublayers (kernels 1 and 2).
// Block = (32 tokens, a group of G heads): 12 warps (2 x 6, each 16 x 24),
// 4 stages; one GEMM pass covers the 3 x 48 qkv columns of 2 heads of 24.
constexpr int kQkvBM = 32;
constexpr int kQkvBN = 144;
template <typename W>
using QkvGemm = TileGemm<W, kQkvBM, kQkvBN, 2, 6, 1, true, 4>;

inline int qkv_heads_per_block(int H) { return H % 2 == 0 ? 2 : 1; }

// Shared memory of qkv_project, in this order: the GEMM stages; the
// resident A; the x rows [BM][C], whose space then holds the f32 q, k, v
// [BM][3 GW] (GW = G hd). A caller's own parts follow at this offset.
template <typename W> __host__ __device__ inline size_t qkv_smem(int C, int GW) {
  return QkvGemm<W>::smem_bytes + sizeof(W) * kQkvBM * resident_ld<W>(C) +
         sizeof(float) * kQkvBM * (size_t)(C > 3 * GW ? C : 3 * GW);
}

// q, k and v of the `used` tokens from tok0, for heads h0 .. h0 + G - 1:
// the first weight stages are issued, then LN + modulate of the rows (x
// staged by cp.async) into a resident tile rounded to W, projected onto the
// heads' 3 G hd rows of qkv_w, + bias, in f32; q scaled, then q and k roped
// at the table row pos(token) when use_rope. Returns the f32 [kQkvBM][3 GW]
// tile (q, k, v, each G heads of hd) in shared memory, after a barrier.
// Called by all threads.
template <typename W, typename V, typename Pos>
__device__ __forceinline__ float* qkv_project(
    unsigned char* smem, const float* __restrict__ x, const V* __restrict__ shift,
    const V* __restrict__ scale, const W* __restrict__ qkv_w, const V* __restrict__ qkv_b,
    const float* __restrict__ sin_t, const float* __restrict__ cos_t, int tok0, int used,
    int tok_per_batch, int C, int hd, int h0, int G, int use_rope, float q_scale, Pos pos) {
  using Gm = QkvGemm<W>;
  const int half = hd / 2, GW = G * hd, QW = 3 * GW, lda = resident_ld<W>(C);
  W* stages = reinterpret_cast<W*>(smem);
  W* As = reinterpret_cast<W*>(smem + Gm::smem_bytes);
  float* xs = reinterpret_cast<float*>(smem + Gm::smem_bytes + sizeof(W) * kQkvBM * lda);
  float* qkv = xs;  // the x rows are consumed by the LN before the GEMM's epilogue

  stage_x_rows(xs, x, tok0, used, C);
  // local column n: segment (q, k, v) n / GW, channel h0 * hd + n % GW
  auto row_of = [&](int n) { const int seg = n / GW; return seg * C + h0 * hd + (n - seg * GW); };
  Gm::run(
      As, lda, nullptr, [&](int n) { return qkv_w + (size_t)row_of(n) * C; }, qkv_w, C, QW,
      stages,
      [&] {  // LN + modulate while the first weight stages are in flight
        cp_async_wait<Gm::kStagesAhead>();
        __syncthreads();
        ln_modulate_rows<W, V>(xs, shift, scale, tok0, used, tok_per_batch, C, kQkvBM, As, lda);
      },
      [&](int r, int n, float acc) { qkv[r * QW + n] = acc + to_f(qkv_b[row_of(n)]); });
  __syncthreads();

  for (int p = threadIdx.x; p < used * G * half; p += blockDim.x) {
    const int r = p / (G * half), hl = (p / half) % G, i = p % half;
    float* q = qkv + r * QW + hl * hd;
    float* k = q + GW;
    q[i] *= q_scale;
    q[i + half] *= q_scale;
    if (use_rope) {
      const int at = pos(tok0 + r);
      rope_pair(q, i, half, sin_t + at * hd, cos_t + at * hd);
      rope_pair(k, i, half, sin_t + at * hd, cos_t + at * hd);
    }
  }
  __syncthreads();
  return qkv;
}

// y[tok, c] = x[tok, c] + gate[b, c] * (sum_k A[tok, k] w[c, k] + bias[c]):
// the last projection and gated residual of kernels 1 to 3. Block = (32
// tokens, 32 output columns), so each block reads only its slice of w; A
// and w both stream through 8 stages (K is up to 1536 here); 8 warps, two
// k groups of 2 x 2.
constexpr int kOutBM = 32, kOutBN = 32;
template <typename W>
using OutGemm = TileGemm<W, kOutBM, kOutBN, 2, 2, 2, false, 8>;

template <typename W, typename V>
__global__ void __launch_bounds__(OutGemm<W>::kThreads)
gated_out_proj_kernel(const W* __restrict__ A, const W* __restrict__ w,
                      const V* __restrict__ bias, const V* __restrict__ gate,
                      const float* __restrict__ x, float* __restrict__ y, int n_tok,
                      int tok_per_batch, int K, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* stages = reinterpret_cast<W*>(smem_raw);
  const int tok0 = blockIdx.x * kOutBM, n_valid = min(kOutBM, n_tok - tok0);
  const int c0 = blockIdx.y * kOutBN;
  OutGemm<W>::run(
      nullptr, 0,
      [&](int r) -> const W* { return r < n_valid ? A + (size_t)(tok0 + r) * K : nullptr; },
      [&](int n) { return w + (size_t)(c0 + n) * K; }, w, K, min(kOutBN, C - c0), stages,
      [] {},
      [&](int r, int n, float acc) {
        if (r >= n_valid) return;
        const int tok = tok0 + r, c = c0 + n, b = tok / tok_per_batch;
        const size_t i = (size_t)tok * C + c;
        y[i] = x[i] + to_f(gate[(size_t)b * C + c]) * (acc + to_f(bias[c]));
      });
}

template <typename W, typename V>
inline cudaError_t launch_gated_out_proj(const W* A, const void* w, const void* bias,
                                         const void* gate, const float* x, float* y, int n_tok,
                                         int tok_per_batch, int K, int C, cudaStream_t stream) {
  using G = OutGemm<W>;
  static bool smem_set = false;
  auto kernel = gated_out_proj_kernel<W, V>;
  cudaError_t e = allow_smem(kernel, G::smem_bytes, smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((n_tok + kOutBM - 1) / kOutBM, (C + kOutBN - 1) / kOutBN);
  kernel<<<grid, G::kThreads, G::smem_bytes, stream>>>(
      A, (const W*)w, (const V*)bias, (const V*)gate, x, y, n_tok, tok_per_batch, K, C);
  return cudaGetLastError();
}

// The largest dynamic shared memory a block of this card may take.
constexpr size_t kMaxSmem = 227 * 1024;

}  // namespace mdgen
