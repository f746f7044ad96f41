// Tile helpers for the port's Hopper (sm_90a) attention kernels:
// asynchronous 16-byte global->shared copies (cp.async), fragment loads
// (ldmatrix) and the bf16 tensor-core product (mma.sync m16n8k16, f32
// accumulate).
//
// Shared-memory tiles are row-major bf16 with a padded row stride of
// DMAX + 8 elements (DMAX = 64 or 128). The 16 bytes of padding put the
// eight row addresses of every 8x8 ldmatrix block on eight distinct
// four-bank groups (row r starts at bank 4r mod 32 for both strides, 144
// and 272 bytes), so the fragment loads are free of bank conflicts.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// - A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][..],
//   a2 = A[g][2t+8..], a3 = A[g+8][2t+8..].
// - B (16 x 8, "col"): b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g].
// - C (16 x 8, f32): c0, c1 = C[g][2t..2t+1]; c2, c3 = C[g+8][2t..2t+1].
// A C tile pair of two neighbouring n-tiles is, element for element, the
// A operand of the next product over those 16 columns (acc_as_a).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace edl {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes past src_bytes (0 or
// 16 here) are written as zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared (lse / delta entries); zero when src_bytes = 0.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l supplies the address of row l % 8 of
// matrix l / 8, and register i receives M_i[g][2t..2t+1].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed: register i receives M_i[2t..2t+1][g].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns [16 kc, 16 kc + 16) of a 16-row accumulator, as an A fragment.
template <int NT>
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4],
                                         const float (&c)[NT][4], int kc) {
  a[0] = pack_f32(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_f32(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_f32(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_f32(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Lane offsets (in elements, row stride STR) for ldmatrix.x4:
// - a_lane: an A fragment (16 rows x 16 cols) at (0, 0); the same
//   offsets serve ldmatrix.x4.trans of a 16-row x 16-col block read as
//   B fragments of two neighbouring 8-col n-tiles (X[k][n] row-major);
// - b_lane: B fragments of two neighbouring 8-row n-tiles of a
//   row-major (n, k) tile, k in [0, 16).
template <int STR>
__device__ __forceinline__ int a_lane(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;
}

template <int STR>
__device__ __forceinline__ int b_lane(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * STR + ((lane >> 3) & 1) * 8;
}

// s (16 x 8 NT) = A rows . B rows^T over the head dim (D <= DMAX):
// a_addr is this lane's a_lane address of the 16 A rows, b_addr its
// b_lane address of the 8 NT B rows, both in a padded DMAX tile.
template <int DMAX, int NT>
__device__ __forceinline__ void rows_dot_rows(float (&s)[NT][4],
                                              uint32_t a_addr,
                                              uint32_t b_addr, int D) {
  constexpr int STR = DMAX + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < DMAX / 16; ++kc) {
    if (kc * 16 < D) {
      uint32_t a[4];
      ldmatrix_x4(a, a_addr + kc * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_addr + (np * 16 * STR + kc * 16) * 2);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc (16 x DMAX) += C (16 x 8 NT accumulator, as A) * X (8 NT rows x
// DMAX, row-major in a padded tile): x_addr is this lane's a_lane
// address of X's first row; B fragments by ldmatrix.x4.trans.
template <int DMAX, int NT>
__device__ __forceinline__ void acc_times_rows(float (&acc)[DMAX / 8][4],
                                               const float (&c)[NT][4],
                                               uint32_t x_addr, int D) {
  constexpr int STR = DMAX + 8;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    uint32_t a[4];
    acc_as_a<NT>(a, c, kc);
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp) {
      if (dp * 16 < D) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, x_addr + (kc * 16 * STR + dp * 16) * 2);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// Rows [row0, row0 + ROWS) of an (L, D) head slice (row stride in
// elements, 16-byte aligned) -> a padded shared tile, in 16-byte
// cp.async chunks issued by NTHREADS threads; rows past L and columns
// past D arrive as zeros. The caller commits and waits.
template <int DMAX, int ROWS, int NTHREADS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        long long row_stride, int row0, int L,
                                        int D) {
  constexpr int CPR = DMAX / 8;  // 16-byte chunks per row
  constexpr int STR = DMAX + 8;
  static_assert(ROWS * CPR % NTHREADS == 0, "chunks must split evenly");
  const uint32_t base = smem_addr(dst);
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int r = idx / CPR, c = idx % CPR;
    const int row = row0 + r;
    const bool ok = row < L && c * 8 < D;
    const __nv_bfloat16* g = ok ? src + row * row_stride + c * 8 : src;
    cp_async16(base + (r * STR + c * 8) * 2, g, ok ? 16 : 0);
  }
}

}  // namespace edl
