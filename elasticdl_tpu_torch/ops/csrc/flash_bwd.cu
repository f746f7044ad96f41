// Flash-attention backward for NVIDIA Hopper (sm_90a): two kernels.
//
// Replaces the Pallas TPU kernels of elasticdl_tpu/ops/flash_attention.py:
// - flash_bwd_dq  <- `_bwd_dq_kernel`  (launched by `_flash_bwd`'s first
//   pl.pallas_call): dQ = sum_k dS K * scale,
// - flash_bwd_dkv <- `_bwd_dkv_kernel` (its second pl.pallas_call):
//   dV = sum_q P^T dO and dK = sum_q dS^T Q * scale,
// with P = exp(S * scale - lse) recomputed per tile (`_recompute_p`),
// dP = dO V^T and dS = P * (dP - delta). delta = rowsum(dO * O) - g_lse is
// computed outside, in PyTorch, as the JAX package computes it in XLA.
//
// What differs from the TPU kernels, and why:
// - The TPU walks the reduction axis (k-blocks for dQ, q-blocks for
//   dK/dV) as a sequential grid axis and carries the sums in VMEM. Blocks
//   on Hopper run in no order, so each block owns one tile of rows (of
//   queries for dQ, of keys for dK/dV) of one (batch, head) and loops over
//   the other axis itself; the sums stay in registers. Under causal
//   masking the dQ loop stops at the diagonal and the dK/dV loop starts
//   there. Two kernels and no atomics: results are deterministic.
// - Inputs stay in their (B, L, H, D) layout, read through strides (no
//   head-folding copy); lse and delta are (B, H, L) f32, not broadcast
//   over 128 lanes.
//
// Bound on this card, at the training shape (bf16, B=16, H=12, L=1024,
// D=64, causal): flash_bwd_dq must move q, k, v, dO and dq (2 bytes each)
// plus lse and delta (4 bytes): 127.4 MB, 38.0 us at 3.35 TB/s; its three
// products are 38.7 GFLOP over the visible pairs, 39.1 us at the 989
// TFLOP/s bf16 peak. flash_bwd_dkv moves one more (B, L, H, D) tensor and
// does four products: 152.6 MB (45.5 us) and 51.6 GFLOP (52.2 us). Both
// are bound by operations, the first narrowly. Every intermediate (S, P,
// dP, dS) stays on chip; device memory sees each input once per tile of
// the other axis, mostly from L2.
//
// bf16 instances (what the model trains with). A tile step of a design
// that copies with dependent 2-byte loads between two barriers waits on
// the copies, not on the tensor cores; this one is built around them:
// 1. Copies. The rows a block owns (Q and dO for dQ, K and V for dK/dV)
//    are loaded once, and the other axis streams through a two-stage ring
//    of 64-row tiles in shared memory (K and V for dQ; Q, dO and their lse
//    and delta entries for dK/dV), all by cp.async in 16-byte chunks (4
//    bytes for lse/delta). The copy of tile i + 1 is issued right after
//    the one barrier that opens tile i, so it is in flight while tile i's
//    products run. Rows past L and columns past D arrive as zeros through
//    cp.async's source-size operand. 16-byte copies need 16-byte aligned
//    bases and row strides: ops/flash_attention.py checks.
// 2. Fragments (hopper_tiles.cuh). ldmatrix.x4 loads the A fragments of
//    the owned rows and the B fragments of two n-tiles of streamed rows
//    for S = Q K^T and dP = dO V^T (S^T = K Q^T and dP^T = V dO^T for
//    dK/dV); ldmatrix.x4.trans the B fragments of dS K, P^T dO and dS^T Q.
//    Shared rows are padded by 16 bytes, which puts the eight rows of
//    every 8x8 ldmatrix block on distinct banks: no bank conflicts.
// 3. Tiles. A block owns BM rows, one warp per 16, so a staged tile
//    serves BM rows: kDqRows = 128 (8 warps) for dQ and kDkvRows = 64
//    (4 warps) for dK/dV, each the faster of 64 and 128 at the training
//    shape on an H100 (scripts/torch_flash_ab.py --tile-rows times
//    the other shape; PERF.md has the times). dQ's 124 registers let two
//    256-thread blocks share an SM; dK/dV's two D-wide accumulators need
//    ~160 registers, so three 128-thread blocks (12 warps) share an SM
//    where one 256-thread block (8 warps) would. A warp takes a
//    streamed tile in two 32-column halves, so its live S and dP are
//    16 x 32, which keeps every bf16 instance free of spills.
// 4. Mask. Only a (warp, half tile) that straddles the causal diagonal or
//    the end of the other axis computes the mask; one wholly beyond the
//    diagonal or the end is skipped. log2(e) is folded into the scale and
//    lse, P = exp2(S * scale * log2 e - lse * log2 e).
// 5. Order. The grid is (B * H, tiles) and blocks issue x first, so every
//    head's tile y issues before any head's tile y + 1. dQ maps y to
//    q-tiles from the last, which under causal masking walk the most
//    k-tiles; dK/dV's natural order already starts with the k-tiles that
//    walk the most q-tiles. The longest blocks go first, not last.
// 6. Products: mma.sync m16n8k16 with f32 accumulators. The first two
//    products' accumulators are, in layout, the A operand of the next (for
//    dK/dV they are taken transposed), so P and dS never leave registers;
//    they are rounded to bf16 for the tensor cores.
// f32 instances: plain f32 FMA on the CUDA cores (TF32 would miss the f32
// tolerance); P and dS pass through shared memory.
// Both take D up to 128 in multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr int kTile = 64;  // rows of a streamed tile (and of an f32 tile)
constexpr int kDqRows = 128;  // rows a bf16 dQ block owns
constexpr int kDkvRows = 64;  // rows a bf16 dK/dV block owns

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, H, Lq)
  const float* delta;  // (B, H, Lq)
  void* dq;
  void* dk;
  void* dv;
  int B, H, Lq, Lk, D;
  // strides in elements as (batch, seq, head); the head dim is unit-stride
  long long q_s[3], k_s[3], v_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base,
                                             const long long (&s)[3], int b,
                                             int h) {
  return static_cast<const T*>(base) + b * s[0] + h * s[2];
}

template <typename T>
__device__ __forceinline__ T* head_ptr_w(void* base, const long long (&s)[3],
                                         int b, int h) {
  return static_cast<T*>(base) + b * s[0] + h * s[2];
}

// ---------------------------------------------------------------------------
// bf16: cp.async ring, ldmatrix fragments, mma.sync tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHalf = 32;           // streamed columns a warp takes at once
constexpr int kHalfNT = kHalf / 8;  // their n-tiles

// Blocks per SM that __launch_bounds__ asks registers for, the most
// that ptxas fits without spills (its report, printed by chip_smoke.py):
// at DMAX = 64, dQ 2 x 256 threads (128 registers) or 3 x 128 (170);
// dK/dV, with two D-wide accumulators, 1 x 256 or 3 x 128. At DMAX = 128
// one block.
constexpr int bf16_min_blocks(int dmax, int rows, bool dkv) {
  return dmax > 64 ? 1 : rows == 64 ? 3 : dkv ? 1 : 2;
}

// Shared bytes: BM owned rows of two tensors, a two-stage ring of two
// 64-row tiles, and for dK/dV the ring's lse and delta entries.
constexpr size_t bf16_smem(int dmax, int rows, bool stats) {
  return static_cast<size_t>(2 * rows + 4 * kTile) * (dmax + 8) *
             sizeof(bf16) +
         (stats ? 4 * kTile * sizeof(float) : 0);
}

// One warp's 16 query rows against keys [c0, c0 + 32) of the staged K/V
// tile: S, dP, then dQ += dS K over those keys. lse0/lse1 are the rows'
// lse times log2 e.
template <int DMAX, bool MASK>
__device__ __forceinline__ void dq_half(float (&acc)[DMAX / 8][4],
                                        uint32_t q_a, uint32_t o_a,
                                        uint32_t k_b, uint32_t v_b,
                                        uint32_t k_t, const Params& p,
                                        float sl2, int row0, float lse0,
                                        float lse1, float dl0, float dl1,
                                        int c0, int t) {
  float s[kHalfNT][4], dp[kHalfNT][4];
  edl::rows_dot_rows<DMAX, kHalfNT>(s, q_a, k_b, p.D);   // S = Q K^T
  edl::rows_dot_rows<DMAX, kHalfNT>(dp, o_a, v_b, p.D);  // dP = dO V^T
#pragma unroll
  for (int nt = 0; nt < kHalfNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool lo = e < 2;
      float pv = exp2f(fmaf(s[nt][e], sl2, lo ? -lse0 : -lse1));
      if (MASK) {
        const int col = c0 + nt * 8 + 2 * t + (e & 1);
        const int row = lo ? row0 : row0 + 8;
        if (col >= p.Lk || (p.causal && col > row)) pv = 0.f;
      }
      s[nt][e] = pv * (dp[nt][e] - (lo ? dl0 : dl1));  // dS
    }
  }
  edl::acc_times_rows<DMAX, kHalfNT>(acc, s, k_t, p.D);  // dQ += dS K
}

template <int DMAX, int BM>
__global__ void __launch_bounds__(BM * 2, bf16_min_blocks(DMAX, BM, false))
    flash_bwd_dq_bf16(Params p) {
  constexpr int STR = DMAX + 8;
  constexpr int NDT = DMAX / 8;
  constexpr int NT = BM * 2;         // threads: one warp per 16 rows
  constexpr int TILE = kTile * STR;  // elements of one staged tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + BM * STR;    // dO
  bf16* ring = Os + BM * STR;  // stage s: K at ring + 2 s TILE, then V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  // the last q-tiles walk the most k-tiles under causal masking: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int D = p.D;
  const int wr = warp * 16;

  const bf16* kp = head_ptr<bf16>(p.k, p.k_s, b, h);
  const bf16* vp = head_ptr<bf16>(p.v, p.v_s, b, h);
  edl::cp_rows<DMAX, BM, NT>(Qs, head_ptr<bf16>(p.q, p.q_s, b, h),
                             p.q_s[1], q0, p.Lq, D);
  edl::cp_rows<DMAX, BM, NT>(Os, head_ptr<bf16>(p.dout, p.do_s, b, h),
                             p.do_s[1], q0, p.Lq, D);
  edl::cp_rows<DMAX, kTile, NT>(ring, kp, p.k_s[1], 0, p.Lk, D);
  edl::cp_rows<DMAX, kTile, NT>(ring + TILE, vp, p.v_s[1], 0, p.Lk, D);
  edl::cp_async_commit();

  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const long long st = static_cast<long long>(bh) * p.Lq;
  const float lse0 = row0 < p.Lq ? p.lse[st + row0] * kLog2e : 0.f;
  const float lse1 = row1 < p.Lq ? p.lse[st + row1] * kLog2e : 0.f;
  const float dl0 = row0 < p.Lq ? p.delta[st + row0] : 0.f;
  const float dl1 = row1 < p.Lq ? p.delta[st + row1] : 0.f;
  const float sl2 = p.scale * kLog2e;

  float acc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  const int k_end = p.causal ? min(p.Lk, q0 + BM) : p.Lk;
  const int n_kt = (k_end + kTile - 1) / kTile;
  const uint32_t q_a = edl::smem_addr(Qs + wr * STR + edl::a_lane<STR>(lane));
  const uint32_t o_a = edl::smem_addr(Os + wr * STR + edl::a_lane<STR>(lane));
  const uint32_t ring_a = edl::smem_addr(ring);
  const uint32_t b_off = edl::b_lane<STR>(lane) * 2;  // bytes
  const uint32_t t_off = edl::a_lane<STR>(lane) * 2;

  for (int it = 0; it < n_kt; ++it) {
    edl::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_kt) {  // its stage is free: copy during tile it
      bf16* nxt = ring + ((it + 1) & 1) * 2 * TILE;
      edl::cp_rows<DMAX, kTile, NT>(nxt, kp, p.k_s[1], (it + 1) * kTile,
                                    p.Lk, D);
      edl::cp_rows<DMAX, kTile, NT>(nxt + TILE, vp, p.v_s[1],
                                    (it + 1) * kTile, p.Lk, D);
      edl::cp_async_commit();
    }
    const int k0 = it * kTile;
    const uint32_t ks = ring_a + (it & 1) * 2 * TILE * 2;
    const uint32_t vs = ks + TILE * 2;
#pragma unroll
    for (int half = 0; half < kTile / kHalf; ++half) {
      const int c0 = k0 + half * kHalf;
      // every pair of this warp's rows with these keys masked: skip
      if (c0 >= p.Lk || (p.causal && c0 > q0 + wr + 15)) continue;
      const uint32_t hk = half * kHalf * STR * 2;
      if (c0 + kHalf > p.Lk || (p.causal && c0 + kHalf - 1 > q0 + wr)) {
        dq_half<DMAX, true>(acc, q_a, o_a, ks + hk + b_off, vs + hk + b_off,
                            ks + hk + t_off, p, sl2, row0, lse0, lse1, dl0,
                            dl1, c0, t);
      } else {
        dq_half<DMAX, false>(acc, q_a, o_a, ks + hk + b_off,
                             vs + hk + b_off, ks + hk + t_off, p, sl2, row0,
                             lse0, lse1, dl0, dl1, c0, t);
      }
    }
  }
  edl::cp_async_wait<0>();

  bf16* op = head_ptr_w<bf16>(p.dq, p.dq_s, b, h);
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    if (dt * 8 < D) {
      const int col = dt * 8 + 2 * t;
      if (row0 < p.Lq) {
        *reinterpret_cast<__nv_bfloat162*>(op + row0 * p.dq_s[1] + col) =
            __floats2bfloat162_rn(acc[dt][0] * p.scale,
                                  acc[dt][1] * p.scale);
      }
      if (row1 < p.Lq) {
        *reinterpret_cast<__nv_bfloat162*>(op + row1 * p.dq_s[1] + col) =
            __floats2bfloat162_rn(acc[dt][2] * p.scale,
                                  acc[dt][3] * p.scale);
      }
    }
  }
}

// One warp's 16 key rows against queries [c0, c0 + 32) of the staged
// Q/dO tile: S^T, dP^T, then dV += P^T dO and dK += dS^T Q over those
// queries. lse_s and dl_s point at the half's 32 entries.
template <int DMAX, bool MASK>
__device__ __forceinline__ void dkv_half(
    float (&dk)[DMAX / 8][4], float (&dv)[DMAX / 8][4], uint32_t k_a,
    uint32_t v_a, uint32_t q_b, uint32_t o_b, uint32_t q_t, uint32_t o_t,
    const float* lse_s, const float* dl_s, const Params& p, float sl2,
    int krow0, int c0, int t) {
  float s[kHalfNT][4], dp[kHalfNT][4];
  edl::rows_dot_rows<DMAX, kHalfNT>(s, k_a, q_b, p.D);   // S^T = K Q^T
  edl::rows_dot_rows<DMAX, kHalfNT>(dp, v_a, o_b, p.D);  // dP^T = V dO^T
#pragma unroll
  for (int nt = 0; nt < kHalfNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = nt * 8 + 2 * t + (e & 1);
      float pv = exp2f(fmaf(s[nt][e], sl2, -lse_s[qc] * kLog2e));
      if (MASK) {
        const int qrow = c0 + qc;
        const int krow = e < 2 ? krow0 : krow0 + 8;
        if (qrow >= p.Lq || (p.causal && krow > qrow)) pv = 0.f;
      }
      s[nt][e] = pv;                            // P^T
      dp[nt][e] = pv * (dp[nt][e] - dl_s[qc]);  // dS^T
    }
  }
  edl::acc_times_rows<DMAX, kHalfNT>(dv, s, o_t, p.D);   // dV += P^T dO
  edl::acc_times_rows<DMAX, kHalfNT>(dk, dp, q_t, p.D);  // dK += dS^T Q
}

template <int DMAX, int BM>
__global__ void __launch_bounds__(BM * 2, bf16_min_blocks(DMAX, BM, true))
    flash_bwd_dkv_bf16(Params p) {
  constexpr int STR = DMAX + 8;
  constexpr int NDT = DMAX / 8;
  constexpr int NT = BM * 2;
  constexpr int TILE = kTile * STR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BM * STR;
  bf16* ring = Vs + BM * STR;  // stage s: Q at ring + 2 s TILE, then dO
  float* stats = reinterpret_cast<float*>(ring + 4 * TILE);
  // stage s: lse at stats + 2 s kTile, then delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * BM;
  const int D = p.D;
  const int wr = warp * 16;

  const bf16* qp = head_ptr<bf16>(p.q, p.q_s, b, h);
  const bf16* dop = head_ptr<bf16>(p.dout, p.do_s, b, h);
  const long long st = static_cast<long long>(bh) * p.Lq;
  // q-tiles entirely above the diagonal see this k-tile masked
  const int q_begin = p.causal ? k0 : 0;
  const int n_qt = q_begin < p.Lq ? (p.Lq - q_begin + kTile - 1) / kTile : 0;

  auto stage = [&](int it) {  // Q, dO, lse, delta of q-tile it
    const int q0 = q_begin + it * kTile;
    bf16* dst = ring + (it & 1) * 2 * TILE;
    edl::cp_rows<DMAX, kTile, NT>(dst, qp, p.q_s[1], q0, p.Lq, D);
    edl::cp_rows<DMAX, kTile, NT>(dst + TILE, dop, p.do_s[1], q0, p.Lq, D);
    if (threadIdx.x < 2 * kTile) {
      const int row = q0 + (threadIdx.x & (kTile - 1));
      const float* src = (threadIdx.x < kTile ? p.lse : p.delta) + st;
      const bool ok = row < p.Lq;
      edl::cp_async4(
          edl::smem_addr(stats + (it & 1) * 2 * kTile + threadIdx.x),
          ok ? src + row : src, ok ? 4 : 0);
    }
  };

  edl::cp_rows<DMAX, BM, NT>(Ks, head_ptr<bf16>(p.k, p.k_s, b, h),
                             p.k_s[1], k0, p.Lk, D);
  edl::cp_rows<DMAX, BM, NT>(Vs, head_ptr<bf16>(p.v, p.v_s, b, h),
                             p.v_s[1], k0, p.Lk, D);
  if (n_qt > 0) stage(0);
  edl::cp_async_commit();

  // this thread's two key rows: g and g + 8 of the warp's 16
  const int krow0 = k0 + wr + g, krow1 = krow0 + 8;
  const float sl2 = p.scale * kLog2e;
  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }
  const uint32_t k_a = edl::smem_addr(Ks + wr * STR + edl::a_lane<STR>(lane));
  const uint32_t v_a = edl::smem_addr(Vs + wr * STR + edl::a_lane<STR>(lane));
  const uint32_t ring_a = edl::smem_addr(ring);
  const uint32_t b_off = edl::b_lane<STR>(lane) * 2;  // bytes
  const uint32_t t_off = edl::a_lane<STR>(lane) * 2;

  for (int it = 0; it < n_qt; ++it) {
    edl::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_qt) {  // its stage is free: copy during tile it
      stage(it + 1);
      edl::cp_async_commit();
    }
    const int q0 = q_begin + it * kTile;
    const uint32_t qs = ring_a + (it & 1) * 2 * TILE * 2;
    const uint32_t os = qs + TILE * 2;
    const float* ls = stats + (it & 1) * 2 * kTile;
#pragma unroll
    for (int half = 0; half < kTile / kHalf; ++half) {
      const int c0 = q0 + half * kHalf;
      // every pair of this warp's keys with these queries masked: skip
      if (c0 >= p.Lq || (p.causal && c0 + kHalf - 1 < k0 + wr)) continue;
      const uint32_t hq = half * kHalf * STR * 2;
      const float* lh = ls + half * kHalf;
      if (c0 + kHalf > p.Lq || (p.causal && c0 < k0 + wr + 15)) {
        dkv_half<DMAX, true>(dk, dv, k_a, v_a, qs + hq + b_off,
                             os + hq + b_off, qs + hq + t_off,
                             os + hq + t_off, lh, lh + kTile, p, sl2, krow0,
                             c0, t);
      } else {
        dkv_half<DMAX, false>(dk, dv, k_a, v_a, qs + hq + b_off,
                              os + hq + b_off, qs + hq + t_off,
                              os + hq + t_off, lh, lh + kTile, p, sl2,
                              krow0, c0, t);
      }
    }
  }
  edl::cp_async_wait<0>();

  bf16* kop = head_ptr_w<bf16>(p.dk, p.dk_s, b, h);
  bf16* vop = head_ptr_w<bf16>(p.dv, p.dv_s, b, h);
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    if (dt * 8 < D) {
      const int col = dt * 8 + 2 * t;
      if (krow0 < p.Lk) {
        *reinterpret_cast<__nv_bfloat162*>(kop + krow0 * p.dk_s[1] + col) =
            __floats2bfloat162_rn(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(vop + krow0 * p.dv_s[1] + col) =
            __floats2bfloat162_rn(dv[dt][0], dv[dt][1]);
      }
      if (krow1 < p.Lk) {
        *reinterpret_cast<__nv_bfloat162*>(kop + krow1 * p.dk_s[1] + col) =
            __floats2bfloat162_rn(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(vop + krow1 * p.dv_s[1] + col) =
            __floats2bfloat162_rn(dv[dt][2], dv[dt][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kSst = kTile + 1;  // padded stride of a 64x64 score tile

// rows [row0, row0 + 64) of a (L, D) head slice -> smem (stride D + 1),
// zero past L
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0,
                                              int L, int D) {
  const int st = D + 1;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kF32Threads) {
    const int r = idx / D, c = idx - r * D;
    const int row = row0 + r;
    dst[r * st + c] = row < L ? src[row * row_stride + c] : 0.f;
  }
}

// thread (ty, tx) owns tile rows ty + 16 i and tile cols tx + 16 j:
// s = A rows . B rows, dp = C rows . E rows, over the head dim
__device__ __forceinline__ void two_dots_f32(float (&s)[4][4],
                                             float (&dp)[4][4],
                                             const float* as, const float* bs,
                                             const float* cs, const float* es,
                                             int D, int ty, int tx) {
  const int st = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  }
  for (int d = 0; d < D; ++d) {
    float a[4], c[4], bb[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = as[(ty + 16 * i) * st + d];
      c[i] = cs[(ty + 16 * i) * st + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bb[j] = bs[(tx + 16 * j) * st + d];
      e[j] = es[(tx + 16 * j) * st + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(256) flash_bwd_dq_f32(Params p) {
  constexpr int NJ = DMAX / 16;  // head-dim columns per thread
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int st = D + 1;
  float* Qs = smem;
  float* Os = Qs + kTile * st;  // dO
  float* Ks = Os + kTile * st;
  float* Vs = Ks + kTile * st;
  float* Ss = Vs + kTile * st;  // dS
  float* lse_s = Ss + kTile * kSst;
  float* dl_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const long long sto = static_cast<long long>(bh) * p.Lq;

  load_tile_f32(Qs, head_ptr<float>(p.q, p.q_s, b, h), p.q_s[1], q0, p.Lq,
                D);
  load_tile_f32(Os, head_ptr<float>(p.dout, p.do_s, b, h), p.do_s[1], q0,
                p.Lq, D);
  if (tid < kTile) {
    const int row = q0 + tid;
    lse_s[tid] = row < p.Lq ? p.lse[sto + row] : 0.f;
    dl_s[tid] = row < p.Lq ? p.delta[sto + row] : 0.f;
  }
  const float* kp = head_ptr<float>(p.k, p.k_s, b, h);
  const float* vp = head_ptr<float>(p.v, p.v_s, b, h);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int k_end = p.causal ? min(p.Lk, q0 + kTile) : p.Lk;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile_f32(Ks, kp, p.k_s[1], k0, p.Lk, D);
    load_tile_f32(Vs, vp, p.v_s[1], k0, p.Lk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_dots_f32(s, dp, Qs, Ks, Os, Vs, D, ty, tx);  // S, dP
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int row = q0 + r, col = k0 + c;
        const bool vis = col < p.Lk && !(p.causal && col > row);
        const float pv = vis ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
        Ss[r * kSst + c] = pv * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {  // dQ += dS K
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty + 16 * i) * kSst + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float kv = c < D ? Ks[kk * st + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

  float* op = head_ptr_w<float>(p.dq, p.dq_s, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < p.Lq) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) op[row * p.dq_s[1] + c] = acc[i][j] * p.scale;
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(256) flash_bwd_dkv_f32(Params p) {
  constexpr int NJ = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int st = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kTile * st;
  float* Qs = Vs + kTile * st;
  float* Os = Qs + kTile * st;  // dO
  float* Ps = Os + kTile * st;  // P^T
  float* Ds = Ps + kTile * kSst;  // dS^T
  float* lse_s = Ds + kTile * kSst;
  float* dl_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kTile;
  const long long sto = static_cast<long long>(bh) * p.Lq;

  load_tile_f32(Ks, head_ptr<float>(p.k, p.k_s, b, h), p.k_s[1], k0, p.Lk,
                D);
  load_tile_f32(Vs, head_ptr<float>(p.v, p.v_s, b, h), p.v_s[1], k0, p.Lk,
                D);
  const float* qp = head_ptr<float>(p.q, p.q_s, b, h);
  const float* dop = head_ptr<float>(p.dout, p.do_s, b, h);

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  }
  const int q_begin = p.causal ? k0 : 0;

  for (int q0 = q_begin; q0 < p.Lq; q0 += kTile) {
    __syncthreads();
    load_tile_f32(Qs, qp, p.q_s[1], q0, p.Lq, D);
    load_tile_f32(Os, dop, p.do_s[1], q0, p.Lq, D);
    if (tid < kTile) {
      const int row = q0 + tid;
      lse_s[tid] = row < p.Lq ? p.lse[sto + row] : 0.f;
      dl_s[tid] = row < p.Lq ? p.delta[sto + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    two_dots_f32(s, dp, Ks, Qs, Vs, Os, D, ty, tx);  // S^T, dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = ty + 16 * i, qc = tx + 16 * j;
        const int krow = k0 + kr, qrow = q0 + qc;
        const bool vis = qrow < p.Lq && !(p.causal && krow > qrow);
        const float pv = vis ? expf(s[i][j] * p.scale - lse_s[qc]) : 0.f;
        Ps[kr * kSst + qc] = pv;
        Ds[kr * kSst + qc] = pv * (dp[i][j] - dl_s[qc]);
      }
    }
    __syncthreads();

    for (int qq = 0; qq < kTile; ++qq) {  // dV += P^T dO, dK += dS^T Q
      float pr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Ps[(ty + 16 * i) * kSst + qq];
        dr[i] = Ds[(ty + 16 * i) * kSst + qq];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float ov = c < D ? Os[qq * st + c] : 0.f;
        const float qv = c < D ? Qs[qq * st + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pr[i], ov, dv[i][j]);
          dk[i][j] = fmaf(dr[i], qv, dk[i][j]);
        }
      }
    }
  }

  float* kop = head_ptr_w<float>(p.dk, p.dk_s, b, h);
  float* vop = head_ptr_w<float>(p.dv, p.dv_s, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < p.Lk) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) {
          kop[row * p.dk_s[1] + c] = dk[i][j] * p.scale;
          vop[row * p.dv_s[1] + c] = dv[i][j];
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const Params& p, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

void copy3(long long (&dst)[3], const long long* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

bool fill(Params& p, const long long* dims, float scale, int causal) {
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.Lq = static_cast<int>(dims[2]);
  p.Lk = static_cast<int>(dims[3]);
  p.D = static_cast<int>(dims[4]);
  p.scale = scale;
  p.causal = causal;
  return p.D > 0 && p.D <= 128 && p.D % 8 == 0 && p.Lq > 0 && p.Lk > 0 &&
         p.B * p.H > 0 && p.B * p.H <= 65535;
}

}  // namespace

// dims: B, H, Lq, Lk, D. strides (elements): q, k, v, dO, dq, each as
// (batch, seq, head); the head dim must be unit-stride. lse and delta are
// (B, H, Lq) float32, contiguous. dtype: 0 float32, 1 bfloat16. Returns a
// cudaError_t (0 on a successful launch).
extern "C" int edl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const long long* dims,
                                const long long* strides, int dtype,
                                int causal, float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  copy3(p.q_s, strides);
  copy3(p.k_s, strides + 3);
  copy3(p.v_s, strides + 6);
  copy3(p.do_s, strides + 9);
  copy3(p.dq_s, strides + 12);
  if (!fill(p, dims, scale, causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    constexpr int BM = kDqRows;
    const dim3 grid(p.B * p.H, (p.Lq + BM - 1) / BM);
    err = p.D <= 64
              ? launch(flash_bwd_dq_bf16<64, BM>, grid, 2 * BM,
                       bf16_smem(64, BM, false), p, st)
              : launch(flash_bwd_dq_bf16<128, BM>, grid, 2 * BM,
                       bf16_smem(128, BM, false), p, st);
  } else if (dtype == 0) {
    const dim3 tiles((p.Lq + kTile - 1) / kTile, p.B * p.H);
    const size_t smem =
        (4 * kTile * (p.D + 1) + kTile * kSst + 2 * kTile) * sizeof(float);
    err = p.D <= 64
              ? launch(flash_bwd_dq_f32<64>, tiles, kF32Threads, smem, p, st)
              : launch(flash_bwd_dq_f32<128>, tiles, kF32Threads, smem, p,
                       st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As edl_flash_bwd_dq; strides: q, k, v, dO, dk, dv.
extern "C" int edl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const long long* dims,
                                 const long long* strides, int dtype,
                                 int causal, float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  copy3(p.q_s, strides);
  copy3(p.k_s, strides + 3);
  copy3(p.v_s, strides + 6);
  copy3(p.do_s, strides + 9);
  copy3(p.dk_s, strides + 12);
  copy3(p.dv_s, strides + 15);
  if (!fill(p, dims, scale, causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    constexpr int BM = kDkvRows;
    const dim3 grid(p.B * p.H, (p.Lk + BM - 1) / BM);
    err = p.D <= 64
              ? launch(flash_bwd_dkv_bf16<64, BM>, grid, 2 * BM,
                       bf16_smem(64, BM, true), p, st)
              : launch(flash_bwd_dkv_bf16<128, BM>, grid, 2 * BM,
                       bf16_smem(128, BM, true), p, st);
  } else if (dtype == 0) {
    const dim3 tiles((p.Lk + kTile - 1) / kTile, p.B * p.H);
    const size_t smem = (4 * kTile * (p.D + 1) + 2 * kTile * kSst +
                         2 * kTile) *
                        sizeof(float);
    err = p.D <= 64
              ? launch(flash_bwd_dkv_f32<64>, tiles, kF32Threads, smem, p,
                       st)
              : launch(flash_bwd_dkv_f32<128>, tiles, kF32Threads, smem, p,
                       st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
