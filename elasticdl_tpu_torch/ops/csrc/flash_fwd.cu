// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (elasticdl_tpu/ops/flash_attention.py, launched by `_flash_fwd`'s
// pl.pallas_call). It computes the same function: per (batch, head) the
// online-softmax attention forward with running max m, running sum l and
// the output accumulator kept in f32, blocks above the causal diagonal
// skipped, out = acc / l and lse = m + log(l).
//
// What differs from the TPU kernel, and why:
// - The TPU walks k-blocks on a sequential third grid axis and carries
//   m/l/acc in VMEM scratch between grid steps. Blocks on Hopper run in
//   no order, so each block owns one (q-tile, batch*head) pair and
//   walks the k-tiles in a loop; m, l and acc never leave the SM.
//   Under causal masking that loop stops at the diagonal.
// - q, k, v and out stay in their (B, L, H, D) layout and are read
//   through strides: no head-folding transpose copy (`_fold_heads`).
// - lse is written as (B, H, L) f32, not broadcast over 128 lanes.
//
// Bound on this card, at the training shape (bf16, B=16, H=12, L=1024,
// D=64, causal): the kernel must read q, k, v and write out (2 bytes
// each) plus lse (4 bytes): 101.5 MB, 30.3 us at 3.35 TB/s; its two
// products over the visible pairs are 25.8 GFLOP, 26.1 us at the 989
// TFLOP/s bf16 tensor-core peak. So memory bounds it, narrowly (the
// serving shape, B=8, is half of both). Every intermediate (scores,
// probabilities, m, l, acc) stays on chip; device memory sees each input
// once per q-tile and each output once. K/V are re-read once per q-tile,
// mostly from L2.
//
// bf16 instances (what the model runs), built around the tensor cores:
// 1. Copies. A block's Q rows are copied once, K and V stream through a
//    two-stage ring of 64-row tiles in shared memory, all by cp.async in
//    16-byte chunks (hopper_tiles.cuh). The copy of tile i + 1 is issued
//    right after the one barrier that opens tile i, so it is in flight
//    while tile i's products run. Rows past L and columns past D arrive
//    as zeros through cp.async's source-size operand. 16-byte copies need
//    16-byte aligned bases and row strides: ops/flash_attention.py checks.
// 2. Fragments. Q's A fragments come by ldmatrix.x4 from the block's
//    shared Q rows at every tile, K's B fragments by ldmatrix.x4 and V's
//    by ldmatrix.x4.trans, two n-tiles per load (rows_dot_rows and
//    acc_times_rows). Held in registers for the whole loop, Q's fragments
//    pushed the D = 64 instance past the 128 registers that two blocks
//    per SM allow, and it spilled; the reload costs ~1 % (PERF.md).
//    Shared rows are padded by 16 bytes: no bank conflicts. The QK^T
//    accumulator is, in layout, the A operand of PV (acc_as_a), so P
//    never leaves registers; it is rounded to bf16 for the tensor cores.
// 3. Tiles. A block owns kFwdRows query rows, one warp per 16, so a
//    staged K/V tile serves kFwdRows rows. 128 (8 warps, two blocks per
//    SM) against 64 (4 warps, four blocks) was timed on an H100
//    (scripts/torch_flash_ab.py --tile-rows; PERF.md has the times) and
//    the faster is fixed here; at 64 rows and D = 64 the 128-register cap
//    of four blocks spills.
// 4. Softmax. Scores stay raw; scale * log2(e) is folded into one FMA
//    per element ahead of ex2.approx, so m and l live in the log2 domain
//    and lse = (m * scale * log2 e + log2 l) * ln 2 comes out in
//    natural-log units, as the backward kernels read it. Only a (warp,
//    tile) that straddles the causal diagonal or the end of Lk computes
//    the mask; one wholly beyond the diagonal is skipped.
// 5. Order. The grid is (B * H, q-tiles) and blocks issue x first; y maps
//    to q-tiles from the last, which under causal masking walk the most
//    k-tiles, so the longest blocks issue first, not last.
// 6. Stores. Each warp stages its normalized 16 output rows in its own
//    (now idle) Q rows and writes them back in 16-byte stores; lse is
//    written once per row.
// f32 instances: plain f32 FMA on the CUDA cores (no TF32: it would miss
// the f32 tolerance); K/V tiles are staged in shared memory.
// Both take D up to 128 in multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kBlockQ = 64;   // query rows of an f32 block
constexpr int kBlockK = 64;   // keys of a staged K/V tile
constexpr int kFwdRows = 128;  // query rows a bf16 block owns

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Lq, Lk, D;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// bf16: cp.async ring, ldmatrix fragments, mma.sync tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kKeyNT = kBlockK / 8;  // key n-tiles of a staged tile

// 2^x by the special-function unit, denormal results flushed to zero.
// exp2f wraps the same instruction in a fix-up for the denormal range;
// this was ~10 % faster at the training shape and bitwise equal on every
// case chip_smoke.py checks (PERF.md).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Blocks per SM that __launch_bounds__ asks registers for: at DMAX = 64,
// two 256-thread blocks or four 128-thread blocks (128 registers each);
// at DMAX = 128 one block.
constexpr int fwd_min_blocks(int dmax, int rows) {
  return dmax > 64 ? 1 : rows == 64 ? 4 : 2;
}

// Shared bytes: the block's Q rows and a two-stage ring of K and V tiles.
constexpr size_t fwd_smem(int dmax, int rows) {
  return static_cast<size_t>(rows + 4 * kBlockK) * (dmax + 8) * sizeof(bf16);
}

// One warp's 16 query rows against the staged K/V tile: S, the
// online-softmax update of (m, l, acc), then acc += P V. m0/m1 are the
// rows' running maxima of the raw scores, l0/l1 this lane's partial sums
// of exp2 over its columns. With MASK, element e of n-tile nt (key
// k0 + 2t + nt * 8 + e % 2) is masked where nt * 8 + e % 2 reaches lim0
// (row g) or lim1 (row g + 8).
template <int DMAX, bool MASK>
__device__ __forceinline__ void fwd_tile(float (&acc)[DMAX / 8][4],
                                         float& m0, float& m1, float& l0,
                                         float& l1,
                                         uint32_t q_a, uint32_t k_b,
                                         uint32_t v_t, int D, float sl2,
                                         int lim0, int lim1) {
  float s[kKeyNT][4];
  edl::rows_dot_rows<DMAX, kKeyNT>(s, q_a, k_b, D);  // S = Q K^T
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < kKeyNT; ++nt) {
    if (MASK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (nt * 8 + (e & 1) >= (e < 2 ? lim0 : lim1)) s[nt][e] = kNegInf;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  // a row's four lanes share it: reduce the maxima over the quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float al0 = ex2((m0 - mn0) * sl2), al1 = ex2((m1 - mn1) * sl2);
  m0 = mn0;
  m1 = mn1;
  const float nb0 = -mn0 * sl2, nb1 = -mn1 * sl2;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kKeyNT; ++nt) {
    s[nt][0] = ex2(fmaf(s[nt][0], sl2, nb0));
    s[nt][1] = ex2(fmaf(s[nt][1], sl2, nb0));
    s[nt][2] = ex2(fmaf(s[nt][2], sl2, nb1));
    s[nt][3] = ex2(fmaf(s[nt][3], sl2, nb1));
    rs0 += s[nt][0] + s[nt][1];
    rs1 += s[nt][2] + s[nt][3];
  }
  // alpha is uniform across the quad, so the quad's partial sums add up
  // to the row sum (reduced once, at the end)
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
    acc[dt][0] *= al0;
    acc[dt][1] *= al0;
    acc[dt][2] *= al1;
    acc[dt][3] *= al1;
  }
  edl::acc_times_rows<DMAX, kKeyNT>(acc, s, v_t, D);  // acc += P V
}

template <int DMAX, int BM>
__global__ void __launch_bounds__(BM * 2, fwd_min_blocks(DMAX, BM))
    flash_fwd_bf16(Params p) {
  constexpr int STR = DMAX + 8;
  constexpr int CPR = DMAX / 8;        // 16-byte chunks per row
  constexpr int NT = BM * 2;           // threads: one warp per 16 rows
  constexpr int TILE = kBlockK * STR;  // elements of one staged tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + BM * STR;  // stage s: K at ring + 2 s TILE, then V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  // the last q-tiles walk the most k-tiles under causal masking: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int D = p.D;
  const int wr = warp * 16;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  edl::cp_rows<DMAX, BM, NT>(
      Qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_sl,
      q0, p.Lq, D);
  edl::cp_rows<DMAX, kBlockK, NT>(ring, kp, p.k_sl, 0, p.Lk, D);
  edl::cp_rows<DMAX, kBlockK, NT>(ring + TILE, vp, p.v_sl, 0, p.Lk, D);
  edl::cp_async_commit();
  const uint32_t q_a = edl::smem_addr(Qs + wr * STR + edl::a_lane<STR>(lane));

  float acc[DMAX / 8][4];
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * kLog2e;
  const int k_end = p.causal ? min(p.Lk, q0 + BM) : p.Lk;
  const int n_kt = (k_end + kBlockK - 1) / kBlockK;
  const uint32_t ring_a = edl::smem_addr(ring);
  const uint32_t b_off = edl::b_lane<STR>(lane) * 2;  // bytes
  const uint32_t t_off = edl::a_lane<STR>(lane) * 2;

  for (int it = 0; it < n_kt; ++it) {
    edl::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; every warp is done with it - 1
    if (it + 1 < n_kt) {  // its stage is free: copy during tile it
      bf16* nxt = ring + ((it + 1) & 1) * 2 * TILE;
      edl::cp_rows<DMAX, kBlockK, NT>(nxt, kp, p.k_sl, (it + 1) * kBlockK,
                                      p.Lk, D);
      edl::cp_rows<DMAX, kBlockK, NT>(nxt + TILE, vp, p.v_sl,
                                      (it + 1) * kBlockK, p.Lk, D);
      edl::cp_async_commit();
    }
    const int k0 = it * kBlockK;
    // every pair of this warp's rows with these keys masked: skip
    if (p.causal && k0 > q0 + wr + 15) continue;
    const uint32_t ks = ring_a + (it & 1) * 2 * TILE * 2;
    const uint32_t vs = ks + TILE * 2;
    if (k0 + kBlockK > p.Lk || (p.causal && k0 + kBlockK - 1 > q0 + wr)) {
      // this lane's first masked column offset: past Lk, or past its row
      const int end = p.Lk - k0 - 2 * t;
      const int diag = row0 + 1 - k0 - 2 * t;
      fwd_tile<DMAX, true>(acc, m0, m1, l0, l1, q_a, ks + b_off, vs + t_off,
                           D, sl2, p.causal ? min(end, diag) : end,
                           p.causal ? min(end, diag + 8) : end);
    } else {
      fwd_tile<DMAX, false>(acc, m0, m1, l0, l1, q_a, ks + b_off, vs + t_off,
                            D, sl2, 0, 0);
    }
  }
  edl::cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // stage the warp's 16 normalized rows in its own Q rows (no other warp
  // reads them), then write them back in 16-byte stores
  __syncwarp();  // every lane's last Q fragment load is done
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* stage = Qs + wr * STR;
#pragma unroll
  for (int dt = 0; dt < DMAX / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * STR + col) =
        __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * STR + col) =
        __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  __syncwarp();
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < 16 * CPR / 32; ++j) {
    const int i = lane + 32 * j;
    const int r = i / CPR, c = i % CPR;
    const int row = q0 + wr + r;
    if (row < p.Lq && c * 8 < D) {
      *reinterpret_cast<uint4*>(op + row * p.o_sl + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * STR + c * 8);
    }
  }
  if (t == 0) {
    float* lp = p.lse + static_cast<long long>(bh) * p.Lq;
    if (row0 < p.Lq) lp[row0] = (m0 * sl2 + log2f(l0)) * kLn2;
    if (row1 < p.Lq) lp[row1] = (m1 * sl2 + log2f(l1)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

template <int DMAX>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int NT = 256;
  constexpr int NJ = DMAX / 16;      // head-dim columns per thread
  constexpr int SST = kBlockK + 1;   // padded score-row stride
  extern __shared__ __align__(16) float smem[];
  const int D = p.D;
  const int qst = D + 1;  // padded Q/K row stride: conflict-free column reads
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * qst;
  float* Vs = Ks + kBlockK * qst;
  float* Ss = Vs + kBlockK * D;
  float* m_s = Ss + kBlockQ * SST;
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < kBlockQ * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    const int row = q0 + r;
    Qs[r * qst + c] = row < p.Lq ? qp[row * p.q_sl + c] : 0.f;
  }
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int k_end = p.causal ? min(p.Lk, q0 + kBlockQ) : p.Lk;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();
    for (int idx = tid; idx < kBlockK * D; idx += NT) {
      const int r = idx / D, c = idx - r * D;
      const int row = k0 + r;
      const bool ok = row < p.Lk;
      Ks[r * qst + c] = ok ? kp[row * p.k_sl + c] : 0.f;
      Vs[r * D + c] = ok ? vp[row * p.v_sl + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * qst + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * qst + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float val = s[i][j] * p.scale;
        if (k0 + c >= p.Lk || (p.causal && k0 + c > q0 + r)) val = kNegInf;
        Ss[r * SST + c] = val;
      }
    }
    __syncthreads();

    {  // row statistics: 4 neighbouring lanes per row
      const int r = tid >> 2, part = tid & 3;
      float* srow = Ss + r * SST;
      float mx = kNegInf;
      for (int c = part; c < kBlockK; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < kBlockK; c += 4) {
        const float e = expf(srow[c] - m_new);
        srow[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SST + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float vv = c < D ? Vs[kk * D + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row < p.Lq) {
      const float l = l_s[r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) op[row * p.o_sl + c] = acc[i][j] / l;
      }
    }
  }
  if (tid < kBlockQ && q0 + tid < p.Lq) {
    p.lse[static_cast<long long>(bh) * p.Lq + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
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

}  // namespace

// dims: B, H, Lq, Lk, D. strides (elements): q, k, v, out, each as
// (batch, seq, head); the head dim must be unit-stride. dtype: 0 float32,
// 1 bfloat16. Returns a cudaError_t (0 on a successful launch).
extern "C" int edl_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const long long* dims,
                             const long long* strides, int dtype,
                             int causal, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = static_cast<float*>(lse);
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.Lq = static_cast<int>(dims[2]);
  p.Lk = static_cast<int>(dims[3]);
  p.D = static_cast<int>(dims[4]);
  p.q_sb = strides[0];
  p.q_sl = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_sl = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_sl = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_sl = strides[10];
  p.o_sh = strides[11];
  p.scale = scale;
  p.causal = causal;
  if (p.D <= 0 || p.D > 128 || p.D % 8 != 0 || p.Lq <= 0 || p.Lk <= 0 ||
      p.B * p.H <= 0 || p.B * p.H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    constexpr int BM = kFwdRows;
    const dim3 grid(p.B * p.H, (p.Lq + BM - 1) / BM);
    err = p.D <= 64 ? launch(flash_fwd_bf16<64, BM>, grid, 2 * BM,
                             fwd_smem(64, BM), p, st)
                    : launch(flash_fwd_bf16<128, BM>, grid, 2 * BM,
                             fwd_smem(128, BM), p, st);
  } else if (dtype == 0) {
    const dim3 grid((p.Lq + kBlockQ - 1) / kBlockQ, p.B * p.H);
    const size_t smem =
        (2 * kBlockQ * (p.D + 1) + kBlockK * p.D + kBlockQ * (kBlockK + 1) +
         3 * kBlockQ) *
        sizeof(float);
    if (p.D <= 64) {
      err = launch(flash_fwd_f32<64>, grid, 256, smem, p, st);
    } else {
      err = launch(flash_fwd_f32<128>, grid, 256, smem, p, st);
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
