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
//   no order, so each block here owns one (q-tile, batch*head) pair and
//   walks the k-tiles in a loop; m, l and acc never leave the SM.
//   Under causal masking that loop stops at the diagonal.
// - q, k, v and out stay in their (B, L, H, D) layout and are read
//   through strides: no head-folding transpose copy (`_fold_heads`).
// - lse is written as (B, H, L) f32, not broadcast over 128 lanes.
//
// Bound on this card: at the serving shape (bf16, B=8, H=12, L=1024,
// D=64, causal) the kernel must read q, k, v and write out (2 bytes each)
// plus lse (4 bytes): 50.7 MB, 15.1 us at 3.35 TB/s; its two products are
// 12.9 GFLOP, 13.0 us at the 989 TFLOP/s bf16 tensor-core peak. So memory
// bounds it, narrowly. The design keeps every intermediate (scores,
// probabilities, m, l, acc) on chip, so device memory sees each input
// once per q-tile and each output once. K/V are re-read once per q-tile
// (16 times at L=1024), mostly from L2.
//
// Two instances:
// - bf16: tensor cores via mma.sync m16n8k16 (f32 accumulate). Four warps
//   each own 16 query rows of a 64-row tile; P stays in registers between
//   the two products (the QK^T accumulator layout is the PV A-operand
//   layout). P is rounded to bf16 for the second product.
// - f32: plain f32 FMA on the CUDA cores (no TF32: it would miss the f32
//   tolerance). K/V tiles are staged in shared memory.
// Both take D up to 128 in multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

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
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
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

template <int DMAX>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16(Params p) {
  constexpr int STR = DMAX + 8;     // smem row stride (elements): no bank
                                    // conflicts on fragment loads
  constexpr int NKC = DMAX / 16;    // head-dim chunks of QK^T
  constexpr int NDT = DMAX / 8;     // head-dim n-tiles of PV
  constexpr int NST = kBlockK / 8;  // key n-tiles of QK^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * STR;
  __nv_bfloat16* Vs = Ks + kBlockK * STR;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const int D = p.D;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Q tile -> smem (zero past D and past Lq) -> A fragments in registers.
  for (int idx = tid; idx < kBlockQ * DMAX; idx += 128) {
    const int r = idx / DMAX, c = idx % DMAX;
    const int row = q0 + r;
    Qs[r * STR + c] =
        (row < p.Lq && c < D) ? qp[row * p.q_sl + c] : zero;
  }
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qa[NKC][4];
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
    const __nv_bfloat16* base = Qs + (wr + g) * STR + kc * 16 + 2 * t;
    qa[kc][0] = ld32(base);
    qa[kc][1] = ld32(base + 8 * STR);
    qa[kc][2] = ld32(base + 8);
    qa[kc][3] = ld32(base + 8 * STR + 8);
  }

  float oacc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  }
  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int k_end = p.causal ? min(p.Lk, q0 + kBlockQ) : p.Lk;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < kBlockK * DMAX; idx += 128) {
      const int r = idx / DMAX, c = idx % DMAX;
      const int row = k0 + r;
      const bool ok = row < p.Lk && c < D;
      Ks[r * STR + c] = ok ? kp[row * p.k_sl + c] : zero;
      Vs[r * STR + c] = ok ? vp[row * p.v_sl + c] : zero;
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NST][4];
#pragma unroll
    for (int nt = 0; nt < NST; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
      if (kc * 16 < D) {
#pragma unroll
        for (int nt = 0; nt < NST; ++nt) {
          const __nv_bfloat16* kb = Ks + (nt * 8 + g) * STR + kc * 16 + 2 * t;
          mma_bf16(s[nt], qa[kc], ld32(kb), ld32(kb + 8));
        }
      }
    }

    // scale, mask, online softmax (rows shared by the 4 lanes of a quad)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float val = s[nt][e] * p.scale;
        if (col >= p.Lk || (p.causal && col > row)) val = kNegInf;
        s[nt][e] = val;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NST; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mn0);
      s[nt][1] = __expf(s[nt][1] - mn0);
      s[nt][2] = __expf(s[nt][2] - mn1);
      s[nt][3] = __expf(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    // per-lane partial sums: alpha is uniform across the quad, so the
    // quad's partials add up to the row sum (reduced once, at the end)
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      oacc[dt][0] *= al0;
      oacc[dt][1] *= al0;
      oacc[dt][2] *= al1;
      oacc[dt][3] *= al1;
    }

    // O += P V: the S accumulator layout is the A-fragment layout
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kc][0], s[2 * kc][1]),
          pack_f32(s[2 * kc][2], s[2 * kc][3]),
          pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        if (dt * 8 < D) {
          const __nv_bfloat16* vb = Vs + (kc * 16 + 2 * t) * STR + dt * 8 + g;
          mma_bf16(oacc[dt], pa, pack_bf16(vb[0], vb[STR]),
                   pack_bf16(vb[8 * STR], vb[9 * STR]));
        }
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    if (dt * 8 < D) {
      const int col = dt * 8 + 2 * t;
      if (row0 < p.Lq) {
        *reinterpret_cast<__nv_bfloat162*>(op + row0 * p.o_sl + col) =
            __floats2bfloat162_rn(oacc[dt][0] / l0, oacc[dt][1] / l0);
      }
      if (row1 < p.Lq) {
        *reinterpret_cast<__nv_bfloat162*>(op + row1 * p.o_sl + col) =
            __floats2bfloat162_rn(oacc[dt][2] / l1, oacc[dt][3] / l1);
      }
    }
  }
  if (t == 0) {
    float* lp = p.lse + static_cast<long long>(bh) * p.Lq;
    if (row0 < p.Lq) lp[row0] = m0 + logf(l0);
    if (row1 < p.Lq) lp[row1] = m1 + logf(l1);
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
cudaError_t launch(Kernel kernel, int threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.Lq + kBlockQ - 1) / kBlockQ, p.B * p.H);
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
    if (p.D <= 64) {
      err = launch(flash_fwd_bf16<64>, 128,
                   3 * kBlockQ * (64 + 8) * sizeof(__nv_bfloat16), p, st);
    } else {
      err = launch(flash_fwd_bf16<128>, 128,
                   3 * kBlockQ * (128 + 8) * sizeof(__nv_bfloat16), p, st);
    }
  } else if (dtype == 0) {
    const size_t smem =
        (2 * kBlockQ * (p.D + 1) + kBlockK * p.D + kBlockQ * (kBlockK + 1) +
         3 * kBlockQ) *
        sizeof(float);
    if (p.D <= 64) {
      err = launch(flash_fwd_f32<64>, 256, smem, p, st);
    } else {
      err = launch(flash_fwd_f32<128>, 256, smem, p, st);
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
