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
//   on Hopper run in no order, so each block owns one 64-row tile (of
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
// are bound by operations, the first narrowly. Every intermediate (S, P, dP, dS) stays on chip;
// device memory sees each input once per tile of the other axis, mostly
// from L2.
//
// Two instances of each kernel:
// - bf16: tensor cores via mma.sync m16n8k16 with f32 accumulators. Four
//   warps each own 16 rows of the block's 64-row tile. The first two
//   products' accumulators are, in layout, the A operand of the next
//   product (for dK/dV the products are taken transposed, S^T = K Q^T, so
//   P^T and dS^T come out that way), so P and dS never leave registers.
//   P and dS are rounded to bf16 for the tensor cores.
// - f32: plain f32 FMA on the CUDA cores (TF32 would miss the f32
//   tolerance); P and dS pass through shared memory.
// Both take D up to 128 in multiples of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;  // rows of a q-tile and of a k-tile

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

// rows [row0, row0 + 64) of a (L, D) head slice -> smem (stride STR),
// zero past L and past D
template <int DMAX>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride,
                                               int row0, int L, int D) {
  constexpr int STR = DMAX + 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < kTile * DMAX; idx += blockDim.x) {
    const int r = idx / DMAX, c = idx % DMAX;
    const int row = row0 + r;
    dst[r * STR + c] = (row < L && c < D) ? src[row * row_stride + c] : zero;
  }
}

// A fragment (16x16, row-major) at smem rows [r0, r0 + 16), cols
// [c0, c0 + 16)
template <int STR>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int r0,
                                       int c0, int g, int t) {
  const __nv_bfloat16* base = s + (r0 + g) * STR + c0 + 2 * t;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * STR);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * STR + 8);
}

// The 16x64 accumulator (8 n-tiles) as the A operand of chunk kc.
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4],
                                         const float (&c)[8][4], int kc) {
  a[0] = pack_f32(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_f32(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_f32(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_f32(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// acc (16 x DMAX) += A (16 x 64 tile rows) * X (64 tile rows x DMAX) with
// X in smem, row-major (stride STR)
template <int DMAX>
__device__ __forceinline__ void acc_times_rows(float (&acc)[DMAX / 8][4],
                                               const float (&c)[8][4],
                                               const __nv_bfloat16* xs,
                                               int D, int g, int t) {
  constexpr int STR = DMAX + 8;
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    uint32_t a[4];
    acc_as_a(a, c, kc);
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; ++dt) {
      if (dt * 8 < D) {
        const __nv_bfloat16* xb = xs + (kc * 16 + 2 * t) * STR + dt * 8 + g;
        mma_bf16(acc[dt], a, pack_bf16(xb[0], xb[STR]),
                 pack_bf16(xb[8 * STR], xb[9 * STR]));
      }
    }
  }
}

// s (16 x 64) = A rows (smem, 16 rows from r0) . B rows (smem, 64 rows)^T
// over the head dim
template <int DMAX>
__device__ __forceinline__ void rows_dot_rows(float (&s)[8][4],
                                              const __nv_bfloat16* as,
                                              const __nv_bfloat16* bs,
                                              int r0, int D, int g, int t) {
  constexpr int STR = DMAX + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < DMAX / 16; ++kc) {
    if (kc * 16 < D) {
      uint32_t a[4];
      a_frag<STR>(a, as, r0, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* bb = bs + (nt * 8 + g) * STR + kc * 16 + 2 * t;
        mma_bf16(s[nt], a, ld32(bb), ld32(bb + 8));
      }
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(Params p) {
  constexpr int STR = DMAX + 8;
  constexpr int NDT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + kTile * STR;  // dO
  __nv_bfloat16* Ks = Os + kTile * STR;
  __nv_bfloat16* Vs = Ks + kTile * STR;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const int D = p.D;
  const int wr = warp * 16;

  load_tile_bf16<DMAX>(Qs, head_ptr<__nv_bfloat16>(p.q, p.q_s, b, h),
                       p.q_s[1], q0, p.Lq, D);
  load_tile_bf16<DMAX>(Os, head_ptr<__nv_bfloat16>(p.dout, p.do_s, b, h),
                       p.do_s[1], q0, p.Lq, D);
  const __nv_bfloat16* kp = head_ptr<__nv_bfloat16>(p.k, p.k_s, b, h);
  const __nv_bfloat16* vp = head_ptr<__nv_bfloat16>(p.v, p.v_s, b, h);

  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = q0 + wr + g, row1 = row0 + 8;
  const long long st = static_cast<long long>(bh) * p.Lq;
  const float lse0 = row0 < p.Lq ? p.lse[st + row0] : 0.f;
  const float lse1 = row1 < p.Lq ? p.lse[st + row1] : 0.f;
  const float dl0 = row0 < p.Lq ? p.delta[st + row0] : 0.f;
  const float dl1 = row1 < p.Lq ? p.delta[st + row1] : 0.f;

  float acc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  const int k_end = p.causal ? min(p.Lk, q0 + kTile) : p.Lk;

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<DMAX>(Ks, kp, p.k_s[1], k0, p.Lk, D);
    load_tile_bf16<DMAX>(Vs, vp, p.v_s[1], k0, p.Lk, D);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_dot_rows<DMAX>(s, Qs, Ks, wr, D, g, t);   // S = Q K^T
    rows_dot_rows<DMAX>(dp, Os, Vs, wr, D, g, t);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool vis = col < p.Lk && !(p.causal && col > row);
        const float pv =
            vis ? __expf(s[nt][e] * p.scale - (e < 2 ? lse0 : lse1)) : 0.f;
        s[nt][e] = pv * (dp[nt][e] - (e < 2 ? dl0 : dl1));  // dS
      }
    }
    acc_times_rows<DMAX>(acc, s, Ks, D, g, t);  // dQ += dS K
  }

  __nv_bfloat16* op = head_ptr_w<__nv_bfloat16>(p.dq, p.dq_s, b, h);
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

template <int DMAX>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(Params p) {
  constexpr int STR = DMAX + 8;
  constexpr int NDT = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile * STR;
  __nv_bfloat16* Qs = Vs + kTile * STR;
  __nv_bfloat16* Os = Qs + kTile * STR;  // dO
  float* lse_s = reinterpret_cast<float*>(Os + kTile * STR);
  float* dl_s = lse_s + kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kTile;
  const int D = p.D;
  const int wr = warp * 16;

  load_tile_bf16<DMAX>(Ks, head_ptr<__nv_bfloat16>(p.k, p.k_s, b, h),
                       p.k_s[1], k0, p.Lk, D);
  load_tile_bf16<DMAX>(Vs, head_ptr<__nv_bfloat16>(p.v, p.v_s, b, h),
                       p.v_s[1], k0, p.Lk, D);
  const __nv_bfloat16* qp = head_ptr<__nv_bfloat16>(p.q, p.q_s, b, h);
  const __nv_bfloat16* dop = head_ptr<__nv_bfloat16>(p.dout, p.do_s, b, h);
  const long long st = static_cast<long long>(bh) * p.Lq;

  // this thread's two key rows: g and g + 8 of the warp's 16
  const int krow0 = k0 + wr + g, krow1 = krow0 + 8;
  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }
  // q-tiles entirely above the diagonal see this k-tile masked
  const int q_begin = p.causal ? k0 : 0;

  for (int q0 = q_begin; q0 < p.Lq; q0 += kTile) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile_bf16<DMAX>(Qs, qp, p.q_s[1], q0, p.Lq, D);
    load_tile_bf16<DMAX>(Os, dop, p.do_s[1], q0, p.Lq, D);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < p.Lq ? p.lse[st + row] : 0.f;
      dl_s[threadIdx.x] = row < p.Lq ? p.delta[st + row] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_dot_rows<DMAX>(s, Ks, Qs, wr, D, g, t);   // S^T = K Q^T
    rows_dot_rows<DMAX>(dp, Vs, Os, wr, D, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const int qrow = q0 + qc;
        const int krow = e < 2 ? krow0 : krow1;
        const bool vis = qrow < p.Lq && !(p.causal && krow > qrow);
        const float pv = vis ? __expf(s[nt][e] * p.scale - lse_s[qc]) : 0.f;
        s[nt][e] = pv;                            // P^T
        dp[nt][e] = pv * (dp[nt][e] - dl_s[qc]);  // dS^T
      }
    }
    acc_times_rows<DMAX>(dv, s, Os, D, g, t);   // dV += P^T dO
    acc_times_rows<DMAX>(dk, dp, Qs, D, g, t);  // dK += dS^T Q
  }

  __nv_bfloat16* kop = head_ptr_w<__nv_bfloat16>(p.dk, p.dk_s, b, h);
  __nv_bfloat16* vop = head_ptr_w<__nv_bfloat16>(p.dv, p.dv_s, b, h);
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
cudaError_t launch(Kernel kernel, int tiles, int threads, size_t smem,
                   const Params& p, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, p.B * p.H);
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

size_t bf16_smem(int dmax, bool stats) {
  return 4 * kTile * (dmax + 8) * sizeof(__nv_bfloat16) +
         (stats ? 2 * kTile * sizeof(float) : 0);
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
  const int tiles = (p.Lq + kTile - 1) / kTile;
  cudaError_t err;
  if (dtype == 1) {
    err = p.D <= 64
              ? launch(flash_bwd_dq_bf16<64>, tiles, 128,
                       bf16_smem(64, false), p, st)
              : launch(flash_bwd_dq_bf16<128>, tiles, 128,
                       bf16_smem(128, false), p, st);
  } else if (dtype == 0) {
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
  const int tiles = (p.Lk + kTile - 1) / kTile;
  cudaError_t err;
  if (dtype == 1) {
    err = p.D <= 64
              ? launch(flash_bwd_dkv_bf16<64>, tiles, 128,
                       bf16_smem(64, true), p, st)
              : launch(flash_bwd_dkv_bf16<128>, tiles, 128,
                       bf16_smem(128, true), p, st);
  } else if (dtype == 0) {
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
