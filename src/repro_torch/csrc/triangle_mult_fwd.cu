// Triangle-multiplicative update, forward (kernel K3 of the port).
//
// Replaces: src/repro/kernels/triangle.py::triangle_mult_fwd (Pallas body
// `_tri_fwd_kernel`), reached through kernels/ops.py::triangle_mult_masked.
//
// Computes, with x_a (r_i, r_k, c_z), x_b (r_j, r_k, c_z), x_g (r_i, r_j, c_z)
// and packed [value | gate] projections w_a, w_b (c_z, 2c):
//     a[i,k,:] = sigmoid(x_a[i,k].W_ag + b_ag) * (x_a[i,k].W_av + b_av) * kmask[k]
//     b[j,k,:] = sigmoid(x_b[j,k].W_bg + b_bg) * (x_b[j,k].W_bv + b_bv)
//     s[i,j,:] = sum_k a[i,k,:] * b[j,k,:]                       (fp32)
//     y[i,j,:] = sigmoid(x_g[i,j].W_g + b_g) * (LN(s[i,j]).W_o + b_o)
// LayerNorm over the fp32 s with eps 1e-5, as the Pallas kernel does.
//
// What bounds it on the H100: at r = 256, c = c_z = 128 every stage is a
// contraction with far more operations than bytes (17 GFLOP in all, the
// k-contraction alone 2 r^3 c = 4.3 GFLOP, on 16 MiB of activations), so
// it is bound by operations: the tensor cores' rate for bf16 inputs.
//
// Design: the Pallas kernel keeps whole (block, r_k, c_z) operand rows in
// VMEM and recomputes the projections in every (i, j) program.  A Hopper
// block has 227 KB of shared memory, not megabytes, and recomputing the
// projections per j-tile would multiply their cost by r / tile.  So the
// work is split in two kernels, the gated projections written ONCE per side
// into a scratch buffer in the input type (k_mask applied in fp32 before the
// rounding), then one kernel for the contraction, the LayerNorm, the
// out-projection and the gate, so s and the pre-gate output never reach
// device memory.
//  * bf16 inputs (serving): tensor cores, mma.sync m16n8k16 with fp32
//    accumulation.  tri_proj_mma_kernel is a 64-row x (32 value + 32 gate)
//    tile GEMM from shared memory; it writes a and b channel-major
//    (c, r, r_k rounded up to 16, zero-filled), so that in
//    tri_contract_mma_kernel every channel's (16 i x 16 j) tile is an NT
//    product whose fragments are single 32-bit loads.  That kernel parks
//    the tile's fp32 s for all c channels in shared memory, takes the
//    LayerNorm statistics, and feeds LN(s) rounded to bf16 and x_g as the
//    A operands of the out-projection and gate products.
//  * fp32 inputs: the exact path on the fp32 CUDA cores (tri_proj_kernel,
//    tri_contract_kernel: one block per 8x8 tile, one thread per channel).
// Ragged r_i / r_j are masked (rows past the edge are zeros and not
// written); k is looped exactly or zero-padded, so any r_k works.
// When `s_out` is not null (autograd needs the backward), the contraction
// kernels also write the fp32 pre-LayerNorm s (r_i, r_j, c) from shared
// memory: the residual that K4 (csrc/triangle_mult_bwd.cu) starts from.
// Without a gradient the pointer is null and s stays on chip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int PROJ_ROWS = 32;  // x rows per projection block
constexpr int TI = 8;          // output tile rows (i)
constexpr int TJ = 8;          // output tile cols (j)
constexpr int TP = TI * TJ;    // pairs per tile
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// out[i, k, n] = sigmoid(x[i,k].w[:, c+n] + bias[c+n]) * (x[i,k].w[:, n] + bias[n]) * kmask[k]
// x[i, k, :] lives at x + i * si + k * sk (channels contiguous); out is
// contiguous (ri, rk, c).  Dynamic shared memory: PROJ_ROWS * cz floats.
template <typename T>
__global__ void __launch_bounds__(THREADS)
tri_proj_kernel(const T* __restrict__ x, long long si, long long sk,
                const T* __restrict__ w, const T* __restrict__ bias,
                const float* __restrict__ kmask, T* __restrict__ out,
                int ri, int rk, int cz, int c) {
  extern __shared__ __align__(16) float xs[];  // [PROJ_ROWS][cz]
  const long long n_rows = (long long)ri * rk;
  const long long r0 = (long long)blockIdx.x * PROJ_ROWS;
  const int tid = threadIdx.x;

  for (int e = tid; e < PROJ_ROWS * cz; e += THREADS) {
    const int r = e / cz;
    const int ch = e - r * cz;
    const long long row = r0 + r;
    float val = 0.f;
    if (row < n_rows) {
      const long long i = row / rk;
      const long long kk = row - i * rk;
      val = to_f(x[i * si + kk * sk + ch]);
    }
    xs[e] = val;
  }
  __syncthreads();

  for (int n = tid; n < c; n += THREADS) {
    float av[PROJ_ROWS], ag[PROJ_ROWS];
    const float bv = to_f(bias[n]);
    const float bg = to_f(bias[c + n]);
#pragma unroll
    for (int r = 0; r < PROJ_ROWS; ++r) {
      av[r] = bv;
      ag[r] = bg;
    }
    for (int ch = 0; ch < cz; ch += 4) {
      float wv[4], wg[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wv[u] = to_f(w[(size_t)(ch + u) * 2 * c + n]);
        wg[u] = to_f(w[(size_t)(ch + u) * 2 * c + c + n]);
      }
#pragma unroll
      for (int r = 0; r < PROJ_ROWS; ++r) {
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[r * cz + ch]);
        av[r] = fmaf(x4.x, wv[0], av[r]);
        av[r] = fmaf(x4.y, wv[1], av[r]);
        av[r] = fmaf(x4.z, wv[2], av[r]);
        av[r] = fmaf(x4.w, wv[3], av[r]);
        ag[r] = fmaf(x4.x, wg[0], ag[r]);
        ag[r] = fmaf(x4.y, wg[1], ag[r]);
        ag[r] = fmaf(x4.z, wg[2], ag[r]);
        ag[r] = fmaf(x4.w, wg[3], ag[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < PROJ_ROWS; ++r) {
      const long long row = r0 + r;
      if (row < n_rows) {
        float val = sigmoid_f(ag[r]) * av[r];
        if (kmask != nullptr) val *= kmask[row % rk];
        out[row * c + n] = from_f<T>(val);
      }
    }
  }
}

// One block per (TI x TJ) output tile.  Dynamic shared memory:
// TP * c floats (s, then LN(s)) + TP * cz floats (the x_g tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
tri_contract_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ xg, const T* __restrict__ ln_s,
                    const T* __restrict__ ln_b, const T* __restrict__ w_o,
                    const T* __restrict__ b_o, const T* __restrict__ w_g,
                    const T* __restrict__ b_g, T* __restrict__ out,
                    float* __restrict__ s_out, int ri, int rj, int rk, int cz, int c) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;            // [TP][c]
  float* gt = smem + TP * c;   // [TP][cz]
  const int j0 = blockIdx.x * TJ;
  const int i0 = blockIdx.y * TI;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // x_g tile -> shared memory (coalesced over channels)
  for (int e = tid; e < TP * cz; e += THREADS) {
    const int p = e / cz;
    const int z = e - p * cz;
    const int i = i0 + p / TJ;
    const int j = j0 + p % TJ;
    gt[e] = (i < ri && j < rj) ? to_f(xg[((size_t)i * rj + j) * cz + z]) : 0.f;
  }

  // s[i, j, ch] = sum_k a[i, k, ch] * b[j, k, ch]: one thread per channel
  for (int ch = tid; ch < c; ch += THREADS) {
    float acc[TI][TJ];
#pragma unroll
    for (int ii = 0; ii < TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < rk; ++kk) {
      float av[TI], bv[TJ];
#pragma unroll
      for (int ii = 0; ii < TI; ++ii) {
        const int i = i0 + ii;
        av[ii] = i < ri ? to_f(a[((size_t)i * rk + kk) * c + ch]) : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        const int j = j0 + jj;
        bv[jj] = j < rj ? to_f(b[((size_t)j * rk + kk) * c + ch]) : 0.f;
      }
#pragma unroll
      for (int ii = 0; ii < TI; ++ii)
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) st[(ii * TJ + jj) * c + ch] = acc[ii][jj];
  }
  __syncthreads();
  if (s_out != nullptr)
    for (int e = tid; e < TP * c; e += THREADS) {
      const int p = e / c;
      const int i = i0 + p / TJ, j = j0 + p % TJ;
      if (i < ri && j < rj) s_out[((size_t)i * rj + j) * c + (e - p * c)] = st[e];
    }
  __syncthreads();  // the LayerNorm below rewrites st in place

  // LayerNorm over channels, one warp per pair, in place: st <- LN(s)
  const float inv_c = 1.f / (float)c;
  for (int p = warp; p < TP; p += THREADS / 32) {
    float* row = st + p * c;
    float sum = 0.f;
    for (int ch = lane; ch < c; ch += 32) sum += row[ch];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum * inv_c;
    float sq = 0.f;
    for (int ch = lane; ch < c; ch += 32) {
      const float d = row[ch] - mu;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq * inv_c + LN_EPS);
    for (int ch = lane; ch < c; ch += 32)
      row[ch] = (row[ch] - mu) * rstd * to_f(ln_s[ch]) + to_f(ln_b[ch]);
  }
  __syncthreads();

  // y = sigmoid(x_g.W_g + b_g) * (LN(s).W_o + b_o): one thread per output
  // channel z, the tile's pairs in two halves to bound registers
  constexpr int HALF = TP / 2;
  for (int z = tid; z < cz; z += THREADS) {
    const float bo = to_f(b_o[z]);
    const float bgz = to_f(b_g[z]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p0 = half * HALF;
      float u[HALF], g[HALF];
#pragma unroll
      for (int p = 0; p < HALF; ++p) {
        u[p] = bo;
        g[p] = bgz;
      }
      for (int ch = 0; ch < c; ch += 4) {
        float w4[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) w4[t] = to_f(w_o[(size_t)(ch + t) * cz + z]);
#pragma unroll
        for (int p = 0; p < HALF; ++p) {
          const float4 n4 = *reinterpret_cast<const float4*>(&st[(p0 + p) * c + ch]);
          u[p] = fmaf(n4.x, w4[0], u[p]);
          u[p] = fmaf(n4.y, w4[1], u[p]);
          u[p] = fmaf(n4.z, w4[2], u[p]);
          u[p] = fmaf(n4.w, w4[3], u[p]);
        }
      }
      for (int ch = 0; ch < cz; ch += 4) {
        float w4[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) w4[t] = to_f(w_g[(size_t)(ch + t) * cz + z]);
#pragma unroll
        for (int p = 0; p < HALF; ++p) {
          const float4 x4 = *reinterpret_cast<const float4*>(&gt[(p0 + p) * cz + ch]);
          g[p] = fmaf(x4.x, w4[0], g[p]);
          g[p] = fmaf(x4.y, w4[1], g[p]);
          g[p] = fmaf(x4.z, w4[2], g[p]);
          g[p] = fmaf(x4.w, w4[3], g[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < HALF; ++p) {
        const int i = i0 + (p0 + p) / TJ;
        const int j = j0 + (p0 + p) % TJ;
        if (i < ri && j < rj)
          out[((size_t)i * rj + j) * cz + z] = from_f<T>(sigmoid_f(g[p]) * u[p]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MP_ROWS = 64;      // projection rows per block (4 warps x 16)
constexpr int MP_COLS = 32;      // value channels per block (+ as many gate)
constexpr int MT = 16;           // contraction tile: 16 i x 16 j pairs
constexpr int MT_WARPS = 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, col-major), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[n][i * rkp + k] = sigmoid(x[i,k].w[:, c+n] + b[c+n]) * (x[i,k].w[:, n] + b[n])
//                       * kmask[k], 0 for k >= rk.  Rows enumerate (i, k < rkp).
// Dynamic shared memory: 2 * MP_ROWS * (cz + 8) bf16.
__global__ void __launch_bounds__(128)
tri_proj_mma_kernel(const bf16* __restrict__ x, long long si, long long sk,
                    const bf16* __restrict__ w, const bf16* __restrict__ bias,
                    const float* __restrict__ kmask, bf16* __restrict__ out,
                    int ri, int rk, int rkp, int cz, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xs_ld = cz + 8;  // padded row: fragment loads hit distinct banks
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // [MP_ROWS][xs_ld]
  bf16* ws = xs + MP_ROWS * xs_ld;                // [2 * MP_COLS][xs_ld], n-major
  const long long n_rows = (long long)ri * rkp;
  const long long r0 = (long long)blockIdx.x * MP_ROWS;
  const int n0 = blockIdx.y * MP_COLS;
  const int tid = threadIdx.x;

  for (int e = tid; e < MP_ROWS * cz / 2; e += 128) {
    const int r = e / (cz / 2);
    const int cc = (e - r * (cz / 2)) * 2;
    const long long row = r0 + r;
    uint32_t val = 0u;
    if (row < n_rows) {
      const long long i = row / rkp;
      const long long kk = row - i * rkp;
      if (kk < rk) val = ld32(x + i * si + kk * sk + cc);
    }
    *reinterpret_cast<uint32_t*>(&xs[r * xs_ld + cc]) = val;
  }
  for (int e = tid; e < 2 * MP_COLS * cz; e += 128) {
    const int kk = e / (2 * MP_COLS);
    const int n = e - kk * 2 * MP_COLS;
    const int ch = n0 + (n % MP_COLS);
    const int col = n < MP_COLS ? ch : c + ch;
    ws[n * xs_ld + kk] = ch < c ? w[(size_t)kk * 2 * c + col] : __float2bfloat16(0.f);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;
  float acc[2 * MP_COLS / 8][4];
#pragma unroll
  for (int nt = 0; nt < 2 * MP_COLS / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int k0 = 0; k0 < cz; k0 += 16) {
    const int kk = k0 + 2 * t;
    const uint32_t a[4] = {ld32(&xs[(rw + g) * xs_ld + kk]), ld32(&xs[(rw + g + 8) * xs_ld + kk]),
                           ld32(&xs[(rw + g) * xs_ld + kk + 8]),
                           ld32(&xs[(rw + g + 8) * xs_ld + kk + 8])};
#pragma unroll
    for (int nt = 0; nt < 2 * MP_COLS / 8; ++nt) {
      const bf16* wr = &ws[(nt * 8 + g) * xs_ld + kk];
      mma16816(acc[nt], a, ld32(wr), ld32(wr + 8));
    }
  }
#pragma unroll
  for (int nt = 0; nt < MP_COLS / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long row = r0 + rw + g + (e >= 2 ? 8 : 0);
      const int n = n0 + nt * 8 + 2 * t + (e & 1);
      if (row >= n_rows || n >= c) continue;
      const long long kk = row % rkp;
      const float m = kk < rk ? (kmask != nullptr ? kmask[kk] : 1.f) : 0.f;
      const float val = sigmoid_f(acc[nt + MP_COLS / 8][e] + to_f(bias[c + n])) *
                        (acc[nt][e] + to_f(bias[n])) * m;
      out[(size_t)n * n_rows + row] = __float2bfloat16(val);
    }
  }
}

// One block of MT_WARPS warps per (16 i x 16 j) tile.  a_t (c, ri, rkp) and
// b_t (c, rj, rkp) channel-major, zero past rk.  Dynamic shared memory:
// 256 * (c + 4) floats (s) + 512 floats (LN statistics).
__global__ void __launch_bounds__(MT_WARPS * 32)
tri_contract_mma_kernel(const bf16* __restrict__ a_t, const bf16* __restrict__ b_t,
                        const bf16* __restrict__ xg, const bf16* __restrict__ ln_s,
                        const bf16* __restrict__ ln_b, const bf16* __restrict__ w_o,
                        const bf16* __restrict__ b_o, const bf16* __restrict__ w_g,
                        const bf16* __restrict__ b_g, bf16* __restrict__ out,
                        float* __restrict__ s_out, int ri, int rj, int rkp, int cz, int c) {
  extern __shared__ __align__(16) float smem_f[];
  const int cs = c + 4;                        // s row stride (floats)
  float* st = smem_f;                          // [MT * MT][cs], pair = il * MT + jl
  float* mu = st + MT * MT * cs;               // [MT * MT]
  float* rstd = mu + MT * MT;                  // [MT * MT]
  const int j0 = blockIdx.x * MT;
  const int i0 = blockIdx.y * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // s[i, j, ch] = sum_k a[ch, i, k] * b[ch, j, k]: one channel at a time per warp
  const size_t plane_a = (size_t)ri * rkp, plane_b = (size_t)rj * rkp;
  const int ia = i0 + g, ib = i0 + g + 8, ja = j0 + g, jb = j0 + g + 8;
  for (int ch = warp; ch < c; ch += MT_WARPS) {
    const bf16* ap = a_t + ch * plane_a;
    const bf16* bp = b_t + ch * plane_b;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < rkp; k0 += 16) {
      const int kk = k0 + 2 * t;
      const uint32_t a[4] = {ia < ri ? ld32(ap + (size_t)ia * rkp + kk) : 0u,
                             ib < ri ? ld32(ap + (size_t)ib * rkp + kk) : 0u,
                             ia < ri ? ld32(ap + (size_t)ia * rkp + kk + 8) : 0u,
                             ib < ri ? ld32(ap + (size_t)ib * rkp + kk + 8) : 0u};
      mma16816(acc[0], a, ja < rj ? ld32(bp + (size_t)ja * rkp + kk) : 0u,
               ja < rj ? ld32(bp + (size_t)ja * rkp + kk + 8) : 0u);
      mma16816(acc[1], a, jb < rj ? ld32(bp + (size_t)jb * rkp + kk) : 0u,
               jb < rj ? ld32(bp + (size_t)jb * rkp + kk + 8) : 0u);
    }
#pragma unroll
    for (int jt = 0; jt < 2; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = g + (e >= 2 ? 8 : 0);
        const int jl = jt * 8 + 2 * t + (e & 1);
        st[(il * MT + jl) * cs + ch] = acc[jt][e];
      }
  }
  __syncthreads();
  if (s_out != nullptr)
    for (int e = threadIdx.x; e < MT * MT * c; e += MT_WARPS * 32) {
      const int p = e / c, ch = e - p * c;
      const int i = i0 + p / MT, j = j0 + p % MT;
      if (i < ri && j < rj) s_out[((size_t)i * rj + j) * c + ch] = st[p * cs + ch];
    }

  // LayerNorm statistics over channels, one warp per pair
  const float inv_c = 1.f / (float)c;
  for (int p = warp; p < MT * MT; p += MT_WARPS) {
    const float* row = st + p * cs;
    float sum = 0.f;
    for (int ch = lane; ch < c; ch += 32) sum += row[ch];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float m = sum * inv_c;
    float sq = 0.f;
    for (int ch = lane; ch < c; ch += 32) {
      const float d = row[ch] - m;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (lane == 0) {
      mu[p] = m;
      rstd[p] = rsqrtf(sq * inv_c + LN_EPS);
    }
  }
  __syncthreads();

  // y = sigmoid(x_g.W_g + b_g) * (bf16(LN(s)).W_o + b_o).  An m-tile of 16
  // pairs is one i row (il = mt) and its 16 j; a warp takes 32 output
  // channels at a time.
  for (int mt = warp; mt < MT; mt += MT_WARPS) {
    const int pa = mt * MT + g, pb = pa + 8;
    const int i = i0 + mt;
    const bool va = i < ri && ja < rj, vb = i < ri && jb < rj;
    const bf16* xa = xg + ((size_t)i * rj + ja) * cz;
    const bf16* xb = xg + ((size_t)i * rj + jb) * cz;
    const float mua = mu[pa], ra = rstd[pa], mub = mu[pb], rb = rstd[pb];
    for (int n0 = 0; n0 < cz; n0 += 32) {
      float u[4][4], gt[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[nt][e] = gt[nt][e] = 0.f;
      for (int k0 = 0; k0 < c; k0 += 16) {
        const int kk = k0 + 2 * t;
        const float g0 = to_f(ln_s[kk]), g1 = to_f(ln_s[kk + 1]);
        const float g8 = to_f(ln_s[kk + 8]), g9 = to_f(ln_s[kk + 9]);
        const float b0 = to_f(ln_b[kk]), b1 = to_f(ln_b[kk + 1]);
        const float b8 = to_f(ln_b[kk + 8]), b9 = to_f(ln_b[kk + 9]);
        const float2 sa0 = *reinterpret_cast<const float2*>(&st[pa * cs + kk]);
        const float2 sb0 = *reinterpret_cast<const float2*>(&st[pb * cs + kk]);
        const float2 sa8 = *reinterpret_cast<const float2*>(&st[pa * cs + kk + 8]);
        const float2 sb8 = *reinterpret_cast<const float2*>(&st[pb * cs + kk + 8]);
        const uint32_t a[4] = {
            pack_bf16((sa0.x - mua) * ra * g0 + b0, (sa0.y - mua) * ra * g1 + b1),
            pack_bf16((sb0.x - mub) * rb * g0 + b0, (sb0.y - mub) * rb * g1 + b1),
            pack_bf16((sa8.x - mua) * ra * g8 + b8, (sa8.y - mua) * ra * g9 + b9),
            pack_bf16((sb8.x - mub) * rb * g8 + b8, (sb8.y - mub) * rb * g9 + b9)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + nt * 8 + g;
          if (n0 + nt * 8 >= cz) break;
          mma16816(u[nt], a, pack_raw(w_o[(size_t)kk * cz + n], w_o[(size_t)(kk + 1) * cz + n]),
                   pack_raw(w_o[(size_t)(kk + 8) * cz + n], w_o[(size_t)(kk + 9) * cz + n]));
        }
      }
      for (int k0 = 0; k0 < cz; k0 += 16) {
        const int kk = k0 + 2 * t;
        const uint32_t a[4] = {va ? ld32(xa + kk) : 0u, vb ? ld32(xb + kk) : 0u,
                               va ? ld32(xa + kk + 8) : 0u, vb ? ld32(xb + kk + 8) : 0u};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + nt * 8 + g;
          if (n0 + nt * 8 >= cz) break;
          mma16816(gt[nt], a, pack_raw(w_g[(size_t)kk * cz + n], w_g[(size_t)(kk + 1) * cz + n]),
                   pack_raw(w_g[(size_t)(kk + 8) * cz + n], w_g[(size_t)(kk + 9) * cz + n]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int z = n0 + nt * 8 + 2 * t;
        if (z >= cz) break;
        const float bo0 = to_f(b_o[z]), bo1 = to_f(b_o[z + 1]);
        const float bg0 = to_f(b_g[z]), bg1 = to_f(b_g[z + 1]);
        if (va)
          *reinterpret_cast<uint32_t*>(out + ((size_t)i * rj + ja) * cz + z) =
              pack_bf16(sigmoid_f(gt[nt][0] + bg0) * (u[nt][0] + bo0),
                        sigmoid_f(gt[nt][1] + bg1) * (u[nt][1] + bo1));
        if (vb)
          *reinterpret_cast<uint32_t*>(out + ((size_t)i * rj + jb) * cz + z) =
              pack_bf16(sigmoid_f(gt[nt][2] + bg0) * (u[nt][2] + bo0),
                        sigmoid_f(gt[nt][3] + bg1) * (u[nt][3] + bo1));
      }
    }
  }
}

cudaError_t run_mma(const void* xa, long long xa_si, long long xa_sk, const void* xb,
                    long long xb_sj, long long xb_sk, const void* xg, const float* kmask,
                    const void* w_a, const void* b_a, const void* w_b, const void* b_b,
                    const void* ln_s, const void* ln_b, const void* w_o, const void* b_o,
                    const void* w_g, const void* b_g, void* a_buf, void* b_buf, void* out,
                    float* s_out, int ri, int rj, int rk, int cz, int c, cudaStream_t stream) {
  if (cz % 16 != 0 || c % 16 != 0) return cudaErrorInvalidValue;
  const int rkp = (rk + 15) / 16 * 16;
  const size_t proj_smem = (size_t)2 * MP_ROWS * (cz + 8) * sizeof(bf16);
  const size_t tile_smem = ((size_t)MT * MT * (c + 4) + 2 * MT * MT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tri_proj_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)proj_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tri_contract_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile_smem);
  if (err != cudaSuccess) return err;
  const dim3 pgrid_a((unsigned)(((long long)ri * rkp + MP_ROWS - 1) / MP_ROWS),
                     (unsigned)((c + MP_COLS - 1) / MP_COLS));
  tri_proj_mma_kernel<<<pgrid_a, 128, proj_smem, stream>>>(
      static_cast<const bf16*>(xa), xa_si, xa_sk, static_cast<const bf16*>(w_a),
      static_cast<const bf16*>(b_a), kmask, static_cast<bf16*>(a_buf), ri, rk, rkp, cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 pgrid_b((unsigned)(((long long)rj * rkp + MP_ROWS - 1) / MP_ROWS),
                     (unsigned)((c + MP_COLS - 1) / MP_COLS));
  tri_proj_mma_kernel<<<pgrid_b, 128, proj_smem, stream>>>(
      static_cast<const bf16*>(xb), xb_sj, xb_sk, static_cast<const bf16*>(w_b),
      static_cast<const bf16*>(b_b), nullptr, static_cast<bf16*>(b_buf), rj, rk, rkp, cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((unsigned)((rj + MT - 1) / MT), (unsigned)((ri + MT - 1) / MT));
  tri_contract_mma_kernel<<<grid, MT_WARPS * 32, tile_smem, stream>>>(
      static_cast<const bf16*>(a_buf), static_cast<const bf16*>(b_buf),
      static_cast<const bf16*>(xg), static_cast<const bf16*>(ln_s),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w_o),
      static_cast<const bf16*>(b_o), static_cast<const bf16*>(w_g),
      static_cast<const bf16*>(b_g), static_cast<bf16*>(out), s_out, ri, rj, rkp, cz, c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 inputs: the CUDA cores
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t run(const void* xa, long long xa_si, long long xa_sk, const void* xb,
                long long xb_sj, long long xb_sk, const void* xg, const float* kmask,
                const void* w_a, const void* b_a, const void* w_b, const void* b_b,
                const void* ln_s, const void* ln_b, const void* w_o, const void* b_o,
                const void* w_g, const void* b_g, void* a_buf, void* b_buf, void* out,
                float* s_out, int ri, int rj, int rk, int cz, int c, cudaStream_t stream) {
  const size_t proj_smem = (size_t)PROJ_ROWS * cz * sizeof(float);
  const size_t tile_smem = (size_t)TP * (c + cz) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(tri_proj_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)proj_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tri_contract_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile_smem);
  if (err != cudaSuccess) return err;

  const long long rows_a = (long long)ri * rk;
  const long long rows_b = (long long)rj * rk;
  tri_proj_kernel<T><<<(unsigned)((rows_a + PROJ_ROWS - 1) / PROJ_ROWS), THREADS, proj_smem,
                       stream>>>(static_cast<const T*>(xa), xa_si, xa_sk,
                                 static_cast<const T*>(w_a), static_cast<const T*>(b_a),
                                 kmask, static_cast<T*>(a_buf), ri, rk, cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tri_proj_kernel<T><<<(unsigned)((rows_b + PROJ_ROWS - 1) / PROJ_ROWS), THREADS, proj_smem,
                       stream>>>(static_cast<const T*>(xb), xb_sj, xb_sk,
                                 static_cast<const T*>(w_b), static_cast<const T*>(b_b),
                                 nullptr, static_cast<T*>(b_buf), rj, rk, cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((unsigned)((rj + TJ - 1) / TJ), (unsigned)((ri + TI - 1) / TI));
  tri_contract_kernel<T><<<grid, THREADS, tile_smem, stream>>>(
      static_cast<const T*>(a_buf), static_cast<const T*>(b_buf), static_cast<const T*>(xg),
      static_cast<const T*>(ln_s), static_cast<const T*>(ln_b), static_cast<const T*>(w_o),
      static_cast<const T*>(b_o), static_cast<const T*>(w_g), static_cast<const T*>(b_g),
      static_cast<T*>(out), s_out, ri, rj, rk, cz, c);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (every tensor argument but kmask,
// which is float32 or null).  a_buf / b_buf are scratch of c * ri * rkp and
// c * rj * rkp elements, rkp = rk rounded up to a multiple of 16.  cz and c
// must be multiples of 4 (float32) or 16 (bfloat16).  `s_out` may be null;
// when given it receives the fp32 pre-LayerNorm contraction (ri, rj, c).
// Returns the first cudaError_t met (0 = success).
extern "C" int triangle_mult_fwd(const void* xa, long long xa_si, long long xa_sk,
                                 const void* xb, long long xb_sj, long long xb_sk,
                                 const void* xg, const void* kmask, const void* w_a,
                                 const void* b_a, const void* w_b, const void* b_b,
                                 const void* ln_s, const void* ln_b, const void* w_o,
                                 const void* b_o, const void* w_g, const void* b_g,
                                 void* a_buf, void* b_buf, void* out, void* s_out, int ri,
                                 int rj, int rk, int cz, int c, int dtype, void* stream) {
  if (ri <= 0 || rj <= 0 || rk <= 0 || cz % 4 != 0 || c % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kmask);
  if (dtype == 0)
    return (int)run<float>(xa, xa_si, xa_sk, xb, xb_sj, xb_sk, xg, km, w_a, b_a, w_b, b_b,
                           ln_s, ln_b, w_o, b_o, w_g, b_g, a_buf, b_buf, out,
                           static_cast<float*>(s_out), ri, rj, rk, cz, c, st);
  if (dtype == 1)
    return (int)run_mma(xa, xa_si, xa_sk, xb, xb_sj, xb_sk, xg, km, w_a, b_a, w_b, b_b, ln_s,
                        ln_b, w_o, b_o, w_g, b_g, a_buf, b_buf, out,
                        static_cast<float*>(s_out), ri, rj, rk, cz, c, st);
  return (int)cudaErrorInvalidValue;
}
