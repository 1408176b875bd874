// Triangle-multiplicative update, backward (kernels K4 and K5 of the port).
//
// Replaces: src/repro/kernels/triangle.py::triangle_mult_bwd_epilogue (K4,
// Pallas body `_tri_bwd_epi_kernel`) and ::triangle_mult_bwd_dx (K5, Pallas
// body `_tri_bwd_dx_kernel`), reached through the custom VJP of
// kernels/ops.py::triangle_mult.
//
// K4, from the forward's fp32 pre-LayerNorm contraction s (r_i, r_j, c), the
// gate source x_g and the output cotangent dy (r_i, r_j, c_z), per pair:
//     nhat = (s - mu) * rstd,  n = nhat * ln_s + ln_b,  u = n.W_o + b_o
//     g = sigmoid(x_g.W_g + b_g),  du = dy * g,  dzg = dy * u * g * (1 - g)
//     dx_g = dzg.W_g^T,  dn = du.W_o^T,
//     ds = rstd * (dn*ln_s - mean(dn*ln_s) - nhat * mean(dn*ln_s*nhat))
// and, summed over every pair, dln_s = dn*nhat, dln_b = dn, dW_o = n^T du,
// db_o = du, dW_g = x_g^T dzg, db_g = dzg.
// K5, for one operand side, with ds (r_p, r_q, c) (the local side's rows
// leading: the second call passes ds transposed, by its strides), the local
// source x_loc (r_p, r_k, c_z) and the streamed source x_str (r_q, r_k, c_z):
//     str[q,k] = sigmoid(x_str.W_sg + b_sg) * (x_str.W_sv + b_sv)
//     d_loc[p,k,:] = sum_q ds[p,q,:] * str[q,k,:]
//     h = x_loc.W_loc + b_loc = [val | gate],  sg = sigmoid(gate)
//     dh = [d_loc * sg | d_loc * val * sg * (1 - sg)],  dx = dh.W_loc^T
// and, summed over every (p, k), dW_loc = x_loc^T dh, db_loc = dh.
// All arithmetic is fp32; dx_g and dx are rounded to the input type.
//
// What bounds them on the H100: at r 256, c = c_z = 128 both are
// contractions with far more operations than bytes (K4 ~17 GFLOP on ~130 MB,
// K5 ~21.5 GFLOP on ~70 MB), so the operations bound them.
//
// In fp32 both run on the fp32 CUDA cores (67 TFLOP/s):
//  * Row kernels (tri_epi_bwd_rows_kernel, tri_dx_rows_kernel) take 32 pairs
//    per block with every channel in shared memory, do the per-pair work and
//    write the per-pair results the sums need (n, du, dzg; dh) to scratch.
//    The bias-like vector sums leave as one partial row per block.
//  * The matrix sums (dW_o, dW_g, dW_loc) are A^T B over all pairs:
//    outer_acc_kernel splits the pairs into ~128 ranges, each block sums its
//    range for a 64 x 64 output tile into a partial, and sum_chunks_kernel /
//    col_sum_kernel add the partials in a fixed order.  No atomics: two runs
//    give the same bits.
//  * K5's streamed projection is staged once per call in fp32
//    (tri_proj_f32_kernel); the contraction (tri_dx_contract_kernel) is, per
//    channel, a product of r x r matrices, one block per 8 x 8 (p, k) tile,
//    one thread per channel, reading ds through its strides.
//
// K4 in bf16 (the training path) runs every product on the tensor cores,
// four launches:
//   1. tri_epi_bwd_mma_kernel, the per-pair pass: one block of 8 warps per
//      SM with W_o and W_g resident in shared memory (read [k][n] through
//      ldmatrix.trans for u and zg, [n][k] through ldmatrix for dn and dx_g:
//      no transposed copies); each warp walks 16-pair tiles, keeping s, the
//      LayerNorm statistics, g, du and dzg in registers.  It writes ds, dx_g,
//      n, du and dzg (hi/lo) and one partial row of the four vector sums per
//      block.
//   2. tri_epi_dw_kernel, twice: dW_o = n^T du and dW_g = x_g^T dzg as
//      split-K tile GEMMs over the pairs (both operands pair-major, A read
//      [k][m] through ldmatrix.trans), into partials;
//   3. tri_epi_sums_kernel adds the dW and vector partials in a fixed order.
// Precision: n, du and dzg are fp32 in the reference and stay hi/lo pairs
// (below): u = n.W_o and dn, dx_g take 2 products each, zg 1, dW_o 3, dW_g
// 2, ~26 GFLOP of bf16 products at r 256 (tests/test_torch_triangle_split.py
// checks the arithmetic against check_grad_close).  What bounds it: the
// per-pair pass is one block of 8 warps an SM (W_o and W_g fill shared
// memory), so each warp's 16-pair tile is a long dependent chain (loads of
// s, LayerNorm, four products, sigmoid, column sums) that few other warps
// can cover; the hi/lo scratch the sums read adds ~200 MB at r 256.
//
// K5 in bf16 (the training path) runs every product on the tensor cores as
// a tiled GEMM (tile_mma.cuh: mma.sync m16n8k16 from ldmatrix fragments,
// operands staged through a 3-stage cp.async ring, 128 x 64 block tiles),
// six launches:
//   1. tri_dx_split_kernel: ds (read by its strides, so the second side's
//      transposed view needs no copy) -> hi/lo bf16, channel-major.
//   2. tri_dx_proj_kernel: both gated projections in one launch, the
//      streamed side's str as a hi/lo pair, the local side's fp32
//      pre-activations h (the epilogue of step 3 needs both halves).
//   3. tri_dx_contract_mma_kernel: per channel d_loc = ds . str, then dh
//      from h in registers, written hi/lo channel-major; per-tile db sums.
//   4. tri_dx_out_kernel: dx^T = W_loc . dh^T, rounded to bf16.
//   5. tri_dx_dw_kernel: dW^T = dh^T . x_loc, split over the pairs into
//      partials; tri_dx_sums_kernel adds the dW and db partials in a fixed
//      order (no atomics: two runs give the same bits).
// Precision: ds, str, d_loc and dh are fp32 in the reference, so none is
// rounded to a single bf16.  Each is split v = hi + lo (hi = bf16(v), lo =
// bf16(v - hi)); an fp32 x fp32 product is hi.hi' + hi.lo' + lo.hi', an fp32
// x bf16 one hi.w + lo.w, all accumulated in fp32: ~16 mantissa bits per
// operand, inside check_grad_close's fp32 tolerance where one bf16 rounding
// of ds is not (tests/test_torch_triangle_split.py).  The split raises the
// work from ~21.5 to ~39 GFLOP of bf16 products.  What bounds it now: the
// mma.sync rate of 32 x 32 warp tiles fed from shared memory, and the
// contraction's epilogue traffic (h read, dh written: ~130 MB at r 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int EP = 32;         // pair rows per block in the row kernels
constexpr int PROJ_ROWS = 32;  // x rows per block in the projection
constexpr int CT = 8;          // K5 contraction tile: 8 p x 8 k
constexpr int OT = 64;         // outer-product output tile: 64 x 64
constexpr int OP = 16;         // pairs per outer-product step
constexpr int OUTER_BLOCKS = 512;  // target blocks of one outer-product sum
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// K4: per-pair epilogue backward
// ---------------------------------------------------------------------------

// One block per EP pairs (pair = i * r_j + j).  Dynamic shared memory
// (floats): EP * (2c + 4cz) + 2c + EP.  part_vec row of this block:
// [sum dn*nhat (c) | sum dn (c) | sum du (cz) | sum dzg (cz)].
template <typename T>
__global__ void __launch_bounds__(THREADS)
tri_epi_bwd_rows_kernel(const float* __restrict__ s, const T* __restrict__ xg,
                        const T* __restrict__ dy, const T* __restrict__ ln_s,
                        const T* __restrict__ ln_b, const T* __restrict__ w_o,
                        const T* __restrict__ b_o, const T* __restrict__ w_g,
                        const T* __restrict__ b_g, const T* __restrict__ w_o_t,
                        const T* __restrict__ w_g_t, float* __restrict__ ds,
                        T* __restrict__ dxg, float* __restrict__ n_out,
                        float* __restrict__ du_out, float* __restrict__ dzg_out,
                        float* __restrict__ part_vec, long long P, int cz, int c) {
  extern __shared__ __align__(16) float smem[];
  float* nh = smem;                 // [EP][c]  nhat
  float* xs = nh + EP * c;          // [EP][cz] x_g
  float* dys = xs + EP * cz;        // [EP][cz] dy
  float* dus = dys + EP * cz;       // [EP][cz] du
  float* dzs = dus + EP * cz;       // [EP][cz] dzg
  float* dns = dzs + EP * cz;       // [EP][c]  dn
  float* gam = dns + EP * c;        // [c]
  float* bet = gam + c;             // [c]
  float* rstd_s = bet + c;          // [EP]
  const long long p0 = (long long)blockIdx.x * EP;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pv = part_vec + (size_t)blockIdx.x * (2 * c + 2 * cz);

  for (int e = tid; e < EP * c; e += THREADS) {
    const int p = e / c;
    const long long r = p0 + p;
    nh[e] = r < P ? s[r * c + (e - p * c)] : 0.f;
  }
  for (int e = tid; e < EP * cz; e += THREADS) {
    const int p = e / cz;
    const long long r = p0 + p;
    const int z = e - p * cz;
    xs[e] = r < P ? to_f(xg[r * cz + z]) : 0.f;
    dys[e] = r < P ? to_f(dy[r * cz + z]) : 0.f;
  }
  for (int ch = tid; ch < c; ch += THREADS) {
    gam[ch] = to_f(ln_s[ch]);
    bet[ch] = to_f(ln_b[ch]);
  }
  __syncthreads();

  // LayerNorm statistics, one warp per pair: nh <- nhat; n to scratch
  const float inv_c = 1.f / (float)c;
  for (int p = warp; p < EP; p += THREADS / 32) {
    float* row = nh + p * c;
    float sum = 0.f;
    for (int ch = lane; ch < c; ch += 32) sum += row[ch];
    const float mu = warp_sum(sum) * inv_c;
    float sq = 0.f;
    for (int ch = lane; ch < c; ch += 32) {
      const float d = row[ch] - mu;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_c + LN_EPS);
    const long long r = p0 + p;
    for (int ch = lane; ch < c; ch += 32) {
      const float v = (row[ch] - mu) * rstd;
      row[ch] = v;
      if (r < P) n_out[r * c + ch] = v * gam[ch] + bet[ch];
    }
    if (lane == 0) rstd_s[p] = rstd;
  }
  __syncthreads();

  // u = n.W_o + b_o and the gate, one thread per output channel z
  for (int z = tid; z < cz; z += THREADS) {
    float u[EP], zg[EP];
    const float bo = to_f(b_o[z]), bg = to_f(b_g[z]);
#pragma unroll
    for (int p = 0; p < EP; ++p) {
      u[p] = bo;
      zg[p] = bg;
    }
    for (int ch = 0; ch < c; ++ch) {
      const float w = to_f(w_o[(size_t)ch * cz + z]);
      const float ga = gam[ch], be = bet[ch];
#pragma unroll
      for (int p = 0; p < EP; ++p) u[p] = fmaf(fmaf(nh[p * c + ch], ga, be), w, u[p]);
    }
    for (int zz = 0; zz < cz; ++zz) {
      const float w = to_f(w_g[(size_t)zz * cz + z]);
#pragma unroll
      for (int p = 0; p < EP; ++p) zg[p] = fmaf(xs[p * cz + zz], w, zg[p]);
    }
    float sdu = 0.f, sdz = 0.f;
#pragma unroll
    for (int p = 0; p < EP; ++p) {
      const float g = sigmoid_f(zg[p]);
      const float d = dys[p * cz + z];
      const float du = d * g;
      const float dz = d * u[p] * g * (1.f - g);
      dus[p * cz + z] = du;
      dzs[p * cz + z] = dz;
      sdu += du;
      sdz += dz;
      const long long r = p0 + p;
      if (r < P) {
        du_out[r * cz + z] = du;
        dzg_out[r * cz + z] = dz;
      }
    }
    pv[2 * c + z] = sdu;
    pv[2 * c + cz + z] = sdz;
  }
  __syncthreads();

  // dx_g = dzg.W_g^T (columns < cz) and dn = du.W_o^T (the next c columns)
  for (int col = tid; col < cz + c; col += THREADS) {
    float acc[EP];
#pragma unroll
    for (int p = 0; p < EP; ++p) acc[p] = 0.f;
    if (col < cz) {
      for (int z = 0; z < cz; ++z) {
        const float w = to_f(w_g_t[(size_t)z * cz + col]);
#pragma unroll
        for (int p = 0; p < EP; ++p) acc[p] = fmaf(dzs[p * cz + z], w, acc[p]);
      }
#pragma unroll
      for (int p = 0; p < EP; ++p) {
        const long long r = p0 + p;
        if (r < P) dxg[r * cz + col] = from_f<T>(acc[p]);
      }
    } else {
      const int ch = col - cz;
      for (int z = 0; z < cz; ++z) {
        const float w = to_f(w_o_t[(size_t)z * c + ch]);
#pragma unroll
        for (int p = 0; p < EP; ++p) acc[p] = fmaf(dus[p * cz + z], w, acc[p]);
      }
#pragma unroll
      for (int p = 0; p < EP; ++p) dns[p * c + ch] = acc[p];
    }
  }
  __syncthreads();

  // ds, one warp per pair
  for (int p = warp; p < EP; p += THREADS / 32) {
    const float* nrow = nh + p * c;
    const float* drow = dns + p * c;
    float m1 = 0.f, m2 = 0.f;
    for (int ch = lane; ch < c; ch += 32) {
      const float dnh = drow[ch] * gam[ch];
      m1 += dnh;
      m2 += dnh * nrow[ch];
    }
    m1 = warp_sum(m1) * inv_c;
    m2 = warp_sum(m2) * inv_c;
    const long long r = p0 + p;
    if (r < P) {
      const float rstd = rstd_s[p];
      for (int ch = lane; ch < c; ch += 32)
        ds[r * c + ch] = rstd * (drow[ch] * gam[ch] - m1 - nrow[ch] * m2);
    }
  }
  // this block's partial sums of the LayerNorm parameters' gradients
  for (int ch = tid; ch < c; ch += THREADS) {
    float a = 0.f, b = 0.f;
#pragma unroll 8
    for (int p = 0; p < EP; ++p) {
      a = fmaf(dns[p * c + ch], nh[p * c + ch], a);
      b += dns[p * c + ch];
    }
    pv[ch] = a;
    pv[c + ch] = b;
  }
}

// ---------------------------------------------------------------------------
// Sums over all pairs, in two passes
// ---------------------------------------------------------------------------

// part[z][m][n] = sum over pairs p of range z of A[p][m] * B[p][n].  Row p of
// A lives at (p / a_inner) * a_s0 + (p % a_inner) * a_s1 (channels
// contiguous); B is contiguous (P, N) fp32.
template <typename TA>
__global__ void __launch_bounds__(256)
outer_acc_kernel(const TA* __restrict__ A, long long a_inner, long long a_s0, long long a_s1,
                 const float* __restrict__ B, float* __restrict__ part, long long P, int M,
                 int N, long long rows_per_split) {
  __shared__ __align__(16) float As[OP][OT];
  __shared__ __align__(16) float Bs[OP][OT];
  const int n0 = blockIdx.x * OT, m0 = blockIdx.y * OT;
  const long long pb = (long long)blockIdx.z * rows_per_split;
  const long long pe = pb + rows_per_split < P ? pb + rows_per_split : P;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long pc = pb; pc < pe; pc += OP) {
    for (int e = tid; e < OP * OT; e += 256) {
      const int pr = e / OT, mm = e - pr * OT;
      const long long p = pc + pr;
      const int m = m0 + mm, n = n0 + mm;
      float a = 0.f, b = 0.f;
      if (p < pe) {
        if (m < M) a = to_f(A[(p / a_inner) * a_s0 + (p % a_inner) * a_s1 + m]);
        if (n < N) b = B[p * N + n];
      }
      As[pr][mm] = a;
      Bs[pr][mm] = b;
    }
    __syncthreads();
#pragma unroll
    for (int pr = 0; pr < OP; ++pr) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[pr][tm * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[pr][tn * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tm * 4 + i, n = n0 + tn * 4 + j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j];
    }
}

// out[e] = sum_{i < n} part[i * E + e], in order (E large, n small).
__global__ void __launch_bounds__(256)
sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ out, int n, long long E) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) s += part[(size_t)i * E + e];
  out[e] = s;
}

// out[col] = sum_i part[i * E + col], one block per column, a fixed-order
// tree over 256 strided partial sums (E small, n large).
__global__ void __launch_bounds__(256)
col_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int n, int E) {
  __shared__ float red[256];
  const int col = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += 256) s += part[(size_t)i * E + col];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[col] = red[0];
}

struct OuterPlan {
  int nsplit;
  long long rows;
};

OuterPlan outer_plan(long long P, int M, int N) {
  const long long tiles = (long long)((M + OT - 1) / OT) * ((N + OT - 1) / OT);
  long long nsplit = OUTER_BLOCKS / tiles;
  const long long max_split = (P + OP - 1) / OP;
  if (nsplit > max_split) nsplit = max_split;
  if (nsplit < 1) nsplit = 1;
  const long long rows = (P + nsplit - 1) / nsplit;
  return {(int)((P + rows - 1) / rows), rows};
}

// out (M, N) fp32 = A^T B over all P pairs; part is scratch of
// nsplit * M * N floats.
template <typename TA>
cudaError_t outer_sum(const TA* A, long long a_inner, long long a_s0, long long a_s1,
                      const float* B, float* part, float* out, long long P, int M, int N,
                      cudaStream_t st) {
  const OuterPlan pl = outer_plan(P, M, N);
  const dim3 grid((unsigned)((N + OT - 1) / OT), (unsigned)((M + OT - 1) / OT),
                  (unsigned)pl.nsplit);
  outer_acc_kernel<TA><<<grid, 256, 0, st>>>(A, a_inner, a_s0, a_s1, B, part, P, M, N, pl.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long E = (long long)M * N;
  sum_chunks_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(part, out, pl.nsplit, E);
  return cudaGetLastError();
}

long long outer_scratch(long long P, int M, int N) {
  return (long long)outer_plan(P, M, N).nsplit * M * N;
}

// ---------------------------------------------------------------------------
// K5: streamed projection, contraction, local projection backward
// ---------------------------------------------------------------------------

// out[r, n] = sigmoid(x[r].w[:, c+n] + bias[c+n]) * (x[r].w[:, n] + bias[n]),
// fp32, rows r = (i, k) of x at x + i * si + k * sk, out contiguous (ri*rk, c).
// Dynamic shared memory: PROJ_ROWS * cz floats.
template <typename T>
__global__ void __launch_bounds__(THREADS)
tri_proj_f32_kernel(const T* __restrict__ x, long long si, long long sk,
                    const T* __restrict__ w, const T* __restrict__ bias,
                    float* __restrict__ out, int ri, int rk, int cz, int c) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // [PROJ_ROWS][cz]
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
      val = to_f(x[i * si + (row - i * rk) * sk + ch]);
    }
    xs[e] = val;
  }
  __syncthreads();
  for (int n = tid; n < c; n += THREADS) {
    float av[PROJ_ROWS], ag[PROJ_ROWS];
    const float bv = to_f(bias[n]), bg = to_f(bias[c + n]);
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
        av[r] = fmaf(x4.x, wv[0], fmaf(x4.y, wv[1], fmaf(x4.z, wv[2], fmaf(x4.w, wv[3], av[r]))));
        ag[r] = fmaf(x4.x, wg[0], fmaf(x4.y, wg[1], fmaf(x4.z, wg[2], fmaf(x4.w, wg[3], ag[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < PROJ_ROWS; ++r) {
      const long long row = r0 + r;
      if (row < n_rows) out[row * c + n] = sigmoid_f(ag[r]) * av[r];
    }
  }
}

// d_loc[p, k, ch] = sum_q ds[p, q, ch] * str[q, k, ch]: one block per
// (8 p x 8 k) tile, one thread per channel.  ds row (p, q) at
// p * ds_sp + q * ds_sq (channels contiguous); str, d_loc contiguous.
__global__ void __launch_bounds__(THREADS)
tri_dx_contract_kernel(const float* __restrict__ ds, long long ds_sp, long long ds_sq,
                       const float* __restrict__ strv, float* __restrict__ dloc, int rp,
                       int rq, int rk, int c) {
  const int k0 = blockIdx.x * CT;
  const int p0 = blockIdx.y * CT;
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    float acc[CT][CT];
#pragma unroll
    for (int a = 0; a < CT; ++a)
#pragma unroll
      for (int b = 0; b < CT; ++b) acc[a][b] = 0.f;
#pragma unroll 2
    for (int q = 0; q < rq; ++q) {
      float dv[CT], sv[CT];
#pragma unroll
      for (int a = 0; a < CT; ++a) {
        const int p = p0 + a;
        dv[a] = p < rp ? ds[p * ds_sp + q * ds_sq + ch] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < CT; ++b) {
        const int k = k0 + b;
        sv[b] = k < rk ? strv[((size_t)q * rk + k) * c + ch] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < CT; ++a)
#pragma unroll
        for (int b = 0; b < CT; ++b) acc[a][b] = fmaf(dv[a], sv[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < CT; ++a)
#pragma unroll
      for (int b = 0; b < CT; ++b) {
        const int p = p0 + a, k = k0 + b;
        if (p < rp && k < rk) dloc[((size_t)p * rk + k) * c + ch] = acc[a][b];
      }
  }
}

// One block per EP pairs (p, k) of the local side, pair index p * rk + k.
// Dynamic shared memory (floats): EP * (cz + 2c).  part_vec row of this
// block: [sum dh (2c)].
template <typename T>
__global__ void __launch_bounds__(THREADS)
tri_dx_rows_kernel(const T* __restrict__ x, long long sp, long long sk,
                   const T* __restrict__ w, const T* __restrict__ bias,
                   const T* __restrict__ w_t, const float* __restrict__ dloc,
                   float* __restrict__ dh_out, T* __restrict__ dx,
                   float* __restrict__ part_vec, int rp, int rk, int cz, int c) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [EP][cz]
  float* dhs = xs + EP * cz;     // [EP][2c]
  const long long P = (long long)rp * rk;
  const long long p0 = (long long)blockIdx.x * EP;
  const int tid = threadIdx.x;
  const int c2 = 2 * c;
  float* pv = part_vec + (size_t)blockIdx.x * c2;
  for (int e = tid; e < EP * cz; e += THREADS) {
    const int p = e / cz;
    const long long r = p0 + p;
    float val = 0.f;
    if (r < P) {
      const long long i = r / rk;
      val = to_f(x[i * sp + (r - i * rk) * sk + (e - p * cz)]);
    }
    xs[e] = val;
  }
  __syncthreads();

  // recompute the local gated projection; dh for the value and gate halves
  for (int n = tid; n < c; n += THREADS) {
    float av[EP], ag[EP];
    const float bv = to_f(bias[n]), bg = to_f(bias[c + n]);
#pragma unroll
    for (int p = 0; p < EP; ++p) {
      av[p] = bv;
      ag[p] = bg;
    }
    for (int kk = 0; kk < cz; ++kk) {
      const float wv = to_f(w[(size_t)kk * c2 + n]);
      const float wg = to_f(w[(size_t)kk * c2 + c + n]);
#pragma unroll
      for (int p = 0; p < EP; ++p) {
        av[p] = fmaf(xs[p * cz + kk], wv, av[p]);
        ag[p] = fmaf(xs[p * cz + kk], wg, ag[p]);
      }
    }
    float sv = 0.f, sg_sum = 0.f;
#pragma unroll
    for (int p = 0; p < EP; ++p) {
      const long long r = p0 + p;
      const float dl = r < P ? dloc[r * c + n] : 0.f;
      const float sg = sigmoid_f(ag[p]);
      const float dval = dl * sg;
      const float dgt = dl * av[p] * sg * (1.f - sg);
      dhs[p * c2 + n] = dval;
      dhs[p * c2 + c + n] = dgt;
      if (r < P) {
        dh_out[r * c2 + n] = dval;
        dh_out[r * c2 + c + n] = dgt;
      }
      sv += dval;
      sg_sum += dgt;
    }
    pv[n] = sv;
    pv[c + n] = sg_sum;
  }
  __syncthreads();

  // dx = dh.W_loc^T, one thread per input channel
  for (int z = tid; z < cz; z += THREADS) {
    float acc[EP];
#pragma unroll
    for (int p = 0; p < EP; ++p) acc[p] = 0.f;
    for (int n = 0; n < c2; ++n) {
      const float wt = to_f(w_t[(size_t)n * cz + z]);
#pragma unroll
      for (int p = 0; p < EP; ++p) acc[p] = fmaf(dhs[p * c2 + n], wt, acc[p]);
    }
#pragma unroll
    for (int p = 0; p < EP; ++p) {
      const long long r = p0 + p;
      if (r < P) dx[r * cz + z] = from_f<T>(acc[p]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5, bf16 inputs: tiled tensor-core GEMMs (tile_mma.cuh), split precision
// ---------------------------------------------------------------------------
//
// Scratch over padded extents (Rp, Rq, Rk: r_p, r_q, r_k rounded up to
// 128; Pp = Rp * Rk padded pairs m = p * Rk + k), zero in the pads wherever
// a product reads them; channel-major (ch, ., .) or tile-major
// (tile::tm_index, as the projections write it):
//   ds_hi, ds_lo (c, Rp, Rq) bf16        str_hi, str_lo tile-major (Rq, Rk, c) bf16
//   h tile-major (Rp, Rk, 2c) fp32        dh_hi, dh_lo (2c, Pp) bf16
//   db partials (tiles, 2c) fp32      dW partials (splits, cz, 2c) fp32

using tile::bf16;
using tile::i64;

// ds (rp, rq, c) fp32 by strides -> its hi/lo bf16 pair, channel-major.
// One block per (p, 64 q, 64 channels), through a shared-memory transpose:
// reads coalesced over channels, writes over q.
__global__ void __launch_bounds__(256)
tri_dx_split_kernel(const float* __restrict__ ds, i64 sp, i64 sq, bf16* __restrict__ hi,
                    bf16* __restrict__ lo, int rp, int rq, int Rp, int Rq, int c) {
  __shared__ float t[64][65];
  const int q0 = blockIdx.x * 64, p = blockIdx.y, ch0 = blockIdx.z * 64;
  for (int e = threadIdx.x; e < 64 * 64; e += 256) {
    const int q = e >> 6, ch = e & 63;
    t[ch][q] = (p < rp && q0 + q < rq && ch0 + ch < c)
                   ? ds[p * sp + (i64)(q0 + q) * sq + ch0 + ch]
                   : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 64; e += 256) {
    const int ch = e >> 6, q = e & 63;
    if (ch0 + ch >= c) continue;
    const i64 o = ((i64)(ch0 + ch) * Rp + p) * Rq + q0 + q;
    tile::split_bf16(t[ch][q], hi[o], lo[o]);
  }
}

// Side 0: the streamed projection str (hi/lo); side 1: the local side's
// pre-activations h.
__global__ void __launch_bounds__(tile::PROJ_THREADS)
tri_dx_proj_kernel(tile::ProjSide s0, tile::ProjSide s1, int rk, int Rk, int cz, int c) {
  tile::proj_body(s0, s1, rk, Rk, cz, c);
}

constexpr int STG32 = 36;  // staging row of 32 floats (+4 against bank conflicts)

// One warp's 32 x 32 fp32 tile v (tile::Frag's layout) as hi/lo bf16 rows:
// row r at hi + r * ld, lo + r * ld.  Staged through the warp's `stg` (32 x
// STG32 floats), so that four lanes write each row's 64 bytes.
__device__ __forceinline__ void warp_store_split(float* stg, const tile::Acc& v, bf16* hi,
                                                 bf16* lo, i64 ld) {
  const tile::Frag f;
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stg[(f.row(mt, e) - f.wm * 32) * STG32 + f.col(nt, e) - f.wn * 32] = v[mt][nt][e];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = q * 8 + (lane >> 2), col = (lane & 3) * 8;
    const float* src = stg + r * STG32 + col;
    uint4 h, l;
    tile::split8(*reinterpret_cast<const float4*>(src), *reinterpret_cast<const float4*>(src + 4),
                 h, l);
    *reinterpret_cast<uint4*>(hi + r * ld + col) = h;
    *reinterpret_cast<uint4*>(lo + r * ld + col) = l;
  }
}

// Per channel ch = blockIdx.z, one 128 p x 64 k tile of
//     d_loc[p, k] = sum_q ds[p, q] * str[q, k]       (3 split products)
// then, in registers, dh = [d_loc * sg | d_loc * val * sg * (1 - sg)] from
// h, written as hi/lo (zero past rp, rk), and this tile's sums of dh for db.
__global__ void __launch_bounds__(tile::THREADS)
tri_dx_contract_mma_kernel(const bf16* __restrict__ ds_hi, const bf16* __restrict__ ds_lo,
                           const bf16* __restrict__ st_hi, const bf16* __restrict__ st_lo,
                           const float* __restrict__ h, bf16* __restrict__ dh_hi,
                           bf16* __restrict__ dh_lo, float* __restrict__ db_part, int rp,
                           int rk, int Rp, int Rq, int Rk, int c) {
  using namespace tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int ch = blockIdx.z, p0 = blockIdx.y * BM, k0 = blockIdx.x * BN;
  const i64 a_off = ((i64)ch * Rp + p0) * Rq;
  Acc acc;
  auto load = [&](const Stage& st, int ks) {
    const int q0 = ks * BK;
    load_a(st.a_hi, [&](int r, int kc, bool& ok) {
      ok = true;
      return ds_hi + a_off + (i64)r * Rq + q0 + kc;
    });
    load_a(st.a_lo, [&](int r, int kc, bool& ok) {
      ok = true;
      return ds_lo + a_off + (i64)r * Rq + q0 + kc;
    });
    load_b_kn(st.b_hi, [&](int kr, int nc, bool& ok) {
      ok = true;
      return st_hi + tm_index(q0 + kr, k0 + nc, ch, Rk, c);
    });
    load_b_kn(st.b_lo, [&](int kr, int nc, bool& ok) {
      ok = true;
      return st_lo + tm_index(q0 + kr, k0 + nc, ch, Rk, c);
    });
  };
  mainloop<true, true, true>(smem, Rq / BK, load, acc);

  const Frag f;
  const i64 Pp = (i64)Rp * Rk;
  // all of this thread's h first, so that the loads overlap
  float2 hvs[2][2][4], hgs[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const i64 o = tm_index(p0 + f.row(mt, 2 * hf), k0 + f.col(nt, 0), ch, Rk, 2 * c);
        hvs[mt][hf][nt] = *reinterpret_cast<const float2*>(h + o);
        hgs[mt][hf][nt] = *reinterpret_cast<const float2*>(h + o + (i64)c * tile::PM);
      }
  // dh in registers: acc <- the value half, dg <- the gate half
  float sv = 0.f, sg_sum = 0.f;
  Acc dg;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + f.row(mt, 2 * hf);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int k = k0 + f.col(nt, 0);  // and k + 1
        const float2 val = hvs[mt][hf][nt], gt = hgs[mt][hf][nt];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& d = acc[mt][nt][2 * hf + e];
          const float sg = tile::sigmoid_f(e ? gt.y : gt.x);
          const bool ok = p < rp && k + e < rk;
          dg[mt][nt][2 * hf + e] = ok ? d * (e ? val.y : val.x) * sg * (1.f - sg) : 0.f;
          d = ok ? d * sg : 0.f;
          sv += d;
          sg_sum += dg[mt][nt][2 * hf + e];
        }
      }
    }
  // written as rows of 32 values through shared memory (the ring is free)
  float* stg = reinterpret_cast<float*>(smem_raw) + (threadIdx.x >> 5) * 32 * STG32;
  const i64 o = (i64)(p0 + f.wm * 32) * Rk + k0 + f.wn * 32;
  warp_store_split(stg, acc, dh_hi + (i64)ch * Pp + o, dh_lo + (i64)ch * Pp + o, Rk);
  warp_store_split(stg, dg, dh_hi + (i64)(c + ch) * Pp + o, dh_lo + (i64)(c + ch) * Pp + o, Rk);
  // this tile's sums, in a fixed order: lanes, then warps
  sv = warp_sum(sv);
  sg_sum = warp_sum(sg_sum);
  __shared__ float red[2][tile::THREADS / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = sv;
    red[1][warp] = sg_sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < tile::THREADS / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    float* part = db_part + (i64)(blockIdx.y * gridDim.x + blockIdx.x) * 2 * c;
    part[ch] = a;
    part[c + ch] = b;
  }
}

// dx^T (cz, Pp) = W_loc (cz, 2c) . dh^T (2c, Pp)  (2 split products), one
// 128 z x 64 pair tile; rounded to bf16 and written through shared memory
// as rows of dx (rp, rk, cz).
__global__ void __launch_bounds__(tile::THREADS)
tri_dx_out_kernel(const bf16* __restrict__ w, const bf16* __restrict__ dh_hi,
                  const bf16* __restrict__ dh_lo, bf16* __restrict__ dx, int rp, int rk,
                  int Rk, i64 Pp, int cz, int c) {
  using namespace tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int z0 = blockIdx.x * BM;
  const i64 m0 = (i64)blockIdx.y * BN;
  const int c2 = 2 * c;
  Acc acc;
  auto load = [&](const Stage& st, int ks) {
    const int n0 = ks * BK;
    load_a(st.a_hi, [&](int r, int kc, bool& ok) {
      ok = z0 + r < cz;
      return ok ? w + (i64)(z0 + r) * c2 + n0 + kc : w;
    });
    load_b_kn(st.b_hi, [&](int kr, int nc, bool& ok) {
      ok = true;
      return dh_hi + (i64)(n0 + kr) * Pp + m0 + nc;
    });
    load_b_kn(st.b_lo, [&](int kr, int nc, bool& ok) {
      ok = true;
      return dh_lo + (i64)(n0 + kr) * Pp + m0 + nc;
    });
  };
  mainloop<false, true, true>(smem, c2 / BK, load, acc);

  constexpr int LDO = BM + 8;  // [pair][z] tile
  const Frag f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        smem[f.col(nt, e) * LDO + f.row(mt, e)] = __float2bfloat16(acc[mt][nt][e]);
  __syncthreads();
  for (int e = threadIdx.x; e < BN * (BM / 8); e += tile::THREADS) {
    const int ml = e / (BM / 8), zc = (e % (BM / 8)) * 8;
    const i64 p = m0 / Rk;  // a 64-pair tile lies in one p
    const int k = (int)(m0 - p * Rk) + ml;
    if (p < rp && k < rk && z0 + zc < cz)
      *reinterpret_cast<uint4*>(dx + ((i64)p * rk + k) * cz + z0 + zc) =
          *reinterpret_cast<const uint4*>(smem + ml * LDO + zc);
  }
}

// dW^T partial (2c, cz) over one range of k-steps of the padded pairs:
// dh^T (2c, Pp) . x_loc (Pp, cz)  (2 split products); x's rows past rp, rk
// are zeros.  part[split][z][n].
__global__ void __launch_bounds__(tile::THREADS)
tri_dx_dw_kernel(const bf16* __restrict__ dh_hi, const bf16* __restrict__ dh_lo,
                 const bf16* __restrict__ x, i64 sp, i64 sk, float* __restrict__ part, int rp,
                 int rk, int Rk, i64 Pp, int cz, int c, int steps) {
  using namespace tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int z0 = blockIdx.x * BN, n0 = blockIdx.y * BM, c2 = 2 * c;
  const int ks0 = blockIdx.z * steps;
  const int nk = min(steps, (int)(Pp / BK) - ks0);
  Acc acc;
  auto load = [&](const Stage& st, int ks) {
    const i64 mb = (i64)(ks0 + ks) * BK;
    load_a(st.a_hi, [&](int r, int kc, bool& ok) {
      ok = n0 + r < c2;
      return ok ? dh_hi + (i64)(n0 + r) * Pp + mb + kc : dh_hi;
    });
    load_a(st.a_lo, [&](int r, int kc, bool& ok) {
      ok = n0 + r < c2;
      return ok ? dh_lo + (i64)(n0 + r) * Pp + mb + kc : dh_lo;
    });
    const i64 p = mb / Rk;  // a k-step of BK pairs lies in one p (Rk % 64 == 0)
    const int kb = (int)(mb - p * Rk);
    load_b_kn(st.b_hi, [&](int kr, int nc, bool& ok) {
      const int k = kb + kr, z = z0 + nc;
      ok = p < rp && k < rk && z < cz;
      return ok ? x + p * sp + k * sk + z : x;
    });
  };
  mainloop<true, false, true>(smem, nk, load, acc);

  const Frag f;
  float* out = part + (i64)blockIdx.z * cz * c2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + f.row(mt, e), z = z0 + f.col(nt, e);
        if (n < c2 && z < cz) out[(i64)z * c2 + n] = acc[mt][nt][e];
      }
}

// dw[e] = sum of the split partials, db[n] = sum of the tile partials, each
// in a fixed order (no atomics: two runs give the same bits).
__global__ void __launch_bounds__(256)
tri_dx_sums_kernel(const float* __restrict__ dw_part, const float* __restrict__ db_part,
                   float* __restrict__ dw, float* __restrict__ db, int nsplit, int ntiles,
                   int E, int c2) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e < E) {
    float s = 0.f;
    for (int i = 0; i < nsplit; ++i) s += dw_part[(i64)i * E + e];
    dw[e] = s;
  } else if (e < E + c2) {
    const int n = e - E;
    float s = 0.f;
    for (int i = 0; i < ntiles; ++i) s += db_part[(i64)i * c2 + n];
    db[n] = s;
  }
}

struct DxPlan {
  int Rp, Rq, Rk, ntiles, nsplit, steps;
  i64 Pp;
  // byte offsets into the scratch
  i64 ds_hi, ds_lo, st_hi, st_lo, h, dh_hi, dh_lo, db_part, dw_part, bytes;
};

DxPlan dx_plan(int rp, int rq, int rk, int cz, int c) {
  DxPlan d;
  d.Rp = tile::round_up(rp, tile::PAD);
  d.Rq = tile::round_up(rq, tile::PAD);
  d.Rk = tile::round_up(rk, tile::PAD);
  d.Pp = (i64)d.Rp * d.Rk;
  d.ntiles = (d.Rp / tile::BM) * (d.Rk / tile::BN);
  const int ksteps = (int)(d.Pp / tile::BK);
  const int wtiles = ((cz + tile::BN - 1) / tile::BN) * ((2 * c + tile::BM - 1) / tile::BM);
  int nsplit = OUTER_BLOCKS / wtiles;
  nsplit = nsplit < 1 ? 1 : (nsplit > ksteps ? ksteps : nsplit);
  d.steps = (ksteps + nsplit - 1) / nsplit;
  d.nsplit = (ksteps + d.steps - 1) / d.steps;
  i64 off = 0;
  auto take = [&](i64 bytes) {
    const i64 o = off;
    off += (bytes + 255) / 256 * 256;
    return o;
  };
  const i64 ds_n = (i64)c * d.Rp * d.Rq, st_n = (i64)c * d.Rq * d.Rk, h_n = 2 * c * d.Pp;
  d.ds_hi = take(2 * ds_n);
  d.ds_lo = take(2 * ds_n);
  d.st_hi = take(2 * st_n);
  d.st_lo = take(2 * st_n);
  d.h = take(4 * h_n);
  d.dh_hi = take(2 * h_n);
  d.dh_lo = take(2 * h_n);
  d.db_part = take(4 * (i64)d.ntiles * 2 * c);
  d.dw_part = take(4 * (i64)d.nsplit * cz * 2 * c);
  d.bytes = off;
  return d;
}

// ---------------------------------------------------------------------------
// K4, bf16 inputs: the per-pair pass and the parameter sums on the tensor
// cores (tile_mma.cuh), split precision
// ---------------------------------------------------------------------------
//
// Scratch (bytes, epi_plan): n_hi, n_lo (P, c), du_hi, du_lo, dz_hi, dz_lo
// (P, cz) bf16, pair-major; the pair pass's per-block vector partials
// (blocks, 2c + 2cz) fp32; the dW_o and dW_g split partials fp32.

constexpr int EPI_WARPS = 8;          // warps of a block of the pair pass
constexpr int EPI_ROWS = 16;          // pairs of one warp tile
constexpr int EPI_MAX_BLOCKS = 1024;  // the pair pass's grid is at most this

// Shared memory of the pair pass for a channel width W (c, cz <= W): W_o and
// W_g, four [16][W + 8] bf16 tiles per warp, each warp's four vector sums
// and the four parameter vectors, fp32.
__host__ __device__ constexpr int epi_smem(int W) {
  return 2 * W * (W + 8) * 2 + EPI_WARPS * 4 * EPI_ROWS * (W + 8) * 2 +
         EPI_WARPS * 4 * W * 4 + 4 * W * 4;
}
static_assert(epi_smem(128) <= 232448, "the pair pass fits one SM at c = cz = 128");

// One block of 8 warps per SM; each warp walks 16-pair tiles on its own (a
// warp's tile rows are its own rows of every A operand, so __syncwarp
// orders them).  Per tile, in the warp's four tiles ta0, ta1, tb0, tb1:
//   1. x_g -> tb0, dy -> tb1 by cp.async; s straight into registers, the
//      LayerNorm statistics by quad shuffles, n as hi/lo -> ta0, ta1 (and
//      to global memory for dW_o);
//   2. u = n.W_o (2 products), zg = x_g.W_g (1), W read [k][n] through
//      ldmatrix.trans;
//   3. g, du, dzg in registers, their column sums; du hi/lo -> ta0, ta1,
//      dzg hi/lo -> tb0, tb1 (and to global memory for the dW sums);
//   4. dn = du.W_o^T (2 products), W read [n][k] through ldmatrix; ds, and
//      the dln_s, dln_b column sums, from s read again;
//   5. dx_g = dzg.W_g^T (2 products).
// Each warp adds its column sums to its own shared-memory row in tile
// order; the block adds its warps' rows in order into one partial row.
template <int NW>  // W = 16 NW: c, cz <= W, multiples of 16
__global__ void __launch_bounds__(EPI_WARPS * 32, 1)
tri_epi_bwd_mma_kernel(const float* __restrict__ s, const bf16* __restrict__ xg,
                       const bf16* __restrict__ dy, const bf16* __restrict__ ln_s,
                       const bf16* __restrict__ ln_b, const bf16* __restrict__ w_o,
                       const bf16* __restrict__ b_o, const bf16* __restrict__ w_g,
                       const bf16* __restrict__ b_g, float* __restrict__ ds,
                       bf16* __restrict__ dxg, bf16* __restrict__ n_hi,
                       bf16* __restrict__ n_lo, bf16* __restrict__ du_hi,
                       bf16* __restrict__ du_lo, bf16* __restrict__ dz_hi,
                       bf16* __restrict__ dz_lo, float* __restrict__ part_vec, i64 P, int cz,
                       int c) {
  using namespace tile;
  constexpr int W = 16 * NW, LD = W + 8, NT = 2 * NW, TILE = EPI_ROWS * LD;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wo = reinterpret_cast<bf16*>(smem_raw);  // [W][LD]: W_o[ch][z]
  bf16* wg = wo + W * LD;                         // [W][LD]: W_g[z'][z]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* ta0 = wg + W * LD + warp * 4 * TILE;
  bf16* ta1 = ta0 + TILE;
  bf16* tb0 = ta1 + TILE;
  bf16* tb1 = tb0 + TILE;
  float* vsum_all = reinterpret_cast<float*>(wg + W * LD + EPI_WARPS * 4 * TILE);
  float* vsum = vsum_all + warp * 4 * W;      // [dln_s | dln_b | db_o | db_g]
  float* prm = vsum_all + EPI_WARPS * 4 * W;  // [ln_s | ln_b | b_o | b_g]

  for (int e = tid; e < W * (W / 8); e += EPI_WARPS * 32) {
    const int r = e / (W / 8), z = (e % (W / 8)) * 8;
    const bool ok_o = r < c && z < cz, ok_g = r < cz && z < cz;
    cp16(wo + r * LD + z, ok_o ? w_o + (i64)r * cz + z : w_o, ok_o);
    cp16(wg + r * LD + z, ok_g ? w_g + (i64)r * cz + z : w_g, ok_g);
  }
  cp_commit();
  for (int i = tid; i < W; i += EPI_WARPS * 32) {
    prm[i] = i < c ? __bfloat162float(ln_s[i]) : 0.f;
    prm[W + i] = i < c ? __bfloat162float(ln_b[i]) : 0.f;
    prm[2 * W + i] = i < cz ? __bfloat162float(b_o[i]) : 0.f;
    prm[3 * W + i] = i < cz ? __bfloat162float(b_g[i]) : 0.f;
  }
  for (int i = tid; i < EPI_WARPS * 4 * W; i += EPI_WARPS * 32) vsum_all[i] = 0.f;
  cp_wait<0>();
  __syncthreads();

  const float inv_c = 1.f / (float)c;
  const i64 ntiles = (P + EPI_ROWS - 1) / EPI_ROWS;
  for (i64 tl = (i64)blockIdx.x * EPI_WARPS + warp; tl < ntiles;
       tl += (i64)gridDim.x * EPI_WARPS) {
    const i64 p0 = tl * EPI_ROWS;
    const i64 pr[2] = {p0 + g, p0 + g + 8};  // this thread's rows g, g + 8
    __syncwarp();                            // the last tile's reads are done
    for (int e = lane; e < EPI_ROWS * (W / 8); e += 32) {
      const int r = e / (W / 8), z = (e % (W / 8)) * 8;
      const bool ok = p0 + r < P && z < cz;
      const i64 o = (p0 + r) * cz + z;
      cp16(tb0 + r * LD + z, ok ? xg + o : xg, ok);
      cp16(tb1 + r * LD + z, ok ? dy + o : dy, ok);
    }
    cp_commit();

    // 1. LayerNorm: rows g and g + 8, columns nt * 8 + 2t (+1)
    float mu[2], rstd[2];
    {
      float sv[2][NT][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + 2 * t;
          float2 v = make_float2(0.f, 0.f);
          if (pr[h] < P && col < c) v = *reinterpret_cast<const float2*>(s + pr[h] * c + col);
          sv[h][nt][0] = v.x;
          sv[h][nt][1] = v.y;
          sum += v.x + v.y;
        }
        sum += __shfl_xor_sync(FULL, sum, 1);
        sum += __shfl_xor_sync(FULL, sum, 2);
        mu[h] = sum * inv_c;
        float sq = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt * 8 + 2 * t < c) {
            const float d0 = sv[h][nt][0] - mu[h], d1 = sv[h][nt][1] - mu[h];
            sq += d0 * d0 + d1 * d1;
          }
        sq += __shfl_xor_sync(FULL, sq, 1);
        sq += __shfl_xor_sync(FULL, sq, 2);
        rstd[h] = rsqrtf(sq * inv_c + LN_EPS);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + 2 * t, row = g + 8 * h;
          float n0 = 0.f, n1 = 0.f;
          if (pr[h] < P && col < c) {
            n0 = (sv[h][nt][0] - mu[h]) * rstd[h] * prm[col] + prm[W + col];
            n1 = (sv[h][nt][1] - mu[h]) * rstd[h] * prm[col + 1] + prm[W + col + 1];
          }
          bf16 h0, l0, h1, l1;
          split_bf16(n0, h0, l0);
          split_bf16(n1, h1, l1);
          *reinterpret_cast<__nv_bfloat162*>(ta0 + row * LD + col) = __halves2bfloat162(h0, h1);
          *reinterpret_cast<__nv_bfloat162*>(ta1 + row * LD + col) = __halves2bfloat162(l0, l1);
        }
    }
    __syncwarp();
    for (int e = lane; e < EPI_ROWS * (c / 8); e += 32) {  // n, for dW_o
      const int r = e / (c / 8), col = (e % (c / 8)) * 8;
      if (p0 + r < P) {
        const i64 o = (p0 + r) * c + col;
        *reinterpret_cast<uint4*>(n_hi + o) = *reinterpret_cast<const uint4*>(ta0 + r * LD + col);
        *reinterpret_cast<uint4*>(n_lo + o) = *reinterpret_cast<const uint4*>(ta1 + r * LD + col);
      }
    }
    cp_wait<0>();
    __syncwarp();  // x_g and dy landed

    // 2. u = n.W_o (hi and lo), zg = x_g.W_g
    float au[NT][4], ag[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) au[nt][e] = ag[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NW; ++kc) {
      uint32_t ah[4], al[4], ax[4];
      frag_a(ah, ta0, LD, 0, kc * 16);
      frag_a(al, ta1, LD, 0, kc * 16);
      frag_a(ax, tb0, LD, 0, kc * 16);
#pragma unroll
      for (int np = 0; np < NW; ++np) {
        uint32_t b[2][2], bw[2][2];
        frag_b2<true>(b, wo, LD, np * 16, kc * 16);
        frag_b2<true>(bw, wg, LD, np * 16, kc * 16);
        mma16816(au[2 * np], al, b[0][0], b[0][1]);
        mma16816(au[2 * np + 1], al, b[1][0], b[1][1]);
        mma16816(ag[2 * np], ax, bw[0][0], bw[0][1]);
        mma16816(ag[2 * np + 1], ax, bw[1][0], bw[1][1]);
        mma16816(au[2 * np], ah, b[0][0], b[0][1]);
        mma16816(au[2 * np + 1], ah, b[1][0], b[1][1]);
      }
    }

    // 3. g, du, dzg (au <- du, ag <- dzg) and their column sums
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 d2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(tb1 + (g + 8 * h) * LD + col));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dyv = e ? d2.y : d2.x;
          const float u = au[nt][2 * h + e] + prm[2 * W + col + e];
          const float gg = tile::sigmoid_f(ag[nt][2 * h + e] + prm[3 * W + col + e]);
          au[nt][2 * h + e] = dyv * gg;
          ag[nt][2 * h + e] = dyv * u * gg * (1.f - gg);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = au[nt][e] + au[nt][2 + e], b = ag[nt][e] + ag[nt][2 + e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          a += __shfl_xor_sync(FULL, a, o);
          b += __shfl_xor_sync(FULL, b, o);
        }
        if (g == 0) {
          vsum[2 * W + col + e] += a;
          vsum[3 * W + col + e] += b;
        }
      }
    }
    __syncwarp();  // every lane read n, x_g and dy
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = (g + 8 * h) * LD + nt * 8 + 2 * t;
        bf16 h0, l0, h1, l1;
        split_bf16(au[nt][2 * h], h0, l0);
        split_bf16(au[nt][2 * h + 1], h1, l1);
        *reinterpret_cast<__nv_bfloat162*>(ta0 + o) = __halves2bfloat162(h0, h1);
        *reinterpret_cast<__nv_bfloat162*>(ta1 + o) = __halves2bfloat162(l0, l1);
        split_bf16(ag[nt][2 * h], h0, l0);
        split_bf16(ag[nt][2 * h + 1], h1, l1);
        *reinterpret_cast<__nv_bfloat162*>(tb0 + o) = __halves2bfloat162(h0, h1);
        *reinterpret_cast<__nv_bfloat162*>(tb1 + o) = __halves2bfloat162(l0, l1);
      }
    __syncwarp();
    for (int e = lane; e < EPI_ROWS * (cz / 8); e += 32) {  // du, dzg, for the dW sums
      const int r = e / (cz / 8), z = (e % (cz / 8)) * 8;
      if (p0 + r < P) {
        const i64 o = (p0 + r) * cz + z;
        const int so = r * LD + z;
        *reinterpret_cast<uint4*>(du_hi + o) = *reinterpret_cast<const uint4*>(ta0 + so);
        *reinterpret_cast<uint4*>(du_lo + o) = *reinterpret_cast<const uint4*>(ta1 + so);
        *reinterpret_cast<uint4*>(dz_hi + o) = *reinterpret_cast<const uint4*>(tb0 + so);
        *reinterpret_cast<uint4*>(dz_lo + o) = *reinterpret_cast<const uint4*>(tb1 + so);
      }
    }

    // 4. dn = du.W_o^T, then ds and the LayerNorm parameters' column sums
    {
      float dn[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) dn[nt][0] = dn[nt][1] = dn[nt][2] = dn[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NW; ++kc) {
        uint32_t ah[4], al[4];
        frag_a(ah, ta0, LD, 0, kc * 16);
        frag_a(al, ta1, LD, 0, kc * 16);
#pragma unroll
        for (int np = 0; np < NW; ++np) {
          uint32_t b[2][2];
          frag_b2<false>(b, wo, LD, np * 16, kc * 16);
          mma16816(dn[2 * np], al, b[0][0], b[0][1]);
          mma16816(dn[2 * np + 1], al, b[1][0], b[1][1]);
          mma16816(dn[2 * np], ah, b[0][0], b[0][1]);
          mma16816(dn[2 * np + 1], ah, b[1][0], b[1][1]);
        }
      }
      float nh[NT][4], m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = pr[h] < P && col < c;
          float2 v = make_float2(0.f, 0.f);
          if (ok) v = *reinterpret_cast<const float2*>(s + pr[h] * c + col);
          nh[nt][2 * h] = ok ? (v.x - mu[h]) * rstd[h] : 0.f;
          nh[nt][2 * h + 1] = ok ? (v.y - mu[h]) * rstd[h] : 0.f;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dnh = dn[nt][2 * h + e] * prm[col + e];
            m1[h] += dnh;
            m2[h] += dnh * nh[nt][2 * h + e];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m1[h] += __shfl_xor_sync(FULL, m1[h], 1);
        m1[h] += __shfl_xor_sync(FULL, m1[h], 2);
        m2[h] += __shfl_xor_sync(FULL, m2[h], 1);
        m2[h] += __shfl_xor_sync(FULL, m2[h], 2);
        m1[h] *= inv_c;
        m2[h] *= inv_c;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (pr[h] < P && col < c) {
            float2 o;
            o.x = rstd[h] * (dn[nt][2 * h] * prm[col] - m1[h] - nh[nt][2 * h] * m2[h]);
            o.y = rstd[h] * (dn[nt][2 * h + 1] * prm[col + 1] - m1[h] - nh[nt][2 * h + 1] * m2[h]);
            *reinterpret_cast<float2*>(ds + pr[h] * c + col) = o;
          }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = dn[nt][e] * nh[nt][e] + dn[nt][2 + e] * nh[nt][2 + e];
          float b = dn[nt][e] + dn[nt][2 + e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            a += __shfl_xor_sync(FULL, a, o);
            b += __shfl_xor_sync(FULL, b, o);
          }
          if (g == 0) {
            vsum[col + e] += a;
            vsum[W + col + e] += b;
          }
        }
      }
    }

    // 5. dx_g = dzg.W_g^T
    {
      float dx[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) dx[nt][0] = dx[nt][1] = dx[nt][2] = dx[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NW; ++kc) {
        uint32_t ah[4], al[4];
        frag_a(ah, tb0, LD, 0, kc * 16);
        frag_a(al, tb1, LD, 0, kc * 16);
#pragma unroll
        for (int np = 0; np < NW; ++np) {
          uint32_t b[2][2];
          frag_b2<false>(b, wg, LD, np * 16, kc * 16);
          mma16816(dx[2 * np], al, b[0][0], b[0][1]);
          mma16816(dx[2 * np + 1], al, b[1][0], b[1][1]);
          mma16816(dx[2 * np], ah, b[0][0], b[0][1]);
          mma16816(dx[2 * np + 1], ah, b[1][0], b[1][1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (pr[h] < P && col < cz)
            *reinterpret_cast<uint32_t*>(dxg + pr[h] * cz + col) =
                pack_bf16(dx[nt][2 * h], dx[nt][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  // this block's partial row, its warps added in order
  float* pv = part_vec + (i64)blockIdx.x * (2 * c + 2 * cz);
  for (int i = tid; i < 4 * W; i += EPI_WARPS * 32) {
    const int q = i / W, j = i - q * W;
    if (j >= (q < 2 ? c : cz)) continue;
    float a = 0.f;
    for (int w = 0; w < EPI_WARPS; ++w) a += vsum_all[w * 4 * W + i];
    pv[(q == 0 ? 0 : q == 1 ? c : q == 2 ? 2 * c : 2 * c + cz) + j] = a;
  }
}

// dW partial over one range of k-steps of the pairs: part[split][m][n] =
// sum_p A[p][m] B[p][n], A (P, M) and B (P, N) bf16, pair-major; A's lo
// tile if A_LO, B's always (3 split products with A_LO, else 2).  Rows past
// P read as zeros.
template <bool A_LO>
__global__ void __launch_bounds__(tile::THREADS)
tri_epi_dw_kernel(const bf16* __restrict__ a_hi, const bf16* __restrict__ a_lo,
                  const bf16* __restrict__ b_hi, const bf16* __restrict__ b_lo,
                  float* __restrict__ part, i64 P, int M, int N, int steps) {
  using namespace tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const i64 ks0 = (i64)blockIdx.z * steps;
  const i64 total = (P + BK - 1) / BK;
  const int nk = (int)(total - ks0 < steps ? total - ks0 : steps);
  Acc acc;
  auto load = [&](const Stage& st, int ks) {
    const i64 pb = (ks0 + ks) * BK;
    load_a_km(st.a_hi, [&](int kr, int mc, bool& ok) {
      ok = pb + kr < P && m0 + mc < M;
      return ok ? a_hi + (pb + kr) * M + m0 + mc : a_hi;
    });
    if constexpr (A_LO)
      load_a_km(st.a_lo, [&](int kr, int mc, bool& ok) {
        ok = pb + kr < P && m0 + mc < M;
        return ok ? a_lo + (pb + kr) * M + m0 + mc : a_lo;
      });
    load_b_kn(st.b_hi, [&](int kr, int nc, bool& ok) {
      ok = pb + kr < P && n0 + nc < N;
      return ok ? b_hi + (pb + kr) * N + n0 + nc : b_hi;
    });
    load_b_kn(st.b_lo, [&](int kr, int nc, bool& ok) {
      ok = pb + kr < P && n0 + nc < N;
      return ok ? b_lo + (pb + kr) * N + n0 + nc : b_lo;
    });
  };
  mainloop<A_LO, true, true, true>(smem, nk, load, acc);
  const Frag f;
  float* out = part + (i64)blockIdx.z * M * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + f.row(mt, e), n = n0 + f.col(nt, e);
        if (m < M && n < N) out[(i64)m * N + n] = acc[mt][nt][e];
      }
}

// dW_o and dW_g from their split partials, and the vector sums from the pair
// pass's block rows, each in a fixed order (no atomics: two runs give the
// same bits).
__global__ void __launch_bounds__(256)
tri_epi_sums_kernel(const float* __restrict__ dwo_part, const float* __restrict__ dwg_part,
                    const float* __restrict__ vec_part, float* __restrict__ dw_o,
                    float* __restrict__ dw_g, float* __restrict__ vec, int nsplit, int nblk,
                    int Eo, int Eg, int Ev) {
  int j = blockIdx.x * 256 + threadIdx.x;
  const float* src;
  float* dst;
  int n, E;
  if (j < Eo) {
    src = dwo_part, dst = dw_o, n = nsplit, E = Eo;
  } else if ((j -= Eo) < Eg) {
    src = dwg_part, dst = dw_g, n = nsplit, E = Eg;
  } else if ((j -= Eg) < Ev) {
    src = vec_part, dst = vec, n = nblk, E = Ev;
  } else {
    return;
  }
  float a = 0.f;
  for (int i = 0; i < n; ++i) a += src[(i64)i * E + j];
  dst[j] = a;
}

struct EpiPlan {
  int nblk_max, nsplit, steps;
  // byte offsets into the scratch
  i64 n_hi, n_lo, du_hi, du_lo, dz_hi, dz_lo, vec_part, dwo_part, dwg_part, bytes;
};

EpiPlan epi_plan(i64 P, int cz, int c) {
  EpiPlan d;
  const i64 nb = ((P + EPI_ROWS - 1) / EPI_ROWS + EPI_WARPS - 1) / EPI_WARPS;
  d.nblk_max = (int)(nb < EPI_MAX_BLOCKS ? nb : EPI_MAX_BLOCKS);
  const i64 ksteps = (P + tile::BK - 1) / tile::BK;
  const int t_o = ((c + tile::BM - 1) / tile::BM) * ((cz + tile::BN - 1) / tile::BN);
  const int t_g = ((cz + tile::BM - 1) / tile::BM) * ((cz + tile::BN - 1) / tile::BN);
  i64 nsplit = OUTER_BLOCKS / 2 / (t_o > t_g ? t_o : t_g);
  nsplit = nsplit < 1 ? 1 : (nsplit > ksteps ? ksteps : nsplit);
  d.steps = (int)((ksteps + nsplit - 1) / nsplit);
  d.nsplit = (int)((ksteps + d.steps - 1) / d.steps);
  i64 off = 0;
  auto take = [&](i64 bytes) {
    const i64 o = off;
    off += (bytes + 255) / 256 * 256;
    return o;
  };
  d.n_hi = take(2 * P * c);
  d.n_lo = take(2 * P * c);
  d.du_hi = take(2 * P * cz);
  d.du_lo = take(2 * P * cz);
  d.dz_hi = take(2 * P * cz);
  d.dz_lo = take(2 * P * cz);
  d.vec_part = take(4 * (i64)d.nblk_max * (2 * c + 2 * cz));
  d.dwo_part = take(4 * (i64)d.nsplit * c * cz);
  d.dwg_part = take(4 * (i64)d.nsplit * cz * cz);
  d.bytes = off;
  return d;
}

struct EpiArgs {
  const float* s;
  const bf16 *xg, *dy, *ln_s, *ln_b, *w_o, *b_o, *w_g, *b_g;
  float* ds;
  bf16 *dxg, *n_hi, *n_lo, *du_hi, *du_lo, *dz_hi, *dz_lo;
  float* vec_part;
  i64 P;
  int cz, c;
};

template <int NW>
cudaError_t launch_epi_pass(const EpiArgs& a, int nblk, cudaStream_t st) {
  constexpr int smem = epi_smem(16 * NW);
  const cudaError_t err = tile::configure((const void*)tri_epi_bwd_mma_kernel<NW>, smem);
  if (err != cudaSuccess) return err;
  tri_epi_bwd_mma_kernel<NW><<<nblk, EPI_WARPS * 32, smem, st>>>(
      a.s, a.xg, a.dy, a.ln_s, a.ln_b, a.w_o, a.b_o, a.w_g, a.b_g, a.ds, a.dxg, a.n_hi, a.n_lo,
      a.du_hi, a.du_lo, a.dz_hi, a.dz_lo, a.vec_part, a.P, a.cz, a.c);
  return cudaGetLastError();
}

cudaError_t run_epilogue_mma(const float* s, const bf16* xg, const bf16* dy, const bf16* ln_s,
                             const bf16* ln_b, const bf16* w_o, const bf16* b_o,
                             const bf16* w_g, const bf16* b_g, float* ds, bf16* dxg,
                             float* vec, float* dw_o, float* dw_g, void* scratch, i64 P, int cz,
                             int c, cudaStream_t st) {
  if (c % 16 != 0 || cz % 16 != 0 || c > 128 || cz > 128) return cudaErrorInvalidValue;
  const EpiPlan d = epi_plan(P, cz, c);
  char* base = static_cast<char*>(scratch);
  auto bp = [&](i64 off) { return reinterpret_cast<bf16*>(base + off); };
  float* dwo_part = reinterpret_cast<float*>(base + d.dwo_part);
  float* dwg_part = reinterpret_cast<float*>(base + d.dwg_part);
  const EpiArgs a{s,        xg,         dy,         ln_s,       ln_b,       w_o,
                  b_o,      w_g,        b_g,        ds,         dxg,        bp(d.n_hi),
                  bp(d.n_lo), bp(d.du_hi), bp(d.du_lo), bp(d.dz_hi), bp(d.dz_lo),
                  reinterpret_cast<float*>(base + d.vec_part), P, cz, c};
  int dev = 0, nsm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int nblk = nsm < d.nblk_max ? nsm : d.nblk_max;
  const int mx = c > cz ? c : cz;
  err = mx <= 16   ? launch_epi_pass<1>(a, nblk, st)
        : mx <= 32 ? launch_epi_pass<2>(a, nblk, st)
        : mx <= 64 ? launch_epi_pass<4>(a, nblk, st)
                   : launch_epi_pass<8>(a, nblk, st);
  if (err != cudaSuccess) return err;
  const int dw3 = tile::smem_bytes<true, true>(), dw2 = tile::smem_bytes<false, true>();
  if ((err = tile::configure((const void*)tri_epi_dw_kernel<true>, dw3)) != cudaSuccess ||
      (err = tile::configure((const void*)tri_epi_dw_kernel<false>, dw2)) != cudaSuccess)
    return err;
  // dW_o (c, cz) = n^T du (3 products); dW_g (cz, cz) = x_g^T dzg (2)
  const unsigned zt = (cz + tile::BN - 1) / tile::BN;
  tri_epi_dw_kernel<true><<<dim3(zt, (c + tile::BM - 1) / tile::BM, d.nsplit), tile::THREADS,
                            dw3, st>>>(a.n_hi, a.n_lo, a.du_hi, a.du_lo, dwo_part, P, c, cz,
                                       d.steps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tri_epi_dw_kernel<false><<<dim3(zt, (cz + tile::BM - 1) / tile::BM, d.nsplit), tile::THREADS,
                             dw2, st>>>(xg, nullptr, a.dz_hi, a.dz_lo, dwg_part, P, cz, cz,
                                        d.steps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int Eo = c * cz, Eg = cz * cz, Ev = 2 * c + 2 * cz;
  tri_epi_sums_kernel<<<(Eo + Eg + Ev + 255) / 256, 256, 0, st>>>(
      dwo_part, dwg_part, a.vec_part, dw_o, dw_g, vec, d.nsplit, nblk, Eo, Eg, Ev);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

long long epi_blocks(long long P) { return (P + EP - 1) / EP; }

// scratch floats: n (P c), du (P cz), dzg (P cz), vector partials, then the
// larger of the two outer-product partials
long long epi_scratch(long long P, int cz, int c) {
  const long long o1 = outer_scratch(P, c, cz), o2 = outer_scratch(P, cz, cz);
  return P * c + 2 * P * cz + epi_blocks(P) * (2 * c + 2 * cz) + (o1 > o2 ? o1 : o2);
}

template <typename T>
cudaError_t run_epilogue(const float* s, const T* xg, const T* dy, const T* ln_s,
                         const T* ln_b, const T* w_o, const T* b_o, const T* w_g,
                         const T* b_g, const T* w_o_t, const T* w_g_t, float* ds, T* dxg,
                         float* vec, float* dw_o, float* dw_g, float* scratch, long long P,
                         int cz, int c, cudaStream_t st) {
  float* n_buf = scratch;
  float* du = n_buf + P * c;
  float* dzg = du + P * cz;
  float* pvec = dzg + P * cz;
  const long long nblk = epi_blocks(P);
  float* outer = pvec + nblk * (2 * c + 2 * cz);
  const size_t smem = sizeof(float) * ((size_t)EP * (2 * c + 4 * cz) + 2 * c + EP);
  cudaError_t err = cudaFuncSetAttribute(tri_epi_bwd_rows_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tri_epi_bwd_rows_kernel<T><<<(unsigned)nblk, THREADS, smem, st>>>(
      s, xg, dy, ln_s, ln_b, w_o, b_o, w_g, b_g, w_o_t, w_g_t, ds, dxg, n_buf, du, dzg, pvec, P,
      cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  col_sum_kernel<<<(unsigned)(2 * c + 2 * cz), 256, 0, st>>>(pvec, vec, (int)nblk, 2 * c + 2 * cz);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = outer_sum<float>(n_buf, P, 0, c, du, outer, dw_o, P, c, cz, st)) != cudaSuccess)
    return err;
  return outer_sum<T>(xg, P, 0, cz, dzg, outer, dw_g, P, cz, cz, st);
}

long long dx_blocks(long long P) { return (P + EP - 1) / EP; }

// scratch floats: str (rq rk c), d_loc (rp rk c), dh (P 2c), vector
// partials, outer-product partials
long long dx_scratch(int rp, int rq, int rk, int cz, int c) {
  const long long P = (long long)rp * rk;
  return (long long)rq * rk * c + P * c + P * 2 * c + dx_blocks(P) * 2 * c +
         outer_scratch(P, cz, 2 * c);
}

template <typename T>
cudaError_t run_dx(const float* ds, long long ds_sp, long long ds_sq, const T* xl,
                   long long xl_sp, long long xl_sk, const T* xs, long long xs_sq,
                   long long xs_sk, const T* w_loc, const T* b_loc, const T* w_str,
                   const T* b_str, const T* w_loc_t, T* dx, float* dw, float* db,
                   float* scratch, int rp, int rq, int rk, int cz, int c, cudaStream_t st) {
  const long long P = (long long)rp * rk;
  float* strv = scratch;
  float* dloc = strv + (long long)rq * rk * c;
  float* dh = dloc + P * c;
  float* pvec = dh + P * 2 * c;
  const long long nblk = dx_blocks(P);
  float* outer = pvec + nblk * 2 * c;

  const size_t proj_smem = sizeof(float) * (size_t)PROJ_ROWS * cz;
  cudaError_t err = cudaFuncSetAttribute(tri_proj_f32_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)proj_smem);
  if (err != cudaSuccess) return err;
  const long long rows_q = (long long)rq * rk;
  tri_proj_f32_kernel<T><<<(unsigned)((rows_q + PROJ_ROWS - 1) / PROJ_ROWS), THREADS, proj_smem,
                           st>>>(xs, xs_sq, xs_sk, w_str, b_str, strv, rq, rk, cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tri_dx_contract_kernel<<<dim3((unsigned)((rk + CT - 1) / CT), (unsigned)((rp + CT - 1) / CT)),
                           THREADS, 0, st>>>(ds, ds_sp, ds_sq, strv, dloc, rp, rq, rk, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t rows_smem = sizeof(float) * (size_t)EP * (cz + 2 * c);
  err = cudaFuncSetAttribute(tri_dx_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rows_smem);
  if (err != cudaSuccess) return err;
  tri_dx_rows_kernel<T><<<(unsigned)nblk, THREADS, rows_smem, st>>>(
      xl, xl_sp, xl_sk, w_loc, b_loc, w_loc_t, dloc, dh, dx, pvec, rp, rk, cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  col_sum_kernel<<<(unsigned)(2 * c), 256, 0, st>>>(pvec, db, (int)nblk, 2 * c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return outer_sum<T>(xl, rk, xl_sp, xl_sk, dh, outer, dw, P, cz, 2 * c, st);
}

cudaError_t run_dx_mma(const float* ds, i64 ds_sp, i64 ds_sq, const bf16* xl, i64 xl_sp,
                       i64 xl_sk, const bf16* xs, i64 xs_sq, i64 xs_sk, const bf16* w_loc,
                       const bf16* b_loc, const bf16* w_str, const bf16* b_str, bf16* dx,
                       float* dw, float* db, void* scratch, int rp, int rq, int rk, int cz,
                       int c, cudaStream_t st) {
  if (cz % 16 != 0 || c % 16 != 0) return cudaErrorInvalidValue;
  const DxPlan d = dx_plan(rp, rq, rk, cz, c);
  char* base = static_cast<char*>(scratch);
  bf16* ds_hi = reinterpret_cast<bf16*>(base + d.ds_hi);
  bf16* ds_lo = reinterpret_cast<bf16*>(base + d.ds_lo);
  bf16* st_hi = reinterpret_cast<bf16*>(base + d.st_hi);
  bf16* st_lo = reinterpret_cast<bf16*>(base + d.st_lo);
  float* h = reinterpret_cast<float*>(base + d.h);
  bf16* dh_hi = reinterpret_cast<bf16*>(base + d.dh_hi);
  bf16* dh_lo = reinterpret_cast<bf16*>(base + d.dh_lo);
  float* db_part = reinterpret_cast<float*>(base + d.db_part);
  float* dw_part = reinterpret_cast<float*>(base + d.dw_part);
  const int proj_smem = tile::proj_smem(cz, c), contract_smem = tile::smem_bytes<true, true>(),
            out_smem = tile::smem_bytes<false, true>(), dw_smem = tile::smem_bytes<true, false>();
  cudaError_t err;
  if ((err = tile::configure((const void*)tri_dx_proj_kernel, proj_smem)) != cudaSuccess ||
      (err = tile::configure((const void*)tri_dx_contract_mma_kernel, contract_smem)) !=
          cudaSuccess ||
      (err = tile::configure((const void*)tri_dx_out_kernel, out_smem)) != cudaSuccess ||
      (err = tile::configure((const void*)tri_dx_dw_kernel, dw_smem)) != cudaSuccess)
    return err;
  int dev = 0, nsm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;

  tri_dx_split_kernel<<<dim3(d.Rq / 64, d.Rp, (c + 63) / 64), 256, 0, st>>>(
      ds, ds_sp, ds_sq, ds_hi, ds_lo, rp, rq, d.Rp, d.Rq, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const tile::ProjSide strm{xs, xs_sq, xs_sk, rq, d.Rq, w_str, b_str, nullptr,
                            tile::PROJ_SPLIT, st_hi, st_lo};
  const tile::ProjSide loc{xl, xl_sp, xl_sk, rp, d.Rp, w_loc, b_loc, nullptr,
                           tile::PROJ_PREACT, h, nullptr};
  tri_dx_proj_kernel<<<dim3(nsm, 2), tile::PROJ_THREADS, proj_smem, st>>>(strm, loc, rk, d.Rk,
                                                                         cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tri_dx_contract_mma_kernel<<<dim3(d.Rk / tile::BN, d.Rp / tile::BM, c), tile::THREADS,
                               contract_smem,
                               st>>>(
      ds_hi, ds_lo, st_hi, st_lo, h, dh_hi, dh_lo, db_part, rp, rk, d.Rp, d.Rq, d.Rk, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tri_dx_out_kernel<<<dim3((cz + tile::BM - 1) / tile::BM, (unsigned)(d.Pp / tile::BN)),
                      tile::THREADS, out_smem,
                      st>>>(
      w_loc, dh_hi, dh_lo, dx, rp, rk, d.Rk, d.Pp, cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tri_dx_dw_kernel<<<dim3((cz + tile::BN - 1) / tile::BN, (2 * c + tile::BM - 1) / tile::BM,
                          d.nsplit),
                     tile::THREADS, dw_smem,
                     st>>>(dh_hi, dh_lo, xl, xl_sp, xl_sk, dw_part, rp, rk, d.Rk, d.Pp, cz, c,
                           d.steps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int E = cz * 2 * c;
  tri_dx_sums_kernel<<<(E + 2 * c + 255) / 256, 256, 0, st>>>(dw_part, db_part, dw, db,
                                                               d.nsplit, d.ntiles, E, 2 * c);
  return cudaGetLastError();
}

}  // namespace

// Scratch floats the two entry points below need.  The caller sizes the
// scratch by kernels/cost.py::triangle_mult_bwd_{epilogue,dx}_scratch, and
// a launch refuses less.
static long long epilogue_need(long long P, int cz, int c, int dtype) {
  if (dtype == 1) return (epi_plan(P, cz, c).bytes + 3) / 4;
  return epi_scratch(P, cz, c);
}

static long long dx_need(int rp, int rq, int rk, int cz, int c, int dtype) {
  if (dtype == 1) return (dx_plan(rp, rq, rk, cz, c).bytes + 3) / 4;
  return dx_scratch(rp, rq, rk, cz, c);
}

// K4.  dtype codes: 0 = float32, 1 = bfloat16 (xg, dy, dxg and every
// parameter).  w_o_t = W_o^T (cz, c) and w_g_t = W_g^T contiguous copies
// for float32; bfloat16 reads W_o and W_g in place and ignores them (it
// takes c, cz multiples of 16, at most 128).  s and ds are (P, c) fp32; vec
// receives [dln_s (c) | dln_b (c) | db_o (cz) | db_g (cz)], dw_o (c, cz) and
// dw_g (cz, cz) fp32.  Every tensor contiguous.  `scratch` holds
// `scratch_bytes` bytes, at least 4 * epilogue_need(...).  Returns the
// first cudaError_t met (0 = success).
extern "C" int triangle_mult_bwd_epilogue(const void* s, const void* xg, const void* dy,
                                          const void* ln_s, const void* ln_b, const void* w_o,
                                          const void* b_o, const void* w_g, const void* b_g,
                                          const void* w_o_t, const void* w_g_t, void* ds,
                                          void* dxg, void* vec, void* dw_o, void* dw_g,
                                          void* scratch, long long scratch_bytes, long long P,
                                          int cz, int c, int dtype, void* stream) {
  if (P <= 0 || cz <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (scratch_bytes < 4 * epilogue_need(P, cz, c, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EPI_ARGS(T)                                                                             \
  static_cast<const float*>(s), static_cast<const T*>(xg), static_cast<const T*>(dy),          \
      static_cast<const T*>(ln_s), static_cast<const T*>(ln_b), static_cast<const T*>(w_o),    \
      static_cast<const T*>(b_o), static_cast<const T*>(w_g), static_cast<const T*>(b_g),      \
      static_cast<const T*>(w_o_t), static_cast<const T*>(w_g_t), static_cast<float*>(ds),     \
      static_cast<T*>(dxg), static_cast<float*>(vec), static_cast<float*>(dw_o),               \
      static_cast<float*>(dw_g), static_cast<float*>(scratch), P, cz, c, st
  if (dtype == 0) return (int)run_epilogue<float>(EPI_ARGS(float));
#undef EPI_ARGS
  if (dtype == 1)
    return (int)run_epilogue_mma(
        static_cast<const float*>(s), static_cast<const bf16*>(xg), static_cast<const bf16*>(dy),
        static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
        static_cast<const bf16*>(w_o), static_cast<const bf16*>(b_o),
        static_cast<const bf16*>(w_g), static_cast<const bf16*>(b_g), static_cast<float*>(ds),
        static_cast<bf16*>(dxg), static_cast<float*>(vec), static_cast<float*>(dw_o),
        static_cast<float*>(dw_g), scratch, P, cz, c, st);
  return (int)cudaErrorInvalidValue;
}

// K5.  ds (rp, rq, c) fp32 by strides (ds_sp, ds_sq; channels contiguous);
// x_loc (rp, rk, cz) and x_str (rq, rk, cz) by strides; w_loc, w_str
// (cz, 2c) packed [value | gate], w_loc_t = W_loc^T (2c, cz), all of
// `dtype`; dx (rp, rk, cz) contiguous of `dtype`; dw (cz, 2c) and db (2c)
// fp32.  `scratch` holds `scratch_bytes` bytes, at least
// 4 * dx_need(...).  Returns the first cudaError_t met (0 = success).
extern "C" int triangle_mult_bwd_dx(const void* ds, long long ds_sp, long long ds_sq,
                                    const void* x_loc, long long xl_sp, long long xl_sk,
                                    const void* x_str, long long xs_sq, long long xs_sk,
                                    const void* w_loc, const void* b_loc, const void* w_str,
                                    const void* b_str, const void* w_loc_t, void* dx, void* dw,
                                    void* db, void* scratch, long long scratch_bytes, int rp,
                                    int rq, int rk, int cz, int c, int dtype, void* stream) {
  if (rp <= 0 || rq <= 0 || rk <= 0 || cz % 4 != 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (scratch_bytes < 4 * dx_need(rp, rq, rk, cz, c, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DX_ARGS(T)                                                                              \
  static_cast<const float*>(ds), ds_sp, ds_sq, static_cast<const T*>(x_loc), xl_sp, xl_sk,     \
      static_cast<const T*>(x_str), xs_sq, xs_sk, static_cast<const T*>(w_loc),                \
      static_cast<const T*>(b_loc), static_cast<const T*>(w_str), static_cast<const T*>(b_str), \
      static_cast<const T*>(w_loc_t), static_cast<T*>(dx), static_cast<float*>(dw),            \
      static_cast<float*>(db), static_cast<float*>(scratch), rp, rq, rk, cz, c, st
  if (dtype == 0) return (int)run_dx<float>(DX_ARGS(float));
#undef DX_ARGS
  if (dtype == 1)
    return (int)run_dx_mma(static_cast<const float*>(ds), ds_sp, ds_sq,
                           static_cast<const bf16*>(x_loc), xl_sp, xl_sk,
                           static_cast<const bf16*>(x_str), xs_sq, xs_sk,
                           static_cast<const bf16*>(w_loc), static_cast<const bf16*>(b_loc),
                           static_cast<const bf16*>(w_str), static_cast<const bf16*>(b_str),
                           static_cast<bf16*>(dx), static_cast<float*>(dw),
                           static_cast<float*>(db), scratch, rp, rq, rk, cz, c, st);
  return (int)cudaErrorInvalidValue;
}
