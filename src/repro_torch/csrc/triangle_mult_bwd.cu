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
// K5 ~21 GFLOP on ~70 MB), so the operations bound them.  This first version
// runs on the fp32 CUDA cores (67 TFLOP/s), not the tensor cores.
//
// Design.  The Pallas kernels keep whole operand rows in VMEM and carry the
// parameter-gradient sums across their grid in constant-index output blocks,
// which relies on the TPU running its grid in sequence.  Here:
//  * Row kernels (tri_epi_bwd_rows_kernel, tri_dx_rows_kernel) take 32 pairs
//    per block with every channel in shared memory, do the per-pair work and
//    write the per-pair results the sums need (n, du, dzg; dh) to scratch.
//    The bias-like vector sums leave as one partial row per block.
//  * The matrix sums (dW_o, dW_g, dW_loc) are A^T B over all pairs:
//    outer_acc_kernel splits the pairs into ~128 ranges, each block sums its
//    range for a 64 x 64 output tile into a partial, and sum_chunks_kernel /
//    col_sum_kernel add the partials in a fixed order.  No atomics: two runs
//    give the same bits.  With 16x16 pair tiles and per-tile partials the
//    partials would take 32 MiB per sum; split ranges take ~8 MiB.
//  * K5's streamed projection is staged ONCE per call in fp32 device memory
//    (tri_proj_f32_kernel), not recomputed per tile as the Pallas kernel
//    does: per tile it would cost r_p / 8 times over.  The contraction
//    (tri_dx_contract_kernel) is then, per channel, a product of r x r
//    matrices: one block per 8 x 8 (p, k) tile, one thread per channel, so
//    every load is coalesced over the contiguous channel axis, for ds read
//    through its strides as well (no transpose copy for the second side).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// Scratch sizes in floats for the two entry points below.
extern "C" long long triangle_mult_bwd_epilogue_scratch(long long P, int cz, int c) {
  return epi_scratch(P, cz, c);
}

extern "C" long long triangle_mult_bwd_dx_scratch(int rp, int rq, int rk, int cz, int c) {
  return dx_scratch(rp, rq, rk, cz, c);
}

// K4.  dtype codes: 0 = float32, 1 = bfloat16 (xg, dy, dxg and every
// parameter, w_o_t = W_o^T (cz, c) and w_g_t = W_g^T contiguous copies).
// s and ds are (P, c) fp32; vec receives [dln_s (c) | dln_b (c) | db_o (cz) |
// db_g (cz)], dw_o (c, cz) and dw_g (cz, cz) fp32.  Every tensor contiguous.
// Returns the first cudaError_t met (0 = success).
extern "C" int triangle_mult_bwd_epilogue(const void* s, const void* xg, const void* dy,
                                          const void* ln_s, const void* ln_b, const void* w_o,
                                          const void* b_o, const void* w_g, const void* b_g,
                                          const void* w_o_t, const void* w_g_t, void* ds,
                                          void* dxg, void* vec, void* dw_o, void* dw_g,
                                          void* scratch, long long P, int cz, int c, int dtype,
                                          void* stream) {
  if (P <= 0 || cz <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define EPI_ARGS(T)                                                                             \
  static_cast<const float*>(s), static_cast<const T*>(xg), static_cast<const T*>(dy),          \
      static_cast<const T*>(ln_s), static_cast<const T*>(ln_b), static_cast<const T*>(w_o),    \
      static_cast<const T*>(b_o), static_cast<const T*>(w_g), static_cast<const T*>(b_g),      \
      static_cast<const T*>(w_o_t), static_cast<const T*>(w_g_t), static_cast<float*>(ds),     \
      static_cast<T*>(dxg), static_cast<float*>(vec), static_cast<float*>(dw_o),               \
      static_cast<float*>(dw_g), static_cast<float*>(scratch), P, cz, c, st
  if (dtype == 0) return (int)run_epilogue<float>(EPI_ARGS(float));
  if (dtype == 1) return (int)run_epilogue<__nv_bfloat16>(EPI_ARGS(__nv_bfloat16));
#undef EPI_ARGS
  return (int)cudaErrorInvalidValue;
}

// K5.  ds (rp, rq, c) fp32 by strides (ds_sp, ds_sq; channels contiguous);
// x_loc (rp, rk, cz) and x_str (rq, rk, cz) by strides; w_loc, w_str
// (cz, 2c) packed [value | gate], w_loc_t = W_loc^T (2c, cz), all of
// `dtype`; dx (rp, rk, cz) contiguous of `dtype`; dw (cz, 2c) and db (2c)
// fp32.  Returns the first cudaError_t met (0 = success).
extern "C" int triangle_mult_bwd_dx(const void* ds, long long ds_sp, long long ds_sq,
                                    const void* x_loc, long long xl_sp, long long xl_sk,
                                    const void* x_str, long long xs_sq, long long xs_sk,
                                    const void* w_loc, const void* b_loc, const void* w_str,
                                    const void* b_str, const void* w_loc_t, void* dx, void* dw,
                                    void* db, void* scratch, int rp, int rq, int rk, int cz,
                                    int c, int dtype, void* stream) {
  if (rp <= 0 || rq <= 0 || rk <= 0 || cz % 4 != 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DX_ARGS(T)                                                                              \
  static_cast<const float*>(ds), ds_sp, ds_sq, static_cast<const T*>(x_loc), xl_sp, xl_sk,     \
      static_cast<const T*>(x_str), xs_sq, xs_sk, static_cast<const T*>(w_loc),                \
      static_cast<const T*>(b_loc), static_cast<const T*>(w_str), static_cast<const T*>(b_str), \
      static_cast<const T*>(w_loc_t), static_cast<T*>(dx), static_cast<float*>(dw),            \
      static_cast<float*>(db), static_cast<float*>(scratch), rp, rq, rk, cz, c, st
  if (dtype == 0) return (int)run_dx<float>(DX_ARGS(float));
  if (dtype == 1) return (int)run_dx<__nv_bfloat16>(DX_ARGS(__nv_bfloat16));
#undef DX_ARGS
  return (int)cudaErrorInvalidValue;
}
