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
// gated projections are written ONCE per side into scratch in the input
// type (k_mask applied in fp32 before the rounding).
//  * bf16 inputs (serving and training): three tensor-core kernels built on
//    tile_mma.cuh (mma.sync m16n8k16, ldmatrix fragments, fp32 accumulation):
//    tri_fwd_proj_kernel, both sides' projections in one persistent launch
//    with W in shared memory and the gate as a register epilogue;
//    tri_fwd_contract_kernel, per channel a 128 i x 64 j tile of s = a.b^T
//    with k streamed through a 3-stage cp.async ring, s written fp32;
//    tri_fwd_out_kernel, per tile of 64 pairs the LayerNorm statistics of s
//    over c in fp32, LN(s) rounded to bf16 and x_g as the A operands of the
//    out-projection and gate products (W_o, W_g resident in shared memory),
//    y = sigmoid(g) * u in bf16, and s_out (r_i, r_j, c) when given; the
//    next tile's s and x_g are copied in while one computes.  a, b and s
//    are tile-major (tile::tm_index): a tile's channels are one block.
//    What bounds it now: the mma.sync rate of 32 x 32 warp tiles and the
//    projection's per-output epilogue, not the bytes.
//  * fp32 inputs: the exact path on the fp32 CUDA cores (tri_proj_kernel,
//    tri_contract_kernel: one block per 8x8 tile, one thread per channel),
//    s kept in shared memory.
// Ragged r_i / r_j are masked (rows past the edge are zeros and not
// written); k is looped exactly or zero-padded, so any r_k works.
// When `s_out` is not null (autograd needs the backward), the kernels also
// write the fp32 pre-LayerNorm s (r_i, r_j, c): the residual that K4
// (csrc/triangle_mult_bwd.cu) starts from.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_mma.cuh"

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
// bf16 inputs: tiled tensor-core GEMMs (tile_mma.cuh)
// ---------------------------------------------------------------------------
//
// Scratch, tile-major (tile::tm_index) over padded extents (Ri, Rj, Rk:
// r_i, r_j, r_k rounded up to 128): a (Ri, Rk, c) and b (Rj, Rk, c) bf16,
// zero in the pads; s (Ri, Rj, c) fp32.

using tile::bf16;
using tile::i64;

constexpr int OP = tile::PM;  // pairs per epilogue tile: one i, 64 j, one tile of s
constexpr int OUT_WARPS = 8;  // 4 x 16 pairs by 2 x 64 output channels

// The gated projections a (side 0, k_mask applied) and b (side 1).
__global__ void __launch_bounds__(tile::PROJ_THREADS)
tri_fwd_proj_kernel(tile::ProjSide s0, tile::ProjSide s1, int rk, int Rk, int cz, int c) {
  tile::proj_body(s0, s1, rk, Rk, cz, c);
}

// Per channel ch = blockIdx.z, one 128 i x 64 j tile of s = a . b^T
// (k-contraction, fp32 accumulation), written channel-major.
__global__ void __launch_bounds__(tile::THREADS)
tri_fwd_contract_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                        float* __restrict__ s, int Rj, int Rk, int c) {
  using tile::Acc;
  using tile::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int ch = blockIdx.z, i0 = blockIdx.y * tile::BM, j0 = blockIdx.x * tile::BN;
  Acc acc;
  auto load = [&](const tile::Stage& st, int ks) {
    const int k0 = ks * BK;
    tile::load_a(st.a_hi, [&](int r, int kc, bool& ok) {
      ok = true;
      return a + tile::tm_index(i0 + r, k0 + kc, ch, Rk, c);
    });
    tile::load_b_nk(st.b_hi, [&](int n, int kc, bool& ok) {
      ok = true;
      return b + tile::tm_index(j0 + n, k0 + kc, ch, Rk, c);
    });
  };
  tile::mainloop<false, false, false>(smem, Rk / BK, load, acc);
  const tile::Frag f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(
            s + tile::tm_index(i0 + f.row(mt, 2 * h), j0 + f.col(nt, 0), ch, Rj, c)) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// Epilogue over tiles of OP pairs (one i, 64 j), a persistent block per SM
// with W_o and W_g resident in shared memory.  Per tile: the fp32 s (to
// s_out when given), its LayerNorm statistics over c, LN(s) rounded to bf16
// as the A operand of the out-projection and x_g as that of the gate
// projection (mma.sync from shared memory), y = sigmoid(g) * u in bf16.  The
// next tile's s and x_g are copied in (cp.async) while this one computes.
// Dynamic shared memory: tri_out_smem(cz, c).
constexpr int SP = OP + 4;  // s tile row: 64 j of one channel

__global__ void __launch_bounds__(OUT_WARPS * 32)
tri_fwd_out_kernel(const float* __restrict__ s, const bf16* __restrict__ xg,
                   const bf16* __restrict__ ln_s, const bf16* __restrict__ ln_b,
                   const bf16* __restrict__ w_o, const bf16* __restrict__ b_o,
                   const bf16* __restrict__ w_g, const bf16* __restrict__ b_g,
                   bf16* __restrict__ out, float* __restrict__ s_out, int ri, int rj, int Rj,
                   int cz, int c) {
  constexpr int NT = OUT_WARPS * 32, PARTS = NT / OP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldc = c + 8, ldz = cz + 8;
  float* sbuf = reinterpret_cast<float*>(smem_raw);  // [2][c][SP]
  float* gam = sbuf + 2 * c * SP;
  float* bet = gam + c;
  float* bo = bet + c;
  float* bg = bo + cz;
  float* red = bg + cz;      // [PARTS][OP]
  float* mu = red + PARTS * OP;  // [OP]
  float* rstd = mu + OP;         // [OP]
  bf16* wo = reinterpret_cast<bf16*>(rstd + OP);  // [c][ldz]
  bf16* wg = wo + c * ldz;                        // [cz][ldz]
  bf16* ln = wg + cz * ldz;                       // [OP][ldc]
  bf16* xbuf = ln + OP * ldc;                     // [2][OP][ldz]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntj = (rj + OP - 1) / OP, tiles = ri * ntj;

  auto issue = [&](int tl, int buf) {  // cp.async of tile tl's s and x_g
    const int i = tl / ntj, j0 = (tl - i * ntj) * OP;
    const float* src = s + tile::tm_index(i, j0, 0, Rj, c);  // c x OP, contiguous
    float* sd = sbuf + buf * c * SP;
    for (int e = tid; e < c * (OP / 4); e += NT) {
      const int ch = e / (OP / 4), q = (e % (OP / 4)) * 4;
      tile::cp16(sd + ch * SP + q, src + ch * OP + q, true);
    }
    bf16* xd = xbuf + buf * OP * ldz;
    for (int e = tid; e < OP * (cz / 8); e += NT) {
      const int r = e / (cz / 8), col = (e % (cz / 8)) * 8;
      const bool ok = j0 + r < rj;
      tile::cp16(xd + r * ldz + col, ok ? xg + ((i64)i * rj + j0 + r) * cz + col : xg, ok);
    }
  };
  for (int e = tid; e < c * (cz / 8); e += NT) {
    const int r = e / (cz / 8), col = (e % (cz / 8)) * 8;
    tile::cp16(wo + r * ldz + col, w_o + (i64)r * cz + col, true);
  }
  for (int e = tid; e < cz * (cz / 8); e += NT) {
    const int r = e / (cz / 8), col = (e % (cz / 8)) * 8;
    tile::cp16(wg + r * ldz + col, w_g + (i64)r * cz + col, true);
  }
  if ((int)blockIdx.x < tiles) issue(blockIdx.x, 0);
  tile::cp_commit();
  for (int ch = tid; ch < c; ch += NT) {
    gam[ch] = to_f(ln_s[ch]);
    bet[ch] = to_f(ln_b[ch]);
  }
  for (int z = tid; z < cz; z += NT) {
    bo[z] = to_f(b_o[z]);
    bg[z] = to_f(b_g[z]);
  }
  const float inv_c = 1.f / (float)c;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
  const int pp = tid % OP, part = tid / OP, cpart = c / PARTS;  // LayerNorm layout
  int buf = 0;
  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x, buf ^= 1) {
    const int i = tl / ntj, j0 = (tl - i * ntj) * OP;
    if (tl + (int)gridDim.x < tiles) issue(tl + gridDim.x, buf ^ 1);
    tile::cp_commit();
    tile::cp_wait<1>();
    __syncthreads();  // this tile's s and x_g (and the weights) landed
    const float* st = sbuf + buf * c * SP;
    const bf16* xs = xbuf + buf * OP * ldz;
    if (s_out != nullptr)
      for (int e = tid; e < OP * c; e += NT) {
        const int jj = e / c, ch = e % c;
        if (j0 + jj < rj) s_out[((i64)i * rj + j0 + jj) * c + ch] = st[ch * SP + jj];
      }
    // LayerNorm statistics over channels: PARTS threads per pair, each a
    // c / PARTS slice, the slices added in a fixed order
    float sum = 0.f;
    for (int ch = part * cpart; ch < (part + 1) * cpart; ++ch) sum += st[ch * SP + pp];
    red[part * OP + pp] = sum;
    __syncthreads();
    if (part == 0) {
      float tot = 0.f;
      for (int q = 0; q < PARTS; ++q) tot += red[q * OP + pp];
      mu[pp] = tot * inv_c;
    }
    __syncthreads();
    const float m = mu[pp];
    float sq = 0.f;
    for (int ch = part * cpart; ch < (part + 1) * cpart; ++ch) {
      const float d = st[ch * SP + pp] - m;
      sq += d * d;
    }
    red[part * OP + pp] = sq;
    __syncthreads();
    if (part == 0) {
      float tot = 0.f;
      for (int q = 0; q < PARTS; ++q) tot += red[q * OP + pp];
      rstd[pp] = rsqrtf(tot * inv_c + LN_EPS);
    }
    __syncthreads();
    const float rs = rstd[pp];
    for (int ch = part * cpart; ch < (part + 1) * cpart; ++ch)
      ln[pp * ldc + ch] = __float2bfloat16((st[ch * SP + pp] - m) * rs * gam[ch] + bet[ch]);
    __syncthreads();
    if (wn * 64 < cz) {
      float u[8][4], gt[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[nt][e] = gt[nt][e] = 0.f;
      for (int kk = 0; kk < c; kk += 16) {
        uint32_t a[4];
        tile::frag_a(a, ln, ldc, wm * 16, kk);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (wn * 64 + np * 16 >= cz) break;
          uint32_t b[2][2];
          tile::frag_b2<true>(b, wo, ldz, wn * 64 + np * 16, kk);
          tile::mma16816(u[2 * np], a, b[0][0], b[0][1]);
          tile::mma16816(u[2 * np + 1], a, b[1][0], b[1][1]);
        }
      }
      for (int kk = 0; kk < cz; kk += 16) {
        uint32_t a[4];
        tile::frag_a(a, xs, ldz, wm * 16, kk);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (wn * 64 + np * 16 >= cz) break;
          uint32_t b[2][2];
          tile::frag_b2<true>(b, wg, ldz, wn * 64 + np * 16, kk);
          tile::mma16816(gt[2 * np], a, b[0][0], b[0][1]);
          tile::mma16816(gt[2 * np + 1], a, b[1][0], b[1][1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int z = wn * 64 + nt * 8 + 2 * t;
        if (z >= cz) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = j0 + wm * 16 + g + 8 * h;
          if (j < rj)
            *reinterpret_cast<uint32_t*>(out + ((i64)i * rj + j) * cz + z) = tile::pack_bf16(
                sigmoid_f(gt[nt][2 * h] + bg[z]) * (u[nt][2 * h] + bo[z]),
                sigmoid_f(gt[nt][2 * h + 1] + bg[z + 1]) * (u[nt][2 * h + 1] + bo[z + 1]));
        }
      }
    }
    __syncthreads();  // the next iteration copies into this tile's buffers
  }
  tile::cp_wait<0>();
}

size_t tri_out_smem(int cz, int c) {
  const int parts = OUT_WARPS * 32 / OP;
  return ((size_t)2 * c * SP + 2 * c + 2 * cz + (size_t)(parts + 2) * OP) * 4 +
         ((size_t)c * (cz + 8) + (size_t)cz * (cz + 8) + (size_t)OP * (c + 8) +
          (size_t)2 * OP * (cz + 8)) * 2;
}

struct FwdPlan {
  int Ri, Rj, Rk;
  i64 a, b, s, bytes;  // byte offsets into the scratch
};

FwdPlan fwd_plan(int ri, int rj, int rk, int c) {
  FwdPlan d;
  d.Ri = tile::round_up(ri, tile::PAD);
  d.Rj = tile::round_up(rj, tile::PAD);
  d.Rk = tile::round_up(rk, tile::PAD);
  i64 off = 0;
  auto take = [&](i64 bytes) {
    const i64 o = off;
    off += (bytes + 255) / 256 * 256;
    return o;
  };
  d.a = take((i64)2 * c * d.Ri * d.Rk);
  d.b = take((i64)2 * c * d.Rj * d.Rk);
  d.s = take((i64)4 * c * d.Ri * d.Rj);
  d.bytes = off;
  return d;
}

cudaError_t run_mma(const void* xa, long long xa_si, long long xa_sk, const void* xb,
                    long long xb_sj, long long xb_sk, const void* xg, const float* kmask,
                    const void* w_a, const void* b_a, const void* w_b, const void* b_b,
                    const void* ln_s, const void* ln_b, const void* w_o, const void* b_o,
                    const void* w_g, const void* b_g, void* scratch, void* out, float* s_out,
                    int ri, int rj, int rk, int cz, int c, cudaStream_t stream) {
  if (cz % 16 != 0 || c % 16 != 0) return cudaErrorInvalidValue;
  const FwdPlan d = fwd_plan(ri, rj, rk, c);
  char* base = static_cast<char*>(scratch);
  bf16* a_buf = reinterpret_cast<bf16*>(base + d.a);
  bf16* b_buf = reinterpret_cast<bf16*>(base + d.b);
  float* s_buf = reinterpret_cast<float*>(base + d.s);
  const int proj_smem = tile::proj_smem(cz, c), contract_smem = tile::smem_bytes<false, false>();
  const int out_smem = (int)tri_out_smem(cz, c);
  cudaError_t err;
  if ((err = tile::configure((const void*)tri_fwd_proj_kernel, proj_smem)) != cudaSuccess ||
      (err = tile::configure((const void*)tri_fwd_contract_kernel, contract_smem)) !=
          cudaSuccess ||
      (err = tile::configure((const void*)tri_fwd_out_kernel, out_smem)) != cudaSuccess)
    return err;
  int dev = 0, nsm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;

  const tile::ProjSide sa{static_cast<const bf16*>(xa), xa_si, xa_sk, ri, d.Ri,
                          static_cast<const bf16*>(w_a), static_cast<const bf16*>(b_a), kmask,
                          tile::PROJ_BF16, a_buf, nullptr};
  const tile::ProjSide sb{static_cast<const bf16*>(xb), xb_sj, xb_sk, rj, d.Rj,
                          static_cast<const bf16*>(w_b), static_cast<const bf16*>(b_b), nullptr,
                          tile::PROJ_BF16, b_buf, nullptr};
  tri_fwd_proj_kernel<<<dim3(nsm, 2), tile::PROJ_THREADS, proj_smem, stream>>>(sa, sb, rk,
                                                                              d.Rk, cz, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tri_fwd_contract_kernel<<<dim3(d.Rj / tile::BN, d.Ri / tile::BM, c), tile::THREADS,
                            contract_smem,
                            stream>>>(
      a_buf, b_buf, s_buf, d.Rj, d.Rk, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = ri * ((rj + OP - 1) / OP);
  tri_fwd_out_kernel<<<tiles < nsm ? tiles : nsm, OUT_WARPS * 32, out_smem, stream>>>(
      s_buf, static_cast<const bf16*>(xg), static_cast<const bf16*>(ln_s),
      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w_o),
      static_cast<const bf16*>(b_o), static_cast<const bf16*>(w_g),
      static_cast<const bf16*>(b_g), static_cast<bf16*>(out), s_out, ri, rj, d.Rj, cz, c);
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

// Scratch bytes of triangle_mult_fwd: a and b, (ri + rj) * rk * c floats
// (float32); channel-major padded a, b and s (bfloat16, see run_mma).  The
// caller sizes it by kernels/cost.py::triangle_mult_fwd_scratch, and the
// launch refuses less.
static long long scratch_need(int ri, int rj, int rk, int c, int dtype) {
  if (dtype == 1) return fwd_plan(ri, rj, rk, c).bytes;
  return (long long)(ri + rj) * rk * c * (long long)sizeof(float);
}

// dtype codes: 0 = float32, 1 = bfloat16 (every tensor argument but kmask,
// which is float32 or null).  `scratch` holds `scratch_bytes` bytes, at
// least scratch_need(...).  cz and c must be multiples of 4 (float32) or 16 (bfloat16; xa and
// xb then with 16-byte aligned rows).  `s_out` may be null; when given it
// receives the fp32 pre-LayerNorm contraction (ri, rj, c).  Returns the
// first cudaError_t met (0 = success).
extern "C" int triangle_mult_fwd(const void* xa, long long xa_si, long long xa_sk,
                                 const void* xb, long long xb_sj, long long xb_sk,
                                 const void* xg, const void* kmask, const void* w_a,
                                 const void* b_a, const void* w_b, const void* b_b,
                                 const void* ln_s, const void* ln_b, const void* w_o,
                                 const void* b_o, const void* w_g, const void* b_g,
                                 void* scratch, long long scratch_bytes, void* out, void* s_out,
                                 int ri, int rj, int rk, int cz, int c, int dtype, void* stream) {
  if (ri <= 0 || rj <= 0 || rk <= 0 || cz % 4 != 0 || c % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes < scratch_need(ri, rj, rk, c, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kmask);
  if (dtype == 0) {
    float* a_buf = static_cast<float*>(scratch);
    float* b_buf = a_buf + (long long)ri * rk * c;
    return (int)run<float>(xa, xa_si, xa_sk, xb, xb_sj, xb_sk, xg, km, w_a, b_a, w_b, b_b,
                           ln_s, ln_b, w_o, b_o, w_g, b_g, a_buf, b_buf, out,
                           static_cast<float*>(s_out), ri, rj, rk, cz, c, st);
  }
  if (dtype == 1)
    return (int)run_mma(xa, xa_si, xa_sk, xb, xb_sj, xb_sk, xg, km, w_a, b_a, w_b, b_b, ln_s,
                        ln_b, w_o, b_o, w_g, b_g, scratch, out, static_cast<float*>(s_out),
                        ri, rj, rk, cz, c, st);
  return (int)cudaErrorInvalidValue;
}
