// Evoformer gated-bias attention, backward (kernel K2 of the port).
//
// Replaces: src/repro/kernels/flash_attention.py::evo_attention_bwd (Pallas
// bodies `_evo_bwd_dq_kernel` and `_evo_bwd_dkv_kernel`), reached through the
// custom VJPs of kernels/ops.py::evo_attention and ::evo_attention_nobias.
//
// Computes, from the forward's inputs, its gated output `out` and the fp32
// log-sum-exp `lse` of every score row (written by K1), with q/k/v/gate/out/do
// laid out (L, S, H, C), the bias (H, S, S) shared by all L rows:
//     dgate  = do * out * (1 - sigmoid(gate)),  do_raw = do * sigmoid(gate)
//     delta  = sum_c do * out                    (rowsum(do_raw * o_raw))
//     p_ij   = exp(q_i.k_j * scale + bias[h,i,j] - lse_i)
//     ds_ij  = p_ij * (do_raw_i.v_j - delta_i)
//     dq_i   = scale * sum_j ds_ij k_j,  dk_j = scale * sum_i ds_ij q_i,
//     dv_j   = sum_i p_ij do_raw_i,      dbias[h,i,j] = sum_l ds_ij
// Sums are fp32.  For bf16 inputs the products run on the tensor cores
// with bf16 operands, as the Pallas kernels' dots do: do_raw is rounded to
// bf16 for dp, ds for dq and dk, and p and do_raw for dv (the Pallas dk/dv
// kernel keeps that last product in fp32; here it shares the tensor cores).
// dbias sums the fp32 ds.  fp32 inputs keep every product in fp32.
//
// What bounds it on the H100: 14*L*H*S^2*C operations (scores and dp are
// recomputed in both kernels) on ~8 (L,S,H,C) tensors plus the bias and
// dbias: at S 256, C 32 some 100 operations per byte, below the ~295 the
// tensor cores need per byte, so the bytes bound it.
//
// Design: three kernels and a reduction, as in the reference's two Pallas
// kernels plus the row-sum:
//  * evo_bwd_prep_kernel: delta and dgate, one thread per (l, i, h) row.
//  * evo_bwd_dq_kernel: one block per (head, 16-query tile, chunk of lead
//    rows); K/V stream through shared memory in 64-key tiles.  The Pallas
//    kernel sums dbias over L by revisiting one output block in grid order,
//    which relies on the TPU running its grid in sequence.  Here each block
//    loops over its chunk of lead rows and keeps its tile's dbias sum
//    (16 x S fp32) in shared memory, owned element by element by one thread,
//    and writes it as that chunk's partial; sum_chunks_kernel adds the
//    partials in a fixed order.  No atomics: two runs give the same bits.
//    dbias_chunks sizes the chunks to fill the 132 SMs.
//  * evo_bwd_dkv_kernel: one block per (lead row * head, 16-key tile);
//    Q/dO stream through shared memory in 64-query tiles (the bias tile too,
//    so its reads stay coalesced).
//  * bf16 inputs: the same two kernels on the tensor cores (mma.sync
//    m16n8k16, fp32 accumulation), 64 queries (dq) or 64 keys (dk/dv) per
//    block, one warp per 16 rows, the head dim zero-padded to 16 or 32 as
//    in K1.  Each operand is staged in shared memory in the layout whose
//    fragments are single 32-bit loads (K key- and channel-major, Q and
//    do_raw query- and channel-major).  The dq kernel keeps its 64 x S
//    dbias sum in shared memory, each element owned by the thread whose
//    accumulator fragment holds it.
//  * fp32 inputs: one thread per query (dq) or key (dk/dv) on the fp32 CUDA
//    cores, 16 rows per block.
// Any S: keys and queries past S get p = 0 and are not written.  Head dims
// 4, 8, 16 and 32 are compile-time constants.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TQ = 16;  // dq kernel: query rows per block
constexpr int TK = 64;  // dq kernel: keys per shared-memory tile
constexpr int UK = 16;  // dkv kernel: keys per block
constexpr int UQ = 64;  // dkv kernel: queries per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// delta[(l*H + h)*S + i] = sum_c do * out; dgate = do * out * (1 - sigmoid(gate))
template <typename T>
__global__ void __launch_bounds__(THREADS)
evo_bwd_prep_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                    const T* __restrict__ gate, float* __restrict__ delta,
                    T* __restrict__ dgate, long long rows, int S, int H, int C) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= rows) return;
  const long long l = r / ((long long)S * H);
  const int rem = (int)(r - l * S * H);
  const int i = rem / H;
  const int h = rem - i * H;
  const size_t base = (size_t)r * C;
  float d = 0.f;
  for (int c = 0; c < C; ++c) {
    const float g = to_f(dout[base + c]);
    const float o = to_f(out[base + c]);
    d = fmaf(g, o, d);
    if (gate != nullptr) dgate[base + c] = from_f<T>(g * o * (1.f - sigmoid_f(to_f(gate[base + c]))));
  }
  delta[((size_t)l * H + h) * S + i] = d;
}

// One block per (h, 16-query tile) x chunk of lead rows [l0, l1).
// Dynamic shared memory (floats): qs[TQ][C] + dos[TQ][C] + ks[TK][C+1] +
// vs[TK][C+1] + dss[TQ][TK+1] + rows[2*TQ] (+ dbacc[TQ][S] when biased).
template <typename T, typename BT, int C>
__global__ void __launch_bounds__(THREADS)
evo_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const BT* __restrict__ bias, const T* __restrict__ gate,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  float* __restrict__ dbias_part, int L, int S, int H, int rows_per_chunk,
                  float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [TQ][C]
  float* dos = qs + TQ * C;                // [TQ][C] do_raw
  float* ks = dos + TQ * C;                // [TK][C + 1]
  float* vs = ks + TK * (C + 1);           // [TK][C + 1]
  float* dss = vs + TK * (C + 1);          // [TQ][TK + 1]
  float* lse_s = dss + TQ * (TK + 1);      // [TQ]
  float* del_s = lse_s + TQ;               // [TQ]
  float* dbacc = del_s + TQ;               // [TQ][S]

  const int nqt = (S + TQ - 1) / TQ;
  const int h = blockIdx.x / nqt;
  const int q0 = (blockIdx.x - h * nqt) * TQ;
  const int chunk = blockIdx.y;
  const int l0 = chunk * rows_per_chunk;
  const int l1 = min(L, l0 + rows_per_chunk);
  const int tid = threadIdx.x;
  const size_t rs = (size_t)H * C;  // between consecutive positions
  const bool biased = bias != nullptr;
  const BT* bh = biased ? bias + (size_t)h * S * S : nullptr;

  if (biased)
    for (int e = tid; e < TQ * S; e += THREADS) dbacc[e] = 0.f;

  constexpr int NOUT = (TQ * C + THREADS - 1) / THREADS;
  const int jl = tid % TK;       // phase A: this thread's key in the tile
  const int ib = tid / TK;       // and its first query row (rows ib, ib+2, ...)

  for (int l = l0; l < l1; ++l) {
    const size_t base = (size_t)l * S * rs + (size_t)h * C;
    __syncthreads();  // the previous row's tiles are consumed
    for (int e = tid; e < TQ * C; e += THREADS) {
      const int i = e / C, c = e - i * C;
      const int row = q0 + i;
      float qv = 0.f, dv = 0.f;
      if (row < S) {
        const size_t off = base + (size_t)row * rs + c;
        qv = to_f(q[off]);
        dv = to_f(dout[off]);
        if (gate != nullptr) dv *= sigmoid_f(to_f(gate[off]));
      }
      qs[e] = qv;
      dos[e] = dv;
    }
    if (tid < TQ) {
      const int row = q0 + tid;
      const size_t r = ((size_t)l * H + h) * S + row;
      lse_s[tid] = row < S ? lse[r] : 0.f;
      del_s[tid] = row < S ? delta[r] : 0.f;
    }
    float acc[NOUT];
#pragma unroll
    for (int u = 0; u < NOUT; ++u) acc[u] = 0.f;

    for (int k0 = 0; k0 < S; k0 += TK) {
      __syncthreads();
      for (int e = tid; e < TK * C; e += THREADS) {
        const int kk = e / C, c = e - kk * C;
        const int j = k0 + kk;
        float kv = 0.f, vv = 0.f;
        if (j < S) {
          const size_t off = base + (size_t)j * rs + c;
          kv = to_f(k[off]);
          vv = to_f(v[off]);
        }
        ks[kk * (C + 1) + c] = kv;
        vs[kk * (C + 1) + c] = vv;
      }
      __syncthreads();
      // phase A: ds for (row, key) pairs; this thread's key is fixed
      {
        float kr[C], vr[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          kr[c] = ks[jl * (C + 1) + c];
          vr[c] = vs[jl * (C + 1) + c];
        }
        const int j = k0 + jl;
#pragma unroll 2
        for (int i = ib; i < TQ; i += THREADS / TK) {
          const int row = q0 + i;
          float sdot = 0.f, dp = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            sdot = fmaf(qs[i * C + c], kr[c], sdot);
            dp = fmaf(dos[i * C + c], vr[c], dp);
          }
          float ds = 0.f;
          if (row < S && j < S) {
            float x = sdot * scale;
            if (biased) x += to_f(bh[(size_t)row * S + j]);
            const float p = expf(x - lse_s[i]);
            ds = p * (dp - del_s[i]);
            if (biased) dbacc[i * S + j] += ds;
          }
          dss[i * (TK + 1) + jl] = ds;
        }
      }
      __syncthreads();
      // phase B: dq[i][c] += sum_j ds[i][j] k[j][c]
#pragma unroll
      for (int u = 0; u < NOUT; ++u) {
        const int o = tid + u * THREADS;
        if (o < TQ * C) {
          const int i = o / C, c = o - i * C;
          float a = acc[u];
#pragma unroll 8
          for (int kk = 0; kk < TK; ++kk) a = fmaf(dss[i * (TK + 1) + kk], ks[kk * (C + 1) + c], a);
          acc[u] = a;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NOUT; ++u) {
      const int o = tid + u * THREADS;
      if (o < TQ * C) {
        const int i = o / C, c = o - i * C;
        const int row = q0 + i;
        if (row < S) dq[base + (size_t)row * rs + c] = from_f<T>(acc[u] * scale);
      }
    }
  }

  if (biased) {
    __syncthreads();
    float* part = dbias_part + (size_t)chunk * H * S * S + (size_t)h * S * S;
    for (int e = tid; e < TQ * S; e += THREADS) {
      const int i = e / S, j = e - i * S;
      const int row = q0 + i;
      if (row < S) part[(size_t)row * S + j] = dbacc[e];
    }
  }
}

// One block per (l*H + h, 16-key tile).  Dynamic shared memory (floats):
// ks[UK][C] + vs[UK][C] + qs[UQ][C+1] + dos[UQ][C+1] + bs[UQ][UK+1] +
// ps[UQ][UK+1] + dss[UQ][UK+1] + rows[2*UQ].
template <typename T, typename BT, int C>
__global__ void __launch_bounds__(THREADS)
evo_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const BT* __restrict__ bias, const T* __restrict__ gate,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int S, int H, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                        // [UK][C]
  float* vs = ks + UK * C;                 // [UK][C]
  float* qs = vs + UK * C;                 // [UQ][C + 1]
  float* dos = qs + UQ * (C + 1);          // [UQ][C + 1] do_raw
  float* bs = dos + UQ * (C + 1);          // [UQ][UK + 1]
  float* ps = bs + UQ * (UK + 1);          // [UQ][UK + 1]
  float* dss = ps + UQ * (UK + 1);         // [UQ][UK + 1]
  float* lse_s = dss + UQ * (UK + 1);      // [UQ]
  float* del_s = lse_s + UQ;               // [UQ]

  const int lh = blockIdx.x;
  const int l = lh / H;
  const int h = lh - l * H;
  const int k0 = blockIdx.y * UK;
  const int tid = threadIdx.x;
  const size_t rs = (size_t)H * C;
  const size_t base = (size_t)l * S * rs + (size_t)h * C;
  const bool biased = bias != nullptr;
  const BT* bh = biased ? bias + (size_t)h * S * S : nullptr;

  for (int e = tid; e < UK * C; e += THREADS) {
    const int kk = e / C, c = e - kk * C;
    const int j = k0 + kk;
    float kv = 0.f, vv = 0.f;
    if (j < S) {
      const size_t off = base + (size_t)j * rs + c;
      kv = to_f(k[off]);
      vv = to_f(v[off]);
    }
    ks[e] = kv;
    vs[e] = vv;
  }

  constexpr int NOUT = (UK * C + THREADS - 1) / THREADS;
  float acck[NOUT], accv[NOUT];
#pragma unroll
  for (int u = 0; u < NOUT; ++u) acck[u] = accv[u] = 0.f;
  const int il = tid % UQ;   // phase A: this thread's query in the tile
  const int jb = tid / UQ;   // and its first key (keys jb, jb+2, ...)

  for (int q0 = 0; q0 < S; q0 += UQ) {
    __syncthreads();
    for (int e = tid; e < UQ * C; e += THREADS) {
      const int i = e / C, c = e - i * C;
      const int row = q0 + i;
      float qv = 0.f, dv_ = 0.f;
      if (row < S) {
        const size_t off = base + (size_t)row * rs + c;
        qv = to_f(q[off]);
        dv_ = to_f(dout[off]);
        if (gate != nullptr) dv_ *= sigmoid_f(to_f(gate[off]));
      }
      qs[i * (C + 1) + c] = qv;
      dos[i * (C + 1) + c] = dv_;
    }
    if (biased)
      for (int e = tid; e < UQ * UK; e += THREADS) {
        const int i = e / UK, jj = e - i * UK;
        const int row = q0 + i, j = k0 + jj;
        bs[i * (UK + 1) + jj] = (row < S && j < S) ? to_f(bh[(size_t)row * S + j]) : 0.f;
      }
    if (tid < UQ) {
      const int row = q0 + tid;
      const size_t r = (size_t)lh * S + row;
      lse_s[tid] = row < S ? lse[r] : 0.f;
      del_s[tid] = row < S ? delta[r] : 0.f;
    }
    __syncthreads();
    // phase A: p and ds for (query, key) pairs; this thread's query is fixed
    {
      float qr[C], dr[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        qr[c] = qs[il * (C + 1) + c];
        dr[c] = dos[il * (C + 1) + c];
      }
      const int row = q0 + il;
#pragma unroll 2
      for (int jj = jb; jj < UK; jj += THREADS / UQ) {
        const int j = k0 + jj;
        float sdot = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          sdot = fmaf(qr[c], ks[jj * C + c], sdot);
          dp = fmaf(dr[c], vs[jj * C + c], dp);
        }
        float p = 0.f, ds = 0.f;
        if (row < S && j < S) {
          float x = sdot * scale;
          if (biased) x += bs[il * (UK + 1) + jj];
          p = expf(x - lse_s[il]);
          ds = p * (dp - del_s[il]);
        }
        ps[il * (UK + 1) + jj] = p;
        dss[il * (UK + 1) + jj] = ds;
      }
    }
    __syncthreads();
    // phase B: dk[j][c] += sum_i ds[i][j] q[i][c]; dv[j][c] += sum_i p[i][j] do_raw[i][c]
#pragma unroll
    for (int u = 0; u < NOUT; ++u) {
      const int o = tid + u * THREADS;
      if (o < UK * C) {
        const int jj = o / C, c = o - jj * C;
        float ak = acck[u], av = accv[u];
#pragma unroll 8
        for (int i = 0; i < UQ; ++i) {
          ak = fmaf(dss[i * (UK + 1) + jj], qs[i * (C + 1) + c], ak);
          av = fmaf(ps[i * (UK + 1) + jj], dos[i * (C + 1) + c], av);
        }
        acck[u] = ak;
        accv[u] = av;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < NOUT; ++u) {
    const int o = tid + u * THREADS;
    if (o < UK * C) {
      const int jj = o / C, c = o - jj * C;
      const int j = k0 + jj;
      if (j < S) {
        const size_t off = base + (size_t)j * rs + c;
        dk[off] = from_f<T>(acck[u] * scale);
        dv[off] = from_f<T>(accv[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MQ = 64;  // dq kernel: queries per block; dkv kernel: queries per tile
constexpr int MK = 64;  // dq kernel: keys per tile; dkv kernel: keys per block

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
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

// do_raw = do * sigmoid(gate) for channels (c, c+1) of one row, as a bf16
// pair; zero outside (S, C)
__device__ __forceinline__ uint32_t do_raw_pair(const bf16* dout, const bf16* gate,
                                                size_t off, bool ok) {
  if (!ok) return 0u;
  const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(dout + off);
  float d0 = __bfloat162float(d2.x), d1 = __bfloat162float(d2.y);
  if (gate != nullptr) {
    const __nv_bfloat162 g2 = *reinterpret_cast<const __nv_bfloat162*>(gate + off);
    d0 *= sigmoid_f(__bfloat162float(g2.x));
    d1 *= sigmoid_f(__bfloat162float(g2.y));
  }
  return pack_bf16(d0, d1);
}

// One block of 4 warps per (h, 64-query tile) x chunk of lead rows; a warp
// owns 16 queries.  Dynamic shared memory: ks[MK][CP+8] + kt[CP][MK+8] +
// vs[MK][CP+8] bf16, then dbacc[MQ][S] fp32 when biased.
template <typename BT, int CP>
__global__ void __launch_bounds__(128)
evo_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const BT* __restrict__ bias,
                      const bf16* __restrict__ gate, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, float* __restrict__ dbias_part, int L, int S,
                      int H, int C, int rows_per_chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [MK][CP + 8]  key-major
  bf16* kt = ks + MK * (CP + 8);                  // [CP][MK + 8]  channel-major
  bf16* vs = kt + CP * (MK + 8);                  // [MK][CP + 8]  key-major
  float* dbacc = reinterpret_cast<float*>(vs + MK * (CP + 8));  // [MQ][S]

  const int nqt = (S + MQ - 1) / MQ;
  const int h = blockIdx.x / nqt;
  const int q0 = (blockIdx.x - h * nqt) * MQ;
  const int chunk = blockIdx.y;
  const int l0 = chunk * rows_per_chunk;
  const int l1 = min(L, l0 + rows_per_chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;     // local rows of this thread
  const int r0 = q0 + lr0, r1 = q0 + lr1;
  const size_t rs = (size_t)H * C;
  const bool biased = bias != nullptr;
  const BT* bh = biased ? bias + (size_t)h * S * S : nullptr;
  if (biased)
    for (int e = tid; e < MQ * S; e += 128) dbacc[e] = 0.f;

  for (int l = l0; l < l1; ++l) {
    const size_t base = (size_t)l * S * rs + (size_t)h * C;
    uint32_t qa[CP / 16][4], da[CP / 16][4];
#pragma unroll
    for (int kc = 0; kc < CP / 16; ++kc) {
      const int c0 = kc * 16 + 2 * t, c8 = c0 + 8;
      const bool a0 = r0 < S && c0 < C, a1 = r1 < S && c0 < C;
      const bool a2 = r0 < S && c8 < C, a3 = r1 < S && c8 < C;
      qa[kc][0] = a0 ? ld32(q + base + (size_t)r0 * rs + c0) : 0u;
      qa[kc][1] = a1 ? ld32(q + base + (size_t)r1 * rs + c0) : 0u;
      qa[kc][2] = a2 ? ld32(q + base + (size_t)r0 * rs + c8) : 0u;
      qa[kc][3] = a3 ? ld32(q + base + (size_t)r1 * rs + c8) : 0u;
      da[kc][0] = do_raw_pair(dout, gate, base + (size_t)r0 * rs + c0, a0);
      da[kc][1] = do_raw_pair(dout, gate, base + (size_t)r1 * rs + c0, a1);
      da[kc][2] = do_raw_pair(dout, gate, base + (size_t)r0 * rs + c8, a2);
      da[kc][3] = do_raw_pair(dout, gate, base + (size_t)r1 * rs + c8, a3);
    }
    const size_t lrow = ((size_t)l * H + h) * S;
    const float lse0 = r0 < S ? lse[lrow + r0] : 0.f, lse1 = r1 < S ? lse[lrow + r1] : 0.f;
    const float del0 = r0 < S ? delta[lrow + r0] : 0.f, del1 = r1 < S ? delta[lrow + r1] : 0.f;
    float dqa[CP / 8][4];
#pragma unroll
    for (int ct = 0; ct < CP / 8; ++ct) dqa[ct][0] = dqa[ct][1] = dqa[ct][2] = dqa[ct][3] = 0.f;

    for (int k0 = 0; k0 < S; k0 += MK) {
      __syncthreads();  // the previous tile is consumed
      for (int e = tid; e < MK * CP / 2; e += 128) {
        const int key = e / (CP / 2);
        const int c = (e - key * (CP / 2)) * 2;
        const int j = k0 + key;
        uint32_t kv = 0u, vv = 0u;
        if (j < S && c < C) {
          const size_t off = base + (size_t)j * rs + c;
          kv = ld32(k + off);
          vv = ld32(v + off);
        }
        *reinterpret_cast<uint32_t*>(&ks[key * (CP + 8) + c]) = kv;
        *reinterpret_cast<uint32_t*>(&vs[key * (CP + 8) + c]) = vv;
        const __nv_bfloat162 k2 = *reinterpret_cast<const __nv_bfloat162*>(&kv);
        kt[c * (MK + 8) + key] = k2.x;
        kt[(c + 1) * (MK + 8) + key] = k2.y;
      }
      __syncthreads();
      // scores S = Q.K^T and dP = do_raw.V^T, 16 rows x MK keys per warp
      float sc[MK / 8][4], dp[MK / 8][4];
#pragma unroll
      for (int nt = 0; nt < MK / 8; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
        const bf16* kr = &ks[(nt * 8 + g) * (CP + 8) + 2 * t];
        const bf16* vr = &vs[(nt * 8 + g) * (CP + 8) + 2 * t];
#pragma unroll
        for (int kc = 0; kc < CP / 16; ++kc) {
          mma16816(sc[nt], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
          mma16816(dp[nt], da[kc], ld32(vr + kc * 16), ld32(vr + kc * 16 + 8));
        }
      }
      // ds = p * (dp - delta), p = exp(s * scale + bias - lse); dbias sum
#pragma unroll
      for (int nt = 0; nt < MK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const int row = hi ? r1 : r0;
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          float ds = 0.f;
          if (row < S && col < S) {
            float x = sc[nt][e] * scale;
            if (biased) x += to_f(bh[(size_t)row * S + col]);
            const float p = expf(x - (hi ? lse1 : lse0));
            ds = p * (dp[nt][e] - (hi ? del1 : del0));
            if (biased) dbacc[(hi ? lr1 : lr0) * S + col] += ds;
          }
          sc[nt][e] = ds;
        }
      }
      // dQ += dS.K: the ds fragments are the A operand, K channel-major is B
#pragma unroll
      for (int kc = 0; kc < MK / 16; ++kc) {
        const uint32_t a[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                               pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                               pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                               pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
        for (int ct = 0; ct < CP / 8; ++ct) {
          const bf16* kr = &kt[(ct * 8 + g) * (MK + 8) + kc * 16 + 2 * t];
          mma16816(dqa[ct], a, ld32(kr), ld32(kr + 8));
        }
      }
    }
#pragma unroll
    for (int ct = 0; ct < CP / 8; ++ct) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r == 0 ? r0 : r1;
        const int c = ct * 8 + 2 * t;
        if (row < S && c < C)
          *reinterpret_cast<uint32_t*>(dq + base + (size_t)row * rs + c) =
              pack_bf16(dqa[ct][2 * r] * scale, dqa[ct][2 * r + 1] * scale);
      }
    }
  }

  if (biased) {
    __syncthreads();
    float* part = dbias_part + (size_t)chunk * H * S * S + (size_t)h * S * S;
    for (int e = tid; e < MQ * S; e += 128) {
      const int i = e / S, j = e - i * S;
      const int row = q0 + i;
      if (row < S) part[(size_t)row * S + j] = dbacc[e];
    }
  }
}

// One block of 4 warps per (l*H + h, 64-key tile); a warp owns 16 keys and
// streams 64-query tiles.  Dynamic shared memory: qs[MQ][CP+8] +
// qt[CP][MQ+8] + ds_[MQ][CP+8] + dt[CP][MQ+8] bf16, then bsm[MQ][MK+1] +
// lse_s[MQ] + del_s[MQ] fp32.
template <typename BT, int CP>
__global__ void __launch_bounds__(128)
evo_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const BT* __restrict__ bias,
                       const bf16* __restrict__ gate, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int C,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [MQ][CP + 8]  query-major
  bf16* qt = qs + MQ * (CP + 8);                  // [CP][MQ + 8]  channel-major
  bf16* dos = qt + CP * (MQ + 8);                 // [MQ][CP + 8]  do_raw, query-major
  bf16* dot = dos + MQ * (CP + 8);                // [CP][MQ + 8]  do_raw, channel-major
  float* bsm = reinterpret_cast<float*>(dot + CP * (MQ + 8));  // [MQ][MK + 1]
  float* lse_s = bsm + MQ * (MK + 1);
  float* del_s = lse_s + MQ;

  const int lh = blockIdx.x;
  const int l = lh / H;
  const int h = lh - l * H;
  const int k0 = blockIdx.y * MK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lk0 = warp * 16 + g, lk1 = lk0 + 8;     // local keys of this thread
  const int j0 = k0 + lk0, j1 = k0 + lk1;
  const size_t rs = (size_t)H * C;
  const size_t base = (size_t)l * S * rs + (size_t)h * C;
  const bool biased = bias != nullptr;
  const BT* bh = biased ? bias + (size_t)h * S * S : nullptr;

  uint32_t ka[CP / 16][4], va[CP / 16][4];
#pragma unroll
  for (int kc = 0; kc < CP / 16; ++kc) {
    const int c0 = kc * 16 + 2 * t, c8 = c0 + 8;
    const bool a0 = j0 < S && c0 < C, a1 = j1 < S && c0 < C;
    const bool a2 = j0 < S && c8 < C, a3 = j1 < S && c8 < C;
    ka[kc][0] = a0 ? ld32(k + base + (size_t)j0 * rs + c0) : 0u;
    ka[kc][1] = a1 ? ld32(k + base + (size_t)j1 * rs + c0) : 0u;
    ka[kc][2] = a2 ? ld32(k + base + (size_t)j0 * rs + c8) : 0u;
    ka[kc][3] = a3 ? ld32(k + base + (size_t)j1 * rs + c8) : 0u;
    va[kc][0] = a0 ? ld32(v + base + (size_t)j0 * rs + c0) : 0u;
    va[kc][1] = a1 ? ld32(v + base + (size_t)j1 * rs + c0) : 0u;
    va[kc][2] = a2 ? ld32(v + base + (size_t)j0 * rs + c8) : 0u;
    va[kc][3] = a3 ? ld32(v + base + (size_t)j1 * rs + c8) : 0u;
  }
  float dka[CP / 8][4], dva[CP / 8][4];
#pragma unroll
  for (int ct = 0; ct < CP / 8; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[ct][e] = dva[ct][e] = 0.f;

  for (int q0 = 0; q0 < S; q0 += MQ) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < MQ * CP / 2; e += 128) {
      const int qi = e / (CP / 2);
      const int c = (e - qi * (CP / 2)) * 2;
      const int row = q0 + qi;
      const bool ok = row < S && c < C;
      const size_t off = base + (size_t)row * rs + c;
      const uint32_t qv = ok ? ld32(q + off) : 0u;
      const uint32_t dv2 = do_raw_pair(dout, gate, off, ok);
      *reinterpret_cast<uint32_t*>(&qs[qi * (CP + 8) + c]) = qv;
      *reinterpret_cast<uint32_t*>(&dos[qi * (CP + 8) + c]) = dv2;
      const __nv_bfloat162 q2 = *reinterpret_cast<const __nv_bfloat162*>(&qv);
      const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dv2);
      qt[c * (MQ + 8) + qi] = q2.x;
      qt[(c + 1) * (MQ + 8) + qi] = q2.y;
      dot[c * (MQ + 8) + qi] = d2.x;
      dot[(c + 1) * (MQ + 8) + qi] = d2.y;
    }
    if (biased)
      for (int e = tid; e < MQ * MK; e += 128) {
        const int qi = e / MK, kk = e - qi * MK;
        const int row = q0 + qi, j = k0 + kk;
        bsm[qi * (MK + 1) + kk] = (row < S && j < S) ? to_f(bh[(size_t)row * S + j]) : 0.f;
      }
    if (tid < MQ) {
      const int row = q0 + tid;
      const size_t r = (size_t)lh * S + row;
      lse_s[tid] = row < S ? lse[r] : 0.f;
      del_s[tid] = row < S ? delta[r] : 0.f;
    }
    __syncthreads();
    // S^T = K.Q^T and dP^T = V.do_raw^T, 16 keys x MQ queries per warp
    float st[MQ / 8][4], dpt[MQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < MQ / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      const bf16* qr = &qs[(nt * 8 + g) * (CP + 8) + 2 * t];
      const bf16* dr = &dos[(nt * 8 + g) * (CP + 8) + 2 * t];
#pragma unroll
      for (int kc = 0; kc < CP / 16; ++kc) {
        mma16816(st[nt], ka[kc], ld32(qr + kc * 16), ld32(qr + kc * 16 + 8));
        mma16816(dpt[nt], va[kc], ld32(dr + kc * 16), ld32(dr + kc * 16 + 8));
      }
    }
    // p^T and ds^T
#pragma unroll
    for (int nt = 0; nt < MQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const int key = hi ? j1 : j0;
        const int qi = nt * 8 + 2 * t + (e & 1);
        float p = 0.f, ds = 0.f;
        if (key < S && q0 + qi < S) {
          float x = st[nt][e] * scale;
          if (biased) x += bsm[qi * (MK + 1) + (hi ? lk1 : lk0)];
          p = expf(x - lse_s[qi]);
          ds = p * (dpt[nt][e] - del_s[qi]);
        }
        st[nt][e] = p;
        dpt[nt][e] = ds;
      }
    }
    // dV += P^T.do_raw and dK += dS^T.Q, the queries as the k dimension
#pragma unroll
    for (int kc = 0; kc < MQ / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kc][0], st[2 * kc][1]),
                              pack_bf16(st[2 * kc][2], st[2 * kc][3]),
                              pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]),
                              pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]),
                              pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]),
                              pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
                              pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
      for (int ct = 0; ct < CP / 8; ++ct) {
        const bf16* dr = &dot[(ct * 8 + g) * (MQ + 8) + kc * 16 + 2 * t];
        const bf16* qr = &qt[(ct * 8 + g) * (MQ + 8) + kc * 16 + 2 * t];
        mma16816(dva[ct], pa, ld32(dr), ld32(dr + 8));
        mma16816(dka[ct], sa, ld32(qr), ld32(qr + 8));
      }
    }
  }
#pragma unroll
  for (int ct = 0; ct < CP / 8; ++ct) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r == 0 ? j0 : j1;
      const int c = ct * 8 + 2 * t;
      if (key < S && c < C) {
        const size_t off = base + (size_t)key * rs + c;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(dka[ct][2 * r] * scale, dka[ct][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(dva[ct][2 * r], dva[ct][2 * r + 1]);
      }
    }
  }
}

// out[e] = sum_{s < n} part[s * E + e], in order.
__global__ void __launch_bounds__(256)
sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ out, int n, long long E) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += part[(size_t)i * E + e];
  out[e] = s;
}

template <typename T, typename BT, int C>
cudaError_t run(const void* q, const void* k, const void* v, const void* bias,
                const void* gate, const void* out, const void* dout, const float* lse,
                float* delta, void* dq, void* dk, void* dv, void* dgate, float* dbias,
                float* dbias_part, int L, int S, int H, int n_chunks, float scale,
                cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(gate);
  const T* do_ = static_cast<const T*>(dout);
  const BT* b_ = static_cast<const BT*>(bias);
  const long long rows = (long long)L * S * H;
  evo_bwd_prep_kernel<T><<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const T*>(out), do_, g_, delta, static_cast<T*>(dgate), rows, S, H, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int rows_per_chunk = (L + n_chunks - 1) / n_chunks;
  const size_t dq_smem = sizeof(float) * ((size_t)2 * TQ * C + 2 * TK * (C + 1) +
                                          TQ * (TK + 1) + 2 * TQ +
                                          (bias != nullptr ? (size_t)TQ * S : 0));
  err = cudaFuncSetAttribute(evo_bwd_dq_kernel<T, BT, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  const int nqt = (S + TQ - 1) / TQ;
  // with one chunk the partial is the result itself
  float* part = n_chunks == 1 ? dbias : dbias_part;
  evo_bwd_dq_kernel<T, BT, C><<<dim3((unsigned)(H * nqt), (unsigned)n_chunks), THREADS, dq_smem,
                                st>>>(q_, k_, v_, b_, g_, do_, lse, delta, static_cast<T*>(dq),
                                      part, L, S, H, rows_per_chunk, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (bias != nullptr && n_chunks > 1) {
    const long long E = (long long)H * S * S;
    sum_chunks_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(dbias_part, dbias, n_chunks, E);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const size_t dkv_smem = sizeof(float) * ((size_t)2 * UK * C + 2 * UQ * (C + 1) +
                                           3 * UQ * (UK + 1) + 2 * UQ);
  err = cudaFuncSetAttribute(evo_bwd_dkv_kernel<T, BT, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  evo_bwd_dkv_kernel<T, BT, C><<<dim3((unsigned)(L * H), (unsigned)((S + UK - 1) / UK)), THREADS,
                                 dkv_smem, st>>>(q_, k_, v_, b_, g_, do_, lse, delta,
                                                 static_cast<T*>(dk), static_cast<T*>(dv), S, H,
                                                 scale);
  return cudaGetLastError();
}

template <typename BT, int CP>
cudaError_t run_mma(const void* q, const void* k, const void* v, const void* bias,
                    const void* gate, const void* out, const void* dout, const float* lse,
                    float* delta, void* dq, void* dk, void* dv, void* dgate, float* dbias,
                    float* dbias_part, int L, int S, int H, int C, int n_chunks, float scale,
                    cudaStream_t st) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* g_ = static_cast<const bf16*>(gate);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const BT* b_ = static_cast<const BT*>(bias);
  const long long rows = (long long)L * S * H;
  evo_bwd_prep_kernel<bf16><<<(unsigned)((rows + THREADS - 1) / THREADS), THREADS, 0, st>>>(
      static_cast<const bf16*>(out), do_, g_, delta, static_cast<bf16*>(dgate), rows, S, H, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int rows_per_chunk = (L + n_chunks - 1) / n_chunks;
  const size_t dq_smem = sizeof(bf16) * ((size_t)2 * MK * (CP + 8) + CP * (MK + 8)) +
                         (bias != nullptr ? sizeof(float) * (size_t)MQ * S : 0);
  if (dq_smem > 232448) return cudaErrorInvalidValue;   // S too long for the dbias tile
  err = cudaFuncSetAttribute(evo_bwd_dq_mma_kernel<BT, CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return err;
  const int nqt = (S + MQ - 1) / MQ;
  float* part = n_chunks == 1 ? dbias : dbias_part;
  evo_bwd_dq_mma_kernel<BT, CP><<<dim3((unsigned)(H * nqt), (unsigned)n_chunks), 128, dq_smem,
                                  st>>>(q_, k_, v_, b_, g_, do_, lse, delta,
                                        static_cast<bf16*>(dq), part, L, S, H, C,
                                        rows_per_chunk, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (bias != nullptr && n_chunks > 1) {
    const long long E = (long long)H * S * S;
    sum_chunks_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(dbias_part, dbias, n_chunks, E);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t dkv_smem = sizeof(bf16) * ((size_t)2 * MQ * (CP + 8) + 2 * CP * (MQ + 8)) +
                          sizeof(float) * ((size_t)MQ * (MK + 1) + 2 * MQ);
  err = cudaFuncSetAttribute(evo_bwd_dkv_mma_kernel<BT, CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return err;
  evo_bwd_dkv_mma_kernel<BT, CP><<<dim3((unsigned)(L * H), (unsigned)((S + MK - 1) / MK)), 128,
                                   dkv_smem, st>>>(q_, k_, v_, b_, g_, do_, lse, delta,
                                                   static_cast<bf16*>(dk),
                                                   static_cast<bf16*>(dv), S, H, C, scale);
  return cudaGetLastError();
}

template <typename BT>
cudaError_t dispatch_fp32(const void* q, const void* k, const void* v, const void* bias,
                          const void* gate, const void* out, const void* dout,
                          const float* lse, float* delta, void* dq, void* dk, void* dv,
                          void* dgate, float* dbias, float* dbias_part, int L, int S, int H,
                          int C, int n_chunks, float scale, cudaStream_t st) {
#define EVO_BWD_CASE(CC)                                                                      \
  case CC:                                                                                    \
    return run<float, BT, CC>(q, k, v, bias, gate, out, dout, lse, delta, dq, dk, dv, dgate,  \
                              dbias, dbias_part, L, S, H, n_chunks, scale, st);
  switch (C) {
    EVO_BWD_CASE(4)
    EVO_BWD_CASE(8)
    EVO_BWD_CASE(16)
    EVO_BWD_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef EVO_BWD_CASE
}

template <typename BT>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, const void* bias,
                          const void* gate, const void* out, const void* dout,
                          const float* lse, float* delta, void* dq, void* dk, void* dv,
                          void* dgate, float* dbias, float* dbias_part, int L, int S, int H,
                          int C, int n_chunks, float scale, cudaStream_t st) {
  if (C != 4 && C != 8 && C != 16 && C != 32) return cudaErrorInvalidValue;
  if (C <= 16)   // head dim zero-padded to 16 or 32
    return run_mma<BT, 16>(q, k, v, bias, gate, out, dout, lse, delta, dq, dk, dv, dgate,
                           dbias, dbias_part, L, S, H, C, n_chunks, scale, st);
  return run_mma<BT, 32>(q, k, v, bias, gate, out, dout, lse, delta, dq, dk, dv, dgate, dbias,
                         dbias_part, L, S, H, C, n_chunks, scale, st);
}

// Lead-row chunks of the dq kernel: each chunk's blocks sum dbias over their
// rows into one partial, so more chunks give more blocks and more partials.
// Aims at ~15 blocks per SM (fp32, 16 queries per block) or ~4 (bf16, 64);
// every chunk holds rows.
int dbias_chunks(int L, int S, int H, int dtype) {
  const int tile = dtype == 1 ? MQ : TQ;
  const int target = dtype == 1 ? 512 : 2048;
  const int per_chunk = H * ((S + tile - 1) / tile);
  int n = (target + per_chunk - 1) / per_chunk;
  n = n < 1 ? 1 : (n > L ? L : n);
  const int rows = (L + n - 1) / n;
  return (L + rows - 1) / rows;
}

}  // namespace

// The number of dbias partials (lead-row chunks) evo_attention_bwd takes for
// a biased call: the caller allocates n_chunks * H * S * S floats of
// dbias_part when it is above 1.
extern "C" int evo_attention_bwd_chunks(int L, int S, int H, int dtype) {
  return dbias_chunks(L, S, H, dtype);
}

// dtype codes: 0 = float32, 1 = bfloat16 (q/k/v/gate/out/dout/dq/dk/dv/dgate
// share `dtype`; the bias has `bias_dtype`).  `bias` and `gate` may be null,
// and then `dbias`/`dbias_part` and `dgate` are not touched.  lse is (L*H, S)
// fp32 from the forward; delta is (L*H, S) fp32 scratch; dbias (H, S, S) fp32;
// dbias_part is scratch of n_chunks * H * S * S floats (unused when
// n_chunks == 1).  Returns the first cudaError_t met (0 = success).
extern "C" int evo_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* gate, const void* out,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, void* dgate, void* dbias,
                                 void* dbias_part, int L, int S, int H, int C, int n_chunks,
                                 int dtype, int bias_dtype, float scale, void* stream) {
  if (L <= 0 || S <= 0 || H <= 0 || n_chunks <= 0 || n_chunks > L) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  float* db = static_cast<float*>(dbias);
  float* dbp = static_cast<float*>(dbias_part);
#define EVO_BWD_ARGS                                                                          \
  q, k, v, bias, gate, out, dout, lse_, delta_, dq, dk, dv, dgate, db, dbp, L, S, H, C, n_chunks, \
      scale, st
  if (dtype == 0 && bias_dtype == 0) return (int)dispatch_fp32<float>(EVO_BWD_ARGS);
  if (dtype == 0 && bias_dtype == 1) return (int)dispatch_fp32<__nv_bfloat16>(EVO_BWD_ARGS);
  if (dtype == 1 && bias_dtype == 0) return (int)dispatch_bf16<float>(EVO_BWD_ARGS);
  if (dtype == 1 && bias_dtype == 1) return (int)dispatch_bf16<__nv_bfloat16>(EVO_BWD_ARGS);
#undef EVO_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
