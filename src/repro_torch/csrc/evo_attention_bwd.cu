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
// computed in both kernels below) on ~10 (L,S,H,C) tensors plus the bias
// and dbias: at S 256, C 32 some 100 operations per byte, below the ~295 the
// tensor cores need per byte, so the bytes bound it.
//
// Design, bf16 (the training path): four launches (five when S takes more
// than one key window), no atomics, so two runs give the same bits.
//  * evo_bwd_prep_bf16_kernel: delta, and with a gate do_raw (bf16, written
//    once, read by both kernels in place of do and gate) and dgate.  One
//    thread per 16-byte chunk, a row's chunks on adjacent lanes.
//  * evo_bwd_dq_win_kernel: dq and dbias.  A block of two warpgroups owns
//    one (head, 64-query tile, window of up to 256 keys) and a range of
//    lead rows.  The window's bias tiles arrive once and its fp32 dbias
//    sums stay in shared memory for the block's life (each element owned
//    by the thread whose accumulator fragment holds it, so no bank
//    conflicts and no synchronisation); the block writes its dbias partial
//    once, at its end.  It walks its rows (outer) and the window's key
//    tiles (inner), the two warpgroups taking alternate tiles; dq sums in
//    registers.  A longer S takes more windows, whose fp32 dq partials
//    evo_bwd_dq_sum_kernel adds: no buffer grows with S.  The blocks fill
//    the SMs once, so a biased call has one dbias partial an SM at most
//    (8 at the triangle shapes, 8 MB), which evo_bwd_dbias_sum_kernel adds
//    in a fixed order.
//  * evo_bwd_dkv_ring_kernel: dk and dv.  A block of 4 warps owns one
//    (head, 64-key tile) and a group of lead rows (as many as two blocks an
//    SM leave room for: K, V and fp32 dk and dv sums a row); the 64-query
//    tiles are the outer loop, the rows the inner one, so each bias tile is
//    loaded once per block and read by column (the block's scores are
//    S^T).
//  * In both kernels the streamed tiles (K and V, or Q, do_raw, lse and
//    delta) arrive through a 3-stage cp.async ring, two items ahead of the
//    tensor cores; so do the bias tiles and a row's resident tiles.
//    Fragments come from ldmatrix, and ldmatrix.trans where a product needs
//    a tile by columns (K for dq, Q and do_raw for dk and dv): no transposed
//    copy is made.  p is computed in base 2 (the bias and lse scaled by
//    log2 e).  mma.sync m16n8k16 does the products: at C 32 the kernel is
//    bytes-bound and a k-depth of 32 leaves wgmma little to gain.
//  * Two kernels rather than one pass that writes ds: ds in bf16 would be
//    L*H*S^2*2 bytes written and read twice (134 MB, ~80 us at the
//    triangle shapes, against a 51 us bound for the whole call), while
//    recomputing the scores and dp costs 4*L*H*S^2*C operations (~9 GFLOP,
//    ~10 us at the tensor cores' rate).
//  * A bias whose rows do not start on 16-byte boundaries (S not a multiple
//    of 8, or 4 in fp32) is first copied to a padded layout.
// fp32 inputs: one thread per query (dq) or key (dk/dv) on the fp32 CUDA
// cores, 16 rows per block, the dbias sum of a 16 x S tile in shared
// memory; they serve tests, not the main path.
// Any S: keys and queries past S get p = 0 and are not written.  Head dims
// 4, 8, 16 and 32 (zero-padded to 16 or 32 on the tensor cores).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_mma.cuh"

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


// out[e] = sum_{s < n} part[s * E + e], in order.
__global__ void __launch_bounds__(256)
evo_bwd_dbias_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int n,
                         long long E) {
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
    evo_bwd_dbias_sum_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(dbias_part, dbias, n_chunks, E);
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

// Lead-row chunks of the fp32 dq kernel: each chunk's blocks sum dbias over
// their rows into one partial, so more chunks give more blocks and more
// partials.  Aims at ~15 blocks (16 queries each) per SM; every chunk holds
// rows.
int dbias_chunks(int L, int S, int H) {
  const int per_chunk = H * ((S + TQ - 1) / TQ);
  int n = (2048 + per_chunk - 1) / per_chunk;
  n = n < 1 ? 1 : (n > L ? L : n);
  const int rows = (L + n - 1) / n;
  return (L + rows - 1) / rows;
}

// ---------------------------------------------------------------------------
// bf16 inputs: pipelined tensor-core kernels (mma.sync m16n8k16 from
// ldmatrix fragments, cp.async rings; see the note at the top)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int RT = 64;      // rows (queries or keys) of a tile
constexpr int RING = 3;     // stages of the operand ring
// bias tile buffers: a tile is issued RING - 1 items ahead of its first use,
// and with one row in a group every item takes a new tile
constexpr int NBIAS = RING;
// shared memory of a dk/dv block: two blocks (8 warps) share an SM
constexpr int SMEM_BUDGET = 114688;

// 8 or 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp8(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// 2^x in one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ldmatrix addresses as 32-bit shared offsets: this lane's byte offset in
// a [64][LDT] bf16 tile, computed once, plus a constant per fragment.
// `a`: an A fragment (16 rows x 16 k at row m0, col k0: + (m0 * LDT + k0) *
// 2), and the B fragments of two n-tiles of a [k][n] tile (ldmatrix.trans,
// + (k0 * LDT + n0) * 2); `bnk`: those of a [n][k] tile (+ (n0 * LDT + k0)
// * 2).  The fragments are tile_mma.cuh's frag_a and frag_b2.
struct FragOff {
  uint32_t a, bnk;
};
template <int LDT>
__device__ __forceinline__ FragOff frag_offsets() {
  const int lane = threadIdx.x & 31;
  return {(uint32_t)((((lane & 7) + ((lane >> 3) & 1) * 8) * LDT + (lane >> 4) * 8) * 2),
          (uint32_t)((((lane & 7) + (lane >> 4) * 8) * LDT + ((lane >> 3) & 1) * 8) * 2)};
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Shared-memory plan of the dk/dv kernel: a ring of bias tiles, the operand
// ring, and per lead row of its group K and V tiles and the fp32 dk and dv
// sums.  Operand tiles are [64][CP+8] bf16 (16-byte row padding: the 8 row
// reads of an ldmatrix phase hit distinct banks); bias tiles [64][LDB] in
// the bias's type, LDB chosen so that reading a tile by column (this
// kernel's scores are S^T) is conflict-free.
template <typename BT, int CP>
struct Plan {
  static constexpr int LDT = CP + 8;
  static constexpr int TILE = RT * LDT;  // elements of one operand tile
  static constexpr int LDB = sizeof(BT) == 4 ? 68 : 72;
  static constexpr int BIAS_BYTES = NBIAS * RT * LDB * (int)sizeof(BT);
  // ring stage: Q and do_raw tiles, lse and delta of 64 rows
  static constexpr int STAGE_BYTES = 2 * TILE * 2 + 2 * RT * 4;
  // per lead row of a group: K and V tiles, the dk and dv sums
  static constexpr int ROW_BYTES = 2 * TILE * 2 + 2 * RT * CP * 4;
  static constexpr int FIXED = BIAS_BYTES + RING * STAGE_BYTES;
  static int rows(int L) {  // lead rows a group holds
    int r = (SMEM_BUDGET - FIXED) / ROW_BYTES;
    return r < L ? r : L;
  }
  static size_t smem(int rows) { return (size_t)FIXED + (size_t)rows * ROW_BYTES; }
};

// Shared-memory plan of the dq kernel: the window's bias tiles and dbias
// sums, a ring of K/V tile pairs, three slots of a row's Q, do_raw, lse and
// delta, and warpgroup 1's dq sum.  NW key tiles a window: 4 (256 keys)
// with a bf16 bias, 2 with an fp32 one.
template <typename BT, int CP>
struct WinPlan {
  static constexpr int NW = sizeof(BT) == 2 ? 4 : 2;
  static constexpr int LDT = CP + 8;
  static constexpr int TILE = RT * LDT;
  static constexpr int LDB = 72;
  static constexpr int SLOT_BYTES = 2 * TILE * 2 + 2 * RT * 4;
  static constexpr int OFF_DBIAS = NW * RT * LDB * (int)sizeof(BT);
  static constexpr int OFF_RING = OFF_DBIAS + NW * RT * RT * 4;
  static constexpr int OFF_SLOTS = OFF_RING + RING * 4 * TILE * 2;
  static constexpr int OFF_DQX = OFF_SLOTS + RING * SLOT_BYTES;
  static constexpr int SMEM = OFF_DQX + RT * CP * 4;
};

// One 64-row x CP tile of an (L, S, H, C) tensor, rows p0.. of lead row l,
// head h, into dst [64][CP+8]: cp.async, zeros past S and past C.
template <int CP, int NT = 128>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int l, int p0, int h,
                                          int S, int H, int C) {
  constexpr int LDT = CP + 8;
  const bf16* base = src + ((size_t)l * S * H + h) * C;  // position 0 of (l, h)
  const int rs = H * C;
  for (int e = threadIdx.x; e < RT * (CP / 8); e += NT) {
    const int r = e / (CP / 8), c = (e % (CP / 8)) * 8;
    const int pos = p0 + r;
    const bool row_ok = pos < S;
    const bf16* s = base + (row_ok ? pos : 0) * rs + c;
    bf16* d = dst + r * LDT + c;
    if (C >= 8 || c >= C) {
      tile::cp16(d, c < C ? s : src, row_ok && c < C);
    } else {  // C == 4: 8 bytes of data, 8 of zeros
      cp8(d, s, row_ok);
      cp8(d + 4, src, false);
    }
  }
}

// 64 fp32 values of a (L*H, S) row-statistics array, rows p0.. of (l, h)
__device__ __forceinline__ void load_stats(float* dst, const float* src, int l, int p0, int h,
                                           int S, int H) {
  const int r = threadIdx.x;
  if (r < RT) {
    const bool ok = p0 + r < S;
    cp4(dst + r, ok ? src + ((size_t)l * H + h) * S + p0 + r : src, ok);
  }
}

// The (64 query, 64 key) tile of bias[h] at (q0, k0), rows of pitch bp
template <typename BT, int LDB, int NT = 128>
__device__ __forceinline__ void load_bias(BT* dst, const BT* bias, int h, int q0, int k0, int S,
                                          int bp) {
  constexpr int PER = 16 / (int)sizeof(BT);  // elements per 16-byte copy
  for (int e = threadIdx.x; e < RT * (RT / PER); e += NT) {
    const int r = e / (RT / PER), c = (e % (RT / PER)) * PER;
    const bool ok = q0 + r < S && k0 + c < S;
    const BT* s = ok ? bias + ((size_t)h * S + q0 + r) * bp + k0 + c : bias;
    tile::cp16(dst + r * LDB + c, s, ok);
  }
}

__device__ __forceinline__ float2 bias_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 bias_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int E>
__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[E]) {
  if constexpr (E == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(b[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 x = __bfloat1622float2(b[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

template <int E>
__device__ __forceinline__ void store_vec(bf16* p, const float (&f)[E]) {
  uint32_t w[E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) w[i] = tile::pack_bf16(f[2 * i], f[2 * i + 1]);
  if constexpr (E == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// delta = sum_c do * out per (l, i, h) row; with a gate also do_raw = do *
// sigmoid(gate) and dgate = do * out * (1 - sigmoid(gate)), in bf16.  One
// thread per 16-byte chunk (8 channels; 4 when C is 4), the chunks of a row
// on adjacent lanes.
template <int C>
__global__ void __launch_bounds__(256)
evo_bwd_prep_bf16_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                         const bf16* __restrict__ gate, float* __restrict__ delta,
                         bf16* __restrict__ dgate, bf16* __restrict__ do_raw, long long rows,
                         int S, int H) {
  constexpr int E = C < 8 ? C : 8;
  constexpr int P = C / E;  // chunks per row: 1, 2 or 4 (256 threads hold whole rows)
  const long long chunk = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long r = chunk / P;
  const bool ok = r < rows;
  float d = 0.f;
  if (ok) {
    const size_t off = (size_t)chunk * E;
    float o[E], g[E];
    load_vec<E>(out + off, o);
    load_vec<E>(dout + off, g);
#pragma unroll
    for (int i = 0; i < E; ++i) d = fmaf(g[i], o[i], d);
    if (gate != nullptr) {
      float x[E], dr[E], dg[E];
      load_vec<E>(gate + off, x);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float sg = sigmoid_f(x[i]);
        dr[i] = g[i] * sg;
        dg[i] = g[i] * o[i] * (1.f - sg);
      }
      store_vec<E>(do_raw + off, dr);
      store_vec<E>(dgate + off, dg);
    }
  }
#pragma unroll
  for (int s = 1; s < P; s <<= 1) d += __shfl_xor_sync(0xffffffffu, d, s);
  if (ok && chunk % P == 0) {
    const long long l = r / ((long long)S * H);
    const int rem = (int)(r - l * S * H);
    const int i = rem / H, h = rem - i * H;
    delta[((size_t)l * H + h) * S + i] = d;
  }
}

// bias (H, S, S) -> (H, S, bp) with zero columns past S, so that every row
// starts on a 16-byte boundary
template <typename BT>
__global__ void __launch_bounds__(256)
evo_bwd_bias_pack_kernel(const BT* __restrict__ bias, BT* __restrict__ packed, int S, int bp,
                         long long total) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  const long long row = e / bp;
  const int j = (int)(e - row * bp);
  packed[e] = j < S ? bias[row * S + j] : BT(0.f);
}

// dq and the dbias partial.  One block of two warpgroups per (h, 64-query
// tile, window of up to NW 64-key tiles) x range of lead rows.  The
// window's bias tiles arrive once, and its dbias sums (fp32, each element
// owned by the thread whose accumulator fragment holds it) stay in shared
// memory for the block's life: no buffer grows with S, as a longer S takes
// more windows.  The block walks its rows (outer) and the window's tiles
// (inner), warpgroup g taking tiles j = g, g + 2, ...: per row Q, do_raw,
// lse and delta arrive in one of three slots, K and V of two tiles (one
// per warpgroup) in each stage of the ring.  dq sums over the warpgroup's
// tiles in registers; warpgroup 1 hands its sum to warpgroup 0 through
// shared memory at the row's end, which writes dq (or, with several
// windows, the window's fp32 partial).  The block writes its dbias partial
// once, at its end.
template <typename BT, int CP>
__global__ void __launch_bounds__(256)
evo_bwd_dq_win_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dor,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const BT* __restrict__ bias, int bp, bf16* __restrict__ dq,
                      float* __restrict__ dq_part, float* __restrict__ dbias_part, int L, int S,
                      int H, int C, int rows_per_block, float scale) {
  using PL = WinPlan<BT, CP>;
  constexpr int LDT = PL::LDT, TILE = PL::TILE, LDB = PL::LDB, NW = PL::NW, NF = CP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BT* bsm = reinterpret_cast<BT*>(smem_raw);                               // [NW][64][LDB]
  float* dbs = reinterpret_cast<float*>(smem_raw + PL::OFF_DBIAS);         // [NW][64*64]
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + PL::OFF_RING);           // [RING][2][2][TILE]
  unsigned char* slots = smem_raw + PL::OFF_SLOTS;                         // [RING] Q, do_raw, lse, delta
  float* dqx = reinterpret_cast<float*>(smem_raw + PL::OFF_DQX);           // [64*CP]

  const int nt_ = (S + RT - 1) / RT;
  const int nwin = (nt_ + NW - 1) / NW;
  const int h = blockIdx.x / (((S + RT - 1) / RT) * nwin);
  const int rem = blockIdx.x - h * nt_ * nwin;
  const int qt = rem / nwin, win = rem - qt * nwin;
  const int q0 = qt * RT, kt0 = win * NW;
  const int ntw = min(NW, nt_ - kt0);      // tiles in this window
  const int npp = (ntw + 1) / 2;           // tile pairs a row takes
  const int lb0 = blockIdx.y * rows_per_block;
  const int nl = min(L, lb0 + rows_per_block) - lb0;
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const bool biased = bias != nullptr;
  const float c2 = scale * LOG2E;
  const FragOff fo = frag_offsets<LDT>();
  const int items = nl * npp;

  for (int e = tid; e < NW * RT * RT; e += 256) dbs[e] = 0.f;
  // pair item i: row lb0 + i / npp, tiles 2 (i % npp) and 2 (i % npp) + 1
  auto issue = [&](int i) {
    if (i < items) {
      const int li = i / npp, p = i - li * npp;
      const int l = lb0 + li;
      bf16* st = ring + (i % RING) * 4 * TILE;
      for (int j = 2 * p; j < min(ntw, 2 * p + 2); ++j) {
        bf16* d = st + (j - 2 * p) * 2 * TILE;
        load_rows<CP, 256>(d, k, l, (kt0 + j) * RT, h, S, H, C);
        load_rows<CP, 256>(d + TILE, v, l, (kt0 + j) * RT, h, S, H, C);
      }
      if (p == 0) {
        unsigned char* sl = slots + (li % RING) * PL::SLOT_BYTES;
        bf16* qs = reinterpret_cast<bf16*>(sl);
        float* stats = reinterpret_cast<float*>(sl + 2 * TILE * 2);
        load_rows<CP, 256>(qs, q, l, q0, h, S, H, C);
        load_rows<CP, 256>(qs + TILE, dor, l, q0, h, S, H, C);
        load_stats(stats, lse, l, q0, h, S, H);
        load_stats(stats + RT, delta, l, q0, h, S, H);
      }
      if (i == 0 && biased)
        for (int j = 0; j < ntw; ++j)
          load_bias<BT, LDB, 256>(bsm + j * RT * LDB, bias, h, q0, (kt0 + j) * RT, S, bp);
    }
    tile::cp_commit();
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) issue(i);

  float dqa[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f) dqa[f][0] = dqa[f][1] = dqa[f][2] = dqa[f][3] = 0.f;
  for (int i = 0; i < items; ++i) {
    tile::cp_wait<RING - 2>();
    __syncthreads();
    issue(i + RING - 1);
    const int li = i / npp, p = i - li * npp;
    const int j = 2 * p + wgi;  // this warpgroup's tile in the window
    const unsigned char* sl = slots + (li % RING) * PL::SLOT_BYTES;
    const bf16* qs = reinterpret_cast<const bf16*>(sl);
    const float* lse_s = reinterpret_cast<const float*>(sl + 2 * TILE * 2);
    const float* del_s = lse_s + RT;
    if (j < ntw) {
      const bf16* ks = ring + (i % RING) * 4 * TILE + wgi * 2 * TILE;
      const uint32_t ku = smem_u32(ks), vu = ku + TILE * 2;
      const uint32_t qu = smem_u32(qs) + warp * 16 * LDT * 2, du = qu + TILE * 2;
      const int k0 = (kt0 + j) * RT;
      // S = Q.K^T and dP = do_raw.V^T, 16 queries x 64 keys a warp
      float sc[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < CP / 16; ++kc) {
        uint32_t qa[4], da[4];
        ldsm4(qa, qu + fo.a + kc * 32);
        ldsm4(da, du + fo.a + kc * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm4(b, ku + fo.bnk + (np * 16 * LDT + kc * 16) * 2);
          tile::mma16816(sc[2 * np], qa, b[0], b[1]);
          tile::mma16816(sc[2 * np + 1], qa, b[2], b[3]);
          ldsm4(b, vu + fo.bnk + (np * 16 * LDT + kc * 16) * 2);
          tile::mma16816(dp[2 * np], da, b[0], b[1]);
          tile::mma16816(dp[2 * np + 1], da, b[2], b[3]);
        }
      }
      // ds = p * (dp - delta), p = exp(s * scale + bias - lse), in base 2;
      // the dbias sum in this thread's elements of the window's tile j
      const float lse0 = lse_s[lr0] * LOG2E, lse1 = lse_s[lr1] * LOG2E;
      const float del0 = del_s[lr0], del1 = del_s[lr1];
      const BT* bt = bsm + j * RT * LDB;
      float* db = dbs + j * RT * RT + warp * 32 * 32 + lane;
      const bool edge = q0 + RT > S || k0 + RT > S;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int lc = nt * 8 + 2 * t;
        float2 b0 = make_float2(0.f, 0.f), b1 = b0;
        if (biased) {
          b0 = bias_pair(bt + lr0 * LDB + lc);
          b1 = bias_pair(bt + lr1 * LDB + lc);
        }
        const float bb[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const float x = fmaf(sc[nt][e], c2, fmaf(bb[e], LOG2E, -(hi ? lse1 : lse0)));
          float ds = ex2(x) * (dp[nt][e] - (hi ? del1 : del0));
          if (edge && (q0 + (hi ? lr1 : lr0) >= S || k0 + lc + (e & 1) >= S)) ds = 0.f;
          if (biased) db[(nt * 4 + e) * 32] += ds;
          sc[nt][e] = ds;
        }
      }
      // dQ += dS.K: the ds fragments are the A operand, K [key][c] read
      // transposed by ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < RT / 16; ++kc) {
        const uint32_t a[4] = {tile::pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                               tile::pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                               tile::pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                               tile::pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
        for (int np = 0; np < CP / 16; ++np) {
          uint32_t b[4];
          ldsm4t(b, ku + fo.a + (kc * 16 * LDT + np * 16) * 2);
          tile::mma16816(dqa[2 * np], a, b[0], b[1]);
          tile::mma16816(dqa[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    if (p == npp - 1) {  // the row's last pair: warpgroup 1's dq sum to warpgroup 0
      float* x = dqx + warp * NF * 4 * 32 + lane;
      if (wgi == 1)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[(f * 4 + e) * 32] = dqa[f][e];
            dqa[f][e] = 0.f;
          }
      __syncthreads();
      if (wgi == 0) {
        const int l = lb0 + li;
        const size_t base = ((size_t)l * S) * H * C + (size_t)h * C;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int c = f * 8 + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = q0 + (r == 0 ? lr0 : lr1);
            const float v0 = dqa[f][2 * r] + x[(f * 4 + 2 * r) * 32];
            const float v1 = dqa[f][2 * r + 1] + x[(f * 4 + 2 * r + 1) * 32];
            dqa[f][2 * r] = dqa[f][2 * r + 1] = 0.f;
            if (row >= S || c >= C) continue;
            const size_t off = base + (size_t)row * H * C + c;
            if (nwin == 1) {
              *reinterpret_cast<uint32_t*>(dq + off) = tile::pack_bf16(v0 * scale, v1 * scale);
            } else {
              float* pp = dq_part + (size_t)win * L * S * H * C + off;
              pp[0] = v0;
              if (c + 1 < C) pp[1] = v1;
            }
          }
        }
      }
    }
  }
  tile::cp_wait<0>();
  if (biased) {  // the block's dbias partial: each thread its own elements
    __syncthreads();
    float* part = dbias_part + ((size_t)blockIdx.y * H + h) * S * S;
    for (int j = wgi; j < ntw; j += 2) {
      const float* db = dbs + j * RT * RT + warp * 32 * 32 + lane;
      const int k0 = (kt0 + j) * RT;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + (e >= 2 ? lr1 : lr0), col = k0 + nt * 8 + 2 * t + (e & 1);
          if (row < S && col < S) part[(size_t)row * S + col] = db[(nt * 4 + e) * 32];
        }
    }
  }
}

// dq = bf16(scale * sum_w part[w]) over the windows, in order.
__global__ void __launch_bounds__(256)
evo_bwd_dq_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dq, int n, long long E,
                      float scale) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += part[(size_t)i * E + e];
  dq[e] = __float2bfloat16(s * scale);
}

// dk and dv.  One block of 4 warps per (h, 64-key tile) x group of `R`
// lead rows; a warp owns 16 keys.  K and V of the group's rows arrive once;
// then for each 64-query tile (outer) and each row (inner) Q, do_raw, lse
// and delta stream through the ring.  The bias tile is loaded once per
// query tile for the whole group (read transposed: the block's scores are
// S^T).  dk and dv sum over the query tiles in shared memory.
template <typename BT, int CP>
__global__ void __launch_bounds__(128)
evo_bwd_dkv_ring_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dor,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const BT* __restrict__ bias, int bp, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int L, int S, int H, int C, int R, float scale) {
  using PL = Plan<BT, CP>;
  constexpr int LDT = PL::LDT, TILE = PL::TILE, LDB = PL::LDB, NF = CP / 8;
  constexpr int STAGE = PL::STAGE_BYTES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BT* bsm = reinterpret_cast<BT*>(smem_raw);
  unsigned char* ring = smem_raw + PL::BIAS_BYTES;
  bf16* ksm = reinterpret_cast<bf16*>(smem_raw + PL::FIXED);
  bf16* vsm = ksm + R * TILE;
  float* dkacc = reinterpret_cast<float*>(vsm + R * TILE);
  float* dvacc = dkacc + R * RT * CP;

  const int nt_ = (S + RT - 1) / RT;
  const int h = blockIdx.x / nt_;
  const int k0 = (blockIdx.x - h * nt_) * RT;
  const int l0 = blockIdx.y * R;
  const int nl = min(R, L - l0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lk0 = warp * 16 + g, lk1 = lk0 + 8;  // this thread's keys in the tile
  const bool biased = bias != nullptr;
  const float c2 = scale * LOG2E;
  const FragOff fo = frag_offsets<LDT>();
  const int items = nt_ * nl;

  auto issue = [&](int i) {
    if (i < items) {
      const int qt = i / nl, li = i - qt * nl;
      unsigned char* st = ring + (i % RING) * STAGE;
      bf16* qs = reinterpret_cast<bf16*>(st);
      float* stats = reinterpret_cast<float*>(st + 2 * TILE * 2);
      load_rows<CP>(qs, q, l0 + li, qt * RT, h, S, H, C);
      load_rows<CP>(qs + TILE, dor, l0 + li, qt * RT, h, S, H, C);
      load_stats(stats, lse, l0 + li, qt * RT, h, S, H);
      load_stats(stats + RT, delta, l0 + li, qt * RT, h, S, H);
      if (li == 0 && biased)
        load_bias<BT, LDB>(bsm + (qt % NBIAS) * RT * LDB, bias, h, qt * RT, k0, S, bp);
      if (i == 0)
        for (int r = 0; r < nl; ++r) {
          load_rows<CP>(ksm + r * TILE, k, l0 + r, k0, h, S, H, C);
          load_rows<CP>(vsm + r * TILE, v, l0 + r, k0, h, S, H, C);
        }
    }
    tile::cp_commit();
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) issue(i);

  for (int i = 0; i < items; ++i) {
    tile::cp_wait<RING - 2>();
    __syncthreads();
    issue(i + RING - 1);
    const int qt = i / nl, li = i - qt * nl;
    const unsigned char* st = ring + (i % RING) * STAGE;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * TILE * 2);
    const float* del_s = lse_s + RT;
    const int q0 = qt * RT;
    // S^T = K.Q^T and dP^T = V.do_raw^T, 16 keys x 64 queries a warp
    float st_[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st_[nt][e] = dpt[nt][e] = 0.f;
    const uint32_t qu = smem_u32(qs), du = qu + TILE * 2;
    const uint32_t ku = smem_u32(ksm + li * TILE) + warp * 16 * LDT * 2;
    const uint32_t vu = smem_u32(vsm + li * TILE) + warp * 16 * LDT * 2;
#pragma unroll
    for (int kc = 0; kc < CP / 16; ++kc) {
      uint32_t ka[4], va[4];
      ldsm4(ka, ku + fo.a + kc * 32);
      ldsm4(va, vu + fo.a + kc * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm4(b, qu + fo.bnk + (np * 16 * LDT + kc * 16) * 2);
        tile::mma16816(st_[2 * np], ka, b[0], b[1]);
        tile::mma16816(st_[2 * np + 1], ka, b[2], b[3]);
        ldsm4(b, du + fo.bnk + (np * 16 * LDT + kc * 16) * 2);
        tile::mma16816(dpt[2 * np], va, b[0], b[1]);
        tile::mma16816(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }
    // p^T and ds^T; the bias tile [query][key] read by column
    const BT* bt = bsm + (qt % NBIAS) * RT * LDB;
    const bool edge = q0 + RT > S || k0 + RT > S;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lk = e >= 2 ? lk1 : lk0;
        const int lq = nt * 8 + 2 * t + (e & 1);
        const float bb = biased ? to_f(bt[lq * LDB + lk]) : 0.f;
        const float x = fmaf(st_[nt][e], c2, fmaf(bb, LOG2E, -lse_s[lq] * LOG2E));
        float p = ex2(x);
        float ds = p * (dpt[nt][e] - del_s[lq]);
        if (edge && (q0 + lq >= S || k0 + lk >= S)) p = ds = 0.f;
        st_[nt][e] = p;
        dpt[nt][e] = ds;
      }
    }
    // dV += P^T.do_raw and dK += dS^T.Q, the queries as the k dimension;
    // Q and do_raw [query][c] read transposed by ldmatrix.trans
    float* akp = dkacc + li * RT * CP + warp * NF * 4 * 32 + lane;
    float* avp = dvacc + li * RT * CP + warp * NF * 4 * 32 + lane;
    float dka[NF][4], dva[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dka[f][e] = qt == 0 ? 0.f : akp[(f * 4 + e) * 32];
        dva[f][e] = qt == 0 ? 0.f : avp[(f * 4 + e) * 32];
      }
#pragma unroll
    for (int kc = 0; kc < RT / 16; ++kc) {
      const uint32_t pa[4] = {tile::pack_bf16(st_[2 * kc][0], st_[2 * kc][1]),
                              tile::pack_bf16(st_[2 * kc][2], st_[2 * kc][3]),
                              tile::pack_bf16(st_[2 * kc + 1][0], st_[2 * kc + 1][1]),
                              tile::pack_bf16(st_[2 * kc + 1][2], st_[2 * kc + 1][3])};
      const uint32_t sa[4] = {tile::pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]),
                              tile::pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]),
                              tile::pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]),
                              tile::pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < CP / 16; ++np) {
        uint32_t b[4];
        ldsm4t(b, du + fo.a + (kc * 16 * LDT + np * 16) * 2);
        tile::mma16816(dva[2 * np], pa, b[0], b[1]);
        tile::mma16816(dva[2 * np + 1], pa, b[2], b[3]);
        ldsm4t(b, qu + fo.a + (kc * 16 * LDT + np * 16) * 2);
        tile::mma16816(dka[2 * np], sa, b[0], b[1]);
        tile::mma16816(dka[2 * np + 1], sa, b[2], b[3]);
      }
    }
    if (qt == nt_ - 1) {
      const size_t base = ((size_t)(l0 + li) * S) * H * C + (size_t)h * C;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int c = f * 8 + 2 * t;
        if (c >= C) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = k0 + (r == 0 ? lk0 : lk1);
          if (key >= S) continue;
          const size_t off = base + (size_t)key * H * C + c;
          *reinterpret_cast<uint32_t*>(dk + off) =
              tile::pack_bf16(dka[f][2 * r] * scale, dka[f][2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off) = tile::pack_bf16(dva[f][2 * r], dva[f][2 * r + 1]);
        }
      }
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          akp[(f * 4 + e) * 32] = dka[f][e];
          avp[(f * 4 + e) * 32] = dva[f][e];
        }
    }
  }
  tile::cp_wait<0>();
}

// Scratch of a bf16 call, carved from one workspace in this order: delta
// (L*H*S fp32), do_raw (L*S*H*C bf16, gated calls), the packed bias (H*S*bp,
// when S's rows do not start on 16-byte boundaries), the dbias partials
// (n_part*H*S*S fp32, when n_part > 1), the dq partials (nwin*L*S*H*C fp32,
// when S takes more than one key window).
struct Bf16Layout {
  int nwin;           // key windows of the dq kernel
  int n_part;         // dq blocks along the lead rows (dbias partials)
  int rows_per_part;  // lead rows each of them walks
  int rows_dkv;       // lead rows a dk/dv block holds
  bool pack;          // the bias is first copied to rows of pitch bp
  int bp;             // bias row pitch (elements)
  size_t off_dor, off_bias, off_part, off_dqp, bytes;
};

inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

template <typename BT, int CP>
Bf16Layout bf16_layout(int L, int S, int H, int C, bool biased, bool gated, bool pack) {
  Bf16Layout y;
  const int nt = (S + RT - 1) / RT;
  y.nwin = (nt + WinPlan<BT, CP>::NW - 1) / WinPlan<BT, CP>::NW;
  y.rows_dkv = Plan<BT, CP>::rows(L);
  // dq blocks (one an SM) along the lead rows: one wave with a bias, since
  // each is one fp32 dbias partial of H * S * S; two without
  const int tiles = H * nt * y.nwin;
  int n = (biased ? 132 : 264) / tiles;
  n = n < 1 ? 1 : (n > L ? L : n);
  y.rows_per_part = (L + n - 1) / n;
  y.n_part = (L + y.rows_per_part - 1) / y.rows_per_part;
  const int per = 16 / (int)sizeof(BT);
  y.pack = biased && pack;
  y.bp = y.pack ? (S + per - 1) / per * per : S;
  size_t off = align256((size_t)L * H * S * 4);
  y.off_dor = off;
  if (gated) off += align256((size_t)L * S * H * C * 2);
  y.off_bias = off;
  if (y.pack) off += align256((size_t)H * S * y.bp * sizeof(BT));
  y.off_part = off;
  if (biased && y.n_part > 1) off += align256((size_t)y.n_part * H * S * S * 4);
  y.off_dqp = off;
  if (y.nwin > 1) off += align256((size_t)y.nwin * L * S * H * C * 4);
  y.bytes = off;
  return y;
}

template <int C>
cudaError_t launch_prep_bf16(const bf16* out, const bf16* dout, const bf16* gate, float* delta,
                             bf16* dgate, bf16* dor, int L, int S, int H, cudaStream_t st) {
  constexpr int E = C < 8 ? C : 8;
  const long long rows = (long long)L * S * H;
  const long long chunks = rows * (C / E);
  evo_bwd_prep_bf16_kernel<C><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(
      out, dout, gate, delta, dgate, dor, rows, S, H);
  return cudaGetLastError();
}

template <typename BT, int CP>
cudaError_t run_bf16(const void* q, const void* k, const void* v, const void* bias,
                     const void* gate, const void* out, const void* dout, const float* lse,
                     void* dq, void* dk, void* dv, void* dgate, float* dbias, char* ws, int L,
                     int S, int H, int C, float scale, cudaStream_t st) {
  const bool biased = bias != nullptr, gated = gate != nullptr;
  const bool pack = biased && (S % (16 / (int)sizeof(BT)) != 0 ||
                               reinterpret_cast<uintptr_t>(bias) % 16 != 0);
  const Bf16Layout y = bf16_layout<BT, CP>(L, S, H, C, biased, gated, pack);
  float* delta = reinterpret_cast<float*>(ws);
  bf16* dor = gated ? reinterpret_cast<bf16*>(ws + y.off_dor)
                    : const_cast<bf16*>(static_cast<const bf16*>(dout));
  const bf16* out_ = static_cast<const bf16*>(out);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const bf16* g_ = static_cast<const bf16*>(gate);
  cudaError_t err;
  switch (C) {
    case 4: err = launch_prep_bf16<4>(out_, do_, g_, delta, static_cast<bf16*>(dgate), dor, L, S, H, st); break;
    case 8: err = launch_prep_bf16<8>(out_, do_, g_, delta, static_cast<bf16*>(dgate), dor, L, S, H, st); break;
    case 16: err = launch_prep_bf16<16>(out_, do_, g_, delta, static_cast<bf16*>(dgate), dor, L, S, H, st); break;
    default: err = launch_prep_bf16<32>(out_, do_, g_, delta, static_cast<bf16*>(dgate), dor, L, S, H, st); break;
  }
  if (err != cudaSuccess) return err;
  const BT* b_ = static_cast<const BT*>(bias);
  if (y.pack) {
    BT* packed = reinterpret_cast<BT*>(ws + y.off_bias);
    const long long total = (long long)H * S * y.bp;
    evo_bwd_bias_pack_kernel<BT><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(b_, packed, S,
                                                                                  y.bp, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    b_ = packed;
  }
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const int nt = (S + RT - 1) / RT;

  float* part = y.n_part > 1 ? reinterpret_cast<float*>(ws + y.off_part) : dbias;
  float* dqp = reinterpret_cast<float*>(ws + y.off_dqp);
  constexpr int DQ_SMEM = WinPlan<BT, CP>::SMEM;
  if ((err = tile::configure((const void*)evo_bwd_dq_win_kernel<BT, CP>, DQ_SMEM)) != cudaSuccess)
    return err;
  evo_bwd_dq_win_kernel<BT, CP><<<dim3((unsigned)(H * nt * y.nwin), (unsigned)y.n_part), 256,
                                  DQ_SMEM, st>>>(q_, k_, v_, dor, lse, delta, b_, y.bp,
                                                 static_cast<bf16*>(dq), dqp, part, L, S, H, C,
                                                 y.rows_per_part, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (y.nwin > 1) {
    const long long E = (long long)L * S * H * C;
    evo_bwd_dq_sum_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(
        dqp, static_cast<bf16*>(dq), y.nwin, E, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (biased && y.n_part > 1) {
    const long long E = (long long)H * S * S;
    evo_bwd_dbias_sum_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(part, dbias, y.n_part,
                                                                           E);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const size_t dkv_smem = Plan<BT, CP>::smem(y.rows_dkv);
  if ((err = tile::configure((const void*)evo_bwd_dkv_ring_kernel<BT, CP>, (int)dkv_smem)) !=
      cudaSuccess)
    return err;
  const int n_dkv = (L + y.rows_dkv - 1) / y.rows_dkv;
  evo_bwd_dkv_ring_kernel<BT, CP><<<dim3((unsigned)(H * nt), (unsigned)n_dkv), 128, dkv_smem,
                                    st>>>(q_, k_, v_, dor, lse, delta, b_, y.bp,
                                          static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, S, H,
                                          C, y.rows_dkv, scale);
  return cudaGetLastError();
}

template <typename BT>
Bf16Layout layout_bf16(int L, int S, int H, int C, bool biased, bool gated, bool pack) {
  return C <= 16 ? bf16_layout<BT, 16>(L, S, H, C, biased, gated, pack)
                 : bf16_layout<BT, 32>(L, S, H, C, biased, gated, pack);
}

// fp32 calls: delta, then the dbias partials when there are several chunks
size_t fp32_bytes(int L, int S, int H, bool biased, int n_chunks) {
  return align256((size_t)L * H * S * 4) +
         (biased && n_chunks > 1 ? align256((size_t)n_chunks * H * S * S * 4) : 0);
}

}  // namespace

// Workspace bytes evo_attention_bwd needs for this call; the caller sizes
// it by kernels/cost.py::evo_attention_bwd_scratch, and the launch refuses
// less.  bias_misaligned: the bias's data does not start on a 16-byte
// boundary.
static long long workspace_need(int L, int S, int H, int C, int dtype, int bias_dtype,
                                int has_bias, int has_gate, int bias_misaligned) {
  if (dtype == 0) return (long long)fp32_bytes(L, S, H, has_bias, dbias_chunks(L, S, H));
  const int per = bias_dtype == 1 ? 8 : 4;
  const bool pack = has_bias && (S % per != 0 || bias_misaligned);
  const Bf16Layout y = (has_bias && bias_dtype == 0)
                           ? layout_bf16<float>(L, S, H, C, true, has_gate, pack)
                           : layout_bf16<__nv_bfloat16>(L, S, H, C, has_bias, has_gate, pack);
  return (long long)y.bytes;
}

// dtype codes: 0 = float32, 1 = bfloat16 (q/k/v/gate/out/dout/dq/dk/dv/dgate
// share `dtype`; the bias has `bias_dtype`).  `bias` and `gate` may be null,
// and then `dbias` and `dgate` are not touched.  lse is (L*H, S) fp32 from
// the forward; dbias (H, S, S) fp32; `workspace` holds `workspace_bytes`
// bytes, 16-byte aligned, at least workspace_need(...).  Returns the first
// cudaError_t met (0 = success).
extern "C" int evo_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* gate, const void* out,
                                 const void* dout, const void* lse, void* dq, void* dk, void* dv,
                                 void* dgate, void* dbias, void* workspace,
                                 long long workspace_bytes, int L, int S, int H, int C, int dtype,
                                 int bias_dtype, float scale, void* stream) {
  if (L <= 0 || S <= 0 || H <= 0 || (C != 4 && C != 8 && C != 16 && C != 32))
    return (int)cudaErrorInvalidValue;
  if (workspace_bytes < workspace_need(L, S, H, C, dtype, bias_dtype, bias != nullptr,
                                       gate != nullptr,
                                       reinterpret_cast<uintptr_t>(bias) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_ = static_cast<const float*>(lse);
  float* db = static_cast<float*>(dbias);
  char* ws = static_cast<char*>(workspace);
  if (dtype == 0) {
    const int n_chunks = bias != nullptr ? dbias_chunks(L, S, H) : L;
    float* delta = reinterpret_cast<float*>(ws);
    float* part = reinterpret_cast<float*>(ws + align256((size_t)L * H * S * 4));
#define EVO_BWD_ARGS                                                                         \
  q, k, v, bias, gate, out, dout, lse_, delta, dq, dk, dv, dgate, db, part, L, S, H, C, n_chunks, \
      scale, st
    if (bias_dtype == 0) return (int)dispatch_fp32<float>(EVO_BWD_ARGS);
    if (bias_dtype == 1) return (int)dispatch_fp32<__nv_bfloat16>(EVO_BWD_ARGS);
#undef EVO_BWD_ARGS
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define EVO_BWD_BF16(BT, CP)                                                              \
  run_bf16<BT, CP>(q, k, v, bias, gate, out, dout, lse_, dq, dk, dv, dgate, db, ws, L, S, H, \
                   C, scale, st)
  if (bias != nullptr && bias_dtype == 0)
    return (int)(C <= 16 ? EVO_BWD_BF16(float, 16) : EVO_BWD_BF16(float, 32));
  if (bias != nullptr && bias_dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)(C <= 16 ? EVO_BWD_BF16(__nv_bfloat16, 16) : EVO_BWD_BF16(__nv_bfloat16, 32));
#undef EVO_BWD_BF16
}
