// LM flash attention, forward (kernel K6 of the port).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
// (Pallas body `_flash_kernel`), reached through kernels/ops.py::
// flash_attention from nn/attention.py::attention(impl="pallas") without a
// bias: every layer of a dense LM's prefill.
//
// Computes, per batch row b, query head h and query i, over keys j < T:
//     o[b,i,h,:] = sum_j p_ij v[b,j,h/G,:] / sum_j p_ij
//     p_ij       = exp(q[b,i,h,:].k[b,j,h/G,:] * scale - m_i),  j <= i if causal
// with q (B, S, H, D), k/v (B, T, KV, D), H = KV * G (grouped-query
// attention).  Positions count from 0 on both sides, as the reference's
// causal mask does (query i sees keys 0..i even when T != S).  Scores and
// the softmax statistics are fp32; for bf16 inputs p is rounded to bf16 for
// the product with v (the Pallas kernel's `p.astype(v.dtype)`) while the
// row sum adds the fp32 p.  out = acc / max(l, 1e-30), in q's type.
//
// What bounds it on the H100: a causal prefill of S tokens does ~2*H*D*S^2
// operations on (2*S*H + 2*T*KV)*D*2 bytes; at the glm4-9b shapes (H 32,
// KV 2, D 128, S 512..3000) that is ~1000-6000 operations per byte, far
// above the card's ~295 bf16 operations per byte: the tensor cores bound
// it.
//
// Design (bf16, the serving path): a block of 4 warps owns 64 query rows of
// one (b, h); each warp 16 rows, held as mma.sync m16n8k16 A fragments in
// registers for the whole key loop.  K and V stream through shared memory in
// 64-key tiles (16-byte loads, rows padded by 16 bytes so the ldmatrix row
// reads are conflict-free); Q.K^T and P.V are bf16 mma.sync with fp32
// accumulation and an fp32 online softmax (running max, sum, accumulator).
// K's fragments come from ldmatrix, V's from ldmatrix.trans, so V needs no
// transposed copy.  The KV head is h / G, read in place: the Pallas wrapper
// repeats K/V G-fold in HBM, here the G heads of a group read the same
// rows.  Causal tiles past the diagonal are not visited (the Pallas grid
// skips them too), and query blocks run heaviest first.  Any S and T: rows
// past S are not written, keys past T are zero-filled and get p = 0.
// q/k/v are read through their (batch, position, head) strides; the last
// dim is contiguous.
//
// fp32 inputs: the exact path on the fp32 CUDA cores, one warp per 4 query
// rows, each lane holding D/32 channels; a score is a warp-shuffle sum and
// the softmax is updated key by key.  It serves tests, not the main path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef long long i64;

struct Strides {
  i64 b, s, h;  // elements between batch rows, positions, heads
};

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MQ = 64;   // query rows per block: 4 warps x 16
constexpr int MK = 64;   // keys per shared-memory tile
constexpr int PAD = 8;   // bf16 elements of row padding (16 bytes)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.  Without .trans lane (g, t) = (l / 4, l % 4) gets
// (row g, cols 2t, 2t+1) of each matrix; with .trans (rows 2t, 2t+1, col g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

template <int D>
__global__ void __launch_bounds__(128)
flash_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int S, int T,
                               int H, int G, Strides qs, Strides ks_, Strides vs_,
                               int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[MK][D + PAD];
  __shared__ __align__(16) __nv_bfloat16 vs[MK][D + PAD];

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;
  // heaviest query blocks first: under a causal mask the last block of rows
  // visits the most key tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks_.b + kvh * ks_.h;
  const __nv_bfloat16* vb = v + b * vs_.b + kvh * vs_.h;

  auto ld_q = [&](int row, int c) -> uint32_t {
    if (row < S) return *reinterpret_cast<const uint32_t*>(qb + row * qs.s + c);
    return 0u;
  };
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c0 = kc * 16 + 2 * t;
    qa[kc][0] = ld_q(row0, c0);
    qa[kc][1] = ld_q(row1, c0);
    qa[kc][2] = ld_q(row0, c0 + 8);
    qa[kc][3] = ld_q(row1, c0 + 8);
  }
  float o[D / 8][4];
#pragma unroll
  for (int ct = 0; ct < D / 8; ++ct) o[ct][0] = o[ct][1] = o[ct][2] = o[ct][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};
  float lsum[2] = {0.f, 0.f};

  // ldmatrix addresses: lane l -> row l % 8 of matrix l / 8
  const int lrow = lane & 7;
  const int lmat = lane >> 3;
  const int kend = causal ? min(T, q0 + MQ) : T;
  for (int k0 = 0; k0 < kend; k0 += MK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < MK * (D / 8); e += 128) {
      const int key = e / (D / 8);
      const int c = (e - key * (D / 8)) * 8;
      const int j = k0 + key;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < T) {
        kv = *reinterpret_cast<const uint4*>(kb + j * ks_.s + c);
        vv = *reinterpret_cast<const uint4*>(vb + j * vs_.s + c);
      }
      *reinterpret_cast<uint4*>(&ks[key][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[key][c]) = vv;
    }
    __syncthreads();

    // scores: 16 rows x MK keys per warp.  For n-tile nt (keys nt*8..+7) and
    // k-chunks kc, kc+1 the four matrices are K[keys][kc*16 + 0..7],
    // [kc*16 + 8..15], [(kc+1)*16 + 0..7], [(kc+1)*16 + 8..15]: B fragments
    // (b0, b1) of kc and of kc + 1.
    float s[MK / 8][4];
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; kc += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, &ks[nt * 8 + lrow][kc * 16 + lmat * 8]);
        mma16816(s[nt], qa[kc], bk[0], bk[1]);
        mma16816(s[nt], qa[kc + 1], bk[2], bk[3]);
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= T || (causal && col > row)) x = -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float corr0 = expf(m[0] - mx[0]);
    const float corr1 = expf(m[1] - mx[1]);
    m[0] = mx[0];
    m[1] = mx[1];
    lsum[0] *= corr0;
    lsum[1] *= corr1;
#pragma unroll
    for (int ct = 0; ct < D / 8; ++ct) {
      o[ct][0] *= corr0;
      o[ct][1] *= corr0;
      o[ct][2] *= corr1;
      o[ct][3] *= corr1;
    }
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
        lsum[e >> 1] += s[nt][e];
      }
    }
    // O += P.V, 16 keys per k-step; the score fragments are P's A operand.
    // For channel tiles ct, ct+1 the four matrices (read transposed) are
    // V[kc*16 + 0..7][ct*8..], V[kc*16 + 8..15][ct*8..], and the same for
    // ct + 1: B fragments (b0, b1) of ct and of ct + 1.
#pragma unroll
    for (int kc = 0; kc < MK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int ct = 0; ct < D / 8; ct += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, &vs[kc * 16 + (lmat & 1) * 8 + lrow][(ct + (lmat >> 1)) * 8]);
        mma16816(o[ct], pa, bv[0], bv[1]);
        mma16816(o[ct + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
  }
  const float inv[2] = {1.f / fmaxf(lsum[0], 1e-30f), 1.f / fmaxf(lsum[1], 1e-30f)};
#pragma unroll
  for (int ct = 0; ct < D / 8; ++ct) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row0 : row1;
      if (row >= S) continue;
      const int c = ct * 8 + 2 * t;
      const i64 off = ((i64)(b * S + row) * H + h) * D + c;  // out is contiguous
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(o[ct][2 * r] * inv[r], o[ct][2 * r + 1] * inv[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int RW = 4;          // query rows per warp
constexpr int FW = 8;          // warps per block
constexpr int FQ = RW * FW;    // query rows per block
constexpr int FK = 32;         // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(FW * 32)
flash_attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ out,
                               int S, int T, int H, int G, Strides qs, Strides ks_,
                               Strides vs_, int causal, float scale) {
  constexpr int CL = D / 32;  // channels per lane: lane + 32 * cc
  __shared__ float ks[FK][D];
  __shared__ float vs[FK][D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks_.b + kvh * ks_.h;
  const float* vb = v + b * vs_.b + kvh * vs_.h;

  float qr[RW][CL], acc[RW][CL], m[RW], l[RW];
  int rows[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    rows[i] = q0 + warp * RW + i;
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CL; ++cc) {
      qr[i][cc] = rows[i] < S ? qb[rows[i] * qs.s + lane + 32 * cc] : 0.f;
      acc[i][cc] = 0.f;
    }
  }
  const int kend = causal ? min(T, q0 + FQ) : T;
  for (int k0 = 0; k0 < kend; k0 += FK) {
    __syncthreads();
    for (int e = threadIdx.x; e < FK * D; e += FW * 32) {
      const int key = e / D;
      const int c = e - key * D;
      const int j = k0 + key;
      ks[key][c] = j < T ? kb[j * ks_.s + c] : 0.f;
      vs[key][c] = j < T ? vb[j * vs_.s + c] : 0.f;
    }
    __syncthreads();
    const int n = min(FK, kend - k0);
    for (int kk = 0; kk < n; ++kk) {
      const int j = k0 + kk;
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        float d = 0.f;
#pragma unroll
        for (int cc = 0; cc < CL; ++cc) d = fmaf(qr[i][cc], ks[kk][lane + 32 * cc], d);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (causal && j > rows[i]) continue;  // uniform across the warp
        const float x = d * scale;
        const float m_new = fmaxf(m[i], x);
        const float corr = expf(m[i] - m_new);
        const float p = expf(x - m_new);
        l[i] = l[i] * corr + p;
#pragma unroll
        for (int cc = 0; cc < CL; ++cc)
          acc[i][cc] = fmaf(p, vs[kk][lane + 32 * cc], acc[i][cc] * corr);
        m[i] = m_new;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (rows[i] >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const i64 off = ((i64)(b * S + rows[i]) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CL; ++cc) out[off + lane + 32 * cc] = acc[i][cc] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int T, int H, int G, Strides qs, Strides ks_, Strides vs_, int causal,
                   int dtype, float scale, cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid((unsigned)(B * H), (unsigned)((S + MQ - 1) / MQ));
    flash_attention_fwd_mma_kernel<D><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, T, H, G,
        qs, ks_, vs_, causal, scale);
  } else {
    const dim3 grid((unsigned)(B * H), (unsigned)((S + FQ - 1) / FQ));
    flash_attention_fwd_f32_kernel<D><<<grid, FW * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, T, H, G, qs, ks_, vs_,
        causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  q (B, S, H, D) and k/v (B, T, KV, D)
// are given by their base pointers and (batch, position, head) strides in
// elements, the last dim contiguous; out is a contiguous (B, S, H, D) tensor.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int T, int H, int KV, int D,
                                   i64 qsb, i64 qss, i64 qsh, i64 ksb, i64 kss, i64 ksh,
                                   i64 vsb, i64 vss, i64 vsh, int causal, int dtype,
                                   float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks_{ksb, kss, ksh}, vs_{vsb, vss, vsh};
  const int G = H / KV;
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, out, B, S, T, H, G, qs, ks_, vs_, causal, dtype, scale, st);
    case 64: return (int)launch<64>(q, k, v, out, B, S, T, H, G, qs, ks_, vs_, causal, dtype, scale, st);
    case 128: return (int)launch<128>(q, k, v, out, B, S, T, H, G, qs, ks_, vs_, causal, dtype, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
