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
// it, and only wgmma reaches their full rate.
//
// Design, bf16 at D 128 (the serving path; wgmma.cuh has the pieces):
//  * A block of 3 warpgroups owns 128 query rows of one (b, h).  Warpgroup
//    0 is the producer: one thread issues TMA loads.  Warpgroups 1 and 2
//    are consumers, 64 query rows each.
//  * Q (128 x 128) arrives once by TMA.  K and V stream in 128-key tiles
//    through a ring of 3 stages in shared memory, each filled by TMA (4-d
//    tensor maps over (D, heads, positions, batch), so the KV head h / G and
//    any (batch, position, head) strides are read in place) and completing
//    on its `full` mbarrier; the consumers' 8 warps release a stage on its
//    `empty` mbarrier.  So the producer keeps up to 3 tiles in flight while
//    the tensor cores work.
//  * S = Q.K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major, 128-byte swizzle).  O += P.V is wgmma m64n128k16 with P in
//    registers: the fp32 score accumulator is packed to bf16 pairs in place,
//    since wgmma's accumulator layout is its A-register layout, and V is
//    read as stored (channel-contiguous, MN-major) with the transpose bit.
//  * Softmax in base 2: the running max is taken over the raw scores, and
//    p = 2^(s * c - m * c) with c = scale * log2(e) is one FFMA and one MUFU
//    ex2 an element.  The causal and T masks are applied only on tiles that
//    cross the diagonal or T.  O is rescaled only when some row of the warp
//    moved its max.
//  * Each consumer issues tile n's S = Q.K^T and tile n-1's P.V together,
//    waits for the scores and runs tile n's softmax while P.V runs on the
//    tensor cores (one score buffer: P is packed to bf16 registers first).
//    The two consumers take turns issuing their products (named
//    barriers), so that one's softmax runs during the other's products.
//    The producer warpgroup gives up registers (setmaxnreg 24), the
//    consumers take them (240).
//  * Causal tiles past the diagonal are not loaded.  Taking turns, both
//    consumers walk the block's tiles: the first one's part of the last
//    tile is masked whole.  Query blocks run heaviest first.  Rows past S
//    are zero-filled by TMA and not written; keys past T are zero-filled
//    and masked.
// D 32, 64 and 112 (bf16) keep the mma.sync kernel below: a block of 4
// warps owns 64 query rows, K/V in 64-key tiles through shared memory,
// ldmatrix fragments (ldmatrix.trans for V).  D 112 (zamba2-7b's shared
// attention, 3584 / 32) is 7 k-steps of 16 for Q.K^T, the odd last one
// through ldmatrix.x2, and 14 n-tiles of 8 for P.V; a shared row of 112 + 8
// bf16 is 240 bytes, 16-byte aligned, and its 8 rows of an ldmatrix hit
// distinct banks (a 60-word stride); 30 KB of shared memory a block.  A
// plain first version, not the wgmma path of D 128.
//
// fp32 inputs: the exact path on the fp32 CUDA cores, one warp per 4 query
// rows, each lane holding D/32 channels; a score is a warp-shuffle sum and
// the softmax is updated key by key.  It serves tests, not the main path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>

#include "wgmma.cuh"

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

// Two 8x8 bf16 matrices: lanes 0-15 give the addresses (lane l: row l % 8
// of matrix l / 8), as for ldsm_x4's first two.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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
      for (int kc = 0; kc + 1 < D / 16; kc += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, &ks[nt * 8 + lrow][kc * 16 + lmat * 8]);
        mma16816(s[nt], qa[kc], bk[0], bk[1]);
        mma16816(s[nt], qa[kc + 1], bk[2], bk[3]);
      }
      if constexpr (D / 16 % 2 == 1) {
        // D 112: the last 16 channels alone, matrices 0 and 1 (lanes 16-31
        // repeat lanes 0-15's addresses, which x2 ignores)
        constexpr int kc = D / 16 - 1;
        uint32_t bk[2];
        ldsm_x2(bk, &ks[nt * 8 + lrow][kc * 16 + (lmat & 1) * 8]);
        mma16816(s[nt], qa[kc], bk[0], bk[1]);
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
// bf16 inputs, D 128: wgmma with a TMA-filled K/V ring
// ---------------------------------------------------------------------------

namespace w {
constexpr int D = 128;
constexpr int BM = 128;                    // query rows per block
constexpr int BN = 128;                    // keys per K/V tile
constexpr int STAGES = 3;
// the two consumers take turns issuing their products (named barriers 1
// and 2), so that one's softmax runs during the other's products
constexpr bool PINGPONG = true;
constexpr int PANEL_Q = BM * 64 * 2;       // one 64-column panel of Q: 16 KB
constexpr int PANEL_KV = BN * 64 * 2;      // one 64-column panel of K or V: 16 KB
constexpr int Q_BYTES = 2 * PANEL_Q;
constexpr int STAGE_BYTES = 4 * PANEL_KV;  // K's two panels, then V's
constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
}  // namespace w

// S = Q.K^T of one key tile (Q's 64 rows at qslab, K at kb, both two
// 64-column panels), one wgmma group, not waited for
__device__ __forceinline__ void issue_scores(float (&sc)[w::BN / 2], uint32_t qslab, uint32_t kb) {
  wg::fence_regs(sc);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < w::D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;  // k-step within the 128-byte row
    const uint64_t da = wg::desc_sw128(qslab + (kk >> 2) * w::PANEL_Q + off, 16, 1024);
    const uint64_t db = wg::desc_sw128(kb + (kk >> 2) * w::PANEL_KV + off, 16, 1024);
    wg::wgmma_ss<w::BN>(sc, da, db, kk > 0);
  }
  wg::wgmma_commit();
}

// O += P.V of one tile, one wgmma group: P's bf16 pairs are the A
// registers, 16 keys a k-step; V at vb (two 64-column panels)
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&pa)[w::BN / 16][4],
                                         uint32_t vb) {
  wg::fence_regs(o);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < w::BN / 16; ++kk)
    wg::wgmma_m64n128k16_rs_tb(o, pa[kk], wg::desc_sw128(vb + kk * 16 * 128, w::PANEL_KV, 1024));
  wg::wgmma_commit();
}

// Online softmax of one tile, in place in sc: masks keys past T and
// (causal) past each row when `edge`; updates the running max m (of the raw
// scores) and sum l of the thread's two rows and returns their corrections
// in corr.  p = 2^(s * c - m * c) with c = scale * log2(e): one FFMA and one
// MUFU an element.
__device__ __forceinline__ void tile_softmax(float (&sc)[w::BN / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, bool edge, int r0, int r1,
                                             int t, int T, int causal, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < w::BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        if (col >= T || (causal && col > (e < 2 ? r0 : r1))) sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < w::BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j + 0], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = wg::ex2((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    ms[r] = mx[r] * scale_log2;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < w::BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = wg::ex2(fmaf(sc[4 * j + e], scale_log2, -ms[e >> 1]));
      ps[e >> 1] += sc[4 * j + e];
    }
  }
  l[0] = l[0] * corr[0] + ps[0];
  l[1] = l[1] * corr[1] + ps[1];
}

__device__ __forceinline__ void pack_p(uint32_t (&pa)[w::BN / 16][4], const float (&sc)[w::BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < w::BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

__global__ void __launch_bounds__(384, 1)
flash_attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ out, int S, int T, int H, int G,
                                 int causal, float scale_log2) {
  using namespace w;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-byte alignment
  const uint32_t skv = sq + Q_BYTES;
  const uint32_t qbar = skv + STAGES * STAGE_BYTES;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest query blocks first
  const int kend = causal ? min(T, q0 + BM) : T;
  const int ntiles = (kend + BN - 1) / BN;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    wg::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full0 + 8 * s, 1);
      wg::mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 0) {  // producer: one thread issues every load
    wg::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      wg::mbar_expect_tx(qbar, Q_BYTES);
      wg::tma_load_4d(sq, &tq, qbar, 0, h, q0, b);
      wg::tma_load_4d(sq + PANEL_Q, &tq, qbar, 64, h, q0, b);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % STAGES;
        wg::mbar_wait(empty0 + 8 * s, ((n / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s, st = skv + s * STAGE_BYTES;
        wg::mbar_expect_tx(full, STAGE_BYTES);
        wg::tma_load_4d(st, &tk, full, 0, kvh, n * BN, b);
        wg::tma_load_4d(st + PANEL_KV, &tk, full, 64, kvh, n * BN, b);
        wg::tma_load_4d(st + 2 * PANEL_KV, &tv, full, 0, kvh, n * BN, b);
        wg::tma_load_4d(st + 3 * PANEL_KV, &tv, full, 64, kvh, n * BN, b);
      }
    }
    return;
  }
  wg::setmaxnreg_inc<240>();

  // consumers: warpgroup cw owns rows q0 + 64 cw .. + 63
  const int cw = wgi - 1;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + cw * 64;
  const int r0 = row_lo + warp * 16 + g, r1 = r0 + 8;
  const uint32_t qslab = sq + cw * 64 * 128;  // this warpgroup's rows in each Q panel
  // tiles this warpgroup computes: under a causal mask none past its last
  // row; taking turns, both consumers walk the block's tiles (the first
  // consumer's last tile is then masked whole)
  const int nw = PINGPONG ? ntiles : causal ? min(ntiles, (row_lo + 63) / BN + 1) : ntiles;

  float o[64], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  uint32_t pa[BN / 16][4];  // P of the tile in flight, bf16 A fragments
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, corr[2];
  auto stage = [&](int n) { return skv + (n % STAGES) * STAGE_BYTES; };
  auto wait_full = [&](int n) { wg::mbar_wait(full0 + 8 * (n % STAGES), (n / STAGES) & 1); };
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty0 + 8 * (n % STAGES));
  };
  // masks only on tiles that cross the diagonal or T
  auto edge = [&](int n) { return (causal && n * BN + BN - 1 > row_lo) || n * BN + BN > T; };

  // turns: consumer cw issues after named barrier 1 + cw, then lets the
  // other one go; the first turn is consumer 0's
  auto my_turn = [&]() {
    if (PINGPONG) wg::named_sync(1 + cw, 256);
  };
  auto your_turn = [&](bool last) {
    if (PINGPONG && !(last && cw == 1)) wg::named_arrive(2 - cw, 256);
  };
  if (PINGPONG && cw == 1) wg::named_arrive(1, 256);

  wg::mbar_wait(qbar, 0);
  if (nw > 0) {
    wait_full(0);
    my_turn();
    issue_scores(sc, qslab, stage(0));
    your_turn(false);
    wg::wgmma_wait<0>();
    wg::fence_regs(sc);
    tile_softmax(sc, m, l, corr, 0, edge(0), r0, r1, t, T, causal, scale_log2);
    pack_p(pa, sc);
  }
  for (int n = 1; n < nw; ++n) {
    // tile n's scores and tile n - 1's P.V go to the tensor cores together;
    // tile n's softmax runs while P.V does
    wait_full(n);
    my_turn();
    issue_scores(sc, qslab, stage(n));
    issue_pv(o, pa, stage(n - 1) + 2 * PANEL_KV);
    your_turn(false);
    wg::wgmma_wait<1>();
    wg::fence_regs(sc);
    tile_softmax(sc, m, l, corr, n * BN, edge(n), r0, r1, t, T, causal, scale_log2);
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
    release(n - 1);
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    }
    pack_p(pa, sc);
  }
  if (nw > 0) {
    my_turn();
    issue_pv(o, pa, stage(nw - 1) + 2 * PANEL_KV);
    your_turn(true);
    wg::wgmma_wait<0>();
    wg::fence_regs(o);
    release(nw - 1);
  }
  for (int n = nw; n < ntiles; ++n) {  // tiles past this warpgroup's rows
    wait_full(n);
    release(n);
  }

  float l0 = l[0], l1 = l[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + ((i64)(b * S + r0) * H + h) * D + c) =
          pack_bf16(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + ((i64)(b * S + r1) * H + h) * D + c) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// Encoded tensor maps of recent calls.  A map depends only on the address,
// extents, strides and box it was encoded from, so an entry that matches
// them is exact; encoding costs microseconds of host time a call, where a
// prefill's layers and a benchmark's repeats reuse their buffers.
struct MapCache {
  struct Entry {
    uint64_t key[9];
    CUtensorMap map;
  };
  static constexpr int N = 64;
  Entry e[N];
  int used = 0, next = 0;
  std::mutex mu;

  bool get(CUtensorMap* map, const void* base, const uint64_t dims[4], const uint64_t st[3],
           uint32_t rows) {
    const uint64_t key[9] = {(uint64_t)(uintptr_t)base, dims[1], dims[2], dims[3],
                             st[0], st[1], st[2], rows, dims[0]};
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i)
      if (memcmp(e[i].key, key, sizeof(key)) == 0) {
        *map = e[i].map;
        return true;
      }
    if (!wg::bf16_map_4d(map, base, dims, st, rows)) return false;
    Entry& slot = e[next];
    memcpy(slot.key, key, sizeof(key));
    slot.map = *map;
    next = (next + 1) % N;
    used = used < N ? used + 1 : N;
    return true;
  }
};

constexpr int kMaxDevices = 64;

cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S,
                         int T, int H, int KV, Strides qs, Strides ks_, Strides vs_, int causal,
                         float scale, cudaStream_t stream) {
  static MapCache maps;
  CUtensorMap tq, tk, tv;
  const uint64_t qd[4] = {128, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t kd[4] = {128, (uint64_t)KV, (uint64_t)T, (uint64_t)B};
  const uint64_t qst[3] = {(uint64_t)qs.h * 2, (uint64_t)qs.s * 2, (uint64_t)qs.b * 2};
  const uint64_t kst[3] = {(uint64_t)ks_.h * 2, (uint64_t)ks_.s * 2, (uint64_t)ks_.b * 2};
  const uint64_t vst[3] = {(uint64_t)vs_.h * 2, (uint64_t)vs_.s * 2, (uint64_t)vs_.b * 2};
  if (!maps.get(&tq, q, qd, qst, w::BM) || !maps.get(&tk, k, kd, kst, w::BN) ||
      !maps.get(&tv, v, kd, vst, w::BN))
    return cudaErrorInvalidValue;
  // A function attribute belongs to the current device's context: it is set
  // once for each device the kernel is launched on.  (The tensor maps need
  // no such key: a map is a function of the address, extents, strides and
  // box alone, and device addresses are unique within a process.)
  static std::atomic<bool> configured[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(flash_attention_fwd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, w::SMEM);
    if (err != cudaSuccess) return err;
    configured[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((unsigned)(B * H), (unsigned)((S + w::BM - 1) / w::BM));
  flash_attention_fwd_wgmma_kernel<<<grid, 384, w::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, T, H, H / KV, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
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
  // channels per lane: lane + 32 * cc, those < D (D 112: 4, the last of
  // them on lanes 0-15 only)
  constexpr int CL = (D + 31) / 32;
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
      const int c = lane + 32 * cc;
      qr[i][cc] = rows[i] < S && c < D ? qb[rows[i] * qs.s + c] : 0.f;
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
        for (int cc = 0; cc < CL; ++cc)
          if (lane + 32 * cc < D) d = fmaf(qr[i][cc], ks[kk][lane + 32 * cc], d);
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
          if (lane + 32 * cc < D)
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
    for (int cc = 0; cc < CL; ++cc)
      if (lane + 32 * cc < D) out[off + lane + 32 * cc] = acc[i][cc] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int T, int H, int G, Strides qs, Strides ks_, Strides vs_, int causal,
                   int dtype, float scale, cudaStream_t stream) {
  if (dtype == 1) {
    if constexpr (D == 128) {
      return launch_wgmma(q, k, v, out, B, S, T, H, H / G, qs, ks_, vs_, causal, scale, stream);
    } else {
      const dim3 grid((unsigned)(B * H), (unsigned)((S + MQ - 1) / MQ));
      flash_attention_fwd_mma_kernel<D><<<grid, 128, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, T, H, G,
          qs, ks_, vs_, causal, scale);
    }
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

// dtype codes: 0 = float32, 1 = bfloat16.  `a` holds 21 int64 values: the
// base pointers of q, k, v and out, then B, S, T, H, KV, D, the (batch,
// position, head) strides of q, k and v in elements (the last dim
// contiguous; out is a contiguous (B, S, H, D) tensor), causal and dtype.
// One array rather than 21 arguments: a prefill launches this once a layer,
// and each argument costs the caller host time.  Returns the cudaError_t of
// the launch (0 = success).
extern "C" int flash_attention_fwd(const i64* a, float scale, void* stream) {
  const void *q = (const void*)a[0], *k = (const void*)a[1], *v = (const void*)a[2];
  void* out = (void*)a[3];
  const int B = (int)a[4], S = (int)a[5], T = (int)a[6], H = (int)a[7], KV = (int)a[8],
            D = (int)a[9], causal = (int)a[19], dtype = (int)a[20];
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{a[10], a[11], a[12]}, ks_{a[13], a[14], a[15]}, vs_{a[16], a[17], a[18]};
  const int G = H / KV;
  switch (D) {
    case 32: return (int)launch<32>(q, k, v, out, B, S, T, H, G, qs, ks_, vs_, causal, dtype, scale, st);
    case 64: return (int)launch<64>(q, k, v, out, B, S, T, H, G, qs, ks_, vs_, causal, dtype, scale, st);
    case 112: return (int)launch<112>(q, k, v, out, B, S, T, H, G, qs, ks_, vs_, causal, dtype, scale, st);
    case 128: return (int)launch<128>(q, k, v, out, B, S, T, H, G, qs, ks_, vs_, causal, dtype, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
