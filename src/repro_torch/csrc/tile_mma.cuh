// Tensor-core tile GEMM pieces shared by the triangle-multiplicative kernels
// (K3 in triangle_mult_fwd.cu, K5 in triangle_mult_bwd.cu).
//
// One block of 8 warps computes a 128 x 64 fp32 tile C = sum_k A[m][k]
// B[k][n] with bf16 mma.sync m16n8k16 (fp32 accumulation); each warp owns
// 32 x 32.  The operands are re-read from L2 by the blocks that share them,
// so the tile's area per loaded byte (43 operations a byte) sets the rate.
// The operands stream through shared memory in 32-deep k-steps, a 3-stage
// ring filled by cp.async (16 bytes a copy, zero-filled where the source
// lies outside the operand), so two k-steps' copies are in flight while the
// tensor cores work on a third.  Fragments come from ldmatrix: A is staged
// [m][k] (k contiguous, ldmatrix) or [k][m] (m contiguous, ldmatrix.trans);
// B either [k][n] (n contiguous, ldmatrix.trans) or [n][k] (k contiguous,
// ldmatrix).  Rows are padded by 16 bytes, so the 8
// row reads of each ldmatrix phase hit distinct banks.
//
// Split precision.  An fp32 operand v is staged as two bf16 tiles, hi =
// bf16(v) and lo = bf16(v - hi), and the product is hi*hi' + hi*lo' + lo*hi'
// (the lo*lo' term, ~2^-16 relative, is dropped): about 16 bits of each
// operand's mantissa, against 8 for a single bf16.  A bf16 operand is its
// own hi.  Every product of two bf16 values is exact in the fp32
// accumulator.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

using bf16 = __nv_bfloat16;
typedef long long i64;

constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3, THREADS = 256;
constexpr int PAD = 128;  // padded extents are multiples of BM and BN
constexpr int LDA = BK + 8;     // A stage tile [BM][LDA]
constexpr int LDA_KM = BM + 8;  // or [BK][LDA_KM]
constexpr int LDB_KN = BN + 8;  // B stage tile [BK][LDB_KN]
constexpr int LDB_NK = BK + 8;  // B stage tile [BN][LDB_NK]
constexpr int A_ELEMS = BM * LDA;
static_assert(BK * LDA_KM <= A_ELEMS, "a [k][m] A tile fits an A stage");
constexpr int B_ELEMS = BK * LDB_KN > BN * LDB_NK ? BK * LDB_KN : BN * LDB_NK;
// A stage holds A's hi tile, its lo tile if A is split, then B's likewise.
template <bool A_LO, bool B_LO>
__host__ __device__ constexpr int stage_elems() {
  return (A_LO ? 2 : 1) * A_ELEMS + (B_LO ? 2 : 1) * B_ELEMS;
}
template <bool A_LO, bool B_LO>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_elems<A_LO, B_LO>() * (int)sizeof(bf16);
}

// Dynamic shared memory above 48 KB, and the largest shared-memory carveout,
// so that as many blocks fit an SM as their shared memory allows.
inline cudaError_t configure(const void* kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Eight fp32 values (a, b) as eight bf16 hi values and eight lo values.
__device__ __forceinline__ void split8(const float4& a, const float4& b, uint4& hi, uint4& lo) {
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bf16 h0, l0, h1, l1;
    split_bf16(x[2 * q], h0, l0);
    split_bf16(x[2 * q + 1], h1, l1);
    __nv_bfloat162 hp = __halves2bfloat162(h0, h1), lp = __halves2bfloat162(l0, l1);
    h[q] = *reinterpret_cast<uint32_t*>(&hp);
    l[q] = *reinterpret_cast<uint32_t*>(&lp);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a valid address: pass the operand's base).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.  Without .trans lane (g, t) = (l / 4, l % 4) gets (row g, cols 2t,
// 2t+1) of each; with .trans (rows 2t, 2t+1, col g).
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

// d += a (16x16, row-major) * b (16x8, col-major), bf16 in, fp32 accumulate.
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 m x 16 k fragment of a [m][k] tile (row stride ld elements)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, t + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 + (lane >> 4) * 8);
}

// The same fragment of a [k][m] tile (m contiguous), through ldmatrix.trans:
// matrix j of the four is (k0 + 8 (j >> 1), m0 + 8 (j & 1)).
__device__ __forceinline__ void frag_a_km(uint32_t (&a)[4], const bf16* t, int ld, int m0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(a, t + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + m0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-wide n-tiles (n0, n0 + 8) x 16 k: b[0] for n0, b[1]
// for n0 + 8.  KN: the tile is [k][n]; otherwise [n][k].
template <bool KN>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[2][2], const bf16* t, int ld, int n0,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  if (KN)
    ldsm_x4_trans(r, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
  else
    ldsm_x4(r, t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

struct Stage {
  bf16 *a_hi, *a_lo, *b_hi, *b_lo;
};

template <bool A_LO, bool B_LO>
__device__ __forceinline__ Stage stage_at(bf16* base, int s) {
  bf16* p = base + s * stage_elems<A_LO, B_LO>();
  bf16* b = p + (A_LO ? 2 : 1) * A_ELEMS;
  return {p, A_LO ? p + A_ELEMS : nullptr, b, B_LO ? b + B_ELEMS : nullptr};
}

// Stage loaders: src(row, col, ok) returns the global address of the 8
// elements at (row, col .. col + 7) of the tile and sets ok (false: zeros).
template <class Src>
__device__ __forceinline__ void load_a(bf16* dst, Src src) {
  for (int e = threadIdx.x; e < BM * (BK / 8); e += THREADS) {
    const int r = e / (BK / 8), kc = (e % (BK / 8)) * 8;
    bool ok;
    const bf16* p = src(r, kc, ok);
    cp16(dst + r * LDA + kc, p, ok);
  }
}
template <class Src>
__device__ __forceinline__ void load_a_km(bf16* dst, Src src) {
  for (int e = threadIdx.x; e < BK * (BM / 8); e += THREADS) {
    const int kr = e / (BM / 8), mc = (e % (BM / 8)) * 8;
    bool ok;
    const bf16* p = src(kr, mc, ok);
    cp16(dst + kr * LDA_KM + mc, p, ok);
  }
}
template <class Src>
__device__ __forceinline__ void load_b_kn(bf16* dst, Src src) {
  for (int e = threadIdx.x; e < BK * (BN / 8); e += THREADS) {
    const int kr = e / (BN / 8), nc = (e % (BN / 8)) * 8;
    bool ok;
    const bf16* p = src(kr, nc, ok);
    cp16(dst + kr * LDB_KN + nc, p, ok);
  }
}
template <class Src>
__device__ __forceinline__ void load_b_nk(bf16* dst, Src src) {
  for (int e = threadIdx.x; e < BN * (BK / 8); e += THREADS) {
    const int n = e / (BK / 8), kc = (e % (BK / 8)) * 8;
    bool ok;
    const bf16* p = src(n, kc, ok);
    cp16(dst + n * LDB_NK + kc, p, ok);
  }
}

// acc[mt][nt][e]: warp rows wm*32 + mt*16 + g (+8 for e >= 2), cols wn*32 +
// nt*8 + 2t + (e & 1), with (wm, wn) = (warp & 3, warp >> 2).
typedef float Acc[2][4][4];

struct Frag {  // this thread's place in the block tile
  int wm, wn, g, t;
  __device__ __forceinline__ Frag() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    wm = warp & 3;
    wn = warp >> 2;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ __forceinline__ int row(int mt, int e) const {
    return wm * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
  }
  __device__ __forceinline__ int col(int nt, int e) const { return wn * 32 + nt * 8 + 2 * t + (e & 1); }
};

// A_KM: A's stage tile is [k][m] (load_a_km), else [m][k] (load_a).
template <bool A_LO, bool B_LO, bool B_KN, bool A_KM = false>
__device__ __forceinline__ void mma_stage(const Stage& st, Acc& acc) {
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * 32;
  const int ldb = B_KN ? LDB_KN : LDB_NK;
  constexpr int KS = BK / 16;
  // every fragment of the stage first, then the products: no product waits
  // on the ldmatrix just before it
  uint32_t ah[KS][2][4], al[KS][2][4], bh[KS][4][2], bl[KS][4][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (A_KM) {
        frag_a_km(ah[ks][mt], st.a_hi, LDA_KM, m0 + mt * 16, ks * 16);
        if (A_LO) frag_a_km(al[ks][mt], st.a_lo, LDA_KM, m0 + mt * 16, ks * 16);
      } else {
        frag_a(ah[ks][mt], st.a_hi, LDA, m0 + mt * 16, ks * 16);
        if (A_LO) frag_a(al[ks][mt], st.a_lo, LDA, m0 + mt * 16, ks * 16);
      }
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      frag_b2<B_KN>(*reinterpret_cast<uint32_t(*)[2][2]>(&bh[ks][2 * np]), st.b_hi, ldb,
                    n0 + np * 16, ks * 16);
      if (B_LO)
        frag_b2<B_KN>(*reinterpret_cast<uint32_t(*)[2][2]>(&bl[ks][2 * np]), st.b_lo, ldb,
                      n0 + np * 16, ks * 16);
    }
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    // term by term, so that consecutive products feed different accumulators
    if (A_LO)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], al[ks][mt], bh[ks][nt][0], bh[ks][nt][1]);
    if (B_LO)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], ah[ks][mt], bl[ks][nt][0], bl[ks][nt][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma16816(acc[mt][nt], ah[ks][mt], bh[ks][nt][0], bh[ks][nt][1]);
  }
}

// The k loop: nk k-steps of BK through the STAGES-deep ring.  load(stage,
// ks) issues the cp.async copies of k-step ks into `stage`.  Ends with every
// copy landed and the block synchronised, so the epilogue may reuse smem.
template <bool A_LO, bool B_LO, bool B_KN, bool A_KM = false, class Load>
__device__ __forceinline__ void mainloop(bf16* smem, int nk, Load&& load, Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(stage_at<A_LO, B_LO>(smem, s), s);
    cp_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // k-step `it` landed; k-step it - 1's stage is free
    const int nx = it + STAGES - 1;
    if (nx < nk) load(stage_at<A_LO, B_LO>(smem, nx % STAGES), nx);
    cp_commit();
    mma_stage<A_LO, B_LO, B_KN, A_KM>(stage_at<A_LO, B_LO>(smem, it % STAGES), acc);
  }
  cp_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Gated projections of one or two operand sides, on the tensor cores
// ---------------------------------------------------------------------------

// What the projection writes, tile-major over the padded pair space (Ri x
// Rk): tiles of PM pairs (one i, PM consecutive k), in each tile channel
// after channel (tm_index), so that a tile's outputs are one contiguous
// block.
enum ProjMode {
  PROJ_BF16 = 0,   // sigmoid(gate) * value * kmask[k], bf16, zero in the pads (K3's a, b)
  PROJ_SPLIT = 1,  // sigmoid(gate) * value as an fp32 hi/lo bf16 pair, zero in the pads
  PROJ_PREACT = 2  // the fp32 pre-activations: value to out0[ch], gate to out0[c + ch]
};

struct ProjSide {
  const bf16* x;   // (ri, rk, cz), row (i, k) at x + i * si + k * sk
  i64 si, sk;
  int ri, Ri;      // rows, padded to a multiple of 64
  const bf16* w;   // (cz, 2c) packed [value | gate]
  const bf16* bias;
  const float* kmask;  // PROJ_BF16 only; may be null
  int mode;
  void* out0;
  void* out1;
};

// Persistent over 64-row tiles of side blockIdx.y's padded pair space
// (Rk % 64 == 0: a tile lies in one i).  The side's W stays in shared
// memory, its columns permuted so that each group of 32 holds 16 value
// channels and the same 16 gate channels: a warp's accumulator holds both,
// and the gate is an epilogue in registers.  The next tile's x rows are
// copied in (cp.async) while this one computes.  8 warps: 2 x 32 rows by 4
// strides over the c / 16 column groups.  c % 16 == 0, cz % 16 == 0, x's
// rows 16-byte aligned.  Dynamic shared memory: proj_smem(cz, c).
constexpr int PM = 64, PROJ_THREADS = 256;

// Element (i, k, ch) of a tile-major (Ri, Rk, C) array (Rk % PM == 0): the
// PM consecutive k of one (i, ch) are contiguous.
__host__ __device__ __forceinline__ i64 tm_index(int i, int k, int ch, int Rk, int C) {
  return (((i64)i * (Rk / PM) + k / PM) * C + ch) * PM + k % PM;
}
constexpr int STG = 36;  // staging row: 32 rows of one channel (+4 against bank conflicts)

inline int proj_smem(int cz, int c) {
  return ((2 * c + 8) * cz + 2 * PM * (cz + 8)) * 2 + PROJ_THREADS / 32 * 8 * STG * 4;
}

// One warp's 32 rows x 8 channels, thread (g, t) holding v[mt][h][e] of row
// mt*16 + g + 8h, channel 2t + e, written channel after channel through the
// warp's staging buffer: each lane stores 8 consecutive rows of one
// channel, so a warp writes whole 32-byte sectors.  out[0] + base is
// (channel 0, row 0); channels lie `plane` elements apart.  PROJ_SPLIT writes hi to out0 and lo
// to out1; PROJ_PREACT writes fp32.
__device__ __forceinline__ void warp_store(float* stg, const float (&v)[2][2][2], int mode,
                                           void* out0, void* out1, i64 base, i64 plane) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) stg[(2 * t + e) * STG + mt * 16 + g + 8 * h] = v[mt][h][e];
  __syncwarp();
  const float* src = stg + (lane >> 2) * STG + (lane & 3) * 8;
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  const i64 o = base + (lane >> 2) * plane + (lane & 3) * 8;
  if (mode == PROJ_PREACT) {
    float* out = static_cast<float*>(out0) + o;
    *reinterpret_cast<float4*>(out) = a;
    *reinterpret_cast<float4*>(out + 4) = b;
    return;
  }
  uint4 hi, lo;
  split8(a, b, hi, lo);
  *reinterpret_cast<uint4*>(static_cast<bf16*>(out0) + o) = hi;
  if (mode == PROJ_SPLIT) *reinterpret_cast<uint4*>(static_cast<bf16*>(out1) + o) = lo;
}

__device__ __forceinline__ void proj_body(const ProjSide& s0, const ProjSide& s1, int rk,
                                          int Rk, int cz, int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ProjSide s = blockIdx.y ? s1 : s0;
  const int c2 = 2 * c, ldw = c2 + 8, ldx = cz + 8;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [cz][ldw]
  bf16* xs = ws + cz * ldw;                      // [2][PM][ldx]
  float* stg = reinterpret_cast<float*>(xs + 2 * PM * ldx) + (threadIdx.x >> 5) * 8 * STG;
  const int tiles = (int)((i64)s.Ri * Rk / PM);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  for (int e = tid; e < cz * (c2 / 8); e += PROJ_THREADS) {
    const int z = e / (c2 / 8), pn = (e % (c2 / 8)) * 8, grp = pn >> 5, w = pn & 31;
    const int col = w < 16 ? grp * 16 + w : c + grp * 16 + w - 16;
    cp16(ws + z * ldw + pn, s.w + (i64)z * c2 + col, true);
  }
  auto issue = [&](int tl, int buf) {
    const i64 m0 = (i64)tl * PM;
    const int i = (int)(m0 / Rk), k0 = (int)(m0 - (i64)i * Rk);
    const bf16* xi = s.x + (i64)i * s.si;
    bf16* d = xs + buf * PM * ldx;
    for (int e = tid; e < PM * (cz / 8); e += PROJ_THREADS) {
      const int r = e / (cz / 8), z = (e % (cz / 8)) * 8, k = k0 + r;
      const bool ok = i < s.ri && k < rk;
      cp16(d + r * ldx + z, ok ? xi + (i64)k * s.sk + z : s.x, ok);
    }
  };
  if ((int)blockIdx.x < tiles) issue(blockIdx.x, 0);
  cp_commit();
  int buf = 0;
  for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x, buf ^= 1) {
    if (tl + (int)gridDim.x < tiles) issue(tl + gridDim.x, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // this tile's x (and W) landed
    const bf16* xt = xs + buf * PM * ldx;
    const i64 m0 = (i64)tl * PM;
    const int i = (int)(m0 / Rk), k0 = (int)(m0 - (i64)i * Rk);
    for (int grp = wn; grp < c / 16; grp += PROJ_THREADS / 64) {
      float acc[2][4][4] = {};
      // fragments of k-step kk + 16 are loaded while kk's products run
      uint32_t a[2][2][4], b[2][2][2][2];
      auto frags = [&](int q, int kk) {
        frag_a(a[q][0], xt, ldx, wm * 32, kk);
        frag_a(a[q][1], xt, ldx, wm * 32 + 16, kk);
        frag_b2<true>(b[q][0], ws, ldw, grp * 32, kk);       // value channels
        frag_b2<true>(b[q][1], ws, ldw, grp * 32 + 16, kk);  // their gates
      };
      auto products = [&](int q) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma16816(acc[mt][nt], a[q][mt], b[q][nt >> 1][nt & 1][0], b[q][nt >> 1][nt & 1][1]);
      };
      frags(0, 0);
      for (int kk = 0; kk < cz; kk += 32) {
        if (kk + 16 < cz) frags(1, kk + 16);
        products(0);
        if (kk + 16 >= cz) break;
        if (kk + 32 < cz) frags(0, kk + 32);
        products(1);
      }
      // every load before the first store: the outputs may alias the
      // inputs as far as the compiler knows
      float bv[2][2], bgt[2][2], scale[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = grp * 16 + nt * 8 + 2 * t + e;
          bv[nt][e] = __bfloat162float(s.bias[ch]);
          bgt[nt][e] = __bfloat162float(s.bias[c + ch]);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + wm * 32 + mt * 16 + g + 8 * h;
          const bool valid = i < s.ri && k < rk;
          scale[mt][h] = !valid ? 0.f : (s.kmask != nullptr ? s.kmask[k] : 1.f);
        }
      const int C = s.mode == PROJ_PREACT ? 2 * c : c;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float v[2][2][2], gt[2][2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[mt][h][e] = acc[mt][nt][2 * h + e] + bv[nt][e];
              gt[mt][h][e] = acc[mt][nt + 2][2 * h + e] + bgt[nt][e];
              // zero in the pads; PROJ_BF16 scales by k_mask in fp32
              if (s.mode != PROJ_PREACT)
                v[mt][h][e] = sigmoid_f(gt[mt][h][e]) * v[mt][h][e] * scale[mt][h];
            }
        const i64 base = ((i64)tl * C + grp * 16 + nt * 8) * PM + wm * 32;
        warp_store(stg, v, s.mode, s.out0, s.out1, base, PM);
        if (s.mode == PROJ_PREACT)
          warp_store(stg, gt, s.mode, s.out0, s.out1, base + (i64)c * PM, PM);
      }
    }
    __syncthreads();  // the next iteration copies into this tile's buffer
  }
  cp_wait<0>();
}

}  // namespace tile
