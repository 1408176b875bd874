// Evoformer gated-bias attention, forward (kernel K1 of the port).
//
// Replaces: src/repro/kernels/flash_attention.py::evo_attention_fwd
// (Pallas body `_evo_kernel`), reached through kernels/ops.py::evo_attention
// and ::evo_attention_nobias.
//
// Computes, per lead row l, head h and query i, over keys j < S:
//     o[l,i,h,:] = sigmoid(gate[l,i,h,:]) * sum_j p_ij v[l,j,h,:]
//     p_ij       = softmax_j(q[l,i,h,:].k[l,j,h,:] * scale + bias[h,i,j])
// with q/k/v/gate/o laid out (L, S, H, C) and the bias (H, S, S) shared by
// all L rows.  bias and gate are optional (null pointers compile nothing
// away, they are uniform branches).
//
// What bounds it on the H100: at the serving shapes (S 128..256, C 8..32)
// a call does 4*L*H*S^2*C operations on 5*L*S*H*C*2 bytes of q/k/v/gate/out
// plus the bias: ~S/5 operations per byte, below the card's ~295 bf16
// operations per byte, so the least time is set by the bytes.  What a
// kernel without the tensor cores actually hits is the operations: on the
// fp32 CUDA cores (67 TFLOP/s) the same work takes ~15x the byte time.
//
// Design: the Pallas kernel keeps a whole (S, C) K/V row resident in VMEM.
// Here K/V stream through shared memory in key tiles with an fp32 online
// softmax (running max m, sum l, accumulator) per query row.
//  * bf16 inputs (serving and training): tensor cores, the ring kernel.
//    Per (lead row, head) the work is small (S <= 256 keys of C <= 32), so
//    what bounds it is not the bytes but issue and latency: a few warps an
//    SM sub-partition each run a dependent chain per key tile (Q.K^T,
//    softmax, P.V) between block barriers.  The design keeps that chain
//    short and the loads off it.  A block of 4 warps owns one head, 64
//    queries and a chunk of lead rows, as short as lets one wave of
//    resident blocks (the occupancy the runtime reports for the launch)
//    cover the grid, so no partial last wave idles the card.  Its bias
//    rows (64 x S in the bias's own type, up to S 256) are copied once by
//    cp.async and stay in shared memory for the whole chunk; K/V of each
//    lead row stream in 64-key tiles through a 4-stage cp.async ring that
//    runs across lead rows, so the next row's first tiles arrive while
//    this row computes, and Q and gate fragments are loaded a row ahead.
//    Each thread's copies are fixed slots (no divisions, no per-tile
//    address arithmetic beyond one offset).  V stays key-major: its B
//    fragments come from ldmatrix.trans.  Past S 256 the bias tile of each
//    key tile rides in its ring stage instead.  Softmax in base 2: the
//    running max is over the raw logits and p = 2^(v*c1 - m*c1), one FFMA
//    and one ex2.approx an element.  C 4 and 8 take mma m16n8k8 for
//    Q.K^T (no zero-padded k); P.V is m16n8k16.  Shared memory at S 256,
//    C 32: fp32 bias 66 KB + ring 40 KB, two blocks (8 warps) an SM; bf16
//    bias 34 KB + 40 KB, three; no bias, four (128 registers).
//  * fp32 inputs: the exact path on the fp32 CUDA cores; one thread per
//    query row keeps q and the accumulator in registers, and the bias tile
//    goes through shared memory so its global reads stay coalesced.
// Ragged S is handled by masking: rows past S are not written and keys past
// S get probability 0.  The output is written in q's type.  When `lse` is
// not null (autograd needs the backward), each row's fp32 log-sum-exp
// m + log(l), laid out (L*H, S), is written too: the residual that K2
// (csrc/evo_attention_bwd.cu) recomputes the probabilities from.  Without a
// gradient the pointer is null and the launch is the serving one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int BQ = 128;  // query rows per block = threads per block
constexpr int BK = 32;   // keys per shared-memory tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename BT, int C>
__global__ void __launch_bounds__(BQ)
evo_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const BT* __restrict__ bias,
                         const T* __restrict__ gate, T* __restrict__ out,
                         float* __restrict__ lse, int S, int H, float scale) {
  __shared__ __align__(16) float ks[BK][C];
  __shared__ __align__(16) float vs[BK][C];
  __shared__ float bs[BQ][BK + 1];  // +1: row reads by thread stay conflict-free

  const int lh = blockIdx.x;  // l * H + h
  const int l = lh / H;
  const int h = lh - l * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int i = q0 + tid;
  const bool row_ok = i < S;
  const size_t row_stride = (size_t)H * C;  // between consecutive positions
  const size_t base = (size_t)l * S * row_stride + (size_t)h * C;
  const size_t my_off = base + (size_t)i * row_stride;

  float qr[C];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = row_ok ? to_f(q[my_off + c]) * scale : 0.f;
    acc[c] = 0.f;
  }
  float m = -1e30f;
  float lsum = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * C; e += BQ) {
      const int kk = e / C;
      const int c = e - kk * C;
      const int j = k0 + kk;
      float kv = 0.f, vv = 0.f;
      if (j < S) {
        const size_t off = base + (size_t)j * row_stride + c;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[kk][c] = kv;
      vs[kk][c] = vv;
    }
    if (bias != nullptr) {
      const BT* bh = bias + (size_t)h * S * S;
      for (int e = tid; e < BQ * BK; e += BQ) {
        const int r = e / BK;
        const int cc = e - r * BK;
        const int ii = q0 + r;
        const int j = k0 + cc;
        bs[r][cc] = (ii < S && j < S) ? to_f(bh[(size_t)ii * S + j]) : 0.f;
      }
    }
    __syncthreads();
    if (!row_ok) continue;

    float sc[BK];
    float m_new = m;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[kk][c]);
        d = fmaf(qr[c], k4.x, d);
        d = fmaf(qr[c + 1], k4.y, d);
        d = fmaf(qr[c + 2], k4.z, d);
        d = fmaf(qr[c + 3], k4.w, d);
      }
      if (bias != nullptr) d += bs[tid][kk];
      sc[kk] = d;
      if (k0 + kk < S) m_new = fmaxf(m_new, d);
    }
    const float corr = expf(m - m_new);
    lsum *= corr;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] *= corr;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float p = (k0 + kk < S) ? expf(sc[kk] - m_new) : 0.f;
      lsum += p;
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[kk][c]);
        acc[c] = fmaf(p, v4.x, acc[c]);
        acc[c + 1] = fmaf(p, v4.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, v4.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, v4.w, acc[c + 3]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  if (lse != nullptr) lse[(size_t)lh * S + i] = m + logf(fmaxf(lsum, 1e-30f));
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float o = acc[c] * inv;
    if (gate != nullptr) o *= 1.f / (1.f + expf(-to_f(gate[my_off + c])));
    out[my_off + c] = from_f<T>(o);
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores (mma.sync, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int TQ = 64;    // query rows per block: 4 warps x 16
constexpr int TK = 64;    // keys per ring stage
constexpr int NST = 4;    // ring stages: three tiles in flight
constexpr int SRES = 256; // the longest S whose bias tile stays resident
constexpr int RING_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a (16x8, row-major) * b (8x8, col-major), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

// 8 bytes global -> shared, asynchronously (zero-filled when !valid)
__device__ __forceinline__ void cp8(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}

// Row pitch (elements) of a K or V stage tile [TK][LDK]: 16 bytes of
// padding (48-byte rows at CP 8), so ldmatrix's 8 row reads hit distinct
// banks.  A bias tile row is padded by 32 bytes, so the float2 / bf16x2
// reads of 4 rows by 4 threads do.
template <int CP>
__host__ __device__ constexpr int ring_ldk() { return CP == 8 ? 24 : CP + 8; }
template <typename BT>
__host__ __device__ constexpr int bias_pad() { return 32 / (int)sizeof(BT); }
template <typename BT, int CP, bool RES>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * TK * ring_ldk<CP>() * 2 + (RES ? 0 : TQ * (TK + bias_pad<BT>()) * (int)sizeof(BT));
}

__device__ __forceinline__ float2 bias_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A block owns head h = blockIdx.y, the query tile of TQ rows at q0 =
// blockIdx.x * TQ, and lead rows [l0, l0 + lch).  It walks the tiles (l,
// key tile) of its rows in order through a ring of NST stages filled by
// cp.async, so the next lead row's K/V arrive while this one computes.
// RES: the block's bias rows (TQ x S, in the bias's own type) are loaded
// once and read from shared memory for every lead row; otherwise each stage
// also carries the TQ x TK bias tile of its keys.  `bp` is the resident
// tile's row pitch (0 without a bias or without RES); `bias_async`: the bias
// rows are 16-byte aligned (else they are copied by plain loads).
// Online softmax in base 2 over the raw logits v (v = q.k with no bias, v =
// q.k * scale + bias with one), p = 2^(v * c1 - m * c1) (one FFMA and one
// ex2.approx an element, c1 = scale * log2 e or log2 e), p rounded to bf16
// for P.V as the Pallas kernel casts p to v's type, the row sum over the
// fp32 p.  CP: the head dim padded to 8, 16 or 32 (C 4 and 8 take
// m16n8k8 products for Q.K^T).
template <typename BT, int CP, bool RES>
__global__ void __launch_bounds__(RING_THREADS, 4)  // <= 128 registers: 4 blocks an SM without a bias
evo_attention_fwd_ring_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, const BT* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ gate,
                              __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int L,
                              int S, int H, int C, int lch, int bp, int bias_async,
                              float scale) {
  using bf16 = __nv_bfloat16;
  using tile::i64;
  constexpr int LDK = ring_ldk<CP>(), KV = TK * LDK, BPR = TK + bias_pad<BT>();
  constexpr int STAGE = stage_bytes<BT, CP, RES>();
  constexpr int QR = CP >= 16 ? CP / 4 : 2;  // Q fragment registers
  constexpr int EPC = 16 / (int)sizeof(BT);  // bias elements a 16-byte copy
  constexpr int CPK = CP / 8;                // 16-byte copies a key row
  constexpr int KSTEP = RING_THREADS / CPK;  // keys between a thread's copies
  constexpr int NCOPY = (TK + KSTEP - 1) / KSTEP;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.x * TQ, h = blockIdx.y;
  const int l0 = blockIdx.z * lch, l1 = min(L, l0 + lch);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  BT* bres = reinterpret_cast<BT*>(smem_raw);             // [TQ][bp]
  unsigned char* ring = smem_raw + (i64)TQ * bp * sizeof(BT);
  const i64 rs = (i64)H * C;                              // between positions
  const i64 lstride = (i64)S * rs;                        // between lead rows
  const BT* bh = bias == nullptr ? nullptr : bias + (i64)h * S * S;
  const int nkt = (S + TK - 1) / TK, ntile = (l1 - l0) * nkt;

  if (C < CP) {  // pad channels: no copy writes them, zero them once
    for (int e = tid; e < NST * STAGE / 16; e += RING_THREADS)
      reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  if (RES && bh != nullptr) {
    if (bias_async) {
      const int cpr = S / EPC;
      for (int e = tid; e < TQ * cpr; e += RING_THREADS) {
        const int r = e / cpr, cc = (e - r * cpr) * EPC;
        const bool ok = q0 + r < S;
        tile::cp16(bres + r * bp + cc, ok ? bh + (i64)(q0 + r) * S + cc : bh, ok);
      }
    } else {
      for (int e = tid; e < TQ * S; e += RING_THREADS) {
        const int r = e / S, cc = e - r * S;
        bres[r * bp + cc] = q0 + r < S ? bh[(i64)(q0 + r) * S + cc] : BT(0.f);
      }
    }
  }
  tile::cp_commit();  // the resident bias (an empty group without one)

  // this thread's K/V copies: keys ckey + i * KSTEP, channels cch .. cch + 7
  const int ckey = tid / CPK, cch = (tid - ckey * CPK) * 8;
  const bf16* kh = k + (i64)h * C + cch;
  const bf16* vh = v + (i64)h * C + cch;
  int il = l0, ik0 = 0;  // the next tile to issue: lead row, first key
  auto issue = [&]() {
    if (il < l1) {
      unsigned char* st = ring + ((il - l0) * nkt + ik0 / TK) % NST * STAGE;
      bf16* ks = reinterpret_cast<bf16*>(st) + ckey * LDK + cch;
      const i64 lb = (i64)il * lstride;
#pragma unroll
      for (int i = 0; i < NCOPY; ++i) {
        const int key = ckey + i * KSTEP;
        if (key < TK) {
          const bool ok = ik0 + key < S;
          const i64 o = ok ? lb + (i64)(ik0 + key) * rs : 0;
          if (C >= 8) {
            tile::cp16(ks + i * KSTEP * LDK, kh + o, ok);
            tile::cp16(ks + KV + i * KSTEP * LDK, vh + o, ok);
          } else {  // C 4: 8 bytes a key
            cp8(ks + i * KSTEP * LDK, kh + o, ok);
            cp8(ks + KV + i * KSTEP * LDK, vh + o, ok);
          }
        }
      }
      if (!RES && bh != nullptr) {
        BT* bs = reinterpret_cast<BT*>(st + 2 * KV * 2);
        if (bias_async) {
          constexpr int cpr = TK / EPC;
          for (int e = tid; e < TQ * cpr; e += RING_THREADS) {
            const int r = e / cpr, cc = (e - r * cpr) * EPC;
            const bool ok = q0 + r < S && ik0 + cc < S;
            tile::cp16(bs + r * BPR + cc, ok ? bh + (i64)(q0 + r) * S + ik0 + cc : bh, ok);
          }
        } else {
          for (int e = tid; e < TQ * TK; e += RING_THREADS) {
            const int r = e / TK, cc = e - r * TK;
            bs[r * BPR + cc] =
                q0 + r < S && ik0 + cc < S ? bh[(i64)(q0 + r) * S + ik0 + cc] : BT(0.f);
          }
        }
      }
      if ((ik0 += TK) >= S) ik0 = 0, ++il;
    }
    tile::cp_commit();
  };
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) issue();

  const int lr0 = warp * 16 + g;                      // this thread's rows lr0, lr0 + 8
  const bool ok0 = q0 + lr0 < S, ok1 = q0 + lr0 + 8 < S;
  const i64 ro0 = (i64)(q0 + lr0) * rs + (i64)h * C + 2 * t, ro1 = ro0 + 8 * rs;
  const float c1 = bh != nullptr ? LOG2E : scale * LOG2E;
  const float u1 = bh != nullptr ? 1.f : scale;  // lse = m * u1 + log(sum)
  // 4 bytes (channels c, c + 1) at row offset ro of lead row base lb
  // 4 bytes (channels 2t + c, + 1) of row p, zero past S or C
  auto ld_pair = [&](const bf16* p, bool ok, int c) -> uint32_t {
    if (ok && (C == CP || 2 * t + c < C)) return *reinterpret_cast<const uint32_t*>(p + c);
    return 0u;
  };
  auto load_q = [&](int l, uint32_t(&dst)[QR]) {
    const bf16* p0 = q + (i64)l * lstride + ro0;
    const bf16* p1 = p0 + 8 * rs;
    if constexpr (CP >= 16) {
#pragma unroll
      for (int kc = 0; kc < CP / 16; ++kc) {
        dst[4 * kc] = ld_pair(p0, ok0, kc * 16);
        dst[4 * kc + 1] = ld_pair(p1, ok1, kc * 16);
        dst[4 * kc + 2] = ld_pair(p0, ok0, kc * 16 + 8);
        dst[4 * kc + 3] = ld_pair(p1, ok1, kc * 16 + 8);
      }
    } else {
      dst[0] = ld_pair(p0, ok0, 0);
      dst[1] = ld_pair(p1, ok1, 0);
    }
  };
  // the gate's fragments, in the accumulator's layout
  auto load_gate = [&](int l, uint32_t(&dst)[CP / 8][2]) {
    const bf16* p0 = gate + (i64)l * lstride + ro0;
    const bf16* p1 = p0 + 8 * rs;
#pragma unroll
    for (int ct = 0; ct < CP / 8; ++ct) {
      dst[ct][0] = ld_pair(p0, ok0, ct * 8);
      dst[ct][1] = ld_pair(p1, ok1, ct * 8);
    }
  };
  // this thread's bias rows (resident tile)
  const BT* brow0 = bres + lr0 * bp + 2 * t;
  const BT* brow1 = brow0 + 8 * bp;

  // Q and gate fragments of the next lead row are loaded a row ahead
  uint32_t qa[QR], qn[QR], gt[CP / 8][2], gn[CP / 8][2];
  float o[CP / 8][4], m[2], lsum[2];
  load_q(l0, qn);
  if (gate != nullptr) load_gate(l0, gn);
  int l = l0, k0 = 0;  // the tile computed now
  for (int j = 0; j < ntile; ++j) {
    tile::cp_wait<NST - 2>();
    __syncthreads();  // tile j landed; tile j - 1's stage is free
    issue();          // tile j + NST - 1
    if (k0 == 0) {    // a new lead row
#pragma unroll
      for (int i = 0; i < QR; ++i) qa[i] = qn[i];
#pragma unroll
      for (int ct = 0; ct < CP / 8; ++ct) gt[ct][0] = gn[ct][0], gt[ct][1] = gn[ct][1];
      if (l + 1 < l1) {  // they arrive while this row computes
        load_q(l + 1, qn);
        if (gate != nullptr) load_gate(l + 1, gn);
      }
#pragma unroll
      for (int ct = 0; ct < CP / 8; ++ct) o[ct][0] = o[ct][1] = o[ct][2] = o[ct][3] = 0.f;
      m[0] = m[1] = -1e30f;
      lsum[0] = lsum[1] = 0.f;
    }
    const unsigned char* st = ring + j % NST * STAGE;
    const bf16* ks = reinterpret_cast<const bf16*>(st);
    const bf16* vs = ks + KV;

    // scores: 16 rows x TK keys per warp
    float s[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (CP >= 16) {
#pragma unroll
      for (int kc = 0; kc < CP / 16; ++kc) {
        const uint32_t a[4] = {qa[4 * kc], qa[4 * kc + 1], qa[4 * kc + 2], qa[4 * kc + 3]};
#pragma unroll
        for (int np = 0; np < TK / 16; ++np) {
          uint32_t b[2][2];
          tile::frag_b2<false>(b, ks, LDK, np * 16, kc * 16);
          tile::mma16816(s[2 * np], a, b[0][0], b[0][1]);
          tile::mma16816(s[2 * np + 1], a, b[1][0], b[1][1]);
        }
      }
    } else {
#pragma unroll
      for (int nq = 0; nq < TK / 32; ++nq) {  // four 8-key n-tiles an ldmatrix
        uint32_t b[4];
        tile::ldsm_x4(b, ks + (nq * 32 + (lane & 7) + (lane >> 3) * 8) * LDK);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma1688(s[4 * nq + i], qa[0], qa[1], b[i]);
      }
    }

    // raw logits, the running max, the rescale of what came before
    if (bh != nullptr) {
      const BT* b0 = RES ? brow0 + k0
                         : reinterpret_cast<const BT*>(st + 2 * KV * 2) + lr0 * BPR + 2 * t;
      const BT* b1 = RES ? brow1 + k0 : b0 + 8 * BPR;
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) {
        const float2 x0 = bias_pair(b0 + nt * 8), x1 = bias_pair(b1 + nt * 8);
        s[nt][0] = fmaf(s[nt][0], scale, x0.x);
        s[nt][1] = fmaf(s[nt][1], scale, x0.y);
        s[nt][2] = fmaf(s[nt][2], scale, x1.x);
        s[nt][3] = fmaf(s[nt][3], scale, x1.y);
      }
    }
    if (k0 + TK > S) {  // the row's ragged last tile: keys past S get p = 0
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt) {
        const int key = k0 + nt * 8 + 2 * t;
        if (key >= S) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= S) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float corr = ex2((m[r] - mx[r]) * c1);
      m[r] = mx[r];
      mc[r] = mx[r] * c1;
      lsum[r] *= corr;
#pragma unroll
      for (int ct = 0; ct < CP / 8; ++ct) {
        o[ct][2 * r] *= corr;
        o[ct][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[nt][e], c1, -mc[e >> 1]));
        lsum[e >> 1] += p;
        s[nt][e] = p;
      }

    // O += P.V, 16 keys a k-step; the score fragments are P's A operand and
    // V's come from its key-major tile through ldmatrix.trans
#pragma unroll
    for (int kc = 0; kc < TK / 16; ++kc) {
      const uint32_t pa[4] = {tile::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              tile::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              tile::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              tile::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      if constexpr (CP >= 16) {
#pragma unroll
        for (int cp = 0; cp < CP / 16; ++cp) {
          uint32_t b[2][2];
          tile::frag_b2<true>(b, vs, LDK, cp * 16, kc * 16);
          tile::mma16816(o[2 * cp], pa, b[0][0], b[0][1]);
          tile::mma16816(o[2 * cp + 1], pa, b[1][0], b[1][1]);
        }
      } else {
        uint32_t b[2];
        ldsm_x2_trans(b, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK);
        tile::mma16816(o[0], pa, b[0], b[1]);
      }
    }

    if ((k0 += TK) >= S) {  // the row's last key tile: normalise, gate, write
      const i64 lb = (i64)l * lstride;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ls = lsum[r];
        ls += __shfl_xor_sync(FULL, ls, 1);
        ls += __shfl_xor_sync(FULL, ls, 2);
        if (!(r ? ok1 : ok0)) continue;
        ls = fmaxf(ls, 1e-30f);
        if (lse != nullptr && t == 0)
          lse[((i64)l * H + h) * S + q0 + lr0 + 8 * r] = m[r] * u1 + logf(ls);
        const float inv = __frcp_rn(ls);
        bf16* orow = out + lb + (r ? ro1 : ro0);
#pragma unroll
        for (int ct = 0; ct < CP / 8; ++ct) {
          if (C != CP && ct * 8 + 2 * t >= C) continue;
          float o0 = o[ct][2 * r] * inv, o1 = o[ct][2 * r + 1] * inv;
          if (gate != nullptr) {
            const float2 g2 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gt[ct][r]));
            o0 *= __frcp_rn(1.f + ex2(-g2.x * LOG2E));
            o1 *= __frcp_rn(1.f + ex2(-g2.y * LOG2E));
          }
          *reinterpret_cast<uint32_t*>(orow + ct * 8) = tile::pack_bf16(o0, o1);
        }
      }
      k0 = 0;
      ++l;
    }
  }
  tile::cp_wait<0>();
}

template <typename BT, int CP, bool RES>
cudaError_t launch_ring(const void* q, const void* k, const void* v, const void* bias,
                        const void* gate, void* out, float* lse, int L, int S, int H, int C,
                        float scale, cudaStream_t stream) {
  const int bp = RES && bias != nullptr ? tile::round_up(S, TK) + bias_pad<BT>() : 0;
  const int smem = TQ * bp * (int)sizeof(BT) + NST * stage_bytes<BT, CP, RES>();
  auto kernel = evo_attention_fwd_ring_kernel<BT, CP, RES>;
  cudaError_t err = tile::configure((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, RING_THREADS, smem)) !=
          cudaSuccess)
    return err;
  // lead rows a block: as few as let one wave of resident blocks cover the
  // grid, so no partial last wave idles the card
  const int qtiles = (S + TQ - 1) / TQ;
  const long long slots = (long long)nsm * (occ > 0 ? occ : 1);
  long long chunks = slots / ((long long)qtiles * H);  // chunks of lead rows a wave holds
  chunks = chunks < 1 ? 1 : (chunks > L ? L : chunks);
  const int lch = (int)((L + chunks - 1) / chunks);
  const int bias_async = bias != nullptr && (uintptr_t)bias % 16 == 0 &&
                         ((long long)S * sizeof(BT)) % 16 == 0;
  const dim3 grid((unsigned)qtiles, (unsigned)H, (unsigned)((L + lch - 1) / lch));
  kernel<<<grid, RING_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const BT*>(bias),
      static_cast<const __nv_bfloat16*>(gate), static_cast<__nv_bfloat16*>(out), lse, L, S, H,
      C, lch, bp, bias_async, scale);
  return cudaGetLastError();
}

template <typename BT, int CP>
cudaError_t launch_mma_cp(const void* q, const void* k, const void* v, const void* bias,
                          const void* gate, void* out, float* lse, int L, int S, int H, int C,
                          float scale, cudaStream_t stream) {
  if (bias != nullptr && S > SRES)
    return launch_ring<BT, CP, false>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, stream);
  return launch_ring<BT, CP, true>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, stream);
}

template <typename BT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* bias,
                       const void* gate, void* out, float* lse, int L, int S, int H, int C,
                       float scale, cudaStream_t stream) {
  if (C <= 8)
    return launch_mma_cp<BT, 8>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, stream);
  if (C <= 16)
    return launch_mma_cp<BT, 16>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, stream);
  if (C <= 32)
    return launch_mma_cp<BT, 32>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// fp32 inputs: the CUDA cores
// ---------------------------------------------------------------------------

template <typename T, typename BT, int C>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* gate, void* out, float* lse, int L, int S, int H, float scale,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)(L * H), (unsigned)((S + BQ - 1) / BQ));
  evo_attention_fwd_kernel<T, BT, C><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const BT*>(bias), static_cast<const T*>(gate), static_cast<T*>(out),
      lse, S, H, scale);
  return cudaGetLastError();
}

template <typename T, typename BT>
cudaError_t dispatch_c(const void* q, const void* k, const void* v, const void* bias,
                       const void* gate, void* out, float* lse, int L, int S, int H, int C,
                       float scale, cudaStream_t stream) {
  switch (C) {
    case 4: return launch<T, BT, 4>(q, k, v, bias, gate, out, lse, L, S, H, scale, stream);
    case 8: return launch<T, BT, 8>(q, k, v, bias, gate, out, lse, L, S, H, scale, stream);
    case 16: return launch<T, BT, 16>(q, k, v, bias, gate, out, lse, L, S, H, scale, stream);
    case 32: return launch<T, BT, 32>(q, k, v, bias, gate, out, lse, L, S, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  `bias`, `gate` and `lse` may be
// null; `lse`, when given, receives (L*H, S) fp32 log-sum-exps.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int evo_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* gate, void* out,
                                 void* lse_out, int L, int S, int H, int C, int dtype,
                                 int bias_dtype, float scale, void* stream) {
  if (L <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (dtype == 0 && bias_dtype == 0)
    return (int)dispatch_c<float, float>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, st);
  if (dtype == 0 && bias_dtype == 1)
    return (int)dispatch_c<float, __nv_bfloat16>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, st);
  if (C != 4 && C != 8 && C != 16 && C != 32) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && bias_dtype == 0)
    return (int)launch_mma<float>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, st);
  if (dtype == 1 && bias_dtype == 1)
    return (int)launch_mma<__nv_bfloat16>(q, k, v, bias, gate, out, lse, L, S, H, C, scale, st);
  return (int)cudaErrorInvalidValue;
}
