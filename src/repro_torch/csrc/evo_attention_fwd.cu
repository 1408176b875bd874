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
//  * bf16 inputs (serving): tensor cores.  A warp owns 16 query rows; Q.K^T
//    and P.V are mma.sync m16n8k16 bf16 products with fp32 accumulation, the
//    head dim zero-padded to 16 or 32; P is rounded to bf16 for P.V (as the
//    Pallas kernel casts p to v's dtype) while l sums the fp32 p.  K is kept
//    key-major and V channel-major in shared memory, so every fragment is
//    one 32-bit load, with rows padded against bank conflicts.
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
// bf16 inputs: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int MQ = 64;   // query rows per block: 4 warps x 16
constexpr int MK = 64;   // keys per shared-memory tile

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

// CP: head dim padded to a multiple of 16 (16 or 32); C: the real head dim
template <typename BT, int CP>
__global__ void __launch_bounds__(128)
evo_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const BT* __restrict__ bias,
                             const __nv_bfloat16* __restrict__ gate,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int S, int H, int C,
                             float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[MK][CP + 8];   // key-major
  __shared__ __align__(16) __nv_bfloat16 vt[CP][MK + 8];   // channel-major

  const int lh = blockIdx.x;  // l * H + h
  const int l = lh / H;
  const int h = lh - l * H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const size_t rs = (size_t)H * C;
  const size_t base = (size_t)l * S * rs + (size_t)h * C;
  const int row0 = blockIdx.y * MQ + warp * 16 + g;  // this thread's rows:
  const int row1 = row0 + 8;                         // row0 and row0 + 8

  auto ld_pair = [&](const __nv_bfloat16* p, int row, int c) -> uint32_t {
    if (row < S && c < C) return *reinterpret_cast<const uint32_t*>(p + base + row * rs + c);
    return 0u;
  };
  uint32_t qa[CP / 16][4];
#pragma unroll
  for (int kc = 0; kc < CP / 16; ++kc) {
    const int c0 = kc * 16 + 2 * t;
    qa[kc][0] = ld_pair(q, row0, c0);
    qa[kc][1] = ld_pair(q, row1, c0);
    qa[kc][2] = ld_pair(q, row0, c0 + 8);
    qa[kc][3] = ld_pair(q, row1, c0 + 8);
  }
  float o[CP / 8][4];
#pragma unroll
  for (int ct = 0; ct < CP / 8; ++ct) o[ct][0] = o[ct][1] = o[ct][2] = o[ct][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};
  float lsum[2] = {0.f, 0.f};
  const BT* bh = bias == nullptr ? nullptr : bias + (size_t)h * S * S;

  for (int k0 = 0; k0 < S; k0 += MK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < MK * CP / 2; e += 128) {
      const int key = e / (CP / 2);
      const int c = (e - key * (CP / 2)) * 2;
      const int j = k0 + key;
      uint32_t kv = 0u, vv = 0u;
      if (j < S && c < C) {
        const size_t off = base + (size_t)j * rs + c;
        kv = *reinterpret_cast<const uint32_t*>(k + off);
        vv = *reinterpret_cast<const uint32_t*>(v + off);
      }
      *reinterpret_cast<uint32_t*>(&ks[key][c]) = kv;
      const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(&vv);
      vt[c][key] = v2.x;
      vt[c + 1][key] = v2.y;
    }
    __syncthreads();

    // scores: 16 rows x MK keys per warp, MK / 8 n-tiles
    float s[MK / 8][4];
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = &ks[nt * 8 + g][0];
#pragma unroll
      for (int kc = 0; kc < CP / 16; ++kc)
        mma16816(s[nt], qa[kc], *reinterpret_cast<const uint32_t*>(kr + kc * 16 + 2 * t),
                 *reinterpret_cast<const uint32_t*>(kr + kc * 16 + 2 * t + 8));
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        float x = s[nt][e] * scale;
        if (bh != nullptr && row < S && col < S) x += to_f(bh[(size_t)row * S + col]);
        if (col >= S) x = -INFINITY;
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
    for (int ct = 0; ct < CP / 8; ++ct) {
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
    // O += P.V, 16 keys per k-step; the score fragments are P's A operand
#pragma unroll
    for (int kc = 0; kc < MK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int ct = 0; ct < CP / 8; ++ct) {
        const __nv_bfloat16* vr = &vt[ct * 8 + g][kc * 16 + 2 * t];
        mma16816(o[ct], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
  }
  if (lse != nullptr && t == 0) {
    if (row0 < S) lse[(size_t)lh * S + row0] = m[0] + logf(fmaxf(lsum[0], 1e-30f));
    if (row1 < S) lse[(size_t)lh * S + row1] = m[1] + logf(fmaxf(lsum[1], 1e-30f));
  }
  const float inv[2] = {1.f / fmaxf(lsum[0], 1e-30f), 1.f / fmaxf(lsum[1], 1e-30f)};
#pragma unroll
  for (int ct = 0; ct < CP / 8; ++ct) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row0 : row1;
      const int c = ct * 8 + 2 * t;
      if (row >= S || c >= C) continue;
      const size_t off = base + (size_t)row * rs + c;
      float o0 = o[ct][2 * r] * inv[r];
      float o1 = o[ct][2 * r + 1] * inv[r];
      if (gate != nullptr) {
        const __nv_bfloat162 g2 = *reinterpret_cast<const __nv_bfloat162*>(gate + off);
        o0 *= 1.f / (1.f + expf(-__bfloat162float(g2.x)));
        o1 *= 1.f / (1.f + expf(-__bfloat162float(g2.y)));
      }
      *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(o0, o1);
    }
  }
}

template <typename BT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* bias,
                       const void* gate, void* out, float* lse, int L, int S, int H, int C,
                       float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(L * H), (unsigned)((S + MQ - 1) / MQ));
  const auto* q_ = static_cast<const __nv_bfloat16*>(q);
  const auto* k_ = static_cast<const __nv_bfloat16*>(k);
  const auto* v_ = static_cast<const __nv_bfloat16*>(v);
  const auto* g_ = static_cast<const __nv_bfloat16*>(gate);
  auto* o_ = static_cast<__nv_bfloat16*>(out);
  const auto* b_ = static_cast<const BT*>(bias);
  if (C <= 16)
    evo_attention_fwd_mma_kernel<BT, 16><<<grid, 128, 0, stream>>>(q_, k_, v_, b_, g_, o_, lse, S, H, C, scale);
  else if (C <= 32)
    evo_attention_fwd_mma_kernel<BT, 32><<<grid, 128, 0, stream>>>(q_, k_, v_, b_, g_, o_, lse, S, H, C, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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
