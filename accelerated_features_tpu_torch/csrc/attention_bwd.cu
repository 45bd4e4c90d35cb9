// The gradient of kernel D (attention.cu) for Hopper (sm_90a): given dO,
// the dq, dk and dv of O = softmax(where(mask, scale * q k^T, -1e9)) v.
//
// It is the gradient of the function the TPU kernel `_attn_kernel` in
// accelerated_features_tpu/ops/pallas/attention.py computes; the JAX
// package has no backward kernel (its training path runs XLA's dense
// attention), so this has no TPU counterpart of its own.
//
// Form: FlashAttention-2's backward. The forward saves the row
// log-sum-exp (natural log) of the masked, scaled scores; here the
// probabilities are recomputed tile by tile from it and never reach device
// memory:
//   P = exp(scale * q k^T - lse), 0 at a masked key,
//   dV = P^T dO,  dP = dO V^T,  Delta = rowsum(dO * O),
//   dS = P (dP - Delta), 0 at a masked key (the `where` cuts it),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// A batch item whose keys are all masked has uniform weights 1/Nk (the
// -1e9 scores are all equal): every key gets dO/Nk of each row in dv, and
// no score gets a gradient.
//
// Three kernels, no atomics, so two runs give bit-equal gradients:
//   attn_bwd_delta  one warp a row: Delta = rowsum(dO * O);
//   attn_bwd_dkdv   a block owns 64 keys (dK, dV in registers) and walks
//                   every 64-row query tile in order;
//   attn_bwd_dq     a block owns 64 query rows (dQ in registers) and walks
//                   every 64-key tile in order.
// The products run as float32 FFMA from shared memory (rows padded to an
// odd stride, so a warp's reads fall on distinct banks or broadcast), each
// thread a 4 x 4 tile of scores and a 4 x D/16 tile of its output. Bound on
// the H100: operations, 5 products of 2*Nq*Nk*D each over the unmasked
// keys at the float32 CUDA-core peak; the two recomputed products (S and
// dP in both kernels) are this design's own work. A simple kernel: the
// tensor cores and the split of the query loop are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define THREADS 256
#define LOG2E 1.4426950408889634f

template <int D>
constexpr int dkdv_smem_floats() {
  return 4 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ + BK;
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * BQ * (D + 1) + BQ * (BK + 1) + 2 * BQ + BK;
}

// Delta[r] = sum_c dO[r,c] * O[r,c], one warp a row
__global__ void attn_bwd_delta(const float* __restrict__ o,
                               const float* __restrict__ dout,
                               float* __restrict__ delta, long rows, int D) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(o[row * D + c], dout[row * D + c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// 1 when item b has an unmasked key (or no mask), else 0; the whole block
// must call it
__device__ __forceinline__ int item_has_key(const uint8_t* mb, int Nk) {
  if (mb == nullptr) return 1;
  int any = 0;
  for (int i = threadIdx.x; i < Nk; i += THREADS) any |= mb[i] != 0;
  return __syncthreads_or(any);
}

// rows [r0, r0+BQ) of a (rows, D) matrix into shared memory with row
// stride D+1; rows beyond `rows` are zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < rows ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// s[a][b] = Qs[r].Ks[c] and dp[a][b] = dOs[r].Vs[c] for this thread's rows
// r = ty + 16a and keys c = tx + 16b
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = Qs[(ty + 16 * a) * LD + d];
      oa[a] = dOs[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = Ks[(tx + 16 * b) * LD + d];
      vb[b] = Vs[(tx + 16 * b) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
}

// P and dS (dS already times scale) of this thread's 4 x 4 scores; code is
// 1 attend, 0 masked, -1 no such key; row_ok false for rows beyond Nq
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float* lse2_s,
                                      const float* delta_s, const int* code_s,
                                      int ty, int tx, bool empty, float inv_nk,
                                      float scale, float scale2,
                                      const bool (&row_ok)[4],
                                      float (&p)[4][4], float (&ds)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int code = code_s[tx + 16 * b];
      float pv = 0.f, dv = 0.f;
      if (row_ok[a] && code >= 0) {
        if (empty) {
          pv = inv_nk;
        } else if (code > 0) {
          pv = exp2f(fmaf(s[a][b], scale2, -lse2_s[r]));
          dv = pv * (dp[a][b] - delta_s[r]) * scale;
        }
      }
      p[a][b] = pv;
      ds[a][b] = dv;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const float* __restrict__ dout, float* __restrict__ dk,
                  float* __restrict__ dv, int Nq, int Nk, float scale) {
  constexpr int LD = D + 1, LP = BK + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  float* lse2_s = dSs + BQ * LP;
  float* delta_s = lse2_s + BQ;
  int* code_s = reinterpret_cast<int*>(delta_s + BQ);

  const int b = blockIdx.y, k0 = blockIdx.x * BK, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // score tile: rows, keys
  const int tk = tid % 16, tc = tid / 16;  // output tile: keys, columns
  const float* qb = q + (size_t)b * Nq * D;
  const float* ob = dout + (size_t)b * Nq * D;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * Nk;
  const bool empty = item_has_key(mb, Nk) == 0;
  const float scale2 = scale * LOG2E, inv_nk = 1.f / (float)Nk;

  load_rows<D>(Ks, k + (size_t)b * Nk * D, k0, Nk);
  load_rows<D>(Vs, v + (size_t)b * Nk * D, k0, Nk);
  if (tid < BK) {
    const int c = k0 + tid;
    code_s[tid] = c >= Nk ? -1 : (mb == nullptr || mb[c] != 0) ? 1 : 0;
  }

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc_k[a][n] = acc_v[a][n] = 0.f;

  for (int r0 = 0; r0 < Nq; r0 += BQ) {
    __syncthreads();  // the previous tile's reads are done
    load_rows<D>(Qs, qb, r0, Nq);
    load_rows<D>(dOs, ob, r0, Nq);
    if (tid < BQ) {
      const bool ok = r0 + tid < Nq;
      const size_t row = (size_t)b * Nq + r0 + tid;
      lse2_s[tid] = ok ? lse[row] * LOG2E : 0.f;
      delta_s[tid] = ok ? delta[row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    bool row_ok[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) row_ok[a] = r0 + ty + 16 * a < Nq;
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    probs(s, dp, lse2_s, delta_s, code_s, ty, tx, empty, inv_nk, scale,
          scale2, row_ok, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[(ty + 16 * a) * LP + tx + 16 * c] = p[a][c];
        dSs[(ty + 16 * a) * LP + tx + 16 * c] = ds[a][c];
      }
    __syncthreads();

    // dV[key] += P[:, key]^T dO, dK[key] += dS[:, key]^T Q
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pa[4], sa[4], oc[NC], qc[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = Ps[r * LP + tk + 16 * a];
        sa[a] = dSs[r * LP + tk + 16 * a];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        oc[n] = dOs[r * LD + tc + 16 * n];
        qc[n] = Qs[r * LD + tc + 16 * n];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          acc_v[a][n] = fmaf(pa[a], oc[n], acc_v[a][n]);
          acc_k[a][n] = fmaf(sa[a], qc[n], acc_k[a][n]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + tk + 16 * a;
    if (key >= Nk) continue;
    const size_t base = ((size_t)b * Nk + key) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dk[base + tc + 16 * n] = acc_k[a][n];
      dv[base + tc + 16 * n] = acc_v[a][n];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dout, float* __restrict__ dq, int Nq,
                int Nk, float scale) {
  constexpr int LD = D + 1, LP = BK + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* lse2_s = dSs + BQ * LP;
  float* delta_s = lse2_s + BQ;
  int* code_s = reinterpret_cast<int*>(delta_s + BQ);

  const int b = blockIdx.y, r0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // score tile: rows, keys
  const int tr = tid % 16, tc = tid / 16;  // output tile: rows, columns
  const float* kb = k + (size_t)b * Nk * D;
  const float* vb = v + (size_t)b * Nk * D;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * Nk;
  const bool empty = item_has_key(mb, Nk) == 0;
  const float scale2 = scale * LOG2E;

  load_rows<D>(Qs, q + (size_t)b * Nq * D, r0, Nq);
  load_rows<D>(dOs, dout + (size_t)b * Nq * D, r0, Nq);
  if (tid < BQ) {
    const bool ok = r0 + tid < Nq;
    const size_t row = (size_t)b * Nq + r0 + tid;
    lse2_s[tid] = ok ? lse[row] * LOG2E : 0.f;
    delta_s[tid] = ok ? delta[row] : 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[a][n] = 0.f;
  bool row_ok[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) row_ok[a] = r0 + ty + 16 * a < Nq;

  // an item without an unmasked key has no score gradient at all
  for (int k0 = 0; !empty && k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    load_rows<D>(Ks, kb, k0, Nk);
    load_rows<D>(Vs, vb, k0, Nk);
    if (tid < BK) {
      const int c = k0 + tid;
      code_s[tid] = c >= Nk ? -1 : (mb == nullptr || mb[c] != 0) ? 1 : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4], p[4][4], ds[4][4];
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    probs(s, dp, lse2_s, delta_s, code_s, ty, tx, false, 0.f, scale, scale2,
          row_ok, p, ds);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dSs[(ty + 16 * a) * LP + tx + 16 * c] = ds[a][c];
    __syncthreads();

    // dQ[row] += dS[row, :] K
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sa[4], kc[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dSs[(tr + 16 * a) * LP + c];
#pragma unroll
      for (int n = 0; n < NC; ++n) kc[n] = Ks[c * LD + tc + 16 * n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[a][n] = fmaf(sa[a], kc[n], acc[a][n]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + tr + 16 * a;
    if (row >= Nq) continue;
    const size_t base = ((size_t)b * Nq + row) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) dq[base + tc + 16 * n] = acc[a][n];
  }
}

template <int D>
static cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                              const uint8_t* mask, const float* lse,
                              float* delta, const float* dout, float* dq,
                              float* dk, float* dv, int B, int Nq, int Nk,
                              float scale, cudaStream_t s) {
  const int bytes_kv = dkdv_smem_floats<D>() * (int)sizeof(float);
  const int bytes_q = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dq<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes_q);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv<D><<<dim3((Nk + BK - 1) / BK, B), THREADS, bytes_kv, s>>>(
      q, k, v, mask, lse, delta, dout, dk, dv, Nq, Nk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dq<D><<<dim3((Nq + BQ - 1) / BQ, B), THREADS, bytes_q, s>>>(
      q, k, v, mask, lse, delta, dout, dq, Nq, Nk, scale);
  return cudaGetLastError();
}

// q, o, dout, dq (B,Nq,D); k, v, dk, dv (B,Nk,D); lse (B,Nq), the forward's
// natural-log row log-sum-exp; delta (B,Nq) scratch; mask (B,Nk) bytes or
// null. All float32, contiguous.
extern "C" int attention_backward(const float* q, const float* k,
                                  const float* v, const uint8_t* mask,
                                  const float* o, const float* lse,
                                  const float* dout, float* delta, float* dq,
                                  float* dk, float* dv, int B, int Nq, int Nk,
                                  int D, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || Nq < 1 || Nk < 1) return (int)cudaErrorInvalidValue;
  const long rows = (long)B * Nq;
  attn_bwd_delta<<<(int)((rows + 7) / 8), 256, 0, s>>>(o, dout, delta, rows,
                                                       D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (D) {
    case 32:
      return (int)launch_bwd<32>(q, k, v, mask, lse, delta, dout, dq, dk, dv,
                                 B, Nq, Nk, scale, s);
    case 64:
      return (int)launch_bwd<64>(q, k, v, mask, lse, delta, dout, dq, dk, dv,
                                 B, Nq, Nk, scale, s);
    case 96:
      return (int)launch_bwd<96>(q, k, v, mask, lse, delta, dout, dq, dk, dv,
                                 B, Nq, Nk, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
