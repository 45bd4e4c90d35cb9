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
// probabilities are recomputed tile by tile from it and never reach shared
// or device memory:
//   P = exp(scale * q k^T - lse), 0 at a masked key,
//   dV = P^T dO,  dP = dO V^T,  Delta = rowsum(dO * O),
//   dS = P (dP - Delta), 0 at a masked key (the `where` cuts it),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// A batch item whose keys are all masked has uniform weights 1/Nk (the
// -1e9 scores are all equal): every key gets dO/Nk of each row in dv, and
// no score gets a gradient. It is found per item from the mask, since the
// log-sum-exp rounds -1e9 + log(Nk) to -1e9.
//
// Bound on the H100: operations. The function needs 5 products of
// 2*Nq*keys*D over the unmasked keys; the gradients are held to float32
// grade (atol 1e-4 + rtol 1e-3 of float64), so every product runs on the
// tensor cores as 3xTF32 (tf32x3.cuh, the cut split as in the forward):
// the least time is 3 * 5 * 2*Nq*keys*D / 495 TFLOP/s.
//
// Design: two launches, no atomics, so two runs give bit-equal gradients.
// A small kernel computes Delta (one warp a row); one main launch then
// holds both roles in its grid, so the two together fill the card: the
// first ceil(Nk/64) blocks of an item own 64 keys each (dK, dV), the rest
// 64 query rows each (dQ). With 4096 keys, or 8 items of 512, that is 128
// blocks of eight warps, one wave on 132 SMs. The roles recompute S and
// dP each, 7 products where the function needs 5.
//   dK/dV: the block's K and V stay in shared memory; Q, dO and the rows'
//   lse and Delta stream through a ring of cp.async stages (two, three at
//   D = 32), 64 rows a stage. A warp owns 16 keys and half of each query
//   tile: it computes S^T = K Q^T and dP^T = V dO^T (keys as accumulator
//   rows) and uses P^T and dS^T, still in the accumulator layout, as the A
//   fragments of dV += P^T dO and dK += dS^T Q. The two halves' sums meet
//   in shared memory at the end, in a fixed order.
//   dQ: the block's Q and dO stay; K and V stream. A warp owns 16 rows and
//   half of each key tile: S = Q K^T, dP = dO V^T, dQ += dS K.
// The A fragment of a 16x8 accumulator tile holds columns 2t and 2t+1,
// which serve as k-slots t and t+4, so the B rows of the second product are
// read in that order. In the D-long contractions (S, dP) a lane reads 16
// bytes of a row at once, columns 8t..8t+3 holding the k-slots of two
// k-steps; in the output products a lane reads 16 bytes of columns 4g..4g+3
// and the output columns are permuted to match (a thread then stores 8
// consecutive columns). Rows are padded to D+4 floats (D+4 = 4 mod 8), so
// both kinds of 16-byte loads fall on distinct banks. Key tiles in which
// every key is masked are skipped when the item has an unmasked key: a
// dK/dV block whose 64 keys are all masked writes zeros and returns, a dQ
// block does not load them, a warp whose 16 keys are all masked does no
// products. With D = 32, two blocks fit on an SM (three heads of 32 at
// B = 8 give 384 blocks).
//
// Measured on an H100 SXM at 700 W (chip_smoke.py): 0.46 ms at
// Nq = Nk = 4096, D = 96 with 3677 keys unmasked, 0.19 of the bound
// (0.0876 ms); 0.074 ms at B = 8, 512 x 512. mma.sync TF32 itself
// sustains 0.64 of the peak there (tools/mma_rate.py). The dK/dV role bounds the
// launch (alone it takes 0.46 ms, the dQ role alone 0.40). Its SMs issue
// HMMAs at ~0.37 of the tensor-core peak and read shared memory at ~0.3
// of its rate: with 226 registers a thread (dK, dV and the scores of 16
// keys x 32 queries) only eight warps fit on an SM, too few to hide the
// latency of shared-memory loads, splits and MMAs behind one another.
// wgmma, with operands read from shared memory by the tensor cores, is the
// way past that.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

#define WARPS 8
#define THREADS (32 * WARPS)
#define ROWS 64  // keys of a dK/dV block, rows of a dQ block and of a stage
#define PAD 4
#define LOG2E 1.4426950408889634f
#define FULL 0xffffffffu

template <int D>
struct Shape {
  static constexpr int LD = D + PAD;  // row stride, = 4 mod 8
  static constexpr int TILE = ROWS * LD;
  // stages of the ring: two where one block takes the SM (2-4% faster
  // than three at D = 96 on an H100), three at D = 32, where two blocks
  // share it (two stages there make ptxas spill under the 128-register
  // cap)
  static constexpr int STAGES = D == 32 ? 3 : 2;
  // a stage: two matrices, then the rows' lse and Delta (dK/dV role)
  static constexpr int STAGE = 2 * TILE + 2 * ROWS;
  static constexpr int FLOATS = 2 * TILE + STAGES * STAGE;
  static constexpr int NO = D / 8;  // 8-column MMA tiles of an output
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const uint8_t* mask;
  const float* lse;
  const float* delta;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  int Nq, Nk;
  float scale;
};

// 2^x on the special-function unit; results below 2^-126 are 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
    s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) delta[row] = s;
}

// rows [r0, r0+ROWS) of two (rows, D) matrices into dst0 and dst1 (stride
// LD) by 16-byte cp.async; rows beyond `rows` are zeros
template <int D>
__device__ __forceinline__ void stage_rows(float* dst0, float* dst1,
                                           const float* src0,
                                           const float* src1, int r0,
                                           int rows) {
  constexpr int LD = Shape<D>::LD, C4 = D / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int r = i / C4, c = (i - r * C4) * 4;
    const bool real = r0 + r < rows;
    const size_t src = (size_t)(real ? r0 + r : 0) * D + c;
    tf32x3::cp_async16(dst0 + r * LD + c, src0 + src, real);
    tf32x3::cp_async16(dst1 + r * LD + c, src1 + src, real);
  }
}

// zeros into rows [r0, min(r0+ROWS, rows)) of one or two (rows, D) outputs
template <int D>
__device__ __forceinline__ void zero_rows(float* a, float* b, int r0,
                                          int rows) {
  const int n = min(ROWS, rows - r0) * (D / 4);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    reinterpret_cast<float4*>(a + (size_t)r0 * D)[i] = z;
    if (b != nullptr) reinterpret_cast<float4*>(b + (size_t)r0 * D)[i] = z;
  }
}

// c[j0+j] += a . b_j for j < NT, 3xTF32: a the A fragment split into
// (hi, lo), b_j = (b0[j], b1[j]) raw; term by term over the NT
// independent accumulators, the small terms first
template <int N, int NT>
__device__ __forceinline__ void mma3(float (&c)[N][4], int j0,
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const float (&b0)[NT],
                                     const float (&b1)[NT]) {
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    tf32x3::split_cut(b0[j], bh[j][0], bl[j][0]);
    tf32x3::split_cut(b1[j], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) tf32x3::mma(c[j0 + j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) tf32x3::mma(c[j0 + j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) tf32x3::mma(c[j0 + j], ah, bh[j]);
}

__device__ __forceinline__ void split4(float a0, float a1, float a2,
                                       float a3, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  tf32x3::split_cut(a0, ah[0], al[0]);
  tf32x3::split_cut(a1, ah[1], al[1]);
  tf32x3::split_cut(a2, ah[2], al[2]);
  tf32x3::split_cut(a3, ah[3], al[3]);
}

// c[j] = A_w . B_j^T over the D columns: A_w the warp's 16 rows (A points at
// its row g, row g+8 is 8 rows on), B_j the 8 rows 8j.. (B points at row g
// of B_0), row-major in shared memory. A lane reads 16 bytes of a row at a
// time: columns 32i + 8t + 4h + (0, 1) are k-slots t and t+4 of one
// k-step, + (2, 3) of the next. The columns are summed over, so any such
// assignment serves; this one loads 16 bytes at once on distinct banks
// (rows g and g+1 lie an odd number of 16-byte groups apart, lanes t an
// even number).
template <int D, int NT>
__device__ __forceinline__ void dot_rows(const float* A, const float* B,
                                         int t, float (&c)[NT][4]) {
  constexpr int LD = Shape<D>::LD;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  A += 8 * t;
  B += 8 * t;
#pragma unroll
  for (int h = 0; h < D / 16; ++h) {
    const int col = (h >> 1) * 32 + (h & 1) * 4;
    const float4 a0 = ld4(A + col), a1 = ld4(A + 8 * LD + col);
    float4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = ld4(B + j * 8 * LD + col);
    uint32_t ah[4], al[4];
    float b0[NT], b1[NT];
    split4(a0.x, a1.x, a0.y, a1.y, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b0[j] = b[j].x;
      b1[j] = b[j].y;
    }
    mma3<NT, NT>(c, 0, ah, al, b0, b1);
    split4(a0.z, a1.z, a0.w, a1.w, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b0[j] = b[j].z;
      b1[j] = b[j].w;
    }
    mma3<NT, NT>(c, 0, ah, al, b0, b1);
  }
}

// acc += F . B_8 over one k-step: F a 16x8 accumulator tile (P or dS; its
// columns 2t and 2t+1 serve as k-slots t and t+4), B_8 the eight rows it
// multiplies (B points at row 2t; row 2t+1 is the next). Output column
// 32(n/4) + 4g + n%4 is the n-th 8-column tile's g-th, so a lane reads 16
// bytes of columns 4g.. of each row, and a thread's accumulators hold, in
// rows g and g+8, columns 32i + 8t .. 32i + 8t + 7 (see store_rows).
template <int D>
__device__ __forceinline__ void acc_rows(float (&acc)[D / 8][4],
                                         const float (&f)[4], const float* B,
                                         int g) {
  constexpr int LD = Shape<D>::LD;
  uint32_t ah[4], al[4];
  split4(f[0], f[2], f[1], f[3], ah, al);
  B += 4 * g;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const float4 r0 = ld4(B + 32 * i), r1 = ld4(B + LD + 32 * i);
    const float b0[4] = {r0.x, r0.y, r0.z, r0.w};
    const float b1[4] = {r1.x, r1.y, r1.z, r1.w};
    mma3<D / 8, 4>(acc, 4 * i, ah, al, b0, b1);
  }
}

// rows g and g+8 (null: not stored) of an output tile kept as acc_rows
// keeps it, times `mul`
template <int D>
__device__ __forceinline__ void store_rows(float* row_g, float* row_g8,
                                           const float (&acc)[D / 8][4],
                                           int t, float mul) {
#pragma unroll
  for (int i = 0; i < D / 32; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = h ? row_g8 : row_g;
      if (row == nullptr) continue;
      const int a = 2 * h, b = 2 * h + 1;
      *reinterpret_cast<float4*>(row + 32 * i + 8 * t) =
          make_float4(acc[4 * i][a] * mul, acc[4 * i + 1][a] * mul,
                      acc[4 * i + 2][a] * mul, acc[4 * i + 3][a] * mul);
      *reinterpret_cast<float4*>(row + 32 * i + 8 * t + 4) =
          make_float4(acc[4 * i][b] * mul, acc[4 * i + 1][b] * mul,
                      acc[4 * i + 2][b] * mul, acc[4 * i + 3][b] * mul);
    }
}

// the two halves' partial sums: one half puts its tile into x (already
// offset by the lane), the other adds it after a barrier
template <int D>
__device__ __forceinline__ void put(const float (&acc)[D / 8][4], float* x) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(n * 4 + e) * 32] = acc[n][e];
}

template <int D>
__device__ __forceinline__ void take(float (&acc)[D / 8][4], const float* x) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += x[(n * 4 + e) * 32];
}

// A block that owns keys [k0, k0+ROWS) of item b: dK and dV
template <int D>
__device__ __forceinline__ void dkdv_role(const Args& a, float* smem, int b,
                                          int kt) {
  using S = Shape<D>;
  constexpr int LD = S::LD, TILE = S::TILE, NO = S::NO;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, kg = warp & 3, half = warp >> 2;
  const int Nq = a.Nq, Nk = a.Nk, k0 = kt * ROWS;
  const uint8_t* mb = a.mask == nullptr ? nullptr : a.mask + (size_t)b * Nk;
  float* dk = a.dk + (size_t)b * Nk * D;
  float* dv = a.dv + (size_t)b * Nk * D;

  // has the item an unmasked key, and has this block?
  bool empty = false, live = true;
  if (mb != nullptr) {
    int any = 0, mine = 0;
    for (int i = threadIdx.x; i < Nk; i += THREADS)
      if (mb[i] != 0) {
        any = 1;
        mine |= i >= k0 && i < k0 + ROWS;
      }
    empty = __syncthreads_or(any) == 0;
    live = __syncthreads_or(mine) != 0;
  }
  if (!empty && !live) {  // every key here weighs exactly 0
    zero_rows<D>(dk, dv, k0, Nk);
    return;
  }
  const int key = k0 + 16 * kg + g;  // this thread's keys: key, key + 8
  const bool att0 = key < Nk && (mb == nullptr || mb[key] != 0);
  const bool att1 = key + 8 < Nk && (mb == nullptr || mb[key + 8] != 0);
  const bool work = __any_sync(FULL, empty ? key < Nk : att0 || att1);

  float* Ks = smem;
  float* Vs = Ks + TILE;
  float* ring = Vs + TILE;
  const float* qb = a.q + (size_t)b * Nq * D;
  const float* ob = a.dout + (size_t)b * Nq * D;
  const float* lb = a.lse + (size_t)b * Nq;
  const float* db = a.delta + (size_t)b * Nq;
  stage_rows<D>(Ks, Vs, a.k + (size_t)b * Nk * D, a.v + (size_t)b * Nk * D,
                k0, Nk);
  auto load = [&](int qt) {
    float* st = ring + (qt % S::STAGES) * S::STAGE;
    const int r0 = qt * ROWS;
    stage_rows<D>(st, st + TILE, qb, ob, r0, Nq);
    if (tid < 2 * ROWS) {  // lse, then Delta, of the 64 rows
      const int r = r0 + (tid & (ROWS - 1));
      const bool real = r < Nq;
      tf32x3::cp_async4(st + 2 * TILE + tid,
                        (tid < ROWS ? lb : db) + (real ? r : 0), real);
    }
  };
  const int n_qt = (Nq + ROWS - 1) / ROWS;
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < n_qt) load(s);
    tf32x3::cp_async_commit();
  }

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const float scale2 = a.scale * LOG2E, inv_nk = 1.f / (float)Nk;
  const float* Kw = Ks + (16 * kg + g) * LD;
  const float* Vw = Vs + (16 * kg + g) * LD;

  for (int qt = 0; qt < n_qt; ++qt) {
    tf32x3::cp_async_wait<S::STAGES - 2>();
    __syncthreads();  // this tile has landed; the previous one is done
    if (qt + S::STAGES - 1 < n_qt) load(qt + S::STAGES - 1);
    tf32x3::cp_async_commit();
    if (!work) continue;
    // this half's 32 query rows of the tile
    const float* st = ring + (qt % S::STAGES) * S::STAGE;
    const float* Qt = st + 32 * half * LD;
    const float* dOt = Qt + TILE;
    const float* lt = st + 2 * TILE + 32 * half;
    // P^T and dS^T: row g / g+8 (e >> 1) is a key, column 8j + 2t + (e & 1)
    // a query
    float p[4][4], ds[4][4];
    if (empty) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = inv_nk;
    } else {
      float s[4][4], dp[4][4];
      dot_rows<D, 4>(Kw, Qt + g * LD, t, s);
      dot_rows<D, 4>(Vw, dOt + g * LD, t, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
        const float2 d =
            *reinterpret_cast<const float2*>(lt + ROWS + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool att = e < 2 ? att0 : att1;
          const float lse2 = (e & 1 ? l.y : l.x) * LOG2E;
          const float pv =
              att ? fast_exp2(fmaf(s[j][e], scale2, -lse2)) : 0.f;
          p[j][e] = pv;
          ds[j][e] = pv * (dp[j][e] - (e & 1 ? d.y : d.x));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc_rows<D>(acc_v, p[j], dOt + (8 * j + 2 * t) * LD, g);
    if (!empty) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc_rows<D>(acc_k, ds[j], Qt + (8 * j + 2 * t) * LD, g);
    }
  }

  // the halves meet: half 0 sums and stores dK, half 1 dV
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* xk = ring + kg * (NO * 4 * 32) + lane;
  float* xv = xk + 4 * NO * 4 * 32;
  if (half) put<D>(acc_k, xk);
  else put<D>(acc_v, xv);
  __syncthreads();
  float* row_g = key < Nk ? (half ? dv : dk) + (size_t)key * D : nullptr;
  float* row_g8 =
      key + 8 < Nk ? (half ? dv : dk) + (size_t)(key + 8) * D : nullptr;
  if (half) {
    take<D>(acc_v, xv);
    store_rows<D>(row_g, row_g8, acc_v, t, 1.f);
  } else {
    take<D>(acc_k, xk);
    store_rows<D>(row_g, row_g8, acc_k, t, a.scale);
  }
}

// A block that owns query rows [r0, r0+ROWS) of item b: dQ
template <int D>
__device__ __forceinline__ void dq_role(const Args& a, float* smem, int b,
                                        int qt) {
  using S = Shape<D>;
  constexpr int LD = S::LD, TILE = S::TILE, NO = S::NO;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, rg = warp & 3, half = warp >> 2;
  const int Nq = a.Nq, Nk = a.Nk, r0 = qt * ROWS;
  const int n_kt = (Nk + ROWS - 1) / ROWS;
  const uint8_t* mb = a.mask == nullptr ? nullptr : a.mask + (size_t)b * Nk;
  float* dq = a.dq + (size_t)b * Nq * D;
  float* ring = smem + 2 * TILE;
  int* live = reinterpret_cast<int*>(ring + S::STAGES * S::STAGE);

  // which key tiles have an unmasked key; may they be skipped?
  bool may_skip = false;
  if (mb != nullptr) {
    for (int i = tid; i < n_kt; i += THREADS) live[i] = 0;
    __syncthreads();
    int any = 0;
    for (int i = tid; i < Nk; i += THREADS)
      if (mb[i] != 0) {
        any = 1;
        live[i / ROWS] = 1;
      }
    if (__syncthreads_or(any) == 0) {  // no score has a gradient
      zero_rows<D>(dq, nullptr, r0, Nq);
      return;
    }
    may_skip = true;
  }
  auto next_live = [&](int tile) {
    while (may_skip && tile < n_kt && live[tile] == 0) ++tile;
    return tile;
  };

  float* Qs = smem;
  float* dOs = Qs + TILE;
  const float* kb = a.k + (size_t)b * Nk * D;
  const float* vb = a.v + (size_t)b * Nk * D;
  stage_rows<D>(Qs, dOs, a.q + (size_t)b * Nq * D,
                a.dout + (size_t)b * Nq * D, r0, Nq);
  int load_t = next_live(0), load_slot = 0;
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (load_t < n_kt) {
      float* st = ring + load_slot * S::STAGE;
      stage_rows<D>(st, st + TILE, kb, vb, load_t * ROWS, Nk);
      load_t = next_live(load_t + 1);
    }
    load_slot = (load_slot + 1) % S::STAGES;
    tf32x3::cp_async_commit();
  }

  // lse (base 2) and Delta of this thread's rows row and row + 8
  const int row = r0 + 16 * rg + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < Nq;
    const size_t r = (size_t)b * Nq + (ok ? row + 8 * h : 0);
    lse2[h] = ok ? a.lse[r] * LOG2E : 0.f;
    dl[h] = ok ? a.delta[r] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale2 = a.scale * LOG2E;
  const float* Qw = Qs + (16 * rg + g) * LD;
  const float* dOw = dOs + (16 * rg + g) * LD;

  int tile = next_live(0), slot = 0;
  while (tile < n_kt) {
    tf32x3::cp_async_wait<S::STAGES - 2>();
    __syncthreads();  // this tile has landed; the previous one is done
    if (load_t < n_kt) {
      float* st = ring + load_slot * S::STAGE;
      stage_rows<D>(st, st + TILE, kb, vb, load_t * ROWS, Nk);
      load_t = next_live(load_t + 1);
    }
    load_slot = (load_slot + 1) % S::STAGES;
    tf32x3::cp_async_commit();

    // this half's 32 keys: key0 + 8j + (0, 1) are accumulator columns
    // 8j + 2t + (0, 1)
    const int key0 = tile * ROWS + 32 * half + 2 * t;
    bool att[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = key0 + 8 * j + e;
        att[j][e] = kk < Nk && (mb == nullptr || mb[kk] != 0);
      }
    const float* st = ring + slot * S::STAGE;
    const float* Kt = st + 32 * half * LD;
    const float* Vt = Kt + TILE;
    float s[4][4], dp[4][4];
    dot_rows<D, 4>(Qw, Kt + g * LD, t, s);
    dot_rows<D, 4>(dOw, Vt + g * LD, t, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = att[j][e & 1]
                             ? fast_exp2(fmaf(s[j][e], scale2, -lse2[e >> 1]))
                             : 0.f;
        ds[e] = pv * (dp[j][e] - dl[e >> 1]);
      }
      acc_rows<D>(acc, ds, Kt + (8 * j + 2 * t) * LD, g);
    }
    slot = (slot + 1) % S::STAGES;
    tile = next_live(tile + 1);
  }

  // the halves meet: half 1 hands its sum over, half 0 stores
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* x = ring + rg * (NO * 4 * 32) + lane;
  if (half) put<D>(acc, x);
  __syncthreads();
  if (half) return;
  take<D>(acc, x);
  store_rows<D>(row < Nq ? dq + (size_t)row * D : nullptr,
                row + 8 < Nq ? dq + (size_t)(row + 8) * D : nullptr, acc, t,
                a.scale);
}

// both roles in one grid: blockIdx.x < ceil(Nk/ROWS) owns keys, the rest
// own query rows; blockIdx.y is the item
template <int D>
__global__ void __launch_bounds__(THREADS, D == 32 ? 2 : 1)
    attn_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int kv_tiles = (a.Nk + ROWS - 1) / ROWS;
  if ((int)blockIdx.x < kv_tiles)
    dkdv_role<D>(a, smem, blockIdx.y, blockIdx.x);
  else
    dq_role<D>(a, smem, blockIdx.y, blockIdx.x - kv_tiles);
}

template <int D>
static size_t smem_bytes(int Nk) {
  return Shape<D>::FLOATS * sizeof(float) +
         (size_t)((Nk + ROWS - 1) / ROWS) * sizeof(int);
}

template <int D>
static cudaError_t launch_bwd(const Args& a, int B, cudaStream_t s) {
  const size_t bytes = smem_bytes<D>(a.Nk);
  if (bytes > 232448) return cudaErrorInvalidValue;  // Nk beyond ~400k
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int blocks = (a.Nk + ROWS - 1) / ROWS + (a.Nq + ROWS - 1) / ROWS;
  attn_bwd_kernel<D><<<dim3(blocks, B), THREADS, bytes, s>>>(a);
  return cudaGetLastError();
}

// q, o, dout, dq (B,Nq,D); k, v, dk, dv (B,Nk,D); lse (B,Nq), the forward's
// natural-log row log-sum-exp; delta (B,Nq) scratch; mask (B,Nk) bytes or
// null. All float32, contiguous; q, k, v, o, dout and the outputs 16-byte
// aligned.
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
  const Args a{q, k, v, mask, lse, delta, dout, dq, dk, dv, Nq, Nk, scale};
  switch (D) {
    case 32:
      return (int)launch_bwd<32>(a, B, s);
    case 64:
      return (int)launch_bwd<64>(a, B, s);
    case 96:
      return (int)launch_bwd<96>(a, B, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
