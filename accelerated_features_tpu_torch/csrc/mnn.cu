// Fused mutual-nearest-neighbour matching for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mnn_kernel` in
// accelerated_features_tpu/ops/pallas/mnn.py (entered through
// mnn_match_fused / batch_mnn_match_fused). For each pair b of a batch,
// d1 (K1,64) and d2 (K2,64), it finds every row's best column and every
// column's best row of the (K1,K2) similarity without writing that matrix
// to device memory; a second, tiny kernel forms idx1, the mutual test,
// `& valid1` and the min_cossim gate. Masking is the plain version's:
// invalid columns are -1e9 for the row argmax, invalid rows and columns
// are -1e9 for the column argmax, and ties go to the first index.
//
// Bound on the H100: operations. At K1 = K2 = 4096 it does 2*K1*K2*64 =
// 2.1 GFLOP per pair against ~2 MB of descriptors. The similarities must be
// float32-grade (bf16- or single-TF32 values flip mutual-argmax decisions),
// so each product runs on the tensor cores as 3xTF32 (tf32x3.cuh): three
// m16n8k8 TF32 products an output into a float32 accumulator, which makes
// the least time 3 * 2.1 GFLOP / 495 TFLOP/s = 0.013 ms.
//
// Design: a block of four warps owns a panel of 128 rows of d1, held in
// shared memory for the whole kernel, and walks 64-column tiles of d2 that
// arrive by cp.async in a ring of three stages, so the next tiles load
// while this one is multiplied. Rows are padded to 68 floats, which puts a
// warp's fragment loads on 32 different banks. A warp computes 32 rows x 64
// columns a tile (2 x 8 MMA tiles, 64 accumulators a thread), splitting the
// fragments into hi and lo in registers (the exact split: the similarities
// decide argmax ties at 1e-6). Each thread keeps the running best column of
// its four rows in registers over the whole loop; the row result is written
// once at the end. The columns are split over gridDim.x only as far as the
// card needs blocks (about two an SM); only then the row side goes through
// atomicMax on a packed 64-bit key, the order-preserving bits of the float
// above the complemented index, which keeps the largest similarity and, on
// ties, the smallest index in any order. The column side is reduced in the
// thread over its rows, over the warp's rows by shuffles (all 16 columns of
// a thread side by side, branch-free, so the shuffle latencies overlap),
// over the block's warps in shared memory, and leaves the block as one
// atomicMax a column and tile. Mask bytes are read a tile ahead into a
// register, so nothing in the loop waits for device memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "tf32x3.cuh"

#define C 64
#define BN 64
#define LD (C + 4)  // row stride in shared memory, = 4 mod 32
#define STAGES 3
#define WARPS 4
#define BM (32 * WARPS)
#define THREADS (32 * WARPS)
#define NEG (-1e9f)

typedef unsigned long long u64;

__device__ __forceinline__ unsigned ordered_bits(float f) {
  unsigned u = __float_as_uint(__fadd_rn(f, 0.f));  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ u64 make_key(float v, int idx) {
  return ((u64)ordered_bits(v) << 32) | (u64)(0xffffffffu - (unsigned)idx);
}

__device__ __forceinline__ int key_index(u64 k) {
  return (int)(0xffffffffu - (unsigned)(k & 0xffffffffu));
}

__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a > b ? a : b; }

constexpr int SMEM_BYTES = (BM * LD + STAGES * BN * LD) * (int)sizeof(float) +
                           STAGES * BN * (int)sizeof(int) +
                           2 * WARPS * BN * (int)sizeof(u64);

__global__ void __launch_bounds__(THREADS, 2)
    mnn_panel_kernel(const float* __restrict__ d1,
                     const float* __restrict__ d2,
                     const uint8_t* __restrict__ v1,
                     const uint8_t* __restrict__ v2, u64* __restrict__ rowkey,
                     u64* __restrict__ colkey, int K1, int K2,
                     int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [BM][LD], the row panel
  float* Bs = As + BM * LD;                        // [STAGES][BN][LD]
  u64* ckw = reinterpret_cast<u64*>(Bs + STAGES * BN * LD);  // [2][WARPS][BN]
  // per stage and column: 1 valid, 0 invalid, -1 beyond K2
  int* cv = reinterpret_cast<int*>(ckw + 2 * WARPS * BN);

  const int b = blockIdx.z, r0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* A = d1 + (size_t)b * K1 * C;
  const float* Bm = d2 + (size_t)b * K2 * C;
  const int n_tiles = (K2 + BN - 1) / BN;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int nt = min(t_begin + tiles_per_split, n_tiles) - t_begin;

  int code_on_its_way = 0, code_slot = -1;
  auto load_tile = [&](int tile, int slot) {
    const int c0 = tile * BN;
    float* dst = Bs + slot * BN * LD;
    for (int i = tid; i < BN * (C / 4); i += THREADS) {
      const int row = i / (C / 4), ch = (i % (C / 4)) * 4;
      const bool real = c0 + row < K2;
      tf32x3::cp_async16(dst + row * LD + ch,
                         Bm + (size_t)(real ? c0 + row : 0) * C + ch, real);
    }
    if (tid < BN) {  // the mask byte is read now and stored a tile later
      const int col = c0 + tid;
      code_slot = slot;
      code_on_its_way =
          col >= K2 ? -1
          : (v2 == nullptr || v2[(size_t)b * K2 + col] != 0) ? 1
                                                             : 0;
    }
  };
  // Store the column code read by the last load_tile: called a tile after
  // the read was started, so no thread waits for device memory in the loop
  auto store_code = [&]() {
    if (tid < BN && code_slot >= 0) cv[code_slot * BN + tid] = code_on_its_way;
  };

  for (int i = tid; i < BM * (C / 4); i += THREADS) {
    const int row = i / (C / 4), ch = (i % (C / 4)) * 4;
    const bool real = r0 + row < K1;
    tf32x3::cp_async16(As + row * LD + ch,
                       A + (size_t)(real ? r0 + row : 0) * C + ch, real);
  }
  for (int s = 0; s < STAGES - 1; ++s) {
    store_code();
    if (s < nt) load_tile(t_begin + s, s);
    tf32x3::cp_async_commit();
  }

  // this thread's rows: r0 + warp*32 + mt*16 + h*8 + g, index mt*2 + h
  bool rin[4], rval[4];
  float best_v[4], row_fill[4];
  int best_i[4], row_id[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    row_id[r] = r0 + warp * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
    rin[r] = row_id[r] < K1;
    rval[r] = rin[r] && (v1 == nullptr ||
                         v1[(size_t)b * K1 + row_id[r]] != 0);
    row_fill[r] = rin[r] ? NEG : -CUDART_INF_F;  // what the column side sees
    best_v[r] = -CUDART_INF_F;
    best_i[r] = -1;
  }

  // one atomicMax a column for the tile the block finished last
  auto flush_columns = [&](int tile, int buf) {
    if (tid < BN && tile * BN + tid < K2) {
      u64 key = 0ull;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        key = umax64(key, ckw[(buf * WARPS + w) * BN + tid]);
      if (key != 0ull)
        atomicMax(&colkey[(size_t)b * K2 + tile * BN + tid], key);
    }
  };

  for (int it = 0; it < nt; ++it) {
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` has landed; tile it-1 is computed
    if (it > 0) flush_columns(t_begin + it - 1, (it - 1) & 1);
    store_code();
    if (it + STAGES - 1 < nt)
      load_tile(t_begin + it + STAGES - 1, (it + STAGES - 1) % STAGES);
    tf32x3::cp_async_commit();

    const int slot = it % STAGES, c0 = (t_begin + it) * BN;
    const float* Bt = Bs + slot * BN * LD;
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll 2
    for (int ks = 0; ks < C / 8; ++ks) {
      uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = As + (warp * 32 + mt * 16 + g) * LD + ks * 8 + t;
        tf32x3::split(p[0], a_hi[mt][0], a_lo[mt][0]);
        tf32x3::split(p[8 * LD], a_hi[mt][1], a_lo[mt][1]);
        tf32x3::split(p[4], a_hi[mt][2], a_lo[mt][2]);
        tf32x3::split(p[8 * LD + 4], a_hi[mt][3], a_lo[mt][3]);
      }
      uint32_t b_hi[8][2], b_lo[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* p = Bt + (j * 8 + g) * LD + ks * 8 + t;
        tf32x3::split(p[0], b_hi[j][0], b_lo[j][0]);
        tf32x3::split(p[4], b_hi[j][1], b_lo[j][1]);
      }
      // term by term over the 16 independent accumulators, the small
      // terms first: no product waits for the one before it
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tf32x3::mma(acc[mt][j], a_lo[mt], b_hi[j]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tf32x3::mma(acc[mt][j], a_hi[mt], b_lo[j]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tf32x3::mma(acc[mt][j], a_hi[mt], b_hi[j]);
    }

    // acc[mt][j][h*2+e] is row mt*2+h, column c0 + j*8 + 2t + e. The 16
    // columns of a thread are reduced side by side, every shuffle round
    // over all of them at once, so the rounds' latencies overlap.
    int code[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 c2 =
          *reinterpret_cast<const int2*>(cv + slot * BN + j * 8 + 2 * t);
      code[2 * j] = c2.x;
      code[2 * j + 1] = c2.y;
    }
    // Branch-free (selects only), so the 16 columns' chains interleave.
    // Fill values stand in for what must not win: -1e9 for a masked column
    // or row, -inf for one beyond K2 or K1 (never above the -inf start).
    float cbest[16], top[16];
    int crow[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int j = c >> 1, e = c & 1, col = c0 + j * 8 + 2 * t + e;
      const bool valid = code[c] > 0;
      const float col_fill = code[c] >= 0 ? NEG : -CUDART_INF_F;
      cbest[c] = -CUDART_INF_F;
      crow[c] = INT_MAX;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // row side: columns come in increasing order, so `>` keeps the
        // first of equal similarities
        const float v = valid ? acc[r >> 1][j][(r & 1) * 2 + e] : col_fill;
        const bool row_better = v > best_v[r];
        best_v[r] = row_better ? v : best_v[r];
        best_i[r] = row_better ? col : best_i[r];
        // column side: the best of this thread's rows, in increasing order
        const float w = rval[r] ? v : row_fill[r];
        const bool col_better = w > cbest[c];
        cbest[c] = col_better ? w : cbest[c];
        crow[c] = col_better ? row_id[r] : crow[c];
      }
      top[c] = cbest[c];
    }
    // then over the eight lanes that hold the column's other rows: the
    // largest value, and the smallest row among those that have it
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int c = 0; c < 16; ++c)
        top[c] = fmaxf(top[c], __shfl_xor_sync(0xffffffffu, top[c], off));
#pragma unroll
    for (int c = 0; c < 16; ++c)
      crow[c] = cbest[c] == top[c] ? crow[c] : INT_MAX;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int c = 0; c < 16; ++c)
        crow[c] = min(crow[c], __shfl_xor_sync(0xffffffffu, crow[c], off));
    if (g == 0) {
      u64* ck = ckw + (((it & 1) * WARPS) + warp) * BN;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ulonglong2 keys;
        keys.x = (code[2 * j] >= 0 && crow[2 * j] != INT_MAX)
                     ? make_key(top[2 * j], crow[2 * j])
                     : 0ull;
        keys.y = (code[2 * j + 1] >= 0 && crow[2 * j + 1] != INT_MAX)
                     ? make_key(top[2 * j + 1], crow[2 * j + 1])
                     : 0ull;
        *reinterpret_cast<ulonglong2*>(ck + j * 8 + 2 * t) = keys;
      }
    }
  }
  __syncthreads();
  flush_columns(t_begin + nt - 1, (nt - 1) & 1);

  // the four lanes of a row hold different columns: merge by key
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u64 key = best_i[r] >= 0 ? make_key(best_v[r], best_i[r]) : 0ull;
    key = umax64(key, __shfl_xor_sync(0xffffffffu, key, 1));
    key = umax64(key, __shfl_xor_sync(0xffffffffu, key, 2));
    if (t == 0 && rin[r] && key != 0ull) {
      u64* dst = &rowkey[(size_t)b * K1 + row_id[r]];
      if (gridDim.x == 1)
        *dst = key;
      else
        atomicMax(dst, key);
    }
  }
}

__global__ void mnn_finish_kernel(const u64* __restrict__ rowkey,
                                  const u64* __restrict__ colkey,
                                  const uint8_t* __restrict__ v1,
                                  int64_t* __restrict__ idx1,
                                  uint8_t* __restrict__ mask, int B, int K1,
                                  int K2, float min_cossim) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)B * K1) return;
  const int b = (int)(t / K1), i = (int)(t % K1);
  const u64 rk = rowkey[t];
  const int j = key_index(rk);
  const int back = key_index(colkey[(size_t)b * K2 + j]);
  bool m = back == i && (v1 == nullptr || v1[t] != 0);
  if (min_cossim > 0.f)
    m = m && from_ordered_bits((unsigned)(rk >> 32)) > min_cossim;
  idx1[t] = j;
  mask[t] = m ? 1 : 0;
}

// d1 (B,K1,64), d2 (B,K2,64) float32; v1 (B,K1), v2 (B,K2) bytes or null;
// keys: scratch of B*(K1+K2) 64-bit words, the row keys then the column
// keys; idx1 (B,K1) int64 and mask (B,K1) bytes out.
extern "C" int mnn_match(const float* d1, const float* d2, const uint8_t* v1,
                         const uint8_t* v2, u64* keys, int64_t* idx1,
                         uint8_t* mask, int B, int K1, int K2,
                         float min_cossim, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || K1 < 1 || K2 < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mnn_panel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  // split the columns until every SM has about two blocks, no further
  const int panels = (K1 + BM - 1) / BM, n_tiles = (K2 + BN - 1) / BN;
  const long blocks = (long)B * panels;
  int splits = (int)std::min(
      (long)n_tiles, std::max(1l, (2l * sms + blocks - 1) / blocks));
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;  // none empty
  // the column keys always start at 0; the row keys only when several
  // blocks merge into them by atomicMax
  u64* rowkey = keys;
  u64* colkey = keys + (size_t)B * K1;
  err = splits > 1
            ? cudaMemsetAsync(keys, 0, sizeof(u64) * B * ((size_t)K1 + K2), s)
            : cudaMemsetAsync(colkey, 0, sizeof(u64) * B * K2, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(splits, panels, B);
  mnn_panel_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      d1, d2, v1, v2, rowkey, colkey, K1, K2, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = (long)B * K1;
  mnn_finish_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(
      rowkey, colkey, v1, idx1, mask, B, K1, K2, min_cossim);
  return (int)cudaGetLastError();
}

// dynamic shared memory of a block of mnn_panel_kernel
extern "C" int mnn_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
