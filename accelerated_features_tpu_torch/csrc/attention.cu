// Single-head softmax attention with a key-side mask for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` in
// accelerated_features_tpu/ops/pallas/attention.py (entered through
// flash_attention; LighterGlue's self- and cross-attention). For each batch
// item it computes out[i,:] = sum_j softmax_j(scale * q[i].k[j]) v[j,:] in
// float32 with the online-softmax recurrence over key tiles, so the Nq x Nk
// score matrix never reaches device memory. Masked keys score -1e9 (never
// -inf): a row whose keys are all masked gets the mean of V over its Nk
// keys, as the plain version gives. Keys beyond Nk do not exist.
//
// Bound on the H100: operations. At Nq = Nk = 4096, D = 96 it does
// 4*Nq*Nk*D = 6.4 GFLOP against ~6 MB of q, k, v and out. The output is
// held to 2e-5, so both products run on the tensor cores at float32 grade
// as 3xTF32 (tf32x3.cuh): three m16n8k8 TF32 products an output, which
// makes the least time 3 * 4*Nq*keys*D / 495 TFLOP/s. The operands are
// split by cutting (split_cut, two instructions an element): its error,
// ~2^-20 of a product, is far inside the gate, and the splitting is most of
// what the kernel executes beside the products.
//
// Design: a block of eight warps owns 128 query rows, staged once in shared
// memory, and walks 64-key tiles of K and V that arrive by cp.async in a
// ring of three stages, so the next tiles load while this one is
// multiplied. Rows are padded to D+4 floats, which puts a warp's fragment
// loads of Q, K and V on 32 different banks. A warp owns 16 rows: it
// computes their 16x64 scores (fragments split into hi and lo in
// registers), and keeps the online softmax in registers in the accumulator
// layout, where a row lies in the four threads of a quad: the row max takes
// two shuffles a tile, the row sum is kept per thread and summed over the
// quad once at the end. The softmax runs in base 2 (scores times
// scale * log2 e, ex2 on the special-function unit). The probabilities
// never leave the registers: the score accumulator of an 8-key MMA tile
// holds keys 2t and 2t+1 where the A fragment of P.V wants k-slots t and
// t+4, and since the key index is summed over, V's rows are read in that
// order (slot t is key 2t, slot t+4 is key 2t+1). A key tile in which every
// key is masked is skipped when the batch item has an unmasked key
// somewhere (its keys then weigh exactly 0); an item with no unmasked key
// runs every tile and gets the mean of V. Mask bytes are read a tile ahead
// into a register, so nothing in the loop waits for device memory. One
// image pair gives only Nq/128 query tiles, fewer than the card has SMs, so
// the keys are also split over blockIdx.y, about one block an SM: each
// split writes its unnormalised (m, l, acc) and a small second kernel
// merges them. With one split the block writes the output itself.
//
// For training, the caller may pass `lse` (B,Nq): the row log-sum-exp of
// the masked, scaled scores in natural log, which the backward
// (attention_bwd.cu) recomputes the probabilities from. The block writes it
// with one split, the merge with more; a null `lse` writes nothing and
// leaves the inference launch as it was.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

#define WARPS 8
#define BM (16 * WARPS)
#define BN 64
#define PAD 4
#define STAGES 3
#define THREADS (32 * WARPS)
#define NEG (-1e9f)
#define LN2 0.6931471805599453f

// 2^x on the special-function unit; results below 2^-126 are 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
constexpr int smem_bytes(int tiles_per_split) {
  return (BM * (D + PAD) + STAGES * 2 * BN * (D + PAD)) * (int)sizeof(float) +
         (STAGES * BN + tiles_per_split) * (int)sizeof(int);
}

// s = Q_w . K_t^T for a warp's 16 query rows and a tile's 64 keys, 3xTF32:
// term by term over the eight independent accumulators, the small terms
// first, so no product waits for the one before it
template <int D>
__device__ __forceinline__ void qk_scores(const float* Qw, const float* Kt,
                                          int g, int t, float (&s)[8][4]) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t a_hi[4], a_lo[4];
    const float* p = Qw + ks * 8;
    tf32x3::split_cut(p[0], a_hi[0], a_lo[0]);
    tf32x3::split_cut(p[8 * LD], a_hi[1], a_lo[1]);
    tf32x3::split_cut(p[4], a_hi[2], a_lo[2]);
    tf32x3::split_cut(p[8 * LD + 4], a_hi[3], a_lo[3]);
    uint32_t b_hi[8][2], b_lo[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* pk = Kt + (j * 8 + g) * LD + ks * 8 + t;
      tf32x3::split_cut(pk[0], b_hi[j][0], b_lo[j][0]);
      tf32x3::split_cut(pk[4], b_hi[j][1], b_lo[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) tf32x3::mma(s[j], a_lo, b_hi[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) tf32x3::mma(s[j], a_hi, b_lo[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) tf32x3::mma(s[j], a_hi, b_hi[j]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    attn_partial_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, float* __restrict__ out,
                        float* __restrict__ lse, int Nq, int Nk, float scale,
                        int tiles_per_split) {
  constexpr int LD = D + PAD;  // row stride of Q, K and V, = 4 mod 32
  constexpr int NO = D / 8;    // 8-column MMA tiles of the output
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [BM][LD]
  float* KVs = Qs + BM * LD;   // [STAGES][K: [BN][LD], V: [BN][LD]]
  // per stage and key: 1 attend, 0 masked, -1 beyond Nk
  int* Ms = reinterpret_cast<int*>(KVs + STAGES * 2 * BN * LD);
  int* live = Ms + STAGES * BN;  // per tile of this split: has an unmasked key

  const int b = blockIdx.z, split = blockIdx.y, r0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* qb = q + (size_t)b * Nq * D;
  const float* kb = k + (size_t)b * Nk * D;
  const float* vb = v + (size_t)b * Nk * D;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * Nk;
  const int n_tiles = (Nk + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  for (int i = tid; i < BM * (D / 4); i += THREADS) {
    const int row = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool real = r0 + row < Nq;
    tf32x3::cp_async16(Qs + row * LD + c,
                       qb + (size_t)(real ? r0 + row : 0) * D + c, real);
  }

  // which tiles may be skipped: those without an unmasked key, if the item
  // has an unmasked key at all
  bool may_skip = false;
  if (mb != nullptr) {
    for (int i = tid; i < tiles_per_split; i += THREADS) live[i] = 0;
    __syncthreads();
    int any = 0;
    for (int i = tid; i < Nk; i += THREADS) {
      if (mb[i] != 0) {
        any = 1;
        const int tile = i / BN;
        if (tile >= t_begin && tile < t_end) live[tile - t_begin] = 1;
      }
    }
    may_skip = __syncthreads_or(any) != 0;
  }
  auto next_live = [&](int tile) {
    while (tile < t_end && may_skip && live[tile - t_begin] == 0) ++tile;
    return tile;
  };

  int code_on_its_way = 0, code_slot = -1;
  auto load_tile = [&](int tile, int slot) {
    const int n0 = tile * BN;
    float* Kt = KVs + slot * 2 * BN * LD;
    float* Vt = Kt + BN * LD;
    for (int i = tid; i < BN * (D / 4); i += THREADS) {
      const int row = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool real = n0 + row < Nk;
      const size_t src = (size_t)(real ? n0 + row : 0) * D + c;
      tf32x3::cp_async16(Kt + row * LD + c, kb + src, real);
      tf32x3::cp_async16(Vt + row * LD + c, vb + src, real);
    }
    if (tid < BN) {  // the mask byte is read now and stored a tile later
      const int col = n0 + tid;
      code_slot = slot;
      code_on_its_way = col >= Nk ? -1
                        : (mb == nullptr || mb[col] != 0) ? 1
                                                          : 0;
    }
  };
  // Store the mask code read by the last load_tile: called a tile after the
  // read was started, so no thread waits for device memory in the loop
  auto store_code = [&]() {
    if (tid < BN && code_slot >= 0) Ms[code_slot * BN + tid] = code_on_its_way;
  };

  int load_t = next_live(t_begin), load_slot = 0;
  int tile = load_t, slot = 0;
  for (int s = 0; s < STAGES - 1; ++s) {
    store_code();
    if (load_t < t_end) {
      load_tile(load_t, load_slot);
      load_t = next_live(load_t + 1);
    }
    load_slot = (load_slot + 1) % STAGES;
    tf32x3::cp_async_commit();
  }

  // this thread's rows are warp*16 + g (h = 0) and + 8 (h = 1); acc[n] holds
  // (h=0: columns n*8 + 2t, +1), (h=1: the same columns). The softmax runs
  // in base 2: m is the row max of score * scale * log2(e).
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* Qw = Qs + (warp * 16 + g) * LD + t;
  const float scale2 = scale * 1.4426950408889634f;

  while (tile < t_end) {
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();  // this tile has landed; the previous one is computed
    store_code();
    if (load_t < t_end) {
      load_tile(load_t, load_slot);
      load_t = next_live(load_t + 1);
    }
    load_slot = (load_slot + 1) % STAGES;
    tf32x3::cp_async_commit();

    const float* Kt = KVs + slot * 2 * BN * LD;
    const float* Vt = Kt + BN * LD;
    float s[8][4];
    qk_scores<D>(Qw, Kt, g, t, s);

    // online softmax; s[j][h*2+e] is row h, key j*8 + 2t + e
    int code[8][2];
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 c2 =
          *reinterpret_cast<const int2*>(Ms + slot * BN + j * 8 + 2 * t);
      code[j][0] = c2.x;
      code[j][1] = c2.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = code[j][e & 1];
        s[j][e] = c > 0 ? s[j][e] * scale2 : NEG;
        if (c >= 0) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      corr[h] = fast_exp2(m[h] - m_new[h]);
      m[h] = m_new[h];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = code[j][e & 1] >= 0 ? fast_exp2(s[j][e] - m_new[e >> 1])
                                      : 0.f;
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];  // per thread
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // acc += P . V, eight keys a step; k-slot t is key 2t, t+4 is key 2t+1,
    // so the score accumulator is the A fragment as it stands
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t a_hi[4], a_lo[4];
      tf32x3::split_cut(s[j][0], a_hi[0], a_lo[0]);  // (g,   key 2t)
      tf32x3::split_cut(s[j][2], a_hi[1], a_lo[1]);  // (g+8, key 2t)
      tf32x3::split_cut(s[j][1], a_hi[2], a_lo[2]);  // (g,   key 2t+1)
      tf32x3::split_cut(s[j][3], a_hi[3], a_lo[3]);  // (g+8, key 2t+1)
      const float* pv = Vt + (j * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += 4) {
        uint32_t b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          tf32x3::split_cut(pv[(n0 + n) * 8], b_hi[n][0], b_lo[n][0]);
          tf32x3::split_cut(pv[LD + (n0 + n) * 8], b_hi[n][1], b_lo[n][1]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) tf32x3::mma(acc[n0 + n], a_lo, b_hi[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n) tf32x3::mma(acc[n0 + n], a_hi, b_lo[n]);
#pragma unroll
        for (int n = 0; n < 4; ++n) tf32x3::mma(acc[n0 + n], a_hi, b_hi[n]);
      }
    }

    slot = (slot + 1) % STAGES;
    tile = next_live(tile + 1);
  }
  tf32x3::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const bool whole = gridDim.y == 1;
  const size_t base = ((size_t)b * gridDim.y + split) * Nq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + h * 8 + g;
    if (row >= Nq) continue;
    const float w = whole ? 1.f / fmaxf(l[h], 1e-30f) : 1.f;
    float* dst = whole ? out + ((size_t)b * Nq + row) * D
                       : part_acc + (base + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * t) =
          make_float2(acc[n][h * 2] * w, acc[n][h * 2 + 1] * w);
    if (!whole && t == 0) {
      part_ml[(base + row) * 2] = m[h];
      part_ml[(base + row) * 2 + 1] = l[h];
    }
    if (whole && lse != nullptr && t == 0)
      lse[(size_t)b * Nq + row] = (m[h] + log2f(fmaxf(l[h], 1e-30f))) * LN2;
  }
}

// out = sum_s w_s acc_s / sum_s w_s l_s with w_s = 2^(m_s - max_s m_s);
// lse (may be null) = (max_s m_s + log2 sum_s w_s l_s) * ln 2
__global__ void attn_merge_kernel(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml,
                                  float* __restrict__ out,
                                  float* __restrict__ lse, int B, int Nq,
                                  int D, int splits) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)B * Nq * D) return;
  const int c = (int)(t % D);
  const long br = t / D;
  const int row = (int)(br % Nq), b = (int)(br / Nq);
  float m_all = NEG;
  for (int s = 0; s < splits; ++s)
    m_all = fmaxf(m_all, part_ml[(((size_t)b * splits + s) * Nq + row) * 2]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t r = ((size_t)b * splits + s) * Nq + row;
    const float w = exp2f(part_ml[r * 2] - m_all);
    den = fmaf(w, part_ml[r * 2 + 1], den);
    num = fmaf(w, part_acc[r * D + c], num);
  }
  out[t] = num / fmaxf(den, 1e-30f);
  if (lse != nullptr && c == 0)
    lse[br] = (m_all + log2f(fmaxf(den, 1e-30f))) * LN2;
}

template <int D>
static cudaError_t launch_partial(const float* q, const float* k,
                                  const float* v, const uint8_t* mask,
                                  float* part_acc, float* part_ml, float* out,
                                  float* lse, int B, int Nq, int Nk,
                                  float scale, int splits, cudaStream_t s) {
  const int n_tiles = (Nk + BN - 1) / BN;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  if ((n_tiles + tiles_per_split - 1) / tiles_per_split != splits)
    return cudaErrorInvalidValue;  // a split would be empty
  const int bytes = smem_bytes<D>(tiles_per_split);
  cudaError_t err = cudaFuncSetAttribute(
      attn_partial_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + BM - 1) / BM, splits, B);
  attn_partial_kernel<D><<<grid, THREADS, bytes, s>>>(
      q, k, v, mask, part_acc, part_ml, out, lse, Nq, Nk, scale,
      tiles_per_split);
  return cudaGetLastError();
}

// q (B,Nq,D), k and v (B,Nk,D), out (B,Nq,D) float32; mask (B,Nk) bytes or
// null; part_acc (B,splits,Nq,D) and part_ml (B,splits,Nq,2) scratch, unused
// (may be null) when splits is 1; lse (B,Nq) float32 or null.
extern "C" int attention_forward(const float* q, const float* k,
                                 const float* v, const uint8_t* mask,
                                 float* part_acc, float* part_ml, float* out,
                                 float* lse, int B, int Nq, int Nk, int D,
                                 float scale, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || Nq < 1 || Nk < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_partial<32>(q, k, v, mask, part_acc, part_ml, out, lse, B,
                               Nq, Nk, scale, splits, s);
      break;
    case 64:
      err = launch_partial<64>(q, k, v, mask, part_acc, part_ml, out, lse, B,
                               Nq, Nk, scale, splits, s);
      break;
    case 96:
      err = launch_partial<96>(q, k, v, mask, part_acc, part_ml, out, lse, B,
                               Nq, Nk, scale, splits, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long n = (long)B * Nq * D;
  attn_merge_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(
      part_acc, part_ml, out, lse, B, Nq, D, splits);
  return (int)cudaGetLastError();
}

// dynamic shared memory of a block of attn_partial_kernel<D>, or -1
extern "C" int attention_smem_bytes(int D, int tiles_per_split) {
  switch (D) {
    case 32:
      return smem_bytes<32>(tiles_per_split);
    case 64:
      return smem_bytes<64>(tiles_per_split);
    case 96:
      return smem_bytes<96>(tiles_per_split);
    default:
      return -1;
  }
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
