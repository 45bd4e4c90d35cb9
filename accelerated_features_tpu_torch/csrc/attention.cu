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
// 4*Nq*Nk*D = 6.4 GFLOP against ~6 MB of q, k, v and out. The scores feed a
// softmax whose output is compared at 2e-5, so the products are FP32 FMAs on
// the CUDA cores. Design: a block owns 64 query rows and walks 64-key tiles
// of K and V staged in shared memory. Each of its 256 threads computes a
// 4x4 piece of the 64x64 score tile (rows 4*ty.., keys tx+16*j, which keeps
// the float4 reads of K free of bank conflicts), reduces row max and row
// sum over the 16 lanes that share its rows by shuffles, writes the
// probabilities transposed to shared memory, and accumulates a 4 x D/16
// piece of P.V; the running (m, l, acc) stay in registers. One image pair
// gives only Nq/64 query tiles, fewer than the card has SMs, so the keys
// are also split over blockIdx.y: each split writes its unnormalised
// (m, l, acc) and a small second kernel merges the splits.

#include <cuda_runtime.h>
#include <stdint.h>

#define BM 64
#define BN 64
#define PAD 4
#define THREADS 256
#define NEG (-1e9f)

template <int D>
constexpr int smem_floats() {
  return BM * (D + PAD) + BN * (D + PAD) + BN * D + BN * (BM + PAD) + BN;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    attn_partial_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ mask,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int Nq, int Nk,
                        float scale, int tiles_per_split) {
  constexpr int LD = D + PAD;   // row stride of Qs and Ks, = 4 mod 32
  constexpr int LP = BM + PAD;  // row stride of Ps
  constexpr int CP = D / 32;    // float2 column pairs a thread owns in P.V
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [BM][LD]
  float* Ks = Qs + BM * LD;     // [BN][LD]
  float* Vs = Ks + BN * LD;     // [BN][D]
  float* Ps = Vs + BN * D;      // [BN][LP], Ps[key][row]
  int* Ms = reinterpret_cast<int*>(Ps + BN * LP);  // 1 attend, 0 masked,
                                                   // -1 beyond Nk
  const int b = blockIdx.z, split = blockIdx.y, r0 = blockIdx.x * BM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + (size_t)b * Nq * D;
  const float* kb = k + (size_t)b * Nk * D;
  const float* vb = v + (size_t)b * Nk * D;

  for (int i = tid; i < BM * D / 4; i += THREADS) {
    const int row = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < Nq)
      a = __ldg(reinterpret_cast<const float4*>(qb + (size_t)(r0 + row) * D +
                                                c));
    *reinterpret_cast<float4*>(Qs + row * LD + c) = a;
  }

  float m[4], l[4], acc[4][2 * CP];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * CP; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (Nk + BN - 1) / BN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * BN;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BN * D / 4; i += THREADS) {
      const int row = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (n0 + row < Nk) {
        kk = __ldg(reinterpret_cast<const float4*>(
            kb + (size_t)(n0 + row) * D + c));
        vv = __ldg(reinterpret_cast<const float4*>(
            vb + (size_t)(n0 + row) * D + c));
      }
      *reinterpret_cast<float4*>(Ks + row * LD + c) = kk;
      *reinterpret_cast<float4*>(Vs + row * D + c) = vv;
    }
    if (tid < BN) {
      const int col = n0 + tid;
      Ms[tid] = col >= Nk ? -1
                : (mask == nullptr || mask[(size_t)b * Nk + col] != 0) ? 1
                                                                       : 0;
    }
    __syncthreads();

    // scores of rows ty*4+i against keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* qrow = Qs + ty * 4 * LD;
    const float* krow = Ks + tx * LD;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qrow + i * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(krow + j * 16 * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
        }
    }

    int code[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) code[j] = Ms[tx + 16 * j];

    // online softmax, a row at a time; the 16 lanes with this ty share it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m_new = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = code[j] > 0 ? s[i][j] * scale : NEG;
        if (code[j] >= 0) m_new = fmaxf(m_new, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, off));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = code[j] >= 0 ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * CP; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx + 16 * j) * LP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[rows ty*4+i][columns 32*c + 2*tx, +1] += P . V
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + j * LP + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float2 vv =
            *reinterpret_cast<const float2*>(Vs + j * D + 32 * c + 2 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * c] = fmaf(pv[i], vv.x, acc[i][2 * c]);
          acc[i][2 * c + 1] = fmaf(pv[i], vv.y, acc[i][2 * c + 1]);
        }
      }
    }
  }

  const size_t base = ((size_t)b * gridDim.y + split) * Nq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= Nq) continue;
    float* dst = part_acc + (base + row) * D;
#pragma unroll
    for (int c = 0; c < CP; ++c)
      *reinterpret_cast<float2*>(dst + 32 * c + 2 * tx) =
          make_float2(acc[i][2 * c], acc[i][2 * c + 1]);
    if (tx == 0) {
      part_ml[(base + row) * 2] = m[i];
      part_ml[(base + row) * 2 + 1] = l[i];
    }
  }
}

// out = sum_s w_s acc_s / sum_s w_s l_s with w_s = exp(m_s - max_s m_s)
__global__ void attn_merge_kernel(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml,
                                  float* __restrict__ out, int B, int Nq,
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
    const float w = expf(part_ml[r * 2] - m_all);
    den = fmaf(w, part_ml[r * 2 + 1], den);
    num = fmaf(w, part_acc[r * D + c], num);
  }
  out[t] = num / fmaxf(den, 1e-30f);
}

template <int D>
static cudaError_t launch_partial(const float* q, const float* k,
                                  const float* v, const uint8_t* mask,
                                  float* part_acc, float* part_ml, int B,
                                  int Nq, int Nk, float scale, int splits,
                                  cudaStream_t s) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_partial_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (Nk + BN - 1) / BN;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((Nq + BM - 1) / BM, splits, B);
  attn_partial_kernel<D><<<grid, THREADS, bytes, s>>>(
      q, k, v, mask, part_acc, part_ml, Nq, Nk, scale, tiles_per_split);
  return cudaGetLastError();
}

// q (B,Nq,D), k and v (B,Nk,D), out (B,Nq,D) float32; mask (B,Nk) bytes or
// null; part_acc (B,splits,Nq,D) and part_ml (B,splits,Nq,2) scratch.
extern "C" int attention_forward(const float* q, const float* k,
                                 const float* v, const uint8_t* mask,
                                 float* part_acc, float* part_ml, float* out,
                                 int B, int Nq, int Nk, int D, float scale,
                                 int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || Nq < 1 || Nk < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch_partial<32>(q, k, v, mask, part_acc, part_ml, B, Nq, Nk,
                               scale, splits, s);
      break;
    case 64:
      err = launch_partial<64>(q, k, v, mask, part_acc, part_ml, B, Nq, Nk,
                               scale, splits, s);
      break;
    case 96:
      err = launch_partial<96>(q, k, v, mask, part_acc, part_ml, B, Nq, Nk,
                               scale, splits, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long n = (long)B * Nq * D;
  attn_merge_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(
      part_acc, part_ml, out, B, Nq, D, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
