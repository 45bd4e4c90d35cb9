// Descriptor sampling for Hopper (sm_90a): per-pixel L2 normalization,
// bicubic sampling and the per-keypoint L2 normalization in one kernel.
//
// Replaces the TPU kernels `_bicubic_kernel` (ops/pallas/bicubic.py:46)
// and `_bicubic_w2_kernel` (ops/pallas/bicubic.py:162) of
// accelerated_features_tpu, and `_sampler_kernel`
// (experiments/bicubic_mxu.py:58). They sample an already normalized
// (B,h,w,64) descriptor map; this kernel takes the backbone's raw map and
// computes
//
//   l2_normalize(sample_bicubic(l2_normalize(maps), pos, ref_hw))
//
// where l2_normalize is x / max(||x||, 1e-12) over the 64 channels and
// sample_bicubic follows grid_sample's bicubic rules (ix = x*w/(W-1) - 0.5,
// A = -0.75, zero padding). On an already normalized map the two agree up
// to rounding. Normalizing only the 16 taps a keypoint reads replaces the
// separate pass over the whole map that ran before sampling.
//
// Bound on the H100: the bytes the function needs are the raw map read once
// (1.9 MB at 800x608), the keypoints and the descriptors written, ~0.9 us at
// 3.35 TB/s; the normalizations' arithmetic (~5 operations a tap channel)
// hides under it. Keypoints come in score order, not in space, so a
// shared-memory tile of the map would not be reused; the map sits in L2 and
// each pixel is read ~8 times from cache (16.8 MB of tap rows at K = 4096).
// What is left is latency, instruction count and the launch: one half-warp
// a keypoint, each lane holding 4 channels as a float4, so a tap is one
// coalesced 256-byte row in 16-byte loads; all 16 taps' loads are issued
// before any arithmetic (64 registers of data), one round trip of memory
// latency a keypoint. The 16 taps' sums of squares are reduced together,
// 15 shuffles that leave lane t of the half-warp with tap t's sum; that lane
// takes the norm and its correctly rounded reciprocal, and 16 shuffles hand
// every lane all 16. Each tap is then multiplied by its reciprocal instead
// of divided by its norm (the plain version divides): 64 IEEE divisions
// and 16 square roots a lane, each with a branch to a slow path, had made
// the kernel twice as slow, and the products differ from the quotients by
// at most an ulp. Taps are weighted and summed in the plain version's order
// (`ops/sample.py`: rows by wx, then by wy); the final norm is 4 shuffle
// steps and 4 divisions.

#include <cuda_runtime.h>
#include <math.h>

#define C 64
// threads a block, chosen on the H100 with tools/kernel_variants.py at
// K = 4096: 128 took 0.00899 ms, 256 0.00921 ms, 512 0.00939 ms
#define BICUBIC_THREADS 128
#define KP_PER_BLOCK (BICUBIC_THREADS / 16)

// torch's cubic convolution kernel, A = -0.75, evaluated as the plain
// version writes it: k1 for |x| <= 1, k2 for 1 < |x| < 2
__device__ __forceinline__ float k1(float x) {
  float x2 = __fmul_rn(x, x), x3 = __fmul_rn(x2, x);
  return __fadd_rn(__fsub_rn(__fmul_rn(1.25f, x3), __fmul_rn(2.25f, x2)),
                   1.f);
}

__device__ __forceinline__ float k2(float x) {
  float x2 = __fmul_rn(x, x), x3 = __fmul_rn(x2, x);
  float s = __fsub_rn(__fmul_rn(-0.75f, x3), __fmul_rn(-3.75f, x2));
  s = __fadd_rn(s, __fmul_rn(-6.f, x));
  return __fsub_rn(s, -3.f);
}

// sum over the 16 lanes of a half-warp; every lane of the warp takes part
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// one exchange step of a reduce-scatter over the 16 lanes of a half-warp:
// each lane keeps the OFF sums whose tap index has its lane's bit OFF and
// adds its partner's values of them
template <int OFF>
__device__ __forceinline__ void exchange(float (&s)[16], bool up) {
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? s[i] : s[i + OFF];
    const float keep = up ? s[i + OFF] : s[i];
    s[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// lane t of each half-warp ends with the half-warp's sum of s[t]
__device__ __forceinline__ float reduce_scatter16(float (&s)[16], int lane) {
  exchange<8>(s, lane & 8);
  exchange<4>(s, lane & 4);
  exchange<2>(s, lane & 2);
  exchange<1>(s, lane & 1);
  return s[0];
}

__device__ __forceinline__ float sq4(float4 v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)),
                   __fadd_rn(__fmul_rn(v.z, v.z), __fmul_rn(v.w, v.w)));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s),
                     __fmul_rn(a.z, s), __fmul_rn(a.w, s));
}

__global__ void __launch_bounds__(BICUBIC_THREADS)
    bicubic_kernel(const float4* __restrict__ maps,
                   const float2* __restrict__ pos, float4* __restrict__ out,
                   int B, int h, int w, int K, float sx, float sy) {
  const int lane = threadIdx.x & 15;  // float4 slot: channels 4*lane..+3
  const long kp = (long)blockIdx.x * KP_PER_BLOCK + (threadIdx.x >> 4);
  // a half-warp past the last keypoint still runs, for the shuffles
  const bool live = kp < (long)B * K;
  const long kq = live ? kp : 0;
  const int b = (int)(kq / K);

  const float2 p = pos[kq];
  const float ix = __fsub_rn(__fmul_rn(p.x, sx), 0.5f);
  const float iy = __fsub_rn(__fmul_rn(p.y, sy), 0.5f);
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = (int)fx, y0 = (int)fy;
  const float tx = __fsub_rn(ix, fx), ty = __fsub_rn(iy, fy);
  const float wx[4] = {k2(__fadd_rn(tx, 1.f)), k1(tx), k1(__fsub_rn(1.f, tx)),
                       k2(__fsub_rn(2.f, tx))};
  const float wy[4] = {k2(__fadd_rn(ty, 1.f)), k1(ty), k1(__fsub_rn(1.f, ty)),
                       k2(__fsub_rn(2.f, ty))};

  // every tap's load in flight before any arithmetic; taps off the map
  // (and every tap of a half-warp past the end) are zero rows
  const float4* mb = maps + (size_t)b * h * w * (C / 4);
  float4 v[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int y = y0 + j - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = x0 + i - 1;
      v[4 * j + i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && x >= 0 && x < w && y >= 0 && y < h)
        v[4 * j + i] = __ldg(mb + ((size_t)y * w + x) * (C / 4) + lane);
    }
  }

  // lane t takes tap t's norm and reciprocal; every lane gets all 16
  float inv[16];
  {
    float ss[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) ss[q] = sq4(v[q]);
    const float mine = __fdiv_rn(
        1.f, fmaxf(sqrtf(reduce_scatter16(ss, lane)), 1e-12f));
#pragma unroll
    for (int q = 0; q < 16; ++q)
      inv[q] = __shfl_sync(0xffffffffu, mine, q, 16);
  }

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 s = mul4(mul4(v[4 * j + i], inv[4 * j + i]), wx[i]);
      row = i == 0 ? s : add4(row, s);
    }
    row = mul4(row, wy[j]);
    acc = j == 0 ? row : add4(acc, row);
  }

  const float den = fmaxf(sqrtf(half_warp_sum(sq4(acc))), 1e-12f);
  if (live)
    out[kp * (C / 4) + lane] =
        make_float4(__fdiv_rn(acc.x, den), __fdiv_rn(acc.y, den),
                    __fdiv_rn(acc.z, den), __fdiv_rn(acc.w, den));
}

extern "C" int bicubic_sample_normalize(const float* maps, const float* pos,
                                        float* out, int B, int h, int w,
                                        int K, float sx, float sy,
                                        void* stream) {
  const long kps = (long)B * K;
  const int blocks = (int)((kps + KP_PER_BLOCK - 1) / KP_PER_BLOCK);
  if (blocks > 0)
    bicubic_kernel<<<blocks, BICUBIC_THREADS, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(maps),
        reinterpret_cast<const float2*>(pos), reinterpret_cast<float4*>(out),
        B, h, w, K, sx, sy);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
