// Fused XFeat stem (block1 + avg-pool skip) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_stem_kernel` in
// accelerated_features_tpu/experiments/stem.py (entered through
// `stem_fused`). On the normalized gray image x (B,H,W), H and W divisible
// by 32, it computes in one launch
//   c1 = relu(conv3x3 s1 (x,  W1) + b1)    1 -> 4
//   c2 = relu(conv3x3 s2 (c1, W2) + b2)    4 -> 8    (/2)
//   c3 = relu(conv3x3 s1 (c2, W3) + b3)    8 -> 8
//   c4 = relu(conv3x3 s2 (c3, W4) + b4)    8 -> 24   (/4)
//   out = c4 + (avgpool4x4(x) * Wskip + bskip)
// with BatchNorm folded into the biases. Every conv pads ITS OWN input with
// one ring of zeros at the image border: an intermediate value at a
// position outside the image is 0, not relu(bias).
//
// The TPU kernel feeds these 1-24 channel convs to a 128-lane matrix unit
// through banded block-Toeplitz weights; none of that is carried over. Here
// the convolutions are direct. A block owns an 8x8 tile of the /4 output
// and keeps the whole chain in shared memory: the 41x41 input tile with its
// halo, then the 39x39 tile of c1, 19x19 of c2, 17x17 of c3 (planar, one
// plane a channel; c3 reuses c1's room). Device memory sees one read of the
// image (plus the halo overlap between blocks) and one write of the
// output, which is NCHW (B,24,H/4,W/4), the layout the next convolution
// reads, so no transpose pass follows.
//
// Bound on the H100: operations in float32 (720 FLOP an input pixel
// against 10 bytes), bytes in bfloat16, and both bounds are microseconds.
// What limits this design is shared memory: each thread owns one position
// and 4 or 6 output channels, so every FMA group costs one activation load
// and one broadcast weight load (weights are laid out [ci][dy][dx][co] so
// a thread reads its channels' weights as one float4 or three float2).
// Work items are ordered channel group first, so the threads of a warp
// share their weight addresses. With 53,504 bytes of dynamic shared memory
// four blocks fit an SM.
//
// bf16 mode follows the TPU kernel's rounding points: input and weights are
// bf16 values (the wrapper rounds the weights, 1/16 of the pooling folded
// into the skip weight), products are summed in float32, the float32 bias
// is added, ReLU, and each activation is rounded to bf16 between layers;
// the pooled row sums are rounded to bf16; the final sum is float32 and is
// rounded once on the way out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define T 8                 // output tile (T x T of the /4 grid)
#define NT 256              // threads a block
#define IN_S (4 * T + 9)    // input tile side, with halo
#define C1_S (4 * T + 7)
#define C2_S (2 * T + 3)
#define C3_S (2 * T + 1)

// offsets into the packed float32 parameter vector (see the wrapper)
#define OFF_W1 0            // [1][3][3][4]
#define OFF_W2 36           // [4][3][3][8]
#define OFF_W3 324          // [8][3][3][8]
#define OFF_W4 900          // [8][3][3][24]
#define OFF_B1 2628
#define OFF_B2 2632
#define OFF_B3 2640
#define OFF_B4 2648
#define OFF_WS 2672         // skip weight / 16
#define OFF_BS 2696
#define N_PARAMS 2720

#define IN_FLOATS 1684      // IN_S * IN_S rounded up to a multiple of 4
#define C1_FLOATS (4 * C1_S * C1_S)
#define C2_FLOATS (8 * C2_S * C2_S)
#define C3_FLOATS (8 * C3_S * C3_S)
#define SMEM_FLOATS (N_PARAMS + IN_FLOATS + C1_FLOATS + C2_FLOATS)

static_assert(IN_S * IN_S <= IN_FLOATS, "input tile room");
static_assert(C3_FLOATS <= C1_FLOATS, "c3 reuses c1's room");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ReLU, then the activation's rounding between layers (bf16 mode only)
template <bool BF>
__device__ __forceinline__ float act(float v) {
  v = fmaxf(v, 0.f);
  if (BF) v = __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <typename IO, bool BF>
__global__ void __launch_bounds__(NT)
    stem_kernel(const IO* __restrict__ x, const float* __restrict__ params,
                IO* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                // parameters
  float* s_in = sw + N_PARAMS;     // input tile
  float* sc1 = s_in + IN_FLOATS;   // c1, later c3
  float* sc2 = sc1 + C1_FLOATS;    // c2
  float* sc3 = sc1;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * T, ox0 = blockIdx.x * T;   // /4 grid
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  // global origin of each tile (row, column), in its own grid
  const int gy3 = 2 * oy0 - 1, gx3 = 2 * ox0 - 1;  // c3, /2 grid
  const int gy2 = gy3 - 1, gx2 = gx3 - 1;          // c2, /2 grid
  const int gy1 = 2 * gy2 - 1, gx1 = 2 * gx2 - 1;  // c1, full grid
  const int gy0 = gy1 - 1, gx0 = gx1 - 1;          // input

  for (int i = tid; i < N_PARAMS; i += NT) sw[i] = params[i];
  const IO* xb = x + (size_t)b * H * W;
  for (int i = tid; i < IN_S * IN_S; i += NT) {
    const int gy = gy0 + i / IN_S, gx = gx0 + i % IN_S;
    s_in[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? to_float(xb[(size_t)gy * W + gx])
                 : 0.f;
  }
  __syncthreads();

  // ---- c1: 1 -> 4, stride 1; one thread a position, 4 channels --------
  for (int i = tid; i < C1_S * C1_S; i += NT) {
    const int ly = i / C1_S, lx = i % C1_S;
    const int gy = gy1 + ly, gx = gx1 + lx;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      a = *reinterpret_cast<const float4*>(sw + OFF_B1);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float v = s_in[(ly + dy) * IN_S + lx + dx];
          const float4 w = *reinterpret_cast<const float4*>(
              sw + OFF_W1 + (dy * 3 + dx) * 4);
          s.x = fmaf(v, w.x, s.x);
          s.y = fmaf(v, w.y, s.y);
          s.z = fmaf(v, w.z, s.z);
          s.w = fmaf(v, w.w, s.w);
        }
      }
      a.x = act<BF>(s.x + a.x);
      a.y = act<BF>(s.y + a.y);
      a.z = act<BF>(s.z + a.z);
      a.w = act<BF>(s.w + a.w);
    }
    sc1[0 * C1_S * C1_S + i] = a.x;
    sc1[1 * C1_S * C1_S + i] = a.y;
    sc1[2 * C1_S * C1_S + i] = a.z;
    sc1[3 * C1_S * C1_S + i] = a.w;
  }
  __syncthreads();

  // ---- c2: 4 -> 8, stride 2; item = (channel group of 4, position) ----
  for (int i = tid; i < 2 * C2_S * C2_S; i += NT) {
    const int g = i / (C2_S * C2_S), pos = i % (C2_S * C2_S);
    const int ly = pos / C2_S, lx = pos % C2_S;
    const int gy = gy2 + ly, gx = gx2 + lx;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2) {
      a = *reinterpret_cast<const float4*>(sw + OFF_B2 + 4 * g);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float v = sc1[ci * C1_S * C1_S + (2 * ly + dy) * C1_S +
                                2 * lx + dx];
            const float4 w = *reinterpret_cast<const float4*>(
                sw + OFF_W2 + ((ci * 3 + dy) * 3 + dx) * 8 + 4 * g);
            s.x = fmaf(v, w.x, s.x);
            s.y = fmaf(v, w.y, s.y);
            s.z = fmaf(v, w.z, s.z);
            s.w = fmaf(v, w.w, s.w);
          }
        }
      }
      a.x = act<BF>(s.x + a.x);
      a.y = act<BF>(s.y + a.y);
      a.z = act<BF>(s.z + a.z);
      a.w = act<BF>(s.w + a.w);
    }
    float* o = sc2 + (4 * g) * C2_S * C2_S + pos;
    o[0 * C2_S * C2_S] = a.x;
    o[1 * C2_S * C2_S] = a.y;
    o[2 * C2_S * C2_S] = a.z;
    o[3 * C2_S * C2_S] = a.w;
  }
  __syncthreads();

  // ---- c3: 8 -> 8, stride 1; written over c1, which is dead -----------
  for (int i = tid; i < 2 * C3_S * C3_S; i += NT) {
    const int g = i / (C3_S * C3_S), pos = i % (C3_S * C3_S);
    const int ly = pos / C3_S, lx = pos % C3_S;
    const int gy = gy3 + ly, gx = gx3 + lx;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H2 && gx >= 0 && gx < W2) {
      a = *reinterpret_cast<const float4*>(sw + OFF_B3 + 4 * g);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int ci = 0; ci < 8; ++ci) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float v =
                sc2[ci * C2_S * C2_S + (ly + dy) * C2_S + lx + dx];
            const float4 w = *reinterpret_cast<const float4*>(
                sw + OFF_W3 + ((ci * 3 + dy) * 3 + dx) * 8 + 4 * g);
            s.x = fmaf(v, w.x, s.x);
            s.y = fmaf(v, w.y, s.y);
            s.z = fmaf(v, w.z, s.z);
            s.w = fmaf(v, w.w, s.w);
          }
        }
      }
      a.x = act<BF>(s.x + a.x);
      a.y = act<BF>(s.y + a.y);
      a.z = act<BF>(s.z + a.z);
      a.w = act<BF>(s.w + a.w);
    }
    float* o = sc3 + (4 * g) * C3_S * C3_S + pos;
    o[0 * C3_S * C3_S] = a.x;
    o[1 * C3_S * C3_S] = a.y;
    o[2 * C3_S * C3_S] = a.z;
    o[3 * C3_S * C3_S] = a.w;
  }
  __syncthreads();

  // ---- c4: 8 -> 24, stride 2, plus the skip; item = (group of 6
  // channels, position): 4 x 64 items, one a thread -----------------------
  IO* ob = out + (size_t)b * 24 * H4 * W4;
  for (int i = tid; i < 4 * T * T; i += NT) {
    const int g = i / (T * T), pos = i % (T * T);
    const int ly = pos / T, lx = pos % T;
    const int oy = oy0 + ly, ox = ox0 + lx;
    if (oy >= H4 || ox >= W4) continue;
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ci = 0; ci < 8; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float v =
              sc3[ci * C3_S * C3_S + (2 * ly + dy) * C3_S + 2 * lx + dx];
          const float2* w = reinterpret_cast<const float2*>(
              sw + OFF_W4 + ((ci * 3 + dy) * 3 + dx) * 24 + 6 * g);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float2 wk = w[k];
            s[2 * k] = fmaf(v, wk.x, s[2 * k]);
            s[2 * k + 1] = fmaf(v, wk.y, s[2 * k + 1]);
          }
        }
      }
    }
    // 4x4 pool of the input under this output: four column sums over the
    // rows (each rounded in bf16 mode, as the TPU kernel's row pooling),
    // then their sum; the skip weight carries the 1/16
    float pool = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float col = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        col += s_in[(4 * ly + 6 + r) * IN_S + 4 * lx + 6 + c];
      if (BF) col = __bfloat162float(__float2bfloat16_rn(col));
      pool += col;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int co = 6 * g + k;
      const float c4 = act<BF>(s[k] + sw[OFF_B4 + co]);
      const float skip = fmaf(pool, sw[OFF_WS + co], sw[OFF_BS + co]);
      store(ob + ((size_t)co * H4 + oy) * W4 + ox, c4 + skip);
    }
  }
}

template <typename IO, bool BF>
static cudaError_t launch(const void* x, const float* params, void* out,
                          int B, int H, int W, cudaStream_t s) {
  constexpr int bytes = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<IO, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W / 4 + T - 1) / T, (H / 4 + T - 1) / T, B);
  stem_kernel<IO, BF><<<grid, NT, bytes, s>>>(
      static_cast<const IO*>(x), params, static_cast<IO*>(out), H, W);
  return cudaGetLastError();
}

// x (B,H,W) and out (B,24,H/4,W/4) float32 (bf16 == 0) or bfloat16
// (bf16 == 1); params: the N_PARAMS packed float32 values.
extern "C" int stem_fused(const void* x, const float* params, void* out,
                          int B, int H, int W, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || H < 32 || W < 32 || H % 32 || W % 32)
    return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? launch<__nv_bfloat16, true>(x, params, out, B, H, W, s)
                    : launch<float, false>(x, params, out, B, H, W, s));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
