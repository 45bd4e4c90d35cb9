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
// the convolutions are direct, on the CUDA cores. A block owns a TX x TY
// tile of the /4 output and keeps the whole chain in shared memory: the
// input tile with its halo, then c1, c2 and c3 on their halo'd tiles
// (planar, one plane a channel; c3 reuses c1's room). Device memory sees
// one read of the image (plus the halo overlap between blocks) and one
// write of the output, which is NCHW (B,24,H/4,W/4), the layout the next
// convolution reads.
//
// Bound on the H100: operations in float32 (720 FLOP an input pixel
// against 10 bytes), bytes in bfloat16. The design aims at the FMAs:
//   * register tiling: a thread owns a strip of outputs (3 positions of a
//     row at c1, 2 at c2 and c3, 1 at c4) and keeps the strip's 3-row input
//     window of one input channel in registers, reused across dy, dx and
//     every output channel: one shared-memory load per 7-18 FMAs at c1-c3,
//     where the direct form loads an activation and a weight for every 4;
//   * the weights are warp-uniform: a thread computes every output channel
//     of c1-c3 and, at c4, a warp-uniform group of 8 of the 24;
//   * the 2,720 weights and biases are a `__grid_constant__` kernel
//     parameter (constant bank 0): c1-c3 are unrolled with compile-time
//     weight offsets, so their weights reach the FFMAs through warp-uniform
//     constant loads (ULDC), not per-thread loads. c4's 1,728 weights are
//     copied into shared memory and read
//     by broadcast loads in a ci loop that is not unrolled: measured on the
//     H100, c4 with constant operands took twice the clocks (its weights
//     are more than the constant cache serves at full rate), and unrolled
//     shared-memory weights were hoisted into registers and spilled;
//   * a 16x16 output tile: the c1 halo costs 1.23x (1.49x at 8x8), and the
//     130 blocks of a 608x800 image, one an SM (146 KB of shared memory,
//     768 threads), are one wave on 132 SMs;
//   * neighbouring threads own neighbouring rows and the planes' row
//     pitches are odd, so the window loads are free of bank conflicts at
//     stride 1.
//
// Accumulation follows the plain version: for each output, products in
// the order ci, dy, dx with fmaf from 0, then the bias, then ReLU. bf16
// mode follows the TPU kernel's rounding points: input and weights are
// bf16 values (the wrapper rounds the weights, 1/16 of the pooling folded
// into the skip weight), products are summed in float32, the float32 bias
// is added, ReLU, and each activation is rounded to bf16 between layers;
// the pooled row sums are rounded to bf16; the final sum is float32 and is
// rounded once on the way out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TX = 16, TY = 16;  // output tile (of the /4 grid)
constexpr int NT = 768;           // threads a block

constexpr int odd(int v) { return v | 1; }

// tile sides with halo (rows H, columns W) and strips a row
constexpr int IN_H = 4 * TY + 9;
constexpr int C1_H = 4 * TY + 7, C1_W = 4 * TX + 7;
constexpr int C2_H = 2 * TY + 3, C2_W = 2 * TX + 3;
constexpr int C3_H = 2 * TY + 1, C3_W = 2 * TX + 1;
constexpr int S1 = 3;                          // c1 strip: 3 positions
constexpr int N1X = (C1_W + S1 - 1) / S1;      // c2, c3 strips: 2
constexpr int N2X = (C2_W + 1) / 2, N3X = (C3_W + 1) / 2;
// odd row pitches; a strip that overhangs the tile writes a column that no
// later layer reads (and a c2 overhang reads c1 cells it discards)
constexpr int P1 = odd(N1X * S1), IN_P = P1 + 2;
constexpr int P2 = odd(N2X * 2), P3 = odd(N3X * 2);

constexpr int IN_FLOATS = IN_H * IN_P;
constexpr int C1_FLOATS = 4 * C1_H * P1;
constexpr int C2_FLOATS = 8 * C2_H * P2;
constexpr int C3_FLOATS = 8 * C3_H * P3;
constexpr int SMEM_FLOATS = IN_FLOATS + C1_FLOATS + C2_FLOATS;

// c4: one output position a thread, its 24 channels in 3 warp-uniform
// groups of 8, so that the c4 phase is exactly one item a thread
constexpr int NG4 = 3, CG4 = 24 / NG4;
static_assert(C3_FLOATS <= C1_FLOATS, "c3 reuses c1's room");
static_assert(NG4 * TX * TY == NT && (TX * TY) % 32 == 0,
              "c4 groups must fill the block, one group a warp");

// offsets into the packed float32 parameter vector (see the wrapper)
constexpr int OFF_W1 = 0;      // [1][3][3][4]
constexpr int OFF_W2 = 36;     // [4][3][3][8]
constexpr int OFF_W3 = 324;    // [8][3][3][8]
constexpr int OFF_W4 = 900;    // [8][3][3][24]
constexpr int OFF_B1 = 2628, OFF_B2 = 2632, OFF_B3 = 2640, OFF_B4 = 2648;
constexpr int OFF_WS = 2672;   // skip weight / 16
constexpr int OFF_BS = 2696;
constexpr int N_PARAMS = 2720;

struct StemParams {
  float v[N_PARAMS];
};

constexpr int N_W4 = 8 * 9 * 24;  // c4's weights, in shared memory

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

// c4 and the skip for one output position and channels [G*CG4, G*CG4+CG4)
template <int G, typename IO, bool BF>
__device__ __forceinline__ void c4_item(const StemParams& p,
                                        const float* sw4, const float* sc3,
                                        const float* s_in, IO* ob, int ly,
                                        int lx, int oy, int ox, int H4,
                                        int W4) {
  constexpr int C0 = G * CG4;
  float acc[CG4];
#pragma unroll
  for (int k = 0; k < CG4; ++k) acc[k] = 0.f;
#pragma unroll 1
  for (int ci = 0; ci < 8; ++ci) {
    float win[3][3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        win[dy][dx] =
            sc3[ci * C3_H * P3 + (2 * ly + dy) * P3 + 2 * lx + dx];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int k = 0; k < CG4; ++k)
          acc[k] = fmaf(win[dy][dx],
                        sw4[((ci * 3 + dy) * 3 + dx) * 24 + C0 + k],
                        acc[k]);
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
      col += s_in[(4 * ly + 6 + r) * IN_P + 4 * lx + 6 + c];
    if (BF) col = __bfloat162float(__float2bfloat16_rn(col));
    pool += col;
  }
  if (oy >= H4 || ox >= W4) return;
#pragma unroll
  for (int k = 0; k < CG4; ++k) {
    const int co = C0 + k;
    const float c4 = act<BF>(acc[k] + p.v[OFF_B4 + co]);
    const float skip = fmaf(pool, p.v[OFF_WS + co], p.v[OFF_BS + co]);
    store(ob + ((size_t)co * H4 + oy) * W4 + ox, c4 + skip);
  }
}

template <typename IO, bool BF>
__global__ void __launch_bounds__(NT)
    stem_kernel(const IO* __restrict__ x, const __grid_constant__ StemParams p,
                IO* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) float sw4[N_W4];
  for (int i = threadIdx.x; i < N_W4; i += NT) sw4[i] = p.v[OFF_W4 + i];
  float* s_in = smem;              // input tile
  float* sc1 = s_in + IN_FLOATS;   // c1, later c3
  float* sc2 = sc1 + C1_FLOATS;    // c2
  float* sc3 = sc1;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TY, ox0 = blockIdx.x * TX;   // /4 grid
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  // global origin of each tile (row, column), in its own grid
  const int gy3 = 2 * oy0 - 1, gx3 = 2 * ox0 - 1;  // c3, /2 grid
  const int gy2 = gy3 - 1, gx2 = gx3 - 1;          // c2, /2 grid
  const int gy1 = 2 * gy2 - 1, gx1 = 2 * gx2 - 1;  // c1, full grid
  const int gy0 = gy1 - 1, gx0 = gx1 - 1;          // input

  const IO* xb = x + (size_t)b * H * W;
  for (int i = tid; i < IN_FLOATS; i += NT) {
    const int gy = gy0 + i / IN_P, gx = gx0 + i % IN_P;
    s_in[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? to_float(xb[(size_t)gy * W + gx])
                  : 0.f;
  }
  __syncthreads();

  // ---- c1: 1 -> 4, stride 1; a strip of 3 positions, 4 channels --------
  for (int i = tid; i < C1_H * N1X; i += NT) {
    const int ly = i % C1_H, lx0 = (i / C1_H) * S1;
    float win[3][S1 + 2];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int c = 0; c < S1 + 2; ++c)
        win[dy][c] = s_in[(ly + dy) * IN_P + lx0 + c];
    float acc[S1][4];
#pragma unroll
    for (int q = 0; q < S1; ++q)
#pragma unroll
      for (int co = 0; co < 4; ++co) acc[q][co] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int co = 0; co < 4; ++co)
#pragma unroll
          for (int q = 0; q < S1; ++q)
            acc[q][co] = fmaf(win[dy][q + dx],
                              p.v[OFF_W1 + (dy * 3 + dx) * 4 + co],
                              acc[q][co]);
    const int gy = gy1 + ly;
#pragma unroll
    for (int q = 0; q < S1; ++q) {
      const int gx = gx1 + lx0 + q;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int co = 0; co < 4; ++co)
        sc1[co * C1_H * P1 + ly * P1 + lx0 + q] =
            in ? act<BF>(acc[q][co] + p.v[OFF_B1 + co]) : 0.f;
    }
  }
  __syncthreads();

  // ---- c2: 4 -> 8, stride 2; a strip of 2 positions, 8 channels --------
  for (int i = tid; i < C2_H * N2X; i += NT) {
    const int ly = i % C2_H, lx0 = (i / C2_H) * 2;
    float acc[2][8];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int co = 0; co < 8; ++co) acc[q][co] = 0.f;
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      float win[3][5];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int c = 0; c < 5; ++c)
          win[dy][c] =
              sc1[ci * C1_H * P1 + (2 * ly + dy) * P1 + 2 * lx0 + c];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int co = 0; co < 8; ++co)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              acc[q][co] = fmaf(
                  win[dy][2 * q + dx],
                  p.v[OFF_W2 + ((ci * 3 + dy) * 3 + dx) * 8 + co], acc[q][co]);
    }
    const int gy = gy2 + ly;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int gx = gx2 + lx0 + q;
      const bool in = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
#pragma unroll
      for (int co = 0; co < 8; ++co)
        sc2[co * C2_H * P2 + ly * P2 + lx0 + q] =
            in ? act<BF>(acc[q][co] + p.v[OFF_B2 + co]) : 0.f;
    }
  }
  __syncthreads();

  // ---- c3: 8 -> 8, stride 1; written over c1, which is dead -----------
  for (int i = tid; i < C3_H * N3X; i += NT) {
    const int ly = i % C3_H, lx0 = (i / C3_H) * 2;
    float acc[2][8];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int co = 0; co < 8; ++co) acc[q][co] = 0.f;
#pragma unroll
    for (int ci = 0; ci < 8; ++ci) {
      float win[3][4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          win[dy][c] = sc2[ci * C2_H * P2 + (ly + dy) * P2 + lx0 + c];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int co = 0; co < 8; ++co)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              acc[q][co] = fmaf(
                  win[dy][q + dx],
                  p.v[OFF_W3 + ((ci * 3 + dy) * 3 + dx) * 8 + co], acc[q][co]);
    }
    const int gy = gy3 + ly;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int gx = gx3 + lx0 + q;
      const bool in = gy >= 0 && gy < H2 && gx >= 0 && gx < W2;
#pragma unroll
      for (int co = 0; co < 8; ++co)
        sc3[co * C3_H * P3 + ly * P3 + lx0 + q] =
            in ? act<BF>(acc[q][co] + p.v[OFF_B3 + co]) : 0.f;
    }
  }
  __syncthreads();

  // ---- c4: 8 -> 24, stride 2, plus the skip: one position a thread, its
  // warp's group of channels (positions x-fastest for coalesced stores) ----
  IO* ob = out + (size_t)b * 24 * H4 * W4;
  const int g = tid / (TX * TY), pos = tid % (TX * TY);
  const int ly = pos / TX, lx = pos % TX;
  const int oy = oy0 + ly, ox = ox0 + lx;
  if (g == 0)
    c4_item<0, IO, BF>(p, sw4, sc3, s_in, ob, ly, lx, oy, ox, H4, W4);
  else if (g == 1)
    c4_item<1, IO, BF>(p, sw4, sc3, s_in, ob, ly, lx, oy, ox, H4, W4);
  else
    c4_item<2, IO, BF>(p, sw4, sc3, s_in, ob, ly, lx, oy, ox, H4, W4);
}

template <typename IO, bool BF>
cudaError_t launch(const void* x, const StemParams& params, void* out, int B,
                   int H, int W, cudaStream_t s) {
  constexpr int bytes = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<IO, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W / 4 + TX - 1) / TX, (H / 4 + TY - 1) / TY, B);
  stem_kernel<IO, BF><<<grid, NT, bytes, s>>>(
      static_cast<const IO*>(x), params, static_cast<IO*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W) and out (B,24,H/4,W/4) float32 (bf16 == 0) or bfloat16
// (bf16 == 1); params: the N_PARAMS packed float32 values in HOST memory,
// copied into the launch's parameters.
extern "C" int stem_fused(const void* x, const float* params, void* out,
                          int B, int H, int W, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B > 65535 || H < 32 || W < 32 || H % 32 || W % 32)
    return (int)cudaErrorInvalidValue;
  StemParams p;
  memcpy(p.v, params, sizeof(p.v));
  return (int)(bf16 ? launch<__nv_bfloat16, true>(x, p, out, B, H, W, s)
                    : launch<float, false>(x, p, out, B, H, W, s));
}

// dynamic shared memory a block, bytes
extern "C" int stem_smem_bytes() { return SMEM_FLOATS * (int)sizeof(float); }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
