// The backbone's feature-pyramid fusion for Hopper (sm_90a): kernel F.
//
// Replaces no TPU kernel. The JAX package leaves this step to XLA
// (`models/backbone.py`: block3 + resize(block4) + resize(block5)), which
// fuses it there. In the port it ran as PyTorch's plain expression
//
//   fused = x3 + up(x4) + up(x5)
//
// two `upsample_bilinear2d_out_frame` launches and two adds, four passes.
// PyTorch's NCHW bilinear kernel runs one thread an output pixel of one
// plane and loops over all B x C planes, so at 64 x 76 x 100 it has 7,600
// threads and most SMs sit idle; the adds make three more full-size passes.
// At B = 64, 608x800 the four take 3.4 ms on an H100 with L2 evicted, 2.5%
// of their byte bound. This kernel computes the same sum in one pass:
// 0.12 ms there, 71% of the bound.
//
// Shapes: x3 (B,C,h,w), x4 (B,C,h/2,w/2), x5 (B,C,h/4,w/4), NCHW float32,
// contiguous; w divisible by 4 (the backbone's h and w are the image's / 8,
// the image's divisible by 32). `up` is half-pixel bilinear
// (align_corners=False): the source index scale * (dst + 0.5) - 0.5 with
// scale 1/2 and 1/4, clamped at 0, the last row and column repeated, as
// upsample_bilinear2d computes it. At these ratios every weight is an exact
// dyadic fraction (0, 1/8, 1/4, 3/8, 5/8, 3/4, 7/8, 1).
//
// Bound on the H100: bytes. The function needs x3 read once (1.95 MB an
// 800x608 image), x4 (0.49 MB) and x5 (0.12 MB) read once and the sum
// written once (1.95 MB): 4.5 MB an image, 288 MB at B = 64, 0.086 ms at
// 3.35 TB/s; its ~20 operations an output element hide under that. The
// design meets it so:
//   * one thread owns 4 neighbouring output columns of one row: x3 is one
//     16-byte load, the sum one 16-byte store, both marked streaming
//     (evict first), so they do not push x4 and x5 out of L1 and L2;
//   * the grid covers all B x C x h rows (at B = 64, 608x800: 7.8 million
//     threads), so every SM has work;
//   * the 4 output columns read 4 columns of x4's two source rows and 3 of
//     x5's, each loaded once into registers (14 loads, through L1/L2: x4
//     and x5 are 4x and 16x smaller than the output and each of their rows
//     serves 2 and 4 output rows);
//   * each output column takes its two operands from those registers at
//     offsets fixed by the ratio. At the borders the loads are clamped, so a
//     column's operands are then the repeated edge value: at the right edge
//     this is what the plain version reads; at the left edge the plain
//     version's second operand carries weight 0, so the two agree.
//
// Arithmetic follows the plain version: the weights are computed with
// upsample_bilinear2d's formula and each interpolation is written as its
// expression, h0 * (w0 * a + w1 * b) + h1 * (w0 * c + w1 * d); the sums
// are taken in the plain order, (x3 + up(x4)) + up(x5).

#include <cuda_runtime.h>

#define FUSION_THREADS 256

namespace {

// upsample_bilinear2d's half-pixel source index (align_corners=False)
__device__ __forceinline__ float source_index(float scale, int dst) {
  const float s = scale * (dst + 0.5f) - 0.5f;
  return s < 0.f ? 0.f : s;
}

// one source row pair of an upsampled map and its row weights
struct Rows {
  const float* top;
  const float* bottom;
  float h0, h1;
};

__device__ __forceinline__ Rows source_rows(const float* plane, float scale,
                                            int h, int rows, int cols) {
  const float r = source_index(scale, h);
  const int r0 = (int)r;
  const int rp = r0 < rows - 1 ? 1 : 0;
  Rows out;
  out.h1 = r - r0;
  out.h0 = 1.f - out.h1;
  out.top = plane + (long)r0 * cols;
  out.bottom = plane + (long)(r0 + rp) * cols;
  return out;
}

__device__ __forceinline__ int clamp_col(int c, int cols) {
  return c < 0 ? 0 : (c > cols - 1 ? cols - 1 : c);
}

// N source columns from `first` on, clamped to the row
template <int N>
__device__ __forceinline__ void load_window(const float* row, int first,
                                            int cols, float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = __ldg(row + clamp_col(first + k, cols));
}

// the plain version's bilinear expression for one output column
__device__ __forceinline__ float lerp2(const Rows& r, float w0, float w1,
                                       float a, float b, float c, float d) {
  return r.h0 * (w0 * a + w1 * b) + r.h1 * (w0 * c + w1 * d);
}

__global__ void __launch_bounds__(FUSION_THREADS)
feature_fusion_kernel(const float4* __restrict__ x3,
                      const float* __restrict__ x4,
                      const float* __restrict__ x5, float4* __restrict__ out,
                      int quads, int h3, int w3) {
  const int i = blockIdx.x * FUSION_THREADS + threadIdx.x;
  if (i >= quads) return;
  const int qs = w3 / 4;           // quads a row
  const int row = i / qs;          // plane * h3 + h
  const int q = i - row * qs;
  const int plane = row / h3;
  const int h = row - plane * h3;
  const int h4 = h3 / 2, w4 = w3 / 2, h5 = h3 / 4, w5 = w3 / 4;

  const float4 base = __ldcs(x3 + i);
  const Rows r4 = source_rows(x4 + (long)plane * h4 * w4, 0.5f, h, h4, w4);
  const Rows r5 = source_rows(x5 + (long)plane * h5 * w5, 0.25f, h, h5, w5);
  // x4 columns 2q-1 .. 2q+2 and x5 columns q-1 .. q+1, clamped
  float t4[4], b4[4], t5[3], b5[3];
  load_window(r4.top, 2 * q - 1, w4, t4);
  load_window(r4.bottom, 2 * q - 1, w4, b4);
  load_window(r5.top, q - 1, w5, t5);
  load_window(r5.bottom, q - 1, w5, b5);

  const float x3v[4] = {base.x, base.y, base.z, base.w};
  float res[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int dst = 4 * q + j;
    // first operand's offset in the window: output column 4q + j reads x4
    // column 2q - 1 + {0, 1, 1, 2}[j] and x5 column q - 1 + {0, 0, 1, 1}[j]
    const int o4 = (j + 1) / 2, o5 = j / 2;
    const float c4 = source_index(0.5f, dst);
    const float l4 = c4 - (int)c4;
    const float c5 = source_index(0.25f, dst);
    const float l5 = c5 - (int)c5;
    const float up4 = lerp2(r4, 1.f - l4, l4, t4[o4], t4[o4 + 1], b4[o4],
                            b4[o4 + 1]);
    const float up5 = lerp2(r5, 1.f - l5, l5, t5[o5], t5[o5 + 1], b5[o5],
                            b5[o5 + 1]);
    res[j] = (x3v[j] + up4) + up5;
  }
  __stcs(out + i, make_float4(res[0], res[1], res[2], res[3]));
}

}  // namespace

// x3 (planes,h3,w3), x4 (planes,h3/2,w3/2), x5 (planes,h3/4,w3/4) and out
// (planes,h3,w3), float32, contiguous; h3 and w3 divisible by 4 and
// planes * h3 * w3 < 2^31.
extern "C" int fuse_pyramid(const float* x3, const float* x4, const float* x5,
                            float* out, int planes, int h3, int w3,
                            void* stream) {
  if (planes < 1 || h3 < 4 || w3 < 4 || h3 % 4 || w3 % 4 ||
      (long long)planes * h3 * w3 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int quads = planes * h3 * (w3 / 4);
  const int blocks = (quads + FUSION_THREADS - 1) / FUSION_THREADS;
  feature_fusion_kernel<<<blocks, FUSION_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x3), x4, x5,
      reinterpret_cast<float4*>(out), quads, h3, w3);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
