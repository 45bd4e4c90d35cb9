// Fused keypoint detection and exact top-k selection for Hopper (sm_90a).
//
// Replaces the TPU kernel `_detect_kernel` in
// accelerated_features_tpu/ops/pallas/detect_fused.py (entered through
// detect_scores_fused / topk_keypoints_fused) together with the selection
// the TPU left to `lax.top_k`. Two kernels:
//
// detect_candidates_kernel, one pass over the decoded heatmap (B,H,W) and
// the /8 reliability map (B,h,w):
//   * the 5x5 local max with `heat >= lmax && heat > thr`, -inf outside;
//   * the separable bilinear upsample of the reliability map at every pixel
//     (src = i*(in/(out-1)) - 0.5, zero weight for out-of-range taps);
//   * score = heat * rel_up, -1 at non-maxima and at (0,0), 0 on the last
//     row and column;
//   * one candidate per 2x2 tile: its best score and its position 2*dy+dx
//     (first of equal maxima);
//   * a per-image histogram of the candidates' keys (below) by their top
//     11 bits: a shared-memory histogram a block, warp-aggregated adds,
//     merged with one global atomic per non-zero bin.
// Every float operation is the one the plain torch version does, in the
// same order and rounded the same way (no FMA contraction), so the two
// give bit-identical candidates.
//
// select_kernel, one cluster of 8 blocks of 1024 threads per image (a
// block a slice of 1/8 of the image's N values): the exact top-k of the
// values (the candidates, or any (B,N) float32 rows), in the order of
// `lax.top_k`: value descending, then index ascending. A value's key is its
// bits made monotone as an unsigned integer (so -0.0 sorts below +0.0).
// Radix select on the key, 11 + 11 + 10 bits:
//   1. from the histogram of the top 11 bits (the candidate kernel's, or
//      one pass), the boundary bin that holds the k-th largest key and the
//      count above it, found by every block alike;
//   2. while the boundary bin holds more keys than are still wanted, each
//      block histograms the next bits of the keys in the bin over its
//      slice, and the slices' histograms are summed through distributed
//      shared memory;
//   3. each block's counts above the boundary and in it, from its last
//      histogram, place its slice after the slices before it; a collect
//      pass in index order then writes the keys above the boundary and the
//      first `remaining` keys of the bin (after level 3, equal keys) to
//      their places, ranked by ballots and a scan, so in index order;
//   4. a bitonic sort, descending, of the k keys (key << 32 | N-1-index),
//      padded to p2 = 2^m >= 1024 and spread over the cluster, p2/8 a
//      block: strides below 128 in registers and shuffles, strides below
//      p2/8 in the block's shared memory, wider ones across the cluster's
//      shared memory; above 131072 keys in a global scratch, read and
//      written past L1;
//   5. decode: values from their keys, and for keypoints xy from the tile
//      index and the tile position; for k > N the tail is (-1.0, index 0).
//
// Bound on the H100: device memory for the candidates (the heatmap once, 4
// bytes a pixel, 1.25 bytes a pixel out); the selection re-reads the
// candidates (0.6 MB an 800x608 image) from L2 one to three times and is
// bound by latency and barriers, so a cluster of 8 SMs shares each pass.
// The candidate pass stages a 16x64-pixel heatmap tile plus its 2-pixel
// halo in shared memory with coalesced loads; each thread owns one 2x2 tile
// and keeps the separable 5x5 max in registers. The small reliability map
// is read through the cache.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define TILES_X 32   // 2x2 tiles per block along x
#define TILES_Y 8    // 2x2 tiles per block along y
#define SM_H (2 * TILES_Y + 4)
#define SM_W (2 * TILES_X + 4)

#define HIST_BINS 2048          // top 11 bits of a key
#define SEL_THREADS 1024
#define SEL_WARPS (SEL_THREADS / 32)
#define ITEMS 8                 // values a thread holds in a streaming pass
#define SEL_SMEM_KEYS 131072    // keys sorted in shared memory (128 KB a block)
#define CL 8                    // blocks of a cluster: one image
#define SEG_R 4                 // sort keys a lane holds in registers
#define SEG (32 * SEG_R)        // keys a warp sorts in registers

// order-preserving map of a float to an unsigned key, and back
__device__ __forceinline__ uint32_t ukey(float v) {
  const int32_t b = __float_as_int(v);
  return (uint32_t)(b < 0 ? b ^ 0x7FFFFFFF : b) ^ 0x80000000u;
}
__device__ __forceinline__ float from_ukey(uint32_t u) {
  const int32_t o = (int32_t)(u ^ 0x80000000u);
  return __int_as_float(o < 0 ? o ^ 0x7FFFFFFF : o);
}

// add one to hist[bin] for every lane where `on`, one atomic per distinct
// bin of the warp; every lane of the warp must call it
__device__ __forceinline__ void warp_hist_add(int* hist, uint32_t bin,
                                              bool on) {
  const unsigned act = __ballot_sync(0xffffffffu, on);
  if (on) {
    const unsigned peers = __match_any_sync(act, bin);
    if ((threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(hist + bin, __popc(peers));
  }
}

// src index and fraction of output position i: src = i*scale - 0.5
__device__ __forceinline__ void src_index(int i, float scale, int& i0,
                                          float& t) {
  float src = __fsub_rn(__fmul_rn((float)i, scale), 0.5f);
  float f = floorf(src);
  i0 = (int)f;
  t = __fsub_rn(src, f);
}

// g0*m0*(1-t) + g1*m1*t with the plain version's rounding order
__device__ __forceinline__ float lerp2(float g0, float g1, bool in0, bool in1,
                                       float t) {
  float a = __fmul_rn(__fmul_rn(g0, in0 ? 1.f : 0.f), __fsub_rn(1.f, t));
  float b = __fmul_rn(__fmul_rn(g1, in1 ? 1.f : 0.f), t);
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float rel_row(const float* __restrict__ row, int w,
                                         int x0, float tx) {
  int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
  return lerp2(__ldg(row + xa), __ldg(row + xb), x0 >= 0 && x0 < w,
               x0 + 1 >= 0 && x0 + 1 < w, tx);
}

__global__ void __launch_bounds__(TILES_X* TILES_Y)
    detect_candidates_kernel(const float* __restrict__ heat,
                             const float* __restrict__ rel,
                             float* __restrict__ best,
                             uint8_t* __restrict__ sub,
                             int* __restrict__ hist, int H, int W, int h,
                             int w, float thr, float sx, float sy) {
  __shared__ float tile[SM_H][SM_W];
  __shared__ int sh_hist[HIST_BINS];
  const int b = blockIdx.z;
  const float* hb = heat + (size_t)b * H * W;
  const float* rb = rel + (size_t)b * h * w;
  const int py0 = blockIdx.y * 2 * TILES_Y - 2;
  const int px0 = blockIdx.x * 2 * TILES_X - 2;
  const int tid = threadIdx.y * TILES_X + threadIdx.x;
  for (int i = tid; i < SM_H * SM_W; i += TILES_X * TILES_Y) {
    int r = i / SM_W, c = i % SM_W;
    int y = py0 + r, x = px0 + c;
    tile[r][c] = (y >= 0 && y < H && x >= 0 && x < W)
                     ? hb[(size_t)y * W + x]
                     : -INFINITY;
  }
  for (int i = tid; i < HIST_BINS; i += TILES_X * TILES_Y) sh_hist[i] = 0;
  __syncthreads();

  const int H2 = H / 2, W2 = W / 2;
  const int ty = blockIdx.y * TILES_Y + threadIdx.y;
  const int tx = blockIdx.x * TILES_X + threadIdx.x;
  const bool inside = ty < H2 && tx < W2;
  float best_v = 0.f;
  if (inside) {
    // 6x6 window around the 2x2 tile: horizontal 5-max for both columns
    const int lr = 2 * threadIdx.y, lc = 2 * threadIdx.x;
    float hm[6][2];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float m = tile[lr + r][lc + c];
#pragma unroll
        for (int k = 1; k < 5; ++k) m = fmaxf(m, tile[lr + r][lc + c + k]);
        hm[r][c] = m;
      }
    }

    int best_s = 0;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = 2 * ty + dy;
      int y0;
      float fy;
      src_index(y, sy, y0, fy);
      const int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = 2 * tx + dx;
        float lmax = hm[dy][dx];
#pragma unroll
        for (int k = 1; k < 5; ++k) lmax = fmaxf(lmax, hm[dy + k][dx]);
        const float v = tile[lr + 2 + dy][lc + 2 + dx];
        float s = -1.f;
        if (v >= lmax && v > thr && !(x == 0 && y == 0)) {
          int x0;
          float fx;
          src_index(x, sx, x0, fx);
          float up = lerp2(rel_row(rb + (size_t)ya * w, w, x0, fx),
                           rel_row(rb + (size_t)yb * w, w, x0, fx),
                           y0 >= 0 && y0 < h, y0 + 1 >= 0 && y0 + 1 < h, fy);
          float near = (y == H - 1 || x == W - 1) ? 0.f : v;
          s = __fmul_rn(near, up);
        }
        if ((dy == 0 && dx == 0) || s > best_v) {
          best_v = s;
          best_s = 2 * dy + dx;
        }
      }
    }
    const size_t o = (size_t)b * H2 * W2 + (size_t)ty * W2 + tx;
    best[o] = best_v;
    sub[o] = (uint8_t)best_s;
  }
  warp_hist_add(sh_hist, ukey(best_v) >> 21, inside);
  __syncthreads();
  int* hb_out = hist + (size_t)b * HIST_BINS;
  for (int i = tid; i < HIST_BINS; i += TILES_X * TILES_Y)
    if (sh_hist[i]) atomicAdd(hb_out + i, sh_hist[i]);
}

// exclusive prefix sum of x over the block's threads, in thread order;
// `total` gets the sum of all. Every thread must call it.
__device__ __forceinline__ int block_scan(int x, int* sh_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sh_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int wsum = lane < SEL_WARPS ? sh_warp[lane] : 0;
    int winc = wsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += y;
    }
    sh_warp[lane] = winc - wsum;
    if (lane == 31) sh_warp[32] = winc;
  }
  __syncthreads();
  const int res = sh_warp[warp] + inc - x;
  total = sh_warp[32];
  __syncthreads();  // sh_warp may be reused
  return res;
}

// the boundary bin of hist[0..nb): the largest bin whose count together
// with the counts above it reaches `want`; writes (bin, count above it)
// into out[0..1]. Bins are handed out from the top, nb / SEL_THREADS a
// thread.
__device__ void find_boundary(const int* hist, int nb, int want, int* sh_warp,
                              int* out) {
  const int per = nb / SEL_THREADS;  // 1 or 2
  const int top = nb - 1 - threadIdx.x * per;
  int s = 0;
  for (int j = 0; j < per; ++j) s += hist[top - j];
  int total;
  int run = block_scan(s, sh_warp, total);
  for (int j = 0; j < per; ++j) {
    const int c = hist[top - j];
    if (run < want && run + c >= want) {
      out[0] = top - j;
      out[1] = run;
    }
    run += c;
  }
  __syncthreads();
}

// sort keys in shared memory (a block's, or another block's of the
// cluster), or with G in a global scratch, read and written past L1: the
// cluster's blocks run on other SMs, whose L1 caches are not coherent
template <bool G>
__device__ __forceinline__ unsigned long long ld_key(
    const unsigned long long* p) {
  if constexpr (G) return __ldcg(p);
  else return *p;
}
template <bool G>
__device__ __forceinline__ void st_key(unsigned long long* p,
                                       unsigned long long v) {
  if constexpr (G) __stcg(p, v);
  else *p = v;
}

// a cluster barrier; with G, global stores before it are fenced first, so
// that the cluster's other blocks see them after it
template <bool G>
__device__ __forceinline__ void cluster_sync(cg::cluster_group& cluster) {
  if constexpr (G) __threadfence();
  cluster.sync();
}

// one warp's part of the bitonic network on the SEG-key segment `seg` of a
// block's keys `sel` (global key index gbase + local index): the merge
// levels from `size` (or, for size 2, every level up to SEG) with their
// strides below SEG, in registers; key r * 32 + lane of the segment is x[r]
template <bool G>
__device__ __forceinline__ void sort_segment(unsigned long long* sel, int seg,
                                             int lane, int size, int gbase) {
  unsigned long long x[SEG_R];
  const int l0 = seg * SEG + lane, g0 = gbase + l0;
#pragma unroll
  for (int r = 0; r < SEG_R; ++r) x[r] = ld_key<G>(sel + l0 + r * 32);
  const int last = size == 2 ? SEG : size;
  for (int sz = size; sz <= last; sz <<= 1) {
#pragma unroll
    for (int stride = SEG / 2; stride > 0; stride >>= 1) {
      if (2 * stride > sz) continue;
      if (stride >= 32) {
        const int rs = stride / 32;
#pragma unroll
        for (int r = 0; r < SEG_R; ++r) {
          if (r & rs) continue;
          const bool desc = ((g0 + r * 32) & sz) == 0;
          const unsigned long long a = x[r], c = x[r | rs];
          if ((a < c) == desc) {
            x[r] = c;
            x[r | rs] = a;
          }
        }
      } else {
        const bool is_lo = (lane & stride) == 0;
#pragma unroll
        for (int r = 0; r < SEG_R; ++r) {
          const unsigned long long y =
              __shfl_xor_sync(0xffffffffu, x[r], stride);
          const bool desc = (((g0 + r * 32) & ~stride) & sz) == 0;
          x[r] = (x[r] > y) == (is_lo == desc) ? x[r] : y;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SEG_R; ++r) st_key<G>(sel + l0 + r * 32, x[r]);
}

// this block's histogram of the bits [nshift, nshift + nbits) of the keys
// in its slice [lo, hi) whose bits above `shift` equal `prefix` (all keys
// when shift == 32); returns this thread's count of keys above the prefix
__device__ int slice_hist(const float* __restrict__ v, int lo, int hi,
                          int* hist, int shift, uint32_t prefix, int nshift,
                          int nbits) {
  const int tid = threadIdx.x;
  int above = 0;
  for (int base = lo; base < hi; base += SEL_THREADS * ITEMS) {
    float x[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = base + j * SEL_THREADS + tid;
      x[j] = i < hi ? __ldg(v + i) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const uint32_t u = ukey(x[j]);
      const bool ok = base + j * SEL_THREADS + tid < hi;
      const bool in = shift == 32 || (u >> shift) == prefix;
      above += ok && shift < 32 && (u >> shift) > prefix;
      warp_hist_add(hist, (u >> nshift) & ((1u << nbits) - 1), ok && in);
    }
  }
  return above;
}

// the image's histogram: the sum of the cluster's slice histograms
__device__ void merge_hist(cg::cluster_group& cluster, int* part, int* hist,
                           int nb) {
  cluster.sync();
  for (int i = threadIdx.x; i < nb; i += SEL_THREADS) {
    int s = 0;
#pragma unroll
    for (int r = 0; r < CL; ++r) s += cluster.map_shared_rank(part, r)[i];
    hist[i] = s;
  }
  cluster.sync();  // no block clears its slice histogram while it is read
}

// One cluster of CL blocks an image. DETECT: write keypoints (xy from the
// tile index and `sub`) and scores; else values and indices. G: the sort
// keys are in `gsel`, else in the blocks' shared memory.
template <bool DETECT, bool G>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(SEL_THREADS)
    select_kernel(const float* __restrict__ vals, int n,
                  const int* __restrict__ hist0, int k, int p2,
                  unsigned long long* __restrict__ gsel,
                  const uint8_t* __restrict__ sub, int w2,
                  long long* __restrict__ out_idx,
                  float* __restrict__ out_val) {
  extern __shared__ unsigned long long sh_sel[];
  __shared__ int sh_hist[HIST_BINS];  // the image's
  __shared__ int sh_part[HIST_BINS];  // this block's slice's
  __shared__ int sh_warp[33];
  __shared__ int sh_misc[4];
  __shared__ int sh_slice[2];  // the slice's keys above the bin and in it
  __shared__ int sh_cnt[2][ITEMS * SEL_WARPS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / CL;
  const float* v = vals + (size_t)b * n;
  const int kk = min(k, n);
  const int span = (n + CL - 1) / CL;
  const int lo = min(n, rank * span), hi = min(n, lo + span);
  const int chunk = p2 / CL;  // sort keys a block: global rank*chunk + local
  const int gbase = rank * chunk;
  unsigned long long* gimg = G ? gsel + (size_t)b * p2 : nullptr;
  unsigned long long* mine = G ? gimg + gbase : sh_sel;
  auto keys_of = [&](int r) {
    return G ? gimg + r * chunk : cluster.map_shared_rank(sh_sel, r);
  };

  // ---- level 1: histogram of the top 11 bits ---------------------------
  if (hist0) {
    for (int i = tid; i < HIST_BINS; i += SEL_THREADS)
      sh_hist[i] = hist0[(size_t)b * HIST_BINS + i];
    __syncthreads();
  } else {
    for (int i = tid; i < HIST_BINS; i += SEL_THREADS) sh_part[i] = 0;
    __syncthreads();
    slice_hist(v, lo, hi, sh_part, 32, 0u, 21, 11);
    merge_hist(cluster, sh_part, sh_hist, HIST_BINS);
  }

  // ---- boundary, refined by 11 and 10 more bits while needed -----------
  uint32_t prefix = 0;  // the boundary's key bits above `shift`
  int shift = 21;
  int remaining = kk;   // keys still wanted from the boundary bin
  int bin, nb;
  int above = -1;  // after a pass: this thread's keys above its prefix
  for (int level = 0;; ++level) {
    nb = level == 2 ? 1024 : HIST_BINS;
    find_boundary(sh_hist, nb, remaining, sh_warp, sh_misc);
    bin = sh_misc[0];
    remaining -= sh_misc[1];
    prefix = (prefix << (level == 2 ? 10 : 11)) | (uint32_t)bin;
    const int in_bin = sh_hist[bin];
    __syncthreads();
    if (in_bin == remaining || level == 2) break;  // the whole bin, or ties
    // next level: histogram of the next bits of the keys in the bin
    const int nbits = level == 1 ? 10 : 11;
    const int nshift = shift - nbits;
    for (int i = tid; i < HIST_BINS; i += SEL_THREADS) sh_part[i] = 0;
    __syncthreads();
    above = slice_hist(v, lo, hi, sh_part, shift, prefix, nshift, nbits);
    merge_hist(cluster, sh_part, sh_hist, 1 << nbits);
    shift = nshift;
  }

  // ---- where this slice's keys go: its counts above the boundary and in
  // it, from its last histogram (or a pass when there was none), and the
  // counts of the slices before it ---------------------------------------
  const int n_above = kk - remaining;
  {
    int c_up = 0, c_eq = 0;
    if (above >= 0) {
      c_up = above;
      for (int j = bin + 1 + tid; j < nb; j += SEL_THREADS) c_up += sh_part[j];
    } else {
      for (int i = lo + tid; i < hi; i += SEL_THREADS) {
        const uint32_t h = ukey(__ldg(v + i)) >> shift;
        c_up += h > prefix;
        c_eq += h == prefix;
      }
    }
    int t_up, t_eq;
    block_scan(c_up, sh_warp, t_up);
    block_scan(c_eq, sh_warp, t_eq);
    if (tid == 0) {
      sh_slice[0] = t_up;
      sh_slice[1] = above >= 0 ? sh_part[bin] : t_eq;
    }
  }
  cluster_sync<G>(cluster);
  int ups = 0, ties = 0;  // keys of the image before this slice's next chunk
  for (int r = 0; r < rank; ++r) {
    ups += cluster.map_shared_rank(sh_slice, r)[0];
    ties += cluster.map_shared_rank(sh_slice, r)[1];
  }
  const int ups_end = ups + sh_slice[0], ties_end = ties + sh_slice[1];

  // ---- collect, in index order: keys above the boundary bin, then the
  // first `remaining` keys of the bin, each to its place among the p2 sort
  // keys spread over the cluster. Element (j, thread) of a chunk is base +
  // j * SEL_THREADS + thread (coalesced); a lane's rank is the ballot's
  // count below it plus the counts of the (j, warp) groups before its own,
  // scanned by warp 0 ---------------------------------------------------------
  const unsigned below = (1u << lane) - 1;
  for (int base = lo;
       base < hi && (ups < ups_end || (ties < ties_end && ties < remaining));
       base += SEL_THREADS * ITEMS) {
    uint32_t u[ITEMS];
    unsigned up[ITEMS], eq[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = base + j * SEL_THREADS + tid;
      u[j] = i < hi ? ukey(__ldg(v + i)) : 0u;
      up[j] = __ballot_sync(0xffffffffu, i < hi && (u[j] >> shift) > prefix);
      eq[j] = __ballot_sync(0xffffffffu, i < hi && (u[j] >> shift) == prefix);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        sh_cnt[0][j * SEL_WARPS + warp] = __popc(up[j]);
        sh_cnt[1][j * SEL_WARPS + warp] = __popc(eq[j]);
      }
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of both counts over (j, warp)
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        int* c = sh_cnt[side] + lane * ITEMS;
        int sum = 0;
#pragma unroll
        for (int e = 0; e < ITEMS; ++e) sum += c[e];
        int inc = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        int run = inc - sum;
#pragma unroll
        for (int e = 0; e < ITEMS; ++e) {
          const int x = c[e];
          c[e] = run;
          run += x;
        }
        if (lane == 31) sh_misc[2 + side] = inc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = base + j * SEL_THREADS + tid;
      const unsigned long long key =
          ((unsigned long long)u[j] << 32) | (uint32_t)(n - 1 - i);
      int pos = -1;
      if (up[j] >> lane & 1u) {
        pos = ups + sh_cnt[0][j * SEL_WARPS + warp] + __popc(up[j] & below);
      } else if (eq[j] >> lane & 1u) {
        const int r =
            ties + sh_cnt[1][j * SEL_WARPS + warp] + __popc(eq[j] & below);
        if (r < remaining) pos = n_above + r;
      }
      if (pos >= 0) st_key<G>(keys_of(pos / chunk) + pos % chunk, key);
    }
    ups += sh_misc[2];
    ties += sh_misc[3];
    __syncthreads();
  }
  for (int i = max(kk - gbase, 0) + tid; i < chunk; i += SEL_THREADS)
    st_key<G>(mine + i, 0ull);  // below every key
  cluster_sync<G>(cluster);

  // ---- bitonic sort, descending, of the p2 keys, chunk a block: strides
  // below 128 in registers (a warp a 128-key segment), strides below the
  // chunk through this block's keys with block barriers, wider strides
  // across the cluster with cluster barriers ------------------------------
  for (int seg = warp; seg < chunk / SEG; seg += SEL_WARPS)
    sort_segment<G>(mine, seg, lane, 2, gbase);
  __syncthreads();
  for (int size = 2 * SEG; size <= p2; size <<= 1) {
    // every block's keys are sorted up to the last size before they are
    // compared across blocks
    if (size > chunk) cluster_sync<G>(cluster);
    for (int stride = size >> 1; stride >= SEG; stride >>= 1) {
      if (stride >= chunk) {  // the partner is in block rank ^ stride/chunk
        if (!(gbase & stride)) {
          unsigned long long* other = keys_of(rank + stride / chunk);
          const bool desc = (gbase & size) == 0;
          for (int t = tid; t < chunk; t += SEL_THREADS) {
            const unsigned long long a = ld_key<G>(mine + t),
                                     c = ld_key<G>(other + t);
            if ((a < c) == desc) {
              st_key<G>(mine + t, c);
              st_key<G>(other + t, a);
            }
          }
        }
        cluster_sync<G>(cluster);
      } else {
        for (int t = tid; t < chunk / 2; t += SEL_THREADS) {
          const int l = 2 * t - (t & (stride - 1));
          const unsigned long long a = ld_key<G>(mine + l),
                                   c = ld_key<G>(mine + l + stride);
          if ((a < c) == (((gbase + l) & size) == 0)) {
            st_key<G>(mine + l, c);
            st_key<G>(mine + l + stride, a);
          }
        }
        __syncthreads();
      }
    }
    for (int seg = warp; seg < chunk / SEG; seg += SEL_WARPS)
      sort_segment<G>(mine, seg, lane, size, gbase);
    __syncthreads();
  }

  // ---- decode this block's sorted keys; k > N pads with (-1.0, index 0) --
  const int mine_end = min(kk, gbase + chunk);
  for (int j = gbase + tid; j < mine_end; j += SEL_THREADS) {
    const unsigned long long key = ld_key<G>(mine + j - gbase);
    const int idx = n - 1 - (int)(uint32_t)key;
    const size_t o = (size_t)b * k + j;
    if (DETECT) {
      const int s = sub[(size_t)b * n + idx];
      out_idx[2 * o] = (idx % w2) * 2 + s % 2;
      out_idx[2 * o + 1] = (idx / w2) * 2 + s / 2;
    } else {
      out_idx[o] = idx;
    }
    out_val[o] = from_ukey((uint32_t)(key >> 32));
  }
  for (int j = kk + rank * SEL_THREADS + tid; j < k; j += CL * SEL_THREADS) {
    const size_t o = (size_t)b * k + j;
    if (DETECT) {
      const int s = sub[(size_t)b * n];
      out_idx[2 * o] = s % 2;
      out_idx[2 * o + 1] = s / 2;
    } else {
      out_idx[o] = 0;
    }
    out_val[o] = -1.f;
  }
}

template <bool DETECT, bool G>
static cudaError_t launch_select(const float* vals, int B, int n,
                                 const int* hist0, int k, int p2, void* gsel,
                                 const uint8_t* sub, int w2, long long* idx,
                                 float* val, cudaStream_t s) {
  const int smem = G ? 0 : p2 / CL * (int)sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel<DETECT, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  select_kernel<DETECT, G><<<B * CL, SEL_THREADS, smem, s>>>(
      vals, n, hist0, k, p2, static_cast<unsigned long long*>(gsel), sub, w2,
      idx, val);
  return cudaGetLastError();
}

// the selection, its keys in shared memory for p2 <= SEL_SMEM_KEYS, else
// in gsel (B,p2)
template <bool DETECT>
static cudaError_t run_select(const float* vals, int B, int n, const int* hist0,
                          int k, int p2, void* gsel, const uint8_t* sub,
                          int w2, long long* idx, float* val,
                          cudaStream_t s) {
  if (n < 1 || k < 1 || p2 < (k < n ? k : n) || p2 < 128 * CL ||
      (p2 & (p2 - 1)) || (p2 > SEL_SMEM_KEYS) != (gsel != nullptr) ||
      B < 1 || B > 65535 / CL)
    return cudaErrorInvalidValue;
  return gsel ? launch_select<DETECT, true>(vals, B, n, hist0, k, p2, gsel,
                                            sub, w2, idx, val, s)
              : launch_select<DETECT, false>(vals, B, n, hist0, k, p2, gsel,
                                             sub, w2, idx, val, s);
}

// Candidates, their histogram and the exact top-k: xy (B,k,2) int64 and
// scores (B,k) f32. best, sub: candidate scratch; hist: (B,2048) int32
// scratch (zeroed here); gsel: (B,p2) uint64 scratch when p2 > 131072, else
// null; p2: the power of two >= min(k, N).
extern "C" int detect_topk(const float* heat, const float* rel, float* best,
                           uint8_t* sub, int* hist, void* gsel,
                           long long* xy, float* scores, int B, int H, int W,
                           int h, int w, float thr, float sx, float sy, int k,
                           int p2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(hist, 0, sizeof(int) * HIST_BINS * (size_t)B, s);
  if (err != cudaSuccess) return (int)err;
  dim3 block(TILES_X, TILES_Y);
  dim3 grid((W / 2 + TILES_X - 1) / TILES_X, (H / 2 + TILES_Y - 1) / TILES_Y,
            B);
  detect_candidates_kernel<<<grid, block, 0, s>>>(heat, rel, best, sub, hist,
                                                  H, W, h, w, thr, sx, sy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)run_select<true>(best, B, (H / 2) * (W / 2), hist, k, p2, gsel,
                           sub, W / 2, xy, scores, s);
}

// Exact top-k of (B,n) f32 rows: idx (B,k) int64 and values (B,k) f32.
extern "C" int topk_exact(const float* vals, void* gsel, long long* idx,
                          float* out, int B, int n, int k, int p2,
                          void* stream) {
  return (int)run_select<false>(vals, B, n, nullptr, k, p2, gsel, nullptr, 1,
                            idx, out, (cudaStream_t)stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
