// Single-head softmax attention with a key-side mask for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` in
// accelerated_features_tpu/ops/pallas/attention.py (entered through
// flash_attention; LighterGlue's and LightGlue's self- and cross-attention).
// For each batch item it computes out[i,:] = sum_j softmax_j(scale *
// q[i].k[j]) v[j,:] in float32 with the online-softmax recurrence over key
// tiles, so the Nq x Nk score matrix never reaches device memory. Masked
// keys score -1e9 (never -inf): a row whose keys are all masked gets the
// mean of V over its Nk keys, as the plain version gives. Keys beyond Nk do
// not exist.
//
// Bound on the H100: operations. At Nq = Nk = 4096, D = 96 it does
// 4*Nq*Nk*D = 6.4 GFLOP against ~6 MB of q, k, v and out. The output is
// held to 2e-5, so both products run on the tensor cores at float32 grade
// as 3xTF32 (tf32x3.cuh): three TF32 products an output, which makes the
// least time 3 * 4*Nq*keys*D / 495 TFLOP/s. The operands are split by
// cutting (split_cut: the head is x itself, the tail x minus x cut to
// TF32; its error, ~2^-20 of a product, is far inside the gate).
//
// attn_partial_kernel<D> (D = 32, 64: LightGlue's heads; 96: LighterGlue's
// one head) runs both products as warpgroup products (wgmma), which alone
// reach the tensor cores' full rate; mma.sync TF32 stops at ~0.64 of it on
// this card. A block of 384 threads owns 128 query rows:
//   - a producer warpgroup (lowered to 40 registers by setmaxnreg) brings
//     each key tile of K and V (64 keys; 32 at D = 96, where two stages of
//     64-key planes and raw tiles would not fit in shared memory) into a ring
//     of two raw stages with two bulk copies (one thread, completion counted
//     on an mbarrier), reads the tile's mask bytes, and splits every element
//     once into TF32 head and tail planes in a ring of two plane stages: K as
//     stored (K-major) and V transposed, since TF32 wgmma takes only K-major
//     B operands. Within each 8-key group V^T's slots follow the order in
//     which the score accumulator holds P (slot t is key 2t, slot t+4 is key
//     2t+1). Beside the planes it writes per-key codes (1 attend, 0 masked,
//     -1 beyond Nk), then fence.proxy.async and an arrive on the stage's
//     `full` mbarrier;
//   - two consumer warpgroups of 64 rows (raised to 232 registers) split
//     their Q rows once into head and tail A fragments held in registers. For
//     each tile: S = three m64nBk8 products a k-step (B the tile's keys;
//     tail.head, head.tail, head.head, the small terms first), the base-2
//     online softmax in registers in the accumulator layout (a row lies in
//     the four threads of a quad), P split in place into A fragments, then O
//     += three m64nDk8 products a step of 8 keys on the V^T planes, and an
//     arrive on the stage's `empty` mbarrier. The two take turns at S (named
//     barriers), so one's softmax runs beside the other's products.
// So no warp re-splits a tile that another has split, Q is split once, the
// B operands come from shared memory without a load instruction, and no
// thread issues a copy per 16 bytes. What bounds it is the tensor rate of
// the products, the producer's split (~8% of the time at LightGlue's
// shape) and, from the consumers' side, the wait for each product group
// before its softmax or the next tile.
//
// A key tile in which every key is masked is skipped when the batch item
// has an unmasked key somewhere (its keys then weigh exactly 0); an item
// with no unmasked key runs every tile and gets the mean of V. One image
// pair gives only Nq/128 query tiles, fewer than the card has SMs, so the
// keys are also split over blockIdx.y, about one block an SM: each split
// writes its unnormalised (m, l, acc) and a small second kernel,
// attn_merge_kernel, merges them. With one split the block writes the
// output itself.
//
// For training, the caller may pass `lse` (B,Nq): the row log-sum-exp of
// the masked, scaled scores in natural log, which the backward
// (attention_bwd.cu) recomputes the probabilities from. The block writes it
// with one split, the merge with more; a null `lse` writes nothing and
// leaves the inference launch as it was.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

#define BN 64  // keys of the tiles the key split counts
#define NEG (-1e9f)
#define LN2 0.6931471805599453f

// 2^x on the special-function unit; results below 2^-126 are 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The warpgroup kernel: one producer warpgroup, two consumer warpgroups of
// 64 query rows. See the note at the top of the file.

namespace wg {

constexpr int CONSUMERS = 2;                     // warpgroups of 64 rows
constexpr int ROWS = 64 * CONSUMERS;             // query rows of a block
constexpr int NTHREADS = 128 * (CONSUMERS + 1);  // the producer is last
constexpr int PLANES = 2;  // stages of split K and V^T planes
constexpr int RAW = 2;     // stages of raw K and V tiles
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 64512 in all

// Byte offsets in a block's dynamic shared memory. A plane holds one TF32
// operand of a BK-key tile as 16-byte chunks (core-matrix rows) without
// swizzle. K (B of Q.K^T: N = keys, K = columns): the chunk of key n and
// columns 4kc..4kc+3 at byte kc*KLEAD + n*16, KLEAD = BK*16 + 16, so that
// eight chunks of one key (one row of the raw tile) land on eight
// different bank groups. V^T (B of P.V: N = columns d, K = key slots): the
// chunk of d and slots 4kc..4kc+3 at byte (kc*D + d)*16. A raw tile is K or
// V as stored, BK rows of D floats, brought in by one bulk copy each.
template <int D>
struct Layout {
  // keys of a tile: 32 at D = 96, where two stages of 64-key planes and
  // the raw tiles would not fit in shared memory
  static constexpr int BK = D == 96 ? 32 : 64;
  static constexpr int KLEAD = BK * 16 + 16;
  static constexpr int KPLANE = D / 4 * KLEAD;
  static constexpr int VPLANE = BK * D * 4;
  static constexpr int STAGE = 2 * KPLANE + 2 * VPLANE;  // K hi, lo, V^T
  static constexpr int RAW_TILE = 2 * BK * D * 4;        // K, then V
  static constexpr int RAWS = PLANES * STAGE;
  static constexpr int CODES = RAWS + RAW * RAW_TILE;        // [PLANES][BK]
  static constexpr int RAW_CODES = CODES + PLANES * BK * 4;  // [RAW][BK]
  // mbarriers: full and empty of each plane stage, loaded of each raw one
  static constexpr int BARS = RAW_CODES + RAW * BK * 4;
  static constexpr int LIVE = BARS + (2 * PLANES + RAW) * 8;
  static constexpr int bytes(int tiles_per_split) {
    return LIVE + 4 * tiles_per_split;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` from asynchronous copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory by the bulk-copy
// engine, counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          bar)
      : "memory");
}

// Wait until the barrier's phase of this parity has completed. The loop
// lies inside one asm statement, so the compiler cannot share its blocks
// between the producer's and the consumers' code (each has its own
// register budget). A wait of 2^33 clocks (seconds) can only be a fault of
// the pipeline: it traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.s64 t1, t1, t0;\n"
      "setp.gt.s64 p, t1, 8589934592;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products or their fence (past which ptxas would
// insert a fence of its own and serialize the products)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// descriptor of a K-major operand without swizzle: 8-row x 16-byte core
// matrices `lead` bytes apart along K and `stride` bytes apart along N
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead,
                                         uint32_t stride) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)(lead >> 4) << 16) | ((uint64_t)(stride >> 4) << 32);
}

// d (64 x N) += a (64 x 8, registers) . b (8 x N, shared memory) in TF32.
// Per warp, a and d are laid out as the mma.sync fragments of tf32x3.cuh
// (warp w owns rows 16w..16w+15). The products always accumulate: a
// scale-d predicate taken from a register made ptxas serialize them.
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the TF32 tail of x under split_cut (the head is x itself)
__device__ __forceinline__ float tail(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::NTHREADS, 1)
    attn_partial_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const uint8_t* __restrict__ mask,
                              float* __restrict__ part_acc,
                              float* __restrict__ part_ml,
                              float* __restrict__ out,
                              float* __restrict__ lse, int Nq, int Nk,
                              float scale, int tiles_per_split) {
  using L = wg::Layout<D>;
  constexpr int NO = D / 8;      // 8-column blocks of the output
  constexpr int BK = L::BK;      // keys of a tile
  constexpr int NK = BK / 8;     // 8-key blocks of a tile
  extern __shared__ __align__(128) unsigned char smem_wg[];
  float* planes = reinterpret_cast<float*>(smem_wg);
  float* raws = reinterpret_cast<float*>(smem_wg + L::RAWS);
  // per plane stage and key: 1 attend, 0 masked, -1 beyond Nk; the raw
  // stages hold the codes of the tiles on their way
  int* codes = reinterpret_cast<int*>(smem_wg + L::CODES);
  int* raw_codes = reinterpret_cast<int*>(smem_wg + L::RAW_CODES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_wg + L::BARS);
  int* live = reinterpret_cast<int*>(smem_wg + L::LIVE);
  const uint32_t full0 = wg::smem_addr(bars);
  const uint32_t empty0 = wg::smem_addr(bars + wg::PLANES);
  const uint32_t loaded0 = wg::smem_addr(bars + 2 * wg::PLANES);

  const int b = blockIdx.z, split = blockIdx.y, r0 = blockIdx.x * wg::ROWS;
  const int tid = threadIdx.x;
  const float* qb = q + (size_t)b * Nq * D;
  const float* kb = k + (size_t)b * Nk * D;
  const float* vb = v + (size_t)b * Nk * D;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * Nk;
  const int n_tiles = (Nk + BK - 1) / BK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  if (tid == 0) {
    for (int s = 0; s < wg::PLANES; ++s) {
      wg::mbar_init(full0 + 8 * s, 128);                   // the producer
      wg::mbar_init(empty0 + 8 * s, 128 * wg::CONSUMERS);  // the consumers
    }
    for (int s = 0; s < wg::RAW; ++s) wg::mbar_init(loaded0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // which tiles may be skipped: those without an unmasked key, if the item
  // has an unmasked key at all
  bool may_skip = false;
  if (mb != nullptr) {
    for (int i = tid; i < tiles_per_split; i += wg::NTHREADS) live[i] = 0;
    __syncthreads();
    int any = 0;
    for (int i = tid; i < Nk; i += wg::NTHREADS) {
      if (mb[i] != 0) {
        any = 1;
        const int tile = i / BK;
        if (tile >= t_begin && tile < t_end) live[tile - t_begin] = 1;
      }
    }
    may_skip = __syncthreads_or(any) != 0;
  }
  __syncthreads();  // the barriers are initialised
  auto next_live = [&](int tile) {
    while (tile < t_end && may_skip && live[tile - t_begin] == 0) ++tile;
    return tile;
  };

  if (tid >= 128 * wg::CONSUMERS) {
    // ---- producer: raw tiles in by bulk copies, split once into the planes
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        wg::PRODUCER_REGS));
    const int p = tid - 128 * wg::CONSUMERS;
    const uint32_t raw0 = wg::smem_addr(raws);
    auto load = [&](int tile, int slot) {  // thread 0 of the warpgroup
      const int n0 = tile * BK;
      const uint32_t bytes = min(BK, Nk - n0) * D * 4;
      const uint32_t bar = loaded0 + 8 * slot;
      wg::mbar_expect(bar, 2 * bytes);
      wg::bulk_load(raw0 + slot * L::RAW_TILE, kb + (size_t)n0 * D, bytes,
                    bar);
      wg::bulk_load(raw0 + slot * L::RAW_TILE + L::RAW_TILE / 2,
                    vb + (size_t)n0 * D, bytes, bar);
    };
    auto code_of = [&](int tile) {
      const int col = tile * BK + p;
      return col >= Nk ? -1 : (mb == nullptr || mb[col] != 0) ? 1 : 0;
    };
    int load_t = next_live(t_begin);
    for (int s = 0; s < wg::RAW; ++s) {
      if (load_t < t_end) {
        if (p == 0) load(load_t, s);
        if (p < BK) raw_codes[s * BK + p] = code_of(load_t);
        load_t = next_live(load_t + 1);
      }
    }
    int slot = 0, ps = 0;
    uint32_t phase = 0, raw_phase = 0;
    for (int tile = next_live(t_begin); tile < t_end;
         tile = next_live(tile + 1)) {
      // the mask byte of the tile loaded at the end of this step, read now
      const int next_code = p < BK && load_t < t_end ? code_of(load_t) : 0;
      const int valid = min(BK, Nk - tile * BK);  // keys of the tile
      wg::mbar_wait(loaded0 + 8 * slot, raw_phase);  // the tile is in
      wg::mbar_wait(empty0 + 8 * ps, phase ^ 1);     // the stage is free
      const float* Kr = raws + slot * (L::RAW_TILE / 4);
      const float* Vr = Kr + BK * D;
      float* Kh = planes + ps * (L::STAGE / 4);
      float* Kl = Kh + L::KPLANE / 4;
      float* Vh = Kl + L::KPLANE / 4;
      float* Vl = Vh + L::VPLANE / 4;
      // K: chunk i of the raw tile is key i / (D/4), columns 4kc..4kc+3;
      // keys beyond Nk (the end of the last tile) become zeros
#pragma unroll 2
      for (int i = p; i < BK * D / 4; i += 128) {
        const int key = i / (D / 4), kc = i % (D / 4);
        float4 x = *reinterpret_cast<const float4*>(Kr + 4 * i);
        if (key >= valid) x = make_float4(0.f, 0.f, 0.f, 0.f);
        const int at = (kc * L::KLEAD + key * 16) / 4;
        *reinterpret_cast<float4*>(Kh + at) = x;
        *reinterpret_cast<float4*>(Kl + at) = make_float4(
            wg::tail(x.x), wg::tail(x.y), wg::tail(x.z), wg::tail(x.w));
      }
      // V^T slot 4(kc%2)+i of key group kc/2 is key 8(kc/2) + 2i + kc%2:
      // the order of P's A fragment in the score accumulator's layout
#pragma unroll 2
      for (int c = p; c < BK * D / 4; c += 128) {
        const int kc = c / D, d = c % D, key = 8 * (kc >> 1) + (kc & 1);
        const float* src = Vr + key * D + d;
        float4 x = make_float4(src[0], src[2 * D], src[4 * D], src[6 * D]);
        if (key + 6 >= valid) {  // keys beyond Nk are zeros
          x.x = key < valid ? x.x : 0.f;
          x.y = key + 2 < valid ? x.y : 0.f;
          x.z = key + 4 < valid ? x.z : 0.f;
          x.w = 0.f;
        }
        *reinterpret_cast<float4*>(Vh + 4 * c) = x;
        *reinterpret_cast<float4*>(Vl + 4 * c) = make_float4(
            wg::tail(x.x), wg::tail(x.y), wg::tail(x.z), wg::tail(x.w));
      }
      if (p < BK) codes[ps * BK + p] = raw_codes[slot * BK + p];
      // the planes were written by this thread's generic stores and are
      // read by the consumers' asynchronous products
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      wg::mbar_arrive(full0 + 8 * ps);
      asm volatile("bar.sync 1, 128;" ::: "memory");  // the raw slot is free
      if (load_t < t_end) {
        if (p == 0) load(load_t, slot);
        if (p < BK) raw_codes[slot * BK + p] = next_code;
        load_t = next_live(load_t + 1);
      }
      if (++slot == wg::RAW) {
        slot = 0;
        raw_phase ^= 1;
      }
      if (++ps == wg::PLANES) {
        ps = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup, 16 a warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        wg::CONSUMER_REGS));
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = r0 + warp * 16 + g;  // and row0 + 8
    // Q's TF32 head and tail as A fragments, split once
    uint32_t qh[NO][4], ql[NO][4];
#pragma unroll
    for (int ks = 0; ks < NO; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e & 1) * 8, col = ks * 8 + t + (e >> 1) * 4;
        const float x = row < Nq ? qb[(size_t)row * D + col] : 0.f;
        tf32x3::split_cut(x, qh[ks][e], ql[ks][e]);
      }
    // s[4j+e] and acc[4n+e]: row g (e < 2) or g + 8, column 8j + 2t + e%2
    // (8n + ...); the softmax runs in base 2, m is the row max of
    // score * scale * log2(e)
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[4 * NO], s[4 * NK];
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) acc[i] = 0.f;
    const float scale2 = scale * 1.4426950408889634f;
    const uint32_t plane0 = wg::smem_addr(planes);
    int ps = 0;
    uint32_t phase = 0;
    // The two warpgroups take turns at S (named barriers 2 and 3, warpgroup
    // 0 first): one's softmax then runs beside the other's products
    // instead of both waiting on the tensor cores at once.
    const int wgc = warp >> 2;
    if (wgc == 1) asm volatile("bar.arrive 2, 256;" ::: "memory");
    for (int tile = next_live(t_begin); tile < t_end;
         tile = next_live(tile + 1)) {
      wg::mbar_wait(full0 + 8 * ps, phase);
      asm volatile("bar.sync %0, 256;" ::"r"(2 + wgc) : "memory");
      const uint32_t kh = plane0 + ps * L::STAGE, kl = kh + L::KPLANE;
      const uint32_t vh = kl + L::KPLANE, vl = vh + L::VPLANE;

      // S = Q.K^T, 3xTF32 a k-step, the small terms first
#pragma unroll
      for (int i = 0; i < 4 * NK; ++i) s[i] = 0.f;
      wg::fence_regs(s);  // the zeros are written before the fence
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NO; ++ks) {
        const uint32_t off = ks * 2 * L::KLEAD;
        wg::mma(s, ql[ks], wg::desc(kh + off, L::KLEAD, 128));
        wg::mma(s, qh[ks], wg::desc(kl + off, L::KLEAD, 128));
        wg::mma(s, qh[ks], wg::desc(kh + off, L::KLEAD, 128));
      }
      wg::wgmma_commit();
      wg::wgmma_wait();
      wg::fence_regs(s);
      if (wgc == 0 || next_live(tile + 1) < t_end)  // the other's turn
        asm volatile("bar.arrive %0, 256;" ::"r"(3 - wgc) : "memory");

      // online softmax
      const int* cs = codes + ps * BK;
      int code[NK][2];
      float m_new[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int2 c2 = *reinterpret_cast<const int2*>(cs + j * 8 + 2 * t);
        code[j][0] = c2.x;
        code[j][1] = c2.y;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = code[j][e & 1];
          s[4 * j + e] = c > 0 ? s[4 * j + e] * scale2 : NEG;
          if (c >= 0) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[4 * j + e]);
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
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = code[j][e & 1] >= 0
                             ? fast_exp2(s[4 * j + e] - m_new[e >> 1])
                             : 0.f;
          sum[e >> 1] += s[4 * j + e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
      for (int i = 0; i < 4 * NO; ++i) acc[i] *= corr[(i >> 1) & 1];

      // acc += P.V^T planes, 3xTF32 a step of 8 keys; the accumulator of
      // S is P's A fragment as it stands (k-slot t is key 2t, t+4 is 2t+1)
      uint32_t ph[NK][4], pl[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        tf32x3::split_cut(s[4 * j + 0], ph[j][0], pl[j][0]);
        tf32x3::split_cut(s[4 * j + 2], ph[j][1], pl[j][1]);
        tf32x3::split_cut(s[4 * j + 1], ph[j][2], pl[j][2]);
        tf32x3::split_cut(s[4 * j + 3], ph[j][3], pl[j][3]);
      }
      wg::fence_regs(acc);
      wg::fence_regs(ph);
      wg::fence_regs(pl);
      wg::wgmma_fence();
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const uint32_t off = j * 2 * D * 16;
        wg::mma(acc, pl[j], wg::desc(vh + off, D * 16, 128));
        wg::mma(acc, ph[j], wg::desc(vl + off, D * 16, 128));
        wg::mma(acc, ph[j], wg::desc(vh + off, D * 16, 128));
      }
      wg::wgmma_commit();
      wg::wgmma_wait();
      wg::fence_regs(acc);
      wg::mbar_arrive(empty0 + 8 * ps);  // this thread is done with the stage
      if (++ps == wg::PLANES) {
        ps = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const bool whole = gridDim.y == 1;
    const size_t base = ((size_t)b * gridDim.y + split) * Nq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      if (row >= Nq) continue;
      const float w = whole ? 1.f / fmaxf(l[h], 1e-30f) : 1.f;
      float* dst = whole ? out + ((size_t)b * Nq + row) * D
                         : part_acc + (base + row) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(dst + n * 8 + 2 * t) =
            make_float2(acc[4 * n + h * 2] * w, acc[4 * n + h * 2 + 1] * w);
      if (!whole && t == 0) {
        part_ml[(base + row) * 2] = m[h];
        part_ml[(base + row) * 2 + 1] = l[h];
      }
      if (whole && lse != nullptr && t == 0)
        lse[(size_t)b * Nq + row] = (m[h] + log2f(fmaxf(l[h], 1e-30f))) * LN2;
    }
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

// the 64-key tiles of each split, or the launch error of an empty split
static cudaError_t tiles_per_split(int Nk, int splits, int* tps) {
  const int n_tiles = (Nk + BN - 1) / BN;
  *tps = (n_tiles + splits - 1) / splits;
  if ((n_tiles + *tps - 1) / *tps != splits)
    return cudaErrorInvalidValue;  // a split would be empty
  return cudaSuccess;
}

template <int D>
static cudaError_t launch_partial(const float* q, const float* k,
                                  const float* v, const uint8_t* mask,
                                  float* part_acc, float* part_ml, float* out,
                                  float* lse, int B, int Nq, int Nk,
                                  float scale, int splits, cudaStream_t s) {
  int tps;
  cudaError_t err = tiles_per_split(Nk, splits, &tps);
  if (err != cudaSuccess) return err;
  tps *= BN / wg::Layout<D>::BK;  // in the kernel's tiles; none is empty
  const int bytes = wg::Layout<D>::bytes(tps);
  err = cudaFuncSetAttribute(attn_partial_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Nq + wg::ROWS - 1) / wg::ROWS, splits, B);
  attn_partial_kernel<D><<<grid, wg::NTHREADS, bytes, s>>>(
      q, k, v, mask, part_acc, part_ml, out, lse, Nq, Nk, scale, tps);
  return cudaGetLastError();
}

// q (B,Nq,D), k and v (B,Nk,D), out (B,Nq,D) float32; mask (B,Nk) bytes or
// null; part_acc (B,splits,Nq,D) and part_ml (B,splits,Nq,2) scratch, unused
// (may be null) when splits is 1; lse (B,Nq) float32 or null. Runs
// attn_partial_kernel (and attn_merge_kernel when splits > 1).
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

// dynamic shared memory of a block of the kernel attention_forward
// launches at width D, `tiles_per_split` 64-key tiles a split, or -1
extern "C" int attention_smem_bytes(int D, int tiles_per_split) {
  switch (D) {
    case 32:
      return wg::Layout<32>::bytes(tiles_per_split);
    case 64:
      return wg::Layout<64>::bytes(tiles_per_split);
    case 96:
      return wg::Layout<96>::bytes(tiles_per_split * 2);
    default:
      return -1;
  }
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
