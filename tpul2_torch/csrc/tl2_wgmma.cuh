// tl2_wgmma.cuh — the TMA + wgmma ring kernel of tl2_wgmma.cu, shared by its instance files
// (tl2_wgmma.cu: the 64/128 tiles and the host API; tl2_wgmma_n32.cu: the tiles with bn = 32;
// tl2_wgmma_swap.cu: bm = 32 over bn 64/128) and by the wide route's kernel
// (tl2_wgmma_wide.cuh, built in the eight tl2_wgmma_wide*.cu files). One nvcc runs per file,
// all side by side. What the kernel computes, and the design, are in tl2_wgmma.cu's header
// (the wide blocks' in tl2_wgmma_wide.cu's).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tl2_wgmma_model.cuh"  // KSTAGE, ROW_BYTES, SMEM_LIMIT, cdiv, the block rules and
                                // the shared-memory models of the ring and the wide route

namespace tl2wg {

typedef __nv_bfloat16 bf16;

// setmaxnreg with two consumer warpgroups: ptxas allocates 168 registers a thread at entry
// (384 threads), so 4 producer warps at 40 and 8 consumer warps at 232 use the same total
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_THREADS = 128;   // the producer warpgroup
// A wait that outlasts this many polls is a fault of the ring protocol: trap (a launch
// error) instead of hanging the card.
constexpr int SPIN_LIMIT = 1 << 26;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_TANH = 4 };

struct WgParams {
  const float* bias;   // (N,) or null
  void* c;             // (batch, M, N), row stride N; a split launch: (splits, M, N) f32
  const bf16* a;       // (batch, M, K): read by the loads producer where load_a != 0
  const bf16* b;       // (batch, K, N) or (batch, N, K): the same where load_b != 0
  long long sa, sb;    // batch strides of A and B in elements
  long long sc;        // batch stride of C in elements
  long long ssplit;    // split stride of C in elements (0 without a split)
  int m, n, k, bk;
  int stages;          // ring depth
  int split_steps;     // 64-deep K stages per split (all of them without a split)
  int act, raster_nm, out_f32, vec_out;
  int load_a, load_b;  // 0: TMA fills the operand; 8, 4, 2: the loads producer's copies
                       // of that many elements; 1: its gather path
  int blk_m, blk_n;      // the block: the CTAs' stride, and where their stores stop
  int wide_stream;       // the wide route: 1 where A streams through the ring beside B
  int tma_c;             // the wide route: 1 where TMA stores C, 0 predicated stores
  int batch;             // the wide route: the batch, whose elements its work items span
};

// The tile's shape on the tensor cores. wgmma takes 64 rows and a width that is a multiple
// of 8, so:
//   bm, bn in {64, 128}: one consumer warpgroup per 64 rows of C, m64 x bn wgmmas;
//   bn = 32 (bm 32, 64 or 128): the same at width 32; at bm = 32 (this orientation is the
//     one picked for 32 x 32) the warpgroup's rows 32..63 read whatever follows the A tile
//     in the stage and are never stored: a row of the product depends only on its row of A;
//   bm = 32, bn in {64, 128} (SWAP): the CTA computes C_tile^T = B_tile^T A_tile^T, so the
//     tile's bn rows of N are wgmma's M (one warpgroup per 64) and A's 32 K-major rows are
//     wgmma's B at width 32; B_t ('nk') is K-major, wgmma's natural A layout, and B ('kn')
//     is MN-major, read with the transpose flag on the shared-memory A operand.
// A block of any edges in 1..128 runs the tile of ring_edge(bm) x ring_edge(bn)
// (tl2_wgmma_model.cuh): the CTAs step by the block's edges (p.blk_m, p.blk_n), not the
// tile's, so the tile's rows beyond bm (columns beyond bn) read the next block's rows
// (columns), or zeros past the problem, and the epilogue stores nothing beyond the block's
// edge or the problem's. A bm <= 32 beside bn > 32 takes the swapped tile, bn <= 32 the
// width-32 one (bm <= 32 too).
template <int BM, int BN>
struct WgTile {
  static constexpr bool SWAP = BM == 32 && BN > 32;
  static constexpr int WG_ROWS = SWAP ? BN : (BM < 64 ? 64 : BM);
  static constexpr int CONSUMERS = WG_ROWS / 64;              // warpgroups, 64 rows each
  static constexpr int THREADS = (CONSUMERS + 1) * 128;       // + the producer warpgroup
  static constexpr int WG_N = SWAP ? BM : BN;                 // wgmma's width
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int ACC = WG_N / 2;                        // f32 registers of m64 x WG_N
};

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.0f);
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x / (1.0f + expf(-x));
    case ACT_TANH: return tanhf(x);
    default: return x;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the barrier with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == SPIN_LIMIT) __trap();
  }
}

// One TMA box of a rank-3 map into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- the loads producer: ordinary loads into the same swizzled stages ----

// `bytes` (4, 8 or 16) from global memory into shared memory, or zeros where !ok (nothing
// is read then: the source size is 0).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(ok ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's newest cp.async groups are pending (n in 0..7).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Generic-proxy writes to shared memory (cp.async, st.shared) become visible to the async
// proxy, which wgmma reads its operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy one run of `w` elements (w = 8, 4 or 2: 16, 8 or 4 bytes; a run never crosses a
// 16-byte unit of the swizzle) to dst, or zeros where !ok.
__device__ __forceinline__ void load_run(uint32_t dst, const bf16* src, const bf16* safe,
                                         bool ok, int w) {
  const void* s = ok ? static_cast<const void*>(src) : static_cast<const void*>(safe);
  switch (w) {
    case 8: cp_async<16>(dst, s, ok); break;
    case 4: cp_async<8>(dst, s, ok); break;
    default: cp_async<4>(dst, s, ok); break;
  }
}

__device__ __forceinline__ int log2_width(int w) { return w == 8 ? 3 : w == 4 ? 2 : 1; }

// The gather path, for rows that allow no 4-byte copy (an odd length or a base 2 bytes off
// 4): 8 elements at p, the first v of them valid (none where v <= 0) and the rest zero,
// from the one or two 16-byte aligned blocks that hold them, shifted into place. A block
// that holds a byte of the operand lies in the page that holds that byte, so its other
// bytes can be read. The loads are ordinary loads into registers: unlike a copy of 2 bytes
// at a time, the 16-byte loads of several runs are in flight together.
__device__ __forceinline__ uint4 gather8(const bf16* p, int v) {
  if (v <= 0) return make_uint4(0, 0, 0, 0);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const int off = static_cast<int>(addr & 15);
  const uint4* blk = reinterpret_cast<const uint4*>(addr - off);
  const uint4 lo = __ldg(blk);
  const uint4 hi = off + 2 * (v < 8 ? v : 8) > 16 ? __ldg(blk + 1) : make_uint4(0, 0, 0, 0);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = off >> 2;  // whole words before the first element
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    x[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = (off & 2) ? __funnelshift_r(x[i], x[i + 1], 16) : x[i];  // element 2i low
    if (2 * i >= v)
      r[i] = 0;
    else if (2 * i + 1 >= v)
      r[i] &= 0xFFFFu;
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// No "memory" clobber: the loads of the next runs may move above the store.
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}

// A K-major operand's stage: R rows of 64 K (A, or B_t), row r = global row row0 + r,
// 128-byte swizzle (the 16-byte unit u of row r sits at unit u ^ (r % 8)). Zeros past
// row_lim and past K. w: the copy width in elements, or 1 for the gather path.
template <int R>
__device__ __forceinline__ void load_kmajor(uint32_t dst, const bf16* src, int ld, int row0,
                                            int row_lim, int k0, int k, int w, int t) {
  if (w == 1) {
#pragma unroll 2
    for (int i = 0; i < R * 8 / PRODUCER_THREADS; ++i) {
      const int q = t + i * PRODUCER_THREADS;
      const int r = q >> 3, u = q & 7;
      const int gr = row0 + r, gc = k0 + 8 * u;
      st_shared16(dst + r * ROW_BYTES + ((u ^ (r & 7)) << 4),
                  gather8(src + (long long)gr * ld + gc, gr < row_lim ? k - gc : 0));
    }
    return;
  }
  const int lw = log2_width(w);
  const int per_row = KSTAGE >> lw;
  for (int q = t; q < R * per_row; q += PRODUCER_THREADS) {
    const int r = q >> (6 - lw), c = (q & (per_row - 1)) << lw;
    const int gr = row0 + r, gc = k0 + c;
    const int cb = 2 * c;
    const uint32_t off = r * ROW_BYTES + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
    load_run(dst + off, src + (long long)gr * ld + gc, src, gr < row_lim && gc < k, w);
  }
}

// B (K, N) in 'kn', MN-major: for bn >= 64, bn / 64 boxes of [64 K][64 N] at 8192 bytes
// each, 128-byte swizzle; for bn = 32 one box of [64 K][32 N], 64-byte swizzle (the 16-byte
// unit u of row r at u ^ ((r / 2) % 4)). Zeros past K and past N. w as for load_kmajor.
template <int BN>
__device__ __forceinline__ void load_mnmajor(uint32_t dst, const bf16* src, int n, int k0,
                                             int k, int n0, int w, int t) {
  constexpr int COLS = BN == 32 ? 32 : 64;
  constexpr int LCOLS = BN == 32 ? 5 : 6;
  constexpr int BOXES = BN == 32 ? 1 : BN / 64;
  if (w == 1) {
    constexpr int LRUNS = LCOLS - 3;  // log2 of the 8-element runs in a row
#pragma unroll 2
    for (int i = 0; i < (BOXES << (6 + LRUNS)) / PRODUCER_THREADS; ++i) {
      const int q = t + i * PRODUCER_THREADS;
      const int box = q >> (6 + LRUNS), r = (q >> LRUNS) & 63, u = q & ((1 << LRUNS) - 1);
      const int gk = k0 + r, gn = n0 + 64 * box + 8 * u;
      const int unit = BN == 32 ? (u ^ ((r >> 1) & 3)) : (u ^ (r & 7));
      st_shared16(dst + box * 64 * ROW_BYTES + r * (2 * COLS) + (unit << 4),
                  gather8(src + (long long)gk * n + gn, gk < k ? n - gn : 0));
    }
    return;
  }
  const int lw = log2_width(w);
  const int lrow = LCOLS - lw;  // log2 of the runs in a row
  const int lbox = 6 + lrow;    // log2 of the runs in a box of 64 rows
  for (int q = t; q < (BOXES << lbox); q += PRODUCER_THREADS) {
    const int box = q >> lbox, r = (q >> lrow) & 63, c = (q & ((1 << lrow) - 1)) << lw;
    const int gk = k0 + r, gn = n0 + 64 * box + c;
    const int cb = 2 * c;
    const int unit = BN == 32 ? ((cb >> 4) ^ ((r >> 1) & 3)) : ((cb >> 4) ^ (r & 7));
    const uint32_t off = box * 64 * ROW_BYTES + r * (2 * COLS) + ((unit << 4) | (cb & 15));
    load_run(dst + off, src + (long long)gk * n + gn, src, gk < k && gn < n, w);
  }
}

// ---- wgmma ----

// wgmma shared-memory matrix descriptor; `swizzle` is the layout type (1: 128-byte,
// 2: 64-byte); the byte offsets are stored in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}
constexpr uint64_t SW128 = 1, SW64 = 2;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of the accumulator across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TL2_F8(b)                                                                     \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),     \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (+)= A[64 x 16] * B[16 x 32]; scale_d = 0 starts from zero. TA / TB: the operand in
// shared memory is MN-major (the transpose flags).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : TL2_F8(0), TL2_F8(8)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A[64 x 16] * B[16 x 64].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : TL2_F8(0), TL2_F8(8), TL2_F8(16), TL2_F8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (+)= A[64 x 16] * B[16 x 128].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : TL2_F8(0), TL2_F8(8), TL2_F8(16), TL2_F8(24), TL2_F8(32), TL2_F8(40), TL2_F8(48),
        TL2_F8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#undef TL2_F8

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (N == 32)
    wgmma_n32<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_n64<TA, TB>(d, da, db, scale_d);
  else
    wgmma_n128<TA, TB>(d, da, db, scale_d);
}

// The k16 wgmmas kk0 .. kk0 + COUNT - 1 of one stage for warpgroup wg; the first starts
// the accumulator from zero. a_s / b_s: the stage's A and B tiles.
template <int BM, int BN, bool RHS_NK, int COUNT>
__device__ __forceinline__ void stage_mma(float (&d)[WgTile<BM, BN>::ACC], uint32_t a_s,
                                          uint32_t b_s, int wg, int kk0) {
  using T = WgTile<BM, BN>;
#pragma unroll
  for (int i = 0; i < COUNT; ++i) {
    const int kk = kk0 + i;
    if constexpr (T::SWAP) {
      // wgmma's A: this warpgroup's 64 rows of N (B_t K-major; B MN-major, one 64-column
      // box, transposed); its B: the A tile's 32 K-major rows
      const uint32_t rows = b_s + wg * 64 * ROW_BYTES;
      const uint64_t da = RHS_NK ? make_desc(rows + kk * 32, 16, 8 * ROW_BYTES, SW128)
                                 : make_desc(rows + kk * 16 * ROW_BYTES, 64 * ROW_BYTES,
                                             8 * ROW_BYTES, SW128);
      const uint64_t db = make_desc(a_s + kk * 32, 16, 8 * ROW_BYTES, SW128);
      wgmma_tile<T::WG_N, RHS_NK ? 0 : 1, 0>(d, da, db, i > 0 ? 1 : 0);
    } else {
      const uint64_t da = make_desc(a_s + wg * 64 * ROW_BYTES + kk * 32, 16, 8 * ROW_BYTES,
                                    SW128);
      uint64_t db;
      if constexpr (RHS_NK)
        db = make_desc(b_s + kk * 32, 16, 8 * ROW_BYTES, SW128);
      else if constexpr (BN == 32)  // [64 K][32 N], rows of 64 bytes
        db = make_desc(b_s + kk * 16 * 64, 64 * 64, 8 * 64, SW64);
      else
        db = make_desc(b_s + kk * 16 * ROW_BYTES, 64 * ROW_BYTES, 8 * ROW_BYTES, SW128);
      wgmma_tile<T::WG_N, 0, RHS_NK ? 0 : 1>(d, da, db, i > 0 ? 1 : 0);
    }
  }
}

// ---- the epilogue ----

__device__ __forceinline__ void store_pair(float* p, float v0, float v1, bool both, bool vec) {
  if (vec && both) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (both) p[1] = v1;
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1, bool both, bool vec) {
  if (vec && both) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (both) p[1] = __float2bfloat16(v1);
  }
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16* p, float v) { *p = __float2bfloat16(v); }

// C of batch element z (and of the CTA's split, blockIdx.y).
template <typename OutT>
__device__ __forceinline__ OutT* out_base(const WgParams& p, int z) {
  return static_cast<OutT*>(p.c) + (long long)z * p.sc + blockIdx.y * p.ssplit;
}

// Bias, activation and the cast of one consumer thread's m64 x N fragment: element
// 4j + 2h + e sits at row 16 * warp + g + 8h, column 8j + 2q + e of the warpgroup's tile.
// Stores stop at row m_lim and column n_lim: the block's edge or the problem's, the nearer.
template <typename OutT, int N>
__device__ __forceinline__ void epilogue(const WgParams& p, const float (&v)[N], int row0,
                                         int col0, int m_lim, int n_lim, int z) {
  OutT* C = out_base<OutT>(p, z);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = col0 + 8 * j;
    if (col >= n_lim) continue;
    const bool both = col + 1 < n_lim;
    float b0 = 0.0f, b1 = 0.0f;
    if (p.bias) {
      b0 = p.bias[col];
      b1 = both ? p.bias[col + 1] : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < m_lim)
        store_pair(C + (long long)row * p.n + col, act_fn(v[4 * j + 2 * h] + b0, p.act),
                   act_fn(v[4 * j + 2 * h + 1] + b1, p.act), both, p.vec_out);
    }
  }
}

// The swapped tile's epilogue: the fragment is C^T, so its rows are columns of C (the bias
// follows them) and its columns rows of C; each element is stored on its own, within
// (m_lim, n_lim) as in epilogue.
template <typename OutT, int N>
__device__ __forceinline__ void epilogue_swapped(const WgParams& p, const float (&v)[N],
                                                 int ncol0, int mrow0, int m_lim, int n_lim,
                                                 int z) {
  OutT* C = out_base<OutT>(p, z);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = ncol0 + 8 * h;
    if (col >= n_lim) continue;
    const float bias = p.bias ? p.bias[col] : 0.0f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = mrow0 + 8 * j + e;
        if (row < m_lim)
          store_one(C + (long long)row * p.n + col, act_fn(v[4 * j + 2 * h + e] + bias, p.act));
      }
    }
  }
}

// One stage's TMA boxes: A's [BM][64 K] where do_a, and B's where do_b (B_t [BN][64 K]; B
// at bn = 32 one [64 K][32 N] box, else bn / 64 boxes of [64 K][64 N]), after the arrival
// on `bar` that expects their bytes (none: a plain arrival).
template <int BM, int BN, bool RHS_NK>
__device__ __forceinline__ void tma_stage(uint32_t a_dst, const CUtensorMap* tma_a,
                                          const CUtensorMap* tma_b, uint32_t bar, bool do_a,
                                          bool do_b, int k0, int m0, int n0, int z) {
  using T = WgTile<BM, BN>;
  const uint32_t b_dst = a_dst + T::A_BYTES;
  mbar_expect_tx(bar, (do_a ? T::A_BYTES : 0) + (do_b ? T::B_BYTES : 0));
  if (do_a) tma_load(a_dst, tma_a, bar, k0, m0, z);
  if (!do_b) return;
  if (RHS_NK) {
    tma_load(b_dst, tma_b, bar, k0, n0, z);
  } else if (BN == 32) {
    tma_load(b_dst, tma_b, bar, n0, k0, z);
  } else {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load(b_dst + j * 64 * ROW_BYTES, tma_b, bar, n0 + 64 * j, k0, z);
  }
}

// ---- the kernel ----

// Add a (half) stage's product to the running sum; at a rounding point of the bf16 family,
// acc = round_bf16(acc + part) and the part starts again from zero.
template <bool ACC_BF16, int ACC, int NC>
__device__ __forceinline__ void fold(float (&sum)[ACC], const float (&st)[ACC],
                                     __nv_bfloat162 (&carry)[NC], bool round) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) sum[i] += st[i];
  if constexpr (ACC_BF16) {
    if (round) {
#pragma unroll
      for (int i = 0; i < ACC / 2; ++i) {
        const float2 a = __bfloat1622float2(carry[i]);
        carry[i] = __floats2bfloat162_rn(a.x + sum[2 * i], a.y + sum[2 * i + 1]);
        sum[2 * i] = sum[2 * i + 1] = 0.0f;
      }
    }
  }
}

// LOADS: an instance with the loads producer (one operand or both); the TMA-only instances
// carry none of its code (compiled into every instance, it made ptxas spill registers in
// the two-warpgroup tiles).
template <int BM, int BN, bool RHS_NK, bool ACC_BF16, bool LOADS>
__global__ void __launch_bounds__(WgTile<BM, BN>::THREADS, 1)
    tl2_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b, WgParams p) {
  using T = WgTile<BM, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int stages = p.stages;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + stages * T::STAGE_BYTES;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (stages + s); };

  // the CTA's block: its stride is the block's edge, which may be below the tile's
  const int tiles_m = cdiv(p.m, p.blk_m), tiles_n = cdiv(p.n, p.blk_n);
  const int tile = blockIdx.x;
  const int tm = p.raster_nm ? tile % tiles_m : tile / tiles_n;
  const int tn = p.raster_nm ? tile / tiles_m : tile % tiles_n;
  const int m0 = tm * p.blk_m, n0 = tn * p.blk_n;
  // this CTA's run of 64-deep K stages: its split's (blockIdx.y), all of K without a split
  const int first = blockIdx.y * p.split_steps;
  const int steps = min(cdiv(p.k, KSTAGE) - first, p.split_steps);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // the TMA thread's expect_tx arrival, and one from each producer thread that loads
      mbar_init(full_bar(s), 1 + (LOADS ? PRODUCER_THREADS : 0));
      mbar_init(empty_bar(s), T::CONSUMERS * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= T::CONSUMERS * 4) {
    // ---- producer warpgroup: one thread issues the TMA boxes (and arrives with their
    // byte count); where an operand is read by loads, all 128 threads load its part of the
    // stage, wait for their copies `lag` stages later, fence them into the async proxy and
    // arrive. Without loads the other threads leave.
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int t = threadIdx.x - T::CONSUMERS * 128;
    const int z = blockIdx.z;
    int s = 0;
    uint32_t phase = 0;
    if constexpr (!LOADS) {
      if (t == 0) {
        for (int it = 0; it < steps; ++it) {
          if (it >= stages) mbar_wait(empty_bar(s), phase ^ 1);  // the stage's last use is read
          tma_stage<BM, BN, RHS_NK>(ring + s * T::STAGE_BYTES, &tma_a, &tma_b, full_bar(s),
                                    true, true, (first + it) * KSTAGE, m0, n0, z);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    } else {
      const bf16* a = p.a + z * p.sa;
      const bf16* b = p.b + z * p.sb;
      const int lag = min(stages - 1, 7);  // stages whose loads are in flight
      for (int it = 0; it < steps; ++it) {
        if (it >= stages) mbar_wait(empty_bar(s), phase ^ 1);
        const uint32_t a_dst = ring + s * T::STAGE_BYTES, b_dst = a_dst + T::A_BYTES;
        const int k0 = (first + it) * KSTAGE;
        if (t == 0)  // the operand TMA can read, if any, and the arrival with its bytes
          tma_stage<BM, BN, RHS_NK>(a_dst, &tma_a, &tma_b, full_bar(s), !p.load_a, !p.load_b,
                                    k0, m0, n0, z);
        if (p.load_a) load_kmajor<BM>(a_dst, a, p.k, m0, p.m, k0, p.k, p.load_a, t);
        if (p.load_b) {
          if (RHS_NK)
            load_kmajor<BN>(b_dst, b, p.k, n0, p.n, k0, p.k, p.load_b, t);
          else
            load_mnmajor<BN>(b_dst, b, p.n, k0, p.k, n0, p.load_b, t);
        }
        cp_async_commit();
        if (it >= lag) {
          cp_async_wait(lag);
          fence_proxy_async();
          mbar_arrive(full_bar((it - lag) % stages));
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
      for (int j = max(0, steps - lag); j < steps; ++j) {
        cp_async_wait(steps - 1 - j);
        fence_proxy_async();
        mbar_arrive(full_bar(j % stages));
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma on each landed stage ----
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp / 4;
    float st[T::ACC];                             // the stage product (wgmma accumulator)
    float sum[T::ACC];                            // f32: the carry; bf16: the interval's part
    __nv_bfloat162 carry[ACC_BF16 ? T::ACC / 2 : 1];  // bf16 family: the carry, packed
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) st[i] = sum[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (ACC_BF16 ? T::ACC / 2 : 1); ++i)
      carry[i] = __floats2bfloat162_rn(0.0f, 0.0f);

    // A bk that is a multiple of 32 but not of 64 puts every other rounding point in the
    // middle of a stage: the bf16 family then runs each stage as two halves of two k16
    // wgmmas and may round after either
    const bool halves = ACC_BF16 && p.bk % KSTAGE != 0;
    int s = 0;
    uint32_t phase = 0;
    for (int it = 0; it < steps; ++it) {
      mbar_wait(full_bar(s), phase);
      const uint32_t a_s = ring + s * T::STAGE_BYTES;
      const uint32_t b_s = a_s + T::A_BYTES;
      const int k0 = (first + it) * KSTAGE;
      const bool last = it + 1 == steps;
      if (!halves) {
        fence_regs(st);
        wgmma_fence();
        stage_mma<BM, BN, RHS_NK, 4>(st, a_s, b_s, wg, 0);  // a fresh sum every stage
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        if (lane == 0) mbar_arrive(empty_bar(s));  // this warp is done reading the stage
        fold<ACC_BF16>(sum, st, carry, ACC_BF16 && ((k0 + KSTAGE) % p.bk == 0 || last));
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          fence_regs(st);
          wgmma_fence();
          stage_mma<BM, BN, RHS_NK, 2>(st, a_s, b_s, wg, 2 * h);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(st);
          if (h == 1 && lane == 0) mbar_arrive(empty_bar(s));
          fold<ACC_BF16>(sum, st, carry,
                         ACC_BF16 && ((k0 + 32 * (h + 1)) % p.bk == 0 || (last && h == 1)));
        }
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }

    if constexpr (ACC_BF16) {
#pragma unroll
      for (int i = 0; i < T::ACC / 2; ++i) {
        const float2 a = __bfloat1622float2(carry[i]);
        sum[2 * i] = a.x;
        sum[2 * i + 1] = a.y;
      }
    }
    const int frag_row = wg * 64 + (warp % 4) * 16 + (lane >> 2);  // row of wgmma's M
    // nothing beyond the block's edge or the problem's is stored
    const int m_lim = min(p.m, m0 + p.blk_m), n_lim = min(p.n, n0 + p.blk_n);
    const int z = blockIdx.z;
    if constexpr (T::SWAP) {
      if (p.out_f32)
        epilogue_swapped<float>(p, sum, n0 + frag_row, m0 + 2 * (lane & 3), m_lim, n_lim, z);
      else
        epilogue_swapped<bf16>(p, sum, n0 + frag_row, m0 + 2 * (lane & 3), m_lim, n_lim, z);
    } else if (BM >= 64 || warp % 4 < 2) {  // at bm = 32, warps 2 and 3 hold rows 32..63
      if (p.out_f32)
        epilogue<float>(p, sum, m0 + frag_row, n0 + 2 * (lane & 3), m_lim, n_lim, z);
      else
        epilogue<bf16>(p, sum, m0 + frag_row, n0 + 2 * (lane & 3), m_lim, n_lim, z);
    }
  }
}

// ---- host side: one instance per (tile, layout, family) ----

template <int BM, int BN, bool RHS_NK, bool ACC_BF16, bool LOADS>
cudaError_t launch_tile(const CUtensorMap& ta, const CUtensorMap& tb, const WgParams& p,
                        int splits, int batch, cudaStream_t stream) {
  using T = WgTile<BM, BN>;
  const auto kernel = tl2_wgmma_kernel<BM, BN, RHS_NK, ACC_BF16, LOADS>;
  static int regs_checked = 0;  // per instance: the registers fit
  static int attr_bytes = 0;    // per instance: the dynamic shared memory the attribute allows
  const int smem = smem_bytes(BM, BN, p.stages);
  if (smem > attr_bytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_bytes = smem;
  }
  if (!regs_checked) {
    if (T::CONSUMERS == 2) {
      // setmaxnreg.inc blocks until the registers are free: refuse a build whose
      // allocation at launch cannot cover the rebalanced counts, rather than hang
      cudaFuncAttributes attr;
      const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e != cudaSuccess) return e;
      const int per_warp = (attr.numRegs + 7) / 8 * 8;
      const int want = T::CONSUMERS * 4 * CONSUMER_REGS + 4 * PRODUCER_REGS;
      if (want > (T::CONSUMERS + 1) * 4 * per_warp) return cudaErrorInvalidConfiguration;
    }
    regs_checked = 1;
  }
  const dim3 grid(cdiv(p.m, p.blk_m) * cdiv(p.n, p.blk_n), splits, batch);
  kernel<<<grid, T::THREADS, smem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

template <int BM, int BN, bool LOADS>
cudaError_t launch_variant(const CUtensorMap& ta, const CUtensorMap& tb, const WgParams& p,
                           int splits, int batch, int rhs_nk, int acc_bf16, cudaStream_t s) {
  if (rhs_nk)
    return acc_bf16 ? launch_tile<BM, BN, true, true, LOADS>(ta, tb, p, splits, batch, s)
                    : launch_tile<BM, BN, true, false, LOADS>(ta, tb, p, splits, batch, s);
  return acc_bf16 ? launch_tile<BM, BN, false, true, LOADS>(ta, tb, p, splits, batch, s)
                  : launch_tile<BM, BN, false, false, LOADS>(ta, tb, p, splits, batch, s);
}

// Each instance file's launcher: its tiles (with the loads producer where p.load_a or
// p.load_b says so), cudaErrorInvalidValue for any other.
#define TL2_WGMMA_LAUNCHER(NAME)                                                         \
  cudaError_t NAME(int bm, int bn, const CUtensorMap& ta, const CUtensorMap& tb,         \
                   const WgParams& p, int splits, int batch, int rhs_nk, int acc_bf16,   \
                   cudaStream_t s)
TL2_WGMMA_LAUNCHER(launch_wide);      // tl2_wgmma.cu: 64/128 tiles, TMA
TL2_WGMMA_LAUNCHER(launch_wide_lsu);  // tl2_wgmma_lsu.cu: 64/128 tiles, loads producer
TL2_WGMMA_LAUNCHER(launch_n32);       // tl2_wgmma_n32.cu: bn = 32, both producers
TL2_WGMMA_LAUNCHER(launch_swap);      // tl2_wgmma_swap.cu: bm = 32 over 64/128, both
// tl2_wgmma_wide.cu: a wide block (p.blk_m x p.blk_n over p.batch problems; tc the
// output's map where p.tma_c), its work items spread over `ctas` persistent CTAs (1 up to
// the items of wide_walk). acc_bf16: the bf16 family's K carry (gk > 1). Dispatches to the
// instance file of the family, the producer and A's mode (p.wide_stream), or of the swapped
// walk (bm <= 32): cudaErrorInvalidValue for a block it has no instance of.
cudaError_t launch_wide_block(const CUtensorMap& ta, const CUtensorMap& tb,
                              const CUtensorMap& tc, const WgParams& p, int ctas, int rhs_nk,
                              int acc_bf16, cudaStream_t s);
// Each wide instance file's launcher (tl2_wgmma_wide.cuh's TL2_WIDE_INSTANCES): the file
// tl2_wgmma_wide{_bf16}{_lsu}{_stream}.cu of NAME's parts (tma: TMA; lsu: the loads
// producer and predicated stores; bf16: the bf16 carry; stream: a streamed A).
#define TL2_WIDE_LAUNCHER(NAME)                                                          \
  cudaError_t NAME(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,  \
                   const WgParams& p, int ctas, int rhs_nk, cudaStream_t s)
TL2_WIDE_LAUNCHER(wide_tma);
TL2_WIDE_LAUNCHER(wide_tma_stream);
TL2_WIDE_LAUNCHER(wide_tma_bf16);
TL2_WIDE_LAUNCHER(wide_tma_bf16_stream);
TL2_WIDE_LAUNCHER(wide_lsu);
TL2_WIDE_LAUNCHER(wide_lsu_stream);
TL2_WIDE_LAUNCHER(wide_lsu_bf16);
TL2_WIDE_LAUNCHER(wide_lsu_bf16_stream);
TL2_WIDE_LAUNCHER(wide_swap);       // tl2_wgmma_wide_swap.cu: bm <= 32, the f32 sum
TL2_WIDE_LAUNCHER(wide_swap_bf16);  // tl2_wgmma_wide_swap_bf16.cu: bm <= 32, the bf16 carry

}  // namespace tl2wg

// One tile's instances with the TMA producer (LOADS_ false) or the loads producer (true).
#define TL2_WGMMA_TILE(BM_, BN_, LOADS_)                                                   \
  if (bm == BM_ && bn == BN_)                                                              \
    return launch_variant<BM_, BN_, LOADS_>(ta, tb, p, splits, batch, rhs_nk, acc_bf16, s);
