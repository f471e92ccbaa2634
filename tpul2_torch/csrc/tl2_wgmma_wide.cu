// tl2_wgmma_wide.cu — the ring's wide route: one CTA per wide block (an edge above 128, up to
// 16384 x 32768, any edge in between), for every wide block of the JAX space. The host API
// that reaches it (tl2_wgmma_bf16out / _f32out, routes 3 'wgmma_wide' and 4 'wgmma_wide_lsu') is in
// tl2_wgmma.cu; the kernel is tl2_wgmma_wide.cuh; the TMA, mbarrier and wgmma pieces are
// tl2_wgmma.cuh's; the shared-memory model is tl2_wgmma_model.cuh's. This file holds the
// TMA instances of the f32 sum with a resident A and the dispatch to the eight instance
// files.
//
// Replaces the Pallas TPU kernels, at the JAX space's wide blocks (tpul2/config.py:422-447:
// bn up to 16384 or the whole N up to 32768, bm its sublane 16 up to 2048 or the whole M,
// "thin-K giants are output-write bound and want the longest contiguous row-major C
// stripes"), with bk any of its K intervals:
//   tpul2/ops/matmul.py::_kernel_multi_k       (gk > 1, call :220)
//   tpul2/ops/matmul.py::_kernel_single_k      (gk == 1)
//   tpul2/ops/batched.py::_bmm_kernel          (batched, gk > 1; blockIdx.z, call :120)
//   tpul2/ops/batched.py::_bmm_kernel_single_k (batched, gk == 1)
//   tpul2/ops/pipelined.py::_kernel            (a staged wide block: tl2_wgmma_staged)
// What it computes, per bm x bn block of each batch element: each sub-tile's product summed
// in f32 over 64-deep stages; with gk > 1 the bf16 family rounds the running sum to bf16 at
// the end of every bk interval, the last one included (so before the bias), as the ring
// does, and the f32 family does not round; with gk == 1 neither family rounds (the f32-sum
// instance runs). Then + bias (f32), the activation, the cast to bf16 or f32; B in 'kn'
// (K, N) or 'nk' (N, K). A bk with bk % 64 == 32 (a rounding point mid-stage) runs each
// stage as two halves in the bf16 family, as the ring does; the JAX space's wide bks are
// multiples of 128 or the whole K, whose rounding points fall on stage boundaries.
//
// A staged wide block (pipeline_depth >= 2, tl2_wgmma.cu's staged()) runs the f32-sum
// instances with a streamed A, `depth` ring stages (up to MAX_STAGES where shared memory
// allows) and bk = K: one f32 sum over all of K, one cast, as pipelined.py::_kernel's DMA ring
// of both operands does; no split K.
//
// What bounds it on the H100: at thin K the output. At 16384 x 16384 x 64 the product writes
// 537 MB of bf16 C against 4 MB of operands and 34 GFLOP: 0.160 ms at 3.35 TB/s against
// 0.035 ms at 989 TFLOP/s. So the design keeps C's stores streaming while the CTA computes:
//   - one CTA per block (grid cdiv(M, bm) x cdiv(N, bn) x batch, raster by grid_order); it
//     walks the block strip by strip (SM = 64 rows at bm <= 64, else 128; a 16384-row block
//     is 128 strips) and, in each strip, sub-tile by sub-tile of 128 columns, each sub-tile
//     over all of K. An edge off that grid (a cover of an unaligned M or N such as 1000, bn
//     below 128 beside a wide bm, bm 33..127) ends the block inside its last strip or
//     sub-tile: the CTA still computes the whole sub-tile, whose rows and columns beyond the
//     block's edge read the next block's rows and columns (or zeros past the problem), and
//     stores nothing beyond the edge. Such a block's C goes out by predicated stores unless
//     the edge is also the problem's (wide_c_grid), since TMA stores clip only there;
//   - bm <= 32 (the JAX space's sublane 16, its covers of M < 16, and 32 beside a wide bn)
//     walks swapped, as the ring's swapped tile does: each 128-column sub-tile is computed as
//     C_sub^T = B_sub^T A^T, the 128 columns wgmma's M (a consumer warpgroup of m64n32k16
//     wgmmas per 64) and the block's rows its width of 32, rows beyond bm never stored; A
//     (32 rows x 64 K, 4 KB a stage) always streams beside B, and C goes out by the swapped
//     epilogue's predicated stores (tl2_wgmma_wide_swap{,_bf16}.cu, the loads producer
//     compiled in);
//   - A is held in one of two modes, chosen from K at the launch (wide_streamed):
//     resident: the strip's A (SM x K, cdiv(K, 64) boxes) is loaded once and stays while the
//       strip's sub-tiles are walked; it is reloaded per strip, as soon as the strip's last
//       wgmma has read it (the a_empty barrier), so the load overlaps that sub-tile's
//       epilogue. It fits beside two ring stages up to K = 512 at 128-row strips and
//       K = 1280 at 64-row ones;
//     streamed, everywhere else: each ring stage carries the strip's 64-deep A box beside
//       B's ((SM + 128) x 128 bytes: 32 KB at SM = 128, 24 KB at SM = 64; four stages and
//       the C staging fit in 227 KB); A is then read once per sub-tile, from L2;
//   - B (128 columns x 64 K per stage) streams through an mbarrier ring of wide_stages
//     stages; the producer runs ahead across sub-tiles and strips, so the next sub-tile's
//     operands are in flight during this one's epilogue;
//   - each consumer warpgroup (64 rows, m64n128k16 wgmmas, a fresh accumulator per 64-deep
//     stage added into an f32 total, as the ring does; the bf16 family's carry packed two to
//     a register) applies the bias and activation, writes its 64 x 128 sub-tile into a
//     shared-memory staging buffer in the 128-byte swizzle of the TMA box (boxes of 64 rows x
//     128 bytes: 64 bf16 or 32 f32 columns) and sends it out by TMA stores
//     (cp.async.bulk.tensor, one bulk group per sub-tile); before a buffer is written again
//     its group must have been read (wait_group.read). bf16 output has two buffers, so a
//     sub-tile's stores overlap the next sub-tile's wgmmas and staging; f32 output, twice
//     the bytes, has one. The output's rank-3 map carries the true M, N and batch, so the
//     stores clip at the edges;
//   - where TMA cannot read an operand (a base off 16 bytes, K % 8, or N % 8 for 'kn' B),
//     the loads producer fills the same swizzled stages and strip (the ring's load_kmajor /
//     load_mnmajor: cp.async or the gather, zeros past M, N and K, fence.proxy.async before
//     each arrival, arrivals lagging the copies by up to stages - 1 stages and all made
//     before the producer waits for a strip's release); where TMA cannot write C (N % 8, or
//     an output off 16 bytes) C goes out by the ring's predicated stores. These are the
//     LOADS instances (route 4), built apart so that the TMA-only ones carry none of it.
// Shared memory (wide_smem_bytes): the ring (B, or B and A), the resident strip if any,
// WIDE_C_BYTES of staging per consumer warpgroup, the barriers.
// Instances: sub-tile height (64, 128) x layout x output dtype in each of eight files, the
// family of the carry x the producer x A's mode (tl2_wgmma_wide{,_bf16}{,_lsu}{,_stream}.cu),
// and the swapped walk's layout x output dtype in two more, one per family
// (tl2_wgmma_wide_swap{,_bf16}.cu), which nvcc builds side by side. A's mode is a template
// argument: chosen at run time, it cost the resident walk 2.5-9% at thin K on the H100
// (PERF.md, the wide blocks' findings).
// Left for later: a persistent schedule over blocks (a 16384-row block is one CTA on the 132
// SMs), splitting a large block over CTAs, 256-column sub-tiles, overlapping one stage's adds
// with the next stage's wgmmas, m64n16 / m64n8 instances of the swapped walk for bm <= 16
// (it runs at width 32), and a split K for staged wide blocks.

#include "tl2_wgmma_wide.cuh"

TL2_WIDE_INSTANCES(wide_tma, false, false, false)

namespace tl2wg {

cudaError_t launch_wide_block(const CUtensorMap& ta, const CUtensorMap& tb,
                              const CUtensorMap& tc, const WgParams& p, int batch, int rhs_nk,
                              int acc_bf16, cudaStream_t s) {
  if (!wide_block_ok(p.blk_m, p.blk_n) || p.stages < WIDE_MIN_STAGES ||
      p.stages > MAX_STAGES || batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  if (wide_swapped(p.blk_m))
    return (acc_bf16 ? wide_swap_bf16 : wide_swap)(ta, tb, tc, p, batch, rhs_nk, s);
  typedef TL2_WIDE_LAUNCHER((*Launcher));
  // [the loads producer or predicated stores][the bf16 carry][a streamed A]
  static const Launcher launchers[2][2][2] = {
      {{wide_tma, wide_tma_stream}, {wide_tma_bf16, wide_tma_bf16_stream}},
      {{wide_lsu, wide_lsu_stream}, {wide_lsu_bf16, wide_lsu_bf16_stream}}};
  const bool loads = p.load_a || p.load_b || !p.tma_c;
  return launchers[loads][acc_bf16 != 0][p.wide_stream != 0](ta, tb, tc, p, batch, rhs_nk, s);
}

}  // namespace tl2wg
