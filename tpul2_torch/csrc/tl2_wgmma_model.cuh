// tl2_wgmma_model.cuh — the ring's shared-memory constants and the wide route's model of its
// blocks, shared memory and ring depth (config.py mirrors each). Plain C++ with no CUDA
// header, so that a host compiler builds it too: tests/test_torch_wide_carry.py compiles it
// with g++ and holds config.py's model to it on a machine with no card. tl2_wgmma.cuh
// includes it.

#pragma once

#ifdef __CUDACC__
#define TL2_HD __host__ __device__
#else
#define TL2_HD
#endif

namespace tl2wg {

constexpr int KSTAGE = 64;              // K depth of one ring stage: one 128-byte bf16 row
constexpr int ROW_BYTES = KSTAGE * 2;   // the 128-byte swizzle span
// Shared memory one block may use on the H100 (227 KB)
constexpr int SMEM_LIMIT = 232448;

// The wide blocks (tl2_wgmma_wide.cu; config.py mirrors each): bm 64, 128 or a multiple of
// WIDE_SUB_N up to WIDE_BM_MAX, bn a multiple of WIDE_SUB_N up to WIDE_BN_MAX, an edge above
// 128. A CTA walks its block in sub-tiles of wide_sub_m rows x WIDE_SUB_N columns; its ring
// is WIDE_STAGES deep where shared memory allows, WIDE_MIN_STAGES at least; each consumer
// warpgroup stages C in WIDE_C_BYTES (64 rows x 128 columns of f32).
constexpr int WIDE_SUB_N = 128;
constexpr int WIDE_BM_MAX = 16384;
constexpr int WIDE_BN_MAX = 16384;
constexpr int WIDE_STAGES = 4;
constexpr int WIDE_MIN_STAGES = 2;
constexpr int WIDE_C_BYTES = 64 * WIDE_SUB_N * 4;

TL2_HD constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A block the wide route takes (config.is_wide and KernelConfig._check_wide).
inline bool wide_block(int bm, int bn) { return bm > 128 || bn > 128; }
inline bool wide_block_ok(int bm, int bn) {
  return wide_block(bm, bn) &&
         (bm == 64 || bm == 128 || (bm % WIDE_SUB_N == 0 && bm <= WIDE_BM_MAX)) &&
         bn % WIDE_SUB_N == 0 && bn <= WIDE_BN_MAX;
}

// Rows of a wide block's sub-tile and A strip (config.wide_sub_m).
inline int wide_sub_m(int bm) { return bm == 64 ? 64 : 128; }

// Shared memory of a wide CTA at depth K (config.wide_smem_bytes): the alignment slack,
// `stages` ring stages (a B box of WIDE_SUB_N rows, and with a streamed A the strip's A box
// beside it), the resident A strip (cdiv(K, 64) boxes; none when A streams), the C staging of
// each consumer warpgroup, a full and an empty mbarrier per stage and for the strip.
inline int wide_smem_bytes(int bm, int k, int stages, bool streamed) {
  const int sm = wide_sub_m(bm);
  const int stage = (WIDE_SUB_N + (streamed ? sm : 0)) * ROW_BYTES;
  const int strip = streamed ? 0 : cdiv(k, KSTAGE) * sm * ROW_BYTES;
  return 1024 + stages * stage + strip + sm / 64 * WIDE_C_BYTES + (2 * stages + 2) * 8;
}

// The ring depth that fits beside the rest in SMEM_LIMIT, at most WIDE_STAGES (0 where none).
inline int wide_fit(int bm, int k, bool streamed) {
  const int free = SMEM_LIMIT - wide_smem_bytes(bm, k, 0, streamed);
  const int stage = (WIDE_SUB_N + (streamed ? wide_sub_m(bm) : 0)) * ROW_BYTES + 16;
  const int fit = free < 0 ? 0 : free / stage;
  return fit < WIDE_STAGES ? fit : WIDE_STAGES;
}

// A streams through the ring where the resident strip of all of K leaves fewer than
// WIDE_MIN_STAGES stages (K > 512 at 128-row strips, K > 1280 at 64-row ones;
// config.wide_streamed).
inline bool wide_streamed(int bm, int k) { return wide_fit(bm, k, false) < WIDE_MIN_STAGES; }

// The ring's depth at depth K in the mode K takes (config.wide_stages).
inline int wide_stages(int bm, int k) { return wide_fit(bm, k, wide_streamed(bm, k)); }

}  // namespace tl2wg
