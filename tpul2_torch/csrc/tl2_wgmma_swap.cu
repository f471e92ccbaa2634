// tl2_wgmma_swap.cu — the ring kernel's instances with bm = 32 over bn 64 and 128: the
// swapped orientation (C_tile^T = B_tile^T A_tile^T), the tile's N rows as wgmma's M and A's
// 32 rows as its width. The kernel and its design: tl2_wgmma.cuh, tl2_wgmma.cu.

#include "tl2_wgmma.cuh"

namespace tl2wg {

TL2_WGMMA_LAUNCHER(launch_swap) {
  if (p.load_a || p.load_b) {
    TL2_WGMMA_TILE(32, 64, true) TL2_WGMMA_TILE(32, 128, true)
  } else {
    TL2_WGMMA_TILE(32, 64, false) TL2_WGMMA_TILE(32, 128, false)
  }
  return cudaErrorInvalidValue;
}

}  // namespace tl2wg
