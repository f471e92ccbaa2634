// tl2_wgmma_n32.cu — the ring kernel's instances with bn = 32 (bm 32, 64, 128): m64n32k16
// wgmmas, B_t read K-major, B ('kn') as one [64 K][32 N] box with the 64-byte swizzle.
// The kernel and its design: tl2_wgmma.cuh, tl2_wgmma.cu.

#include "tl2_wgmma.cuh"

namespace tl2wg {

TL2_WGMMA_LAUNCHER(launch_n32) {
  if (p.load_a || p.load_b) {
    TL2_WGMMA_TILE(32, 32, true) TL2_WGMMA_TILE(64, 32, true) TL2_WGMMA_TILE(128, 32, true)
  } else {
    TL2_WGMMA_TILE(32, 32, false) TL2_WGMMA_TILE(64, 32, false) TL2_WGMMA_TILE(128, 32, false)
  }
  return cudaErrorInvalidValue;
}

}  // namespace tl2wg
