// tl2_wgmma_lsu.cu — the ring kernel's instances of the 64/128 tiles with the loads producer
// (an operand TMA cannot read: a base off 16 bytes, or rows of a length that is not a
// multiple of 8). The kernel and its design: tl2_wgmma.cuh, tl2_wgmma.cu.

#include "tl2_wgmma.cuh"

namespace tl2wg {

TL2_WGMMA_LAUNCHER(launch_wide_lsu) {
  TL2_WGMMA_TILE(64, 64, true) TL2_WGMMA_TILE(64, 128, true)
  TL2_WGMMA_TILE(128, 64, true) TL2_WGMMA_TILE(128, 128, true)
  return cudaErrorInvalidValue;
}

}  // namespace tl2wg
