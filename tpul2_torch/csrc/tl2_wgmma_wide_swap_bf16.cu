// tl2_wgmma_wide_swap_bf16.cu — the wide route's swapped walk (bm <= 32 beside a wide bn), the
// bf16 family's K carry. The kernel is tl2_wgmma_wide.cuh, its design in tl2_wgmma_wide.cu's
// header.

#include "tl2_wgmma_wide.cuh"

TL2_WIDE_SWAP_INSTANCES(wide_swap_bf16, true)
