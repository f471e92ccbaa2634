// tl2_wgmma_wide_swap.cu — the wide route's swapped walk (bm <= 32 beside a wide bn), the f32
// sum: each 128-column sub-tile computed as C_sub^T = B_sub^T A^T, A streamed, the loads
// producer compiled in, predicated stores. The kernel is tl2_wgmma_wide.cuh, its design in
// tl2_wgmma_wide.cu's header.

#include "tl2_wgmma_wide.cuh"

TL2_WIDE_SWAP_INSTANCES(wide_swap, false)
