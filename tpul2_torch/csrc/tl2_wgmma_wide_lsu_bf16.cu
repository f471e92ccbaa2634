// tl2_wgmma_wide_lsu_bf16.cu — the wide route's instances with the loads producer and predicated
// stores (route 4), the bf16 family's K carry, A resident. The kernel is tl2_wgmma_wide.cuh, its
// design in tl2_wgmma_wide.cu's header.

#include "tl2_wgmma_wide.cuh"

TL2_WIDE_INSTANCES(wide_lsu_bf16, true, true, false)
