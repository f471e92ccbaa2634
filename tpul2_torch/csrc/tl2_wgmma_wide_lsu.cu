// tl2_wgmma_wide_lsu.cu — the wide route's instances with the loads producer and predicated
// stores (route 4), the f32 sum, A resident. The kernel is tl2_wgmma_wide.cuh, its design in
// tl2_wgmma_wide.cu's header.

#include "tl2_wgmma_wide.cuh"

TL2_WIDE_INSTANCES(wide_lsu, false, true, false)
