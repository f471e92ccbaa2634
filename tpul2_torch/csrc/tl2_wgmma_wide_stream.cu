// tl2_wgmma_wide_stream.cu — the wide route's instances with the TMA producer and the f32 sum, A
// streamed. The kernel is tl2_wgmma_wide.cuh, its design in tl2_wgmma_wide.cu's header.

#include "tl2_wgmma_wide.cuh"

TL2_WIDE_INSTANCES(wide_tma_stream, false, false, true)
