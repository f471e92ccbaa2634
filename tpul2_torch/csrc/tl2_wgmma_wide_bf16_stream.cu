// tl2_wgmma_wide_bf16_stream.cu — the wide route's instances with the TMA producer and the bf16
// family's K carry, A streamed. The kernel is tl2_wgmma_wide.cuh, its design in
// tl2_wgmma_wide.cu's header.

#include "tl2_wgmma_wide.cuh"

TL2_WIDE_INSTANCES(wide_tma_bf16_stream, true, false, true)
