// tl2_wgmma_wide.cuh — the wide route's kernel, tl2_wgmma_wide_kernel, and its launcher: what it
// computes and the design are in tl2_wgmma_wide.cu's header. The kernel is persistent: a
// launch of G CTAs deals the launch's work items (every 128-column sub-tile of every strip of
// every block of every batch element, wide_walk in tl2_wgmma_model.cuh) out to its CTAs in
// contiguous runs, each walked one strip at a time (for_each_strip), a resident A loaded once
// per strip of the run; G is an argument of the launch (the rule's, one CTA an SM, on every
// dispatch).
// Included by the eight instance files of the plain walk (TL2_WIDE_INSTANCES), one per
// (family of the K carry, producer, A's mode): tl2_wgmma_wide{,_bf16}{,_lsu}{,_stream}.cu
// (TMA or the loads producer and predicated stores; the f32 sum or the bf16 carry; A
// resident or streamed); and by the two of the swapped walk (TL2_WIDE_SWAP_INSTANCES,
// bm <= 32): tl2_wgmma_wide_swap{,_bf16}.cu. nvcc builds them side by side.

#pragma once

#include "tl2_wgmma.cuh"

namespace tl2wg {
namespace {

constexpr int BOX_BYTES = 64 * ROW_BYTES;  // one staging box: 64 rows of 128 bytes

// SM: the sub-tile's rows, 64 or 128; or WIDE_SWAP_M, the swapped walk (SWAP), whose
// sub-tile is the block's <= 32 rows x 128 columns computed transposed: the 128 columns are
// wgmma's M (a consumer warpgroup per 64) and the 32 rows its width (WgTile<32, 128>).
template <int SM, bool OUT_F32>
struct WideTile {
  static constexpr bool SWAP = SM == WIDE_SWAP_M;
  static constexpr int CONSUMERS = (SWAP ? WIDE_SUB_N : SM) / 64;
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int ACC = WgTile<SM, WIDE_SUB_N>::ACC;  // f32 registers of the fragment
  static constexpr int A_BOX = SM * ROW_BYTES;           // one 64-deep box of the A strip
  static constexpr int B_BYTES = WIDE_SUB_N * ROW_BYTES;  // one B box
  static constexpr int BOX_COLS = ROW_BYTES / (OUT_F32 ? 4 : 2);  // C columns per box
  static constexpr int BOXES = WIDE_SUB_N / BOX_COLS;     // boxes of a warpgroup's sub-tile
  static constexpr int NBUF = OUT_F32 ? 1 : 2;            // staging buffers per warpgroup
  // the C staging (none in the swapped walk: its stores are predicated)
  static constexpr int C_BYTES = SWAP ? 0 : CONSUMERS * WIDE_C_BYTES;
  static_assert(NBUF * BOXES * BOX_BYTES == WIDE_C_BYTES, "staging fills WIDE_C_BYTES");
};

// Bias, activation and the cast of one consumer thread's m64 x 128 fragment into the
// warpgroup's staging buffer `buf`: element 4j + 2h + e at row 16 * warp4 + lane / 4 + 8h,
// column 8j + 2q + e (q = lane % 4); box (column / BOX_COLS), 128-byte swizzle (the 16-byte
// unit u of row r at u ^ (r % 8)). n0: the sub-tile's first column of C.
template <bool OUT_F32, int ACT>
__device__ __forceinline__ void stage_c_act(uint32_t buf, const float (&v)[64],
                                            const WgParams& p, int n0, int warp4, int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * q;
    float b0 = 0.0f, b1 = 0.0f;
    if (p.bias != nullptr && col < p.n) {  // N is even, so col + 1 < N too
      b0 = p.bias[col];
      b1 = p.bias[col + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp4 + (lane >> 2) + 8 * h;
      const float x0 = act_apply<ACT>(v[4 * j + 2 * h] + b0);
      const float x1 = act_apply<ACT>(v[4 * j + 2 * h + 1] + b1);
      if constexpr (OUT_F32) {
        const int unit = 2 * (j & 3) + (q >> 1);
        const uint32_t dst =
            buf + (j >> 2) * BOX_BYTES + r * ROW_BYTES + ((unit ^ (r & 7)) << 4) + 8 * (q & 1);
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(dst), "f"(x0), "f"(x1)
                     : "memory");
      } else {
        const uint32_t dst =
            buf + (j >> 3) * BOX_BYTES + r * ROW_BYTES + (((j & 7) ^ (r & 7)) << 4) + 4 * q;
        const __nv_bfloat162 pair = __floats2bfloat162_rn(x0, x1);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                     "r"(*reinterpret_cast<const uint32_t*>(&pair))
                     : "memory");
      }
    }
  }
}

// One sub-tile's B box by TMA: B_t [128 N][64 K], or B two boxes of [64 K][64 N].
template <bool RHS_NK>
__device__ __forceinline__ void tma_b_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int k0, int n0, int z) {
  if (RHS_NK) {
    tma_load(dst, map, bar, k0, n0, z);
  } else {
#pragma unroll
    for (int j = 0; j < WIDE_SUB_N / 64; ++j)
      tma_load(dst + j * 64 * ROW_BYTES, map, bar, n0 + 64 * j, k0, z);
  }
}

// The CTA's work items, its run [wide_first(c), wide_first(c + 1)) in order, one strip at a
// time: f(w, end) for each strip segment of the run with a non-empty item (wide_segment),
// where w is the segment's first item and its columns w.col .. end - 1 are the items to
// compute. Producer and consumers walk the same segments, so the barriers' phases stay in
// step; config.wide_strips mirrors them. A resident A is loaded once per segment.
template <typename F>
__device__ __forceinline__ void for_each_strip(const WideWalk& walk, F&& f) {
  const long long last = wide_first(walk.items, gridDim.x, blockIdx.x + 1);
  WideItem w;
  int end;
  for (long long i = wide_first(walk.items, gridDim.x, blockIdx.x); i < last;) {
    i = wide_segment(walk, i, last, w, end);
    if (w.col < end) f(w, end);
  }
}

// SM: rows of a sub-tile (wide_sub_m: 32, the swapped walk, at bm <= 32; 64 at bm <= 64;
// else 128); ACC_BF16: the bf16 family's K carry
// (rounded at the end of every bk interval); LOADS: an instance with the loads producer and
// predicated stores (chosen per operand and for C at run time), which the TMA-only instances
// carry none of; STREAM: A streams through the ring beside B, else the strip stays resident
// (a run-time choice cost the resident walk 2.5-9% at thin K on the H100).
// The schedule: the launch's work items (wide_walk: every sub-tile of every block of every
// batch element) are dealt out to the gridDim.x CTAs in runs (for_each_strip). Each item is
// a whole sub-tile over all of K, so its bits do not depend on the CTA count.
template <int SM, bool RHS_NK, bool OUT_F32, bool ACC_BF16, bool LOADS, bool STREAM>
__global__ void __launch_bounds__(WideTile<SM, OUT_F32>::THREADS, 1)
    tl2_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tma_a,
                          const __grid_constant__ CUtensorMap tma_b,
                          const __grid_constant__ CUtensorMap tma_c, WgParams p) {
  using T = WideTile<SM, OUT_F32>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int stages = p.stages;
  constexpr bool streamed = STREAM;
  const int ksteps = cdiv(p.k, KSTAGE);
  // a stage: the B box, then (A streamed) the strip's A box of the same 64 K
  const int stage_bytes = T::B_BYTES + (streamed ? T::A_BOX : 0);
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_strip = ring + stages * stage_bytes;  // the resident strip
  const uint32_t c_stage = a_strip + (streamed ? 0 : ksteps * T::A_BOX);
  const uint32_t bars = c_stage + T::C_BYTES;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (stages + s); };
  const uint32_t a_full = bars + 16 * stages, a_empty = a_full + 8;

  // the launch's work items; a block's last strip or column may reach past the block's edge
  // (an edge off the sub-tile grid: a cover of an unaligned dimension, bn < 128, bm < the
  // sub-tile's rows), where it reads the next block's rows or columns and stores nothing
  const WideWalk walk = wide_walk(p.m, p.n, p.blk_m, p.blk_n, p.batch, p.raster_nm);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    // the TMA thread's expect_tx arrival, and one from each producer thread that loads
    const int producers = 1 + (LOADS ? PRODUCER_THREADS : 0);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar(s), producers);
      mbar_init(empty_bar(s), T::CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init(a_full, producers);
    mbar_init(a_empty, T::CONSUMERS * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= T::CONSUMERS * 4) {
    // ---- producer warpgroup: one thread issues every TMA load (and arrives with their
    // bytes); where an operand is read by loads, all 128 threads load their part of each
    // stage (and of the strip) and arrive once their copies are visible ----
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int t = threadIdx.x - T::CONSUMERS * 128;
    if (!LOADS && t != 0) return;
    const bool a_by_tma = !LOADS || !p.load_a, b_by_tma = !LOADS || !p.load_b;
    // the loads producer's arrivals lag its copies by up to `lag` stages; `owed` stages
    // (the newest issued) still wait for theirs
    const int lag = min(stages - 1, 7);
    int s = 0, it = 0, owed = 0;
    uint32_t phase = 0;
    auto settle = [&]() {  // every owed stage's copies done, visible, and arrived
      cp_async_wait(0);
      fence_proxy_async();
      for (; owed > 0; --owed) mbar_arrive(full_bar((it - owed) % stages));
    };
    int loads = 0;  // strips (segments) walked so far
    for_each_strip(walk, [&](const WideItem& w, int end) {
      const int z = w.z, m0 = w.m_blk + w.strip * SM;
      const bf16* a = p.a + z * p.sa;
      const bf16* b = p.b + z * p.sb;
      if (!streamed) {
        // the strip's A, once the last strip's last wgmma has read the buffer (which needs
        // every stage issued so far)
        if (loads > 0) {
          if (LOADS) settle();
          mbar_wait(a_empty, (loads - 1) & 1);
        }
        if (t == 0) {
          mbar_expect_tx(a_full, a_by_tma ? ksteps * T::A_BOX : 0);
          if (a_by_tma)
            for (int ks = 0; ks < ksteps; ++ks)
              tma_load(a_strip + ks * T::A_BOX, &tma_a, a_full, ks * KSTAGE, m0, z);
        }
        if constexpr (LOADS) {
          if (!a_by_tma) {
            for (int ks = 0; ks < ksteps; ++ks)
              load_kmajor<SM>(a_strip + ks * T::A_BOX, a, p.k, m0, p.m, ks * KSTAGE, p.k,
                              p.load_a, t);
            cp_async_commit();
            cp_async_wait(0);
            fence_proxy_async();
          }
          mbar_arrive(a_full);
        }
      }
      ++loads;
      for (int col = w.col; col < end; ++col) {
        const int n0 = w.n_blk + col * WIDE_SUB_N;
        for (int ks = 0; ks < ksteps; ++ks) {
          if (it >= stages) mbar_wait(empty_bar(s), phase ^ 1);  // the stage's last use is read
          const uint32_t dst = ring + s * stage_bytes;
          const int k0 = ks * KSTAGE;
          const bool a_here = streamed && a_by_tma;  // this stage's A box by TMA
          if (t == 0) {
            mbar_expect_tx(full_bar(s), (b_by_tma ? T::B_BYTES : 0) + (a_here ? T::A_BOX : 0));
            if (b_by_tma) tma_b_box<RHS_NK>(dst, &tma_b, full_bar(s), k0, n0, z);
            if (a_here) tma_load(dst + T::B_BYTES, &tma_a, full_bar(s), k0, m0, z);
          }
          ++it;
          if constexpr (LOADS) {
            if (!b_by_tma) {
              if (RHS_NK)
                load_kmajor<WIDE_SUB_N>(dst, b, p.k, n0, p.n, k0, p.k, p.load_b, t);
              else
                load_mnmajor<WIDE_SUB_N>(dst, b, p.n, k0, p.k, n0, p.load_b, t);
            }
            if (streamed && !a_by_tma)
              load_kmajor<SM>(dst + T::B_BYTES, a, p.k, m0, p.m, k0, p.k, p.load_a, t);
            cp_async_commit();
            if (++owed > lag) {
              cp_async_wait(lag);
              fence_proxy_async();
              mbar_arrive(full_bar((it - owed) % stages));
              --owed;
            }
          }
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    });
    if (LOADS) settle();
    return;
  }

  // ---- consumer warpgroups: wgmma on each landed stage (and the resident strip), the K
  // carry, then the sub-tile out: by TMA stores through the staging buffer, or predicated
  // stores ----
  if constexpr (T::CONSUMERS == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, warp4 = warp % 4;
  const bool leader = threadIdx.x % 128 == 0;  // issues the warpgroup's stores
  const uint32_t staging = c_stage + wg * WIDE_C_BYTES;
  const bool store_tma = !T::SWAP && (!LOADS || p.tma_c);
  // A bk that is a multiple of 32 but not of 64 puts every other rounding point in the middle
  // of a stage: the bf16 family then runs each stage as two halves of two k16 wgmmas and may
  // round after either (the ring's rule)
  const bool halves = ACC_BF16 && p.bk % KSTAGE != 0;
  float st[T::ACC];   // the stage product (wgmma accumulator)
  float sum[T::ACC];  // f32: the sum; bf16 carry: the interval's part
  __nv_bfloat162 carry[ACC_BF16 ? T::ACC / 2 : 1];  // bf16 family: the carry, packed
  int s = 0, tile = 0, loads = 0;
  uint32_t phase = 0;
  for_each_strip(walk, [&](const WideItem& w, int end) {
    if (!streamed) mbar_wait(a_full, loads & 1);
    ++loads;
    const int z = w.z;
    const int row0 = w.m_blk + w.strip * SM + wg * 64;  // this warpgroup's first row of C
    for (int col = w.col; col < end; ++col, ++tile) {
      const int n0 = w.n_blk + col * WIDE_SUB_N;
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) sum[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < (ACC_BF16 ? T::ACC / 2 : 1); ++i)
        carry[i] = __floats2bfloat162_rn(0.0f, 0.0f);
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(full_bar(s), phase);
        const uint32_t b_s = ring + s * stage_bytes;
        const uint32_t a_s = streamed ? b_s + T::B_BYTES : a_strip + ks * T::A_BOX;
        const int k0 = ks * KSTAGE;
        const bool last = ks + 1 == ksteps;
        // the segment's last wgmma: the producer may load the next strip over it
        const bool strip_read = !streamed && col + 1 == end && last;
        if (!halves) {
          fence_regs(st);
          wgmma_fence();
          stage_mma<SM, WIDE_SUB_N, RHS_NK, 4>(st, a_s, b_s, wg, 0);  // a fresh sum every stage
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(st);
          if (lane == 0) {
            mbar_arrive(empty_bar(s));  // this warp is done reading the stage
            if (strip_read) mbar_arrive(a_empty);
          }
          fold<ACC_BF16>(sum, st, carry, ACC_BF16 && ((k0 + KSTAGE) % p.bk == 0 || last));
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            fence_regs(st);
            wgmma_fence();
            stage_mma<SM, WIDE_SUB_N, RHS_NK, 2>(st, a_s, b_s, wg, 2 * h);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(st);
            if (h == 1 && lane == 0) {
              mbar_arrive(empty_bar(s));
              if (strip_read) mbar_arrive(a_empty);
            }
            fold<ACC_BF16>(sum, st, carry,
                           ACC_BF16 && ((k0 + 32 * (h + 1)) % p.bk == 0 || (last && h == 1)));
          }
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
      if constexpr (ACC_BF16) {
#pragma unroll
        for (int i = 0; i < T::ACC / 2; ++i) {
          const float2 c2 = __bfloat1622float2(carry[i]);
          sum[2 * i] = c2.x;
          sum[2 * i + 1] = c2.y;
        }
      }
      if constexpr (T::SWAP) {
        // the fragment is the sub-tile's C^T: its rows are columns of C, its columns the
        // block's rows (the ring's swapped epilogue, stores within the block's edges)
        const int ncol = n0 + wg * 64 + warp4 * 16 + (lane >> 2);
        const int mrow = w.m_blk + 2 * (lane & 3);
        if (OUT_F32)
          epilogue_swapped<float>(p, sum, ncol, mrow, w.m_lim, w.n_lim, z);
        else
          epilogue_swapped<bf16>(p, sum, ncol, mrow, w.m_lim, w.n_lim, z);
      } else {
        if (store_tma) {
          // the buffer's last stores must have read it before it is written again
          const uint32_t buf = staging + (tile % T::NBUF) * T::BOXES * BOX_BYTES;
          if (leader) bulk_wait_read<T::NBUF - 1>();
          wg_sync(wg);
          with_act(p.act, [&](auto act) {
            stage_c_act<OUT_F32, decltype(act)::value>(buf, sum, p, n0, warp4, lane);
          });
          fence_proxy_async();  // the generic proxy's writes, visible to the TMA store
          wg_sync(wg);
          if (leader) {
#pragma unroll
            for (int bx = 0; bx < T::BOXES; ++bx)
              tma_store(&tma_c, buf + bx * BOX_BYTES, n0 + bx * T::BOX_COLS, row0, z);
            bulk_commit();
          }
        } else if constexpr (LOADS) {
          // the ring's predicated epilogue (pairs where aligned), stores within the block's
          // edges
          const int row = row0 + warp4 * 16 + (lane >> 2), col0 = n0 + 2 * (lane & 3);
          if (OUT_F32)
            epilogue<float>(p, sum, row, col0, w.m_lim, w.n_lim, z);
          else
            epilogue<bf16>(p, sum, row, col0, w.m_lim, w.n_lim, z);
        }
      }
    }
  });
  if (store_tma && leader) bulk_wait_all();  // the staging must outlive its stores
}

template <int SM, bool RHS_NK, bool OUT_F32, bool ACC_BF16, bool LOADS, bool STREAM>
cudaError_t launch_instance(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,
                            const WgParams& p, int ctas, cudaStream_t stream) {
  using T = WideTile<SM, OUT_F32>;
  const auto kernel = tl2_wgmma_wide_kernel<SM, RHS_NK, OUT_F32, ACC_BF16, LOADS, STREAM>;
  static int regs_checked = 0;  // per instance: the registers fit
  static int attr_bytes = 0;    // per instance: the dynamic shared memory the attribute allows
  const int smem = wide_smem_bytes(SM, p.k, p.stages, STREAM);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (smem > attr_bytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_bytes = smem;
  }
  if (!regs_checked) {
    if (T::CONSUMERS == 2) {
      // as launch_tile: setmaxnreg.inc must find the registers it asks for
      cudaFuncAttributes attr;
      const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e != cudaSuccess) return e;
      const int per_warp = (attr.numRegs + 7) / 8 * 8;
      const int want = T::CONSUMERS * 4 * CONSUMER_REGS + 4 * PRODUCER_REGS;
      if (want > (T::CONSUMERS + 1) * 4 * per_warp) return cudaErrorInvalidConfiguration;
    }
    regs_checked = 1;
  }
  kernel<<<ctas, T::THREADS, smem, stream>>>(ta, tb, tc, p);
  return cudaGetLastError();
}

template <int SM, bool ACC_BF16, bool LOADS, bool STREAM>
cudaError_t launch_sub(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,
                       const WgParams& p, int ctas, int rhs_nk, cudaStream_t s) {
  if (rhs_nk)
    return p.out_f32
               ? launch_instance<SM, true, true, ACC_BF16, LOADS, STREAM>(ta, tb, tc, p, ctas, s)
               : launch_instance<SM, true, false, ACC_BF16, LOADS, STREAM>(ta, tb, tc, p, ctas, s);
  return p.out_f32
             ? launch_instance<SM, false, true, ACC_BF16, LOADS, STREAM>(ta, tb, tc, p, ctas, s)
             : launch_instance<SM, false, false, ACC_BF16, LOADS, STREAM>(ta, tb, tc, p, ctas, s);
}

}  // namespace
}  // namespace tl2wg

// One instance file's launcher of the plain walk: both sub-tile heights, layouts and output
// dtypes of one (family of the K carry, producer, A's mode).
#define TL2_WIDE_INSTANCES(NAME, ACC_BF16, LOADS, STREAM)                                \
  namespace tl2wg {                                                                      \
  TL2_WIDE_LAUNCHER(NAME) {                                                              \
    if (wide_swapped(p.blk_m)) return cudaErrorInvalidValue;                             \
    return wide_sub_m(p.blk_m) == 64                                                     \
               ? launch_sub<64, ACC_BF16, LOADS, STREAM>(ta, tb, tc, p, ctas, rhs_nk, s) \
               : launch_sub<128, ACC_BF16, LOADS, STREAM>(ta, tb, tc, p, ctas, rhs_nk, s); \
  }                                                                                      \
  }

// One instance file's launcher of the swapped walk (bm <= 32): layouts and output dtypes of
// one family of the K carry, with the loads producer compiled in (each operand by TMA or by
// loads, chosen at run time), A streamed and C by predicated stores.
#define TL2_WIDE_SWAP_INSTANCES(NAME, ACC_BF16)                                          \
  namespace tl2wg {                                                                      \
  TL2_WIDE_LAUNCHER(NAME) {                                                              \
    if (!wide_swapped(p.blk_m) || !p.wide_stream || p.tma_c) return cudaErrorInvalidValue; \
    return launch_sub<WIDE_SWAP_M, ACC_BF16, true, true>(ta, tb, tc, p, ctas, rhs_nk, s); \
  }                                                                                      \
  }
