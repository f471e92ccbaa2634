// tl2_wgmma_wide.cu — the ring's wide route: one CTA per wide block (an edge above 128, up to
// 2048 x 16384), for the thin-K band's output-write bound products. The host API that
// reaches it (tl2_wgmma_bf16out / _f32out, route 3 'wgmma_wide') is in tl2_wgmma.cu; the
// TMA, mbarrier and wgmma pieces are tl2_wgmma.cuh's.
//
// Replaces the Pallas TPU kernel
//   tpul2/ops/matmul.py::_kernel_single_k (gk == 1, call :220) at the JAX space's wide
//   blocks (tpul2/config.py:432-446: bn up to 16384 and bm up to 2048, "thin-K giants are
//   output-write bound and want the longest contiguous row-major C stripes"), with the
//   whole K in one block (bk >= K).
// What it computes, per bm x bn block: act(A @ B + bias), the product summed in f32 over all
// of K and never rounded before the epilogue (in both families, as the single-K kernel),
// then the cast to bf16 or f32; B in 'kn' (K, N) or 'nk' (N, K).
//
// What bounds it on the H100: the output. At 16384 x 16384 x 64 the product writes 537 MB
// of bf16 C against 4 MB of operands and 34 GFLOP: 0.160 ms at 3.35 TB/s against 0.035 ms
// at 989 TFLOP/s. So the design keeps C's stores streaming while the CTA computes:
//   - one CTA per block (grid cdiv(M, bm) x cdiv(N, bn), raster by grid_order); it walks
//     the block strip by strip (SM = 64 rows at bm = 64, else 128) and, in each strip,
//     sub-tile by sub-tile of 128 columns;
//   - the strip's A (SM x K, K <= 512 at bm >= 128 in 227 KB) is loaded once by TMA and
//     stays resident while the strip's sub-tiles are walked; it is reloaded per strip, as
//     soon as the strip's last wgmma has read it (the a_empty barrier), so the load overlaps
//     that sub-tile's epilogue. Two strips do not fit beside the rest, so there is one;
//   - B sub-tiles (128 columns x 64 K per stage) stream through an mbarrier ring of
//     wide_stages stages; the producer thread runs ahead across sub-tiles and strips, so the
//     next sub-tile's B is in flight during this one's epilogue;
//   - each consumer warpgroup (64 rows, m64n128k16 wgmmas, a fresh accumulator per 64-deep
//     stage added into an f32 total, as the ring does) applies the bias and activation,
//     writes its 64 x 128 sub-tile into a shared-memory staging buffer in the 128-byte
//     swizzle of the TMA box (boxes of 64 rows x 128 bytes: 64 bf16 or 32 f32 columns) and
//     sends it out by TMA stores (cp.async.bulk.tensor, one bulk group per sub-tile); before
//     a buffer is written again its group must have been read (wait_group.read). bf16
//     output has two buffers, so a sub-tile's stores overlap the next sub-tile's wgmmas and
//     staging; f32 output, twice the bytes, has one, whose stores overlap the next
//     sub-tile's wgmmas only. The output's tensor map carries the true M and N, so the
//     stores clip at the edges;
//   - no loads producer: the route takes operands TMA can read (16-byte aligned bases, K and
//     N multiples of 8) and a 16-byte aligned C; tl2_wgmma_route refuses the rest.
// Shared memory (wide_smem_bytes): the B ring, the A strip (cdiv(K, 64) boxes of [SM][64 K]),
// WIDE_C_BYTES of staging per consumer warpgroup, the barriers; 230,432 bytes at bm >= 128
// and K = 512 with 2 stages.
// Left for later: the JAX space's wide blocks at gk > 1 (a K carry), batched wide blocks,
// the loads producer, a persistent schedule over blocks, 256-column sub-tiles.

#include "tl2_wgmma.cuh"

namespace tl2wg {
namespace {

constexpr int BOX_BYTES = 64 * ROW_BYTES;  // one staging box: 64 rows of 128 bytes

template <int SM, bool OUT_F32>
struct WideTile {
  static constexpr int CONSUMERS = SM / 64;
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int A_BOX = SM * ROW_BYTES;           // one 64-deep box of the A strip
  static constexpr int B_BYTES = WIDE_SUB_N * ROW_BYTES;  // one B stage
  static constexpr int BOX_COLS = ROW_BYTES / (OUT_F32 ? 4 : 2);  // C columns per box
  static constexpr int BOXES = WIDE_SUB_N / BOX_COLS;     // boxes of a warpgroup's sub-tile
  static constexpr int NBUF = OUT_F32 ? 1 : 2;            // staging buffers per warpgroup
  static_assert(NBUF * BOXES * BOX_BYTES == WIDE_C_BYTES, "staging fills WIDE_C_BYTES");
};

// One TMA box from shared memory to global memory (the map clips at the tensor's edges).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups have not yet read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The 128 threads of consumer warpgroup wg (named barrier 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The activation as a compile-time choice (act_fn's, one case each): act_fn's switch on the
// run-time code, inlined at each of a fragment's 64 elements, made this epilogue the wide
// route's bottleneck at thin K on the H100, several times slower even with no activation.
template <int ACT>
__device__ __forceinline__ float act_apply(float x) {
  if constexpr (ACT == ACT_NONE) {
    return x;
  } else {
    return act_fn(x, ACT);
  }
}

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

// stage_c_act of the launch's activation: the switch is taken once per sub-tile.
template <bool OUT_F32>
__device__ __forceinline__ void stage_c(uint32_t buf, const float (&v)[64], const WgParams& p,
                                        int n0, int warp4, int lane) {
  switch (p.act) {
    case ACT_RELU: stage_c_act<OUT_F32, ACT_RELU>(buf, v, p, n0, warp4, lane); break;
    case ACT_GELU: stage_c_act<OUT_F32, ACT_GELU>(buf, v, p, n0, warp4, lane); break;
    case ACT_SILU: stage_c_act<OUT_F32, ACT_SILU>(buf, v, p, n0, warp4, lane); break;
    case ACT_TANH: stage_c_act<OUT_F32, ACT_TANH>(buf, v, p, n0, warp4, lane); break;
    default: stage_c_act<OUT_F32, ACT_NONE>(buf, v, p, n0, warp4, lane); break;
  }
}

template <int SM, bool RHS_NK, bool OUT_F32>
__global__ void __launch_bounds__(WideTile<SM, OUT_F32>::THREADS, 1)
    tl2_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tma_a,
                          const __grid_constant__ CUtensorMap tma_b,
                          const __grid_constant__ CUtensorMap tma_c, WgParams p) {
  using T = WideTile<SM, OUT_F32>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int stages = p.stages;
  const int ksteps = cdiv(p.k, KSTAGE);
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_strip = ring + stages * T::B_BYTES;
  const uint32_t c_stage = a_strip + ksteps * T::A_BOX;
  const uint32_t bars = c_stage + T::CONSUMERS * WIDE_C_BYTES;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (stages + s); };
  const uint32_t a_full = bars + 16 * stages, a_empty = a_full + 8;

  const int blocks_m = cdiv(p.m, p.wide_bm), blocks_n = cdiv(p.n, p.wide_bn);
  const int block = blockIdx.x;
  const int bm_i = p.raster_nm ? block % blocks_m : block / blocks_n;
  const int bn_i = p.raster_nm ? block / blocks_m : block % blocks_n;
  const int m_blk = bm_i * p.wide_bm, n_blk = bn_i * p.wide_bn;
  // the strips and sub-tile columns of this block that hold part of C
  const int strips = cdiv(min(p.wide_bm, p.m - m_blk), SM);
  const int cols = cdiv(min(p.wide_bn, p.n - n_blk), WIDE_SUB_N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar(s), 1);                  // the producer's expect_tx arrival
      mbar_init(empty_bar(s), T::CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, T::CONSUMERS * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= T::CONSUMERS * 4) {
    // ---- producer warpgroup: one thread issues every TMA load; the others leave ----
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != T::CONSUMERS * 128) return;
    int s = 0, it = 0;
    uint32_t phase = 0;
    for (int strip = 0; strip < strips; ++strip) {
      // the strip's A, once the last strip's last wgmma has read the buffer
      if (strip > 0) mbar_wait(a_empty, (strip - 1) & 1);
      mbar_expect_tx(a_full, ksteps * T::A_BOX);
      for (int ks = 0; ks < ksteps; ++ks)
        tma_load(a_strip + ks * T::A_BOX, &tma_a, a_full, ks * KSTAGE, m_blk + strip * SM, 0);
      for (int col = 0; col < cols; ++col) {
        const int n0 = n_blk + col * WIDE_SUB_N;
        for (int ks = 0; ks < ksteps; ++ks, ++it) {
          if (it >= stages) mbar_wait(empty_bar(s), phase ^ 1);  // the stage's last use is read
          const uint32_t dst = ring + s * T::B_BYTES;
          mbar_expect_tx(full_bar(s), T::B_BYTES);
          if (RHS_NK) {
            tma_load(dst, &tma_b, full_bar(s), ks * KSTAGE, n0, 0);
          } else {
#pragma unroll
            for (int j = 0; j < WIDE_SUB_N / 64; ++j)
              tma_load(dst + j * 64 * ROW_BYTES, &tma_b, full_bar(s), n0 + 64 * j, ks * KSTAGE,
                       0);
          }
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wgmma on the resident A strip and each landed B stage, then
  // the sub-tile out through the staging buffer by TMA stores ----
  if constexpr (T::CONSUMERS == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, warp4 = warp % 4;
  const bool leader = threadIdx.x % 128 == 0;  // issues the warpgroup's stores
  const uint32_t staging = c_stage + wg * WIDE_C_BYTES;
  float st[64], sum[64];
  int s = 0, tile = 0;
  uint32_t phase = 0;
  for (int strip = 0; strip < strips; ++strip) {
    mbar_wait(a_full, strip & 1);
    const int row0 = m_blk + strip * SM + wg * 64;  // this warpgroup's first row of C
    for (int col = 0; col < cols; ++col, ++tile) {
      const int n0 = n_blk + col * WIDE_SUB_N;
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(full_bar(s), phase);
        fence_regs(st);
        wgmma_fence();
        stage_mma<SM, WIDE_SUB_N, RHS_NK, 4>(st, a_strip + ks * T::A_BOX, ring + s * T::B_BYTES,
                                             wg, 0);  // a fresh sum every stage
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        if (lane == 0) {
          mbar_arrive(empty_bar(s));  // this warp is done reading the stage
          if (col + 1 == cols && ks + 1 == ksteps) mbar_arrive(a_empty);  // and the strip
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += st[i];
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
      // the buffer's last stores must have read it before it is written again
      const uint32_t buf = staging + (tile % T::NBUF) * T::BOXES * BOX_BYTES;
      if (leader) bulk_wait_read<T::NBUF - 1>();
      wg_sync(wg);
      stage_c<OUT_F32>(buf, sum, p, n0, warp4, lane);
      fence_proxy_async();  // the generic proxy's writes, visible to the TMA store
      wg_sync(wg);
      if (leader) {
#pragma unroll
        for (int b = 0; b < T::BOXES; ++b)
          tma_store(&tma_c, buf + b * BOX_BYTES, n0 + b * T::BOX_COLS, row0);
        bulk_commit();
      }
    }
  }
  if (leader) bulk_wait_all();  // the staging must outlive its stores
}

template <int SM, bool RHS_NK, bool OUT_F32>
cudaError_t launch_instance(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,
                            const WgParams& p, cudaStream_t stream) {
  using T = WideTile<SM, OUT_F32>;
  const auto kernel = tl2_wgmma_wide_kernel<SM, RHS_NK, OUT_F32>;
  static int regs_checked = 0;  // per instance: the registers fit
  static int attr_bytes = 0;    // per instance: the dynamic shared memory the attribute allows
  const int smem = wide_smem_bytes(SM, p.k, p.stages);
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
  const dim3 grid(cdiv(p.m, p.wide_bm) * cdiv(p.n, p.wide_bn));
  kernel<<<grid, T::THREADS, smem, stream>>>(ta, tb, tc, p);
  return cudaGetLastError();
}

template <int SM>
cudaError_t launch_sub(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,
                       const WgParams& p, int rhs_nk, cudaStream_t s) {
  if (rhs_nk)
    return p.out_f32 ? launch_instance<SM, true, true>(ta, tb, tc, p, s)
                     : launch_instance<SM, true, false>(ta, tb, tc, p, s);
  return p.out_f32 ? launch_instance<SM, false, true>(ta, tb, tc, p, s)
                   : launch_instance<SM, false, false>(ta, tb, tc, p, s);
}

}  // namespace

cudaError_t launch_wide_block(const CUtensorMap& ta, const CUtensorMap& tb,
                              const CUtensorMap& tc, const WgParams& p, int rhs_nk,
                              cudaStream_t s) {
  if (!wide_block_ok(p.wide_bm, p.wide_bn) || p.stages < WIDE_MIN_STAGES ||
      p.stages > WIDE_STAGES)
    return cudaErrorInvalidValue;
  return wide_sub_m(p.wide_bm) == 64 ? launch_sub<64>(ta, tb, tc, p, rhs_nk, s)
                                     : launch_sub<128>(ta, tb, tc, p, rhs_nk, s);
}

}  // namespace tl2wg
