// tl2_wgmma.cu — the GEMM body of tpul2_torch redesigned for Hopper (sm_90a): a ring of K
// slices filled by TMA and guarded by mbarriers, consumed by wgmma warpgroups.
//
// Replaces, on the routes below, the Pallas TPU kernels
//   tpul2/ops/matmul.py::_kernel_multi_k       (K carry across grid steps, gk > 1)
//   tpul2/ops/matmul.py::_kernel_single_k      (one block product over all of K, gk == 1)
//   tpul2/ops/batched.py::_bmm_kernel          (batched, K carry; the batch index is blockIdx.z)
//   tpul2/ops/batched.py::_bmm_kernel_single_k (batched, gk == 1)
//   tpul2/ops/pipelined.py::_kernel            (the staged K ring: tl2_wgmma_staged)
// Route (tl2_wgmma_route, mirrored by ops/matmul.py::launch_route): BM and BN in {64, 128},
// operands TMA can read (16-byte aligned bases and rows of a multiple of 16 bytes: K % 8 for
// A and B_t, N % 8 for B), and, where there is a K carry (gk > 1), bk a multiple of 64 so
// that a ring stage never straddles a rounding point. A single interval (gk == 1) has no
// rounding point inside K, so any bk >= K takes the route. Everything else runs
// tl2_matmul.cu's mma.sync body. The staged route (tl2_staged_route, mirrored by
// ops/pipelined.py::staged_route) is the same without bk, since a staged launch sums all of
// K in f32: ring tiles with TMA-readable operands run here, 32-edge tiles run
// tl2_staged.cu. Each route is chosen from the shape before the launch; a launch outside it
// is refused, never redirected.
//
// What it computes, per output tile, exactly as tl2_matmul.cu does (and the JAX kernels,
// matmul.py:116, :146 and batched.py:33, :42):
//   gk > 1: for each K interval of length bk:
//             part = the interval's product in f32
//             acc  = round_to_acc_dtype(acc + part)   -- after every interval, first and last
//   gk == 1:  acc  = the product over all of K in f32 -- never rounded, in both families
//   then + bias (f32), the activation (gelu is the tanh approximation), the cast.
// The bf16 family keeps `part` in f32 registers and the carry as bf16, two to a register.
// The f32 family folds each stage straight into the carry: only the order of the f32 adds
// changes, which ops/matmul.py::allowed_error's first term covers. A gk == 1 launch runs the
// f32-carry instance whatever acc_dtype says: the bf16-carry instance would round the sum
// at the end of its one interval, before the bias, where the single-K kernel does not.
// Precision: each stage's four k16 wgmmas start from a fresh accumulator (scale-d = 0 on the
// first) whose sum then joins the f32 total with ordinary adds. Chaining a whole interval
// through the tensor cores' accumulator lost ~25x cuBLAS's f32 accuracy at K = 8192 with
// mma.sync; chip_smoke.py prints this kernel's error against an f64 product beside cuBLAS's.
//
// What bounds it on the H100: at 4096^3 the product is 137 GFLOP against ~100 MB of
// operands and output, 0.139 ms at 989 TFLOP/s against 0.03 ms at 3.35 TB/s: the tensor
// cores. So the design keeps wgmma issuing: one producer thread keeps the ring's K slices in
// flight with TMA (no thread spends registers or instructions on addresses), and BM / 64
// consumer warpgroups run m64 x BN x k16 wgmmas on whichever stage has landed, each
// releasing its stage through an mbarrier as soon as its wgmmas have read it. The skinny
// (64 x 8192 x 8192) and thin-K (8192 x 128 x 64) shapes are bound by bytes instead: B, and
// at thin K the f32 output's stores, which no design of the mainloop shortens.
//
// Shared memory: a ring of `stages` stages, each [BM][64] of A then 64 deep of B, rows of 128
// bytes with the 128-byte swizzle (the TMA boxes and the wgmma descriptors agree on it):
//   A (M, K) and B_t (N, K) are K-major: one box [rows][64 K];
//   B (K, N) is MN-major (TMA cannot transpose): BN / 64 boxes [64 K][64 N], read by wgmma
//   with the transpose-B flag; LBO = 8192 (the next 64 columns), SBO = 1024 (the next 8 K).
// Edges: the tensor maps carry the true M, N, K (rank 3: inner dim, rows, batch), so TMA
// zero-fills every load past an edge, both operands' K tails included, and rows past M of
// one batch element are zeros, not the next element's rows. Stores are predicated to
// (M, N), so the gate's guard bands test the kernel's own writes.
// Registers: a consumer thread holds BN / 2 floats of the stage product, BN / 2 of the
// carry (f32) or of `part` plus BN / 4 packed bf16 carry registers; with two consumer
// warpgroups the producer warpgroup (one thread of it issues the copies) gives registers up
// (setmaxnreg) and the consumers take them.
// Short K (gk == 1 at K = 64, the thin bring-up shape): the producer issues only the stages K
// needs, so the ring's unused slots cost shared memory, not copies or waits; the fixed cost
// of a CTA is the barrier set-up, one stage's latency and the epilogue's stores.
// Staged launches (tl2_wgmma_staged, the port of pipelined.py::_kernel): one f32 sum over
// all of K through a ring of `depth` stages, then one cast, in both families (the f32-carry
// instance). The depth is the config's pipeline_depth, a launch argument; the carry and
// single-K launches keep CARRY_STAGES. The TPU kernel's grid runs in order on one core; on
// this card a skinny problem's few output tiles leave most of the 132 SMs idle, so a staged
// launch may split K (blockIdx.y): split s sums its run of whole 64-deep stages into an f32
// partial in a workspace (splits x M x N, allocated by the wrapper; TMA zero-fills the last
// split's K tail), and tl2_splitk_reduce_kernel then adds the partials of each element in
// split order and casts once. No atomics: two runs on the same inputs give the same bits.
// Left for later: a persistent schedule, a TMA store staged through shared memory, and
// overlapping one stage's adds with the next stage's wgmmas.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KSTAGE = 64;              // K depth of one ring stage: one 128-byte bf16 row
constexpr int ROW_BYTES = KSTAGE * 2;   // the swizzle span
// Ring depth of the carry and single-K launches, from H100 runs at 4096^3 (128 x 128,
// bk 1024): 3 stages ran 5% slower than 4, and 5 or 6 no faster (PERF.md, the multi-K
// redesign's findings). A staged launch gives its own depth, 2..MAX_STAGES.
constexpr int CARRY_STAGES = 4;
constexpr int MAX_STAGES = 8;
// Shared memory one block may use on the H100 (227 KB)
constexpr int SMEM_LIMIT = 232448;
// setmaxnreg with two consumer warpgroups: ptxas allocates 168 registers a thread at entry
// (384 threads), so 4 producer warps at 40 and 8 consumer warps at 232 use the same total
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// A wait that outlasts this many polls is a fault of the ring protocol: trap (a launch
// error) instead of hanging the card.
constexpr int SPIN_LIMIT = 1 << 26;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_TANH = 4 };

struct WgParams {
  const float* bias;   // (N,) or null
  void* c;             // (batch, M, N), row stride N; a split launch: (splits, M, N) f32
  int m, n, k, bk;
  long long sc;        // batch stride of C in elements
  long long ssplit;    // split stride of C in elements (0 without a split)
  int stages;          // ring depth
  int split_steps;     // 64-deep K stages per split (all of them without a split)
  int act, raster_nm, out_f32, vec_out;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int BM, int BN>
struct WgTile {
  static constexpr int CONSUMERS = BM / 64;                // warpgroups, 64 rows each
  static constexpr int THREADS = (CONSUMERS + 1) * 128;    // + the producer warpgroup
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int STAGE_BYTES = (BM + BN) * ROW_BYTES;
  static constexpr int ACC = BN / 2;                    // f32 registers of an m64 x BN tile
};

// 1024 bytes of slack to align the ring to the swizzle's 1024-byte period, the ring, then a
// full and an empty mbarrier per stage
int smem_bytes(int bm, int bn, int stages) {
  return 1024 + stages * (bm + bn) * ROW_BYTES + 2 * stages * 8;
}

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(x, 0.0f);
    case ACT_GELU: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU: return x / (1.0f + expf(-x));
    case ACT_TANH: return tanhf(x);
    default: return x;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the barrier with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == SPIN_LIMIT) __trap();
  }
}

// One TMA box of a rank-3 map into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle (layout type 1); the
// byte offsets are stored in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of the accumulator across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TL2_F8(b)                                                                     \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),     \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (+)= A[64 x 16] * B[16 x 64]; scale_d = 0 starts from zero. TRANS_B: B is MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : TL2_F8(0), TL2_F8(8), TL2_F8(16), TL2_F8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// d (+)= A[64 x 16] * B[16 x 128].
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : TL2_F8(0), TL2_F8(8), TL2_F8(16), TL2_F8(24), TL2_F8(32), TL2_F8(40), TL2_F8(48),
        TL2_F8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

#undef TL2_F8

template <int BN, bool RHS_NK>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 64)
    wgmma_n64<RHS_NK ? 0 : 1>(d, da, db, scale_d);
  else
    wgmma_n128<RHS_NK ? 0 : 1>(d, da, db, scale_d);
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1, bool both, bool vec) {
  if (vec && both) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (both) p[1] = v1;
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1, bool both, bool vec) {
  if (vec && both) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (both) p[1] = __float2bfloat16(v1);
  }
}

// Bias, activation and the cast of one consumer thread's m64 x BN fragment: element
// 4j + 2h + e sits at row 16 * warp + g + 8h, column 8j + 2q + e of the warpgroup's tile.
template <typename OutT, int N>
__device__ __forceinline__ void epilogue(const WgParams& p, const float (&v)[N], int row0,
                                         int col0) {
  OutT* C = static_cast<OutT*>(p.c) + (long long)blockIdx.z * p.sc + blockIdx.y * p.ssplit;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = col0 + 8 * j;
    if (col >= p.n) continue;
    const bool both = col + 1 < p.n;
    float b0 = 0.0f, b1 = 0.0f;
    if (p.bias) {
      b0 = p.bias[col];
      b1 = both ? p.bias[col + 1] : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < p.m)
        store_pair(C + (long long)row * p.n + col, act_fn(v[4 * j + 2 * h] + b0, p.act),
                   act_fn(v[4 * j + 2 * h + 1] + b1, p.act), both, p.vec_out);
    }
  }
}

template <int BM, int BN, bool RHS_NK, bool ACC_BF16>
__global__ void __launch_bounds__(WgTile<BM, BN>::THREADS, 1)
    tl2_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                     const __grid_constant__ CUtensorMap tma_b, WgParams p) {
  using T = WgTile<BM, BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int stages = p.stages;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + stages * T::STAGE_BYTES;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (stages + s); };

  const int tiles_m = cdiv(p.m, BM), tiles_n = cdiv(p.n, BN);
  const int tile = blockIdx.x;
  const int tm = p.raster_nm ? tile % tiles_m : tile / tiles_n;
  const int tn = p.raster_nm ? tile / tiles_m : tile % tiles_n;
  const int m0 = tm * BM, n0 = tn * BN;
  // this CTA's run of 64-deep K stages: its split's (blockIdx.y), all of K without a split
  const int first = blockIdx.y * p.split_steps;
  const int steps = min(cdiv(p.k, KSTAGE) - first, p.split_steps);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar(s), 1);                     // the producer's expect_tx arrival
      mbar_init(empty_bar(s), T::CONSUMERS * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= T::CONSUMERS * 4) {
    // ---- producer warpgroup: one thread keeps the ring filled, the other warps leave ----
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == T::CONSUMERS * 4 && lane == 0) {
      const int z = blockIdx.z;
      int s = 0;
      uint32_t phase = 0;
      for (int it = 0; it < steps; ++it) {
        if (it >= stages) mbar_wait(empty_bar(s), phase ^ 1);  // the stage's last use is read
        const uint32_t a_dst = ring + s * T::STAGE_BYTES, b_dst = a_dst + T::A_BYTES;
        const int k0 = (first + it) * KSTAGE;
        mbar_expect_tx(full_bar(s), T::STAGE_BYTES);
        tma_load(a_dst, &tma_a, full_bar(s), k0, m0, z);
        if (RHS_NK) {
          tma_load(b_dst, &tma_b, full_bar(s), k0, n0, z);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(b_dst + j * 64 * ROW_BYTES, &tma_b, full_bar(s), n0 + 64 * j, k0, z);
        }
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: wgmma on each landed stage ----
    if constexpr (T::CONSUMERS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp / 4;
    float st[T::ACC];                             // the stage product (wgmma accumulator)
    float sum[T::ACC];                            // f32: the carry; bf16: the interval's part
    __nv_bfloat162 carry[ACC_BF16 ? T::ACC / 2 : 1];  // bf16 family: the carry, packed
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) st[i] = sum[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (ACC_BF16 ? T::ACC / 2 : 1); ++i)
      carry[i] = __floats2bfloat162_rn(0.0f, 0.0f);

    const int spi = p.bk / KSTAGE;  // stages per bk interval
    int s = 0, in_iv = 0;
    uint32_t phase = 0;
    for (int it = 0; it < steps; ++it) {
      mbar_wait(full_bar(s), phase);
      const uint32_t a_s = ring + s * T::STAGE_BYTES + wg * 64 * ROW_BYTES;
      const uint32_t b_s = ring + s * T::STAGE_BYTES + T::A_BYTES;
      fence_regs(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTAGE / 16; ++kk) {
        const uint64_t da = desc_sw128(a_s + kk * 32, 16, 8 * ROW_BYTES);
        const uint64_t db = RHS_NK ? desc_sw128(b_s + kk * 32, 16, 8 * ROW_BYTES)
                                   : desc_sw128(b_s + kk * 16 * ROW_BYTES, 64 * ROW_BYTES,
                                                8 * ROW_BYTES);
        wgmma_tile<BN, RHS_NK>(st, da, db, kk > 0 ? 1 : 0);  // a fresh sum every stage
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      if (lane == 0) mbar_arrive(empty_bar(s));  // this warp is done reading the stage

#pragma unroll
      for (int i = 0; i < T::ACC; ++i) sum[i] += st[i];
      const bool iv_end = in_iv + 1 == spi || it + 1 == steps;
      if constexpr (ACC_BF16) {
        if (iv_end) {  // the rounding point: acc = round_bf16(acc + part)
#pragma unroll
          for (int i = 0; i < T::ACC / 2; ++i) {
            const float2 a = __bfloat1622float2(carry[i]);
            carry[i] = __floats2bfloat162_rn(a.x + sum[2 * i], a.y + sum[2 * i + 1]);
            sum[2 * i] = sum[2 * i + 1] = 0.0f;
          }
        }
      }
      in_iv = iv_end ? 0 : in_iv + 1;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }

    if constexpr (ACC_BF16) {
#pragma unroll
      for (int i = 0; i < T::ACC / 2; ++i) {
        const float2 a = __bfloat1622float2(carry[i]);
        sum[2 * i] = a.x;
        sum[2 * i + 1] = a.y;
      }
    }
    const int row0 = m0 + wg * 64 + (warp % 4) * 16 + (lane >> 2);
    const int col0 = n0 + 2 * (lane & 3);
    if (p.out_f32)
      epilogue<float>(p, sum, row0, col0);
    else
      epilogue<bf16>(p, sum, row0, col0);
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, so the library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                           12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A rank-3 map over a (batch, rows, inner) bf16 array read in boxes [box_rows][64 inner],
// 128-byte swizzled. Loads past any edge read zeros.
bool make_map(CUtensorMap* map, const void* base, int inner, int rows, int batch,
              long long batch_stride, int box_rows) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)KSTAGE, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// The staged route: a ring tile and operands TMA can read. bk plays no part, since a staged
// launch sums all of K in f32 and has no rounding point inside K.
int staged_route_ok(int m, int n, int k, int bm, int bn, int rhs_nk, const void* a,
                    const void* b) {
  if (m <= 0 || n <= 0 || k <= 0) return 0;
  if ((bm != 64 && bm != 128) || (bn != 64 && bn != 128)) return 0;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16) return 0;
  return k % 8 == 0 && (rhs_nk ? k : n) % 8 == 0;
}

int route_ok(int m, int n, int k, int bm, int bn, int bk, int rhs_nk, const void* a,
             const void* b) {
  if (bk <= 0) return 0;
  if (cdiv(k, bk) > 1 && bk % KSTAGE) return 0;  // a stage would straddle a rounding point
  return staged_route_ok(m, n, k, bm, bn, rhs_nk, a, b);
}

template <int BM, int BN, bool RHS_NK, bool ACC_BF16>
cudaError_t launch_tile(const CUtensorMap& ta, const CUtensorMap& tb, const WgParams& p,
                        int splits, int batch, cudaStream_t stream) {
  using T = WgTile<BM, BN>;
  const auto kernel = tl2_wgmma_kernel<BM, BN, RHS_NK, ACC_BF16>;
  static int regs_checked = 0;  // per instance: the registers fit
  static int attr_bytes = 0;    // per instance: the dynamic shared memory the attribute allows
  const int smem = smem_bytes(BM, BN, p.stages);
  if (smem > attr_bytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_bytes = smem;
  }
  if (!regs_checked) {
    if (T::CONSUMERS == 2) {
      // setmaxnreg.inc blocks until the registers are free: refuse a build whose
      // allocation at launch cannot cover the rebalanced counts, rather than hang
      cudaFuncAttributes attr;
      const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e != cudaSuccess) return e;
      const int per_warp = (attr.numRegs + 7) / 8 * 8;
      const int want = T::CONSUMERS * 4 * CONSUMER_REGS + 4 * PRODUCER_REGS;
      if (want > (T::CONSUMERS + 1) * 4 * per_warp)
        return cudaErrorInvalidConfiguration;
    }
    regs_checked = 1;
  }
  const dim3 grid(cdiv(p.m, BM) * cdiv(p.n, BN), splits, batch);
  tl2_wgmma_kernel<BM, BN, RHS_NK, ACC_BF16><<<grid, T::THREADS, smem, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_variant(const CUtensorMap& ta, const CUtensorMap& tb, const WgParams& p,
                           int splits, int batch, int rhs_nk, int acc_bf16, cudaStream_t s) {
  if (rhs_nk)
    return acc_bf16 ? launch_tile<BM, BN, true, true>(ta, tb, p, splits, batch, s)
                    : launch_tile<BM, BN, true, false>(ta, tb, p, splits, batch, s);
  return acc_bf16 ? launch_tile<BM, BN, false, true>(ta, tb, p, splits, batch, s)
                  : launch_tile<BM, BN, false, false>(ta, tb, p, splits, batch, s);
}

// The TMA maps of A and of B or B_t; false if cuTensorMapEncodeTiled refuses them.
bool make_maps(CUtensorMap* ta, CUtensorMap* tb, const void* a, const void* b, int batch,
               int m, int n, int k, long long sa, long long sb, int bm, int bn, int rhs_nk) {
  return make_map(ta, a, k, m, batch, sa, bm) &&
         (rhs_nk ? make_map(tb, b, k, n, batch, sb, bn) : make_map(tb, b, n, k, batch, sb, KSTAGE));
}

// Paired stores need every (row, even column) element of C aligned to two elements.
int pairs_ok(const void* c, int n, int batch, long long sc, int elem_bytes) {
  return n % 2 == 0 && (batch == 1 || sc % 2 == 0) &&
         reinterpret_cast<uintptr_t>(c) % (2 * elem_bytes) == 0;
}

// Launch the instance of (bm, bn); cudaErrorInvalidValue for a tile it has none of.
cudaError_t launch_tiles(int bm, int bn, const CUtensorMap& ta, const CUtensorMap& tb,
                         const WgParams& p, int splits, int batch, int rhs_nk, int acc_bf16,
                         cudaStream_t s) {
#define TL2_WGMMA_TILE(BM_, BN_) \
  if (bm == BM_ && bn == BN_)    \
    return launch_variant<BM_, BN_>(ta, tb, p, splits, batch, rhs_nk, acc_bf16, s);
  TL2_WGMMA_TILE(64, 64) TL2_WGMMA_TILE(64, 128)
  TL2_WGMMA_TILE(128, 64) TL2_WGMMA_TILE(128, 128)
#undef TL2_WGMMA_TILE
  return cudaErrorInvalidValue;
}

template <typename OutT>
int launch(const void* a, const void* b, const void* bias, void* c, int batch, int m, int n,
           int k, long long sa, long long sb, long long sc, int bm, int bn, int bk, int rhs_nk,
           int acc_bf16, int act, int raster_nm, void* stream) {
  if (batch <= 0 || batch > 65535 || !route_ok(m, n, k, bm, bn, bk, rhs_nk, a, b))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!make_maps(&ta, &tb, a, b, batch, m, n, k, sa, sb, bm, bn, rhs_nk))
    return (int)cudaErrorInvalidValue;
  if (cdiv(k, bk) == 1) acc_bf16 = 0;  // one interval: the f32 sum is never rounded
  WgParams p;
  p.bias = static_cast<const float*>(bias);
  p.c = c;
  p.m = m; p.n = n; p.k = k; p.bk = bk;
  p.sc = sc;
  p.ssplit = 0;
  p.stages = CARRY_STAGES;
  p.split_steps = cdiv(k, KSTAGE);
  p.act = act; p.raster_nm = raster_nm; p.out_f32 = sizeof(OutT) == 4;
  p.vec_out = pairs_ok(c, n, batch, sc, sizeof(OutT));
  return (int)launch_tiles(bm, bn, ta, tb, p, 1, batch, rhs_nk, acc_bf16,
                           static_cast<cudaStream_t>(stream));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The split-K reduction: c[i] = cast(((ws[0][i] + ws[1][i]) + ws[2][i]) + ...), the
// partials added in split order, four elements a thread. One thread owns each element, so
// the order, and the bits, are the same on every run.
template <typename OutT>
__global__ void tl2_splitk_reduce_kernel(const float* __restrict__ ws, OutT* __restrict__ c,
                                         long long mn, int splits) {
  const long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= mn) return;
  float4 acc = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(ws + s * mn + i);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  store4(c + i, acc);
}

// What the reduction takes: whole float4s and 16-byte aligned buffers.
int reduce_ok(const void* ws, const void* c, long long mn, int splits) {
  return ws != nullptr && c != nullptr && splits >= 1 && mn > 0 && mn % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(ws) | reinterpret_cast<uintptr_t>(c)) % 16 == 0;
}

cudaError_t launch_reduce(const float* ws, void* c, long long mn, int splits, int out_f32,
                          cudaStream_t s) {
  constexpr int THREADS = 256;
  const dim3 grid((unsigned)((mn / 4 + THREADS - 1) / THREADS));
  if (out_f32)
    tl2_splitk_reduce_kernel<float><<<grid, THREADS, 0, s>>>(ws, static_cast<float*>(c), mn,
                                                             splits);
  else
    tl2_splitk_reduce_kernel<bf16><<<grid, THREADS, 0, s>>>(ws, static_cast<bf16*>(c), mn,
                                                            splits);
  return cudaGetLastError();
}

// The split count a staged launch takes: 1..min(65535, K stages), and no split left empty.
int splits_ok(int k, int splits) {
  const int steps = cdiv(k, KSTAGE);
  return splits >= 1 && splits <= 65535 && splits <= steps &&
         cdiv(steps, cdiv(steps, splits)) == splits;
}

int staged(const void* a, const void* b, void* c, void* ws, int m, int n, int k, int bm, int bn,
           int depth, int splits, int rhs_nk, int raster_nm, int out_f32, void* stream) {
  if (!staged_route_ok(m, n, k, bm, bn, rhs_nk, a, b) || depth < 2 || depth > MAX_STAGES ||
      smem_bytes(bm, bn, depth) > SMEM_LIMIT || !splits_ok(k, splits) || c == nullptr)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && !reduce_ok(ws, c, (long long)m * n, splits))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!make_maps(&ta, &tb, a, b, 1, m, n, k, (long long)m * k, (long long)n * k, bm, bn, rhs_nk))
    return (int)cudaErrorInvalidValue;
  WgParams p;
  p.bias = nullptr;
  p.c = splits > 1 ? ws : c;  // a split writes its f32 partial, the reduction casts
  p.m = m; p.n = n; p.k = k;
  p.bk = k;  // one interval: the f32-carry instance sums all of K, never rounded
  p.sc = 0;
  p.ssplit = splits > 1 ? (long long)m * n : 0;
  p.stages = depth;
  p.split_steps = cdiv(cdiv(k, KSTAGE), splits);
  p.act = ACT_NONE; p.raster_nm = raster_nm;
  p.out_f32 = splits > 1 ? 1 : out_f32;
  p.vec_out = pairs_ok(p.c, n, 1, 0, p.out_f32 ? 4 : 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_tiles(bm, bn, ta, tb, p, splits, 1, rhs_nk, 0, s);
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)launch_reduce(static_cast<const float*>(ws), c, (long long)m * n, splits,
                            out_f32, s);
}

}  // namespace

extern "C" {

// C = act(A @ B [+ bias]) with bf16 output on the wgmma route; the argument list is
// tl2_matmul_bf16out's (vec_a and vec_b are unused: the route requires TMA's alignment;
// acc_bf16 is ignored where gk == 1).
// Returns the cudaError_t of the launch: cudaErrorInvalidValue, before any work, for a
// launch outside the route.
int tl2_wgmma_bf16out(const void* a, const void* b, const void* bias, void* c, int batch, int m,
                      int n, int k, long long sa, long long sb, long long sc, int bm, int bn,
                      int bk, int rhs_nk, int acc_bf16, int act, int raster_nm, int vec_a,
                      int vec_b, void* stream) {
  (void)vec_a;
  (void)vec_b;
  return launch<bf16>(a, b, bias, c, batch, m, n, k, sa, sb, sc, bm, bn, bk, rhs_nk, acc_bf16,
                      act, raster_nm, stream);
}

// The same with f32 output.
int tl2_wgmma_f32out(const void* a, const void* b, const void* bias, void* c, int batch, int m,
                     int n, int k, long long sa, long long sb, long long sc, int bm, int bn,
                     int bk, int rhs_nk, int acc_bf16, int act, int raster_nm, int vec_a,
                     int vec_b, void* stream) {
  (void)vec_a;
  (void)vec_b;
  return launch<float>(a, b, bias, c, batch, m, n, k, sa, sb, sc, bm, bn, bk, rhs_nk, acc_bf16,
                       act, raster_nm, stream);
}

// C = A @ B (rhs_nk = 0) or A @ B_t^T (rhs_nk = 1) through a `depth`-stage ring, f32 over all
// of K, cast once to f32 (out_f32 = 1) or bf16: the staged kernel (pipelined.py::_kernel) on
// the staged route (tl2_staged_route). With splits > 1, split s sums its run of
// cdiv(cdiv(K, 64), splits) stages into ws[s] (splits x M x N f32, 16-byte aligned), then
// the reduction adds the partials in split order into c; with splits == 1, ws is unused.
// Needs 2 <= depth <= 8 within 227 KB of shared memory, and no split left empty. Returns
// the cudaError_t of the launches: cudaErrorInvalidValue, before any work, for what it
// does not take.
int tl2_wgmma_staged(const void* a, const void* b, void* c, void* ws, int m, int n, int k,
                     int bm, int bn, int depth, int splits, int rhs_nk, int raster_nm,
                     int out_f32, void* stream) {
  return staged(a, b, c, ws, m, n, k, bm, bn, depth, splits, rhs_nk, raster_nm, out_f32,
                stream);
}

// The split-K reduction alone (what tl2_wgmma_staged launches after a split): c (M x N,
// bf16 or f32) = the sum over s of ws[s] in split order, cast once.
int tl2_splitk_reduce(const void* ws, void* c, int m, int n, int splits, int out_f32,
                      void* stream) {
  const long long mn = (long long)m * n;
  if (m <= 0 || n <= 0 || !reduce_ok(ws, c, mn, splits)) return (int)cudaErrorInvalidValue;
  return (int)launch_reduce(static_cast<const float*>(ws), c, mn, splits, out_f32,
                            static_cast<cudaStream_t>(stream));
}

// Shared memory of one CTA for a (bm, bn) tile with a ring of `stages`; mirrors
// config.wgmma_smem_bytes.
int tl2_wgmma_smem_bytes(int bm, int bn, int stages) { return smem_bytes(bm, bn, stages); }

// 1 where the launch takes this kernel, 0 where it takes tl2_matmul.cu's mma.sync body;
// mirrors ops/matmul.py::launch_route.
int tl2_wgmma_route(int m, int n, int k, int bm, int bn, int bk, int rhs_nk, const void* a,
                    const void* b) {
  return route_ok(m, n, k, bm, bn, bk, rhs_nk, a, b);
}

// 1 where a staged launch takes this kernel (tl2_wgmma_staged), 0 where it takes
// tl2_staged.cu's mma.sync body; mirrors ops/pipelined.py::staged_route.
int tl2_staged_route(int m, int n, int k, int bm, int bn, int rhs_nk, const void* a,
                     const void* b) {
  return staged_route_ok(m, n, k, bm, bn, rhs_nk, a, b);
}

}  // extern "C"
