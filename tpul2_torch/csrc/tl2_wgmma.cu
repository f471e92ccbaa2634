// tl2_wgmma.cu — the GEMM body of tpul2_torch redesigned for Hopper (sm_90a): a ring of K
// slices filled by TMA (or, for operands TMA cannot read, by ordinary loads) and guarded by
// mbarriers, consumed by wgmma warpgroups. The kernel is tl2_wgmma.cuh; this file holds the
// host side and the instances of the 64/128 tiles with the TMA producer; tl2_wgmma_lsu.cu
// holds theirs with the loads producer, tl2_wgmma_n32.cu those with bn = 32 and
// tl2_wgmma_swap.cu those with bm = 32 over bn 64 / 128 (each with both producers).
//
// Replaces the Pallas TPU kernels
//   tpul2/ops/matmul.py::_kernel_multi_k       (K carry across grid steps, gk > 1)
//   tpul2/ops/matmul.py::_kernel_single_k      (one block product over all of K, gk == 1)
//   tpul2/ops/batched.py::_bmm_kernel          (batched, K carry; the batch index is blockIdx.z)
//   tpul2/ops/batched.py::_bmm_kernel_single_k (batched, gk == 1)
//   tpul2/ops/pipelined.py::_kernel            (the staged K ring: tl2_wgmma_staged)
// Route (tl2_wgmma_route, mirrored by ops/matmul.py::launch_route): every valid config,
// i.e. a block of edges in 1..128 (on the tile of ring_edge(bm) x ring_edge(bn), the CTAs
// stepping by the block's edges) and bk a multiple of 32, runs here; the route names the
// producer: 1 ('wgmma') where TMA can read both operands (16-byte aligned bases and rows of
// a multiple of 16 bytes: K % 8 for A and B_t, N % 8 for B), 2 ('wgmma_lsu') where one of
// them is read by the loads producer. A wide block (an edge above 128, up to 16384 x 32768,
// any edges, tl2_wgmma_wide.cu) takes 3 ('wgmma_wide') where TMA can read both operands and
// write C (N % 8 == 0, a 16-byte aligned C, and every block edge on the sub-tile grid or
// past the problem's: wide_c_grid), else 4 ('wgmma_wide_lsu': the loads producer and
// predicated stores; the swapped walk of bm <= 32 always), at any bk and batch. The staged
// route (tl2_staged_route, mirrored by ops/pipelined.py::staged_route) is the same without
// bk ('ring' / 'ring_lsu' for a ring block, 3 / 4 for a wide one). A launch is refused
// (cudaErrorInvalidValue, before any work) outside them, never redirected; the mma.sync
// bodies (tl2_matmul.cu, tl2_staged.cu) are on no route.
//
// What it computes, per output tile (and the JAX kernels, matmul.py:116, :146 and
// batched.py:33, :42):
//   gk > 1: for each K interval of length bk:
//             part = the interval's product in f32
//             acc  = round_to_acc_dtype(acc + part)   -- after every interval, first and last
//   gk == 1:  acc  = the product over all of K in f32 -- never rounded, in both families
//   then + bias (f32), the activation (gelu is the tanh approximation), the cast.
// The bf16 family keeps `part` in f32 registers and the carry as bf16, two to a register.
// A bk that is a multiple of 32 but not of 64 puts every other rounding point in the middle
// of a 64-deep stage: the bf16 family then runs each stage as two halves of two k16 wgmmas
// and rounds after either half where an interval ends there. The f32 family folds each
// stage straight into the carry: only the order of the f32 adds changes, which
// ops/matmul.py::allowed_error's first term covers. A gk == 1 launch runs the f32-carry
// instance whatever acc_dtype says: the bf16-carry instance would round the sum at the end
// of its one interval, before the bias, where the single-K kernel does not.
// Precision: each stage's (or half stage's) k16 wgmmas start from a fresh accumulator
// (scale-d = 0 on the first) whose sum then joins the f32 total with ordinary adds. Chaining
// a whole interval through the tensor cores' accumulator lost ~25x cuBLAS's f32 accuracy at
// K = 8192 with mma.sync; chip_smoke.py prints this kernel's error against an f64 product.
//
// What bounds it on the H100: at 4096^3 the product is 137 GFLOP against ~100 MB of
// operands and output, 0.139 ms at 989 TFLOP/s against 0.03 ms at 3.35 TB/s: the tensor
// cores. So the design keeps wgmma issuing: one producer thread keeps the ring's K slices in
// flight with TMA, and the consumer warpgroups run m64 x N x k16 wgmmas on whichever stage
// has landed, each releasing its stage through an mbarrier as soon as its wgmmas have read
// it. The skinny (64 x 8192 x 8192), thin-K (8192 x 128 x 64) and decode-size (M <= 32)
// shapes are bound by bytes instead: B, and at thin K the output's stores. At decode sizes
// (1..32 x 4096 x 4096: 34 MB of B against 0.5 GFLOP) MMAs spent on zero rows cost nothing;
// what counts is enough of B in flight on every SM that holds a CTA.
//
// Tiles (WgTile in tl2_wgmma.cuh). wgmma takes 64 rows and any width that is a multiple of 8:
//   bm, bn in {64, 128}: one consumer warpgroup per 64 rows, m64 x bn wgmmas;
//   bn = 32: the same at width 32 (m64n32k16); bm = bn = 32 takes this orientation, its
//     warpgroup's rows 32..63 are never stored;
//   bm = 32, bn in {64, 128}: the operands swap. The CTA computes C_tile^T = B_tile^T A_tile^T:
//     the tile's N rows are wgmma's M (a warpgroup per 64), A's 32 K-major rows wgmma's B at
//     width 32; B_t ('nk') is K-major, wgmma's natural A layout, B ('kn') MN-major, read with
//     the transpose flag on the shared-memory A operand. The epilogue is transposed: the bias
//     follows the accumulator's rows, and each element is stored on its own, predicated to
//     (M, N).
// TMA zero-fills rows past M, so M = 1..31 needs no case of its own. A block narrower than its
// tile (bm or bn not 32, 64 or 128: the JAX space's sublane 16, its covers of M < 16 or of
// N < 128, any full-dim cover) runs the least tile that holds it (ring_edge), with the CTAs
// stepping by the block's edges: the tile's rows beyond bm read the next block's rows (its
// columns beyond bn the next block's columns) and are never stored, since a row of the
// product depends only on its row of A and a column only on its column of B; the epilogue
// stores within the block's edges and the problem's.
//
// Shared memory: a ring of `stages` stages, each [BM][64] of A then 64 deep of B, 1024-byte
// aligned, 128-byte swizzle (the TMA boxes, the loads producer and the wgmma descriptors
// agree on it):
//   A (M, K) and B_t (N, K) are K-major: one box [rows][64 K];
//   B (K, N) is MN-major (TMA cannot transpose): BN / 64 boxes [64 K][64 N], read by wgmma
//   with the transpose flag; LBO = 8192 (the next 64 columns), SBO = 1024 (the next 8 K);
//   at bn = 32 one box [64 K][32 N] of 64-byte rows with the 64-byte swizzle (SBO = 512).
// Ring depth: the carry and single-K launches of the 64/128 tiles keep CARRY_STAGES = 4; a
// 32-edge tile's stage is small, so its ring holds at least 64 KB of the bn side in flight
// (carry_stages: bm 32 x bn 64 8 stages, 32 x 128 4, bn 32 16, at bm 128 x bn 32 the 11
// that fit in 227 KB); config.carry_stages and config.wgmma_smem_bytes mirror both. A staged
// launch gives its own depth (pipeline_depth, 2..8).
// Producers, chosen per operand: TMA, where it can read the operand (the tensor maps carry
// the true M, N, K, rank 3: inner dim, rows, batch, so every load past an edge, both
// operands' K tails and rows past M of one batch element included, reads zeros); else the
// loads producer: the producer warpgroup's 128 threads fill the operand's part of each stage
// with cp.async of 16, 8 or 4 bytes where the base and the row length allow, else by a
// gather (each run of 8 elements from the one or two 16-byte aligned blocks that hold it,
// shifted into place in registers: 2-byte loads, one at a time, ran 4.7x behind
// tl2_matmul.cu at 512 x 50257 x 768 on the H100), into the same swizzled positions, zeros
// past M, N and K on both operands (0 * garbage can be NaN); `lag` stages later each
// thread waits for its copies, issues
// fence.proxy.async.shared::cta (the generic proxy's writes are not visible to wgmma
// without it) and arrives on the stage's full barrier. The consumer code does not know which
// producer filled a stage. A direct launch with vec_a / vec_b = 0 forces the loads producer
// on an aligned operand: the same stages, the same wgmmas, the same bits.
// Edges: stores are predicated to (M, N), so the gate's guard bands test the kernel's own
// writes.
// Registers: a consumer thread holds N / 2 floats of the stage product, N / 2 of the carry
// (f32) or of `part` plus N / 4 packed bf16 carry registers; with two consumer warpgroups
// the producer warpgroup gives registers up (setmaxnreg) and the consumers take them.
// Staged launches (tl2_wgmma_staged, the port of pipelined.py::_kernel): one f32 sum over
// all of K through a ring of `depth` stages, then one cast, in both families (the f32-carry
// instance), on every tile, the 32-edge ones included. The TPU kernel's grid runs in order
// on one core; on this card a skinny problem's few output tiles leave most of the 132 SMs
// idle, so a staged launch may split K (blockIdx.y): split s sums its run of whole 64-deep
// stages into an f32 partial in a workspace (splits x M x N, allocated by the wrapper), and
// tl2_splitk_reduce_kernel then adds the partials of each element in split order and casts
// once. No atomics: two runs on the same inputs give the same bits.
// Left for later: a split K for the carry launches, a persistent schedule, a TMA store
// staged through shared memory (the swapped tile's scattered stores), overlapping one
// stage's adds with the next stage's wgmmas, and n16 / n8 tiles for blocks of an edge of 16
// or less (they run the width-32 and swapped tiles).

#include <string.h>

#include "tl2_wgmma.cuh"

namespace tl2wg {

TL2_WGMMA_LAUNCHER(launch_wide) {
  TL2_WGMMA_TILE(64, 64, false) TL2_WGMMA_TILE(64, 128, false)
  TL2_WGMMA_TILE(128, 64, false) TL2_WGMMA_TILE(128, 128, false)
  return cudaErrorInvalidValue;
}

}  // namespace tl2wg

namespace {

using namespace tl2wg;

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

// A rank-3 map over a (batch, rows, inner) bf16 array read in boxes [box_rows][box_inner],
// swizzled over rows of box_inner * 2 bytes (128: 128-byte swizzle; 64: 64-byte). Loads past
// any edge read zeros.
bool make_map(CUtensorMap* map, const void* base, int inner, int rows, int batch,
              long long batch_stride, int box_inner, int box_rows) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)batch_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         box_inner == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// The output's rank-3 map for the wide route's TMA stores: (batch, M, N) of bf16 or f32, batch
// stride sc elements, in boxes of 64 rows x 128 bytes, 128-byte swizzle; stores past M or N
// are clipped.
bool make_out_map(CUtensorMap* map, void* c, int batch, int m, int n, long long sc, bool f32) {
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const int elem = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)m, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)n * elem, (cuuint64_t)sc * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(ROW_BYTES / elem), 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = enc(map, type, 3, c, dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

// TMA can read a bf16 operand: a 16-byte aligned base and rows of a multiple of 16 bytes.
bool tma_ok(const void* p, int row) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row % 8 == 0;
}

// TMA can write the wide route's C (bf16 or f32): N % 8 == 0 and a 16-byte aligned base (a
// null c, the route's question before an output exists, counts as aligned: a fresh
// allocation is).
bool tma_c_ok(const void* c, int n) {
  return n % 8 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// The loads producer's copy width in elements: the widest of 8, 4, 2 that the base's
// alignment, the row length (so that no copy crosses a row's end) and `step`, the stride of
// the first element a CTA reads in a row (64 along K; a block's bn along N of 'kn' B), allow,
// else 1: the gather path (16-byte aligned loads into registers, shifted into place).
int load_width(const void* p, int row, int step) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int w = 8; w >= 2; w /= 2)
    if (a % (2 * w) == 0 && row % w == 0 && step % w == 0) return w;
  return 1;
}

// The ring's route: 1 where TMA reads both operands ('wgmma', 'ring'), 2 where the loads
// producer reads one ('wgmma_lsu', 'ring_lsu'), 0 (refused) for an empty problem or a block
// that is not a ring block.
int ring_route_code(int m, int n, int k, int bm, int bn, int rhs_nk, const void* a,
                    const void* b) {
  if (m <= 0 || n <= 0 || k <= 0 || !ring_block_ok(bm, bn)) return 0;
  return tma_ok(a, k) && tma_ok(b, rhs_nk ? k : n) ? 1 : 2;
}

// The wide route, at any bk and batch: 3 where TMA reads both operands and writes C, 4 where
// the loads producer reads one or predicated stores write C, 0 for an empty problem or a
// block the kernel has no instance of (config.KernelConfig.validate).
int wide_route_code(int m, int n, int k, int bm, int bn, int rhs_nk, const void* a,
                    const void* b, const void* c) {
  if (m <= 0 || n <= 0 || k <= 0 || !wide_block_ok(bm, bn)) return 0;
  return tma_ok(a, k) && tma_ok(b, rhs_nk ? k : n) && tma_c_ok(c, n) &&
                 wide_c_grid(m, n, bm, bn)
             ? 3
             : 4;
}

// The staged route: the ring's for a ring block, the wide route's (with a fresh output) for a
// wide one. bk plays no part, since a staged launch sums all of K in f32.
int staged_route_code(int m, int n, int k, int bm, int bn, int rhs_nk, const void* a,
                      const void* b) {
  if (wide_block(bm, bn)) return wide_route_code(m, n, k, bm, bn, rhs_nk, a, b, nullptr);
  return ring_route_code(m, n, k, bm, bn, rhs_nk, a, b);
}

// The same for the carry and single-K launches: bk must be a positive multiple of 32, so
// that a rounding point falls on a stage's start or its middle.
int route_code(int m, int n, int k, int bm, int bn, int bk, int rhs_nk, const void* a,
               const void* b, const void* c) {
  if (bk <= 0 || bk % (KSTAGE / 2)) return 0;
  if (wide_block(bm, bn)) return wide_route_code(m, n, k, bm, bn, rhs_nk, a, b, c);
  return ring_route_code(m, n, k, bm, bn, rhs_nk, a, b);
}

// The TMA maps of the operands TMA reads (false if cuTensorMapEncodeTiled refuses one), in
// boxes of the tile's bm rows of A and bn rows (or columns) of B; the map of an operand the
// loads producer reads stays zero and is never used.
bool make_maps(CUtensorMap* ta, CUtensorMap* tb, const void* a, const void* b, int batch,
               int m, int n, int k, long long sa, long long sb, int bm, int bn, int rhs_nk,
               bool tma_a, bool tma_b) {
  memset(ta, 0, sizeof(*ta));
  memset(tb, 0, sizeof(*tb));
  if (tma_a && !make_map(ta, a, k, m, batch, sa, KSTAGE, bm)) return false;
  if (!tma_b) return true;
  if (rhs_nk) return make_map(tb, b, k, n, batch, sb, KSTAGE, bn);
  return make_map(tb, b, n, k, batch, sb, bn == 32 ? 32 : 64, KSTAGE);
}

// Paired stores need every (row, even column) element of C aligned to two elements.
int pairs_ok(const void* c, int n, int batch, long long sc, int elem_bytes) {
  return n % 2 == 0 && (batch == 1 || sc % 2 == 0) &&
         reinterpret_cast<uintptr_t>(c) % (2 * elem_bytes) == 0;
}

// Launch the instance of the tile of p.blk_m x p.blk_n (ring_edge of each) from its file;
// cudaErrorInvalidValue for a tile it has none of.
cudaError_t launch_tiles(const CUtensorMap& ta, const CUtensorMap& tb, const WgParams& p,
                         int splits, int batch, int rhs_nk, int acc_bf16, cudaStream_t s) {
  const int tm = ring_edge(p.blk_m), tn = ring_edge(p.blk_n);
  const auto fn = tm >= 64 && tn >= 64 ? (p.load_a || p.load_b ? launch_wide_lsu : launch_wide)
                  : tn == 32 ? launch_n32 : launch_swap;
  return fn(tm, tn, ta, tb, p, splits, batch, rhs_nk, acc_bf16, s);
}

// The parameters shared by every launch of a bm x bn block; the caller sets c, bk, the batch
// stride of C, the split, the ring depth and the epilogue.
WgParams base_params(const void* a, const void* b, int m, int n, int k, long long sa,
                     long long sb, int bm, int bn, int rhs_nk, bool tma_a, bool tma_b) {
  WgParams p;
  memset(&p, 0, sizeof(p));
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.sa = sa; p.sb = sb;
  p.m = m; p.n = n; p.k = k;
  p.blk_m = bm; p.blk_n = bn;
  p.load_a = tma_a ? 0 : load_width(a, k, KSTAGE);
  p.load_b = tma_b ? 0 : rhs_nk ? load_width(b, k, KSTAGE) : load_width(b, n, bn);
  return p;
}

// The card's SMs (cudaDevAttrMultiProcessorCount of the current device), read once per
// process; 0 until it can be read.
int card_sms() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0, got = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&got, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      sms = got;
  }
  return sms;
}

// A wide block's launch (routes 3 and 4): TMA reads each operand it can (vec_a / vec_b = 0
// hands it to the loads producer) and stores C where it can (wide_c_grid), else predicated
// stores. A resident or a streamed A by K and A's producer (wide_streams); the bf16
// family's carry only with gk > 1. depth > 0: a staged launch, A streamed through a ring of `depth` stages. The work
// items go to `ctas` persistent CTAs; 0: the rule's count (wide_ctas over the card's SMs),
// which every dispatch takes.
int launch_wide_route(const void* a, const void* b, const void* bias, void* c, int batch,
                      int m, int n, int k, long long sa, long long sb, long long sc, int bm,
                      int bn, int bk, int rhs_nk, int acc_bf16, int act, int raster_nm,
                      bool out_f32, int vec_a, int vec_b, cudaStream_t stream, int depth = 0,
                      int ctas = 0) {
  if (c == nullptr) return (int)cudaErrorInvalidValue;
  const bool tma_a = vec_a && tma_ok(a, k), tma_b = vec_b && tma_ok(b, rhs_nk ? k : n);
  const bool tma_c = tma_c_ok(c, n) && wide_c_grid(m, n, bm, bn);
  CUtensorMap ta, tb, tc;
  memset(&tc, 0, sizeof(tc));
  if (!make_maps(&ta, &tb, a, b, batch, m, n, k, sa, sb, wide_sub_m(bm), WIDE_SUB_N, rhs_nk,
                 tma_a, tma_b) ||
      (tma_c && !make_out_map(&tc, c, batch, m, n, sc, out_f32)))
    return (int)cudaErrorInvalidValue;
  WgParams p = base_params(a, b, m, n, k, sa, sb, bm, bn, rhs_nk, tma_a, tma_b);
  p.bias = static_cast<const float*>(bias);
  p.c = c;
  p.bk = bk;
  p.sc = sc;
  p.wide_stream = depth > 0 || wide_streams(bm, k, tma_a);
  p.stages = depth > 0 ? depth : wide_fit(bm, k, p.wide_stream);
  p.split_steps = cdiv(k, KSTAGE);
  p.act = act; p.raster_nm = raster_nm; p.out_f32 = out_f32;
  p.vec_out = pairs_ok(c, n, batch, sc, out_f32 ? 4 : 2) && bn % 2 == 0;
  p.tma_c = tma_c;
  p.batch = batch;
  if (ctas == 0) ctas = wide_ctas(wide_walk(m, n, bm, bn, batch, raster_nm).items, card_sms());
  return (int)launch_wide_block(ta, tb, tc, p, ctas, rhs_nk, acc_bf16 && cdiv(k, bk) > 1,
                                stream);
}

template <typename OutT>
int launch(const void* a, const void* b, const void* bias, void* c, int batch, int m, int n,
           int k, long long sa, long long sb, long long sc, int bm, int bn, int bk, int rhs_nk,
           int acc_bf16, int act, int raster_nm, int vec_a, int vec_b, void* stream) {
  const int route = route_code(m, n, k, bm, bn, bk, rhs_nk, a, b, c);
  if (batch <= 0 || batch > 65535 || !route) return (int)cudaErrorInvalidValue;
  if (route >= 3)
    return launch_wide_route(a, b, bias, c, batch, m, n, k, sa, sb, sc, bm, bn, bk, rhs_nk,
                             acc_bf16, act, raster_nm, sizeof(OutT) == 4, vec_a, vec_b,
                             static_cast<cudaStream_t>(stream));
  const bool tma_a = vec_a && tma_ok(a, k), tma_b = vec_b && tma_ok(b, rhs_nk ? k : n);
  CUtensorMap ta, tb;
  if (!make_maps(&ta, &tb, a, b, batch, m, n, k, sa, sb, ring_edge(bm), ring_edge(bn), rhs_nk,
                 tma_a, tma_b))
    return (int)cudaErrorInvalidValue;
  if (cdiv(k, bk) == 1) acc_bf16 = 0;  // one interval: the f32 sum is never rounded
  WgParams p = base_params(a, b, m, n, k, sa, sb, bm, bn, rhs_nk, tma_a, tma_b);
  p.bias = static_cast<const float*>(bias);
  p.c = c;
  p.bk = bk;
  p.sc = sc;
  p.stages = carry_stages(bm, bn);
  p.split_steps = cdiv(k, KSTAGE);
  p.act = act; p.raster_nm = raster_nm; p.out_f32 = sizeof(OutT) == 4;
  p.vec_out = pairs_ok(c, n, batch, sc, sizeof(OutT)) && bn % 2 == 0;
  return (int)launch_tiles(ta, tb, p, 1, batch, rhs_nk, acc_bf16,
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

// A staged launch at a wide block: the wide walk's f32 sum over all of K (bk = K), A and B
// streamed through `depth` stages, no split, on `ctas` CTAs (0: the rule's).
int staged_wide(const void* a, const void* b, void* c, int m, int n, int k, int bm, int bn,
                int depth, int rhs_nk, int raster_nm, int out_f32, void* stream, int ctas) {
  if (!wide_block(bm, bn) || !staged_route_code(m, n, k, bm, bn, rhs_nk, a, b) ||
      !wide_staged_ok(bm, depth) || c == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_wide_route(a, b, nullptr, c, 1, m, n, k, (long long)m * k, (long long)n * k,
                           (long long)m * n, bm, bn, k, rhs_nk, 0, ACT_NONE, raster_nm,
                           out_f32 != 0, 1, 1, static_cast<cudaStream_t>(stream), depth, ctas);
}

int staged(const void* a, const void* b, void* c, void* ws, int m, int n, int k, int bm, int bn,
           int depth, int splits, int rhs_nk, int raster_nm, int out_f32, void* stream) {
  if (!staged_route_code(m, n, k, bm, bn, rhs_nk, a, b) || depth < 2 || depth > MAX_STAGES ||
      !splits_ok(k, splits) || c == nullptr)
    return (int)cudaErrorInvalidValue;
  if (wide_block(bm, bn)) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return staged_wide(a, b, c, m, n, k, bm, bn, depth, rhs_nk, raster_nm, out_f32, stream, 0);
  }
  if (smem_bytes(bm, bn, depth) > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (splits > 1 && !reduce_ok(ws, c, (long long)m * n, splits))
    return (int)cudaErrorInvalidValue;
  const bool tma_a = tma_ok(a, k), tma_b = tma_ok(b, rhs_nk ? k : n);
  const long long sa = (long long)m * k, sb = (long long)n * k;
  CUtensorMap ta, tb;
  if (!make_maps(&ta, &tb, a, b, 1, m, n, k, sa, sb, ring_edge(bm), ring_edge(bn), rhs_nk,
                 tma_a, tma_b))
    return (int)cudaErrorInvalidValue;
  WgParams p = base_params(a, b, m, n, k, sa, sb, bm, bn, rhs_nk, tma_a, tma_b);
  p.c = splits > 1 ? ws : c;  // a split writes its f32 partial, the reduction casts
  p.bk = k;  // one interval: the f32-carry instance sums all of K, never rounded
  p.ssplit = splits > 1 ? (long long)m * n : 0;
  p.stages = depth;
  p.split_steps = cdiv(cdiv(k, KSTAGE), splits);
  p.act = ACT_NONE; p.raster_nm = raster_nm;
  p.out_f32 = splits > 1 ? 1 : out_f32;
  p.vec_out = pairs_ok(p.c, n, 1, 0, p.out_f32 ? 4 : 2) && bn % 2 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_tiles(ta, tb, p, splits, 1, rhs_nk, 0, s);
  if (e != cudaSuccess || splits == 1) return (int)e;
  return (int)launch_reduce(static_cast<const float*>(ws), c, (long long)m * n, splits,
                            out_f32, s);
}

}  // namespace

extern "C" {

// C = act(A @ B [+ bias]) with bf16 output on the wgmma ring; the argument list is
// tl2_matmul_bf16out's. vec_a / vec_b: 1 lets TMA read the operand where it can, 0 makes
// the loads producer read it (a direct launch's way to hold the two producers to the same
// bits); acc_bf16 is ignored where gk == 1.
// Returns the cudaError_t of the launch: cudaErrorInvalidValue, before any work, for a
// launch outside the route.
int tl2_wgmma_bf16out(const void* a, const void* b, const void* bias, void* c, int batch, int m,
                      int n, int k, long long sa, long long sb, long long sc, int bm, int bn,
                      int bk, int rhs_nk, int acc_bf16, int act, int raster_nm, int vec_a,
                      int vec_b, void* stream) {
  return launch<bf16>(a, b, bias, c, batch, m, n, k, sa, sb, sc, bm, bn, bk, rhs_nk, acc_bf16,
                      act, raster_nm, vec_a, vec_b, stream);
}

// The same with f32 output.
int tl2_wgmma_f32out(const void* a, const void* b, const void* bias, void* c, int batch, int m,
                     int n, int k, long long sa, long long sb, long long sc, int bm, int bn,
                     int bk, int rhs_nk, int acc_bf16, int act, int raster_nm, int vec_a,
                     int vec_b, void* stream) {
  return launch<float>(a, b, bias, c, batch, m, n, k, sa, sb, sc, bm, bn, bk, rhs_nk, acc_bf16,
                       act, raster_nm, vec_a, vec_b, stream);
}

// C = A @ B (rhs_nk = 0) or A @ B_t^T (rhs_nk = 1) through a `depth`-stage ring, f32 over all
// of K, cast once to f32 (out_f32 = 1) or bf16: the staged kernel (pipelined.py::_kernel) on
// the staged route (tl2_staged_route), on any ring block, or on the wide walk for a wide
// block (A streamed, no split). With splits > 1 (ring blocks), split s sums its run of
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

// The ring depth of a carry or single-K launch on a (bm, bn) tile; mirrors
// config.carry_stages.
int tl2_wgmma_carry_stages(int bm, int bn) { return carry_stages(bm, bn); }

// Shared memory of one wide CTA for a bm-row block at depth k with a ring of `stages`, A
// resident (streamed = 0) or streamed (1); mirrors config.wide_smem_bytes.
int tl2_wgmma_wide_smem_bytes(int bm, int k, int stages, int streamed) {
  return wide_smem_bytes(bm, k, stages, streamed != 0);
}

// Whether a bm-row block's A must stream through the ring at depth k (1: its strip does not
// fit) or may stay resident (0); mirrors config.wide_streamed. At thin K a launch streams A
// where TMA reads it (wide_streams).
int tl2_wgmma_wide_streamed(int bm, int k) { return wide_streamed(bm, k); }

// The wide route's ring depth for a bm-row block at depth k; mirrors config.wide_stages.
int tl2_wgmma_wide_stages(int bm, int k) { return wide_stages(bm, k); }

// The producer a launch takes: 1 TMA for both operands ('wgmma'), 2 the loads producer for
// one or both ('wgmma_lsu'), 3 a wide block with TMA for both operands and C ('wgmma_wide'),
// 4 a wide block with the loads producer or predicated stores ('wgmma_wide_lsu'), 0 refused;
// mirrors ops/matmul.py::launch_route. c: the output (null: a fresh allocation, aligned).
int tl2_wgmma_route(int m, int n, int k, int bm, int bn, int bk, int rhs_nk, const void* a,
                    const void* b, const void* c) {
  return route_code(m, n, k, bm, bn, bk, rhs_nk, a, b, c);
}

// The CTAs a wide launch of a bm x bn block over batch x M x N takes by the rule: one per
// SM of this card, or one per work item where there are fewer; mirrors config.wide_ctas.
// 0 for a block that is not wide or an empty problem.
int tl2_wgmma_wide_ctas(int m, int n, int bm, int bn, int batch) {
  if (m <= 0 || n <= 0 || batch <= 0 || !wide_block_ok(bm, bn)) return 0;
  return wide_ctas(wide_walk(m, n, bm, bn, batch, 0).items, card_sms());
}

// A wide launch on `ctas` CTAs instead of the rule's (1 up to its work items), to show that
// the output's bits do not depend on the count: the argument list of tl2_wgmma_bf16out,
// then out_f32 (the output's dtype), depth and ctas. depth > 0 makes it tl2_wgmma_staged's
// wide launch at that (clamped) depth, which ignores bias, bk, acc_bf16, act and vec_a /
// vec_b. No route calls it; chip_smoke.py does. Returns the cudaError_t of the launch.
int tl2_wgmma_wide_witness(const void* a, const void* b, const void* bias, void* c, int batch,
                           int m, int n, int k, long long sa, long long sb, long long sc,
                           int bm, int bn, int bk, int rhs_nk, int acc_bf16, int act,
                           int raster_nm, int vec_a, int vec_b, void* stream, int out_f32,
                           int depth, int ctas) {
  if (ctas < 1) return (int)cudaErrorInvalidValue;
  if (depth > 0)
    return batch == 1 ? staged_wide(a, b, c, m, n, k, bm, bn, depth, rhs_nk, raster_nm,
                                    out_f32, stream, ctas)
                      : (int)cudaErrorInvalidValue;
  if (batch <= 0 || batch > 65535 || route_code(m, n, k, bm, bn, bk, rhs_nk, a, b, c) < 3)
    return (int)cudaErrorInvalidValue;
  return launch_wide_route(a, b, bias, c, batch, m, n, k, sa, sb, sc, bm, bn, bk, rhs_nk,
                           acc_bf16, act, raster_nm, out_f32 != 0, vec_a, vec_b,
                           static_cast<cudaStream_t>(stream), 0, ctas);
}

// The same for a staged launch (tl2_wgmma_staged): 1 'ring', 2 'ring_lsu', for a wide block
// 3 'wgmma_wide', 4 'wgmma_wide_lsu', 0 refused; mirrors ops/pipelined.py::staged_route.
int tl2_staged_route(int m, int n, int k, int bm, int bn, int rhs_nk, const void* a,
                     const void* b) {
  return staged_route_code(m, n, k, bm, bn, rhs_nk, a, b);
}

}  // extern "C"
