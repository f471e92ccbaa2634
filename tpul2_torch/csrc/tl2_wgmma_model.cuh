// tl2_wgmma_model.cuh — the block rules, the shared-memory models and ring depths of the ring
// and of the wide route (config.py mirrors each). Plain C++ with no CUDA header, so that a host
// compiler builds it too: tests/test_torch_wide_carry.py and tests/test_torch_jax_space.py
// compile it with g++ and hold config.py's model to it on a machine with no card.
// tl2_wgmma.cuh includes it.

#pragma once

#ifdef __CUDACC__
#define TL2_HD __host__ __device__
#else
#define TL2_HD
#endif

namespace tl2wg {

constexpr int KSTAGE = 64;              // K depth of one ring stage: one 128-byte bf16 row
constexpr int ROW_BYTES = KSTAGE * 2;   // the 128-byte swizzle span
// Shared memory one block may use on the H100 (227 KB)
constexpr int SMEM_LIMIT = 232448;

// Ring depth of the carry and single-K launches on the 64/128 tiles, from H100 runs at
// 4096^3 (128 x 128, bk 1024): 3 stages ran 5% slower than 4, and 5 or 6 no faster
// (PERF.md, the multi-K redesign's findings). A staged launch gives its own depth,
// 2..MAX_STAGES.
constexpr int CARRY_STAGES = 4;
constexpr int MAX_STAGES = 8;
// The carry and single-K launches of a 32-edge tile size their ring by bytes in flight:
// at least RING_BYTES of the bn side (B, the operand a decode-size product streams) in
// flight per CTA, CARRY_STAGES at least, MAX_RING at most, within SMEM_LIMIT
// (carry_stages below; config.carry_stages mirrors it).
constexpr int RING_BYTES = 65536;
constexpr int MAX_RING = 16;

TL2_HD constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- the ring's blocks ----

// A ring block has both edges in 1..RING_MAX (config.is_wide is false). It runs the tile
// of ring_edge(bm) x ring_edge(bn), the least of 32, 64, 128 that holds each edge; the
// CTAs step by the block's edges, and the tile's rows and columns beyond them are computed
// and never stored (a row of the product depends only on its row of A, a column only on its
// column of B).
constexpr int RING_MAX = 128;
inline int ring_edge(int e) { return e <= 32 ? 32 : e <= 64 ? 64 : 128; }
inline bool ring_block_ok(int bm, int bn) {
  return bm >= 1 && bn >= 1 && bm <= RING_MAX && bn <= RING_MAX;
}

// 1024 bytes of slack to align the ring to the swizzle's 1024-byte period, the ring of the
// block's tile, then a full and an empty mbarrier per stage (config.wgmma_smem_bytes).
inline int smem_bytes(int bm, int bn, int stages) {
  return 1024 + stages * (ring_edge(bm) + ring_edge(bn)) * ROW_BYTES + 2 * stages * 8;
}

// The ring depth of a carry or single-K launch of the block's tile (config.carry_stages).
inline int carry_stages(int bm, int bn) {
  const int tm = ring_edge(bm), tn = ring_edge(bn);
  if (tm >= 64 && tn >= 64) return CARRY_STAGES;
  const int want = cdiv(RING_BYTES, tn * ROW_BYTES);
  const int fit = (SMEM_LIMIT - 1024) / ((tm + tn) * ROW_BYTES + 16);
  const int d = want > CARRY_STAGES ? want : CARRY_STAGES;
  return d < MAX_RING ? (d < fit ? d : fit) : (MAX_RING < fit ? MAX_RING : fit);
}

// ---- the wide blocks ----

// The wide blocks (tl2_wgmma_wide.cu; config.py mirrors each): an edge above RING_MAX, bm in
// 1..WIDE_BM_MAX and bn in 1..WIDE_BN_MAX, any value (the JAX space's edges, its sublane 16,
// its full-dim covers of any M up to 4096 and any N up to 32768). A CTA walks its block in
// sub-tiles of wide_sub_m rows x WIDE_SUB_N columns, the last of each clipped at the block's
// edge; at bm <= 32 the walk is swapped (the sub-tile's 128 columns are wgmma's M, the
// block's rows its width of 32). Its ring is WIDE_STAGES deep where shared memory allows,
// WIDE_MIN_STAGES at least (a staged launch: its depth, up to MAX_STAGES); each consumer
// warpgroup of the plain walk stages C in WIDE_C_BYTES (64 rows x 128 columns of f32).
constexpr int WIDE_SUB_N = 128;
constexpr int WIDE_BM_MAX = 16384;
constexpr int WIDE_BN_MAX = 32768;
constexpr int WIDE_STAGES = 4;
constexpr int WIDE_MIN_STAGES = 2;
constexpr int WIDE_C_BYTES = 64 * WIDE_SUB_N * 4;
constexpr int WIDE_SWAP_M = 32;  // the swapped walk's width: the block's rows, 32 at most

// A block the wide route takes (config.is_wide and KernelConfig._check_wide).
inline bool wide_block(int bm, int bn) { return bm > RING_MAX || bn > RING_MAX; }
inline bool wide_block_ok(int bm, int bn) {
  return wide_block(bm, bn) && bm >= 1 && bn >= 1 && bm <= WIDE_BM_MAX && bn <= WIDE_BN_MAX;
}

// Rows of a wide block's sub-tile and A strip (config.wide_sub_m): WIDE_SWAP_M at bm <= 32
// (the swapped walk), 64 at bm <= 64, else 128.
TL2_HD inline int wide_sub_m(int bm) {
  return bm <= WIDE_SWAP_M ? WIDE_SWAP_M : bm <= 64 ? 64 : 128;
}
TL2_HD inline bool wide_swapped(int bm) { return bm <= WIDE_SWAP_M; }

// Shared memory of a wide CTA at depth K (config.wide_smem_bytes): the alignment slack,
// `stages` ring stages (a B box of WIDE_SUB_N rows, and with a streamed A the strip's A box
// beside it), the resident A strip (cdiv(K, 64) boxes; none when A streams), the C staging of
// each consumer warpgroup of the plain walk (none in the swapped walk, whose stores are
// predicated), a full and an empty mbarrier per stage and for the strip.
inline int wide_smem_bytes(int bm, int k, int stages, bool streamed) {
  const int sm = wide_sub_m(bm);
  const int stage = (WIDE_SUB_N + (streamed ? sm : 0)) * ROW_BYTES;
  const int strip = streamed ? 0 : cdiv(k, KSTAGE) * sm * ROW_BYTES;
  const int staging = wide_swapped(bm) ? 0 : sm / 64 * WIDE_C_BYTES;
  return 1024 + stages * stage + strip + staging + (2 * stages + 2) * 8;
}

// The ring depth that fits beside the rest in SMEM_LIMIT, at most WIDE_STAGES (0 where none).
inline int wide_fit(int bm, int k, bool streamed) {
  const int free = SMEM_LIMIT - wide_smem_bytes(bm, k, 0, streamed);
  const int stage = (WIDE_SUB_N + (streamed ? wide_sub_m(bm) : 0)) * ROW_BYTES + 16;
  const int fit = free < 0 ? 0 : free / stage;
  return fit < WIDE_STAGES ? fit : WIDE_STAGES;
}

// A streams through the ring where the resident strip of all of K leaves fewer than
// WIDE_MIN_STAGES stages (K > 512 at 128-row strips, K > 1280 at 64-row ones), and always
// in the swapped walk (config.wide_streamed).
inline bool wide_streamed(int bm, int k) {
  return wide_swapped(bm) || wide_fit(bm, k, false) < WIDE_MIN_STAGES;
}

// A launch's A mode (config.wide_streams): streamed where the strip does not fit
// (wide_streamed), and also at K <= WIDE_THIN_K where TMA reads A. There a strip is one or
// two 64-deep boxes: keeping it saves little L2 traffic, while each strip of a CTA's run
// costs a load and a barrier round trip before its first wgmma, and a run at thin K holds
// many strips; streamed, the box rides in the ring beside B. Where the loads producer
// gathers A, its copies per item cost more than the strip's reloads, so A stays resident.
constexpr int WIDE_THIN_K = 128;
inline bool wide_streams(int bm, int k, bool tma_a) {
  return wide_streamed(bm, k) || (tma_a && k <= WIDE_THIN_K);
}

// The ring's depth at depth K in the mode K takes (config.wide_stages).
inline int wide_stages(int bm, int k) { return wide_fit(bm, k, wide_streamed(bm, k)); }

// A staged wide launch (the port of pipelined.py::_kernel at a wide block): A and B stream
// through a ring of `depth` stages, as the JAX kernel's DMA slots hold both operands; it
// fits where that ring and the C staging do (config.KernelConfig.smem_bytes).
inline bool wide_staged_ok(int bm, int depth) {
  return depth >= 2 && depth <= MAX_STAGES && wide_smem_bytes(bm, 0, depth, true) <= SMEM_LIMIT;
}

// TMA stores of a wide block's C clip only at the problem's edges (the output's map), so
// they serve a block whose every edge lies on the sub-tile grid or past the problem's edge
// (one block along that dim); the swapped walk's stores are predicated
// (ops.matmul.launch_route's wide_c_grid).
inline bool wide_c_grid(int m, int n, int bm, int bn) {
  return !wide_swapped(bm) && (bm % wide_sub_m(bm) == 0 || bm >= m) &&
         (bn % WIDE_SUB_N == 0 || bn >= n);
}

// ---- the wide walk's schedule (config.wide_walk / wide_item / wide_first / wide_strips /
// wide_ctas; tl2_wgmma_wide.cuh's for_each_strip walks a CTA's run with wide_segment) ----

// A work item is one sub-tile of one block: (batch element, block, strip, column), in that
// order, the column fastest; blocks in the launch's raster (raster_nm: down the columns of
// blocks first). Every block has `strips` x `cols` items: its strips of wide_sub_m rows and
// columns of WIDE_SUB_N, the block's edge (or the problem's, where it is nearer) rounded up
// to them. An edge block's items past the problem's edge are empty: no CTA computes them.
struct WideWalk {
  int m, n, bm, bn, raster_nm, sm;
  int blocks_m, blocks_n, strips, cols;
  long long items;  // batch x blocks x strips x cols
};

TL2_HD inline WideWalk wide_walk(int m, int n, int bm, int bn, int batch, int raster_nm) {
  WideWalk w;
  w.m = m; w.n = n; w.bm = bm; w.bn = bn; w.raster_nm = raster_nm;
  w.sm = wide_sub_m(bm);
  w.blocks_m = cdiv(m, bm);
  w.blocks_n = cdiv(n, bn);
  w.strips = cdiv(bm < m ? bm : m, w.sm);
  w.cols = cdiv(bn < n ? bn : n, WIDE_SUB_N);
  w.items = (long long)batch * w.blocks_m * w.blocks_n * w.strips * w.cols;
  return w;
}

// An item's place: its batch element z, block, strip and column; its block's first row and
// column, stored edges (m_lim, n_lim: the block's edge or the problem's, the nearer) and
// non-empty strips and columns; and whether the item is empty.
struct WideItem {
  int z, block, strip, col;
  int m_blk, n_blk, m_lim, n_lim, strips, cols;
  bool empty;
};

// Item i's place (in 32-bit arithmetic where the walk's items allow it).
TL2_HD inline WideItem wide_item(const WideWalk& w, long long i) {
  WideItem t;
  const int per_block = w.strips * w.cols;
  const int blocks = w.blocks_m * w.blocks_n;
  int rest;
  if (w.items <= 0x7fffffff) {
    const int bi = (int)i / per_block;  // batch element and block
    rest = (int)i - bi * per_block;
    t.z = bi / blocks;
    t.block = bi - t.z * blocks;
  } else {
    const long long bi = i / per_block;
    rest = (int)(i - bi * per_block);
    t.z = (int)(bi / blocks);
    t.block = (int)(bi - (long long)t.z * blocks);
  }
  t.strip = rest / w.cols;
  t.col = rest - t.strip * w.cols;
  const int bm_i = w.raster_nm ? t.block % w.blocks_m : t.block / w.blocks_n;
  const int bn_i = w.raster_nm ? t.block / w.blocks_m : t.block % w.blocks_n;
  t.m_blk = bm_i * w.bm;
  t.n_blk = bn_i * w.bn;
  t.m_lim = w.m < t.m_blk + w.bm ? w.m : t.m_blk + w.bm;
  t.n_lim = w.n < t.n_blk + w.bn ? w.n : t.n_blk + w.bn;
  t.strips = cdiv(t.m_lim - t.m_blk, w.sm);
  t.cols = cdiv(t.n_lim - t.n_blk, WIDE_SUB_N);
  t.empty = t.strip >= t.strips || t.col >= t.cols;
  return t;
}

// The first item of CTA c of `ctas`: floor(c * items / ctas), computed without the product
// (which a witness launch's CTA count could carry past 64 bits). CTA c walks the run
// [wide_first(c), wide_first(c + 1)): runs differ by at most one item.
TL2_HD inline long long wide_first(long long items, int ctas, int c) {
  const long long q = items / ctas, r = items % ctas;
  return c * q + (long long)c * r / ctas;
}

// A run is walked one strip at a time. The segment that starts at item i of the run [i, last)
// holds i's strip's items up to the strip's last column or the run's end, whichever comes
// first. t: item i's place; returns the item after the segment; end: the segment's end
// column, clipped to the strip's non-empty columns (end <= t.col: nothing to compute).
TL2_HD inline long long wide_segment(const WideWalk& w, long long i, long long last,
                                     WideItem& t, int& end) {
  t = wide_item(w, i);
  const long long left = last - i;
  const int stop = left < w.cols - t.col ? t.col + (int)left : w.cols;
  end = t.empty ? t.col : stop < t.cols ? stop : t.cols;
  return i + (stop - t.col);
}

// The CTAs of a wide launch: one per SM (the kernel runs one CTA an SM), or one per item
// where there are fewer items.
inline int wide_ctas(long long items, int sms) {
  return items < sms ? (int)items : sms;
}

}  // namespace tl2wg
