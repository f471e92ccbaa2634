// tl2_staged.cu — the staged (kStage) GEMM kernel of tpul2_torch, hand-written for Hopper
// (sm_90a): mma.sync fed by a cp.async ring.
//
// Off every route: since the 32-edge staged tiles moved onto tl2_wgmma.cu's ring (with its
// split K and its loads producer), nothing in the package launches this kernel. It is kept
// as a direct-launch reference: chip_smoke.py times it beside the ring on the same config.
// It was the port of tpul2/ops/pipelined.py::_kernel for the 32-edge tiles: one output tile
// per CTA, the K loop inside the CTA over a `depth`-slot circular buffer that asynchronous
// copies keep filled ahead of the MMAs.
//
// What it computes: C = A @ B (rhs_nk = 0, B is (K, N)) or C = A @ B_t^T (rhs_nk = 1, B_t is
// (N, K)), bf16 inputs. The sum runs in f32 over the WHOLE K, whatever the config's acc_dtype
// (pipelined.py:69-91 carries an f32 value and casts once), then one cast to bf16 or f32 out.
// No bias, no activation, no edges: the wrapper guarantees M % BM == 0, N % BN == 0 and
// K % 32 == 0, and 16-byte aligned operands, so no load or store is predicated.
//
// What bounds it on the H100: at the skinny serving shape 64 x 8192 x 8192 the work is
// 8.6 GFLOP (0.009 ms at 989 TFLOP/s) against 1 MB of A and 134 MB of B (0.040 ms at
// 3.35 TB/s), so device-memory bytes bound it, and the way to that bound is to keep enough
// loads in flight to cover the memory latency on every SM. tl2_matmul.cu has one synchronous
// stage, so every load latency is exposed (5% of the bytes roofline there).
//
// Design (simple first): the CTA tile and warp tiling are tl2_matmul.cu's (BM, BN in
// {32, 64, 128}, each warp a 32 x 32 sub-tile of mma.sync m16n8k16). Shared memory is a ring
// of `depth` slots, each holding one K slice of 32: A as [BM][32 + 8] and B_t as [BN][32 + 8]
// (K contiguous, fragments read with 32-bit loads as in tl2_matmul.cu), or B as [32][BN + 8]
// (N contiguous, since cp.async cannot transpose; fragments read with ldmatrix .trans). Each
// slot is filled by 16-byte cp.async.cg copies committed as one group. The prologue issues
// slices 0 .. depth-2; step s waits until at most depth-2 groups are pending (slice s has
// landed), synchronises the CTA (so every thread has finished reading the slot that slice
// s-1 occupied), refills that slot with slice s + depth - 1, and runs the slice's MMAs. So
// depth-1 slices are in flight during every step's MMAs. The depth is a runtime value (the
// wait_group immediate comes from a switch), so 10 instances cover the 5 tiles with a
// 32 edge x 2 layouts.
//
// Precision: each slice's two k16 MMAs accumulate into a fresh register set, which is then
// added to the f32 total with an ordinary rounded add. Chaining all K/16 MMAs through the
// tensor cores' accumulator instead gives some 25x cuBLAS's f32 error at K = 8192 (max |err|
// against an f64 product; chip_smoke.py phase 2b prints both), enough to break the f32
// tolerance 1e-5 |C| + 1e-5 sqrt(K) on results near zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KSTEP = 32;           // K depth of one ring slot
constexpr int KPAD = 8;             // row padding in bf16 elements (keeps rows 16-byte aligned)
constexpr int LDS = KSTEP + KPAD;   // row length of a [rows][K] tile: 80 bytes
constexpr int WARP_M = 32;
constexpr int WARP_N = 32;
constexpr int MI = WARP_M / 16;     // m16 MMA tiles per warp
constexpr int NI = WARP_N / 8;      // n8 MMA tiles per warp
constexpr int MAX_DEPTH = 8;

struct StagedParams {
  const bf16* a;   // (M, K)
  const bf16* b;   // (K, N), or (N, K) when rhs_nk
  void* c;         // (M, N), bf16 or f32
  int m, n, k, depth, raster_nm, out_f32;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until at most `pending` committed groups are still in flight (the immediate operand
// of wait_group must be a constant, so the runtime depth picks one).
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The B fragment of one m16n8k16 MMA from a [K][N] tile: rows k0..k0+15 at columns n0..n0+7,
// transposed on the way into registers. Threads 0-15 give the 16 row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN>
struct StagedTile {
  static constexpr int WARPS_N = BN / WARP_N;
  static constexpr int THREADS = (BM / WARP_M) * WARPS_N * 32;
  static constexpr int LDB = BN + KPAD;          // row length of a [K][BN] tile
  static constexpr int SLOT = (BM + BN) * LDS;   // bf16 elements of one ring slot
  // a [KSTEP][BN + KPAD] B tile fits in the [BN][LDS] room of a slot for every BN >= 32
  static_assert(KSTEP * LDB <= BN * LDS, "kn B tile does not fit its slot");
};

// Issue the copies of K slice [k0, k0 + KSTEP) of the CTA's A rows and B columns into one
// slot (no commit).
template <int BM, int BN, bool RHS_NK>
__device__ __forceinline__ void load_slice(const StagedParams& p, int m0, int n0, int k0,
                                           bf16* As, bf16* Bs) {
  using T = StagedTile<BM, BN>;
  constexpr int CHUNKS = KSTEP / 8;  // 16-byte chunks in one K row of a slice
  for (int c = threadIdx.x; c < BM * CHUNKS; c += T::THREADS) {
    const int r = c / CHUNKS, kc = (c % CHUNKS) * 8;
    cp_async16(As + r * LDS + kc, p.a + (long long)(m0 + r) * p.k + k0 + kc);
  }
  if (RHS_NK) {
    for (int c = threadIdx.x; c < BN * CHUNKS; c += T::THREADS) {
      const int r = c / CHUNKS, kc = (c % CHUNKS) * 8;
      cp_async16(Bs + r * LDS + kc, p.b + (long long)(n0 + r) * p.k + k0 + kc);
    }
  } else {
    constexpr int NCH = BN / 8;  // 16-byte chunks in one N row of a slice
    for (int c = threadIdx.x; c < KSTEP * NCH; c += T::THREADS) {
      const int kr = c / NCH, nc = (c % NCH) * 8;
      cp_async16(Bs + kr * T::LDB + nc, p.b + (long long)(k0 + kr) * p.n + n0 + nc);
    }
  }
}

template <int BM, int BN, bool RHS_NK>
__global__ void __launch_bounds__(StagedTile<BM, BN>::THREADS) tl2_staged_kernel(StagedParams p) {
  using T = StagedTile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int tiles_m = p.m / BM, tiles_n = p.n / BN;
  const int tile = blockIdx.x;
  const int tm = p.raster_nm ? tile % tiles_m : tile / tiles_n;
  const int tn = p.raster_nm ? tile / tiles_m : tile % tiles_n;
  const int m0 = tm * BM, n0 = tn * BN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / T::WARPS_N) * WARP_M, wn = (warp % T::WARPS_N) * WARP_N;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const int steps = p.k / KSTEP;
  const int depth = p.depth;

  // prologue: slices 0 .. depth-2 into slots 0 .. depth-2, one group each
  for (int s = 0; s < depth - 1; ++s) {
    if (s < steps) {
      bf16* slot = ring + s * T::SLOT;
      load_slice<BM, BN, RHS_NK>(p, m0, n0, s * KSTEP, slot, slot + BM * LDS);
    }
    cp_async_commit();
  }

  int read_slot = 0, write_slot = depth - 1;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_pending(depth - 2);  // slice s has landed (this thread's copies)
    __syncthreads();                   // ... everyone's, and slot write_slot is free again
    const int nxt = s + depth - 1;
    if (nxt < steps) {
      bf16* slot = ring + write_slot * T::SLOT;
      load_slice<BM, BN, RHS_NK>(p, m0, n0, nxt * KSTEP, slot, slot + BM * LDS);
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform

    const bf16* As = ring + read_slot * T::SLOT;
    const bf16* Bs = As + BM * LDS;
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEP; kk += 16) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const bf16* a = As + (wm + i * 16 + g) * LDS + kk + t * 2;
        af[i][0] = ld32(a);
        af[i][1] = ld32(a + 8 * LDS);
        af[i][2] = ld32(a + 8);
        af[i][3] = ld32(a + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        if (RHS_NK) {
          const bf16* b = Bs + (wn + j * 8 + g) * LDS + kk + t * 2;
          bfr[j][0] = ld32(b);
          bfr[j][1] = ld32(b + 8);
        } else {
          ldmatrix_x2_trans(bfr[j], Bs + (kk + (lane & 15)) * T::LDB + wn + j * 8);
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(part[i][j], af[i], bfr[j]);
    }
    // the slice's sum joins the f32 total with a rounded add (see the note on precision)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
    read_slot = read_slot + 1 == depth ? 0 : read_slot + 1;
    write_slot = write_slot + 1 == depth ? 0 : write_slot + 1;
  }
  cp_async_wait<0>();  // nothing may be in flight when the CTA exits

  // epilogue: one cast of the f32 sums; each thread owns column pairs (t*2, t*2+1)
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + h * 8;
        const int col = n0 + wn + j * 8 + t * 2;
        const long long off = (long long)row * p.n + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (p.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.c) + off) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.c) + off) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
}

int smem_bytes(int bm, int bn, int depth) { return depth * (bm + bn) * LDS * (int)sizeof(bf16); }

template <int BM, int BN, bool RHS_NK>
cudaError_t launch_tile(const StagedParams& p, cudaStream_t stream) {
  using T = StagedTile<BM, BN>;
  const int smem = smem_bytes(BM, BN, p.depth);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tl2_staged_kernel<BM, BN, RHS_NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.m / BM) * (p.n / BN));
  tl2_staged_kernel<BM, BN, RHS_NK><<<grid, T::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_layout(const StagedParams& p, int rhs_nk, cudaStream_t stream) {
  return rhs_nk ? launch_tile<BM, BN, true>(p, stream) : launch_tile<BM, BN, false>(p, stream);
}

}  // namespace

extern "C" {

// C = A @ B (rhs_nk = 0) or A @ B_t^T (rhs_nk = 1) through the depth-slot ring, f32 over all
// of K, written as f32 (out_f32 = 1) or bf16. Needs M % bm == 0, N % bn == 0, K % 32 == 0,
// 2 <= depth <= 8 and 16-byte aligned pointers. Returns the cudaError_t of the launch (cudaErrorInvalidValue,
// before any work, for what the kernel does not take).
int tl2_staged(const void* a, const void* b, void* c, int m, int n, int k, int bm, int bn,
               int depth, int rhs_nk, int raster_nm, int out_f32, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || m % bm || n % bn || k % KSTEP ||
      depth < 2 || depth > MAX_DEPTH)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16)
    return (int)cudaErrorInvalidValue;
  StagedParams p;
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.c = c;
  p.m = m; p.n = n; p.k = k; p.depth = depth;
  p.raster_nm = raster_nm; p.out_f32 = out_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TL2_STAGED_TILE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return (int)launch_layout<BM_, BN_>(p, rhs_nk, s);
  TL2_STAGED_TILE(32, 32) TL2_STAGED_TILE(32, 64) TL2_STAGED_TILE(32, 128)
  TL2_STAGED_TILE(64, 32) TL2_STAGED_TILE(128, 32)
#undef TL2_STAGED_TILE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
