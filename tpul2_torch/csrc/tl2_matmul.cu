// tl2_matmul.cu — the tuned-GEMM kernel of tpul2_torch, hand-written for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels with one CUDA kernel:
//   tpul2/ops/matmul.py::_kernel_multi_k     (K carry across grid steps, gk > 1)
//   tpul2/ops/matmul.py::_kernel_single_k    (whole K in one block, gk == 1)
//   tpul2/ops/batched.py::_bmm_kernel        (batched, K carry)
//   tpul2/ops/batched.py::_bmm_kernel_single_k
// The K-loop length (1 or many bk intervals) is a runtime value and the batch index is
// blockIdx.z, so the four are one launch path. Since tl2_wgmma.cu, this body serves the two
// K-carry kernels only off the wgmma route (ops/matmul.py::multi_k_route): 32-edge tiles
// (the skinny heuristic's 32 x 64), bk not a multiple of 64, and operands TMA cannot read
// (unaligned bases, K % 8 or, for 'kn', N % 8 != 0). It serves every gk == 1 launch.
//
// What it computes, per output tile, for C = act(A @ B [+ bias]) cast to the output type:
//   for each K interval of length bk (the config's rounding interval):
//     part = sum over the interval of A*B in f32: each 32-deep slice on the tensor cores
//            (mma.sync m16n8k16, two k16 MMAs into fresh registers), then added to part;
//     gk > 1:  acc = round_to_acc_dtype(acc + part)   -- after EVERY interval, first and last
//     gk == 1: acc = part                             -- no rounding at all
//   then + bias (f32), then the activation (gelu is the tanh approximation), then the cast.
// This is the JAX kernels' carry exactly (matmul.py:110-116 and :146): in the bf16
// accumulator family the rounding points are part of the result.
// Precision: chaining a whole long interval's MMAs through the tensor cores' accumulator
// gives some 25x cuBLAS's f32 error at K = 8192 (max |err| against an f64 product), enough
// to break the f32 tolerance 1e-5 |C| + 1e-5 sqrt(K) on results near zero; the per-slice
// rounded add keeps every bk inside it (chip_smoke.py phase 2 holds bk = K = 8192 to it).
//
// Edges: every global load is predicated and zero-filled past M, N and K, for both operands
// (0 * garbage can be NaN), and every store is predicated to (M, N). So edge='pad' and
// edge='mask' are the same launch, no padding copy is made, and the kernel writes straight
// into caller memory (the correctness gate's guard bands test that).
// RHS layouts: rhs_nk=0 reads B (K, N); rhs_nk=1 reads B_t (N, K) with no transpose copy.
//
// Design (simple first): a CTA owns a BM x BN output tile, BM, BN in {32, 64, 128}; each warp
// owns a 32 x 32 sub-tile (2 x 4 m16n8 MMA tiles). One shared-memory stage of KSTEP = 32
// along K holds the A tile as [BM][K] and the B tile as [BN][K] (K contiguous, rows padded
// by 8 bf16 so the 32-bit fragment loads are free of bank conflicts); threads load it with
// 16-byte vector loads where the shape allows, then synchronise and run the MMAs.
//
// What bounds it on the H100: at 4096^3 the product is 137 GFLOP against ~100 MB of
// operand/output traffic, far above the card's ~295 FLOP/byte ridge, so the tensor cores
// should bound it; the skinny 64x8192x8192 and thin-K 8192x128x64 shapes are below the ridge
// and bound by bytes. This design reaches neither: with one synchronous stage every load
// latency is exposed, and mma.sync runs at a fraction of the wgmma rate. The TMA ring and
// wgmma warpgroups are tl2_wgmma.cu, which takes 4096^3 off this body; the skinny and
// thin-K shapes still run here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KSTEP = 32;           // K depth of one shared-memory stage; divides every bk
constexpr int KPAD = 8;             // row padding in bf16 elements
constexpr int LDS = KSTEP + KPAD;   // shared-memory row length: 80 bytes
constexpr int WARP_M = 32;
constexpr int WARP_N = 32;
constexpr int MI = WARP_M / 16;     // m16 MMA tiles per warp
constexpr int NI = WARP_N / 8;      // n8 MMA tiles per warp

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_TANH = 4 };

struct Params {
  const bf16* a;       // (batch, M, K)
  const bf16* b;       // (batch, K, N) or (batch, N, K) when rhs_nk
  const float* bias;   // (N,) or null
  void* c;             // (batch, M, N), row stride N
  int m, n, k, bk;
  long long sa, sb, sc;  // batch strides in elements
  int rhs_nk, acc_bf16, act, raster_nm, vec_a, vec_b;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [r0, r0 + ROWS) x [k0, k0 + KSTEP) of a row-major (rows, K) matrix into
// dst[ROWS][LDS], zero-filling outside (rows, K).
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_k(const bf16* src, int rows, int K, int r0, int k0,
                                            bool vec, bf16* dst) {
  constexpr int CHUNKS = KSTEP / 8;
  const bf16 zero = __float2bfloat16(0.0f);
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, kc = (c % CHUNKS) * 8;
    const int gr = r0 + r, gk = k0 + kc;
    bf16* d = dst + r * LDS + kc;
    const bf16* s = src + (long long)gr * K + gk;
    if (vec && gr < rows && gk + 8 <= K) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = (gr < rows && gk + i < K) ? s[i] : zero;
    }
  }
}

// Copy [k0, k0 + KSTEP) x [n0, n0 + BN) of a row-major (K, N) matrix into dst[BN][LDS]
// (transposed, K contiguous), zero-filling outside (K, N).
template <int BN, int THREADS>
__device__ __forceinline__ void load_kn(const bf16* src, int K, int N, int k0, int n0,
                                        bool vec, bf16* dst) {
  constexpr int CHUNKS = BN / 8;
  const bf16 zero = __float2bfloat16(0.0f);
  for (int c = threadIdx.x; c < KSTEP * CHUNKS; c += THREADS) {
    const int kr = c / CHUNKS, nc = (c % CHUNKS) * 8;
    const int gk = k0 + kr, gn = n0 + nc;
    const bf16* s = src + (long long)gk * N + gn;
    uint4 raw;  // 16-byte aligned staging for the vector load
    bf16* v = reinterpret_cast<bf16*>(&raw);
    if (vec && gk < K && gn + 8 <= N) {
      raw = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = (gk < K && gn + i < N) ? s[i] : zero;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(nc + i) * LDS + kr] = v[i];
  }
}

template <int BM, int BN>
struct Tile {
  static constexpr int WARPS_N = BN / WARP_N;
  static constexpr int THREADS = (BM / WARP_M) * WARPS_N * 32;
  static constexpr int SMEM = (BM + BN) * LDS * (int)sizeof(bf16);
};

template <int BM, int BN, typename OutT>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS) tl2_matmul_kernel(Params p) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + BM * LDS;

  const int tiles_m = cdiv(p.m, BM), tiles_n = cdiv(p.n, BN);
  const int tile = blockIdx.x;
  const int tm = p.raster_nm ? tile % tiles_m : tile / tiles_n;
  const int tn = p.raster_nm ? tile / tiles_m : tile % tiles_n;
  const int m0 = tm * BM, n0 = tn * BN;
  const long long z = blockIdx.z;
  const bf16* A = p.a + z * p.sa;
  const bf16* B = p.b + z * p.sb;
  OutT* C = reinterpret_cast<OutT*>(p.c) + z * p.sc;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / T::WARPS_N) * WARP_M, wn = (warp % T::WARPS_N) * WARP_N;

  float acc[MI][NI][4];
  float part[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const int gk = cdiv(p.k, p.bk);
  for (int kb = 0; kb < gk; ++kb) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.0f;

    const int k_begin = kb * p.bk;
    const int k_end = min(k_begin + p.bk, p.k);
    for (int k0 = k_begin; k0 < k_end; k0 += KSTEP) {
      load_rows_k<BM, T::THREADS>(A, p.m, p.k, m0, k0, p.vec_a, As);
      if (p.rhs_nk)
        load_rows_k<BN, T::THREADS>(B, p.n, p.k, n0, k0, p.vec_b, Bs);
      else
        load_kn<BN, T::THREADS>(B, p.k, p.n, k0, n0, p.vec_b, Bs);
      __syncthreads();
      float sl[MI][NI][4];  // this slice's sum (see the note on precision)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) sl[i][j][r] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KSTEP; kk += 16) {
        uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const bf16* s = As + (wm + i * 16 + g) * LDS + kk + t * 2;
          af[i][0] = ld32(s);
          af[i][1] = ld32(s + 8 * LDS);
          af[i][2] = ld32(s + 8);
          af[i][3] = ld32(s + 8 * LDS + 8);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const bf16* s = Bs + (wn + j * 8 + g) * LDS + kk + t * 2;
          bfr[j][0] = ld32(s);
          bfr[j][1] = ld32(s + 8);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_bf16(sl[i][j], af[i], bfr[j]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[i][j][r] += sl[i][j][r];
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (gk == 1) {
            acc[i][j][r] = part[i][j][r];
          } else {
            const float s = acc[i][j][r] + part[i][j][r];
            acc[i][j][r] = p.acc_bf16 ? round_bf16(s) : s;
          }
        }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + t * 2 + (r & 1);
        if (row < p.m && col < p.n) {
          float v = acc[i][j][r];
          if (p.bias) v += p.bias[col];
          store_out(C + (long long)row * p.n + col, act_fn(v, p.act));
        }
      }
}

template <int BM, int BN, typename OutT>
cudaError_t launch_tile(const Params& p, int batch, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  if (T::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tl2_matmul_kernel<BM, BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(cdiv(p.m, BM) * cdiv(p.n, BN), 1, batch);
  tl2_matmul_kernel<BM, BN, OutT><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename OutT>
int launch(const void* a, const void* b, const void* bias, void* c, int batch, int m, int n,
           int k, long long sa, long long sb, long long sc, int bm, int bn, int bk, int rhs_nk,
           int acc_bf16, int act, int raster_nm, int vec_a, int vec_b, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || batch <= 0 || batch > 65535 || bk <= 0 || bk % KSTEP)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.bias = static_cast<const float*>(bias);
  p.c = c;
  p.m = m; p.n = n; p.k = k; p.bk = bk;
  p.sa = sa; p.sb = sb; p.sc = sc;
  p.rhs_nk = rhs_nk; p.acc_bf16 = acc_bf16; p.act = act; p.raster_nm = raster_nm;
  p.vec_a = vec_a; p.vec_b = vec_b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TL2_TILE(BM_, BN_) \
  if (bm == BM_ && bn == BN_) return (int)launch_tile<BM_, BN_, OutT>(p, batch, s);
  TL2_TILE(32, 32) TL2_TILE(32, 64) TL2_TILE(32, 128)
  TL2_TILE(64, 32) TL2_TILE(64, 64) TL2_TILE(64, 128)
  TL2_TILE(128, 32) TL2_TILE(128, 64) TL2_TILE(128, 128)
#undef TL2_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// C = act(A @ B [+ bias]) with bf16 output. Returns the cudaError_t of the launch.
int tl2_matmul_bf16out(const void* a, const void* b, const void* bias, void* c, int batch,
                       int m, int n, int k, long long sa, long long sb, long long sc, int bm,
                       int bn, int bk, int rhs_nk, int acc_bf16, int act, int raster_nm,
                       int vec_a, int vec_b, void* stream) {
  return launch<bf16>(a, b, bias, c, batch, m, n, k, sa, sb, sc, bm, bn, bk, rhs_nk, acc_bf16,
                      act, raster_nm, vec_a, vec_b, stream);
}

// The same with f32 output.
int tl2_matmul_f32out(const void* a, const void* b, const void* bias, void* c, int batch,
                      int m, int n, int k, long long sa, long long sb, long long sc, int bm,
                      int bn, int bk, int rhs_nk, int acc_bf16, int act, int raster_nm,
                      int vec_a, int vec_b, void* stream) {
  return launch<float>(a, b, bias, c, batch, m, n, k, sa, sb, sc, bm, bn, bk, rhs_nk, acc_bf16,
                       act, raster_nm, vec_a, vec_b, stream);
}

// Shared memory of one CTA for a (bm, bn) tile; mirrors KernelConfig.smem_bytes().
int tl2_smem_bytes(int bm, int bn) { return (bm + bn) * LDS * (int)sizeof(bf16); }

// The K depth of one shared-memory stage; every bk must be a multiple of it.
int tl2_kstep(void) { return KSTEP; }

}  // extern "C"
