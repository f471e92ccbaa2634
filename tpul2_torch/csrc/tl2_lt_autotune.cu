// tl2_lt_autotune.cu — the cuBLASLt auto-tuning baseline: a heuristic-algo search per shape.
//
// Host code only: no device kernel. This is a measuring baseline, the counterpart of the
// reference's cublas/fp32/hgemm_cublaslt_auto_tuning.cu (find_best_algo_{nn,tn}_v2, then an
// exec path that reuses the cached algo), not a port of any Pallas kernel; the port's
// kernels never call it. bf16 operands, an f32 compute type (CUBLAS_COMPUTE_32F), a bf16 or
// f32 output.
//
// Row-major C (M x N) = A (M x K) . B is, read column-major, C^T (N x M, ld N) =
// B^T . A^T, the reference's trick (hgemm_cublas.cu): cuBLASLt's first operand X is the RHS
// as stored and its second Y is A as stored, a K x M column-major matrix (ld K).
//   'kn' (nn): B (K x N row-major) is X = N x K column-major (ld N), read as it is;
//   'nk' (tn): B_t (N x K row-major) is K x N column-major (ld K), read transposed.
// The f32 family's rule holds: the preference admits only split-K reductions in the compute
// type (no in-place or output-type reduction, which would add partial sums in bf16).
//
// A plan per (M, N, K, layout, output type) holds the descriptors and the algos of
// cublasLtMatmulAlgoGetHeuristic (up to max_algos) that fit the caller's workspace; those
// that need more, or whose state is not SUCCESS, are skipped and counted. The caller times
// them (tl2_lt_time_round: one untimed call of the shuffled-last algo, then each algo of the
// shuffled order between two CUDA events), selects the winner (tl2_lt_select) and runs it
// (tl2_lt_matmul). The workspace is the caller's (allocated once through torch's
// allocator); the stream is the caller's. Each function returns 0, a cudaError_t, or
// 1000 + a cublasStatus_t.

#include <cublasLt.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <vector>

namespace {

struct Plan {
  cublasLtMatmulDesc_t op = nullptr;
  cublasLtMatrixLayout_t lx = nullptr, ly = nullptr, lc = nullptr;
  std::vector<cublasLtMatmulAlgo_t> algos;
  int skipped = 0;
  int best = -1;
};

using Key = std::tuple<int, int, int, int, int>;  // m, n, k, rhs_nk, out_f32

cublasLtHandle_t g_handle = nullptr;
std::map<Key, Plan> g_plans;
std::mutex g_mu;

constexpr int kLtErr = 1000;

int lt(cublasStatus_t s) { return s == CUBLAS_STATUS_SUCCESS ? 0 : kLtErr + int(s); }

#define TRY(expr)          \
  do {                     \
    int err_ = (expr);     \
    if (err_) return err_; \
  } while (0)

int build_plan(Plan& p, int m, int n, int k, int rhs_nk, int out_f32, long long ws_bytes,
               int max_algos) {
  if (!g_handle) TRY(lt(cublasLtCreate(&g_handle)));
  TRY(lt(cublasLtMatmulDescCreate(&p.op, CUBLAS_COMPUTE_32F, CUDA_R_32F)));
  cublasOperation_t ta = rhs_nk ? CUBLAS_OP_T : CUBLAS_OP_N, tb = CUBLAS_OP_N;
  TRY(lt(cublasLtMatmulDescSetAttribute(p.op, CUBLASLT_MATMUL_DESC_TRANSA, &ta, sizeof(ta))));
  TRY(lt(cublasLtMatmulDescSetAttribute(p.op, CUBLASLT_MATMUL_DESC_TRANSB, &tb, sizeof(tb))));
  if (rhs_nk)
    TRY(lt(cublasLtMatrixLayoutCreate(&p.lx, CUDA_R_16BF, k, n, k)));
  else
    TRY(lt(cublasLtMatrixLayoutCreate(&p.lx, CUDA_R_16BF, n, k, n)));
  TRY(lt(cublasLtMatrixLayoutCreate(&p.ly, CUDA_R_16BF, k, m, k)));
  TRY(lt(cublasLtMatrixLayoutCreate(&p.lc, out_f32 ? CUDA_R_32F : CUDA_R_16BF, n, m, n)));

  cublasLtMatmulPreference_t pref = nullptr;
  TRY(lt(cublasLtMatmulPreferenceCreate(&pref)));
  uint64_t ws = uint64_t(ws_bytes);
  uint32_t reductions = CUBLASLT_REDUCTION_SCHEME_COMPUTE_TYPE;
  int err = lt(cublasLtMatmulPreferenceSetAttribute(
      pref, CUBLASLT_MATMUL_PREF_MAX_WORKSPACE_BYTES, &ws, sizeof(ws)));
  if (!err)
    err = lt(cublasLtMatmulPreferenceSetAttribute(
        pref, CUBLASLT_MATMUL_PREF_REDUCTION_SCHEME_MASK, &reductions, sizeof(reductions)));
  std::vector<cublasLtMatmulHeuristicResult_t> found(max_algos);
  int returned = 0;
  if (!err)
    err = lt(cublasLtMatmulAlgoGetHeuristic(g_handle, p.op, p.lx, p.ly, p.lc, p.lc, pref,
                                            max_algos, found.data(), &returned));
  cublasLtMatmulPreferenceDestroy(pref);
  if (err) return err;
  for (int i = 0; i < returned; ++i) {
    if (found[i].state != CUBLAS_STATUS_SUCCESS || found[i].workspaceSize > ws) {
      ++p.skipped;
      continue;
    }
    p.algos.push_back(found[i].algo);
  }
  return p.algos.empty() ? kLtErr + int(CUBLAS_STATUS_NOT_SUPPORTED) : 0;
}

Plan* find(int m, int n, int k, int rhs_nk, int out_f32) {
  auto it = g_plans.find(Key{m, n, k, rhs_nk, out_f32});
  return it == g_plans.end() ? nullptr : &it->second;
}

int run(const Plan& p, int algo, const void* a, const void* b, void* c, void* ws,
        long long ws_bytes, cudaStream_t stream) {
  const float alpha = 1.0f, beta = 0.0f;
  int err = lt(cublasLtMatmul(g_handle, p.op, &alpha, b, p.lx, a, p.ly, &beta, c, p.lc, c,
                              p.lc, &p.algos[algo], ws, size_t(ws_bytes), stream));
  return err ? err : int(cudaGetLastError());
}

}  // namespace

// The plan of one shape: descriptors and the heuristic's algos that fit ws_bytes. Writes the
// count kept and the count skipped. A second call for the same shape returns the first's.
extern "C" int tl2_lt_prepare(int m, int n, int k, int rhs_nk, int out_f32, long long ws_bytes,
                              int max_algos, int* n_algos, int* n_skipped) {
  if (m <= 0 || n <= 0 || k <= 0 || max_algos <= 0 || ws_bytes < 0) return int(cudaErrorInvalidValue);
  std::lock_guard<std::mutex> lock(g_mu);
  Plan* p = find(m, n, k, rhs_nk, out_f32);
  if (!p) {
    Plan fresh;
    int err = build_plan(fresh, m, n, k, rhs_nk, out_f32, ws_bytes, max_algos);
    if (err) return err;
    p = &(g_plans[Key{m, n, k, rhs_nk, out_f32}] = fresh);
  }
  *n_algos = int(p->algos.size());
  *n_skipped = p->skipped;
  return 0;
}

// One round: an untimed call of order[n_order - 1] (the shuffled-last algo), then each algo
// of `order` between two CUDA events; ms[order[i]] receives its time. Synchronizes.
extern "C" int tl2_lt_time_round(int m, int n, int k, int rhs_nk, int out_f32, const void* a,
                                 const void* b, void* c, void* ws, long long ws_bytes,
                                 const int* order, int n_order, float* ms, void* stream) {
  std::lock_guard<std::mutex> lock(g_mu);
  Plan* p = find(m, n, k, rhs_nk, out_f32);
  if (!p || n_order <= 0) return int(cudaErrorInvalidValue);
  for (int i = 0; i < n_order; ++i)
    if (order[i] < 0 || order[i] >= int(p->algos.size())) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  std::vector<cudaEvent_t> ev(2 * n_order);
  for (auto& e : ev) TRY(int(cudaEventCreate(&e)));
  int err = run(*p, order[n_order - 1], a, b, c, ws, ws_bytes, s);
  for (int i = 0; i < n_order && !err; ++i) {
    err = int(cudaEventRecord(ev[2 * i], s));
    if (!err) err = run(*p, order[i], a, b, c, ws, ws_bytes, s);
    if (!err) err = int(cudaEventRecord(ev[2 * i + 1], s));
  }
  if (!err) err = int(cudaStreamSynchronize(s));
  for (int i = 0; i < n_order && !err; ++i)
    err = int(cudaEventElapsedTime(&ms[order[i]], ev[2 * i], ev[2 * i + 1]));
  for (auto& e : ev) cudaEventDestroy(e);
  return err;
}

// Keep `best` as the shape's winner: tl2_lt_matmul with algo -1 runs it.
extern "C" int tl2_lt_select(int m, int n, int k, int rhs_nk, int out_f32, int best) {
  std::lock_guard<std::mutex> lock(g_mu);
  Plan* p = find(m, n, k, rhs_nk, out_f32);
  if (!p || best < 0 || best >= int(p->algos.size())) return int(cudaErrorInvalidValue);
  p->best = best;
  return 0;
}

// The selected algo of the shape, or -1 (no plan or none selected).
extern "C" int tl2_lt_selected(int m, int n, int k, int rhs_nk, int out_f32) {
  std::lock_guard<std::mutex> lock(g_mu);
  Plan* p = find(m, n, k, rhs_nk, out_f32);
  return p ? p->best : -1;
}

// C = A . B with algo `algo` of the shape's plan, or its selected one where algo is -1.
// Launches on `stream` and does not synchronize.
extern "C" int tl2_lt_matmul(int m, int n, int k, int rhs_nk, int out_f32, int algo,
                             const void* a, const void* b, void* c, void* ws,
                             long long ws_bytes, void* stream) {
  std::lock_guard<std::mutex> lock(g_mu);
  Plan* p = find(m, n, k, rhs_nk, out_f32);
  if (!p) return int(cudaErrorInvalidValue);
  if (algo < 0) algo = p->best;
  if (algo < 0 || algo >= int(p->algos.size())) return int(cudaErrorInvalidValue);
  return run(*p, algo, a, b, c, ws, ws_bytes, static_cast<cudaStream_t>(stream));
}
