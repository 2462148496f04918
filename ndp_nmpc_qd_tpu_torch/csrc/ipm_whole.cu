// The whole warm-started interior-point QP for Hopper (sm_90a), over a
// stored SparseQp payload. Replaces the TPU kernel
// `ops/pallas/ipm_whole.py:riccati_ipm_whole` (body `_ipm_whole_kernel`).
//
// What bounds it on this card: operations. A scenario's solve (3
// iterations) costs about 330k scalar f32 operations, mostly the Riccati
// stage core, against about 11.7 KB of payload, duals and iterates read and
// written once (~21.8 GFLOP and ~0.77 GB at B=65536). As in K1
// (step_whole.cu), the recursion is a chain of short dependent steps, so the
// design keeps everything on the SM and splits each scenario's parallel work
// over a team of lanes. No tensor cores: 10x10 f32 products per scenario,
// which TF32 could not hold at the f32-payload check's 1e-4.
//
// Design: K1's IPM without its linearization: a team of TEAM = 16 lanes a
// scenario, S scenarios a block, the same slot layout and `team_ipm`
// (ndp_team.cuh). The block copies its S scenarios' f32 payload (the
// output of K3), carried duals and mu into shared memory row by row with
// cp.async, lanes across scenarios (each row a contiguous run), and the
// bf16 curvature payload through registers while those copies fly; the
// teams solve; the block writes the duals and mu back in place (the TPU
// kernel's aliases), eq_res, and either folds the deltas into xb/ub in
// place or writes them to zx/zu. The only global memory it touches is its
// inputs and outputs. Shared memory: the same slots as K1 (16,448 bytes a
// scenario at N=20 with the bf16 payload: S = 14; 19,904 with the f32
// payload: S = 11).
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp_team.cuh"

namespace ndp {

// Tensors of one launch.
struct IpmPtrs {
  QpPtrs q;      // payload in
  float* lu_lo;  // (N, 4, B) carried duals, in place
  float* lu_up;
  float* lx_lo;  // (N+1, 3, B)
  float* lx_up;
  float* mu;     // (B,) barrier weight, < 0 = cold; in place
  float* xb;     // (N+1, 10, B) iterates, in place; null: no fold
  float* ub;     // (N, 4, B)
  float* zx;     // (N+1, 10, B) out without the fold
  float* zu;     // (N, 4, B)
  float* eq;     // (B,) out: equality residual
};

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(ndp::MAX_THREADS, 1)
    ipm_whole_kernel(const __grid_constant__ ndp::IpmPtrs p,
                     const __grid_constant__ ndp::StepConsts c, long long B, int S) {
  using namespace ndp;
  extern __shared__ float4 ndp_smem[];
  team_clock(-1);
  float* const base = reinterpret_cast<float*>(ndp_smem);
  const int N = c.n_stages;
  const TeamLayout L = team_layout(N, (int)sizeof(JT));
  const int st = L.stride;
  const long long b0 = (long long)blockIdx.x * S;
  const int nx1 = (N + 1) * NX, nu = N * NU, nv = (N + 1) * 3;

  const Seg<float> in[] = {
      {p.q.gx, L.gx, nx1, false}, {p.q.gu, L.gu, nu, false}, {p.q.bc, L.bc, N * 6, false},
      {p.q.r, L.r, N * NX, false}, {p.q.lub, L.lub, nu, false}, {p.q.uub, L.uub, nu, false},
      {p.q.lxb, L.lxb, nv, false}, {p.q.uxb, L.uxb, nv, false}, {p.q.dx0, L.dx0, NX, false},
      {p.lu_lo, L.lul, nu, false}, {p.lu_up, L.luu, nu, false},
      {p.lx_lo, L.lxl, nv, false}, {p.lx_up, L.lxu, nv, false},
      {p.mu, L.sc + SC_MUW, 1, false},
  };
  stage_in_async(base, st, in, S, b0, B);
  const Seg<JT> jin[] = {  // the curvature payload: one run of the jac dtype
      {static_cast<JT*>(p.q.hq), L.hq, (N + 1) * 16, false},
      {static_cast<JT*>(p.q.a), L.a, N * 40, false},
      {static_cast<JT*>(p.q.b), L.b, N * 30, false},
  };
  stage_in(reinterpret_cast<JT*>(base + L.jac), st * 4 / (int)sizeof(JT), jin, S, b0, B);
  cp_async_wait_all();
  __syncthreads();
  team_clock(CK_STAGE_IN);

  {
    float* slot = base + (threadIdx.x / TEAM) * st;
    team_ipm(team_at<JT>(slot, L, N), c);
  }
  __syncthreads();

  const bool fold = p.xb != nullptr;  // the SQP axpy into xb/ub, or the deltas to zx/zu
  const Seg<float> out[] = {
      {fold ? p.xb : p.zx, L.zx, nx1, fold}, {fold ? p.ub : p.zu, L.zu, nu, fold},
      {p.lu_lo, L.lul, nu, false}, {p.lu_up, L.luu, nu, false},
      {p.lx_lo, L.lxl, nv, false}, {p.lx_up, L.lxu, nv, false},
      {p.mu, L.sc + SC_MU, 1, false}, {p.eq, L.sc + SC_EQ, 1, false},
  };
  stage_out(base, st, out, S, b0, B);
  team_clock(CK_STAGE_OUT);
}

template <typename JT>
static int ipm_whole_launch_t(const ndp::StepConsts* c, const ndp::IpmPtrs* p, long long B,
                              cudaStream_t s) {
  const ndp::TeamGeom g = ndp::team_geometry(c->n_stages, (int)sizeof(JT), B);
  if (g.S < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      ipm_whole_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)g.blocks;
  NDP_LAUNCH(ipm_whole_kernel<JT>, blocks, g.threads, g.smem, s, *p, *c, B, g.S);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch geometry for the ctypes mirror (ndp::team_geometry_out).
void ipm_whole_geometry(int n_stages, int jac_bf16, long long B, long long* out) {
  ndp::team_geometry_out(n_stages, jac_bf16, B, out);
}

int ipm_whole_consts_size() { return (int)sizeof(ndp::StepConsts); }
int ipm_whole_ptrs_size() { return (int)sizeof(ndp::IpmPtrs); }

// Launches the solve on `stream`; returns the error of the shared-memory
// attribute or cudaGetLastError() after the launch.
int ipm_whole_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::IpmPtrs* p, long long B,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return jac_bf16 ? ipm_whole_launch_t<__nv_bfloat16>(c, p, B, s)
                  : ipm_whole_launch_t<float>(c, p, B, s);
}

#ifdef NDP_TEAM_CLOCKS
// The phase cycle counts since the last call (ndp::ClockPhase order).
int ipm_whole_clocks(long long* out) { return ndp::team_clocks_take(out); }
#endif
}  // extern "C"
