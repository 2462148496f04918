// Stage linearization for Hopper (sm_90a): the SparseQp payload of every
// scenario at its RTI iterates. Replaces the TPU kernel
// `ops/pallas/linearize.py:linearize_stage_data` (body `_lin_kernel`).
//
// Design: the stages are independent, as the TPU kernel's grid (scenario
// tiles, stage) computes them, so a thread takes one (stage, scenario): a
// block covers one stage k and THREADS consecutive scenarios (blocks flat,
// stage fastest: block = tile * (N + 1) + k), and the node k = N computes
// the terminal terms, dx0 and the +-big rows of node N (node 0's come with
// stage 0's bounds): the full (N+1, ., B) tensors, which the TPU wrapper
// concatenated outside its kernel. The thread computes the primal RK4
// points once, then walks the 8 tangent columns (0-3 the quaternion states,
// 4-6 the body rates, 7 the collective) in a loop, one at a time: a
// column's 10 tangent values live in registers from its seed to its store
// (no array indexed by a runtime value, so nothing goes to local memory),
// and the loop keeps the code small and the registers at ~126, four blocks
// an SM. Tensor elements are addressed from the kernel's parameters, so no
// pointer a tensor is held in registers. With substeps > 1 each column
// replays the later substeps' points, in an instantiation of its own. Each
// column's arithmetic is rk4_tangents' (ndp.cuh, which K1 runs), column by
// column (rk4_points, rk4_tangent_step), so K1 and K3 compute the same
// payload up to FMA contraction. Measured against a warp a tangent column
// and against all 8 columns a thread in registers (PERF.md).
//
// What bounds it on this card: bytes. A scenario costs about 59k scalar f32
// operations (the RK4 step and its 8 tangent columns, ~3k a stage) against
// about 9.7 KB of inputs read and payload written (bf16 curvature): at
// B=65536, ~0.19 ms of memory traffic against ~0.06 ms of arithmetic. Every
// load and store is coalesced across the warp (batch innermost).
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp.cuh"

namespace ndp {

// Tensors of one launch: the iterates and the tick's inputs in, the payload
// out.
struct LinPtrs {
  const float* xb;  // (N+1, 10, B)
  const float* ub;  // (N, 4, B)
  const float* xr;  // (N+1, 10, B)
  const float* ur;  // (N, 4, B)
  const float* fd;  // (N+1, 3, B) downwash forecast, null without it
  const float* x0;  // (1, 10, B)
  QpPtrs q;         // out
};

namespace k3 {

constexpr int COLS = 8;       // tangent columns
constexpr int THREADS = 128;  // scenarios a block

// Launch geometry: [threads a (stage, scenario), scenarios a block, threads
// a block, blocks, shared-memory bytes a block].
inline void geometry(int N, long long B, long long* out) {
  out[0] = 1;
  out[1] = THREADS;
  out[2] = THREADS;
  out[3] = (B + THREADS - 1) / THREADS * (N + 1);
  out[4] = 0;
}

// Element (k, i) of the thread's scenario of a (stage, d, B) tensor at p,
// addressed from the kernel's parameters (no pointer a tensor is held).
struct Elem {
  long long B, b;
  template <typename T>
  __device__ __forceinline__ T& operator()(T* p, int d, int k, int i) const {
    return p[((long long)k * d + i) * B + b];
  }
};

template <typename JT>
__device__ __forceinline__ JT* jac(void* p) { return static_cast<JT*>(p); }

// Tangent column `col` of stage k into the payload (lin_stage_terms'
// scatter; the collective column's quaternion rows, which are zero, are
// not stored).
template <typename JT>
__device__ __forceinline__ void store_column(const LinPtrs& p, const Elem& e, int k, int col,
                                             const float* tx) {
  if (col < 4) {
    for (int i = 0; i < 3; ++i) {
      e(jac<JT>(p.q.a), 40, k, i * 4 + col) = stf<JT>(tx[i]);            // Apq
      e(jac<JT>(p.q.a), 40, k, 12 + i * 4 + col) = stf<JT>(tx[3 + i]);   // Avq
    }
    for (int i = 0; i < 4; ++i) e(jac<JT>(p.q.a), 40, k, 24 + i * 4 + col) = stf<JT>(tx[6 + i]);
  } else if (col < 7) {
    const int l = col - 4;
    for (int i = 0; i < 3; ++i) {
      e(jac<JT>(p.q.b), 30, k, i * 3 + l) = stf<JT>(tx[i]);              // Bp
      e(jac<JT>(p.q.b), 30, k, 9 + i * 3 + l) = stf<JT>(tx[3 + i]);      // Bv
    }
    for (int i = 0; i < 4; ++i) e(jac<JT>(p.q.b), 30, k, 18 + i * 3 + l) = stf<JT>(tx[6 + i]);
  } else {
    for (int i = 0; i < 6; ++i) e(p.q.bc, 6, k, i) = tx[i];  // collective columns stay f32
  }
}

// Stage k's terms besides the tangents (lin_stage_terms and
// linearize_scenario, same expressions): hq and gx, gu, the defect r from
// the step's end state xe, the bounds. x, u: the stage's iterate.
template <typename JT>
__device__ __forceinline__ void stage_terms(const LinPtrs& p, const Elem& e, int k,
                                            const float* x, const float* u, const float* xe,
                                            const StepConsts& c) {
  float xrq[4], qe[3], hq16[16], gxq[4];
  for (int i = 0; i < 4; ++i) xrq[i] = e(p.xr, NX, k, 6 + i);
  qe_tiles(x + 6, xrq, qe);
  hq_gxq_tiles(xrq, qe, c.q_diag + 7, hq16, gxq);
  for (int j = 0; j < 16; ++j) e(jac<JT>(p.q.hq), 16, k, j) = stf<JT>(c.stage_scale * hq16[j]);
  for (int i = 0; i < 6; ++i) e(p.q.gx, NX, k, i) = c.gx_scale[i] * (x[i] - e(p.xr, NX, k, i));
  for (int i = 0; i < 4; ++i) e(p.q.gx, NX, k, 6 + i) = c.stage_scale * gxq[i];
  for (int l = 0; l < NU; ++l) e(p.q.gu, NU, k, l) = c.gu_scale[l] * (u[l] - e(p.ur, NU, k, l));
  for (int i = 0; i < NX; ++i) e(p.q.r, NX, k, i) = xe[i] - e(p.xb, NX, k + 1, i);
  for (int l = 0; l < NU; ++l) {
    e(p.q.lub, NU, k, l) = c.u_lo[l] - u[l];
    e(p.q.uub, NU, k, l) = c.u_hi[l] - u[l];
  }
  for (int t = 0; t < 3; ++t) {
    e(p.q.lxb, 3, k, t) = k == 0 ? -c.big : c.v_lo[t] - x[3 + t];
    e(p.q.uxb, 3, k, t) = k == 0 ? c.big : c.v_hi[t] - x[3 + t];
  }
}

// The terminal node's terms (linearize_scenario's tail): hq, gx, dx0 and
// the +-big rows of node N.
template <typename JT>
__device__ __forceinline__ void terminal_terms(const LinPtrs& p, const Elem& e, int N,
                                               const StepConsts& c) {
  float x1T[NX], xrT[NX], hqT[16], gxT[NX];
  for (int i = 0; i < NX; ++i) {
    x1T[i] = e(p.xb, NX, N, i);
    xrT[i] = e(p.xr, NX, N, i);
  }
  lin_terminal_terms(x1T, xrT, c, hqT, gxT);
  for (int j = 0; j < 16; ++j) e(jac<JT>(p.q.hq), 16, N, j) = stf<JT>(hqT[j]);
  for (int i = 0; i < NX; ++i) {
    e(p.q.gx, NX, N, i) = gxT[i];
    e(p.q.dx0, NX, 0, i) = e(p.x0, NX, 0, i) - e(p.xb, NX, 0, i);
  }
  for (int t = 0; t < 3; ++t) {
    e(p.q.lxb, 3, N, t) = -c.big;
    e(p.q.uxb, 3, N, t) = c.big;
  }
}

}  // namespace k3
}  // namespace ndp

// REPLAY: built for substeps > 1, where each column replays the later
// substeps' primal points; substeps == 1 (the configuration in use) runs
// without that code, and its registers.
template <typename JT, bool REPLAY>
__global__ void __launch_bounds__(ndp::k3::THREADS)
    linearize_kernel(const __grid_constant__ ndp::LinPtrs p,
                     const __grid_constant__ ndp::StepConsts c, long long B) {
  using namespace ndp;
  using namespace ndp::k3;
  const int N = c.n_stages;
  const long long tile = blockIdx.x / (N + 1);
  const int k = (int)(blockIdx.x - tile * (N + 1));
  const Elem e{B, tile * THREADS + threadIdx.x};
  if (e.b >= B) return;
  if (k == N) {
    terminal_terms<JT>(p, e, N, c);
    return;
  }
  float x[NX], u[NU], fd[3];
  for (int i = 0; i < NX; ++i) x[i] = e(p.xb, NX, k, i);
  for (int l = 0; l < NU; ++l) u[l] = e(p.ub, NU, k, l);
  if (c.with_dist)
    for (int t = 0; t < 3; ++t) fd[t] = e(p.fd, 3, k, t);
  const float* fdp = c.with_dist ? fd : nullptr;
  // the primal step: the first substep's points, its end state x1s, and the
  // end state xe after every substep
  float x2[NX], x3[NX], x4[NX], x1s[NX], xe[NX];
  rk4_points(x, u, fdp, c, x2, x3, x4, x1s);
  for (int i = 0; i < NX; ++i) xe[i] = x1s[i];
  if (REPLAY)
    for (int sub = 1; sub < c.substeps; ++sub) {
      float y2[NX], y3[NX], y4[NX], yn[NX];
      rk4_points(xe, u, fdp, c, y2, y3, y4, yn);
      for (int i = 0; i < NX; ++i) xe[i] = yn[i];
    }
#pragma unroll 1
  for (int col = 0; col < COLS; ++col) {
    float tx[NX], tu[NU];
    tangent_seed(col, tx, tu);
    rk4_tangent_step(x, x2, x3, x4, u, tu, c, tx);
    if (REPLAY) {  // the later substeps, their points replayed for this column
      float xa[NX];
      for (int i = 0; i < NX; ++i) xa[i] = x1s[i];
      for (int sub = 1; sub < c.substeps; ++sub) {
        float y2[NX], y3[NX], y4[NX], yn[NX];
        rk4_points(xa, u, fdp, c, y2, y3, y4, yn);
        rk4_tangent_step(xa, y2, y3, y4, u, tu, c, tx);
        for (int i = 0; i < NX; ++i) xa[i] = yn[i];
      }
    }
    store_column<JT>(p, e, k, col, tx);
  }
  stage_terms<JT>(p, e, k, x, u, xe, c);
}

template <typename JT>
static void launch_t(const ndp::LinPtrs& p, const ndp::StepConsts& c, long long B,
                     unsigned blocks, cudaStream_t s) {
  const auto kern = c.substeps > 1 ? linearize_kernel<JT, true> : linearize_kernel<JT, false>;
  NDP_LAUNCH(kern, blocks, ndp::k3::THREADS, 0, s, p, c, B);
}

extern "C" {

int linearize_consts_size() { return (int)sizeof(ndp::StepConsts); }
int linearize_ptrs_size() { return (int)sizeof(ndp::LinPtrs); }

// The launch geometry for the ctypes mirror (`linearize.geometry`): out =
// [threads a (stage, scenario), scenarios a block, threads a block, blocks,
// shared-memory bytes a block]. The second argument, the jac dtype as the
// other geometry exports take it, is not read.
void linearize_geometry(int n_stages, int, long long B, long long* out) {
  ndp::k3::geometry(n_stages, B, out);
}

// Launches the linearization on `stream`; returns cudaGetLastError().
int linearize_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::LinPtrs* p, long long B,
                     void* stream) {
  long long g[5];
  ndp::k3::geometry(c->n_stages, B, g);
  if (B < 1 || c->n_stages < 1 || g[3] >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    launch_t<__nv_bfloat16>(*p, *c, B, (unsigned)g[3], s);
  else
    launch_t<float>(*p, *c, B, (unsigned)g[3], s);
  return (int)cudaGetLastError();
}

}  // extern "C"
