// One Newton sweep of the structure-sparse Riccati recursion for Hopper
// (sm_90a), in two launches. Replaces the TPU kernels of
// `ops/pallas/riccati_sparse.py:riccati_sweep_sparse`: the backward sweep
// (`_backward_kernel`, K6) with the box rows' Hessian additions sig and
// gradient corrections corr GIVEN as tensors, and the forward rollout
// (`_forward_kernel`, K7) with its optional control clip and its optional
// zero-control ("hold") rollout in the same pass. The IPM calls them for the
// clipped-LQR start (zero iterate, zero sig/corr, clip and hold) and for the
// unfused glue (`fuse_glue=False`: sig/corr from `ipm_corr_terms`).
//
// Backward design (K6): K4's streamed body (ndp_stream.cuh) over its own
// source, `GivenSrc`: teams of TEAM = 4 lanes a scenario, S scenarios a
// block, one stage's rows at a time in shared memory, moved in and out by a
// producer warp's tensor copies. A stage's f32 rows are the payload's gx,
// gu, bc and r, the iterate and sig/corr (58 rows, against K4's 87: no
// slacks, duals, mu or bounds), then hq, a and b in the jac dtype; its
// outputs K, kf and rh (no res2). The row terms (`GivenSrc::Rows`) are read
// from the stage buffer, node N's from sig_x[N] and corr_x[N]. Where the
// rows cannot be tensor-copied (B not a multiple of 8, or a tensor not on
// 16 bytes) the launch runs the one-thread sweep
// (`riccati_sweep_backward_thread_kernel`: `ndp::backward_sweep` with the
// `GivenRows` source, the code K4's one-thread sweep runs with `GlueRows`),
// the route `riccati_sweep_backward_route` reports.
//
// Forward design (K7): one thread per scenario (128 threads a block, masked
// at b < B) runs `ndp::rollout`, which K5's `forward_pass` runs too. The TPU
// grid's sequential stage axis, over which the Pallas kernels carried P and
// dx in VMEM scratch, is a loop inside the block (K6) or the thread (K7).
//
// NaN: the clip is nmax then nmin (jnp.minimum(jnp.maximum(du, lo), hi)
// propagates NaN; fminf/fmaxf would drop it and let a poisoned solve look
// healthy to the recovery screen). `with_hold` is only meaningful at the
// zero iterate, where the defects rh the backward kernel writes equal r;
// nothing here checks that.
//
// What bounds it on this card: bytes. The backward kernel reads the payload,
// the iterate and sig/corr and writes the gains and defects (about 14 KB a
// scenario with the bf16 payload); the forward kernel reads the blocks,
// defects, gains and the clip bounds and writes the rollout (about 10 KB).
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#define NDP_TEAM 4  // lanes a scenario of K6 (ndp_team.cuh)
#ifndef NDP_K6_THREADS  // compute threads a block, at most (the host tests build fewer)
#define NDP_K6_THREADS 320
#endif

#include "ndp_stream.cuh"

namespace ndp {

// Tensors of both launches; each kernel reads and writes its own subset.
struct SweepPtrs {
  QpPtrs q;        // payload: hq gx gu a b bc r (backward), a b bc (forward)
  float* zx;       // (N+1, 10, B) iterate
  float* zu;       // (N, 4, B)
  float* sig_u;    // (N, 4, B) box rows' Hessian additions
  float* sig_x;    // (N+1, 3, B)
  float* corr_u;   // (N, 4, B) and gradient corrections
  float* corr_x;   // (N+1, 3, B)
  float* K;        // (N, 40, B) backward out, forward in
  float* kf;       // (N, 4, B)
  float* rh;       // (N, 10, B)
  float* dx0_res;  // (1, 10, B) forward: the initial-state residual
  float* clip_lo;  // (N, 4, B) or null: no clip
  float* clip_hi;
  float* dx;       // (N+1, 10, B) forward out
  float* du;       // (N, 4, B)
  float* dx_hold;  // (N+1, 10, B) or null: no hold rollout
};

// K6's source of the streamed sweep (ndp_stream.cuh). A stage buffer, in
// floats from its start: the stage's f32 payload, iterate and row terms,
// then its outputs (K, whose first 20 floats hold the box rows' terms
// (GlueOff) until the gain solves overwrite them, kf and rh: 54 floats from
// KO), then the curvature payload in the jac dtype. The input fields, in
// landing order: the f32 ones, then the curvature payload; the outputs K,
// kf and rh.
struct GivenSrc {
  using Ptrs = SweepPtrs;
  static constexpr int MAX_THREADS = NDP_K6_THREADS;
  static constexpr bool RES2 = false;
  enum BufOff {
    GX = 0, GU = 12, BC = 16, R = 24, ZX = 36, ZU = 48, SGU = 52, CRU = 56, SGX = 60, CRX = 64,
    KO = 68, KFO = 108, RHO = 112, JAC = 124
  };
  enum Field { F_GX, F_GU, F_BC, F_R, F_ZX, F_ZU, F_SGU, F_CRU, F_SGX, F_CRX, F_HQ, F_A, F_B, F_IN };
  __host__ __device__ static constexpr int field_rows(int f) {
    return f == F_GX || f == F_R || f == F_ZX ? NX : f == F_BC ? 6 : f == F_HQ ? 16
           : f == F_A ? 40 : f == F_B ? 30 : f == F_SGX || f == F_CRX ? 3 : NU;
  }
  __host__ __device__ static constexpr bool field_jac(int f) { return f >= F_HQ && f < F_IN; }
  __host__ __device__ static constexpr bool field_node(int f) {
    return f == F_GX || f == F_ZX || f == F_SGX || f == F_CRX || f == F_HQ;
  }
  __host__ __device__ static constexpr bool field_once(int) { return false; }
  __host__ __device__ static constexpr int field_slot(int f) {
    return f == F_GX ? GX : f == F_GU ? GU : f == F_BC ? BC : f == F_R ? R : f == F_ZX ? ZX
           : f == F_ZU ? ZU : f == F_SGU ? SGU : f == F_CRU ? CRU : f == F_SGX ? SGX
           : f == F_CRX ? CRX : f == F_HQ ? stream::J_HQ : f == F_A ? stream::J_A : stream::J_B;
  }
  enum OutField { O_K, O_KF, O_RH, O_N };
  __host__ __device__ static constexpr int out_rows(int o) {
    return o == O_K ? NU * NX : o == O_KF ? NU : NX;
  }
  __host__ __device__ static constexpr bool out_once(int) { return false; }
  static const void* field_ptr(const SweepPtrs& p, int f) {
    switch (f) {
      case F_GX: return p.q.gx;
      case F_GU: return p.q.gu;
      case F_BC: return p.q.bc;
      case F_R: return p.q.r;
      case F_ZX: return p.zx;
      case F_ZU: return p.zu;
      case F_SGU: return p.sig_u;
      case F_CRU: return p.corr_u;
      case F_SGX: return p.sig_x;
      case F_CRX: return p.corr_x;
      case F_HQ: return p.q.hq;
      case F_A: return p.q.a;
      default: return p.q.b;
    }
  }
  static float* out_ptr(const SweepPtrs& p, int q) {
    return q == O_K ? p.K : q == O_KF ? p.kf : p.rh;
  }

  // The given row terms of buffer d (`GivenRows` of `backward_sweep`): row e
  // of the u rows (u) or of the v rows; the row's value is not read.
  struct Rows {
    __device__ __forceinline__ void terms(const float* d, bool u, int e, float, float& sig,
                                          float& corr) const {
      sig = d[(u ? SGU : SGX) + e];
      corr = d[(u ? CRU : CRX) + e];
    }
  };
  __device__ static Rows rows(const char*, const int*, int) { return Rows{}; }
};

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(ndp::GivenSrc::MAX_THREADS + 32, 1)
    riccati_sweep_backward_kernel(const __grid_constant__ ndp::SweepPtrs p,
                                  const __grid_constant__ ndp::StepConsts c,
                                  const __grid_constant__ ndp::stream::Maps<ndp::GivenSrc> maps,
                                  int S) {
  extern __shared__ float4 ndp_smem[];
  ndp::stream::backward_body<ndp::GivenSrc, JT>(reinterpret_cast<char*>(ndp_smem), c, maps, S);
}

// The one-thread sweep of ndp.cuh (`backward_sweep` with `GivenRows`, 128
// threads a block, masked at b < B), for batches whose rows the tensor
// copies cannot move: B not a multiple of 8, or a tensor not on 16 bytes.
template <typename JT>
__global__ void __launch_bounds__(128)
    riccati_sweep_backward_thread_kernel(ndp::SweepPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const GivenRows rows{at(p.sig_u, NU, B, b), at(p.corr_u, NU, B, b), at(p.sig_x, 3, B, b),
                       at(p.corr_x, 3, B, b)};
  backward_sweep<JT>(payload_at<JT>(p.q, B, b), at(p.zx, NX, B, b), at(p.zu, NU, B, b), rows,
                     at(p.K, NU * NX, B, b), at(p.kf, NU, B, b), at(p.rh, NX, B, b), c);
}

template <typename JT>
__global__ void __launch_bounds__(128)
    riccati_sweep_forward_kernel(ndp::SweepPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = c.n_stages;
  const View<float> lo = at(p.clip_lo, NU, B, b), hi = at(p.clip_hi, NU, B, b);
  const View<float> dxo = at(p.dx, NX, B, b), duo = at(p.du, NU, B, b);
  const View<float> dxho = at(p.dx_hold, NX, B, b);
  const bool hold = dxho.p != nullptr;
  float dx[NX], dxh[NX];
  for (int i = 0; i < NX; ++i) {
    dx[i] = p.dx0_res[i * B + b];
    dxh[i] = dx[i];
  }
  rollout(
      payload_at<JT>(p.q, B, b), at(p.K, NU * NX, B, b), at(p.kf, NU, B, b), at(p.rh, NX, B, b),
      dx, c,
      [&](int k, const float* x, float* du) {
        if (lo.p)
          for (int l = 0; l < NU; ++l) du[l] = nmin(nmax(du[l], lo(k, l)), hi(k, l));
        for (int i = 0; i < NX; ++i) dxo(k, i) = x[i];
        for (int l = 0; l < NU; ++l) duo(k, l) = du[l];
      },
      [&](int k, const Blocks& m, const float* rk) {
        if (!hold) return;
        float nxt[NX];
        for (int i = 0; i < NX; ++i) dxho(k, i) = dxh[i];
        dyn_step(m, rk, c.h, dxh, nullptr, nxt);
        for (int i = 0; i < NX; ++i) dxh[i] = nxt[i];
      });
  for (int i = 0; i < NX; ++i) dxo(N, i) = dx[i];
  if (hold)
    for (int i = 0; i < NX; ++i) dxho(N, i) = dxh[i];
}

// The route of the backward kernel's last launch: 1 tensor copies (the
// teams), 0 the one-thread sweep, -1 none yet.
static int last_route = -1;

template <typename JT>
static int backward_launch_t(const ndp::StepConsts* c, const ndp::SweepPtrs* p, long long B,
                             cudaStream_t s) {
  return ndp::stream::launch<ndp::GivenSrc, JT>(
      riccati_sweep_backward_kernel<JT>,
      [&] {
        const unsigned blocks = (unsigned)((B + 127) / 128);
        NDP_LAUNCH(riccati_sweep_backward_thread_kernel<JT>, blocks, 128, 0, s, *p, *c, B);
      },
      c, p, B, s, last_route);
}

extern "C" {

int riccati_sweep_consts_size() { return (int)sizeof(ndp::StepConsts); }
int riccati_sweep_ptrs_size() { return (int)sizeof(ndp::SweepPtrs); }

// The backward kernel's launch geometry for the ctypes mirror
// (`_cuda.sweep_geometry("given", ...)`; `ndp::stream::geometry_out`).
void riccati_sweep_backward_geometry(int, int jac_bf16, long long B, long long* out) {
  ndp::stream::geometry_out<ndp::GivenSrc>(jac_bf16, B, out);
}

// Launch the backward kernel on `stream`; return the error of the shared-
// memory attribute or of a tensor map, or cudaGetLastError() after the
// launch.
int riccati_sweep_backward_launch(int jac_bf16, const ndp::StepConsts* c,
                                  const ndp::SweepPtrs* p, long long B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return jac_bf16 ? backward_launch_t<__nv_bfloat16>(c, p, B, s)
                  : backward_launch_t<float>(c, p, B, s);
}

// The route the backward kernel's last launch took (`last_route`).
int riccati_sweep_backward_route() { return last_route; }

#ifdef NDP_TEAM_CLOCKS
// The backward kernel's phase cycle counts since the last call
// (ndp::ClockPhase order).
int riccati_sweep_backward_clocks(long long* out) { return ndp::team_clocks_take(out); }
#endif

// Launch the forward kernel on `stream`; return cudaGetLastError().

int riccati_sweep_forward_launch(int jac_bf16, const ndp::StepConsts* c,
                                 const ndp::SweepPtrs* p, long long B, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    NDP_LAUNCH(riccati_sweep_forward_kernel<__nv_bfloat16>, blocks, threads, 0, s, *p, *c, B);
  else
    NDP_LAUNCH(riccati_sweep_forward_kernel<float>, blocks, threads, 0, s, *p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
