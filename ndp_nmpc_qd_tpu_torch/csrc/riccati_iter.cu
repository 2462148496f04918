// One glue-fused interior-point iteration for Hopper (sm_90a), in two
// launches. Replaces the TPU kernels of
// `ops/pallas/riccati_sparse.py:riccati_iter_fused`: the backward sweep
// (`_backward_kernel_glue`, K4) and the forward rollout
// (`_forward_kernel_glue`, K5). Each kernel writes what `riccati_iter_fused`
// returns: res2 summed over the stages, a_p/a_d min-reduced (2.0 sentinel,
// NaN-propagating) and clamped at 1, comp4 summed over every box row, where
// the TPU wrapper reduced per-stage partial tensors outside its kernels.
//
// What bounds it on this card: bytes, in both kernels. The backward kernel
// does about 88k scalar f32 operations a scenario against about 14.8 KB read
// (payload, iterate, slacks, duals) and written (gains, defects); the
// forward kernel about 14k against about 15.7 KB (payload, gains and state
// in, every direction out).
//
// Backward design (K4): the streamed sweep of ndp_stream.cuh (shared with
// K6) over K4's source, `GlueSrc`: a team of TEAM = 4 lanes a scenario, S
// scenarios a block, and only the current stage's inputs and the sweep's
// working set on the SM, as K8 (riccati_packed.cu) streams them. A stage's
// f32 rows are the payload's, the iterate, the slacks and duals (mu once,
// with the terminal node), then hq, a and b in the jac dtype; the row terms
// (`GlueSrc::Rows`) come from the slack elimination (`glue_pair`), and the
// sum of squared defects goes out as res2, summed over k = N-1..0 as the
// plain version sums it. Where the rows cannot be tensor-copied (B not a
// multiple of 8, or a tensor not on 16 bytes) the launch runs the
// one-thread sweep (`ndp::backward_sweep`, `riccati_backward_thread_kernel`)
// instead, the one other route (`riccati_backward_route`): it measured
// faster there than the teams fed element by element, by every thread or by
// a producer warp (PERF.md).
//
// Forward design (K5): one thread per scenario (128 threads a block, masked
// at b < B), dx in registers over k = 0..N-1 and the terminal node; it does
// not spill. Loads and stores are coalesced across the warp (batch
// innermost).
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#define NDP_TEAM 4  // lanes a scenario of K4 (ndp_team.cuh)
#ifndef NDP_K4_THREADS  // compute threads a block, at most (the host tests build fewer)
#define NDP_K4_THREADS 320
#endif

#include "ndp_stream.cuh"

namespace ndp {

// Tensors of both launches; each kernel reads and writes its own subset.
struct IterPtrs {
  QpPtrs q;      // payload (dx0 unused; the forward kernel reads a, b, bc and
                 // the bounds only)
  float* zx;     // (N+1, 10, B) current iterate
  float* zu;     // (N, 4, B)
  float* su_lo;  // (N, 4, B) slacks of the u rows
  float* su_up;
  float* sx_lo;  // (N+1, 3, B) slacks of the v rows
  float* sx_up;
  float* lu_lo;  // (N, 4, B) duals of the u rows
  float* lu_up;
  float* lx_lo;  // (N+1, 3, B) duals of the v rows
  float* lx_up;
  float* mu;       // (B,) barrier weight
  float* dx0_res;  // (1, 10, B) forward: the initial-state residual
  float* K;        // (N, 40, B) backward out, forward in
  float* kf;       // (N, 4, B)
  float* rh;       // (N, 10, B)
  float* res2;     // (B,) backward out: sum of rh^2
  float* dx;       // (N+1, 10, B) forward out
  float* du;       // (N, 4, B)
  float* dsu_lo;   // (N, 4, B)
  float* dsu_up;
  float* dlu_lo;
  float* dlu_up;
  float* dsx_lo;   // (N+1, 3, B)
  float* dsx_up;
  float* dlx_lo;
  float* dlx_up;
  float* ap;       // (B,) step sizes, clamped at 1
  float* ad;
  float* comp4;    // (4, B) complementarity partials
};

__device__ inline Bounds bounds_at(const IterPtrs& p, long long B, long long b) {
  return Bounds{at(p.su_lo, NU, B, b), at(p.su_up, NU, B, b), at(p.sx_lo, 3, B, b),
                at(p.sx_up, 3, B, b),  at(p.lu_lo, NU, B, b), at(p.lu_up, NU, B, b),
                at(p.lx_lo, 3, B, b),  at(p.lx_up, 3, B, b)};
}

// K4's source of the streamed sweep (ndp_stream.cuh). A stage buffer, in
// floats from its start: the stage's f32 payload, iterate, slacks and
// duals, then its outputs (the gains K, whose first 20 floats hold the box
// rows' terms (GlueOff) until the gain solves overwrite them, kf and the
// defects rh: 54 floats from KO), then the curvature payload in the jac
// dtype. The input fields, in landing order: the f32 ones (mu a single row,
// for the terminal node), then the curvature payload; the outputs K, kf, rh
// and res2 (with stage 0's).
struct GlueSrc {
  using Ptrs = IterPtrs;
  static constexpr int MAX_THREADS = NDP_K4_THREADS;
  static constexpr bool RES2 = true;
  enum BufOff {
    GX = 0, GU = 12, BC = 16, R = 24, LUB = 36, UUB = 40, LXB = 44, UXB = 48, ZX = 52, ZU = 64,
    SUL = 68, SUU = 72, SXL = 76, SXU = 80, LUL = 84, LUU = 88, LXL = 92, LXU = 96,
    KO = 100, KFO = 140, RHO = 144, JAC = 156
  };
  enum Field {
    F_GX, F_GU, F_BC, F_R, F_LUB, F_UUB, F_LXB, F_UXB, F_ZX, F_ZU, F_SUL, F_SUU, F_SXL, F_SXU,
    F_LUL, F_LUU, F_LXL, F_LXU, F_MU, F_HQ, F_A, F_B, F_IN
  };
  __host__ __device__ static constexpr int field_rows(int f) {
    return f == F_GX || f == F_R || f == F_ZX ? NX : f == F_BC ? 6 : f == F_MU ? 1
           : f == F_HQ ? 16 : f == F_A ? 40 : f == F_B ? 30
           : f == F_LXB || f == F_UXB || f == F_SXL || f == F_SXU || f == F_LXL || f == F_LXU ? 3
                                                                                            : NU;
  }
  __host__ __device__ static constexpr bool field_jac(int f) { return f >= F_HQ && f < F_IN; }
  __host__ __device__ static constexpr bool field_node(int f) {
    return f == F_GX || f == F_LXB || f == F_UXB || f == F_ZX || f == F_SXL || f == F_SXU ||
           f == F_LXL || f == F_LXU || f == F_HQ;
  }
  __host__ __device__ static constexpr bool field_once(int f) { return f == F_MU; }
  __host__ __device__ static constexpr int field_slot(int f) {
    return f == F_GX ? GX : f == F_GU ? GU : f == F_BC ? BC : f == F_R ? R : f == F_LUB ? LUB
           : f == F_UUB ? UUB : f == F_LXB ? LXB : f == F_UXB ? UXB : f == F_ZX ? ZX : f == F_ZU ? ZU
           : f == F_SUL ? SUL : f == F_SUU ? SUU : f == F_SXL ? SXL : f == F_SXU ? SXU
           : f == F_LUL ? LUL : f == F_LUU ? LUU : f == F_LXL ? LXL : f == F_LXU ? LXU
           : f == F_HQ ? stream::J_HQ : f == F_A ? stream::J_A : f == F_B ? stream::J_B : 0;
  }
  enum OutField { O_K, O_KF, O_RH, O_R2, O_N };
  __host__ __device__ static constexpr int out_rows(int o) {
    return o == O_K ? NU * NX : o == O_KF ? NU : o == O_RH ? NX : 1;
  }
  __host__ __device__ static constexpr bool out_once(int o) { return o == O_R2; }
  static const void* field_ptr(const IterPtrs& p, int f) {
    switch (f) {
      case F_GX: return p.q.gx;
      case F_GU: return p.q.gu;
      case F_BC: return p.q.bc;
      case F_R: return p.q.r;
      case F_LUB: return p.q.lub;
      case F_UUB: return p.q.uub;
      case F_LXB: return p.q.lxb;
      case F_UXB: return p.q.uxb;
      case F_ZX: return p.zx;
      case F_ZU: return p.zu;
      case F_SUL: return p.su_lo;
      case F_SUU: return p.su_up;
      case F_SXL: return p.sx_lo;
      case F_SXU: return p.sx_up;
      case F_LUL: return p.lu_lo;
      case F_LUU: return p.lu_up;
      case F_LXL: return p.lx_lo;
      case F_LXU: return p.lx_up;
      case F_MU: return p.mu;
      case F_HQ: return p.q.hq;
      case F_A: return p.q.a;
      default: return p.q.b;
    }
  }
  static float* out_ptr(const IterPtrs& p, int q) {
    return q == O_K ? p.K : q == O_KF ? p.kf : q == O_RH ? p.rh : p.res2;
  }

  // The box rows' terms from the staged slacks and duals at barrier weight
  // mu (`_backward_kernel_glue`: glue_pair in the sweep), as `GlueRows` is
  // `backward_sweep`'s (ndp.cuh). Row e of the u rows (u) or of the v rows
  // of buffer d, at the row's value v.
  struct Rows {
    float mu;
    __device__ __forceinline__ void terms(const float* d, bool u, int e, float v, float& sig,
                                          float& corr) const {
      const Glue g = glue_pair(v, d[(u ? LUB : LXB) + e], d[(u ? UUB : UXB) + e],
                               d[(u ? SUL : SXL) + e], d[(u ? SUU : SXU) + e],
                               d[(u ? LUL : LXL) + e], d[(u ? LUU : LXU) + e], mu);
      sig = g.sig;
      corr = g.corr;
    }
  };
  // mu of scenario s, from the landing buffer's once field
  __device__ static Rows rows(const char* smem, const int* in, int s) {
    return Rows{reinterpret_cast<const float*>(smem + in[F_MU])[s]};
  }
};

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(ndp::GlueSrc::MAX_THREADS + 32, 1)
    riccati_backward_kernel(const __grid_constant__ ndp::IterPtrs p,
                            const __grid_constant__ ndp::StepConsts c,
                            const __grid_constant__ ndp::stream::Maps<ndp::GlueSrc> maps, int S) {
  extern __shared__ float4 ndp_smem[];
  ndp::stream::backward_body<ndp::GlueSrc, JT>(reinterpret_cast<char*>(ndp_smem), c, maps, S);
}

// The one-thread sweep of ndp.cuh (`backward_sweep`, 128 threads a block,
// masked at b < B), for batches whose rows the tensor copies cannot move:
// B not a multiple of VEC, or a tensor not on 16 bytes.
template <typename JT>
__global__ void __launch_bounds__(128)
    riccati_backward_thread_kernel(ndp::IterPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  p.res2[b] = backward_sweep<JT>(payload_at<JT>(p.q, B, b), at(p.zx, NX, B, b),
                                 at(p.zu, NU, B, b), bounds_at(p, B, b), p.mu[b],
                                 at(p.K, NU * NX, B, b), at(p.kf, NU, B, b), at(p.rh, NX, B, b),
                                 c);
}

template <typename JT>
__global__ void __launch_bounds__(128)
    riccati_forward_kernel(ndp::IterPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float dx[NX];
  for (int i = 0; i < NX; ++i) dx[i] = p.dx0_res[i * B + b];
  const Dirs dirs{at(p.dsu_lo, NU, B, b), at(p.dsu_up, NU, B, b), at(p.dlu_lo, NU, B, b),
                  at(p.dlu_up, NU, B, b), at(p.dsx_lo, 3, B, b),  at(p.dsx_up, 3, B, b),
                  at(p.dlx_lo, 3, B, b),  at(p.dlx_up, 3, B, b)};
  const StepAcc acc = forward_pass<JT>(
      payload_at<JT>(p.q, B, b), at(p.K, NU * NX, B, b), at(p.kf, NU, B, b), at(p.rh, NX, B, b),
      at(p.zx, NX, B, b), at(p.zu, NU, B, b), bounds_at(p, B, b), p.mu[b], dx,
      at(p.dx, NX, B, b), at(p.du, NU, B, b), dirs, c);
  p.ap[b] = nmin(acc.ap, 1.0f);
  p.ad[b] = nmin(acc.ad, 1.0f);
  p.comp4[b] = acc.c1;
  p.comp4[B + b] = acc.c2;
  p.comp4[2 * B + b] = acc.c3;
  p.comp4[3 * B + b] = acc.c4;
}

// The route of the backward kernel's last launch: 1 tensor copies (the
// teams), 0 the one-thread sweep, -1 none yet.
static int last_route = -1;

template <typename JT>
static int backward_launch_t(const ndp::StepConsts* c, const ndp::IterPtrs* p, long long B,
                             cudaStream_t s) {
  return ndp::stream::launch<ndp::GlueSrc, JT>(
      riccati_backward_kernel<JT>,
      [&] {
        const unsigned blocks = (unsigned)((B + 127) / 128);
        NDP_LAUNCH(riccati_backward_thread_kernel<JT>, blocks, 128, 0, s, *p, *c, B);
      },
      c, p, B, s, last_route);
}

extern "C" {

int riccati_iter_consts_size() { return (int)sizeof(ndp::StepConsts); }
int riccati_iter_ptrs_size() { return (int)sizeof(ndp::IterPtrs); }

// The backward kernel's launch geometry for the ctypes mirror
// (`_cuda.sweep_geometry`): out = [lanes a scenario, scenarios a block,
// threads a block, blocks, shared-memory bytes a block, bytes of a
// scenario's arrays (its slot and columns of the landing and output
// buffers), bytes of its padded slot]. The slot
// holds one stage, so it does not depend on the number of stages.
void riccati_backward_geometry(int, int jac_bf16, long long B, long long* out) {
  ndp::stream::geometry_out<ndp::GlueSrc>(jac_bf16, B, out);
}

// Launch the backward / forward kernel on `stream`; return the error of the
// shared-memory attribute or cudaGetLastError() after the launch.
int riccati_backward_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::IterPtrs* p,
                            long long B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return jac_bf16 ? backward_launch_t<__nv_bfloat16>(c, p, B, s)
                  : backward_launch_t<float>(c, p, B, s);
}

// The route the backward kernel's last launch took (`last_route`).
int riccati_backward_route() { return last_route; }

#ifdef NDP_TEAM_CLOCKS
// The backward kernel's phase cycle counts since the last call
// (ndp::ClockPhase order).
int riccati_backward_clocks(long long* out) { return ndp::team_clocks_take(out); }
#endif

int riccati_forward_launch(int jac_bf16, const ndp::StepConsts* c, const ndp::IterPtrs* p,
                           long long B, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jac_bf16)
    NDP_LAUNCH(riccati_forward_kernel<__nv_bfloat16>, blocks, threads, 0, s, *p, *c, B);
  else
    NDP_LAUNCH(riccati_forward_kernel<float>, blocks, threads, 0, s, *p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
