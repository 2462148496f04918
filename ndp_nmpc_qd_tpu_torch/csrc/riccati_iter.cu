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
// Backward design (K4): a team of TEAM = 4 lanes a scenario, S scenarios a
// block, and only the current stage's inputs and the sweep's working set on
// the SM, as K8 (riccati_packed.cu) streams them: a producer warp loads stage
// k-1's rows into a landing buffer (one tensor copy a field, its f32 rows and
// the curvature payload in the jac dtype) while the teams compute stage k, and
// stores stage k+1's gains, kf and defects from one of two output buffers; the
// compute threads never touch global memory. Where the rows cannot be
// tensor-copied (B not a multiple of 8, or a tensor not on 16 bytes) the
// launch runs the one-thread sweep (`ndp::backward_sweep`,
// `riccati_backward_thread_kernel`) instead, the one other route
// (`riccati_backward_route`): it measured faster there than the teams fed
// element by element, by every thread or by a producer warp (PERF.md). Each
// team moves its scenario's column into its stage buffer (`unpack`) and runs
// `stage_sweep`: the stage's box-row terms and defect rows when it arrives
// (A), then `ndp_team.cuh`'s `team_stage` phases B, C and E over P, p and the
// work area (W_*, 352 floats) in shared memory. Node k+1's iterate, which the
// defects need, is kept from the stage before (ZX1). Every output element is
// computed by one lane with the one-thread expression and order, res2 is
// summed over k = N-1..0 as the plain version sums it, and a NaN stays in its
// slot.
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

#include "ndp_team.cuh"

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

namespace k4 {

constexpr int MAX_THREADS = NDP_K4_THREADS;  // compute threads a block (and a producer warp)

// A stage buffer, in floats from its start: the stage's f32 payload, iterate,
// slacks and duals, then its outputs (the gains K, whose first 20 floats
// hold the box rows' terms (GlueOff) until the gain solves overwrite them,
// kf and the defects rh: 54 floats from KO), then the curvature payload in
// the jac dtype (hq at element 0, a at 16, b at 56). Every array starts on
// 16 bytes.
enum BufOff {
  GX = 0, GU = 12, BC = 16, R = 24, LUB = 36, UUB = 40, LXB = 44, UXB = 48, ZX = 52, ZU = 64,
  SUL = 68, SUU = 72, SXL = 76, SXU = 80, LUL = 84, LUU = 88, LXL = 92, LXU = 96,
  KO = 100, KFO = 140, RHO = 144, JAC = 156
};
constexpr int OUT_ROWS = NU * NX + NU + NX;          // K, kf, rh
constexpr int J_HQ = 0, J_A = 16, J_B = 56, J_N = 86;  // jac-dtype elements
__host__ __device__ constexpr int buf_floats(int jac_bytes) {
  return JAC + (J_N * jac_bytes + 15) / 16 * 4;
}
// A slot: the stage buffer, the work area of `team_stage` (W_*), node k+1's
// iterate (ZX1).
__host__ __device__ constexpr int work_at(int jac_bytes) { return buf_floats(jac_bytes); }
constexpr int ZX1 = W_SIZE, WORK = W_SIZE + 12;
__host__ __device__ constexpr int slot_floats(int jac_bytes) { return work_at(jac_bytes) + WORK; }
// The slot stride in floats: padded to 4 banks mod 32, so that the teams of
// a warp read their 16-byte rows from disjoint banks.
__host__ __device__ constexpr int slot_stride(int jac_bytes) {
  return slot_floats(jac_bytes) + ((4 - slot_floats(jac_bytes) % 32) % 32 + 32) % 32;
}
// The input fields, in landing order: the f32 ones (mu a single row, for
// the terminal node), then the curvature payload in the jac dtype; their
// rows a stage, the slot offsets they unpack to (jac-dtype elements from
// JAC for the last three) and the stages a tensor has (N or N + 1).
enum Field {
  F_GX, F_GU, F_BC, F_R, F_LUB, F_UUB, F_LXB, F_UXB, F_ZX, F_ZU, F_SUL, F_SUU, F_SXL, F_SXU,
  F_LUL, F_LUU, F_LXL, F_LXU, F_MU, F_HQ, F_A, F_B, F_IN
};
__host__ __device__ constexpr int field_rows(int f) {
  return f == F_GX || f == F_R || f == F_ZX ? NX : f == F_BC ? 6 : f == F_MU ? 1
         : f == F_HQ ? 16 : f == F_A ? 40 : f == F_B ? 30
         : f == F_LXB || f == F_UXB || f == F_SXL || f == F_SXU || f == F_LXL || f == F_LXU ? 3
                                                                                          : NU;
}
__host__ __device__ constexpr bool field_jac(int f) { return f >= F_HQ && f < F_IN; }
__host__ __device__ constexpr bool field_node(int f) {  // a node field: N + 1 stages
  return f == F_GX || f == F_LXB || f == F_UXB || f == F_ZX || f == F_SXL || f == F_SXU ||
         f == F_LXL || f == F_LXU || f == F_HQ;
}
__host__ __device__ constexpr bool field_terminal(int f) { return field_node(f) || f == F_MU; }
__host__ __device__ constexpr int field_slot(int f) {
  return f == F_GX ? GX : f == F_GU ? GU : f == F_BC ? BC : f == F_R ? R : f == F_LUB ? LUB
         : f == F_UUB ? UUB : f == F_LXB ? LXB : f == F_UXB ? UXB : f == F_ZX ? ZX : f == F_ZU ? ZU
         : f == F_SUL ? SUL : f == F_SUU ? SUU : f == F_SXL ? SXL : f == F_SXU ? SXU
         : f == F_LUL ? LUL : f == F_LUU ? LUU : f == F_LXL ? LXL : f == F_LXU ? LXU
         : f == F_HQ ? J_HQ : f == F_A ? J_A : f == F_B ? J_B : 0;
}
// The output fields: a stage's K, kf and rh (the slot's 54 floats from KO,
// row for row), and res2 with stage 0's.
enum OutField { O_K, O_KF, O_RH, O_R2, O_N };
__host__ __device__ constexpr int out_rows(int o) {
  return o == O_K ? NU * NX : o == O_KF ? NU : o == O_RH ? NX : 1;
}
constexpr int IN_F32_ROWS = 2 * NX + NX + 6 + 8 * NU + 6 * 3 + 1;  // the f32 fields' rows
constexpr int O_ROWS = OUT_ROWS + 1;
constexpr int VEC = 8;  // scenarios 16 bytes hold of bf16
// S: a multiple of this when there are that many, so that the compute
// threads fill whole warps and rows take whole 16-byte copies.
constexpr int S_STEP = VEC * TEAM > 32 ? VEC : 32 / TEAM;
__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// A block's shared memory, byte offsets: its S slots; the landing buffer,
// one stage's input rows, each field a box [rows][S] on 128 bytes; two
// output buffers (stage k's in buffer k & 1), each output field a box
// [rows][S] on 128 bytes; the landing buffer's mbarrier.
struct Layout {
  int in[F_IN], out[2][O_N], bar, bytes;
};
__host__ __device__ inline Layout layout(int S, int jac_bytes) {
  Layout L;
  int o = round128(4 * S * slot_stride(jac_bytes));
#pragma unroll
  for (int f = 0; f < F_IN; ++f) {
    L.in[f] = o;
    o += round128((field_jac(f) ? jac_bytes : 4) * S * field_rows(f));
  }
  for (int b = 0; b < 2; ++b)
    for (int q = 0; q < O_N; ++q) {
      L.out[b][q] = o;
      o += round128(4 * S * out_rows(q));
    }
  L.bar = o;
  L.bytes = o + 16;
  return L;
}
// A scenario's bytes: its slot, its columns of the landing and output
// buffers.
__host__ __device__ constexpr int scenario_bytes(int jac_bytes) {
  return 4 * (slot_floats(jac_bytes) + IN_F32_ROWS + 2 * O_ROWS) + jac_bytes * J_N;
}

// S scenarios a block (as many as fit, at most MAX_THREADS / TEAM and B, a
// multiple of S_STEP when there are that many), their compute threads in
// whole warps, then the producer warp.
__host__ __device__ inline TeamGeom geometry(int jac_bytes, long long B) {
  TeamGeom g;
  g.team = TEAM;
  long long S = MAX_THREADS / TEAM;
  if (S > B) S = B;
  while (S > 1 && layout((int)S, jac_bytes).bytes > SMEM_MAX) --S;
  if (S >= S_STEP) S -= S % S_STEP;
  g.S = (int)S;
  g.threads = (g.S * TEAM + 31) / 32 * 32 + 32;
  g.smem = layout(g.S, jac_bytes).bytes;
  g.blocks = g.S > 0 ? (B + g.S - 1) / g.S : 0;
  return g;
}

// The tensors' maps for tensor copies: the input fields, then the outputs.
struct Maps {
  TensorMap in[F_IN], out[O_N];
};

// The team's views of stage buffer `d` as stage 0 of a one-stage payload
// (what `team_stage` and `team_terminal` index), over work area `w`.
template <typename JT>
__device__ __forceinline__ Team<JT> stage_team(float* d, float* w) {
  Team<JT> tm;
  tm.t = threadIdx.x % TEAM;
  const int lane = threadIdx.x & 31;
  tm.mask = ((1u << TEAM) - 1u) << (lane & ~(TEAM - 1));
  JT* j = reinterpret_cast<JT*>(d + JAC);
  tm.q.hq = SV<JT>{j + J_HQ, 16};
  tm.q.a = SV<JT>{j + J_A, 40};
  tm.q.b = SV<JT>{j + J_B, 30};
  tm.q.gx = SV<float>{d + GX, NX};
  tm.q.gu = SV<float>{d + GU, NU};
  tm.q.bc = SV<float>{d + BC, 6};
  tm.q.r = SV<float>{d + R, NX};
  tm.K = SV<float>{d + KO, NU * NX};
  tm.kf = SV<float>{d + KFO, NU};
  tm.rh = SV<float>{d + RHO, NX};
  tm.zx = SV<float>{d + ZX, NX};
  tm.zu = SV<float>{d + ZU, NU};
  tm.w = w;
  return tm;
}

// The box rows' terms from the staged slacks and duals at barrier weight mu
// (`_backward_kernel_glue`: glue_pair in the sweep): the row source of
// `stage_sweep`, as `GlueRows` is `backward_sweep`'s (ndp.cuh). Row e of the
// u rows (u) or of the v rows of buffer d, at the row's value v.
struct StageGlueRows {
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

// One stage of the streamed sweep over buffer d: A, job j < 7: box row j's
// terms (u rows 0-3, v rows 4-6) into the gain slots (GlueOff), job i < 10:
// defect row i from the stage's iterate and node k+1's (ZX1); then node k's
// iterate becomes ZX1 and `team_stage` forms the gains. Returns r2 plus this
// stage's sum of squared defects (every lane, in loop order).
template <typename JT, typename RowTerms>
__device__ __forceinline__ float stage_sweep(const Team<JT>& tm, float* d, const RowTerms& rows,
                                             float r2, const StepConsts& c) {
  const int t = tm.t;
  float* const w = tm.w;
  for (int j = t; j < NU + 3; j += TEAM) {
    const bool u = j < NU;
    const int e = u ? j : j - NU;
    const float v = d[u ? ZU + e : ZX + 3 + e];
    float sig, corr;
    rows.terms(d, u, e, v, sig, corr);
    float* const g = d + KO;
    g[G_SIG + j] = sig;
    g[G_CORR + j] = corr;
    if (u) g[G_GHU + j] = d[GU + j] + c.rdiag_stage[j] * v + corr;
  }
  for (int i = t; i < NX; i += TEAM)
    d[RHO + i] = defect_row(tm.q, 0, c.h, d + ZX, w + ZX1, d + ZU, d + R, i);
  tm.sync();
  team_clock(CK_BWD_A);
  for (int i = t; i < NX; i += TEAM) w[ZX1 + i] = d[ZX + i];  // read by stage k-1's defects
  r2 = r2 + sq10(d + RHO);
  team_stage(tm, 0, c);
  return r2;
}

// ---- staging: the producer warp moves stage k's rows into the block's
// landing buffer (`load_stage`) and a stage's outputs out of an output
// buffer (`store_out`) by tensor copies; each team moves its scenario from
// the landing buffer into its stage buffer (`unpack`) ----

__host__ __device__ inline const void* field_ptr(const IterPtrs& p, int f) {
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
__host__ __device__ inline float* out_ptr(const IterPtrs& p, int q) {
  return q == O_K ? p.K : q == O_KF ? p.kf : q == O_RH ? p.rh : p.res2;
}

// Stage k's rows, or with `terminal` the terminal node's and mu, into the
// landing buffer: the producer's lane 0 announces their bytes on the
// mbarrier and issues one tensor copy a field.
template <typename JT>
__device__ __forceinline__ void load_stage(const Maps& maps, int k, bool terminal, char* smem,
                                           const Layout& L, int S, long long b0,
                                           unsigned long long* bar) {
  if ((threadIdx.x & 31) != 0) return;
  unsigned bytes = 0;
#pragma unroll
  for (int f = 0; f < F_IN; ++f)
    if (terminal ? field_terminal(f) : f != F_MU)
      bytes += (field_jac(f) ? sizeof(JT) : 4u) * S * field_rows(f);
  mbar_expect(bar, bytes);
#pragma unroll
  for (int f = 0; f < F_IN; ++f)
    if (terminal ? field_terminal(f) : f != F_MU)
      tma_load(smem + L.in[f], &maps.in[f], (int)b0, f == F_MU ? 0 : k * field_rows(f), bar);
}

// Stage k's outputs (K, kf, rh; res2 with stage 0's) from output buffer o:
// one tensor copy a field from the producer's lane 0.
__device__ __forceinline__ void store_out(const Maps& maps, int k, int o, const char* smem,
                                          const Layout& L, int S, long long b0) {
  if ((threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int q = 0; q < O_N; ++q)
    if (q < O_R2 || k == 0)
      tma_store(&maps.out[q], (int)b0, q == O_R2 ? 0 : k * out_rows(q),
                smem + (o ? L.out[1][q] : L.out[0][q]));
  bulk_commit();
}

// Lane t's share (rows t, t + TEAM, ...) of a field's D landing rows of
// scenario s into the stage buffer at dst.
template <int D, typename T>
__device__ __forceinline__ void unpack_rows(T* dst, const char* src, int S, int s, int t) {
  const T* const l = reinterpret_cast<const T*>(src) + s;
#pragma unroll
  for (int e0 = 0; e0 < D; e0 += TEAM)
    if (e0 + t < D) dst[e0 + t] = l[(e0 + t) * S];
}

// A team's scenario s from the landing buffer into its stage buffer d
// (`terminal`: the terminal node's rows only).
template <typename JT>
__device__ __forceinline__ void unpack(const char* smem, const Layout& L, int S, int s, float* d,
                                       int t, bool terminal) {
  JT* const dj = reinterpret_cast<JT*>(d + JAC);
  unpack_rows<NX>(d + GX, smem + L.in[F_GX], S, s, t);
  unpack_rows<3>(d + LXB, smem + L.in[F_LXB], S, s, t);
  unpack_rows<3>(d + UXB, smem + L.in[F_UXB], S, s, t);
  unpack_rows<NX>(d + ZX, smem + L.in[F_ZX], S, s, t);
  unpack_rows<3>(d + SXL, smem + L.in[F_SXL], S, s, t);
  unpack_rows<3>(d + SXU, smem + L.in[F_SXU], S, s, t);
  unpack_rows<3>(d + LXL, smem + L.in[F_LXL], S, s, t);
  unpack_rows<3>(d + LXU, smem + L.in[F_LXU], S, s, t);
  unpack_rows<16>(dj + J_HQ, smem + L.in[F_HQ], S, s, t);
  if (terminal) return;
  unpack_rows<NU>(d + GU, smem + L.in[F_GU], S, s, t);
  unpack_rows<6>(d + BC, smem + L.in[F_BC], S, s, t);
  unpack_rows<NX>(d + R, smem + L.in[F_R], S, s, t);
  unpack_rows<NU>(d + LUB, smem + L.in[F_LUB], S, s, t);
  unpack_rows<NU>(d + UUB, smem + L.in[F_UUB], S, s, t);
  unpack_rows<NU>(d + ZU, smem + L.in[F_ZU], S, s, t);
  unpack_rows<NU>(d + SUL, smem + L.in[F_SUL], S, s, t);
  unpack_rows<NU>(d + SUU, smem + L.in[F_SUU], S, s, t);
  unpack_rows<NU>(d + LUL, smem + L.in[F_LUL], S, s, t);
  unpack_rows<NU>(d + LUU, smem + L.in[F_LUU], S, s, t);
  unpack_rows<40>(dj + J_A, smem + L.in[F_A], S, s, t);
  unpack_rows<30>(dj + J_B, smem + L.in[F_B], S, s, t);
}

}  // namespace k4

}  // namespace ndp

template <typename JT>
__global__ void __launch_bounds__(ndp::k4::MAX_THREADS + 32, 1)
    riccati_backward_kernel(const __grid_constant__ ndp::IterPtrs p,
                            const __grid_constant__ ndp::StepConsts c,
                            const __grid_constant__ ndp::k4::Maps maps, int S) {
  using namespace ndp;
  using namespace ndp::k4;
  extern __shared__ float4 ndp_smem[];
  char* const smem = reinterpret_cast<char*>(ndp_smem);
  const int N = c.n_stages;
  const Layout L = layout(S, (int)sizeof(JT));
  unsigned long long* const bar = reinterpret_cast<unsigned long long*>(smem + L.bar);
  // the producer warp (after the compute threads' whole warps) moves every
  // row in and out by tensor copies from its lane 0; the compute threads,
  // lane t of the team of slot s, never touch global memory; threads past
  // S * TEAM in the last compute warp only meet the block's barriers
  const int nc = S * TEAM;
  const bool producer = (int)threadIdx.x >= (nc + 31) / 32 * 32;
  const bool compute = (int)threadIdx.x < nc;
  const long long b0 = (long long)blockIdx.x * S;
  const int t = threadIdx.x % TEAM, s = compute ? threadIdx.x / TEAM : 0;
  float* const d = reinterpret_cast<float*>(smem) + s * slot_stride((int)sizeof(JT));
  float* const w = d + work_at((int)sizeof(JT));
  unsigned phase = 0;  // of the mbarrier
  // wait until the stage the producer loaded last has landed
  auto landed = [&]() {
    mbar_wait(bar, phase);
    phase ^= 1;
  };

  // the terminal node and mu, then stage N-1 in flight
  team_clock(-1);
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  if (producer) load_stage<JT>(maps, N, true, smem, L, S, b0, bar);
  landed();
  if (compute) unpack<JT>(smem, L, S, s, d, t, true);
  const StageGlueRows rows{reinterpret_cast<const float*>(smem + L.in[F_MU])[s]};
  fence_async_smem();
  __syncthreads();  // the landing buffer is free, the terminal node unpacked
  if (producer) load_stage<JT>(maps, N - 1, false, smem, L, S, b0, bar);

  // the terminal cost-to-go: node N's v rows' terms, then P, p
  if (compute) {
    const Team<JT> tm = stage_team<JT>(d, w);
    for (int j = NU + t; j < NU + 3; j += TEAM) {
      float sig, corr;
      rows.terms(d, false, j - NU, d[ZX + 3 + j - NU], sig, corr);
      w[W_GT + G_SIG + j] = sig;
      w[W_GT + G_CORR + j] = corr;
    }
    tm.sync();
    team_terminal(tm, 0, c);
    for (int i = t; i < NX; i += TEAM) w[ZX1 + i] = d[ZX + i];
  }

  float r2 = 0.0f;
  for (int k = N - 1; k >= 0; --k) {
    landed();  // stage k; stage k+1's outputs are in buffer (k + 1) & 1
    if (producer && threadIdx.x % 32 == 0) bulk_wait_read();  // stage k+2's store read k & 1
    team_clock(CK_WAIT);
    if (compute) unpack<JT>(smem, L, S, s, d, t, false);
    fence_async_smem();
    __syncthreads();  // the landing buffer is free; every team's outputs of stage k+1 are in
    if (producer) {
      if (k + 1 < N) store_out(maps, k + 1, (k + 1) & 1, smem, L, S, b0);
      if (k > 0) load_stage<JT>(maps, k - 1, false, smem, L, S, b0, bar);
    }
    team_clock(CK_STAGE_IN);
    if (!compute) continue;
    r2 = stage_sweep(stage_team<JT>(d, w), d, rows, r2, c);
    // the stage's K, kf and rh (54 floats from KO) to output buffer k & 1
    const bool odd = k & 1;
    float* const oK = reinterpret_cast<float*>(smem + (odd ? L.out[1][O_K] : L.out[0][O_K]));
    float* const okf = reinterpret_cast<float*>(smem + (odd ? L.out[1][O_KF] : L.out[0][O_KF]));
    float* const orh = reinterpret_cast<float*>(smem + (odd ? L.out[1][O_RH] : L.out[0][O_RH]));
    for (int e = t; e < OUT_ROWS; e += TEAM) {
      float* const o = e < NU * NX ? oK + e * S : e < NU * NX + NU ? okf + (e - NU * NX) * S
                                                                    : orh + (e - NU * NX - NU) * S;
      o[s] = d[KO + e];
    }
    if (k == 0 && t == 0) reinterpret_cast<float*>(smem + L.out[0][O_R2])[s] = r2;
    team_clock(CK_STAGE_OUT);
  }
  fence_async_smem();
  __syncthreads();
  if (producer) {
    store_out(maps, 0, 0, smem, L, S, b0);
    if (threadIdx.x % 32 == 0) bulk_wait();
  }
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

// Whether a launch takes the tensor copies: their box rows must be 16-byte
// aligned (B and S multiples of VEC, every tensor on 16 bytes).
static bool tma_route(const ndp::IterPtrs& p, long long B, int S) {
  using namespace ndp::k4;
  bool ok = B % VEC == 0 && S % VEC == 0;
  for (int f = 0; f < F_IN; ++f)
    ok = ok && reinterpret_cast<unsigned long long>(field_ptr(p, f)) % 16 == 0;
  for (int q = 0; q < O_N; ++q)
    ok = ok && reinterpret_cast<unsigned long long>(out_ptr(p, q)) % 16 == 0;
  return ok;
}

template <typename JT>
static int backward_launch_t(const ndp::StepConsts* c, const ndp::IterPtrs* p, long long B,
                             cudaStream_t s) {
  using namespace ndp;
  using namespace ndp::k4;
  const int N = c->n_stages;
  const TeamGeom g = geometry((int)sizeof(JT), B);
  if (g.S < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      riccati_backward_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  // the tensor copies take a map of each tensor as (rows, B) in boxes of (a
  // stage's rows, S); a map that cannot be made where the rows are aligned is
  // an error, not a reason to run the one-thread sweep
  Maps maps{};
  const bool tma = tma_route(*p, B, g.S);
  last_route = tma ? 1 : 0;
  if (tma) {
    for (int f = 0; f < F_IN; ++f) {
      const long long rows =
          f == F_MU ? 1 : (long long)(field_node(f) ? N + 1 : N) * field_rows(f);
      if (const int err = tensor_map(&maps.in[f], field_ptr(*p, f),
                                     field_jac(f) ? (int)sizeof(JT) : 4, B, rows, g.S,
                                     field_rows(f)))
        return err;
    }
    for (int q = 0; q < O_N; ++q)
      if (const int err = tensor_map(&maps.out[q], out_ptr(*p, q), 4, B,
                                     q == O_R2 ? 1 : (long long)N * out_rows(q), g.S, out_rows(q)))
        return err;
    NDP_LAUNCH(riccati_backward_kernel<JT>, (unsigned)g.blocks, g.threads, g.smem, s, *p, *c,
               maps, g.S);
  } else {
    const unsigned blocks = (unsigned)((B + 127) / 128);
    NDP_LAUNCH(riccati_backward_thread_kernel<JT>, blocks, 128, 0, s, *p, *c, B);
  }
  return (int)cudaGetLastError();
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
  const int jb = jac_bf16 ? 2 : 4;
  const ndp::TeamGeom g = ndp::k4::geometry(jb, B);
  const long long v[7] = {g.team, g.S, g.threads, g.blocks, g.smem, ndp::k4::scenario_bytes(jb),
                          4LL * ndp::k4::slot_stride(jb)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
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
