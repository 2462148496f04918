// Team device code of K1 (step_whole.cu) and K2 (ipm_whole.cu): a team of
// TEAM lanes owns one scenario, and the scenario's whole working set lives in
// the block's dynamic shared memory, as the TPU kernels kept it in VMEM
// (ops/pallas/step_whole.py:231-257, ops/pallas/ipm_whole.py).
//
// Named after the JAX counterparts, as in ndp.cuh:
//   team_linearize   ops/pallas/linearize.py:_lin_kernel (K1 phase 1)
//   team_backward    ops/pallas/riccati_sparse.py:_backward_kernel_glue
//   team_ipm         ops/pallas/ipm_whole.py:_ipm_whole_kernel (its pass A
//                    is _forward_kernel_glue's rollout and box rows)
//
// Layout. A block holds S scenarios, S * TEAM threads; thread `tid` serves
// scenario slot tid / TEAM as lane tid % TEAM. Each slot owns `stride`
// floats of shared memory (TeamLayout): the f32 payload, the IPM scratch,
// the carried duals, the backward stage's work area and a few scalars, then
// the curvature payload (hq, a, b) in the jac dtype. Arrays in a slot are
// (stage, element) row-major, so SV(k, i) = p[k * d + i]. Two arrays share
// space where their lifetimes do not overlap: the region `K` holds K1's step
// inputs (xb, ub, xr, ur, fd, x0) during the linearization, the gains K
// from each backward sweep to the end of the forward rollout, and then the
// box rows' slack and dual directions until pass B has used them; the work
// area of the backward sweep holds the directions dx, du from the rollout to
// pass B.
//
// Lanes split each scenario's parallel work, and each output element is
// computed by one lane with the expression and summation order of the one-
// thread code (ndp.cuh) and the plain version, so the two still differ only
// by FMA contraction:
// - the linearization: lane t takes stages t, t + TEAM, ... and the terminal;
// - the zero-control start and the forward rollout: lane i takes row i of
//   the dynamics (dyn_row), one team barrier a stage; in the rollout lanes
//   0-3 form du and the team reads it by shuffles;
// - the backward sweep: first every stage's box-row terms (sig, corr,
//   ghat_u) and defect rows, which need no barrier between stages; then a
//   stage is three phases: B, lane i owns row i of P, PA and PB; C, every
//   lane forms Rh and rv and factors Rh (chol4, redundantly), lane j
//   completes column j of S and Qh and solves gain column j, lane 10 kf; E,
//   lane i updates row i of P;
// - the slack start, the step ratios and pass B: spread over the box rows,
//   the u rows and the v rows each one uniform loop. The step ratios reduce
//   with NaN-propagating minima in any order; the complementarity sums
//   c0-c4 and r2 keep the plain version's loop order: lanes walk the rows
//   from shared memory, one sum a lane.
// A row index that differs between lanes reads the slot, never a register
// array (which would go to local memory); each phase keeps one code path
// where it can, since the SM runs near its instruction-issue limit.
// Every lane of every team meets every barrier, whether its slot holds a
// scenario (b < B) or not; team barriers are __syncwarp on the team's mask
// (TEAM divides 32, so a team never straddles a warp). A NaN stays in its own
// scenario: nothing crosses slots but the staging copies.
#pragma once

#include "ndp.cuh"

#ifndef NDP_TEAM
#define NDP_TEAM 16
#endif

namespace ndp {

constexpr int TEAM = NDP_TEAM;  // lanes a scenario
static_assert(TEAM == 4 || TEAM == 8 || TEAM == 16, "a team is 4, 8 or 16 lanes of one warp");
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take on sm_90
constexpr int MAX_THREADS = 256;  // __launch_bounds__ of the team kernels

// The backward stage's work area (floats from TeamLayout::work). W_GT holds
// the terminal node's box-row terms in the layout of a stage's (G_SIG..).
// PA and PB are stored transposed (PA_T[j][i] = PA[i][j]), so that a lane
// reads its column as one run; Qh's upper part overwrites PA_T column by
// column. Offsets are multiples of 4 floats where vector loads read.
enum WorkOff {
  W_P = 0, W_p = 100, W_PA = 112, W_PB = 212, W_S = 252, W_GHX = 292, W_GT = 304,
  W_PRP = 328, W_QV = 340, W_SIZE = 352
};
// A stage's box-row terms, computed for every stage before the sweep into
// the stage's gain slots (region K, overwritten by the gains once used): the
// rows j = 0-3 (u) and 4-6 (v) of stage k.
constexpr int G_SIG = 0, G_CORR = 7, G_GHU = 14;
// Scalars of a slot: the carried barrier weight in, mu and eq out, c0-c4.
enum ScalarOff { SC_MUW = 0, SC_MU = 1, SC_EQ = 2, SC_C = 3, SC_SIZE = 8 };

// Offsets of a slot's arrays: floats from the slot's base, and jac-dtype
// elements from the jac base (the slot's base + `jac` floats).
struct TeamLayout {
  int gx, gu, bc, r, lub, uub, lxb, uxb, dx0;          // f32 payload
  int K, kf, rh, sul, suu, sxl, sxu, dx, du, zx, zu;   // IPM scratch
  int lul, luu, lxl, lxu;                              // carried duals
  int work, sc;                                        // work area, scalars
  int jac;                                             // end of the f32 part
  int hq, a, b;                                        // jac-dtype payload
  int bytes;                                           // sum of the arrays
  int stride;                                          // slot stride, floats
};

// Region `K`: the gains, K1's step inputs or the row directions.
__host__ __device__ inline int team_k_floats(int N) {
  const int gains = N * NU * NX;
  const int inputs = 2 * (N + 1) * NX + 2 * N * NU + (N + 1) * 3 + NX;
  const int dirs = 4 * N * NU + 4 * (N + 1) * 3;
  const int m = gains > inputs ? gains : inputs;
  return m > dirs ? m : dirs;
}

__host__ __device__ inline TeamLayout team_layout(int N, int jac_bytes) {
  TeamLayout L;
  int o = 0;
  // every array starts on 16 bytes, for the vector loads
  auto take = [&](int n) { const int at = o; o += (n + 3) / 4 * 4; return at; };
  L.gx = take((N + 1) * NX);
  L.gu = take(N * NU);
  L.bc = take(N * 6);
  L.r = take(N * NX);
  L.lub = take(N * NU);
  L.uub = take(N * NU);
  L.lxb = take((N + 1) * 3);
  L.uxb = take((N + 1) * 3);
  L.dx0 = take(NX);
  L.K = take(team_k_floats(N));
  L.kf = take(N * NU);
  L.rh = take(N * NX);
  L.sul = take(N * NU);
  L.suu = take(N * NU);
  L.sxl = take((N + 1) * 3);
  L.sxu = take((N + 1) * 3);
  L.zx = take((N + 1) * NX);
  L.zu = take(N * NU);
  L.lul = take(N * NU);
  L.luu = take(N * NU);
  L.lxl = take((N + 1) * 3);
  L.lxu = take((N + 1) * 3);
  // the work area is live in the backward sweep only, dx and du from the
  // rollout to pass B: they share space
  const int dxdu = (N + 1) * NX + N * NU;
  L.work = take(W_SIZE > dxdu ? W_SIZE : dxdu);
  L.dx = L.work;
  L.du = L.work + (N + 1) * NX;
  L.sc = take(SC_SIZE);
  L.jac = o;
  L.hq = 0;
  L.a = (N + 1) * 16;
  L.b = L.a + N * 40;
  const int jac_elems = L.b + N * 30;
  L.bytes = 4 * L.jac + jac_bytes * jac_elems;
  // pad so that neighbouring slots of a warp start TEAM banks apart
  int stride = (L.bytes + 3) / 4;
  stride += ((TEAM - stride % 32) % 32 + 32) % 32;
  L.stride = stride;
  return L;
}

// Launch geometry of a batch of B scenarios.
struct TeamGeom {
  int team, S, threads, smem;
  long long blocks;
};

__host__ __device__ inline TeamGeom team_geometry(int N, int jac_bytes, long long B) {
  const TeamLayout L = team_layout(N, jac_bytes);
  TeamGeom g;
  g.team = TEAM;
  long long S = SMEM_MAX / (4LL * L.stride);
  if (S > MAX_THREADS / TEAM) S = MAX_THREADS / TEAM;
  if (S > B) S = B;
  g.S = (int)S;
  g.threads = g.S * TEAM;
  g.smem = g.S * 4 * L.stride;
  g.blocks = g.S > 0 ? (B + g.S - 1) / g.S : 0;
  return g;
}

// The geometry as the ctypes mirror reads it (`_cuda.team_geometry`): out =
// [lanes a scenario, scenarios a block, threads a block, blocks,
// shared-memory bytes a block, bytes of a scenario's arrays, padded bytes a
// scenario].
inline void team_geometry_out(int N, int jac_bf16, long long B, long long* out) {
  const int jb = jac_bf16 ? 2 : 4;
  const TeamGeom g = team_geometry(N, jb, B);
  const TeamLayout L = team_layout(N, jb);
  const long long v[7] = {g.team, g.S, g.threads, g.blocks, g.smem, L.bytes, 4LL * L.stride};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// ---- one slot's arrays ----

// (stage, element) row-major array of one slot.
template <typename T>
struct SV {
  T* p;
  int d;
  __device__ __forceinline__ T& operator()(int k, int i) const { return p[k * d + i]; }
};

template <typename JT>
struct TeamPayload {
  SV<JT> hq, a, b;
  SV<float> gx, gu, bc, r, lub, uub, lxb, uxb, dx0;
};

// Slacks and duals of the box rows, or their directions (same geometry).
struct RowSet {
  SV<float> sul, suu, sxl, sxu, lul, luu, lxl, lxu;
};

template <typename JT>
struct Team {
  int t;          // lane in the team
  unsigned mask;  // the team's lanes in its warp
  TeamPayload<JT> q;
  SV<float> K, kf, rh, dx, du, zx, zu;
  RowSet bd;    // slacks and carried duals
  RowSet dirs;  // their directions (in region K)
  float* w;     // work area
  float* sc;    // scalars
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

template <typename JT>
__device__ inline Team<JT> team_at(float* slot, const TeamLayout& L, int N) {
  Team<JT> tm;
  tm.t = threadIdx.x % TEAM;
  const int lane = threadIdx.x & 31;
  tm.mask = ((1u << TEAM) - 1u) << (lane & ~(TEAM - 1));
  JT* j = reinterpret_cast<JT*>(slot + L.jac);
  tm.q.hq = SV<JT>{j + L.hq, 16};
  tm.q.a = SV<JT>{j + L.a, 40};
  tm.q.b = SV<JT>{j + L.b, 30};
  tm.q.gx = SV<float>{slot + L.gx, NX};
  tm.q.gu = SV<float>{slot + L.gu, NU};
  tm.q.bc = SV<float>{slot + L.bc, 6};
  tm.q.r = SV<float>{slot + L.r, NX};
  tm.q.lub = SV<float>{slot + L.lub, NU};
  tm.q.uub = SV<float>{slot + L.uub, NU};
  tm.q.lxb = SV<float>{slot + L.lxb, 3};
  tm.q.uxb = SV<float>{slot + L.uxb, 3};
  tm.q.dx0 = SV<float>{slot + L.dx0, NX};
  tm.K = SV<float>{slot + L.K, NU * NX};
  tm.kf = SV<float>{slot + L.kf, NU};
  tm.rh = SV<float>{slot + L.rh, NX};
  tm.dx = SV<float>{slot + L.dx, NX};
  tm.du = SV<float>{slot + L.du, NU};
  tm.zx = SV<float>{slot + L.zx, NX};
  tm.zu = SV<float>{slot + L.zu, NU};
  tm.bd = RowSet{SV<float>{slot + L.sul, NU}, SV<float>{slot + L.suu, NU},
                 SV<float>{slot + L.sxl, 3},  SV<float>{slot + L.sxu, 3},
                 SV<float>{slot + L.lul, NU}, SV<float>{slot + L.luu, NU},
                 SV<float>{slot + L.lxl, 3},  SV<float>{slot + L.lxu, 3}};
  float* d = slot + L.K;
  const int u = N * NU, x = (N + 1) * 3;
  tm.dirs = RowSet{SV<float>{d, NU},                 SV<float>{d + u, NU},
                   SV<float>{d + 4 * u, 3},          SV<float>{d + 4 * u + x, 3},
                   SV<float>{d + 2 * u, NU},         SV<float>{d + 3 * u, NU},
                   SV<float>{d + 4 * u + 2 * x, 3},  SV<float>{d + 4 * u + 3 * x, 3}};
  tm.w = slot + L.work;
  tm.sc = slot + L.sc;
  return tm;
}

// ---- staging between global memory (stage, element, B) and the slots ----

constexpr int STAGE_UNROLL = 16;  // loads in flight a thread while staging (jac dtype)

// One (rows, B) tensor of a launch and its array in the slots: `off` is the
// array's offset in a slot; `fold` (out only): dst = slot value + dst.
template <typename T>
struct Seg {
  T* g;
  int off, rows;
  bool fold;
};

// Copy each segment's rows of the block's S scenarios into their slots
// (`base` is slot 0, `stride` the slot stride in T). Thread tid serves slot
// tid % S and rows tid / S + j * TEAM (blockDim = S * TEAM), so neighbouring
// threads read neighbouring scenarios: each row is one contiguous run of S
// values. A thread keeps STAGE_UNROLL loads in flight. Slots past B get
// zeros.
template <typename T>
__device__ __forceinline__ T zero_of() { return stf<T>(0.0f); }

template <typename T, int NS>
__device__ inline void stage_in(T* base, int stride, const Seg<T> (&seg)[NS], int S, long long b0,
                                long long B) {
  const int s = threadIdx.x % S, r0 = threadIdx.x / S;
  const long long b = b0 + s;
  const bool live = b < B;
  T* const dst = base + s * stride;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const T* src = seg[i].g + b;
    const int rows = seg[i].rows, off = seg[i].off;
    for (int e0 = r0; e0 < rows; e0 += STAGE_UNROLL * TEAM) {
      T v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int e = e0 + u * TEAM;
        v[u] = live && e < rows ? src[(long long)e * B] : zero_of<T>();
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u)
        if (e0 + u * TEAM < rows) dst[off + e0 + u * TEAM] = v[u];
    }
  }
}

// The f32 segments by asynchronous copies (cp_async4): a thread issues every
// copy of its rows at once, and the caller waits with cp_async_wait_all()
// before its block barrier.
template <int NS>
__device__ inline void stage_in_async(float* base, int stride, const Seg<float> (&seg)[NS], int S,
                                      long long b0, long long B) {
  const int s = threadIdx.x % S, r0 = threadIdx.x / S;
  const long long b = b0 + s;
  const bool live = b < B;
  float* const dst = base + s * stride;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float* src = seg[i].g + b;
    const int rows = seg[i].rows, off = seg[i].off;
    for (int e = r0; e < rows; e += TEAM) {
      if (live)
        cp_async4(dst + off + e, src + (long long)e * B);
      else
        dst[off + e] = 0.0f;
    }
  }
}

// The reverse, from the slots to the tensors, folding where a segment says.
template <int NS>
__device__ inline void stage_out(const float* base, int stride, const Seg<float> (&seg)[NS], int S,
                                 long long b0, long long B) {
  const int s = threadIdx.x % S, r0 = threadIdx.x / S;
  const long long b = b0 + s;
  if (b >= B) return;
  const float* const src = base + s * stride;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float* const g = seg[i].g + b;
    const int rows = seg[i].rows, off = seg[i].off;
    const bool fold = seg[i].fold;
    for (int e0 = r0; e0 < rows; e0 += STAGE_UNROLL * TEAM) {
      float g0[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int e = e0 + u * TEAM;
        g0[u] = fold && e < rows ? g[(long long)e * B] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int e = e0 + u * TEAM;
        if (e < rows) {
          const float v = src[off + e];
          g[(long long)e * B] = fold ? v + g0[u] : v;
        }
      }
    }
  }
}

// ---- per-row algebra, lane by lane ----

// n jac-dtype values from a row aligned to A bytes (A = 16: a and hq rows;
// else 4: b rows, whose 30 values make 60 or 120 bytes).
template <int n, int A>
__device__ __forceinline__ void ldj(float* dst, const float* src) {
  if (A >= 16)
    ld4<n>(dst, src);
  else
    ld2<n>(dst, src);
}
__device__ __forceinline__ void bf16x2(unsigned u, float* dst) {
  dst[0] = __uint_as_float(u << 16);  // bf16 -> f32 is exact: the high half
  dst[1] = __uint_as_float(u & 0xffff0000u);
}
template <int n, int A>
__device__ __forceinline__ void ldj(float* dst, const __nv_bfloat16* src) {
  if (A >= 16) {
#pragma unroll
    for (int i = 0; i < n; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + i);
      bf16x2(u.x, dst + i);
      bf16x2(u.y, dst + i + 2);
      bf16x2(u.z, dst + i + 4);
      bf16x2(u.w, dst + i + 6);
    }
  } else {
#pragma unroll
    for (int i = 0; i < n; i += 2) bf16x2(*reinterpret_cast<const unsigned*>(src + i), dst + i);
  }
}

// sum over the box rows in loop order of x_lo * y_lo + x_up * y_up, where x
// takes the slack fields of X and y the dual fields of Y (c0 and c1: the
// slacks and duals; c2-c4: with their directions).
__device__ __forceinline__ float row_sum(const RowSet& X, const RowSet& Y, int N) {
  float acc = 0.0f;
  for (int k = 0; k <= N; ++k) {
    if (k < N) {  // a stage's four u rows with one wide load an array
      float sl[NU], ll[NU], su[NU], lu[NU];
      ld4<NU>(sl, &X.sul(k, 0));
      ld4<NU>(ll, &Y.lul(k, 0));
      ld4<NU>(su, &X.suu(k, 0));
      ld4<NU>(lu, &Y.luu(k, 0));
#pragma unroll
      for (int l = 0; l < NU; ++l) acc = acc + sl[l] * ll[l] + su[l] * lu[l];
    }
    for (int i = 0; i < 3; ++i)
      acc = acc + X.sxl(k, i) * Y.lxl(k, i) + X.sxu(k, i) * Y.lxu(k, i);
  }
  return acc;
}

// Stage k's blocks into registers, as load_blocks (ndp.cuh), with wide loads.
template <typename JT>
__device__ __forceinline__ void load_blocks_v(const TeamPayload<JT>& q, int k, Blocks& m) {
  float a[40], b[30], bc[6];
  ldj<40, 16>(a, &q.a(k, 0));
  ldj<30, 4>(b, &q.b(k, 0));
  ld2<6>(bc, &q.bc(k, 0));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j) {
      m.apq[i][j] = a[i * 4 + j];
      m.avq[i][j] = a[12 + i * 4 + j];
    }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) m.aqq[i][j] = a[24 + i * 4 + j];
  for (int i = 0; i < 3; ++i) {
    for (int l = 0; l < 3; ++l) {
      m.bp[i][l] = b[i * 3 + l];
      m.bv[i][l] = b[9 + i * 3 + l];
    }
    m.bp[i][3] = bc[i];
    m.bv[i][3] = bc[3 + i];
  }
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 3; ++l) m.bq[i][l] = b[18 + i * 3 + l];
}

// Row i of a stage's dynamics blocks, read from the slot for any row: A's
// row is a(k, 4i .. 4i+3) (apq rows 0-2, avq 3-5, aqq 6-9), B's is
// b(k, 3i .. 3i+2) plus the collective column bc(k, i) on rows 0-5.
struct RowAB {
  float a[4], b[3], bc;
};
template <typename JT>
__device__ __forceinline__ RowAB row_ab(const TeamPayload<JT>& q, int k, int i) {
  RowAB r;
  for (int j = 0; j < 4; ++j) r.a[j] = ldf(q.a(k, 4 * i + j));
  for (int l = 0; l < 3; ++l) r.b[l] = ldf(q.b(k, 3 * i + l));
  r.bc = i < 6 ? q.bc(k, i) : 0.0f;
  return r;
}

// Row i of dyn_step (ndp.cuh): (A dx + B du + rh)[i]; du null: zero
// control. One code path for the three kinds of row, with dyn_step's terms
// and order: rows 0-2 start from dx[i] + h dx[3+i], rows 3-5 from dx[i],
// rows 6-9 from the A term alone and have no collective term.
template <typename JT>
__device__ __forceinline__ float dyn_row(const TeamPayload<JT>& q, int k, float rh, float h,
                                         const float* dx, const float* du, int i) {
  const RowAB m = row_ab(q, k, i);
  const float* dq = dx + 6;
  const float ad = m.a[0] * dq[0] + m.a[1] * dq[1] + m.a[2] * dq[2] + m.a[3] * dq[3];
  const float base = i < 3 ? dx[i] + h * dx[3 + i] : dx[i];
  float x = i < 6 ? base + ad : ad;
  if (du) {
    float bd = m.b[0] * du[0] + m.b[1] * du[1] + m.b[2] * du[2];
    if (i < 6) bd = bd + m.bc * du[3];
    x = x + bd;
  }
  return x + rh;
}

// Row i of the stage defect rh (riccati_stage_core), one code path as
// dyn_row's.
template <typename JT>
__device__ __forceinline__ float defect_row(const TeamPayload<JT>& q, int k, float h,
                                            const float* zx, const float* zx1, const float* zu,
                                            const float* r, int i) {
  const RowAB m = row_ab(q, k, i);
  const float* zq = zx + 6;
  const float az = m.a[0] * zq[0] + m.a[1] * zq[1] + m.a[2] * zq[2] + m.a[3] * zq[3];
  float bz = m.b[0] * zu[0] + m.b[1] * zu[1] + m.b[2] * zu[2];
  if (i < 6) bz = bz + m.bc * zu[3];
  const float base = i < 3 ? zx[i] + h * zx[3 + i] : zx[i];
  const float x = i < 6 ? base + az : az;
  return x + bz + r[i] - zx1[i];
}

// The box rows of one kind, as element e of each of its arrays: the u rows
// (the (N, 4) arrays; the iterate's entry zu[e], its direction du[e]) or
// the v rows (the (N+1, 3) arrays; zx and dx at node e / 3, row 3 + e % 3).
// The slacks' and duals' directions live in region K (Team::dirs).
struct BoxRows {
  float *s_lo, *s_up, *l_lo, *l_up, *ds_lo, *ds_up, *dl_lo, *dl_up;
  const float *lo, *hi;
};

// f(rows, e, &iterate entry, &direction entry) for every box row this lane
// takes: the u rows, then the v rows, each kind one uniform loop.
template <typename JT, typename F>
__device__ __forceinline__ void for_box_rows(const Team<JT>& tm, int N, F&& f) {
  const RowSet &bd = tm.bd, &dr = tm.dirs;
  const BoxRows u{bd.sul.p, bd.suu.p, bd.lul.p, bd.luu.p, dr.sul.p, dr.suu.p,
                  dr.lul.p, dr.luu.p, tm.q.lub.p, tm.q.uub.p};
  const BoxRows x{bd.sxl.p, bd.sxu.p, bd.lxl.p, bd.lxu.p, dr.sxl.p, dr.sxu.p,
                  dr.lxl.p, dr.lxu.p, tm.q.lxb.p, tm.q.uxb.p};
  for (int e = tm.t; e < N * NU; e += TEAM) f(u, e, tm.zu.p + e, tm.du.p + e, true);
  for (int e = tm.t; e < (N + 1) * 3; e += TEAM) {
    const int k = e / 3, iz = k * NX + 3 + (e - 3 * k);
    f(x, e, tm.zx.p + iz, tm.dx.p + iz, false);
  }
}

// The sum of squares of a 10-vector in order (the r2 terms).
__device__ __forceinline__ float sq10(const float* v) {
  float s = v[0] * v[0];
  for (int i = 1; i < NX; ++i) s = s + v[i] * v[i];
  return s;
}

__device__ __forceinline__ float team_min(float v, unsigned mask) {
  for (int o = TEAM / 2; o > 0; o >>= 1) v = nmin(v, __shfl_xor_sync(mask, v, o));
  return v;
}

// ---- K1 phase 1: the linearization, stage-parallel ----

// The step inputs staged in region K: xb (N+1, 10), ub (N, 4), xr, ur,
// fd (N+1, 3), x0 (10).
struct StepIn {
  const float *xb, *ub, *xr, *ur, *fd, *x0;
};

__device__ inline StepIn step_in(float* kreg, int N) {
  StepIn s;
  s.xb = kreg;
  s.ub = s.xb + (N + 1) * NX;
  s.xr = s.ub + N * NU;
  s.ur = s.xr + (N + 1) * NX;
  s.fd = s.ur + N * NU;
  s.x0 = s.fd + (N + 1) * 3;
  return s;
}

// The payload at the iterates, as linearize_scenario (ndp.cuh) writes it:
// lane t takes stages t, t + TEAM, ..., the stage N being the terminal.
template <typename JT>
__device__ __forceinline__ void team_linearize(const Team<JT>& tm, const StepIn& in, bool with_dist,
                               const StepConsts& c) {
  const int N = c.n_stages;
  const TeamPayload<JT>& w = tm.q;
  for (int k = tm.t; k <= N; k += TEAM) {
    const float* x = in.xb + k * NX;
    if (k < N) {
      const float* u = in.ub + k * NU;
      float hq[16], gx[NX], gu[NU], a40[40], b30[30], bc6[6], r[NX];
      lin_stage_terms(x, x + NX, u, in.xr + k * NX, in.ur + k * NU,
                      with_dist ? in.fd + k * 3 : nullptr, c, hq, gx, gu, a40, b30, bc6, r);
      for (int j = 0; j < 16; ++j) w.hq(k, j) = stf<JT>(hq[j]);
      for (int i = 0; i < NX; ++i) {
        w.gx(k, i) = gx[i];
        w.r(k, i) = r[i];
      }
      for (int l = 0; l < NU; ++l) w.gu(k, l) = gu[l];
      for (int j = 0; j < 40; ++j) w.a(k, j) = stf<JT>(a40[j]);
      for (int j = 0; j < 30; ++j) w.b(k, j) = stf<JT>(b30[j]);
      for (int j = 0; j < 6; ++j) w.bc(k, j) = bc6[j];
      for (int l = 0; l < NU; ++l) {
        w.lub(k, l) = c.u_lo[l] - u[l];
        w.uub(k, l) = c.u_hi[l] - u[l];
      }
      for (int i = 0; i < 3; ++i) {
        w.lxb(k, i) = k == 0 ? -c.big : c.v_lo[i] - x[3 + i];
        w.uxb(k, i) = k == 0 ? c.big : c.v_hi[i] - x[3 + i];
      }
    } else {
      float hqT[16], gxT[NX];
      lin_terminal_terms(x, in.xr + N * NX, c, hqT, gxT);
      for (int j = 0; j < 16; ++j) w.hq(N, j) = stf<JT>(hqT[j]);
      for (int i = 0; i < NX; ++i) {
        w.gx(N, i) = gxT[i];
        w.dx0(0, i) = in.x0[i] - in.xb[i];
      }
      for (int i = 0; i < 3; ++i) {
        w.lxb(N, i) = -c.big;
        w.uxb(N, i) = c.big;
      }
    }
  }
  tm.sync();
  team_clock(CK_LINEARIZE);
}

// ---- the backward Riccati sweep with the slack elimination ----

// The terminal cost-to-go from node N (the views' index of the last node):
// P and p in the work area, from hq, gx and zx at node N and the node's
// box-row terms at W_GT.
template <typename JT>
__device__ __forceinline__ void team_terminal(const Team<JT>& tm, int N, const StepConsts& c) {
  const int t = tm.t;
  const TeamPayload<JT>& q = tm.q;
  float* const w = tm.w;
  float* const P = w + W_P;
  float* const p = w + W_p;
  for (int i = t; i < NX; i += TEAM) {
    const float* zxT = &tm.zx(N, 0);
    float* Pi = P + i * NX;
    for (int j = 0; j < NX; ++j) Pi[j] = 0.0f;
    if (i < 6) {
      Pi[i] = c.diag6_term[i];
      p[i] = q.gx(N, i) + c.diag6_term[i] * zxT[i];
      if (i >= 3) {
        Pi[i] = Pi[i] + w[W_GT + G_SIG + 1 + i];
        p[i] = p[i] + w[W_GT + G_CORR + 1 + i];
      }
    } else {
      const int a = i - 6;
      for (int j = 0; j < 4; ++j) Pi[6 + j] = ldf(q.hq(N, a * 4 + j));
      p[i] = q.gx(N, i) + (ldf(q.hq(N, a * 4 + 0)) * zxT[6] + ldf(q.hq(N, a * 4 + 1)) * zxT[7] +
                           ldf(q.hq(N, a * 4 + 2)) * zxT[8] + ldf(q.hq(N, a * 4 + 3)) * zxT[9]);
    }
  }
  tm.sync();
  team_clock(CK_BWD_TERMINAL);
}

// One backward stage k: gains K(k), kf(k) from P, p (updated in place in the
// work area), with the stage's box-row terms at K(k, 0..19) (GlueOff) and its
// defects at rh(k). Three phases, one team barrier each.
template <typename JT>
__device__ __forceinline__ void team_stage(const Team<JT>& tm, int k, const StepConsts& c) {
  const int t = tm.t;
  const float h = c.h;
  const TeamPayload<JT>& q = tm.q;
  float* const w = tm.w;
  float* const P = w + W_P;
  float* const p = w + W_p;

  // the stage's blocks in registers, indexed by constants only (a row
  // that differs between lanes reads the slot: row_ab)
  Blocks m;
  load_blocks_v(q, k, m);
  // registers for what every lane reads in full, the slot for what a lane
  // reads at its own row (an index that differs between lanes must not
  // index a register array, which would go to local memory)
  float rh[NX], G[20];
  ld2<NX>(rh, &tm.rh(k, 0));
  ld4<20>(G, &tm.K(k, 0));  // the stage's box-row terms (GlueOff)
  const float* Gs = &tm.K(k, 0);
  const float* zxk = &tm.zx(k, 0);
  auto Hq = [&](int i, int j) { return ldf(q.hq(k, i * 4 + j)); };

  // B: lane i: P rh + p, row i of PA = P A and of PB = P B, ghat_x
  for (int i = t; i < NX; i += TEAM) {
    float Pi[NX];
    ld2<NX>(Pi, P + i * NX);
    const float gxi = q.gx(k, i), pi = p[i];
    float s = Pi[0] * rh[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) s = s + Pi[j] * rh[j];
    const float prp = s + pi;
    float PA[NX], PB[NU];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      PA[j] = Pi[j];
      PA[3 + j] = h * Pi[j] + Pi[3 + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      PA[6 + j] = (Pi[0] * m.apq[0][j] + Pi[1] * m.apq[1][j] + Pi[2] * m.apq[2][j]) +
                  (Pi[3] * m.avq[0][j] + Pi[4] * m.avq[1][j] + Pi[5] * m.avq[2][j]) +
                  (Pi[6] * m.aqq[0][j] + Pi[7] * m.aqq[1][j] + Pi[8] * m.aqq[2][j] + Pi[9] * m.aqq[3][j]);
#pragma unroll
    for (int l = 0; l < NU; ++l) {
      float sb = (Pi[0] * m.bp[0][l] + Pi[1] * m.bp[1][l] + Pi[2] * m.bp[2][l]) +
                 (Pi[3] * m.bv[0][l] + Pi[4] * m.bv[1][l] + Pi[5] * m.bv[2][l]);
      if (l < 3)
        sb = sb + (Pi[6] * m.bq[0][l] + Pi[7] * m.bq[1][l] + Pi[8] * m.bq[2][l] + Pi[9] * m.bq[3][l]);
      PB[l] = sb;
    }
    float g;
    if (i < 6) {
      g = gxi + c.diag6_stage[i] * zxk[i];
      if (i >= 3) g = g + Gs[G_CORR + 1 + i];
    } else {
      const int a = i - 6;
      const float* zq = zxk + 6;
      g = gxi + (Hq(a, 0) * zq[0] + Hq(a, 1) * zq[1] + Hq(a, 2) * zq[2] + Hq(a, 3) * zq[3]);
    }
    w[W_PRP + i] = prp;
#pragma unroll
    for (int j = 0; j < NX; ++j) w[W_PA + j * NX + i] = PA[j];
#pragma unroll
    for (int l = 0; l < NU; ++l) w[W_PB + l * NX + i] = PB[l];
    w[W_GHX + i] = g;
  }
  tm.sync();
  team_clock(CK_BWD_B);

  // C: every lane forms Rh = B^T PB + diag (the same expressions) and rv,
  // factors Rh (chol4) and forms A_q^T Prp; job j < 10 (the lane's jobs are
  // t, t + TEAM, ...): column j of S = B^T PA and of Qh (upper part, over
  // PA_T's row j), qv[j], and gain column j; job 10: kf
  {
    float pr[NX + 2], PBc[NU][NX];
    ld4<NX + 2>(pr, w + W_PRP);  // Prp and two floats of padding
#pragma unroll
    for (int mm = 0; mm < NU; ++mm) ld2<NX>(PBc[mm], w + W_PB + mm * NX);
    float R[4][4], L[4][4], Ld[4], rv[NU];
#pragma unroll
    for (int mm = 0; mm < NU; ++mm)
#pragma unroll
      for (int l = 0; l <= mm; ++l) {
        float v = bt_dot(m, PBc[mm], l);
        if (l == mm) v = v + (c.rdiag_stage[l] + G[G_SIG + l]);
        R[l][mm] = v;
        R[mm][l] = v;
      }
#pragma unroll
    for (int l = 0; l < NU; ++l) rv[l] = G[G_GHU + l] + bt_dot(m, pr, l);
    chol4(R, L, Ld);
    float qq[4];  // A_q^T Prp, for the q rows of qv
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qq[i] = (m.apq[0][i] * pr[0] + m.apq[1][i] * pr[1] + m.apq[2][i] * pr[2]) +
              (m.avq[0][i] * pr[3] + m.avq[1][i] * pr[4] + m.avq[2][i] * pr[5]) +
              (m.aqq[0][i] * pr[6] + m.aqq[1][i] * pr[7] + m.aqq[2][i] * pr[8] +
               m.aqq[3][i] * pr[9]);
    for (int job = t; job <= NX; job += TEAM) {
      float rhs[NU], sol[NU];  // S's column j, or rv for kf
#pragma unroll
      for (int l = 0; l < NU; ++l) rhs[l] = rv[l];
      if (job < NX) {
        const int j = job;
        float col[NX];
        ld2<NX>(col, w + W_PA + j * NX);
        const float ghx = w[W_GHX + j];
#pragma unroll
        for (int l = 0; l < NU; ++l) rhs[l] = bt_dot(m, col, l);
        float Qc[NX];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          Qc[i] = col[i];
          Qc[3 + i] = h * col[i] + col[3 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Qc[6 + i] = (m.apq[0][i] * col[0] + m.apq[1][i] * col[1] + m.apq[2][i] * col[2]) +
                      (m.avq[0][i] * col[3] + m.avq[1][i] * col[4] + m.avq[2][i] * col[5]) +
                      (m.aqq[0][i] * col[6] + m.aqq[1][i] * col[7] + m.aqq[2][i] * col[8] +
                       m.aqq[3][i] * col[9]);
        // the diagonal additions in Qh's order (predicated on the lane's
        // column, so that Qc keeps constant indices); the q rows below
        // the diagonal (6 + i > j) are never read
        // (from the registers: the gain solves below overwrite G's slots)
        const float sigx = j == 3 ? G[G_SIG + 4] : j == 4 ? G[G_SIG + 5] : G[G_SIG + 6];
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          if (r == j) Qc[r] = Qc[r] + c.diag6_stage[r];
          if (r >= 3 && r == j) Qc[r] = Qc[r] + sigx;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (6 + i <= j) Qc[6 + i] = Qc[6 + i] + Hq(i, j - 6);
        const float* Ps = w + W_PRP;
        float qv;
        if (j < 3)
          qv = ghx + Ps[j];
        else if (j < 6)
          qv = ghx + h * Ps[j - 3] + Ps[j];
        else
          qv = ghx + (j == 6 ? qq[0] : j == 7 ? qq[1] : j == 8 ? qq[2] : qq[3]);
#pragma unroll
        for (int l = 0; l < NU; ++l) w[W_S + l * NX + j] = rhs[l];
        st2<NX>(w + W_PA + j * NX, Qc);
        w[W_QV + j] = qv;
      }
      // one solve path for the gain columns and kf
      chol4_solve(L, Ld, rhs, sol);
      float* const out = job < NX ? &tm.K(k, job) : &tm.kf(k, 0);
      const int os = job < NX ? NX : 1;
#pragma unroll
      for (int l = 0; l < NU; ++l) out[l * os] = -sol[l];
    }
  }
  tm.sync();
  team_clock(CK_BWD_C);

  // E: lane i: row i of P = Qh + S^T K (upper, mirrored), p = qv + S^T kf
  {
    float Kr[NU * NX], kf[NU];
    ld4<NU * NX>(Kr, &tm.K(k, 0));
    ld4<NU>(kf, &tm.kf(k, 0));
    for (int i = t; i < NX; i += TEAM) {
      const float s0 = w[W_S + i], s1 = w[W_S + NX + i], s2 = w[W_S + 2 * NX + i],
                  s3 = w[W_S + 3 * NX + i];
      const float qv = w[W_QV + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        if (j < i) continue;
        const float v = w[W_PA + j * NX + i] +
                        (s0 * Kr[j] + s1 * Kr[NX + j] + s2 * Kr[2 * NX + j] + s3 * Kr[3 * NX + j]);
        P[i * NX + j] = v;
        P[j * NX + i] = v;
      }
      p[i] = qv + (s0 * kf[0] + s1 * kf[1] + s2 * kf[2] + s3 * kf[3]);
    }
  }
  tm.sync();
  team_clock(CK_BWD_E);
}

// Gains K, kf and defects rh of every stage at the iterate (zx, zu); every
// lane returns the sum of rh^2 over the stages, in loop order.
template <typename JT>
__device__ __forceinline__ float team_backward(const Team<JT>& tm, float mu, const StepConsts& c) {
  const int N = c.n_stages, t = tm.t;
  const float h = c.h;
  const TeamPayload<JT>& q = tm.q;
  float* const w = tm.w;

  // Every stage's box-row terms and defect rows first: they depend on the
  // iterate only, so they need no barrier between stages. The terms of
  // stage k go to its gain slots (GlueOff, row j: 0-3 u, 4-6 v), node N's
  // to W_GT.
  for_box_rows(tm, N, [&](const BoxRows& a, int e, float* v, float*, bool u) {
    const int k = u ? e / NU : e / 3, j = u ? e - NU * k : NU + e - 3 * k;
    float* g = k < N ? &tm.K(k, 0) : w + W_GT;
    const Glue gl = glue_pair(*v, a.lo[e], a.hi[e], a.s_lo[e], a.s_up[e], a.l_lo[e], a.l_up[e], mu);
    g[G_SIG + j] = gl.sig;
    g[G_CORR + j] = gl.corr;
    if (u) g[G_GHU + j] = q.gu(k, j) + c.rdiag_stage[j] * *v + gl.corr;
  });
#pragma unroll 2
  for (int job = t; job < NX * N; job += TEAM) {
    const int k = job / NX, i = job - NX * k;
    tm.rh(k, i) = defect_row(q, k, h, &tm.zx(k, 0), &tm.zx(k + 1, 0), &tm.zu(k, 0), &q.r(k, 0), i);
  }
  tm.sync();
  float r2 = 0.0f;
  for (int k = N - 1; k >= 0; --k) r2 = r2 + sq10(&tm.rh(k, 0));
  team_clock(CK_BWD_A);

  team_terminal(tm, N, c);
  for (int k = N - 1; k >= 0; --k) team_stage(tm, k, c);
  return r2;
}

// ---- the whole IPM (ops/pallas/ipm_whole.py) ----

__device__ inline void slack_init_pair(float lo, float hi, float v, float s_min, float& s_lo,
                                       float& s_up) {
  const float rng = hi - lo;
  const float floor_ = nmin(s_min * nmin(rng, 1e3f), 0.5f * rng);
  s_lo = nmax(fabsf(v - lo), floor_);
  s_up = nmax(fabsf(hi - v), floor_);
}

// The whole warm-started IPM over the slot's payload: zero-control start,
// slacks and dual warm mixing, then num_iters x (backward sweep, forward
// rollout, step ratios and complementarity partials, pass B, barrier
// update). The carried mu is sc[SC_MUW] (< 0: cold); the duals in bd update
// in place; zx/zu end as the primal deltas; mu and eq go to sc.
template <typename JT>
__device__ __forceinline__ void team_ipm(const Team<JT>& tm, const StepConsts& c) {
  const int N = c.n_stages, t = tm.t;
  const TeamPayload<JT>& q = tm.q;
  const RowSet& bd = tm.bd;
  const RowSet& dirs = tm.dirs;
  const float mu_w = tm.sc[SC_MUW];
  const bool cold = mu_w < 0.0f;
  const float n_cons = (float)(2 * N * NU + 2 * (N + 1) * 3);
  auto mix_lam = [&](float carried, float sl) { return cold ? c.mu0 / sl : nmax(carried, 1e-12f); };

  // zero-control dynamics-exact start
  for (int i = t; i < NX; i += TEAM) tm.zx(0, i) = q.dx0(0, i);
  tm.sync();
  for (int k = 0; k < N; ++k) {
    for (int i = t; i < NX; i += TEAM)
      tm.zx(k + 1, i) = dyn_row(q, k, q.r(k, i), c.h, &tm.zx(k, 0), nullptr, i);
    tm.sync();
  }
  // slacks at the zero iterate (zu = 0), dual warm mixing
  for_box_rows(tm, N, [&](const BoxRows& a, int e, float* v, float*, bool u) {
    float s_lo, s_up;
    slack_init_pair(a.lo[e], a.hi[e], u ? 0.0f : *v, c.s_min, s_lo, s_up);
    if (u) *v = 0.0f;
    a.s_lo[e] = s_lo;
    a.s_up[e] = s_up;
    a.l_lo[e] = mix_lam(a.l_lo[e], s_lo);
    a.l_up[e] = mix_lam(a.l_up[e], s_up);
  });
  tm.sync();
  // complementarity-derived barrier start (every lane, the same sum)
  const float c0 = row_sum(bd, bd, N);
  float mu = cold ? c.mu0 : nmin(nmax(c.sigma * c0 / n_cons, c.mu_min), c.mu0);
  team_clock(CK_START);

  float res2 = 0.0f, ap = 0.0f;
  for (int it = 0; it < c.num_iters; ++it) {
    float r2 = team_backward(tm, mu, c);
    for (int i = t; i < NX; i += TEAM) tm.dx(0, i) = q.dx0(0, i) - tm.zx(0, i);
    tm.sync();
    r2 = r2 + sq10(&tm.dx(0, 0));

    // pass A: the rollout from the dx0 residual ...
    for (int k = 0; k < N; ++k) {
      // lane l < 4 forms du[l] = K[l] dx + kf[l] and stores it, the team
      // reads all four by shuffles, and lane i takes row i of the dynamics:
      // one barrier a stage
      float sdu = 0.0f;
      if (t < NU) {
        float kr[NX], dxk[NX];
        ld2<NX>(kr, &tm.K(k, t * NX));
        ld2<NX>(dxk, &tm.dx(k, 0));
        sdu = kr[0] * dxk[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) sdu = sdu + kr[j] * dxk[j];
        sdu = sdu + tm.kf(k, t);
        tm.du(k, t) = sdu;
      }
      float du[NU];
#pragma unroll
      for (int l = 0; l < NU; ++l) du[l] = __shfl_sync(tm.mask, sdu, l, TEAM);
      for (int i = t; i < NX; i += TEAM)
        tm.dx(k + 1, i) = dyn_row(q, k, tm.rh(k, i), c.h, &tm.dx(k, 0), du, i);
      tm.sync();
    }
    team_clock(CK_ROLLOUT);
    // ... then every box row's directions and step ratios (the directions
    // over the gains, which are spent)
    float apr = 2.0f, adr = 2.0f;
    for_box_rows(tm, N, [&](const BoxRows& a, int e, float* v, float* d, bool) {
      const float s_lo = a.s_lo[e], s_up = a.s_up[e], l_lo = a.l_lo[e], l_up = a.l_up[e];
      const Glue g = glue_pair(*v, a.lo[e], a.hi[e], s_lo, s_up, l_lo, l_up, mu);
      const Steps st = bound_steps(*d, g, s_lo, s_up, l_lo, l_up, c.tau);
      apr = nmin(apr, st.ap);
      adr = nmin(adr, st.ad);
      a.ds_lo[e] = st.ds_lo;
      a.ds_up[e] = st.ds_up;
      a.dl_lo[e] = st.dl_lo;
      a.dl_up[e] = st.dl_up;
    });
    ap = nmin(team_min(apr, tm.mask), 1.0f);
    const float ad = nmin(team_min(adr, tm.mask), 1.0f);
    tm.sync();
    team_clock(CK_ROWS);
    // the complementarity partials: lane a sums c_{a+1} over the rows in
    // loop order (c1: s l, c2: ds l, c3: s dl, c4: ds dl)
    {
      // select field by field, by value: selecting between the two structs
      // by reference would put them in local memory
      const bool ds = t & 1, dl = t & 2;
      auto pick = [](bool d, SV<float> a, SV<float> b) { return SV<float>{d ? a.p : b.p, a.d}; };
      const RowSet X{pick(ds, dirs.sul, bd.sul), pick(ds, dirs.suu, bd.suu),
                     pick(ds, dirs.sxl, bd.sxl), pick(ds, dirs.sxu, bd.sxu),
                     bd.lul, bd.luu, bd.lxl, bd.lxu};
      const RowSet Y{bd.sul, bd.suu, bd.sxl, bd.sxu,
                     pick(dl, dirs.lul, bd.lul), pick(dl, dirs.luu, bd.luu),
                     pick(dl, dirs.lxl, bd.lxl), pick(dl, dirs.lxu, bd.lxu)};
      const float ca = row_sum(X, Y, N);
      if (t < 4) tm.sc[SC_C + t] = ca;
    }
    tm.sync();
    team_clock(CK_ROW_SUMS);
    // pass B: the step on the slacks, duals and primal deltas
    for_box_rows(tm, N, [&](const BoxRows& a, int e, float*, float*, bool) {
      a.s_lo[e] = a.s_lo[e] + ap * a.ds_lo[e];
      a.s_up[e] = a.s_up[e] + ap * a.ds_up[e];
      a.l_lo[e] = a.l_lo[e] + ad * a.dl_lo[e];
      a.l_up[e] = a.l_up[e] + ad * a.dl_up[e];
    });
    for (int e = t; e < (N + 1) * NX; e += TEAM) tm.zx.p[e] = tm.zx.p[e] + ap * tm.dx.p[e];
    for (int e = t; e < N * NU; e += TEAM) tm.zu.p[e] = tm.zu.p[e] + ap * tm.du.p[e];
    tm.sync();

    const float* cs = tm.sc + SC_C;
    const float comp = (cs[0] + ap * cs[1] + ad * cs[2] + ap * ad * cs[3]) / n_cons;
    mu = nmax(c.sigma * comp, c.mu_min);
    res2 = r2;
    tm.sync();  // cs is rewritten by the next iteration
    team_clock(CK_PASS_B);
  }
  if (t == 0) {
    tm.sc[SC_MU] = mu;
    tm.sc[SC_EQ] = (1.0f - ap) * sqrtf(res2);
  }
}

}  // namespace ndp
