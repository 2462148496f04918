// The streamed backward Riccati sweep for Hopper (sm_90a), shared by K4
// (riccati_iter.cu, the glue-fused sweep) and K6 (riccati_sweep.cu, the
// sweep with the box rows' terms given): one kernel body over two sources.
//
// A team of TEAM lanes owns a scenario, S scenarios a block, and only the
// current stage's inputs and the sweep's working set live on the SM: a
// producer warp (after the compute threads' whole warps) loads stage k-1's
// rows into a landing buffer (one tensor copy a field: its f32 rows, then
// the curvature payload in the jac dtype) while the teams compute stage k,
// and stores stage k+1's gains, kf and defects from one of two output
// buffers; the compute threads never touch global memory. Each team moves
// its scenario's column into its stage buffer (`unpack`) and runs
// `stage_sweep`: the stage's box-row terms and defect rows when it arrives
// (A), then `ndp_team.cuh`'s `team_stage` phases B, C and E over P, p and
// the work area (W_*, 352 floats) in shared memory. Node k+1's iterate,
// which the defects need, is kept from the stage before (ZX1). Every output
// element is computed by one lane with the one-thread expression and order,
// and a NaN stays in its slot.
//
// A source (`GlueSrc` in riccati_iter.cu, `GivenSrc` in riccati_sweep.cu)
// names what differs:
//   Ptrs, field_ptr(p, f), out_ptr(p, o)  the launch's tensors;
//   F_IN, field_rows/_jac/_node/_once/_slot(f)
//                         the input fields in landing order, their rows a
//                         stage, whether they hold the jac dtype, N + 1
//                         stages (a node field), one row loaded with the
//                         terminal node and never unpacked (mu), and their
//                         offsets in the stage buffer (jac-dtype elements
//                         from JAC for the curvature payload);
//   O_N, out_rows/_once(o)
//                         the output fields (K, kf, rh first, as the stage
//                         buffer holds them from KO) and whether one is
//                         written once, with stage 0's (res2);
//   GX GU BC R ZX ZU KO KFO RHO JAC
//                         the stage buffer's slots `stage_team` and
//                         `stage_sweep` read (floats from its start; every
//                         array on 16 bytes);
//   Rows, rows(once, s)   the row-term source of `stage_sweep`, from the
//                         landing buffer's once fields of scenario s;
//   RES2                  whether the sweep's sum of squared defects goes
//                         out (with stage 0's outputs, field O_N - 1);
//   MAX_THREADS           compute threads a block, at most.
// Batches whose rows the tensor copies cannot take (B not a multiple of VEC,
// or a tensor not on 16 bytes) run the caller's one-thread sweep instead;
// a tensor map that cannot be made where the rows are aligned is an error.
#pragma once

#include "ndp_team.cuh"

namespace ndp {
namespace stream {

constexpr int OUT_ROWS = NU * NX + NU + NX;          // K, kf, rh
constexpr int J_HQ = 0, J_A = 16, J_B = 56, J_N = 86;  // jac-dtype elements of a stage
constexpr int VEC = 8;  // scenarios 16 bytes hold of bf16
// S: a multiple of this when there are that many, so that the compute
// threads fill whole warps and rows take whole 16-byte copies.
constexpr int S_STEP = VEC * TEAM > 32 ? VEC : 32 / TEAM;
__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// A stage buffer: the source's arrays up to JAC, then the curvature payload
// in the jac dtype (hq at element 0, a at 16, b at 56).
template <typename Src>
__host__ __device__ constexpr int buf_floats(int jac_bytes) {
  return Src::JAC + (J_N * jac_bytes + 15) / 16 * 4;
}
// A slot: the stage buffer, the work area of `team_stage` (W_*), node k+1's
// iterate (ZX1).
template <typename Src>
__host__ __device__ constexpr int work_at(int jac_bytes) { return buf_floats<Src>(jac_bytes); }
constexpr int ZX1 = W_SIZE, WORK = W_SIZE + 12;
template <typename Src>
__host__ __device__ constexpr int slot_floats(int jac_bytes) {
  return work_at<Src>(jac_bytes) + WORK;
}
// The slot stride in floats: padded to 4 banks mod 32, so that the teams of
// a warp read their 16-byte rows from disjoint banks.
template <typename Src>
__host__ __device__ constexpr int slot_stride(int jac_bytes) {
  return slot_floats<Src>(jac_bytes) + ((4 - slot_floats<Src>(jac_bytes) % 32) % 32 + 32) % 32;
}
// The f32 input fields' rows a stage, and the output fields'.
template <typename Src>
__host__ __device__ constexpr int in_f32_rows() {
  int n = 0;
  for (int f = 0; f < Src::F_IN; ++f) n += Src::field_jac(f) ? 0 : Src::field_rows(f);
  return n;
}
template <typename Src>
__host__ __device__ constexpr int out_rows_all() {
  int n = 0;
  for (int o = 0; o < Src::O_N; ++o) n += Src::out_rows(o);
  return n;
}
template <typename Src>
__host__ __device__ constexpr bool field_terminal(int f) {
  return Src::field_node(f) || Src::field_once(f);
}

// A block's shared memory, byte offsets: its S slots; the landing buffer,
// one stage's input rows, each field a box [rows][S] on 128 bytes; two
// output buffers (stage k's in buffer k & 1), each output field a box
// [rows][S] on 128 bytes; the landing buffer's mbarrier.
template <typename Src>
struct Layout {
  int in[Src::F_IN], out[2][Src::O_N], bar, bytes;
};
template <typename Src>
__host__ __device__ inline Layout<Src> layout(int S, int jac_bytes) {
  Layout<Src> L;
  int o = round128(4 * S * slot_stride<Src>(jac_bytes));
#pragma unroll
  for (int f = 0; f < Src::F_IN; ++f) {
    L.in[f] = o;
    o += round128((Src::field_jac(f) ? jac_bytes : 4) * S * Src::field_rows(f));
  }
  for (int b = 0; b < 2; ++b)
    for (int q = 0; q < Src::O_N; ++q) {
      L.out[b][q] = o;
      o += round128(4 * S * Src::out_rows(q));
    }
  L.bar = o;
  L.bytes = o + 16;
  return L;
}
// A scenario's bytes: its slot, its columns of the landing and output
// buffers.
template <typename Src>
__host__ __device__ constexpr int scenario_bytes(int jac_bytes) {
  return 4 * (slot_floats<Src>(jac_bytes) + in_f32_rows<Src>() + 2 * out_rows_all<Src>()) +
         jac_bytes * J_N;
}

// S scenarios a block (as many as fit, at most MAX_THREADS / TEAM and B, a
// multiple of S_STEP when there are that many), their compute threads in
// whole warps, then the producer warp.
template <typename Src>
__host__ __device__ inline TeamGeom geometry(int jac_bytes, long long B) {
  TeamGeom g;
  g.team = TEAM;
  long long S = Src::MAX_THREADS / TEAM;
  if (S > B) S = B;
  while (S > 1 && layout<Src>((int)S, jac_bytes).bytes > SMEM_MAX) --S;
  if (S >= S_STEP) S -= S % S_STEP;
  g.S = (int)S;
  g.threads = (g.S * TEAM + 31) / 32 * 32 + 32;
  g.smem = layout<Src>(g.S, jac_bytes).bytes;
  g.blocks = g.S > 0 ? (B + g.S - 1) / g.S : 0;
  return g;
}

// The geometry as the ctypes mirror reads it (`_cuda.sweep_geometry`): out =
// [lanes a scenario, scenarios a block, threads a block, blocks, shared-
// memory bytes a block, bytes of a scenario's arrays (its slot and columns
// of the landing and output buffers), bytes of its padded slot]. The slot
// holds one stage, so it does not depend on the number of stages.
template <typename Src>
inline void geometry_out(int jac_bf16, long long B, long long* out) {
  const int jb = jac_bf16 ? 2 : 4;
  const TeamGeom g = geometry<Src>(jb, B);
  const long long v[7] = {g.team, g.S, g.threads, g.blocks, g.smem, scenario_bytes<Src>(jb),
                          4LL * slot_stride<Src>(jb)};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// The tensors' maps for tensor copies: the input fields, then the outputs.
template <typename Src>
struct Maps {
  TensorMap in[Src::F_IN], out[Src::O_N];
};

// The team's views of stage buffer `d` as stage 0 of a one-stage payload
// (what `team_stage` and `team_terminal` index), over work area `w`.
template <typename Src, typename JT>
__device__ __forceinline__ Team<JT> stage_team(float* d, float* w) {
  Team<JT> tm;
  tm.t = threadIdx.x % TEAM;
  const int lane = threadIdx.x & 31;
  tm.mask = ((1u << TEAM) - 1u) << (lane & ~(TEAM - 1));
  JT* j = reinterpret_cast<JT*>(d + Src::JAC);
  tm.q.hq = SV<JT>{j + J_HQ, 16};
  tm.q.a = SV<JT>{j + J_A, 40};
  tm.q.b = SV<JT>{j + J_B, 30};
  tm.q.gx = SV<float>{d + Src::GX, NX};
  tm.q.gu = SV<float>{d + Src::GU, NU};
  tm.q.bc = SV<float>{d + Src::BC, 6};
  tm.q.r = SV<float>{d + Src::R, NX};
  tm.K = SV<float>{d + Src::KO, NU * NX};
  tm.kf = SV<float>{d + Src::KFO, NU};
  tm.rh = SV<float>{d + Src::RHO, NX};
  tm.zx = SV<float>{d + Src::ZX, NX};
  tm.zu = SV<float>{d + Src::ZU, NU};
  tm.w = w;
  return tm;
}

// One stage of the streamed sweep over buffer d: A, job j < 7: box row j's
// terms (u rows 0-3, v rows 4-6) into the gain slots (GlueOff), job i < 10:
// defect row i from the stage's iterate and node k+1's (ZX1); then node k's
// iterate becomes ZX1 and `team_stage` forms the gains. Returns r2 plus this
// stage's sum of squared defects (every lane, in loop order).
template <typename Src, typename JT, typename RowTerms>
__device__ __forceinline__ float stage_sweep(const Team<JT>& tm, float* d, const RowTerms& rows,
                                             float r2, const StepConsts& c) {
  const int t = tm.t;
  float* const w = tm.w;
  for (int j = t; j < NU + 3; j += TEAM) {
    const bool u = j < NU;
    const int e = u ? j : j - NU;
    const float v = d[u ? Src::ZU + e : Src::ZX + 3 + e];
    float sig, corr;
    rows.terms(d, u, e, v, sig, corr);
    float* const g = d + Src::KO;
    g[G_SIG + j] = sig;
    g[G_CORR + j] = corr;
    if (u) g[G_GHU + j] = d[Src::GU + j] + c.rdiag_stage[j] * v + corr;
  }
  for (int i = t; i < NX; i += TEAM)
    d[Src::RHO + i] = defect_row(tm.q, 0, c.h, d + Src::ZX, w + ZX1, d + Src::ZU, d + Src::R, i);
  tm.sync();
  team_clock(CK_BWD_A);
  for (int i = t; i < NX; i += TEAM) w[ZX1 + i] = d[Src::ZX + i];  // read by stage k-1's defects
  r2 = r2 + sq10(d + Src::RHO);
  team_stage(tm, 0, c);
  return r2;
}

// ---- staging: the producer warp moves stage k's rows into the block's
// landing buffer (`load_stage`) and a stage's outputs out of an output
// buffer (`store_out`) by tensor copies; each team moves its scenario from
// the landing buffer into its stage buffer (`unpack`) ----

// Stage k's rows, or with `terminal` the terminal node's and the once
// fields, into the landing buffer: the producer's lane 0 announces their
// bytes on the mbarrier and issues one tensor copy a field.
template <typename Src, typename JT>
__device__ __forceinline__ void load_stage(const Maps<Src>& maps, int k, bool terminal, char* smem,
                                           const Layout<Src>& L, int S, long long b0,
                                           unsigned long long* bar) {
  if ((threadIdx.x & 31) != 0) return;
  unsigned bytes = 0;
#pragma unroll
  for (int f = 0; f < Src::F_IN; ++f)
    if (terminal ? field_terminal<Src>(f) : !Src::field_once(f))
      bytes += (Src::field_jac(f) ? sizeof(JT) : 4u) * S * Src::field_rows(f);
  mbar_expect(bar, bytes);
#pragma unroll
  for (int f = 0; f < Src::F_IN; ++f)
    if (terminal ? field_terminal<Src>(f) : !Src::field_once(f))
      tma_load(smem + L.in[f], &maps.in[f], (int)b0,
               Src::field_once(f) ? 0 : k * Src::field_rows(f), bar);
}

// Stage k's outputs (K, kf, rh; the once fields with stage 0's) from output
// buffer o: one tensor copy a field from the producer's lane 0.
template <typename Src>
__device__ __forceinline__ void store_out(const Maps<Src>& maps, int k, int o, const char* smem,
                                          const Layout<Src>& L, int S, long long b0) {
  if ((threadIdx.x & 31) != 0) return;
#pragma unroll
  for (int q = 0; q < Src::O_N; ++q)
    if (!Src::out_once(q) || k == 0)
      tma_store(&maps.out[q], (int)b0, Src::out_once(q) ? 0 : k * Src::out_rows(q),
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

// Fields f.. of one kind (`node`: the node fields, else the stage fields
// that are not once fields), in landing order, of scenario s into its stage
// buffer d.
template <typename Src, typename JT, bool node, int f = 0>
__device__ __forceinline__ void unpack_fields(const char* smem, const Layout<Src>& L, int S, int s,
                                              float* d, int t) {
  if constexpr (f < Src::F_IN) {
    if constexpr (Src::field_node(f) == node && !Src::field_once(f)) {
      if constexpr (Src::field_jac(f))
        unpack_rows<Src::field_rows(f)>(reinterpret_cast<JT*>(d + Src::JAC) + Src::field_slot(f),
                                        smem + L.in[f], S, s, t);
      else
        unpack_rows<Src::field_rows(f)>(d + Src::field_slot(f), smem + L.in[f], S, s, t);
    }
    unpack_fields<Src, JT, node, f + 1>(smem, L, S, s, d, t);
  }
}

// A team's scenario s from the landing buffer into its stage buffer d
// (`terminal`: the terminal node's rows only).
template <typename Src, typename JT>
__device__ __forceinline__ void unpack(const char* smem, const Layout<Src>& L, int S, int s,
                                       float* d, int t, bool terminal) {
  unpack_fields<Src, JT, true>(smem, L, S, s, d, t);
  if (terminal) return;
  unpack_fields<Src, JT, false>(smem, L, S, s, d, t);
}

// The sweep of S scenarios from b0 = blockIdx.x * S over the block's
// dynamic shared memory `smem`: the body of the source's __global__ kernel
// (launched with `geometry`'s threads and shared memory).
template <typename Src, typename JT>
__device__ __forceinline__ void backward_body(char* smem, const StepConsts& c,
                                              const Maps<Src>& maps, int S) {
  const int N = c.n_stages;
  const Layout<Src> L = layout<Src>(S, (int)sizeof(JT));
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
  float* const d = reinterpret_cast<float*>(smem) + s * slot_stride<Src>((int)sizeof(JT));
  float* const w = d + work_at<Src>((int)sizeof(JT));
  unsigned phase = 0;  // of the mbarrier
  // wait until the stage the producer loaded last has landed
  auto landed = [&]() {
    mbar_wait(bar, phase);
    phase ^= 1;
  };

  // the terminal node and the once fields, then stage N-1 in flight
  team_clock(-1);
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  if (producer) load_stage<Src, JT>(maps, N, true, smem, L, S, b0, bar);
  landed();
  if (compute) unpack<Src, JT>(smem, L, S, s, d, t, true);
  const typename Src::Rows rows = Src::rows(smem, L.in, s);
  fence_async_smem();
  __syncthreads();  // the landing buffer is free, the terminal node unpacked
  if (producer) load_stage<Src, JT>(maps, N - 1, false, smem, L, S, b0, bar);

  // the terminal cost-to-go: node N's v rows' terms, then P, p
  if (compute) {
    const Team<JT> tm = stage_team<Src, JT>(d, w);
    for (int j = NU + t; j < NU + 3; j += TEAM) {
      float sig, corr;
      rows.terms(d, false, j - NU, d[Src::ZX + 3 + j - NU], sig, corr);
      w[W_GT + G_SIG + j] = sig;
      w[W_GT + G_CORR + j] = corr;
    }
    tm.sync();
    team_terminal(tm, 0, c);
    for (int i = t; i < NX; i += TEAM) w[ZX1 + i] = d[Src::ZX + i];
  }

  float r2 = 0.0f;
  for (int k = N - 1; k >= 0; --k) {
    landed();  // stage k; stage k+1's outputs are in buffer (k + 1) & 1
    if (producer && threadIdx.x % 32 == 0) bulk_wait_read();  // stage k+2's store read k & 1
    team_clock(CK_WAIT);
    if (compute) unpack<Src, JT>(smem, L, S, s, d, t, false);
    fence_async_smem();
    __syncthreads();  // the landing buffer is free; every team's outputs of stage k+1 are in
    if (producer) {
      if (k + 1 < N) store_out<Src>(maps, k + 1, (k + 1) & 1, smem, L, S, b0);
      if (k > 0) load_stage<Src, JT>(maps, k - 1, false, smem, L, S, b0, bar);
    }
    team_clock(CK_STAGE_IN);
    if (!compute) continue;
    r2 = stage_sweep<Src>(stage_team<Src, JT>(d, w), d, rows, r2, c);
    // the stage's K, kf and rh (54 floats from KO) to output buffer k & 1
    const bool odd = k & 1;
    float* const oK = reinterpret_cast<float*>(smem + (odd ? L.out[1][0] : L.out[0][0]));
    float* const okf = reinterpret_cast<float*>(smem + (odd ? L.out[1][1] : L.out[0][1]));
    float* const orh = reinterpret_cast<float*>(smem + (odd ? L.out[1][2] : L.out[0][2]));
    for (int e = t; e < OUT_ROWS; e += TEAM) {
      float* const o = e < NU * NX ? oK + e * S : e < NU * NX + NU ? okf + (e - NU * NX) * S
                                                                    : orh + (e - NU * NX - NU) * S;
      o[s] = d[Src::KO + e];
    }
    if constexpr (Src::RES2)
      if (k == 0 && t == 0) reinterpret_cast<float*>(smem + L.out[0][Src::O_N - 1])[s] = r2;
    team_clock(CK_STAGE_OUT);
  }
  fence_async_smem();
  __syncthreads();
  if (producer) {
    store_out<Src>(maps, 0, 0, smem, L, S, b0);
    if (threadIdx.x % 32 == 0) bulk_wait();
  }
}

// Whether a launch takes the tensor copies: their box rows must be 16-byte
// aligned (B and S multiples of VEC, every tensor on 16 bytes).
template <typename Src>
inline bool tma_route(const typename Src::Ptrs& p, long long B, int S) {
  bool ok = B % VEC == 0 && S % VEC == 0;
  for (int f = 0; f < Src::F_IN; ++f)
    ok = ok && reinterpret_cast<unsigned long long>(Src::field_ptr(p, f)) % 16 == 0;
  for (int q = 0; q < Src::O_N; ++q)
    ok = ok && reinterpret_cast<unsigned long long>(Src::out_ptr(p, q)) % 16 == 0;
  return ok;
}

// Launch `kern` (the source's kernel, running `backward_body`) on `s` where
// the rows are aligned (`route` = 1), else `thread()` (the one-thread sweep,
// `route` = 0). The tensor copies take a map of each tensor as (rows, B) in
// boxes of (a stage's rows, S); a map that cannot be made where the rows are
// aligned is an error, not a reason to run the one-thread sweep. Returns the
// error of the shared-memory attribute or of a map, or cudaGetLastError()
// after the launch.
template <typename Src, typename JT, typename Kernel, typename Thread>
int launch(Kernel kern, Thread&& thread, const StepConsts* c, const typename Src::Ptrs* p,
           long long B, cudaStream_t s, int& route) {
  const int N = c->n_stages;
  const TeamGeom g = geometry<Src>((int)sizeof(JT), B);
  if (g.S < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             g.smem);
  if (e != cudaSuccess) return (int)e;
  Maps<Src> maps{};
  const bool tma = tma_route<Src>(*p, B, g.S);
  route = tma ? 1 : 0;
  if (!tma) {
    thread();
    return (int)cudaGetLastError();
  }
  for (int f = 0; f < Src::F_IN; ++f) {
    const long long rows =
        Src::field_once(f) ? 1 : (long long)(Src::field_node(f) ? N + 1 : N) * Src::field_rows(f);
    if (const int err = tensor_map(&maps.in[f], Src::field_ptr(*p, f),
                                   Src::field_jac(f) ? (int)sizeof(JT) : 4, B, rows, g.S,
                                   Src::field_rows(f)))
      return err;
  }
  for (int q = 0; q < Src::O_N; ++q)
    if (const int err = tensor_map(&maps.out[q], Src::out_ptr(*p, q), 4, B,
                                   Src::out_once(q) ? 1 : (long long)N * Src::out_rows(q), g.S,
                                   Src::out_rows(q)))
      return err;
  NDP_LAUNCH(kern, (unsigned)g.blocks, g.threads, g.smem, s, *p, *c, maps, g.S);
  return (int)cudaGetLastError();
}

}  // namespace stream
}  // namespace ndp
