// Dense Riccati sweep of the legacy packed path for Hopper (sm_90a), in two
// launches. Replaces the TPU kernels of
// `ops/pallas/riccati.py:riccati_sweep_packed`: the backward sweep
// (`_backward_kernel`, K8) and the forward rollout with its optional control
// clip (`_forward_kernel`, K9). The packed IPM (`solver/qp_ipm_packed.py`)
// calls them once for its clipped-LQR start (zero sig, clip) and once per
// iteration for the Newton direction (sig and the defects rhat, no clip).
//
// The sweep is dense: Hxx, Huu, A and B are read exactly as given (no sparse
// structure), and Hxu is taken as zero, as the TPU kernels take it.
//
// What bounds it on this card: bytes. The backward kernel reads the dense
// stage data (Hxx and A are 100 floats a stage; 294 floats, 1,176 bytes, a
// stage in all) and writes the gains (44 floats a stage), about 27.5 KB a
// scenario; its 20 stages of 10x10 products are about 150 kflop a scenario,
// under a third of the time the bytes take at the f32 rate. The forward
// kernel reads A, B, r, K, k and the clip bounds and writes the rollout,
// about 17 KB a scenario.
//
// Backward design (K8): a team of TEAM = 4 lanes a scenario, S scenarios a
// block, and the sweep's whole working set on the SM: nothing but the
// inputs and the gains touches global memory.
// The TPU grid's sequential stage axis, over which the Pallas kernel carried
// P in VMEM scratch, is a loop over k = N-1..0 inside the block. The stage
// inputs stream through the block one stage ahead: a producer warp (after
// the compute warps) loads stage k-1's rows into a landing buffer while the
// teams compute stage k, each field one box [rows][S] of its (stage, d, B)
// tensor viewed as (rows, B), by one tensor copy (TMA, cp.async.bulk.tensor,
// completion on an mbarrier) from the producer's lane 0, and stores stage
// k+1's gains the same way from one of two output buffers. Where a box row
// cannot be tensor-copied (B not a multiple of 4, or a tensor not on 16
// bytes) every thread copies element by element instead, the one other
// route (`riccati_packed_backward_route`): measured at B=65535, 2.14 ms
// against 4.46 for a one-thread sweep with P in a global scratch (PERF.md),
// so K8 keeps it where K4 runs its one-thread sweep. The compute threads of
// the tensor copies' route never issue a global access: measured, that is what kept
// every earlier staging (per-thread cp.async of 4 or 16 bytes, a warp of
// per-row bulk copies) at 1.8-3.1 ms. Each team moves its scenario's column
// of the landing buffer into its slot (`unpack`), which holds the rows of A,
// B and r interleaved (ABr: row t is A[t][0..9], r[t], -, B[t][0..3]), Hxx
// and Huu by columns and ghat and the diagonal additions, so that every lane
// reads what it needs with 16-byte loads. Lane t owns rows t*RPL .. of P and
// p, in registers across stages; one load of a row of ABr serves all its
// rows. A stage is four phases, one barrier each:
//   B: lane t forms its rows of P [A | r | B] (PA, P r, PB), in one loop over
//      the rows of ABr, and stores them by columns (PABr_T: PA's ten columns,
//      PB's four, and Prp = P r + p);
//   C: lane t multiplies [A | B]^T by its columns of PABr_T, again one loop
//      over the rows of ABr: column c < 10 gives column c of Qh (+ Hxx and
//      the diagonal) and of S = B^T PA, c = 10 + m column m of Rh = B^T PB +
//      Huu (+ diagonal), c = 14 qv = ghat_x + A^T Prp and rv = ghat_u + B^T
//      Prp;
//   D: every lane factors Rh (`ndp::chol4`, reciprocal pivots) and solves
//      its gain columns j (`ndp::chol4_solve`; j = 10: kf);
//   E: lane t forms its rows of P <- sym(Qh + S^T K) and p <- qv + S^T k.
// Every output element is computed by one lane with the one-thread
// expression and summation order of the plain version's stage (the sums
// over the rows of ABr run t = 0..9, as `riccati_backward_packed_plain`'s
// contractions are written), so kernel and plain version differ by FMA
// contraction and einsum's summation order only. A NaN stays in its own
// slot; slots past B compute on stale rows and store nothing, and every
// lane meets every barrier.
//
// Forward design (K9): one thread per scenario; dx and du in registers, each
// stage's A, B, r, K and k read once through the read-only path, coalesced
// across the warp (batch innermost).
//
// NaN: the clip is nmax then nmin (jnp.minimum(jnp.maximum(du, lo), hi)
// propagates NaN; fminf/fmaxf would drop it and let a poisoned solve look
// healthy). Without a clip the bound pointers are null and never read.
//
// Bound to PyTorch through ctypes: plain C entry points, no PyTorch headers.

#include "ndp.cuh"

#ifndef NDP_K8_THREADS  // compute threads a block, at most (the host tests build fewer)
#define NDP_K8_THREADS 256
#endif

namespace ndp {

// Tensors of both launches, f32, layout (stage, element, B); each kernel
// reads and writes its own subset. Shared with Python (ctypes).
struct PackedPtrs {
  float* hxx;      // (N+1, 100) backward in
  float* sig_x;    // (N+1, 10) full-state diagonal additions
  float* huu;      // (N, 16)
  float* sig_u;    // (N, 4)
  float* gx;       // (N+1, 10) ghat_x
  float* gu;       // (N, 4) ghat_u
  float* a;        // (N, 100) both
  float* b;        // (N, 40) both
  float* r;        // (N, 10) both
  float* K;        // (N, 40) backward out, forward in: K[l][j] at l * 10 + j
  float* kf;       // (N, 4)
  float* dx0;      // (1, 10) forward in
  float* clip_lo;  // (N, 4) or null: no clip
  float* clip_hi;
  float* dx;       // (N+1, 10) forward out
  float* du;       // (N, 4)
};

namespace k8 {

constexpr int TEAM = 4;  // lanes a scenario
constexpr int MAX_THREADS = NDP_K8_THREADS;  // compute threads a block (and a producer warp)
constexpr int SMEM_MAX = 232448;             // dynamic shared memory a block may take on sm_90
constexpr int NCOL = NX + NU + 1;            // columns of PABr_T: PA's, PB's, Prp
constexpr int RPL = (NX + TEAM - 1) / TEAM;    // rows of P a lane owns (phases B, E)
constexpr int CPL = (NCOL + TEAM - 1) / TEAM;  // columns of PABr_T a lane takes (C)

// A slot's stage buffer, in floats from its start: ABr (10 rows of 16), Hxx
// by columns (10 of 12: HXT + 12 c + i = Hxx[i][c]), Huu by columns (HUT +
// 4 m + l = Huu[l][m]), ghat (GXU: ghat_x at 0..9, ghat_u at 12..15), the
// diagonal additions (SGV: sig_x at 0..9, sig_u at 12..15) and the stage's
// kf (KF).
enum BufOff { ABR = 0, HXT = 160, HUT = 280, GXU = 296, SGV = 312, KF = 328, BUF = 332 };
constexpr int AB_R = 10, AB_B = 12;  // r and B in a row of ABr
// A slot: the stage buffer, then PABr_T (15 rows of 16: PA's columns, PB's,
// Prp; phase C overwrites row c with its results) and K by columns (KT + 4 j
// + l = K[l][j]).
enum SlotOff { PAB = BUF, KT = PAB + 15 * 16, SLOT = KT + NX * NU };
// The input fields, in landing order, and their rows a stage.
enum Field { F_A, F_B, F_R, F_HXX, F_HUU, F_GX, F_GU, F_SX, F_SU, F_IN };
__host__ __device__ constexpr int field_rows(int f) {
  return f == F_A || f == F_HXX ? NX * NX : f == F_B ? NX * NU : f == F_HUU ? NU * NU
         : f == F_R || f == F_GX || f == F_SX ? NX : NU;
}
constexpr int IN_ROWS = 2 * NX * NX + NX * NU + NU * NU + 3 * NX + 2 * NU;  // a stage's inputs
constexpr int O_ROWS = NU * NX + NU;  // a stage's gains: K (40 rows), kf (4)
constexpr int VEC = 4;                // scenarios 16 bytes hold
// S: a multiple of this when there are that many, so that the compute
// threads fill whole warps and rows take whole 16-byte copies.
constexpr int S_STEP = VEC * TEAM > 32 ? VEC : 32 / TEAM;

// The slot stride in floats: SLOT padded to 4 banks mod 32, so that the teams
// of a warp read their 16-byte rows from disjoint banks.
__host__ __device__ constexpr int slot_stride() { return SLOT + ((4 - SLOT % 32) % 32 + 32) % 32; }
__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// A block's shared memory, byte offsets: its S slots; the landing buffer,
// one stage's input rows, each field a box [rows][S] on 128 bytes; two
// output buffers, a stage's gains (stage k's in buffer k & 1: K [40][S], kf
// [4][S]); the landing buffer's mbarrier.
struct Layout {
  int in[F_IN], out[2][2], bar, bytes;
};
__host__ __device__ inline Layout layout(int S) {
  Layout L;
  int o = round128(4 * S * slot_stride());
#pragma unroll
  for (int f = 0; f < F_IN; ++f) {
    L.in[f] = o;
    o += round128(4 * S * field_rows(f));
  }
  for (int b = 0; b < 2; ++b) {
    L.out[b][0] = o;
    o += round128(4 * S * NU * NX);
    L.out[b][1] = o;
    o += round128(4 * S * NU);
  }
  L.bar = o;
  L.bytes = o + 16;
  return L;
}
// A scenario's bytes: its slot, its columns of the landing and output
// buffers.
__host__ __device__ constexpr int scenario_bytes() {
  return 4 * (SLOT + IN_ROWS + 2 * O_ROWS);
}

struct Geom {
  int team, S, threads, smem;
  long long blocks;
};

// S scenarios a block (as many as fit, at most MAX_THREADS / TEAM and B, a
// multiple of S_STEP when there are that many), their compute threads in
// whole warps, then the producer warp.
__host__ __device__ inline Geom geometry(long long B) {
  Geom g;
  g.team = TEAM;
  long long S = MAX_THREADS / TEAM;
  if (S > B) S = B;
  while (S > 1 && layout((int)S).bytes > SMEM_MAX) --S;
  if (S >= S_STEP) S -= S % S_STEP;
  g.S = (int)S;
  g.threads = (g.S * TEAM + 31) / 32 * 32 + 32;
  g.smem = layout(g.S).bytes;
  g.blocks = g.S > 0 ? (B + g.S - 1) / g.S : 0;
  return g;
}

// The tensors' maps for tensor copies: the input fields, then K and kf.
struct Maps {
  TensorMap in[F_IN], out[2];
};

// The producer's part of stage k (the terminal node's Hxx, sig_x and ghat_x
// only with `terminal`): by tensor copies from the producer's lane 0 (tma),
// else by every thread element by element (cp.async; the caller waits).
__device__ __forceinline__ void load_stage(const PackedPtrs& p, const Maps& maps, int k,
                                           bool terminal, char* smem, const Layout& L,
                                           const Rows& R, bool tma, unsigned long long* bar) {
  if (tma) {
    if ((threadIdx.x & 31) != 0) return;
    unsigned bytes = 0;
#pragma unroll
    for (int f = 0; f < F_IN; ++f)
      if (!terminal || f == F_HXX || f == F_GX || f == F_SX) bytes += 4u * R.S * field_rows(f);
    mbar_expect(bar, bytes);
#pragma unroll
    for (int f = 0; f < F_IN; ++f)
      if (!terminal || f == F_HXX || f == F_GX || f == F_SX)
        tma_load(smem + L.in[f], &maps.in[f], (int)R.b0, k * field_rows(f), bar);
    return;
  }
  auto in = [&](int f) { return reinterpret_cast<float*>(smem + L.in[f]); };
  if (!terminal) {
    rows_in<NX * NX>(in(F_A), p.a, k, R);
    rows_in<NX * NU>(in(F_B), p.b, k, R);
    rows_in<NX>(in(F_R), p.r, k, R);
    rows_in<NU * NU>(in(F_HUU), p.huu, k, R);
    rows_in<NU>(in(F_GU), p.gu, k, R);
    rows_in<NU>(in(F_SU), p.sig_u, k, R);
  }
  rows_in<NX * NX>(in(F_HXX), p.hxx, k, R);
  rows_in<NX>(in(F_GX), p.gx, k, R);
  rows_in<NX>(in(F_SX), p.sig_x, k, R);
}

// Stage k's gains from output buffer o (= k & 1) to K and kf: by tensor
// copies from the producer's lane 0 (tma), else by every thread element by
// element.
__device__ __forceinline__ void store_gains(const PackedPtrs& p, const Maps& maps, int k, int o,
                                            char* smem, const Layout& L, const Rows& R,
                                            bool tma) {
  const float* const K = reinterpret_cast<const float*>(smem + (o ? L.out[1][0] : L.out[0][0]));
  const float* const kf = reinterpret_cast<const float*>(smem + (o ? L.out[1][1] : L.out[0][1]));
  if (tma) {
    if ((threadIdx.x & 31) != 0) return;
    tma_store(&maps.out[0], (int)R.b0, k * NU * NX, K);
    tma_store(&maps.out[1], (int)R.b0, k * NU, kf);
    bulk_commit();
    return;
  }
  rows_out(p.K, K, NU * NX, k, R);
  rows_out(p.kf, kf, NU, k, R);
}

// A team's scenario s from the landing buffer into its stage buffer d, lane
// t taking column groups col = t, t + TEAM, ...: col < 10 column col of A
// and of Hxx, sig_x[col] and ghat_x[col]; col = 10 + m column m of B and of
// Huu, sig_u[m] and ghat_u[m]; col = 14 r. `terminal`: Hxx, sig_x and
// ghat_x only.
__device__ __forceinline__ void unpack(const char* smem, const Layout& L, int S, int s, float* d,
                                       int t, bool terminal) {
  auto in = [&](int f) { return reinterpret_cast<const float*>(smem + L.in[f]) + s; };
  for (int col = t; col < (terminal ? NX : NX + NU + 1); col += TEAM) {
    if (col < NX) {
      if (!terminal) {
#pragma unroll
        for (int tt = 0; tt < NX; ++tt) d[ABR + 16 * tt + col] = in(F_A)[(NX * tt + col) * S];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) d[HXT + 12 * col + i] = in(F_HXX)[(NX * i + col) * S];
      d[SGV + col] = in(F_SX)[col * S];
      d[GXU + col] = in(F_GX)[col * S];
    } else if (col < NX + NU) {
      const int m = col - NX;
#pragma unroll
      for (int tt = 0; tt < NX; ++tt) d[ABR + 16 * tt + AB_B + m] = in(F_B)[(NU * tt + m) * S];
#pragma unroll
      for (int ll = 0; ll < NU; ++ll) d[HUT + 4 * m + ll] = in(F_HUU)[(NU * ll + m) * S];
      d[SGV + 12 + m] = in(F_SU)[m * S];
      d[GXU + 12 + m] = in(F_GU)[m * S];
    } else {
#pragma unroll
      for (int tt = 0; tt < NX; ++tt) d[ABR + 16 * tt + AB_R] = in(F_R)[tt * S];
    }
  }
}

// Barrier of a scenario's lanes (TEAM divides 32: a team never straddles a
// warp).
__device__ __forceinline__ void team_sync() {
  const int lane = threadIdx.x & 31;
  __syncwarp(((1u << TEAM) - 1u) << (lane & ~(TEAM - 1)));
}

// Whether a launch takes the tensor copies: their box rows must be 16-byte
// aligned (B and S multiples of VEC, every tensor on 16 bytes). Otherwise
// every thread copies element by element.
inline bool tma_route(const PackedPtrs& p, long long B, int S) {
  const float* const t[F_IN + 2] = {p.a, p.b, p.r, p.hxx, p.huu, p.gx, p.gu, p.sig_x, p.sig_u,
                                    p.K, p.kf};
  bool ok = B % VEC == 0 && S % VEC == 0;
  for (int i = 0; i < F_IN + 2; ++i)
    ok = ok && reinterpret_cast<unsigned long long>(t[i]) % 16 == 0;
  return ok;
}

}  // namespace k8
}  // namespace ndp

__global__ void __launch_bounds__(ndp::k8::MAX_THREADS + 32, 1)
    riccati_packed_backward_kernel(const __grid_constant__ ndp::PackedPtrs p,
                                   const __grid_constant__ ndp::StepConsts c,
                                   const __grid_constant__ ndp::k8::Maps maps, long long B, int S,
                                   bool tma) {
  using namespace ndp;
  using namespace ndp::k8;
  extern __shared__ float4 ndp_smem[];
  char* const smem = reinterpret_cast<char*>(ndp_smem);
  const int N = c.n_stages;
  const Layout L = layout(S);
  unsigned long long* const bar = reinterpret_cast<unsigned long long*>(smem + L.bar);
  // the producer warp (after the compute threads' whole warps) moves every
  // row in and out by tensor copies from its lane 0 (tma), so that the
  // compute threads, lane t of the team of slot s, never touch global
  // memory; else every thread copies element by element (`io`); threads
  // past S * TEAM in the last compute warp only meet the block's barriers
  const int nc = S * TEAM;
  const bool producer = (int)threadIdx.x >= (nc + 31) / 32 * 32;
  const bool compute = (int)threadIdx.x < nc;
  const bool io = tma ? producer : true;  // the threads that move rows
  const Rows R = block_rows(S, B, (long long)blockIdx.x * S);
  const int t = threadIdx.x % TEAM, s = threadIdx.x / TEAM;
  float* const slot = reinterpret_cast<float*>(smem) + (compute ? s : 0) * slot_stride();
  float* const d = slot;  // the stage buffer
  float* const pab = slot + PAB;
  float* const kt = slot + KT;
  unsigned phase = 0;  // of the mbarrier (tma)
  // wait until the stage the producer loaded last has landed
  auto landed = [&]() {
    if (tma) {
      mbar_wait(bar, phase);
      phase ^= 1;
    } else {
      cp_async_wait_all();
      __syncthreads();
    }
  };

  team_clock(-1);
  if (tma && threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  if (io) load_stage(p, maps, N, true, smem, L, R, tma, bar);
  landed();
  if (compute) unpack(smem, L, S, s, d, t, true);
  fence_async_smem();
  __syncthreads();  // the landing buffer is free, the terminal node unpacked
  if (io) load_stage(p, maps, N - 1, false, smem, L, R, tma, bar);
  team_clock(CK_WAIT);

  // terminal cost-to-go: P = Hxx_N + diag(sig_N), p = ghat_N; lane t holds
  // rows i0 .. i0 + RPL - 1 of P and of p in registers from here on (rows
  // past 9 hold zeros and are never stored)
  const int i0 = t * RPL, c0 = t * CPL;
  float P[RPL][NX], pv[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = i0 + r;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float v = i < NX ? d[HXT + 12 * j + i] : 0.0f;
      if (j == i) v = v + d[SGV + i];
      P[r][j] = v;
    }
    pv[r] = i < NX ? d[GXU + i] : 0.0f;
  }

  for (int k = N - 1; k >= 0; --k) {
    const bool odd = k & 1;  // this stage's output buffer: its K and kf
    float* const ob = reinterpret_cast<float*>(smem + (odd ? L.out[1][0] : L.out[0][0]));
    float* const okf = reinterpret_cast<float*>(smem + (odd ? L.out[1][1] : L.out[0][1]));
    landed();  // stage k; stage k+1's gains are in buffer (k + 1) & 1
    if (tma && producer && threadIdx.x % 32 == 0) bulk_wait_read();  // stage k+2's store read ob
    team_clock(CK_WAIT);
    if (!tma && k + 1 < N) store_gains(p, maps, k + 1, (k + 1) & 1, smem, L, R, false);
    if (compute) unpack(smem, L, S, s, d, t, false);
    fence_async_smem();
    __syncthreads();  // the landing buffer is free; every team's gains of stage k+1 are out
    if (io) {
      if (tma && k + 1 < N) store_gains(p, maps, k + 1, (k + 1) & 1, smem, L, R, true);
      if (k > 0) load_stage(p, maps, k - 1, false, smem, L, R, tma, bar);
    }
    team_clock(CK_STAGE_IN);
    if (!compute) continue;

    // B: lane t: its rows of P [A | r | B] (each row of ABr loaded once for
    // all of them), stored by columns
    if (i0 < NX) {
      float acc[RPL][16], ab[16];  // acc[.][11] (ABr's padding) stays unused
      ld4<16>(ab, d + ABR);
#pragma unroll
      for (int r = 0; r < RPL; ++r)
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (e != AB_R + 1) acc[r][e] = P[r][0] * ab[e];
#pragma unroll
      for (int tt = 1; tt < NX; ++tt) {
        ld4<16>(ab, d + ABR + 16 * tt);
#pragma unroll
        for (int r = 0; r < RPL; ++r)
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (e != AB_R + 1) acc[r][e] = acc[r][e] + P[r][tt] * ab[e];
      }
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int i = i0 + r;
        if (i < NX) {
#pragma unroll
          for (int e = 0; e < NX; ++e) pab[16 * e + i] = acc[r][e];
#pragma unroll
          for (int m = 0; m < NU; ++m) pab[16 * (NX + m) + i] = acc[r][AB_B + m];
          pab[16 * (NX + NU) + i] = acc[r][AB_R] + pv[r];  // Prp = P r + p
        }
      }
    }
    team_sync();
    team_clock(CK_BWD_B);

    // C: lane t: [A | B]^T times its columns c0 .. c0 + CPL - 1 of PABr_T
    // (each row of ABr loaded once for all of them), plus the stage's terms
    if (c0 < NCOL) {
      // the A part at 0..9, the B part at 12..15 (10, 11: r and padding)
      float col[CPL][12], acc[CPL][16], ab[16];
#pragma unroll
      for (int r = 0; r < CPL; ++r) ld4<12>(col[r], pab + 16 * (c0 + r < NCOL ? c0 + r : c0));
      ld4<16>(ab, d + ABR);
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        acc[r][AB_R] = acc[r][AB_R + 1] = 0.0f;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (e < AB_R || e >= AB_B) acc[r][e] = ab[e] * col[r][0];
      }
#pragma unroll
      for (int tt = 1; tt < NX; ++tt) {
        ld4<16>(ab, d + ABR + 16 * tt);
#pragma unroll
        for (int r = 0; r < CPL; ++r)
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (e < AB_R || e >= AB_B) acc[r][e] = acc[r][e] + ab[e] * col[r][tt];
      }
      // Qh = A^T PA + Hxx (+ sig_x on the diagonal); Rh = B^T PB + Huu (+
      // sig_u); qv = ghat_x + A^T Prp, rv = ghat_u + B^T Prp; S = B^T PA as is
#pragma unroll
      for (int r = 0; r < CPL; ++r) {
        const int cc = c0 + r;
        if (cc < NCOL) {
          const bool qcol = cc < NX, rcol = cc >= NX && cc < NX + NU, grad = cc == NX + NU;
          float av[12], bv[4];
          ld4<12>(av, qcol ? d + HXT + 12 * cc : d + GXU);
          ld4<4>(bv, rcol ? d + HUT + 4 * (cc - NX) : d + GXU + 12);
          const int dg = qcol ? cc : AB_B + cc - NX;
          const float sg = qcol ? d[SGV + cc] : d[SGV + 12 + (cc - NX) % NU];
#pragma unroll
          for (int e = 0; e < NX; ++e) {
            if (qcol || grad) acc[r][e] = acc[r][e] + av[e];
            if (qcol && e == dg) acc[r][e] = acc[r][e] + sg;
          }
#pragma unroll
          for (int l = 0; l < NU; ++l) {
            if (rcol || grad) acc[r][AB_B + l] = acc[r][AB_B + l] + bv[l];
            if (rcol && AB_B + l == dg) acc[r][AB_B + l] = acc[r][AB_B + l] + sg;
          }
          st4<16>(pab + 16 * cc, acc[r]);  // over the column it read
        }
      }
    }
    team_sync();
    team_clock(CK_BWD_C);

    // D: gains K = -Rh^-1 S (column j < 10), kf = -Rh^-1 rv (j = 10), over
    // the lanes
    {
      float R[4][4], L[4][4], Ld[4];
#pragma unroll
      for (int m = 0; m < NU; ++m) {
        float rc[4];
        ld4<4>(rc, pab + 16 * (NX + m) + AB_B);
#pragma unroll
        for (int l = 0; l < NU; ++l) R[l][m] = rc[l];
      }
      chol4(R, L, Ld);
      for (int j = t; j <= NX; j += TEAM) {
        float rhs[4], sol[4], neg[4];
        ld4<4>(rhs, pab + 16 * (j < NX ? j : NX + NU) + AB_B);
        chol4_solve(L, Ld, rhs, sol);
        // K[l][j] to row l * 10 + j of the output buffer's K, kf to its kf
        // and to KF
        float* const out = j < NX ? ob + j * S + s : okf + s;
        const int os = (j < NX ? NX : 1) * S;
#pragma unroll
        for (int l = 0; l < NU; ++l) {
          neg[l] = -sol[l];
          out[l * os] = neg[l];
        }
        st4<4>(j < NX ? kt + 4 * j : d + KF, neg);
      }
    }
    team_sync();
    team_clock(CK_BWD_D);

    // E: lane t: its rows i of P <- sym(Qh + S^T K), p[i] <- qv[i] +
    // S[:, i] . kf (S[:, j] and K[:, j] loaded once for all of them)
    if (i0 < NX) {
      float kf[4], Ci[RPL][16], Ki[RPL][4];
      ld4<4>(kf, d + KF);
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int i = i0 + r < NX ? i0 + r : i0;
        ld4<16>(Ci[r], pab + 16 * i);  // Qh[j][i] at j, S[:, i] at 12..15
        ld4<4>(Ki[r], kt + 4 * i);
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float Sj[4], Kj[4];
        ld4<4>(Sj, pab + 16 * j + AB_B);
        ld4<4>(Kj, kt + 4 * j);
#pragma unroll
        for (int r = 0; r < RPL; ++r) {
          const int i = i0 + r < NX ? i0 + r : i0;
          const float pij = pab[16 * j + i] + (Ci[r][12] * Kj[0] + Ci[r][13] * Kj[1] +
                                               Ci[r][14] * Kj[2] + Ci[r][15] * Kj[3]);
          const float pji =
              Ci[r][j] + (Sj[0] * Ki[r][0] + Sj[1] * Ki[r][1] + Sj[2] * Ki[r][2] + Sj[3] * Ki[r][3]);
          P[r][j] = 0.5f * (pij + pji);
        }
      }
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int i = i0 + r < NX ? i0 + r : i0;
        pv[r] = pab[16 * (NX + NU) + i] +
                (Ci[r][12] * kf[0] + Ci[r][13] * kf[1] + Ci[r][14] * kf[2] + Ci[r][15] * kf[3]);
      }
    }
    team_clock(CK_BWD_E);
  }
  fence_async_smem();
  __syncthreads();
  if (io) {
    store_gains(p, maps, 0, 0, smem, L, R, tma);
    if (tma && threadIdx.x % 32 == 0) bulk_wait();
  }
}

__global__ void __launch_bounds__(128)
    riccati_packed_forward_kernel(ndp::PackedPtrs p, ndp::StepConsts c, long long B) {
  using namespace ndp;
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = c.n_stages;
  // every input through the read-only path (ld.global.nc): no store of dx
  // or du can alias it, so a stage's loads need not wait for the stores
  // before them
  const View<const float> av = at<const float>(p.a, NX * NX, B, b);
  const View<const float> bv = at<const float>(p.b, NX * NU, B, b);
  const View<const float> rv = at<const float>(p.r, NX, B, b);
  const View<const float> Kv = at<const float>(p.K, NU * NX, B, b);
  const View<const float> kv = at<const float>(p.kf, NU, B, b);
  const View<const float> lo = at<const float>(p.clip_lo, NU, B, b);
  const View<const float> hi = at<const float>(p.clip_hi, NU, B, b);
  const View<float> dxo = at(p.dx, NX, B, b), duo = at(p.du, NU, B, b);
  auto in = [](const View<const float>& v, int k, int i) { return __ldg(&v(k, i)); };
  float dx[NX], du[NU], nxt[NX];
  for (int i = 0; i < NX; ++i) dx[i] = __ldg(p.dx0 + i * B + b);
  for (int k = 0; k < N; ++k) {
    for (int l = 0; l < NU; ++l) {
      float s = in(Kv, k, l * NX) * dx[0];
      for (int j = 1; j < NX; ++j) s = s + in(Kv, k, l * NX + j) * dx[j];
      du[l] = s + in(kv, k, l);
      if (lo.p) du[l] = nmin(nmax(du[l], in(lo, k, l)), in(hi, k, l));
    }
    for (int i = 0; i < NX; ++i) dxo(k, i) = dx[i];
    for (int l = 0; l < NU; ++l) duo(k, l) = du[l];
    for (int i = 0; i < NX; ++i) {
      float s = in(av, k, i * NX) * dx[0];
      for (int j = 1; j < NX; ++j) s = s + in(av, k, i * NX + j) * dx[j];
      float t = in(bv, k, i * NU) * du[0];
      for (int l = 1; l < NU; ++l) t = t + in(bv, k, i * NU + l) * du[l];
      nxt[i] = s + t + in(rv, k, i);
    }
    for (int i = 0; i < NX; ++i) dx[i] = nxt[i];
  }
  for (int i = 0; i < NX; ++i) dxo(N, i) = dx[i];
}

// The route of the backward kernel's last launch: 1 tensor copies, 0
// element-by-element copies, -1 none yet.
static int last_route = -1;

extern "C" {

int riccati_packed_consts_size() { return (int)sizeof(ndp::StepConsts); }
int riccati_packed_ptrs_size() { return (int)sizeof(ndp::PackedPtrs); }

// The backward kernel's launch geometry for the ctypes mirror
// (`_cuda.sweep_geometry`): out = [lanes a scenario, scenarios a block,
// threads a block, blocks, shared-memory bytes a block, bytes of a
// scenario's arrays (its slot and columns of the landing and output
// buffers), bytes of its padded slot]. The geometry does not depend on the
// number of stages, and the packed path has no bf16 payload.
void riccati_packed_backward_geometry(int, int, long long B, long long* out) {
  const ndp::k8::Geom g = ndp::k8::geometry(B);
  const long long v[7] = {g.team,  g.S,  g.threads, g.blocks, g.smem, ndp::k8::scenario_bytes(),
                          4LL * ndp::k8::slot_stride()};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// Launch the backward / forward kernel on `stream`; return the error of the
// shared-memory attribute or cudaGetLastError() after the launch. f32 only:
// `jac_bf16` must be 0 (the packed path has no bf16 payload).
int riccati_packed_backward_launch(int jac_bf16, const ndp::StepConsts* c,
                                   const ndp::PackedPtrs* p, long long B, void* stream) {
  using namespace ndp;
  using namespace ndp::k8;
  const int N = c->n_stages;
  if (jac_bf16 || N < 1) return (int)cudaErrorInvalidValue;
  const Geom g = geometry(B);
  if (g.S < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      riccati_packed_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  // the tensor copies take a map of each tensor as (rows, B) in boxes of (a
  // stage's rows, S); a map that cannot be made where the rows are aligned is
  // an error, not a reason to copy element by element
  Maps maps{};
  const bool tma = tma_route(*p, B, g.S);
  if (tma) {
    const float* const in[F_IN] = {p->a,  p->b,  p->r,     p->hxx,  p->huu,
                                   p->gx, p->gu, p->sig_x, p->sig_u};
    const int nodes[F_IN] = {N, N, N, N + 1, N, N + 1, N, N + 1, N};
    int err = 0;
    for (int f = 0; f < F_IN && !err; ++f)
      err = tensor_map(&maps.in[f], in[f], 4, B, (long long)nodes[f] * field_rows(f), g.S,
                       field_rows(f));
    if (!err) err = tensor_map(&maps.out[0], p->K, 4, B, (long long)N * NU * NX, g.S, NU * NX);
    if (!err) err = tensor_map(&maps.out[1], p->kf, 4, B, (long long)N * NU, g.S, NU);
    if (err) return err;
  }
  last_route = tma ? 1 : 0;
  NDP_LAUNCH(riccati_packed_backward_kernel, (unsigned)g.blocks, g.threads, g.smem,
             static_cast<cudaStream_t>(stream), *p, *c, maps, B, g.S, tma);
  return (int)cudaGetLastError();
}

// The route the backward kernel's last launch took (`last_route`).
int riccati_packed_backward_route() { return last_route; }

#ifdef NDP_TEAM_CLOCKS
// The backward kernel's phase cycle counts since the last call
// (ndp::ClockPhase order).
int riccati_packed_backward_clocks(long long* out) { return ndp::team_clocks_take(out); }
#endif

int riccati_packed_forward_launch(int jac_bf16, const ndp::StepConsts* c,
                                  const ndp::PackedPtrs* p, long long B, void* stream) {
  if (jac_bf16) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  NDP_LAUNCH(riccati_packed_forward_kernel, blocks, threads, 0,
             static_cast<cudaStream_t>(stream), *p, *c, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
