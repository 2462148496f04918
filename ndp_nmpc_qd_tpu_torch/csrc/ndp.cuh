// Device functions shared by the port's CUDA kernels: the one-thread-per-
// scenario sweeps of linearize.cu, riccati_iter.cu and riccati_sweep.cu, and
// the per-stage and per-row algebra that the team kernels of step_whole.cu
// and ipm_whole.cu (ndp_team.cuh) call lane by lane.
// Each function is named after its JAX counterpart:
//   lin_stage_terms / lin_terminal_terms  ops/pallas/linearize.py:122,183
//   linearize_scenario                    ops/pallas/linearize.py:_lin_kernel
//   glue_pair, terminal_init_core, riccati_stage_core, dyn_step,
//   bound_steps                           ops/pallas/riccati_sparse.py:74-437
//   backward_sweep (GlueRows / GivenRows) ops/pallas/riccati_sparse.py:
//                                         _backward_kernel_glue /
//                                         _backward_kernel
//   rollout, forward_pass                 _forward_kernel, _forward_kernel_glue
//   chol4, chol4_solve                    ops/pallas/riccati.py:101,122
// and follows the same operation order as the plain PyTorch versions in
// ops/kernels/{linearize,riccati_sparse,ipm_whole}.py, so the two differ only
// by nvcc's FMA contraction.
//
// Arrays in global memory use the kernel layout (stage, element, B) with the
// batch innermost: a View is pre-offset to its thread's scenario, and element
// (k, i) sits at p[(k * d + i) * B], so neighbouring threads touch
// neighbouring addresses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#ifndef NDP_HOST_EMULATION
#include <cuda.h>  // CUtensorMap
#endif

// A kernel launch, kern<<<grid, block, smem, stream>>>(args...). Built as
// host C++ (NDP_HOST_EMULATION, the headers under ../emulate/include), the
// device code runs on the CPU: the blocks one after another, each thread of
// a block on a host thread of its own, so that the kernels' barriers and
// shared memory behave as on the card.
#ifdef NDP_HOST_EMULATION
#define NDP_LAUNCH(kern, grid, block, smem, stream, ...) \
  ndp_emulate::launch((grid), (block), (smem), [&] { kern(__VA_ARGS__); })
#else
#define NDP_LAUNCH(kern, grid, block, smem, stream, ...) \
  kern<<<(grid), (block), (smem), (stream)>>>(__VA_ARGS__)
#endif

namespace ndp {

constexpr int NX = 10;
constexpr int NU = 4;

// Constants of the linearization and the IPM, products precomputed on the
// host in double so they round to float as the plain version's do; a kernel
// leaves the fields it does not read at 0. Mirrored field for field by
// `StepConsts` in ops/kernels/_cuda.py.
struct StepConsts {
  float h;            // shooting interval
  float rk_half;      // 0.5 * h / substeps
  float rk_step;      // h / substeps
  float rk_sixth;     // h / substeps / 6
  float inv_mass;
  float gravity;
  float stage_scale;
  float q_diag[NX];
  float gx_scale[6];  // stage_scale * q_diag[:6]
  float gu_scale[NU]; // stage_scale * r_diag
  float u_lo[NU], u_hi[NU], v_lo[3], v_hi[3];
  float big;
  float diag6_stage[6], diag6_term[6], rdiag_stage[NU];
  float tau, sigma, mu0, s_min, mu_min;
  int substeps;
  int num_iters;
  int n_stages;
  int with_dist;
};

template <typename T>
struct View {
  T* p;
  int d;
  long long B;
  __device__ __forceinline__ T& operator()(int k, int i) const {
    return p[((long long)k * d + i) * B];
  }
};

// View of scenario b of a (stage, d, B) tensor; a null tensor stays null.
template <typename T>
__device__ __forceinline__ View<T> at(T* p, int d, long long B, long long b) {
  return View<T>{p ? p + b : nullptr, d, B};
}

__device__ __forceinline__ float ldf(float v) { return v; }
__device__ __forceinline__ float ldf(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T stf(float v);
template <>
__device__ __forceinline__ float stf<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 stf<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype(bf16)
}

// Asynchronous copy of one float, global to shared memory without a
// register (cp.async); the caller waits with cp_async_wait_all() before the
// barrier that publishes the copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#ifdef NDP_HOST_EMULATION
  *dst = *src;
#else
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
#endif
}
__device__ __forceinline__ void cp_async_wait_all() {
#ifndef NDP_HOST_EMULATION
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// ---- tensor copies by the Tensor Memory Accelerator ----
// A stage's rows of a (stage, d, B) tensor, viewed as the 2-D tensor
// (rows, B), are one box of (d rows, S columns): one instruction loads it
// into shared memory (dense [d][S], at a 128-byte aligned address), its
// completion counted on an mbarrier that one thread announced the bytes on
// (mbar_expect), and one stores it back, tracked by the issuing thread's bulk
// groups. Boxes past B are filled with zeros in and clipped out. Generic-
// proxy accesses of shared memory are ordered before the tensor copies that
// follow them by fence_async_smem. The host build copies at once, and its
// mbar_wait is a barrier of the block (every thread of a block waits on the
// mbarrier in the port's kernels).
#ifdef NDP_HOST_EMULATION
struct TensorMap {
  const char* base;
  int esize;
  long long cols, rows;
  int box_cols, box_rows;
};
inline int tensor_map(TensorMap* m, const void* base, int esize, long long cols, long long rows,
                      int box_cols, int box_rows) {
  *m = TensorMap{static_cast<const char*>(base), esize, cols, rows, box_cols, box_rows};
  return 0;
}
#else
using TensorMap = CUtensorMap;
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
// The map of a (rows, cols) tensor of f32 (esize 4) or bf16 (2) elements at
// base, rows `cols` elements apart, in boxes of (box_rows, box_cols); 0 or a
// cudaError.
inline int tensor_map(TensorMap* m, const void* base, int esize, long long cols, long long rows,
                      int box_cols, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      m, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
#endif

__device__ __forceinline__ unsigned smem_u32(const void* p) {
#ifdef NDP_HOST_EMULATION
  return 0;
#else
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
#endif
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
#ifndef NDP_HOST_EMULATION
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
#ifndef NDP_HOST_EMULATION
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
#endif
}
// Wait until the mbarrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
#ifdef NDP_HOST_EMULATION
  __syncthreads();
#else
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
#endif
}
// Box (col, row) of the map into dst.
__device__ __forceinline__ void tma_load(void* dst, const TensorMap* m, int col, int row,
                                         unsigned long long* bar) {
#ifdef NDP_HOST_EMULATION
  char* d = static_cast<char*>(dst);
  for (int r = 0; r < m->box_rows; ++r)
    for (int c = 0; c < m->box_cols; ++c, d += m->esize) {
      if (row + r < m->rows && col + c < m->cols)
        std::memcpy(d, m->base + ((row + r) * m->cols + col + c) * m->esize, m->esize);
      else
        std::memset(d, 0, m->esize);
    }
#else
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(m), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
#endif
}
// src into box (col, row) of the map.
__device__ __forceinline__ void tma_store(const TensorMap* m, int col, int row, const void* src) {
#ifdef NDP_HOST_EMULATION
  const char* s = static_cast<const char*>(src);
  for (int r = 0; r < m->box_rows; ++r)
    for (int c = 0; c < m->box_cols; ++c, s += m->esize)
      if (row + r < m->rows && col + c < m->cols)
        std::memcpy(const_cast<char*>(m->base) + ((row + r) * m->cols + col + c) * m->esize, s,
                    m->esize);
#else
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::
                   "l"(m),
               "r"(col), "r"(row), "r"(smem_u32(src))
               : "memory");
#endif
}
__device__ __forceinline__ void bulk_commit() {
#ifndef NDP_HOST_EMULATION
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#endif
}
// Wait until every committed store has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
#ifndef NDP_HOST_EMULATION
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
#endif
}
// Wait until every committed store has written global memory.
__device__ __forceinline__ void bulk_wait() {
#ifndef NDP_HOST_EMULATION
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#endif
}
__device__ __forceinline__ void fence_async_smem() {
#ifndef NDP_HOST_EMULATION
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// ---- the streamed sweeps' rows, element by element ----
// A block of a streamed sweep (K8, K4, K6) holds one stage's input rows in a
// landing buffer and its output rows in output buffers, [row][S]: row e of
// a field is one run of the block's S scenarios. Where the rows cannot be
// tensor-copied (above), K8 moves them with these, one f32 element a copy
// (cp.async.ca in), every thread of the block taking column tid % S of
// rows tid / S, tid / S + rpi, ... (threads past rpi * S take none).
struct Rows {
  int S, n;  // scenarios a block, the block's live ones (from b0)
  long long B, b0;
  int c, r0, rpi;
};

__device__ __forceinline__ Rows block_rows(int S, long long B, long long b0) {
  Rows R;
  R.S = S;
  R.B = B;
  R.b0 = b0;
  R.n = (int)(B - b0 < S ? B - b0 : S);
  R.rpi = blockDim.x / S;
  R.c = threadIdx.x % S;
  R.r0 = (int)threadIdx.x < R.rpi * S ? threadIdx.x / S : 1 << 30;
  return R;
}

// Rows 0..D-1 of stage k of the (., D, B) tensor g into dst[e * S + s], the
// block's live scenarios (the columns of the others are left as they are).
template <int D>
__device__ __forceinline__ void rows_in(float* dst, const float* g, int k, const Rows& R) {
  if (R.c >= R.n) return;
  const float* const gk = g + (long long)k * D * R.B + R.b0 + R.c;
  for (int e = R.r0; e < D; e += R.rpi) cp_async4(dst + e * R.S + R.c, gk + (long long)e * R.B);
}

// Rows 0..D-1 of src[e * S + s] to stage k of the (., D, B) tensor g, the
// block's live scenarios.
__device__ __forceinline__ void rows_out(float* g, const float* src, int D, int k, const Rows& R) {
  if (R.c >= R.n) return;
  float* const gk = g + (long long)k * D * R.B + R.b0 + R.c;
  for (int e = R.r0; e < D; e += R.rpi) gk[(long long)e * R.B] = src[e * R.S + R.c];
}

// Vector loads and stores: n floats between 8-byte (ld2, st2) or 16-byte
// (ld4, st4) aligned shared memory and registers. One wide access takes the
// shared-memory pipe once where n scalar ones take it n times.
template <int n>
__device__ __forceinline__ void ld2(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < n; i += 2) {
    const float2 v = *reinterpret_cast<const float2*>(src + i);
    dst[i] = v.x;
    dst[i + 1] = v.y;
  }
}
template <int n>
__device__ __forceinline__ void ld4(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < n; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    dst[i] = v.x;
    dst[i + 1] = v.y;
    dst[i + 2] = v.z;
    dst[i + 3] = v.w;
  }
}
template <int n>
__device__ __forceinline__ void st2(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < n; i += 2) *reinterpret_cast<float2*>(dst + i) = make_float2(src[i], src[i + 1]);
}
template <int n>
__device__ __forceinline__ void st4(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
}

// NaN-propagating min/max (jnp.minimum / torch.minimum semantics; fminf
// would drop a NaN and hide a failed solve from the health flag).
__device__ __forceinline__ float nmin(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float nmax(float a, float b) { return (a != a || a > b) ? a : b; }

// Cycle counts of the phases of block 0's first thread: built only with
// NDP_TEAM_CLOCKS (tools/time_team_kernels.py and tools/time_sweep_kernels.py
// read them through <kernel>_clocks); without it team_clock compiles to
// nothing. K1/K2 use the phases up to CK_STAGE_OUT; the streamed sweeps (K8,
// K4, K6) also CK_WAIT (the wait for a stage's inputs and the block barrier)
// and CK_BWD_D (K8's gain solves).
enum ClockPhase {
  CK_STAGE_IN, CK_LINEARIZE, CK_START, CK_BWD_TERMINAL, CK_BWD_A, CK_BWD_B, CK_BWD_C,
  CK_BWD_E, CK_ROLLOUT, CK_ROWS, CK_ROW_SUMS, CK_PASS_B, CK_STAGE_OUT, CK_WAIT,
  CK_BWD_D, CK_COUNT
};
#ifdef NDP_TEAM_CLOCKS
__device__ long long team_clocks[CK_COUNT];
__device__ long long team_clock_last;
__device__ __forceinline__ void team_clock(int phase) {  // phase < 0: start the clock
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long now = clock64();
    if (phase >= 0) team_clocks[phase] += now - team_clock_last;
    team_clock_last = now;
  }
}
// Copies the counts to `out` (CK_COUNT values) and zeroes them.
inline int team_clocks_take(long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, team_clocks, sizeof(long long) * CK_COUNT);
  if (e != cudaSuccess) return (int)e;
  const long long zero[CK_COUNT] = {};
  return (int)cudaMemcpyToSymbol(team_clocks, zero, sizeof(zero));
}
#else
__device__ __forceinline__ void team_clock(int) {}
#endif

// ---- the stage QP payload (solver/ocp_sparse.py SparseQp + dx0) ----

// Pointers of a payload in (stage, element, B) tensors; hq, a and b hold the
// jac dtype (float or bf16), the rest float. Shared with Python (ctypes).
struct QpPtrs {
  void* hq;    // (N+1, 16)
  float* gx;   // (N+1, 10)
  float* gu;   // (N, 4)
  void* a;     // (N, 40)
  void* b;     // (N, 30)
  float* bc;   // (N, 6)
  float* r;    // (N, 10)
  float* lub;  // (N, 4)
  float* uub;
  float* lxb;  // (N+1, 3)
  float* uxb;
  float* dx0;  // (1, 10)
};

// One scenario's view of a payload.
template <typename JT>
struct Payload {
  View<JT> hq, a, b;  // curvature, stored in the jac dtype
  View<float> gx, gu, bc, r, lub, uub, lxb, uxb, dx0;
};

template <typename JT>
__device__ inline Payload<JT> payload_at(const QpPtrs& p, long long B, long long b) {
  Payload<JT> q;
  q.hq = at(static_cast<JT*>(p.hq), 16, B, b);
  q.a = at(static_cast<JT*>(p.a), 40, B, b);
  q.b = at(static_cast<JT*>(p.b), 30, B, b);
  q.gx = at(p.gx, NX, B, b);
  q.gu = at(p.gu, NU, B, b);
  q.bc = at(p.bc, 6, B, b);
  q.r = at(p.r, NX, B, b);
  q.lub = at(p.lub, NU, B, b);
  q.uub = at(p.uub, NU, B, b);
  q.lxb = at(p.lxb, 3, B, b);
  q.uxb = at(p.uxb, 3, B, b);
  q.dx0 = at(p.dx0, NX, B, b);
  return q;
}

// ---- linearization (ops/pallas/linearize.py) ----

__device__ inline void f_cont(const float* x, const float* u, const float* fd,
                              const StepConsts& c, float* out) {
  const float qw = x[6], qx = x[7], qy = x[8], qz = x[9];
  const float wx = u[0], wy = u[1], wz = u[2], cc = u[3];
  float ax = 2.0f * (qx * qz + qw * qy) * cc;
  float ay = 2.0f * (qy * qz - qw * qx) * cc;
  float az = (1.0f - 2.0f * qx * qx - 2.0f * qy * qy) * cc - c.gravity;
  if (fd) {
    ax = ax + fd[0] * c.inv_mass;
    ay = ay + fd[1] * c.inv_mass;
    az = az + fd[2] * c.inv_mass;
  }
  out[0] = x[3];
  out[1] = x[4];
  out[2] = x[5];
  out[3] = ax;
  out[4] = ay;
  out[5] = az;
  out[6] = (-wx * qx - wy * qy - wz * qz) * 0.5f;
  out[7] = (wx * qw + wz * qy - wy * qz) * 0.5f;
  out[8] = (wy * qw - wz * qx + wx * qz) * 0.5f;
  out[9] = (wz * qw + wy * qx - wx * qy) * 0.5f;
}

// Directional derivative of f_cont at (x, u) along (tx, tu); the forecast
// force is a constant input and has no tangent.
__device__ inline void f_cont_jvp(const float* x, const float* u, const float* tx,
                                  const float* tu, float* out) {
  const float qw = x[6], qx = x[7], qy = x[8], qz = x[9];
  const float wx = u[0], wy = u[1], wz = u[2], cc = u[3];
  const float tqw = tx[6], tqx = tx[7], tqy = tx[8], tqz = tx[9];
  const float twx = tu[0], twy = tu[1], twz = tu[2], tc = tu[3];
  const float s_ax = qx * qz + qw * qy;
  const float t_ax = (tqx * qz + qx * tqz) + (tqw * qy + qw * tqy);
  const float s_ay = qy * qz - qw * qx;
  const float t_ay = (tqy * qz + qy * tqz) - (tqw * qx + qw * tqx);
  const float s_az = 1.0f - 2.0f * qx * qx - 2.0f * qy * qy;
  const float t_az = (-4.0f * qx) * tqx + (-4.0f * qy) * tqy;
  out[0] = tx[3];
  out[1] = tx[4];
  out[2] = tx[5];
  out[3] = (2.0f * t_ax) * cc + (2.0f * s_ax) * tc;
  out[4] = (2.0f * t_ay) * cc + (2.0f * s_ay) * tc;
  out[5] = t_az * cc + s_az * tc;
  const float pwx = twx * qx + wx * tqx, pwy = twy * qy + wy * tqy, pwz = twz * qz + wz * tqz;
  out[6] = 0.5f * ((-pwx - pwy) - pwz);
  out[7] = 0.5f * (((twx * qw + wx * tqw) + (twz * qy + wz * tqy)) - (twy * qz + wy * tqz));
  out[8] = 0.5f * (((twy * qw + wy * tqw) - (twz * qx + wz * tqx)) + (twx * qz + wx * tqz));
  out[9] = 0.5f * (((twz * qw + wz * tqw) + (twy * qx + wy * tqx)) - (twx * qy + wx * tqy));
}

// RK4 step and its 8 varying tangent columns, by hand in forward mode:
// columns 0-3 seed the quaternion states, 4-7 the controls (what
// `jax.linearize` replays on the traced primal chain).
__device__ inline void rk4_tangents(const float* x_in, const float* u, const float* fd,
                                    const StepConsts& c, float* xn, float T[8][NX]) {
  float x[NX];
  for (int i = 0; i < NX; ++i) x[i] = x_in[i];
  for (int col = 0; col < 8; ++col)
    for (int i = 0; i < NX; ++i) T[col][i] = (col < 4 && i == 6 + col) ? 1.0f : 0.0f;
  for (int sub = 0; sub < c.substeps; ++sub) {
    float k1[NX], k2[NX], k3[NX], k4[NX], x2[NX], x3[NX], x4[NX];
    f_cont(x, u, fd, c, k1);
    for (int i = 0; i < NX; ++i) x2[i] = x[i] + c.rk_half * k1[i];
    f_cont(x2, u, fd, c, k2);
    for (int i = 0; i < NX; ++i) x3[i] = x[i] + c.rk_half * k2[i];
    f_cont(x3, u, fd, c, k3);
    for (int i = 0; i < NX; ++i) x4[i] = x[i] + c.rk_step * k3[i];
    f_cont(x4, u, fd, c, k4);
    for (int col = 0; col < 8; ++col) {
      float tu[NU] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (col >= 4) tu[col - 4] = 1.0f;
      float* tx = T[col];
      float t1[NX], t2[NX], t3[NX], t4[NX], tt[NX];
      f_cont_jvp(x, u, tx, tu, t1);
      for (int i = 0; i < NX; ++i) tt[i] = tx[i] + c.rk_half * t1[i];
      f_cont_jvp(x2, u, tt, tu, t2);
      for (int i = 0; i < NX; ++i) tt[i] = tx[i] + c.rk_half * t2[i];
      f_cont_jvp(x3, u, tt, tu, t3);
      for (int i = 0; i < NX; ++i) tt[i] = tx[i] + c.rk_step * t3[i];
      f_cont_jvp(x4, u, tt, tu, t4);
      for (int i = 0; i < NX; ++i)
        tx[i] = tx[i] + c.rk_sixth * (t1[i] + 2.0f * t2[i] + 2.0f * t3[i] + t4[i]);
    }
    for (int i = 0; i < NX; ++i)
      x[i] = x[i] + c.rk_sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
  }
  for (int i = 0; i < NX; ++i) xn[i] = x[i];
}

// The column-wise form of rk4_tangents, for K3 (linearize.cu), which gives
// each tangent column a thread of its own: the same expressions and order,
// one substep at a time. rk4_points: the substep's evaluation points x2,
// x3, x4 from x, and the next state xn.
__device__ __forceinline__ void rk4_points(const float* x, const float* u, const float* fd,
                                           const StepConsts& c, float* x2, float* x3, float* x4,
                                           float* xn) {
  float k1[NX], k2[NX], k3[NX], k4[NX];
  f_cont(x, u, fd, c, k1);
  for (int i = 0; i < NX; ++i) x2[i] = x[i] + c.rk_half * k1[i];
  f_cont(x2, u, fd, c, k2);
  for (int i = 0; i < NX; ++i) x3[i] = x[i] + c.rk_half * k2[i];
  f_cont(x3, u, fd, c, k3);
  for (int i = 0; i < NX; ++i) x4[i] = x[i] + c.rk_step * k3[i];
  f_cont(x4, u, fd, c, k4);
  for (int i = 0; i < NX; ++i)
    xn[i] = x[i] + c.rk_sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
}
// Tangent column `col` (0-3 the quaternion states, 4-7 the controls) at
// the start of the step: its seed, and its control direction tu.
__device__ __forceinline__ void tangent_seed(int col, float* tx, float* tu) {
  for (int i = 0; i < NX; ++i) tx[i] = (col < 4 && i == 6 + col) ? 1.0f : 0.0f;
  for (int l = 0; l < NU; ++l) tu[l] = col == 4 + l ? 1.0f : 0.0f;
}
// One substep of a tangent column tx (in place) along control direction tu,
// replayed on the substep's points (f_cont_jvp reads their quaternions
// x[6..9] only).
__device__ __forceinline__ void rk4_tangent_step(const float* x, const float* x2, const float* x3,
                                                 const float* x4, const float* u,
                                                 const float* tu, const StepConsts& c,
                                                 float* tx) {
  float t1[NX], t2[NX], t3[NX], t4[NX], tt[NX];
  f_cont_jvp(x, u, tx, tu, t1);
  for (int i = 0; i < NX; ++i) tt[i] = tx[i] + c.rk_half * t1[i];
  f_cont_jvp(x2, u, tt, tu, t2);
  for (int i = 0; i < NX; ++i) tt[i] = tx[i] + c.rk_half * t2[i];
  f_cont_jvp(x3, u, tt, tu, t3);
  for (int i = 0; i < NX; ++i) tt[i] = tx[i] + c.rk_step * t3[i];
  f_cont_jvp(x4, u, tt, tu, t4);
  for (int i = 0; i < NX; ++i)
    tx[i] = tx[i] + c.rk_sixth * (t1[i] + 2.0f * t2[i] + 2.0f * t3[i] + t4[i]);
}
// Quaternion tracking error (ops/quat.py:error_vector).
__device__ inline void qe_tiles(const float* q, const float* qr, float* qe) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float qwr = qr[0], qxr = qr[1], qyr = qr[2], qzr = qr[3];
  qe[0] = qwr * qx - qw * qxr + qyr * qz - qy * qzr;
  qe[1] = qwr * qy - qw * qyr - qxr * qz + qx * qzr;
  qe[2] = qxr * qy - qx * qyr + qwr * qz - qw * qzr;
}

// Closed-form Hq = Gq^T diag(wq) Gq (16) and Gq^T (wq * qe) (4).
__device__ inline void hq_gxq_tiles(const float* qr, const float* qe, const float* wq,
                                    float* hq, float* gxq) {
  const float qw = qr[0], qx = qr[1], qy = qr[2], qz = qr[3];
  const float cols[4][3] = {{-qx, -qy, -qz}, {qw, qz, -qy}, {-qz, qw, qx}, {qy, -qx, qw}};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      hq[i * 4 + j] = wq[0] * cols[i][0] * cols[j][0] + wq[1] * cols[i][1] * cols[j][1] +
                      wq[2] * cols[i][2] * cols[j][2];
  const float v0 = wq[0] * qe[0], v1 = wq[1] * qe[1], v2 = wq[2] * qe[2];
  for (int i = 0; i < 4; ++i) gxq[i] = cols[i][0] * v0 + cols[i][1] * v1 + cols[i][2] * v2;
}

// One shooting stage's QP terms (linearize._lin_stage_terms).
__device__ inline void lin_stage_terms(const float* x, const float* x1, const float* u,
                                       const float* xr, const float* ur, const float* fd,
                                       const StepConsts& c, float* hq, float* gx, float* gu,
                                       float* a40, float* b30, float* bc6, float* r) {
  float qe[3], hq16[16], gxq[4];
  qe_tiles(x + 6, xr + 6, qe);
  hq_gxq_tiles(xr + 6, qe, c.q_diag + 7, hq16, gxq);
  for (int j = 0; j < 16; ++j) hq[j] = c.stage_scale * hq16[j];
  for (int i = 0; i < 6; ++i) gx[i] = c.gx_scale[i] * (x[i] - xr[i]);
  for (int i = 0; i < 4; ++i) gx[6 + i] = c.stage_scale * gxq[i];
  for (int l = 0; l < NU; ++l) gu[l] = c.gu_scale[l] * (u[l] - ur[l]);

  float xn[NX], T[8][NX];
  rk4_tangents(x, u, fd, c, xn, T);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j) {
      a40[i * 4 + j] = T[j][i];            // Apq
      a40[12 + i * 4 + j] = T[j][3 + i];   // Avq
    }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) a40[24 + i * 4 + j] = T[j][6 + i];  // Aqq
  for (int i = 0; i < 3; ++i) {
    for (int l = 0; l < 3; ++l) {
      b30[i * 3 + l] = T[4 + l][i];           // Bp omega columns
      b30[9 + i * 3 + l] = T[4 + l][3 + i];   // Bv omega columns
    }
    bc6[i] = T[7][i];  // collective columns stay f32
    bc6[3 + i] = T[7][3 + i];
  }
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 3; ++l) b30[18 + i * 3 + l] = T[4 + l][6 + i];  // Bq
  for (int i = 0; i < NX; ++i) r[i] = xn[i] - x1[i];
}

// Terminal-node Gauss-Newton terms (cost scaling 1).
__device__ inline void lin_terminal_terms(const float* x1, const float* xrT, const StepConsts& c,
                                          float* hqT, float* gxT) {
  float qe[3], gxq[4];
  qe_tiles(x1 + 6, xrT + 6, qe);
  hq_gxq_tiles(xrT + 6, qe, c.q_diag + 7, hqT, gxq);
  for (int i = 0; i < 6; ++i) gxT[i] = c.q_diag[i] * (x1[i] - xrT[i]);
  for (int i = 0; i < 4; ++i) gxT[6 + i] = gxq[i];
}

// One scenario's whole payload at the iterates (xb, ub): every stage's
// terms, the terminal terms, the bound residuals (u box every stage, v box on
// interior nodes, +-big on nodes 0 and N) and dx0 = x0 - xb[0]. fd.p null:
// no disturbance input.
template <typename JT>
__device__ inline void linearize_scenario(View<const float> xb, View<const float> ub,
                                          View<const float> xr, View<const float> ur,
                                          View<const float> fdv, View<const float> x0,
                                          const Payload<JT>& w, const StepConsts& c) {
  const int N = c.n_stages;
  const bool with_dist = fdv.p != nullptr;
  for (int k = 0; k < N; ++k) {
    float x[NX], x1[NX], u[NU], xrk[NX], urk[NU], fd[3];
    for (int i = 0; i < NX; ++i) {
      x[i] = xb(k, i);
      x1[i] = xb(k + 1, i);
      xrk[i] = xr(k, i);
    }
    for (int l = 0; l < NU; ++l) {
      u[l] = ub(k, l);
      urk[l] = ur(k, l);
    }
    if (with_dist)
      for (int t = 0; t < 3; ++t) fd[t] = fdv(k, t);
    float hq[16], gx[NX], gu[NU], a40[40], b30[30], bc6[6], r[NX];
    lin_stage_terms(x, x1, u, xrk, urk, with_dist ? fd : nullptr, c, hq, gx, gu, a40, b30, bc6, r);
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
    for (int t = 0; t < 3; ++t) {
      w.lxb(k, t) = k == 0 ? -c.big : c.v_lo[t] - x[3 + t];
      w.uxb(k, t) = k == 0 ? c.big : c.v_hi[t] - x[3 + t];
    }
  }
  float x1T[NX], xrT[NX], hqT[16], gxT[NX];
  for (int i = 0; i < NX; ++i) {
    x1T[i] = xb(N, i);
    xrT[i] = xr(N, i);
  }
  lin_terminal_terms(x1T, xrT, c, hqT, gxT);
  for (int j = 0; j < 16; ++j) w.hq(N, j) = stf<JT>(hqT[j]);
  for (int i = 0; i < NX; ++i) {
    w.gx(N, i) = gxT[i];
    w.dx0(0, i) = x0(0, i) - xb(0, i);
  }
  for (int t = 0; t < 3; ++t) {
    w.lxb(N, t) = -c.big;
    w.uxb(N, t) = c.big;
  }
}

// ---- Riccati stage algebra (ops/pallas/riccati_sparse.py) ----

struct Blocks {
  float apq[3][4], avq[3][4], aqq[4][4];
  float bp[3][4], bv[3][4];  // column 3 = collective (f32 payload)
  float bq[4][3];
};

template <typename JT>
__device__ inline void load_blocks(const Payload<JT>& q, int k, Blocks& m) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j) {
      m.apq[i][j] = ldf(q.a(k, i * 4 + j));
      m.avq[i][j] = ldf(q.a(k, 12 + i * 4 + j));
    }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) m.aqq[i][j] = ldf(q.a(k, 24 + i * 4 + j));
  for (int i = 0; i < 3; ++i) {
    for (int l = 0; l < 3; ++l) {
      m.bp[i][l] = ldf(q.b(k, i * 3 + l));
      m.bv[i][l] = ldf(q.b(k, 9 + i * 3 + l));
    }
    m.bp[i][3] = q.bc(k, i);
    m.bv[i][3] = q.bc(k, 3 + i);
  }
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 3; ++l) m.bq[i][l] = ldf(q.b(k, 18 + i * 3 + l));
}

// (B^T vec)[l]; bq lacks the collective column.
__device__ inline float bt_dot(const Blocks& m, const float* v, int l) {
  float s = m.bp[0][l] * v[0] + m.bp[1][l] * v[1] + m.bp[2][l] * v[2];
  s = s + (m.bv[0][l] * v[3] + m.bv[1][l] * v[4] + m.bv[2][l] * v[5]);
  if (l < 3) s = s + (m.bq[0][l] * v[6] + m.bq[1][l] * v[7] + m.bq[2][l] * v[8] + m.bq[3][l] * v[9]);
  return s;
}

struct Glue {
  float sig, corr, r_lo, r_up, rc_lo, rc_up;
};

// Slack elimination of one two-sided bound row.
__device__ inline Glue glue_pair(float v, float lo, float hi, float s_lo, float s_up, float l_lo,
                                 float l_up, float mu) {
  Glue g;
  g.r_lo = v - lo - s_lo;
  g.r_up = hi - v - s_up;
  g.rc_lo = s_lo * l_lo - mu;
  g.rc_up = s_up * l_up - mu;
  const float rs_lo = 1.0f / s_lo;
  const float rs_up = 1.0f / s_up;
  g.sig = l_lo * rs_lo + l_up * rs_up;
  g.corr = -l_lo + l_up + (g.rc_lo + l_lo * g.r_lo) * rs_lo - (g.rc_up + l_up * g.r_up) * rs_up;
  return g;
}

// P = diag6_term (+) HqT + diag(sigT on v), p = ghat_N.
__device__ inline void terminal_init_core(const float* hqT, const float* gxT, const float* zxT,
                                          const float* sigT, const float* corrT,
                                          const StepConsts& c, float* P, float* p) {
  for (int i = 0; i < NX * NX; ++i) P[i] = 0.0f;
  for (int i = 0; i < 6; ++i) {
    P[i * NX + i] = c.diag6_term[i];
    p[i] = gxT[i] + c.diag6_term[i] * zxT[i];
  }
  for (int i = 0; i < 3; ++i) {
    P[(3 + i) * NX + 3 + i] = P[(3 + i) * NX + 3 + i] + sigT[i];
    p[3 + i] = p[3 + i] + corrT[i];
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) P[(6 + i) * NX + 6 + j] = hqT[i * 4 + j];
    p[6 + i] = gxT[6 + i] + (hqT[i * 4 + 0] * zxT[6] + hqT[i * 4 + 1] * zxT[7] +
                             hqT[i * 4 + 2] * zxT[8] + hqT[i * 4 + 3] * zxT[9]);
  }
}

// Cholesky of a 4x4 SPD matrix: lower L and reciprocal diagonal Ld.
__device__ inline void chol4(const float R[4][4], float L[4][4], float* Ld) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j <= i; ++j) {
      float s = R[i][j];
      for (int t = 0; t < j; ++t) s = s - L[i][t] * L[j][t];
      if (i == j) {
        L[i][j] = sqrtf(s);
        Ld[i] = 1.0f / L[i][j];
      } else {
        L[i][j] = s * Ld[j];
      }
    }
}

// Solve (L L^T) x = rhs for one column.
__device__ inline void chol4_solve(const float L[4][4], const float* Ld, const float* rhs,
                                   float* x) {
  float y[4];
  for (int i = 0; i < 4; ++i) {
    float s = rhs[i];
    for (int t = 0; t < i; ++t) s = s - L[i][t] * y[t];
    y[i] = s * Ld[i];
  }
  for (int i = 3; i >= 0; --i) {
    float s = y[i];
    for (int t = i + 1; t < 4; ++t) s = s - L[t][i] * x[t];
    x[i] = s * Ld[i];
  }
}

// One backward Riccati stage: fused ghat/rhat assembly, structured
// products, Cholesky gain solve; P (10x10 row-major) and p update in place.
__device__ inline void riccati_stage_core(float* P, float* p, const float Hq[4][4],
                                          const float* gx, const float* gu, const Blocks& m,
                                          const float* r, const float* zx, const float* zx1,
                                          const float* zu, const float* sig_u,
                                          const float* sig_x, const float* corr_u,
                                          const float* corr_x, const StepConsts& c,
                                          float K[NU][NX], float* kf, float* rh) {
  const float h = c.h;
  const float* zq = zx + 6;
  float ghx[NX], ghu[NU];
  for (int i = 0; i < 6; ++i) ghx[i] = gx[i] + c.diag6_stage[i] * zx[i];
  for (int i = 0; i < 3; ++i) ghx[3 + i] = ghx[3 + i] + corr_x[i];
  for (int i = 0; i < 4; ++i)
    ghx[6 + i] = gx[6 + i] + (Hq[i][0] * zq[0] + Hq[i][1] * zq[1] + Hq[i][2] * zq[2] + Hq[i][3] * zq[3]);
  for (int l = 0; l < NU; ++l) ghu[l] = gu[l] + c.rdiag_stage[l] * zu[l] + corr_u[l];

  for (int i = 0; i < 3; ++i) {
    rh[i] = zx[i] + h * zx[3 + i] +
            (m.apq[i][0] * zq[0] + m.apq[i][1] * zq[1] + m.apq[i][2] * zq[2] + m.apq[i][3] * zq[3]) +
            (m.bp[i][0] * zu[0] + m.bp[i][1] * zu[1] + m.bp[i][2] * zu[2] + m.bp[i][3] * zu[3]) +
            r[i] - zx1[i];
    rh[3 + i] = zx[3 + i] +
                (m.avq[i][0] * zq[0] + m.avq[i][1] * zq[1] + m.avq[i][2] * zq[2] + m.avq[i][3] * zq[3]) +
                (m.bv[i][0] * zu[0] + m.bv[i][1] * zu[1] + m.bv[i][2] * zu[2] + m.bv[i][3] * zu[3]) +
                r[3 + i] - zx1[3 + i];
  }
  for (int i = 0; i < 4; ++i)
    rh[6 + i] = (m.aqq[i][0] * zq[0] + m.aqq[i][1] * zq[1] + m.aqq[i][2] * zq[2] + m.aqq[i][3] * zq[3]) +
                (m.bq[i][0] * zu[0] + m.bq[i][1] * zu[1] + m.bq[i][2] * zu[2]) + r[6 + i] - zx1[6 + i];

  float Prp[NX];
  for (int i = 0; i < NX; ++i) {
    float s = P[i * NX] * rh[0];
    for (int j = 1; j < NX; ++j) s = s + P[i * NX + j] * rh[j];
    Prp[i] = s + p[i];
  }

  // PA columns: p-cols copy, v-cols h-shift, q-cols one 10x4 contraction
  float PA[NX][NX], PB[NX][NU];
  for (int i = 0; i < NX; ++i) {
    const float* Pi = P + i * NX;
    for (int j = 0; j < 3; ++j) {
      PA[i][j] = Pi[j];
      PA[i][3 + j] = h * Pi[j] + Pi[3 + j];
    }
    for (int j = 0; j < 4; ++j)
      PA[i][6 + j] = (Pi[0] * m.apq[0][j] + Pi[1] * m.apq[1][j] + Pi[2] * m.apq[2][j]) +
                     (Pi[3] * m.avq[0][j] + Pi[4] * m.avq[1][j] + Pi[5] * m.avq[2][j]) +
                     (Pi[6] * m.aqq[0][j] + Pi[7] * m.aqq[1][j] + Pi[8] * m.aqq[2][j] + Pi[9] * m.aqq[3][j]);
    for (int l = 0; l < NU; ++l) {
      float s = (Pi[0] * m.bp[0][l] + Pi[1] * m.bp[1][l] + Pi[2] * m.bp[2][l]) +
                (Pi[3] * m.bv[0][l] + Pi[4] * m.bv[1][l] + Pi[5] * m.bv[2][l]);
      if (l < 3)
        s = s + (Pi[6] * m.bq[0][l] + Pi[7] * m.bq[1][l] + Pi[8] * m.bq[2][l] + Pi[9] * m.bq[3][l]);
      PB[i][l] = s;
    }
  }

  // Qh = Hxx + diag(sig) + A^T P A: q-rows on/above the diagonal only
  float Qh[NX][NX];
  for (int j = 0; j < NX; ++j)
    for (int i = 0; i < 3; ++i) {
      Qh[i][j] = PA[i][j];
      Qh[3 + i][j] = h * PA[i][j] + PA[3 + i][j];
    }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 6 + i; ++j) Qh[6 + i][j] = Qh[j][6 + i];
    for (int j = 6 + i; j < NX; ++j)
      Qh[6 + i][j] = (m.apq[0][i] * PA[0][j] + m.apq[1][i] * PA[1][j] + m.apq[2][i] * PA[2][j]) +
                     (m.avq[0][i] * PA[3][j] + m.avq[1][i] * PA[4][j] + m.avq[2][i] * PA[5][j]) +
                     (m.aqq[0][i] * PA[6][j] + m.aqq[1][i] * PA[7][j] + m.aqq[2][i] * PA[8][j] +
                      m.aqq[3][i] * PA[9][j]);
  }
  for (int i = 0; i < 6; ++i) Qh[i][i] = Qh[i][i] + c.diag6_stage[i];
  for (int i = 0; i < 3; ++i) Qh[3 + i][3 + i] = Qh[3 + i][3 + i] + sig_x[i];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) Qh[6 + i][6 + j] = Qh[6 + i][6 + j] + Hq[i][j];

  // S = B^T PA (4x10); Rh = diag + sig_u + B^T PB (upper, mirrored)
  float S[NU][NX], Rh[4][4], col[NX];
  for (int j = 0; j < NX; ++j) {
    for (int t = 0; t < NX; ++t) col[t] = PA[t][j];
    for (int l = 0; l < NU; ++l) S[l][j] = bt_dot(m, col, l);
  }
  for (int mm = 0; mm < NU; ++mm) {
    for (int t = 0; t < NX; ++t) col[t] = PB[t][mm];
    for (int l = 0; l <= mm; ++l) {
      Rh[l][mm] = bt_dot(m, col, l);
      if (mm > l) Rh[mm][l] = Rh[l][mm];
    }
  }
  for (int l = 0; l < NU; ++l) Rh[l][l] = Rh[l][l] + (c.rdiag_stage[l] + sig_u[l]);

  float qv[NX], rv[NU];
  for (int i = 0; i < 3; ++i) {
    qv[i] = ghx[i] + Prp[i];
    qv[3 + i] = ghx[3 + i] + h * Prp[i] + Prp[3 + i];
  }
  for (int i = 0; i < 4; ++i)
    qv[6 + i] = ghx[6 + i] + ((m.apq[0][i] * Prp[0] + m.apq[1][i] * Prp[1] + m.apq[2][i] * Prp[2]) +
                              (m.avq[0][i] * Prp[3] + m.avq[1][i] * Prp[4] + m.avq[2][i] * Prp[5]) +
                              (m.aqq[0][i] * Prp[6] + m.aqq[1][i] * Prp[7] + m.aqq[2][i] * Prp[8] +
                               m.aqq[3][i] * Prp[9]));
  for (int l = 0; l < NU; ++l) rv[l] = ghu[l] + bt_dot(m, Prp, l);

  float L[4][4], Ld[4], rhs[4], sol[4];
  chol4(Rh, L, Ld);
  for (int k = 0; k < NX; ++k) {
    for (int l = 0; l < NU; ++l) rhs[l] = S[l][k];
    chol4_solve(L, Ld, rhs, sol);
    for (int l = 0; l < NU; ++l) K[l][k] = -sol[l];
  }
  chol4_solve(L, Ld, rv, sol);
  for (int l = 0; l < NU; ++l) kf[l] = -sol[l];

  // P_new = Qh + S^T K (upper computed, lower mirrored); p_new = qv + S^T kf
  for (int i = 0; i < NX; ++i)
    for (int j = i; j < NX; ++j) {
      const float v = Qh[i][j] + (S[0][i] * K[0][j] + S[1][i] * K[1][j] + S[2][i] * K[2][j] +
                                  S[3][i] * K[3][j]);
      P[i * NX + j] = v;
      P[j * NX + i] = v;
    }
  for (int i = 0; i < NX; ++i)
    p[i] = qv[i] + (S[0][i] * kf[0] + S[1][i] * kf[1] + S[2][i] * kf[2] + S[3][i] * kf[3]);
}

// dx_{k+1} = A dx_k + B du_k + rh (du == nullptr: zero-control rollout).
__device__ inline void dyn_step(const Blocks& m, const float* rh, float h, const float* dx,
                                const float* du, float* nxt) {
  const float* dq = dx + 6;
  for (int i = 0; i < 3; ++i) {
    float a = dx[i] + h * dx[3 + i] +
              (m.apq[i][0] * dq[0] + m.apq[i][1] * dq[1] + m.apq[i][2] * dq[2] + m.apq[i][3] * dq[3]);
    float v = dx[3 + i] +
              (m.avq[i][0] * dq[0] + m.avq[i][1] * dq[1] + m.avq[i][2] * dq[2] + m.avq[i][3] * dq[3]);
    if (du) {
      a = a + (m.bp[i][0] * du[0] + m.bp[i][1] * du[1] + m.bp[i][2] * du[2] + m.bp[i][3] * du[3]);
      v = v + (m.bv[i][0] * du[0] + m.bv[i][1] * du[1] + m.bv[i][2] * du[2] + m.bv[i][3] * du[3]);
    }
    nxt[i] = a + rh[i];
    nxt[3 + i] = v + rh[3 + i];
  }
  for (int i = 0; i < 4; ++i) {
    float q = m.aqq[i][0] * dq[0] + m.aqq[i][1] * dq[1] + m.aqq[i][2] * dq[2] + m.aqq[i][3] * dq[3];
    if (du) q = q + (m.bq[i][0] * du[0] + m.bq[i][1] * du[1] + m.bq[i][2] * du[2]);
    nxt[6 + i] = q + rh[6 + i];
  }
}

// Fraction-to-boundary ratio; 2 where dv >= 0 (callers clamp at 1).
__device__ inline float ratio(float v, float dv, float tau) {
  return dv < 0.0f ? (-tau * v) / dv : 2.0f;
}

struct Steps {
  float ds_lo, ds_up, dl_lo, dl_up, ap, ad;
};

// Slack/dual direction recovery for one bound row and its step ratios.
__device__ inline Steps bound_steps(float d, const Glue& g, float s_lo, float s_up, float l_lo,
                                    float l_up, float tau) {
  Steps st;
  st.ds_lo = d + g.r_lo;
  st.ds_up = -d + g.r_up;
  st.dl_lo = -(g.rc_lo + l_lo * st.ds_lo) / s_lo;
  st.dl_up = -(g.rc_up + l_up * st.ds_up) / s_up;
  st.ap = nmin(ratio(s_lo, st.ds_lo, tau), ratio(s_up, st.ds_up, tau));
  st.ad = nmin(ratio(l_lo, st.dl_lo, tau), ratio(l_up, st.dl_up, tau));
  return st;
}

// Pass-A accumulators: step ratios and the complementarity partials.
struct StepAcc {
  float ap, ad, c1, c2, c3, c4;
  __device__ Steps row(float v, float d, float lo, float hi, float s_lo, float s_up, float l_lo,
                       float l_up, float mu, float tau) {
    const Glue g = glue_pair(v, lo, hi, s_lo, s_up, l_lo, l_up, mu);
    const Steps st = bound_steps(d, g, s_lo, s_up, l_lo, l_up, tau);
    ap = nmin(ap, st.ap);
    ad = nmin(ad, st.ad);
    c1 = c1 + s_lo * l_lo + s_up * l_up;
    c2 = c2 + st.ds_lo * l_lo + st.ds_up * l_up;
    c3 = c3 + s_lo * st.dl_lo + s_up * st.dl_up;
    c4 = c4 + st.ds_lo * st.dl_lo + st.ds_up * st.dl_up;
    return st;
  }
};

// Pass-B update of one bound row's slacks and duals, in place.
__device__ inline void update_row(float v, float d, float lo, float hi, float& s_lo, float& s_up,
                                  float& l_lo, float& l_up, float mu, float ap, float ad) {
  const Glue g = glue_pair(v, lo, hi, s_lo, s_up, l_lo, l_up, mu);
  const float ds_lo = d + g.r_lo;
  const float ds_up = -d + g.r_up;
  const float nl_lo = l_lo + ad * (-(g.rc_lo + l_lo * ds_lo) / s_lo);
  const float nl_up = l_up + ad * (-(g.rc_up + l_up * ds_up) / s_up);
  s_lo = s_lo + ap * ds_lo;
  s_up = s_up + ap * ds_up;
  l_lo = nl_lo;
  l_up = nl_up;
}

// Slacks and duals of the box rows: u rows (N, 4), v rows (N+1, 3).
struct Bounds {
  View<float> sul, suu, sxl, sxu, lul, luu, lxl, lxu;
};

// Slack and dual directions of the box rows; not stored where sul.p is null.
struct Dirs {
  View<float> sul, suu, lul, luu, sxl, sxu, lxl, lxu;
};

// ---- one Riccati sweep (ops/pallas/riccati_sparse.py) ----

// Where the backward sweep takes the box rows' Hessian additions and
// gradient corrections (sig, corr) from. Each source answers u_row(k, l, v)
// and x_row(k, i, v) for the row's current value v, so both sweeps below run
// the same terminal_init_core / riccati_stage_core code.

// The slack elimination from the slacks, duals and barrier weight
// (`_backward_kernel_glue`: glue_pair in the sweep).
struct GlueRows {
  View<float> lub, uub, lxb, uxb;  // the payload's box residuals
  Bounds bd;
  float mu;
  __device__ void u_row(int k, int l, float v, float& sig, float& corr) const {
    const Glue g = glue_pair(v, lub(k, l), uub(k, l), bd.sul(k, l), bd.suu(k, l), bd.lul(k, l),
                             bd.luu(k, l), mu);
    sig = g.sig;
    corr = g.corr;
  }
  __device__ void x_row(int k, int i, float v, float& sig, float& corr) const {
    const Glue g = glue_pair(v, lxb(k, i), uxb(k, i), bd.sxl(k, i), bd.sxu(k, i), bd.lxl(k, i),
                             bd.lxu(k, i), mu);
    sig = g.sig;
    corr = g.corr;
  }
};

// Given tensors sig_u/corr_u (N, 4), sig_x/corr_x (N+1, 3) (`_backward_kernel`
// of `riccati_sweep_sparse`, whose caller forms them).
struct GivenRows {
  View<float> sig_u, corr_u, sig_x, corr_x;
  __device__ void u_row(int k, int l, float, float& sig, float& corr) const {
    sig = sig_u(k, l);
    corr = corr_u(k, l);
  }
  __device__ void x_row(int k, int i, float, float& sig, float& corr) const {
    sig = sig_x(k, i);
    corr = corr_x(k, i);
  }
};

// Backward Riccati sweep at the iterate (zx, zu), stages N-1..0, with the
// box rows' terms from `rows`. Writes the gains K (N, 40), kf (N, 4) and the
// defects rh (N, 10); returns the sum of rh^2 over the stages, in loop order.
template <typename JT, typename Rows>
__device__ inline float backward_sweep(const Payload<JT>& q, View<float> zx, View<float> zu,
                                       const Rows& rows, View<float> Ko, View<float> kfo,
                                       View<float> rho, const StepConsts& c) {
  const int N = c.n_stages;
  float P[NX * NX], p[NX];
  {
    float zxT[NX], hqT[16], gxT[NX], sigT[3], corrT[3];
    for (int i = 0; i < NX; ++i) zxT[i] = zx(N, i);
    for (int i = 0; i < 3; ++i) rows.x_row(N, i, zxT[3 + i], sigT[i], corrT[i]);
    for (int j = 0; j < 16; ++j) hqT[j] = ldf(q.hq(N, j));
    for (int i = 0; i < NX; ++i) gxT[i] = q.gx(N, i);
    terminal_init_core(hqT, gxT, zxT, sigT, corrT, c, P, p);
  }
  Blocks m;
  float r2 = 0.0f;
  for (int k = N - 1; k >= 0; --k) {
    float Hq[4][4], gx[NX], gu[NU], rk[NX], zxk[NX], zx1[NX], zuk[NU];
    float sig_u[NU], corr_u[NU], sig_x[3], corr_x[3], K[NU][NX], kf[NU], rh[NX];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) Hq[i][j] = ldf(q.hq(k, i * 4 + j));
    for (int i = 0; i < NX; ++i) {
      gx[i] = q.gx(k, i);
      rk[i] = q.r(k, i);
      zxk[i] = zx(k, i);
      zx1[i] = zx(k + 1, i);
    }
    for (int l = 0; l < NU; ++l) {
      gu[l] = q.gu(k, l);
      zuk[l] = zu(k, l);
    }
    load_blocks(q, k, m);
    for (int l = 0; l < NU; ++l) rows.u_row(k, l, zuk[l], sig_u[l], corr_u[l]);
    for (int i = 0; i < 3; ++i) rows.x_row(k, i, zxk[3 + i], sig_x[i], corr_x[i]);
    riccati_stage_core(P, p, Hq, gx, gu, m, rk, zxk, zx1, zuk, sig_u, sig_x, corr_u, corr_x, c,
                       K, kf, rh);
    for (int l = 0; l < NU; ++l) {
      for (int j = 0; j < NX; ++j) Ko(k, l * NX + j) = K[l][j];
      kfo(k, l) = kf[l];
    }
    float sq = rh[0] * rh[0];
    for (int i = 0; i < NX; ++i) {
      rho(k, i) = rh[i];
      if (i > 0) sq = sq + rh[i] * rh[i];
    }
    r2 = r2 + sq;
  }
  return r2;
}

// The sweep with the slack elimination of the box rows (`_backward_kernel_glue`).
template <typename JT>
__device__ inline float backward_sweep(const Payload<JT>& q, View<float> zx, View<float> zu,
                                       const Bounds& bd, float mu, View<float> Ko, View<float> kfo,
                                       View<float> rho, const StepConsts& c) {
  return backward_sweep(q, zx, zu, GlueRows{q.lub, q.uub, q.lxb, q.uxb, bd, mu}, Ko, kfo, rho, c);
}

// The forward rollout of a sweep from dx (clobbered): for k = 0..N-1,
// du = K_k dx + kf_k, then visit(k, dx, du) (which may change du before it
// is used, and stores what its caller wants), then after(k, m, rk) with
// stage k's blocks and defect loaded, then dx <- A_k dx + B_k du + rh_k.
// dx holds node N at the end.
template <typename JT, typename Visit, typename After>
__device__ inline void rollout(const Payload<JT>& q, View<float> Ko, View<float> kfo,
                               View<float> rho, float* dx, const StepConsts& c, Visit&& visit,
                               After&& after) {
  const int N = c.n_stages;
  Blocks m;
  float rk[NX], nxt[NX];
  for (int k = 0; k < N; ++k) {
    float du[NU];
    for (int l = 0; l < NU; ++l) {
      float sdu = Ko(k, l * NX) * dx[0];
      for (int j = 1; j < NX; ++j) sdu = sdu + Ko(k, l * NX + j) * dx[j];
      du[l] = sdu + kfo(k, l);
    }
    visit(k, dx, du);
    load_blocks(q, k, m);
    for (int i = 0; i < NX; ++i) rk[i] = rho(k, i);
    after(k, m, rk);
    dyn_step(m, rk, c.h, dx, du, nxt);
    for (int i = 0; i < NX; ++i) dx[i] = nxt[i];
  }
}

// Forward rollout from dx (the dx0 residual; clobbered) with the gains of
// `backward_sweep`, plus the direction recovery, fraction-to-boundary ratios
// and complementarity partials of every box row (`_forward_kernel_glue`).
// Writes the directions dxo (N+1, 10), duo (N, 4) and, where dirs.sul.p is
// set, the slack and dual directions; returns the accumulators over all rows
// in loop order (ap/ad not yet clamped at 1).
template <typename JT>
__device__ inline StepAcc forward_pass(const Payload<JT>& q, View<float> Ko, View<float> kfo,
                                       View<float> rho, View<float> zx, View<float> zu,
                                       const Bounds& bd, float mu, float* dx, View<float> dxo,
                                       View<float> duo, const Dirs& dirs, const StepConsts& c) {
  const int N = c.n_stages;
  const bool store = dirs.sul.p != nullptr;
  StepAcc acc{2.0f, 2.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  auto x_rows = [&](int k, const float* x) {
    for (int i = 0; i < 3; ++i) {
      const Steps st = acc.row(zx(k, 3 + i), x[3 + i], q.lxb(k, i), q.uxb(k, i), bd.sxl(k, i),
                               bd.sxu(k, i), bd.lxl(k, i), bd.lxu(k, i), mu, c.tau);
      if (store) {
        dirs.sxl(k, i) = st.ds_lo;
        dirs.sxu(k, i) = st.ds_up;
        dirs.lxl(k, i) = st.dl_lo;
        dirs.lxu(k, i) = st.dl_up;
      }
    }
  };
  rollout(
      q, Ko, kfo, rho, dx, c,
      [&](int k, const float* x, float* du) {
        for (int i = 0; i < NX; ++i) dxo(k, i) = x[i];
        for (int l = 0; l < NU; ++l) duo(k, l) = du[l];
        for (int l = 0; l < NU; ++l) {
          const Steps st = acc.row(zu(k, l), du[l], q.lub(k, l), q.uub(k, l), bd.sul(k, l),
                                   bd.suu(k, l), bd.lul(k, l), bd.luu(k, l), mu, c.tau);
          if (store) {
            dirs.sul(k, l) = st.ds_lo;
            dirs.suu(k, l) = st.ds_up;
            dirs.lul(k, l) = st.dl_lo;
            dirs.luu(k, l) = st.dl_up;
          }
        }
        x_rows(k, x);
      },
      [](int, const Blocks&, const float*) {});
  for (int i = 0; i < NX; ++i) dxo(N, i) = dx[i];
  x_rows(N, dx);
  return acc;
}

}  // namespace ndp
