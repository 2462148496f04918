// Host stand-ins for the CUDA runtime and the device built-ins that the
// port's kernels use, so that csrc/*.cu builds as host C++ with
// -DNDP_HOST_EMULATION (see ../__init__.py). A launch (NDP_LAUNCH in
// ndp.cuh) runs the blocks one after another; each thread of a block runs
// on a host thread of its own. __syncthreads is a barrier of the block,
// __syncwarp(mask) one of the lanes of the thread's warp in the mask (those
// the block has): in the port's kernels every thread of a block meets the
// block's barriers, and every lane of a mask its mask's, in the same order.
// A warp shuffle goes through a per-block array between two waits at the
// barrier of the thread's whole warp. Shared memory is one buffer, refilled
// with NaN bytes before each block.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__

struct uint3 {
  unsigned x, y, z;
};
struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef struct CUstream_st* cudaStream_t;

// What one block may hold on sm_90: the kernels' launches are refused above it.
alignas(16) inline float4 ndp_smem[232448 / 16];

namespace ndp_emulate {
inline thread_local uint3 thread_idx, block_idx, block_dim;
inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local std::barrier<>* warp_barrier = nullptr;

// The barriers of one warp's lane masks, made at a mask's first use.
struct WarpMasks {
  std::mutex m;
  unsigned present = 0;  // the warp's lanes the block has
  std::map<unsigned, std::unique_ptr<std::barrier<>>> bars;
  std::barrier<>& of(unsigned mask) {
    std::lock_guard<std::mutex> lock(m);
    auto& b = bars[mask];
    if (!b) b = std::make_unique<std::barrier<>>(__builtin_popcount(mask & present));
    return *b;
  }
};
inline thread_local WarpMasks* warp_masks = nullptr;
inline cudaError_t last_error = cudaSuccess;

// Runs `body` as a grid of `grid` blocks of `block` threads.
template <typename F>
void launch(unsigned grid, int block, int smem, F&& body) {
  if (block < 1 || block > 1024 || smem < 0 || smem > (int)sizeof(ndp_smem)) {
    last_error = cudaErrorInvalidValue;
    return;
  }
  for (unsigned bx = 0; bx < grid; ++bx) {
    std::memset(ndp_smem, 0xff, sizeof(ndp_smem));  // NaN in every float
    std::barrier<> bar(block);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    std::vector<std::unique_ptr<WarpMasks>> masks;
    for (int w = 0; w * 32 < block; ++w) {
      const int lanes = block - 32 * w < 32 ? block - 32 * w : 32;
      warps.push_back(std::make_unique<std::barrier<>>(lanes));
      masks.push_back(std::make_unique<WarpMasks>());
      masks.back()->present = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
    }
    std::vector<std::thread> threads;
    threads.reserve(block);
    for (int tx = 0; tx < block; ++tx)
      threads.emplace_back([&, tx] {
        thread_idx = uint3{(unsigned)tx, 0, 0};
        block_idx = uint3{bx, 0, 0};
        block_dim = uint3{(unsigned)block, 1, 1};
        block_barrier = &bar;
        warp_barrier = warps[tx / 32].get();
        warp_masks = masks[tx / 32].get();
        body();
      });
    for (auto& t : threads) t.join();
  }
}
}  // namespace ndp_emulate

#define threadIdx (ndp_emulate::thread_idx)
#define blockIdx (ndp_emulate::block_idx)
#define blockDim (ndp_emulate::block_dim)

inline void __syncthreads() { ndp_emulate::block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  ndp_emulate::warp_masks->of(mask).arrive_and_wait();
}
namespace ndp_emulate {
inline float shfl_buf[1024];
// The value that thread `from` of the block passed in.
inline float exchange(float v, unsigned from) {
  shfl_buf[thread_idx.x] = v;
  warp_barrier->arrive_and_wait();
  const float r = shfl_buf[from];
  warp_barrier->arrive_and_wait();
  return r;
}
}  // namespace ndp_emulate
// Lane `src` of the thread's width-lane segment of its warp.
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  const unsigned me = ndp_emulate::thread_idx.x;
  return ndp_emulate::exchange(v, (me & ~31u) + ((me & 31u) & ~unsigned(width - 1)) +
                                      unsigned(src % width));
}
inline float __shfl_xor_sync(unsigned, float v, int mask, int = 32) {
  return ndp_emulate::exchange(v, ndp_emulate::thread_idx.x ^ unsigned(mask));
}
// A load through the read-only path: a plain load.
template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

inline cudaError_t cudaGetLastError() {
  const cudaError_t e = ndp_emulate::last_error;
  ndp_emulate::last_error = cudaSuccess;
  return e;
}
template <typename Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int bytes) {
  return bytes <= (int)sizeof(ndp_smem) ? cudaSuccess : cudaErrorInvalidValue;
}
