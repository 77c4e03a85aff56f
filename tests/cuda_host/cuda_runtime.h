// Host stand-in for the CUDA pieces csrc/dense.cu uses, so that g++ can
// compile that file and run its kernels on the CPU
// (tests/test_torch_dense_cuda_host.py).  Not a CUDA runtime: qualifiers
// vanish, __shared__ arrays become function statics, and a launch runs
// its blocks one after another, each block one warp at a time, the
// warp's 32 lanes as coroutines on the launching thread, which meet at
// __ballot_sync, __syncwarp, __shfl_sync and __shfl_xor_sync.  The
// kernels cooperate within a warp only (no __syncthreads), so warps in
// turn behave as warps in parallel.
#pragma once
#include <stdint.h>
#include <string.h>

#include <stdio.h>
#include <stdlib.h>
#include <ucontext.h>

#include <functional>
#include <vector>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

struct uint4 {
  unsigned x, y, z, w;
};

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes, sharedSizeBytes;
};
template <typename K>
inline int cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  memset(a, 0, sizeof(*a));
  return cudaSuccess;
}
template <typename K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 0;
  return cudaSuccess;
}

// The warp: 32 lanes as coroutines on the launching thread (ucontext),
// run in turn until each reaches a collective or returns.  A collective
// completes once every lane has reached it (a lane that returns while
// others wait is a kernel bug: abort).
struct HostWarp {
  ucontext_t main_ctx, lane_ctx[32];
  std::vector<char> stack[32];
  bool done[32];
  int lane = 0;
  unsigned ballot = 0, result = 0;
  uint64_t value[32];
  const std::function<void()>* body = nullptr;
};
inline HostWarp g_warp;

inline void host_lane_entry() {
  (*g_warp.body)();
  g_warp.done[g_warp.lane] = true;  // uc_link resumes the scheduler
}

// Every lane's arrival at a collective: back to the scheduler.
inline unsigned __ballot_sync(unsigned, int pred) {
  const int lane = g_warp.lane;
  if (pred) g_warp.ballot |= 1u << lane;
  swapcontext(&g_warp.lane_ctx[lane], &g_warp.main_ctx);
  return g_warp.result;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { __ballot_sync(0xFFFFFFFFu, 0); }
template <typename T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  const unsigned lane = threadIdx.x & 31;
  memcpy(&g_warp.value[lane], &v, sizeof(T));
  __syncwarp();
  T out;
  memcpy(&out, &g_warp.value[src_lane & 31], sizeof(T));
  __syncwarp();
  return out;
}
template <typename T>
inline T __shfl_xor_sync(unsigned mask, T v, int lane_mask) {
  return __shfl_sync(mask, v, (int)(threadIdx.x & 31) ^ lane_mask);
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline long long __double_as_longlong(double f) { long long i; memcpy(&i, &f, 8); return i; }

// One host thread runs every lane: plain read-modify-writes are atomic.
template <typename T>
inline T atomicMax(T* p, T v) {
  T old = *p;
  if (old < v) *p = v;
  return old;
}
template <typename T>
inline T atomicMin(T* p, T v) {
  T old = *p;
  if (v < old) *p = v;
  return old;
}
template <typename T>
inline T atomicAdd(T* p, T v) {
  T old = *p;
  *p = old + v;
  return old;
}

// kernel<<<grid, block, 0, stream>>>(args) becomes
// host_launch(grid, block, [&] { kernel(args); }): every warp of every
// block in turn.
inline void host_launch(dim3 grid, dim3 block, const std::function<void()>& body) {
  gridDim = grid;
  blockDim = block;
  HostWarp& w = g_warp;
  w.body = &body;
  for (int l = 0; l < 32; ++l) w.stack[l].resize(1 << 18);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (unsigned wi = 0; wi < block.x / 32; ++wi) {
        blockIdx = dim3(bx, by);
        for (int l = 0; l < 32; ++l) {
          getcontext(&w.lane_ctx[l]);
          w.lane_ctx[l].uc_stack.ss_sp = w.stack[l].data();
          w.lane_ctx[l].uc_stack.ss_size = w.stack[l].size();
          w.lane_ctx[l].uc_link = &w.main_ctx;
          makecontext(&w.lane_ctx[l], host_lane_entry, 0);
          w.done[l] = false;
        }
        for (;;) {
          int n_done = 0;
          for (int l = 0; l < 32; ++l) {
            if (!w.done[l]) {
              w.lane = l;
              threadIdx = dim3(wi * 32 + l);
              swapcontext(&w.main_ctx, &w.lane_ctx[l]);
            }
            n_done += w.done[l];
          }
          if (n_done == 32) break;
          if (n_done) {
            fprintf(stderr, "host_launch: %d lanes returned while the others wait at a "
                            "collective\n", n_done);
            abort();
          }
          w.result = w.ballot;
          w.ballot = 0;
        }
      }
}
