// Host stand-in for the CUDA pieces csrc/dense.cu uses, so that g++ can
// compile that file and run its kernels on the CPU
// (tests/test_torch_dense_cuda_host.py).  Not a CUDA runtime: qualifiers
// vanish, __shared__ arrays become function statics, a launch runs its
// blocks one after another, and a block whose kernel uses warp
// collectives runs one warp at a time as 32 host threads, one a lane,
// whose __ballot_sync and __syncwarp meet at a barrier.
#pragma once
#include <stdint.h>
#include <string.h>

#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

struct WarpBarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, gen = 0;
  unsigned ballot = 0, result = 0;
};
inline WarpBarrier g_warp;

inline unsigned __ballot_sync(unsigned, int pred) {
  std::unique_lock<std::mutex> lk(g_warp.m);
  if (pred) g_warp.ballot |= 1u << (threadIdx.x & 31);
  int gen = g_warp.gen;
  if (++g_warp.count == 32) {
    g_warp.result = g_warp.ballot;
    g_warp.ballot = 0;
    g_warp.count = 0;
    ++g_warp.gen;
    g_warp.cv.notify_all();
  } else {
    g_warp.cv.wait(lk, [&] { return g_warp.gen != gen; });
  }
  return g_warp.result;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { __ballot_sync(0xFFFFFFFFu, 0); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline long long __double_as_longlong(double f) { long long i; memcpy(&i, &f, 8); return i; }

template <typename T>
inline T atomicMax(T* p, T v) {
  T old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v &&
         !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}

// kernel<<<grid, block, 0, stream>>>(args) becomes
// host_launch(grid, block, warps, [&] { kernel(args); }).
inline void host_launch(dim3 grid, dim3 block, bool warps, const std::function<void()>& body) {
  gridDim = grid;
  blockDim = block;
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      if (!warps) {
        blockIdx = dim3(bx, by);
        for (unsigned t = 0; t < block.x; ++t) {
          threadIdx = dim3(t);
          body();
        }
        continue;
      }
      for (unsigned w = 0; w < block.x / 32; ++w) {
        std::vector<std::thread> lanes;
        for (unsigned l = 0; l < 32; ++l)
          lanes.emplace_back([&, w, l, bx, by] {
            blockIdx = dim3(bx, by);
            threadIdx = dim3(w * 32 + l);
            body();
          });
        for (auto& t : lanes) t.join();
      }
    }
}
