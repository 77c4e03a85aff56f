// Host stand-in for the CUDA pieces csrc/dense.cu and csrc/render.cu use,
// so that g++ can compile those files and run their kernels on the CPU
// (tests/test_torch_dense_cuda_host.py, tests/test_torch_render_cuda_host.py).
// Not a CUDA runtime: qualifiers vanish, __shared__ arrays become function
// statics, dynamic shared memory is a buffer the launch sizes
// (host_dynamic_shared), and a launch runs its blocks one after another,
// each block's threads as coroutines on the launching thread (ucontext).
// A thread runs until it reaches a collective or returns.  A warp's
// collectives (__ballot_sync, __syncwarp, __shfl_sync, __shfl_xor_sync)
// complete once its 32 lanes have reached one; __syncthreads completes
// once every thread of the block has reached it.  A thread that returns
// while others of its warp wait at a collective, or of its block at
// __syncthreads, is a kernel bug: abort.  Block sizes are whole warps.
// A thread starts through makecontext and switches with _setjmp and
// _longjmp, which, unlike swapcontext, make no system call.
#pragma once
#include <setjmp.h>
#include <stdint.h>
#include <string.h>

#include <stdio.h>
#include <stdlib.h>
#include <ucontext.h>

#include <functional>
#include <memory>
#include <vector>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

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
typedef void* cudaEvent_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// A launch here runs before it returns, so a timing event has nothing to
// stamp.
inline cudaError_t cudaEventRecord(cudaEvent_t, cudaStream_t) { return cudaSuccess; }

struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes, sharedSizeBytes;
};
template <typename K>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  memset(a, 0, sizeof(*a));
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 0;
  return cudaSuccess;
}

// The device's int min and max (float code calls fminf and fmaxf).
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// The block: its threads as coroutines, run in turn until each reaches a
// collective or returns.
enum { HOST_RUN, HOST_AT_WARP, HOST_AT_BLOCK, HOST_DONE };
struct HostThread {
  ucontext_t start;  // its entry, on its own stack
  jmp_buf resume;    // where it waits, once started
  std::unique_ptr<char[]> stack;
  int state;
  bool started;
};
struct HostWarpMeet {
  unsigned ballot, result;
  uint64_t value[32];
};
struct HostBlock {
  static constexpr size_t STACK_BYTES = 1 << 18;
  jmp_buf scheduler;
  std::vector<HostThread> threads;
  std::vector<HostWarpMeet> warps;
  std::vector<uint64_t> dynamic_shared;  // 8-byte words
  int current = 0;
  const std::function<void()>* body = nullptr;
};
inline HostBlock g_block;

// The launch's dynamic shared memory (extern __shared__ in CUDA).
inline void* host_dynamic_shared() { return g_block.dynamic_shared.data(); }

inline void host_thread_entry() {
  (*g_block.body)();
  g_block.threads[g_block.current].state = HOST_DONE;
  _longjmp(g_block.scheduler, 1);
}

inline void host_yield(int state) {
  HostThread& t = g_block.threads[g_block.current];
  t.state = state;
  if (!_setjmp(t.resume)) _longjmp(g_block.scheduler, 1);
}

// A lane's arrival at one of its warp's collectives.
inline unsigned __ballot_sync(unsigned, int pred) {
  const int tid = g_block.current;
  HostWarpMeet& w = g_block.warps[tid >> 5];
  if (pred) w.ballot |= 1u << (tid & 31);
  host_yield(HOST_AT_WARP);
  return w.result;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { __ballot_sync(0xFFFFFFFFu, 0); }
template <typename T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  const int tid = g_block.current;
  HostWarpMeet& w = g_block.warps[tid >> 5];
  memcpy(&w.value[tid & 31], &v, sizeof(T));
  __syncwarp();
  T out;
  memcpy(&out, &w.value[src_lane & 31], sizeof(T));
  __syncwarp();
  return out;
}
template <typename T>
inline T __shfl_xor_sync(unsigned mask, T v, int lane_mask) {
  return __shfl_sync(mask, v, (g_block.current & 31) ^ lane_mask);
}
inline void __syncthreads() { host_yield(HOST_AT_BLOCK); }

inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline long long __double_as_longlong(double f) { long long i; memcpy(&i, &f, 8); return i; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)(uintptr_t)p; }

// One host thread runs every thread: plain read-modify-writes are atomic.
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

[[noreturn]] inline void host_kernel_bug(const char* what, unsigned bx, unsigned by,
                                         unsigned bz) {
  fprintf(stderr, "host_launch: block (%u, %u, %u): %s\n", bx, by, bz, what);
  abort();
}

// Runs the current block (blockIdx set) to its end.
inline void host_run_block(dim3 block) {
  HostBlock& b = g_block;
  const int n = (int)(block.x * block.y * block.z);
  for (int i = 0; i < n; ++i) {
    HostThread& t = b.threads[i];
    getcontext(&t.start);
    t.start.uc_stack.ss_sp = t.stack.get();
    t.start.uc_stack.ss_size = HostBlock::STACK_BYTES;
    t.start.uc_link = nullptr;  // host_thread_entry never returns
    makecontext(&t.start, host_thread_entry, 0);
    t.state = HOST_RUN;
    t.started = false;
  }
  for (HostWarpMeet& w : b.warps) w.ballot = w.result = 0;
  for (;;) {
    for (int i = 0; i < n; ++i) {
      if (b.threads[i].state != HOST_RUN) continue;
      HostThread& t = b.threads[i];
      b.current = i;
      threadIdx = dim3(i % block.x, (i / block.x) % block.y, i / (block.x * block.y));
      if (_setjmp(b.scheduler)) continue;  // back from thread i
      if (t.started) _longjmp(t.resume, 1);
      t.started = true;
      setcontext(&t.start);
    }
    // Every thread now waits at a collective or has returned.
    int done = 0, at_block = 0;
    bool released = false;
    for (int w = 0; w < n / 32; ++w) {
      int at_warp = 0;
      for (int l = 0; l < 32; ++l) {
        const int s = b.threads[32 * w + l].state;
        at_warp += s == HOST_AT_WARP;
        at_block += s == HOST_AT_BLOCK;
        done += s == HOST_DONE;
      }
      if (at_warp == 32) {
        HostWarpMeet& m = b.warps[w];
        m.result = m.ballot;
        m.ballot = 0;
        for (int l = 0; l < 32; ++l) b.threads[32 * w + l].state = HOST_RUN;
        released = true;
      } else if (at_warp) {
        host_kernel_bug("lanes wait at a warp collective that others never reach", blockIdx.x,
                        blockIdx.y, blockIdx.z);
      }
    }
    if (done == n) return;
    if (released) continue;
    if (at_block != n) {
      host_kernel_bug("threads wait at __syncthreads while others have returned", blockIdx.x,
                      blockIdx.y, blockIdx.z);
    }
    for (int i = 0; i < n; ++i) b.threads[i].state = HOST_RUN;
  }
}

// kernel<<<grid, block, smem, stream>>>(args) becomes
// host_launch(grid, block, smem, [&] { kernel(args); }): every block in
// turn, its threads together.
inline void host_launch(dim3 grid, dim3 block, size_t smem, const std::function<void()>& body) {
  HostBlock& b = g_block;
  const unsigned n = block.x * block.y * block.z;
  if (n == 0 || n % 32) host_kernel_bug("block size is not a whole number of warps", 0, 0, 0);
  gridDim = grid;
  blockDim = block;
  b.body = &body;
  while (b.threads.size() < n) {
    b.threads.emplace_back();
    b.threads.back().stack.reset(new char[HostBlock::STACK_BYTES]);
  }
  b.warps.resize(n / 32);
  b.dynamic_shared.assign((smem + 7) / 8, 0);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = dim3(bx, by, bz);
        host_run_block(block);
      }
}
