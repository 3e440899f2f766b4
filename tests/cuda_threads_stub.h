// A stand-in for <cuda_runtime.h> that runs the port's CUDA kernels on
// the host, for tests/test_torch_warp_rehearsal.py. Every CUDA thread is a
// host thread: a launch runs its blocks one after another, each block's
// threads together; __syncthreads is a barrier of the block, __syncwarp
// one of the warp, and a shuffle writes each lane's value to an exchange
// array of its warp between two warp barriers. The dynamic shared memory
// of a block is one host buffer, filled with NaN so that a read of an
// entry no thread wrote shows in the results. Arithmetic is the host's
// f32: built with -ffp-contract=off, __fmaf_rn is a rounded product and
// a rounded sum, as the per-thread core's a * b + c is there, so the two
// designs agree bit for bit exactly when every output takes the same
// operations in the same order.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <barrier>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct uint3 {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct CUstream_st;
typedef CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

// the streaming multiprocessors the stand-in card reports: few, so that
// a few hundred particles already take the warp kernels' widest blocks
constexpr int kStubSMs = 16;

namespace bipk_stub {

struct Block {
  std::barrier<> block;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint32_t> exchange;  // 32 words per warp
  std::vector<float> smem;
  Block(int threads, size_t smem_bytes)
      : block(threads),
        exchange(32 * ((threads + 31) / 32)),
        smem((smem_bytes + sizeof(float) - 1) / sizeof(float),
             std::numeric_limits<float>::quiet_NaN()) {
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(threads - 32 * w < 32 ? threads - 32 * w
                                                                             : 32));
  }
};

inline thread_local Block* block = nullptr;

}  // namespace bipk_stub

inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

inline float* bipk_dynamic_smem() { return bipk_stub::block->smem.data(); }

inline void __syncthreads() { bipk_stub::block->block.arrive_and_wait(); }

inline void __syncwarp(unsigned = 0xffffffffu) {
  bipk_stub::block->warps[threadIdx.x / 32]->arrive_and_wait();
}

// value of lane src of the caller's segment of `width` lanes
template <class T>
inline T __shfl_sync(unsigned, T value, int src, int width = 32) {
  static_assert(sizeof(T) == sizeof(uint32_t), "32-bit shuffles only");
  uint32_t* lanes = bipk_stub::block->exchange.data() + 32 * (threadIdx.x / 32);
  uint32_t bits;
  std::memcpy(&bits, &value, sizeof bits);
  lanes[threadIdx.x % 32] = bits;
  __syncwarp();
  bits = lanes[(threadIdx.x % 32) / width * width + src % width];
  __syncwarp();
  std::memcpy(&value, &bits, sizeof bits);
  return value;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

template <class A, class B>
inline auto min(A a, B b) {
  return a < b ? a : b;
}

inline float rsqrtf(float x) { return 1.f / sqrtf(x); }
inline float cospif(float x) { return cosf(3.14159265358979f * x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return a * b + c; }

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = kStubSMs;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// bipk_launch(grid, threads, smem, stream, [&] { kernel(args); })
inline void bipk_launch(dim3 grid, dim3 threads, size_t smem_bytes, cudaStream_t,
                        const std::function<void()>& body) {
  const int n = (int)threads.x;
  for (unsigned b = 0; b < grid.x; ++b) {
    bipk_stub::Block blk(n, smem_bytes);
    std::vector<std::thread> pool;
    pool.reserve(n);
    for (int t = 0; t < n; ++t) {
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim = threads;
        gridDim = grid;
        bipk_stub::block = &blk;
        body();
      });
    }
    for (auto& th : pool) th.join();
  }
}
