// A stand-in for <cuda_runtime.h> that runs the port's CUDA kernels on
// the host, for tests/test_torch_warp_rehearsal.py,
// tests/test_torch_systematic_rehearsal.py,
// tests/test_torch_dedup_project_rehearsal.py and
// tests/test_torch_unpacked_rehearsal.py. Every CUDA thread is a host
// thread (from a pool kept between launches, each woken alone): a launch
// runs its blocks one after another, each block's threads together;
// __syncthreads is a barrier of the block, __syncwarp
// one of the warp, and a shuffle or a ballot writes each lane's value to
// an exchange array of its warp between two warp barriers. The dynamic shared memory
// of a block is one host buffer, filled with NaN so that a read of an
// entry no thread wrote shows in the results. Arithmetic is the host's
// f32: built with -ffp-contract=off, __fmaf_rn is a rounded product and
// a rounded sum, as the per-thread core's a * b + c is there, so the two
// designs agree bit for bit exactly when every output takes the same
// operations in the same order.
//
// The stand-in has two cards with different SM counts. The current card
// is one setting of the process (bipk_stub_set_device), and every
// cudaFuncSetAttribute call is recorded with the card it acted on, so a
// test can see the kernels' launch state kept per card. Those controls
// are compiled into the one translation unit that defines
// BIPK_STUB_CONTROLS before it includes this header.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <barrier>
#include <condition_variable>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <mutex>
#include <semaphore>
#include <set>
#include <thread>
#include <utility>
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
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct CUstream_st;
typedef CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

// the streaming multiprocessors each stand-in card reports: card 0 few,
// so that a few hundred particles already take the warp kernels' widest
// blocks; card 1 as many as an H100 has, so that they take one-warp blocks
constexpr int kStubDevices = 2;
constexpr int kStubSMs[kStubDevices] = {16, 132};

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

inline int device = 0;  // the current card
// every cudaFuncSetAttribute call: (card, kernel)
inline std::mutex attribute_mutex;
inline std::vector<std::pair<int, const void*>> attribute_calls;

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

// value of lane (lane - delta) of the caller's warp; a lane below delta
// keeps its own
template <class T>
inline T __shfl_up_sync(unsigned mask, T value, unsigned delta) {
  const int lane = (int)(threadIdx.x % 32);
  return __shfl_sync(mask, value, lane >= (int)delta ? lane - (int)delta : lane);
}

// bit l set where lane l of the caller's warp passed a true predicate
inline unsigned __ballot_sync(unsigned, int predicate) {
  uint32_t* lanes = bipk_stub::block->exchange.data() + 32 * (threadIdx.x / 32);
  lanes[threadIdx.x % 32] = predicate != 0;
  __syncwarp();
  const int width = (int)blockDim.x - 32 * (int)(threadIdx.x / 32);  // the warp's lanes
  unsigned bits = 0;
  for (int l = 0; l < 32 && l < width; ++l) bits |= lanes[l] ? 1u << l : 0u;
  __syncwarp();
  return bits;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

// value of lane (lane ^ lane_mask) of the caller's warp
template <class T>
inline T __shfl_xor_sync(unsigned mask, T value, int lane_mask) {
  return __shfl_sync(mask, value, (int)(threadIdx.x % 32) ^ lane_mask);
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

template <class A, class B>
inline auto min(A a, B b) {
  return a < b ? a : b;
}
template <class A, class B>
inline auto max(A a, B b) {
  return a < b ? b : a;
}

inline float rsqrtf(float x) { return 1.f / sqrtf(x); }
inline float cospif(float x) { return cosf(3.14159265358979f * x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return a * b + c; }
// the card's float-to-int conversion rounding up: NaN gives 0, values
// past the int range its ends
inline int __float2int_ru(float x) {
  if (x != x) return 0;
  const float c = ceilf(x);
  if (c >= 2147483648.f) return std::numeric_limits<int>::max();
  if (c < -2147483648.f) return std::numeric_limits<int>::min();
  return (int)c;
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = bipk_stub::device;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int dev) {
  if (dev < 0 || dev >= kStubDevices) return cudaErrorInvalidDevice;
  *value = kStubSMs[dev];
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F kernel, cudaFuncAttribute, int) {
  std::lock_guard<std::mutex> hold(bipk_stub::attribute_mutex);
  bipk_stub::attribute_calls.emplace_back(bipk_stub::device,
                                          reinterpret_cast<const void*>(kernel));
  return cudaSuccess;
}

#ifdef BIPK_STUB_CONTROLS
// make card `dev` the current one
extern "C" void bipk_stub_set_device(int dev) { bipk_stub::device = dev; }

// the cudaFuncSetAttribute calls made on card `dev`, and how many distinct
// kernels they named
extern "C" int bipk_stub_attribute_calls(int dev, int* kernels) {
  std::lock_guard<std::mutex> hold(bipk_stub::attribute_mutex);
  int calls = 0;
  std::set<const void*> named;
  for (const auto& [d, kernel] : bipk_stub::attribute_calls) {
    if (d != dev) continue;
    ++calls;
    named.insert(kernel);
  }
  *kernels = (int)named.size();
  return calls;
}
#endif

namespace bipk_stub {

// The host threads that run a block's CUDA threads, kept from one launch
// to the next (creating 1024 of them took most of a launch's time):
// worker i runs CUDA thread i of each block, and run() returns when every
// one of the n has finished. Each worker waits on a semaphore of its own,
// so a block of n threads wakes n workers and no more: a pool grown to
// 256 by an earlier launch, woken whole for every one-warp block, made
// launches of 100 one-warp blocks take most of a child's 120 s on a
// loaded host.
class Pool {
 public:
  void run(int n, const std::function<void(int)>& job) {
    while ((int)workers_.size() < n) {
      workers_.push_back(std::make_unique<std::binary_semaphore>(0));
      std::thread([this, id = (int)workers_.size() - 1, go = workers_.back().get()] {
        for (;;) {
          go->acquire();
          (*job_)(id);
          if (pending_.fetch_sub(1, std::memory_order_acq_rel) == 1) done_.release();
        }
      }).detach();
    }
    job_ = &job;
    pending_.store(n, std::memory_order_relaxed);
    for (int i = 0; i < n; ++i) workers_[i]->release();
    done_.acquire();
  }

 private:
  std::vector<std::unique_ptr<std::binary_semaphore>> workers_;
  const std::function<void(int)>* job_ = nullptr;
  std::atomic<int> pending_{0};
  std::binary_semaphore done_{0};
};

// never destroyed: its detached workers wait on it until the process ends
inline Pool& pool() {
  static Pool* const p = new Pool;
  return *p;
}

}  // namespace bipk_stub

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// bipk_launch(grid, threads, smem, stream, [&] { kernel(args); })
inline void bipk_launch(dim3 grid, dim3 threads, size_t smem_bytes, cudaStream_t,
                        const std::function<void()>& body) {
  const int n = (int)threads.x;
  for (unsigned b = 0; b < grid.x; ++b) {
    bipk_stub::Block blk(n, smem_bytes);
    bipk_stub::pool().run(n, [&](int t) {
      threadIdx.x = t;
      blockIdx.x = b;
      blockDim = threads;
      gridDim = grid;
      bipk_stub::block = &blk;
      body();
    });
  }
}
