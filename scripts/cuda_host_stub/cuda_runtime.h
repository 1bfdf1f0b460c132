// Host stand-in for the CUDA runtime, to rehearse a kernel of csrc/ on the
// CPU with g++ (scripts/rehearse_sweep_host.py).  Each block runs as
// blockDim std::threads, one block after the other (stub_launch) or all
// blocks at once (stub_launch_coop, for cudaLaunchCooperativeKernel, with a
// std::barrier over the whole grid for cooperative_groups' grid sync);
// __syncthreads, __syncwarp and bar.sync with a thread count are
// std::barriers (__reduce_max_sync a __syncwarp pair), __shared__ is static
// (shared by concurrent blocks: a cooperative kernel keeps its shared data
// in the dynamic buffer), __shfl_sync goes through a per-warp slot array,
// the dynamic shared memory is a buffer of each block filled with NaN, and
// cp.async copies at once (cuda_pipeline.h).
// STUB_SMEM_OPTIN sets the shared memory a block may take (default 232448
// bytes, an H100's), STUB_SMS the number of SMs (default 2) and
// STUB_BLOCKS_PER_SM the occupancy (default 2).  It checks a kernel's logic
// (indices, barriers, order), not nvcc's code or its speed; products and
// sums are rounded one at a time (no fused multiply-add), as in numpy.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cfloat>
#include <cmath>
#include <map>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorCooperativeLaunchTooLarge = 82 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
struct alignas(16) double2 { double x, y; };  // CUDA's __align__(16)
inline double2 make_double2(double a, double b) { return {a, b}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct stub_idx { unsigned x, y, z; };
inline thread_local stub_idx threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
// One block's barriers, shuffle slots and dynamic shared memory.
struct stub_block {
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  double slots[64][32];
  std::vector<double> dyn;
  std::mutex named_mu;  // bar.sync with an id and a thread count, made on first use
  std::map<int, std::unique_ptr<std::barrier<>>> named;
  stub_block(unsigned nt, size_t smem)
      : bar(nt), dyn(smem / sizeof(double) + 1, std::nan("")) {
    for (unsigned w = 0; w < (nt + 31) / 32; ++w)
      wbar.emplace_back(new std::barrier<>(std::min(32u, nt - 32 * w)));
  }
};
inline thread_local stub_block* stub_blk;
inline thread_local double* stub_dyn_smem;
inline std::barrier<>* stub_grid_bar;
// the opt-in shared memory of each kernel, as the card keeps it per function
inline std::map<const void*, size_t> stub_max_dyn;
template <class F>
size_t stub_dyn_limit(F f) {
  const auto it = stub_max_dyn.find(reinterpret_cast<const void*>(f));
  return it == stub_max_dyn.end() ? 48 * 1024 : it->second;
}
inline void __syncthreads() { stub_blk->bar.arrive_and_wait(); }
// `bar.sync id, count;`: the first `count` threads to arrive at barrier id
inline void stub_bar_sync(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(stub_blk->named_mu);
    auto& slot = stub_blk->named[id];
    if (!slot) slot.reset(new std::barrier<>(count));
    b = slot.get();
  }
  b->arrive_and_wait();
}
inline void __syncwarp(unsigned = 0xffffffffu) { stub_blk->wbar[threadIdx.x / 32]->arrive_and_wait(); }
inline double __shfl_sync(unsigned, double v, int src) {
  const int w = threadIdx.x / 32;
  stub_blk->slots[w][threadIdx.x % 32] = v;
  __syncwarp();
  const double r = stub_blk->slots[w][src];
  __syncwarp();
  return r;
}
inline double __shfl_xor_sync(unsigned m, double v, int o) {
  return __shfl_sync(m, v, (threadIdx.x % 32) ^ o);
}
// rounding is not the stub's business: no fused multiply-add (as numpy)
inline double __fma_rn(double a, double b, double c) { return a * b + c; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline std::mutex stub_atomic_mu;
inline int atomicMax(int* a, int v) {
  std::lock_guard<std::mutex> lock(stub_atomic_mu);
  const int old = *a;
  *a = std::max(old, v);
  return old;
}
inline unsigned atomicAdd(unsigned* a, unsigned v) {
  std::lock_guard<std::mutex> lock(stub_atomic_mu);
  const unsigned old = *a;
  *a = old + v;
  return old;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
// the warp's largest value, every lane receiving it
inline int __reduce_max_sync(unsigned, int v) {
  const int w = threadIdx.x / 32, n = std::min(32u, blockDim.x - 32 * w);
  stub_blk->slots[w][threadIdx.x % 32] = v;
  __syncwarp();
  int m = v;
  for (int k = 0; k < n; ++k) m = std::max(m, (int)stub_blk->slots[w][k]);
  __syncwarp();
  return m;
}
// cp.async (<cuda_pipeline.h>): synchronous stand-ins, each copy done when
// issued (the earliest an asynchronous copy may land), so a slot refilled
// while another thread still reads it shows in the result
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
inline double __ldg(const double* p) { return *p; }
inline double __ldcg(const double* p) { return *p; }
inline int __ldcg(const int* p) { return *p; }
inline double2 __ldg(const double2* p) { return *p; }
inline int __ldg(const int* p) { return *p; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "stub error" : "no error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline int stub_env(const char* name, int dflt) {
  const char* s = std::getenv(name);
  return s ? std::atoi(s) : dflt;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? stub_env("STUB_SMS", 2)
                                           : stub_env("STUB_SMEM_OPTIN", 232448);
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t smem) {
  *n = smem > (size_t)stub_env("STUB_SMEM_OPTIN", 232448) ? 0
                                                          : stub_env("STUB_BLOCKS_PER_SM", 2);
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F f, cudaFuncAttribute, int v) {
  stub_max_dyn[reinterpret_cast<const void*>(f)] = (size_t)v;
  return cudaSuccess;
}
inline cudaError_t cudaMemcpy2DAsync(void* dst, size_t dp, const void* src, size_t sp,
                                     size_t w, size_t h, cudaMemcpyKind, cudaStream_t) {
  for (size_t r = 0; r < h; ++r) std::memcpy((char*)dst + r * dp, (const char*)src + r * sp, w);
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* dst, int v, size_t n, cudaStream_t) {
  std::memset(dst, v, n);
  return cudaSuccess;
}
// The threads of blocks [b0, b1) of grid g, each block with its own state.
template <class F>
void stub_run(dim3 g, dim3 b, size_t smem, unsigned b0, unsigned b1, F body) {
  const unsigned nt = b.x * b.y * b.z;
  std::vector<std::unique_ptr<stub_block>> blocks;
  std::vector<std::thread> th;
  for (unsigned k = b0; k < b1; ++k) {
    blocks.emplace_back(new stub_block(nt, smem));
    stub_block* blk = blocks.back().get();
    const stub_idx bi = {k % g.x, (k / g.x) % g.y, k / (g.x * g.y)};
    for (unsigned t = 0; t < nt; ++t)
      th.emplace_back([=] {
        threadIdx = {t % b.x, (t / b.x) % b.y, t / (b.x * b.y)};
        blockIdx = bi;
        stub_blk = blk;
        stub_dyn_smem = blk->dyn.data();
        body();
      });
  }
  for (auto& x : th) x.join();
}
template <class K, class... A>
void stub_launch(K kernel, dim3 g, dim3 b, size_t smem, cudaStream_t, A... args) {
  if (smem > stub_dyn_limit(kernel)) std::abort();  // refused launch
  blockDim = b;
  gridDim = g;
  for (unsigned k = 0; k < g.x * g.y * g.z; ++k)
    stub_run(g, b, smem, k, k + 1, [=] { kernel(args...); });
}
// cudaLaunchCooperativeKernel: every block at once, args as the runtime
// takes them (one pointer per kernel argument).
template <class... A, size_t... I>
void stub_call(void (*kernel)(A...), void** args, std::index_sequence<I...>) {
  kernel(*static_cast<A*>(args[I])...);
}
template <class... A>
cudaError_t stub_launch_coop(void (*kernel)(A...), dim3 g, dim3 b, void** args, size_t smem,
                             cudaStream_t) {
  if (smem > stub_dyn_limit(kernel)) return cudaErrorInvalidValue;
  const unsigned nb = g.x * g.y * g.z;
  if ((int)nb > stub_env("STUB_SMS", 2) * stub_env("STUB_BLOCKS_PER_SM", 2))
    return cudaErrorCooperativeLaunchTooLarge;
  blockDim = b;
  gridDim = g;
  std::barrier<> grid_bar(nb * b.x * b.y * b.z);
  stub_grid_bar = &grid_bar;
  stub_run(g, b, smem, 0, nb,
           [=] { stub_call(kernel, args, std::index_sequence_for<A...>{}); });
  return cudaSuccess;
}
