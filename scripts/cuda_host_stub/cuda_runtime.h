// Host stand-in for the CUDA runtime, to rehearse a kernel of csrc/ on the
// CPU with g++ (scripts/rehearse_sweep_host.py).  Each block runs as
// blockDim std::threads, one block after the other; __syncthreads and
// __syncwarp are std::barriers, __shared__ is static, __shfl_sync goes
// through a per-warp slot array, and the dynamic shared memory is a buffer
// filled with NaN.  STUB_SMEM_OPTIN sets the shared memory a block may take
// (default 232448 bytes, an H100's).  It checks a kernel's logic (indices,
// barriers, order), not nvcc's code or its speed; products and sums are
// rounded one at a time (no fused multiply-add), as in numpy.
#pragma once
#include <algorithm>
#include <barrier>
#include <cfloat>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
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
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
struct double2 { double x, y; };
inline double2 make_double2(double a, double b) { return {a, b}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct stub_idx { unsigned x, y, z; };
inline thread_local stub_idx threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* stub_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> stub_wbar;
inline double stub_slots[64][32];
inline double* stub_dyn_smem;
inline size_t stub_max_dyn = 48 * 1024;
inline void __syncthreads() { stub_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { stub_wbar[threadIdx.x / 32]->arrive_and_wait(); }
inline double __shfl_sync(unsigned, double v, int src) {
  const int w = threadIdx.x / 32;
  stub_slots[w][threadIdx.x % 32] = v;
  __syncwarp();
  const double r = stub_slots[w][src];
  __syncwarp();
  return r;
}
// rounding is not the stub's business: no fused multiply-add (as numpy)
inline double __fma_rn(double a, double b, double c) { return a * b + c; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __ldg(const double* p) { return *p; }
inline double2 __ldg(const double2* p) { return *p; }
inline int __ldg(const int* p) { return *p; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "stub error" : "no error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  const char* s = std::getenv("STUB_SMEM_OPTIN");
  *v = s ? std::atoi(s) : 232448;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) {
  stub_max_dyn = (size_t)v;
  return cudaSuccess;
}
inline cudaError_t cudaMemcpy2DAsync(void* dst, size_t dp, const void* src, size_t sp,
                                     size_t w, size_t h, cudaMemcpyKind, cudaStream_t) {
  for (size_t r = 0; r < h; ++r) std::memcpy((char*)dst + r * dp, (const char*)src + r * sp, w);
  return cudaSuccess;
}
template <class K, class... A>
void stub_launch(K kernel, dim3 g, dim3 b, size_t smem, cudaStream_t, A... args) {
  if (smem > 48 * 1024 && smem > stub_max_dyn) std::abort();  // refused launch
  blockDim = b;
  gridDim = g;
  const unsigned nt = b.x * b.y * b.z;
  std::vector<double> dyn(smem / sizeof(double) + 1, std::nan(""));
  stub_dyn_smem = dyn.data();
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx) {
        std::barrier<> bar(nt);
        stub_bar = &bar;
        stub_wbar.clear();
        for (unsigned w = 0; w < (nt + 31) / 32; ++w)
          stub_wbar.emplace_back(new std::barrier<>(std::min(32u, nt - 32 * w)));
        std::vector<std::thread> th;
        for (unsigned t = 0; t < nt; ++t)
          th.emplace_back([=] {
            threadIdx = {t % b.x, (t / b.x) % b.y, t / (b.x * b.y)};
            blockIdx = {bx, by, bz};
            kernel(args...);
          });
        for (auto& x : th) x.join();
      }
}
