// Complex scalars of the SpMV kernels (K2 and K7 in lattice_kernels.cu, K6
// there too, K8 in bell_kernels.cu).
//
// PyTorch keeps complex64 and complex128 interleaved, (re, im) per value, 8
// and 16 bytes, aligned to their size: `cplx<float>` and `cplx<double>` have
// that layout, so a kernel reads a complex tensor through its data pointer as
// it stands.  The kernels are templates over the scalar; what differs between
// a real and a complex scalar is only here: the product and the sum, the
// read-only and evict-first loads (one 8- or 16-byte load per value, as
// float2 / double2), the warp shuffle (two, one per part) and the cp.async
// copy size (in lattice_kernels.cu).  For float and double every function
// below is the intrinsic the kernels called before, so their real code is
// unchanged.

#pragma once

#include <cuda_runtime.h>

namespace dmt {

template <typename R>
struct __align__(2 * sizeof(R)) cplx {
  R re, im;
  __host__ __device__ constexpr cplx() : re(0), im(0) {}
  __host__ __device__ constexpr cplx(R r) : re(r), im(0) {}  // T(0) in the kernels
  __host__ __device__ constexpr cplx(R r, R i) : re(r), im(i) {}
};

template <typename R>
__device__ __forceinline__ cplx<R> operator*(const cplx<R> a, const cplx<R> b) {
  return cplx<R>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}

template <typename R>
__device__ __forceinline__ cplx<R> operator+(const cplx<R> a, const cplx<R> b) {
  return cplx<R>(a.re + b.re, a.im + b.im);
}

template <typename R>
__device__ __forceinline__ cplx<R>& operator+=(cplx<R>& a, const cplx<R> b) {
  a.re += b.re;
  a.im += b.im;
  return a;
}

// read-only (non-coherent) load
__device__ __forceinline__ float ld_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ld_ro(const double* p) { return __ldg(p); }
__device__ __forceinline__ cplx<float> ld_ro(const cplx<float>* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return cplx<float>(v.x, v.y);
}
__device__ __forceinline__ cplx<double> ld_ro(const cplx<double>* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return cplx<double>(v.x, v.y);
}

// evict-first (streaming) load
__device__ __forceinline__ float ld_cs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_cs(const double* p) { return __ldcs(p); }
__device__ __forceinline__ cplx<float> ld_cs(const cplx<float>* p) {
  const float2 v = __ldcs(reinterpret_cast<const float2*>(p));
  return cplx<float>(v.x, v.y);
}
__device__ __forceinline__ cplx<double> ld_cs(const cplx<double>* p) {
  const double2 v = __ldcs(reinterpret_cast<const double2*>(p));
  return cplx<double>(v.x, v.y);
}

// butterfly shuffle over the whole warp
__device__ __forceinline__ float shfl_xor(const float v, const int o) { return __shfl_xor_sync(0xffffffffu, v, o); }
__device__ __forceinline__ double shfl_xor(const double v, const int o) { return __shfl_xor_sync(0xffffffffu, v, o); }
template <typename R>
__device__ __forceinline__ cplx<R> shfl_xor(const cplx<R> v, const int o) {
  return cplx<R>(__shfl_xor_sync(0xffffffffu, v.re, o), __shfl_xor_sync(0xffffffffu, v.im, o));
}

}  // namespace dmt
