// Hopper (sm_90a) kernel of the unstructured path: the SpMV of the blocked-ELL
// (BELL) operator, K8, on that operator's nonzeros.
//
// Built by dolfinx_mpc_tpu_torch/_build.py together with lattice_kernels.cu
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC) into one shared library with a plain C interface, loaded
// with ctypes.  The extern "C" launcher enqueues one kernel on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper
// (la/bell.py:bell_matvec), which raises on any non-zero code.  Templated on
// float (the CG operator of the contact path), double (the f64 oracle on
// the card) and complex64 / complex128 (dmt::cplx of complex.cuh, torch's
// interleaved values read as they stand: a value is 8 or 16 B beside its
// 4 B column).
//
// K8 replaces dolfinx_mpc_tpu/la/bell.py:_bell_matvec_pallas (:147-189,
// `kernel` :164) together with the JAX segment_sum of the COO remainder
// (:113-116): y = A x for the operator a BellMatrix holds,
//   y[b*8 + r] = sum_t data[b, t, r, :] . x[cols[b, t]*128 : +128] + remainder,
// for the first n_rows rows.  The TPU kernel streams every dense 8 x 128
// tile, because the VPU and MXU want whole tiles; on the contact operator
// 1.9 % of the tile slots are nonzeros, so a tile stream reads 689 MB (f32)
// for 26 MB of matrix.  The H100 has no such constraint, so the kernel reads
// a packed layout of the nonzeros alone (la/bell.py:bell_pack, built once per
// operator): a CSR whose rows hold the tile nonzeros in (t, lane) order,
// each with its absolute int32 column, followed by the row's remainder
// entries.  The remainder therefore rides in the same launch.
//
// What bounds it: device memory, each nonzero read once (value + int32
// column: 8 B in f32, 12 B in f64), the row pointers, x and y: 26.4 MB in
// f32 at the 74,658-dof contact operator, 0.0079 ms at 3.35 TB/s.  The
// design: a sub-warp of G threads (a power of two, from the mean row length;
// the wrapper picks it) per row, lane l taking entries l, l + G, ... of the
// row, so each step of a sub-warp reads G consecutive values and columns;
// x (0.3 MB) stays in L2 and is read through the read-only path; the G
// partial sums reduce by __shfl_xor_sync inside the sub-warp.  74,658 rows
// x 8 lanes is 18,700 warps, enough to fill the card.  Long rows (the MPC
// slave rows of the remainder) just loop longer.  Rows with no entry get 0.
// The sum order is per lane, then a tree over the lanes; the plain version
// (bell_packed_matvec_plain) adds in row order.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include "complex.cuh"

namespace {

using dmt::cplx;
using dmt::ld_ro;
using dmt::shfl_xor;

constexpr int kThreads = 256;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
bell_csr_matvec_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                       const T* __restrict__ val, const T* __restrict__ x, T* __restrict__ y,
                       int n_rows) {
  // n_rows * G < 2^31 (checked by the wrapper), so 32-bit indices suffice
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int row = t / G;
  const int lane = t & (G - 1);
  int p = 0, e = 0;
  if (row < n_rows) {
    p = __ldg(row_ptr + row) + lane;
    e = __ldg(row_ptr + row + 1);
  }
  T acc = T(0);
#pragma unroll 4
  for (; p < e; p += G) acc += ld_ro(val + p) * ld_ro(x + __ldg(col + p));
  // every thread of the warp reaches the shuffles (rows past the end carry
  // 0), and xor partners within G stay inside the sub-warp
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += shfl_xor(acc, o);
  if (row < n_rows && lane == 0) y[row] = acc;
}

template <typename T>
int launch_bell_csr_matvec(const int* row_ptr, const int* col, const T* val, const T* x, T* y,
                           int n_rows, int g, void* stream) {
  if (n_rows <= 0) return 0;
  const unsigned int blocks =
      static_cast<unsigned int>((static_cast<long long>(n_rows) * g + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 2:
      bell_csr_matvec_kernel<T, 2><<<blocks, kThreads, 0, st>>>(row_ptr, col, val, x, y, n_rows);
      break;
    case 4:
      bell_csr_matvec_kernel<T, 4><<<blocks, kThreads, 0, st>>>(row_ptr, col, val, x, y, n_rows);
      break;
    case 8:
      bell_csr_matvec_kernel<T, 8><<<blocks, kThreads, 0, st>>>(row_ptr, col, val, x, y, n_rows);
      break;
    case 16:
      bell_csr_matvec_kernel<T, 16><<<blocks, kThreads, 0, st>>>(row_ptr, col, val, x, y, n_rows);
      break;
    case 32:
      bell_csr_matvec_kernel<T, 32><<<blocks, kThreads, 0, st>>>(row_ptr, col, val, x, y, n_rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dmt_bell_csr_matvec_f32(const int* row_ptr, const int* col, const float* val, const float* x,
                            float* y, int n_rows, int g, void* stream) {
  return launch_bell_csr_matvec<float>(row_ptr, col, val, x, y, n_rows, g, stream);
}

int dmt_bell_csr_matvec_f64(const int* row_ptr, const int* col, const double* val, const double* x,
                            double* y, int n_rows, int g, void* stream) {
  return launch_bell_csr_matvec<double>(row_ptr, col, val, x, y, n_rows, g, stream);
}

// complex64 / complex128: val, x and y are torch's interleaved (re, im) tensors
int dmt_bell_csr_matvec_c64(const int* row_ptr, const int* col, const void* val, const void* x, void* y,
                            int n_rows, int g, void* stream) {
  using C = cplx<float>;
  return launch_bell_csr_matvec<C>(row_ptr, col, static_cast<const C*>(val), static_cast<const C*>(x),
                                   static_cast<C*>(y), n_rows, g, stream);
}

int dmt_bell_csr_matvec_c128(const int* row_ptr, const int* col, const void* val, const void* x, void* y,
                             int n_rows, int g, void* stream) {
  using C = cplx<double>;
  return launch_bell_csr_matvec<C>(row_ptr, col, static_cast<const C*>(val), static_cast<const C*>(x),
                                   static_cast<C*>(y), n_rows, g, stream);
}

}  // extern "C"
