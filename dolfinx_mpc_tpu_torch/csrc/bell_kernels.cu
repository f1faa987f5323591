// Hopper (sm_90a) kernel of the unstructured path: the blocked-ELL (BELL)
// SpMV, K8.
//
// Built by dolfinx_mpc_tpu_torch/_build.py together with lattice_kernels.cu
// (nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC) into one shared library with a plain C interface, loaded
// with ctypes.  The extern "C" launcher enqueues one kernel on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so that a refused launch reaches the Python wrapper
// (la/bell.py:bell_matvec), which raises on any non-zero code.  Templated on
// float (the CG operator of the contact path) and double (the f64 oracle on
// the card).
//
// K8 replaces dolfinx_mpc_tpu/la/bell.py:_bell_matvec_pallas (:147-189,
// `kernel` :164): y[b*R + r] = sum_t data[b, t, r, :] . x[cols[b, t]*C : +C]
// with R = 8 rows per block and C = 128 columns per tile.  The TPU kernel
// keeps the whole x tile grid in VMEM and streams the data tiles through
// the grid pipeline.  Here x (300 KB at 74,658 dofs) does not fit shared
// memory and stays resident in the 50 MB L2 instead, read through the
// read-only path; the bounds check against n_cols replaces the JAX zero
// pad of x.
//
// What bounds it: the data tiles, read once, nblk*mt*R*C values (688.9 MB
// in f32 at the 74k-dof contact operator, 1.9 % of which are nonzeros),
// plus cols, x and y (0.7 MB): a pure HBM stream, 0.21 ms at 3.35 TB/s.
// The design keeps that stream coalesced and in flight: one block of C =
// 128 threads per row block b, thread c owns lane c of every tile, so each
// warp reads 32 consecutive values of a tile row per load (128 B in f32,
// 512 B per row across the block) and issues R = 8 independent loads per
// tile; the loads are marked evict-first (__ldcs) so the single-use tiles do
// not push x out of L2.  The R row sums stay in registers across the mt
// tiles and are reduced over the 128 lanes at the end (warp shuffles, then
// shared memory across the 4 warps): the sum order is t, then a tree over
// c, not the plain version's, which holds f32 to a few ulps.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;
constexpr int kC = 128;
constexpr int kWarps = kC / 32;

template <typename T>
__global__ void __launch_bounds__(kC)
bell_matvec_kernel(const T* __restrict__ data, const int* __restrict__ cols, const T* __restrict__ x,
                   T* __restrict__ y, int mt, long long n_rows, long long n_cols) {
  const long long b = blockIdx.x;
  const int c = threadIdx.x;
  T acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = T(0);
  const int* cb = cols + b * mt;
  const T* db = data + b * mt * (kR * kC) + c;
  for (int t = 0; t < mt; ++t) {
    const long long col = static_cast<long long>(__ldg(cb + t)) * kC + c;
    const T xv = col < n_cols ? __ldg(x + col) : T(0);
    const T* dt = db + static_cast<long long>(t) * (kR * kC);
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] += __ldcs(dt + r * kC) * xv;
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  }
  __shared__ T part[kWarps][kR];
  const int warp = c >> 5;
  if ((c & 31) == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) part[warp][r] = acc[r];
  }
  __syncthreads();
  if (c < kR) {
    T s = part[0][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][c];
    const long long row = b * kR + c;
    if (row < n_rows) y[row] = s;
  }
}

template <typename T>
int launch_bell_matvec(const T* data, const int* cols, const T* x, T* y, int nblk, int mt,
                       long long n_rows, long long n_cols, void* stream) {
  if (nblk == 0 || n_rows == 0) return 0;
  bell_matvec_kernel<T><<<nblk, kC, 0, static_cast<cudaStream_t>(stream)>>>(data, cols, x, y, mt, n_rows,
                                                                             n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dmt_bell_matvec_f32(const float* data, const int* cols, const float* x, float* y, int nblk, int mt,
                        long long n_rows, long long n_cols, void* stream) {
  return launch_bell_matvec<float>(data, cols, x, y, nblk, mt, n_rows, n_cols, stream);
}

int dmt_bell_matvec_f64(const double* data, const int* cols, const double* x, double* y, int nblk, int mt,
                        long long n_rows, long long n_cols, void* stream) {
  return launch_bell_matvec<double>(data, cols, x, y, nblk, mt, n_rows, n_cols, stream);
}

}  // extern "C"
