// Hopper (sm_90a) kernels of the lattice fast path: the fused lean-fold
// assemblers (K1, its blocked use K4, and the masked K3), the unmasked
// assembler (K5), the scalar DIA SpMV (K2), the vector (bs > 1) DIA SpMV
// (K7) and the parity-blocked SpMV (K6).
//
// Built by dolfinx_mpc_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Each
// extern "C" launcher enqueues one kernel on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so that a
// refused launch reaches the Python wrapper (ops/lattice_kernels.py), which
// raises on any non-zero code.  All kernels are templated on float (the
// main path) and double (the f64 oracles on the card).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int n_blocks(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// K1 / K4 / K3: fused lean-fold assemblers.
//
// The host reduction (ops/lattice_kernels.py:build_fold_table) has already
// collapsed every element tensor entry of the uniform lattice into a short
// table per output plane mi:
//   planes[8*mi .. 8*mi+7] = (ri, ci, di, dj, dk, is_diag, e_begin, e_end)
//   ent[3*e .. 3*e+2]      = (dax, day, daz)   for e in [e_begin, e_end)
//   coef[3*e .. 3*e+2]     = (c0, c1, c2)      value c0 s^3 + c1 s^2 + c2 s
// Entry e covers the box window p in [dax, dax+nx), j in [day, day+ny),
// k in [daz, daz+nz).  The result is masked by the keep mask of the row
// (stack row ri at p, j, k) and of the column (stack row ci at p+di, j+dj,
// k+dk), and the diagonal planes get diagval on the bc rows.  On the grid
// layout (degree 1) a plane is a DIA offset and the stack rows are dof
// components; on the parity-blocked layout (degree 2) a plane is a triple
// (row class, column class, coarse offset) over the padded class grids and
// the stack rows are the 8 parity classes — the same arithmetic, which is
// why the JAX package runs K1's Pallas code over a _BlockedView for K4.
//
// One thread per output element (mi, p, j, k), k fastest, so the single
// store per thread is coalesced.  The kernels are bound by that write
// (16.5 MB per P1 assembly at n=64 in f32, 253 MB for the 230 P2 triples
// at n=64); the table (a few KB) stays in L1/L2, and the per-entry window
// test is a handful of integer compares, so there is no tiling to do.  The
// TPU kernels' VMEM offset splitting, transposed j-factor layout and SMEM
// x-factor tables answered TPU memory limits and have no counterpart here.
// ---------------------------------------------------------------------------
struct PlanePoint {
  int mi, p, j, k;
};

__device__ __forceinline__ PlanePoint split_index(long long idx, int n0, int n1, int n2) {
  PlanePoint q;
  q.k = static_cast<int>(idx % n2);
  long long r = idx / n2;
  q.j = static_cast<int>(r % n1);
  r /= n1;
  q.p = static_cast<int>(r % n0);
  q.mi = static_cast<int>(r / n0);
  return q;
}

// Unmasked value of the output element: the sum of the table entries whose
// window holds (p, j, k).
template <typename T>
__device__ __forceinline__ T window_sum(const PlanePoint& q, int e0, int e1, int nx, int ny, int nz,
                                        const int* __restrict__ ent, const T* __restrict__ coef,
                                        T s) {
  const T s2 = s * s, s3 = s2 * s;
  T acc = T(0);
  for (int e = e0; e < e1; ++e) {
    const int dax = __ldg(ent + 3 * e), day = __ldg(ent + 3 * e + 1), daz = __ldg(ent + 3 * e + 2);
    if (q.p >= dax && q.p < dax + nx && q.j >= day && q.j < day + ny && q.k >= daz &&
        q.k < daz + nz) {
      acc += __ldg(coef + 3 * e) * s3 + __ldg(coef + 3 * e + 1) * s2 + __ldg(coef + 3 * e + 2) * s;
    }
  }
  return acc;
}

// K1 (and K4): separable masks.  Replaces dolfinx_mpc_tpu/ops/
// pallas_lattice.py:_make_lean_fold_pallas_group (kernel_factored) and,
// launched on the blocked table, make_lean_blocked_pallas.  The masks are
// halo-padded per-axis factors of each stack row; the diagonal term is
// diagval * (pad - keep), with pad the real-slot indicator.  On the blocked
// layout pad is 0 on the padded slots, where keep is 0 too, so every padded
// slot comes out an exact 0 (the blocked SpMV and the fold rely on that).
template <typename T>
__global__ void fold_assemble_kernel(T* __restrict__ out, int n_pl, int n0, int n1, int n2,
                                     int nx, int ny, int nz,
                                     const int* __restrict__ planes,
                                     const int* __restrict__ ent,
                                     const T* __restrict__ coef,
                                     const T* __restrict__ fac, int n_stack, T s, T dv) {
  const long long total = static_cast<long long>(n_pl) * n0 * n1 * n2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const PlanePoint q = split_index(idx, n0, n1, n2);
  const int p = q.p, j = q.j, k = q.k;
  const int* pl = planes + 8 * q.mi;
  const int ri = __ldg(pl + 0), ci = __ldg(pl + 1);
  const int di = __ldg(pl + 2), dj = __ldg(pl + 3), dk = __ldg(pl + 4);
  const int is_diag = __ldg(pl + 5);
  const int e0 = __ldg(pl + 6), e1 = __ldg(pl + 7);
  if (e0 == e1) {  // a plane no move reaches stays zero (as in the TPU kernel)
    out[idx] = T(0);
    return;
  }
  const T acc = window_sum(q, e0, e1, nx, ny, nz, ent, coef, s);
  // halo-padded factor rows: [ki | pi] (n_stack, n0+2), [kj | pj] (n_stack,
  // n1+2), [kk | pk] (n_stack, n2+2); index +1 skips the halo
  const int L0 = n0 + 2, L1 = n1 + 2, L2 = n2 + 2;
  const T* ki = fac;
  const T* pi = ki + n_stack * L0;
  const T* kj = pi + n_stack * L0;
  const T* pj = kj + n_stack * L1;
  const T* kk = pj + n_stack * L1;
  const T* pk = kk + n_stack * L2;
  const T row = __ldg(ki + ri * L0 + p + 1) * __ldg(kj + ri * L1 + j + 1) * __ldg(kk + ri * L2 + k + 1);
  const T col = __ldg(ki + ci * L0 + p + 1 + di) * __ldg(kj + ci * L1 + j + 1 + dj) *
                __ldg(kk + ci * L2 + k + 1 + dk);
  T res = acc * row * col;
  if (is_diag) {
    const T pad = __ldg(pi + ri * L0 + p + 1) * __ldg(pj + ri * L1 + j + 1) * __ldg(pk + ri * L2 + k + 1);
    res += dv * (pad - row);
  }
  out[idx] = res;
}

// K3: masks read from memory.  Replaces dolfinx_mpc_tpu/ops/
// pallas_lattice.py:kernel_masked (fuse mode "2d"), on either layout.  keep
// is the halo-padded keep stack (n_stack, n0+2, n1+2, n2+2), so the shifted
// column read (|d| <= 1) never leaves it; ind is the bc multiplicity stack
// (n_stack, n0, n1, n2), added times diagval on the diagonal planes.  Two
// or three extra reads per output value, served mostly by L1/L2 (the keep
// stack is 4 % of the output's size on the blocked layout); no VMEM budget
// means no size limit, unlike the TPU kernel.
template <typename T>
__global__ void fold_assemble_masked_kernel(T* __restrict__ out, int n_pl, int n0, int n1, int n2,
                                            int nx, int ny, int nz,
                                            const int* __restrict__ planes,
                                            const int* __restrict__ ent,
                                            const T* __restrict__ coef,
                                            const T* __restrict__ keep,
                                            const T* __restrict__ ind, T s, T dv) {
  const long long total = static_cast<long long>(n_pl) * n0 * n1 * n2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const PlanePoint q = split_index(idx, n0, n1, n2);
  const int* pl = planes + 8 * q.mi;
  const int ri = __ldg(pl + 0), ci = __ldg(pl + 1);
  const int di = __ldg(pl + 2), dj = __ldg(pl + 3), dk = __ldg(pl + 4);
  const int is_diag = __ldg(pl + 5);
  const int e0 = __ldg(pl + 6), e1 = __ldg(pl + 7);
  if (e0 == e1) {
    out[idx] = T(0);
    return;
  }
  const T acc = window_sum(q, e0, e1, nx, ny, nz, ent, coef, s);
  const long long L0 = n0 + 2, L1 = n1 + 2, L2 = n2 + 2;
  const T row = __ldg(keep + ((ri * L0 + q.p + 1) * L1 + q.j + 1) * L2 + q.k + 1);
  const T col = __ldg(keep + ((ci * L0 + q.p + 1 + di) * L1 + q.j + 1 + dj) * L2 + q.k + 1 + dk);
  T res = acc * row * col;
  if (is_diag) {
    res += dv * __ldg(ind + ((static_cast<long long>(ri) * n0 + q.p) * n1 + q.j) * n2 + q.k);
  }
  out[idx] = res;
}

// Unmasked value on the r-refined grid (r = R > 1): entry e's box q lands
// on the refined point (dax + R qx, day + R qy, daz + R qz), q inside the
// box grid — the stride-R form of the TPU kernel's pltpu.repeat upsampling
// times its even-parity mask and the x-plane weight (p - dax) % R == 0.
template <typename T, int R>
__device__ __forceinline__ T window_sum_strided(const PlanePoint& q, int e0, int e1, int nx, int ny,
                                                int nz, const int* __restrict__ ent,
                                                const T* __restrict__ coef, T s) {
  const T s2 = s * s, s3 = s2 * s;
  T acc = T(0);
  for (int e = e0; e < e1; ++e) {
    const int u = q.p - __ldg(ent + 3 * e), v = q.j - __ldg(ent + 3 * e + 1),
              w = q.k - __ldg(ent + 3 * e + 2);
    if (u >= 0 && u < R * nx && u % R == 0 && v >= 0 && v < R * ny && v % R == 0 && w >= 0 &&
        w < R * nz && w % R == 0) {
      acc += __ldg(coef + 3 * e) * s3 + __ldg(coef + 3 * e + 1) * s2 + __ldg(coef + 3 * e + 2) * s;
    }
  }
  return acc;
}

// K5: the unmasked planes, no mask factors and no diagval term.  Replaces
// dolfinx_mpc_tpu/ops/pallas_lattice.py:_make_lean_fold_pallas_group ->
// kernel (fuse_mode None), which the JAX package runs for a form without
// Dirichlet dofs, where every mask is the identity: on the vertex grid (any
// bs) and on the blocked class grids (degree 2) at R = 1, and on the
// refined degree-2 grid at R = 2.  K1's thread layout and the same bound,
// the single coalesced write; at R = 1 the value is window_sum itself, so
// the result equals K1's with unit factors bit for bit.  At R = 2 a point
// meets only the entries whose corner shares its parity, and the window
// ends at the last box (R (n - 1) + d <= n1 - 1: the TPU kernel's clip at
// n1 - day never cuts a written value).
template <typename T, int R>
__global__ void fold_assemble_raw_kernel(T* __restrict__ out, int n_pl, int n0, int n1, int n2,
                                         int nx, int ny, int nz, const int* __restrict__ planes,
                                         const int* __restrict__ ent, const T* __restrict__ coef,
                                         T s) {
  const long long total = static_cast<long long>(n_pl) * n0 * n1 * n2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const PlanePoint q = split_index(idx, n0, n1, n2);
  const int* pl = planes + 8 * q.mi;
  const int e0 = __ldg(pl + 6), e1 = __ldg(pl + 7);
  if constexpr (R == 1) {
    out[idx] = window_sum(q, e0, e1, nx, ny, nz, ent, coef, s);
  } else {
    out[idx] = window_sum_strided<T, R>(q, e0, e1, nx, ny, nz, ent, coef, s);
  }
}

// ---------------------------------------------------------------------------
// Offsets passed by value in the kernel parameters (no device table, no
// host-to-device copy per launch): K7's (di, dj, dk) triples.
// ---------------------------------------------------------------------------
constexpr int kMaxOffsets = 128;

struct Offsets {
  int n;
  int d[3 * kMaxOffsets];
};

// ---------------------------------------------------------------------------
// K2: scalar DIA SpMV, y[p] = sum_d data[d, p] * x[p + off_d], zero outside
// the grid, data (n_off, n0, n1, n2), x and y (n0, n1, n2), k fastest.
//
// Replaces dolfinx_mpc_tpu/ops/pallas_lattice.py:_make_dia_matvec_group
// (`kernel` :766, pallas_call :791), which runs one program per x-plane
// with the 2W+1 neighbouring x planes in VMEM and roll + iota edge masks.
//
// What bounds it: device memory, (n_off + 2) values per point (18.7 MB per
// fine-level SpMV of the P1 path at n=64 in f32, 0.0056 ms at 3.35 TB/s).
// The design is 2.5-D blocking.  A block owns a range of kDiaPoints
// consecutive points of the flattened (j, k) plane, q = j*n2 + k, and
// marches along i over `li` planes.  Every x neighbour of its points lies in
// the flat range [q0 - H, q0 + kDiaPoints + H) of planes i-W .. i+W, with
// H = W*n2 + W, so shared memory holds a ring of 2W+2 such plane segments:
// 2W+1 in use and one being filled by cp.async with the next plane while
// the current one is summed.  Cells outside the grid are zero-filled by the
// copy itself (src-size 0): planes i < 0 or >= n0 and flat indices outside
// [0, n1*n2) — the JAX package's zero pad.  That covers the i and j edges;
// a flat shift dj*n2 + dk that crosses a k edge lands on the next row, so
// each point keeps a (2W+1)-bit mask of the dk in range, computed once.
// The flat range, not a rectangle, is the tile because every grid of the
// paths has odd n2 (2^m + 1): a rectangular k tile would leave a ragged
// one-column tile per row, and the same oddness puts every row at a 4-byte
// but never a 16-byte boundary, so the data planes are read with coalesced
// scalar loads (a warp reads 32 consecutive values of a plane), each value
// once.  Offsets stay kernel parameters, with their flat shifts computed on
// the host; index arithmetic inside the plane is 32-bit.  The sum per point
// runs over the offsets in order, as the plain version's does.
// ---------------------------------------------------------------------------
constexpr int kDiaPoints = 256;  // plane points per block, one per thread

struct DiaParams {
  int n;   // offsets
  int w;   // halo width W: 1 or 2, >= max |d|
  int n0, n1, n2;
  int li;  // x planes per block
  int di[kMaxOffsets];
  int sh[kMaxOffsets];  // flat shift dj*n2 + dk inside the plane
  int dk[kMaxOffsets];
};

template <typename T>
__device__ __forceinline__ void cp_async_or_zero(T* dst, const T* src, bool in) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int n = in ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T, int W>
__global__ void __launch_bounds__(kDiaPoints)
dia_matvec_kernel(const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                  const DiaParams p) {
  constexpr int NP = 2 * W + 2;  // ring slots
  extern __shared__ __align__(16) unsigned char dia_smem[];
  T* ring = reinterpret_cast<T*>(dia_smem);
  const int P = p.n1 * p.n2;
  const int H = W * p.n2 + W;
  const int seg = kDiaPoints + 2 * H;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kDiaPoints;
  const int q = q0 + tid;
  const bool live = q < P;
  const int k = live ? q % p.n2 : 0;
  unsigned int kmask = 0;  // bit dk + W: k + dk lies in [0, n2)
#pragma unroll
  for (int dk = -W; dk <= W; ++dk) kmask |= (k + dk >= 0 && k + dk < p.n2) ? (1u << (dk + W)) : 0u;
  const long long N = static_cast<long long>(p.n0) * P;
  const int i0 = blockIdx.y * p.li;
  const int i1 = min(i0 + p.li, p.n0);

  // plane ip's segment [q0 - H, q0 + kDiaPoints + H) into ring slot `slot`
  auto load_plane = [&](int ip, int slot) {
    T* dst = ring + slot * seg;
    const bool plane_in = ip >= 0 && ip < p.n0;
    const T* src = x + static_cast<long long>(plane_in ? ip : 0) * P;
    for (int e = tid; e < seg; e += kDiaPoints) {
      const int g = q0 - H + e;
      const bool in = plane_in && g >= 0 && g < P;
      cp_async_or_zero(dst + e, in ? src + g : x, in);
    }
  };
  // planes i0 - W + m go to slot m mod NP
  for (int m = 0; m <= 2 * W; ++m) load_plane(i0 - W + m, m);
  cp_async_commit();
  for (int i = i0; i < i1; ++i) {
    const int s = i - i0;
    // the slot of plane i - W - 1, free since the barrier that ended the
    // last step, takes plane i + W + 1
    if (i + 1 < i1) load_plane(i + W + 1, (s + 2 * W + 1) % NP);
    cp_async_commit();
    cp_async_wait_all_but_one();  // planes i - W .. i + W have landed
    __syncthreads();
    if (live) {
      const int rot = s % NP;
      const T* xc = ring + tid + H;
      const T* dd = data + static_cast<long long>(i) * P + q;
      T acc = T(0);
#pragma unroll 4
      for (int d = 0; d < p.n; ++d) {
        // loads unconditional (both stay in bounds), the add masked, so
        // that the unrolled loads can be in flight together
        const T a = __ldg(dd + d * N);
        int slot = rot + W + p.di[d];
        slot -= slot >= NP ? NP : 0;
        const T xv = xc[slot * seg + p.sh[d]];
        if ((kmask >> (p.dk[d] + W)) & 1u) acc += a * xv;
      }
      y[static_cast<long long>(i) * P + q] = acc;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K7: vector DIA SpMV with BS dof components per lattice point,
//   y[(v, ci)] = sum_{d, cj} data[d, ci, cj, v] * x[(v + off_d, cj)],
// data (n_off, BS, BS, n0, n1, n2), x and y interleaved (point-major, BS
// components each), zero outside the grid.
//
// Replaces dolfinx_mpc_tpu/ops/pallas_lattice.py:make_dia_matvec_bs_pallas
// (kernel).  The TPU version splits x into component-major planes with a
// moveaxis + halo pad and splits the (offset, ci, cj) rows across calls to
// fit VMEM; here one thread per grid point (k fastest) reads the BS source
// components at v + off (contiguous in the interleaved layout) once per
// offset, with bounds checks in place of the roll + iota masks, streams the
// BS^2 data planes (coalesced along k) and keeps the BS sums in registers.
// Bound by device memory: (BS^2 n_off + 2 BS) values per point, 155 MB per
// fine-level SpMV of P1 elasticity at n=64 in f32.  The sum order per
// output is the plain version's: offset-major, then cj.
// ---------------------------------------------------------------------------
template <typename T, int BS>
__global__ void dia_matvec_bs_kernel(const T* __restrict__ data, const T* __restrict__ x,
                                     T* __restrict__ y, const Offsets offs, int n0, int n1, int n2) {
  const long long N = static_cast<long long>(n0) * n1 * n2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= N) return;
  const int k = static_cast<int>(idx % n2);
  const long long r = idx / n2;
  const int j = static_cast<int>(r % n1);
  const int i = static_cast<int>(r / n1);
  T acc[BS];
#pragma unroll
  for (int c = 0; c < BS; ++c) acc[c] = T(0);
  for (int d = 0; d < offs.n; ++d) {
    const int di = offs.d[3 * d], dj = offs.d[3 * d + 1], dk = offs.d[3 * d + 2];
    const int ii = i + di, jj = j + dj, kk = k + dk;
    if (ii >= 0 && ii < n0 && jj >= 0 && jj < n1 && kk >= 0 && kk < n2) {
      const long long src = idx + (static_cast<long long>(di) * n1 + dj) * n2 + dk;
      T xs[BS];
#pragma unroll
      for (int cj = 0; cj < BS; ++cj) xs[cj] = __ldg(x + src * BS + cj);
      const T* dd = data + static_cast<long long>(d) * BS * BS * N + idx;
#pragma unroll
      for (int ci = 0; ci < BS; ++ci) {
        T t = __ldg(dd + (ci * BS) * N) * xs[0];
#pragma unroll
        for (int cj = 1; cj < BS; ++cj) t += __ldg(dd + (ci * BS + cj) * N) * xs[cj];
        acc[ci] += t;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < BS; ++c) y[idx * BS + c] = acc[c];
}

// ---------------------------------------------------------------------------
// K6: parity-blocked SpMV on the padded class stack,
//   y_b[ci, q] = sum over the triples (m, cj, off) of row class ci of
//                data[m, q] * x_b[cj, q + off],  zero outside [0, s)^3.
//
// Replaces dolfinx_mpc_tpu/ops/pallas_lattice.py:make_blocked_matvec_pallas,
// whose per-plane roll + iota masks become bounds-checked loads (equal to
// the JAX package's halo pad, ops/lattice.py:337-345).  tab is the host-built
// CSR of the triples by row class, uploaded once per operator:
//   tab[0 .. n_cls]                 row pointers,
//   tab[n_cls+1 + 5*t .. +4]        (m, cj, di, dj, dk) of triple t,
// 230 triples for P2 tets, 4.6 KB: beyond the classic 4 KB kernel-parameter
// budget, so it is a device table and not passed by value as K2's offsets.
// One thread per (row class, coarse point), k fastest.  Bound by device
// memory: (n_trip + 2 n_cls) values per coarse point, 270 MB per matvec at
// n=64 in f32; the x neighbours come again through L1/L2.  The classes
// carry 19 to 65 triples, so whole blocks of the body class do ~3x the
// vertex class's work; that imbalance is left to later tuning.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void blocked_matvec_kernel(const T* __restrict__ data, const T* __restrict__ x,
                                      T* __restrict__ y, const int* __restrict__ tab, int n_cls,
                                      int s0, int s1, int s2) {
  const long long S = static_cast<long long>(s0) * s1 * s2;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_cls * S) return;
  const int ci = static_cast<int>(idx / S);
  const long long qf = idx - ci * S;
  const int k = static_cast<int>(qf % s2);
  const long long r = qf / s2;
  const int j = static_cast<int>(r % s1);
  const int p = static_cast<int>(r / s1);
  const int* trip = tab + n_cls + 1;
  T acc = T(0);
  const int t1 = __ldg(tab + ci + 1);
  for (int t = __ldg(tab + ci); t < t1; ++t) {
    const int* e = trip + 5 * t;
    const int m = __ldg(e), cj = __ldg(e + 1);
    const int di = __ldg(e + 2), dj = __ldg(e + 3), dk = __ldg(e + 4);
    const int pp = p + di, jj = j + dj, kk = k + dk;
    if (pp >= 0 && pp < s0 && jj >= 0 && jj < s1 && kk >= 0 && kk < s2) {
      acc += __ldg(data + m * S + qf) * __ldg(x + cj * S + (static_cast<long long>(pp) * s1 + jj) * s2 + kk);
    }
  }
  y[idx] = acc;
}

template <typename T, int W>
int launch_dia_matvec_w(const T* data, const T* x, T* y, const DiaParams& p, cudaStream_t st) {
  const int H = W * p.n2 + W;
  const size_t smem = static_cast<size_t>(2 * W + 2) * (kDiaPoints + 2 * H) * sizeof(T);
  if (smem > 48 * 1024) {  // beyond the default 48 KB (long k rows at W = 2, f64): opt in
    const cudaError_t e = cudaFuncSetAttribute(dia_matvec_kernel<T, W>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long P = static_cast<long long>(p.n1) * p.n2;
  const dim3 grid(static_cast<unsigned int>((P + kDiaPoints - 1) / kDiaPoints),
                  static_cast<unsigned int>((p.n0 + p.li - 1) / p.li));
  dia_matvec_kernel<T, W><<<grid, kDiaPoints, smem, st>>>(data, x, y, p);
  return static_cast<int>(cudaGetLastError());
}

// K2's launcher: the parameter block is built once per operator by the
// wrapper (ops/lattice_kernels.py:DiaMatvecLaunch) and read here by pointer.
template <typename T>
int launch_dia_matvec(const T* data, const T* x, T* y, const DiaParams* p, void* stream) {
  if (p->n < 0 || p->n > kMaxOffsets || p->li < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p->n0) * p->n1 * p->n2 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p->w) {
    case 1:
      return launch_dia_matvec_w<T, 1>(data, x, y, *p, st);
    case 2:
      return launch_dia_matvec_w<T, 2>(data, x, y, *p, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_dia_matvec_bs(const T* data, const T* x, T* y, const int* offs_host, int n_off, int bs,
                         int n0, int n1, int n2, void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  const long long N = static_cast<long long>(n0) * n1 * n2;
  if (N == 0) return 0;
  Offsets offs;
  offs.n = n_off;
  for (int q = 0; q < 3 * n_off; ++q) offs.d[q] = offs_host[q];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 2:
      dia_matvec_bs_kernel<T, 2><<<n_blocks(N), kThreads, 0, st>>>(data, x, y, offs, n0, n1, n2);
      break;
    case 3:
      dia_matvec_bs_kernel<T, 3><<<n_blocks(N), kThreads, 0, st>>>(data, x, y, offs, n0, n1, n2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fold_assemble_raw(T* out, int n_pl, int n0, int n1, int n2, int nx, int ny, int nz,
                             const int* planes, const int* ent, const T* coef, int r, T s,
                             void* stream) {
  const long long total = static_cast<long long>(n_pl) * n0 * n1 * n2;
  if (total == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 1:
      fold_assemble_raw_kernel<T, 1><<<n_blocks(total), kThreads, 0, st>>>(
          out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef, s);
      break;
    case 2:
      fold_assemble_raw_kernel<T, 2><<<n_blocks(total), kThreads, 0, st>>>(
          out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fold_assemble(T* out, int n_pl, int n0, int n1, int n2, int nx, int ny, int nz,
                         const int* planes, const int* ent, const T* coef, const T* fac,
                         int n_stack, T s, T dv, void* stream) {
  const long long total = static_cast<long long>(n_pl) * n0 * n1 * n2;
  if (total == 0) return 0;
  fold_assemble_kernel<T><<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef, fac, n_stack, s, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fold_assemble_masked(T* out, int n_pl, int n0, int n1, int n2, int nx, int ny, int nz,
                                const int* planes, const int* ent, const T* coef, const T* keep,
                                const T* ind, T s, T dv, void* stream) {
  const long long total = static_cast<long long>(n_pl) * n0 * n1 * n2;
  if (total == 0) return 0;
  fold_assemble_masked_kernel<T><<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef, keep, ind, s, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_blocked_matvec(const T* data, const T* x, T* y, const int* tab, int n_cls, int s0,
                          int s1, int s2, void* stream) {
  const long long total = static_cast<long long>(n_cls) * s0 * s1 * s2;
  if (total == 0) return 0;
  blocked_matvec_kernel<T><<<n_blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, x, y, tab, n_cls, s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// params: a DiaParams block, built by the wrapper once per operator
int dmt_dia_matvec_f32(const float* data, const float* x, float* y, const void* params, void* stream) {
  return launch_dia_matvec<float>(data, x, y, static_cast<const DiaParams*>(params), stream);
}

int dmt_dia_matvec_f64(const double* data, const double* x, double* y, const void* params,
                       void* stream) {
  return launch_dia_matvec<double>(data, x, y, static_cast<const DiaParams*>(params), stream);
}

int dmt_dia_matvec_bs_f32(const float* data, const float* x, float* y, const int* offs, int n_off,
                          int bs, int n0, int n1, int n2, void* stream) {
  return launch_dia_matvec_bs<float>(data, x, y, offs, n_off, bs, n0, n1, n2, stream);
}

int dmt_dia_matvec_bs_f64(const double* data, const double* x, double* y, const int* offs,
                          int n_off, int bs, int n0, int n1, int n2, void* stream) {
  return launch_dia_matvec_bs<double>(data, x, y, offs, n_off, bs, n0, n1, n2, stream);
}

int dmt_fold_assemble_raw_f32(float* out, int n_pl, int n0, int n1, int n2, int nx, int ny, int nz,
                              const int* planes, const int* ent, const float* coef, int r, float s,
                              void* stream) {
  return launch_fold_assemble_raw<float>(out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef, r, s,
                                         stream);
}

int dmt_fold_assemble_raw_f64(double* out, int n_pl, int n0, int n1, int n2, int nx, int ny,
                              int nz, const int* planes, const int* ent, const double* coef, int r,
                              double s, void* stream) {
  return launch_fold_assemble_raw<double>(out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef, r,
                                          s, stream);
}

int dmt_fold_assemble_f32(float* out, int n_pl, int n0, int n1, int n2, int nx, int ny, int nz,
                          const int* planes, const int* ent, const float* coef, const float* fac,
                          int n_stack, float s, float dv, void* stream) {
  return launch_fold_assemble<float>(out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef, fac,
                                     n_stack, s, dv, stream);
}

int dmt_fold_assemble_f64(double* out, int n_pl, int n0, int n1, int n2, int nx, int ny, int nz,
                          const int* planes, const int* ent, const double* coef,
                          const double* fac, int n_stack, double s, double dv, void* stream) {
  return launch_fold_assemble<double>(out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef, fac,
                                      n_stack, s, dv, stream);
}

int dmt_fold_assemble_masked_f32(float* out, int n_pl, int n0, int n1, int n2, int nx, int ny,
                                 int nz, const int* planes, const int* ent, const float* coef,
                                 const float* keep, const float* ind, float s, float dv,
                                 void* stream) {
  return launch_fold_assemble_masked<float>(out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef,
                                            keep, ind, s, dv, stream);
}

int dmt_fold_assemble_masked_f64(double* out, int n_pl, int n0, int n1, int n2, int nx, int ny,
                                 int nz, const int* planes, const int* ent, const double* coef,
                                 const double* keep, const double* ind, double s, double dv,
                                 void* stream) {
  return launch_fold_assemble_masked<double>(out, n_pl, n0, n1, n2, nx, ny, nz, planes, ent, coef,
                                             keep, ind, s, dv, stream);
}

int dmt_blocked_matvec_f32(const float* data, const float* x, float* y, const int* tab, int n_cls,
                           int s0, int s1, int s2, void* stream) {
  return launch_blocked_matvec<float>(data, x, y, tab, n_cls, s0, s1, s2, stream);
}

int dmt_blocked_matvec_f64(const double* data, const double* x, double* y, const int* tab,
                           int n_cls, int s0, int s1, int s2, void* stream) {
  return launch_blocked_matvec<double>(data, x, y, tab, n_cls, s0, s1, s2, stream);
}

}  // extern "C"
