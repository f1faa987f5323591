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
// cp.async helpers and the shared-memory opt-in of the plane-staged SpMVs
// (K2, K7, K6).
// ---------------------------------------------------------------------------
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

// A data-plane load: through the read-only cache, or, for an operator larger
// than the 50 MB L2 (STREAM), evict-first (ld.global.cs) so that the
// stream does not push x and y out of L2; where the operator fits, the
// cached load keeps it L2-resident from one call to the next.
template <bool STREAM, typename T>
__device__ __forceinline__ T ld_plane(const T* p) {
  if constexpr (STREAM) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

constexpr int kMaxDevices = 64;

// Beyond the default 48 KB a launch is refused unless the kernel has been
// opted in to its dynamic shared memory on the current device.  `granted`
// (one array per kernel instantiation) remembers what each device already
// allows, so the runtime call is made once and not per launch.
inline int smem_opt_in(const void* kernel, size_t smem, size_t* granted) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && granted[dev] >= smem) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = smem;
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// K2 and K7: DIA SpMV with BS dof components per lattice point (K2: BS = 1,
// K7: BS = 2, 3),
//   y[(v, ci)] = sum_{d, cj} data[d, ci, cj, v] * x[(v + off_d, cj)],
// data (n_off, BS, BS, n0, n1, n2), x and y interleaved (point-major, BS
// components each, k fastest), zero outside the grid.
//
// K2 replaces dolfinx_mpc_tpu/ops/pallas_lattice.py:_make_dia_matvec_group
// (`kernel` :766, pallas_call :791), K7 make_dia_matvec_bs_pallas (`kernel`
// :835, pallas_call :874).  The TPU kernels run one program per x plane with
// the 2W+1 neighbouring planes in VMEM and roll + iota edge masks; K7's
// splits x into component-major planes and its (offset, ci, cj) rows across
// calls to fit VMEM.
//
// What bounds them: device memory, (BS^2 n_off + 2 BS) values per point
// (K2: 18.7 MB per fine-level SpMV of the P1 path at n=64 in f32, 0.0056 ms
// at 3.35 TB/s; K7: 155 MB for P1 elasticity at n=64, 0.0462 ms).  The
// design is 2.5-D blocking.  A block owns a range of kDiaPoints consecutive
// points of the flattened (j, k) plane, q = j*n2 + k, and marches along i
// over `li` planes.  Every x neighbour of its points lies in the flat range
// [q0 - H, q0 + kDiaPoints + H) of planes i-W .. i+W, with H = W*n2 + W; in
// the interleaved layout that range, all BS components, is one contiguous
// run of x, so shared memory holds a ring of 2W+2 such runs: 2W+1 in use
// and one being filled by cp.async with the next plane while the current
// one is summed.  Cells outside the grid are zero-filled by the copy itself
// (src-size 0): planes i < 0 or >= n0 and flat indices outside [0, n1*n2)
// — the JAX package's zero pad.  That covers the i and j edges; a flat
// shift dj*n2 + dk that crosses a k edge lands on the next row, so each
// point keeps a (2W+1)-bit mask of the dk in range, computed once.  The
// flat range, not a rectangle, is the tile because every grid of the paths
// has odd n2 (2^m + 1): a rectangular k tile would leave a ragged
// one-column tile per row, and the same oddness puts every row at a 4-byte
// but never a 16-byte boundary, so the data planes are read with coalesced
// scalar loads (a warp reads 32 consecutive values of a plane), each value
// once.  The ring is read at stride BS words, free of bank conflicts in
// f32 at BS = 1 and 3.  K7 walks the offsets in chunks of kDiaChunk: the
// BS^2 data loads of every offset of a chunk are issued before any add,
// unconditionally (they stay in bounds), and only the add is masked, so it
// has 27 loads in flight per thread at BS = 3 (a chunk of 3 offsets, 71
// registers, three blocks per SM, ran faster than 2 or 4 on the H100); K2
// keeps its own unrolled loop over the offsets.  Offsets stay kernel
// parameters, with their flat shifts computed on the host; index
// arithmetic inside the plane is 32-bit.  The BS sums per point stay in
// registers and run over the offsets in order, then cj — the plain
// version's order.
// ---------------------------------------------------------------------------
constexpr int kMaxOffsets = 128;
constexpr int kDiaPoints = 256;  // plane points per block, one per thread
constexpr int kDiaChunk = 3;     // K7: offsets whose loads are issued together

struct DiaParams {
  int n;   // offsets
  int w;   // halo width W: 1 or 2, >= max |d|
  int bs;  // dof components per point: 1 (K2), 2 or 3 (K7)
  int n0, n1, n2;
  int li;  // x planes per block
  int di[kMaxOffsets];
  int sh[kMaxOffsets];  // flat shift dj*n2 + dk inside the plane
  int dk[kMaxOffsets];
  // K7: evict-first data loads (the operator exceeds the L2).  Last, so that
  // K2's offset arrays keep their place in the parameter space: placed
  // before them it made K2 up to 18 % slower on the H100.
  int stream;
};

template <typename T, int W, int BS, bool STREAM>
__global__ void __launch_bounds__(kDiaPoints)
dia_matvec_kernel(const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                  const DiaParams p) {
  constexpr int NP = 2 * W + 2;  // ring slots
  constexpr int BB = BS * BS;
  extern __shared__ __align__(16) unsigned char dia_smem[];
  T* ring = reinterpret_cast<T*>(dia_smem);
  const int P = p.n1 * p.n2;
  const int H = W * p.n2 + W;
  const int seg = (kDiaPoints + 2 * H) * BS;  // values per ring slot
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

  // plane ip's points [q0 - H, q0 + kDiaPoints + H), every component, into
  // ring slot `slot`
  auto load_plane = [&](int ip, int slot) {
    T* dst = ring + slot * seg;
    const bool plane_in = ip >= 0 && ip < p.n0;
    const T* src = x + static_cast<long long>(plane_in ? ip : 0) * P * BS;
    const int g0 = (q0 - H) * BS, g1 = P * BS;
    for (int e = tid; e < seg; e += kDiaPoints) {
      const int g = g0 + e;
      const bool in = plane_in && g >= 0 && g < g1;
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
      const T* xc = ring + (tid + H) * BS;
      const T* dd = data + static_cast<long long>(i) * P + q;
      if constexpr (BS == 1) {
        // K2: its own loop (the chunked walk below was slower at BS = 1
        // on the H100)
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
      } else {
        T acc[BS];
#pragma unroll
        for (int c = 0; c < BS; ++c) acc[c] = T(0);
        for (int d0 = 0; d0 < p.n; d0 += kDiaChunk) {
          T a[kDiaChunk][BB];
          T xv[kDiaChunk][BS];
          bool on[kDiaChunk];
#pragma unroll
          for (int u = 0; u < kDiaChunk; ++u) {
            // past the last offset: offset 0 again (in bounds), never added
            const int d = d0 + u < p.n ? d0 + u : 0;
            const T* dp = dd + static_cast<long long>(d) * BB * N;
#pragma unroll
            for (int c = 0; c < BB; ++c) a[u][c] = ld_plane<STREAM>(dp + c * N);
            int slot = rot + W + p.di[d];
            slot -= slot >= NP ? NP : 0;
            const T* xs = xc + slot * seg + p.sh[d] * BS;
#pragma unroll
            for (int cj = 0; cj < BS; ++cj) xv[u][cj] = xs[cj];
            on[u] = d0 + u < p.n && ((kmask >> (p.dk[d] + W)) & 1u);
          }
#pragma unroll
          for (int u = 0; u < kDiaChunk; ++u) {
            if (on[u]) {
#pragma unroll
              for (int ci = 0; ci < BS; ++ci) {
                T t = a[u][ci * BS] * xv[u][0];
#pragma unroll
                for (int cj = 1; cj < BS; ++cj) t += a[u][ci * BS + cj] * xv[u][cj];
                acc[ci] += t;
              }
            }
          }
        }
        T* yq = y + (static_cast<long long>(i) * P + q) * BS;
#pragma unroll
        for (int c = 0; c < BS; ++c) yq[c] = acc[c];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K6: parity-blocked SpMV on the padded class stack,
//   y_b[ci, q] = sum over the triples (m, cj, off) of row class ci of
//                data[m, q] * x_b[cj, q + off],  zero outside [0, s)^3.
//
// Replaces dolfinx_mpc_tpu/ops/pallas_lattice.py:make_blocked_matvec_pallas
// (`kernel` :916, pallas_call :989), whose per-plane roll + iota masks
// equal the JAX package's halo pad (ops/lattice.py:337-345).
//
// What bounds it: device memory, (n_trip + 2 n_cls) values per coarse
// point (270 MB per matvec at P2 n=64 in f32, 0.0807 ms).  Every coarse
// offset is within +-1, so it is K2's 2.5-D design at W = 1 over all
// classes at once: a block owns `pts` consecutive points of the flattened
// (j, k) class plane and marches along i, with a cp.async ring of 4 slots
// x n_cls classes x (pts + 2H) values in shared memory (H = s2 + 1),
// zero-filled outside the grid, and the per-point k-edge mask.  Each thread
// computes all n_cls outputs of R = 2 points (pts = 2 x threads), so every
// thread walks all the triples (the classes carry 19 to 65 each; one
// thread per (class, point) left whole blocks with 3x the work of others).
// The triple table (grouped by row class, each class in triple order) is
// a device array built once per operator, one int2 per triple: (column
// class cj << 24 | H + flat shift, m | row class << 16 | last of its class
// << 21 | (di + 1) << 22 | (dk + 1) << 24); each block copies it into
// shared memory as (offset of x_b[cj] at the flat shift inside a ring
// slot, the same second word), so every read of it in the loop is a
// warp-uniform broadcast.  (Passed in the kernel parameters instead, it ran
// no faster, and its 4 KB copy into every launch doubled the wrapper's host
// time.)  The triples are walked flat, across class boundaries, in chunks
// of U = 16 whose U x R data loads are issued before any add, so a thread
// keeps 32 of the 230 coalesced data streams in flight (fewer, at R = 1 or
// U = 8, and more, at R = 4, ran slower on the H100); the sum of a class
// is stored when its last triple has been added, so each class's sum runs
// over its triples in triple order — the plain version's order.
// ---------------------------------------------------------------------------
constexpr int kBlockedThreads = 256;  // most threads per block
constexpr int kBlockedR = 2;          // points per thread
constexpr int kBlockedU = 16;         // triples whose loads are issued together

struct BlockedParams {
  int n_cls, n_trip;
  int s0, s1, s2;
  int li;              // coarse x planes per block
  int pts;             // plane points per block: kBlockedR per thread
  unsigned int empty;  // row classes without triples (their output is 0)
  int stream;          // evict-first data loads (the operator exceeds the L2)
};

template <typename T, bool STREAM>
__global__ void __launch_bounds__(kBlockedThreads)
blocked_matvec_kernel(const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                      const int2* __restrict__ tab, const BlockedParams p) {
  constexpr int W = 1, NP = 2 * W + 2, R = kBlockedR, U = kBlockedU;
  extern __shared__ __align__(16) unsigned char blk_smem[];
  int2* trip = reinterpret_cast<int2*>(blk_smem);
  T* ring = reinterpret_cast<T*>(trip + ((p.n_trip + 1) & ~1));  // 16-byte aligned
  const int n_cls = p.n_cls, n_trip = p.n_trip;
  const int nt = p.pts / R;
  const int P = p.s1 * p.s2;
  const int H = W * p.s2 + W;
  const int seg = p.pts + 2 * H;  // values per class per ring slot
  const int cseg = n_cls * seg;   // values per ring slot
  const long long S = static_cast<long long>(p.s0) * P;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * p.pts;
  bool live[R];
  unsigned int kmask[R];  // bit dk + W: k + dk lies in [0, s2)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = q0 + tid + r * nt;
    live[r] = q < P;
    const int k = live[r] ? q % p.s2 : 0;
    kmask[r] = 0;
#pragma unroll
    for (int dk = -W; dk <= W; ++dk) kmask[r] |= (k + dk >= 0 && k + dk < p.s2) ? (1u << (dk + W)) : 0u;
  }
  const int i0 = blockIdx.y * p.li;
  const int i1 = min(i0 + p.li, p.s0);
  for (int t = tid; t < n_trip; t += nt) {  // published by the first barrier below
    const int2 e = __ldg(tab + t);
    trip[t] = make_int2((e.x >> 24) * seg + (e.x & 0xffffff), e.y);
  }

  // plane ip's points [q0 - H, q0 + pts + H) of every class into slot `slot`
  auto load_plane = [&](int ip, int slot) {
    const bool plane_in = ip >= 0 && ip < p.s0;
    const T* src = x + static_cast<long long>(plane_in ? ip : 0) * P;
    for (int c = 0; c < n_cls; ++c) {
      T* dst = ring + slot * cseg + c * seg;
      for (int e = tid; e < seg; e += nt) {
        const int g = q0 - H + e;
        const bool in = plane_in && g >= 0 && g < P;
        cp_async_or_zero(dst + e, in ? src + c * S + g : x, in);
      }
    }
  };
  for (int m = 0; m <= 2 * W; ++m) load_plane(i0 - W + m, m);
  cp_async_commit();
  for (int i = i0; i < i1; ++i) {
    const int s = i - i0;
    if (i + 1 < i1) load_plane(i + W + 1, (s + 2 * W + 1) % NP);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    if (live[0]) {  // live[r] implies live[0]
      const int rot = s % NP;
      const T* xr = ring + tid;
      const T* dq = data + static_cast<long long>(i) * P + q0 + tid;
      T* yq = y + static_cast<long long>(i) * P + q0 + tid;
      T acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = T(0);
      for (int t0 = 0; t0 < n_trip; t0 += U) {
        int2 e[U];
        T a[U][R], xv[U][R];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          // past the last triple: the last one again (in bounds), never added
          e[u] = trip[min(t0 + u, n_trip - 1)];
          const T* dm = dq + (e[u].y & 0xffff) * S;
          int slot = rot + ((e[u].y >> 22) & 3);
          slot -= slot >= NP ? NP : 0;
          const T* xs = xr + slot * cseg + e[u].x;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            a[u][r] = live[r] ? ld_plane<STREAM>(dm + r * nt) : T(0);
            xv[u][r] = xs[r * nt];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (t0 + u < n_trip) {
            const int dk = (e[u].y >> 24) & 3;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if ((kmask[r] >> dk) & 1u) acc[r] += a[u][r] * xv[u][r];
            if ((e[u].y >> 21) & 1) {
              const long long ci = (e[u].y >> 16) & 31;
#pragma unroll
              for (int r = 0; r < R; ++r) {
                if (live[r]) yq[ci * S + r * nt] = acc[r];
                acc[r] = T(0);
              }
            }
          }
        }
      }
      for (int ci = 0; ci < n_cls; ++ci) {
        if ((p.empty >> ci) & 1u) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (live[r]) yq[ci * S + r * nt] = T(0);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int W, int BS, bool STREAM>
int launch_dia_matvec_wbs(const T* data, const T* x, T* y, const DiaParams& p, cudaStream_t st) {
  static size_t granted[kMaxDevices] = {};
  const int H = W * p.n2 + W;
  const size_t smem = static_cast<size_t>(2 * W + 2) * (kDiaPoints + 2 * H) * BS * sizeof(T);
  const int e =
      smem_opt_in(reinterpret_cast<const void*>(dia_matvec_kernel<T, W, BS, STREAM>), smem, granted);
  if (e != 0) return e;
  const long long P = static_cast<long long>(p.n1) * p.n2;
  const dim3 grid(static_cast<unsigned int>((P + kDiaPoints - 1) / kDiaPoints),
                  static_cast<unsigned int>((p.n0 + p.li - 1) / p.li));
  dia_matvec_kernel<T, W, BS, STREAM><<<grid, kDiaPoints, smem, st>>>(data, x, y, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W, int BS>
int launch_dia_matvec_wb(const T* data, const T* x, T* y, const DiaParams& p, cudaStream_t st) {
  if constexpr (BS > 1) {
    if (p.stream) return launch_dia_matvec_wbs<T, W, BS, true>(data, x, y, p, st);
  }
  return launch_dia_matvec_wbs<T, W, BS, false>(data, x, y, p, st);
}

// K2's and K7's launcher: the parameter block is built once per operator by
// the wrapper (ops/lattice_kernels.py:DiaMatvecLaunch, DiaBsMatvecLaunch)
// and read here by pointer.
template <typename T>
int launch_dia_matvec(const T* data, const T* x, T* y, const DiaParams* p, void* stream) {
  if (p->n < 0 || p->n > kMaxOffsets || p->li < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p->n0) * p->n1 * p->n2 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (10 * p->w + p->bs) {
    case 11:
      return launch_dia_matvec_wb<T, 1, 1>(data, x, y, *p, st);
    case 12:
      return launch_dia_matvec_wb<T, 1, 2>(data, x, y, *p, st);
    case 13:
      return launch_dia_matvec_wb<T, 1, 3>(data, x, y, *p, st);
    case 21:
      return launch_dia_matvec_wb<T, 2, 1>(data, x, y, *p, st);
    case 22:
      return launch_dia_matvec_wb<T, 2, 2>(data, x, y, *p, st);
    case 23:
      return launch_dia_matvec_wb<T, 2, 3>(data, x, y, *p, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool STREAM>
int launch_blocked_matvec_s(const T* data, const T* x, T* y, const int2* tab, const BlockedParams& p,
                            cudaStream_t st) {
  static size_t granted[kMaxDevices] = {};
  const int H = p.s2 + 1;
  const size_t smem = static_cast<size_t>((p.n_trip + 1) & ~1) * sizeof(int2) +
                      static_cast<size_t>(4) * p.n_cls * (p.pts + 2 * H) * sizeof(T);
  const int e = smem_opt_in(reinterpret_cast<const void*>(blocked_matvec_kernel<T, STREAM>), smem, granted);
  if (e != 0) return e;
  const long long P = static_cast<long long>(p.s1) * p.s2;
  const dim3 grid(static_cast<unsigned int>((P + p.pts - 1) / p.pts),
                  static_cast<unsigned int>((p.s0 + p.li - 1) / p.li));
  blocked_matvec_kernel<T, STREAM><<<grid, p.pts / kBlockedR, smem, st>>>(data, x, y, tab, p);
  return static_cast<int>(cudaGetLastError());
}

// K6's launcher: the parameter block and the device table are built once
// per operator by the wrapper (ops/lattice_kernels.py:BlockedMatvecLaunch);
// the block is read here by pointer.
template <typename T>
int launch_blocked_matvec(const T* data, const T* x, T* y, const int* tab, const BlockedParams* p,
                          void* stream) {
  const int nt = p->pts / kBlockedR;
  if (p->n_cls < 1 || p->n_cls > 32 || p->n_trip < 1 || p->n_trip > 65535 || p->li < 1 || nt < 32 ||
      nt > kBlockedThreads || nt % 32 != 0 || nt * kBlockedR != p->pts)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p->s0) * p->s1 * p->s2 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int2* t2 = reinterpret_cast<const int2*>(tab);
  return p->stream ? launch_blocked_matvec_s<T, true>(data, x, y, t2, *p, st)
                   : launch_blocked_matvec_s<T, false>(data, x, y, t2, *p, st);
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

}  // namespace

extern "C" {

// params: a DiaParams block (K2 at bs 1, K7 at bs 2 and 3), built by the
// wrapper once per operator
int dmt_dia_matvec_f32(const float* data, const float* x, float* y, const void* params, void* stream) {
  return launch_dia_matvec<float>(data, x, y, static_cast<const DiaParams*>(params), stream);
}

int dmt_dia_matvec_f64(const double* data, const double* x, double* y, const void* params,
                       void* stream) {
  return launch_dia_matvec<double>(data, x, y, static_cast<const DiaParams*>(params), stream);
}

// tab: K6's device table; params: a BlockedParams block; both built by the
// wrapper once per operator
int dmt_blocked_matvec_f32(const float* data, const float* x, float* y, const int* tab,
                           const void* params, void* stream) {
  return launch_blocked_matvec<float>(data, x, y, tab, static_cast<const BlockedParams*>(params), stream);
}

int dmt_blocked_matvec_f64(const double* data, const double* x, double* y, const int* tab,
                           const void* params, void* stream) {
  return launch_blocked_matvec<double>(data, x, y, tab, static_cast<const BlockedParams*>(params), stream);
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

}  // extern "C"
