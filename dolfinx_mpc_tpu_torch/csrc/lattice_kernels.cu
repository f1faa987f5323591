// Hopper (sm_90a) kernels of the lattice fast path: the fused lean-fold
// assemblers (K1, its blocked use K4, the masked K3 and the unmasked K5,
// one block design over per-class window sums, K5 also at window stride 2),
// the scalar DIA SpMV (K2), the vector (bs > 1) DIA SpMV (K7) and the
// parity-blocked SpMV (K6).
//
// Built by dolfinx_mpc_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Each
// extern "C" launcher enqueues one kernel on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() so that a
// refused launch reaches the Python wrapper (ops/lattice_kernels.py), which
// raises on any non-zero code.  All kernels are templated on float (the
// main path) and double (the f64 oracles on the card); the SpMVs (K2, K7,
// K6) also on complex64 and complex128 (dmt::cplx of complex.cuh, torch's
// interleaved layout read as it stands).

#include <cuda_runtime.h>

#include "complex.cuh"

namespace {

using dmt::cplx;
using dmt::ld_cs;
using dmt::ld_ro;

// ---------------------------------------------------------------------------
// K1 / K4 / K3 and K5: fused lean-fold assemblers.
//
// The host reduction (ops/lattice_kernels.py:build_fold_table) has already
// collapsed every element tensor entry of the uniform lattice into a short
// table per output plane mi:
//   planes[8*mi .. 8*mi+7] = (ri, ci, di, dj, dk, is_diag, e_begin, e_end)
//   ent[3*e .. 3*e+2]      = (dax, day, daz)   for e in [e_begin, e_end)
//   coef[3*e .. 3*e+2]     = (c0, c1, c2)      value c0 s^3 + c1 s^2 + c2 s
// Entry e covers the box window p in [dax, dax+nx), j in [day, day+ny),
// k in [daz, daz+nz) (on the refined degree-2 grid, K5 only, the points
// da + R q of the boxes q: stride R = 2).  K1, K4 and K3 mask the result by
// the keep mask of the row (stack row ri at p, j, k) and of the column
// (stack row ci at p+di, j+dj, k+dk), and the diagonal planes get diagval
// on the bc rows; K5 writes it unmasked.  On the grid layout (degree 1) a
// plane is a DIA offset and the stack rows are dof components; on the
// parity-blocked layout (degree 2) a plane is a triple (row class, column
// class, coarse offset) over the padded class grids and the stack rows are
// the 8 parity classes — the same arithmetic, which is why the JAX package
// runs K1's Pallas code over a _BlockedView for K4.
//
// What bounds them is their single write of the output (16.5 MB per P1
// assembly at n=64 in f32, 253 MB for the 230 P2 triples at n=64, 558 MB
// for K5's 65 refined planes at 129^3), but only if the work per output
// value is a few instructions.  The first designs (one thread per value,
// its index split by three 64-bit div/mod pairs, then a walk over the
// plane's whole entry table with three index loads and six compares per
// entry) ran at 11-19 % of that bound on the H100: they were bound by
// integer instructions, not by the write.  The redesign rests on the
// windows' shape: every window spans [da, da + R n) on an axis, so the
// segment starts ("edges") {0} U {da} U {da + R n} inside the grid split
// each axis into at most 4 segments at R = 1 (3 on an unpadded grid), and
// inside a segment the windows that hold a point depend only on its parity
// mod R; the window sum is therefore constant on the classes (segment,
// parity) of each axis: <= 64 per plane at R = 1, <= 512 at R = 2 (125 on
// the refined grid, classes (0, 1, 2, 3, 2n) per axis).  A block computes
// its plane's class values once, with one expression at each class's
// first point (the same entries in the same order at every launch, so K5
// at R = 1 equals K1 / K4 with unit factors bit for bit), then writes its
// x plane with a lookup per value (and K1's / K3's mask products).  The TPU
// kernels' VMEM offset splitting, transposed j-factor layout, SMEM x-factor
// tables and pltpu.repeat upsampling answered TPU memory limits and have
// no counterpart here.
// ---------------------------------------------------------------------------

// The limits of a launch at window stride R: a plane holds one entry per
// window corner, at most (R + 1)^3 (8 for K1, K4, K3 and K5 at R = 1, 27 for
// K5 on the refined grid), and an axis holds at most 4 R classes.
template <int R>
struct FoldLimits {
  static constexpr int entries = (R + 1) * (R + 1) * (R + 1);
  static constexpr int edges = 4 * R;
  static constexpr int classes = edges * edges * edges;
};
constexpr int kFoldMaxThreads = 512;

// The launch shape and the classes of a launch at stride R, built once per
// table by the wrapper (ops/lattice_kernels.py:fold_launch_params,
// FoldLaunch) and read by the launcher by pointer: FoldParams (R = 1) for
// K1 / K4, K3 and K5, FoldParamsR<2> for K5 on the refined grid.  The
// stride-1 block keeps room for 4 classes per axis only: with room for 8
// K1 ran 4-10 % slower on the H100 (its class set-up then read the block
// by a computed index).
template <int E>
struct FoldParamsT {
  int n_pl, n0, n1, n2;  // planes and the grid
  int nx, ny, nz;        // window extents (boxes)
  int n_stack;           // factor rows (K1 / K4)
  int ne[3];             // classes per axis, 1 .. E
  int edge[3][E];        // their first points: 0 = edge[a][0] < edge[a][1] < ... < n_a
  int g;                 // row groups per block: thread u takes rows u / kw + g t
  int kw;                // columns per row group (thread u takes k = u % kw + kw t)
  int threads;           // g * kw rounded up to whole warps
  int stream;            // evict-first stores (the output exceeds the L2)
  int stage;             // K3: keep planes staged in shared memory
};
template <int R>
using FoldParamsR = FoldParamsT<FoldLimits<R>::edges>;
using FoldParams = FoldParamsR<1>;

// The class of x on axis a.  At R = 1 its segment: the number of edges
// <= x, less one.  At R > 1 the last class whose first point is <= x and
// shares x's parity: the first point of x's own class, since a class's
// points are those of its parity in its segment.
template <int R = 1>
__device__ __forceinline__ int fold_segment(const FoldParamsR<R>& p, int a, int x) {
  int c = 0;
#pragma unroll
  for (int b = 1; b < FoldLimits<R>::edges; ++b) {
    if constexpr (R == 1) {
      c += (b < p.ne[a] && x >= p.edge[a][b]) ? 1 : 0;
    } else {
      c = (b < p.ne[a] && x >= p.edge[a][b] && (x - p.edge[a][b]) % R == 0) ? b : c;
    }
  }
  return c;
}

// Whether the window of corner da and n boxes holds x on one axis.
template <int R>
__device__ __forceinline__ bool fold_holds(int x, int da, int n) {
  if constexpr (R == 1) {
    return x >= da && x < da + n;
  } else {
    const int u = x - da;
    return u >= 0 && u < R * n && u % R == 0;
  }
}

struct FoldPlane {
  int ri, ci, di, dj, dk, is_diag, e0, e1;
};

__device__ __forceinline__ FoldPlane fold_plane(const int* __restrict__ planes, int mi) {
  const int* pl = planes + 8 * mi;
  return FoldPlane{__ldg(pl + 0), __ldg(pl + 1), __ldg(pl + 2), __ldg(pl + 3),
                   __ldg(pl + 4), __ldg(pl + 5), __ldg(pl + 6), __ldg(pl + 7)};
}

// A block's shared memory: the plane's entries, staged once, and its class
// values; after them the kernel's per-row tables.
template <typename T, int R = 1>
struct FoldShared {
  T coef[3 * FoldLimits<R>::entries];
  T cls[FoldLimits<R>::classes];
  int ent[3 * FoldLimits<R>::entries];
};

// Stage the plane's <= FoldLimits<R>::entries entries (one load per value,
// the block's threads at once).  Published by the barrier that follows.
template <typename T, int R>
__device__ __forceinline__ void fold_stage_entries(FoldShared<T, R>& sh, const FoldPlane& f,
                                                   const int* __restrict__ ent, const T* __restrict__ coef) {
  for (int t = threadIdx.x; t < 3 * (f.e1 - f.e0); t += blockDim.x) {
    sh.ent[t] = __ldg(ent + 3 * f.e0 + t);
    sh.coef[t] = __ldg(coef + 3 * f.e0 + t);
  }
}

// The first point of class c on axis a (edge[a][0] is 0), picked by an
// unrolled select: an indexed read of the parameter block was slower for
// K1 and K4 on the H100.
template <int R>
__device__ __forceinline__ int fold_first(const FoldParamsR<R>& p, int a, int c) {
  int v = 0;
#pragma unroll
  for (int b = 1; b < FoldLimits<R>::edges; ++b) v = (b == c) ? p.edge[a][b] : v;
  return v;
}

// The plane's class values into sh.cls[(c0 * ne1 + c1) * ne2 + c2], each at
// the class's first point (edge[0][c0], edge[1][c1], edge[2][c2]): the sum
// of the entries whose window holds it, in table order, with one
// expression, so that K5 at R = 1 and K1 / K4 (the same instantiation)
// agree bit for bit, and every value is the plain version's sum of the
// same terms in the same order.  The entry loop is unrolled to the
// FoldLimits<R>::entries bound so that its shared-memory reads are issued
// together.
template <typename T, int R>
__device__ __forceinline__ void fold_class_values(FoldShared<T, R>& sh, const FoldParamsR<R>& p, int n_ent, T s) {
  const T s2 = s * s, s3 = s2 * s;
  const int n12 = p.ne[1] * p.ne[2];
  for (int c = threadIdx.x; c < p.ne[0] * n12; c += blockDim.x) {
    const int x = fold_first<R>(p, 0, c / n12), y = fold_first<R>(p, 1, (c / p.ne[2]) % p.ne[1]),
              z = fold_first<R>(p, 2, c % p.ne[2]);
    T acc = T(0);
#pragma unroll
    for (int e = 0; e < FoldLimits<R>::entries; ++e) {
      if (e < n_ent) {
        const int dax = sh.ent[3 * e], day = sh.ent[3 * e + 1], daz = sh.ent[3 * e + 2];
        if (fold_holds<R>(x, dax, p.nx) && fold_holds<R>(y, day, p.ny) && fold_holds<R>(z, daz, p.nz)) {
          acc += sh.coef[3 * e] * s3 + sh.coef[3 * e + 1] * s2 + sh.coef[3 * e + 2] * s;
        }
      }
    }
    sh.cls[c] = acc;
  }
}

// K1's / K4's per-row record in shared memory, read with one vector load:
// kj[ri, j], kj[ci, j + dj], pj[ri, j] and the segment of j times ne[2].
template <typename T>
struct __align__(16) FoldRow {
  T r, c, p;
  int cls;
};

// An output store: plain, or evict-first (st.global.cs) for an output
// larger than the L2, which is written once and read by a later kernel.
template <bool STREAM, typename T>
__device__ __forceinline__ void st_out(T* q, T v) {
  if constexpr (STREAM) {
    __stcs(q, v);
  } else {
    *q = v;
  }
}

// A plane no move reaches stays zero (as in the TPU kernel): its blocks
// write zeros and read nothing more.  Returns whether the plane is empty.
template <bool STREAM, typename T>
__device__ __forceinline__ bool fold_empty_plane(T* o, const FoldPlane& f, int P) {
  if (f.e0 != f.e1) return false;
  for (int t = threadIdx.x; t < P; t += blockDim.x) st_out<STREAM>(o + t, T(0));
  return true;
}

// K1 (and K4): separable masks.  Replaces dolfinx_mpc_tpu/ops/
// pallas_lattice.py:_make_lean_fold_pallas_group (kernel_factored) and,
// launched on the blocked table, make_lean_blocked_pallas.  The masks are
// halo-padded per-axis factors of each stack row; the diagonal term is
// diagval * (pad - keep), with pad the real-slot indicator.  On the blocked
// layout pad is 0 on the padded slots, where keep is 0 too, so every padded
// slot comes out an exact 0 (the blocked SpMV and the fold rely on that).
//
// A block takes plane blockIdx.y, x plane blockIdx.x.  Its threads form g
// row groups of kw columns: thread u keeps column k = u % kw
// (its k factors in registers) and writes rows j = u / kw, + g, ...; the
// rows' factors and segments are staged in shared memory once (a 16-byte
// FoldRow each, one vector load per value), beside the entries and the
// class values, and the x factors are uniform over the block.  Everything
// the set-up loads is issued before its first barrier, so a block waits about
// two load latencies before it writes.  A warp's stores run along k, 4 B
// (8 B in f64) per thread, coalesced; the row loop is unrolled so that
// several rows' reads are in flight.  Odd row lengths (2^m + 1) leave the
// rows unaligned; staging chunks of rows in shared memory to write them
// with aligned 16-byte stores ran no faster on the H100 (its per-chunk
// barriers cost what the stores saved).  A plane with no entry writes
// zeros and reads nothing.  The products keep the first design's order,
// acc * row * col and dv * (pad - row), with row = (ki kj) kk.  32-bit
// index arithmetic inside a plane.
template <typename T, bool STREAM>
__global__ void __launch_bounds__(kFoldMaxThreads)
fold_assemble_kernel(T* __restrict__ out, const int* __restrict__ planes, const int* __restrict__ ent,
                     const T* __restrict__ coef, const T* __restrict__ fac, const FoldParams p, T s, T dv) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  const int mi = blockIdx.y, i = blockIdx.x;
  T* const o = out + (static_cast<long long>(mi) * p.n0 + i) * p.n1 * p.n2;
  const FoldPlane f = fold_plane(planes, mi);
  if (fold_empty_plane<STREAM>(o, f, p.n1 * p.n2)) return;
  // halo-padded factor rows: [ki | pi] (n_stack, n0+2), [kj | pj] (n_stack,
  // n1+2), [kk | pk] (n_stack, n2+2); index +1 skips the halo
  const int L0 = p.n0 + 2, L1 = p.n1 + 2, L2 = p.n2 + 2;
  const T* ki = fac;
  const T* pi = ki + p.n_stack * L0;
  const T* kj = pi + p.n_stack * L0;
  const T* pj = kj + p.n_stack * L1;
  const T* kk = pj + p.n_stack * L1;
  const T* pk = kk + p.n_stack * L2;
  FoldShared<T>& sh = *reinterpret_cast<FoldShared<T>*>(fold_smem);
  FoldRow<T>* rows = reinterpret_cast<FoldRow<T>*>(fold_smem + sizeof(FoldShared<T>));
  fold_stage_entries(sh, f, ent, coef);
  for (int j = threadIdx.x; j < p.n1; j += blockDim.x) {
    rows[j] = FoldRow<T>{__ldg(kj + f.ri * L1 + j + 1), __ldg(kj + f.ci * L1 + j + 1 + f.dj),
                         __ldg(pj + f.ri * L1 + j + 1), fold_segment(p, 1, j) * p.ne[2]};
  }
  const int jg = threadIdx.x / p.kw;
  int k = threadIdx.x - jg * p.kw;
  const T ir = __ldg(ki + f.ri * L0 + i + 1), ic = __ldg(ki + f.ci * L0 + i + 1 + f.di);
  const T ip = __ldg(pi + f.ri * L0 + i + 1);
  T kr = T(0), kc = T(0), kp = T(0);
  if (k < p.n2) {
    kr = __ldg(kk + f.ri * L2 + k + 1);
    kc = __ldg(kk + f.ci * L2 + k + 1 + f.dk);
    kp = __ldg(pk + f.ri * L2 + k + 1);
  }
  __syncthreads();
  fold_class_values(sh, p, f.e1 - f.e0, s);
  __syncthreads();
  if (jg >= p.g) return;
  const T* ci = sh.cls + fold_segment(p, 0, i) * p.ne[1] * p.ne[2];
  const int step = p.g * p.n2;
  for (; k < p.n2; k += p.kw) {
    if (k >= p.kw) {
      kr = __ldg(kk + f.ri * L2 + k + 1);
      kc = __ldg(kk + f.ci * L2 + k + 1 + f.dk);
      kp = __ldg(pk + f.ri * L2 + k + 1);
    }
    const T* cv = ci + fold_segment(p, 2, k);
    T* q = o + jg * p.n2 + k;
    if (f.is_diag) {
#pragma unroll 4
      for (int j = jg; j < p.n1; j += p.g, q += step) {
        const FoldRow<T> w = rows[j];
        const T row = ir * w.r * kr;
        const T res = cv[w.cls] * row * (ic * w.c * kc);
        const T pad = ip * w.p * kp;
        st_out<STREAM>(q, res + dv * (pad - row));
      }
    } else {
#pragma unroll 4
      for (int j = jg; j < p.n1; j += p.g, q += step) {
        const FoldRow<T> w = rows[j];
        const T row = ir * w.r * kr;
        st_out<STREAM>(q, cv[w.cls] * row * (ic * w.c * kc));
      }
    }
  }
}

// K3's keep reads: from the staged planes in shared memory, or from the L2.
template <bool STAGE>
__device__ __forceinline__ unsigned char ld_keep(const unsigned char* q) {
  if constexpr (STAGE) {
    return *q;
  } else {
    return __ldg(q);
  }
}

template <typename T, bool STREAM, bool STAGE>
__device__ __forceinline__ void fold_masked_rows(T* q, const T* cv, const int* jcls, const unsigned char* kr,
                                                 const unsigned char* kc, const T* id, int jg, int n1, int g,
                                                 int step, int kstep, bool diag, T dv) {
  if (diag) {
#pragma unroll 4
    for (int j = jg; j < n1; j += g, q += step, kr += kstep, kc += kstep, id += step)
      st_out<STREAM>(q, cv[jcls[j]] * T(ld_keep<STAGE>(kr)) * T(ld_keep<STAGE>(kc)) + dv * __ldg(id));
  } else {
#pragma unroll 4
    for (int j = jg; j < n1; j += g, q += step, kr += kstep, kc += kstep)
      st_out<STREAM>(q, cv[jcls[j]] * T(ld_keep<STAGE>(kr)) * T(ld_keep<STAGE>(kc)));
  }
}

// K3: masks read from memory.  Replaces dolfinx_mpc_tpu/ops/
// pallas_lattice.py:kernel_masked (fuse mode "2d"), on either layout.  keep
// is the halo-padded keep stack (n_stack, n0+2, n1+2, n2+2), so the shifted
// column read (|d| <= 1) never leaves it; ind is the bc multiplicity stack
// (n_stack, n0, n1, n2), added times diagval on the diagonal planes (and
// read only there).  K1's block and thread layout, set-up and class values.
// The keep stack holds only 0 and 1, so the kernel reads it as bytes (a
// copy the wrapper makes once per table, 2.4 MB at P2 n=64 instead of 9.6).
// Per value it needs the row plane keep[ri, i] and the shifted column
// plane keep[ci, i + di] at (j, k): with STAGE a block first copies both
// halo planes (4.5 KB each at 65^2) into shared memory with 4-byte loads,
// so the row loop reads shared memory only (read from the L2 value by
// value, bytes or not, the loads' latency kept K3 P2 well behind K4 on the
// H100).  Without STAGE (planes beyond a block's shared memory)
// the reads go to the L2, coalesced along k.  The stores are K1's.  No
// VMEM budget means no size limit, unlike the TPU kernel.
template <typename T, bool STREAM, bool STAGE>
__global__ void __launch_bounds__(kFoldMaxThreads)
fold_assemble_masked_kernel(T* __restrict__ out, const int* __restrict__ planes, const int* __restrict__ ent,
                            const T* __restrict__ coef, const unsigned char* __restrict__ keep,
                            const T* __restrict__ ind, const FoldParams p, T s, T dv) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  const int mi = blockIdx.y, i = blockIdx.x;
  const int P = p.n1 * p.n2;
  T* const o = out + (static_cast<long long>(mi) * p.n0 + i) * P;
  const FoldPlane f = fold_plane(planes, mi);
  if (fold_empty_plane<STREAM>(o, f, P)) return;
  FoldShared<T>& sh = *reinterpret_cast<FoldShared<T>*>(fold_smem);
  int* jcls = reinterpret_cast<int*>(fold_smem + sizeof(FoldShared<T>));  // segment of j times ne[2]
  unsigned int* kst = reinterpret_cast<unsigned int*>(jcls + p.n1);      // STAGE: the two keep planes
  const int L2 = p.n2 + 2;
  const int L12 = (p.n1 + 2) * L2;
  const int words = L12 / 4 + 2;  // a staged halo plane, from its start rounded down to 4 bytes
  const long long L0 = p.n0 + 2;
  const unsigned char* kr0 = keep + (f.ri * L0 + i + 1) * L12;  // halo plane of the row mask
  const unsigned char* kc0 = keep + (f.ci * L0 + i + 1 + f.di) * L12;
  const unsigned char* rb;  // the two planes as the row loop reads them
  const unsigned char* cb;
  fold_stage_entries(sh, f, ent, coef);
  for (int j = threadIdx.x; j < p.n1; j += blockDim.x) jcls[j] = fold_segment(p, 1, j) * p.ne[2];
  if constexpr (STAGE) {
    const int ar = static_cast<int>(reinterpret_cast<size_t>(kr0) & 3);
    const int ac = static_cast<int>(reinterpret_cast<size_t>(kc0) & 3);
    const unsigned int* wr = reinterpret_cast<const unsigned int*>(kr0 - ar);
    const unsigned int* wc = reinterpret_cast<const unsigned int*>(kc0 - ac);
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      kst[w] = __ldg(wr + w);
      kst[words + w] = __ldg(wc + w);
    }
    rb = reinterpret_cast<const unsigned char*>(kst) + ar;
    cb = reinterpret_cast<const unsigned char*>(kst + words) + ac;
  } else {
    rb = kr0;
    cb = kc0;
  }
  __syncthreads();
  fold_class_values(sh, p, f.e1 - f.e0, s);
  __syncthreads();
  const int jg = threadIdx.x / p.kw;
  if (jg >= p.g) return;
  const T* ci = sh.cls + fold_segment(p, 0, i) * p.ne[1] * p.ne[2];
  const int step = p.g * p.n2, kstep = p.g * L2;
  for (int k = threadIdx.x - jg * p.kw; k < p.n2; k += p.kw) {
    const int r0 = (jg + 1) * L2 + k + 1, c0 = (jg + 1 + f.dj) * L2 + k + 1 + f.dk;
    const T* id = ind + (static_cast<long long>(f.ri) * p.n0 + i) * P + jg * p.n2 + k;
    fold_masked_rows<T, STREAM, STAGE>(o + jg * p.n2 + k, ci + fold_segment(p, 2, k), jcls, rb + r0, cb + c0, id,
                                       jg, p.n1, p.g, step, kstep, f.is_diag, dv);
  }
}

// K5: the unmasked planes, no mask factors and no diagval term.  Replaces
// dolfinx_mpc_tpu/ops/pallas_lattice.py:_make_lean_fold_pallas_group ->
// kernel (fuse_mode None), which the JAX package runs for a form without
// Dirichlet dofs, where every mask is the identity: on the vertex grid (any
// bs) and on the blocked class grids (degree 2) at R = 1, and on the
// refined degree-2 grid at R = 2, where an entry adds only at the points
// of its corner's parity (the stride-R form of the TPU kernel's
// pltpu.repeat upsampling times its parity mask and x-plane weight).  The
// window ends at the last box (R (n - 1) + d <= n1 - 1: the TPU kernel's
// clip at n1 - day never cuts a written value).
//
// K1's design without the masks: one block per (plane, x plane), the
// plane's entries staged and its class values computed once
// (fold_class_values: at R = 1 K1's own instantiation, so the values equal
// unit-factor K1 / K4 bit for bit; at R = 2 with the parity classes,
// up to 27 entries per plane), each row's class times ne[2] in shared
// memory (as K3's jcls), each thread's column class in a register.  The
// store loop is K1's: g row groups of kw columns, stores coalesced along
// k and evict-first beyond the L2; per value one shared-memory lookup
// (jcls[j] is a broadcast within a row) and one store.  Bound by the
// write: 253 MB for the 230 blocked P2 triples at n=64, 148 MB for the 135
// bs=3 planes, 558 MB for the 65 refined planes (129^3) in f32.
template <typename T, int R, bool STREAM>
__global__ void __launch_bounds__(kFoldMaxThreads)
fold_assemble_raw_kernel(T* __restrict__ out, const int* __restrict__ planes, const int* __restrict__ ent,
                         const T* __restrict__ coef, const FoldParamsR<R> p, T s) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  const int mi = blockIdx.y, i = blockIdx.x;
  T* const o = out + (static_cast<long long>(mi) * p.n0 + i) * p.n1 * p.n2;
  const FoldPlane f = fold_plane(planes, mi);
  if (fold_empty_plane<STREAM>(o, f, p.n1 * p.n2)) return;
  FoldShared<T, R>& sh = *reinterpret_cast<FoldShared<T, R>*>(fold_smem);
  int* jcls = reinterpret_cast<int*>(fold_smem + sizeof(FoldShared<T, R>));  // class of j times ne[2]
  fold_stage_entries(sh, f, ent, coef);
  for (int j = threadIdx.x; j < p.n1; j += blockDim.x) jcls[j] = fold_segment<R>(p, 1, j) * p.ne[2];
  __syncthreads();
  fold_class_values(sh, p, f.e1 - f.e0, s);
  __syncthreads();
  const int jg = threadIdx.x / p.kw;
  if (jg >= p.g) return;
  const T* ci = sh.cls + fold_segment<R>(p, 0, i) * p.ne[1] * p.ne[2];
  const int step = p.g * p.n2;
  for (int k = threadIdx.x - jg * p.kw; k < p.n2; k += p.kw) {
    const T* cv = ci + fold_segment<R>(p, 2, k);
    T* q = o + jg * p.n2 + k;
#pragma unroll 4
    for (int j = jg; j < p.n1; j += p.g, q += step) st_out<STREAM>(q, cv[jcls[j]]);
  }
}

// ---------------------------------------------------------------------------
// cp.async helpers and the shared-memory opt-in of the plane-staged SpMVs
// (K2, K7, K6).  One copy per value: 4 bytes (f32), 8 (f64, c64) or 16
// (c128), each aligned to its size in device and shared memory.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void cp_async_or_zero(T* dst, const T* src, bool in) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int n = in ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n) : "memory");
  } else if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n) : "memory");
  } else {
    static_assert(sizeof(T) == 16, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n) : "memory");
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
    return ld_cs(p);
  } else {
    return ld_ro(p);
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
// K7's chunk for a scalar T: c128 (16 B) issues two offsets' loads at a
// time, so that its 4-register values keep about the f64 chunk's registers
template <typename T>
constexpr int kDiaChunkOf = sizeof(T) > 8 ? 2 : kDiaChunk;

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
  constexpr int CH = kDiaChunkOf<T>;
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
          const T a = ld_ro(dd + d * N);
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
        for (int d0 = 0; d0 < p.n; d0 += CH) {
          T a[CH][BB];
          T xv[CH][BS];
          bool on[CH];
#pragma unroll
          for (int u = 0; u < CH; ++u) {
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
          for (int u = 0; u < CH; ++u) {
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
// K6's chunk for a scalar T: c128 (16 B) issues 8 triples' loads at a time,
// so that its 4-register values keep the f64 chunk's registers
template <typename T>
constexpr int kBlockedUOf = sizeof(T) > 8 ? kBlockedU / 2 : kBlockedU;

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
  constexpr int W = 1, NP = 2 * W + 2, R = kBlockedR, U = kBlockedUOf<T>;
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

// Shared memory of an assembler block: the entries and class values, per
// row j the class and (K1 / K4) the three factor rows, and (K3 with
// stage) the two keep planes.
enum FoldKind { kFoldFactored, kFoldMasked, kFoldRaw };

template <typename T, int R = 1>
size_t fold_smem_bytes(const FoldParamsR<R>& p, FoldKind kind) {
  if (kind == kFoldFactored) return sizeof(FoldShared<T>) + static_cast<size_t>(p.n1) * sizeof(FoldRow<T>);
  const size_t rows = sizeof(FoldShared<T, R>) + sizeof(int) * static_cast<size_t>(p.n1);
  if (kind == kFoldRaw || !p.stage) return rows;
  const size_t words = static_cast<size_t>(p.n1 + 2) * (p.n2 + 2) / 4 + 2;
  return rows + 8 * words;
}

template <int R = 1>
bool fold_params_ok(const FoldParamsR<R>& p) {
  if (p.g < 1 || p.kw < 1 || p.threads < 32 || p.threads > kFoldMaxThreads || p.threads % 32 != 0 ||
      p.g * p.kw > p.threads || p.n_pl > 65535)
    return false;
  for (int a = 0; a < 3; ++a)
    if (p.ne[a] < 1 || p.ne[a] > FoldLimits<R>::edges || p.edge[a][0] != 0) return false;
  return true;
}

template <typename T, bool STREAM>
int launch_fold_assemble_s(T* out, const int* planes, const int* ent, const T* coef, const T* fac,
                           const FoldParams& p, T s, T dv, cudaStream_t st) {
  static size_t granted[kMaxDevices] = {};
  const size_t smem = fold_smem_bytes<T>(p, kFoldFactored);
  const int e = smem_opt_in(reinterpret_cast<const void*>(fold_assemble_kernel<T, STREAM>), smem, granted);
  if (e != 0) return e;
  const dim3 grid(static_cast<unsigned int>(p.n0), static_cast<unsigned int>(p.n_pl));
  fold_assemble_kernel<T, STREAM><<<grid, p.threads, smem, st>>>(out, planes, ent, coef, fac, p, s, dv);
  return static_cast<int>(cudaGetLastError());
}

// K1's and K4's launcher; params: the FoldParams block the wrapper built
// once per table (ops/lattice_kernels.py:FoldLaunch).
template <typename T>
int launch_fold_assemble(T* out, const int* planes, const int* ent, const T* coef, const T* fac,
                         const FoldParams* p, T s, T dv, void* stream) {
  if (!fold_params_ok(*p)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p->n_pl) * p->n0 * p->n1 * p->n2 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p->stream ? launch_fold_assemble_s<T, true>(out, planes, ent, coef, fac, *p, s, dv, st)
                   : launch_fold_assemble_s<T, false>(out, planes, ent, coef, fac, *p, s, dv, st);
}

template <typename T, bool STREAM, bool STAGE>
int launch_fold_assemble_masked_s(T* out, const int* planes, const int* ent, const T* coef,
                                  const unsigned char* keep, const T* ind, const FoldParams& p, T s, T dv,
                                  cudaStream_t st) {
  static size_t granted[kMaxDevices] = {};
  const size_t smem = fold_smem_bytes<T>(p, kFoldMasked);
  const int e = smem_opt_in(reinterpret_cast<const void*>(fold_assemble_masked_kernel<T, STREAM, STAGE>), smem,
                            granted);
  if (e != 0) return e;
  const dim3 grid(static_cast<unsigned int>(p.n0), static_cast<unsigned int>(p.n_pl));
  fold_assemble_masked_kernel<T, STREAM, STAGE><<<grid, p.threads, smem, st>>>(out, planes, ent, coef, keep,
                                                                               ind, p, s, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool STREAM>
int launch_fold_assemble_masked_t(T* out, const int* planes, const int* ent, const T* coef,
                                  const unsigned char* keep, const T* ind, const FoldParams& p, T s, T dv,
                                  cudaStream_t st) {
  return p.stage ? launch_fold_assemble_masked_s<T, STREAM, true>(out, planes, ent, coef, keep, ind, p, s, dv, st)
                 : launch_fold_assemble_masked_s<T, STREAM, false>(out, planes, ent, coef, keep, ind, p, s, dv, st);
}

// K3's launcher, on the same parameter block.
template <typename T>
int launch_fold_assemble_masked(T* out, const int* planes, const int* ent, const T* coef,
                                const unsigned char* keep, const T* ind, const FoldParams* p, T s, T dv,
                                void* stream) {
  if (!fold_params_ok(*p)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p->n_pl) * p->n0 * p->n1 * p->n2 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p->stream ? launch_fold_assemble_masked_t<T, true>(out, planes, ent, coef, keep, ind, *p, s, dv, st)
                   : launch_fold_assemble_masked_t<T, false>(out, planes, ent, coef, keep, ind, *p, s, dv, st);
}

template <typename T, int R, bool STREAM>
int launch_fold_assemble_raw_s(T* out, const int* planes, const int* ent, const T* coef, const FoldParamsR<R>& p,
                               T s, cudaStream_t st) {
  static size_t granted[kMaxDevices] = {};
  const size_t smem = fold_smem_bytes<T, R>(p, kFoldRaw);
  const int e = smem_opt_in(reinterpret_cast<const void*>(fold_assemble_raw_kernel<T, R, STREAM>), smem, granted);
  if (e != 0) return e;
  const dim3 grid(static_cast<unsigned int>(p.n0), static_cast<unsigned int>(p.n_pl));
  fold_assemble_raw_kernel<T, R, STREAM><<<grid, p.threads, smem, st>>>(out, planes, ent, coef, p, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R>
int launch_fold_assemble_raw_r(T* out, const int* planes, const int* ent, const T* coef, const void* params, T s,
                               void* stream) {
  const FoldParamsR<R>& p = *static_cast<const FoldParamsR<R>*>(params);
  if (!fold_params_ok<R>(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(p.n_pl) * p.n0 * p.n1 * p.n2 == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.stream ? launch_fold_assemble_raw_s<T, R, true>(out, planes, ent, coef, p, s, st)
                  : launch_fold_assemble_raw_s<T, R, false>(out, planes, ent, coef, p, s, st);
}

// K5's launcher: params is a FoldParams block at stride r = 1 and a
// FoldParamsR<2> block at r = 2.
template <typename T>
int launch_fold_assemble_raw(T* out, const int* planes, const int* ent, const T* coef, const void* params, int r,
                             T s, void* stream) {
  switch (r) {
    case 1:
      return launch_fold_assemble_raw_r<T, 1>(out, planes, ent, coef, params, s, stream);
    case 2:
      return launch_fold_assemble_raw_r<T, 2>(out, planes, ent, coef, params, s, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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

// complex64 / complex128: data, x and y are torch's interleaved (re, im)
// tensors
int dmt_dia_matvec_c64(const void* data, const void* x, void* y, const void* params, void* stream) {
  using C = cplx<float>;
  return launch_dia_matvec<C>(static_cast<const C*>(data), static_cast<const C*>(x), static_cast<C*>(y),
                              static_cast<const DiaParams*>(params), stream);
}

int dmt_dia_matvec_c128(const void* data, const void* x, void* y, const void* params, void* stream) {
  using C = cplx<double>;
  return launch_dia_matvec<C>(static_cast<const C*>(data), static_cast<const C*>(x), static_cast<C*>(y),
                              static_cast<const DiaParams*>(params), stream);
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

int dmt_blocked_matvec_c64(const void* data, const void* x, void* y, const int* tab, const void* params,
                           void* stream) {
  using C = cplx<float>;
  return launch_blocked_matvec<C>(static_cast<const C*>(data), static_cast<const C*>(x), static_cast<C*>(y), tab,
                                  static_cast<const BlockedParams*>(params), stream);
}

int dmt_blocked_matvec_c128(const void* data, const void* x, void* y, const int* tab, const void* params,
                            void* stream) {
  using C = cplx<double>;
  return launch_blocked_matvec<C>(static_cast<const C*>(data), static_cast<const C*>(x), static_cast<C*>(y), tab,
                                  static_cast<const BlockedParams*>(params), stream);
}

// params: a FoldParams block (K1 / K4 and K3), built by the wrapper once per
// table
int dmt_fold_assemble_f32(float* out, const int* planes, const int* ent, const float* coef, const float* fac,
                          const void* params, float s, float dv, void* stream) {
  return launch_fold_assemble<float>(out, planes, ent, coef, fac, static_cast<const FoldParams*>(params), s, dv,
                                     stream);
}

int dmt_fold_assemble_f64(double* out, const int* planes, const int* ent, const double* coef,
                          const double* fac, const void* params, double s, double dv, void* stream) {
  return launch_fold_assemble<double>(out, planes, ent, coef, fac, static_cast<const FoldParams*>(params), s, dv,
                                      stream);
}

// keep: the keep stack as bytes (0 / 1), made by the wrapper once per table,
// with 8 bytes or more after its end (a staged halo plane of L bytes is read
// as L / 4 + 2 words from its start rounded down to 4 bytes)
int dmt_fold_assemble_masked_f32(float* out, const int* planes, const int* ent, const float* coef,
                                 const unsigned char* keep, const float* ind, const void* params, float s,
                                 float dv, void* stream) {
  return launch_fold_assemble_masked<float>(out, planes, ent, coef, keep, ind,
                                            static_cast<const FoldParams*>(params), s, dv, stream);
}

int dmt_fold_assemble_masked_f64(double* out, const int* planes, const int* ent, const double* coef,
                                 const unsigned char* keep, const double* ind, const void* params, double s,
                                 double dv, void* stream) {
  return launch_fold_assemble_masked<double>(out, planes, ent, coef, keep, ind,
                                             static_cast<const FoldParams*>(params), s, dv, stream);
}

// r: K5's window stride, 1 (params a FoldParams block) or 2 (FoldParamsR<2>)
int dmt_fold_assemble_raw_f32(float* out, const int* planes, const int* ent, const float* coef,
                              const void* params, int r, float s, void* stream) {
  return launch_fold_assemble_raw<float>(out, planes, ent, coef, params, r, s, stream);
}

int dmt_fold_assemble_raw_f64(double* out, const int* planes, const int* ent, const double* coef,
                              const void* params, int r, double s, void* stream) {
  return launch_fold_assemble_raw<double>(out, planes, ent, coef, params, r, s, stream);
}

}  // extern "C"
