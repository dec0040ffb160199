// Matrix-free 7-point / 27-point stencil kernels, written for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package:
//
//   st_halo_*      <- src/repro/kernels/spmv_stencil.py:177 stencil_spmv_halo
//   st_boundary_*  <- src/repro/kernels/spmv_stencil.py:221 stencil_spmv_boundary
//   st_spmv_*      <- src/repro/kernels/spmv_stencil.py:131 stencil_spmv
//   st_jacobi_*    <- src/repro/kernels/jacobi_stencil.py:56 jacobi_stencil_sweep
//
// Layout: S stacked slabs of nz planes of ny rows of nx points, row-major,
// x fastest: point (s, z, y, x) at ((s*nz + z)*ny + y)*nx + x. A halo plane
// array is (S, ny, nx). Homogeneous Dirichlet edges: x and y always, and z
// where no halo plane is given (a null halo pointer reads as a zero plane).
//
//   7pt:  y = diag*c - ax*(c[x-1] + c[x+1]) - ay*(c[y-1] + c[y+1])
//                    - az*(c[z-1] + c[z+1]),          diag = 2*(ax+ay+az)
//   27pt: s9(plane) = the 3x3 (y, x) neighbourhood sum of a plane,
//         y = 27*c - (s9(z-1) + s9(z) + s9(z+1))
//
// Bits: every output is formed by the same rounded operations in the same
// order, written with the round-to-nearest intrinsics (__dmul_rn, __dadd_rn,
// __dsub_rn; __f*_rn for float), which the compiler never contracts into an
// FMA, in the order of the JAX package's oracles (kernels/ref.py): the 7pt
// terms x, then y, then z; the 27pt s9 over dy then dx in (-1, 0, 1),
// starting from +0 and adding a zero where the neighbour falls off the grid;
// s27 = (s9(z-1) + s9(z)) + s9(z+1). So the boundary kernel's planes equal
// the march's bit for bit, whatever nvcc contracts elsewhere, and all equal
// the plain PyTorch versions (separately rounded elementwise ops in the same
// order). The coefficients arrive already rounded to the working type by the
// host.
//
// What bounds them on this card: bytes. A 7pt output costs 14 flops by the
// JAX package's count (2k) and a 27pt one 54, against 16 bytes (f64) of x
// read and y written: at most 3.4 flops per byte, far below the FP64 ridge
// of about 10. The least time is x (plus the halo planes) in and y out over
// the 3.35 TB/s of HBM3; the sweep adds b and dinv in. The TPU kernels hold
// a (bz, ny, nx) block in VMEM plus one plane from each z-neighbour.
//
// The slab product of the solvers (st_halo_*) and the single-grid product
// (st_spmv_*: S grids with zero z-edges are S slabs with null halo planes)
// are one z-march, halo_march_kernel. A one-thread-per-point design reads
// every neighbour through L1 (7 loads per point at 7pt, 27 at 27pt, where
// the same s9 plane sum is formed three times), so at 27pt the L1 load
// wavefronts, not HBM, set its pace (39-41% of the bound). Here:
//
// * A block of 128 x 2 threads owns a 128 x 8 (x, y) tile of one slab, four
//   rows per thread, and walks along z over a run of output planes, one
//   plane per step. Each plane's tile plus a one-point rim (10 x 130
//   values) goes into shared memory through a ring of three stages filled
//   by cp.async, so the next two planes are in flight while one is
//   computed. Rim points off the grid, and every point of a null halo
//   plane, are zero-filled by the copy itself (cp.async with a source size
//   of 0): the Dirichlet edges cost no branch in the arithmetic. Plane -1
//   of slab s is prev[s] and plane nz is next[s]. Each thread's copy
//   offsets are computed once, not per plane; outputs are written with
//   streaming stores.
// * Each thread reads its x/y neighbours from shared memory and keeps its
//   z-neighbours in registers: 7pt keeps c(z-2), c(z-1) and the x/y part
//   of output z-1, and finishes that output when plane z arrives; 27pt
//   computes s9 of each plane once (9 shared loads per point), keeps
//   s9(z-2), s9(z-1) and c(z-1), and writes 27c - ((s9(z-2) + s9(z-1)) +
//   s9(z)). Each x value crosses from L2 once per tile (1.27x with the
//   rim), and no plane is read again for its z-neighbours.
// * The kernel picks its own run length: it fills the card with one wave of
//   resident blocks (occupancy x SM count), splitting each tile's S*nz
//   planes into at most that many runs (a run may cross a slab edge, where
//   it restarts its march), but never into runs shorter than 20 planes, so
//   the planes re-read at run edges stay below 2/20 = 10% of x. Longer runs
//   (fewer blocks in flight), a fourth stage, and a TMA box copy per plane
//   (one thread and an mbarrier; the box must start 16-byte aligned along x)
//   all measured slower on the H100 than this.
//
// The boundary product (st_boundary_*) computes only output planes 0 and
// nz-1 of every slab (two planes per slab, one launch) and can write them
// straight into a full (S, nz, ny, nx) result: the overlapped SpMV's fix-up.
// It moves little (6 planes in and 2 out per slab: 16.8 MB, 5 us at the
// path's 4 x 64 x 256 x 256), so a launch of many short blocks pays the
// fill and drain of each wave. boundary_tile_kernel:
//
// * A block of 128 x 2 threads owns a 128 x 8 (x, y) tile of one edge
//   plane, the march's, 4 adjacent rows per thread, so a point's
//   y-neighbours are the next point's centre and come from shared memory
//   once. Compiled for 4 blocks per SM, the path's 512 tiles fit one wave
//   of 528; the launch sizes its grid to one wave (occupancy x SM count),
//   and the edge planes past it go round a grid-stride loop. 1 or 2 rows
//   per thread (more, shorter tiles) measured slower on the H100.
// * It reads plane 0 from prev[s], x[s][0], x[s][1] and plane nz-1 from
//   x[s][nz-2], x[s][nz-1], next[s]. The planes the stencil reads with a
//   one-point rim (all three at 27pt, the centre at 7pt) go into shared
//   memory through cp.async in the march's stage layout, off-grid and
//   null-plane points zero-filled by the copy, one commit group per plane;
//   at 7pt each thread loads its z-neighbours, which want no rim, straight
//   into registers (a null plane reads as zeros). Every load is issued
//   before the first wait, so all of the launch's loads are in flight
//   together; at 27pt the block then sums each plane as it arrives, in the
//   order of the sums (s9 below, the centre's, then above's), with the
//   march's staged point sums (no bounds predicate in the arithmetic), and
//   it writes with streaming stores. Staging all three planes at 7pt
//   measured slower on the H100 than this, and no faster than the
//   one-thread-per-point kernel it replaces.
//
// The sweep (st_jacobi_*) keeps the one-thread-per-point design, in
// jacobi_kernel: one thread per output point of a 32 x 8 block of one
// plane, blockIdx.z over the planes in order, so the z-neighbours a block
// reads were read by its neighbouring planes' blocks a moment before and x
// streams from HBM about once; stencil_point forms each output.
//
// 64-bit offsets throughout: one card holds side 512 (134 M points).
//
// C interface, for ctypes: pointers and the stream are void*, sizes are
// long long, coefficients are the working type, and every entry returns
// cudaGetLastError() after its launch (0 = success). Nothing here
// allocates or synchronises; the caller owns the outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32;  // block: 32 points along x ...
constexpr int kTy = 8;   // ... by 8 rows along y
constexpr long long kMaxGridZ = 65535;

template <typename T>
struct Rn;

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
};

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};

template <typename T>
struct Coef {
  T diag, ax, ay, az;  // 27pt: diag = 27, ax..az unused
};

// The 3x3 (y, x) neighbourhood sum of plane p at (iy, ix), in the oracle's
// order: dy, then dx, over (-1, 0, 1); the term of (dy, dx) is
// p[iy - dy][ix - dx], zero off the grid. A null plane sums to +0.
template <typename T>
__device__ __forceinline__ T s9(const T* __restrict__ p, long long i, int iy, int ix, int ny,
                                int nx) {
  T s = T(0);
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int yy = iy - dy, xx = ix - dx;
      const bool in = p != nullptr && yy >= 0 && yy < ny && xx >= 0 && xx < nx;
      s = Rn<T>::add(s, in ? p[i - (long long)dy * nx - dx] : T(0));
    }
  }
  return s;
}

// One output point at offset i = iy*nx + ix of its plane, from the centre
// plane c and the planes below (lo, z-1) and above (hi, z+1); a null plane
// is zero. The sweep computes its outputs here; the staged kernels repeat
// its operations, in its order, from shared memory.
template <typename T, bool S27>
__device__ __forceinline__ T stencil_point(const T* __restrict__ c, const T* __restrict__ lo,
                                           const T* __restrict__ hi, long long i, int iy, int ix,
                                           int ny, int nx, Coef<T> k) {
  using A = Rn<T>;
  if constexpr (S27) {
    const T s27 = A::add(A::add(s9(lo, i, iy, ix, ny, nx), s9(c, i, iy, ix, ny, nx)),
                         s9(hi, i, iy, ix, ny, nx));
    return A::sub(A::mul(k.diag, c[i]), s27);
  } else {
    const T xm = ix > 0 ? c[i - 1] : T(0);
    const T xp = ix < nx - 1 ? c[i + 1] : T(0);
    const T ym = iy > 0 ? c[i - nx] : T(0);
    const T yp = iy < ny - 1 ? c[i + nx] : T(0);
    const T zm = lo != nullptr ? lo[i] : T(0);
    const T zp = hi != nullptr ? hi[i] : T(0);
    T y = A::mul(k.diag, c[i]);
    y = A::sub(y, A::mul(k.ax, A::add(xm, xp)));
    y = A::sub(y, A::mul(k.ay, A::add(ym, yp)));
    y = A::sub(y, A::mul(k.az, A::add(zm, zp)));
    return y;
  }
}

// The damped sweep x + omega*dinv*(b - A x) on every plane of every grid,
// both z-edges zero.
template <typename T, bool S27>
__global__ void __launch_bounds__(kTx * kTy)
jacobi_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ dinv,
              T* __restrict__ y, long long S, long long nz, int ny, int nx, Coef<T> k, T omega) {
  const int ix = blockIdx.x * kTx + threadIdx.x;
  const int iy = blockIdx.y * kTy + threadIdx.y;
  if (ix >= nx || iy >= ny) return;
  const long long plane = (long long)ny * nx;
  const long long i = (long long)iy * nx + ix;
  for (long long q = blockIdx.z; q < S * nz; q += gridDim.z) {
    const long long z = q % nz;
    const T* c = x + q * plane;
    const T* lo = z > 0 ? c - plane : nullptr;
    const T* hi = z < nz - 1 ? c + plane : nullptr;
    const T v = stencil_point<T, S27>(c, lo, hi, i, iy, ix, ny, nx, k);
    const long long o = q * plane + i;
    y[o] = Rn<T>::add(c[i], Rn<T>::mul(Rn<T>::mul(omega, dinv[o]), Rn<T>::sub(b[o], v)));
  }
}

// ---------------------------------------------------------------------------
// The staged kernels: the z-march of st_halo_* and st_spmv_* (a 128 x 8
// (x, y) tile of one slab per block, a run of output planes per block, each
// plane's tile with its rim in a ring of shared-memory stages filled by
// cp.async) and the edge-plane tiles of st_boundary_*.

constexpr int kMx = 128;                // tile width: threads along x
constexpr int kMyT = kTx * kTy / kMx;   // threads along y
constexpr int kRows = 4;           // rows per thread, in both staged kernels
constexpr int kMy = kMyT * kRows;  // tile height
constexpr int kRimY = kMy + 2;          // a plane's tile plus a one-point rim
constexpr int kRing = 3;           // stages: one computed, up to two in flight
constexpr long long kMinRun = 20;  // shortest run: re-read planes <= 2/20 of x
static_assert(kMy >= kTy, "bad_shape's ny limit keeps the staged kernels' grid height in range");

// A stage: rows (kRimY in the march) of W = kMx + 2E values (E per 16
// bytes), each a tile row with its rim; the tile's
// points lie in columns E .. E + kMx - 1 and the rim points in columns E - 1
// and E + kMx, so a tile row starts 16-byte aligned.
template <typename T>
struct Stage {
  static constexpr int E = 16 / (int)sizeof(T);
  static constexpr int W = kMx + 2 * E;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One value into shared memory, or a zero where !valid (a source size of 0:
// the copy reads nothing and writes +0).
template <typename T>
__device__ __forceinline__ void cp_async_or_zero(T* dst, const T* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}

// A staged plane's 3x3 (y, x) neighbourhood sum at the point p points to,
// in stencil_point's order (a zero-filled rim stands for the off-grid
// neighbours).
template <typename T>
__device__ __forceinline__ T staged_s9(const T* p) {
  constexpr int W = Stage<T>::W;
  T s = T(0);
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) s = Rn<T>::add(s, p[-dy * W - dx]);
  }
  return s;
}

// The 7pt output at the staged centre-plane point p but for its z term:
// diag*c - ax*(c[x-1] + c[x+1]) - ay*(c[y-1] + c[y+1]).
template <typename T>
__device__ __forceinline__ T staged_xy7(const T* p, Coef<T> k) {
  using A = Rn<T>;
  constexpr int W = Stage<T>::W;
  const T v = A::sub(A::mul(k.diag, p[0]), A::mul(k.ax, A::add(p[-1], p[1])));
  return A::sub(v, A::mul(k.ay, A::add(p[-W], p[W])));
}

// A block's runs: the S*nz stacked output planes of its tile split evenly
// into `runs` runs, run q0..q1 for each blockIdx.z (a grid-stride loop past
// 65535). Within a run the planes of slab s form a segment [za, zb),
// marched by loading planes za-1 .. zb (-1 is prev[s], nz is next[s], a
// null one a zero plane) and writing output p-1 once plane p is in
// (p > za). Thread (tx, ty) owns the points (tx, ty + kMyT j), j < kRows.
// Resident blocks per SM it is compiled for: 3 at 7pt (78 registers), 2 at
// 27pt (its 9-point sums of 4 rows want more); tighter caps spill.
template <typename T, bool S27>
__global__ void __launch_bounds__(kTx * kTy, S27 ? 2 : 3)
halo_march_kernel(const T* __restrict__ x, const T* __restrict__ prev,
                  const T* __restrict__ next, T* __restrict__ y, long long S, long long nz,
                  int ny, int nx, long long runs, Coef<T> k) {
  using A = Rn<T>;
  constexpr int W = Stage<T>::W, E = Stage<T>::E;
  constexpr int kThreads = kMx * kMyT;
  constexpr int kCopies = (kMx + 2) * kRimY;  // values copied per plane
  constexpr int kSlots = (kCopies + kThreads - 1) / kThreads;
  __shared__ __align__(16) T ring[kRing][kRimY][W];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kMx + tx;
  const int x0 = blockIdx.x * kMx, y0 = blockIdx.y * kMy;
  const int ix = x0 + tx;
  const long long plane = (long long)ny * nx;
  const long long P = S * nz;
  // This thread's copies, rim points tid + 256j, the same in every plane:
  // their offset in the plane, and whether they lie on the grid.
  long long slot_off[kSlots];
  bool slot_in[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = j * kThreads + tid;
    const int ry = e / (kMx + 2), rx = e - ry * (kMx + 2);
    const int gy = y0 + ry - 1, gx = x0 + rx - 1;
    slot_in[j] = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
    slot_off[j] = (long long)gy * nx + gx;
  }
  for (long long run = blockIdx.z; run < runs; run += gridDim.z) {
    const long long q0 = run * P / runs, q1 = (run + 1) * P / runs;
    if (q0 >= q1) continue;  // uniform across the block
    const long long s_first = q0 / nz, z_first = q0 - s_first * nz;
    const long long s_last = (q1 - 1) / nz, z_end = q1 - s_last * nz;
    const long long steps = (q1 - q0) + 2 * (s_last - s_first + 1);
    auto za = [&](long long s) { return s == s_first ? z_first : 0LL; };
    auto zb = [&](long long s) { return s == s_last ? z_end : nz; };
    auto advance = [&](long long& s, long long& p) {
      if (p < zb(s)) {
        ++p;
      } else {
        ++s;
        p = -1;
      }
    };
    // plane p of slab s (-1: prev[s], nz: next[s]) into stage st
    auto load = [&](long long s, long long p, int st) {
      const T* src = p < 0     ? (prev != nullptr ? prev + s * plane : nullptr)
                     : p >= nz ? (next != nullptr ? next + s * plane : nullptr)
                               : x + (s * nz + p) * plane;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int e = j * kThreads + tid;
        if (e < kCopies) {
          const int ry = e / (kMx + 2);
          const bool v = src != nullptr && slot_in[j];
          cp_async_or_zero(&ring[st][ry][E - 1 + e - ry * (kMx + 2)], v ? src + slot_off[j] : x,
                           v);
        }
      }
    };
    long long ls = s_first, lp = z_first - 1;  // the next plane to load
    int lst = 0;
    for (int j = 0; j < kRing - 1; ++j) {
      if (j < steps) {
        load(ls, lp, lst);
        advance(ls, lp);
        lst = lst + 1 == kRing ? 0 : lst + 1;
      }
      cp_async_commit();
    }
    long long cs = s_first, cz = z_first - 1;  // the plane computed now
    int cst = 0;
    // 7pt: c(z-2), c(z-1) and the x/y part of output z-1; 27pt: s9(z-2),
    // s9(z-1) and c(z-1) (in c_m), for each of the thread's rows
    T c_mm[kRows], c_m[kRows], v_m[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) c_mm[j] = c_m[j] = v_m[j] = T(0);
    for (long long t = 0; t < steps; ++t) {
      cp_async_wait<kRing - 2>();  // this thread's copies of plane t are in
      __syncthreads();             // everyone's are, and the stage of plane t-1 is free
      if (t + kRing - 1 < steps) {
        load(ls, lp, lst);
        advance(ls, lp);
        lst = lst + 1 == kRing ? 0 : lst + 1;
      }
      cp_async_commit();
      const T(*sh)[W] = ring[cst];
      const bool write = cz > za(cs);  // output cz - 1 is in its segment
      const long long o = (cs * nz + cz - 1) * plane + ix;  // output plane cz - 1, column ix
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int ry = ty + j * kMyT + 1, cx = tx + E;  // the point in the stage
        const int iy = y0 + ry - 1;
        const bool w = write && ix < nx && iy < ny;
        const T c = sh[ry][cx];
        if constexpr (S27) {
          const T s9v = staged_s9(&sh[ry][cx]);
          // c_mm: s9(z-2), v_m: s9(z-1), c_m: c(z-1)
          if (w)
            __stcs(y + o + (long long)iy * nx,
                   A::sub(A::mul(k.diag, c_m[j]), A::add(A::add(c_mm[j], v_m[j]), s9v)));
          c_mm[j] = v_m[j];
          v_m[j] = s9v;
          c_m[j] = c;
        } else {
          const T v = staged_xy7(&sh[ry][cx], k);
          if (w)
            __stcs(y + o + (long long)iy * nx, A::sub(v_m[j], A::mul(k.az, A::add(c_mm[j], c))));
          c_mm[j] = c_m[j];
          c_m[j] = c;
          v_m[j] = v;
        }
      }
      advance(cs, cz);
      cst = cst + 1 == kRing ? 0 : cst + 1;
    }
    __syncthreads();  // the ring is free before the next run loads into it
  }
}

// Output planes 0 and nz-1 of every slab only (nz >= 2), a tile of one
// edge plane per block: edge q = 2s + last of slab s (a grid-stride loop
// past 65535). Plane 0 reads prev[s], x[s][0], x[s][1]; plane nz-1 reads
// x[s][nz-2], x[s][nz-1], next[s]. Slab s's two planes land at y +
// (s*y_planes + {0, y_last})*plane: (S, 2, ny, nx) with y_planes = 2,
// y_last = 1, or planes 0 and nz-1 of a full (S, nz, ny, nx) result with
// y_planes = nz, y_last = nz-1. A block's tile is the march's, 128 x 8, in
// its stage layout; thread (tx, ty) owns the kRows adjacent points (tx,
// ty kRows + j), j < kRows, so the rows it reads for one point's
// y-neighbours are the next point's centre and are loaded from shared
// memory once. Compiled for 4 resident blocks per SM (at most 64 registers;
// uncapped, 7pt takes more and only 3 fit), so the path's 512 tiles fit one
// wave of 528.
template <typename T, bool S27>
__global__ void __launch_bounds__(kTx * kTy, 4)
boundary_tile_kernel(const T* __restrict__ x, const T* __restrict__ prev,
                     const T* __restrict__ next, T* __restrict__ y, long long S, long long nz,
                     int ny, int nx, long long y_planes, long long y_last, Coef<T> k) {
  using A = Rn<T>;
  constexpr int W = Stage<T>::W, E = Stage<T>::E;
  constexpr int kThreads = kMx * kMyT;
  constexpr int kStaged = S27 ? 3 : 1;  // 27pt: below, centre, above; 7pt: the centre
  constexpr int kCopies = (kMx + 2) * kRimY;  // values per staged plane, with the rim
  __shared__ __align__(16) T stage[kStaged][kRimY][W];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kMx + tx;
  const int x0 = blockIdx.x * kMx, y0 = blockIdx.y * kMy;
  const int ix = x0 + tx, r0 = ty * kRows + 1;  // r0: the stage row of the first point
  const long long plane = (long long)ny * nx;
  for (long long q = blockIdx.z; q < 2 * S; q += gridDim.z) {
    const long long s = q >> 1;
    const bool last = q & 1;
    const T* c = x + (s * nz + (last ? nz - 1 : 0)) * plane;
    const T* const lo = last ? c - plane : (prev != nullptr ? prev + s * plane : nullptr);
    const T* const hi = last ? (next != nullptr ? next + s * plane : nullptr) : c + plane;
    // 7pt: the z-neighbours, which want no rim, straight into registers
    T zlo[kRows], zhi[kRows];
    if constexpr (!S27) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int iy = y0 + r0 + j - 1;
        const bool in = ix < nx && iy < ny;
        const long long o = (long long)iy * nx + ix;
        zlo[j] = in && lo != nullptr ? __ldg(lo + o) : T(0);
        zhi[j] = in && hi != nullptr ? __ldg(hi + o) : T(0);
      }
    }
    // the staged planes with their rim, one commit group each, in the
    // order the sums take them
#pragma unroll
    for (int p = 0; p < kStaged; ++p) {
      const T* const src = !S27 || p == 1 ? c : p == 0 ? lo : hi;
      T* const st = &stage[p][0][E - 1];
      for (int e = tid; e < kCopies; e += kThreads) {
        const int r = e / (kMx + 2), cc = e - r * (kMx + 2);
        const int gy = y0 + r - 1, gx = x0 + cc - 1;
        const bool v = src != nullptr && gy >= 0 && gy < ny && gx >= 0 && gx < nx;
        cp_async_or_zero(st + r * W + cc, v ? src + (long long)gy * nx + gx : x, v);
      }
      cp_async_commit();
    }
    T part[kRows];  // the outputs (27pt: first the partial z-sums)
    if constexpr (S27) {
      cp_async_wait<2>();
      __syncthreads();  // the plane below is in
#pragma unroll
      for (int j = 0; j < kRows; ++j) part[j] = staged_s9(&stage[0][r0 + j][tx + E]);
      cp_async_wait<1>();
      __syncthreads();  // the centre plane is in
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        part[j] = A::add(part[j], staged_s9(&stage[1][r0 + j][tx + E]));
      cp_async_wait<0>();
      __syncthreads();  // the plane above is in
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        part[j] = A::sub(A::mul(k.diag, stage[1][r0 + j][tx + E]),
                         A::add(part[j], staged_s9(&stage[2][r0 + j][tx + E])));
    } else {
      cp_async_wait<0>();
      __syncthreads();  // the centre plane is in
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        part[j] = A::sub(staged_xy7(&stage[0][r0 + j][tx + E], k),
                         A::mul(k.az, A::add(zlo[j], zhi[j])));
    }
    T* const yq = y + (s * y_planes + (last ? y_last : 0)) * plane + ix;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int iy = y0 + r0 + j - 1;
      if (ix >= nx || iy >= ny) break;
      __stcs(yq + (long long)iy * nx, part[j]);
    }
    __syncthreads();  // the stages are free before the next edge loads into them
  }
}

bool bad_shape(long long S, long long nz, long long ny, long long nx) {
  return S < 0 || nz < 1 || ny < 1 || nx < 1 || ny > kTy * 65535LL || nx > 0x7fffffffLL;
}

dim3 grid_for(long long planes, long long ny, long long nx) {
  return dim3((unsigned)((nx + kTx - 1) / kTx), (unsigned)((ny + kTy - 1) / kTy),
              (unsigned)(planes < kMaxGridZ ? planes : kMaxGridZ));
}

template <typename T>
int launch_jacobi(const void* x, const void* b, const void* dinv, void* y, long long S,
                  long long nz, long long ny, long long nx, int s27, Coef<T> k, T omega,
                  void* stream) {
  if (bad_shape(S, nz, ny, nx)) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const dim3 grid = grid_for(S * nz, ny, nx);
  const dim3 block(kTx, kTy);
  cudaStream_t st = (cudaStream_t)stream;
  const T *xp = (const T*)x, *bp = (const T*)b, *dp = (const T*)dinv;
  T* yp = (T*)y;
  if (s27) {
    jacobi_kernel<T, true><<<grid, block, 0, st>>>(xp, bp, dp, yp, S, nz, (int)ny, (int)nx, k,
                                                   omega);
  } else {
    jacobi_kernel<T, false><<<grid, block, 0, st>>>(xp, bp, dp, yp, S, nz, (int)ny, (int)nx, k,
                                                    omega);
  }
  return (int)cudaGetLastError();
}

// Resident blocks of `kernel` per SM (its caller asks once per instantiation).
template <typename K>
int blocks_per_sm(K kernel, int threads) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, 0) != cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

// The card's SMs, asked once (the launch shape only, never the result,
// depends on it).
int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 1;
  }();
  return n;
}

template <typename T, bool S27>
int launch_march(const T* x, const T* prev, const T* next, T* y, long long S, long long nz,
                 long long ny, long long nx, Coef<T> k, cudaStream_t st) {
  static const int per_sm = blocks_per_sm(halo_march_kernel<T, S27>, kTx * kTy);
  const int sms = sm_count();
  const long long gx = (nx + kMx - 1) / kMx, gy = (ny + kMy - 1) / kMy;
  const long long P = S * nz;
  // one wave of resident blocks, runs no shorter than kMinRun planes
  long long runs = (long long)per_sm * sms / (gx * gy);
  runs = runs < 1 ? 1 : runs;
  runs = runs < 1 + P / kMinRun ? runs : 1 + P / kMinRun;
  runs = runs < P ? runs : P;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)(runs < kMaxGridZ ? runs : kMaxGridZ));
  halo_march_kernel<T, S27><<<grid, dim3(kMx, kMyT), 0, st>>>(x, prev, next, y, S, nz, (int)ny,
                                                             (int)nx, runs, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_halo(const void* x, const void* prev, const void* next, void* y, long long S,
                long long nz, long long ny, long long nx, int s27, Coef<T> k, void* stream) {
  if (bad_shape(S, nz, ny, nx)) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const T *xp = (const T*)x, *pp = (const T*)prev, *np = (const T*)next;
  cudaStream_t st = (cudaStream_t)stream;
  if (s27) return launch_march<T, true>(xp, pp, np, (T*)y, S, nz, ny, nx, k, st);
  return launch_march<T, false>(xp, pp, np, (T*)y, S, nz, ny, nx, k, st);
}

template <typename T, bool S27>
int launch_edges(const T* x, const T* prev, const T* next, T* y, long long S, long long nz,
                 long long ny, long long nx, long long y_planes, long long y_last, Coef<T> k,
                 cudaStream_t st) {
  static const int per_sm = blocks_per_sm(boundary_tile_kernel<T, S27>, kTx * kTy);
  const long long gx = (nx + kMx - 1) / kMx, gy = (ny + kMy - 1) / kMy;
  // one wave of resident blocks; the edges past it go round the grid-stride loop
  long long edges = (long long)per_sm * sm_count() / (gx * gy);
  edges = edges < 1 ? 1 : edges;
  edges = edges < 2 * S ? edges : 2 * S;
  edges = edges < kMaxGridZ ? edges : kMaxGridZ;
  boundary_tile_kernel<T, S27><<<dim3((unsigned)gx, (unsigned)gy, (unsigned)edges),
                                 dim3(kMx, kMyT), 0, st>>>(x, prev, next, y, S, nz, (int)ny,
                                                           (int)nx, y_planes, y_last, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_boundary(const void* x, const void* prev, const void* next, void* y, long long S,
                    long long nz, long long ny, long long nx, long long y_planes,
                    long long y_last, int s27, Coef<T> k, void* stream) {
  if (bad_shape(S, nz, ny, nx) || nz < 2 || y_last < 1 || y_planes <= y_last)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const T *xp = (const T*)x, *pp = (const T*)prev, *np = (const T*)next;
  cudaStream_t st = (cudaStream_t)stream;
  if (s27) return launch_edges<T, true>(xp, pp, np, (T*)y, S, nz, ny, nx, y_planes, y_last, k, st);
  return launch_edges<T, false>(xp, pp, np, (T*)y, S, nz, ny, nx, y_planes, y_last, k, st);
}

}  // namespace

extern "C" {

#define ST_ENTRIES(SUF, T)                                                                      \
  int st_spmv_##SUF(const void* x, void* y, long long S, long long nz, long long ny,           \
                    long long nx, int s27, T diag, T ax, T ay, T az, void* stream) {            \
    return launch_halo<T>(x, nullptr, nullptr, y, S, nz, ny, nx, s27,                         \
                          Coef<T>{diag, ax, ay, az}, stream);                                   \
  }                                                                                             \
  int st_halo_##SUF(const void* x, const void* prev, const void* next, void* y, long long S,   \
                    long long nz, long long ny, long long nx, int s27, T diag, T ax, T ay,     \
                    T az, void* stream) {                                                       \
    return launch_halo<T>(x, prev, next, y, S, nz, ny, nx, s27, Coef<T>{diag, ax, ay, az},    \
                          stream);                                                              \
  }                                                                                             \
  int st_boundary_##SUF(const void* x, const void* prev, const void* next, void* y,            \
                        long long S, long long nz, long long ny, long long nx,                 \
                        long long y_planes, long long y_last, int s27, T diag, T ax, T ay,     \
                        T az, void* stream) {                                                   \
    return launch_boundary<T>(x, prev, next, y, S, nz, ny, nx, y_planes, y_last, s27,          \
                              Coef<T>{diag, ax, ay, az}, stream);                               \
  }                                                                                             \
  int st_jacobi_##SUF(const void* x, const void* b, const void* dinv, void* y, long long S,     \
                      long long nz, long long ny, long long nx, int s27, T diag, T ax, T ay,   \
                      T az, T omega, void* stream) {                                            \
    return launch_jacobi<T>(x, b, dinv, y, S, nz, ny, nx, s27, Coef<T>{diag, ax, ay, az},      \
                            omega, stream);                                                     \
  }

ST_ENTRIES(f32, float)
ST_ENTRIES(f64, double)

#undef ST_ENTRIES

}  // extern "C"
