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
// One __device__ point function, stencil_point, computes every output of
// the slab, boundary and sweep kernels, from the centre plane and the planes
// below and above; the z-march of st_halo_* repeats its operations from
// shared memory and registers. The arithmetic is written with the
// round-to-nearest intrinsics (__dmul_rn, __dadd_rn, __dsub_rn; __f*_rn for
// float), which the compiler never contracts into an FMA, in the order of
// the JAX package's oracles (kernels/ref.py): the 7pt terms x, then y, then
// z; the 27pt s9 over dy then dx in (-1, 0, 1), starting from +0 and adding
// a zero where the neighbour falls off the grid; s27 = (s9(z-1) + s9(z)) +
// s9(z+1). So the boundary kernel's planes equal the march's bit for bit,
// whatever nvcc contracts elsewhere, and all equal the plain PyTorch
// versions (separately rounded elementwise ops in the same order). The
// coefficients arrive already rounded to the working type by the host.
//
// What bounds them on this card: bytes. A 7pt output costs 14 flops by the
// JAX package's count (2k) and a 27pt one 54, against 16 bytes (f64) of x
// read and y written: at most 3.4 flops per byte, far below the FP64 ridge
// of about 10. The least time is x (plus the halo planes) in and y out over
// the 3.35 TB/s of HBM3; the sweep adds b and dinv in. The TPU kernels hold
// a (bz, ny, nx) block in VMEM plus one plane from each z-neighbour.
//
// The slab product of the solvers (st_halo_*) is a z-march,
// halo_march_kernel. The one-thread-per-point design it replaces reads every
// neighbour through L1 (7 loads per point at 7pt, 27 at 27pt, where the
// same s9 plane sum is formed three times), so at 27pt the L1 load
// wavefronts, not HBM, set its pace (39% of the bound). Here:
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
// * Bits: every output is formed by the rounded operations of stencil_point
//   in its order (the 7pt z term last, s9 over dy then dx from +0 with a
//   zero for each off-grid neighbour, the three s9 summed (z-1 + z) + z+1),
//   so the march equals the slab kernel, the boundary kernel's planes and
//   the plain versions bit for bit.
//
// The other three kernels keep the one-thread-per-point design:
//
// * One thread per output point, a block of 32 x 8 points of one plane: a
//   warp reads 32 neighbouring x values (coalesced), and the x-1/x+1,
//   y-1/y+1 reads of the block hit the same lines in L1.
// * Blocks run plane by plane (blockIdx.z over the S*nz output planes, in
//   order), so the planes z-1 and z+1 a block reads were read by the blocks
//   of the neighbouring planes a moment before or after: a few planes (0.5
//   MB each at 256 x 256 in f64) in flight stay in the 50 MB L2, and x
//   streams from HBM about once.
// * The boundary kernel computes only output planes 0 and nz-1 of every
//   shard (two planes per shard, one launch), and can write them straight
//   into a full (S, nz, ny, nx) result: the overlapped SpMV's fix-up.
// * 64-bit offsets throughout: one card holds side 512 (134 M points).
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
// is zero. Every kernel below computes its outputs here.
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

// Every plane of every grid, both z-edges zero (the single-grid SpMV).
// kJacobi turns the product into the damped sweep x + omega*dinv*(b - A x).
template <typename T, bool S27, bool kJacobi>
__global__ void __launch_bounds__(kTx * kTy)
slab_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ dinv,
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
    if constexpr (kJacobi) {
      y[o] = Rn<T>::add(c[i], Rn<T>::mul(Rn<T>::mul(omega, dinv[o]), Rn<T>::sub(b[o], v)));
    } else {
      y[o] = v;
    }
  }
}

// Output planes 0 and nz-1 of every slab only (nz >= 2): plane 0 from
// prev[s], x[s][0], x[s][1]; plane nz-1 from x[s][nz-2], x[s][nz-1],
// next[s]. Slab s's two planes land at y + (s*y_planes + {0, y_last})*plane:
// (S, 2, ny, nx) with y_planes = 2, y_last = 1, or planes 0 and nz-1 of a
// full (S, nz, ny, nx) result with y_planes = nz, y_last = nz-1.
template <typename T, bool S27>
__global__ void __launch_bounds__(kTx * kTy)
boundary_kernel(const T* __restrict__ x, const T* __restrict__ prev, const T* __restrict__ next,
                T* __restrict__ y, long long S, long long nz, int ny, int nx,
                long long y_planes, long long y_last, Coef<T> k) {
  const int ix = blockIdx.x * kTx + threadIdx.x;
  const int iy = blockIdx.y * kTy + threadIdx.y;
  if (ix >= nx || iy >= ny) return;
  const long long plane = (long long)ny * nx;
  const long long i = (long long)iy * nx + ix;
  for (long long q = blockIdx.z; q < S * 2; q += gridDim.z) {
    const long long s = q >> 1;
    const bool last = q & 1;
    const T* c = x + (s * nz + (last ? nz - 1 : 0)) * plane;
    const T* lo = last ? c - plane : (prev != nullptr ? prev + s * plane : nullptr);
    const T* hi = last ? (next != nullptr ? next + s * plane : nullptr) : c + plane;
    y[(s * y_planes + (last ? y_last : 0)) * plane + i] =
        stencil_point<T, S27>(c, lo, hi, i, iy, ix, ny, nx, k);
  }
}

// ---------------------------------------------------------------------------
// The z-march of st_halo_*: a 32 x 8 (x, y) tile of one slab per block, a
// run of output planes per block, each plane's tile with its rim in a ring
// of shared-memory stages filled by cp.async.

constexpr int kMx = 128;                // tile width: threads along x
constexpr int kMyT = kTx * kTy / kMx;   // threads along y
constexpr int kMarchRows = 4;           // rows per thread
constexpr int kMy = kMyT * kMarchRows;  // tile height
constexpr int kRimY = kMy + 2;          // a plane's tile plus a one-point rim
constexpr int kRing = 3;           // stages: one computed, up to two in flight
constexpr long long kMinRun = 20;  // shortest run: re-read planes <= 2/20 of x
static_assert(kMy >= kTy, "bad_shape's ny limit keeps the march's grid height in range");

// A stage: kRimY rows of W = kMx + 2E values (E per 16 bytes); the tile's
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

// A block's runs: the S*nz stacked output planes of its tile split evenly
// into `runs` runs, run q0..q1 for each blockIdx.z (a grid-stride loop past
// 65535). Within a run the planes of slab s form a segment [za, zb),
// marched by loading planes za-1 .. zb (-1 is prev[s], nz is next[s], a
// null one a zero plane) and writing output p-1 once plane p is in
// (p > za). Thread (tx, ty) owns the points (tx, ty + kMyT j), j < kMarchRows.
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
    T c_mm[kMarchRows], c_m[kMarchRows], v_m[kMarchRows];
#pragma unroll
    for (int j = 0; j < kMarchRows; ++j) c_mm[j] = c_m[j] = v_m[j] = T(0);
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
      for (int j = 0; j < kMarchRows; ++j) {
        const int ry = ty + j * kMyT + 1, cx = tx + E;  // the point in the stage
        const int iy = y0 + ry - 1;
        const bool w = write && ix < nx && iy < ny;
        const T c = sh[ry][cx];
        if constexpr (S27) {
          T s9v = T(0);
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) s9v = A::add(s9v, sh[ry - dy][cx - dx]);
          }
          // c_mm: s9(z-2), v_m: s9(z-1), c_m: c(z-1)
          if (w)
            __stcs(y + o + (long long)iy * nx,
                   A::sub(A::mul(k.diag, c_m[j]), A::add(A::add(c_mm[j], v_m[j]), s9v)));
          c_mm[j] = v_m[j];
          v_m[j] = s9v;
          c_m[j] = c;
        } else {
          T v = A::mul(k.diag, c);
          v = A::sub(v, A::mul(k.ax, A::add(sh[ry][cx - 1], sh[ry][cx + 1])));
          v = A::sub(v, A::mul(k.ay, A::add(sh[ry - 1][cx], sh[ry + 1][cx])));
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

bool bad_shape(long long S, long long nz, long long ny, long long nx) {
  return S < 0 || nz < 1 || ny < 1 || nx < 1 || ny > kTy * 65535LL || nx > 0x7fffffffLL;
}

dim3 grid_for(long long planes, long long ny, long long nx) {
  return dim3((unsigned)((nx + kTx - 1) / kTx), (unsigned)((ny + kTy - 1) / kTy),
              (unsigned)(planes < kMaxGridZ ? planes : kMaxGridZ));
}

template <typename T, bool kJacobi>
int launch_slab(const void* x, const void* b, const void* dinv, void* y, long long S,
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
    slab_kernel<T, true, kJacobi><<<grid, block, 0, st>>>(xp, bp, dp, yp, S, nz, (int)ny,
                                                         (int)nx, k, omega);
  } else {
    slab_kernel<T, false, kJacobi><<<grid, block, 0, st>>>(xp, bp, dp, yp, S, nz, (int)ny,
                                                          (int)nx, k, omega);
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

template <typename T>
int launch_boundary(const void* x, const void* prev, const void* next, void* y, long long S,
                    long long nz, long long ny, long long nx, long long y_planes,
                    long long y_last, int s27, Coef<T> k, void* stream) {
  if (bad_shape(S, nz, ny, nx) || nz < 2 || y_last < 1 || y_planes <= y_last)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const dim3 grid = grid_for(S * 2, ny, nx);
  const dim3 block(kTx, kTy);
  cudaStream_t st = (cudaStream_t)stream;
  if (s27) {
    boundary_kernel<T, true><<<grid, block, 0, st>>>(
        (const T*)x, (const T*)prev, (const T*)next, (T*)y, S, nz, (int)ny, (int)nx, y_planes,
        y_last, k);
  } else {
    boundary_kernel<T, false><<<grid, block, 0, st>>>(
        (const T*)x, (const T*)prev, (const T*)next, (T*)y, S, nz, (int)ny, (int)nx, y_planes,
        y_last, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define ST_ENTRIES(SUF, T)                                                                      \
  int st_spmv_##SUF(const void* x, void* y, long long S, long long nz, long long ny,           \
                    long long nx, int s27, T diag, T ax, T ay, T az, void* stream) {            \
    return launch_slab<T, false>(x, nullptr, nullptr, y, S, nz, ny, nx, s27,                  \
                                 Coef<T>{diag, ax, ay, az}, T(0), stream);                     \
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
    return launch_slab<T, true>(x, b, dinv, y, S, nz, ny, nx, s27, Coef<T>{diag, ax, ay, az},  \
                                omega, stream);                                                 \
  }

ST_ENTRIES(f32, float)
ST_ENTRIES(f64, double)

#undef ST_ENTRIES

}  // extern "C"
