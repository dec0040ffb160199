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
// One __device__ point function, stencil_point, computes every output of all
// four kernels, from the centre plane and the planes below and above. Its
// arithmetic is written with the round-to-nearest intrinsics (__dmul_rn,
// __dadd_rn, __dsub_rn; __f*_rn for float), which the compiler never
// contracts into an FMA, in the order of the JAX package's oracles
// (kernels/ref.py): the 7pt terms x, then y, then z; the 27pt s9 over dy
// then dx in (-1, 0, 1), starting from +0 and adding a zero where the
// neighbour falls off the grid; s27 = (s9(z-1) + s9(z)) + s9(z+1). So the
// boundary kernel's planes equal the slab kernel's bit for bit, whatever
// nvcc contracts elsewhere, and both equal the plain PyTorch versions
// (separately rounded elementwise ops in the same order). The coefficients
// arrive already rounded to the working type by the host.
//
// What bounds them on this card: bytes. A 7pt output costs 14 flops by the
// JAX package's count (2k) and a 27pt one 54, against 16 bytes (f64) of x
// read and y written: at most 3.4 flops per byte, far below the FP64 ridge
// of about 10. The least time is x (plus the halo planes) in and y out over
// the 3.35 TB/s of HBM3; the sweep adds b and dinv in. The TPU kernels hold
// a (bz, ny, nx) block in VMEM plus one plane from each z-neighbour; here:
//
// * One thread per output point, a block of 32 x 8 points of one plane: a
//   warp reads 32 neighbouring x values (coalesced), and the x-1/x+1,
//   y-1/y+1 reads of the block hit the same lines in L1. No shared-memory
//   tiling yet.
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

// Every plane of every slab. With kHalo, plane 0 of slab s reads prev[s]
// below it and plane nz-1 reads next[s] above it (either may be null: a
// zero plane); without, both z-edges are zero (the single-grid SpMV).
// kJacobi turns the product into the damped sweep x + omega*dinv*(b - A x).
template <typename T, bool S27, bool kHalo, bool kJacobi>
__global__ void __launch_bounds__(kTx * kTy)
slab_kernel(const T* __restrict__ x, const T* __restrict__ prev, const T* __restrict__ next,
            const T* __restrict__ b, const T* __restrict__ dinv, T* __restrict__ y, long long S,
            long long nz, int ny, int nx, Coef<T> k, T omega) {
  const int ix = blockIdx.x * kTx + threadIdx.x;
  const int iy = blockIdx.y * kTy + threadIdx.y;
  if (ix >= nx || iy >= ny) return;
  const long long plane = (long long)ny * nx;
  const long long i = (long long)iy * nx + ix;
  for (long long q = blockIdx.z; q < S * nz; q += gridDim.z) {
    const long long s = q / nz;
    const long long z = q - s * nz;
    const T* c = x + q * plane;
    const T* lo = z > 0 ? c - plane : (kHalo && prev != nullptr ? prev + s * plane : nullptr);
    const T* hi = z < nz - 1 ? c + plane : (kHalo && next != nullptr ? next + s * plane : nullptr);
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

bool bad_shape(long long S, long long nz, long long ny, long long nx) {
  return S < 0 || nz < 1 || ny < 1 || nx < 1 || ny > kTy * 65535LL || nx > 0x7fffffffLL;
}

dim3 grid_for(long long planes, long long ny, long long nx) {
  return dim3((unsigned)((nx + kTx - 1) / kTx), (unsigned)((ny + kTy - 1) / kTy),
              (unsigned)(planes < kMaxGridZ ? planes : kMaxGridZ));
}

template <typename T, bool kHalo, bool kJacobi>
int launch_slab(const void* x, const void* prev, const void* next, const void* b,
                const void* dinv, void* y, long long S, long long nz, long long ny, long long nx,
                int s27, Coef<T> k, T omega, void* stream) {
  if (bad_shape(S, nz, ny, nx)) return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaGetLastError();
  const dim3 grid = grid_for(S * nz, ny, nx);
  const dim3 block(kTx, kTy);
  cudaStream_t st = (cudaStream_t)stream;
  const T *xp = (const T*)x, *pp = (const T*)prev, *np = (const T*)next;
  const T *bp = (const T*)b, *dp = (const T*)dinv;
  T* yp = (T*)y;
  if (s27) {
    slab_kernel<T, true, kHalo, kJacobi><<<grid, block, 0, st>>>(
        xp, pp, np, bp, dp, yp, S, nz, (int)ny, (int)nx, k, omega);
  } else {
    slab_kernel<T, false, kHalo, kJacobi><<<grid, block, 0, st>>>(
        xp, pp, np, bp, dp, yp, S, nz, (int)ny, (int)nx, k, omega);
  }
  return (int)cudaGetLastError();
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
    return launch_slab<T, false, false>(x, nullptr, nullptr, nullptr, nullptr, y, S, nz, ny,   \
                                        nx, s27, Coef<T>{diag, ax, ay, az}, T(0), stream);     \
  }                                                                                             \
  int st_halo_##SUF(const void* x, const void* prev, const void* next, void* y, long long S,   \
                    long long nz, long long ny, long long nx, int s27, T diag, T ax, T ay,     \
                    T az, void* stream) {                                                       \
    return launch_slab<T, true, false>(x, prev, next, nullptr, nullptr, y, S, nz, ny, nx, s27, \
                                       Coef<T>{diag, ax, ay, az}, T(0), stream);               \
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
    return launch_slab<T, false, true>(x, nullptr, nullptr, b, dinv, y, S, nz, ny, nx, s27,    \
                                       Coef<T>{diag, ax, ay, az}, omega, stream);              \
  }

ST_ENTRIES(f32, float)
ST_ENTRIES(f64, double)

#undef ST_ENTRIES

}  // extern "C"
