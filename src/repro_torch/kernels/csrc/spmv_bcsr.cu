// Block-CSR SpMV and SpMM of the BCSR interior, written for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package:
//
//   bs_spmv_*  <- src/repro/kernels/spmv_bcsr.py:39 bcsr_spmv
//   bs_spmm_*  <- src/repro/kernels/spmv_bcsr.py:80 bcsr_spmm
//
// Layout: the uniform blocks-per-row BCSR of core/sparse.pack_bcsr, stacked
// over S shards. Block-row i of shard s owns the bpr dense (br, bc) tiles
// blocks[s][i*bpr + k], k < bpr, row-major, with block-column ids
// bcol[s][i*bpr + k]; padding tiles are zero with bcol = 0. x is (S, R_in) or
// (S, R_in, r) row-major; y is (S, n_out) or (S, n_out, r).
//
//   y[s][i*br + a](, c) = sum_k sum_j blocks[s][i*bpr + k][a][j]
//                                   * x[s][bcol[s][i*bpr + k]*bc + j](, c)
//
// Rows at or past n_out are not written; x entries at or past R_in read as
// zero (the zero padding of the TPU kernel's x tiles), so the ragged last
// block-row and block-column need no host-side padding copy.
//
// What bounds them on this card: bytes. A tile's br*bc values are each used
// in one multiply-add per right-hand side (2 flops per 8 bytes in f64 at
// r = 1, 2r per 8 bytes for the SpMM), far below the FP64 ridge of about 10
// flops per byte, so the least time is the tiles, the block ids, x and y
// over the 3.35 TB/s of HBM3. The TPU kernel walks a sequential grid
// (block-row x bpr) and accumulates each output tile in VMEM across it;
// here one thread owns one output and loops over its block-row's tiles:
//
// * One kernel for both: the SpMV is the SpMM with r = 1. Thread t of shard
//   s (grid (ceil(n_out*r / 256), S)) owns output row t / r, right-hand side
//   t % r, and sums tile row a of its block-row's bpr tiles against their x
//   tiles, in a fixed order (tiles, then the tile's columns), so the same
//   inputs give the same bits on every run: no atomics, no reduction across
//   threads.
// * Neighbouring threads share work: the r threads of one row read the same
//   tile row (a broadcast) and consecutive x entries; the br rows of one
//   block-row read one contiguous tile, and the tiles of a block-row lie
//   next to each other. Tile rows are read as 16-byte vectors where the
//   tile width allows it, so the tiles, the bulk of the bytes, stream from
//   memory once.
// * Compile-time tiles: the kernel is instantiated for square tiles of 2,
//   3, 4, 8 and 16 (every loop over a tile row unrolled, no division by a
//   run-time width) and once for run-time br, bc up to 16.
// * x is gathered tile by tile through L1/L2 (a block-row's tiles reach
//   bpr block columns); on banded matrices the x tiles of neighbouring
//   block-rows overlap, so most of those reads hit L2.
//
// Tiles up to 16 x 16 (the CLI's --block); the wrapper raises above that.
//
// C interface, for ctypes: pointers and the stream are void*, sizes are
// long long, and every entry returns cudaGetLastError() after its launch
// (0 = success). Nothing here allocates or synchronises; the caller owns
// the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 16;  // largest br and bc

// Row j..j+BC of a tile (16-byte aligned when BC allows a vector load: the
// tile array starts on an allocation and every tile and tile row spans a
// multiple of the vector width).
template <typename T, int BC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, T (&v)[BC]) {
  if constexpr (sizeof(T) == 8 && BC % 2 == 0) {
#pragma unroll
    for (int j = 0; j < BC; j += 2) {
      const double2 d = *reinterpret_cast<const double2*>(p + j);
      v[j] = d.x;
      v[j + 1] = d.y;
    }
  } else if constexpr (sizeof(T) == 4 && BC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < BC; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < BC; ++j) v[j] = p[j];
  }
}

// Compile-time square tiles (B > 0).
template <typename T, int B>
__global__ void __launch_bounds__(kThreads)
bcsr_tile_kernel(const T* __restrict__ blocks, const int* __restrict__ bcol,
                 const T* __restrict__ x, T* __restrict__ y, int NB, int bpr, int r,
                 long long R_in, long long n_out) {
  const long long s = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;  // n_out * r < 2^31
  if (t >= n_out * r) return;
  const int row = r == 1 ? t : t / r;
  const int c = t - row * r;
  const int brow = row / B;
  const int a = row - brow * B;
  const long long tile0 = (s * NB + brow) * (long long)bpr;
  const T* __restrict__ arow = blocks + tile0 * (B * B) + a * B;
  const int* __restrict__ ids = bcol + tile0;
  const T* __restrict__ xs = x + s * R_in * r + c;
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k < bpr; ++k) {
    T v[B];
    load_row<T, B>(arow + (long long)k * (B * B), v);
    const long long c0 = (long long)ids[k] * B;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const T xv = c0 + j < R_in ? xs[(c0 + j) * r] : T(0);
      acc += v[j] * xv;
    }
  }
  y[(s * n_out + row) * r + c] = acc;
}

// Run-time tiles, any br, bc up to kMaxDim.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bcsr_any_kernel(const T* __restrict__ blocks, const int* __restrict__ bcol,
                const T* __restrict__ x, T* __restrict__ y, int NB, int bpr, int br, int bc,
                int r, long long R_in, long long n_out) {
  const long long s = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;  // n_out * r < 2^31
  if (t >= n_out * r) return;
  const int row = r == 1 ? t : t / r;
  const int c = t - row * r;
  const int brow = row / br;
  const int a = row - brow * br;
  const int E = br * bc;
  const long long tile0 = (s * NB + brow) * (long long)bpr;
  const T* __restrict__ arow = blocks + tile0 * E + a * bc;
  const int* __restrict__ ids = bcol + tile0;
  const T* __restrict__ xs = x + s * R_in * r + c;
  T acc = T(0);
  for (int k = 0; k < bpr; ++k) {
    const T* __restrict__ p = arow + (long long)k * E;
    const long long c0 = (long long)ids[k] * bc;
    for (int j = 0; j < bc; ++j) {
      const T xv = c0 + j < R_in ? xs[(c0 + j) * r] : T(0);
      acc += p[j] * xv;
    }
  }
  y[(s * n_out + row) * r + c] = acc;
}

bool bad_args(long long S, long long NB, int bpr, int br, int bc, int r, long long R_in,
              long long n_out) {
  return S < 0 || S > 65535 || NB < 1 || NB > 0x7fffffffLL || bpr < 1 || br < 1 ||
         br > kMaxDim || bc < 1 || bc > kMaxDim || r < 1 || R_in < 0 || n_out < 0 ||
         n_out > NB * br || n_out * r > 0x7fffffffLL;
}

template <typename T>
int launch(const void* blocks, const void* bcol, const void* x, void* y, long long S,
           long long NB, int bpr, int br, int bc, int r, long long R_in, long long n_out,
           void* stream) {
  if (bad_args(S, NB, bpr, br, bc, r, R_in, n_out)) return (int)cudaErrorInvalidValue;
  if (S == 0 || n_out == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n_out * r + kThreads - 1) / kThreads), (unsigned)S);
  cudaStream_t st = (cudaStream_t)stream;
  const T* b = (const T*)blocks;
  const int* ids = (const int*)bcol;
  const T* xv = (const T*)x;
  T* yv = (T*)y;
  const int nb = (int)NB;
  if (br == bc && br == 2) {
    bcsr_tile_kernel<T, 2><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, r, R_in, n_out);
  } else if (br == bc && br == 3) {
    bcsr_tile_kernel<T, 3><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, r, R_in, n_out);
  } else if (br == bc && br == 4) {
    bcsr_tile_kernel<T, 4><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, r, R_in, n_out);
  } else if (br == bc && br == 8) {
    bcsr_tile_kernel<T, 8><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, r, R_in, n_out);
  } else if (br == bc && br == 16) {
    bcsr_tile_kernel<T, 16><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, r, R_in, n_out);
  } else {
    bcsr_any_kernel<T><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, br, bc, r, R_in,
                                                   n_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bs_spmv_f32(const void* blocks, const void* bcol, const void* x, void* y, long long S,
                long long NB, int bpr, int br, int bc, long long R_in, long long n_out,
                void* stream) {
  return launch<float>(blocks, bcol, x, y, S, NB, bpr, br, bc, 1, R_in, n_out, stream);
}
int bs_spmv_f64(const void* blocks, const void* bcol, const void* x, void* y, long long S,
                long long NB, int bpr, int br, int bc, long long R_in, long long n_out,
                void* stream) {
  return launch<double>(blocks, bcol, x, y, S, NB, bpr, br, bc, 1, R_in, n_out, stream);
}

int bs_spmm_f32(const void* blocks, const void* bcol, const void* x, void* y, long long S,
                long long NB, int bpr, int br, int bc, int r, long long R_in,
                long long n_out, void* stream) {
  return launch<float>(blocks, bcol, x, y, S, NB, bpr, br, bc, r, R_in, n_out, stream);
}
int bs_spmm_f64(const void* blocks, const void* bcol, const void* x, void* y, long long S,
                long long NB, int bpr, int br, int bc, int r, long long R_in,
                long long n_out, void* stream) {
  return launch<double>(blocks, bcol, x, y, S, NB, bpr, br, bc, r, R_in, n_out, stream);
}

}  // extern "C"
