// Block-CSR SpMV and SpMM of the BCSR interior, written for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package:
//
//   bs_spmv_*  <- src/repro/kernels/spmv_bcsr.py:39 bcsr_spmv
//   bs_spmm_*  <- src/repro/kernels/spmv_bcsr.py:80 bcsr_spmm (r = 1: the SpMV's kernel)
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
// (block-row x bpr) and accumulates each output tile in VMEM across it.
//
// The SpMV (r = 1), bcsr_tile_kernel and bcsr_any_kernel: one thread owns
// one output and loops over its block-row's tiles.
//
// * Thread t of shard s (grid (ceil(n_out / 256), S)) owns output row t and
//   sums tile row a of its block-row's bpr tiles against their x tiles, in
//   a fixed order (tiles, then the tile's columns), so the same inputs give
//   the same bits on every run: no atomics, no reduction across threads.
// * The br rows of one block-row read one contiguous tile, and the tiles of
//   a block-row lie next to each other. Tile rows are read as 16-byte
//   vectors where the tile width allows it, so the tiles, the bulk of the
//   bytes, stream from memory once; x is gathered through L1/L2.
// * Compile-time tiles: instantiated for square tiles of 2, 3, 4, 8 and 16
//   (every loop over a tile row unrolled, no division by a run-time width)
//   and once for run-time br, bc up to 16.
//
// The SpMM (r >= 2), bcsr_rhs_kernel. With one thread per (row, right-hand
// side), every tile row was loaded by r threads and every x tile came
// through L2 once per row after a dependent id load; with several
// right-hand sides per row-thread, the br threads of a block-row still read
// the same x rows from shared memory, 256 bytes apart, into the same banks.
// Shared-memory wavefronts, not HBM, set the pace. So:
//
// * A thread owns up to 4 rows of one block-row (all of a tile of 4 rows or
//   fewer) and a group of G = 2 or 4 right-hand sides: it reads each x row
//   of a tile once (G values, as 16-byte vectors where r and the pointers
//   allow) for all its rows, and each tile value once for G outputs.
//   Consecutive threads own consecutive block-rows.
// * A block owns a run of consecutive block-rows (up to 256 threads). Their
//   tiles are one contiguous span of `blocks`; it streams through a ring of
//   three shared-memory stages (8 KB of tiles each) by cp.async, a few
//   tiles of every block-row per stage, so two stages are in flight while
//   one is computed. The run's block-column ids are copied to shared memory
//   once, with the first two stages, so no x load waits on an id load.
// * The x window: banded interiors are the common case (on the boneS10
//   analog the 13 tiles of a block-row lie within a few block columns of
//   the diagonal, and neighbouring block-rows share most of their x tiles).
//   From the run's ids the block finds the block columns its tiles reach;
//   where they fit (48 KB), that slice of x is copied to shared memory once
//   and every tile of the run reads x there. A tile outside it (or every
//   tile, where the ids are scattered) reads x from global memory. The
//   decision is the kernel's, from the ids: no host sync, no argument.
// * Banks: a stage's block-row pieces and the window's block columns lie
//   16 bytes past a multiple of 128 bytes apart, so the 8 threads of a
//   quarter-warp (8 block-rows) read 8 different 16-byte bank groups.
// * Determinism: each output sums its tiles, then the tile's columns, in a
//   fixed order with fma, in one thread, whichever path its x takes: two
//   launches on the same inputs give the same bits.
// * Compile-time square tiles of 2, 3, 4, 8 and 16 and run-time br x bc,
//   each for G = 2 and 4; right-hand sides past what a block's threads
//   hold go to further blocks of the same run.
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
                 const T* __restrict__ x, T* __restrict__ y, int NB, int bpr, long long R_in,
                 long long n_out) {
  const long long s = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;  // n_out < 2^31
  if (row >= n_out) return;
  const int brow = row / B;
  const int a = row - brow * B;
  const long long tile0 = (s * NB + brow) * (long long)bpr;
  const T* __restrict__ arow = blocks + tile0 * (B * B) + a * B;
  const int* __restrict__ ids = bcol + tile0;
  const T* __restrict__ xs = x + s * R_in;
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k < bpr; ++k) {
    T v[B];
    load_row<T, B>(arow + (long long)k * (B * B), v);
    const long long c0 = (long long)ids[k] * B;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const T xv = c0 + j < R_in ? xs[c0 + j] : T(0);
      acc += v[j] * xv;
    }
  }
  y[s * n_out + row] = acc;
}

// Run-time tiles, any br, bc up to kMaxDim.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bcsr_any_kernel(const T* __restrict__ blocks, const int* __restrict__ bcol,
                const T* __restrict__ x, T* __restrict__ y, int NB, int bpr, int br, int bc,
                long long R_in, long long n_out) {
  const long long s = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;  // n_out < 2^31
  if (row >= n_out) return;
  const int brow = row / br;
  const int a = row - brow * br;
  const int E = br * bc;
  const long long tile0 = (s * NB + brow) * (long long)bpr;
  const T* __restrict__ arow = blocks + tile0 * E + a * bc;
  const int* __restrict__ ids = bcol + tile0;
  const T* __restrict__ xs = x + s * R_in;
  T acc = T(0);
  for (int k = 0; k < bpr; ++k) {
    const T* __restrict__ p = arow + (long long)k * E;
    const long long c0 = (long long)ids[k] * bc;
    for (int j = 0; j < bc; ++j) {
      const T xv = c0 + j < R_in ? xs[c0 + j] : T(0);
      acc += p[j] * xv;
    }
  }
  y[s * n_out + row] = acc;
}

// ---------------------------------------------------------------------------
// The SpMM (r >= 2): several right-hand sides per thread, staged tiles.

constexpr int kRhsThreads = 256;      // most threads of a block
constexpr int kStageBytes = 8192;     // tile bytes of one ring stage (before padding)
constexpr int kRhsStages = 3;         // stages: one computed, up to two in flight
constexpr int kMaxIdsBytes = 16384;   // the run's block-column ids
constexpr int kMaxWindowBytes = 49152;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// BYTES (4, 8 or 16) into shared memory, of which the first n are copied and
// the rest zero-filled (n = 0 reads nothing).
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
  }
}

// n_valid contiguous elements of src into dst (16-byte aligned), zeros up to
// n_total, by the block's threads: 16-byte copies where src is 16-byte
// aligned (dst is rounded up to whole 16-byte units then), else one element
// per copy.
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, long long n_valid,
                                          long long n_total, int tid, int nthr) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int E = 16 / sizeof(T);
    for (long long u = tid; u < (n_total + E - 1) / E; u += nthr) {
      const long long left = n_valid - u * E;
      const int nb = left >= E ? 16 : (left > 0 ? (int)(left * sizeof(T)) : 0);
      cp_async_bytes<16>(dst + u * E, nb > 0 ? src + u * E : src, nb);
    }
  } else {
    for (long long e = tid; e < n_total; e += nthr)
      cp_async_bytes<sizeof(T)>(dst + e, e < n_valid ? src + e : src,
                                e < n_valid ? (int)sizeof(T) : 0);
  }
}

// G consecutive right-hand sides of one x row into v: as 16-byte (8-byte
// for two floats) vectors when vec (the caller guarantees the alignment),
// else one by one, zero past the n that exist.
template <typename T, int G>
__device__ __forceinline__ void load_rhs(const T* __restrict__ p, T (&v)[G], int n, bool vec) {
  if (vec) {
    if constexpr (sizeof(T) == 8) {
#pragma unroll
      for (int g = 0; g < G; g += 2) {
        const double2 d = *reinterpret_cast<const double2*>(p + g);
        v[g] = d.x;
        v[g + 1] = d.y;
      }
    } else if constexpr (G == 2) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      v[0] = f.x;
      v[1] = f.y;
    } else {
#pragma unroll
      for (int g = 0; g < G; g += 4) {
        const float4 f = *reinterpret_cast<const float4*>(p + g);
        v[g] = f.x;
        v[g + 1] = f.y;
        v[g + 2] = f.z;
        v[g + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = g < n ? p[g] : T(0);
  }
}

template <typename T, int G>
__device__ __forceinline__ void store_rhs(T* __restrict__ p, const T (&v)[G], int n, bool vec) {
  if (vec) {
    if constexpr (sizeof(T) == 8) {
#pragma unroll
      for (int g = 0; g < G; g += 2)
        *reinterpret_cast<double2*>(p + g) = make_double2(v[g], v[g + 1]);
    } else if constexpr (G == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int g = 0; g < G; g += 4)
        *reinterpret_cast<float4*>(p + g) = make_float4(v[g], v[g + 1], v[g + 2], v[g + 3]);
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g < n) p[g] = v[g];
  }
}

// Up to 4 consecutive values of tile row p from column jc on, into v[0..):
// 16-byte vectors where the tile's rows and jc are 16-byte aligned in shared
// memory, else one by one (n: the columns that exist from jc on).
template <typename T, int B>
__device__ __forceinline__ void load_tile_seg(const T* __restrict__ p, T (&v)[4], int n) {
  if constexpr (B >= 4 && (B * sizeof(T)) % 16 == 0) {
    if constexpr (sizeof(T) == 8) {
      const double2 a = *reinterpret_cast<const double2*>(p);
      const double2 b = *reinterpret_cast<const double2*>(p + 2);
      v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
    } else {
      const float4 a = *reinterpret_cast<const float4*>(p);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    }
  } else if constexpr (B == 2 && sizeof(T) == 8) {
    const double2 a = *reinterpret_cast<const double2*>(p);
    v[0] = a.x, v[1] = a.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) v[j] = p[j];
  }
}

// The layout of one launch's blocks, chosen on the host (launch_rhs_as).
struct RhsPlan {
  int nbr;     // block-rows of a run
  int kc;      // tiles per block-row in one stage
  int ps;      // elements between block-rows' pieces of a stage
  int tr;      // threads per row group, each owning G right-hand sides
  int nslab;   // blocks per run along the right-hand sides
  int win;     // block columns the x window holds (0: none)
  int wcs;     // elements between the window's block columns
  bool vec;    // x and y rows as vectors (r % G == 0, aligned pointers)
  bool tile16; // every tile starts 16-byte aligned: copy tiles in 16 bytes
  bool x16;    // every x block column starts 16-byte aligned: copy in 16 bytes
};

// Rows per thread: a thread owns RB rows of one block-row (all of a tile of
// 4 rows or fewer), so each x value it loads feeds RB x G multiply-adds.
template <int B>
constexpr int kRowsPerThread = B > 0 && B < 4 ? B : 4;

// Block (run, slab) of shard blockIdx.y: block-rows [i0, i0 + nbr) (a run)
// and right-hand sides [slab*tr*G, (slab+1)*tr*G). Thread t owns block-row
// t % nbr of the run (consecutive threads, consecutive block-rows), its
// rows [rg*RB, rg*RB + RB) and the G right-hand sides of group gi, with
// (rg, gi) from t / nbr. B > 0: square B x B tiles; B = 0: br x bc from the
// arguments. Shared memory: the run's ids, kRhsStages tile stages, the x
// window. The pieces of a stage and the window's block columns lie 16
// bytes past a multiple of 128 bytes apart, so the 8 threads of a
// quarter-warp, on 8 block-rows, read 8 different banks.
template <typename T, int B, int G>
__global__ void __launch_bounds__(kRhsThreads)
bcsr_rhs_kernel(const T* __restrict__ blocks, const int* __restrict__ bcol,
                const T* __restrict__ x, T* __restrict__ y, int NB, int bpr, int br_, int bc_,
                int r, long long R_in, long long n_out, RhsPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int win_lo, win_hi;
  constexpr int E = 16 / sizeof(T);
  constexpr int RB = kRowsPerThread<B>;
  const int br = B > 0 ? B : br_, bc = B > 0 ? B : bc_;
  const int nrg = (br + RB - 1) / RB;
  const int TE = br * bc;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long s = blockIdx.y;
  const int run = blockIdx.x / pl.nslab, slab = blockIdx.x - run * pl.nslab;
  const int i0 = run * pl.nbr;
  const int nbr = NB - i0 < pl.nbr ? NB - i0 : pl.nbr;  // block-rows of this run
  const int nids = nbr * bpr;
  int* ids = reinterpret_cast<int*>(smem);
  T* stage0 = reinterpret_cast<T*>(smem + ((pl.nbr * bpr * 4 + 15) & ~15));
  const int stage_elems = pl.nbr * pl.ps;
  T* xw = stage0 + kRhsStages * stage_elems;

  const long long tile0 = ((long long)s * NB + i0) * bpr;  // the run's first tile
  const T* __restrict__ tiles = blocks + tile0 * TE;
  const int nchunks = (bpr + pl.kc - 1) / pl.kc;
  auto stage_tiles = [&](int chunk) {  // tiles [k0, k0 + kc) of every block-row
    T* st = stage0 + (chunk % kRhsStages) * stage_elems;
    const int k0 = chunk * pl.kc;
    const int kc = bpr - k0 < pl.kc ? bpr - k0 : pl.kc;
    if (pl.tile16) {
      const int upp = kc * TE / E;  // 16-byte copies per block-row piece
      for (int e = tid; e < nbr * upp; e += nthr) {
        const int ib = e / upp, u = e - ib * upp;
        cp_async_bytes<16>(st + ib * pl.ps + u * E,
                           tiles + ((long long)ib * bpr + k0) * TE + (long long)u * E, 16);
      }
    } else {
      const int upp = kc * TE;
      for (int e = tid; e < nbr * upp; e += nthr) {
        const int ib = e / upp, u = e - ib * upp;
        cp_async_bytes<sizeof(T)>(st + ib * pl.ps + u,
                                  tiles + ((long long)ib * bpr + k0) * TE + u, sizeof(T));
      }
    }
  };

  // the ids, and the first kRhsStages - 1 stages, in flight together
  if (tid == 0) {
    win_lo = 0x7fffffff;
    win_hi = -1;
  }
  copy_span(ids, bcol + tile0, nids, nids, tid, nthr);
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < kRhsStages - 1; ++c) {
    if (c < nchunks) stage_tiles(c);
    cp_async_commit();
  }
  cp_async_wait<kRhsStages - 1>();  // the ids
  __syncthreads();

  // The x window: the block columns the run's tiles reach, when they fit.
  // Padding tiles (block column 0 after a larger one: pack_bcsr appends
  // them to a block-row's ascending columns) do not widen it; a tile
  // outside it reads x from global memory, with the same arithmetic.
  int w0 = 0, wn = 0;
  if (pl.win > 0) {
    int lo = 0x7fffffff, hi = -1;
    for (int e = tid; e < nids; e += nthr) {
      const int id = ids[e];
      if (e % bpr == 0 || id > ids[e - 1]) {
        lo = id < lo ? id : lo;
        hi = id > hi ? id : hi;
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((tid & 31) == 0) {
      atomicMin(&win_lo, lo);
      atomicMax(&win_hi, hi);
    }
    __syncthreads();
    if (win_hi >= win_lo && win_hi - win_lo < pl.win) {
      w0 = win_lo;
      wn = win_hi - win_lo + 1;
      // block column c of the window: x rows (w0 + c)*bc .. + bc, zero past R_in
      const int col = bc * r;  // elements of one block column
      const T* src = x + (s * R_in + (long long)w0 * bc) * r;
      auto valid = [&](int c) {
        const long long v = R_in - (long long)(w0 + c) * bc;
        return (int)(v <= 0 ? 0 : (v < bc ? v : bc)) * r;
      };
      if (pl.x16) {
        const int upc = col / E;
        for (int e = tid; e < wn * upc; e += nthr) {
          const int c = e / upc, u = e - c * upc;
          const int left = valid(c) - u * E;
          const int nb = left >= E ? 16 : (left > 0 ? left * (int)sizeof(T) : 0);
          cp_async_bytes<16>(xw + c * pl.wcs + u * E,
                             nb > 0 ? src + (long long)c * col + u * E : src, nb);
        }
      } else {
        for (int e = tid; e < wn * col; e += nthr) {
          const int c = e / col, u = e - c * col;
          const bool v = u < valid(c);
          cp_async_bytes<sizeof(T)>(xw + c * pl.wcs + u, v ? src + (long long)c * col + u : src,
                                    v ? (int)sizeof(T) : 0);
        }
      }
    }
  }
  cp_async_commit();

  const int ib = tid % pl.nbr, rest = tid / pl.nbr;
  const int rg = rest % nrg, gi = rest / nrg;
  const int a0 = rg * RB;
  const int c0 = (slab * pl.tr + gi) * G;
  const bool active = gi < pl.tr && ib < nbr && c0 < r;
  const int nrhs = r - c0 < G ? r - c0 : G;
  const T* __restrict__ xs = x + s * R_in * r + c0;
  T acc[RB][G];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
#pragma unroll
    for (int g = 0; g < G; ++g) acc[i][g] = T(0);
  }

  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (chunk == 0) {
      cp_async_wait<0>();  // the window too
    } else {
      cp_async_wait<kRhsStages - 2>();  // chunk (and, early on, a later group)
    }
    __syncthreads();  // the chunk is in, and the stage it replaces is free
    if (chunk + kRhsStages - 1 < nchunks) stage_tiles(chunk + kRhsStages - 1);
    cp_async_commit();
    if (!active) continue;
    const int k0 = chunk * pl.kc;
    const int kc = bpr - k0 < pl.kc ? bpr - k0 : pl.kc;
    const T* piece = stage0 + (chunk % kRhsStages) * stage_elems + ib * pl.ps;
    const int* kid = ids + ib * bpr + k0;
    for (int kk = 0; kk < kc; ++kk) {
      const int id = kid[kk];
      const T* tp = piece + kk * TE + a0 * bc;  // row a0 of the tile
      const bool in_win = (unsigned)(id - w0) < (unsigned)wn;
      const long long col0 = (long long)id * bc;
      const T* xr = in_win ? xw + (id - w0) * pl.wcs + c0 : xs + col0 * r;
      // columns jc .. jc+3 at a time: x rows once, then each of the RB rows
#pragma unroll
      for (int jc = 0; jc < (B > 0 ? B : kMaxDim); jc += 4) {
        if (B == 0 && jc >= bc) break;
        const int nj = bc - jc < 4 ? bc - jc : 4;
        T xv[4][G];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nj && (in_win || col0 + jc + j < R_in)) {
            load_rhs<T, G>(xr + (long long)(jc + j) * r, xv[j], nrhs, pl.vec);
          } else {
#pragma unroll
            for (int g = 0; g < G; ++g) xv[j][g] = T(0);
          }
        }
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (B == 0 && a0 + i >= br) break;
          T tv[4];
          load_tile_seg<T, B>(tp + i * bc + jc, tv, nj);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nj) {
#pragma unroll
              for (int g = 0; g < G; ++g) acc[i][g] = fma(tv[j], xv[j][g], acc[i][g]);
            }
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const long long row = (long long)(i0 + ib) * br + a0 + i;
    if (a0 + i < br && row < n_out)
      store_rhs<T, G>(y + (s * n_out + row) * r + c0, acc[i], nrhs, pl.vec);
  }
}

template <typename T, int B, int G>
int launch_rhs_as(const T* b, const int* ids, const T* x, T* y, long long S, int NB, int bpr,
                  int br, int bc, int r, long long R_in, long long n_out, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  constexpr int RB = kRowsPerThread<B>;
  const int groups = (r + G - 1) / G;
  const int nrg = (br + RB - 1) / RB;
  const int te_bytes = br * bc * (int)sizeof(T);
  // elements of n bytes rounded up to 16 past a multiple of 128
  auto pad = [](long long bytes) { return (int)(((bytes + 127) / 128 * 128 + 16) / sizeof(T)); };
  RhsPlan pl;
  pl.tr = groups < kRhsThreads / nrg ? groups : kRhsThreads / nrg;
  pl.nslab = (groups + pl.tr - 1) / pl.tr;
  int nbr = kRhsThreads / (nrg * pl.tr);
  const int ids_cap = kMaxIdsBytes / (4 * bpr), tile_cap = kStageBytes / te_bytes;
  nbr = nbr < ids_cap ? nbr : (ids_cap > 1 ? ids_cap : 1);
  nbr = nbr < tile_cap ? nbr : (tile_cap > 1 ? tile_cap : 1);
  pl.nbr = nbr < NB ? nbr : NB;
  const int kc = kStageBytes / (pl.nbr * te_bytes);
  pl.kc = kc < 1 ? 1 : (kc > bpr ? bpr : kc);
  pl.ps = pad((long long)pl.kc * te_bytes);
  pl.wcs = pad((long long)bc * r * sizeof(T));
  pl.win = 0;
  if (pl.nslab == 1) {
    // the diagonal span of the run plus the reach of two full block-rows
    const long long cols = ((long long)pl.nbr * br + bc - 1) / bc + 2LL * bpr;
    const long long cap = kMaxWindowBytes / ((long long)pl.wcs * sizeof(T));
    pl.win = (int)(cols < cap ? cols : cap);
  }
  const uintptr_t vb = G * sizeof(T) < 16 ? G * sizeof(T) : 16;
  pl.vec = r % G == 0 && reinterpret_cast<uintptr_t>(x) % vb == 0 &&
           reinterpret_cast<uintptr_t>(y) % vb == 0;
  pl.tile16 = te_bytes % 16 == 0;
  pl.x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (bc * r * sizeof(T)) % 16 == 0 &&
           (R_in * r * sizeof(T)) % 16 == 0;
  const size_t smem = (size_t)((pl.nbr * bpr * 4 + 15) & ~15) +
                      sizeof(T) * ((size_t)kRhsStages * pl.nbr * pl.ps + (size_t)pl.win * pl.wcs);
  const long long blocks_x = (NB + pl.nbr - 1) / pl.nbr * (long long)pl.nslab;
  if (smem > 232448 || blocks_x > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = bcsr_rhs_kernel<T, B, G>;
  // past 48 KB the kernel must be allowed its dynamic shared memory, once per
  // device and size (a runtime call kept off the solver's per-iteration path)
  static int allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 49152 && (dev >= 64 || allowed[dev] < (int)smem)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) allowed[dev] = (int)smem;
  }
  const int threads = (pl.nbr * nrg * pl.tr + 31) / 32 * 32;
  kernel<<<dim3((unsigned)blocks_x, (unsigned)S), threads, smem, st>>>(b, ids, x, y, NB, bpr, br,
                                                                     bc, r, R_in, n_out, pl);
  return (int)cudaGetLastError();
}

// G, the right-hand sides a thread owns: 2 for r <= 2, else 4 at a time.
template <typename T, int B>
int launch_rhs_tile(const T* b, const int* ids, const T* x, T* y, long long S, int NB, int bpr,
                    int br, int bc, int r, long long R_in, long long n_out, cudaStream_t st) {
  if (r <= 2)
    return launch_rhs_as<T, B, 2>(b, ids, x, y, S, NB, bpr, br, bc, r, R_in, n_out, st);
  return launch_rhs_as<T, B, 4>(b, ids, x, y, S, NB, bpr, br, bc, r, R_in, n_out, st);
}

bool bad_args(long long S, long long NB, int bpr, int br, int bc, int r, long long R_in,
              long long n_out) {
  return S < 0 || S > 65535 || NB < 1 || NB > 0x7fffffffLL || bpr < 1 || br < 1 ||
         br > kMaxDim || bc < 1 || bc > kMaxDim || r < 1 || R_in < 0 || n_out < 0 ||
         n_out > NB * br || n_out * r > 0x7fffffffLL;
}

template <typename T>
int launch_rhs(const T* b, const int* ids, const T* x, T* y, long long S, int NB, int bpr,
               int br, int bc, int r, long long R_in, long long n_out, cudaStream_t st) {
  const int sq = br == bc ? br : 0;
  switch (sq) {
    case 2: return launch_rhs_tile<T, 2>(b, ids, x, y, S, NB, bpr, br, bc, r, R_in, n_out, st);
    case 3: return launch_rhs_tile<T, 3>(b, ids, x, y, S, NB, bpr, br, bc, r, R_in, n_out, st);
    case 4: return launch_rhs_tile<T, 4>(b, ids, x, y, S, NB, bpr, br, bc, r, R_in, n_out, st);
    case 8: return launch_rhs_tile<T, 8>(b, ids, x, y, S, NB, bpr, br, bc, r, R_in, n_out, st);
    case 16: return launch_rhs_tile<T, 16>(b, ids, x, y, S, NB, bpr, br, bc, r, R_in, n_out, st);
    default: return launch_rhs_tile<T, 0>(b, ids, x, y, S, NB, bpr, br, bc, r, R_in, n_out, st);
  }
}

template <typename T>
int launch(const void* blocks, const void* bcol, const void* x, void* y, long long S,
           long long NB, int bpr, int br, int bc, int r, long long R_in, long long n_out,
           void* stream) {
  if (bad_args(S, NB, bpr, br, bc, r, R_in, n_out)) return (int)cudaErrorInvalidValue;
  if (S == 0 || n_out == 0) return (int)cudaGetLastError();
  if (r >= 2)
    return launch_rhs<T>((const T*)blocks, (const int*)bcol, (const T*)x, (T*)y, S, (int)NB, bpr,
                         br, bc, r, R_in, n_out, (cudaStream_t)stream);
  const dim3 grid((unsigned)((n_out + kThreads - 1) / kThreads), (unsigned)S);
  cudaStream_t st = (cudaStream_t)stream;
  const T* b = (const T*)blocks;
  const int* ids = (const int*)bcol;
  const T* xv = (const T*)x;
  T* yv = (T*)y;
  const int nb = (int)NB;
  if (br == bc && br == 2) {
    bcsr_tile_kernel<T, 2><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, R_in, n_out);
  } else if (br == bc && br == 3) {
    bcsr_tile_kernel<T, 3><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, R_in, n_out);
  } else if (br == bc && br == 4) {
    bcsr_tile_kernel<T, 4><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, R_in, n_out);
  } else if (br == bc && br == 8) {
    bcsr_tile_kernel<T, 8><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, R_in, n_out);
  } else if (br == bc && br == 16) {
    bcsr_tile_kernel<T, 16><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, R_in, n_out);
  } else {
    bcsr_any_kernel<T><<<grid, kThreads, 0, st>>>(b, ids, xv, yv, nb, bpr, br, bc, R_in, n_out);
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
