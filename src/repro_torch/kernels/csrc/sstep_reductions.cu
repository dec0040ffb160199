// s-step CG kernels, written for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package:
//
//   ss_gram_*    <- src/repro/kernels/fused_reductions.py:414 sstep_gram
//   ss_basis_*   <- src/repro/kernels/fused_reductions.py:469 sstep_basis
//   ss_update_*  <- src/repro/kernels/fused_reductions.py:503 sstep_update
//
// Operands: basis blocks (S, R, s) row-major (element (sh, i, c) at
// (sh * R + i) * s + c), vectors (S, R); the coefficients B (s, s), dinv (s,)
// and a (s,) are one device array shared by every shard (the JAX package's
// replicated values after its all-reduce), read through a pointer and never
// copied to the host.
//
// What bounds them on this card: bytes. Per element read the Gram does
// about 2s/3 multiply-adds and the updates s, far below the FP64 ridge of
// 34 TFLOP/s over 3.35 TB/s (about 10 flops per byte), so the least time is
// the bytes each input is read once and each output written once over HBM3.
// The design:
//
// * ss_gram: one pass over P, W, Wp and r. For s <= kRegS each thread walks
//   rows with a grid stride and keeps all 2s^2 + s + 1 sums in registers (11
//   at s = 2, 37 at s = 4); neighbouring threads read neighbouring rows, so a
//   warp's loads cover contiguous runs. For larger s the sums do not fit in
//   registers: a block stages a tile of rows of all four operands in shared
//   memory, and each thread owns up to kEntries of the sums, adding the
//   tile's rows in order.
// * Deterministic reduction, no float atomics: blocks run in no order, so
//   each block writes its sums to partials[S][nblk][K] (warp shuffles, then
//   the warps in order) and a second launch adds the nblk partials of every
//   entry in a fixed order. nblk depends on the shape and the card only, so
//   the same inputs give the same bits on every run (and the iteration
//   counts of a solve repeat).
// * ss_basis: one thread per output element (row i, column j); the row's s
//   values of Qp and Wp are read by the s neighbouring threads together (one
//   line in L1), B and dinv are staged in shared memory once per block, and
//   both outputs are written in the same pass.
// * ss_update: one thread per row, a staged in shared memory, both outputs
//   written in the same pass.
// * Ragged R: every index is masked against the true length; the shards are
//   independent rows of one flat (S * R) range for the updates. s up to 8 is
//   unrolled at compile time; up to kMaxS takes a run-time loop.
//
// C interface, for ctypes: pointers and the stream are void*, every entry
// returns cudaGetLastError() after its launches (0 = success). Nothing here
// allocates or synchronises; the caller owns outputs and scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 16;
constexpr int kRegS = 4;        // Gram sums in registers up to this s
constexpr int kTileRows = 64;   // staged rows of the shared-memory Gram path
constexpr int kMaxK = 2 * kMaxS * kMaxS + kMaxS + 1;
constexpr int kEntries = (kMaxK + kThreads - 1) / kThreads;  // sums per thread, smem path
constexpr int kItems = 4;       // update elements per thread per grid pass

__host__ __device__ inline int gram_len(int s) { return 2 * s * s + s + 1; }
__host__ __device__ inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Stage 1 of ss_gram, s = SS <= kRegS: block bx of shard sh adds rows
// bx * kThreads + t, + nblk * kThreads, ... into registers, then reduces
// them over the block in a fixed order into partials[sh][bx][K].
template <typename T, int SS>
__global__ void __launch_bounds__(kThreads)
gram_reg_kernel(const T* __restrict__ P, const T* __restrict__ W, const T* __restrict__ Wp,
                const T* __restrict__ r, long long R, int nblk, T* __restrict__ partials) {
  constexpr int K = 2 * SS * SS + SS + 1;
  const int sh = blockIdx.y;
  const int bx = blockIdx.x;
  T acc[K];
#pragma unroll
  for (int e = 0; e < K; ++e) acc[e] = T(0);
  const long long base = (long long)sh * R;
  const long long stride = (long long)nblk * kThreads;
  for (long long i = (long long)bx * kThreads + threadIdx.x; i < R; i += stride) {
    const long long at = (base + i) * SS;
    T p[SS], w[SS], q[SS];
#pragma unroll
    for (int c = 0; c < SS; ++c) {
      p[c] = P[at + c];
      w[c] = W[at + c];
      q[c] = Wp[at + c];
    }
    const T rv = r[base + i];
#pragma unroll
    for (int a = 0; a < SS; ++a) {
#pragma unroll
      for (int b = 0; b < SS; ++b) {
        acc[a * SS + b] += p[a] * w[b];            // P^T W
        acc[SS * SS + a * SS + b] += q[a] * p[b];  // Wp^T P
      }
      acc[2 * SS * SS + a] += p[a] * rv;           // P^T r
    }
    acc[K - 1] += rv * rv;                         // r^T r
  }
  __shared__ T red[kThreads / 32][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    T v = acc[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][e] = v;
  }
  __syncthreads();
  T* dst = partials + ((long long)sh * nblk + bx) * K;
  for (int e = threadIdx.x; e < K; e += kThreads) {
    T v = T(0);
    for (int wi = 0; wi < kThreads / 32; ++wi) v += red[wi][e];
    dst[e] = v;
  }
}

// Offsets, inside one staged row [p(s) | w(s) | wp(s) | r], of the two
// factors of flat Gram entry e.
__device__ __forceinline__ void gram_factors(int e, int s, int& la, int& lb) {
  const int ss = s * s;
  if (e < ss) {  // (P^T W)[a][b]
    la = e / s;
    lb = s + e % s;
  } else if (e < 2 * ss) {  // (Wp^T P)[a][b]
    la = 2 * s + (e - ss) / s;
    lb = (e - ss) % s;
  } else if (e < 2 * ss + s) {  // (P^T r)[a]
    la = e - 2 * ss;
    lb = 3 * s;
  } else {  // r^T r
    la = 3 * s;
    lb = 3 * s;
  }
}

// Stage 1 of ss_gram for kRegS < s <= kMaxS: block bx of shard sh stages row
// tiles bx, bx + nblk, ... in shared memory; thread t owns entries t,
// t + kThreads, ... and adds each tile's rows in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_smem_kernel(const T* __restrict__ P, const T* __restrict__ W, const T* __restrict__ Wp,
                 const T* __restrict__ r, long long R, int s, int nblk,
                 T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int K = gram_len(s);
  const int ld = 3 * s + 1;
  const int sh = blockIdx.y;
  const int bx = blockIdx.x;
  int la[kEntries], lb[kEntries];
  T acc[kEntries];
#pragma unroll
  for (int q = 0; q < kEntries; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e < K) gram_factors(e, s, la[q], lb[q]);
    acc[q] = T(0);
  }
  const long long ntiles = ceil_div(R, kTileRows);
  for (long long t = bx; t < ntiles; t += nblk) {
    const long long row0 = t * kTileRows;
    const int rows = (int)(R - row0 < kTileRows ? R - row0 : kTileRows);
    const long long vb = (long long)sh * R + row0;
    const T* pp = P + vb * s;
    const T* wp = W + vb * s;
    const T* qp = Wp + vb * s;
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < rows * s; idx += kThreads) {
      const int i = idx / s, c = idx - i * s;
      sm[i * ld + c] = pp[idx];
      sm[i * ld + s + c] = wp[idx];
      sm[i * ld + 2 * s + c] = qp[idx];
    }
    for (int i = threadIdx.x; i < rows; i += kThreads) sm[i * ld + 3 * s] = r[vb + i];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kEntries; ++q) {
      if (threadIdx.x + q * kThreads < K) {
        T part = T(0);
        for (int i = 0; i < rows; ++i) part += sm[i * ld + la[q]] * sm[i * ld + lb[q]];
        acc[q] += part;
      }
    }
  }
  T* dst = partials + ((long long)sh * nblk + bx) * K;
#pragma unroll
  for (int q = 0; q < kEntries; ++q) {
    const int e = threadIdx.x + q * kThreads;
    if (e < K) dst[e] = acc[q];
  }
}

// Stage 2: out[sh][e] = sum over b of partials[sh][b][e], b in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_sum_kernel(const T* __restrict__ partials, int nblk, int K, T* __restrict__ out) {
  const int sh = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= K) return;
  const T* src = partials + (long long)sh * nblk * K + e;
  T v = T(0);
  for (int b = 0; b < nblk; ++b) v += src[(long long)b * K];
  out[(long long)sh * K + e] = v;
}

// o1 = Pb * diag(dinv) - Qp @ B, o2 = Wb * diag(dinv) - Wp @ B over n = S*R*s
// elements; SS = 0 takes s at run time.
template <typename T, int SS>
__global__ void __launch_bounds__(kThreads)
basis_kernel(const T* __restrict__ B, const T* __restrict__ dinv, const T* __restrict__ Qp,
             const T* __restrict__ Pb, const T* __restrict__ Wp, const T* __restrict__ Wb,
             T* __restrict__ O1, T* __restrict__ O2, long long n, int s_rt) {
  const int s = SS > 0 ? SS : s_rt;
  __shared__ T bs[kMaxS * kMaxS];
  __shared__ T ds[kMaxS];
  for (int e = threadIdx.x; e < s * s; e += kThreads) bs[e] = B[e];
  for (int e = threadIdx.x; e < s; e += kThreads) ds[e] = dinv[e];
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n; e += stride) {
    const long long row = e / s;
    const int j = (int)(e - row * s);
    const T* q = Qp + row * s;
    const T* w = Wp + row * s;
    T a1 = T(0), a2 = T(0);
    if (SS > 0) {
#pragma unroll
      for (int k = 0; k < (SS > 0 ? SS : 1); ++k) {
        a1 += q[k] * bs[k * s + j];
        a2 += w[k] * bs[k * s + j];
      }
    } else {
      for (int k = 0; k < s; ++k) {
        a1 += q[k] * bs[k * s + j];
        a2 += w[k] * bs[k * s + j];
      }
    }
    O1[e] = Pb[e] * ds[j] - a1;
    O2[e] = Wb[e] * ds[j] - a2;
  }
}

// ox = x + Q @ a, orr = r - WQ @ a over n = S*R rows; SS = 0 takes s at run
// time.
template <typename T, int SS>
__global__ void __launch_bounds__(kThreads)
update_kernel(const T* __restrict__ a, const T* __restrict__ Q, const T* __restrict__ WQ,
              const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ ox,
              T* __restrict__ orr, long long n, int s_rt) {
  const int s = SS > 0 ? SS : s_rt;
  __shared__ T as[kMaxS];
  for (int e = threadIdx.x; e < s; e += kThreads) as[e] = a[e];
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const T* q = Q + i * s;
    const T* w = WQ + i * s;
    T aq = T(0), aw = T(0);
    if (SS > 0) {
#pragma unroll
      for (int k = 0; k < (SS > 0 ? SS : 1); ++k) {
        aq += q[k] * as[k];
        aw += w[k] * as[k];
      }
    } else {
      for (int k = 0; k < s; ++k) {
        aq += q[k] * as[k];
        aw += w[k] * as[k];
      }
    }
    ox[i] = x[i] + aq;
    orr[i] = r[i] - aw;
  }
}

bool bad_shape(long long S, long long R, int s) {
  return S < 1 || S > 65535 || R < 1 || s < 1 || s > kMaxS;
}

int sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

int gram_smem_bytes(int s, int itemsize) { return kTileRows * (3 * s + 1) * itemsize; }

template <typename T>
const void* gram_reg_fn(int s) {
  switch (s) {
    case 1: return (const void*)gram_reg_kernel<T, 1>;
    case 2: return (const void*)gram_reg_kernel<T, 2>;
    case 3: return (const void*)gram_reg_kernel<T, 3>;
    default: return (const void*)gram_reg_kernel<T, 4>;
  }
}

// Blocks per shard: as many as the card holds at once (the kernel's
// occupancy times the SM count, over the shards), at most one per row unit.
// It depends on the shape and the card only, so a run's partials are added
// in the same order every time.
template <typename T>
int gram_nblk(long long S, long long R, int s) {
  int per_sm = 0;
  long long units;
  if (s <= kRegS) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_reg_fn<T>(s), kThreads, 0);
    units = ceil_div(R, kThreads);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_smem_kernel<T>, kThreads,
                                                  gram_smem_bytes(s, (int)sizeof(T)));
    units = ceil_div(R, kTileRows);
  }
  long long nb = (long long)sms() * (per_sm > 0 ? per_sm : 1) / S;
  if (nb < 1) nb = 1;
  return (int)(nb < units ? nb : units);
}

template <typename T>
int launch_gram(const void* pb, const void* wb, const void* wp, const void* r, long long S,
                long long R, int s, void* partials, void* out, void* stream) {
  if (bad_shape(S, R, s)) return (int)cudaErrorInvalidValue;
  const int nblk = gram_nblk<T>(S, R, s);
  const int K = gram_len(s);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)nblk, (unsigned)S);
  const T *P = (const T*)pb, *W = (const T*)wb, *Q = (const T*)wp, *rv = (const T*)r;
  T* part = (T*)partials;
  switch (s) {
    case 1: gram_reg_kernel<T, 1><<<grid, kThreads, 0, st>>>(P, W, Q, rv, R, nblk, part); break;
    case 2: gram_reg_kernel<T, 2><<<grid, kThreads, 0, st>>>(P, W, Q, rv, R, nblk, part); break;
    case 3: gram_reg_kernel<T, 3><<<grid, kThreads, 0, st>>>(P, W, Q, rv, R, nblk, part); break;
    case 4: gram_reg_kernel<T, 4><<<grid, kThreads, 0, st>>>(P, W, Q, rv, R, nblk, part); break;
    default:
      gram_smem_kernel<T><<<grid, kThreads, gram_smem_bytes(s, (int)sizeof(T)), st>>>(
          P, W, Q, rv, R, s, nblk, part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gram_sum_kernel<T><<<dim3((unsigned)ceil_div(K, kThreads), (unsigned)S), kThreads, 0, st>>>(
      part, nblk, K, (T*)out);
  return (int)cudaGetLastError();
}

long long grid_for(long long n) {
  const long long g = ceil_div(n, (long long)kThreads * kItems);
  return g < 1 ? 1 : (g > 0x7fffffffLL ? 0x7fffffffLL : g);
}

template <typename T>
int launch_basis(const void* b, const void* dinv, const void* qp, const void* pb,
                 const void* wp, const void* wb, void* o1, void* o2, long long S, long long R,
                 int s, void* stream) {
  if (bad_shape(S, R, s)) return (int)cudaErrorInvalidValue;
  const long long n = S * R * s;
  const unsigned grid = (unsigned)grid_for(n);
  cudaStream_t st = (cudaStream_t)stream;
#define SS_BASIS(K_)                                                                        \
  basis_kernel<T, K_><<<grid, kThreads, 0, st>>>((const T*)b, (const T*)dinv, (const T*)qp, \
                                                 (const T*)pb, (const T*)wp, (const T*)wb,  \
                                                 (T*)o1, (T*)o2, n, s)
  switch (s) {
    case 1: SS_BASIS(1); break;
    case 2: SS_BASIS(2); break;
    case 3: SS_BASIS(3); break;
    case 4: SS_BASIS(4); break;
    case 5: SS_BASIS(5); break;
    case 6: SS_BASIS(6); break;
    case 7: SS_BASIS(7); break;
    case 8: SS_BASIS(8); break;
    default: SS_BASIS(0);
  }
#undef SS_BASIS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_update(const void* a, const void* q, const void* wq, const void* x, const void* r,
                  void* ox, void* orr, long long S, long long R, int s, void* stream) {
  if (bad_shape(S, R, s)) return (int)cudaErrorInvalidValue;
  const long long n = S * R;
  const unsigned grid = (unsigned)grid_for(n);
  cudaStream_t st = (cudaStream_t)stream;
#define SS_UPDATE(K_)                                                                      \
  update_kernel<T, K_><<<grid, kThreads, 0, st>>>((const T*)a, (const T*)q, (const T*)wq,  \
                                                  (const T*)x, (const T*)r, (T*)ox, (T*)orr, \
                                                  n, s)
  switch (s) {
    case 1: SS_UPDATE(1); break;
    case 2: SS_UPDATE(2); break;
    case 3: SS_UPDATE(3); break;
    case 4: SS_UPDATE(4); break;
    case 5: SS_UPDATE(5); break;
    case 6: SS_UPDATE(6); break;
    case 7: SS_UPDATE(7); break;
    case 8: SS_UPDATE(8); break;
    default: SS_UPDATE(0);
  }
#undef SS_UPDATE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest s the kernels take.
int ss_max_s() { return kMaxS; }

// Blocks per shard of ss_gram: the caller sizes partials as
// S * ss_gram_nblk(...) * (2 s^2 + s + 1) elements.
int ss_gram_nblk(long long S, long long R, int s, int itemsize) {
  if (bad_shape(S, R, s)) return 0;
  return itemsize == 4 ? gram_nblk<float>(S, R, s) : gram_nblk<double>(S, R, s);
}

// out (S, 2 s^2 + s + 1) = [P^T W | Wp^T P | P^T r | r^T r] of every shard.
int ss_gram_f32(const void* pb, const void* wb, const void* wp, const void* r, long long S,
                long long R, int s, void* partials, void* out, void* stream) {
  return launch_gram<float>(pb, wb, wp, r, S, R, s, partials, out, stream);
}
int ss_gram_f64(const void* pb, const void* wb, const void* wp, const void* r, long long S,
                long long R, int s, void* partials, void* out, void* stream) {
  return launch_gram<double>(pb, wb, wp, r, S, R, s, partials, out, stream);
}

// (o1, o2) = (Pb * diag(dinv) - Qp @ B, Wb * diag(dinv) - Wp @ B) for every shard.
int ss_basis_f32(const void* b, const void* dinv, const void* qp, const void* pb,
                 const void* wp, const void* wb, void* o1, void* o2, long long S, long long R,
                 int s, void* stream) {
  return launch_basis<float>(b, dinv, qp, pb, wp, wb, o1, o2, S, R, s, stream);
}
int ss_basis_f64(const void* b, const void* dinv, const void* qp, const void* pb,
                 const void* wp, const void* wb, void* o1, void* o2, long long S, long long R,
                 int s, void* stream) {
  return launch_basis<double>(b, dinv, qp, pb, wp, wb, o1, o2, S, R, s, stream);
}

// (ox, orr) = (x + Q @ a, r - WQ @ a) for every shard.
int ss_update_f32(const void* a, const void* q, const void* wq, const void* x, const void* r,
                  void* ox, void* orr, long long S, long long R, int s, void* stream) {
  return launch_update<float>(a, q, wq, x, r, ox, orr, S, R, s, stream);
}
int ss_update_f64(const void* a, const void* q, const void* wq, const void* x, const void* r,
                  void* ox, void* orr, long long S, long long R, int s, void* stream) {
  return launch_update<double>(a, q, wq, x, r, ox, orr, S, R, s, stream);
}

}  // extern "C"
