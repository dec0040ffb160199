// Fused vector kernels of the CG hot paths, written for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package:
//
//   fr_dots_*        <- src/repro/kernels/fused_reductions.py:104 fused_dots_n
//   fr_axpy_*        <- src/repro/kernels/fused_reductions.py:156 fused_axpy
//   fr_axpy2_*       <- src/repro/kernels/fused_reductions.py:178 fused_axpy2
//   fr_axpy2_dots_*  <- src/repro/kernels/fused_reductions.py:196 fused_axpy2_dots
//
// What bounds them on this card: bytes. They stream whole vectors and do one
// or two flops per element read (no tensor-core work), so the least time is
// the bytes moved over the 3.35 TB/s of HBM3. The design follows from that:
//
// * Stacked layout. Vectors are the (S, R) stack of S shards on one device.
//   The grid is (ceil(R / kTile), S); a block owns one tile of one shard and
//   masks the ragged tail of the shard itself (no host padding copies).
// * Every operand is read once and every output written once per call: the
//   dot kernel loads each DISTINCT operand once per element and forms all
//   requested products from registers; the axpy2+dot kernel accumulates the
//   squared norm of its second output while that output is still in
//   registers, so the norm costs no second pass over memory.
// * Coalesced loads: thread t of a block reads elements t, t + 256, ... of
//   its tile, so each warp touches 32 consecutive elements per load, and all
//   kItems loads of a thread are issued before any arithmetic uses them.
// * Deterministic reductions, no float atomics: stage 1 reduces each tile
//   (warp shuffles, then shared memory) into partials[S][nblk][k]; stage 2
//   is a second small launch, one block per shard, that sums the partials in
//   a fixed order. The same inputs give the same bits on every run, so CG
//   iteration counts repeat. Sums accumulate in the input type, as the JAX
//   package's kernels do.
// * Scalars stay on the device: alpha/beta arrive as device pointers with a
//   shard stride (0 for one global scalar, 1 for one per shard). fused_axpy
//   also takes a scalar by value (a null pointer selects it), so a caller's
//   Python number costs no host-to-device copy and no stream sync.
//
// fused_axpy streams 3 vectors and does one FMA per element, so its time is
// the memory pipe's; the design, as measured on an H100 (PERF.md):
//
// * 16-byte accesses: each thread loads and stores one double2 / float4. A
//   shard whose rows start off a 16-byte boundary (odd R in f64, or a view
//   that starts 8 bytes in) does its few head and tail elements one by one;
//   when x, y and o are not equally aligned the kernel takes one element per
//   access (still exactly right, just narrower).
// * Many small tiles: one block per 256 units of a shard, each thread one
//   unit per operand. This measured faster than one wave of blocks striding
//   over the shard (3%) and than 2, 4 or 8 units per thread.
// * Streaming stores (st.global.cs): o is written once and not read again
//   here. They measured 0.2-1.8% faster than plain stores at every length
//   of the AMG levels; streaming loads were 1-2% slower at the longest,
//   and both together 3%.
// * Exactly one fma(a, x, y) per element: the bits equal those of the
//   kernel it replaces, which the compiler also contracted to one FMA.
//
// C interface, for ctypes: pointers and the stream are void*, sizes are
// long long, and every entry returns cudaGetLastError() after its launches
// (0 = success). Nothing here allocates or synchronises; the caller owns
// outputs and scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // elements per thread per tile
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOps = 4;    // distinct operands of one fused_dots_n call
constexpr int kMaxProds = 6;  // distinct products of one fused_dots_n call

template <typename T>
struct DotsArgs {
  const T* op[kMaxOps];
  int pa[kMaxProds];  // left operand index of each product
  int pb[kMaxProds];  // right operand index of each product
  int n_ops;
  int n_prods;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum K per-thread values over the block; the totals land in thread 0.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&v)[K]) {
  __shared__ T smem[K * kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const T w = warp_sum(v[j]);
    if (lane == 0) smem[j * kWarps + warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = warp_sum(lane < kWarps ? smem[j * kWarps + lane] : T(0));
  }
}

template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kMaxOps], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// Stage 1 of fused_dots_n: per-tile partial sums of every product.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dots_tile_kernel(DotsArgs<T> a, long long R, int nblk, T* __restrict__ partials) {
  const int s = blockIdx.y;
  const long long row = (long long)s * R;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  T v[kItems][kMaxOps];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads;
    const bool ok = i < R;
#pragma unroll
    for (int t = 0; t < kMaxOps; ++t) v[it][t] = (ok && t < a.n_ops) ? a.op[t][row + i] : T(0);
  }
  T acc[kMaxProds];
#pragma unroll
  for (int j = 0; j < kMaxProds; ++j) acc[j] = T(0);
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
#pragma unroll
    for (int j = 0; j < kMaxProds; ++j) {
      if (j < a.n_prods) acc[j] += pick(v[it], a.pa[j]) * pick(v[it], a.pb[j]);
    }
  }
  block_sum<T, kMaxProds>(acc);
  if (threadIdx.x == 0) {
    T* dst = partials + ((long long)s * nblk + blockIdx.x) * kMaxProds;
#pragma unroll
    for (int j = 0; j < kMaxProds; ++j)
      if (j < a.n_prods) dst[j] = acc[j];
  }
}

// Stage 2: one block per shard sums its nblk tile partials in a fixed order.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
partials_sum_kernel(const T* __restrict__ partials, int nblk, int k_out, T* __restrict__ out) {
  const int s = blockIdx.x;
  T acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = T(0);
  for (int b = threadIdx.x; b < nblk; b += kThreads) {
    const T* src = partials + ((long long)s * nblk + b) * K;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k_out) acc[j] += src[j];
  }
  block_sum<T, K>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k_out) out[(long long)s * k_out + j] = acc[j];
  }
}

// ---- fused_axpy: o = a * x + y -----------------------------------------

constexpr int kAxpyThreads = 256;  // one 16-byte unit (or one element) each

// The scalar of fused_axpy: a device pointer with a shard stride, or, when
// the pointer is null, a value passed by value at launch.
template <typename T>
struct AxpyScalar {
  const T* ptr;
  long long stride;
  T val;
  __device__ __forceinline__ T get(int s) const { return ptr ? ptr[s * stride] : val; }
};

// The access unit: a 16-byte vector of T, or T itself on the narrow path.
template <typename T, bool kVec>
struct Unit {
  using type = T;
  static constexpr int n = 1;
};
template <>
struct Unit<double, true> {
  using type = double2;
  static constexpr int n = 2;
};
template <>
struct Unit<float, true> {
  using type = float4;
  static constexpr int n = 4;
};

__device__ __forceinline__ double fma_unit(double a, double x, double y) { return fma(a, x, y); }
__device__ __forceinline__ float fma_unit(float a, float x, float y) { return fmaf(a, x, y); }
__device__ __forceinline__ double2 fma_unit(double a, double2 x, double2 y) {
  return make_double2(fma(a, x.x, y.x), fma(a, x.y, y.y));
}
__device__ __forceinline__ float4 fma_unit(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

// Grid (nbx, S): block (bx, s) takes tile bx of shard s's 16-byte units
// (kVec) or elements, one per thread; block 0 of each shard also does the
// shard's unaligned head (< 16 bytes) and its ragged tail (< one unit).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kAxpyThreads)
axpy_kernel(AxpyScalar<T> a, const T* __restrict__ x, const T* __restrict__ y,
            T* __restrict__ o, long long R) {
  using U = typename Unit<T, kVec>::type;
  constexpr int V = Unit<T, kVec>::n;
  const int s = blockIdx.y;
  const T av = a.get(s);
  const long long row = (long long)s * R;
  const T* xs = x + row;
  const T* ys = y + row;
  T* os = o + row;
  long long head = 0;
  if (kVec) {
    const unsigned mis = (unsigned)((uintptr_t)xs & 15u);
    head = mis ? (long long)((16u - mis) / sizeof(T)) : 0;
    if (head > R) head = R;
  }
  const long long nunit = (R - head) / V;
  if (blockIdx.x == 0) {
    const long long tail = head + nunit * V;  // R - tail < V
    const int t = threadIdx.x;
    if (t < head) __stcs(os + t, fma_unit(av, xs[t], ys[t]));
    if (t < R - tail) __stcs(os + tail + t, fma_unit(av, xs[tail + t], ys[tail + t]));
  }
  const long long i = (long long)blockIdx.x * kAxpyThreads + threadIdx.x;
  if (i < nunit) {
    const U* xu = reinterpret_cast<const U*>(xs + head);
    const U* yu = reinterpret_cast<const U*>(ys + head);
    __stcs(reinterpret_cast<U*>(os + head) + i, fma_unit(av, xu[i], yu[i]));
  }
}

// o1 = a1[s] * x1 + y1 ; o2 = a2[s] * x2 + y2 (the fcg/pipecg updates)
template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy2_kernel(const T* __restrict__ a1, long long s1, const T* __restrict__ x1,
             const T* __restrict__ y1, const T* __restrict__ a2, long long s2,
             const T* __restrict__ x2, const T* __restrict__ y2, T* __restrict__ o1,
             T* __restrict__ o2, long long R) {
  const int s = blockIdx.y;
  const long long row = (long long)s * R;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  const T av1 = a1[s * s1];
  const T av2 = a2[s * s2];
  T x1v[kItems], y1v[kItems], x2v[kItems], y2v[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads;
    const bool ok = i < R;
    x1v[it] = ok ? x1[row + i] : T(0);
    y1v[it] = ok ? y1[row + i] : T(0);
    x2v[it] = ok ? x2[row + i] : T(0);
    y2v[it] = ok ? y2[row + i] : T(0);
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads;
    if (i < R) {
      o1[row + i] = av1 * x1v[it] + y1v[it];
      o2[row + i] = av2 * x2v[it] + y2v[it];
    }
  }
}

// o1 = a1[s] * x1 + y1 ; o2 = a2[s] * x2 + y2 ; partials[s][blk] = sum(o2 * o2)
template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy2_dots_kernel(const T* __restrict__ a1, long long s1, const T* __restrict__ x1,
                  const T* __restrict__ y1, const T* __restrict__ a2, long long s2,
                  const T* __restrict__ x2, const T* __restrict__ y2, T* __restrict__ o1,
                  T* __restrict__ o2, long long R, int nblk, T* __restrict__ partials) {
  const int s = blockIdx.y;
  const long long row = (long long)s * R;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  const T av1 = a1[s * s1];
  const T av2 = a2[s * s2];
  T x1v[kItems], y1v[kItems], x2v[kItems], y2v[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads;
    const bool ok = i < R;
    x1v[it] = ok ? x1[row + i] : T(0);
    y1v[it] = ok ? y1[row + i] : T(0);
    x2v[it] = ok ? x2[row + i] : T(0);
    y2v[it] = ok ? y2[row + i] : T(0);
  }
  T acc[1] = {T(0)};
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads;
    if (i < R) {
      const T v2 = av2 * x2v[it] + y2v[it];
      o1[row + i] = av1 * x1v[it] + y1v[it];
      o2[row + i] = v2;
      acc[0] += v2 * v2;
    }
  }
  block_sum<T, 1>(acc);
  if (threadIdx.x == 0) partials[(long long)s * nblk + blockIdx.x] = acc[0];
}

bool bad_shape(long long S, long long R) { return S < 1 || S > 65535 || R < 1; }

int tiles(long long R) { return (int)((R + kTile - 1) / kTile); }

template <typename T>
int launch_dots(const void* p0, const void* p1, const void* p2, const void* p3, int n_ops,
                int n_prods, int code, long long S, long long R, void* partials, void* out,
                void* stream) {
  if (bad_shape(S, R) || n_ops < 1 || n_ops > kMaxOps || n_prods < 1 || n_prods > kMaxProds)
    return (int)cudaErrorInvalidValue;
  DotsArgs<T> a;
  a.op[0] = (const T*)p0;
  a.op[1] = (const T*)p1;
  a.op[2] = (const T*)p2;
  a.op[3] = (const T*)p3;
  for (int j = 0; j < kMaxProds; ++j) {
    a.pa[j] = (code >> (4 * j + 2)) & 3;
    a.pb[j] = (code >> (4 * j)) & 3;
  }
  a.n_ops = n_ops;
  a.n_prods = n_prods;
  const int nblk = tiles(R);
  cudaStream_t st = (cudaStream_t)stream;
  dots_tile_kernel<T><<<dim3(nblk, (unsigned)S), kThreads, 0, st>>>(a, R, nblk, (T*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  partials_sum_kernel<T, kMaxProds>
      <<<(unsigned)S, kThreads, 0, st>>>((const T*)partials, nblk, n_prods, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int launch_axpy_as(AxpyScalar<T> a, const T* x, const T* y, T* o, long long S, long long R,
                   cudaStream_t st) {
  const long long units = R / Unit<T, kVec>::n + 1;
  const long long nbx = (units + kAxpyThreads - 1) / kAxpyThreads;
  if (nbx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // the grid's x limit
  axpy_kernel<T, kVec><<<dim3((unsigned)nbx, (unsigned)S), kAxpyThreads, 0, st>>>(a, x, y, o, R);
  return (int)cudaGetLastError();
}

// ``a`` null: the scalar is ``a_val``; else a[s * a_stride] on the device.
template <typename T>
int launch_axpy(const void* a, long long a_stride, T a_val, const void* x, const void* y,
                void* o, long long S, long long R, void* stream) {
  if (bad_shape(S, R)) return (int)cudaErrorInvalidValue;
  const AxpyScalar<T> sc{(const T*)a, a_stride, a_val};
  const uintptr_t phase = (uintptr_t)x & 15u;
  const bool vec = ((uintptr_t)y & 15u) == phase && ((uintptr_t)o & 15u) == phase;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch_axpy_as<T, true>(sc, (const T*)x, (const T*)y, (T*)o, S, R, st)
             : launch_axpy_as<T, false>(sc, (const T*)x, (const T*)y, (T*)o, S, R, st);
}

template <typename T>
int launch_axpy2(const void* a1, long long s1, const void* x1, const void* y1, const void* a2,
                 long long s2, const void* x2, const void* y2, void* o1, void* o2, long long S,
                 long long R, void* stream) {
  if (bad_shape(S, R)) return (int)cudaErrorInvalidValue;
  axpy2_kernel<T><<<dim3(tiles(R), (unsigned)S), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)a1, s1, (const T*)x1, (const T*)y1, (const T*)a2, s2, (const T*)x2,
      (const T*)y2, (T*)o1, (T*)o2, R);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_axpy2_dots(const void* a1, long long s1, const void* x1, const void* y1,
                      const void* a2, long long s2, const void* x2, const void* y2, void* o1,
                      void* o2, long long S, long long R, void* partials, void* out,
                      void* stream) {
  if (bad_shape(S, R)) return (int)cudaErrorInvalidValue;
  const int nblk = tiles(R);
  cudaStream_t st = (cudaStream_t)stream;
  axpy2_dots_kernel<T><<<dim3(nblk, (unsigned)S), kThreads, 0, st>>>(
      (const T*)a1, s1, (const T*)x1, (const T*)y1, (const T*)a2, s2, (const T*)x2,
      (const T*)y2, (T*)o1, (T*)o2, R, nblk, (T*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  partials_sum_kernel<T, 1><<<(unsigned)S, kThreads, 0, st>>>((const T*)partials, nblk, 1, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements per tile: the caller sizes partials as S * ceil(R / tile) * k.
int fr_tile(void) { return kTile; }

// Products are packed 4 bits each into `code`: product j multiplies operand
// (code >> (4j + 2)) & 3 by operand (code >> 4j) & 3. partials holds
// S * ceil(R / tile) * 6 elements (6 = the most products); out is
// (S, n_prods).
int fr_dots_f32(const void* p0, const void* p1, const void* p2, const void* p3, int n_ops,
                int n_prods, int code, long long S, long long R, void* partials, void* out,
                void* stream) {
  return launch_dots<float>(p0, p1, p2, p3, n_ops, n_prods, code, S, R, partials, out, stream);
}
int fr_dots_f64(const void* p0, const void* p1, const void* p2, const void* p3, int n_ops,
                int n_prods, int code, long long S, long long R, void* partials, void* out,
                void* stream) {
  return launch_dots<double>(p0, p1, p2, p3, n_ops, n_prods, code, S, R, partials, out, stream);
}

// o = a * x + y over (S, R). ``a`` a device pointer read at a[s * a_stride]
// (stride 0: one scalar, 1: one per shard), or null to use ``a_val``.
int fr_axpy_f32(const void* a, long long a_stride, float a_val, const void* x, const void* y,
                void* o, long long S, long long R, void* stream) {
  return launch_axpy<float>(a, a_stride, a_val, x, y, o, S, R, stream);
}
int fr_axpy_f64(const void* a, long long a_stride, double a_val, const void* x, const void* y,
                void* o, long long S, long long R, void* stream) {
  return launch_axpy<double>(a, a_stride, a_val, x, y, o, S, R, stream);
}

int fr_axpy2_f32(const void* a1, long long s1, const void* x1, const void* y1, const void* a2,
                 long long s2, const void* x2, const void* y2, void* o1, void* o2, long long S,
                 long long R, void* stream) {
  return launch_axpy2<float>(a1, s1, x1, y1, a2, s2, x2, y2, o1, o2, S, R, stream);
}
int fr_axpy2_f64(const void* a1, long long s1, const void* x1, const void* y1, const void* a2,
                 long long s2, const void* x2, const void* y2, void* o1, void* o2, long long S,
                 long long R, void* stream) {
  return launch_axpy2<double>(a1, s1, x1, y1, a2, s2, x2, y2, o1, o2, S, R, stream);
}

// partials holds S * ceil(R / tile) elements; out is (S, 1).
int fr_axpy2_dots_f32(const void* a1, long long s1, const void* x1, const void* y1,
                      const void* a2, long long s2, const void* x2, const void* y2, void* o1,
                      void* o2, long long S, long long R, void* partials, void* out,
                      void* stream) {
  return launch_axpy2_dots<float>(a1, s1, x1, y1, a2, s2, x2, y2, o1, o2, S, R, partials, out,
                                  stream);
}
int fr_axpy2_dots_f64(const void* a1, long long s1, const void* x1, const void* y1,
                      const void* a2, long long s2, const void* x2, const void* y2, void* o1,
                      void* o2, long long S, long long R, void* partials, void* out,
                      void* stream) {
  return launch_axpy2_dots<double>(a1, s1, x1, y1, a2, s2, x2, y2, o1, o2, S, R, partials, out,
                                   stream);
}

}  // extern "C"
