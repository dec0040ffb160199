// Multi-RHS block kernels of the block-HS CG hot path, written for Hopper (sm_90a).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package:
//
//   br_gram_*     <- src/repro/kernels/fused_reductions.py:287 block_gram
//   br_update_*   <- src/repro/kernels/fused_reductions.py:330 block_update
//   br_update2_*  <- src/repro/kernels/fused_reductions.py:361 block_update2
//
// Operands are stacked column blocks: (S, R, r) row-major, S shards of R rows
// of r right-hand sides; element (s, i, c) sits at (s * R + i) * r + c.
//
// What bounds them on this card: bytes. At the path's r = 8 a Gram costs
// 2 r flops per element read and an update 2 r flops per element moved,
// far below the FP64 ridge of 34 TFLOP/s over 3.35 TB/s (about 10 flops per
// byte), so the least time is the bytes moved over HBM3. The design:
//
// * Row tiles through shared memory. A block stages a tile of rows of every
//   operand in shared memory with coalesced loads: neighbouring threads read
//   neighbouring elements, so for r <= the column tile a warp reads one
//   contiguous run of rows. Each distinct operand is read from HBM once per
//   call; the Gram products and the row-times-(r x r) contractions are then
//   formed from shared memory.
// * Any r. The r x r output (Gram) or the r output columns (updates) are cut
//   into column tiles (kCT = 16 for the Gram, kJC = 32 for the updates) and
//   the inner dimension of the updates into chunks of kKC = 32, so shared
//   memory stays under 48 KB for every r. For r <= the tile width there is
//   one tile and every operand is read exactly once; larger r re-reads an
//   operand's columns once per tile.
// * Loads in flight: a thread issues a batch of global loads before it
//   stores any of them to shared memory (the latency of one load is not
//   paid per element), and the Gram grid holds as many blocks as the card
//   keeps resident, each walking many row tiles.
// * Deterministic Gram reduction, no float atomics: blocks run in no order,
//   so nothing carries an accumulator between them. Each block walks a fixed
//   set of row tiles, keeps its (P, r, r) sums in shared memory, and writes
//   them to partials[S][nblk][P][r][r]; a second launch sums the nblk
//   partials of every entry in a fixed order. nblk depends on the shape and
//   the card only, so the same inputs give the same bits on every run.
// * Coefficients stay on the device: the (r, r) blocks, shared by every
//   shard, and the deflation mask arrive as device pointers; the blocks are
//   staged in shared memory chunk by chunk.
//
// C interface, for ctypes: pointers and the stream are void*, every entry
// returns cudaGetLastError() after its launches (0 = success). Nothing here
// allocates or synchronises; the caller owns outputs and scratch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOps = 4;     // distinct operands of one block_gram call
constexpr int kMaxProds = 6;   // distinct ordered products of one call
constexpr int kCT = 16;        // Gram output column tile
constexpr int kGramSmem = 44 * 1024;  // most dynamic shared bytes of a Gram block (< 48 KB)
constexpr int kJC = 32;        // update output column tile
constexpr int kKC = 32;        // update inner-dimension chunk
constexpr int kUpdTile = 1024; // update outputs per block tile (4 per thread)
constexpr int kLd = 8;         // global loads in flight per thread while staging
constexpr int kMI = 2;         // Gram micro-tile per thread: kMI x kMJ entries
constexpr int kMJ = 4;

template <typename T>
struct GramArgs {
  const T* op[kMaxOps];
  int pa[kMaxProds];  // left operand of each product (X in X^T Y)
  int pb[kMaxProds];  // right operand of each product (Y)
  int n_ops;
  int n_prods;
};

__host__ __device__ inline int gram_tiles(int r) { return (r + kCT - 1) / kCT; }

// Copy rows [0, rows) x columns [c0, c0 + nc) of a row-major (., r) block
// into a rows x nc tile in shared memory with row stride ld. Each thread
// issues kLd loads before it stores any of them, so the loads are in flight
// together. A whole dense run (nc == r == ld) needs no index arithmetic;
// otherwise the row of a flat index comes from a float reciprocal (exact
// here: index < 2^24 and its fraction stays >= 1/(2 nc) from an integer).
template <typename T>
__device__ __forceinline__ void stage(T* __restrict__ dst, int ld, const T* __restrict__ src,
                                      int rows, int r, int c0, int nc) {
  const int cnt = rows * nc;
  const bool dense = nc == r && ld == nc;
  const float inv = 1.0f / (float)nc;
  for (int b0 = 0; b0 < cnt; b0 += kThreads * kLd) {
    T v[kLd];
#pragma unroll
    for (int u = 0; u < kLd; ++u) {
      const int idx = b0 + u * kThreads + threadIdx.x;
      if (idx < cnt) {
        const int t = dense ? 0 : (int)(((float)idx + 0.5f) * inv);
        v[u] = dense ? src[idx] : src[(long long)t * r + c0 + (idx - t * nc)];
      }
    }
#pragma unroll
    for (int u = 0; u < kLd; ++u) {
      const int idx = b0 + u * kThreads + threadIdx.x;
      if (idx < cnt) {
        const int t = dense ? 0 : (int)(((float)idx + 0.5f) * inv);
        dst[dense ? idx : t * ld + (idx - t * nc)] = v[u];
      }
    }
  }
}

// Gram slab row stride: odd, so the rows a warp reads at once fall in
// distinct shared-memory banks.
__host__ __device__ inline int gram_ld(int n) { return n | 1; }

// Shared elements per staged row of all operands (the widest tile).
int gram_row_elems(int r, int n_ops) {
  const int ld = gram_ld(r < kCT ? r : kCT);
  return n_ops * (gram_tiles(r) == 1 ? ld : 2 * ld);
}

// Rows per Gram row tile: the staged slabs fit kGramSmem.
int gram_rows(int r, int n_ops, int itemsize) {
  int tr = kGramSmem / itemsize / gram_row_elems(r, n_ops);
  if (tr > 256) tr = 256;
  return tr < 1 ? 1 : tr;
}

__host__ __device__ inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Stage 1 of block_gram. Block (bx, tile) of shard s walks row tiles
// bx, bx + nblk, ... of its (i-tile, j-tile) of the Gram. Each thread owns a
// kMI x kMJ micro-tile of one product's entries and every G-th row of each
// tile: per row it reads kMI + kMJ values from shared memory for kMI * kMJ
// FMAs, and keeps its sums in registers across all tiles. At the end the G
// partial micro-tiles of each entry are added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)  // 3 resident blocks: loads of one hide behind another
gram_tile_kernel(GramArgs<T> a, long long R, int r, int tr, int nblk, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int s = blockIdx.y;
  const int bx = blockIdx.x % nblk;
  const int tile = blockIdx.x / nblk;
  const int nct = gram_tiles(r);
  const int ti = tile / nct, tj = tile % nct;
  const int i0 = ti * kCT, j0 = tj * kCT;
  const int ni = min(kCT, r - i0), nj = min(kCT, r - j0);
  const bool diag = ti == tj;  // one slab serves both sides
  const int lda = gram_ld(ni);
  const int ldb = diag ? lda : gram_ld(nj);
  const int per_op = tr * (diag ? lda : lda + ldb);
  const int mi = (ni + kMI - 1) / kMI, mj = (nj + kMJ - 1) / kMJ;
  const int n_mt = a.n_prods * mi * mj;  // <= kMaxProds * 32 <= kThreads
  const int G = kThreads / n_mt;
  const int mt = threadIdx.x / G, g = threadIdx.x - mt * G;
  const bool active = mt < n_mt;
  const int p = active ? mt / (mi * mj) : 0;
  const int ib = active ? (mt - p * mi * mj) / mj * kMI : 0;
  const int jb = active ? (mt - p * mi * mj) % mj * kMJ : 0;
  const T* as = smem + a.pa[p] * per_op;
  const T* bs = smem + a.pb[p] * per_op + (diag ? 0 : tr * lda);
  int ia[kMI], jv[kMJ];  // clamped: entries past the tile are computed, not kept
#pragma unroll
  for (int u = 0; u < kMI; ++u) ia[u] = min(ib + u, ni - 1);
#pragma unroll
  for (int v = 0; v < kMJ; ++v) jv[v] = min(jb + v, nj - 1);
  T acc[kMI][kMJ];
#pragma unroll
  for (int u = 0; u < kMI; ++u)
#pragma unroll
    for (int v = 0; v < kMJ; ++v) acc[u][v] = T(0);

  const long long nrt = ceil_div(R, tr);
  for (long long rt = bx; rt < nrt; rt += nblk) {
    const long long row0 = rt * tr;
    const int rows = (int)(R - row0 < tr ? R - row0 : tr);
    __syncthreads();  // the previous tile's slabs are consumed
    for (int o = 0; o < a.n_ops; ++o) {
      const T* src = a.op[o] + ((long long)s * R + row0) * r;
      stage(smem + o * per_op, lda, src, rows, r, i0, ni);
      if (!diag) stage(smem + o * per_op + tr * lda, ldb, src, rows, r, j0, nj);
    }
    __syncthreads();
    if (active) {
      // the tile's rows are summed apart and then added to the running sums,
      // so no sum runs over more than one tile's rows or one block's tiles
      T part[kMI][kMJ];
#pragma unroll
      for (int u = 0; u < kMI; ++u)
#pragma unroll
        for (int v = 0; v < kMJ; ++v) part[u][v] = T(0);
      for (int t = g; t < rows; t += G) {
        T av[kMI], bv[kMJ];
#pragma unroll
        for (int u = 0; u < kMI; ++u) av[u] = as[t * lda + ia[u]];
#pragma unroll
        for (int v = 0; v < kMJ; ++v) bv[v] = bs[t * ldb + jv[v]];
#pragma unroll
        for (int u = 0; u < kMI; ++u)
#pragma unroll
          for (int v = 0; v < kMJ; ++v) part[u][v] += av[u] * bv[v];
      }
#pragma unroll
      for (int u = 0; u < kMI; ++u)
#pragma unroll
        for (int v = 0; v < kMJ; ++v) acc[u][v] += part[u][v];
    }
  }
  __syncthreads();  // the slabs become the reduction scratch
  constexpr int kMT = kMI * kMJ;
  if (active) {
#pragma unroll
    for (int u = 0; u < kMI; ++u)
#pragma unroll
      for (int v = 0; v < kMJ; ++v) smem[threadIdx.x * kMT + u * kMJ + v] = acc[u][v];
  }
  __syncthreads();
  const long long rr = (long long)r * r;
  T* dst = partials + ((long long)s * nblk + bx) * a.n_prods * rr;
  for (int e = threadIdx.x; e < n_mt * kMT; e += kThreads) {
    const int m = e / kMT, q = e - m * kMT;
    const int pm = m / (mi * mj);
    const int i = (m - pm * mi * mj) / mj * kMI + q / kMJ;
    const int j = (m - pm * mi * mj) % mj * kMJ + q % kMJ;
    if (i < ni && j < nj) {
      T v = T(0);
      for (int gg = 0; gg < G; ++gg) v += smem[(m * G + gg) * kMT + q];
      dst[pm * rr + (long long)(i0 + i) * r + j0 + j] = v;
    }
  }
}

// Stage 2: out[s][k] = sum over b of partials[s][b][k], b in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_sum_kernel(const T* __restrict__ partials, int nblk, long long K, T* __restrict__ out) {
  const int s = blockIdx.y;
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= K) return;
  const T* src = partials + (long long)s * nblk * K + k;
  T v = T(0);
  for (int b = 0; b < nblk; ++b) v += src[(long long)b * K];
  out[(long long)s * K + k] = v;
}

// o_t = y_t * mask + x_t @ M_t for NT terms (block_update: NT = 1 with an
// optional mask; block_update2: NT = 2, no mask). Block (rt, s, jt) owns
// rows [rt * tr, rt * tr + tr) and output columns [jt * kJC, + nj) of shard
// s; the inner dimension runs in chunks of kKC through shared memory.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
update_kernel(const T* __restrict__ m0, const T* __restrict__ m1,
              const T* __restrict__ mask, const T* __restrict__ x0, const T* __restrict__ x1,
              const T* __restrict__ y0, const T* __restrict__ y1, T* __restrict__ o0,
              T* __restrict__ o1, long long R, int r, int tr) {
  __shared__ T xs[NT][kUpdTile];
  __shared__ T ms[NT][kKC * kJC];
  const int s = blockIdx.y;
  const int j0 = blockIdx.z * kJC;
  const int nj = min(kJC, r - j0);
  const long long row0 = (long long)blockIdx.x * tr;
  const int rows = (int)(R - row0 < tr ? R - row0 : tr);
  const long long base = ((long long)s * R + row0) * r;
  const T* xp[2] = {x0 + base, NT > 1 ? x1 + base : nullptr};
  const T* mp[2] = {m0, m1};
  constexpr int kItems = kUpdTile / kThreads;
  T acc[NT][kItems];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int it = 0; it < kItems; ++it) acc[q][it] = T(0);

  for (int k0 = 0; k0 < r; k0 += kKC) {
    const int kc = min(kKC, r - k0);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      stage(xs[q], kc, xp[q], rows, r, k0, kc);
      stage(ms[q], nj, mp[q] + (long long)k0 * r, kc, r, j0, nj);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int t = e / nj;
      if (t < rows) {
        const int j = e - t * nj;
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          T v = acc[q][it];
          for (int c = 0; c < kc; ++c) v += xs[q][t * kc + c] * ms[q][c * nj + j];
          acc[q][it] = v;
        }
      }
    }
  }
  // epilogue: every y load of the thread is issued before the first store
  const T* yp[2] = {y0 + base, NT > 1 ? y1 + base : nullptr};
  T* op[2] = {o0 + base, NT > 1 ? o1 + base : nullptr};
  T yv[NT][kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int t = e / nj;
#pragma unroll
    for (int q = 0; q < NT; ++q)
      yv[q][it] = t < rows ? yp[q][(long long)t * r + j0 + (e - t * nj)] : T(0);
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int t = e / nj;
    if (t < rows) {
      const int j = e - t * nj;
      const long long at = (long long)t * r + j0 + j;
#pragma unroll
      for (int q = 0; q < NT; ++q)
        op[q][at] = (mask != nullptr ? yv[q][it] * mask[j0 + j] : yv[q][it]) + acc[q][it];
    }
  }
}

// Shared bytes a Gram block of this shape uses: the staged slabs, at least
// the per-thread micro-tiles of the final reduction.
int gram_smem(int r, int n_ops, int itemsize) {
  const int slabs = gram_rows(r, n_ops, itemsize) * gram_row_elems(r, n_ops);
  const int red = kThreads * kMI * kMJ;
  return (slabs > red ? slabs : red) * itemsize;
}

// Blocks per shard and column tile: as many as the card holds at once (the
// occupancy of gram_tile_kernel times the SM count), at most one per row
// tile. It depends on the shape and the card only, so a run's partials are
// summed in the same order every time.
template <typename T>
int gram_nblk(long long S, long long R, int r, int n_ops) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gram_tile_kernel<T>, kThreads, gram_smem(r, n_ops, (int)sizeof(T)));
  const long long nct = gram_tiles(r);
  const long long nrt = ceil_div(R, gram_rows(r, n_ops, (int)sizeof(T)));
  long long nb = (long long)sms * per_sm / (S * nct * nct);
  if (nb < 1) nb = 1;
  return (int)(nb < nrt ? nb : nrt);
}

bool bad_block(long long S, long long R, int r) {
  return S < 1 || S > 65535 || R < 1 || r < 1;
}

int update_rows(int r) {
  const int nj = r < kJC ? r : kJC;
  return kUpdTile / nj;
}

template <typename T>
int launch_gram(const void* p0, const void* p1, const void* p2, const void* p3, int n_ops,
                int n_prods, int code, long long S, long long R, int r, void* partials,
                void* out, void* stream) {
  if (bad_block(S, R, r) || n_ops < 1 || n_ops > kMaxOps || n_prods < 1 ||
      n_prods > kMaxProds)
    return (int)cudaErrorInvalidValue;
  GramArgs<T> a;
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
  const int tr = gram_rows(r, n_ops, (int)sizeof(T));
  const int nblk = gram_nblk<T>(S, R, r, n_ops);
  const long long nct = gram_tiles(r);
  const long long gx = (long long)nblk * nct * nct;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  gram_tile_kernel<T><<<dim3((unsigned)gx, (unsigned)S), kThreads,
                        gram_smem(r, n_ops, (int)sizeof(T)), st>>>(
      a, R, r, tr, nblk, (T*)partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long K = (long long)n_prods * r * r;
  gram_sum_kernel<T><<<dim3((unsigned)ceil_div(K, kThreads), (unsigned)S), kThreads, 0, st>>>(
      (const T*)partials, nblk, K, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
int launch_update(const void* m0, const void* m1, const void* mask,
                  const void* x0, const void* x1, const void* y0, const void* y1, void* o0,
                  void* o1, long long S, long long R, int r, void* stream) {
  if (bad_block(S, R, r))
    return (int)cudaErrorInvalidValue;
  const int tr = update_rows(r);
  const long long nct = ceil_div(r, kJC);
  if (nct > 65535) return (int)cudaErrorInvalidValue;
  update_kernel<T, NT><<<dim3((unsigned)ceil_div(R, tr), (unsigned)S, (unsigned)nct), kThreads,
                         0, (cudaStream_t)stream>>>(
      (const T*)m0, (const T*)m1, (const T*)mask, (const T*)x0, (const T*)x1,
      (const T*)y0, (const T*)y1, (T*)o0, (T*)o1, R, r, tr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile partials of block_gram: the caller sizes partials as
// S * br_gram_nblk(...) * n_prods * r * r elements.
int br_gram_nblk(long long S, long long R, int r, int n_ops, int itemsize) {
  if (bad_block(S, R, r) || n_ops < 1) return 0;
  return itemsize == 4 ? gram_nblk<float>(S, R, r, n_ops) : gram_nblk<double>(S, R, r, n_ops);
}

// Products are packed 4 bits each into `code`: product j is
// op[(code >> (4j + 2)) & 3]^T @ op[(code >> 4j) & 3]. out is (S, n_prods, r, r).
int br_gram_f32(const void* p0, const void* p1, const void* p2, const void* p3, int n_ops,
                int n_prods, int code, long long S, long long R, int r, void* partials, void* out,
                void* stream) {
  return launch_gram<float>(p0, p1, p2, p3, n_ops, n_prods, code, S, R, r, partials, out,
                            stream);
}
int br_gram_f64(const void* p0, const void* p1, const void* p2, const void* p3, int n_ops,
                int n_prods, int code, long long S, long long R, int r, void* partials, void* out,
                void* stream) {
  return launch_gram<double>(p0, p1, p2, p3, n_ops, n_prods, code, S, R, r, partials, out,
                             stream);
}

// o = y * mask + x @ m for every shard; m is (r, r), mask is (r,) or null.
int br_update_f32(const void* m, const void* mask, const void* x,
                  const void* y, void* o, long long S, long long R, int r, void* stream) {
  return launch_update<float, 1>(m, nullptr, mask, x, nullptr, y, nullptr, o, nullptr,
                                 S, R, r, stream);
}
int br_update_f64(const void* m, const void* mask, const void* x,
                  const void* y, void* o, long long S, long long R, int r, void* stream) {
  return launch_update<double, 1>(m, nullptr, mask, x, nullptr, y, nullptr, o,
                                  nullptr, S, R, r, stream);
}

// (o1, o2) = (y1 + x1 @ a1, y2 + x2 @ a2) for every shard; a1, a2 are (r, r).
int br_update2_f32(const void* a1, const void* x1, const void* y1, const void* a2,
                   const void* x2, const void* y2, void* o1, void* o2,
                   long long S, long long R, int r, void* stream) {
  return launch_update<float, 2>(a1, a2, nullptr, x1, x2, y1, y2, o1, o2, S, R, r,
                                 stream);
}
int br_update2_f64(const void* a1, const void* x1, const void* y1, const void* a2,
                   const void* x2, const void* y2, void* o1, void* o2,
                   long long S, long long R, int r, void* stream) {
  return launch_update<double, 2>(a1, a2, nullptr, x1, x2, y1, y2, o1, o2, S, R, r,
                                  stream);
}

}  // extern "C"
