// Chain fused-LASSO column transform for Hopper (sm_90a), plain C interface
// for ctypes.
//
// K4 chain_suffix_sums — replaces repro/kernels/fused/fused.py:76
//    chain_suffix_sums_pallas. For the 1-D fused LASSO (the path graph
//    rooted at column 0) Theorem 6's transform is the column suffix sum
//        S[:, v] = X[:, v] + S[:, v+1],   S[:, p-1] = X[:, p-1],
//    one IEEE add per column, in this order, so that S is bitwise the
//    reference's exact right fold (numpy transform_design). Every add is
//    __dadd_rn / __fadd_rn: nothing is contracted or re-associated.
//    Bound on this card: the bytes, X read once and S written once
//    (2 n p itemsize; 1.6 GB at n = 1000, p = 100,000 in float64, 0.48 ms
//    at 3.35 TB/s). Under that sits a latency floor: each row is a chain
//    of p - 1 dependent adds, and a split along p would re-associate, so
//    the rows are the only parallel axis (about 1000 threads at n = 1000).
//    Design: X is row-major, so a thread-per-row walk would stride by p
//    across a warp. A CTA owns ROWS = 8 rows and walks tiles of W = 256
//    columns from right to left. All 256 threads load a tile coalesced
//    (each warp reads 32 neighbouring columns of one row) into registers
//    one tile ahead, then into a padded shared-memory tile (double
//    buffered: two barriers per tile); 8 threads, one per row, fold the
//    tile right to left, each carrying its row's running sum in a register;
//    then all threads write the tile back coalesced. At n = 1000 that is
//    125 CTAs, about one per SM, each with 16 KB of loads in flight while
//    it folds the previous tile.
//
// add_latency — a measuring aid, on no path: one thread runs a chain of
//    dependent adds between two clock64() reads, so that the latency
//    floor above can be stated in cycles measured on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per CTA
constexpr int ROWS = 8;            // rows per CTA (one folding thread each)
constexpr int W = 256;             // columns per tile
constexpr int PER = ROWS * W / NT; // elements each thread moves per tile

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(NT)
chain_suffix_kernel(const T* __restrict__ X, T* __restrict__ S, int n, int p) {
  // +1 column of padding: the 8 folding threads read one column of 8 rows
  // at a time, which would otherwise fall in one bank
  __shared__ T tile[2][ROWS][W + 1];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int n_tiles = (p + W - 1) / W;
  T reg[PER];

  // tile t spans global columns [p - (t+1) W, p - t W); local column c is
  // global column p - (t+1) W + c, absent (c below the edge) in the last,
  // partial tile
  auto load = [&](int t) {
    const int base = p - (t + 1) * W;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * NT;
      const int row = r0 + e / W, col = base + e % W;
      reg[q] = (row < n && col >= 0) ? X[(size_t)row * p + col] : T(0);
    }
  };

  load(0);
  T acc = T(-0.0);                 // x + (-0) == x for every x, -0 included
  for (int t = 0; t < n_tiles; ++t) {
    T(*tl)[W + 1] = tile[t & 1];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * NT;
      tl[e / W][e % W] = reg[q];
    }
    __syncthreads();
    if (t + 1 < n_tiles) load(t + 1);   // in flight while the tile folds
    const int base = p - (t + 1) * W;
    const int lo = base < 0 ? -base : 0;
    if (tid < ROWS) {
      T* row = tl[tid];
#pragma unroll 8
      for (int c = W - 1; c >= lo; --c) {
        acc = add_rn(row[c], acc);
        row[c] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * NT;
      const int row = r0 + e / W, col = base + e % W;
      if (row < n && col >= 0) S[(size_t)row * p + col] = tl[e / W][e % W];
    }
    // the next tile fills the other buffer; this one is refilled only
    // after the next iteration's first barrier, which every thread reaches
    // after its stores above
  }
}

template <typename T>
__global__ void add_latency_kernel(int n_adds, long long* cycles, T* buf) {
  const T x = buf[0];
  T acc = buf[1];
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n_adds; ++i) acc = add_rn(acc, x);
  const long long t1 = clock64();
  buf[1] = acc;
  cycles[0] = t1 - t0;
}

template <typename T>
int launch(const void* X, void* S, int n, int p, void* stream) {
  const int grid = (n + ROWS - 1) / ROWS;
  if (grid > 0 && p > 0)
    chain_suffix_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const T*)X, (T*)S, n, p);
  return (int)cudaGetLastError();
}

template <typename T>
int latency(int n_adds, void* cycles, void* buf, void* stream) {
  add_latency_kernel<T><<<1, 1, 0, (cudaStream_t)stream>>>(
      n_adds, (long long*)cycles, (T*)buf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int chain_suffix_sums_f32(const void* X, void* S, int n, int p, void* stream) {
  return launch<float>(X, S, n, p, stream);
}
int chain_suffix_sums_f64(const void* X, void* S, int n, int p, void* stream) {
  return launch<double>(X, S, n, p, stream);
}
int add_latency_f32(int n_adds, void* cycles, void* buf, void* stream) {
  return latency<float>(n_adds, cycles, buf, stream);
}
int add_latency_f64(int n_adds, void* cycles, void* buf, void* stream) {
  return latency<double>(n_adds, cycles, buf, stream);
}

}  // extern "C"
