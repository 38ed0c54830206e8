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
//    the rows are the only parallel axis (about 1000 chains at n = 1000).
//    Design: a CTA owns ROWS = 8 rows (125 CTAs at n = 1000, one wave) and
//    walks tiles of 8 rows x W = 256 columns from right to left through a
//    ring of STAGES tiles in shared memory, with three warps and no CTA
//    barrier after the set-up. When a row's stride is a whole number of
//    16-byte words (and X and S are 16-byte aligned), rows move by bulk
//    (TMA) copies; otherwise element by element.
//    - a producer warp fills the ring: one lane issues a bulk copy per row
//      of a tile, completing on the stage's `full` mbarrier (or every lane
//      issues element cp.asyncs, each lane's completion arriving on
//      `full`). It refills a stage once the store warp has arrived on its
//      `empty` mbarrier. Only the columns and rows that exist are copied:
//      nothing is zero-filled.
//    - a fold warp: lane r (< ROWS) folds row r. It reads its row of a tile
//      into registers AHEAD chunks (NV 16-byte vectors each) ahead, the
//      next tile's first chunks during the last ones of this one, so the
//      chain is pure adds; it writes each folded chunk back in place and
//      arrives on the stage's `folded` mbarrier. Rows are padded by 16
//      bytes in the ring, so the 8 lanes' vector reads hit distinct banks.
//      The fold starts at column p - 1 with acc = -0.0 (x + -0 == x for
//      every x, -0 included) and skips the absent columns left of column 0
//      in the last tile; rows past n are neither folded nor stored.
//    - a store warp writes the folded tile out: one lane issues a bulk
//      store per row (after the fold lanes' proxy fence) and releases a
//      stage once its stores have read it (element stores measured slower
//      in float32); or every lane writes elements, coalesced, and arrives
//      on `empty`.
//    The tunables (AHEAD, NV, STAGES, BULK_STORE) are the fastest of the
//    variants scripts/chain_variants_torch.py times (PERF.md section 6).
//
// add_latency — a measuring aid, on no path: one thread runs a chain of
//    dependent adds between two clock64() reads, so that the latency
//    floor above can be stated in cycles measured on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;            // rows per CTA (one folding lane each)
constexpr int W = 256;             // columns per tile
constexpr int NTH = 96;            // producer, fold and store warps
constexpr int PAD = 16;            // bytes after each row of a stage
constexpr int AHEAD = 1;           // chunks the fold reads ahead (1 or 3)
// rows of whole 16-byte words leave a stage by one bulk (TMA) store a row;
// false: one element a lane, as other rows do
constexpr bool BULK_STORE = true;

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

// 16-byte vectors of T, and their i-th element (i known at compile time)
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int N = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int N = 2; };
__device__ __forceinline__ float& at(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double& at(double2& v, int i) {
  return i == 0 ? v.x : v.y;
}

template <typename T>
struct Ring {
  static constexpr int RS = W + PAD / (int)sizeof(T);   // row stride, elements
  static constexpr int STAGE = ROWS * RS;               // elements a stage
  static constexpr int STAGES = sizeof(T) == 8 ? 6 : 10;
  static constexpr int NV = 8;                          // vectors a chunk
  static constexpr int CH = NV * Vec<T>::N;             // values a chunk
  static constexpr size_t SMEM =
      (size_t)STAGES * STAGE * sizeof(T) + 3 * STAGES * sizeof(uint64_t);
  static_assert(W % CH == 0 && (W / CH) % (AHEAD + 1) == 0,
                "whole chunks a tile, a whole number of read-ahead rounds");
  static_assert((RS * sizeof(T)) % 16 == 0, "16-byte aligned rows");
};

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(saddr(bar)), "r"(count) : "memory");
}
// One thread: the next phase of `bar` waits for `bytes` more of copies.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(saddr(bar)), "r"(bytes) : "memory");
}
// One thread: a bulk (TMA) copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar))
               : "memory");
}
// One thread: a bulk (TMA) copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from shared to global memory, in this thread's current
// bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(saddr(src)), "r"(bytes) : "memory");
}
// cp.async of one element of N bytes from global to shared memory
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
               :: "r"(saddr(dst)), "l"(src), "n"(N) : "memory");
}
// `bar` receives one arrival once this thread's earlier cp.asyncs land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(saddr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{ .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(saddr(bar)), "r"(parity) : "memory");
}

// BULK: rows are whole 16-byte words (p * sizeof(T) % 16 == 0, X and S
// 16-byte aligned), so each row of a tile moves by one bulk copy;
// otherwise element by element.
template <typename T, bool BULK>
__global__ void __launch_bounds__(NTH)
chain_suffix_kernel(const T* __restrict__ X, T* __restrict__ S, int n, int p) {
  using RG = Ring<T>;
  using V = typename Vec<T>::type;
  constexpr int VN = Vec<T>::N, NV = RG::NV, CH = RG::CH, NB = AHEAD + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + (size_t)RG::STAGES * RG::STAGE * sizeof(T));
  uint64_t* folded = full + RG::STAGES;
  uint64_t* empty = folded + RG::STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * ROWS;
  const int rows = n - r0 < ROWS ? n - r0 : ROWS;
  const int n_tiles = (p + W - 1) / W;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RG::STAGES; ++s) {
      bar_init(full + s, BULK ? 1 : 32);
      bar_init(folded + s, ROWS);
      bar_init(empty + s, BULK && BULK_STORE ? 1 : 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tile t spans global columns [p - (t+1) W, p - t W) and sits in stage
  // t % STAGES; local column c is global column base + c, absent (c < lo)
  // in the last tile when W does not divide p
  if (warp == 0) {                                  // producer
    if (BULK && lane != 0) return;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % RG::STAGES;
      if (t >= RG::STAGES) bar_wait(empty + s, ((t / RG::STAGES) - 1) & 1);
      const int base = p - (t + 1) * W;
      const int lo = base < 0 ? -base : 0;
      T* st = ring + (size_t)s * RG::STAGE + lo;
      const T* src = X + (size_t)r0 * p + (base + lo);
      if constexpr (BULK) {
        const unsigned bytes = (unsigned)((W - lo) * sizeof(T));
        bar_expect(full + s, bytes * rows);
        for (int r = 0; r < rows; ++r)
          bulk_copy(st + r * RG::RS, src + (size_t)r * p, bytes, full + s);
      } else {
        for (int r = 0; r < rows; ++r)
          for (int c = lane; c < W - lo; c += 32)
            cp_async<sizeof(T)>(st + r * RG::RS + c, src + (size_t)r * p + c);
        cp_async_arrive(full + s);
      }
    }
  } else if (warp == 1) {                           // fold
    if (lane >= ROWS) return;
    constexpr int NQ = W / CH;                      // chunks a tile
    const bool live = lane < rows;
    T acc = T(-0.0);
    // chunk i of a whole tile (i-th from the right) sits in buf[i % NB];
    // NB divides NQ, so the next tile's first AHEAD chunks land where
    // that tile will look for them
    V buf[NB][NV];
    auto load = [&](V (&c)[NV], const T* src) {
#pragma unroll
      for (int v = 0; v < NV; ++v) c[v] = *reinterpret_cast<const V*>(src + v * VN);
    };
    bool have = false;       // the tile's first AHEAD chunks already read
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % RG::STAGES;
      if (!have) bar_wait(full + s, (t / RG::STAGES) & 1);
      const int base = p - (t + 1) * W;
      T* row = ring + (size_t)s * RG::STAGE + lane * RG::RS;
      if (base >= 0) {                              // a whole tile
        if (!have && live)
#pragma unroll
          for (int i = 0; i < AHEAD; ++i) load(buf[i], row + W - (i + 1) * CH);
        // the next tile is whole too: read its first chunks during this one
        const bool next = t + 1 < n_tiles && base >= W;
        const int s2 = (t + 1) % RG::STAGES;
        const T* row2 = ring + (size_t)s2 * RG::STAGE + lane * RG::RS;
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const int ia = i + AHEAD;                 // the chunk read now
          if (ia < NQ) {
            if (live) load(buf[ia % NB], row + W - (ia + 1) * CH);
          } else if (next) {
            if (ia == NQ) bar_wait(full + s2, ((t + 1) / RG::STAGES) & 1);
            if (live) load(buf[ia % NB], row2 + W - (ia - NQ + 1) * CH);
          }
          if (live) {
            V (&c)[NV] = buf[i % NB];
#pragma unroll
            for (int v = NV - 1; v >= 0; --v)
#pragma unroll
              for (int e = VN - 1; e >= 0; --e) {
                acc = add_rn(at(c[v], e), acc);
                at(c[v], e) = acc;
              }
#pragma unroll
            for (int v = 0; v < NV; ++v)
              *reinterpret_cast<V*>(row + W - (i + 1) * CH + v * VN) = c[v];
          }
        }
        have = next;
      } else if (live) {                            // the last, partial tile
        for (int c = W - 1; c >= -base; --c) {
          acc = add_rn(row[c], acc);
          row[c] = acc;
        }
      }
      // the folded tile, written by the generic proxy, is read next by a
      // bulk store, an async-proxy read
      if (BULK && BULK_STORE)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive(folded + s);
    }
  } else {                                          // store
    if (BULK && BULK_STORE) {
      // one lane: a bulk store a row, one bulk group a tile; a stage is
      // released once the next tile's stores are issued and its own have
      // read it
      if (lane != 0) return;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % RG::STAGES;
        bar_wait(folded + s, (t / RG::STAGES) & 1);
        const int base = p - (t + 1) * W;
        const int lo = base < 0 ? -base : 0;
        const T* st = ring + (size_t)s * RG::STAGE + lo;
        T* dst = S + (size_t)r0 * p + (base + lo);
        const unsigned bytes = (unsigned)((W - lo) * sizeof(T));
        for (int r = 0; r < rows; ++r)
          bulk_store(dst + (size_t)r * p, st + r * RG::RS, bytes);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        if (t > 0) bar_arrive(empty + (t - 1) % RG::STAGES);
      }
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      return;
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % RG::STAGES;
      bar_wait(folded + s, (t / RG::STAGES) & 1);
      const int base = p - (t + 1) * W;
      const int lo = base < 0 ? -base : 0;
      const T* st = ring + (size_t)s * RG::STAGE + lo;
      T* dst = S + (size_t)r0 * p + (base + lo);
      for (int r = 0; r < rows; ++r)
#pragma unroll 8
        for (int c = lane; c < W - lo; c += 32)
          dst[(size_t)r * p + c] = st[r * RG::RS + c];
      // the fold wrote the stage in place (generic proxy); the producer's
      // next bulk copy into it is an async-proxy write
      if (BULK) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive(empty + s);
    }
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

template <typename T, bool BULK>
int launch_k(const void* X, void* S, int n, int p, void* stream) {
  const size_t smem = Ring<T>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      chain_suffix_kernel<T, BULK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + ROWS - 1) / ROWS;
  chain_suffix_kernel<T, BULK><<<grid, NTH, smem, (cudaStream_t)stream>>>(
      (const T*)X, (T*)S, n, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* X, void* S, int n, int p, void* stream) {
  if (n <= 0 || p <= 0) return (int)cudaGetLastError();
  const bool bulk = ((size_t)p * sizeof(T)) % 16 == 0 &&
                    (uintptr_t)X % 16 == 0 && (uintptr_t)S % 16 == 0;
  return bulk ? launch_k<T, true>(X, S, n, p, stream)
              : launch_k<T, false>(X, S, n, p, stream);
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
