// Group-LASSO block coordinate descent for Hopper (sm_90a), plain C
// interface for ctypes.
//
// B-n3 group_bcd — replaces the burst of src/repro/core/group.py:114
//    _gsaif_jit (the fori_loops at :165 and :169) and the epoch of the
//    unscreened oracle :67 solve_group_lasso_bcd (the fori_loop at :91),
//    XLA loops with no Pallas kernel. n_epochs cyclic sweeps over the live
//    slots of a group active set, in slot order, each a block step of the
//    group soft-threshold:
//        g    = X_j^T f'(z)                      (gsize dot products)
//        v    = beta_j - g / L_j
//        b    = v * max(0, 1 - (lam / L_j) / max(||v||, 1e-30))
//        z   += X_j (b - beta_j),  beta_j = b
//    from z = sum_j X_j beta_j over the live slots (group.py:171). The
//    wrapper (kernels/group/group.py) gathers the live groups' blocks once
//    a launch into A (live, gsize, n), each column of a block a contiguous
//    row of A, and passes the live slots' ids in slot order; L_j (the
//    caller's max(alpha ||X_j||_F^2, 1e-30)) comes in per slot. Least
//    squares and logistic (f'(z) = -y / (1 + exp(y z)), an exp a row a
//    step), float32 and float64.
//    A masked slot is skipped. That is exact: the reference's block of a
//    masked slot is zero and its step writes 0, so neither z nor any
//    other beta moves; the wrapper zeroes its beta (when n_epochs > 0) as
//    that step would.
//    Bound on this card: n_epochs * live dependent block steps. The bytes
//    (the live block once, 80 KB a slot at n = 1000, gsize 10 in f64) and
//    operations (~4 n gsize a step) are small against a step's latency,
//    and the live block (25 MB at 314 live groups) sits in L2, so what
//    bounds a step is its chain: a pass over the thread's rows (the
//    previous step's update of z, f'(z), the gsize partial dots), the
//    block reduction of gsize sums, gsize divisions, the norm's serial
//    fmas, a square root and a division; and under the chain, the read
//    rate from L2 of the SMs that hold the rows (one SM reads about 95
//    GB/s, 0.83 us for a block of 80 KB: PERF.md section 6).
//    Design: the burst is NT = 512 threads' work; thread t owns the rows
//    t, t + 512, and warp w's partial sums are its lanes' by a fixed tree.
//    Two forms, chosen by the wrapper's gate (kernels/group/group.py::
//    group_form), each its own entry:
//    * the register form (group_bcd_reg_*; n <= 1024 and gsize <= 10): a
//      cluster of CLUSTER = 8 CTAs of 64 threads, CTA k holding threads
//      64 k ..., so each SM reads an eighth of a block a step, and a
//      thread has registers for two sets of its 2 rows of a block's 10
//      columns. The wrapper lays a block out as (gsize, 512, 2) (the
//      thread's two rows of a column side by side), so each column is one
//      16-byte load a thread (as 20 8-byte loads, they held each warp
//      about 1,000 cycles before the last one left). The step's block stays
//      in registers for the next step's update of z (no re-read), and the
//      next step's block is loaded into the other set right after the
//      step's barrier wait, where it flies behind the tail and the next
//      update (loaded at the start of its own step, before the update or
//      at the end of the tail, a step took 20-30 % longer). One barrier
//      wait a step: each warp sends its column sums to every CTA of the
//      cluster (st.async, counted on the receiver's barrier of the step's
//      parity, so no CTA waits for its stores to land), and after the
//      wait every warp forms all gsize column sums, v, ||v||, the scale
//      and d itself (its lanes share v and d through the warp's own slice
//      of shared memory, and a vote tells whether the step moved
//      anything). A warp's gsize shuffle trees are folded into one another
//      (two columns share a shuffle at the first level, four at the
//      second, ...), so a warp sums 10 columns with 12 shuffles instead of
//      50, and lane brev5(c) ends with column c's sum. Every warp's lane
//      brev5(c) keeps its slot's beta_c in a register: it reads it from
//      its CTA's copy of the live slots' beta before the wait (or, with
//      one live slot, keeps the b it formed the step before), and warp 0's
//      lane writes the new b after it, so no read of a step races that
//      step's write; every CTA keeps the same copy, and CTA 0 writes beta.
//    * the chunked form (group_bcd_*; any n and gsize <= 256 within the
//      shared-memory gate): one CTA of 512 threads; z, y and the rows'
//      gradients in shared memory, a pass over the rows CH = 8 columns at
//      a time, the previous step's update of z re-read from its block,
//      three barriers a step (the warp sums, then v, then b and d with a
//      __syncthreads_or).
//    Both forms compute every number the same way, and so give the same
//    bits: the row's update of z is its gsize products summed first, then
//    added (one rounding at z's scale, as the plain version's addmv),
//    every product an explicit fma, each thread's sums over its rows
//    ascending, each column summed over a warp's lanes by the shuffle-down
//    tree 16 -> 1 and over the 16 warps by the same tree (the folded trees
//    add the same pairs: a + b = b + a), ||v||^2 an fma chain over the
//    columns ascending, the same divisions. A launch is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;            // threads of a burst
constexpr int NW = NT / 32;
constexpr int CH = 8;              // the chunked form's columns a pass
constexpr int ROWS = 2;            // the register form's rows a thread
constexpr int COLS = 10;           // and its column bound
constexpr int CLUSTER = 8;         // and its CTAs, NT / CLUSTER threads each
constexpr int LS = 0, LOGIT = 1;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return ::exp(x); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T, int L>
__device__ __forceinline__ T grad(T z, T y) {
  if (L == LS) return z - y;
  return -y * (T(1) / (T(1) + exp_t(y * z)));       // -y sigmoid(-y z)
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// row i of X_j d: the step's update of z_i, summed before it is added to
// z_i (one rounding at z's scale a step, as the plain version's addmv)
template <typename T>
__device__ __forceinline__ T row_update(const T* __restrict__ blk,
                                        const T* d, int i, int n, int gsz) {
  T u = T(0);
  for (int c = 0; c < gsz; ++c) u = fma_rn(blk[(size_t)c * n + i], d[c], u);
  return u;
}

// ---------------------------------------------------------------------------
// the chunked form
// ---------------------------------------------------------------------------

template <typename T, int L>
__global__ void __launch_bounds__(NT, 1) group_bcd_kernel(
    const T* __restrict__ A, const T* __restrict__ y,
    const int* __restrict__ slot, T* __restrict__ beta,
    const T* __restrict__ Lg, T lam, int n_ep, int n, int nl, int gsz,
    T* __restrict__ zout) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* zs = reinterpret_cast<T*>(smem);   // z (n)
  T* ys = zs + n;                       // y (n)
  T* gr = ys + n;                       // f'(z) of the rows (n)
  T* bs = gr + n;                       // the live slots' beta (nl, gsz)
  T* ls = bs + (size_t)nl * gsz;        // their L (nl)
  T* ts = ls + nl;                      // their lam / L (nl)
  T* red = ts + nl;                     // warp sums (NW, gsz)
  T* vv = red + NW * gsz;               // v of the step (gsz)
  T* dv = vv + gsz;                     // b - beta of the step (gsz)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t blk = (size_t)gsz * n;   // elements of one block of A
  for (int i = tid; i < n; i += NT) ys[i] = y[i];
  for (int e = tid; e < nl * gsz; e += NT)
    bs[e] = beta[(size_t)slot[e / gsz] * gsz + e % gsz];
  for (int s = tid; s < nl; s += NT) {
    ls[s] = Lg[slot[s]];
    ts[s] = lam / ls[s];
  }
  __syncthreads();

  // z = sum over the live slots of X_j beta_j, the thread's rows
  for (int i = tid; i < n; i += NT) {
    T acc = T(0);
    for (int s = 0; s < nl; ++s) {
      const T* a = A + s * blk + i;
      const T* bj = bs + (size_t)s * gsz;
      T u = T(0);                       // X_j beta_j, then added to z
      for (int c = 0; c < gsz; ++c) u = fma_rn(a[(size_t)c * n], bj[c], u);
      acc += u;
    }
    zs[i] = acc;
  }

  bool moved = false;                   // the previous step's d is nonzero
  const T* prev = A;                    // the previous step's block
  for (int ep = 0; ep < n_ep; ++ep) {
    for (int s = 0; s < nl; ++s) {
      const T* cur = A + s * blk;
      for (int q = 0; q < gsz; q += CH) {
        T part[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) part[c] = T(0);
        for (int i = tid; i < n; i += NT) {
          T a[CH];                      // this chunk's columns of the row
#pragma unroll
          for (int c = 0; c < CH; ++c)
            a[c] = q + c < gsz ? cur[(size_t)(q + c) * n + i] : T(0);
          T g;
          if (q == 0) {                 // the previous step's update, f'(z)
            T zi = zs[i];
            if (moved) {
              zi += row_update(prev, dv, i, n, gsz);
              zs[i] = zi;
            }
            g = grad<T, L>(zi, ys[i]);
            gr[i] = g;
          } else {
            g = gr[i];
          }
#pragma unroll
          for (int c = 0; c < CH; ++c) part[c] = fma_rn(a[c], g, part[c]);
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (q + c < gsz) {
            const T v = warp_sum(part[c]);
            if (lane == 0) red[warp * gsz + q + c] = v;
          }
        }
      }
      __syncthreads();                  // A: the warp sums are in
      const T lj = ls[s], tj = ts[s];
      T* bj = bs + (size_t)s * gsz;
      // column c is summed over the warps by warp c % NW, in warp order
      for (int c = warp; c < gsz; c += NW) {
        const T sum = warp_sum(lane < NW ? red[lane * gsz + c] : T(0));
        if (lane == 0) vv[c] = bj[c] - sum / lj;
      }
      __syncthreads();                  // B: v is in
      T nrm2 = T(0);
      for (int c = 0; c < gsz; ++c) nrm2 = fma_rn(vv[c], vv[c], nrm2);
      const T scale =
          fmax(T(1) - tj / fmax(sqrt(nrm2), T(1e-30)), T(0));
      bool nz = false;
      if (tid < gsz) {
        const T b = vv[tid] * scale;
        const T d = b - bj[tid];
        dv[tid] = d;
        bj[tid] = b;
        nz = d != T(0);
      }
      moved = __syncthreads_or(nz) != 0;   // C: b and d are in
      prev = cur;
    }
  }

  for (int i = tid; i < n; i += NT) {   // the last step's update
    T zi = zs[i];
    if (moved) zi += row_update(prev, dv, i, n, gsz);
    zout[i] = zi;
  }
  for (int e = tid; e < nl * gsz; e += NT)
    beta[(size_t)slot[e / gsz] * gsz + e % gsz] = bs[e];
}

// ---------------------------------------------------------------------------
// the register form
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned peer(unsigned a, int k) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(k));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(saddr(b)) : "memory");
}
// the one arrival of a phase, which expects `bytes` more
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(saddr(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* b, unsigned parity) {
  unsigned done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
               "p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n}"
               : "=r"(done) : "r"(saddr(b)), "r"(parity) : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  while (!mbar_try(b, parity)) {
  }
}
// `v` into another CTA's shared memory at `a`, counted on its barrier at
// `bar` (both cluster addresses)
__device__ __forceinline__ void st_async(unsigned a, double v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 "
               "[%0], %1, [%2];" :: "r"(a), "d"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(unsigned a, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
               "[%0], %1, [%2];" :: "r"(a), "f"(v), "r"(bar) : "memory");
}

// K column values, one a register, each summed over the lanes of its
// 2 O-lane segment by the shuffle-down tree's pairs (lane q + O into
// lane q, O halving): two columns share a shuffle, the lower half of a
// segment keeping the first's sum, the upper half the second's. After
// the level O = 1 lane l holds column brev5(l)'s sum (of the columns
// folded in at the first level; an odd one out folds with itself).
template <typename T, int K, int O>
struct Fold {
  template <int N>
  static __device__ __forceinline__ T run(T (&v)[N], int lane) {
    const bool lo = (lane & O) == 0;
#pragma unroll
    for (int j = 0; j < (K + 1) / 2; ++j) {
      if (2 * j + 1 < K) {
        const T x = v[2 * j], y = v[2 * j + 1];
        v[j] = (lo ? x : y) + __shfl_xor_sync(0xffffffffu, lo ? y : x, O);
      } else {
        v[j] = v[2 * j] + __shfl_xor_sync(0xffffffffu, v[2 * j], O);
      }
    }
    return Fold<T, (K + 1) / 2, O / 2>::run(v, lane);
  }
};
template <typename T, int K>
struct Fold<T, K, 0> {
  template <int N>
  static __device__ __forceinline__ T run(T (&v)[N], int) { return v[0]; }
};

// the thread's rows of one block's COLS columns (0 past n and past gsize)
template <typename T>
struct Rows {
  T a[ROWS][COLS];
};
// a thread's ROWS = 2 values of one column, one load
template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

// One cluster of C CTAs of NT / C threads: CTA k holds the one-CTA burst's
// threads k NT / C, ..., so thread t's rows and warp w's sums are those of
// a burst on one CTA of NT. Each warp sends its column sums to every CTA
// (st.async, counted on the receiver's barrier of the step's parity), so
// no CTA waits for another's stores, and one barrier wait a step stands
// for the CTA barrier.
template <typename T, int L, int C>
__global__ void __launch_bounds__(NT / C, 1) group_bcd_reg_kernel(
    const T* __restrict__ A, const T* __restrict__ y,
    const int* __restrict__ slot, T* __restrict__ beta,
    const T* __restrict__ Lg, T lam, int n_ep, int n, int nl, int gsz,
    T* __restrict__ zout) {
  constexpr int G = COLS, TPC = NT / C, HALF = (COLS + 1) / 2;
  static_assert(G <= 32, "a warp's folded trees hold at most 32 columns");
  static_assert(ROWS == 2, "a thread's rows of a column are one pair");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);  // by step parity (2)
  T* bs = reinterpret_cast<T*>(smem + 16);  // the live slots' beta (nl, gsz)
  T* ls = bs + (size_t)nl * gsz;        // their L (nl)
  T* ts = ls + nl;                      // their lam / L (nl)
  T* red = ts + nl;                     // warp sums (2 parities, NW, G)
  T* wv = red + 2 * NW * G;             // each warp's v and d (NW, 2 G)

  const int lt = threadIdx.x, lane = lt & 31, lw = lt >> 5;
  const int tid = blockIdx.x * TPC + lt, warp = tid >> 5;
  const int col = __brev(lane) >> 27;   // the column this lane finishes
  const bool mine = col < gsz;
  T* vw = wv + lw * 2 * G;              // this warp's v (G), then d (G)
  const size_t blk = (size_t)gsz * NT * ROWS;   // elements of a block of A
  // every warp's sums of a step reach every CTA
  const unsigned bytes = NW * gsz * sizeof(T);
  bool ok[ROWS];
  T zr[ROWS], yr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = tid + NT * r;
    ok[r] = i < n;
    yr[r] = ok[r] ? y[i] : T(0);
  }
  for (int e = lt; e < nl * gsz; e += TPC)   // each CTA its own copy
    bs[e] = beta[(size_t)slot[e / gsz] * gsz + e % gsz];
  for (int s = lt; s < nl; s += TPC) {
    ls[s] = Lg[slot[s]];
    ts[s] = lam / ls[s];
  }
  if (lt == 0) {
    mbar_init(mbar);
    mbar_init(mbar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();                       // every CTA set up

  // the thread's rows of slot s's block: its pair of each column
  auto fetch = [&](Rows<T>& b, int s) {
    using P2 = typename Pair<T>::type;
    const P2* p = reinterpret_cast<const P2*>(A + (size_t)s * blk) + tid;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const P2 v = c < gsz ? __ldg(p + (size_t)c * NT) : P2{T(0), T(0)};
      b.a[0][c] = v.x;
      b.a[1][c] = v.y;
    }
  };

  // z = sum over the live slots of X_j beta_j, the thread's rows
  Rows<T> X, Y;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) zr[r] = T(0);
  for (int s = 0; s < nl; ++s) {
    fetch(X, s);
    const T* bj = bs + (size_t)s * gsz;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      T u = T(0);                       // X_j beta_j, then added to z
#pragma unroll
      for (int c = 0; c < G; ++c)
        if (c < gsz) u = fma_rn(X.a[r][c], bj[c], u);
      zr[r] += u;
    }
  }

  const long long S = (long long)n_ep * nl;
  bool moved = false;                   // the previous step's d is nonzero
  T bjc = T(0);                         // beta of the step's slot, column col
  int s = 0;
  // the rows' update of z by the previous step's d (a row's gsize
  // products summed, then added)
  auto update = [&](const Rows<T>& b, const T (&d)[G]) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      T u = T(0);
#pragma unroll
      for (int c = 0; c < G; ++c)
        if (c < gsz) u = fma_rn(b.a[r][c], d[c], u);
      if (ok[r]) zr[r] += u;
    }
  };
  // step t on its block in `cur` with the previous step's block in `prv`,
  // whose registers take the next step's block once the update of z is
  // done with them
  auto step = [&](Rows<T>& cur, Rows<T>& prv, long long t) {
    const int par = (int)(t & 1);
    if ((nl > 1 || t == 0) && mine) bjc = bs[(size_t)s * gsz + col];
    if (lt == 0) mbar_expect(mbar + par, bytes);
    T d[G];                             // the previous step's d (warp copy)
#pragma unroll
    for (int c = 0; c < G; ++c) d[c] = moved && c < gsz ? vw[G + c] : T(0);
    if (moved) update(prv, d);
    T part[G];
#pragma unroll
    for (int c = 0; c < G; ++c) part[c] = T(0);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (ok[r]) {
        const T g = grad<T, L>(zr[r], yr[r]);
#pragma unroll
        for (int c = 0; c < G; ++c) part[c] = fma_rn(cur.a[r][c], g, part[c]);
      }
    }
    {
      const T w = Fold<T, G, 16>::run(part, lane);
      if (mine) {
        const unsigned a = saddr(red + (par * NW + warp) * G + col);
#pragma unroll
        for (int k = 0; k < C; ++k)
          st_async(peer(a, k), w, peer(saddr(mbar + par), k));
      }
    }
    mbar_wait(mbar + par, (unsigned)(t >> 1) & 1u);  // every warp's sums
    // the next step's block, in flight behind the tail and the next update
    if (t + 1 < S) fetch(prv, s + 1 == nl ? 0 : s + 1);
    // every warp sums every column over the 16 warps: two columns a
    // register (lanes 0-15 column 2j, 16-31 column 2j + 1, lane q holding
    // warp q's sum), the tree's first level adding lanes 16-31's zeros
    T q[HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = 2 * j + (lane >> 4);
      q[j] = (c < gsz ? red[(par * NW + (lane & 15)) * G + c] : T(0)) + T(0);
    }
    const T sum = Fold<T, HALF, 8>::run(q, lane);
    const T lj = ls[s], tj = ts[s];
    T v = T(0);
    if (mine) {
      v = bjc - sum / lj;
      vw[col] = v;
    }
    __syncwarp();
    T nrm2 = T(0);
#pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < gsz) nrm2 = fma_rn(vw[c], vw[c], nrm2);
    const T scale = fmax(T(1) - tj / fmax(sqrt(nrm2), T(1e-30)), T(0));
    T dc = T(0);
    if (mine) {
      const T b = v * scale;
      dc = b - bjc;
      vw[G + col] = dc;
      if (lw == 0) bs[(size_t)s * gsz + col] = b;
      bjc = b;                          // the next step's, with one live slot
    }
    moved = __any_sync(0xffffffffu, dc != T(0));
    __syncwarp();                       // the warp's d is in
    s = s + 1 == nl ? 0 : s + 1;
  };
  if (S > 0) fetch(X, 0);
  long long t = 0;
  for (; t + 1 < S; t += 2) {
    step(X, Y, t);
    step(Y, X, t + 1);
  }
  if (t < S) step(X, Y, t);

  if (moved) {                          // the last step's update
    T d[G];
#pragma unroll
    for (int c = 0; c < G; ++c) d[c] = c < gsz ? vw[G + c] : T(0);
    if (S & 1) update(X, d); else update(Y, d);   // its block's set
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (ok[r]) zout[tid + NT * r] = zr[r];
  __syncthreads();
  if (blockIdx.x == 0)                  // the CTAs' copies are equal
    for (int e = lt; e < nl * gsz; e += TPC)
      beta[(size_t)slot[e / gsz] * gsz + e % gsz] = bs[e];
  cluster_sync();                       // no CTA leaves while sums fly
}

// keep in step with kernels/group/group.py::group_smem_bytes (which counts
// every slot, live or not)
size_t smem_bytes(bool reg, int n, int nl, int gsz, size_t itemsize) {
  if (reg)                              // the two barriers, then the arrays
    return 16 + ((size_t)nl * gsz + 2 * (size_t)nl + 4 * (size_t)NW * COLS) *
                    itemsize;
  return (3 * (size_t)n + (size_t)nl * gsz + 2 * (size_t)nl +
          (NW + 2) * (size_t)gsz) * itemsize;
}

template <typename T, int L, bool REG>
int launch(const void* A, const void* y, const void* slot, void* beta,
           const void* Lg, T lam, int n_epochs, int n, int nl, int gsz,
           void* z, void* stream) {
  if (gsz < 1 || gsz > (REG ? COLS : 256) || (REG && n > ROWS * NT))
    return (int)cudaErrorInvalidValue;
  constexpr int C = REG ? CLUSTER : 1;
  auto kernel = REG ? group_bcd_reg_kernel<T, L, CLUSTER>
                    : group_bcd_kernel<T, L>;
  const size_t smem = smem_bytes(REG, n, nl, gsz, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(NT / C, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = REG ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)A, (const T*)y, (const int*)slot, (T*)beta,
      (const T*)Lg, lam, n_epochs, n, nl, gsz, (T*)z);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A (nl, gsize, n): the live blocks, transposed (the register form: (nl,
// gsize, 512, 2), the pair (t, r) row t + 512 r, 0 past n); slot (nl,)
// their slot ids in slot order; beta (k, gsize) updated in place on the
// live slots; L (k)
#define GROUP_BCD_ENTRY(NAME, T, L, REG)                                     \
  int NAME(const void* A, const void* y, const void* slot, void* beta,      \
           const void* Lg, T lam, int n_epochs, int n, int nl, int gsize,   \
           void* z, void* stream) {                                          \
    return launch<T, L, REG>(A, y, slot, beta, Lg, lam, n_epochs, n, nl,    \
                             gsize, z, stream);                              \
  }

GROUP_BCD_ENTRY(group_bcd_ls_f32, float, LS, false)
GROUP_BCD_ENTRY(group_bcd_ls_f64, double, LS, false)
GROUP_BCD_ENTRY(group_bcd_logit_f32, float, LOGIT, false)
GROUP_BCD_ENTRY(group_bcd_logit_f64, double, LOGIT, false)
GROUP_BCD_ENTRY(group_bcd_reg_ls_f32, float, LS, true)
GROUP_BCD_ENTRY(group_bcd_reg_ls_f64, double, LS, true)
GROUP_BCD_ENTRY(group_bcd_reg_logit_f32, float, LOGIT, true)
GROUP_BCD_ENTRY(group_bcd_reg_logit_f64, double, LOGIT, true)

#undef GROUP_BCD_ENTRY

}  // extern "C"
