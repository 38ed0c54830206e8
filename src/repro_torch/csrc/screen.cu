// SAIF screening kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// K1 screen_fused — replaces repro/kernels/screen/screen.py:271
//    screen_fused_pallas (and, with masked == 0, :124 screen_scores_pallas).
// K1b screen_fused_batch — replaces repro/kernels/screen/screen.py:394
//    screen_fused_batch_pallas: K1 for m problems over one shared X
//    (Theta (m, n), active (m, p), r (m,), col_norm shared or per problem).
//    Per problem b and column i of the row-major (n, p) design X:
//        s_i  = |x_i^T theta_b|               (-inf when i is active/padding)
//        ub_i = s_i + ||x_i|| r_b,  lb_i = |s_i - ||x_i|| r_b|
//    and per tile of BP = 256 columns its top-h_tile (score, global id) in
//    the order of a stable descending sort of (score, lane), and its max ub.
//    K1 is the BB = 1 instance of one template, K1b the BB = 16 instance.
//    Bound on this card: bytes, X read once per chunk of BB = 16 problems,
//    n*p*itemsize at 3.35 TB/s. The 2*n*p*16 flops of a chunk fit in under
//    half that time on the f64 CUDA cores; a tensor-core product would not
//    keep the sum order (and wgmma has no f64 type).
//    Design, against that bound:
//    - the scan: a thread owns COLS columns of a tile and QB of the chunk's
//      problems and keeps their sums in registers, one fma per row in row
//      order from 0, so each problem's scores are bit for bit K1's and no
//      sum is split over rows. Theta reaches the threads as shared-memory
//      broadcasts, which cost as much as distinct loads: COLS = 2 halves
//      them per fma, and in float64 a thread keeps all 16 of K1b's sums
//      per column (128 threads a CTA, so that its 2 x 16 sums fit in
//      registers under three CTAs per SM);
//    - the X stream: persistent CTAs, CTAS per SM, walk the (tile, chunk)
//      work items; X and Theta rows reach shared memory through a ring of
//      STAGES slabs filled with cp.async (16-byte copies where a row allows
//      them, element copies otherwise, so any p and alignment work), STAGES
//      - 1 slabs in flight, and the stream runs on across a CTA's items.
//      Three CTAs per SM hide the latency of the shared loads and fma
//      chains better than one CTA streaming across items;
//    - the epilogue: per problem the 256 masked scores go to shared memory
//      and one warp sorts (score, lane) with a bitonic network, 8 pairs per
//      lane, in O(log^2 256) steps and no barrier; the BB problems spread
//      over the CTA's warps, and the tile's max ub is a warp reduction. The
//      Pallas kernel's h_tile rounds of argmax were cheap on a TPU's
//      sequential grid; on this card each round cost two block barriers.
//
// K2 ub_histogram — replaces repro/kernels/screen/screen.py:512
//    ub_histogram_pallas. hist[m] = #{i : #{l : lb_sorted[l] <= ub_i} = m}.
//    Bound: reading ub once (p*itemsize bytes); the p*h comparisons run on
//    lb_sorted held in shared memory. Counts go into a shared int32
//    histogram with atomicAdd, then into the global one: integer atomics
//    keep the result exact and independent of the order of the adds.
//
// K2b ub_histogram_batch — replaces repro/kernels/screen/screen.py:562
//    ub_histogram_batch_pallas: K2 per problem, ub (m, p), lb_sorted (m, h)
//    -> hist (m, h+1). The grid gains a problem axis; each CTA holds its
//    problem's lb_sorted and bins in shared memory. K2 is its m = 1 case.
//    Bound: reading ub once, m*p*itemsize bytes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BP = 256;          // columns per tile of the scan

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

// Rounded products and sums that nvcc never contracts into an FMA, so the
// bounds are the plain version's two roundings, not one.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
// One row step of the scan, a single rounding: acc + th * x. K1 and K1b
// both go through it, so their sums agree bit for bit.
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// The BB Theta values of one row of a chunk, read from shared memory in
// 16-byte loads (one broadcast per load) instead of one load per problem.
template <typename T, int BB>
struct __align__(16) ThetaRow {
  T v[BB];
};

constexpr int SMEM_BUDGET = 220 * 1024;   // of the 228 KB of an SM
constexpr int SORT_PER_LANE = BP / 32;    // (key, lane) pairs a lane sorts

// Geometry and shared memory of the scan instance (T, BB). A thread owns
// COLS neighbouring columns of the tile and QB of the chunk's BB problems
// (GROUPS groups of TPG threads split the problems), so that one shared
// load of a Theta value feeds COLS fmas and one load of X feeds QB. Shared
// memory (a third of the SM's per CTA) holds a ring of STAGES slabs (ROWS
// rows of X's tile and of the chunk's Theta), as deep as it allows, and
// per problem the tile's masked scores, each row padded by one element per
// 8 so that a lane's 8 consecutive pairs load without bank conflicts, and
// its per-warp maxima of ub.
template <typename T, int BB>
struct Scan {
  // K1b: 2 columns x 16 problems a thread in float64; in float32 2 x 8,
  // twice the threads, measured faster
  static constexpr int GROUPS = BB >= 16 && sizeof(T) == 4 ? 2 : 1;
  static constexpr int COLS = BB >= 16 ? 2 : 1;
  static constexpr int QB = BB / GROUPS;
  static constexpr int TPG = BP / COLS;
  static constexpr int THREADS = TPG * GROUPS;
  static constexpr int NWARP = THREADS / 32;
  static constexpr int GWARP = TPG / 32;            // warps of a group
  static constexpr int CTAS = 3;                    // per SM
  static constexpr int SLAB = BB >= 16 ? 8 * 1024 : 16 * 1024;   // X bytes
  static constexpr int ROWS = SLAB / (BP * (int)sizeof(T));
  static constexpr int EPAD = BP + BP / SORT_PER_LANE;
  static constexpr size_t EPI_BYTES =
      (size_t)BB * (EPAD + GWARP) * sizeof(T);
  static constexpr size_t X_STAGE = (size_t)ROWS * BP * sizeof(T);
  static constexpr size_t TH_STAGE = (size_t)ROWS * sizeof(ThetaRow<T, BB>);
  static constexpr int STAGES =
      (int)((SMEM_BUDGET / CTAS - EPI_BYTES) / (X_STAGE + TH_STAGE));
  static constexpr size_t SMEM = STAGES * (X_STAGE + TH_STAGE) + EPI_BYTES;
  static_assert(BB % GROUPS == 0, "even split of the problems");
  static_assert(X_STAGE % (16 * THREADS) == 0,
                "16-byte copies split evenly over the threads");
  static_assert(STAGES >= 3, "a ring needs stages in flight");
};

// N values of type T read from shared memory as one aligned load.
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

// cp.async of one element; with ok false nothing is read and the shared
// word is zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(N), "r"(ok ? N : 0)
               : "memory");
}
// cp.async of 16 bytes past L1; with ok false the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (key a, lane ia) comes before (key b, lane ib): the larger score, then
// the lower lane. Total on finite and -inf keys.
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  return a > b || (a == b && ia < ib);
}

// One step of the bitonic network over pairs jj = lx * L apart, which sit
// in lanes lx apart: the lower slot of an ascending block keeps the better
// pair of the two.
template <typename T, int L>
__device__ __forceinline__ void sort_across(T (&k)[L], int (&id)[L], int wl,
                                            int kk, int lx) {
  const bool lower = (wl & lx) == 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const T ok = __shfl_xor_sync(0xffffffffu, k[j], lx);
    const int oi = __shfl_xor_sync(0xffffffffu, id[j], lx);
    const bool up = ((wl * L + j) & kk) == 0;
    if (before(ok, oi, k[j], id[j]) == (lower == up)) {
      k[j] = ok;
      id[j] = oi;
    }
  }
}

// The same step for pairs JJ < L apart, in one lane's registers.
template <typename T, int L, int JJ>
__device__ __forceinline__ void sort_within(T (&k)[L], int (&id)[L], int wl,
                                            int kk) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int pj = j ^ JJ;
    if (pj > j) {
      const bool up = ((wl * L + j) & kk) == 0;
      if (up ? before(k[pj], id[pj], k[j], id[j])
             : before(k[j], id[j], k[pj], id[pj])) {
        const T tk = k[j];
        k[j] = k[pj];
        k[pj] = tk;
        const int ti = id[j];
        id[j] = id[pj];
        id[pj] = ti;
      }
    }
  }
}

// One warp: the tile's top h_tile (score, global id) of one problem and its
// max ub (the largest of the n_umax per-warp maxima in umax_s). Lane wl
// holds pairs wl*8 .. wl*8+7 and sorts them with the warp in a bitonic
// network, best first; partners 8 or more apart sit in another lane (a
// shuffle), nearer ones in the same lane's registers.
template <typename T>
__device__ __forceinline__ void tile_top(const T* key_s, const T* umax_s,
                                         int n_umax, int wl, int h_tile,
                                         int base, T* tops, int* topi,
                                         T* tmax) {
  constexpr int L = SORT_PER_LANE;
  T k[L];
  int id[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    k[j] = key_s[wl * (L + 1) + j];
    id[j] = wl * L + j;
  }
  T mx = -pos_inf<T>();
  for (int i = 0; i < n_umax; ++i) mx = fmax(mx, umax_s[i]);
  if (wl == 0) *tmax = mx;

  // blocks of kk pairs, merged over distances jj = kk/2 .. 1; the loops
  // over kk and over the lane distances stay rolled to keep the code small
#pragma unroll 1
  for (int kk = 2; kk <= BP; kk <<= 1) {
#pragma unroll 1
    for (int lx = kk / (2 * L); lx > 0; lx >>= 1)   // jj = lx * L >= L
      sort_across<T, L>(k, id, wl, kk, lx);
    if (kk > 4) sort_within<T, L, 4>(k, id, wl, kk);
    if (kk > 2) sort_within<T, L, 2>(k, id, wl, kk);
    sort_within<T, L, 1>(k, id, wl, kk);
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int t = wl * L + j;
    if (t < h_tile) {
      tops[t] = k[j];
      topi[t] = base + id[j];
    }
  }
}

// Persistent: CTA c takes work items c, c + gridDim.x, ... of the
// (p tiles) x (problem chunks) items, item = tile * chunks + chunk, so the
// CTAs running at one time share X tiles in L2 when m > BB. Item (tile,
// chunk) scans columns [tile*BP, tile*BP + BP) for problems
// [chunk*BB, chunk*BB + nb) of the m.
template <typename T, int BB>
__global__ void __launch_bounds__(Scan<T, BB>::THREADS, Scan<T, BB>::CTAS)
screen_fused_kernel(const T* __restrict__ X, const T* __restrict__ Theta,
                    const T* __restrict__ col_norm, int cn_stride,
                    const uint8_t* __restrict__ active,
                    const T* __restrict__ r, int m, int n, int p, int h_tile,
                    int masked, T* __restrict__ score, T* __restrict__ ub,
                    T* __restrict__ lb, T* __restrict__ tops,
                    int* __restrict__ topi, T* __restrict__ tmax) {
  using S = Scan<T, BB>;
  constexpr int ROWS = S::ROWS, QB = S::QB, COLS = S::COLS;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  ThetaRow<T, BB>* ths =
      reinterpret_cast<ThetaRow<T, BB>*>(smem + STAGES * S::X_STAGE);
  T* key_s = reinterpret_cast<T*>(smem + STAGES * (S::X_STAGE + S::TH_STAGE));
  T* umax_s = key_s + BB * S::EPAD;

  const int t = threadIdx.x;
  const int g = t / S::TPG;            // problems [g*QB, g*QB + QB) of a chunk
  const int c0 = (t % S::TPG) * COLS;  // columns [c0, c0 + COLS) of the tile
  const int p_blocks = (p + BP - 1) / BP;
  const int chunks = (m + BB - 1) / BB;
  const int items = p_blocks * chunks;
  const int my_items =
      (int)blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // slabs per item; at least one, whose barrier guards key_s between items
  const int slabs = n > ROWS ? (n + ROWS - 1) / ROWS : 1;
  const int total = my_items * slabs;

  // the producer side, run by every thread: the next slab of this CTA's
  // stream (rows [row0, row0 + ROWS) of its item's tile and of its chunk's
  // Theta rows) into its stage
  int pn = 0, p_item = blockIdx.x, p_row0 = 0, p_stage = 0;
  auto fetch = [&]() {
    if (pn < total) {
      const int tile = p_item / chunks, q0 = (p_item % chunks) * BB;
      const int nb = min(BB, m - q0);
      // 16-byte copies where a row's vector is aligned and inside p (all
      // of them when p*itemsize is a multiple of 16), else element copies
      constexpr int VEC = 16 / sizeof(T), VPR = BP / VEC;
#pragma unroll
      for (int k = 0; k < ROWS * VPR / S::THREADS; ++k) {
        const int e = t + k * S::THREADS;
        const int i = e / VPR, c = tile * BP + (e % VPR) * VEC;
        T* dst = xs + (size_t)p_stage * ROWS * BP + i * BP + (e % VPR) * VEC;
        const T* src = X + (size_t)(p_row0 + i) * p + c;
        if (p_row0 + i >= n) {            // zeros: fma(0, 0, acc) == acc
          cp_async16(dst, X, false);
        } else if (c + VEC <= p && ((uintptr_t)src & 15) == 0) {
          cp_async16(dst, src, true);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            cp_async<sizeof(T)>(dst + j, c + j < p ? src + j : X, c + j < p);
        }
      }
      for (int e = t; e < ROWS * BB; e += S::THREADS) {   // rows fastest
        const int q = e / ROWS, i = e % ROWS;
        const bool ok = q < nb && p_row0 + i < n;
        cp_async<sizeof(T)>(
            &ths[p_stage * ROWS + i].v[q],
            ok ? Theta + (size_t)(q0 + q) * n + p_row0 + i : Theta, ok);
      }
      ++pn;
      p_stage = p_stage + 1 == STAGES ? 0 : p_stage + 1;
      p_row0 += ROWS;
      if (p_row0 >= slabs * ROWS) {
        p_row0 = 0;
        p_item += gridDim.x;
      }
    }
    cp_async_commit();                    // empty groups keep the count
  };

#pragma unroll 1
  for (int k = 0; k < STAGES - 1; ++k) fetch();

  const int w = t >> 5, wl = t & 31;
  int stage = 0;
  for (int it = 0; it < my_items; ++it) {
    const int item = blockIdx.x + it * gridDim.x;
    const int tile = item / chunks, q0 = (item % chunks) * BB + g * QB;
    const int nq = max(0, min(QB, m - q0));   // this thread's live problems

    T acc[COLS][QB];
#pragma unroll
    for (int j = 0; j < COLS; ++j)
#pragma unroll
      for (int q = 0; q < QB; ++q) acc[j][q] = T(0);
    for (int sl = 0; sl < slabs; ++sl) {
      cp_async_wait<STAGES - 2>();        // this slab has landed (own copies)
      __syncthreads();                    // everyone's; the last stage is free
      fetch();
      const T* xr = xs + (size_t)stage * ROWS * BP + c0;
      const ThetaRow<T, BB>* tr = ths + stage * ROWS;
      stage = stage + 1 == STAGES ? 0 : stage + 1;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        // one load of X feeds QB problems, one of Theta COLS columns
        const Vec<T, COLS> x = *reinterpret_cast<const Vec<T, COLS>*>(
            xr + i * BP);
        const Vec<T, QB> th =
            reinterpret_cast<const Vec<T, QB>*>(tr[i].v)[g];
#pragma unroll
        for (int q = 0; q < QB; ++q)
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[j][q] = fma_rn(th.v[q], x.v[j], acc[j][q]);
      }
    }

    // epilogue: the bounds, then (masked) each problem's tile max ub and
    // top-h, one warp per problem; the ring keeps streaming meanwhile
    T mx[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      mx[q] = -pos_inf<T>();
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int lane = c0 + j, col = tile * BP + lane;
        const bool in = col < p;
        if (q < nq) {
          const size_t at = (size_t)(q0 + q) * p + col;
          const T sc = fabs(acc[j][q]);
          const T nr =
              in ? mul_rn(col_norm[(size_t)(q0 + q) * cn_stride + col],
                          r[q0 + q])
                 : T(0);
          if (!masked) {
            if (in) {
              score[at] = sc;
              ub[at] = add_rn(sc, nr);
              lb[at] = fabs(sub_rn(sc, nr));
            }
            continue;
          }
          const bool act = !in || active[at] != 0;
          const T ms = act ? -pos_inf<T>() : sc;
          const T u = add_rn(ms, nr);
          if (in) {
            score[at] = ms;
            ub[at] = u;
            lb[at] = fabs(sub_rn(ms, nr));
          }
          key_s[(g * QB + q) * S::EPAD + lane + lane / SORT_PER_LANE] = ms;
          mx[q] = fmax(mx[q], u);
        }
      }
    }
    if (masked) {
#pragma unroll
      for (int q = 0; q < QB; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx[q] = fmax(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], off));
        if (wl == 0 && q < nq)
          umax_s[(g * QB + q) * S::GWARP + (t % S::TPG) / 32] = mx[q];
      }
      // the next write of key_s/umax_s is behind the next slab's barrier
      __syncthreads();
      const int b0 = (item % chunks) * BB, nb = min(BB, m - b0);
      for (int q = w; q < nb; q += S::NWARP) {
        const size_t tb = (size_t)(b0 + q) * p_blocks + tile;
        tile_top(key_s + q * S::EPAD, umax_s + q * S::GWARP, S::GWARP, wl,
                 h_tile, tile * BP, tops + tb * h_tile, topi + tb * h_tile,
                 tmax + tb);
      }
    }
  }
}

template <typename T>
__global__ void ub_hist_kernel(const T* __restrict__ ub,
                               const T* __restrict__ lb_sorted, int p, int h,
                               int* __restrict__ hist) {
  extern __shared__ __align__(16) unsigned char smem[];
  ub += (size_t)blockIdx.y * p;                 // this CTA's problem
  lb_sorted += (size_t)blockIdx.y * h;
  hist += (size_t)blockIdx.y * (h + 1);
  T* lb_s = reinterpret_cast<T*>(smem);
  int* hist_s = reinterpret_cast<int*>(lb_s + h);
  for (int l = threadIdx.x; l < h; l += blockDim.x) lb_s[l] = lb_sorted[l];
  for (int m = threadIdx.x; m <= h; m += blockDim.x) hist_s[m] = 0;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += gridDim.x * blockDim.x) {
    const T u = ub[i];
    int c = 0;
    for (int l = 0; l < h; ++l) c += (lb_s[l] <= u) ? 1 : 0;
    atomicAdd(&hist_s[c], 1);
  }
  __syncthreads();
  for (int m = threadIdx.x; m <= h; m += blockDim.x)
    if (hist_s[m]) atomicAdd(&hist[m], hist_s[m]);
}

template <typename T, int BB>
int launch_screen(const void* X, const void* Theta, const void* col_norm,
                  int cn_stride, const void* active, const void* r, int m,
                  int n, int p, int h_tile, int masked, void* score, void* ub,
                  void* lb, void* tops, void* topi, void* tmax, void* stream) {
  const size_t smem = Scan<T, BB>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      screen_fused_kernel<T, BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, screen_fused_kernel<T, BB>, Scan<T, BB>::THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int items = ((p + BP - 1) / BP) * ((m + BB - 1) / BB);
  if (items == 0) return (int)cudaSuccess;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  screen_fused_kernel<T, BB>
      <<<grid, Scan<T, BB>::THREADS, smem,
         (cudaStream_t)stream>>>(
          (const T*)X, (const T*)Theta, (const T*)col_norm, cn_stride,
          (const uint8_t*)active, (const T*)r, m, n, p, h_tile, masked,
          (T*)score, (T*)ub, (T*)lb, (T*)tops, (int*)topi, (T*)tmax);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hist(const void* ub, const void* lb_sorted, int m, int p, int h,
                void* hist, void* stream) {
  const int threads = 256;
  int blocks = (p + threads - 1) / threads;
  if (blocks > 4 * 132) blocks = 4 * 132;
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)h * sizeof(T) + (size_t)(h + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ub_hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ub_hist_kernel<T><<<dim3(blocks, m), threads, smem, (cudaStream_t)stream>>>(
      (const T*)ub, (const T*)lb_sorted, p, h, (int*)hist);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 (BB = 1, m = 1) and K1b (BB = 16): the same kernel and arguments.
#define SCREEN_ENTRY(NAME, T, BB)                                              \
  int NAME(const void* X, const void* Theta, const void* col_norm,            \
           int cn_stride, const void* active, const void* r, int m, int n,    \
           int p, int h_tile, int masked, void* score, void* ub, void* lb,    \
           void* tops, void* topi, void* tmax, void* stream) {                \
    return launch_screen<T, BB>(X, Theta, col_norm, cn_stride, active, r, m,  \
                                n, p, h_tile, masked, score, ub, lb, tops,    \
                                topi, tmax, stream);                          \
  }

SCREEN_ENTRY(screen_fused_f32, float, 1)
SCREEN_ENTRY(screen_fused_f64, double, 1)
SCREEN_ENTRY(screen_fused_batch_f32, float, 16)
SCREEN_ENTRY(screen_fused_batch_f64, double, 16)

// K2 (m = 1) and K2b
int ub_histogram_f32(const void* ub, const void* lb_sorted, int m, int p,
                     int h, void* hist, void* stream) {
  return launch_hist<float>(ub, lb_sorted, m, p, h, hist, stream);
}

int ub_histogram_f64(const void* ub, const void* lb_sorted, int m, int p,
                     int h, void* hist, void* stream) {
  return launch_hist<double>(ub, lb_sorted, m, p, h, hist, stream);
}

}  // extern "C"
