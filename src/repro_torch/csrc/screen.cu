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
//    The mixed mode (the Pallas kernels' in_dtype / acc_dtype, the certified
//    mixed-precision screen of parity="fast") with a float32 input is the
//    float instance on X cast by the caller: Theta arrives holding values
//    the caller rounded to float32, so every product is exact and only the
//    row-order float sum rounds. With a bf16 input it is the tensor-core
//    scan below (screen_tc_kernel). The template still takes a bf16 X (TI =
//    bf16, each element widened to T before its fma): only
//    scripts/screen_variants_torch.py instantiates it, as a timing variant.
//    In the mixed mode ub (and the tile max) is multiplied by the caller's
//    `guard` (1 + 8 u_acc; 1 leaves the working mode's bits).
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
// K1 / K1b in the bf16 mixed mode — screen_tc_kernel, the same outputs,
//    argument order and output shapes as the instances above, for the
//    Pallas kernels' in_dtype = bf16 (repro/kernels/screen/screen.py:246
//    _screen_dtypes: X and Theta tiles cast to bf16, the MXU accumulating
//    bf16 x bf16 in f32). Every bf16 x bf16 product is exact in float32,
//    so only the accumulation rounds, and the mode is checked against its
//    twin within the sums' bound, not bit for bit: the tensor cores may
//    take it. Bound on this card: bytes, X in bf16 read once per chunk of
//    up to 16 problems (n*p*2 bytes, 0.060 ms at the smoke's n = 1000, p =
//    100,000), against 2*16*n*p flops that take about 3 us at 989 TFLOP/s.
//    The float32-input mode stays on the fma instance: TF32 would round
//    X's float32 values, and the mode's premise is exact products.
//    Design, against that bound:
//    - the product, transposed so that the MMA's M comes from the columns:
//      D (256 columns x N problems) = A (256 x k) * B (k x N), A = X's tile
//      (rows k, columns M, stored columns-contiguous: wgmma's transposed,
//      MN-major A), B = the chunk's Theta rows (K-major, its (m, n)
//      row-major layout). A work item is one tile of BP = 256 columns and
//      one chunk of N = 8 (m <= 8; K1 is m = 1) or 16 problems; one
//      warpgroup issues its m64nNk16 wgmmas, four 64-column quarters a
//      k16 step;
//    - the stream: one producer thread feeds a ring of STAGES stages in
//      shared memory with TMA (full/empty mbarrier pairs); a stage is 64
//      rows of X as four 64 x 64 boxes (128-byte swizzle, so a box row is
//      at most 128 bytes) and the chunk's 64 Theta values a problem. The
//      CTAs are persistent over the (tile, chunk) items in K1b's order,
//      and 16 further warps run each item's epilogue from a double buffer
//      while the wgmmas and the loads go on with the next item (the
//      epilogue, its warp sorts above all, took as long as an item's
//      loads when the wgmma warps ran it themselves). TMA zero-fills
//      rows past n and problems past m (a zero product adds an exact zero),
//      so a ragged n or m needs no special path; boxes wholly past p are
//      not loaded, and their lanes are masked. X's and Theta's row strides
//      (ldx, ldt) are multiples of 8 elements, as TMA needs; the tensor
//      maps are encoded on the host through cudaGetDriverEntryPoint (no
//      libcuda link) and passed as __grid_constant__ arguments;
//    - the sums: each 64-row stage is one chain of four wgmmas from zero,
//      added into registers with __fadd_rn. NVIDIA does not document the
//      rounding of wgmma's float32 accumulation (studies of earlier tensor
//      cores found aligned significands and truncated adds), so this route
//      certifies its sums with the unit roundoff 2^-23 of a truncating
//      float32 adder (core/screen_backend.py scan_unit_roundoff); the
//      __fadd_rn adds only tighten the true error;
//    - the epilogue: each accumulator's |sum| goes to shared memory in the
//      per-problem layout tile_top reads, then the masked epilogue above
//      (rounded bounds, the guard, the stores, per-warp ub maxima, one
//      warp's bitonic sort per problem), a thread one column for half of
//      the chunk's problems.
//    A refused launch or tensor-map encode returns an error, never falls
//    back.
//
// K2 ub_histogram / screen_tail — replaces repro/kernels/screen/screen.py:512
//    ub_histogram_pallas and the code around it in one screen
//    (repro/core/screen_backend.py:146-168): the candidates' lower bounds
//    lb_l = |s_l - ||x_l|| r| (a rounded product, then a rounded
//    difference), their violation counts |V_l| = #{i : ub_i >= lb_l}, the
//    survivors #{i : ub_i >= 1} and the screen's max ub (of K1's tile
//    maxima). Both go through c_i = #{l : lb_sorted[l] <= ub_i}:
//    hist[m] = #{i : c_i = m}, and |V_l| is the suffix sum of hist at l's
//    first position among the sorted bounds, plus one. The histogram entry
//    takes lb_sorted and writes hist; the tail entry takes the candidates
//    (score, id) and writes lb, the counts, the survivors and max ub.
//    Bound on this card: reading ub once, m*p*itemsize bytes, a few
//    microseconds; the launch itself costs about as much. On the TPU XLA
//    fused the code around the histogram into the kernel's program; here
//    it was some twenty small launches and as many host calls a screen.
//    Design:
//    - one thread-block cluster per problem (grid (cluster, m): 16 CTAs
//      while the m clusters fit on the SMs at once, else 8); every CTA
//      computes the h bounds and sorts them in its shared memory (a
//      bitonic network on the values, NaN last as in torch.sort; one warp
//      for h <= 256, the block above), then streams its slice of the
//      problem's ub once in 16-byte loads (ub was written by K1 just
//      before and is L2-resident);
//    - c_i: ub below the smallest bound (bin 0, the common case) and ub at
//      or above the largest (bin h) are counted in registers, the rest by
//      a branch-free binary search (log2 h steps, not h compares) into
//      shared int32 bins (warp-aggregated atomics, __match_any_sync,
//      measured slower on the screens' ub: scripts/tail_variants_torch.py);
//    - the CTAs add their bins into the leader CTA's through distributed
//      shared memory and meet at one cluster barrier; the leader then
//      writes hist, or the suffix sums and each candidate's count (its
//      first position found by torch.searchsorted's own search). No
//      memset, no global atomics, no second pass over ub: integer adds
//      keep every output exact and independent of their order.
//    K2b is the same kernel over m problems (ub (m, p); col_norm shared or
//    per problem), one cluster each. Bound: m*p*itemsize bytes.
#include <cooperative_groups.h>
#include <cuda.h>              // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

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
// An X element in the accumulator's type (exact: bf16 -> float widens; the
// bf16 overload serves only the fma timing variant of the bf16 mode).
[[maybe_unused]] __device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }

// The BB Theta values of one row of a chunk, read from shared memory in
// 16-byte loads (one broadcast per load) instead of one load per problem.
template <typename T, int BB>
struct __align__(16) ThetaRow {
  T v[BB];
};

constexpr int SMEM_BUDGET = 220 * 1024;   // of the 228 KB of an SM
constexpr int SORT_PER_LANE = BP / 32;    // (key, lane) pairs a lane sorts

// Geometry and shared memory of the scan instance (TI, TA, BB): X in TI,
// the sums and everything else in TA (T below). A thread owns
// COLS neighbouring columns of the tile and QB of the chunk's BB problems
// (GROUPS groups of TPG threads split the problems), so that one shared
// load of a Theta value feeds COLS fmas and one load of X feeds QB. Shared
// memory (a third of the SM's per CTA) holds a ring of STAGES slabs (ROWS
// rows of X's tile and of the chunk's Theta), as deep as it allows, and
// per problem the tile's masked scores, each row padded by one element per
// 8 so that a lane's 8 consecutive pairs load without bank conflicts, and
// its per-warp maxima of ub.
template <typename TI, typename T, int BB>
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
  static constexpr int ROWS = SLAB / (BP * (int)sizeof(TI));
  static constexpr int EPAD = BP + BP / SORT_PER_LANE;
  static constexpr size_t EPI_BYTES =
      (size_t)BB * (EPAD + GWARP) * sizeof(T);
  static constexpr size_t X_STAGE = (size_t)ROWS * BP * sizeof(TI);
  static constexpr size_t TH_STAGE = (size_t)ROWS * sizeof(ThetaRow<T, BB>);
  static constexpr int STAGES =
      (int)((SMEM_BUDGET / CTAS - EPI_BYTES) / (X_STAGE + TH_STAGE));
  static constexpr size_t SMEM = STAGES * (X_STAGE + TH_STAGE) + EPI_BYTES;
  static_assert(BB % GROUPS == 0, "even split of the problems");
  static_assert(X_STAGE % (16 * THREADS) == 0,
                "16-byte copies split evenly over the threads");
  static_assert(STAGES >= 3, "a ring needs stages in flight");
};

// N values of type T read as one aligned load (shared or global memory).
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
// One element of X into shared memory: cp.async where the element is 4 or
// 8 bytes, a plain load and store for a 2-byte bf16 (cp.async has no
// 2-byte copy; the slab's barrier orders the store like the copies).
template <typename TI>
__device__ __forceinline__ void copy_elem(TI* dst, const TI* src, bool ok) {
  if constexpr (sizeof(TI) >= 4) {
    cp_async<sizeof(TI)>(dst, src, ok);
  } else {
    *reinterpret_cast<unsigned short*>(dst) =
        ok ? *reinterpret_cast<const unsigned short*>(src)
           : (unsigned short)0;
  }
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
template <typename TI, typename T, int BB>
__global__ void __launch_bounds__(Scan<TI, T, BB>::THREADS,
                                  Scan<TI, T, BB>::CTAS)
screen_fused_kernel(const TI* __restrict__ X, const T* __restrict__ Theta,
                    const T* __restrict__ col_norm, int cn_stride,
                    const uint8_t* __restrict__ active,
                    const T* __restrict__ r, int m, int n, int p, int h_tile,
                    int masked, T guard, T* __restrict__ score,
                    T* __restrict__ ub, T* __restrict__ lb,
                    T* __restrict__ tops, int* __restrict__ topi,
                    T* __restrict__ tmax) {
  using S = Scan<TI, T, BB>;
  constexpr int ROWS = S::ROWS, QB = S::QB, COLS = S::COLS;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  TI* xs = reinterpret_cast<TI*>(smem);
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
      constexpr int VEC = 16 / sizeof(TI), VPR = BP / VEC;
#pragma unroll
      for (int k = 0; k < ROWS * VPR / S::THREADS; ++k) {
        const int e = t + k * S::THREADS;
        const int i = e / VPR, c = tile * BP + (e % VPR) * VEC;
        TI* dst = xs + (size_t)p_stage * ROWS * BP + i * BP + (e % VPR) * VEC;
        const TI* src = X + (size_t)(p_row0 + i) * p + c;
        if (p_row0 + i >= n) {            // zeros: fma(0, 0, acc) == acc
          cp_async16(dst, X, false);
        } else if (c + VEC <= p && ((uintptr_t)src & 15) == 0) {
          cp_async16(dst, src, true);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            copy_elem(dst + j, c + j < p ? src + j : X, c + j < p);
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
      const TI* xr = xs + (size_t)stage * ROWS * BP + c0;
      const ThetaRow<T, BB>* tr = ths + stage * ROWS;
      stage = stage + 1 == STAGES ? 0 : stage + 1;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        // one load of X feeds QB problems, one of Theta COLS columns
        const Vec<TI, COLS> x = *reinterpret_cast<const Vec<TI, COLS>*>(
            xr + i * BP);
        const Vec<T, QB> th =
            reinterpret_cast<const Vec<T, QB>*>(tr[i].v)[g];
#pragma unroll
        for (int q = 0; q < QB; ++q)
#pragma unroll
          for (int j = 0; j < COLS; ++j)
            acc[j][q] = fma_rn(th.v[q], to_acc(x.v[j]), acc[j][q]);
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
          T u = add_rn(ms, nr);
          if (guard != T(1)) u = mul_rn(u, guard);
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

// ---------------------------------------------------------------------------
// K1 / K1b in the bf16 mixed mode: the tensor-core scan
// ---------------------------------------------------------------------------
constexpr int TC_KB = 64;                  // rows of X a stage
constexpr int TC_BOX = 64;                 // columns of a TMA box (128 bytes)
constexpr int TC_BOX_BYTES = TC_KB * TC_BOX * 2;
constexpr int TC_QUARTERS = BP / TC_BOX;   // m64 tiles of a tile, one a box
constexpr int TC_MMA = 128;                // warps 0-3: the wgmma warpgroup
constexpr int TC_EPI = 512;                // warps 4-19: the epilogue
constexpr int TC_EWARPS = TC_EPI / 32;
constexpr int TC_THREADS = TC_MMA + TC_EPI + 32;   // + the producer warp
constexpr int TC_UWARPS = BP / 32;         // warps whose ub maxima a row has
// a problem's row of |sums| in shared memory: tile_top's padded layout,
// rows 4 floats (mod 32 banks) apart so that a fragment's stores of four
// problems x eight lanes hit 32 banks
constexpr int TC_KS = BP + BP / SORT_PER_LANE + 4;
constexpr int TC_SMEM_MAX = 227 * 1024;    // a CTA's most on this card
constexpr int TC_MAX_STAGES = 16;
// a failed cuTensorMapEncodeTiled returns TC_ENCODE_ERROR + its CUresult
constexpr int TC_ENCODE_ERROR = 100000;

// Geometry of the instance with chunks of N problems (the MMA's N): a
// stage holds 64 rows of X's tile (4 boxes) and of the chunk's Theta, the
// ring as many stages as one CTA's shared memory allows beside two buffers
// of the epilogue's N rows of |sums| and per-warp maxima and the barriers
// (1 KB spare aligns the ring to the swizzle's 1024 bytes).
template <int N>
struct TcScan {
  static constexpr size_t X_STAGE = (size_t)TC_QUARTERS * TC_BOX_BYTES;
  static constexpr size_t TH_STAGE = (size_t)N * TC_KB * 2;
  static constexpr size_t STAGE = X_STAGE + TH_STAGE;
  static constexpr int EPI_FLOATS = N * (TC_KS + TC_UWARPS);  // a buffer's
  static constexpr size_t EPI = 2 * (size_t)EPI_FLOATS * 4;
  static constexpr size_t BARS = (2 * TC_MAX_STAGES + 4) * 8;
  static constexpr size_t FIT = (TC_SMEM_MAX - 1024 - EPI - BARS) / STAGE;
  static constexpr int STAGES =
      (int)(FIT < TC_MAX_STAGES ? FIT : TC_MAX_STAGES);
  static constexpr size_t SMEM = 1024 + STAGES * STAGE + EPI + BARS;
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle's alignment");
  static_assert(STAGES >= 2, "a ring needs stages in flight");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: the box at (c0, c1) (innermost first) of `map` into dst, counted
// on `bar`'s transaction bytes
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}
// the epilogue's 512 threads meet (named barrier 1)
__device__ __forceinline__ void epi_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TC_EPI) : "memory");
}

// wgmma's shared-memory matrix descriptor of a 128-byte-swizzled operand at
// shared address a: start, leading and stride byte offsets in 16-byte
// units, layout 1 (SWIZZLE_128B) in bits 62-63. Both offsets are 1024
// bytes: the stride between groups of 8 swizzled 128-byte rows (K for the
// MN-major A, N for the K-major B); the other offset is not read at these
// shapes (A's 64 columns and B's 64 k-values are each one swizzle row).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across the wgmmas
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32, in registers) += A (64 x 16, bf16, MN-major) * B
// (16 x N, bf16, K-major), both from shared memory (imm-trans-a = 1)
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b);
template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// Persistent, work items as in screen_fused_kernel (item = tile * chunks +
// chunk, CTA c takes c, c + gridDim.x, ...), chunks of N problems. Three
// roles run side by side: warp 20 (one thread) loads the stages; warps 0-3,
// one warpgroup, issue the wgmmas of every stage and write each item's
// |sums| into one of two epilogue buffers (mbarriers kfull / kempty); warps
// 4-19 run each item's epilogue from its buffer (the column pass, then one
// warp's sort a problem) while the wgmmas go on with the next item. The
// epilogue's loads of the norms and the mask are issued before its buffer
// is full, so their latency hides behind the wgmmas too.
//
// The accumulator fragment of m64nNk16 (float32): thread l of warp wq of
// the warpgroup holds, in register v of quarter i (columns i * 64 ..),
// column lane  i * 64 + 16 wq + l / 4 + 8 ((v / 2) % 2)  of the tile and
// problem q = 8 (v / 4) + 2 (l % 4) + v % 2 of the chunk.
template <int N>
__global__ void __launch_bounds__(TC_THREADS, 1)
screen_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmt,
                 const float* __restrict__ col_norm, int cn_stride,
                 const uint8_t* __restrict__ active,
                 const float* __restrict__ r, int m, int n, int p,
                 int h_tile, int masked, float guard,
                 float* __restrict__ score, float* __restrict__ ub,
                 float* __restrict__ lb, float* __restrict__ tops,
                 int* __restrict__ topi, float* __restrict__ tmax) {
  using S = TcScan<N>;
  constexpr int STAGES = S::STAGES, R = N / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* epi = reinterpret_cast<float*>(smem + STAGES * S::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * S::EPI_FLOATS);
  uint64_t* empty = full + TC_MAX_STAGES;
  uint64_t* kfull = empty + TC_MAX_STAGES;   // [b]: buffer b holds |sums|
  uint64_t* kempty = kfull + 2;              // [b]: buffer b is free

  const int t = threadIdx.x, w = t >> 5, wl = t & 31;
  const int p_blocks = (p + BP - 1) / BP, chunks = (m + N - 1) / N;
  const int items = p_blocks * chunks;
  const int kblocks = (n + TC_KB - 1) / TC_KB;
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_MMA / 32);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&kfull[b], TC_MMA / 32);
      mbar_init(&kempty[b], TC_EWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (w == (TC_MMA + TC_EPI) / 32) {    // the producer: one thread
    if (wl == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = item / chunks, chunk = item % chunks;
        const int boxes =
            min(TC_QUARTERS, (p - tile * BP + TC_BOX - 1) / TC_BOX);
        const uint32_t bytes = boxes * TC_BOX_BYTES + (uint32_t)S::TH_STAGE;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[s], ph ^ 1);   // the first round passes at once
          mbar_expect_tx(&full[s], bytes);
          unsigned char* st = smem + s * S::STAGE;
          for (int i = 0; i < boxes; ++i)
            tma_load(st + i * TC_BOX_BYTES, &tmx, tile * BP + i * TC_BOX,
                     kb * TC_KB, &full[s]);
          tma_load(st + S::X_STAGE, &tmt, kb * TC_KB, chunk * N, &full[s]);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  if (w < TC_MMA / 32) {                // the wgmma warpgroup
    int s = 0;
    uint32_t ph = 0;
    for (int it = 0;; ++it) {
      if (blockIdx.x + it * gridDim.x >= items) break;
      float sum[TC_QUARTERS][R];
#pragma unroll
      for (int i = 0; i < TC_QUARTERS; ++i)
#pragma unroll
        for (int v = 0; v < R; ++v) sum[i][v] = 0.f;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[s], ph);
        const uint32_t st = smem_u32(smem + s * S::STAGE);
        float d[TC_QUARTERS][R];
#pragma unroll
        for (int i = 0; i < TC_QUARTERS; ++i) {
#pragma unroll
          for (int v = 0; v < R; ++v) d[i][v] = 0.f;
          fence_regs(d[i]);
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < TC_KB / 16; ++j) {
          // k16 step j: A 16 rows (two groups of 8 swizzled rows) further,
          // B 16 k-values (32 bytes) further along its swizzled rows
          const uint64_t db =
              sw128_desc(st + (uint32_t)S::X_STAGE + 32 * j);
#pragma unroll
          for (int i = 0; i < TC_QUARTERS; ++i)
            wgmma_bf16<N>(d[i], sw128_desc(st + i * TC_BOX_BYTES
                                           + j * 16 * 128), db);
        }
        wgmma_commit_wait();
#pragma unroll
        for (int i = 0; i < TC_QUARTERS; ++i) fence_regs(d[i]);
        __syncwarp();
        if (wl == 0) mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < TC_QUARTERS; ++i)
#pragma unroll
          for (int v = 0; v < R; ++v)
            sum[i][v] = __fadd_rn(sum[i][v], d[i][v]);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      // |sums| into buffer it % 2 once the epilogue has freed it (its use
      // it / 2 - 1)
      const int b = it & 1, u = it >> 1;
      if (u > 0) mbar_wait(&kempty[b], (uint32_t)(u - 1) & 1);
      float* key_s = epi + b * S::EPI_FLOATS;
#pragma unroll
      for (int i = 0; i < TC_QUARTERS; ++i)
#pragma unroll
        for (int v = 0; v < R; ++v) {
          const int lane = i * TC_BOX + 16 * w + (wl >> 2)
                           + 8 * ((v >> 1) & 1);
          const int q = 8 * (v >> 2) + 2 * (wl & 3) + (v & 1);
          key_s[q * TC_KS + lane + lane / SORT_PER_LANE] = fabsf(sum[i][v]);
        }
      __syncwarp();
      if (wl == 0) mbar_arrive(&kfull[b]);
    }
    return;
  }

  // the epilogue: thread e owns column lane c of the tile for the chunk's
  // problems of parity half; warp ew sorts problems ew, ew + 16, ...
  const int e = t - TC_MMA, ew = e >> 5, c = e % BP, half = e / BP;
  constexpr int QH = N / 2;             // problems of a parity
  for (int it = 0;; ++it) {
    const int item = blockIdx.x + it * gridDim.x;
    if (item >= items) break;
    const int tile = item / chunks, q0 = (item % chunks) * N;
    const int nb = min(N, m - q0), col = tile * BP + c;
    float nr[QH];
    bool act[QH];
#pragma unroll
    for (int j = 0; j < QH; ++j) {
      const int q = 2 * j + half, b = q0 + q;
      const bool in = col < p && q < nb;
      nr[j] = in ? mul_rn(col_norm[(size_t)b * cn_stride + col], r[b]) : 0.f;
      act[j] = !in || (masked && active[(size_t)b * p + col] != 0);
    }
    const int b = it & 1;
    mbar_wait(&kfull[b], (uint32_t)(it >> 1) & 1);
    float* key_s = epi + b * S::EPI_FLOATS;
    float* umax_s = key_s + N * TC_KS;
#pragma unroll
    for (int j = 0; j < QH; ++j) {
      const int q = 2 * j + half;
      if (q >= nb) break;
      const size_t at = (size_t)(q0 + q) * p + col;
      float* ks = key_s + q * TC_KS + c + c / SORT_PER_LANE;
      const float sc = *ks;
      if (!masked) {
        if (col < p) {
          score[at] = sc;
          ub[at] = add_rn(sc, nr[j]);
          lb[at] = fabsf(sub_rn(sc, nr[j]));
        }
        continue;
      }
      const float ms = act[j] ? -pos_inf<float>() : sc;
      float u = add_rn(ms, nr[j]);
      if (guard != 1.f) u = mul_rn(u, guard);
      if (col < p) {
        score[at] = ms;
        ub[at] = u;
        lb[at] = fabsf(sub_rn(ms, nr[j]));
      }
      *ks = ms;
      float mx = fmaxf(-pos_inf<float>(), u);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (wl == 0) umax_s[q * TC_UWARPS + (c >> 5)] = mx;
    }
    if (masked) {
      epi_sync();
      for (int q = ew; q < nb; q += TC_EWARPS) {
        const size_t tb = (size_t)(q0 + q) * p_blocks + tile;
        tile_top(key_s + q * TC_KS, umax_s + q * TC_UWARPS, TC_UWARPS, wl,
                 h_tile, tile * BP, tops + tb * h_tile, topi + tb * h_tile,
                 tmax + tb);
      }
    }
    __syncwarp();
    if (wl == 0) mbar_arrive(&kempty[b]);
  }
}

// ---------------------------------------------------------------------------
// K2: the screen's tail
// ---------------------------------------------------------------------------
constexpr int TAIL_THREADS = 512;
constexpr int TAIL_WARPS = TAIL_THREADS / 32;
constexpr int TAIL_UNROLL = 4;            // 16-byte loads in flight a thread

// torch.sort's ascending order on values: NaN after everything else
template <typename T>
__device__ __forceinline__ bool sorts_before(T a, T b) {
  return a < b || (b != b && a == a);
}

// max as torch.max reduces: a NaN anywhere makes the result NaN
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// lb_l = |s_l - ||x_{id_l}|| r|, rounded as the plain version rounds it; a
// padding lane (id >= p) reads column p - 1, as the clamp there does
template <typename T>
__device__ __forceinline__ T cand_bound(const T* score, const int64_t* idx,
                                        const T* cn, T r, int p, int l) {
  const int64_t i = idx[l] < (int64_t)p - 1 ? idx[l] : (int64_t)p - 1;
  return fabs(sub_rn(score[l], mul_rn(cn[i], r)));
}

// Sort v[0, h) ascending in place: the bitonic network whose merges all
// run upwards (the first step of each merge compares mirror images in the
// block), over the next power of two P of h, with v[h, P) standing for
// values above every other. Those never move, so each comparator that
// reaches them is skipped. NT threads from thread 0 take part; WARP: they
// are one warp, which syncs by __syncwarp.
template <typename T, bool WARP>
__device__ void sort_bounds(T* v, int h, int t) {
  constexpr int NT = WARP ? 32 : TAIL_THREADS;
  int half_p = 1;                       // P / 2: the pairs of a step
  while (2 * half_p < h) half_p <<= 1;
  for (int lk = 1; (1 << (lk - 1)) < h; ++lk) {     // blocks of k = 2^lk
    for (int lj = lk - 1; lj >= 0; --lj) {          // distance 2^lj
      for (int q = t; q < half_p; q += NT) {
        const int lo = ((q >> lj) << (lj + 1)) | (q & ((1 << lj) - 1));
        const int hi = lj == lk - 1 ? lo ^ ((1 << lk) - 1)   // mirror
                                    : lo + (1 << lj);
        if (hi < h) {
          const T a = v[lo], b = v[hi];
          if (sorts_before(b, a)) {
            v[lo] = b;
            v[hi] = a;
          }
        }
      }
      if (WARP) __syncwarp();
      else __syncthreads();
    }
  }
}

// c = #{l : lb[l] <= u} on lb sorted (NaN last), whose predicate is true on
// a prefix: binary search from the largest power of two <= h, top.
template <typename T>
__device__ __forceinline__ int count_le(const T* lb, int h, int top, T u) {
  int c = 0;
  for (int s = top; s > 0; s >>= 1) {
    const int nc = c + s;
    if (nc <= h && lb[nc - 1] <= u) c = nc;
  }
  return c;
}

// torch.searchsorted(lb, v, right=False), its loop as torch writes it (the
// same midpoints, so the same answer for a NaN too)
template <typename T>
__device__ __forceinline__ int lower_bound(const T* lb, int h, T v) {
  int s = 0, e = h;
  while (s < e) {
    const int mid = s + ((e - s) >> 1);
    if (!(lb[mid] >= v)) s = mid + 1;
    else e = mid;
  }
  return s;
}

// One cluster of gridDim.x CTAs per problem b = blockIdx.y. With lb_sorted
// set it is the histogram entry (writes hist only); otherwise the tail.
template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
screen_tail_kernel(const T* __restrict__ ub, int p, int h,
                   const T* __restrict__ lb_sorted,
                   const T* __restrict__ cand_score, int cs_stride,
                   const int64_t* __restrict__ cand_idx,
                   const T* __restrict__ col_norm, int cn_stride,
                   const T* __restrict__ r, const T* __restrict__ tmax,
                   int pb, int* __restrict__ hist, T* __restrict__ cand_lb,
                   int* __restrict__ cand_ge, int* __restrict__ n_surv,
                   T* __restrict__ max_ub) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncta = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int t = threadIdx.x, w = t >> 5, wl = t & 31;
  const bool tail = lb_sorted == nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  T* lb_s = reinterpret_cast<T*>(smem);
  T* wmax_s = lb_s + ((h + 1) & ~1);                     // TAIL_WARPS
  int* bins_s = reinterpret_cast<int*>(wmax_s + TAIL_WARPS);   // h + 1
  int* surv_s = bins_s + h + 1;                          // 1
  int* wsum_s = surv_s + 1;                              // TAIL_WARPS

  // the tile maxima (by the last CTA) and this thread's first ub vectors
  // are requested first: their latency overlaps the bounds and the sort
  T mx = -pos_inf<T>();
  if (tail && rank == ncta - 1)
    for (int i = t; i < pb; i += TAIL_THREADS)
      mx = max_nan(mx, tmax[(size_t)b * pb + i]);
  const T* u = ub + (size_t)b * p;
  constexpr int V = 16 / sizeof(T);
  constexpr int STRIDE = TAIL_UNROLL * TAIL_THREADS;
  const int head =
      min(p, (int)(((16 - ((uintptr_t)u & 15)) & 15) / sizeof(T)));
  const int nv = (p - head) / V;
  const int v0 = (int)((int64_t)nv * rank / ncta);
  const int v1 = (int)((int64_t)nv * (rank + 1) / ncta);
  const Vec<T, V>* uv = reinterpret_cast<const Vec<T, V>*>(u + head);
  Vec<T, V> x[TAIL_UNROLL];
  auto fetch = [&](int v) {
#pragma unroll
    for (int k = 0; k < TAIL_UNROLL; ++k)
      if (v + k * TAIL_THREADS < v1) x[k] = uv[v + k * TAIL_THREADS];
  };
  fetch(v0 + t);

  // the bins start at zero; the leader's are ready for the others at the
  // cluster barrier's arrival, which the pass overlaps
  for (int i = t; i <= h; i += TAIL_THREADS) bins_s[i] = 0;
  if (t == 0) *surv_s = 0;
  const T* score = cand_score + (size_t)b * cs_stride;
  const int64_t* idx = cand_idx + (size_t)b * h;
  const T* cn = col_norm + (size_t)b * cn_stride;
  const T rb = tail ? r[b] : T(0);
  T mine = T(0);                        // bound l = t, kept for the leader
  for (int l = t; l < h; l += TAIL_THREADS) {
    T v;
    if (tail) {
      v = cand_bound(score, idx, cn, rb, p, l);
      if (rank == 0) cand_lb[(size_t)b * h + l] = v;
    } else {
      v = lb_sorted[(size_t)b * h + l];
    }
    if (l == t) mine = v;
    lb_s[l] = v;
  }
  __syncthreads();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (tail) {
    if (h <= 256) {
      if (w == 0) sort_bounds<T, true>(lb_s, h, t);
      __syncthreads();
    } else {
      sort_bounds<T, false>(lb_s, h, t);
    }
  }

  // one pass over this CTA's slice of ub, the next vectors in flight
  const T lo = h > 0 ? lb_s[0] : CUDART_NAN;             // NaN: all in bin 0
  const T hi = h > 0 ? lb_s[h - 1] : CUDART_NAN;
  const int top = h > 0 ? 1 << (31 - __clz(h)) : 0;
  int n0 = 0, nh = 0, ns = 0;
  auto count = [&](T y) {
    ns += y >= T(1);
    if (!(lo <= y)) {
      ++n0;
    } else if (hi <= y) {
      ++nh;
    } else {
      atomicAdd(&bins_s[count_le(lb_s, h, top, y)], 1);
    }
  };
  for (int v = v0 + t; v < v1; v += STRIDE) {
    Vec<T, V> y[TAIL_UNROLL];
#pragma unroll
    for (int k = 0; k < TAIL_UNROLL; ++k) y[k] = x[k];
    fetch(v + STRIDE);
#pragma unroll
    for (int k = 0; k < TAIL_UNROLL; ++k)
      if (v + k * TAIL_THREADS < v1)
#pragma unroll
        for (int j = 0; j < V; ++j) count(y[k].v[j]);
  }
  if (rank == ncta - 1) {               // the unaligned head and the tail
    for (int i = t; i < head; i += TAIL_THREADS) count(u[i]);
    for (int i = head + nv * V + t; i < p; i += TAIL_THREADS) count(u[i]);
  }
  n0 = __reduce_add_sync(0xffffffffu, n0);
  nh = __reduce_add_sync(0xffffffffu, nh);
  ns = __reduce_add_sync(0xffffffffu, ns);
  if (wl == 0) {
    if (n0) atomicAdd(&bins_s[0], n0);
    if (nh) atomicAdd(&bins_s[h], nh);
    if (ns) atomicAdd(surv_s, ns);
  }

  // max ub of the problem's tile maxima, by the last CTA
  if (tail && rank == ncta - 1) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (wl == 0) wmax_s[w] = mx;
  }
  __syncthreads();                      // this CTA's bins are complete
  if (tail && rank == ncta - 1 && t == 0) {
    T m = wmax_s[0];
    for (int i = 1; i < TAIL_WARPS; ++i) m = max_nan(m, wmax_s[i]);
    max_ub[b] = m;
  }

  // merge into the leader's bins
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (rank != 0) {
    int* dst = cluster.map_shared_rank(bins_s, 0);
    for (int i = t; i <= h; i += TAIL_THREADS) {
      const int c = bins_s[i];
      if (c) atomicAdd(dst + i, c);
    }
    if (t == 0 && *surv_s) atomicAdd(cluster.map_shared_rank(surv_s, 0),
                                     *surv_s);
  }
  cluster.sync();
  if (rank != 0) return;

  if (!tail) {
    for (int i = t; i <= h; i += TAIL_THREADS)
      hist[(size_t)b * (h + 1) + i] = bins_s[i];
    return;
  }
  if (t == 0) n_surv[b] = *surv_s;
  // suffix sums in place: bins_s[m] = #{i : c_i >= m}; thread t owns bins
  // [t*per, t*per + per)
  const int per = (h + 1 + TAIL_THREADS - 1) / TAIL_THREADS;
  const int i0 = min(t * per, h + 1), i1 = min(i0 + per, h + 1);
  int own = 0;
  for (int i = i0; i < i1; ++i) own += bins_s[i];
  int inc = own;                        // own + every later lane's
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(0xffffffffu, inc, off);
    if (wl + off < 32) inc += o;
  }
  if (wl == 0) wsum_s[w] = inc;
  __syncthreads();
  int acc = inc - own;
  for (int j = w + 1; j < TAIL_WARPS; ++j) acc += wsum_s[j];
  for (int i = i1 - 1; i >= i0; --i) {
    acc += bins_s[i];
    bins_s[i] = acc;
  }
  __syncthreads();
  for (int l = t; l < h; l += TAIL_THREADS) {
    const T v = l == t ? mine : cand_bound(score, idx, cn, rb, p, l);
    const int pos = lower_bound(lb_s, h, v);
    cand_ge[(size_t)b * h + l] = bins_s[pos + 1 < h ? pos + 1 : h];
  }
}

__global__ void empty_kernel() {}

template <typename TI, typename T, int BB>
int launch_screen(const void* X, const void* Theta, const void* col_norm,
                  int cn_stride, const void* active, const void* r, int m,
                  int n, int p, int h_tile, int masked, T guard, void* score,
                  void* ub, void* lb, void* tops, void* topi, void* tmax,
                  void* stream) {
  using S = Scan<TI, T, BB>;
  const size_t smem = S::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      screen_fused_kernel<TI, T, BB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, screen_fused_kernel<TI, T, BB>, S::THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int items = ((p + BP - 1) / BP) * ((m + BB - 1) / BB);
  if (items == 0) return (int)cudaSuccess;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  screen_fused_kernel<TI, T, BB><<<grid, S::THREADS, smem,
                                   (cudaStream_t)stream>>>(
      (const TI*)X, (const T*)Theta, (const T*)col_norm, cn_stride,
      (const uint8_t*)active, (const T*)r, m, n, p, h_tile, masked, guard,
      (T*)score, (T*)ub, (T*)lb, (T*)tops, (int*)topi, (T*)tmax);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link)
cudaError_t encoder(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || f == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of a row-major bf16 matrix (rows, cols) with row stride
// ld elements, read in boxes of 64 columns (128 bytes, swizzled) x
// box_rows rows; out-of-range elements read as zeros.
int encode_bf16(EncodeTiledFn enc, CUtensorMap* map, const void* base,
                int rows, int cols, int ld, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TC_BOX, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TC_ENCODE_ERROR + (int)res;
}

// K1 / K1b's bf16 mode: chunks of N = 8 problems while m <= 8, else 16
template <int N>
int launch_tc(const void* X, int ldx, const void* Theta, int ldt,
              const void* col_norm, int cn_stride, const void* active,
              const void* r, int m, int n, int p, int h_tile, int masked,
              float guard, void* score, void* ub, void* lb, void* tops,
              void* topi, void* tmax, void* stream) {
  using S = TcScan<N>;
  const int items = ((p + BP - 1) / BP) * ((m + N - 1) / N);
  if (items == 0) return (int)cudaSuccess;
  CUtensorMap tmx, tmt;
  memset(&tmx, 0, sizeof tmx);
  memset(&tmt, 0, sizeof tmt);
  if (n > 0) {                          // n = 0: no stage is loaded
    EncodeTiledFn enc;
    cudaError_t e = encoder(&enc);
    if (e != cudaSuccess) return (int)e;
    int rc = encode_bf16(enc, &tmx, X, n, p, ldx, TC_KB);
    if (rc != 0) return rc;
    rc = encode_bf16(enc, &tmt, Theta, m, n, ldt, N);
    if (rc != 0) return rc;
  }
  cudaError_t e = cudaFuncSetAttribute(
      screen_tc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, screen_tc_kernel<N>, TC_THREADS, S::SMEM);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  screen_tc_kernel<N><<<grid, TC_THREADS, S::SMEM, (cudaStream_t)stream>>>(
      tmx, tmt, (const float*)col_norm, cn_stride, (const uint8_t*)active,
      (const float*)r, m, n, p, h_tile, masked, guard, (float*)score,
      (float*)ub, (float*)lb, (float*)tops, (int*)topi, (float*)tmax);
  return (int)cudaGetLastError();
}

// The tail kernel over m problems, one cluster each: 16 CTAs (the
// non-portable size) while the m clusters of 16 fit on the SMs at once,
// else the portable 8 (16 of 16-CTA clusters ran in two waves).
template <typename T>
int launch_tail(const void* ub, int m, int p, int h, const void* lb_sorted,
                const void* cand_score, int cs_stride, const void* cand_idx,
                const void* col_norm, int cn_stride, const void* r,
                const void* tmax, int pb, void* hist, void* cand_lb,
                void* cand_ge, void* n_surv, void* max_ub, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  cudaError_t e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int cluster = 16 * m <= sms ? 16 : 8;
  const size_t smem = (size_t)((h + 1) & ~1) * sizeof(T)
                      + TAIL_WARPS * sizeof(T) + (size_t)(h + 2) * sizeof(int)
                      + TAIL_WARPS * sizeof(int);
  e = cudaFuncSetAttribute(
      screen_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(screen_tail_kernel<T>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, m, 1);
  cfg.blockDim = dim3(TAIL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, screen_tail_kernel<T>, (const T*)ub, p, h,
                         (const T*)lb_sorted, (const T*)cand_score, cs_stride,
                         (const int64_t*)cand_idx, (const T*)col_norm,
                         cn_stride, (const T*)r, (const T*)tmax, pb,
                         (int*)hist, (T*)cand_lb, (int*)cand_ge, (int*)n_surv,
                         (T*)max_ub);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 (BB = 1, m = 1) and K1b (BB = 16): the same kernel and arguments; X in
// TI, everything else in T (the float mixed mode is the _f32 entry on an X
// cast to float).
#define SCREEN_ENTRY(NAME, TI, T, BB)                                          \
  int NAME(const void* X, const void* Theta, const void* col_norm,            \
           int cn_stride, const void* active, const void* r, int m, int n,    \
           int p, int h_tile, int masked, T guard, void* score, void* ub,     \
           void* lb, void* tops, void* topi, void* tmax, void* stream) {      \
    return launch_screen<TI, T, BB>(X, Theta, col_norm, cn_stride, active, r, \
                                    m, n, p, h_tile, masked, guard, score,    \
                                    ub, lb, tops, topi, tmax, stream);        \
  }

SCREEN_ENTRY(screen_fused_f32, float, float, 1)
SCREEN_ENTRY(screen_fused_f64, double, double, 1)
SCREEN_ENTRY(screen_fused_batch_f32, float, float, 16)
SCREEN_ENTRY(screen_fused_batch_f64, double, double, 16)

// K1 and K1b in the bf16 mixed mode, the tensor-core scan: X (n, p) and
// Theta (m, n) in bf16 with row strides ldx and ldt (multiples of 8
// elements, 16-byte-aligned starts), col_norm, r, guard and the outputs in
// float32, otherwise the scan entries' arguments. Returns a cudaError_t,
// or TC_ENCODE_ERROR + the CUresult of a refused tensor-map encode.
int screen_fused_tc(const void* X, int ldx, const void* Theta, int ldt,
                    const void* col_norm, int cn_stride, const void* active,
                    const void* r, int m, int n, int p, int h_tile,
                    int masked, float guard, void* score, void* ub, void* lb,
                    void* tops, void* topi, void* tmax, void* stream) {
  return m <= 8
             ? launch_tc<8>(X, ldx, Theta, ldt, col_norm, cn_stride, active,
                            r, m, n, p, h_tile, masked, guard, score, ub, lb,
                            tops, topi, tmax, stream)
             : launch_tc<16>(X, ldx, Theta, ldt, col_norm, cn_stride, active,
                             r, m, n, p, h_tile, masked, guard, score, ub,
                             lb, tops, topi, tmax, stream);
}

// K2 and K2b, the histogram entry: hist (m, h+1) of ub (m, p) against
// lb_sorted (m, h)
#define HIST_ENTRY(NAME, T)                                                    \
  int NAME(const void* ub, const void* lb_sorted, int m, int p, int h,        \
           void* hist, void* stream) {                                        \
    return launch_tail<T>(ub, m, p, h, lb_sorted, nullptr, 0, nullptr,        \
                          nullptr, 0, nullptr, nullptr, 0, hist, nullptr,     \
                          nullptr, nullptr, nullptr, stream);                 \
  }

HIST_ENTRY(ub_histogram_f32, float)
HIST_ENTRY(ub_histogram_f64, double)

// K2 and K2b, the tail entry: from ub (m, p), tmax (m, pb), the candidates'
// scores (row stride cs_stride) and ids (m, h), the norms (row stride
// cn_stride: 0 shared, p per problem) and r (m,), writes cand_lb and
// cand_ge (m, h), n_surv and max_ub (m,)
#define TAIL_ENTRY(NAME, T)                                                    \
  int NAME(const void* ub, const void* tmax, const void* cand_score,          \
           int cs_stride, const void* cand_idx, const void* col_norm,         \
           int cn_stride, const void* r, int m, int p, int pb, int h,         \
           void* cand_lb, void* cand_ge, void* n_surv, void* max_ub,          \
           void* stream) {                                                    \
    return launch_tail<T>(ub, m, p, h, nullptr, cand_score, cs_stride,        \
                          cand_idx, col_norm, cn_stride, r, tmax, pb,         \
                          nullptr, cand_lb, cand_ge, n_surv, max_ub, stream); \
  }

TAIL_ENTRY(screen_tail_f32, float)
TAIL_ENTRY(screen_tail_f64, double)

// one launch of an empty kernel: the floor under a launch's device time
int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
