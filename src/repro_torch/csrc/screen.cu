// SAIF screening kernels for Hopper (sm_90a), plain C interface for ctypes.
//
// K1 screen_fused — replaces repro/kernels/screen/screen.py:271
//    screen_fused_pallas (and, with masked == 0, :124 screen_scores_pallas).
//    Per column i of the row-major (n, p) design X:
//        s_i  = |x_i^T theta|                 (-inf when i is active/padding)
//        ub_i = s_i + ||x_i|| r,  lb_i = |s_i - ||x_i|| r|   (+inf when masked)
//    and per tile of BP columns its top-h_tile (score, global id), ties to
//    the lowest lane, and its max ub.
//    Bound on this card: reading X once, n*p*itemsize bytes at 3.35 TB/s;
//    the epilogue is O(BP * h_tile) per tile, on data already on chip.
//    Design: one CTA per tile of BP = 256 columns, one thread per column.
//    The thread walks the n rows, so a warp reads 32 neighbouring columns of
//    one row: every load of X is coalesced and X is read exactly once. The
//    TPU kernel carried a partial sum across sequential grid steps; here the
//    sum stays in a register for the whole column (no cross-CTA traffic),
//    kept in the working type (double for f64). theta is staged through
//    shared memory in chunks of BP rows. The top-h is h_tile rounds of a
//    block argmax over (available, score, -lane), the TPU kernel's
//    sort-free iterative extraction.
//
// K1b screen_fused_batch — replaces repro/kernels/screen/screen.py:394
//    screen_fused_batch_pallas: K1 for m problems over one shared X
//    (Theta (m, n), active (m, p), r (m,), col_norm shared or per problem).
//    Bound on this card: reading X once per chunk of BB = 16 problems,
//    n*p*itemsize bytes at 3.35 TB/s (2*n*p*16 flops per chunk stay far
//    under the f64 peak). Design: K1's grid gains a chunk axis; a thread
//    keeps BB accumulators, one per problem of its chunk, so one load of
//    X[i, col] feeds all of them and X is read once per chunk instead of
//    once per problem. Theta for the chunk is staged through shared memory
//    as K1 stages theta, row-major so that a row's 16 values come in
//    16-byte broadcast loads; then the same buffer holds the finished sums
//    for K1's epilogue, run once per problem. K1 is the BB = 1 instance of the
//    same kernel, and every row step is one explicit fma in the same row
//    order, so each problem's scores are bitwise K1's.
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

constexpr int BP = 256;          // columns per CTA = threads per CTA
constexpr int NWARP = BP / 32;

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

template <typename T>
struct Cand {
  int av;     // 1 if the lane is still available
  T val;
  int lane;
};

// a beats b: available first, then the larger score, then the lower lane
template <typename T>
__device__ __forceinline__ bool beats(const Cand<T>& a, const Cand<T>& b) {
  if (a.av != b.av) return a.av > b.av;
  if (a.val != b.val) return a.val > b.val;
  return a.lane < b.lane;
}

template <typename T>
__device__ __forceinline__ Cand<T> warp_best(Cand<T> c) {
  for (int off = 16; off > 0; off >>= 1) {
    Cand<T> o;
    o.av = __shfl_down_sync(0xffffffffu, c.av, off);
    o.val = __shfl_down_sync(0xffffffffu, c.val, off);
    o.lane = __shfl_down_sync(0xffffffffu, c.lane, off);
    if (beats(o, c)) c = o;
  }
  return c;
}

// The BB Theta values of one row of a chunk, read from shared memory in
// 16-byte loads (one broadcast per load) instead of one load per problem.
template <typename T, int BB>
struct __align__(16) ThetaRow {
  T v[BB];
};

// Grid (p tiles, problem chunks). CTA (tile, c) scans columns
// [tile*BP, tile*BP + BP) for problems [c*BB, c*BB + nb) of the m.
template <typename T, int BB>
__global__ void __launch_bounds__(BP)
screen_fused_kernel(const T* __restrict__ X, const T* __restrict__ Theta,
                    const T* __restrict__ col_norm, int cn_stride,
                    const uint8_t* __restrict__ active,
                    const T* __restrict__ r, int m, int n, int p, int h_tile,
                    int masked, T* __restrict__ score, T* __restrict__ ub,
                    T* __restrict__ lb, T* __restrict__ tops,
                    int* __restrict__ topi, T* __restrict__ tmax) {
  // row i of the chunk's Theta block, then (per lane) the finished sums
  __shared__ ThetaRow<T, BB> th_s[BP];
  __shared__ Cand<T> red[NWARP];
  __shared__ T red_max[NWARP];
  __shared__ int winner;

  const int lane = threadIdx.x;
  const int tile = blockIdx.x;
  const int col = tile * BP + lane;
  const bool in = col < p;
  const int q0 = blockIdx.y * BB;
  const int nb = min(BB, m - q0);
  const int p_blocks = gridDim.x;

  T acc[BB];
#pragma unroll
  for (int q = 0; q < BB; ++q) acc[q] = T(0);
  for (int r0 = 0; r0 < n; r0 += BP) {
    const int rows = min(BP, n - r0);
    __syncthreads();
    for (int e = lane; e < rows * BB; e += BP) {   // consecutive smem words
      const int i = e / BB, q = e % BB;
      th_s[i].v[q] = q < nb ? Theta[(size_t)(q0 + q) * n + r0 + i] : T(0);
    }
    __syncthreads();
    if (in) {
      const T* xp = X + (size_t)r0 * p + col;
#pragma unroll (BB == 1 ? 8 : 4)
      for (int i = 0; i < rows; ++i) {
        const T x = xp[(size_t)i * p];           // one load feeds the chunk
        const ThetaRow<T, BB> th = th_s[i];
#pragma unroll
        for (int q = 0; q < BB; ++q)
          if (q < nb) acc[q] = fma_rn(th.v[q], x, acc[q]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < BB; ++q) th_s[lane].v[q] = acc[q];  // own lane only

  const int w = lane >> 5, wl = lane & 31;
  for (int q = 0; q < nb; ++q) {
    const int b = q0 + q;
    const size_t at = (size_t)b * p + col;
    const T s = fabs(th_s[lane].v[q]);
    const T nr = in ? mul_rn(col_norm[(size_t)b * cn_stride + col], r[b])
                    : T(0);
    if (!masked) {
      if (in) {
        score[at] = s;
        ub[at] = add_rn(s, nr);
        lb[at] = fabs(sub_rn(s, nr));
      }
      continue;
    }
    const bool act = !in || active[at] != 0;
    const T ms = act ? -pos_inf<T>() : s;
    const T u = add_rn(ms, nr);
    if (in) {
      score[at] = ms;
      ub[at] = u;
      lb[at] = fabs(sub_rn(ms, nr));
    }

    // tile max ub
    T mx = u;
    for (int off = 16; off > 0; off >>= 1)
      mx = fmax(mx, __shfl_down_sync(0xffffffffu, mx, off));
    if (wl == 0) red_max[w] = mx;
    __syncthreads();
    const size_t tb = (size_t)b * p_blocks + tile;
    if (lane == 0) {
      T mm = red_max[0];
      for (int i = 1; i < NWARP; ++i) mm = fmax(mm, red_max[i]);
      tmax[tb] = mm;
    }

    // tile top-h: h_tile rounds of block argmax, the winner leaves the pool
    int avail = 1;
    for (int t = 0; t < h_tile; ++t) {
      Cand<T> c{avail, avail ? ms : -pos_inf<T>(), lane};
      c = warp_best(c);
      if (wl == 0) red[w] = c;
      __syncthreads();
      if (lane == 0) {
        Cand<T> best = red[0];
        for (int i = 1; i < NWARP; ++i)
          if (beats(red[i], best)) best = red[i];
        tops[tb * h_tile + t] = best.val;
        topi[tb * h_tile + t] = tile * BP + best.lane;
        winner = best.lane;
      }
      __syncthreads();
      if (lane == winner) avail = 0;
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
  const dim3 grid((p + BP - 1) / BP, (m + BB - 1) / BB);
  screen_fused_kernel<T, BB><<<grid, BP, 0, (cudaStream_t)stream>>>(
      (const T*)X, (const T*)Theta, (const T*)col_norm, cn_stride,
      (const uint8_t*)active, (const T*)r, m, n, p, h_tile, masked, (T*)score,
      (T*)ub, (T*)lb, (T*)tops, (int*)topi, (T*)tmax);
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
