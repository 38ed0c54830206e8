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
//    Bound on this card: n_epochs * live dependent block steps, each a
//    pass over n rows (2 gsize loads and fmas and a gradient a row), a
//    block reduction of gsize sums, one division and a square root. The
//    bytes (the live block once, 80 KB a slot at n = 1000, gsize 10 in
//    f64) and operations (~4 n gsize a step) are small against the
//    latency of a step: what bounds it is that chain, as for K3.
//    Design: one CTA of GROUP_NT = 512 threads owns the burst (256 and
//    1,024 were slower: PERF.md section 6); thread t owns the rows t,
//    t + 512, ..., so every load of A is coalesced (a block's gsize
//    columns are gsize rows of A, the live block L2-resident across
//    epochs; a first version read the design in place, n rows p apart a
//    step, and was slower). Shared memory holds z, y, the rows' gradients,
//    the live slots' coefficients, L and lam / L (formed once a launch,
//    the same division as the step's), so the gate
//    (kernels/group/group.py::group_smem_ok) is on n, k and gsize. A step
//    is one pass over the thread's rows that applies the previous step's
//    update to z (the row's gsize products summed first, then added: one
//    rounding at z's scale, as the plain version's addmv; adding each
//    product to z_i put the float32 results 2-5x farther from the
//    float64 ones than the plain version's), forms f'(z_i) and this
//    step's partial dots, CH = 8
//    columns at a time (a register array; any gsize up to 256 in chunks,
//    each chunk with its warp shuffles), then three barriers: the warp
//    sums are in (A), warp c % 16 sums column c over the warps with its
//    shuffles and forms v_c (B), every thread takes ||v|| from the same
//    values in the same order, threads c < gsize write b_c and the update
//    d_c, and the barrier (C) also tells every thread whether any d_c is
//    nonzero: a step that moves nothing leaves z as it was.
//    Every product is an explicit fma; each thread's sums run over its
//    rows ascending and the warp trees shuffle down 16 -> 1 in a fixed
//    order, so a launch is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

// threads of the one CTA (scripts/group_bcd_threads_probe.py builds others)
#ifndef GROUP_NT
#define GROUP_NT 512
#endif

namespace {

constexpr int CH = 8;              // columns of a block reduced together
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

template <typename T, int L, int NT>
__global__ void __launch_bounds__(NT, 1) group_bcd_kernel(
    const T* __restrict__ A, const T* __restrict__ y,
    const int* __restrict__ slot, T* __restrict__ beta,
    const T* __restrict__ Lg, T lam, int n_ep, int n, int nl, int gsz,
    T* __restrict__ zout) {
  constexpr int NW = NT / 32;
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

// keep in step with kernels/group/group.py::group_smem_bytes (which counts
// every slot, live or not)
size_t smem_bytes(int n, int nl, int gsz, int nw, size_t itemsize) {
  return (3 * (size_t)n + (size_t)nl * gsz + 2 * (size_t)nl +
          (nw + 2) * (size_t)gsz) * itemsize;
}

template <typename T, int L, int NT>
int launch(const void* A, const void* y, const void* slot, void* beta,
           const void* Lg, T lam, int n_epochs, int n, int nl, int gsz,
           void* z, void* stream) {
  if (gsz < 1 || gsz > 256) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, nl, gsz, NT / 32, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        group_bcd_kernel<T, L, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  group_bcd_kernel<T, L, NT><<<1, NT, smem, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)y, (const int*)slot, (T*)beta, (const T*)Lg,
      lam, n_epochs, n, nl, gsz, (T*)z);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A (nl, gsize, n): the live blocks, transposed; slot (nl,) their slot ids
// in slot order; beta (k, gsize) updated in place on the live slots; L (k)
#define GROUP_BCD_ENTRY(NAME, T, L, NT)                                      \
  int NAME(const void* A, const void* y, const void* slot, void* beta,      \
           const void* Lg, T lam, int n_epochs, int n, int nl, int gsize,   \
           void* z, void* stream) {                                          \
    return launch<T, L, NT>(A, y, slot, beta, Lg, lam, n_epochs, n, nl,     \
                            gsize, z, stream);                               \
  }

GROUP_BCD_ENTRY(group_bcd_ls_f32, float, LS, GROUP_NT)
GROUP_BCD_ENTRY(group_bcd_ls_f64, double, LS, GROUP_NT)
GROUP_BCD_ENTRY(group_bcd_logit_f32, float, LOGIT, GROUP_NT)
GROUP_BCD_ENTRY(group_bcd_logit_f64, double, LOGIT, GROUP_NT)

#undef GROUP_BCD_ENTRY

}  // extern "C"
