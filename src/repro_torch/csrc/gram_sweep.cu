// Covariance-update CM sweeps for Hopper (sm_90a), plain C interface for
// ctypes.
//
// K6 gram_sweep / K6b gram_sweep_batch — replace the device loop of
//    repro/core/cm.py:126 gram_epochs (an XLA fori_loop, not a pallas_call),
//    the inner sweep of the least-squares Gram engine. On the active block's
//    Gram matrix G (k, k) and rho (k,) (for a weighted problem the carry
//    holds Xa^T diag(w) Xa and Xa^T diag(w) y, so the sweep itself is
//    unweighted):
//        inv_l = 1 / max(alpha G_jj, 1e-30),  thr = lam (pen_j) inv_l
//        qr = G beta - rho
//        for each epoch, for jj < count: j = order[jj]
//          b_new = S(beta_j - qr_j inv_l_j, thr_j)   (0 where mask_j is false)
//          qr += (b_new - beta_j) G[:, j],  beta_j = b_new
//    Returns beta. K6b runs m problems, one CTA each (grid (m,)), reading
//    each problem's lambda, epoch count and live-slot count from device
//    arrays; K6 is its one-problem launch with the counts passed directly,
//    the same body, so a fleet sweep is bitwise a serial sweep.
//    Bound on this card: count * n_epochs dependent steps, each a scalar
//    soft-threshold and a length-k axpy; the bytes (one row of G from L2
//    per step) and flops (2k per step) are tiny, so the latency of one
//    barrier and one L2 round trip per step bounds it.
//    Design: one CTA per problem. qr, beta, inv_l and thr (k each), order
//    and mask sit in shared memory (4 k itemsize + 5 k bytes: 148 KB at
//    k = 4,000 in f64). Thread t owns the entries t, t + NT, ... of qr and
//    beta. The CTA forms qr itself, each entry an explicit fma chain over
//    the slots in slot order (no library gemv whose kernel choice depends
//    on the shape), reading G row by row (coalesced; G is symmetric on
//    live slots). Each step the owner of slot j computes b_new from its
//    own qr_j and beta_j and leaves b_new - beta_j in a shared slot double
//    buffered by step parity, one barrier, then every thread applies the
//    axpy to its own entries with row j of G (coalesced); a zero update is
//    skipped, as the plain loop skips it. One barrier per step. The step's
//    arithmetic is the plain loop's, two roundings each for the product
//    and the difference (no contraction); the axpy is one fma per entry.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per CTA

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T, bool PEN>
__global__ void __launch_bounds__(NT)
gram_sweep_kernel(const T* __restrict__ G, const T* __restrict__ rho,
                  T* __restrict__ beta, const uint8_t* __restrict__ mask,
                  const int* __restrict__ order, const T* __restrict__ pen,
                  const T* __restrict__ lam_b, int n_epochs, int count,
                  const int* __restrict__ nep_b, const int* __restrict__ cnt_b,
                  T alpha, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const T lam = lam_b[b];
  if (nep_b != nullptr) {             // K6b: CTA b owns problem b
    n_epochs = nep_b[b];
    count = cnt_b[b];
  }
  G += (size_t)b * k * k;
  rho += (size_t)b * k;
  beta += (size_t)b * k;
  mask += (size_t)b * k;
  order += (size_t)b * k;
  if (PEN) pen += (size_t)b * k;

  T* q_s = reinterpret_cast<T*>(smem);
  T* b_s = q_s + k;
  T* il_s = b_s + k;
  T* th_s = il_s + k;
  T* d_s = th_s + k;                  // 2 slots: the step's update
  int* o_s = reinterpret_cast<int*>(d_s + 2);
  uint8_t* m_s = reinterpret_cast<uint8_t*>(o_s + k);
  const int tid = threadIdx.x;

  for (int j = tid; j < k; j += NT) {
    b_s[j] = beta[j];
    o_s[j] = order[j];
    m_s[j] = mask[j];
    const T il = div_rn(T(1), fmax(mul_rn(alpha, G[(size_t)j * k + j]), T(1e-30)));
    il_s[j] = il;
    th_s[j] = PEN ? mul_rn(mul_rn(lam, pen[j]), il) : mul_rn(lam, il);
  }
  __syncthreads();
  // qr = G beta - rho over the slots with beta != 0 (a zero term adds 0)
  for (int t = tid; t < k; t += NT) {
    T acc = T(0);
    for (int s = 0; s < k; ++s) {
      const T bs = b_s[s];
      if (bs != T(0)) acc = fma_rn(G[(size_t)s * k + t], bs, acc);
    }
    q_s[t] = sub_rn(acc, rho[t]);
  }
  __syncthreads();                    // the sweep writes b_s

  int parity = 0;
  for (int ep = 0; ep < n_epochs; ++ep) {
    for (int jj = 0; jj < count; ++jj) {
      const int j = o_s[jj];
      if (j % NT == tid) {            // the owner of slot j
        const T bj = b_s[j];
        T b_new = T(0);
        if (m_s[j]) {
          const T u = sub_rn(bj, mul_rn(q_s[j], il_s[j]));
          const T a = sub_rn(fabs(u), th_s[j]);
          b_new = a > T(0) ? copysign(a, u) : T(0);
        }
        b_s[j] = b_new;
        d_s[parity] = sub_rn(b_new, bj);
      }
      __syncthreads();
      const T d = d_s[parity];
      parity ^= 1;
      if (d != T(0)) {
        const T* gj = G + (size_t)j * k;
        for (int t = tid; t < k; t += NT) q_s[t] = fma_rn(d, gj[t], q_s[t]);
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < k; j += NT) beta[j] = b_s[j];
}

// keep in step with kernels/gram/gram.py::gram_smem_bytes
size_t smem_bytes(int k, size_t itemsize) {
  return (4 * (size_t)k + 2) * itemsize + (size_t)k * (sizeof(int) + 1);
}

template <typename T, bool PEN>
int launch_t(const void* G, const void* rho, void* beta, const void* mask,
             const void* order, const void* pen, const void* lam,
             int n_epochs, int count, const void* nep, const void* cnt,
             T alpha, int m, int k, void* stream) {
  const size_t smem = smem_bytes(k, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gram_sweep_kernel<T, PEN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gram_sweep_kernel<T, PEN><<<m, NT, smem, (cudaStream_t)stream>>>(
      (const T*)G, (const T*)rho, (T*)beta, (const uint8_t*)mask,
      (const int*)order, (const T*)pen, (const T*)lam, n_epochs, count,
      (const int*)nep, (const int*)cnt, alpha, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* G, const void* rho, void* beta, const void* mask,
           const void* order, const void* pen, const void* lam, int n_epochs,
           int count, const void* nep, const void* cnt, T alpha, int m, int k,
           void* stream) {
  if (m < 1 || k < 1) return 0;
  if (pen != nullptr)
    return launch_t<T, true>(G, rho, beta, mask, order, pen, lam, n_epochs,
                             count, nep, cnt, alpha, m, k, stream);
  return launch_t<T, false>(G, rho, beta, mask, order, pen, lam, n_epochs,
                            count, nep, cnt, alpha, m, k, stream);
}

}  // namespace

extern "C" {

// G (m, k, k), rho / beta / mask / order / pen (m, k), lam (m,). K6 passes
// m = 1 with nep = cnt = null and the counts directly; K6b passes the (m,)
// device arrays nep and cnt. pen is null for an all-penalized block.
#define GRAM_ENTRY(NAME, T)                                                    \
  int NAME(const void* G, const void* rho, void* beta, const void* mask,      \
           const void* order, const void* pen, const void* lam,               \
           int n_epochs, int count, const void* nep, const void* cnt,         \
           T alpha, int m, int k, void* stream) {                              \
    return launch<T>(G, rho, beta, mask, order, pen, lam, n_epochs, count,    \
                     nep, cnt, alpha, m, k, stream);                           \
  }

GRAM_ENTRY(gram_sweep_f32, float)
GRAM_ENTRY(gram_sweep_f64, double)

}  // extern "C"
