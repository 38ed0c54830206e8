// Least-squares CM epochs for Hopper (sm_90a), plain C interface for ctypes.
//
// K5 cm_epochs — replaces repro/kernels/cm/cm.py:106 cm_epochs_pallas.
//    n_epochs cyclic sweeps over every slot j = 0 .. k-1 of the active block
//    A (n, k), in residual form:
//        r = y - A beta                         (once, at the start)
//        g = a_j . r,  c = max(col_sq_j, 1e-30)
//        beta_j <- S(beta_j + g / c, lam / c)   (0 where mask_j is false)
//        r += (beta_j_old - beta_j) a_j
//    Returns (beta, r). Like the TPU kernel it computes in float32 whatever
//    the caller's type: the wrapper casts.
//    Bound on this card: k * n_epochs dependent steps, each a length-n dot,
//    a scalar soft-threshold and a length-n axpy. The bytes (one column of A
//    from L2 per step) and flops (4n per step) are tiny; what bounds it is
//    the latency of one block reduction plus one L2 round trip per step,
//    as for K3 (PERF.md has both per-step times).
//    Design: K3's. One CTA owns the sweep; r (n floats), beta, col_sq and
//    mask (k each) sit in shared memory. A is passed transposed, A^T (k, n)
//    contiguous, so column j is one coalesced row read from L2. r = y - A
//    beta is formed once, one thread per row summing over the k slots in
//    slot order. Each step: every thread forms its part of a_j . r over its
//    rows; a warp-shuffle + shared-memory reduction (double buffered by step
//    parity, so that one barrier per step suffices) leaves the same g in
//    every thread; every thread computes the same soft-threshold; each
//    thread updates its own rows of r. A zero update is skipped (the TPU
//    kernel adds 0 * a_j, the same r for finite a_j).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads of the one CTA
constexpr int NW = NT / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block sum; every thread gets the same value (summed in the same order).
// `buf` must not be reused before the next barrier.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* buf) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = buf[0];
  for (int i = 1; i < NW; ++i) s += buf[i];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(NT)
cm_epochs_kernel(const T* __restrict__ AT, const T* __restrict__ y,
                 T* __restrict__ beta, const T* __restrict__ col_sq,
                 const uint8_t* __restrict__ mask, T lam, int n_epochs, int n,
                 int k, T* __restrict__ r_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* r_s = reinterpret_cast<T*>(smem);
  T* b_s = r_s + n;
  T* c_s = b_s + k;
  T* red = c_s + k;                   // 2 * NW reduction slots
  uint8_t* m_s = reinterpret_cast<uint8_t*>(red + 2 * NW);
  const int tid = threadIdx.x;

  for (int j = tid; j < k; j += NT) {
    b_s[j] = beta[j];
    c_s[j] = col_sq[j];
    m_s[j] = mask[j];
  }
  __syncthreads();
  // r = y - A beta, one thread per row, the slots in order
  for (int i = tid; i < n; i += NT) {
    T acc = T(0);
    for (int j = 0; j < k; ++j) acc = fma(AT[(size_t)j * n + i], b_s[j], acc);
    r_s[i] = y[i] - acc;              // each thread keeps to its own rows
  }

  int parity = 0;
  for (int ep = 0; ep < n_epochs; ++ep) {
    for (int j = 0; j < k; ++j) {
      const T bj = b_s[j];                          // read before the barrier
      const T* aj = AT + (size_t)j * n;
      T part = T(0);
      for (int i = tid; i < n; i += NT) part = fma(aj[i], r_s[i], part);
      const T g = block_sum(part, red + parity * NW);
      parity ^= 1;
      const T csq = fmax(c_s[j], T(1e-30));
      const T u = bj + g / csq;
      const T t = lam / csq;
      const T a = fabs(u) - t;
      T b_new = a > T(0) ? copysign(a, u) : T(0);
      if (!m_s[j]) b_new = T(0);
      b_s[j] = b_new;                               // same value in every thread
      const T d = bj - b_new;
      if (d != T(0))
        for (int i = tid; i < n; i += NT) r_s[i] = fma(d, aj[i], r_s[i]);
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += NT) r_out[i] = r_s[i];
  for (int j = tid; j < k; j += NT) beta[j] = b_s[j];
}

// keep in step with kernels/cm/cm.py::cm_epochs_smem_bytes
size_t smem_bytes(int n, int k, size_t itemsize) {
  return ((size_t)n + 2 * (size_t)k + 2 * NW) * itemsize + (size_t)k;
}

template <typename T>
int launch(const void* AT, const void* y, void* beta, const void* col_sq,
           const void* mask, T lam, int n_epochs, int n, int k, void* r,
           void* stream) {
  const size_t smem = smem_bytes(n, k, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_epochs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cm_epochs_kernel<T><<<1, NT, smem, (cudaStream_t)stream>>>(
      (const T*)AT, (const T*)y, (T*)beta, (const T*)col_sq,
      (const uint8_t*)mask, lam, n_epochs, n, k, (T*)r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 only: the TPU kernel's type, which the wrapper casts to
int cm_epochs_f32(const void* AT, const void* y, void* beta,
                  const void* col_sq, const void* mask, float lam,
                  int n_epochs, int n, int k, void* r, void* stream) {
  return launch<float>(AT, y, beta, col_sq, mask, lam, n_epochs, n, k, r,
                       stream);
}

}  // extern "C"
