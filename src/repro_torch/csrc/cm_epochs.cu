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
//    the latency of one step: a block reduction (5 shuffles, a barrier, 8
//    serial adds), one division, the soft-threshold and the thread's pass
//    over its rows.
//    Design: K3's (csrc/cm_burst.cu), in residual form. One CTA owns the
//    sweep. A is passed transposed, A^T (k, n) contiguous, so column j is
//    one coalesced row read from L2. Thread t owns the rows t, t + NT, ...:
//    up to n = 2048 its rows of r sit in registers (4 or 8 rows a thread, a
//    compile-time count), past that r sits in shared memory (there the
//    update and the next dot stay two loops over the rows, as in K3's
//    shared-memory form). The order is cyclic, so the column of step s + 2
//    is loaded into registers (three sets rotate) while step s runs, and
//    the L2 round trip leaves the chain. Each step: the warp-shuffle +
//    shared-memory reduction (double buffered by step parity, so one
//    barrier per step suffices) leaves the same g in every thread, every
//    thread computes the same soft-threshold, and one branch-free pass
//    over the thread's rows applies the step's update to r and forms the
//    next step's part of the dot from it. A warp issues its instructions
//    in order, so every one between two barriers is on the chain: the
//    loads of step s + 2 (one address, the rows at fixed offsets from it)
//    are issued behind the barrier, beside the serial sum and the
//    division. max(col_sq_j, 1e-30) and lam / that are computed once per
//    slot before the sweep (the thresholds kept in beta's own buffer until
//    beta is written back), so one division, g / c, stays on the chain.
//    The arithmetic of every element and its order are the kernel's first
//    version's: r = y - A beta sums every slot in slot order (no zero term
//    skipped: an fma with a zero beta can turn -0 into +0), each thread's
//    part of the dot runs over its rows ascending, the warp tree shuffles
//    down 16 -> 1, the warp sums are added in warp order, every product is
//    an explicit fma, and a zero update is skipped (the TPU kernel adds
//    0 * a_j, the same r for finite a_j).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads of the one CTA
constexpr int NW = NT / 32;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

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

// One coordinate step known ahead: its slot, the thread's rows of the
// slot's column (registers for R > 0; read from L2 in the pass for R = 0),
// and the slot's constants.
template <typename T, int R>
struct Ahead {
  T a[R > 0 ? R : 1];
  const T* col;
  int j;
  T c, t;                          // max(col_sq_j, 1e-30), lam / c
  bool live;
};

// R > 0: a thread's rows i = tid + NT r of r in registers (n <= R NT);
// R = 0: r in shared memory.
template <typename T, int R>
__global__ void __launch_bounds__(NT)
cm_epochs_kernel(const T* __restrict__ AT, const T* __restrict__ y,
                 T* __restrict__ beta, const T* __restrict__ col_sq,
                 const uint8_t* __restrict__ mask, T lam, int n_epochs, int n,
                 int k, T* __restrict__ r_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* r_s = reinterpret_cast<T*>(smem);  // R = 0: r; R > 0: unused
  T* b_s = r_s + n;
  T* c_s = b_s + k;                   // max(col_sq_j, 1e-30)
  T* red = c_s + k;                   // 2 * NW reduction slots
  uint8_t* m_s = reinterpret_cast<uint8_t*>(red + 2 * NW);
  // the thresholds lam / c_j live in beta's own buffer until the end
  T* t_g = beta;
  const int tid = threadIdx.x;
  T rr[R > 0 ? R : 1];

  for (int j = tid; j < k; j += NT) {
    b_s[j] = beta[j];
    const T c = fmax(col_sq[j], T(1e-30));
    c_s[j] = c;
    m_s[j] = mask[j];
    t_g[j] = lam / c;
  }
  __syncthreads();
  // r = y - A beta, each row summing every slot in slot order
  const T* at_t = AT + tid;           // the thread's first row of A^T's rows
  if constexpr (R > 0) {
    T acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = T(0);
    for (int j = 0; j < k; ++j) {
      const T bj = b_s[j];
      const T* col = at_t + (size_t)j * n;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tid + NT * r < n) acc[r] = fma_rn(__ldg(col + NT * r), bj, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)       // rows past n hold 0 and stay unused
      rr[r] = tid + NT * r < n ? y[tid + NT * r] - acc[r] : T(0);
  } else {
    for (int i = tid; i < n; i += NT) {
      T acc = T(0);
      for (int j = 0; j < k; ++j) acc = fma_rn(__ldg(AT + (size_t)j * n + i), b_s[j], acc);
      r_s[i] = y[i] - acc;            // each thread keeps to its own rows
    }
  }

  const long long S = (long long)n_epochs * k;
  auto fetch = [&](Ahead<T, R>& st, int j) {
    st.j = j;
    st.col = AT + (size_t)j * n;
    if constexpr (R > 0) {
      // one address a step; the rows sit at fixed offsets from it
      const T* col = at_t + (size_t)j * n;
#pragma unroll
      for (int r = 0; r < R; ++r)
        st.a[r] = tid + NT * r < n ? __ldg(col + NT * r) : T(0);
    }
    st.c = c_s[j];
    st.t = t_g[j];
    st.live = m_s[j] != 0;
  };
  if (S > 0) {
    Ahead<T, R> A, B, C;
    fetch(A, 0);
    int pos = k > 1 ? 1 : 0;          // the slot fetched next
    if (S > 1) fetch(B, pos);
    pos = pos + 1 == k ? 0 : pos + 1;
    T bj = b_s[A.j];
    // the first step's part of a_j . r over the thread's rows
    T part = T(0);
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (tid + NT * r < n) part = fma_rn(A.a[r], rr[r], part);
    } else {
      for (int i = tid; i < n; i += NT) part = fma_rn(__ldg(A.col + i), r_s[i], part);
    }
    int parity = 0;
    // step s on `cur`, with `nxt` (step s + 1) in hand and step s + 2
    // fetched into `pre`; the loop below rotates the three
    auto iter = [&](Ahead<T, R>& cur, const Ahead<T, R>& nxt, Ahead<T, R>& pre,
                    long long s) {
      const T g = block_sum(part, red + parity * NW);
      parity ^= 1;
      // issued behind the barrier, where the serial sum and the division
      // leave the warp's issue slots free
      if (s + 2 < S) {
        fetch(pre, pos);
        pos = pos + 1 == k ? 0 : pos + 1;
      }
      const T u = bj + g / cur.c;
      const T a = fabs(u) - cur.t;
      T b_new = a > T(0) ? copysign(a, u) : T(0);
      if (!cur.live) b_new = T(0);
      b_s[cur.j] = b_new;                           // same value in every thread
      const T d = bj - b_new;
      if (s + 1 < S) bj = b_s[nxt.j];
      // this step's residual update fused with the next step's dot, with
      // no branch: a zero update keeps r_i as it was (the fma's result is
      // not taken), rows past n are skipped; after the last step the
      // part is formed from unfetched registers and never used
      const bool upd = d != T(0);
      part = T(0);
      if constexpr (R > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool row = tid + NT * r < n;
          const T ru = fma_rn(d, cur.a[r], rr[r]);
          if (upd && row) rr[r] = ru;
          if (row) part = fma_rn(nxt.a[r], rr[r], part);
        }
      } else {
        // r in shared memory: the update, then the next step's dot
        if (upd)
          for (int i = tid; i < n; i += NT)
            r_s[i] = fma_rn(d, __ldg(cur.col + i), r_s[i]);
        if (s + 1 < S)
          for (int i = tid; i < n; i += NT)
            part = fma_rn(__ldg(nxt.col + i), r_s[i], part);
      }
    };
    for (long long s = 0;;) {
      iter(A, B, C, s);
      if (++s == S) break;
      iter(B, C, A, s);
      if (++s == S) break;
      iter(C, A, B, s);
      if (++s == S) break;
    }
  }
  __syncthreads();                    // every threshold read; beta's buffer is free
  if constexpr (R > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + NT * r;
      if (i < n) r_out[i] = rr[r];
    }
  } else {
    for (int i = tid; i < n; i += NT) r_out[i] = r_s[i];
  }
  for (int j = tid; j < k; j += NT) beta[j] = b_s[j];
}

// keep in step with kernels/cm/cm.py::cm_epochs_smem_bytes
size_t smem_bytes(int n, int k, size_t itemsize) {
  return ((size_t)n + 2 * (size_t)k + 2 * NW) * itemsize + (size_t)k;
}

template <typename T, int R>
int launch_r(const void* AT, const void* y, void* beta, const void* col_sq,
             const void* mask, T lam, int n_epochs, int n, int k, void* r,
             void* stream) {
  const size_t smem = smem_bytes(n, k, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_epochs_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cm_epochs_kernel<T, R><<<1, NT, smem, (cudaStream_t)stream>>>(
      (const T*)AT, (const T*)y, (T*)beta, (const T*)col_sq,
      (const uint8_t*)mask, lam, n_epochs, n, k, (T*)r);
  return (int)cudaGetLastError();
}

// rows per thread held in registers: 4 up to n = 1024, 8 up to 2048, past
// that r in shared memory
template <typename T>
int launch(const void* AT, const void* y, void* beta, const void* col_sq,
           const void* mask, T lam, int n_epochs, int n, int k, void* r,
           void* stream) {
  if (n <= 4 * NT)
    return launch_r<T, 4>(AT, y, beta, col_sq, mask, lam, n_epochs, n, k, r,
                          stream);
  if (n <= 8 * NT)
    return launch_r<T, 8>(AT, y, beta, col_sq, mask, lam, n_epochs, n, k, r,
                          stream);
  return launch_r<T, 0>(AT, y, beta, col_sq, mask, lam, n_epochs, n, k, r,
                        stream);
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
