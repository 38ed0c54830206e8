// Wide-design CM sweeps for Hopper (sm_90a), plain C interface for ctypes.
//
// K7 cm_sweep_wide — replaces src/repro/core/cm.py:66 cm_epoch, the XLA
//    fori_loop that every baseline of the paper runs as its inner solver
//    (dynamic screening over all p columns, the DPP sequential path and
//    the strong-rule homotopy over reduced designs, the unscreened CM).
//    n_epochs cyclic prox-Newton sweeps over the first `count` slots of
//    `order` on a transposed design XT (k, n), any k, with z = X beta kept
//    by rank-1 updates: K3's interface without K3's tail (the dual point
//    and the gap stay torch ops in the callers). Per slot the arithmetic
//    of repro/core/cm.py:35 _coordinate_step: L_j = max(alpha |x_j|^2,
//    1e-30), beta_j <- S(beta_j - x_j . f'(z) / L_j, lam pen_j / L_j),
//    0 on a masked slot, z += (beta_j new - old) x_j. Least squares and
//    logistic, float32 and float64, optional per-slot l1 weights `pen`.
//    Bound on this card: count * n_epochs dependent coordinate steps, each
//    a length-n dot product, a scalar soft-threshold and a length-n axpy.
//    Its bytes (one column a step, 8 KB at n = 1000 in f64) and flops
//    (~4n a step) are tiny against the latency of one step: a block
//    reduction (5 shuffles, a barrier, 8 serial adds), one division, the
//    soft-threshold and the thread's pass over its rows. Unlike K3's
//    block, a full-width design (800 MB at n = 1000, k = 100,000) does not
//    fit the 50 MB L2, so each column comes from HBM.
//    Design: K3's step (csrc/cm_burst.cu). One CTA of 256 threads owns the
//    sweep; thread t owns the rows t, t + NT, ...; up to n = 2048 its rows
//    of z and y sit in registers, past that in shared memory. The slot
//    state cannot live in shared memory at any k, so it stays in global
//    memory and is read ahead: the order is fixed, so the column of step
//    s + 2 is loaded into registers (three sets rotate) together with its
//    slot's |x_j|^2, weight and mask, the slot index of step s + 3 one
//    step before that (no load waits on another), beta of step s + 2 once
//    step s has written its own (a slot met again within two steps takes
//    the value in hand), and one thread a 128-byte line asks L2 for the
//    column of step s + PF + 1, so the register loads meet L2 and not HBM.
//    Thread 0 writes each new beta_j to global memory; the next read of
//    that slot is at least one barrier later. Every element's arithmetic
//    and its order are those of K3: the dot and the update are explicit
//    fmas, the reduction tree is fixed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads of the one CTA
constexpr int NW = NT / 32;
constexpr int PF = 8;              // L2 prefetch distance, in steps
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

// A thread's rows i = tid + NT r of z and y: in registers for r < R
// (n <= R NT), in shared memory for R = 0.
template <typename T, int R>
struct Rows {
  T z[R], y[R];
  __device__ __forceinline__ void bind(T*, T*) {}
  __device__ __forceinline__ T& Z(int r, int) { return z[r]; }
  __device__ __forceinline__ T& Y(int r, int) { return y[r]; }
};
template <typename T>
struct Rows<T, 0> {
  T* z;
  T* y;
  __device__ __forceinline__ void bind(T* zs, T* ys) { z = zs; y = ys; }
  __device__ __forceinline__ T& Z(int, int i) { return z[i]; }
  __device__ __forceinline__ T& Y(int, int i) { return y[i]; }
};

// One coordinate step known ahead: its slot, the thread's rows of the
// slot's column (registers for R > 0; read in the pass for R = 0), the
// slot's raw |x_j|^2 and weight as loaded, then L_j and the threshold,
// its mask and its beta.
template <typename T, int R>
struct Ahead {
  T a[R > 0 ? R : 1];
  const T* col;
  int j;
  T csq, w, lj, t, b;
  uint8_t live;
  __device__ __forceinline__ T at(int r, int i) const {
    if constexpr (R > 0) return a[r];
    return __ldg(col + i);
  }
};

// Position of step q in `order`, advanced one step at a time.
struct Pos {
  int p, count;
  __device__ __forceinline__ void init(long long q, int c) { count = c; p = (int)(q % c); }
  __device__ __forceinline__ int next() {
    const int r = p;
    p = p + 1 == count ? 0 : p + 1;
    return r;
  }
};

template <typename T>
__device__ __forceinline__ void l2_prefetch(const T* col, int n) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(col) & ~uintptr_t(127);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(col + n - 1) & ~uintptr_t(127);
  const int lines = (int)((hi - lo) >> 7) + 1;
  for (int l = threadIdx.x; l < lines; l += NT)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(lo + ((uintptr_t)l << 7)));
}

template <typename T, int L, int R>
__global__ void __launch_bounds__(NT)
cm_wide_kernel(const T* __restrict__ XT, const T* __restrict__ y,
               T* beta, T* __restrict__ z, const T* __restrict__ col_sq,
               const uint8_t* __restrict__ mask, const T* __restrict__ pen,
               const int* __restrict__ order, T lam, int n_epochs, int count,
               int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* red = reinterpret_cast<T*>(smem);  // 2 * NW reduction slots
  T* y_s = red + 2 * NW;                // R = 0: y and z; R > 0: absent
  T* z_s = y_s + n;
  const T alpha = (L == LS) ? T(1) : T(0.25);
  const int tid = threadIdx.x;
  const int nr = R > 0 ? R : (n + NT - 1) / NT;   // rows per thread
  Rows<T, R> rw;
  rw.bind(z_s, y_s);
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const int i = tid + NT * r;
    if (i < n) {
      rw.Y(r, i) = y[i];
      rw.Z(r, i) = z[i];
    }
  }

  const long long S = (long long)n_epochs * count;
  // issue the loads of one step's column and slot constants; nothing here
  // waits on them
  auto fetch = [&](Ahead<T, R>& st, int j) {
    st.j = j;
    st.col = XT + (size_t)j * n;
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid + NT * r;
        st.a[r] = i < n ? __ldg(st.col + i) : T(0);
      }
    }
    st.csq = __ldg(col_sq + j);
    st.w = pen != nullptr ? __ldg(pen + j) : T(1);
    st.live = __ldg(mask + j);
  };
  // L_j and the threshold, a step after the loads were issued
  auto finish = [&](Ahead<T, R>& st) {
    st.lj = fmax(alpha * st.csq, T(1e-30));
    st.t = (pen != nullptr ? lam * st.w : lam) / st.lj;
  };
  if (S > 0) {
    Ahead<T, R> A, B, C;
    Pos qn, qp;                        // order positions of steps s + 3 and
    qn.init(0, count);                 // s + PF + 2, as the loop runs
    fetch(A, __ldg(order + qn.next()));
    A.b = __ldcg(beta + A.j);
    finish(A);
    if (S > 1) {
      fetch(B, __ldg(order + qn.next()));
      B.b = __ldcg(beta + B.j);        // B.j == A.j: replaced at step 0
    }
    int jn = __ldg(order + qn.next()); // the slot of step 2
    for (long long q = 2; q <= PF && q < S; ++q)
      l2_prefetch(XT + (size_t)__ldg(order + (int)(q % count)) * n, n);
    qp.init(PF + 1, count);
    int jp = __ldg(order + qp.next()); // the slot of step PF + 1
    // the first step's partial dot a_j . f'(z, y) over the thread's rows
    T part = T(0);
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      const int i = tid + NT * r;
      if (i < n)
        part = fma_rn(A.at(r, i), grad<T, L>(rw.Z(r, i), rw.Y(r, i)), part);
    }
    int parity = 0;
    // step s on `cur`, with `nxt` (step s + 1) in hand and step s + 2
    // fetched into `pre`; the loop below rotates the three
    auto iter = [&](Ahead<T, R>& cur, Ahead<T, R>& nxt, Ahead<T, R>& pre,
                    long long s) {
      if (s + 2 < S) {
        fetch(pre, jn);
        if (s + 3 < S) jn = __ldg(order + qn.next());
      }
      if (s + PF + 1 < S) {
        l2_prefetch(XT + (size_t)jp * n, n);
        if (s + PF + 2 < S) jp = __ldg(order + qp.next());
      }
      const bool more = s + 1 < S;
      if (more) finish(nxt);
      const T g = block_sum(part, red + parity * NW);
      parity ^= 1;
      const T u = cur.b - g / cur.lj;
      const T a = fabs(u) - cur.t;
      T b_new = a > T(0) ? copysign(a, u) : T(0);
      if (!cur.live) b_new = T(0);
      if (tid == 0) beta[cur.j] = b_new;
      const T d = b_new - cur.b;
      // beta of the next two steps: a slot met again takes b_new; any
      // other was last written at least one barrier ago
      if (more && nxt.j == cur.j) nxt.b = b_new;
      if (s + 2 < S) pre.b = pre.j == cur.j ? b_new : __ldcg(beta + pre.j);
      // this step's update of z fused with the next step's dot
      part = T(0);
      if constexpr (R > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = tid + NT * r;
          if (i < n) {
            T zi = rw.Z(r, i);
            if (d != T(0)) {
              zi = fma_rn(d, cur.a[r], zi);
              rw.Z(r, i) = zi;
            }
            if (more) part = fma_rn(nxt.a[r], grad<T, L>(zi, rw.Y(r, i)), part);
          }
        }
      } else {
        // rows in shared memory: the update, then the next step's dot
        if (d != T(0))
          for (int i = tid; i < n; i += NT)
            z_s[i] = fma_rn(d, __ldg(cur.col + i), z_s[i]);
        if (more)
          for (int i = tid; i < n; i += NT)
            part = fma_rn(__ldg(nxt.col + i), grad<T, L>(z_s[i], y_s[i]), part);
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
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const int i = tid + NT * r;
    if (i < n) z[i] = rw.Z(r, i);
  }
}

// keep in step with kernels/cm/wide.py::cm_wide_smem_bytes (which also
// counts y's and z's n each for the register forms)
size_t smem_bytes(int n, size_t itemsize, bool rows_in_smem) {
  return (2 * (size_t)NW + (rows_in_smem ? 2 * (size_t)n : 0)) * itemsize;
}

template <typename T, int L, int R>
int launch_r(const void* XT, const void* y, void* beta, void* z,
             const void* col_sq, const void* mask, const void* pen,
             const void* order, T lam, int n_epochs, int count, int n,
             void* stream) {
  const size_t smem = smem_bytes(n, sizeof(T), R == 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_wide_kernel<T, L, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cm_wide_kernel<T, L, R><<<1, NT, smem, (cudaStream_t)stream>>>(
      (const T*)XT, (const T*)y, (T*)beta, (T*)z, (const T*)col_sq,
      (const uint8_t*)mask, (const T*)pen, (const int*)order, lam, n_epochs,
      count, n);
  return (int)cudaGetLastError();
}

// rows per thread held in registers: 4 up to n = 1024, 8 up to 2048, past
// that z and y in shared memory
template <typename T, int L>
int launch(const void* XT, const void* y, void* beta, void* z,
           const void* col_sq, const void* mask, const void* pen,
           const void* order, T lam, int n_epochs, int count, int n,
           void* stream) {
  if (n <= 4 * NT)
    return launch_r<T, L, 4>(XT, y, beta, z, col_sq, mask, pen, order, lam,
                             n_epochs, count, n, stream);
  if (n <= 8 * NT)
    return launch_r<T, L, 8>(XT, y, beta, z, col_sq, mask, pen, order, lam,
                             n_epochs, count, n, stream);
  return launch_r<T, L, 0>(XT, y, beta, z, col_sq, mask, pen, order, lam,
                           n_epochs, count, n, stream);
}

}  // namespace

extern "C" {

// pen may be null (every slot penalized)
#define WIDE_ENTRY(NAME, T, L)                                                 \
  int NAME(const void* XT, const void* y, void* beta, void* z,                \
           const void* col_sq, const void* mask, const void* pen,             \
           const void* order, T lam, int n_epochs, int count, int n,          \
           void* stream) {                                                     \
    return launch<T, L>(XT, y, beta, z, col_sq, mask, pen, order, lam,        \
                        n_epochs, count, n, stream);                          \
  }

WIDE_ENTRY(cm_sweep_wide_ls_f32, float, LS)
WIDE_ENTRY(cm_sweep_wide_ls_f64, double, LS)
WIDE_ENTRY(cm_sweep_wide_logit_f32, float, LOGIT)
WIDE_ENTRY(cm_sweep_wide_logit_f64, double, LOGIT)

}  // extern "C"
