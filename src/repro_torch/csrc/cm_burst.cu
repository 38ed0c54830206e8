// SAIF inner CM burst for Hopper (sm_90a), plain C interface for ctypes.
//
// K3 cm_burst — replaces repro/kernels/cm/cm.py:355 cm_burst_pallas, its
//    plain-LASSO specialisation (has_unpen=False: every slot penalized).
//    n_epochs cyclic prox-Newton sweeps over the first `count` slots of
//    `order` on the active block, z = A beta kept by rank-1 updates; then a
//    fresh z = A beta, the feasible dual point theta (LS: the tau* scaling;
//    logistic: rescale + dom f* clip) and the primal-dual gap.
//    With `pen` (the _pen entries) it is the has_unpen=True branch
//    (cm.py:184-206): per-slot l1 weights in the threshold, and a tail
//    that takes the first live slot with weight 0 as fused LASSO's
//    unpenalized column ab (read from the block, not copied), Newton-
//    polishes b along it for logistic (4 steps: Hessian floor 1e-30, step
//    clip 1e3 / max|ab|, two block reductions each), projects the dual
//    point onto ab's orthogonal complement (one more block reduction),
//    scales over the penalized columns only and weights the l1 term.
//    Bound on this card: the sweep is count * n_epochs dependent coordinate
//    steps, each a length-n dot product, a scalar soft-threshold and a
//    length-n axpy. Its bytes (one column of A from L2 per step, a few MB
//    per burst) and flops (~4n per step) are tiny; what bounds it is the
//    latency of one step: a block reduction (5 shuffles, a barrier, 8
//    serial adds), one division, the soft-threshold and the thread's pass
//    over its rows.
//    Design: one CTA owns the burst. The block is passed transposed, A^T
//    (k, n) contiguous, so column j is one coalesced row read from L2 (an
//    n = 1000, k = 1024 f64 block is 8 MB, well inside the 50 MB L2).
//    Thread t owns the rows t, t + NT, ...: up to n = 2048 its rows of z
//    and y sit in registers (4 or 8 rows a thread, a compile-time count),
//    past that in shared memory (there the update and the next dot stay
//    two loops over the rows: fused, they measured slower). The order is
//    fixed, so the column of step
//    s + 2 is loaded into registers (three sets rotate) while step s runs,
//    and the L2 round trip leaves the chain. Each step: every thread forms
//    its part of a_j . f'(z, y), a warp-shuffle + shared-memory reduction
//    (double buffered by step parity, so one barrier per step suffices)
//    leaves the same sum in every thread, every thread computes the same
//    soft-threshold, and one pass over the thread's rows applies the
//    step's update to z and forms the next step's part from it. The
//    threshold lam (pen_j) / max(alpha |a_j|^2, 1e-30) of every slot is
//    divided out once, before the sweep (kept in beta's own buffer until
//    the tail writes beta back), so one division stays on the chain. Every
//    element's arithmetic and its order are those of the plain loop: the
//    dot and the update are explicit fmas, the reduction tree is fixed.
//    beta, col_sq, the weights, order and mask (k each), the reduction
//    slots and the dual workspace (n) sit in shared memory; the layout
//    also keeps y's and z's n each, which only the shared-memory form
//    uses, so one gate (cm_smem_bytes) serves both forms. A multi-CTA or
//    cluster design that splits n is work for a later change.
//
// K3b cm_burst_batch — replaces repro/kernels/cm/cm.py:296
//    cm_burst_batch_pallas: K3 (no unpenalized slot) for m problems, one
//    CTA each, grid (m,). CTA b reads problem b's transposed block
//    AT[b] (k, n), its y, state and order, and its lambda, epoch count and
//    live-slot count from device arrays, so the host reads nothing to
//    launch. The body is K3's own (K3 is the m = 1 launch with the scalars
//    passed directly), so a fleet burst is bitwise a serial burst, and a
//    CTA needs K3's shared memory (cm_smem_bytes), not more. Bound: as K3,
//    the latency of each problem's chain of coordinate steps; the m chains
//    run side by side on m SMs.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads of the one CTA
constexpr int NW = NT / 32;
constexpr int LS = 0, LOGIT = 1;

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float exp(float x) { return expf(x); }
  static __device__ __forceinline__ float log(float x) { return logf(x); }
  static __device__ __forceinline__ float log1p(float x) { return log1pf(x); }
  static __device__ __forceinline__ bool finite(float x) { return isfinite(x); }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double exp(double x) { return ::exp(x); }
  static __device__ __forceinline__ double log(double x) { return ::log(x); }
  static __device__ __forceinline__ double log1p(double x) { return ::log1p(x); }
  static __device__ __forceinline__ bool finite(double x) { return isfinite(x); }
};

template <typename T>
__device__ __forceinline__ T sigmoid(T x) { return T(1) / (T(1) + Num<T>::exp(-x)); }

template <typename T, int L>
__device__ __forceinline__ T grad(T z, T y) {
  if (L == LS) return z - y;
  return -y * sigmoid<T>(-y * z);
}

template <typename T, int L>
__device__ __forceinline__ T value(T z, T y) {
  if (L == LS) { const T d = z - y; return T(0.5) * d * d; }
  const T m = -y * z;                                   // logaddexp(0, m)
  return fmax(T(0), m) + Num<T>::log1p(Num<T>::exp(-fabs(m)));
}

template <typename T, int L>
__device__ __forceinline__ T hess(T z, T y) {
  if (L == LS) return T(1);
  const T s = sigmoid<T>(-y * z);
  return s * (T(1) - s);
}

template <typename T>
__device__ __forceinline__ T xlogx(T s) { return s > T(0) ? s * Num<T>::log(s) : T(0); }

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T, int L>
__device__ __forceinline__ T conj(T u, T y) {
  // the fma nvcc chose for this sum in the kernel's first build (0.5 u^2
  // rounded, u y exact), written out
  if (L == LS) return fma_rn(u, y, T(0.5) * u * u);
  const T s = -u * y;
  return xlogx(s) + xlogx(T(1) - s);
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

// Block max; every thread gets the same value. Same buffer rule as above.
template <typename T>
__device__ __forceinline__ T block_max(T v, T* buf) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmax(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = buf[0];
  for (int i = 1; i < NW; ++i) s = fmax(s, buf[i]);
  return s;
}

// Two block sums behind one barrier; `buf` holds 2 * NW slots.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T* buf) {
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    buf[threadIdx.x >> 5] = a;
    buf[NW + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  a = buf[0];
  b = buf[NW];
  for (int i = 1; i < NW; ++i) {
    a += buf[i];
    b += buf[NW + i];
  }
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
// slot's column (registers for R > 0; read from L2 in the pass for R = 0),
// and the slot's constants.
template <typename T, int R>
struct Ahead {
  T a[R > 0 ? R : 1];
  const T* col;
  int j;
  T lj, t;
  bool live;
  __device__ __forceinline__ T at(int r, int i) const {
    return R > 0 ? a[r] : col[i];
  }
};

template <typename T, int L, bool PEN, int R>
__global__ void __launch_bounds__(NT)
cm_burst_kernel(const T* __restrict__ AT, const T* __restrict__ y,
                T* __restrict__ beta, const T* __restrict__ col_sq,
                const uint8_t* __restrict__ mask, const int* __restrict__ order,
                const T* __restrict__ pen, T lam, int n_epochs, int count,
                const T* __restrict__ lam_b, const int* __restrict__ nep_b,
                const int* __restrict__ cnt_b, int n, int k,
                T* __restrict__ z_out, T* __restrict__ theta_out,
                T* __restrict__ gap_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (lam_b != nullptr) {             // K3b: CTA b owns problem b
    const int b = blockIdx.x;
    lam = lam_b[b];
    n_epochs = nep_b[b];
    count = cnt_b[b];
    AT += (size_t)b * k * n;
    y += (size_t)b * n;
    beta += (size_t)b * k;
    col_sq += (size_t)b * k;
    mask += (size_t)b * k;
    order += (size_t)b * k;
    z_out += (size_t)b * n;
    theta_out += (size_t)b * n;
    gap_out += b;
  }
  T* y_s = reinterpret_cast<T*>(smem);  // R = 0: y and z; R > 0: unused
  T* z_s = y_s + n;
  T* w_s = z_s + n;                   // unscaled dual point, then theta
  T* b_s = w_s + n;
  T* c_s = b_s + k;
  T* p_s = c_s + k;                   // PEN: the (k,) l1 weights
  T* red = p_s + (PEN ? k : 0);       // 4 * NW reduction slots
  int* o_s = reinterpret_cast<int*>(red + 4 * NW);
  uint8_t* m_s = reinterpret_cast<uint8_t*>(o_s + k);
  // the sweep's per-slot thresholds live in beta's own buffer until the
  // tail writes beta back
  T* t_g = beta;
  const T alpha = (L == LS) ? T(1) : T(0.25);
  const int tid = threadIdx.x;
  const int nr = R > 0 ? R : (n + NT - 1) / NT;   // rows per thread
  Rows<T, R> rw;
  rw.bind(z_s, y_s);

#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const int i = tid + NT * r;
    if (i < n) rw.Y(r, i) = y[i];
  }
  for (int j = tid; j < k; j += NT) {
    b_s[j] = beta[j];
    c_s[j] = col_sq[j];
    if (PEN) p_s[j] = pen[j];
    o_s[j] = order[j];
    m_s[j] = mask[j];
    const T lj = fmax(alpha * c_s[j], T(1e-30));
    t_g[j] = PEN ? lam * p_s[j] / lj : lam / lj;
  }
  __syncthreads();
  // z = A beta over the slots with beta != 0 (a zero term adds exactly 0)
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const int i = tid + NT * r;
    if (i < n) {
      T acc = T(0);
      for (int j = 0; j < k; ++j) {
        const T bj = b_s[j];
        if (bj != T(0)) acc = fma_rn(AT[(size_t)j * n + i], bj, acc);
      }
      rw.Z(r, i) = acc;
    }
  }
  __syncthreads();

  const long long S = (long long)n_epochs * count;
  auto fetch = [&](Ahead<T, R>& st, int pos) {
    const int j = o_s[pos];
    st.j = j;
    st.col = AT + (size_t)j * n;
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid + NT * r;
        st.a[r] = i < n ? __ldg(st.col + i) : T(0);
      }
    }
    st.lj = fmax(alpha * c_s[j], T(1e-30));
    st.t = t_g[j];
    st.live = m_s[j] != 0;
  };
  if (S > 0) {
    Ahead<T, R> A, B, C;
    fetch(A, 0);
    int pos = count > 1 ? 1 : 0;      // the position fetched next
    if (S > 1) fetch(B, pos);
    pos = pos + 1 == count ? 0 : pos + 1;
    T bj = b_s[A.j];
    // the first step's partial dot a_j . f'(z, y) over the thread's rows
    T part = T(0);
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      const int i = tid + NT * r;
      if (i < n) part = fma_rn(A.at(r, i), grad<T, L>(rw.Z(r, i), rw.Y(r, i)), part);
    }
    int parity = 0;
    // step s on `cur`, with `nxt` (step s + 1) in hand and step s + 2
    // fetched into `pre`; the loop below rotates the three
    auto iter = [&](Ahead<T, R>& cur, const Ahead<T, R>& nxt, Ahead<T, R>& pre,
                    long long s) {
      if (s + 2 < S) {
        fetch(pre, pos);
        pos = pos + 1 == count ? 0 : pos + 1;
      }
      const T g = block_sum(part, red + parity * NW);
      parity ^= 1;
      const T u = bj - g / cur.lj;
      const T a = fabs(u) - cur.t;
      T b_new = a > T(0) ? copysign(a, u) : T(0);
      if (!cur.live) b_new = T(0);
      b_s[cur.j] = b_new;                           // same value in every thread
      const T d = b_new - bj;
      const bool more = s + 1 < S;
      if (more) bj = b_s[nxt.j];
      // this step's residual update fused with the next step's dot
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
  __syncthreads();

  // ---- tail: fresh z, [polish b,] dual point, gap ----
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const int i = tid + NT * r;
    if (i < n) {
      T acc = T(0);
      for (int j = 0; j < k; ++j) {
        const T bj = b_s[j];
        if (bj != T(0)) acc = fma_rn(AT[(size_t)j * n + i], bj, acc);
      }
      rw.Z(r, i) = acc;               // each thread keeps to its own rows
    }
  }
  // the unpenalized slot: the first live one with weight 0 (same in every
  // thread); u < 0 leaves the plain-LASSO tail
  int u = -1;
  if (PEN)
    for (int j = 0; j < k; ++j)
      if (m_s[j] && p_s[j] == T(0)) { u = j; break; }
  const T* ab = AT + (size_t)(u < 0 ? 0 : u) * n;
  if (PEN && L != LS && u >= 0) {
    // Newton polish of b (duality.polish_unpen): x_b^T f'(z) ~ 0 so the
    // projection below is a benign correction
    T amax = T(0);
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      const int i = tid + NT * r;
      if (i < n) amax = fmax(amax, fabs(ab[i]));
    }
    const T lim = T(1e3) / fmax(block_max(amax, red), T(1e-30));
    T b = b_s[u];
    for (int it = 0; it < 4; ++it) {
      T pg = T(0), ph = T(0);
#pragma unroll
      for (int r = 0; r < nr; ++r) {
        const int i = tid + NT * r;
        if (i < n) {
          const T a = ab[i];
          pg += a * grad<T, L>(rw.Z(r, i), rw.Y(r, i));
          ph += a * a * hess<T, L>(rw.Z(r, i), rw.Y(r, i));
        }
      }
      // alternate halves of `red`: the other half was last read before
      // the previous call's barrier (block_max took the first half)
      block_sum2(pg, ph, red + 2 * NW * ((it + 1) & 1));
      const T d = fmin(fmax(pg / fmax(ph, T(1e-30)), -lim), lim);
      b -= d;
#pragma unroll
      for (int r = 0; r < nr; ++r) {
        const int i = tid + NT * r;
        if (i < n) rw.Z(r, i) -= d * ab[i];
      }
    }
    if (tid == 0) b_s[u] = b;         // read again only after a barrier
  }
  T cproj = T(0);                     // hat -= ab * cproj (Thm 7 projection)
  if (PEN && u >= 0) {
    __syncthreads();                  // the polish's buffers are free
    T pah = T(0), paa = T(0);
#pragma unroll
    for (int r = 0; r < nr; ++r) {
      const int i = tid + NT * r;
      if (i < n) {
        const T a = ab[i];
        pah += a * (-grad<T, L>(rw.Z(r, i), rw.Y(r, i)) / lam);
        paa += a * a;
      }
    }
    block_sum2(pah, paa, red);
    cproj = pah / fmax(paa, T(1e-30));
  }
  T part_val = T(0), part_sq = T(0), part_yh = T(0);
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const int i = tid + NT * r;
    if (i < n) {
      const T zi = rw.Z(r, i);
      const T yi = rw.Y(r, i);
      z_out[i] = zi;
      T hat = -grad<T, L>(zi, yi) / lam;
      if (PEN && u >= 0) hat -= ab[i] * cproj;
      w_s[i] = hat;
      part_val += value<T, L>(zi, yi);
      part_sq += hat * hat;
      part_yh += yi * hat;
    }
  }
  __syncthreads();
  // max_j |a_j . hat|: one warp per column
  const int w = tid >> 5, wl = tid & 31;
  T mx = T(0);
  for (int j = w; j < k; j += NW) {
    const T* aj = AT + (size_t)j * n;
    T c = T(0);
    for (int i = wl; i < n; i += 32) c += w_s[i] * aj[i];
    c = warp_sum(c);
    mx = fmax(mx, PEN ? fabs(c) * p_s[j] : fabs(c));   // penalized only
  }
  if (wl == 0) red[2 * NW + w] = mx;
  T l1 = T(0);
  for (int j = tid; j < k; j += NT) l1 += PEN ? p_s[j] * fabs(b_s[j]) : fabs(b_s[j]);
  __syncthreads();
  T max_corr = red[2 * NW];
  for (int i = 1; i < NW; ++i) max_corr = fmax(max_corr, red[2 * NW + i]);
  const T p_val = block_sum(part_val, red) + lam * block_sum(l1, red + NW);
  __syncthreads();
  T tau = T(0);                       // LS: theta = tau * hat
  const T denom = fmax(max_corr, T(1));  // logistic: theta = hat / denom
  if (L == LS) {
    const T sq = block_sum(part_sq, red);
    const T yh = block_sum(part_yh, red + NW);
    const T bound = T(1) / fmax(max_corr, T(1e-30));
    const T tau_star = yh / (lam * fmax(sq, T(1e-30)));
    tau = fmin(fmax(tau_star, -bound), bound);
    if (!Num<T>::finite(tau)) tau = T(1) / denom;
  }
  T part_conj = T(0);
  // least squares: the first (rows % 4) of a thread's terms contract the
  // other product (u y rounded, 0.5 u^2 exact), as the unrolled loop of
  // the kernel's first build did
  const int pre = tid < n ? ((n - 1 - tid) / NT + 1) & 3 : 0;
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    const int i = tid + NT * r;
    if (i < n) {
      T th;
      const T yi = rw.Y(r, i);
      if (L == LS) {
        th = tau * w_s[i];
      } else {
        th = w_s[i] / denom;
        T s = -(-lam * th) * yi;
        s = fmin(fmax(s, T(1e-12)), T(1) - T(1e-12));
        th = -(-s * yi) / lam;
      }
      theta_out[i] = th;
      const T v = -lam * th;
      part_conj += L == LS && r < pre ? fma_rn(v, T(0.5) * v, v * yi)
                                      : conj<T, L>(v, yi);
    }
  }
  __syncthreads();
  const T d_val = -block_sum(part_conj, red + 2 * NW);
  for (int j = tid; j < k; j += NT) beta[j] = b_s[j];
  if (tid == 0) gap_out[0] = p_val - d_val;
}

// keep in step with kernels/cm/cm.py::cm_smem_bytes
size_t smem_bytes(int n, int k, size_t itemsize, bool pen) {
  return (3 * (size_t)n + (pen ? 3 : 2) * (size_t)k + 4 * NW) * itemsize +
         (size_t)k * (sizeof(int) + 1);
}

template <typename T, int L, bool PEN, int R>
int launch_r(const void* AT, const void* y, void* beta, const void* col_sq,
             const void* mask, const void* order, const void* pen, T lam,
             int n_epochs, int count, const void* lam_b, const void* nep_b,
             const void* cnt_b, int m, int n, int k, void* z, void* theta,
             void* gap, void* stream) {
  const size_t smem = smem_bytes(n, k, sizeof(T), PEN);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cm_burst_kernel<T, L, PEN, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cm_burst_kernel<T, L, PEN, R><<<m, NT, smem, (cudaStream_t)stream>>>(
      (const T*)AT, (const T*)y, (T*)beta, (const T*)col_sq,
      (const uint8_t*)mask, (const int*)order, (const T*)pen, lam, n_epochs,
      count, (const T*)lam_b, (const int*)nep_b, (const int*)cnt_b, n, k,
      (T*)z, (T*)theta, (T*)gap);
  return (int)cudaGetLastError();
}

// rows per thread held in registers: 4 up to n = 1024, 8 up to 2048, past
// that z and y in shared memory
template <typename T, int L, bool PEN>
int launch(const void* AT, const void* y, void* beta, const void* col_sq,
           const void* mask, const void* order, const void* pen, T lam,
           int n_epochs, int count, const void* lam_b, const void* nep_b,
           const void* cnt_b, int m, int n, int k, void* z, void* theta,
           void* gap, void* stream) {
  if (n <= 4 * NT)
    return launch_r<T, L, PEN, 4>(AT, y, beta, col_sq, mask, order, pen, lam,
                                  n_epochs, count, lam_b, nep_b, cnt_b, m, n,
                                  k, z, theta, gap, stream);
  if (n <= 8 * NT)
    return launch_r<T, L, PEN, 8>(AT, y, beta, col_sq, mask, order, pen, lam,
                                  n_epochs, count, lam_b, nep_b, cnt_b, m, n,
                                  k, z, theta, gap, stream);
  return launch_r<T, L, PEN, 0>(AT, y, beta, col_sq, mask, order, pen, lam,
                                n_epochs, count, lam_b, nep_b, cnt_b, m, n, k,
                                z, theta, gap, stream);
}

}  // namespace

extern "C" {

#define CM_ENTRY(NAME, T, L)                                                   \
  int NAME(const void* AT, const void* y, void* beta, const void* col_sq,     \
           const void* mask, const void* order, T lam, int n_epochs,          \
           int count, int n, int k, void* z, void* theta, void* gap,          \
           void* stream) {                                                     \
    return launch<T, L, false>(AT, y, beta, col_sq, mask, order, nullptr,     \
                               lam, n_epochs, count, nullptr, nullptr,        \
                               nullptr, 1, n, k, z, theta, gap, stream);      \
  }

#define CM_ENTRY_PEN(NAME, T, L)                                               \
  int NAME(const void* AT, const void* y, void* beta, const void* col_sq,     \
           const void* mask, const void* order, const void* pen, T lam,       \
           int n_epochs, int count, int n, int k, void* z, void* theta,       \
           void* gap, void* stream) {                                          \
    return launch<T, L, true>(AT, y, beta, col_sq, mask, order, pen, lam,     \
                              n_epochs, count, nullptr, nullptr, nullptr, 1,  \
                              n, k, z, theta, gap, stream);                   \
  }

// K3b: m problems, lambda / epochs / live counts as device arrays (m,)
#define CM_ENTRY_BATCH(NAME, T, L)                                             \
  int NAME(const void* AT, const void* Y, void* beta, const void* col_sq,     \
           const void* mask, const void* order, const void* lam,              \
           const void* n_epochs, const void* count, int m, int n, int k,      \
           void* z, void* theta, void* gap, void* stream) {                   \
    return launch<T, L, false>(AT, Y, beta, col_sq, mask, order, nullptr,     \
                               T(0), 0, 0, lam, n_epochs, count, m, n, k, z,  \
                               theta, gap, stream);                           \
  }

CM_ENTRY(cm_burst_ls_f32, float, LS)
CM_ENTRY(cm_burst_ls_f64, double, LS)
CM_ENTRY(cm_burst_logit_f32, float, LOGIT)
CM_ENTRY(cm_burst_logit_f64, double, LOGIT)
CM_ENTRY_PEN(cm_burst_ls_f32_pen, float, LS)
CM_ENTRY_PEN(cm_burst_ls_f64_pen, double, LS)
CM_ENTRY_PEN(cm_burst_logit_f32_pen, float, LOGIT)
CM_ENTRY_PEN(cm_burst_logit_f64_pen, double, LOGIT)
CM_ENTRY_BATCH(cm_burst_batch_ls_f32, float, LS)
CM_ENTRY_BATCH(cm_burst_batch_ls_f64, double, LS)
CM_ENTRY_BATCH(cm_burst_batch_logit_f32, float, LOGIT)
CM_ENTRY_BATCH(cm_burst_batch_logit_f64, double, LOGIT)

}  // extern "C"
