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
//    soft-threshold and a length-k axpy. The bytes (one row of G per step,
//    from L2) and flops (2k per step) are tiny; what bounds it is the
//    latency of one step: the broadcast of the update, the soft-threshold
//    that produces the next one, and the read of the G entry that links
//    them.
//    Design: one CTA per problem. Its 256 threads set up qr (each entry an
//    explicit fma chain over the slots in slot order, reading G row by row,
//    coalesced; G is symmetric on live slots), beta, inv_l, thr, order and
//    mask in shared memory. Up to k = 1024, where a row of G is a whole
//    number of 16-byte words, one warp then sweeps with no barrier: lane l
//    owns the 16-byte vectors l, l + 32, ... of slots, their qr in
//    registers (a copy in shared memory serves the owner's reads) and
//    their beta, so no lane reads an entry another lane writes, and the
//    update d is broadcast by __shfl_sync. The order is fixed, so the rows
//    of G are known ahead: a RING-deep ring in shared memory holds the rows
//    of the coming steps, each filled by one bulk (TMA) copy that a lane
//    of a second warp issues, GR rows at a time once the sweep arrives on
//    their group's `empty` mbarrier, completing on its `full` one. Each
//    step the owner of the next slot, whose state it read a step ahead,
//    updates that one entry first and soft-thresholds it (every lane runs
//    the same branch-free code; only the owner's result is used); the
//    rest of the axpy follows, up to 8 vectors at a time, loads first,
//    skipping vectors of masked slots (their qr is never read). So the
//    chain of dependent steps is a broadcast, an fma and a soft-threshold.
//    Past k = 1024, or for rows not 16-byte aligned, all 256 threads sweep
//    with one barrier a step, the owner passing d through shared memory
//    and every thread updating its entries from the row in L2. A zero
//    update is skipped, as the plain loop skips it. The arithmetic of
//    every entry is the plain loop's, in step order: two roundings each
//    for the step's product and difference (no contraction), one fma per
//    axpy entry.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per CTA (the set-up)
constexpr int RING = 16;           // rows of G in flight, a power of two
constexpr int GR = 4;              // rows a ring barrier covers
constexpr int NG = RING / GR;      // groups in the ring
constexpr int WARP_K = 1024;       // k up to which one warp sweeps
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a CTA may take

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// The ring's barriers, two per group of GR rows, one arrival each: `full`
// (the thread that starts the copies, plus their bytes) and `empty` (the
// sweep, done reading the group).
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(saddr(bar))
               : "memory");
}
// One thread: the next phase of `bar` waits for `bytes` more of copies.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(saddr(bar)), "r"(bytes) : "memory");
}
// One thread: a bulk (TMA) copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(saddr(bar))
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{ .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(saddr(bar)), "r"(parity) : "memory");
}

// The soft-threshold of one slot from its qr value q, beta bj, inv_l, thr
// and mask; returns the new beta (branch-free: 0 where not live).
template <typename T>
__device__ __forceinline__ T soft(T q, T bj, T il, T th, bool live) {
  const T u = sub_rn(bj, mul_rn(q, il));
  const T a = sub_rn(fabs(u), th);
  return live && a > T(0) ? copysign(a, u) : T(0);
}

// 16-byte vectors of T, and their i-th element (i known at compile time)
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };
__device__ __forceinline__ float& at(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double& at(double2& v, int i) {
  return i == 0 ? v.x : v.y;
}

// E > 0: one warp sweeps (k <= 32 E) with the ring; lane l owns the
// 16-byte vectors l, l + 32, ... of slots, their qr in registers. E = 0:
// NT threads sweep, qr in shared memory, rows of G read from L2, d passed
// through shared memory behind one barrier a step (with the ring or the
// next owner's entry first this form measured no faster: its barrier
// bounds it).
template <typename T, bool PEN, int E>
__global__ void __launch_bounds__(NT)
gram_sweep_kernel(const T* __restrict__ G, const T* __restrict__ rho,
                  T* __restrict__ beta, const uint8_t* __restrict__ mask,
                  const int* __restrict__ order, const T* __restrict__ pen,
                  const T* __restrict__ lam_b, int n_epochs, int count,
                  const int* __restrict__ nep_b, const int* __restrict__ cnt_b,
                  T alpha, int k, size_t ring_off) {
  using VT = typename Vec<T>::type;
  constexpr int V = 16 / sizeof(T);   // slots a vector
  constexpr int D = E > 0 ? RING : 0;
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
  T* d_s = th_s + k;                  // 2 slots: the update (NT threads)
  int* o_s = reinterpret_cast<int*>(d_s + 2);
  uint8_t* m_s = reinterpret_cast<uint8_t*>(o_s + k);
  T* ring = reinterpret_cast<T*>(smem + ring_off);   // (D, k)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + D * k);   // (NG,)
  uint64_t* empty = full + NG;                                    // (NG,)
  const int tid = threadIdx.x;

  if (D > 0 && tid == 0) {
    for (int r = 0; r < NG; ++r) {
      bar_init(full + r);
      bar_init(empty + r);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
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
  __syncthreads();

  const long long S = (long long)n_epochs * count;
  auto next = [&](int p) { return p + 1 == count ? 0 : p + 1; };
  if constexpr (E > 0) {
    // warp 1's first lane feeds the ring, GR rows of the coming steps on
    // one barrier, each group once the sweep has released its last use
    if (tid == 32) {
      const unsigned bytes = (unsigned)(k * sizeof(T));
      int pos = 0;
      for (long long g = 0; g * GR < S; ++g) {
        const int r = (int)(g & (NG - 1));
        if (g >= NG) bar_wait(empty + r, (unsigned)((g / NG - 1) & 1));
        const int rows = (int)(S - g * GR < GR ? S - g * GR : GR);
        bar_expect(full + r, rows * bytes);
        for (int i = 0; i < rows; ++i) {
          bulk_copy(ring + (int)((g * GR + i) & (RING - 1)) * k,
                    G + (size_t)o_s[pos] * k, bytes, full + r);
          pos = next(pos);
        }
      }
      return;
    }
    if (tid >= 32) return;
    if (S > 0) {
      // Every lane runs the owner's arithmetic on the slot it reads (only
      // the owner's is right), so the chain of a step has no branch:
      // broadcast d, the next owner's entry and soft-threshold; its state
      // was read a step ahead.
      constexpr int EV = E / V;       // vectors a lane owns
      const int kv = k / V;           // vectors of a row (the ring needs V | k)
      VT* qv_s = reinterpret_cast<VT*>(q_s);
      VT q[EV];
      // bit e: vector e holds a live slot. qr of a masked slot is never
      // read (its step sets beta to 0 whatever qr is), so the axpy skips
      // vectors of masked slots only.
      unsigned liveb = 0;
#pragma unroll
      for (int e = 0; e < EV; ++e) {
        const int v = tid + 32 * e;
        if (v < kv) {
          q[e] = qv_s[v];
          bool any = false;
#pragma unroll
          for (int i = 0; i < V; ++i) any = any || m_s[V * v + i] != 0;
          liveb |= (unsigned)any << e;
        }
      }
      bar_wait(full, 0);
      const T* row = ring;
      int p2 = next(next(0));         // position of step s + 2
      int j = o_s[0], jn = o_s[next(0)], jnn = o_s[p2];
      T dn;                           // step s's update, on its owner
      {
        const T b0 = b_s[j];
        const T b_new = soft(q_s[j], b0, il_s[j], th_s[j], m_s[j] != 0);
        if (tid == (j / V & 31)) b_s[j] = b_new;
        dn = sub_rn(b_new, b0);
      }
      // the state of step s + 1's slot (on its owner)
      T qn = q_s[jn], gn = row[jn], bn = b_s[jn], iln = il_s[jn],
        thn = th_s[jn];
      bool live = m_s[jn] != 0;
      for (long long s = 0; s < S; ++s) {
        const int p3 = next(p2);
        const int jnnn = o_s[p3];
        const T d = __shfl_sync(0xffffffffu, dn, j / V & 31);
        {
          const T qd = d != T(0) ? fma_rn(d, gn, qn) : qn;
          const T b_new = soft(qd, bn, iln, thn, live);
          if (s + 1 < S && tid == (jn / V & 31)) b_s[jn] = b_new;
          dn = sub_rn(b_new, bn);
        }
        if (d != T(0)) {
          const VT* rv = reinterpret_cast<const VT*>(row);
          // CH vectors at a time, loads first
          constexpr int CH = EV < 8 ? EV : 8;
#pragma unroll
          for (int c = 0; c < EV; c += CH) {
            VT g[CH];
#pragma unroll
            for (int e = 0; e < CH; ++e) {
              const int v = tid + 32 * (c + e);
              if (liveb >> (c + e) & 1) g[e] = rv[v];
            }
#pragma unroll
            for (int e = 0; e < CH; ++e) {
              const int v = tid + 32 * (c + e);
              if (liveb >> (c + e) & 1) {
#pragma unroll
                for (int i = 0; i < V; ++i)
                  at(q[c + e], i) = fma_rn(d, at(g[e], i), at(q[c + e], i));
                qv_s[v] = q[c + e];
              }
            }
          }
        }
        if ((s + 1) % GR == 0) {
          // the group of steps s - GR + 1 .. s is read: release it, then
          // wait for the next
          const long long g = s / GR;
          if ((g + NG) * GR < S) {
            __syncwarp();
            if (tid == 0) bar_arrive(empty + (int)(g & (NG - 1)));
          }
          if (s + 1 < S)
            bar_wait(full + (int)((g + 1) & (NG - 1)),
                     (unsigned)(((g + 1) / NG) & 1));
        }
        row = ring + (int)((s + 1) & (RING - 1)) * k;
        qn = q_s[jnn];                // step s + 2's slot
        gn = row[jnn];
        bn = b_s[jnn];
        iln = il_s[jnn];
        thn = th_s[jnn];
        live = m_s[jnn] != 0;
        j = jn;
        jn = jnn;
        jnn = jnnn;
        p2 = p3;
      }
    }
    __syncwarp();                     // the owners' beta, to every lane
    for (int t = tid; t < k; t += 32) beta[t] = b_s[t];
  } else {
    // NT threads: thread t owns slots t, t + NT, ...; the owner of the
    // step's slot soft-thresholds it and leaves the update in a shared
    // slot double buffered by step parity, one barrier, then every
    // thread applies the axpy to its own entries with the row from L2
    int parity = 0;
    for (int ep = 0; ep < n_epochs; ++ep) {
      for (int jj = 0; jj < count; ++jj) {
        const int j = o_s[jj];
        if (j % NT == tid) {
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
    for (int t = tid; t < k; t += NT) beta[t] = b_s[t];
  }
}

// keep in step with kernels/gram/gram.py::gram_smem_bytes (the gate) and
// gram_sweep_form (the ring)
size_t smem_bytes(int k, size_t itemsize) {
  return (4 * (size_t)k + 2) * itemsize + (size_t)k * (sizeof(int) + 1);
}

size_t ring_offset(int k, size_t itemsize) {
  return (smem_bytes(k, itemsize) + 15) & ~(size_t)15;
}

// the ring and its barriers after the state, where they fit and every row
// of G starts on a 16-byte boundary
bool ring_fits(int k, size_t itemsize) {
  return (k * itemsize) % 16 == 0 &&
         ring_offset(k, itemsize) + RING * (k * itemsize + 16) <= SMEM_MAX;
}

template <typename T, bool PEN, int E>
int launch_t(const void* G, const void* rho, void* beta, const void* mask,
             const void* order, const void* pen, const void* lam,
             int n_epochs, int count, const void* nep, const void* cnt,
             T alpha, int m, int k, void* stream) {
  const size_t off = ring_offset(k, sizeof(T));
  const size_t smem = E > 0 ? off + (size_t)RING * (k * sizeof(T) + 16)
                            : smem_bytes(k, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gram_sweep_kernel<T, PEN, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gram_sweep_kernel<T, PEN, E><<<m, NT, smem, (cudaStream_t)stream>>>(
      (const T*)G, (const T*)rho, (T*)beta, (const uint8_t*)mask,
      (const int*)order, (const T*)pen, (const T*)lam, n_epochs, count,
      (const int*)nep, (const int*)cnt, alpha, k, off);
  return (int)cudaGetLastError();
}

// one warp with the ring up to k = WARP_K (16 or 32 slots a lane) where
// the ring fits, else NT threads reading G from L2
template <typename T, bool PEN>
int launch_pen(const void* G, const void* rho, void* beta, const void* mask,
               const void* order, const void* pen, const void* lam,
               int n_epochs, int count, const void* nep, const void* cnt,
               T alpha, int m, int k, void* stream) {
  if (k > WARP_K || !ring_fits(k, sizeof(T)))
    return launch_t<T, PEN, 0>(G, rho, beta, mask, order, pen, lam,
                               n_epochs, count, nep, cnt, alpha, m, k, stream);
  if (k <= 512)
    return launch_t<T, PEN, 16>(G, rho, beta, mask, order, pen, lam,
                                n_epochs, count, nep, cnt, alpha, m, k,
                                stream);
  return launch_t<T, PEN, 32>(G, rho, beta, mask, order, pen, lam, n_epochs,
                              count, nep, cnt, alpha, m, k, stream);
}

template <typename T>
int launch(const void* G, const void* rho, void* beta, const void* mask,
           const void* order, const void* pen, const void* lam, int n_epochs,
           int count, const void* nep, const void* cnt, T alpha, int m, int k,
           void* stream) {
  if (m < 1 || k < 1) return 0;
  if (pen != nullptr)
    return launch_pen<T, true>(G, rho, beta, mask, order, pen, lam, n_epochs,
                               count, nep, cnt, alpha, m, k, stream);
  return launch_pen<T, false>(G, rho, beta, mask, order, pen, lam, n_epochs,
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
