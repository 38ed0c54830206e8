// Wide-design CM sweeps for Hopper (sm_90a), plain C interface for ctypes.
//
// K7 cm_sweep_wide — replaces src/repro/core/cm.py:66 cm_epoch, the XLA
//    fori_loop that every baseline of the paper runs as its inner solver
//    (dynamic screening over all p columns, the DPP sequential path and
//    the strong-rule homotopy over reduced designs, the unscreened CM).
//    n_epochs cyclic prox-Newton sweeps over the first `count` slots of
//    `order` (distinct slots, as a sweep's order lists them) on a
//    transposed design XT (k, n), any k, with z = X beta kept by rank-1
//    updates: K3's interface without K3's tail (the dual point and the gap
//    stay torch ops in the callers). Per slot the arithmetic of
//    repro/core/cm.py:35 _coordinate_step: L_j = max(alpha |x_j|^2,
//    1e-30), beta_j <- S(beta_j - x_j . f'(z) / L_j, lam pen_j / L_j),
//    0 on a masked slot, z += (beta_j new - old) x_j. Least squares and
//    logistic, float32 and float64, optional per-slot l1 weights `pen`.
//    Bound on this card: count * n_epochs dependent coordinate steps, each
//    a length-n dot product, a scalar soft-threshold and a length-n axpy.
//    Its bytes (one column a step, 8 KB at n = 1000 in f64) and flops
//    (~4n a step) are tiny against the latency of one step: a block
//    reduction (5 shuffles, a barrier, 8 serial adds), one division, the
//    soft-threshold and the thread's pass over its rows. A full-width
//    design (800 MB at n = 1000, k = 100,000) does not fit the 50 MB L2,
//    so each column comes from HBM.
//    Design: K5's step (csrc/cm_epochs.cu) fed by a stream of slot
//    records, with the column prefetch on another SM. One CTA of 256
//    threads owns the sweep; thread t owns the rows t, t + NT, ...; up to
//    n = 2048 its rows of z and y sit in registers (rows past n hold 0 and
//    stay 0), past that in shared memory. The slot state cannot live in
//    shared memory at k = 100,000, but the order is fixed for the launch,
//    so a prologue packs one record per position s < count of `order`
//    into a scratch buffer: {L_j, t_j, j, beta} (32 bytes in f64, 16 in
//    f32), L_j and the threshold t_j = (pen ? lam pen_j : lam) / L_j
//    computed as the first version did, t_j = +inf on a masked slot
//    (|u| - inf is never > 0, so the step gives 0 as the mask did). Each
//    step then reads records at fixed distances ahead, at addresses that
//    depend on no other load, all behind the barrier where the serial sum
//    and the division leave the warp's issue slots free: the slot of step
//    s + 5, and step s + 2's column (into registers, three sets rotating:
//    one address, the rows at fixed offsets from it), L_j, t_j and beta.
//    Beta is carried by position: thread 0 writes the new beta into
//    record s, which the next epoch reads back two steps ahead, at least
//    one barrier after the write; a count of 1 or 2, where that read would
//    overtake the write, takes the value in hand (the last two new betas),
//    as the first version did. At the end every record's beta is
//    scattered back to beta[order[s]]. One division stays on the chain
//    (g / L_j), and the fused pass (this step's update of z, the next
//    step's dot) has no branch: a zero update keeps z_i by a select.
//    The columns come from HBM at full width: a prefetch warp asks L2 for
//    the column of step s + PF, one bulk prefetch a column, its slots read
//    32 records at a time. It runs in a second CTA of a cluster of two,
//    on another SM, polling the step that thread 0 stores into its shared
//    memory (one store a step, no fence): as a ninth warp of the sweep's
//    CTA, even one that never wakes, it slowed every step, and a
//    shared-memory ring of columns filled by bulk copies from a producer
//    warp was slower still (PERF.md section 6).
//    Every element's arithmetic and its order are those of the first
//    version (and of K3): the dot and the update are explicit fmas, each
//    thread's rows ascending, the reduction tree fixed.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads of the sweep
constexpr int NW = NT / 32;
constexpr int PF = 10;             // L2 prefetch distance, in steps
constexpr int LS = 0, LOGIT = 1;
// shared memory ahead of the reduction slots: the step word that the
// sweep stores into the prefetch CTA's copy, padded to 16 bytes so that
// the serial sum reads the slots by 16-byte loads
constexpr size_t HEAD = 16;

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return ::exp(x); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ void set_inf(float& x) { x = __int_as_float(0x7f800000); }
__device__ __forceinline__ void set_inf(double& x) { x = __longlong_as_double(0x7ff0000000000000LL); }

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

// Block sum over the NT sweeping threads; every one gets the same value
// (summed in the same order). `buf` must not be reused before the next
// barrier.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* buf) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = buf[0];
  for (int i = 1; i < NW; ++i) s += buf[i];
  return s;
}

// One position of the sweep's order: L_j, the threshold, the slot and its
// beta (written by the sweep as it goes).
template <typename T>
struct alignas(4 * sizeof(T)) Rec {
  T l, t;
  int j;
  T b;
};
static_assert(sizeof(Rec<double>) == 32 && sizeof(Rec<float>) == 16,
              "keep in step with kernels/cm/wide.py::REC_WORDS");

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// L_j and t_j of a record, one vector load
template <typename T>
__device__ __forceinline__ void load_lt(const Rec<T>* r, T& l, T& t) {
  const typename Pair<T>::type v =
      *reinterpret_cast<const typename Pair<T>::type*>(r);
  l = v.x;
  t = v.y;
}

template <typename T, int L>
__device__ __forceinline__ void pack_records(
    Rec<T>* rec, const T* __restrict__ beta, const T* __restrict__ col_sq,
    const uint8_t* __restrict__ mask, const T* __restrict__ pen,
    const int* __restrict__ order, T lam, int count) {
  const T alpha = (L == LS) ? T(1) : T(0.25);
#pragma unroll 4
  for (int s = threadIdx.x; s < count; s += NT) {
    const int j = order[s];
    const T lj = fmax(alpha * col_sq[j], T(1e-30));
    const T th = (pen != nullptr ? lam * pen[j] : lam) / lj;
    Rec<T> r;
    r.l = lj;
    if (mask[j]) r.t = th;
    else set_inf(r.t);
    r.j = j;
    r.b = beta[j];
    rec[s] = r;
  }
}

// soft-threshold of beta bb by the step's sum g
template <typename T>
__device__ __forceinline__ T soft(T bb, T g, T l, T t) {
  const T u = bb - g / l;
  const T a = fabs(u) - t;
  return a > T(0) ? copysign(a, u) : T(0);
}

// this step's update of the thread's rows (column `cur`) fused with the
// next step's part of the dot (column `nxt`), branch-free
template <typename T, int L, int R>
__device__ __forceinline__ T fused_pass(T d, const T* cur, const T* nxt,
                                        T* z, const T* y) {
  const bool upd = d != T(0);
  T part = T(0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const T zu = fma_rn(d, cur[r], z[r]);
    z[r] = upd ? zu : z[r];
    part = fma_rn(nxt[r], grad<T, L>(z[r], y[r]), part);
  }
  return part;
}

// One bulk L2 prefetch of a column (rounded out to 16 bytes, clipped to
// the design's last whole 16 bytes).
template <typename T>
__device__ __forceinline__ void prefetch_col(const T* col, int n,
                                             uintptr_t end16) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(col) & ~uintptr_t(15);
  uintptr_t hi = (reinterpret_cast<uintptr_t>(col + n) + 15) & ~uintptr_t(15);
  hi = hi < end16 ? hi : end16;
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(lo), "r"((unsigned)(hi - lo)) : "memory");
}

// A step known ahead: the thread's rows of its column (registers for
// R > 0; for R = 0 the column's address), L_j, t_j, beta and its record's
// position; `nj` / `npos`: the slot and position of the step three later
// (read a step before that step's column).
template <typename T, int R>
struct Ahead {
  T a[R > 0 ? R : 1];
  const T* col;
  T l, t, b;
  int pos, nj, npos;
};

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}
// the shared-memory address of `p` in the cluster's CTA 1
__device__ __forceinline__ unsigned peer_addr(const void* p) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 1;" : "=r"(r) : "r"(saddr(p)));
  return r;
}
// the sweep's step, stored into CTA 1's shared memory (no fence) and
// polled there
__device__ __forceinline__ void store_peer(unsigned addr, long long s) {
  asm volatile("st.relaxed.cluster.shared::cluster.b64 [%0], %1;"
               :: "r"(addr), "l"(s) : "memory");
}
__device__ __forceinline__ long long load_step(const long long* p) {
  long long s;
  asm volatile("ld.relaxed.cluster.shared.b64 %0, [%1];"
               : "=l"(s) : "r"(saddr(p)) : "memory");
  return s;
}

// The prefetch warp: walks the record stream 32 positions at a time (one
// slot a lane, the next 32 read ahead) and asks L2 for the column of step
// q, one bulk prefetch from lane 0, once the sweep has reached step
// q - PF: it polls the step that thread 0 of the sweep stores into its
// CTA's `step` word.
template <typename T>
__device__ __forceinline__ void prefetch_warp(const T* XT, const Rec<T>* rec,
                                              const long long* step,
                                              long long S, int count, int n,
                                              uintptr_t end16) {
  const int lane = threadIdx.x & 31;
  int p = lane % count;
  int cj = rec[p].j;
  for (long long q0 = 0; q0 < S; q0 += 32) {
    const int pn = (int)((p + 32) % count);
    const int nj = rec[pn].j;
    const int m = S - q0 < 32 ? (int)(S - q0) : 32;
    for (int i = 0; i < m; ++i) {
      const long long t = q0 + i - PF;
      if (t >= 0)
        while (load_step(step) < t) __nanosleep(64);
      const int j = __shfl_sync(0xffffffffu, cj, i);
      if (lane == 0) prefetch_col(XT + (size_t)j * n, n, end16);
    }
    cj = nj;
    p = pn;
  }
}

template <typename T, int L, int R>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT)
cm_wide_kernel(const T* __restrict__ XT, const T* __restrict__ y,
               T* __restrict__ beta, T* __restrict__ z,
               const T* __restrict__ col_sq, const uint8_t* __restrict__ mask,
               const T* __restrict__ pen, const int* __restrict__ order,
               Rec<T>* rec, T lam, int n_epochs, int count, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* step = reinterpret_cast<long long*>(smem);  // CTA 1: polled
  T* red = reinterpret_cast<T*>(smem + HEAD);  // 2 * NW reduction slots
  T* y_s = red + 2 * NW;                // R = 0: y and z; R > 0: absent
  T* z_s = y_s + n;
  const int tid = threadIdx.x;
  const long long S = (long long)n_epochs * count;
  if (S == 0) return;
  const bool peer = cluster_rank() == 1;
  if (!peer)
    pack_records<T, L>(rec, beta, col_sq, mask, pen, order, lam, count);
  if (tid == 0) *step = 0;
  cluster_sync();                      // the records and the step word
  if (peer) {                          // the prefetch warp's CTA
    if (tid < 32)
      prefetch_warp(XT, rec, step, S, count, n,
                    reinterpret_cast<uintptr_t>(XT + (size_t)k * n) &
                        ~uintptr_t(15));
    cluster_sync();                    // the sweep is done with `step`
    return;
  }
  const unsigned step_peer = peer_addr(step);
  // each thread reads and writes its own rows only
  T zr[R > 0 ? R : 1], yr[R > 0 ? R : 1];
  bool row[R > 0 ? R : 1];
  if constexpr (R > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + NT * r;
      row[r] = i < n;
      yr[r] = row[r] ? y[i] : T(0);
      zr[r] = row[r] ? z[i] : T(0);
    }
  } else {
    for (int i = tid; i < n; i += NT) {
      y_s[i] = y[i];
      z_s[i] = z[i];
    }
  }

  const T* XTt = XT + tid;
  auto wrap = [&](int p) { return p + 1 == count ? 0 : p + 1; };
  int p5 = 0;                          // position of the next record to read
  // step q of `st` from its pending slot: its column, L_j, t_j and beta
  // (all threads), then the slot of step q + 3
  auto fetch = [&](Ahead<T, R>& st) {
    const int j = st.nj;
    st.pos = st.npos;
    if constexpr (R > 0) {
      const T* col = XTt + (size_t)j * n;
#pragma unroll
      for (int r = 0; r < R; ++r) st.a[r] = row[r] ? __ldg(col + NT * r) : T(0);
    } else {
      st.col = XT + (size_t)j * n;
    }
    load_lt(rec + st.pos, st.l, st.t);
    st.b = __ldcg(&rec[st.pos].b);
    st.nj = rec[p5].j;
    st.npos = p5;
    p5 = wrap(p5);
  };
  Ahead<T, R> A, B, C;
  // pending slots of steps 0, 1, 2
  A.nj = rec[p5].j; A.npos = p5; p5 = wrap(p5);
  B.nj = rec[p5].j; B.npos = p5; p5 = wrap(p5);
  C.nj = rec[p5].j; C.npos = p5; p5 = wrap(p5);
  fetch(A);                            // steps 0 and 1; pending 3 and 4
  fetch(B);
  // beta in hand: the new beta of the last two steps (a count of 1 or 2
  // reads its slot's beta before the last write lands)
  const bool c1 = count == 1, c2 = count == 2;
  T h2 = A.b, h1 = c1 ? A.b : B.b;
  // the first step's partial dot a_j . f'(z, y) over the thread's rows
  T part = T(0);
  if constexpr (R > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) part = fma_rn(A.a[r], grad<T, L>(zr[r], yr[r]), part);
  } else {
    for (int i = tid; i < n; i += NT)
      part = fma_rn(__ldg(A.col + i), grad<T, L>(z_s[i], y_s[i]), part);
  }
  int parity = 0;
  // step s on `cur`, with `nxt` (step s + 1) in hand and step s + 2
  // fetched into `pre`; the loop below rotates the three
  auto iter = [&](Ahead<T, R>& cur, const Ahead<T, R>& nxt, Ahead<T, R>& pre,
                  long long s) {
    const T g = block_sum<T>(part, red + parity * NW);
    parity ^= 1;
    if (tid == 0) store_peer(step_peer, s);   // the sweep is at step s
    // issued behind the barrier, where the serial sum and the division
    // leave the warp's issue slots free
    fetch(pre);
    const T bb = c1 ? h1 : c2 ? h2 : cur.b;
    const T b_new = soft(bb, g, cur.l, cur.t);
    if (tid == 0) rec[cur.pos].b = b_new;
    h2 = h1;
    h1 = b_new;
    const T d = b_new - bb;
    if constexpr (R > 0) {
      part = fused_pass<T, L, R>(d, cur.a, nxt.a, zr, yr);
    } else {
      // rows in shared memory: the update, then the next step's dot
      if (d != T(0))
        for (int i = tid; i < n; i += NT)
          z_s[i] = fma_rn(d, __ldg(cur.col + i), z_s[i]);
      part = T(0);
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
  __syncthreads();                     // every last beta
  for (int s = tid; s < count; s += NT) beta[order[s]] = __ldcg(&rec[s].b);
  if constexpr (R > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (row[r]) z[tid + NT * r] = zr[r];
  } else {
    for (int i = tid; i < n; i += NT) z[i] = z_s[i];
  }
  cluster_sync();                      // CTA 1's step word outlives the stores
}

// keep in step with kernels/cm/wide.py::cm_wide_smem_bytes (which also
// counts y's and z's n each for the register forms, and not HEAD: its
// budget sits 27 KB under the card's 227 KB a CTA)
size_t smem_bytes(int n, size_t itemsize, bool rows_in_smem) {
  return HEAD + (2 * (size_t)NW + (rows_in_smem ? 2 * (size_t)n : 0)) * itemsize;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int L, int R>
int launch_r(const void* XT, const void* y, void* beta, void* z,
             const void* col_sq, const void* mask, const void* pen,
             const void* order, void* rec, T lam, int n_epochs, int count,
             int n, int k, void* stream) {
  const size_t smem = smem_bytes(n, sizeof(T), R == 0);
  int e = set_smem(cm_wide_kernel<T, L, R>, smem);
  if (e) return e;
  cm_wide_kernel<T, L, R><<<2, NT, smem, (cudaStream_t)stream>>>(
      (const T*)XT, (const T*)y, (T*)beta, (T*)z, (const T*)col_sq,
      (const uint8_t*)mask, (const T*)pen, (const int*)order, (Rec<T>*)rec,
      lam, n_epochs, count, n, k);
  return (int)cudaGetLastError();
}

// rows per thread held in registers: 4 up to n = 1024, 8 up to 2048, past
// that z and y in shared memory
template <typename T, int L>
int launch(const void* XT, const void* y, void* beta, void* z,
           const void* col_sq, const void* mask, const void* pen,
           const void* order, void* rec, T lam, int n_epochs, int count,
           int n, int k, void* stream) {
  if (n <= 4 * NT)
    return launch_r<T, L, 4>(XT, y, beta, z, col_sq, mask, pen, order, rec,
                             lam, n_epochs, count, n, k, stream);
  if (n <= 8 * NT)
    return launch_r<T, L, 8>(XT, y, beta, z, col_sq, mask, pen, order, rec,
                             lam, n_epochs, count, n, k, stream);
  return launch_r<T, L, 0>(XT, y, beta, z, col_sq, mask, pen, order, rec,
                           lam, n_epochs, count, n, k, stream);
}

}  // namespace

extern "C" {

// pen may be null (every slot penalized); rec: count records of 4 words
// of T (scratch)
#define WIDE_ENTRY(NAME, T, L)                                                 \
  int NAME(const void* XT, const void* y, void* beta, void* z,                \
           const void* col_sq, const void* mask, const void* pen,             \
           const void* order, void* rec, T lam, int n_epochs, int count,      \
           int n, int k, void* stream) {                                       \
    return launch<T, L>(XT, y, beta, z, col_sq, mask, pen, order, rec, lam,   \
                        n_epochs, count, n, k, stream);                       \
  }

WIDE_ENTRY(cm_sweep_wide_ls_f32, float, LS)
WIDE_ENTRY(cm_sweep_wide_ls_f64, double, LS)
WIDE_ENTRY(cm_sweep_wide_logit_f32, float, LOGIT)
WIDE_ENTRY(cm_sweep_wide_logit_f64, double, LOGIT)

}  // extern "C"
