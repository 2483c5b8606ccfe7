// Fused DSE campaign sweep for NVIDIA Hopper (sm_90a): three hand-written
// kernels.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers).  Every entry point takes raw device pointers and the
// caller's CUDA stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
//
// -fmad=false is part of the contract, not a tuning choice: the float64 tier
// must reproduce the tensor code in repro_torch/core/costmodel.py bit for bit
// (one ulp in latency or power can flip a `<=` of the constraint mask or a
// dominance test), and eager tensor ops never contract a*b+c.  For the same
// reason every expression below keeps the association of the tensor code, the
// cube is x*x*x, and every literal is cast to T so the float instantiation
// computes in float, as a float32 tensor op with a python scalar does.
//
// ---------------------------------------------------------------------------
// dse_sweep<T>   replaces the TPU kernel repro/kernels/dse_sweep.py::_sweep_kernel
//
//   All W workloads x one packed candidate tile, elementwise:
//   scale_census -> simulate_batch (three roofline times, per-axis collective
//   time with axis_link_counts, max + (1-overlap)*rest latency,
//   utilisation-weighted cubic-DVFS power capped at TDP, energy) ->
//   sweep_feasibility.
//     in : cand_cols [18, N] (CAND_COLS, struct of arrays), wl_cols [W, 6]
//     out: energy [W, N], latency [W, N] (T), feasible [W, N] (uint8 0/1)
//
//   Bound on an H100: bytes.  It must move (18*N + 2*W*N)*sizeof(T) + W*N
//   bytes; at the campaign's default tile (W=6, N=4096, float64) that is
//   about 1.0 MB, i.e. ~0.3 us at 3.35 TB/s, against ~150 flops per element
//   (~4 MFLOP, ~0.1 us at the float64 rate).  Both are far below the cost of
//   launching a kernel at all, so at that tile the launch is latency-bound
//   and the campaign host-bound.  What the design does about the bytes: one
//   thread per (workload, lane) with blockIdx.y = workload, so a warp's 18
//   column loads are contiguous along N (coalesced) and the W re-reads of a
//   candidate column hit L2; the six workload scalars are read once per
//   thread; nothing is staged in shared memory because nothing is reused
//   within a block.  There is no lane padding: the ragged edge is
//   `if (lane < n)`.  The `valid` column stays, because the campaign pads
//   every tile to one fixed width and marks the padding lanes infeasible.
//
// ---------------------------------------------------------------------------
// screen_rows<T>   replaces the jnp screen fused behind the TPU kernel in the
//                  same launch, repro/core/costmodel.py::_screen_rows
//
//   One block per workload row, three phases separated by __syncthreads():
//   (1) feasible min e, min l, max e, max l and the feasible count;
//   (2) eight probe argmins of w_p*(e/e_lo) + l/l_lo over feasible lanes,
//       ties to the LOWEST lane (as argmin does);
//   (3) keep = feasible & !(weakly dominated, strictly in one coordinate, by
//       any probe), and the survivor count.
//     in : energy, latency [W, N] (T), feasible [W, N] (uint8)
//     out: keep [W, N] (uint8), n_surv, n_feas [W] (int64), ref_e, ref_l [W]
//          (T; -inf when the row has no feasible lane -- then every argmin is
//          lane 0 and keep is all false)
//
//   Every reduction here is a min, a max, a count or a lexicographic
//   (score, lane) minimum: all are associative and commutative on the values
//   that occur (no NaN), so the result does not depend on the order in which
//   threads or blocks combine -- the kernel is deterministic and equals the
//   tensor code exactly.
//
//   Bound on an H100: bytes, (2*sizeof(T) + 2) * W * N read/written once
//   (~0.45 MB at W=6, N=4096, float64), again far below launch cost.  What
//   holds it back is occupancy, not bandwidth: W blocks (six in the default
//   campaign) run on W of the card's 132 SMs, and each block walks its row
//   three times (the re-reads come from L2).  It stays for the `general`
//   launch plan only, which shapes past the fused kernel's shared memory take.
//
// ---------------------------------------------------------------------------
// k1_sweep_reduce<T>   replaces, in one launch, the TPU kernel _sweep_kernel
//                      and the jnp screen and compaction behind it
//                      (repro/core/costmodel.py::_screen_rows,
//                      ::_compact_rows_device)
//
//   One thread-block cluster of C CTAs (C <= 16, launched with
//   cudaLaunchKernelEx and the cluster-dimension attribute) per workload row;
//   CTA r owns lanes [r*lanes, (r+1)*lanes) of the row, with 512 threads (at
//   most 128 registers each) or, for wide slices, 1024 (at most 64).
//     1. sweep: sweep_point() of each owned lane into the CTA's own shared
//        memory (e, l and a flag byte; dynamic shared memory);
//     2. feasible min / max of e and l and the feasible count: warp shuffles,
//        once across warps, cluster.sync(), then every CTA combines the C
//        partials by reading its peers' shared memory (map_shared_rank);
//     3. the eight (score, lane) probe argmins the same way; each probe's
//        (e, l) is read from the owning CTA's shared memory;
//     4. keep = feasible & !dominated, the CTA's survivor count, and over
//        DSMEM the exclusive prefix of the counts of lower ranks;
//     5. a block scan of the keep bits in lane order gives each survivor its
//        rank in the row; ranks < K are written, the rest of the K slots are
//        zero-filled, CTA 0 writes the row's counts and maxima; a last
//        cluster.sync() keeps every CTA resident while peers read it.
//     in : cand_cols [18, N], wl_cols [W, 6], K
//     out: n_surv, n_feas [W] (int64), ref_e, ref_l [W] (T),
//          surv_idx [W, K] (int64, ascending lanes), surv_e, surv_l [W, K]
//          (T): what screen_rows_kernel and the compaction give, with no
//          [W, N] row ever written to device memory.
//   The reductions are min, max, count and lexicographic min and the scan
//   runs in rank order, so the result is deterministic and equals the plain
//   chain bit for bit.  Bound on an H100: the candidate columns read once
//   plus the [W, K] outputs written, about 0.9 MB at the default tile (W=6,
//   N=4096, K=2048, float64), against ~200 operations per (row, lane); the
//   W re-reads of the columns are left to L2.  What the design removes: the
//   [W, N] round trip through device memory, the screen's ~135 block-wide
//   barriers a row, and the W-SM occupancy of the screen.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSweepThreads = 256;
constexpr int kScreenThreads = 1024;
constexpr int kProbes = 8;
constexpr int kFusedMaxThreads = 1024;  // threads of a fused CTA, at most
constexpr int kMaxCluster = 16;         // non-portable cluster size limit
constexpr int kPortableCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

// column order of cand_cols (CAND_COLS in repro_torch/core/costmodel.py)
enum CandCol {
  C_N_CHIPS = 0, C_FREQ, C_MESH_POD, C_MESH_DATA, C_MESH_MODEL, C_VALID,
  C_NOMINAL, C_FMIN, C_FMAX, C_PEAK, C_HBM_BW, C_ICI_BW, C_TDP, C_IDLE,
  C_ICI_LINKS, C_LINKS_PER_AXIS, C_HOP_S, C_HBM_BYTES, C_COUNT
};

// column order of wl_cols (WL_COLS)
enum WlCol { W_FLOPS = 0, W_HBM, W_COLL, W_WIRE, W_BASE_CHIPS, W_STATE_GB,
             W_COUNT };

}  // namespace

// SimConfig + constraint, passed by value to the sweep kernel.  Doubles on
// the host side; cast to T once per thread.
struct SweepParams {
  double one_minus_overlap;
  double w_mxu, w_hbm, w_ici;
  double frac_data, frac_model;     // (1 - coll_model_frac), coll_model_frac
  double max_power_w, max_latency_s;
  int has_max_power, has_max_latency, min_hbm_fit;
};

struct ScreenParams {
  double weights[kProbes];          // already rounded to T on the host
};

// everything the fused kernel takes besides pointers and extents
struct FusedParams {
  SweepParams sweep;
  ScreenParams screen;
};

namespace {

template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return a > b ? a : b;
}
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return a < b ? a : b;
}
__device__ __forceinline__ double tfloor(double x) { return floor(x); }
__device__ __forceinline__ float tfloor(float x) { return floorf(x); }

// hw.axis_link_counts for one axis: min(min(want(k), per_axis), budget)
template <typename T>
__device__ __forceinline__ T axis_links(T k, T per_axis, T budget) {
  T want = k >= T(3) ? T(2) : (k >= T(2) ? T(1) : T(0));
  return tmin(tmin(want, per_axis), budget);
}

// costmodel._axis_collective_time; the guarded denominator keeps dead lanes
// (no links, no bandwidth) away from a zero divide before the select
template <typename T>
__device__ __forceinline__ T axis_time(T payload, T k, T links, T bw, T hop) {
  bool live = (k > T(1)) && (links > T(0)) && (bw > T(0)) && (payload > T(0));
  T denom = live ? bw * (links > T(0) ? links : T(1)) : T(1);
  T t_bw = payload * (k - T(1)) / tmax(k, T(1)) / denom;
  T t_hop = T(2) * (k - T(1)) * hop;
  return live ? t_bw + t_hop : T(0);
}

// the six scalars of one workload row that the sweep reads
template <typename T> struct WlRow { T flops, hbm_b, wire_b, bc, state_gb; };

template <typename T>
__device__ __forceinline__ WlRow<T> load_wl_row(const T* __restrict__ wl,
                                                int64_t w) {
  const T* wrow = wl + w * W_COUNT;
  return {wrow[W_FLOPS], wrow[W_HBM], wrow[W_WIRE], wrow[W_BASE_CHIPS],
          wrow[W_STATE_GB]};
}

// The sweep of one (workload, lane): energy, latency and the constraint
// mask.  dse_sweep_kernel and k1_sweep_reduce_kernel both call it, so the
// arithmetic of the two kernels cannot diverge.
template <typename T>
__device__ __forceinline__ void sweep_point(const T* __restrict__ cand,
                                            int64_t n, int64_t lane,
                                            const WlRow<T> r,
                                            const SweepParams p, T& e_out,
                                            T& lat_out, bool& ok_out) {
  const T flops = r.flops, hbm_b = r.hbm_b, wire_b = r.wire_b;
  const T bc = r.bc, state_gb = r.state_gb;

  const T nc = cand[C_N_CHIPS * n + lane];
  const T freq_in = cand[C_FREQ * n + lane];
  const T kp = cand[C_MESH_POD * n + lane];
  const T kd = cand[C_MESH_DATA * n + lane];
  const T km = cand[C_MESH_MODEL * n + lane];
  const T valid = cand[C_VALID * n + lane];
  const T nominal = cand[C_NOMINAL * n + lane];
  const T f_min = cand[C_FMIN * n + lane];
  const T f_max = cand[C_FMAX * n + lane];
  const T peak0 = cand[C_PEAK * n + lane];
  const T hbm_bw = cand[C_HBM_BW * n + lane];
  const T ici_bw = cand[C_ICI_BW * n + lane];
  const T tdp = cand[C_TDP * n + lane];
  const T idle = cand[C_IDLE * n + lane];
  const T ici_links = cand[C_ICI_LINKS * n + lane];
  const T per_axis = cand[C_LINKS_PER_AXIS * n + lane];
  const T hop = cand[C_HOP_S * n + lane];
  const T hbm_cap = cand[C_HBM_BYTES * n + lane];

  // scale_census (only the keys the mesh-aware simulation reads)
  const T r_ = bc / nc;
  const T ring_base = tmax((bc - T(1)) / bc, T(1e-9));
  const T flops_s = flops * r_;
  const T hbm_s = hbm_b * r_;
  const T payload = wire_b * r_ / ring_base;

  // simulate_batch
  const T freq = tmin(tmax(freq_in, f_min), f_max);
  const T peak = peak0 * (freq / nominal);
  const T t_comp = flops_s / peak;
  const T t_mem = hbm_s / hbm_bw;
  const T p_d = payload * T(p.frac_data);
  const T p_m = payload * T(p.frac_model);

  const T n_active = T(kp > T(1) ? 1 : 0) + T(kd > T(1) ? 1 : 0)
                     + T(km > T(1) ? 1 : 0);
  const T budget = tmax(tfloor(ici_links / tmax(n_active, T(1))), T(1));
  const T lp = axis_links(kp, per_axis, budget);
  const T ld = axis_links(kd, per_axis, budget);
  const T lm = axis_links(km, per_axis, budget);
  const T t_coll = (axis_time(p_d, kd, ld, ici_bw, hop)
                    + axis_time(p_d / tmax(kd, T(1)), kp, lp, ici_bw, hop))
                   + axis_time(p_m, km, lm, ici_bw, hop);

  const T t_max = tmax(tmax(t_comp, t_mem), t_coll);
  T lat = t_max + T(p.one_minus_overlap) * (((t_comp + t_mem) + t_coll)
                                            - t_max);
  lat = tmax(lat, T(1e-9));

  T util = (T(p.w_mxu) * (t_comp / lat) + T(p.w_hbm) * (t_mem / lat))
           + T(p.w_ici) * (t_coll / lat);
  util = tmin(tmax(util, T(0)), T(1));
  const T fr = freq / f_max;
  T power = idle + (tdp - idle) * util * (fr * fr * fr);
  power = tmin(power, tdp);
  const T e = power * lat * nc;

  // sweep_feasibility
  bool ok = valid > T(0);
  if (p.min_hbm_fit) {
    const T state_pd = state_gb * bc / nc;
    ok = ok && (state_pd * T(1e9) <= hbm_cap * T(0.9));
  }
  if (p.has_max_power) ok = ok && (power * nc <= T(p.max_power_w));
  if (p.has_max_latency) ok = ok && (lat <= T(p.max_latency_s));

  e_out = e;
  lat_out = lat;
  ok_out = ok;
}

template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
dse_sweep_kernel(const T* __restrict__ cand, const T* __restrict__ wl,
                 T* __restrict__ energy, T* __restrict__ latency_out,
                 uint8_t* __restrict__ feasible, int64_t n, SweepParams p) {
  const int64_t lane = (int64_t)blockIdx.x * kSweepThreads + threadIdx.x;
  if (lane >= n) return;
  const int64_t w = blockIdx.y;
  T e, lat;
  bool ok;
  sweep_point(cand, n, lane, load_wl_row(wl, w), p, e, lat, ok);
  const int64_t o = w * n + lane;
  energy[o] = e;
  latency_out[o] = lat;
  feasible[o] = ok ? 1 : 0;
}

// ---- block reductions over kScreenThreads values in shared memory ---------

template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, V* buf, Op op) {
  const int tid = threadIdx.x;
  buf[tid] = v;
  __syncthreads();
  for (int s = kScreenThreads / 2; s > 0; s >>= 1) {
    if (tid < s) buf[tid] = op(buf[tid], buf[tid + s]);
    __syncthreads();
  }
  V out = buf[0];
  __syncthreads();          // buf is reused by the next reduction
  return out;
}

// (score, lane) pair ordered by score, then by lane: the minimum is the
// argmin with ties to the lowest lane
template <typename T> struct Probe { T s; long long i; };

template <typename T>
__device__ __forceinline__ bool probe_less(T s, long long i, T bs,
                                           long long bi) {
  return (s < bs) || (s == bs && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(kScreenThreads)
screen_rows_kernel(const T* __restrict__ energy, const T* __restrict__ latency,
                   const uint8_t* __restrict__ feasible,
                   uint8_t* __restrict__ keep, long long* __restrict__ n_surv,
                   long long* __restrict__ n_feas, T* __restrict__ ref_e,
                   T* __restrict__ ref_l, int64_t n, ScreenParams sp) {
  __shared__ T s_val[kScreenThreads];
  __shared__ long long s_idx[kScreenThreads];
  __shared__ T s_ep[kProbes];
  __shared__ T s_lp[kProbes];

  const int tid = threadIdx.x;
  const int64_t w = blockIdx.x;
  const T* e = energy + w * n;
  const T* l = latency + w * n;
  const uint8_t* f = feasible + w * n;
  const T inf = T(INFINITY);

  // phase 1: feasible extrema and count
  T e_lo = inf, l_lo = inf, e_hi = -inf, l_hi = -inf;
  long long cnt = 0;
  for (int64_t i = tid; i < n; i += kScreenThreads) {
    if (f[i]) {
      const T ei = e[i], li = l[i];
      e_lo = tmin(e_lo, ei);
      l_lo = tmin(l_lo, li);
      e_hi = tmax(e_hi, ei);
      l_hi = tmax(l_hi, li);
      ++cnt;
    }
  }
  auto op_min = [](T a, T b) { return a < b ? a : b; };
  auto op_max = [](T a, T b) { return a > b ? a : b; };
  auto op_add = [](long long a, long long b) { return a + b; };
  e_lo = block_reduce(e_lo, s_val, op_min);
  l_lo = block_reduce(l_lo, s_val, op_min);
  e_hi = block_reduce(e_hi, s_val, op_max);
  l_hi = block_reduce(l_hi, s_val, op_max);
  cnt = block_reduce(cnt, s_idx, op_add);

  // phase 2: eight probe argmins over where(feasible, score, inf)
  T best_s[kProbes];
  long long best_i[kProbes];
#pragma unroll
  for (int p = 0; p < kProbes; ++p) { best_s[p] = inf; best_i[p] = n; }
  for (int64_t i = tid; i < n; i += kScreenThreads) {
    const bool fi = f[i] != 0;
    const T en = e[i] / e_lo;
    const T ln = l[i] / l_lo;
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const T s = fi ? T(sp.weights[p]) * en + ln : inf;
      if (probe_less<T>(s, i, best_s[p], best_i[p])) {
        best_s[p] = s;
        best_i[p] = i;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    // tree reduction of the (score, lane) pair, both halves in lock step
    s_val[tid] = best_s[p];
    s_idx[tid] = best_i[p];
    __syncthreads();
    for (int s = kScreenThreads / 2; s > 0; s >>= 1) {
      if (tid < s && probe_less<T>(s_val[tid + s], s_idx[tid + s],
                                   s_val[tid], s_idx[tid])) {
        s_val[tid] = s_val[tid + s];
        s_idx[tid] = s_idx[tid + s];
      }
      __syncthreads();
    }
    if (tid == 0) {
      const long long pi = s_idx[0] < n ? s_idx[0] : 0;
      s_ep[p] = e[pi];
      s_lp[p] = l[pi];
    }
    __syncthreads();
  }

  // phase 3: drop everything a probe dominates, count the survivors
  T ep[kProbes], lp[kProbes];
#pragma unroll
  for (int p = 0; p < kProbes; ++p) { ep[p] = s_ep[p]; lp[p] = s_lp[p]; }
  long long surv = 0;
  uint8_t* k_out = keep + w * n;
  for (int64_t i = tid; i < n; i += kScreenThreads) {
    const T ei = e[i], li = l[i];
    bool dom = false;
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      dom = dom || ((ei >= ep[p]) && (li >= lp[p])
                    && ((ei > ep[p]) || (li > lp[p])));
    }
    const bool kp = (f[i] != 0) && !dom;
    k_out[i] = kp ? 1 : 0;
    surv += kp ? 1 : 0;
  }
  surv = block_reduce(surv, s_idx, op_add);

  if (tid == 0) {
    n_surv[w] = surv;
    n_feas[w] = cnt;
    ref_e[w] = e_hi;
    ref_l[w] = l_hi;
  }
}


// ---- the fused tile: sweep, screen and compaction in one cluster launch ----

template <typename T>
__device__ __forceinline__ bool lane_less(T s, int i, T bs, int bi) {
  return (s < bs) || (s == bs && i < bi);
}

// bytes of dynamic shared memory of a fused CTA that owns `lanes` lanes:
// energy and latency in T, one flag byte (bit 0 feasible, bit 1 kept)
template <typename T> __host__ __device__ constexpr int64_t fused_smem(
    int64_t lanes) {
  return (lanes * (2 * (int64_t)sizeof(T) + 1) + 15) / 16 * 16;
}

template <typename T, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, 1)
k1_sweep_reduce_kernel(const T* __restrict__ cand, const T* __restrict__ wl,
                       long long* __restrict__ n_surv,
                       long long* __restrict__ n_feas, T* __restrict__ ref_e,
                       T* __restrict__ ref_l, long long* __restrict__ surv_idx,
                       T* __restrict__ surv_e, T* __restrict__ surv_l,
                       int64_t n, int lanes, int64_t k, FusedParams fp) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, wlane = tid & 31, nwarps = nthreads >> 5;
  const int64_t w = blockIdx.y;
  const int64_t base = (int64_t)crank * lanes;
  // lanes of this CTA's slice that exist (the last slices may hold fewer)
  const int own = (int)(n - base < lanes ? (n - base > 0 ? n - base : 0)
                                         : lanes);
  const T inf = T(INFINITY);

  extern __shared__ __align__(16) unsigned char smem[];
  T* s_e = reinterpret_cast<T*>(smem);
  T* s_l = s_e + lanes;
  uint8_t* s_f = reinterpret_cast<uint8_t*>(s_l + lanes);

  constexpr int kMaxWarps = kMaxThreads / 32;
  __shared__ T s_wext[kMaxWarps][4];
  __shared__ int s_wcnt[kMaxWarps];
  __shared__ T s_ps[kMaxWarps][kProbes];
  __shared__ int s_pi[kMaxWarps][kProbes];
  __shared__ int s_scan[2][kMaxWarps];
  // this CTA's partials, read by its peers through distributed shared memory
  __shared__ T c_ext[4];
  __shared__ int c_feas;
  __shared__ T c_ps[kProbes];
  __shared__ int c_pi[kProbes];
  __shared__ int c_keep;
  // the row's values, combined from all the cluster's partials
  __shared__ T r_ext[4];
  __shared__ int r_feas;
  __shared__ T r_ep[kProbes], r_lp[kProbes];
  __shared__ long long r_off, r_tot;

  // 1. sweep this slice into shared memory; feasible extrema and count
  const WlRow<T> row = load_wl_row(wl, w);
  T e_lo = inf, l_lo = inf, e_hi = -inf, l_hi = -inf;
  int cnt = 0;
  for (int i = tid; i < own; i += nthreads) {
    T e, lat;
    bool ok;
    sweep_point(cand, n, base + i, row, fp.sweep, e, lat, ok);
    s_e[i] = e;
    s_l[i] = lat;
    s_f[i] = ok ? 1 : 0;
    if (ok) {
      e_lo = tmin(e_lo, e);
      l_lo = tmin(l_lo, lat);
      e_hi = tmax(e_hi, e);
      l_hi = tmax(l_hi, lat);
      ++cnt;
    }
  }
  // 2. extrema: warp shuffles, once across warps, then across the cluster
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    e_lo = tmin(e_lo, __shfl_xor_sync(kFull, e_lo, o));
    l_lo = tmin(l_lo, __shfl_xor_sync(kFull, l_lo, o));
    e_hi = tmax(e_hi, __shfl_xor_sync(kFull, e_hi, o));
    l_hi = tmax(l_hi, __shfl_xor_sync(kFull, l_hi, o));
    cnt += __shfl_xor_sync(kFull, cnt, o);
  }
  if (wlane == 0) {
    s_wext[warp][0] = e_lo;
    s_wext[warp][1] = l_lo;
    s_wext[warp][2] = e_hi;
    s_wext[warp][3] = l_hi;
    s_wcnt[warp] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    for (int q = 1; q < nwarps; ++q) {
      e_lo = tmin(e_lo, s_wext[q][0]);
      l_lo = tmin(l_lo, s_wext[q][1]);
      e_hi = tmax(e_hi, s_wext[q][2]);
      l_hi = tmax(l_hi, s_wext[q][3]);
      cnt += s_wcnt[q];
    }
    c_ext[0] = e_lo;
    c_ext[1] = l_lo;
    c_ext[2] = e_hi;
    c_ext[3] = l_hi;
    c_feas = cnt;
  }
  cluster.sync();                                           // barrier 1
  if (warp == 0) {
    T v0 = inf, v1 = inf, v2 = -inf, v3 = -inf;
    int c = 0;
    if (wlane < csize) {
      const T* pe = cluster.map_shared_rank(c_ext, wlane);
      v0 = pe[0];
      v1 = pe[1];
      v2 = pe[2];
      v3 = pe[3];
      c = *cluster.map_shared_rank(&c_feas, wlane);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v0 = tmin(v0, __shfl_xor_sync(kFull, v0, o));
      v1 = tmin(v1, __shfl_xor_sync(kFull, v1, o));
      v2 = tmax(v2, __shfl_xor_sync(kFull, v2, o));
      v3 = tmax(v3, __shfl_xor_sync(kFull, v3, o));
      c += __shfl_xor_sync(kFull, c, o);
    }
    if (wlane == 0) {
      r_ext[0] = v0;
      r_ext[1] = v1;
      r_ext[2] = v2;
      r_ext[3] = v3;
      r_feas = c;
    }
  }
  __syncthreads();
  e_lo = r_ext[0];
  l_lo = r_ext[1];

  // 3. eight probe argmins of w_p*(e/e_lo) + l/l_lo over feasible lanes,
  //    ties to the lowest lane (a row without a feasible lane: lane 0)
  T best_s[kProbes];
  int best_i[kProbes];
#pragma unroll
  for (int p = 0; p < kProbes; ++p) { best_s[p] = inf; best_i[p] = INT_MAX; }
  for (int i = tid; i < own; i += nthreads) {
    const bool fi = s_f[i] != 0;
    const T en = s_e[i] / e_lo;
    const T ln = s_l[i] / l_lo;
    const int g = (int)(base + i);
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const T s = fi ? T(fp.screen.weights[p]) * en + ln : inf;
      if (lane_less<T>(s, g, best_s[p], best_i[p])) {
        best_s[p] = s;
        best_i[p] = g;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T os = __shfl_xor_sync(kFull, best_s[p], o);
      const int oi = __shfl_xor_sync(kFull, best_i[p], o);
      if (lane_less<T>(os, oi, best_s[p], best_i[p])) {
        best_s[p] = os;
        best_i[p] = oi;
      }
    }
    if (wlane == 0) {
      s_ps[warp][p] = best_s[p];
      s_pi[warp][p] = best_i[p];
    }
  }
  __syncthreads();
  if (tid < kProbes) {
    T bs = s_ps[0][tid];
    int bi = s_pi[0][tid];
    for (int q = 1; q < nwarps; ++q) {
      if (lane_less<T>(s_ps[q][tid], s_pi[q][tid], bs, bi)) {
        bs = s_ps[q][tid];
        bi = s_pi[q][tid];
      }
    }
    c_ps[tid] = bs;
    c_pi[tid] = bi;
  }
  cluster.sync();                                           // barrier 2
  // one warp a probe: lane r reads CTA r's partial, shuffles pick the best,
  // lane 0 reads the probe's (e, l) from the CTA that owns its lane
  for (int p = warp; p < kProbes; p += nwarps) {
    T bs = inf;
    int bi = INT_MAX;
    if (wlane < csize) {
      bs = cluster.map_shared_rank(c_ps, wlane)[p];
      bi = cluster.map_shared_rank(c_pi, wlane)[p];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T os = __shfl_xor_sync(kFull, bs, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (lane_less<T>(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (wlane == 0) {
      const int pi = bi < n ? bi : 0;
      const int owner = pi / lanes, at = pi - owner * lanes;
      r_ep[p] = cluster.map_shared_rank(s_e, owner)[at];
      r_lp[p] = cluster.map_shared_rank(s_l, owner)[at];
    }
  }
  __syncthreads();

  // 4. keep = feasible & not dominated by a probe; the slice's count
  T ep[kProbes], lp[kProbes];
#pragma unroll
  for (int p = 0; p < kProbes; ++p) { ep[p] = r_ep[p]; lp[p] = r_lp[p]; }
  int kept = 0;
  for (int i = tid; i < own; i += nthreads) {
    const T ei = s_e[i], li = s_l[i];
    bool dom = false;
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      dom = dom || ((ei >= ep[p]) && (li >= lp[p])
                    && ((ei > ep[p]) || (li > lp[p])));
    }
    if (s_f[i] && !dom) {
      s_f[i] = 3;
      ++kept;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync(kFull, kept, o);
  if (wlane == 0) s_wcnt[warp] = kept;
  __syncthreads();
  if (tid == 0) {
    for (int q = 1; q < nwarps; ++q) kept += s_wcnt[q];
    c_keep = kept;
  }
  cluster.sync();                                           // barrier 3
  // the survivors of lower ranks come first: this slice's global offset
  if (warp == 0) {
    long long v = wlane < csize ? *cluster.map_shared_rank(&c_keep, wlane)
                                : 0;
    long long before = wlane < crank ? v : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_xor_sync(kFull, v, o);
      before += __shfl_xor_sync(kFull, before, o);
    }
    if (wlane == 0) {
      r_tot = v;
      r_off = before;
    }
  }
  __syncthreads();

  // 5. compaction in lane order: a block scan of the keep bits per round
  //    of nthreads lanes, carried across rounds; ranks >= k are not written
  const long long tot = r_tot;
  long long carry = r_off;
  int buf = 0;
  const unsigned below = (1u << wlane) - 1u;
  for (int i0 = 0; i0 < own && carry < k; i0 += nthreads) {
    const int i = i0 + tid;
    const bool kp = i < own && s_f[i] == 3;
    const unsigned b = __ballot_sync(kFull, kp);
    if (wlane == 0) s_scan[buf][warp] = __popc(b);
    __syncthreads();
    int before = 0, round = 0;
    for (int q = 0; q < nwarps; ++q) {
      const int v = s_scan[buf][q];
      before += q < warp ? v : 0;
      round += v;
    }
    if (kp) {
      const long long rank = carry + before + __popc(b & below);
      if (rank < k) {
        const int64_t o = w * k + rank;
        surv_idx[o] = base + i;
        surv_e[o] = s_e[i];
        surv_l[o] = s_l[i];
      }
    }
    carry += round;
    buf ^= 1;
  }
  // zero fill past the row's survivors, spread over the cluster
  const long long filled = tot < k ? tot : k;
  for (long long s = filled + (long long)crank * nthreads + tid; s < k;
       s += (long long)csize * nthreads) {
    const int64_t o = w * k + s;
    surv_idx[o] = 0;
    surv_e[o] = T(0);
    surv_l[o] = T(0);
  }
  if (crank == 0 && tid == 0) {
    n_surv[w] = tot;
    n_feas[w] = r_feas;
    ref_e[w] = r_ext[2];
    ref_l[w] = r_ext[3];
  }
  cluster.sync();            // barrier 4: no CTA leaves while a peer reads it
}

template <typename T>
int launch_sweep(const void* cand, const void* wl, void* energy, void* latency,
                 void* feasible, int64_t w, int64_t n, const SweepParams* p,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((n + kSweepThreads - 1) / kSweepThreads), (unsigned)w);
  dse_sweep_kernel<T><<<grid, kSweepThreads, 0, (cudaStream_t)stream>>>(
      (const T*)cand, (const T*)wl, (T*)energy, (T*)latency,
      (uint8_t*)feasible, n, *p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_screen(const void* energy, const void* latency,
                  const void* feasible, void* keep, void* n_surv, void* n_feas,
                  void* ref_e, void* ref_l, int64_t w, int64_t n,
                  const ScreenParams* sp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  screen_rows_kernel<T><<<(unsigned)w, kScreenThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)energy, (const T*)latency, (const uint8_t*)feasible,
      (uint8_t*)keep, (long long*)n_surv, (long long*)n_feas, (T*)ref_e,
      (T*)ref_l, n, *sp);
  return (int)cudaGetLastError();
}


// the fused kernel instance that takes `threads` threads: 512 at most (up to
// 128 registers a thread), or 1024 (64 registers); null past that
template <typename T>
using FusedKernel = void (*)(const T*, const T*, long long*, long long*, T*,
                             T*, long long*, T*, T*, int64_t, int, int64_t,
                             FusedParams);

template <typename T>
FusedKernel<T> fused_kernel(int threads) {
  if (threads <= 512) return k1_sweep_reduce_kernel<T, 512>;
  if (threads <= 1024) return k1_sweep_reduce_kernel<T, 1024>;
  return nullptr;
}

// the dynamic shared memory and the non-portable cluster size each
// instance was last allowed on each device, so they are set once
constexpr int kMaxDevices = 64;

// the fused kernel's launch configuration, checked; 0 or an error code
template <typename T>
int fused_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                 FusedKernel<T>* kern_out, int device, int64_t w, int64_t n,
                 int clusters, int lanes, int threads, int64_t smem,
                 void* stream) {
  const FusedKernel<T> kern = fused_kernel<T>(threads);
  if (kern == nullptr || w < 1 || w > 65535 || n < 1 || n >= INT_MAX
      || clusters < 1 || clusters > kMaxCluster || threads < 32
      || threads % 32 || lanes < 1 || (int64_t)clusters * lanes < n
      || smem < fused_smem<T>(lanes) || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  static int64_t smem_allowed[2][kMaxDevices];
  static bool wide_allowed[2][kMaxDevices];
  const int slot = threads > 512 ? 1 : 0;
  cudaError_t err;
  if (smem > smem_allowed[slot][device]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed[slot][device] = smem;
  }
  if (clusters > kPortableCluster && !wide_allowed[slot][device]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    wide_allowed[slot][device] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)clusters, (unsigned)w, 1);
  cfg->blockDim = dim3((unsigned)threads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *kern_out = kern;
  return 0;
}

template <typename T>
int launch_fused(const void* cand, const void* wl, void* n_surv, void* n_feas,
                 void* ref_e, void* ref_l, void* surv_idx, void* surv_e,
                 void* surv_l, int64_t w, int64_t n, int64_t k, int clusters,
                 int lanes, int threads, int64_t smem, const FusedParams* fp,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  FusedKernel<T> kern;
  int code = fused_config<T>(&cfg, attr, &kern, device, w, n, clusters, lanes,
                             threads, smem, stream);
  if (code != 0) return code;
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)cand, (const T*)wl,
                           (long long*)n_surv, (long long*)n_feas, (T*)ref_e,
                           (T*)ref_l, (long long*)surv_idx, (T*)surv_e,
                           (T*)surv_l, n, lanes, k, *fp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int fused_max_clusters(int64_t w, int64_t n, int clusters, int lanes,
                       int threads, int64_t smem, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  FusedKernel<T> kern;
  int code = fused_config<T>(&cfg, attr, &kern, device, w, n, clusters, lanes,
                             threads, smem, nullptr);
  if (code != 0) return code;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kern, &cfg);
}

}  // namespace

extern "C" {

int dse_sweep_f64(const void* cand, const void* wl, void* energy,
                  void* latency, void* feasible, int64_t w, int64_t n,
                  const SweepParams* p, int device, void* stream) {
  return launch_sweep<double>(cand, wl, energy, latency, feasible, w, n, p,
                              device, stream);
}

int dse_sweep_f32(const void* cand, const void* wl, void* energy,
                  void* latency, void* feasible, int64_t w, int64_t n,
                  const SweepParams* p, int device, void* stream) {
  return launch_sweep<float>(cand, wl, energy, latency, feasible, w, n, p,
                             device, stream);
}

int screen_rows_f64(const void* energy, const void* latency,
                    const void* feasible, void* keep, void* n_surv,
                    void* n_feas, void* ref_e, void* ref_l, int64_t w,
                    int64_t n, const ScreenParams* sp, int device,
                    void* stream) {
  return launch_screen<double>(energy, latency, feasible, keep, n_surv, n_feas,
                               ref_e, ref_l, w, n, sp, device, stream);
}

int screen_rows_f32(const void* energy, const void* latency,
                    const void* feasible, void* keep, void* n_surv,
                    void* n_feas, void* ref_e, void* ref_l, int64_t w,
                    int64_t n, const ScreenParams* sp, int device,
                    void* stream) {
  return launch_screen<float>(energy, latency, feasible, keep, n_surv, n_feas,
                              ref_e, ref_l, w, n, sp, device, stream);
}

#define K1_FUSED_ARGS                                                        \
  const void *cand, const void *wl, void *n_surv, void *n_feas,             \
      void *ref_e, void *ref_l, void *surv_idx, void *surv_e, void *surv_l, \
      int64_t w, int64_t n, int64_t k, int clusters, int lanes, int threads, \
      int64_t smem, const FusedParams *fp, int device, void *stream
#define K1_FUSED_PASS                                                        \
  cand, wl, n_surv, n_feas, ref_e, ref_l, surv_idx, surv_e, surv_l, w, n, k, \
      clusters, lanes, threads, smem, fp, device, stream

int sweep_reduce_f64(K1_FUSED_ARGS) {
  return launch_fused<double>(K1_FUSED_PASS);
}

int sweep_reduce_f32(K1_FUSED_ARGS) {
  return launch_fused<float>(K1_FUSED_PASS);
}

// cudaOccupancyMaxActiveClusters of the fused kernel at this configuration
int sweep_reduce_max_clusters(int is_f64, int64_t w, int64_t n, int clusters,
                              int lanes, int threads, int64_t smem,
                              int device, int* out) {
  return is_f64 ? fused_max_clusters<double>(w, n, clusters, lanes, threads,
                                             smem, device, out)
                : fused_max_clusters<float>(w, n, clusters, lanes, threads,
                                            smem, device, out);
}

const char* dse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
