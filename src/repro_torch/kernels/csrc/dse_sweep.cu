// Fused DSE campaign sweep for NVIDIA Hopper (sm_90a): two hand-written kernels.
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
//   three times (the re-reads come from L2).  That is accepted for now; a
//   split-row version with a second pass is the obvious next step for wide
//   tiles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSweepThreads = 256;
constexpr int kScreenThreads = 1024;
constexpr int kProbes = 8;

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

template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
dse_sweep_kernel(const T* __restrict__ cand, const T* __restrict__ wl,
                 T* __restrict__ energy, T* __restrict__ latency_out,
                 uint8_t* __restrict__ feasible, int64_t n, SweepParams p) {
  const int64_t lane = (int64_t)blockIdx.x * kSweepThreads + threadIdx.x;
  if (lane >= n) return;
  const int64_t w = blockIdx.y;

  const T* wrow = wl + w * W_COUNT;
  const T flops = wrow[W_FLOPS], hbm_b = wrow[W_HBM], wire_b = wrow[W_WIRE];
  const T bc = wrow[W_BASE_CHIPS], state_gb = wrow[W_STATE_GB];

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
  const T r = bc / nc;
  const T ring_base = tmax((bc - T(1)) / bc, T(1e-9));
  const T flops_s = flops * r;
  const T hbm_s = hbm_b * r;
  const T payload = wire_b * r / ring_base;

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

const char* dse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
