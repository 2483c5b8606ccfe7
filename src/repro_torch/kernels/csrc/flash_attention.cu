// Flash-attention forward for NVIDIA Hopper (sm_90a), BSHD layout.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers), WITH FMA contraction and without --use_fast_math: the
// kernel is held to its plain version by a tolerance, and exp2f / expf keep
// their accurate (2 ulp) forms.  Every entry point takes raw device
// pointers, element strides and the caller's CUDA stream, launches on that
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().
//
// ---------------------------------------------------------------------------
// flash_attention   replaces the TPU kernel
//                   repro/kernels/flash_attention.py::_flash_kernel
//
//   o[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h, :] . k[b, j, h/G, :])
//                   * v[b, j, h/G, :],   G = H / KV,
//   over j <= i when causal, over all j < S otherwise.
//     in : q [B, S, H, hd], k [B, S, KV, hd], v [B, S, KV, hv] (T, any
//          strides with the last dimension dense, 16-byte aligned rows)
//     out: o [B, S, H, hv] (T)
//
//   The TPU kernel runs a (B*H, q-block, kv-block) grid with the kv axis
//   sequential on one core, carrying the running max m, the running sum l
//   and the float32 accumulator in VMEM scratch across grid steps; blocks
//   above the diagonal are skipped and the diagonal block is masked by
//   position.  Here one block owns one (q-block, b*h) pair for its whole
//   life and the kv-block loop runs inside it, so m, l and the accumulator
//   stay in registers (shared memory for the float32 version's m and l) and
//   nothing is carried between blocks.  Under causal the loop stops at the
//   last kv block a query row of the block can see.  The reference's GQA
//   head expansion (jnp.repeat of K and V) and its [B*H, S, hd] transposes
//   are gone: the block reads q, k, v in place and indexes the kv head as
//   h / (H / KV).  The reference's S % block == 0 rule is gone too: query
//   rows and keys past S are loaded as zeros, keys past S are masked and
//   rows past S are not stored.  Constants kept: NEG_INF = -1e30 (finite,
//   not -inf), the denominator clamped at 1e-30, l = l * corr + sum(p),
//   acc = acc * corr + p @ v, o = acc / max(l, 1e-30).
//
//   Bound on an H100: operations.  For a causal prefill the kernel does
//   2 * B * H * S(S+1)/2 * (hd + hv) flops on (q, k, v, o) bytes: at
//   stablelm-1.6b's B=1, S=4096, H=32, hd=hv=64 that is 68.7 GFLOP on
//   34 MB, about 2,000 flops per byte, far above the card's ridge point
//   (~295 in bf16).  So bf16 runs on the tensor cores from this first
//   version: flash_bf16_kernel issues mma.sync.aligned.m16n8k16 bf16 x bf16
//   -> f32 (inline PTX), four warps per 64-query block, each warp owning 16
//   query rows.  S = Q K^T is accumulated in registers as mma C fragments;
//   the online softmax runs on those fragments (row max / sum over the four
//   lanes of a quad by shuffles); P is rounded to bf16 and re-used directly
//   as the A fragment of the P V product (the C layout of two adjacent
//   n-tiles is the A layout of one k-step), so P never touches shared
//   memory.  K and V tiles of 64 keys are double-buffered in shared memory
//   by cp.async (the next tile is in flight while this one is multiplied
//   out), kept row-major with rows padded by 8 elements, and read into mma
//   fragments by ldmatrix (.trans for V), which hits 32 distinct banks.
//   Scores are scaled by scale * log2(e) and exponentiated with exp2f.
//   What this version leaves for later: wgmma + TMA, warp specialisation.
//
//   float32 (flash_f32_kernel) runs on the CUDA cores (67 TFLOP/s peak):
//   256 threads per 64-query block, S = Q K^T as a 4x4 register tile per
//   thread from k-major shared tiles, the scores and probabilities in
//   shared memory, the row statistics by four threads per row, and the
//   accumulator as a 4 x (hv/16) register tile per thread.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMinDenom = 1e-30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, KV;
  int64_t qs_b, qs_s, qs_h;  // element strides of q, k, v, o
  int64_t ks_b, ks_s, ks_h;
  int64_t vs_b, vs_s, vs_h;
  int64_t os_b, os_s, os_h;
  float scale;
  int causal;
};

// the q-block of this block: under causal the heaviest (last) q-blocks go
// first, so the long kv loops start early and the short ones fill the tail
__device__ __forceinline__ int q_block(const Params& p) {
  return p.causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
}

// --- bf16: tensor cores ------------------------------------------------------

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per kv tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of row padding (16 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and each lane receives (row lane/4, columns 2(lane%4), +1) of each: the
// mma.sync fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed: each lane receives (rows 2(lane%4), +1,
// column lane/4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&t);
}

// d += a (16x16, row-major fragment) * b (16x8, column-major fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD, int HV>
constexpr int bf16_smem_bytes() {
  return (kBQ * (HD + kPad) + 2 * kBK * (HD + kPad) + 2 * kBK * (HV + kPad)) *
         2;
}

template <int HD, int HV>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(const Params p) {
  static_assert(HD % 16 == 0 && HV % 16 == 0, "mma / ldmatrix tile shapes");
  constexpr int LDQ = HD + kPad, LDK = HD + kPad, LDV = HV + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LDQ]
  bf16* Ks = Qs + kBQ * LDQ;                      // [2][kBK][LDK]
  bf16* Vs = Ks + 2 * kBK * LDK;                  // [2][kBK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group / thread in group
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix matrix / row
  const int q0 = q_block(p) * kBQ;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.qs_b + h * p.qs_h;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  bf16* op = static_cast<bf16*>(p.o) + b * p.os_b + h * p.os_h;

  // one kv tile into buffer `buf` (keys past S zero-filled)
  auto load_kv = [&](int kb, int buf) {
    const int k0 = kb * kBK;
    bf16* kd = Ks + buf * kBK * LDK;
    bf16* vd = Vs + buf * kBK * LDV;
    for (int i = tid; i < kBK * (HD / 8); i += kThreads) {
      const int r = i / (HD / 8), c = i % (HD / 8);
      const bool ok = k0 + r < p.S;
      cp_async16(kd + r * LDK + c * 8, ok ? kp + (k0 + r) * p.ks_s + c * 8 : kp,
                 ok);
    }
    for (int i = tid; i < kBK * (HV / 8); i += kThreads) {
      const int r = i / (HV / 8), c = i % (HV / 8);
      const bool ok = k0 + r < p.S;
      cp_async16(vd + r * LDV + c * 8, ok ? vp + (k0 + r) * p.vs_s + c * 8 : vp,
                 ok);
    }
  };

  // the Q tile (rows past S zero-filled) travels with kv tile 0
  for (int i = tid; i < kBQ * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    const bool ok = q0 + r < p.S;
    cp_async16(Qs + r * LDQ + c * 8, ok ? qp + (q0 + r) * p.qs_s + c * 8 : qp,
               ok);
  }
  load_kv(0, 0);
  cp_async_commit();

  const int rw = warp * 16 + g;  // this thread's rows: rw and rw + 8
  uint32_t qa[HD / 16][4];       // A fragments of this warp's 16 Q rows
  float oacc[HV / 8][4];
#pragma unroll
  for (int n = 0; n < HV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 domain
  float l[2] = {0.0f, 0.0f};        // this thread's share of the running sum
  const float sl2 = p.scale * kLog2e;
  const int kv_end = p.causal ? min(q0 + kBQ, p.S) : p.S;
  const int n_kv = (kv_end + kBK - 1) / kBK;

  for (int kb = 0; kb < n_kv; ++kb) {
    // the next tile is in flight while this one is multiplied out
    if (kb + 1 < n_kv) {
      load_kv(kb + 1, (kb + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * LDQ + kk * 16 +
                                (lane >> 4) * 8);
    }
    const bf16* Kb = Ks + (kb & 1) * kBK * LDK;
    const bf16* Vb = Vs + (kb & 1) * kBK * LDV;
    const int k0 = kb * kBK;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys);
    // one ldmatrix.x4 gives the B fragments of two n-tiles
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kb + (np * 16 + (mi >> 1) * 8 + mr) * LDK + kk * 16 +
                            (mi & 1) * 8);
        mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
      }

    // scale, mask (diagonal tiles and keys past S only), row max
    const bool masked = (k0 + kBK > p.S) || (p.causal && k0 + kBK - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (masked) {
          const int row = q0 + rw + (e >> 1) * 8;
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          if (key >= p.S || (p.causal && key > row)) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = pe;
        rs[e >> 1] += pe;
      }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < HV / 8; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }

    // O += P V: the C fragments of n-tiles 2j and 2j+1 are the A fragment
    // of k-step j (keys [16 j, 16 j + 16)); one ldmatrix.x4.trans of the
    // row-major V tile gives the B fragments of two 8-column tiles of O
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HV / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vb + (j * 16 + (mi & 1) * 8 + mr) * LDV +
                                  dp * 16 + (mi >> 1) * 8);
        mma_bf16(oacc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  // l over the quad, then o = acc / max(l, 1e-30), rounded to bf16 once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], kMinDenom);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rw + i * 8;
    if (row >= p.S) continue;
    bf16* orow = op + row * p.os_s;
#pragma unroll
    for (int n = 0; n < HV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
          pack_bf16(oacc[n][2 * i] / l[i], oacc[n][2 * i + 1] / l[i]);
    }
  }
}

// --- float32: CUDA cores -------------------------------------------------------

constexpr int kFQ = 64;         // query rows per block
constexpr int kFK = 64;         // keys per kv tile
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 rows each
constexpr int kFPad = 4;        // float row padding (keeps float4 alignment)

template <int HD, int HV>
constexpr int f32_smem_bytes() {
  return (HD * (kFQ + kFPad) + HD * (kFK + kFPad) + kFK * (HV + kFPad) +
          kFK * (kFQ + kFPad) + 3 * kFQ) * 4;
}

template <int HD, int HV>
__global__ void __launch_bounds__(kFThreads) flash_f32_kernel(const Params p) {
  static_assert(HD % 4 == 0 && HV % 16 == 0, "tile shapes");
  constexpr int LQ = kFQ + kFPad, LK = kFK + kFPad, LV = HV + kFPad;
  constexpr int LP = kFQ + kFPad;
  constexpr int TN = HV / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float fsm[];
  float* Qt = fsm;               // [HD][LQ], k-major
  float* Kt = Qt + HD * LQ;      // [HD][LK], k-major
  float* Vs = Kt + HD * LK;      // [kFK][LV]
  float* Pt = Vs + kFK * LV;     // [kFK][LP]: scores, then probabilities
  float* m_s = Pt + kFK * LP;    // running max per row
  float* l_s = m_s + kFQ;        // running sum per row
  float* c_s = l_s + kFQ;        // this tile's correction per row

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = q_block(p) * kFQ;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const float* qp = static_cast<const float*>(p.q) + b * p.qs_b + h * p.qs_h;
  const float* kp = static_cast<const float*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const float* vp = static_cast<const float*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  float* op = static_cast<float*>(p.o) + b * p.os_b + h * p.os_h;

  for (int i = tid; i < kFQ * (HD / 4); i += kFThreads) {
    const int r = i / (HD / 4), c = i % (HD / 4);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.S)
      val = *reinterpret_cast<const float4*>(qp + (q0 + r) * p.qs_s + c * 4);
    Qt[(c * 4 + 0) * LQ + r] = val.x;
    Qt[(c * 4 + 1) * LQ + r] = val.y;
    Qt[(c * 4 + 2) * LQ + r] = val.z;
    Qt[(c * 4 + 3) * LQ + r] = val.w;
  }
  if (tid < kFQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int kv_end = p.causal ? min(q0 + kFQ, p.S) : p.S;
  const int n_kv = (kv_end + kFK - 1) / kFK;
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * kFK;
    __syncthreads();  // the previous tile's V and P are consumed
    for (int i = tid; i < kFK * (HD / 4); i += kFThreads) {
      const int r = i / (HD / 4), c = i % (HD / 4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < p.S)
        val = *reinterpret_cast<const float4*>(kp + (k0 + r) * p.ks_s + c * 4);
      Kt[(c * 4 + 0) * LK + r] = val.x;
      Kt[(c * 4 + 1) * LK + r] = val.y;
      Kt[(c * 4 + 2) * LK + r] = val.z;
      Kt[(c * 4 + 3) * LK + r] = val.w;
    }
    for (int i = tid; i < kFK * (HV / 4); i += kFThreads) {
      const int r = i / (HV / 4), c = i % (HV / 4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < p.S)
        val = *reinterpret_cast<const float4*>(vp + (k0 + r) * p.vs_s + c * 4);
      *reinterpret_cast<float4*>(Vs + r * LV + c * 4) = val;
    }
    __syncthreads();

    // scores for rows 4 ty .. 4 ty + 3, keys 4 tx .. 4 tx + 3
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * LQ + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(Kt + d * LK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += av[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty * 4 + i, key = k0 + tx * 4 + j;
        float x = sc[i][j] * p.scale;
        if (key >= p.S || (p.causal && key > row)) x = kNegInf;
        Pt[(tx * 4 + j) * LP + ty * 4 + i] = x;
      }
    __syncthreads();

    // row statistics: four neighbouring lanes per row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kFK / 4; ++kk)
        mx = fmaxf(mx, Pt[(part * (kFK / 4) + kk) * LP + r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kFK / 4; ++kk) {
        float* cell = Pt + (part * (kFK / 4) + kk) * LP + r;
        const float pe = expf(*cell - m_new);
        *cell = pe;
        sum += pe;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float c = expf(m_old - m_new);
        c_s[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V for rows 4 ty .. +3, columns TN tx .. +TN-1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 pq = *reinterpret_cast<const float4*>(Pt + kk * LP + ty * 4);
      const float pv[4] = {pq.x, pq.y, pq.z, pq.w};
      float vv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) vv[j] = Vs[kk * LV + tx * TN + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.S) continue;
    const float den = fmaxf(l_s[ty * 4 + i], kMinDenom);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      op[row * p.os_s + tx * TN + j] = acc[i][j] / den;
  }
}

// --- launch ------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int smem, int threads, int rows_per_block,
           const Params& p, int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (p.S + rows_per_block - 1) / rows_per_block;
  dim3 grid((unsigned)(B * p.H), (unsigned)nq);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD, int HV>
int launch_bf16(const Params& p, int B, int device, void* stream) {
  return launch(flash_bf16_kernel<HD, HV>, bf16_smem_bytes<HD, HV>(),
                kThreads, kBQ, p, B, device, stream);
}

template <int HD, int HV>
int launch_f32(const Params& p, int B, int device, void* stream) {
  return launch(flash_f32_kernel<HD, HV>, f32_smem_bytes<HD, HV>(),
                kFThreads, kFQ, p, B, device, stream);
}

// the (hd, hv) instances: hd, hv in {32, 64, 128}
#define FLASH_DISPATCH(LAUNCH)                                        \
  switch (hd * 1000 + hv) {                                           \
    case 32032: return LAUNCH<32, 32>(p, B, device, stream);          \
    case 32064: return LAUNCH<32, 64>(p, B, device, stream);          \
    case 32128: return LAUNCH<32, 128>(p, B, device, stream);         \
    case 64032: return LAUNCH<64, 32>(p, B, device, stream);          \
    case 64064: return LAUNCH<64, 64>(p, B, device, stream);          \
    case 64128: return LAUNCH<64, 128>(p, B, device, stream);         \
    case 128032: return LAUNCH<128, 32>(p, B, device, stream);        \
    case 128064: return LAUNCH<128, 64>(p, B, device, stream);        \
    case 128128: return LAUNCH<128, 128>(p, B, device, stream);       \
    default: return (int)cudaErrorInvalidValue;                       \
  }

Params make_params(const void* q, const void* k, const void* v, void* o,
                   int S, int H, int KV, const long long* st, float scale,
                   int causal) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.S = S; p.H = H; p.KV = KV;
  p.qs_b = st[0]; p.qs_s = st[1]; p.qs_h = st[2];
  p.ks_b = st[3]; p.ks_s = st[4]; p.ks_h = st[5];
  p.vs_b = st[6]; p.vs_s = st[7]; p.vs_h = st[8];
  p.os_b = st[9]; p.os_s = st[10]; p.os_h = st[11];
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, seq, head) of q, k, v, o in order
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int KV, int hd, int hv,
                         const long long* strides, float scale, int causal,
                         int device, void* stream) {
  const Params p = make_params(q, k, v, o, S, H, KV, strides, scale, causal);
  FLASH_DISPATCH(launch_bf16)
}

int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int hd, int hv,
                        const long long* strides, float scale, int causal,
                        int device, void* stream) {
  const Params p = make_params(q, k, v, o, S, H, KV, strides, scale, causal);
  FLASH_DISPATCH(launch_f32)
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
