// Flash-attention backward for NVIDIA Hopper (sm_90a), BSHD layout.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -Xptxas -v
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers), with FMA contraction and without --use_fast_math (the
// kernels are held to their plain version by a tolerance; the float32
// kernels' expf keeps its accurate form, the bf16 kernels' ex2.approx is as
// accurate as exp2f, 2 ulp, but flushes results below 2^-126).  Every entry
// point takes raw device pointers, element strides, the launch plan and the
// caller's CUDA stream, launches on that stream, does not synchronise,
// allocates nothing, and returns a CUDA error code: cudaErrorInvalidValue
// for a plan, shape or tensor map it refuses, else cudaGetLastError().
//
// ---------------------------------------------------------------------------
// K3 backward   the gradient of the TPU kernel
//   repro/kernels/flash_attention.py::_flash_kernel (the reference defines
//   none: it trains through its XLA attention, repro/models/layers.py
//   flash_attention, and jax.vjp differentiates that)
//
//   Given q [B, S, H, D], k, v [B, S, KV, D], the forward's o [B, S, H, D]
//   and row log-sum-exp lse [B, H, S] (flash_attention.cu's *_lse entry
//   points), and do = dL/do [B, S, H, D], with G = H / KV:
//     D_i   = sum_d do[i, d] o[i, d]                       (float32)
//     P_ij  = exp(scale q_i . k_j - lse_i), 0 for j > i when causal
//     dV_j  = sum_{h in group} sum_i P_ij do_i
//     dP_ij = do_i . v_j
//     dS_ij = P_ij (dP_ij - D_i) scale
//     dQ_i  = sum_j dS_ij k_j
//     dK_j  = sum_{h in group} sum_i dS_ij q_i
//   out: dq [B, S, H, D], dk, dv [B, S, KV, D] in the input type.
//
//   Bound on an H100: operations.  Per (b, h) the backward needs five
//   products over the causally visible pairs -- S again, dP, dV, dQ, dK --
//   2 * pairs * 5 * D flops, 2.5 times the forward's: at stablelm-1.6b's
//   B=1, S=4096, H=32, D=64 that is 171.8 GFLOP on ~50 MB, far above the
//   card's ridge point (0.174 ms at 989 TFLOP/s).  The only way to the
//   tensor cores' full rate is wgmma fed by loads that cost the multiplying
//   threads nothing, and at D = 64 the exponentials (one per pair, on the
//   SFU) weigh nearly as much as the products.
//
//   Two passes, no float atomics, so two runs are bitwise equal: a dQ
//   kernel (which also writes D and lse * log2(e) to a float32 scratch),
//   then a dK / dV kernel.  Each pass recomputes S and dP, so the call does
//   seven products where five are needed (floor 0.243 ms at stablelm), but
//   every product takes its A operand from shared memory or from registers
//   (the C fragment of one m64 product is the A fragment of the next, so P
//   and dS never touch shared memory), and GQA's sums over a group's heads
//   stay inside one block.  The fused alternative -- one pass over key
//   blocks that also writes float32 dQ partials per key block, summed in
//   a second, deterministic pass -- writes and reads back 67,584 rows x 32
//   heads x 64 x 4 B = 554 MB at stablelm (~0.33 ms of HBM), more than the
//   two products it saves; adding dQ with float atomics instead would break
//   the bitwise equality of two runs that training's resume relies on.
//
//   The launch plan -- tiles, ring depths, the persistent grids and the
//   schedule of work items over their blocks -- is made in Python
//   (repro_torch/kernels/flash_attention.py, plan_bwd()).  The entry points
//   check that a plan fits the shape and obey it; they choose nothing.
//
//   flash_bwd_dq_bf16_tc_kernel<D>, flash_bwd_dkdv_bf16_tc_kernel<D>   bf16,
//     D in {64, 128}, K3's forward (flash_attention.cu,
//     flash_bf16_tc_kernel) with its roles turned around.  Persistent: one
//     384-thread block an SM walks the work items the plan's schedule gives
//     it (a list per block, heaviest first, longest-processing-time
//     assignment, so the causal grid's 32:1 spread of work evens out).
//     Warpgroup 0 loads: it drops to 24 registers (setmaxnreg) and one of
//     its threads issues every TMA copy, over 4-D tensor maps (hd, heads,
//     S, B) of q, do, k, v as they lie, 64-column boxes in the 128-byte
//     swizzle; TMA's zero fill covers rows and keys past S.  Warpgroups 1
//     and 2 rise to 240 registers; each owns 64 rows (dQ) or 64 keys (dK /
//     dV) of the item and they take turns to issue their products (named
//     barriers 1 and 2), so one's exponentials run under the other's
//     products.
//     dQ: an item is 128 query rows of one (b, h).  Their Q and dO tiles
//       (two slots, so the next item's load under this one) stay while K
//       and V tiles (128 keys at D = 64, 64 at D = 128, so that S, dP and
//       dQ fit the registers) stream through a ring of full / empty
//       mbarriers, from the diagonal down.  Per kv tile, S = Q K^T and
//       dP = dO V^T by wgmma.m64nNk16 from shared memory (K and V as
//       stored are K-major B operands), P = 2^(S scale log2 e - lse log2 e)
//       and dS / scale = P (dP - D) on the fragments, masked by selects
//       only on tiles that hold the diagonal or keys past S; dQ / scale +=
//       (dS / scale) K by wgmma with dS rounded to bf16 in registers and K
//       as an MN-major B (imm-trans-b = 1); the scale multiplies dQ once,
//       at the store (dK likewise).  The products of tile j issue
//       together with dQ of tile j - 1, so P and dS of one tile run under
//       the other's products.  D of the item's rows comes from o and do in
//       device memory before the loop.
//     dK / dV: an item is 128 keys of one (b, kv head): its K and V tiles
//       (two slots) stay while the group's G heads' Q and dO tiles of 64
//       query rows, with their lse * log2 e and D (a bulk copy from the dQ
//       kernel's scratch, padded to whole 128-row tiles so every copy is
//       aligned), stream through the ring, each head from the first q tile
//       that sees the item's keys.  S^T = K Q^T and dP^T = V dO^T from
//       shared memory, P^T and dS^T on the fragments (lse and D are per
//       column here: read from shared memory), dV += P^T dO and dK +=
//       dS^T Q with A from registers and dO, Q as MN-major B.  At D = 64
//       the products of q tile i issue together with dV and dK of tile
//       i - 1 (at D = 128 the registers do not hold both).  dK and dV stay
//       in registers across the group's heads and are stored once.
//   flash_bwd_dq_f32_tc_kernel<D>, flash_bwd_dkdv_f32_tc_kernel<D>   float32,
//     D in {64, 128}: every product -- S and dP in both kernels, dQ, dV, dK
//     -- on the tensor cores as 3xTF32 (mma.sync m16n8k8; each operand split
//     as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), each product lo hi
//     + hi lo + hi hi, the small terms first, into a float32 accumulator;
//     the helpers are hopper.cuh's, which K4 shares).  That is
//     float32-accurate to ~1e-6 relative, inside every float32 gate, so the
//     kernels ignore torch.backends.cuda.matmul.allow_tf32: one-pass TF32
//     keeps ~3 decimal digits, which a gate of 1e-4 of scale does not
//     allow.  They replace kernels that ran every product on the CUDA
//     cores, a serial fmaf chain out of shared memory for each score.
//     Bound: operations.  The 5 products at 3xTF32 (495 / 3 TFLOP/s) take
//     1.04 ms at stablelm-1.6b's B=1 S=4096 H=32 D=64 and 0.65 ms at
//     qwen3-14b's B=1 S=2048 H=40 KV=8 D=128; the 7 of the two passes 1.46
//     / 0.91 ms (the CUDA cores' 67 TFLOP/s: 2.57 / 1.60 ms for 5).
//     mma.sync reaches the tensor cores at well under wgmma's rate, and
//     each product here costs three of them, the splits and the fragment
//     loads, all executed by the warp; wgmma (TF32 from shared memory,
//     K-major operands only) is the route past that.
//     Items are 64 query rows (dQ) or 64 keys (dK / dV), one block each; the
//     grid lists them heaviest first, so the hardware, handing blocks out in
//     order, deals them longest first.  The item's resident tiles (Q and
//     dO, or K and V) load once; the streamed ones (K and V, or the head's
//     Q and dO with their lse and D) of f32_step rows come through a ring of
//     two slots by 16-byte cp.async, the next tile under this one's
//     products.  Shared rows of D + 4 floats keep both reads of a tile
//     conflict-free.  The accumulator fragment of S or dP is the A fragment
//     of the next product once the reduction index is relabelled (relabel_a,
//     frag_b), so P and dS stay in registers where the warp that made them
//     uses them.  Operands are split as they are read from shared memory.
//     Each 16 x 8 block of dQ, dK or dV adds a tile's sum, made in a fresh
//     accumulator, in float32: mma.sync's accumulation truncates, and over a
//     whole row of S = 4096 it drifted to ~1e-4 of scale.  A warp skips a
//     tile the causal mask hides from all its rows; the diagonal tile and
//     keys (rows) past S are masked by selects, past S even when not causal
//     (a zero K gives P = e^-lse, not 0).
//     dQ: 4 warps, warp w owns rows 16 w .. 16 w + 15 and computes S, dP,
//       P, dS and dQ for them; it also writes D of its rows to the scratch.
//     dK / dV: 8 warps; warps 2 w and 2 w + 1 share keys 16 w .. 16 w + 15.
//       The first computes S^T and P^T, hands P^T to the second through
//       shared memory and adds P^T dO to dV; the second computes dP^T and
//       dS^T and adds dS^T Q to dK.  Each warp holds one accumulator (dK and
//       dV together are 128 registers a thread at D = 128) and runs 2 of the
//       4 products.  An item is one head: one that walked a GQA group's G
//       heads in turn set the pass's time (qwen3's 256 such items on 132
//       SMs), so with GQA each item writes float32 partials and
//       flash_bwd_dkdv_sum_f32_kernel adds a group's G of them in head
//       order.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// strides: (batch, seq, head) element strides of each tensor, in this order
enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, S]
  // float32: D [B, H, S], written by the dQ kernel.  bf16: D [B * H,
  // s_pad] and lse2 = lse * log2(e) [B * H, s_pad], written by the dQ
  // kernel (0 on the rows past S)
  float* dd;
  float* lse2;
  void* dq;
  void* dk;
  void* dv;
  int S, H, KV;
  int s_pad;             // bf16: S rounded up to whole 128-row tiles
  const int* sched_dq;   // bf16: each kernel's schedule, offsets [blocks +
  const int* sched_kv;   //   1] then items (flash_attention_bwd_bf16)
  // float32 with H > KV: the dK / dV kernel's per-head partial dK, then
  // dV [B, S, H, D], which flash_bwd_dkdv_sum_f32_kernel sums by group
  float* part;
  int64_t part_half;     // B S H D: where the dV partials start
  int64_t st[3 * kTensors];
  float scale;
  int causal;
};

// a non-negative index as a 64-bit offset, zero-extended: no register has
// to keep its sign word (which, held across a loop, can cost a spill)
__device__ __forceinline__ int64_t u64(int i) { return (int64_t)(uint32_t)i; }

// the (b, head) base of tensor T and its row stride
template <typename E, int T>
__device__ __forceinline__ E* base(const Params& p, const void* ptr, int b,
                                   int head) {
  return const_cast<E*>(static_cast<const E*>(ptr)) + u64(b) * p.st[3 * T] +
         u64(head) * p.st[3 * T + 2];
}
template <int T>
__device__ __forceinline__ int64_t row_stride(const Params& p) {
  return p.st[3 * T + 1];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&t);
}

// --- bf16, wgmma ----------------------------------------------------------------

// 2^x by the SFU (ex2.approx: 2 ulp, as exp2f's; results below 2^-126
// flushed to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// `bytes` (a multiple of 16) global -> shared by the bulk-copy engine,
// completing on `bar` like a TMA load
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// named barriers for the consumers' turns (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// C[64 x 64] (=|+)= A[64 x 16] (K-major, descriptor da) * B[64 x 16]^T
// (K-major, descriptor db); scale_d = 0 overwrites C
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// C[64 x 64] += A[64 x 16] (registers: the m16n8k16 A fragment of each
// warp's 16 rows) * B[16 x 64] (MN-major, descriptor db, imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// C[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[64 x D] += A (registers) * B[16 x D] (MN-major)
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_m64n64k16(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n128k16(d, a, db);
}

// S[64 x 128] (=|+)= A[64 x 16] (K-major) * B[128 x 16]^T (K-major)
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// C[64 x N] (=|+)= A (K-major) * B^T (K-major), N keys or query rows
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_m64n64k16(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_m64n128k16(d, da, db, scale_d);
}

constexpr int kThreads = 384;       // loader warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kRows = 128;          // dQ: query rows an item; dK / dV: keys
constexpr int kStep = 64;           // dK / dV: query rows a q tile
constexpr int kBoxBig = kRows * 128;   // a 64-column box of a 128-row tile
constexpr int kBoxStep = kStep * 128;  // of a 64-row tile
// kRows == 2 kStep keeps every q tile of the dK / dV ring on a 128-row
// boundary of the items: the scratch's padding, the causal first q tile
static_assert(kRows == 2 * kStep, "tile sizes");

// the dQ kernel's kv tile: 128 keys at D = 64 (S and dP take 64 + 64
// registers a thread beside dQ's 32), 64 at D = 128 (dQ takes 64)
template <int D>
__host__ __device__ constexpr int dq_step() {
  return D == 64 ? 128 : 64;
}
// ring slots of each kernel (the budget of 227 KB decides)
template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D == 64 ? 4 : 3;
}
template <int D>
__host__ __device__ constexpr int dkdv_stages() {
  return D == 64 ? 4 : 3;
}

// shared memory: 1 KiB to align the base to the swizzle's 1024-byte period,
// two item slots of Q and dO, the ring of K and V tiles, the barriers
template <int D>
constexpr int dq_smem_bytes() {
  return 1024 + 2 * 2 * (D / 64) * kBoxBig +
         dq_stages<D>() * 2 * (D / 64) * dq_step<D>() * 128 +
         (4 + 4 * dq_stages<D>()) * 8;
}
// two item slots of K and V; the ring of Q and dO tiles with their 64 lse2
// and D values; the barriers
template <int D>
constexpr int dkdv_smem_bytes() {
  return 1024 + 2 * 2 * (D / 64) * kBoxBig +
         dkdv_stages<D>() * (2 * (D / 64) * kBoxStep + 2 * kStep * 4) +
         (4 + 2 * dkdv_stages<D>()) * 8;
}
static_assert(dq_smem_bytes<64>() <= 232448 && dq_smem_bytes<128>() <= 232448,
              "a block's shared memory is 227 KB");
static_assert(dkdv_smem_bytes<64>() <= 232448 &&
                  dkdv_smem_bytes<128>() <= 232448,
              "a block's shared memory is 227 KB");

// accumulator fragment of a warpgroup's m64 product: thread t holds rows
// 16 (t / 32) + (t % 32) / 4 and + 8, columns 8 n + 2 (t % 4) + {0, 1} in
// [4 n + {0, 1}] and [4 n + {2, 3}].  The C fragments of column groups 2 j
// and 2 j + 1 are the A fragment of k-step j of the next product.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const Params p) {
  static_assert(D == 64 || D == 128, "head dims of the wgmma kernels");
  constexpr int BN = dq_step<D>();
  constexpr int stages = dq_stages<D>();
  constexpr int kBoxK = BN * 128;             // a 64-column box of K or V
  constexpr int kTileQ = (D / 64) * kBoxBig;  // Q or dO of an item
  constexpr int kTileK = (D / 64) * kBoxK;    // a K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                   // [2][kTileQ]
  uint8_t* sdO = sQ + 2 * kTileQ;       // [2][kTileQ]
  uint8_t* sK = sdO + 2 * kTileQ;       // [stages][kTileK]
  uint8_t* sV = sK + stages * kTileK;   // [stages][kTileK]
  uint64_t* t_full = reinterpret_cast<uint64_t*>(sV + stages * kTileK);
  uint64_t* t_empty = t_full + 2;
  uint64_t* k_full = t_empty + 2;
  uint64_t* k_empty = k_full + stages;
  uint64_t* v_full = k_empty + stages;
  uint64_t* v_empty = v_full + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&t_full[i], 1);  // the loader's expect_tx
      mbar_init(&t_empty[i], kConsumerWarps);  // one lane per warp
    }
    for (int st = 0; st < stages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], kConsumerWarps);
      mbar_init(&v_empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's items: (b * H + h) * nq + q-block, heaviest first
  const int nq = (p.S + kRows - 1) / kRows;
  const int first = p.sched_dq[blockIdx.x];
  const int n_mine = p.sched_dq[blockIdx.x + 1] - first;
  const int* items = p.sched_dq + gridDim.x + 1 + first;
  auto kv_tiles = [&](int qb) {
    const int kv_end = p.causal ? min((qb + 1) * kRows, p.S) : p.S;
    return (kv_end + BN - 1) / BN;
  };

  if (tid < 128) {
    // ---- loader: one thread issues every copy; the K / V ring runs on
    // across this block's items ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_do);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      int ring = 0;
      for (int j = 0; j < n_mine; ++j) {
        const int item = items[j];
        const int bh = item / nq, qb = item % nq;
        const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
        const int n_kv = kv_tiles(qb);
        const int slot = j & 1;
        mbar_wait(&t_empty[slot], ((j >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&t_full[slot], 2 * kTileQ);
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc) {
          tma_load_4d(sQ + slot * kTileQ + cc * kBoxBig, &tm_q, &t_full[slot],
                      64 * cc, h, qb * kRows, b);
          tma_load_4d(sdO + slot * kTileQ + cc * kBoxBig, &tm_do,
                      &t_full[slot], 64 * cc, h, qb * kRows, b);
        }
        for (int it = 0; it < n_kv; ++it, ++ring) {
          const int st = ring % stages;
          const uint32_t free_parity = ((ring / stages) & 1) ^ 1;
          const int k0 = (n_kv - 1 - it) * BN;  // from the diagonal down
          mbar_wait(&k_empty[st], free_parity);
          mbar_arrive_expect_tx(&k_full[st], kTileK);
#pragma unroll
          for (int cc = 0; cc < D / 64; ++cc)
            tma_load_4d(sK + st * kTileK + cc * kBoxK, &tm_k, &k_full[st],
                        64 * cc, kvh, k0, b);
          mbar_wait(&v_empty[st], free_parity);
          mbar_arrive_expect_tx(&v_full[st], kTileK);
#pragma unroll
          for (int cc = 0; cc < D / 64; ++cc)
            tma_load_4d(sV + st * kTileK + cc * kBoxK, &tm_v, &v_full[st],
                        64 * cc, kvh, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [q0 + 64 cw, q0 + 64 cw + 64) of
  // each item ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = tid / 128 - 1;
  const int t = tid & 127, lane = t & 31, t4 = lane & 3;
  const int frag_row = (t >> 5) * 16 + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  const int seq = p.S;
  const bool causal = p.causal;

  float dq[D / 2];                 // dQ / scale
  float s[BN / 2], dp[BN / 2];     // S then dS / scale; dP
  uint32_t da[BN / 16][4];         // dS / scale in bf16: A fragments of dS K
  float dsum[2], l2[2];            // D and lse * log2 e of the 2 rows
  int row0 = 0, row_lo = 0;
  uint32_t q_addr = 0, do_addr = 0;

  // S = Q K^T and dP = dO V^T of ring slot st, 64 rows x BN keys, D / 16
  // steps of 16 (two boxes at D = 128): K-major, 8-row groups 1 KB apart,
  // the step's 16 columns at +32 bytes inside the swizzled row.  One
  // commit group, not waited for.
  auto issue_sdp = [&](int st) {
    const uint32_t k_addr = smem_u32(sK + st * kTileK);
    const uint32_t v_addr = smem_u32(sV + st * kTileK);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN>(
          s, smem_desc(q_addr + (kk / 4) * kBoxBig + (kk % 4) * 32, 16, 1024),
          smem_desc(k_addr + (kk / 4) * kBoxK + (kk % 4) * 32, 16, 1024),
          kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN>(
          dp,
          smem_desc(do_addr + (kk / 4) * kBoxBig + (kk % 4) * 32, 16, 1024),
          smem_desc(v_addr + (kk / 4) * kBoxK + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
  };
  // dQ += dS K of slot st: K MN-major, key step j at +2 KB, the two 64-wide
  // column boxes of D = 128 one box apart (LBO).  One commit group.
  auto issue_dq = [&](int st) {
    const uint32_t k_addr = smem_u32(sK + st * kTileK);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      wgmma_rs<D>(dq, da[j], smem_desc(k_addr + j * 2048, kBoxK, 1024));
    wgmma_commit();
  };
  // P and dS / scale of kv tile kt (keys [kt BN, kt BN + BN)) in s, from S
  // in s and dP; on a tile with the diagonal or keys past S masked by
  // selects (keys past S must go: TMA zero-filled their K and V, so P
  // there is 2^-lse2, which can overflow)
  auto ds_tile = [&](int k0, auto masked) {
    constexpr bool kMasked = decltype(masked)::value;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pe = fast_exp2(fmaf(s[4 * n + e], sl2, -l2[i]));
        if constexpr (kMasked) {
          const int row = row0 + 8 * i;
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          pe = (key >= seq || (causal && key > row)) ? 0.0f : pe;
        }
        s[4 * n + e] = pe * (dp[4 * n + e] - dsum[i]);
      }
  };
  auto ds_of = [&](int kt) {
    const int k0 = kt * BN;
    if (k0 + BN > seq || (causal && k0 + BN - 1 > row_lo))
      ds_tile(k0, std::true_type());
    else
      ds_tile(k0, std::false_type());
  };
  auto pack_ds = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) c_to_a(da[j], s + 8 * j);
  };
  auto fence_da = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) fence_frag(da[j]);
  };

  // The two consumer warpgroups take turns to issue (named barriers 1 and
  // 2, 256 threads: one warpgroup syncs, the other arrives).  Each issues
  // n_kv + 1 times an item; warpgroup 1 opens warpgroup 0's first turn and
  // gives no turn after its very last.
  const int my_turn = 1 + cw, their_turn = 2 - cw;
  if (cw == 1) bar_arrive(1, 256);

  int ring = 0;  // the K / V slot sequence, as the loader's
  for (int j = 0; j < n_mine; ++j) {
    const int item = items[j];
    const int bh = item / nq, qb = item % nq;
    const int b = bh / p.H, h = bh % p.H;
    const int n_kv = kv_tiles(qb);
    const int slot = j & 1;
    row_lo = qb * kRows + cw * 64;
    row0 = row_lo + frag_row;
    q_addr = smem_u32(sQ + slot * kTileQ) + cw * 64 * 128;
    do_addr = smem_u32(sdO + slot * kTileQ) + cw * 64 * 128;

    // D = rowsum(dO o O) and lse of this thread's two rows: the quad's four
    // threads take D / 4 columns each; written to the scratch for the dK /
    // dV kernel, zeros on the rows past S
    const bf16* op = base<const bf16, kO>(p, p.o, b, h);
    const bf16* dop = base<const bf16, kDO>(p, p.dout, b, h);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      float acc = 0.0f;
      if (row < seq) {
        const uint4* orow = reinterpret_cast<const uint4*>(
            op + row * row_stride<kO>(p) + t4 * (D / 4));
        const uint4* drow = reinterpret_cast<const uint4*>(
            dop + row * row_stride<kDO>(p) + t4 * (D / 4));
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          const uint4 a = orow[c], d = drow[c];
          const uint32_t av[4] = {a.x, a.y, a.z, a.w};
          const uint32_t dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 af = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&av[e]));
            const float2 df = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&dv[e]));
            acc = fmaf(af.x, df.x, acc);
            acc = fmaf(af.y, df.y, acc);
          }
        }
      }
      dsum[i] = quad_sum(acc);
      l2[i] = row < seq ? p.lse[(int64_t)bh * seq + row] * kLog2e : 0.0f;
      if (t4 == 0) {
        const int64_t at = (int64_t)bh * p.s_pad + row;
        p.dd[at] = dsum[i];
        p.lse2[at] = l2[i];
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
    const bool last_item = j + 1 == n_mine;

    // kv tile 0 (the diagonal one under causal): S and dP, then dS
    mbar_wait(&t_full[slot], (j >> 1) & 1);
    {
      const int st = ring % stages;
      mbar_wait(&k_full[st], (ring / stages) & 1);
      mbar_wait(&v_full[st], (ring / stages) & 1);
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_sdp(st);
      bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      if (lane == 0) {
        mbar_arrive(&v_empty[st]);
        if (n_kv == 1) mbar_arrive(&t_empty[slot]);  // Q, dO done
      }
      ds_of(n_kv - 1);
      pack_ds();
    }
    // kv tile it: S and dP of tile it, and dQ += dS K of tile it - 1, in
    // flight together; P and dS of tile it while dQ runs
    for (int it = 1; it < n_kv; ++it) {
      const int r = ring + it;
      const int st = r % stages, pst = (r - 1) % stages;
      mbar_wait(&k_full[st], (r / stages) & 1);
      mbar_wait(&v_full[st], (r / stages) & 1);
      fence_acc(dq);
      fence_da();
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_sdp(st);
      issue_dq(pst);
      bar_arrive(their_turn, 256);
      wgmma_wait<1>();  // S, dP done (groups complete in order)
      fence_acc(s);
      fence_acc(dp);
      if (lane == 0) {
        mbar_arrive(&v_empty[st]);
        if (it == n_kv - 1) mbar_arrive(&t_empty[slot]);  // Q, dO done
      }
      ds_of(n_kv - 1 - it);
      wgmma_wait<0>();  // dQ of the last tile done: its K and dS free
      fence_acc(dq);
      fence_da();
      if (lane == 0) mbar_arrive(&k_empty[pst]);
      pack_ds();
    }
    {
      const int st = (ring + n_kv - 1) % stages;
      fence_acc(dq);
      fence_da();
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_dq(st);
      if (cw == 0 || !last_item) bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc(dq);
      fence_da();
      if (lane == 0) mbar_arrive(&k_empty[st]);
    }
    ring += n_kv;

    bf16* dqp = base<bf16, kDQ>(p, p.dq, b, h);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= seq) continue;
      bf16* out = dqp + row * row_stride<kDQ>(p);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + n * 8 + t4 * 2) =
            pack_bf16(dq[4 * n + 2 * i] * p.scale,
                      dq[4 * n + 2 * i + 1] * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_bf16_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const Params p) {
  static_assert(D == 64 || D == 128, "head dims of the wgmma kernels");
  constexpr int stages = dkdv_stages<D>();
  constexpr int kTileK = (D / 64) * kBoxBig;   // K or V of an item
  constexpr int kTileQ = (D / 64) * kBoxStep;  // a Q or dO tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;                    // [2][kTileK]
  uint8_t* sV = sK + 2 * kTileK;         // [2][kTileK]
  uint8_t* sQ = sV + 2 * kTileK;         // [stages][kTileQ]
  uint8_t* sdO = sQ + stages * kTileQ;   // [stages][kTileQ]
  float* sL = reinterpret_cast<float*>(sdO + stages * kTileQ);  // [stages][64]
  float* sD = sL + stages * kStep;                              // [stages][64]
  uint64_t* t_full = reinterpret_cast<uint64_t*>(sD + stages * kStep);
  uint64_t* t_empty = t_full + 2;
  uint64_t* q_full = t_empty + 2;
  uint64_t* q_empty = q_full + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&t_full[i], 1);
      mbar_init(&t_empty[i], kConsumerWarps);
    }
    for (int st = 0; st < stages; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&q_empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's items: (b * KV + kv head) * nk + key block, heaviest first;
  // each walks the group's G heads, each head over the q tiles of 64 rows
  // from the first that sees the block's keys
  const int nk = (p.S + kRows - 1) / kRows;
  const int nq = (p.S + kStep - 1) / kStep;
  const int G = p.H / p.KV;
  const int first = p.sched_kv[blockIdx.x];
  const int n_mine = p.sched_kv[blockIdx.x + 1] - first;
  const int* items = p.sched_kv + gridDim.x + 1 + first;
  auto first_q = [&](int kb) { return p.causal ? kb * (kRows / kStep) : 0; };

  if (tid < 128) {
    // ---- loader ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_do);
      int ring = 0;
      for (int j = 0; j < n_mine; ++j) {
        const int item = items[j];
        const int bkv = item / nk, kb = item % nk;
        const int b = bkv / p.KV, kvh = bkv % p.KV;
        const int slot = j & 1;
        mbar_wait(&t_empty[slot], ((j >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&t_full[slot], 2 * kTileK);
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc) {
          tma_load_4d(sK + slot * kTileK + cc * kBoxBig, &tm_k, &t_full[slot],
                      64 * cc, kvh, kb * kRows, b);
          tma_load_4d(sV + slot * kTileK + cc * kBoxBig, &tm_v, &t_full[slot],
                      64 * cc, kvh, kb * kRows, b);
        }
        const int qt0 = first_q(kb), per_head = nq - qt0;
        for (int i = 0; i < G * per_head; ++i, ++ring) {
          const int h = kvh * G + i / per_head;
          const int q0 = (qt0 + i % per_head) * kStep;
          const int st = ring % stages;
          mbar_wait(&q_empty[st], ((ring / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&q_full[st], 2 * kTileQ + 2 * kStep * 4);
#pragma unroll
          for (int cc = 0; cc < D / 64; ++cc) {
            tma_load_4d(sQ + st * kTileQ + cc * kBoxStep, &tm_q, &q_full[st],
                        64 * cc, h, q0, b);
            tma_load_4d(sdO + st * kTileQ + cc * kBoxStep, &tm_do,
                        &q_full[st], 64 * cc, h, q0, b);
          }
          const int64_t at = (int64_t)(b * p.H + h) * p.s_pad + q0;
          bulk_load(sL + st * kStep, p.lse2 + at, kStep * 4, &q_full[st]);
          bulk_load(sD + st * kStep, p.dd + at, kStep * 4, &q_full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys [k0 + 64 cw, k0 + 64 cw + 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = tid / 128 - 1;
  const int t = tid & 127, lane = t & 31, t4 = lane & 3;
  const int frag_row = (t >> 5) * 16 + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  const int seq = p.S;

  // At D = 128 the overlap below would hold S^T and dP^T of one q tile
  // beside P^T and dS^T of the other and dK, dV (224 registers a thread):
  // ptxas then serializes the wgmmas and spills, so there a tile's products
  // wait for the last tile's.
  constexpr bool kOverlap = D == 64;
  float dk[D / 2], dv[D / 2];          // dK / scale, dV
  float s[kStep / 2], dp[kStep / 2];   // S^T then P^T; dP^T then dS^T /
                                       // scale: 64 keys x 64 queries
  uint32_t pa[kStep / 16][4], da[kStep / 16][4];  // P^T, dS^T in bf16
  int key0 = 0, key_lo = 0;
  uint32_t k_addr = 0, v_addr = 0;
  auto fence_frags = [&]() {
#pragma unroll
    for (int j = 0; j < kStep / 16; ++j) {
      fence_frag(pa[j]);
      fence_frag(da[j]);
    }
  };
  // S^T = K Q^T and dP^T = V dO^T of ring slot st: A = this warpgroup's 64
  // keys, K-major from the item's tiles; B = the q tile, K-major.  One
  // commit group.
  auto issue_sdpt = [&](int st) {
    const uint32_t q_addr = smem_u32(sQ + st * kTileQ);
    const uint32_t do_addr = smem_u32(sdO + st * kTileQ);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(
          s, smem_desc(k_addr + (kk / 4) * kBoxBig + (kk % 4) * 32, 16, 1024),
          smem_desc(q_addr + (kk / 4) * kBoxStep + (kk % 4) * 32, 16, 1024),
          kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_m64n64k16(
          dp, smem_desc(v_addr + (kk / 4) * kBoxBig + (kk % 4) * 32, 16, 1024),
          smem_desc(do_addr + (kk / 4) * kBoxStep + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
  };
  // dV += P^T dO and dK / scale += (dS^T / scale) Q of slot st: A from
  // registers; B = dO and Q as MN-major, query step j at +2 KB.  One commit
  // group.
  auto issue_dkdv = [&](int st) {
    const uint32_t q_addr = smem_u32(sQ + st * kTileQ);
    const uint32_t do_addr = smem_u32(sdO + st * kTileQ);
#pragma unroll
    for (int j = 0; j < kStep / 16; ++j)
      wgmma_rs<D>(dv, pa[j], smem_desc(do_addr + j * 2048, kBoxStep, 1024));
#pragma unroll
    for (int j = 0; j < kStep / 16; ++j)
      wgmma_rs<D>(dk, da[j], smem_desc(q_addr + j * 2048, kBoxStep, 1024));
    wgmma_commit();
  };
  // P^T into s and dS^T / scale into dp for the q tile at q0 (ring slot
  // st); lse2 and D per column from shared memory; on a tile with the
  // diagonal, P^T = 0 for a key after the query, by selects.  Queries past
  // S need no mask: TMA zero-filled their Q and dO, and the scratch holds
  // 0 for their lse2 and D, so P^T = 1, dP^T = 0 and dS^T = 0 add nothing.
  auto p_ds_tile = [&](int st, int q0, auto masked) {
    constexpr bool kMasked = decltype(masked)::value;
    const float* L = sL + st * kStep;
    const float* Dd = sD + st * kStep;
#pragma unroll
    for (int n = 0; n < kStep / 8; ++n) {
      const int col = n * 8 + t4 * 2;
      const float2 lc = *reinterpret_cast<const float2*>(L + col);
      const float2 dc = *reinterpret_cast<const float2*>(Dd + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = fast_exp2(fmaf(s[4 * n + e], sl2, (e & 1) ? -lc.y : -lc.x));
        if constexpr (kMasked) {
          const int key = key0 + 8 * (e >> 1);
          pe = key > q0 + col + (e & 1) ? 0.0f : pe;
        }
        s[4 * n + e] = pe;
        dp[4 * n + e] = pe * (dp[4 * n + e] - ((e & 1) ? dc.y : dc.x));
      }
    }
  };
  auto p_ds = [&](int st, int q0) {
    if (p.causal && key_lo + 63 > q0)
      p_ds_tile(st, q0, std::true_type());
    else
      p_ds_tile(st, q0, std::false_type());
  };
  auto pack_pds = [&]() {
#pragma unroll
    for (int j = 0; j < kStep / 16; ++j) {
      c_to_a(pa[j], s + 8 * j);
      c_to_a(da[j], dp + 8 * j);
    }
  };

  // turns as in the dQ kernel: steps + 1 issues an item with kOverlap,
  // 2 steps without
  const int my_turn = 1 + cw, their_turn = 2 - cw;
  if (cw == 1) bar_arrive(1, 256);

  int ring = 0;  // the Q / dO slot sequence, as the loader's
  for (int j = 0; j < n_mine; ++j) {
    const int item = items[j];
    const int bkv = item / nk, kb = item % nk;
    const int b = bkv / p.KV, kvh = bkv % p.KV;
    const int slot = j & 1;
    key_lo = kb * kRows + cw * 64;
    key0 = key_lo + frag_row;
    k_addr = smem_u32(sK + slot * kTileK) + cw * 64 * 128;
    v_addr = smem_u32(sV + slot * kTileK) + cw * 64 * 128;
    const int qt0 = first_q(kb), per_head = nq - qt0;
    const int steps = G * per_head;
    auto q0_of = [&](int i) { return (qt0 + i % per_head) * kStep; };
    const bool last_item = j + 1 == n_mine;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

    // q tile 0: S^T and dP^T, then P^T and dS^T
    mbar_wait(&t_full[slot], (j >> 1) & 1);
    {
      const int st = ring % stages;
      mbar_wait(&q_full[st], (ring / stages) & 1);
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_sdpt(st);
      bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      if (lane == 0 && steps == 1) mbar_arrive(&t_empty[slot]);  // K, V done
      p_ds(st, q0_of(0));
      pack_pds();
    }
    // q tile i.  kOverlap: S^T and dP^T of tile i, and dV, dK of tile
    // i - 1, in flight together; P^T and dS^T of tile i while dV and dK
    // run.  Else dV, dK of tile i - 1 first, then S^T and dP^T of tile i
    // (two turns).
    for (int i = 1; i < steps; ++i) {
      const int r = ring + i;
      const int st = r % stages, pst = (r - 1) % stages;
      if constexpr (kOverlap) mbar_wait(&q_full[st], (r / stages) & 1);
      fence_acc(dk);
      fence_acc(dv);
      fence_frags();
      bar_sync(my_turn, 256);
      wgmma_fence();
      if constexpr (kOverlap) {
        issue_sdpt(st);
        issue_dkdv(pst);
        bar_arrive(their_turn, 256);
        wgmma_wait<1>();  // S^T, dP^T done (groups complete in order)
      } else {
        issue_dkdv(pst);  // not held up by tile i's loads
        bar_arrive(their_turn, 256);
        wgmma_wait<0>();
        fence_acc(dk);
        fence_acc(dv);
        fence_frags();
        if (lane == 0) mbar_arrive(&q_empty[pst]);
        mbar_wait(&q_full[st], (r / stages) & 1);
        bar_sync(my_turn, 256);
        wgmma_fence();
        issue_sdpt(st);
        bar_arrive(their_turn, 256);
        wgmma_wait<0>();
      }
      fence_acc(s);
      fence_acc(dp);
      if (lane == 0 && i == steps - 1) mbar_arrive(&t_empty[slot]);
      p_ds(st, q0_of(i));
      if constexpr (kOverlap) {
        wgmma_wait<0>();  // dV, dK of the last tile done: its slot is free
        fence_acc(dk);
        fence_acc(dv);
        fence_frags();
        if (lane == 0) mbar_arrive(&q_empty[pst]);
      }
      pack_pds();
    }
    {
      const int st = (ring + steps - 1) % stages;
      fence_acc(dk);
      fence_acc(dv);
      fence_frags();
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_dkdv(st);
      if (cw == 0 || !last_item) bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      fence_frags();
      if (lane == 0) mbar_arrive(&q_empty[st]);
    }
    ring += steps;

    bf16* dkp = base<bf16, kDK>(p, p.dk, b, kvh);
    bf16* dvp = base<bf16, kDV>(p, p.dv, b, kvh);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key >= seq) continue;
      bf16* ko = dkp + key * row_stride<kDK>(p);
      bf16* vo = dvp + key * row_stride<kDV>(p);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(ko + n * 8 + t4 * 2) =
            pack_bf16(dk[4 * n + 2 * i] * p.scale,
                      dk[4 * n + 2 * i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(vo + n * 8 + t4 * 2) =
            pack_bf16(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
      }
    }
  }
}

// --- float32, 3xTF32 on mma.sync ------------------------------------------------

constexpr int kF = 64;           // rows (dQ) or keys (dK / dV) of an item
constexpr int kFThreads = 128;   // the dQ kernel's block: 4 warps of 16 rows
constexpr int kKVThreads = 256;  // the dK / dV kernel's: 4 pairs of warps
constexpr int kFStages = 2;      // ring slots of the streamed tiles

// keys (dQ) or query rows (dK / dV) of a streamed tile: with 32 at D =
// 64 and 16 at D = 128 two blocks of each kernel fit an SM and ptxas
// needs no spill (dQ at D = 128 alone holds 64 accumulator registers a
// thread)
template <int D>
__host__ __device__ constexpr int f32_step() {
  return D == 64 ? 32 : 16;
}

// shared rows are D + 4 floats: a row stride of 4 (mod 32) words puts both
// ways a tile is read on 32 distinct banks -- element [g][t] (A fragments,
// B of S = Q K^T) at bank 4 g + t, element [2 t][g] (B of dQ = dS K, dV =
// P^T dO, dK = dS^T Q) at 8 t + g -- and keeps every row whole 16-byte
// chunks for cp.async
template <int D>
constexpr int f32_dq_smem_bytes() {  // Q, dO; the ring's K, V
  return (2 * kF + kFStages * 2 * f32_step<D>()) * (D + 4) * 4;
}
template <int D>
constexpr int f32_dkdv_smem_bytes() {  // K, V; P^T; the ring's Q, dO, lse, D
  return (2 * kF * (D + 4) + kF * (f32_step<D>() + 8) +
          kFStages * 2 * f32_step<D>() * (D + 5)) * 4;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared::cta.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + ROWS) of a [S, D] float32 view (row stride st) into
// shared rows of D + 4 floats, by 16-byte cp.async; zeros past S
template <int D, int ROWS, int THREADS = kFThreads>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int64_t st, int r0, int S) {
  constexpr int kChunks = D / 4;
  static_assert(ROWS * kChunks % THREADS == 0, "whole rounds");
#pragma unroll
  for (int j = 0; j < ROWS * kChunks / THREADS; ++j) {
    const int i = (int)threadIdx.x + j * THREADS;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < S;
    cp_async16(smem_u32(dst + r * (D + 4) + 4 * c),
               src + (ok ? u64(r0 + r) * st + 4 * c : 0), ok);
  }
}

// the A fragment of rows row0 + (g, g + 8), columns c0 + (t, t + 4) of a
// shared tile, split into TF32 hi and lo
template <int LD>
__device__ __forceinline__ void frag_a(const float* s, int row0, int c0,
                                       int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = s + (row0 + g) * LD + c0 + t;
  split_tf32<true>(p[0], hi[0], lo[0]);
  split_tf32<true>(p[8 * LD], hi[1], lo[1]);
  split_tf32<true>(p[4], hi[2], lo[2]);
  split_tf32<true>(p[8 * LD + 4], hi[3], lo[3]);
}

// the B fragment of a product against a shared tile's transpose (S = Q
// K^T): B[k][n] = s[n0 + n][k0 + k], so b0 = s[n0 + g][k0 + t], b1 =
// s[n0 + g][k0 + t + 4]
template <int LD>
__device__ __forceinline__ void frag_bt(const float* s, int n0, int k0, int g,
                                        int t, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  const float* p = s + (n0 + g) * LD + k0 + t;
  split_tf32<true>(p[0], hi[0], lo[0]);
  split_tf32<true>(p[4], hi[1], lo[1]);
}

// the B fragment of a product against a shared tile as it lies (dQ = dS
// K), with the reduction index relabelled so that an accumulator fragment
// is the A fragment as it stands: k-slot t is row k0 + 2 t, k-slot t + 4
// row k0 + 2 t + 1 (see relabel_a)
template <int LD>
__device__ __forceinline__ void frag_b(const float* s, int k0, int n0, int g,
                                       int t, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float* p = s + (k0 + 2 * t) * LD + n0 + g;
  split_tf32<true>(p[0], hi[0], lo[0]);
  split_tf32<true>(p[LD], hi[1], lo[1]);
}

// an accumulator fragment c (rows g, g + 8; columns 2 t, 2 t + 1 of 8) as
// the A fragment of the next product: {c0, c2, c1, c3} puts column 2 t in
// k-slot t and column 2 t + 1 in k-slot t + 4, which frag_b matches; the
// sum over the 8 columns only changes its order, the same in every run
__device__ __forceinline__ void relabel_a(const float (&c)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32<true>(c[0], hi[0], lo[0]);
  split_tf32<true>(c[2], hi[1], lo[1]);
  split_tf32<true>(c[1], hi[2], lo[2]);
  split_tf32<true>(c[3], hi[3], lo[3]);
}

// d += a b in float32 as 3xTF32: lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b),
// the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s = A B^T over the D columns for a warp's 16 rows row0.. of a resident
// tile A against the NT * 8 rows of a streamed tile B (S = Q K^T in the dQ
// kernel; S^T = K Q^T, dP^T = V dO^T in the dK / dV kernel)
template <int D, int NT>
__device__ __forceinline__ void scores_f32(const float* A, const float* B,
                                           int row0, int g, int t,
                                           float (&s)[NT][4]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
  // unrolled as far as the 128 registers of the dK / dV kernel's two
  // blocks an SM allow without a spill (ptxas)
  constexpr int kUnroll = D == 64 ? 2 : 4;
#pragma unroll kUnroll
  for (int kd = 0; kd < D / 8; ++kd) {
    uint32_t ah[4], al[4];
    frag_a<LD>(A, row0, 8 * kd, g, t, ah, al);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh[2], bl[2];
      frag_bt<LD>(B, 8 * n, 8 * kd, g, t, bh, bl);
      mma_3xtf32(s[n], ah, al, bh, bl);
    }
  }
}

// acc += c B: c a warp's [16][NT * 8] accumulator fragments (P or dS),
// B the streamed tile's [NT * 8][D] rows as they lie.  Each 16 x 8 block
// of acc sums the tile in a fresh accumulator and adds it to acc in
// float32: mma.sync's float32 accumulation truncates, and over the
// thousands of steps of a whole row it drifts toward zero (~1e-4 of scale
// at S = 4096), where the tile's sum of 3 NT steps does not.
template <int D, int NT>
__device__ __forceinline__ void accumulate_f32(const float (&c)[NT][4],
                                               const float* B, int g, int t,
                                               float (&acc)[D / 8][4]) {
  constexpr int LD = D + 4;
  uint32_t ah[NT][4], al[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) relabel_a(c[kk], ah[kk], al[kk]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t bh[2], bl[2];
      frag_b<LD>(B, 8 * kk, 8 * n, g, t, bh, bl);
      mma_3xtf32(part, ah[kk], al[kk], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// dQ: an item is kF query rows of one (b, h), blockIdx.x = (the item's
// q-block, heaviest first under causal) * B H + b H + h.  Q and dO stay;
// K and V tiles of f32_step keys stream through a ring of kFStages slots,
// from key 0 to the item's last row (to S when not causal).  D of the rows
// goes to the scratch for the dK / dV kernel.
template <int D>
__global__ void __launch_bounds__(kFThreads, 2)
flash_bwd_dq_f32_tc_kernel(const Params p) {
  constexpr int LD = D + 4, KT = f32_step<D>(), NT = KT / 8;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;               // [kF][LD]
  float* dOs = Qs + kF * LD;     // [kF][LD]
  float* ring = dOs + kF * LD;   // kFStages x (K [KT][LD], V [KT][LD])

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (p.S + kF - 1) / kF, BH = (int)gridDim.x / nq;
  const int qb = p.causal ? nq - 1 - (int)blockIdx.x / BH
                          : (int)blockIdx.x / BH;
  const int bh = (int)blockIdx.x % BH;
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
  const int q0 = qb * kF, r0 = q0 + 16 * warp;  // the warp's first row
  const float* kp = base<const float, kK>(p, p.k, b, kvh);
  const float* vp = base<const float, kV>(p, p.v, b, kvh);

  load_rows_f32<D, kF>(Qs, base<const float, kQ>(p, p.q, b, h),
                       row_stride<kQ>(p), q0, p.S);
  load_rows_f32<D, kF>(dOs, base<const float, kDO>(p, p.dout, b, h),
                       row_stride<kDO>(p), q0, p.S);
  cp_async_commit();
  const int kv_end = p.causal ? min(q0 + kF, p.S) : p.S;
  const int tiles = (kv_end + KT - 1) / KT;
  load_rows_f32<D, KT>(ring, kp, row_stride<kK>(p), 0, p.S);
  load_rows_f32<D, KT>(ring + KT * LD, vp, row_stride<kV>(p), 0, p.S);
  cp_async_commit();

  // lse and D of rows g, g + 8 (D: the warp sums each of its rows, the
  // first kv tile loading meanwhile)
  const int64_t lrow = u64(bh) * p.S;
  float lse[2], dd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    lse[i] = row < p.S ? p.lse[lrow + row] : 0.0f;
  }
  cp_async_wait<1>();
  __syncthreads();
  {
    const float* op = base<const float, kO>(p, p.o, b, h);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      float acc = 0.0f;
      if (row < p.S) {
        const float* orow = op + u64(row) * row_stride<kO>(p);
#pragma unroll
        for (int j = 0; j < D / 32; ++j)
          acc = fmaf(dOs[(16 * warp + r) * LD + lane + 32 * j],
                     orow[lane + 32 * j], acc);
      }
      acc = warp_sum(acc);
      if (r == g) dd[0] = acc;
      if (r == g + 8) dd[1] = acc;
      if (lane == 0 && row < p.S) p.dd[lrow + row] = acc;
    }
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      float* nxt = ring + ((it + 1) % kFStages) * 2 * KT * LD;
      load_rows_f32<D, KT>(nxt, kp, row_stride<kK>(p), (it + 1) * KT, p.S);
      load_rows_f32<D, KT>(nxt + KT * LD, vp, row_stride<kV>(p),
                           (it + 1) * KT, p.S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * KT;
    // a tile whose keys all lie above the warp's rows adds nothing to them
    if (!p.causal || k0 <= r0 + 15) {
      const float* Ks = ring + (it % kFStages) * 2 * KT * LD;
      const float* Vs = Ks + KT * LD;
      float s[NT][4], dp[NT][4];
      scores_f32<D, NT>(Qs, Ks, 16 * warp, g, t, s);
      scores_f32<D, NT>(dOs, Vs, 16 * warp, g, t, dp);
      // P = exp(S scale - lse), 0 for keys past S or above the row; dS /
      // scale = P (dP - D) into dp
      const bool edge = k0 + KT > p.S || (p.causal && k0 + KT - 1 > r0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = expf(s[n][e] * p.scale - lse[e >> 1]);
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          if (edge && (key >= p.S || (p.causal && key > row))) pe = 0.0f;
          dp[n][e] = pe * (dp[n][e] - dd[e >> 1]);
        }
      accumulate_f32<D, NT>(dp, Ks, g, t, dq);
    }
    __syncthreads();  // the slot is refilled next
  }

  float* dqp = base<float, kDQ>(p, p.dq, b, h);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= p.S) continue;
    float* out = dqp + u64(row) * row_stride<kDQ>(p);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n + 2 * t) = make_float2(
          dq[n][2 * i] * p.scale, dq[n][2 * i + 1] * p.scale);
  }
}

// dK / dV: an item is kF keys and one head, blockIdx.x = (the item's key
// block, heaviest first under causal) * B H + b H + h.  K and V of the
// head's kv head stay; the head's Q and dO tiles of f32_step rows, with
// their lse and D (the dQ kernel's scratch), stream through a ring of
// kFStages slots from the first row that sees the item's keys.  Warps 2 w
// and 2 w + 1 share the keys 16 w .. 16 w + 15: per tile the first (the P
// warp) computes S^T and P^T, hands P^T to the second through shared
// memory and adds P^T dO to dV; the second (the dS warp) computes dP^T and
// dS^T = P^T (dP^T - D) and adds dS^T Q to dK.  Each warp runs 2 of the 4
// products and holds one accumulator, so neither holds dK and dV (128
// registers a thread at D = 128) beside the scores.  Without GQA the item
// writes dk, dv; with it, its head's float32 partials, which
// flash_bwd_dkdv_sum_f32_kernel adds up by group in head order.
// rows [qt0, qt0 + f32_step) of head h's Q and dO, with their lse and D,
// into a dK / dV ring slot: [QT][D + 4] Q, then dO, then QT lse, QT D
template <int D>
__device__ __forceinline__ void load_q_tile(const Params& p, float* slot,
                                            int b, int h, int qt0) {
  constexpr int QT = f32_step<D>(), LD = D + 4;
  load_rows_f32<D, QT, kKVThreads>(slot, base<const float, kQ>(p, p.q, b, h),
                                   row_stride<kQ>(p), qt0, p.S);
  load_rows_f32<D, QT, kKVThreads>(slot + QT * LD,
                                   base<const float, kDO>(p, p.dout, b, h),
                                   row_stride<kDO>(p), qt0, p.S);
  const int row = qt0 + (int)threadIdx.x % QT;
  const float* src = threadIdx.x < QT ? p.lse : p.dd;
  if (threadIdx.x < 2 * QT)
    cp_async4(smem_u32(slot + 2 * QT * LD + threadIdx.x),
              src + (row < p.S ? u64(b * p.H + h) * p.S + row : 0),
              row < p.S);
}

template <int D>
__global__ void __launch_bounds__(kKVThreads, 2)
flash_bwd_dkdv_f32_tc_kernel(const Params p) {
  constexpr int LD = D + 4, QT = f32_step<D>(), NT = QT / 8, LP = QT + 8;
  constexpr int kSlot = 2 * QT * LD + 2 * QT;  // Q, dO, lse, D
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;               // [kF][LD]
  float* Vs = Ks + kF * LD;      // [kF][LD]
  float* Pt = Vs + kF * LD;      // [kF][LP]: P^T, from the P warps
  float* ring = Pt + kF * LP;    // kFStages x kSlot

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool pwarp = (warp & 1) == 0;
  const int r16 = 16 * (warp >> 1);  // the warp's first key in the item
  const int nk = (p.S + kF - 1) / kF, BH = (int)gridDim.x / nk;
  const int kb = (int)blockIdx.x / BH, bh = (int)blockIdx.x % BH;
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
  const int k0 = kb * kF, key0 = k0 + r16;
  load_rows_f32<D, kF, kKVThreads>(Ks, base<const float, kK>(p, p.k, b, kvh),
                                   row_stride<kK>(p), k0, p.S);
  load_rows_f32<D, kF, kKVThreads>(Vs, base<const float, kV>(p, p.v, b, kvh),
                                   row_stride<kV>(p), k0, p.S);
  cp_async_commit();

  // the query tiles of one head, from the first that sees a key here
  // (k0 is a multiple of QT)
  const int qs0 = p.causal ? k0 : 0;
  load_q_tile<D>(p, ring, b, h, qs0);
  cp_async_commit();

  // P warp: dV; dS warp: dK / scale
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const float* A = pwarp ? Ks : Vs;
  for (int qt0 = qs0, i = 0; qt0 < p.S; qt0 += QT, i ^= 1) {
    if (qt0 + QT < p.S) load_q_tile<D>(p, ring + (i ^ 1) * kSlot, b, h, qt0 + QT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qs = ring + i * kSlot;
    const float* dOs = Qs + QT * LD;
    const float* Ls = dOs + QT * LD;
    const float* Ds = Ls + QT;
    // a tile whose rows all lie before the warp's keys adds nothing to them
    const bool active = !p.causal || qt0 + QT - 1 >= key0;
    float c[NT][4];  // P warp: S^T, then P^T; dS warp: dP^T, then dS^T
    if (active) {
      scores_f32<D, NT>(A, pwarp ? Qs : dOs, r16, g, t, c);
      if (pwarp) {
        // P^T, 0 for rows past S or before the key
        const bool edge = qt0 + QT > p.S || (p.causal && qt0 < key0 + 15);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = 8 * n + 2 * t + (e & 1), row = qt0 + ql;
            const int key = key0 + g + 8 * (e >> 1);
            float pe = expf(c[n][e] * p.scale - Ls[ql]);
            if (edge && (row >= p.S || (p.causal && key > row))) pe = 0.0f;
            c[n][e] = pe;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(Pt + (r16 + g + 8 * i) * LP + 8 * n +
                                       2 * t) =
                make_float2(c[n][2 * i], c[n][2 * i + 1]);
        }
      }
    }
    __syncthreads();  // P^T handed over
    if (active) {
      if (!pwarp) {
        // dS^T / scale = P^T (dP^T - D)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 pe = *reinterpret_cast<const float2*>(
                Pt + (r16 + g + 8 * i) * LP + 8 * n + 2 * t);
            const int ql = 8 * n + 2 * t;
            c[n][2 * i] = pe.x * (c[n][2 * i] - Ds[ql]);
            c[n][2 * i + 1] = pe.y * (c[n][2 * i + 1] - Ds[ql + 1]);
          }
      }
      accumulate_f32<D, NT>(c, pwarp ? dOs : Qs, g, t, acc);
    }
    __syncthreads();  // the slot and P^T are refilled next
  }

  // without GQA dk, dv; with it, the head's partials, rows of H D floats
  float* out;
  int64_t st;
  if (p.H == p.KV) {
    out = pwarp ? base<float, kDV>(p, p.dv, b, kvh)
                : base<float, kDK>(p, p.dk, b, kvh);
    st = pwarp ? row_stride<kDV>(p) : row_stride<kDK>(p);
  } else {
    out = p.part + (pwarp ? p.part_half : 0) +
          (u64(b) * p.S * p.H + h) * D;
    st = (int64_t)p.H * D;
  }
  const float mul = pwarp ? 1.0f : p.scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + 8 * i;
    if (key >= p.S) continue;
    float* o = out + u64(key) * st;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(o + 8 * n + 2 * t) =
          make_float2(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// dK and dV with GQA: for each (b, key, kv head), the sum of the group's G
// float32 partials in head order (the same order in every run); 4 columns
// a thread
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum_f32_kernel(const Params p, int B) {
  const int G = p.H / p.KV;
  const int64_t total = (int64_t)B * p.S * p.KV * (D / 4);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % (D / 4));
    const int64_t r = i / (D / 4);
    const int kvh = (int)(r % p.KV), key = (int)(r / p.KV % p.S);
    const int b = (int)(r / p.KV / p.S);
    const float* src = p.part + (((int64_t)b * p.S + key) * p.H + kvh * G) * D
                       + 4 * c;
    float4 k4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v4 = k4;
    for (int gi = 0; gi < G; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(src + gi * D);
      const float4 y =
          *reinterpret_cast<const float4*>(src + p.part_half + gi * D);
      k4.x += x.x; k4.y += x.y; k4.z += x.z; k4.w += x.w;
      v4.x += y.x; v4.y += y.y; v4.z += y.z; v4.w += y.w;
    }
    *reinterpret_cast<float4*>(base<float, kDK>(p, p.dk, b, kvh) +
                               key * row_stride<kDK>(p) + 4 * c) = k4;
    *reinterpret_cast<float4*>(base<float, kDV>(p, p.dv, b, kvh) +
                               key * row_stride<kDV>(p) + 4 * c) = v4;
  }
}

// --- launch ------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int threads, const Params& p,
                   int gx, int gy, unsigned* smem_done, int device,
                   void* stream) {
  cudaError_t err = allow_smem(kernel, smem, device, smem_done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), threads, smem,
           (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

// a 4-D tensor map over a BSHD bf16 tensor as it lies, dims (d, heads, S,
// B), boxes of 64 x 1 x rows x 1 (st: its batch, seq, head strides)
bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int heads,
                 int d, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_bf16(map, base, 4, dims, strides, box);
}

// parts: 1 the dQ kernel, 2 the dK / dV kernel (which reads the scratch the
// dQ kernel wrote), 3 both in this order
template <int D>
int launch_bf16(const Params& p, int B, const long long* st, int ctas_dq,
                int ctas_kv, int parts, int device, void* stream) {
  static unsigned dq_done = 0, kv_done = 0;
  cudaError_t err = cudaSuccess;
  CUtensorMap tm_q = {}, tm_do = {}, tm_k = {}, tm_v = {};
  if (parts & 1) {
    if (!encode_bshd(&tm_q, p.q, B, p.S, p.H, D, st + 3 * kQ, kRows) ||
        !encode_bshd(&tm_do, p.dout, B, p.S, p.H, D, st + 3 * kDO, kRows) ||
        !encode_bshd(&tm_k, p.k, B, p.S, p.KV, D, st + 3 * kK,
                     dq_step<D>()) ||
        !encode_bshd(&tm_v, p.v, B, p.S, p.KV, D, st + 3 * kV, dq_step<D>()))
      return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dq_bf16_tc_kernel<D>;
    err = allow_smem(kernel, dq_smem_bytes<D>(), device, &dq_done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<ctas_dq, kThreads, dq_smem_bytes<D>(), (cudaStream_t)stream>>>(
        tm_q, tm_do, tm_k, tm_v, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    if (!encode_bshd(&tm_k, p.k, B, p.S, p.KV, D, st + 3 * kK, kRows) ||
        !encode_bshd(&tm_v, p.v, B, p.S, p.KV, D, st + 3 * kV, kRows) ||
        !encode_bshd(&tm_q, p.q, B, p.S, p.H, D, st + 3 * kQ, kStep) ||
        !encode_bshd(&tm_do, p.dout, B, p.S, p.H, D, st + 3 * kDO, kStep))
      return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dkdv_bf16_tc_kernel<D>;
    err = allow_smem(kernel, dkdv_smem_bytes<D>(), device, &kv_done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<ctas_kv, kThreads, dkdv_smem_bytes<D>(),
             (cudaStream_t)stream>>>(tm_k, tm_v, tm_q, tm_do, p);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <int D>
int launch_f32(const Params& p, int B, int ctas_dq, int ctas_kv, int parts,
               int device, void* stream) {
  static unsigned dq_done = 0, kv_done = 0;
  if (parts & 1) {
    cudaError_t err = launch(flash_bwd_dq_f32_tc_kernel<D>,
                             f32_dq_smem_bytes<D>(), kFThreads, p, ctas_dq,
                             1, &dq_done, device, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    cudaError_t err = launch(flash_bwd_dkdv_f32_tc_kernel<D>,
                             f32_dkdv_smem_bytes<D>(), kKVThreads, p, ctas_kv,
                             1, &kv_done, device, stream);
    if (err != cudaSuccess || p.H == p.KV) return (int)err;
    const int64_t total = (int64_t)B * p.S * p.KV * (D / 4);
    const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256
                                                          : 65536);
    flash_bwd_dkdv_sum_f32_kernel<D><<<blocks, 256, 0,
                                       (cudaStream_t)stream>>>(p, B);
    return (int)cudaGetLastError();
  }
  return (int)cudaSuccess;
}

bool aligned_rows(const void* const* ptrs, const long long* st, int elem) {
  for (int i = 0; i < kTensors; ++i)
    if (!aligned16(ptrs[i])) return false;
  for (int i = 0; i < 3 * kTensors; ++i)
    if ((st[i] * elem) % 16) return false;
  return true;
}

// the checks both variants share; fills p
bool make_params(Params* p, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse, void* dd,
                 void* dq, void* dk, void* dv, int B, int S, int H, int KV,
                 int hd, const long long* strides, float scale, int causal,
                 int parts, int elem) {
  const void* ptrs[kTensors] = {q, k, v, o, dout, dq, dk, dv};
  if (B < 1 || S < 1 || KV < 1 || H % KV || (hd != 64 && hd != 128) ||
      (int64_t)B * H >= (1ll << 31) || lse == nullptr || dd == nullptr ||
      parts < 1 || parts > 3 || !aligned_rows(ptrs, strides, elem))
    return false;
  *p = Params{};
  p->q = q; p->k = k; p->v = v; p->o = o; p->dout = dout;
  p->lse = static_cast<const float*>(lse);
  p->dd = static_cast<float*>(dd);
  p->dq = dq; p->dk = dk; p->dv = dv;
  p->S = S; p->H = H; p->KV = KV;
  for (int i = 0; i < 3 * kTensors; ++i) p->st[i] = strides[i];
  p->scale = scale;
  p->causal = causal;
  return true;
}

}  // namespace

extern "C" {

// Both entry points: q, k, v, o, do, lse, the scratch, (bf16: the
// schedule,) dq, dk, dv device pointers; B, S, H, KV, hd (== hv, 64 or
// 128); strides: 24 element strides, (batch, seq, head) of q, k, v, o, do,
// dq, dk, dv in order; the softmax scale; causal; the plan: the dQ
// kernel's rows an item (q_rows) and kv step, the dK / dV kernel's keys an
// item (kv_rows) and q step, the ring depths of the two kernels and their
// grids (blocks); parts: 1 the dQ kernel, 2 the dK / dV kernel (it reads
// the scratch a dQ launch of the same call wrote), 3 both in this order (a
// training step's call); the device and the stream.  Every row 16-byte
// aligned.  Each entry point checks the plan against its own constants and
// refuses any other.

// bf16 on wgmma.  Plan: q_rows = kv_rows = 128, q_step = 64, kv_step 128 at
// hd 64 and 64 at 128 (dq_step), the ring depths of the two kernels (4 and
// 4 at hd 64, 3 and 3 at 128), their persistent grids ctas_dq <= B * H * nq
// and ctas_kv <= B * KV * nq blocks (nq = ceil(S / 128)).  scratch: float32
// [2, B * H, 128 nq] (lse2, then D).  sched: int32, each kernel's schedule
// in turn -- ctas + 1 offsets, then its items, block c taking items
// [offsets[c], offsets[c + 1]) in order: for the dQ kernel B * H * nq items
// (b * H + h) * nq + q-block, for the dK / dV kernel B * KV * nq items
// (b * KV + kv head) * nq + key block.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* scratch, const void* sched, void* dq,
                             void* dk, void* dv, int B, int S, int H, int KV,
                             int hd, const long long* strides, float scale,
                             int causal, int q_rows, int kv_rows, int q_step,
                             int kv_step, int stages_dq, int stages_dkdv,
                             int ctas_dq, int ctas_kv, int parts, int device,
                             void* stream) {
  Params p;
  if (!make_params(&p, q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, H,
                   KV, hd, strides, scale, causal, parts, 2) ||
      sched == nullptr || q_rows != kRows || kv_rows != kRows ||
      q_step != kStep ||
      kv_step != (hd == 64 ? dq_step<64>() : dq_step<128>()))
    return (int)cudaErrorInvalidValue;
  const int64_t nq = (S + kRows - 1) / kRows;
  const int64_t n_dq = (int64_t)B * H * nq, n_kv = (int64_t)B * KV * nq;
  const bool d64 = hd == 64;
  if (stages_dq != (d64 ? dq_stages<64>() : dq_stages<128>()) ||
      stages_dkdv != (d64 ? dkdv_stages<64>() : dkdv_stages<128>()) ||
      n_dq >= (1ll << 31) || ctas_dq < 1 || ctas_dq > n_dq || ctas_kv < 1 ||
      ctas_kv > n_kv)
    return (int)cudaErrorInvalidValue;
  p.s_pad = (int)(nq * kRows);
  p.lse2 = static_cast<float*>(scratch);
  p.dd = p.lse2 + (int64_t)B * H * p.s_pad;
  p.sched_dq = static_cast<const int*>(sched);
  p.sched_kv = p.sched_dq + ctas_dq + 1 + n_dq;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return d64 ? launch_bf16<64>(p, B, strides, ctas_dq, ctas_kv, parts,
                               device, stream)
             : launch_bf16<128>(p, B, strides, ctas_dq, ctas_kv, parts,
                                device, stream);
}

// float32 as 3xTF32 on mma.sync.  Plan: q_rows = kv_rows = 64 (kF), q_step
// = kv_step = f32_step, 2 ring slots in each kernel, grids of one block an
// item: ctas_dq = ctas_kv = B * H * nq (nq = ceil(S / 64)).  scratch:
// float32 D [B, H, S], after the dK, dV partials 2 x [B, S, H, hd] when H >
// KV.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dd, void* dq, void* dk, void* dv, int B,
                            int S, int H, int KV, int hd,
                            const long long* strides, float scale, int causal,
                            int q_rows, int kv_rows, int q_step, int kv_step,
                            int stages_dq, int stages_dkdv, int ctas_dq,
                            int ctas_kv, int parts, int device,
                            void* stream) {
  Params p;
  const int step = hd == 64 ? f32_step<64>() : f32_step<128>();
  const int64_t nq = (S + kF - 1) / kF;
  if (!make_params(&p, q, k, v, o, dout, lse, dd, dq, dk, dv, B, S, H, KV,
                   hd, strides, scale, causal, parts, 4) ||
      q_rows != kF || kv_rows != kF || q_step != step || kv_step != step ||
      stages_dq != kFStages || stages_dkdv != kFStages ||
      (int64_t)B * H * nq >= (1ll << 31) || ctas_dq != (int64_t)B * H * nq ||
      ctas_kv != ctas_dq)
    return (int)cudaErrorInvalidValue;
  // with GQA the scratch holds the dK, dV partials [B, S, H, hd], then D
  p.part_half = (int64_t)B * S * H * hd;
  p.part = static_cast<float*>(dd);
  if (H > KV) p.dd += 2 * p.part_half;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return hd == 64
             ? launch_f32<64>(p, B, ctas_dq, ctas_kv, parts, device, stream)
             : launch_f32<128>(p, B, ctas_dq, ctas_kv, parts, device, stream);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
