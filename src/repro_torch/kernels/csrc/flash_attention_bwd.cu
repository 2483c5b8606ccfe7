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
//     P_ij  = exp(scale q_i . k_j - lse_i), 0 for j > i, j >= P when
//             causal (P = prefix: the bidirectional prefix of P keys every
//             row sees, PaliGemma's image patches; 0 plain causal)
//     dV_j  = sum_{h in group} sum_i P_ij do_i
//     dP_ij = do_i . v_j
//     dS_ij = P_ij (dP_ij - D_i) scale
//     dQ_i  = sum_j dS_ij k_j
//     dK_j  = sum_{h in group} sum_i dS_ij q_i
//   out: dq [B, S, H, D], dk, dv [B, S, KV, D] in the input type.
//   The keys and values may be Sk long, Sk != S, when the call is not
//   causal (cross attention): k, v, dk, dv are then [B, Sk, KV, D], and
//   the query rows (dQ items, q tiles, lse, D) run over S, the keys (kv
//   tiles, dK / dV items, key masks, the K / V tensor maps) over Sk.
//   With a prefix, a dQ item of causal rows [q0, q1) walks the keys up to
//   max(q1, P) (causal_end), and a dK / dV item that holds a key of the
//   prefix walks every query row from 0; the masks hide a key after its
//   row and past the prefix (hidden), on the tiles they did before.
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
//   flash_bwd_dq_bf16_tc_kernel<HD, HV> (hd == hv == D in {64, 128, 256},
//   and (192, 128)), flash_bwd_dkdv_bf16_tc_kernel<D> (D in {64, 128}),
//   flash_bwd_dkdv_bf16_split_kernel<HD, HV> (256 and (192, 128))   bf16,
//   K3's forward
//     (flash_attention.cu, flash_bf16_tc_kernel) with its roles turned
//     around.  Persistent: one
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
//       (two slots, so the next item's load under this one; one at D =
//       256, where a slot is 128 KB) stay while K and V tiles (128 keys at
//       D = 64, 64 at D = 128, 32 at D = 256, so that S, dP and dQ fit the
//       registers) stream through a ring of full / empty
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
//     Head dim 256 (paligemma, MQA: H = 8, KV = 1).  A 64 x 256 float32
//       accumulator is 128 registers a thread, and two 128-row Q / dO item
//       slots alone would be 256 KB.  dQ: one item slot (Q and dO, 128 KB)
//       and a ring of 3 K / V tiles of 32 keys (32 KB a stage): 225 KB;
//       registers dQ 128 + S 16 + dP 16 + dS 8; S and dP by
//       wgmma.m64n32k16, dQ += dS K by wgmma.m64n256k16, the block's
//       ping-pong and overlap as above (the lower warpgroup computes the
//       two 32-key tiles above its rows masked to 0: no branch).  dK / dV
//       (flash_bwd_dkdv_bf16_split_kernel): dK and dV do not fit one
//       warpgroup together, so the two consumer warpgroups split them -- the
//       float32 kernels' warp-pair split lifted to warpgroups: warpgroup 0
//       computes S^T = K Q^T and P^T, hands P^T (float32, one fragment a
//       thread, 16 KB, two buffers on full / empty mbarriers) to warpgroup
//       1 and adds P^T dO to dV; warpgroup 1 computes dP^T = V dO^T and dS^T
//       and adds dS^T Q to dK; each product m64n64k16 or m64n256k16.  An
//       item is 64 keys of ONE head (512 items at paligemma's B=1 S=4096,
//       not the 64 an item per kv head would give 132 SMs), the item's K
//       and V (64 KB) resident, Q / dO tiles of 64 rows with their lse2 and
//       D through 2 slots (130 KB): 226 KB.  With GQA the items write
//       float32 partials [2, B, Sk, H, D] after the scratch's lse2 and D,
//       and flash_bwd_dkdv_sum_f32_kernel adds a group's in head order (67
//       MB written and read at paligemma's shape).  P and dS are rounded to
//       bf16 for the products as at 64 and 128; dS takes P in float32.
//     (hd, hv) = (192, 128) (deepseek's MLA: H == KV = 128, no GQA).  Q and
//       K rows are 3 boxes, dO and V rows 2: S = Q K^T takes 12 k16 steps,
//       dP = dO V^T 8.  dQ: one item slot (Q 48 KB and dO 32 KB) and a ring
//       of 3 K / V tiles of 64 keys (24 + 16 KB a stage): 201 KB; registers
//       dQ 96 + S 32 + dP 32 + dS 16; dQ += dS K by one wgmma.m64n192k16 a
//       16-key step (192 is a legal wgmma width: a multiple of 8 up to
//       256).  dK (96 registers) and dV (64) beside S^T and dP^T would be
//       ~224 of the 240, so dK / dV takes the split kernel: the P
//       warpgroup's S^T runs over 192 columns and its dV += P^T dO is
//       m64n128k16, the dS warpgroup's dP^T over 128 and its dK += dS^T Q
//       m64n192k16; the item's K and V (40 KB) resident, 3 ring slots of Q
//       / dO tiles with their lse2 and D (40.5 KB each), the two P^T
//       buffers (32 KB): 195 KB.  An item is 64 keys of one head (8,192
//       items at deepseek's B=1 S=4096); H == KV, so no partials.  It
//       replaces the float32 TF32 kernels with bf16 tiles (one TF32
//       mma.sync a product, items of 64 rows or keys, one block an item),
//       which took 38.2 ms at that shape against SDPA's 4.0.
//   flash_bwd_dq_f32_tc_kernel<HD, HV>, flash_bwd_dkdv_f32_tc_kernel<HD,
//     HV>   float32, hd == hv == D in {64, 128}.  Every product -- S
//     and dP in both kernels, dQ, dV, dK
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
//   flash_bwd_f32_wgmma_kernel<kPassDQ | kPassDK | kPassDV, HD, HV>
//     float32 at (hd, hv) = (192, 128) (deepseek's MLA, H == KV) and at hd
//     = hv = 256 (paligemma, GQA; below): every product as
//     3xTF32 on wgmma, split by cvt.rna as above.  TF32 wgmma reads both
//     shared-memory operands K-major only, so dQ = dS K needs K^T, dK = dS^T
//     Q needs Q^T and dV = P^T dO needs dO^T with the reduction index
//     contiguous; a pre-pass writes them, and q, k, v, do as they lie, split
//     into hi and lo, to a float32 scratch (4.8 GB at deepseek's B=1 S=4096
//     H=128; read once each, written twice their size), with D =
//     rowsum(dO o).  Shared memory sets the design: a 64-row tile of 192
//     columns is 96 KB split, so no block holds two such tiles and a ring:
//     the bf16 kernels' split dK / dV layout (dK on one warpgroup, dV on the
//     other) would need K and V resident (160 KB) and a second K / V-wide
//     tile for each warpgroup.  So one 192-wide operand stays (Q for dQ, K
//     for dK and dV), everything else streams as 32 KB chunks (64 rows x 64
//     columns, hi and lo) through a ring of 4 (225 KB in all), and one
//     consumer warpgroup runs three passes, each holding one output (dQ or
//     dK 96 registers a thread, dV 64): dQ (S, dP, dS, dQ += dS K), dK (S^T,
//     dP^T, dS^T, dK += dS^T Q), dV (S^T, P^T, dV += P^T dO).  Eight
//     products where five are needed (S three times, dP twice), each pass
//     streaming 320 KB (dV 160 KB) a 64 x 64 tile pair from the L2.  An
//     item is 64 rows or keys of one head, one block an item, head by head
//     (a round's operands stay in the L2), heaviest first inside a head.
//     Products: wgmma.m64n64k8, S and dP from shared memory (chained in one
//     accumulator: 1e-4 of scale is the gate), the outputs with dS (or P)
//     from registers -- the accumulator fragment once the reduction index
//     is relabelled, the transposed operands' index stored in tf32_key order
//     -- 64 columns at a time into a fresh accumulator added in float32; no
//     atomics, so two runs are bitwise equal.
//     Head dim 256 (paligemma: 8 heads over 1 kv head, the patches'
//     prefix).  It replaces flash_bwd_{dq,dkdv}_f32_tc_kernel<256> (3xTF32
//     on mma.sync, 16-row steps, one block an SM), 1.29 times SDPA's
//     backward.  Budgets:
//     - Shared memory: the resident tile is 128 KB, so the ring has 3
//       slots (231,480 bytes in all).  A dP product over a pair of chunks
//       (64 columns of the item's rows and of the tile's, 2 slots) would
//       leave the loader no slot ahead, so a dP chunk is 32 columns of
//       both in one slot, 8 of them a tile pair.
//     - Registers: the output is 128 a thread, S and dP 64 beside it, then
//       dS's hi and lo 64 and a fresh 64-column accumulator 32: 224.  The
//       dK and dV passes' lse2 and D of the tile's 16 columns a thread (32
//       more, in registers at (192, 128)) are staged in shared memory
//       instead: each thread loads one value before the products and stores
//       it under them (two buffers, one named barrier a tile).  ptxas: 254,
//       254 and 253 registers (dQ, dK, dV), no spill.
//     - GQA: an item is 64 rows or keys of one query head (512 items a pass
//       at B=1 S=4096 H=8, against 64 for items that walked the group's
//       heads); q, do and their copies lie over the B H query heads, k, v
//       and theirs over the B KV kv heads, each item's loads naming its own
//       head (a_head) and the streamed tiles' (t_head).  The dK and dV
//       items write float32 partials [B, Sk, H, 256] after D in the
//       scratch (67 MB at B=1 S=4096), and flash_bwd_dkdv_sum_f32_kernel
//       adds a group's in head order: no atomics.
//     - The prefix: a dK / dV item that holds a key of the prefix walks
//       every q tile from 0, a dQ item the keys up to causal_end; the masks
//       run on edge tiles only, as at (192, 128).
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
  int S, Sk, H, KV;      // S query rows, Sk keys (== S when causal)
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
  int prefix;            // causal: keys [0, prefix) seen by every row
};

// a non-negative index as a 64-bit offset, zero-extended: no register has
// to keep its sign word (which, held across a loop, can cost a spill)
__device__ __forceinline__ int64_t u64(int i) { return (int64_t)(uint32_t)i; }

// the end of the keys a causal block of rows [.., q_end) sees: its last
// row's, or the prefix's where that lies further
__device__ __forceinline__ int causal_end(const Params& p, int q_end) {
  return max(min(q_end, p.Sk), min(p.prefix, p.Sk));
}

// a key the causal mask hides from a row: after it and past the prefix,
// i.e. after the row's last visible key (one max a row, not a compare an
// element)
__device__ __forceinline__ bool hidden(int key, int row, int prefix) {
  return key > max(row, prefix - 1);
}

// the rows before which a key is hidden: its own row, none (0) for a key of
// the prefix -- hidden(key, row, prefix) == row < hidden_below(key, prefix)
__device__ __forceinline__ int hidden_below(int key, int prefix) {
  return key >= prefix ? key : 0;
}

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
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n192k16(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n256k16(d, a, db);
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

// S[64 x 32] (=|+)= A[64 x 16] (K-major) * B[32 x 16]^T (K-major)
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// C[64 x N] (=|+)= A (K-major) * B^T (K-major), N keys or query rows
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_m64n32k16(d, da, db, scale_d);
}
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

// Below D is the Q K^T width (hd): the head dims are hd == hv in {64, 128,
// 256} and deepseek's (hd, hv) = (192, 128).
// the dQ kernel's kv tile: 128 keys at D = 64 (S and dP take 64 + 64
// registers a thread beside dQ's 32), 64 at D = 128 (dQ takes 64) and at
// 192 (dQ 96), 32 at D = 256 (dQ takes 128; S, dP 16 each)
template <int D>
__host__ __device__ constexpr int dq_step() {
  return D == 64 ? 128 : D == 128 ? 64 : D == 192 ? 64 : 32;
}
// ring slots of each kernel (the budget of 227 KB decides; the dK / dV
// kernel at D = 192 and 256 is flash_bwd_dkdv_bf16_split_kernel,
// split_stages)
template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D == 64 ? 4 : 3;
}
template <int D>
__host__ __device__ constexpr int dkdv_stages() {
  return D == 64 ? 4 : 3;
}
// the dQ kernel's item slots of Q and dO: two (the next item's load under
// this one), one at D = 192 (80 KB a slot) and 256 (128 KB)
template <int D>
__host__ __device__ constexpr int dq_slots() {
  return D >= 192 ? 1 : 2;
}

// shared memory: 1 KiB to align the base to the swizzle's 1024-byte period,
// the item slots of Q and dO, the ring of K and V tiles, the barriers
template <int HD, int HV>
constexpr int dq_smem_bytes() {
  return 1024 + dq_slots<HD>() * ((HD + HV) / 64) * kBoxBig +
         dq_stages<HD>() * ((HD + HV) / 64) * dq_step<HD>() * 128 +
         (2 * dq_slots<HD>() + 4 * dq_stages<HD>()) * 8;
}
// two item slots of K and V; the ring of Q and dO tiles with their 64 lse2
// and D values; the barriers
template <int D>
constexpr int dkdv_smem_bytes() {
  return 1024 + 2 * 2 * (D / 64) * kBoxBig +
         dkdv_stages<D>() * (2 * (D / 64) * kBoxStep + 2 * kStep * 4) +
         (4 + 2 * dkdv_stages<D>()) * 8;
}
static_assert(dq_smem_bytes<64, 64>() <= 232448 &&
                  dq_smem_bytes<128, 128>() <= 232448 &&
                  dq_smem_bytes<192, 128>() <= 232448 &&
                  dq_smem_bytes<256, 256>() <= 232448,
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

template <int HD, int HV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const Params p) {
  static_assert((HD == HV && (HD == 64 || HD == 128 || HD == 256)) ||
                    (HD == 192 && HV == 128),
                "head dims of the wgmma dQ kernel");
  constexpr int BN = dq_step<HD>();
  constexpr int stages = dq_stages<HD>();
  constexpr int slots = dq_slots<HD>();
  constexpr int kBoxK = BN * 128;              // a 64-column box of K or V
  constexpr int kTileQ = (HD / 64) * kBoxBig;  // Q of an item
  constexpr int kTileO = (HV / 64) * kBoxBig;  // dO of an item
  constexpr int kTileK = (HD / 64) * kBoxK;    // a K tile
  constexpr int kTileV = (HV / 64) * kBoxK;    // a V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                       // [slots][kTileQ]
  uint8_t* sdO = sQ + slots * kTileQ;       // [slots][kTileO]
  uint8_t* sK = sdO + slots * kTileO;       // [stages][kTileK]
  uint8_t* sV = sK + stages * kTileK;       // [stages][kTileV]
  uint64_t* t_full = reinterpret_cast<uint64_t*>(sV + stages * kTileV);
  uint64_t* t_empty = t_full + slots;
  uint64_t* k_full = t_empty + slots;
  uint64_t* k_empty = k_full + stages;
  uint64_t* v_full = k_empty + stages;
  uint64_t* v_empty = v_full + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < slots; ++i) {
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
    const int kv_end = p.causal ? causal_end(p, (qb + 1) * kRows) : p.Sk;
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
        const int slot = j % slots;
        mbar_wait(&t_empty[slot], ((j / slots) & 1) ^ 1);
        mbar_arrive_expect_tx(&t_full[slot], kTileQ + kTileO);
#pragma unroll
        for (int cc = 0; cc < HD / 64; ++cc)
          tma_load_4d(sQ + slot * kTileQ + cc * kBoxBig, &tm_q, &t_full[slot],
                      64 * cc, h, qb * kRows, b);
#pragma unroll
        for (int cc = 0; cc < HV / 64; ++cc)
          tma_load_4d(sdO + slot * kTileO + cc * kBoxBig, &tm_do,
                      &t_full[slot], 64 * cc, h, qb * kRows, b);
        for (int it = 0; it < n_kv; ++it, ++ring) {
          const int st = ring % stages;
          const uint32_t free_parity = ((ring / stages) & 1) ^ 1;
          const int k0 = (n_kv - 1 - it) * BN;  // from the last down
          mbar_wait(&k_empty[st], free_parity);
          mbar_arrive_expect_tx(&k_full[st], kTileK);
#pragma unroll
          for (int cc = 0; cc < HD / 64; ++cc)
            tma_load_4d(sK + st * kTileK + cc * kBoxK, &tm_k, &k_full[st],
                        64 * cc, kvh, k0, b);
          mbar_wait(&v_empty[st], free_parity);
          mbar_arrive_expect_tx(&v_full[st], kTileV);
#pragma unroll
          for (int cc = 0; cc < HV / 64; ++cc)
            tma_load_4d(sV + st * kTileV + cc * kBoxK, &tm_v, &v_full[st],
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
  const int seq = p.S, keys = p.Sk;  // query rows, keys
  const bool causal = p.causal;
  const int prefix = p.prefix;

  float dq[HD / 2];                // dQ / scale
  float s[BN / 2], dp[BN / 2];     // S then dS / scale; dP
  uint32_t da[BN / 16][4];         // dS / scale in bf16: A fragments of dS K
  float dsum[2], l2[2];            // D and lse * log2 e of the 2 rows
  int row0 = 0, row_lo = 0;
  uint32_t q_addr = 0, do_addr = 0;

  // S = Q K^T and dP = dO V^T of ring slot st, 64 rows x BN keys, HD / 16
  // and HV / 16 steps of 16 (a box per 64 columns): K-major, 8-row groups
  // 1 KB apart, the step's 16 columns at +32 bytes inside the swizzled row.
  // One commit group, not waited for.  At (192, 128) and 256 the item's Q
  // and dO addresses pass an empty asm first, so that their 20 or 32
  // descriptors are made at each issue and not hoisted out of the kv loop
  // (64 registers at 256, which ptxas spilled)
  auto issue_sdp = [&](int st) {
    if constexpr (HD + HV > 256)
      asm volatile("" : "+r"(q_addr), "+r"(do_addr));
    const uint32_t k_addr = smem_u32(sK + st * kTileK);
    const uint32_t v_addr = smem_u32(sV + st * kTileV);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BN>(
          s, smem_desc(q_addr + (kk / 4) * kBoxBig + (kk % 4) * 32, 16, 1024),
          smem_desc(k_addr + (kk / 4) * kBoxK + (kk % 4) * 32, 16, 1024),
          kk > 0);
#pragma unroll
    for (int kk = 0; kk < HV / 16; ++kk)
      wgmma_ss<BN>(
          dp,
          smem_desc(do_addr + (kk / 4) * kBoxBig + (kk % 4) * 32, 16, 1024),
          smem_desc(v_addr + (kk / 4) * kBoxK + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
  };
  // dQ += dS K of slot st: K MN-major, key step j at +2 KB, the 64-wide
  // column boxes one box apart (LBO).  One commit group.
  auto issue_dq = [&](int st) {
    const uint32_t k_addr = smem_u32(sK + st * kTileK);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      wgmma_rs<HD>(dq, da[j], smem_desc(k_addr + j * 2048, kBoxK, 1024));
    wgmma_commit();
  };
  // P and dS / scale of kv tile kt (keys [kt BN, kt BN + BN)) in s, from S
  // in s and dP; on a tile past a row of the warpgroup (the diagonal, the
  // prefix's end) or with keys past Sk masked by selects (keys past Sk must
  // go: TMA zero-filled their K and V, so P there is 2^-lse2, which can
  // overflow)
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
          pe = (key >= keys || (causal && hidden(key, row, prefix))) ? 0.0f
                                                                     : pe;
        }
        s[4 * n + e] = pe * (dp[4 * n + e] - dsum[i]);
      }
  };
  auto ds_of = [&](int kt) {
    const int k0 = kt * BN;
    if (k0 + BN > keys || (causal && k0 + BN - 1 > row_lo))
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
    const int slot = j % slots;
    row_lo = qb * kRows + cw * 64;
    row0 = row_lo + frag_row;
    q_addr = smem_u32(sQ + slot * kTileQ) + cw * 64 * 128;
    do_addr = smem_u32(sdO + slot * kTileO) + cw * 64 * 128;

    // D = rowsum(dO o O) and lse of this thread's two rows: the quad's four
    // threads take HV / 4 columns each; written to the scratch for the dK /
    // dV kernel, zeros on the rows past S
    const bf16* op = base<const bf16, kO>(p, p.o, b, h);
    const bf16* dop = base<const bf16, kDO>(p, p.dout, b, h);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      float acc = 0.0f;
      if (row < seq) {
        const uint4* orow = reinterpret_cast<const uint4*>(
            op + row * row_stride<kO>(p) + t4 * (HV / 4));
        const uint4* drow = reinterpret_cast<const uint4*>(
            dop + row * row_stride<kDO>(p) + t4 * (HV / 4));
#pragma unroll
        for (int c = 0; c < HV / 32; ++c) {
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
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.0f;
    const bool last_item = j + 1 == n_mine;

    // kv tile 0 (the diagonal one, or the prefix's last, under causal): S
    // and dP, then dS
    mbar_wait(&t_full[slot], (j / slots) & 1);
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
      for (int n = 0; n < HD / 8; ++n)
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
  // from the first that sees the block's keys (row 0 where a key of the
  // block lies in the prefix)
  const int nk = (p.Sk + kRows - 1) / kRows;
  const int nq = (p.S + kStep - 1) / kStep;
  const int G = p.H / p.KV;
  const int first = p.sched_kv[blockIdx.x];
  const int n_mine = p.sched_kv[blockIdx.x + 1] - first;
  const int* items = p.sched_kv + gridDim.x + 1 + first;
  auto first_q = [&](int kb) {
    return p.causal && kb * kRows >= p.prefix ? kb * (kRows / kStep) : 0;
  };

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
  const int keys = p.Sk;

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
  // diagonal (or before it, inside the prefix), P^T = 0 for a key after the
  // query and past the prefix, by selects.  Queries past
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
          pe = hidden(key, q0 + col + (e & 1), p.prefix) ? 0.0f : pe;
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
      if (key >= keys) continue;
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

// dK / dV at D = 192 and 256: a 64 x 256 float32 accumulator is 128
// registers a thread, and at (192, 128) dK (96) and dV (64) with S^T and
// dP^T would be ~224, so one warpgroup does not hold dK beside dV.  The
// two consumer warpgroups split them: warpgroup 0 (the P warpgroup)
// computes S^T = K Q^T and P^T, hands P^T (float32) to warpgroup 1 through
// shared memory and adds P^T dO to dV; warpgroup 1 (the dS warpgroup)
// computes dP^T = V dO^T, dS^T = P^T (dP^T - D) and adds dS^T Q to dK --
// the float32 kernels' warp-pair split lifted to warpgroups.  At (192, 128)
// the two sides differ in width: the P warpgroup's scores run over HD = 192
// columns and its dV over HV = 128, the dS warpgroup's scores over 128 and
// its dK over 192 (one wgmma.m64n192k16 a 16-row step).  An item is kStep
// keys of ONE head, so that MQA / GQA give as many items as heads times key
// blocks; with GQA (at 256 only) each item writes float32 partials that
// flash_bwd_dkdv_sum_f32_kernel adds by group in head order.
constexpr int kSplitPt = 128 * (kStep / 2);  // floats of a P^T buffer

// Q / dO ring slots of the split kernel (D the Q K^T width): 2 at 256 (64
// KB a pair), 3 at (192, 128) (40 KB)
template <int D>
__host__ __device__ constexpr int split_stages() {
  return D == 256 ? 2 : 3;
}

// shared memory: 1 KiB to align the base, the item's K and V (64 keys),
// the ring of Q and dO tiles (64 rows) with their lse2 and D, two P^T
// buffers (one float32 fragment a thread), the barriers
template <int HD, int HV>
constexpr int split_smem_bytes() {
  return 1024 + ((HD + HV) / 64) * kBoxStep +
         split_stages<HD>() * (((HD + HV) / 64) * kBoxStep + 2 * kStep * 4) +
         2 * kSplitPt * 4 + (2 + 2 * split_stages<HD>() + 4) * 8;
}
static_assert(split_smem_bytes<192, 128>() <= 232448 &&
                  split_smem_bytes<256, 256>() <= 232448,
              "a block's shared memory is 227 KB");

template <int HD, int HV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_bf16_split_kernel(const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_do,
                                 const Params p) {
  static_assert((HD == 256 && HV == 256) || (HD == 192 && HV == 128),
                "the split dK / dV kernel's head dims");
  constexpr int stages = split_stages<HD>();
  constexpr int kTileK = (HD / 64) * kBoxStep;  // K, or a Q tile
  constexpr int kTileV = (HV / 64) * kBoxStep;  // V, or a dO tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = sK + kTileK;
  uint8_t* sQ = sV + kTileV;              // [stages][kTileK]
  uint8_t* sdO = sQ + stages * kTileK;    // [stages][kTileV]
  float* sL = reinterpret_cast<float*>(sdO + stages * kTileV);  // [stages][64]
  float* sD = sL + stages * kStep;                              // [stages][64]
  float* sP = sD + stages * kStep;                  // [2][kSplitPt]: P^T
  uint64_t* t_full = reinterpret_cast<uint64_t*>(sP + 2 * kSplitPt);
  uint64_t* t_empty = t_full + 1;
  uint64_t* q_full = t_empty + 1;
  uint64_t* q_empty = q_full + stages;
  uint64_t* p_full = q_empty + stages;
  uint64_t* p_empty = p_full + 2;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(t_full, 1);
    mbar_init(t_empty, kConsumerWarps);
    for (int st = 0; st < stages; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&q_empty[st], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {  // every thread of a warpgroup arrives
      mbar_init(&p_full[i], 128);
      mbar_init(&p_empty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's items: (b * H + h) * nk + key block, heaviest first; each
  // walks its head's q tiles of 64 rows from the first that sees the
  // block's keys (row 0 where a key of the block lies in the prefix)
  const int nk = (p.Sk + kStep - 1) / kStep;
  const int nq = (p.S + kStep - 1) / kStep;
  const int first = p.sched_kv[blockIdx.x];
  const int n_mine = p.sched_kv[blockIdx.x + 1] - first;
  const int* items = p.sched_kv + gridDim.x + 1 + first;
  auto first_q = [&](int kb) {
    return p.causal && kb * kStep >= p.prefix ? kb : 0;
  };

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
        const int bh = item / nk, kb = item % nk;
        const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
        mbar_wait(t_empty, (j & 1) ^ 1);
        mbar_arrive_expect_tx(t_full, kTileK + kTileV);
#pragma unroll
        for (int cc = 0; cc < HD / 64; ++cc)
          tma_load_4d(sK + cc * kBoxStep, &tm_k, t_full, 64 * cc, kvh,
                      kb * kStep, b);
#pragma unroll
        for (int cc = 0; cc < HV / 64; ++cc)
          tma_load_4d(sV + cc * kBoxStep, &tm_v, t_full, 64 * cc, kvh,
                      kb * kStep, b);
        for (int qt = first_q(kb); qt < nq; ++qt, ++ring) {
          const int st = ring % stages;
          mbar_wait(&q_empty[st], ((ring / stages) & 1) ^ 1);
          mbar_arrive_expect_tx(&q_full[st],
                                kTileK + kTileV + 2 * kStep * 4);
#pragma unroll
          for (int cc = 0; cc < HD / 64; ++cc)
            tma_load_4d(sQ + st * kTileK + cc * kBoxStep, &tm_q, &q_full[st],
                        64 * cc, h, qt * kStep, b);
#pragma unroll
          for (int cc = 0; cc < HV / 64; ++cc)
            tma_load_4d(sdO + st * kTileV + cc * kBoxStep, &tm_do,
                        &q_full[st], 64 * cc, h, qt * kStep, b);
          const int64_t at = (int64_t)bh * p.s_pad + qt * kStep;
          bulk_load(sL + st * kStep, p.lse2 + at, kStep * 4, &q_full[st]);
          bulk_load(sD + st * kStep, p.dd + at, kStep * 4, &q_full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: both own the item's 64 keys; cw 0 makes P^T and dV,
  // cw 1 dS^T and dK ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = tid / 128 - 1;
  const int t = tid & 127, lane = t & 31, t4 = lane & 3;
  const int frag_row = (t >> 5) * 16 + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  const bool pgroup = cw == 0;

  // One warpgroup's side, KD the scores' reduction width (HD for S^T = K
  // Q^T, HV for dP^T = V dO^T), AD its accumulator's (HV for dV += P^T dO,
  // HD for dK += dS^T Q).  The scores' A is the item's K or V (64 keys,
  // K-major), their B the ring's Q or dO tile (K-major); the
  // accumulation's B is the ring's dO or Q tile (MN-major).
  auto consume = [&](auto kd, auto ad) {
    constexpr int KD = decltype(kd)::value, AD = decltype(ad)::value;
    constexpr int kTileB = (KD / 64) * kBoxStep, kTileM = (AD / 64) * kBoxStep;
    const uint32_t a_addr = smem_u32(pgroup ? sK : sV);
    const uint8_t* sB = pgroup ? sQ : sdO;
    const uint8_t* sM = pgroup ? sdO : sQ;

    float acc[AD / 2];             // dV (P warpgroup), dK / scale (dS)
    float c[kStep / 2];            // S^T then P^T; dP^T then dS^T / scale
    uint32_t a[kStep / 16][4];     // P^T or dS^T in bf16: A of the accumulation
    int ring = 0;                  // the Q / dO slot sequence, as the loader's
    int u = 0;                     // the P^T hand-over sequence
    for (int j = 0; j < n_mine; ++j) {
      const int item = items[j];
      const int bh = item / nk, kb = item % nk;
      const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
      const int key_lo = kb * kStep, key0 = key_lo + frag_row;
      const int qt0 = first_q(kb), steps = nq - qt0;
#pragma unroll
      for (int i = 0; i < AD / 2; ++i) acc[i] = 0.0f;
      mbar_wait(t_full, j & 1);
      for (int i = 0; i < steps; ++i, ++ring, ++u) {
        const int st = ring % stages, q0 = (qt0 + i) * kStep;
        mbar_wait(&q_full[st], (ring / stages) & 1);
        // S^T = K Q^T or dP^T = V dO^T: 64 keys x 64 rows, KD / 16 steps
        const uint32_t b_addr = smem_u32(sB + st * kTileB);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KD / 16; ++kk)
          wgmma_ss_m64n64k16(
              c, smem_desc(a_addr + (kk / 4) * kBoxStep + (kk % 4) * 32, 16,
                           1024),
              smem_desc(b_addr + (kk / 4) * kBoxStep + (kk % 4) * 32, 16,
                        1024),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(c);
        if (lane == 0 && i == steps - 1) mbar_arrive(t_empty);  // K or V done
        const int buf = u & 1;
        const uint32_t phase = (u >> 1) & 1;
        float4* pt = reinterpret_cast<float4*>(sP + buf * kSplitPt) + t;
        if (pgroup) {
          // P^T, lse2 per column; on a tile with the diagonal (or before
          // it, inside the prefix) 0 for a key after the row and past the
          // prefix, by selects.  Rows past S need no mask: their Q and dO
          // are TMA's zeros and their lse2 and D the scratch's, so P^T = 1,
          // dV gains 0 and dS^T is 0.
          const float* L = sL + st * kStep;
          const bool masked = p.causal && key_lo + kStep - 1 > q0;
#pragma unroll
          for (int n = 0; n < kStep / 8; ++n) {
            const int col = n * 8 + t4 * 2;
            const float2 lc = *reinterpret_cast<const float2*>(L + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pe =
                  fast_exp2(fmaf(c[4 * n + e], sl2, (e & 1) ? -lc.y : -lc.x));
              const int key = key0 + 8 * (e >> 1);
              c[4 * n + e] =
                  masked && hidden(key, q0 + col + (e & 1), p.prefix) ? 0.0f
                                                                      : pe;
            }
          }
          mbar_wait(&p_empty[buf], phase ^ 1);
#pragma unroll
          for (int n = 0; n < kStep / 8; ++n)
            pt[n * 128] = make_float4(c[4 * n], c[4 * n + 1], c[4 * n + 2],
                                      c[4 * n + 3]);
          mbar_arrive(&p_full[buf]);
        } else {
          // dS^T / scale = P^T (dP^T - D), D per column
          const float* Dd = sD + st * kStep;
          mbar_wait(&p_full[buf], phase);
#pragma unroll
          for (int n = 0; n < kStep / 8; ++n) {
            const int col = n * 8 + t4 * 2;
            const float2 dc = *reinterpret_cast<const float2*>(Dd + col);
            const float4 pe = pt[n * 128];
            c[4 * n] = pe.x * (c[4 * n] - dc.x);
            c[4 * n + 1] = pe.y * (c[4 * n + 1] - dc.y);
            c[4 * n + 2] = pe.z * (c[4 * n + 2] - dc.x);
            c[4 * n + 3] = pe.w * (c[4 * n + 3] - dc.y);
          }
          mbar_arrive(&p_empty[buf]);
        }
        // dV += P^T dO or dK / scale += (dS^T / scale) Q: A from registers,
        // B the tile as MN-major, row step jj at +2 KB, 64-column boxes one
        // box apart (LBO)
#pragma unroll
        for (int jj = 0; jj < kStep / 16; ++jj) c_to_a(a[jj], c + 8 * jj);
        const uint32_t m_addr = smem_u32(sM + st * kTileM);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < kStep / 16; ++jj)
          wgmma_rs<AD>(acc, a[jj],
                       smem_desc(m_addr + jj * 2048, kBoxStep, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int jj = 0; jj < kStep / 16; ++jj) fence_frag(a[jj]);
        if (lane == 0) mbar_arrive(&q_empty[st]);
      }

      // this thread's two keys: dk or dv without GQA; with it (hd == hv)
      // the head's float32 partials, rows of H AD floats
      const float mul = pgroup ? 1.0f : p.scale;
      bool direct = true;
      if constexpr (HD == HV) direct = p.H == p.KV;
      if (direct) {
        bf16* out = pgroup ? base<bf16, kDV>(p, p.dv, b, kvh)
                           : base<bf16, kDK>(p, p.dk, b, kvh);
        const int64_t rs = pgroup ? row_stride<kDV>(p) : row_stride<kDK>(p);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = key0 + 8 * i;
          if (key >= p.Sk) continue;
          bf16* o = out + u64(key) * rs;
#pragma unroll
          for (int n = 0; n < AD / 8; ++n)
            *reinterpret_cast<uint32_t*>(o + n * 8 + t4 * 2) = pack_bf16(
                acc[4 * n + 2 * i] * mul, acc[4 * n + 2 * i + 1] * mul);
        }
      } else {
        float* out = p.part + (pgroup ? p.part_half : 0) +
                     (u64(b) * p.Sk * p.H + h) * AD;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = key0 + 8 * i;
          if (key >= p.Sk) continue;
          float* o = out + u64(key) * p.H * AD;
#pragma unroll
          for (int n = 0; n < AD / 8; ++n)
            *reinterpret_cast<float2*>(o + n * 8 + t4 * 2) = make_float2(
                acc[4 * n + 2 * i] * mul, acc[4 * n + 2 * i + 1] * mul);
        }
      }
    }
  };
  if constexpr (HD == HV)
    consume(std::integral_constant<int, HD>(),
            std::integral_constant<int, HD>());
  else if (pgroup)
    consume(std::integral_constant<int, HD>(),
            std::integral_constant<int, HV>());
  else
    consume(std::integral_constant<int, HV>(),
            std::integral_constant<int, HD>());
}

// --- TF32 tensor cores on mma.sync: float32 as 3xTF32 ---------------------------

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

// shared rows are D elements and 16 bytes: for float32 a row stride of 4
// (mod 32) words puts both ways a tile is read on 32 distinct banks --
// element [g][t] (A fragments, B of S = Q K^T) at bank 4 g + t, element
// [2 t][g] (B of dQ = dS K, dV = P^T dO, dK = dS^T Q) at 8 t + g -- and
// keeps every row whole 16-byte chunks for cp.async
template <int D>
__host__ __device__ constexpr int row_ld() {
  return D + 4;
}
// a Q (or K) row of HD and a dO (or V) row of HV elements
template <int HD, int HV>
__host__ __device__ constexpr int pair_bytes() {
  return (row_ld<HD>() + row_ld<HV>()) * 4;
}
template <int HD, int HV>
constexpr int f32_dq_smem_bytes() {  // Q, dO; the ring's K, V
  return (kF + kFStages * f32_step<HD>()) * pair_bytes<HD, HV>();
}
// a dK / dV ring slot: Q and dO tiles, then their float32 lse and D
template <int HD, int HV>
__host__ __device__ constexpr int f32_slot_bytes() {
  return f32_step<HD>() * pair_bytes<HD, HV>() + 2 * f32_step<HD>() * 4;
}
template <int HD, int HV>
constexpr int f32_dkdv_smem_bytes() {  // K, V; P^T; the ring
  return kF * pair_bytes<HD, HV>() + kF * (f32_step<HD>() + 8) * 4 +
         kFStages * f32_slot_bytes<HD, HV>();
}
static_assert(f32_dq_smem_bytes<128, 128>() <= 232448 &&
                  f32_dkdv_smem_bytes<128, 128>() <= 232448,
              "a block's shared memory is 227 KB");

// two adjacent outputs
__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared::cta.global [%0], [%1], 4, %2;\n" ::"r"(
                   dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [r0, r0 + ROWS) of a [S, D] float32 view (row stride st) into shared
// rows of row_ld<D>() elements, by 16-byte cp.async; zeros past S
template <int D, int ROWS, int THREADS = kFThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t st, int r0, int S) {
  constexpr int kPer = 4;  // elements a 16-byte chunk
  constexpr int kChunks = D / kPer, LD = row_ld<D>();
  // a last partial round only where the chunks are no whole number of
  // rounds
  constexpr int kRounds = (ROWS * kChunks + THREADS - 1) / THREADS;
  constexpr bool kWhole = ROWS * kChunks % THREADS == 0;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = (int)threadIdx.x + j * THREADS;
    if (!kWhole && i >= ROWS * kChunks) break;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < S;
    cp_async16(smem_u32(dst + r * LD + kPer * c),
               src + (ok ? u64(r0 + r) * st + kPer * c : 0), ok);
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
  constexpr int LD = row_ld<D>();
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
  constexpr int LD = row_ld<D>();
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
// from key 0 to the item's last row or the prefix's end, whichever lies
// further (to Sk when not causal).  D of the rows goes to the scratch for
// the dK / dV kernel.  Q and K rows are HD wide, dO and V rows HV.
template <int HD, int HV>
__global__ void __launch_bounds__(kFThreads, 2)
flash_bwd_dq_f32_tc_kernel(const Params p) {
  constexpr int LD = row_ld<HD>(), LV = row_ld<HV>();
  constexpr int KT = f32_step<HD>(), NT = KT / 8, SLOT = KT * (LD + LV);
  extern __shared__ __align__(16) uint8_t fsm[];
  float* Qs = reinterpret_cast<float*>(fsm);  // [kF][LD]
  float* dOs = Qs + kF * LD;              // [kF][LV]
  float* ring = dOs + kF * LV;            // kFStages x (K [KT][LD], V [KT][LV])

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

  load_rows<HD, kF>(Qs, base<const float, kQ>(p, p.q, b, h),
                       row_stride<kQ>(p), q0, p.S);
  load_rows<HV, kF>(dOs, base<const float, kDO>(p, p.dout, b, h),
                       row_stride<kDO>(p), q0, p.S);
  cp_async_commit();
  const int kv_end = p.causal ? causal_end(p, q0 + kF) : p.Sk;
  const int tiles = (kv_end + KT - 1) / KT;
  load_rows<HD, KT>(ring, kp, row_stride<kK>(p), 0, p.Sk);
  load_rows<HV, KT>(ring + KT * LD, vp, row_stride<kV>(p), 0, p.Sk);
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
        for (int j = 0; j < HV / 32; ++j)
          acc = fmaf(dOs[(16 * warp + r) * LV + lane + 32 * j],
                     orow[lane + 32 * j], acc);
      }
      acc = warp_sum(acc);
      if (r == g) dd[0] = acc;
      if (r == g + 8) dd[1] = acc;
      if (lane == 0 && row < p.S) p.dd[lrow + row] = acc;
    }
  }

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      float* nxt = ring + ((it + 1) % kFStages) * SLOT;
      load_rows<HD, KT>(nxt, kp, row_stride<kK>(p), (it + 1) * KT, p.Sk);
      load_rows<HV, KT>(nxt + KT * LD, vp, row_stride<kV>(p),
                           (it + 1) * KT, p.Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * KT;
    // a tile whose keys all lie above the warp's rows and past the prefix
    // adds nothing to them
    if (!p.causal || k0 <= r0 + 15 || k0 < p.prefix) {
      const float* Ks = ring + (it % kFStages) * SLOT;
      const float* Vs = Ks + KT * LD;
      float s[NT][4], dp[NT][4];
      scores_f32<HD, NT>(Qs, Ks, 16 * warp, g, t, s);
      scores_f32<HV, NT>(dOs, Vs, 16 * warp, g, t, dp);
      // P = exp(S scale - lse), 0 for keys past Sk or hidden from the row;
      // dS / scale = P (dP - D) into dp
      const bool edge = k0 + KT > p.Sk || (p.causal && k0 + KT - 1 > r0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = expf(s[n][e] * p.scale - lse[e >> 1]);
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          if (edge && (key >= p.Sk ||
                       (p.causal && hidden(key, row, p.prefix))))
            pe = 0.0f;
          dp[n][e] = pe * (dp[n][e] - dd[e >> 1]);
        }
      accumulate_f32<HD, NT>(dp, Ks, g, t, dq);
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
    for (int n = 0; n < HD / 8; ++n)
      store2(out + 8 * n + 2 * t, dq[n][2 * i] * p.scale,
             dq[n][2 * i + 1] * p.scale);
  }
}

// dK / dV: an item is kF keys and one head, blockIdx.x = (the item's key
// block, heaviest first under causal) * B H + b H + h.  K and V of the
// head's kv head stay; the head's Q and dO tiles of f32_step rows, with
// their lse and D (the dQ kernel's scratch), stream through a ring of
// kFStages slots from the first row that sees the item's keys (row 0 for
// an item that holds a key of the prefix).  Warps 2 w and 2 w + 1 share
// the keys 16 w .. 16 w + 15: per tile the first (the P
// warp) computes S^T and P^T, hands P^T to the second through shared
// memory and adds P^T dO to dV; the second (the dS warp) computes dP^T and
// dS^T = P^T (dP^T - D) and adds dS^T Q to dK.  Each warp runs 2 of the 4
// products and holds one accumulator, so neither holds dK and dV (128
// registers a thread at D = 128) beside the scores.  Without GQA the item
// writes dk, dv; with it, its head's float32 partials, which
// flash_bwd_dkdv_sum_f32_kernel adds up by group in head order.
// rows [qt0, qt0 + f32_step) of head h's Q and dO, with their lse and D,
// into a dK / dV ring slot: [QT][LD] Q, then [QT][LV] dO, then QT lse,
// QT D (float32)
template <int HD, int HV>
__device__ __forceinline__ void load_q_tile(const Params& p, uint8_t* slot,
                                            int b, int h, int qt0) {
  constexpr int QT = f32_step<HD>(), LD = row_ld<HD>();
  constexpr int LV = row_ld<HV>();
  float* q = reinterpret_cast<float*>(slot);
  load_rows<HD, QT, kKVThreads>(q, base<const float, kQ>(p, p.q, b, h),
                                   row_stride<kQ>(p), qt0, p.S);
  load_rows<HV, QT, kKVThreads>(q + QT * LD,
                                   base<const float, kDO>(p, p.dout, b, h),
                                   row_stride<kDO>(p), qt0, p.S);
  float* stats = reinterpret_cast<float*>(q + QT * (LD + LV));
  const int row = qt0 + (int)threadIdx.x % QT;
  const float* src = threadIdx.x < QT ? p.lse : p.dd;
  if (threadIdx.x < 2 * QT)
    cp_async4(smem_u32(stats + threadIdx.x),
              src + (row < p.S ? u64(b * p.H + h) * p.S + row : 0),
              row < p.S);
}

template <int HD, int HV>
__global__ void __launch_bounds__(kKVThreads, 2)
flash_bwd_dkdv_f32_tc_kernel(const Params p) {
  static_assert(HD == HV, "dK and dV share one accumulator width");
  constexpr int LD = row_ld<HD>(), LV = row_ld<HV>();
  constexpr int QT = f32_step<HD>(), NT = QT / 8;
  constexpr int LP = QT + 8;
  extern __shared__ __align__(16) uint8_t fsm[];
  float* Ks = reinterpret_cast<float*>(fsm);                   // [kF][LD]
  float* Vs = Ks + kF * LD;                                // [kF][LV]
  float* Pt = reinterpret_cast<float*>(Vs + kF * LV);  // [kF][LP]: P^T
  uint8_t* ring = reinterpret_cast<uint8_t*>(Pt + kF * LP);  // the slots

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool pwarp = (warp & 1) == 0;
  const int r16 = 16 * (warp >> 1);  // the warp's first key in the item
  const int nk = (p.Sk + kF - 1) / kF, BH = (int)gridDim.x / nk;
  const int kb = (int)blockIdx.x / BH, bh = (int)blockIdx.x % BH;
  const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
  const int k0 = kb * kF, key0 = k0 + r16;
  load_rows<HD, kF, kKVThreads>(Ks, base<const float, kK>(p, p.k, b, kvh),
                                   row_stride<kK>(p), k0, p.Sk);
  load_rows<HV, kF, kKVThreads>(Vs, base<const float, kV>(p, p.v, b, kvh),
                                   row_stride<kV>(p), k0, p.Sk);
  cp_async_commit();

  // the query tiles of one head, from the first that sees a key here
  // (k0 is a multiple of QT; every row sees a key of the prefix)
  const int qs0 = p.causal && k0 >= p.prefix ? k0 : 0;
  constexpr int kSlot = f32_slot_bytes<HD, HV>();
  load_q_tile<HD, HV>(p, ring, b, h, qs0);
  cp_async_commit();

  // P warp: dV (its first HV / 8 column groups); dS warp: dK / scale
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const float* A = pwarp ? Ks : Vs;
  // this thread's two keys' hidden_below: a row before it masks P^T
  const int below[2] = {hidden_below(key0 + g, p.prefix),
                        hidden_below(key0 + g + 8, p.prefix)};
  for (int qt0 = qs0, i = 0; qt0 < p.S; qt0 += QT, i ^= 1) {
    if (qt0 + QT < p.S)
      load_q_tile<HD, HV>(p, ring + (i ^ 1) * kSlot, b, h, qt0 + QT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qs = reinterpret_cast<const float*>(ring + i * kSlot);
    const float* dOs = Qs + QT * LD;
    const float* Ls = reinterpret_cast<const float*>(dOs + QT * LV);
    const float* Ds = Ls + QT;
    // a tile whose rows all lie before the warp's keys, where none of them
    // is in the prefix, adds nothing to them
    const bool active =
        !p.causal || qt0 + QT - 1 >= key0 || key0 < p.prefix;
    float c[NT][4];  // P warp: S^T, then P^T; dS warp: dP^T, then dS^T
    if (active) {
      scores_f32<HD, NT>(A, pwarp ? Qs : dOs, r16, g, t, c);
      if (pwarp) {
        // P^T, 0 for rows past S or keys hidden from the row
        const bool edge = qt0 + QT > p.S || (p.causal && qt0 < key0 + 15);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = 8 * n + 2 * t + (e & 1), row = qt0 + ql;
            float pe = expf(c[n][e] * p.scale - Ls[ql]);
            if (edge && (row >= p.S || (p.causal && row < below[e >> 1])))
              pe = 0.0f;
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
      accumulate_f32<HD, NT>(c, pwarp ? dOs : Qs, g, t, acc);
    }
    __syncthreads();  // the slot and P^T are refilled next
  }

  const float mul = pwarp ? 1.0f : p.scale;
  // the rows of this thread's two keys: dk, dv without GQA; with it the
  // head's float32 partials, rows of H D floats (one code path for
  // float32: two cost the 128-register budget a spill at D = 128)
  auto write = [&](float* out, int64_t st) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + g + 8 * i;
      if (key >= p.Sk) continue;
      float* o = out + u64(key) * st;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        store2(o + 8 * n + 2 * t, acc[n][2 * i] * mul,
               acc[n][2 * i + 1] * mul);
    }
  };
  if (p.H == p.KV)
    write(pwarp ? base<float, kDV>(p, p.dv, b, kvh)
                : base<float, kDK>(p, p.dk, b, kvh),
          pwarp ? row_stride<kDV>(p) : row_stride<kDK>(p));
  else
    write(p.part + (pwarp ? p.part_half : 0) +
              (u64(b) * p.Sk * p.H + h) * HD,
          (int64_t)p.H * HD);
}

// four adjacent outputs, rounded to T
__device__ __forceinline__ void store4(float* out, float4 x) {
  *reinterpret_cast<float4*>(out) = x;
}
__device__ __forceinline__ void store4(bf16* out, float4 x) {
  *reinterpret_cast<uint2*>(out) = make_uint2(pack_bf16(x.x, x.y),
                                              pack_bf16(x.z, x.w));
}

// dK and dV with GQA: for each (b, key, kv head), the sum of the group's G
// float32 partials in head order (the same order in every run); 4 columns
// a thread
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum_f32_kernel(const Params p, int B) {
  const int G = p.H / p.KV;
  const int64_t total = (int64_t)B * p.Sk * p.KV * (D / 4);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % (D / 4));
    const int64_t r = i / (D / 4);
    const int kvh = (int)(r % p.KV), key = (int)(r / p.KV % p.Sk);
    const int b = (int)(r / p.KV / p.Sk);
    const float* src = p.part + (((int64_t)b * p.Sk + key) * p.H + kvh * G) * D
                       + 4 * c;
    float4 k4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), v4 = k4;
    for (int gi = 0; gi < G; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(src + gi * D);
      const float4 y =
          *reinterpret_cast<const float4*>(src + p.part_half + gi * D);
      k4.x += x.x; k4.y += x.y; k4.z += x.z; k4.w += x.w;
      v4.x += y.x; v4.y += y.y; v4.z += y.z; v4.w += y.w;
    }
    store4(base<T, kDK>(p, p.dk, b, kvh) + key * row_stride<kDK>(p) + 4 * c,
           k4);
    store4(base<T, kDV>(p, p.dv, b, kvh) + key * row_stride<kDV>(p) + 4 * c,
           v4);
  }
}

// --- float32 at (192, 128) and hd 256: 3xTF32 on wgmma ---------------------------
//
// flash_bwd_f32_wgmma_kernel<kDQ | kDK | kDV, HD, HV> (module header).  A
// pre-pass (flash_bwd_f32_t_kernel: q, k, do; flash_bwd_f32_split_kernel:
// v; flash_bwd_f32_dd_kernel) writes every operand split into TF32 hi and
// lo into the float32 scratch -- q, k, v, do as they lie, q, k and do
// transposed (reduction index contiguous, in tf32_key order inside each 8)
// -- and D = rowsum(dO o); then three launches of one kernel, each a pass
// over its items with one consumer warpgroup and a loader warp:
//   kDQ: an item is 64 query rows of one head; Q resident; per kv tile S
//        = Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K (K^T streamed);
//   kDK: an item is 64 keys of one head; K resident; per q tile S^T = K
//        Q^T, dP^T = V dO^T, dS^T, dK += dS^T Q (Q^T streamed);
//   kDV: an item is 64 keys; K resident; per q tile S^T, P^T, dV += P^T dO
//        (dO^T streamed).
// Only the HD-wide resident (Q or K) stays in shared memory; every
// streamed operand comes as 32 KB chunks (hi and lo) through the ring.
// With GQA an item is one query head's; q, do and their copies are laid
// out over the B H query heads, k, v and theirs over the B KV kv heads, and
// the dK and dV items write per-head float32 partials that
// flash_bwd_dkdv_sum_f32_kernel adds in head order.

constexpr int kB3Rows = 64;       // rows of an item and of a streamed tile
constexpr int kB3Threads = 160;   // the consumer warpgroup, the loader warp
constexpr int kB3Box = 8192;      // 64 rows of 32 floats (128 bytes)
constexpr int kB3Slot = 4 * kB3Box;  // a chunk: two boxes' hi and lo
enum { kPassDQ = 0, kPassDK = 1, kPassDV = 2 };

// ring slots: 4 beside (192, 128)'s resident of 96 KB, 3 beside hd 256's
// 128 KB.  With 3 a dP chunk takes one slot (32 columns of A and of B), so
// that the loader keeps a slot ahead; with 4 two (64 columns of each)
template <int HD>
__host__ __device__ constexpr int b3_slots() {
  return HD == 256 ? 3 : 4;
}
// bytes of the dK / dV passes' staged lse2 and D at hd 256: two buffers (q
// tiles in turns) of 64 of each, float32 (at (192, 128) each thread loads
// its 16 columns' into registers ahead of their use; beside hd 256's 128
// output registers those 32 would spill)
template <int HD>
__host__ __device__ constexpr int b3_stat_bytes() {
  return HD == 256 ? 2 * 2 * kB3Rows * 4 : 0;
}

// shared memory: the 1 KiB alignment of the swizzle's period; the resident
// tile's hi and lo (64 rows of HD floats), the ring, the staged lse2 and D,
// the barriers (the resident's full, a full / empty pair a slot)
template <int HD, int HV>
__host__ __device__ constexpr int b3_smem_bytes() {
  return 1024 + 2 * kB3Rows * HD * 4 + b3_slots<HD>() * kB3Slot +
         b3_stat_bytes<HD>() + (1 + 2 * b3_slots<HD>()) * 8;
}
static_assert(b3_smem_bytes<192, 128>() <= 232448 &&
                  b3_smem_bytes<256, 256>() <= 232448,
              "a block's shared memory is 227 KB");

// v as TF32 hi and lo (hopper.cuh split_rows)
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_f32_split_kernel(const float* src, int64_t sb, int64_t ss,
                           int64_t sh, int S, int heads, int64_t total,
                           float* dst, int64_t half) {
  split_rows<D>(src, sb, ss, sh, S, heads, total, dst, half);
}

// q, k, do as TF32 hi and lo, transposed and as they lie (hopper.cuh
// split_tile)
template <int W>
__global__ void __launch_bounds__(256)
flash_bwd_f32_t_kernel(const float* src, int64_t sb, int64_t ss, int64_t sh,
                       int S, int heads, int sp, float* dst, int64_t half,
                       float* rows, int64_t rows_half) {
  split_tile<W>(src, sb, ss, sh, S, heads, sp, dst, half, rows, rows_half);
}

// D [B H, S] = rowsum(dO o), float32: one warp a row, in a fixed order
template <int HV>
__global__ void __launch_bounds__(256)
flash_bwd_f32_dd_kernel(const Params p, int B) {
  const int64_t rows = (int64_t)B * p.H * p.S;
  const int lane = threadIdx.x & 31;
  for (int64_t r = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
       r < rows; r += (int64_t)gridDim.x * blockDim.x / 32) {
    const int s = (int)(r % p.S);
    const int64_t bh = r / p.S;
    const int b = (int)(bh / p.H), h = (int)(bh % p.H);
    const float* dor = base<const float, kDO>(p, p.dout, b, h) +
                       u64(s) * row_stride<kDO>(p);
    const float* orow = base<const float, kO>(p, p.o, b, h) +
                        u64(s) * row_stride<kO>(p);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < HV / 32; ++j)
      acc = fmaf(dor[lane + 32 * j], orow[lane + 32 * j], acc);
    acc = warp_sum(acc);
    if (lane == 0) p.dd[r] = acc;
  }
}

template <int MODE, int HD, int HV>
__global__ void __launch_bounds__(kB3Threads, 1)
flash_bwd_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a1,
                           const __grid_constant__ CUtensorMap tm_a2,
                           const __grid_constant__ CUtensorMap tm_b1,
                           const __grid_constant__ CUtensorMap tm_b2,
                           const __grid_constant__ CUtensorMap tm_bt,
                           const Params p) {
  static_assert((HD == 192 && HV == 128) || (HD == 256 && HV == 256),
                "the (192, 128) and the hd-256 passes");
  constexpr bool kByRow = MODE == kPassDQ;  // item rows are query rows
  constexpr bool kDP = MODE != kPassDV;     // dP (and dS) computed
  constexpr int W = MODE == kPassDV ? HV : HD;  // output width
  constexpr int NB = W / 64;                    // output column blocks
  constexpr int kSlots = b3_slots<HD>();
  constexpr bool kOneSlotDP = kSlots == 3;  // a dP chunk: 32 columns, 1 slot
  constexpr bool kStage = b3_stat_bytes<HD>() > 0 && !kByRow;
  constexpr int kA1 = 2 * kB3Rows * HD * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA1 = smem;             // HD / 32 boxes of hi, lo
  uint8_t* ring = sA1 + kA1;
  float* stat = reinterpret_cast<float*>(ring + kSlots * kB3Slot);
  uint64_t* res_full =
      reinterpret_cast<uint64_t*>(ring + kSlots * kB3Slot +
                                  b3_stat_bytes<HD>());
  uint64_t* full = res_full + 1;
  uint64_t* empty = full + kSlots;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int st = 0; st < kSlots; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);  // one lane per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the item: query head bh's tile ib (query rows for kDQ, keys
  // otherwise), head by head, inside a head heaviest first under causal;
  // its kv head kvbh.  The item's own operands (the resident, A2) lie over
  // the heads of its rows, the streamed tiles' over the others'
  const int n_items = kByRow ? (p.S + kB3Rows - 1) / kB3Rows
                             : (p.Sk + kB3Rows - 1) / kB3Rows;
  const int bh = (int)blockIdx.x / n_items;
  const int kvbh = (bh / p.H) * p.KV + (bh % p.H) / (p.H / p.KV);
  const int a_head = kByRow ? bh : kvbh;
  const int t_head = kByRow ? kvbh : bh;
  const int ib = kByRow && p.causal
                     ? n_items - 1 - (int)blockIdx.x % n_items
                     : (int)blockIdx.x % n_items;
  const int i0 = ib * kB3Rows;
  // the streamed tiles: kDQ the kv tiles up to the rows' last visible key;
  // else the q tiles from the first that sees a key here (0 for an item
  // that holds a key of the prefix)
  const int t_first = kByRow || !p.causal || i0 < p.prefix ? 0 : ib;
  const int t_end =
      kByRow ? ((p.causal ? causal_end(p, i0 + kB3Rows) : p.Sk) + kB3Rows -
                1) / kB3Rows
             : (p.S + kB3Rows - 1) / kB3Rows;

  if (tid >= 128) {
    // ---- loader: the resident, then per streamed tile HD / 64 chunks of
    // B1, (kDQ, kDK) the dP chunks of A2 (the item's rows) and B2 (the
    // tile's), and NB of the transposed operand ----
    if (tid == 128) {
      prefetch_tensormap(&tm_a1);
      prefetch_tensormap(&tm_b1);
      prefetch_tensormap(&tm_bt);
      if constexpr (kDP) {
        prefetch_tensormap(&tm_a2);
        prefetch_tensormap(&tm_b2);
      }
      mbar_arrive_expect_tx(res_full, kA1);
#pragma unroll
      for (int c = 0; c < HD / 32; ++c)
        tma_load_4d(sA1 + c * 2 * kB3Box, &tm_a1, res_full, 32 * c, i0,
                    a_head, 0);
      int r = 0;
      // a chunk: box (c0, c1) of map m0, then 16 KB on box (d0, d1) of m1
      auto load = [&](const CUtensorMap* m0, int c0, int c1, int h0,
                      const CUtensorMap* m1, int d0, int d1, int h1) {
        const int st = r % kSlots;
        mbar_wait(&empty[st], ((r / kSlots) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kB3Slot);
        tma_load_4d(ring + st * kB3Slot, m0, &full[st], c0, c1, h0, 0);
        tma_load_4d(ring + st * kB3Slot + 2 * kB3Box, m1, &full[st], d0, d1,
                    h1, 0);
        ++r;
      };
      for (int t = t_first; t < t_end; ++t) {
        const int t0 = t * kB3Rows;
        for (int c = 0; c < HD / 64; ++c)
          load(&tm_b1, 64 * c, t0, t_head, &tm_b1, 64 * c + 32, t0, t_head);
        if constexpr (kDP && kOneSlotDP) {
          for (int c = 0; c < HV / 32; ++c)
            load(&tm_a2, 32 * c, i0, a_head, &tm_b2, 32 * c, t0, t_head);
        } else if constexpr (kDP) {
          for (int c = 0; c < HV / 64; ++c) {
            load(&tm_a2, 64 * c, i0, a_head, &tm_a2, 64 * c + 32, i0,
                 a_head);
            load(&tm_b2, 64 * c, t0, t_head, &tm_b2, 64 * c + 32, t0,
                 t_head);
          }
        }
        for (int cb = 0; cb < NB; ++cb)
          load(&tm_bt, t0, 64 * cb, t_head, &tm_bt, t0 + 32, 64 * cb,
               t_head);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: the item's 64 rows ----
  const int lane = tid & 31, t4 = lane & 3;
  const int frag_row = (tid >> 5) * 16 + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  const uint32_t a1_addr = smem_u32(sA1), ring_addr = smem_u32(ring);
  const bool causal = p.causal;
  const int prefix = p.prefix;
  const int64_t stat0 = (int64_t)bh * p.S;  // lse and D of head bh

  float out[NB][32];  // dQ, dK or dV: a tile's sum added in float32
  float s[32], dp[32];
  float acc[32];      // one output column block of one tile
  uint32_t dh[8][4], dl[8][4];  // dS (P for kDV) in TF32 hi and lo
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) out[cb][i] = 0.0f;
  // kDQ: the lse (log2 domain) and D of this thread's two rows
  float lse_r[2] = {0.0f, 0.0f}, d_r[2] = {0.0f, 0.0f};
  if constexpr (kByRow) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i0 + frag_row + 8 * i;
      if (row < p.S) {
        lse_r[i] = p.lse[stat0 + row] * kLog2e;
        d_r[i] = p.dd[stat0 + row];
      }
    }
  }

  // X (+)= A B^T over STEPS k8 steps (box ks / 4 of each): the small terms
  // of every step first, then hi hi; a_box(ks) and b_box(ks) the addresses
  // of the steps' boxes (hi; lo 8 KB on)
  auto issue_ss = [&](float (&x)[32], auto a_box, auto b_box, bool first,
                      auto steps) {
    constexpr int STEPS = decltype(steps)::value;
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      const uint32_t aa = a_box(ks / 4) + (ks % 4) * 32;
      const uint32_t ba = b_box(ks / 4) + (ks % 4) * 32;
      wgmma_tf32_ss_m64n64k8(x, smem_desc(aa + kB3Box, 16, 1024),
                             smem_desc(ba, 16, 1024), !(first && ks == 0));
      wgmma_tf32_ss_m64n64k8(x, smem_desc(aa, 16, 1024),
                             smem_desc(ba + kB3Box, 16, 1024), 1);
    }
#pragma unroll
    for (int ks = 0; ks < STEPS; ++ks) {
      const uint32_t aa = a_box(ks / 4) + (ks % 4) * 32;
      const uint32_t ba = b_box(ks / 4) + (ks % 4) * 32;
      wgmma_tf32_ss_m64n64k8(x, smem_desc(aa, 16, 1024),
                             smem_desc(ba, 16, 1024), 1);
    }
    wgmma_commit();
  };
  using Chunk = std::integral_constant<int, 8>;     // 64 columns
  using HalfChunk = std::integral_constant<int, 4>; // 32 columns
  // acc = dS (registers, 8 k8 steps) times a chunk of the transposed
  // operand (64 of the reduction index in two boxes, 64 output columns),
  // into a fresh accumulator, the small terms first
  auto issue_rs = [&](int st) {
    const uint32_t ba = ring_addr + st * kB3Slot;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t b = ba + (n / 4) * 2 * kB3Box + (n % 4) * 32;
      wgmma_tf32_rs_m64n64k8(acc, dl[n], smem_desc(b, 16, 1024), n > 0);
      wgmma_tf32_rs_m64n64k8(acc, dh[n], smem_desc(b + kB3Box, 16, 1024),
                             1);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
      wgmma_tf32_rs_m64n64k8(
          acc, dh[n],
          smem_desc(ba + (n / 4) * 2 * kB3Box + (n % 4) * 32, 16, 1024), 1);
    wgmma_commit();
  };
  auto release = [&](int r) {
    if (lane == 0) mbar_arrive(&empty[r % kSlots]);
  };
  auto wait_full = [&](int r) {
    mbar_wait(&full[r % kSlots], (r / kSlots) & 1);
  };
  auto slot_box = [&](int r) {
    const uint32_t a = ring_addr + (r % kSlots) * kB3Slot;
    return [a](int bx) { return a + bx * 2 * kB3Box; };
  };

  mbar_wait(res_full, 0);
  int r = 0;
  for (int t = t_first; t < t_end; ++t) {
    const int t0 = t * kB3Rows;
    // kDK, kDV: the lse (log2 domain) and D of this thread's 16 columns --
    // loaded ahead of their use into registers, or (kStage) by one thread
    // a value into this tile's shared buffer, stored once the products are
    // issued
    float lse_c[8][2], d_c[8][2];
    [[maybe_unused]] float staged = 0.0f;
    [[maybe_unused]] float* stat_t = stat + (t & 1) * 2 * kB3Rows;
    if constexpr (kStage) {
      const int col = t0 + (tid & (kB3Rows - 1));
      if (col < p.S && (tid < kB3Rows || kDP))
        staged = tid < kB3Rows ? p.lse[stat0 + col] * kLog2e
                               : p.dd[stat0 + col];
    } else if constexpr (!kByRow) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t0 + 8 * n + 2 * t4 + e;
          const bool in = col < p.S;
          lse_c[n][e] = in ? p.lse[stat0 + col] * kLog2e : 0.0f;
          d_c[n][e] = in && kDP ? p.dd[stat0 + col] : 0.0f;
        }
    }
    // S (S^T) over HD / 64 chunks, then dP (dP^T) over the dP chunks, one
    // commit group a chunk or pair, chained in one accumulator each; a
    // group's slots released once the next group is issued and its own is
    // done
#pragma unroll
    for (int c = 0; c < HD / 64; ++c, ++r) {
      wait_full(r);
      wgmma_fence();
      issue_ss(s, [&](int bx) { return a1_addr + (2 * c + bx) * 2 * kB3Box; },
               slot_box(r), c == 0, Chunk());
      if (c > 0) {
        wgmma_wait<1>();
        release(r - 1);
      }
    }
    int last = 1;  // slots of the last group issued
    if constexpr (kDP && kOneSlotDP) {
#pragma unroll
      for (int c = 0; c < HV / 32; ++c, ++r) {
        wait_full(r);
        wgmma_fence();
        const auto box = slot_box(r);
        issue_ss(dp, box, [box](int) { return box(1); }, c == 0,
                 HalfChunk());
        wgmma_wait<1>();
        release(r - 1);
      }
    } else if constexpr (kDP) {
#pragma unroll
      for (int c = 0; c < HV / 64; ++c, r += 2) {
        wait_full(r);
        wait_full(r + 1);
        wgmma_fence();
        issue_ss(dp, slot_box(r), slot_box(r + 1), c == 0, Chunk());
        wgmma_wait<1>();
        for (int i = 1; i <= last; ++i) release(r - i);
        last = 2;
      }
    }
    if constexpr (kStage) stat_t[tid] = staged;
    wgmma_wait<0>();
    for (int i = 1; i <= last; ++i) release(r - i);
    fence_acc(s);
    if constexpr (kDP) fence_acc(dp);
    if constexpr (kStage) bar_sync(1, 128);  // the consumer warpgroup
    // P = 2^(S scale log2 e - lse log2 e), 0 where the mask hides the pair
    // or the row / key lies past S / Sk -- tested by selects, and only on a
    // tile that holds such a pair (the diagonal's, a ragged end's): 7 % of
    // the call where every tile tested; dS / scale = P (dP - D); as TF32
    // hi and lo in the A fragments' order (k-slot t = index 2 t)
    const bool edge =
        kByRow ? (t0 + kB3Rows > p.Sk || i0 + kB3Rows > p.S ||
                  (causal && t0 + kB3Rows - 1 > i0))
               : (t0 + kB3Rows > p.S || i0 + kB3Rows > p.Sk ||
                  (causal && i0 + kB3Rows - 1 > t0));
    float x[32];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i_row = i0 + frag_row + 8 * (e >> 1);  // the item's
        const int t_col = t0 + 8 * n + 2 * t4 + (e & 1);  // the tile's
        const int row = kByRow ? i_row : t_col;            // query row
        const int key = kByRow ? t_col : i_row;
        const int col = 8 * n + 2 * t4 + (e & 1);
        const float lse2 = kByRow   ? lse_r[e >> 1]
                           : kStage ? stat_t[col]
                                    : lse_c[n][e & 1];
        const bool hide = edge && (row >= p.S || key >= p.Sk ||
                                   (causal && hidden(key, row, prefix)));
        const float pe = hide ? 0.0f : exp2f(fmaf(s[4 * n + e], sl2, -lse2));
        if constexpr (kDP) {
          const float dd = kByRow   ? d_r[e >> 1]
                           : kStage ? stat_t[kB3Rows + col]
                                    : d_c[n][e & 1];
          x[4 * n + e] = pe * (dp[4 * n + e] - dd);
        } else {
          x[4 * n + e] = pe;
        }
      }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      split_tf32<true>(x[4 * n], dh[n][0], dl[n][0]);
      split_tf32<true>(x[4 * n + 2], dh[n][1], dl[n][1]);
      split_tf32<true>(x[4 * n + 1], dh[n][2], dl[n][2]);
      split_tf32<true>(x[4 * n + 3], dh[n][3], dl[n][3]);
    }
    // the output, a column block (a chunk) at a time into a fresh
    // accumulator (two in turns measured no faster)
#pragma unroll
    for (int cb = 0; cb < NB; ++cb, ++r) {
      wait_full(r);
      wgmma_fence();
      issue_rs(r % kSlots);
      wgmma_wait<0>();
      release(r);
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) out[cb][i] += acc[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      fence_frag(dh[n]);
      fence_frag(dl[n]);
    }
  }

  // rows of the item: dQ rows < S, dK / dV keys < Sk; dQ, dK times scale.
  // With GQA dK and dV go to the head's partials [B, Sk, H, W]
  const int b = bh / p.H, h = bh % p.H, kvh = kvbh % p.KV;
  const bool partial = !kByRow && p.H > p.KV;
  float* dst = MODE == kPassDQ   ? base<float, kDQ>(p, p.dq, b, h)
               : partial         ? p.part + (MODE == kPassDV ? p.part_half
                                                             : 0) +
                             ((int64_t)b * p.Sk * p.H + h) * W
               : MODE == kPassDK ? base<float, kDK>(p, p.dk, b, kvh)
                                 : base<float, kDV>(p, p.dv, b, kvh);
  const int64_t rs = MODE == kPassDQ   ? row_stride<kDQ>(p)
                     : partial         ? (int64_t)p.H * W
                     : MODE == kPassDK ? row_stride<kDK>(p)
                                       : row_stride<kDV>(p);
  const float mul = MODE == kPassDV ? 1.0f : p.scale;
  const int limit = kByRow ? p.S : p.Sk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + frag_row + 8 * i;
    if (row >= limit) continue;
    float* o = dst + u64(row) * rs;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(o + 64 * cb + 8 * n + 2 * t4, out[cb][4 * n + 2 * i] * mul,
               out[cb][4 * n + 2 * i + 1] * mul);
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

// K3's GQA sum of a call's dK / dV partials (H > KV): one thread a 4
// columns of a (b, key, kv head)
template <typename T, int D>
cudaError_t launch_sum(const Params& p, int B, void* stream) {
  const int64_t total = (int64_t)B * p.Sk * p.KV * (D / 4);
  const int blocks =
      (int)((total + 255) / 256 < 65536 ? (total + 255) / 256 : 65536);
  flash_bwd_dkdv_sum_f32_kernel<T, D><<<blocks, 256, 0,
                                        (cudaStream_t)stream>>>(p, B);
  return cudaGetLastError();
}

// parts: 1 the dQ kernel, 2 the dK / dV kernel (which reads the scratch the
// dQ kernel wrote; at hd 192 and 256 the split kernel, then with GQA the
// sum of its partials), 3 both in this order
template <int HD, int HV>
int launch_bf16(const Params& p, int B, const long long* st, int ctas_dq,
                int ctas_kv, int parts, int device, void* stream) {
  static unsigned dq_done = 0, kv_done = 0;
  cudaError_t err = cudaSuccess;
  CUtensorMap tm_q = {}, tm_do = {}, tm_k = {}, tm_v = {};
  if (parts & 1) {
    if (!encode_bshd(&tm_q, p.q, B, p.S, p.H, HD, st + 3 * kQ, kRows) ||
        !encode_bshd(&tm_do, p.dout, B, p.S, p.H, HV, st + 3 * kDO, kRows) ||
        !encode_bshd(&tm_k, p.k, B, p.Sk, p.KV, HD, st + 3 * kK,
                     dq_step<HD>()) ||
        !encode_bshd(&tm_v, p.v, B, p.Sk, p.KV, HV, st + 3 * kV,
                     dq_step<HD>()))
      return (int)cudaErrorInvalidValue;
    auto kernel = flash_bwd_dq_bf16_tc_kernel<HD, HV>;
    constexpr int smem = dq_smem_bytes<HD, HV>();
    err = allow_smem(kernel, smem, device, &dq_done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<ctas_dq, kThreads, smem, (cudaStream_t)stream>>>(
        tm_q, tm_do, tm_k, tm_v, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    constexpr bool kSplit = HD >= 192;   // items of 64 keys of one head
    constexpr int kv_rows = kSplit ? kStep : kRows;
    if (!encode_bshd(&tm_k, p.k, B, p.Sk, p.KV, HD, st + 3 * kK, kv_rows) ||
        !encode_bshd(&tm_v, p.v, B, p.Sk, p.KV, HV, st + 3 * kV, kv_rows) ||
        !encode_bshd(&tm_q, p.q, B, p.S, p.H, HD, st + 3 * kQ, kStep) ||
        !encode_bshd(&tm_do, p.dout, B, p.S, p.H, HV, st + 3 * kDO, kStep))
      return (int)cudaErrorInvalidValue;
    if constexpr (kSplit) {
      auto kernel = flash_bwd_dkdv_bf16_split_kernel<HD, HV>;
      constexpr int smem = split_smem_bytes<HD, HV>();
      err = allow_smem(kernel, smem, device, &kv_done);
      if (err != cudaSuccess) return (int)err;
      kernel<<<ctas_kv, kThreads, smem, (cudaStream_t)stream>>>(
          tm_k, tm_v, tm_q, tm_do, p);
      err = cudaGetLastError();
      if constexpr (HD == HV) {  // no GQA at hd != hv
        if (err == cudaSuccess && p.H > p.KV)
          err = launch_sum<bf16, HD>(p, B, stream);
      }
    } else {
      auto kernel = flash_bwd_dkdv_bf16_tc_kernel<HD>;
      err = allow_smem(kernel, dkdv_smem_bytes<HD>(), device, &kv_done);
      if (err != cudaSuccess) return (int)err;
      kernel<<<ctas_kv, kThreads, dkdv_smem_bytes<HD>(),
               (cudaStream_t)stream>>>(tm_k, tm_v, tm_q, tm_do, p);
      err = cudaGetLastError();
    }
  }
  return (int)err;
}

template <int HD, int HV>
int launch_tf32(const Params& p, int B, int ctas_dq, int ctas_kv, int parts,
                int device, void* stream) {
  static_assert(HD == HV, "the mma.sync float32 kernels: hd == hv");
  static unsigned dq_done = 0, kv_done = 0;
  if (parts & 1) {
    cudaError_t err = launch(flash_bwd_dq_f32_tc_kernel<HD, HV>,
                             f32_dq_smem_bytes<HD, HV>(), kFThreads, p,
                             ctas_dq, 1, &dq_done, device, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 2) {
    cudaError_t err = launch(flash_bwd_dkdv_f32_tc_kernel<HD, HV>,
                             f32_dkdv_smem_bytes<HD, HV>(), kKVThreads, p,
                             ctas_kv, 1, &kv_done, device, stream);
    if (err != cudaSuccess || p.H == p.KV) return (int)err;
    return (int)launch_sum<float, HD>(p, B, stream);
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

// the checks every variant shares (the head dims are each entry point's);
// fills p
bool make_params(Params* p, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse, void* dd,
                 void* dq, void* dk, void* dv, int B, int S, int Sk, int H,
                 int KV, const long long* strides, float scale, int causal,
                 int prefix, int parts, int elem) {
  const void* ptrs[kTensors] = {q, k, v, o, dout, dq, dk, dv};
  if (B < 1 || S < 1 || Sk < 1 || (causal && Sk != S) || prefix < 0 ||
      (!causal && prefix != 0) || KV < 1 || H % KV ||
      (int64_t)B * H >= (1ll << 31) || lse == nullptr || dd == nullptr ||
      parts < 1 || parts > 3 || !aligned_rows(ptrs, strides, elem))
    return false;
  *p = Params{};
  p->q = q; p->k = k; p->v = v; p->o = o; p->dout = dout;
  p->lse = static_cast<const float*>(lse);
  p->dd = static_cast<float*>(dd);
  p->dq = dq; p->dk = dk; p->dv = dv;
  p->S = S; p->Sk = Sk; p->H = H; p->KV = KV;
  for (int i = 0; i < 3 * kTensors; ++i) p->st[i] = strides[i];
  p->scale = scale;
  p->causal = causal;
  p->prefix = prefix;
  return true;
}

// the float32 wgmma backward's scratch (floats), as launch_b3 lays it out:
// q, do and their transposed copies over the B H query heads, k, v and k's
// transposed copy over the B KV kv heads, D [B H, S], and with GQA (H > KV)
// the dK, dV partials [2, B, Sk, H, HD] on a 16-byte boundary after D
struct B3Scratch {
  float *q, *k, *v, *dout, *qt, *kt, *dot, *dd, *part;
  int64_t nq, nk, nv, ndo, nqt, nkt, ndot;  // floats of one half (hi or lo)
  int64_t part_half;                        // floats of one partial
  int sp, skp;                              // S, Sk rounded up to 64
};
template <int HD, int HV>
B3Scratch b3_scratch(float* base, int B, int S, int Sk, int H, int KV) {
  B3Scratch s;
  const int64_t n = (int64_t)B * H, nkv = (int64_t)B * KV;
  s.sp = (S + kB3Rows - 1) / kB3Rows * kB3Rows;
  s.skp = (Sk + kB3Rows - 1) / kB3Rows * kB3Rows;
  s.nq = n * S * HD;
  s.nk = nkv * Sk * HD;
  s.nv = nkv * Sk * HV;
  s.ndo = n * S * HV;
  s.nqt = n * HD * s.sp;
  s.nkt = nkv * HD * s.skp;
  s.ndot = n * HV * s.sp;
  s.q = base;
  s.k = s.q + 2 * s.nq;
  s.v = s.k + 2 * s.nk;
  s.dout = s.v + 2 * s.nv;
  s.qt = s.dout + 2 * s.ndo;
  s.kt = s.qt + 2 * s.nqt;
  s.dot = s.kt + 2 * s.nkt;
  s.dd = s.dot + 2 * s.ndot;
  s.part = s.dd + (n * S + 3) / 4 * 4;
  s.part_half = (int64_t)B * Sk * H * HD;
  return s;
}

// a 4-D float32 map (columns, rows, b * heads, hi / lo) over a split
// operand, boxes of 32 columns x 64 rows x 1 x both
bool encode_split(CUtensorMap* map, const float* base, int cols, int rows,
                  int64_t n, int64_t half) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)n, 2};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)cols * rows * 4,
                                 (cuuint64_t)half * 4};
  const cuuint32_t box[4] = {32, kB3Rows, 1, 2};
  return encode_f32(map, base, 4, dims, strides, box);
}

int b3_blocks(int64_t total) {
  const int64_t n = (total + 255) / 256;
  return (int)(n < 132 * 16 ? n : 132 * 16);
}

template <int MODE, int HD, int HV>
cudaError_t launch_b3_pass(const CUtensorMap& a1, const CUtensorMap& a2,
                           const CUtensorMap& b1, const CUtensorMap& b2,
                           const CUtensorMap& bt, const Params& p, int ctas,
                           int device, cudaStream_t stream) {
  static unsigned done = 0;
  auto kernel = flash_bwd_f32_wgmma_kernel<MODE, HD, HV>;
  constexpr int smem = b3_smem_bytes<HD, HV>();
  cudaError_t err = allow_smem(kernel, smem, device, &done);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kB3Threads, smem, stream>>>(a1, a2, b1, b2, bt, p);
  return cudaGetLastError();
}

// parts 1: the pre-pass (split, transposed, D) and the dQ pass; 2: the dK
// and the dV passes, which read the scratch a part-1 launch wrote, then
// with GQA the sum of their partials
template <int HD, int HV>
int launch_b3(Params p, int B, float* scratch, int ctas_dq, int ctas_kv,
              int parts, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const B3Scratch sc = b3_scratch<HD, HV>(scratch, B, p.S, p.Sk, p.H, p.KV);
  p.dd = sc.dd;
  p.part = sc.part;
  p.part_half = sc.part_half;
  const int n = B * p.H, nkv = B * p.KV;
  if (parts & 1) {
    const int64_t* s = p.st;
    // q, k, do: split as they lie and transposed in one pass; v as it lies
    flash_bwd_f32_t_kernel<HD><<<dim3(sc.sp / 64, HD / 64, n), 256, 0, st>>>(
        static_cast<const float*>(p.q), s[3 * kQ], s[3 * kQ + 1],
        s[3 * kQ + 2], p.S, p.H, sc.sp, sc.qt, sc.nqt, sc.q, sc.nq);
    flash_bwd_f32_t_kernel<HD><<<dim3(sc.skp / 64, HD / 64, nkv), 256, 0,
                                 st>>>(
        static_cast<const float*>(p.k), s[3 * kK], s[3 * kK + 1],
        s[3 * kK + 2], p.Sk, p.KV, sc.skp, sc.kt, sc.nkt, sc.k, sc.nk);
    flash_bwd_f32_t_kernel<HV><<<dim3(sc.sp / 64, HV / 64, n), 256, 0, st>>>(
        static_cast<const float*>(p.dout), s[3 * kDO], s[3 * kDO + 1],
        s[3 * kDO + 2], p.S, p.H, sc.sp, sc.dot, sc.ndot, sc.dout, sc.ndo);
    flash_bwd_f32_split_kernel<HV><<<b3_blocks(sc.nv / 4), 256, 0, st>>>(
        static_cast<const float*>(p.v), s[3 * kV], s[3 * kV + 1],
        s[3 * kV + 2], p.Sk, p.KV, sc.nv / 4, sc.v, sc.nv);
    flash_bwd_f32_dd_kernel<HV><<<b3_blocks((int64_t)n * p.S * 32), 256, 0,
                                  st>>>(p, B);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap tq = {}, tk = {}, tv = {}, tdo = {}, tqt = {}, tkt = {},
              tdot = {};
  if (!encode_split(&tq, sc.q, HD, p.S, n, sc.nq) ||
      !encode_split(&tk, sc.k, HD, p.Sk, nkv, sc.nk) ||
      !encode_split(&tv, sc.v, HV, p.Sk, nkv, sc.nv) ||
      !encode_split(&tdo, sc.dout, HV, p.S, n, sc.ndo) ||
      !encode_split(&tqt, sc.qt, sc.sp, HD, n, sc.nqt) ||
      !encode_split(&tkt, sc.kt, sc.skp, HD, nkv, sc.nkt) ||
      !encode_split(&tdot, sc.dot, sc.sp, HV, n, sc.ndot))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (parts & 1)
    err = launch_b3_pass<kPassDQ, HD, HV>(tq, tdo, tk, tv, tkt, p, ctas_dq,
                                          device, st);
  if (err == cudaSuccess && (parts & 2)) {
    err = launch_b3_pass<kPassDK, HD, HV>(tk, tv, tq, tdo, tqt, p, ctas_kv,
                                          device, st);
    if (err == cudaSuccess)
      err = launch_b3_pass<kPassDV, HD, HV>(tk, tv, tq, tdo, tdot, p,
                                            ctas_kv, device, st);
    if constexpr (HD == HV) {  // GQA at hd 256 only
      if (err == cudaSuccess && p.H > p.KV)
        err = launch_sum<float, HD>(p, B, stream);
    }
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Every entry point: q, k, v, o, do, lse, the scratch, (wgmma: the
// schedule,) dq, dk, dv device pointers; B, S (query rows), Sk (keys;
// == S when causal), H, KV, hd, hv; strides: 24 element strides,
// (batch, seq, head) of q, k, v, o, do, dq, dk, dv in order; the softmax
// scale; causal; prefix (causal only: keys [0, prefix) seen by every
// row); the plan: the dQ
// kernel's rows an item (q_rows) and kv step, the dK / dV kernel's keys an
// item (kv_rows) and q step, the ring depths of the two kernels and their
// grids (blocks); parts: 1 the dQ kernel, 2 the dK / dV kernel (it reads
// the scratch a dQ launch of the same call wrote), 3 both in this order (a
// training step's call); the device and the stream.  Every row 16-byte
// aligned.  Each entry point checks the plan against its own constants and
// refuses any other.

// bf16 on wgmma, hd == hv in {64, 128, 256} or (hd, hv) = (192, 128)
// with H == KV.  Plan: q_rows = 128, q_step = 64, kv_step = dq_step (128
// at hd 64, 64 at 128 and 192, 32 at 256); kv_rows 128 at hd 64 and 128,
// 64 at 192 and 256 (the split dK / dV kernel); the ring depths of the two
// kernels (4 and 4 at hd 64, 3 and 3 at 128, 3 and split_stages at 192 and
// 256: 3 and 2); their persistent grids ctas_dq <= B * H * nq and ctas_kv
// <= (number of dK / dV items) blocks (nq = ceil(S / 128), nk = ceil(Sk /
// kv_rows)).  scratch: float32 [2, B * H, 128 nq] (lse2, then D), at hd 256
// with H > KV followed by the dK, dV partials 2 x [B, Sk, H, hd].  sched:
// int32, each kernel's schedule in turn -- ctas + 1 offsets, then its
// items, block c taking items [offsets[c], offsets[c + 1]) in order: for
// the dQ kernel B * H * nq items (b * H + h) * nq + q-block, for the dK /
// dV kernel B * KV * nk items (b * KV + kv head) * nk + key block, at hd
// 192 and 256 B * H * nk items (b * H + h) * nk + key block.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* scratch, const void* sched, void* dq,
                             void* dk, void* dv, int B, int S, int Sk, int H,
                             int KV, int hd, int hv, const long long* strides,
                             float scale, int causal, int prefix, int q_rows,
                             int kv_rows, int q_step, int kv_step,
                             int stages_dq, int stages_dkdv, int ctas_dq,
                             int ctas_kv, int parts, int device,
                             void* stream) {
  Params p;
  const bool rect = hd == 192 && hv == 128 && H == KV;
  const bool square = hv == hd && (hd == 64 || hd == 128 || hd == 256);
  const bool split = hd >= 192;
  const int want_kv_rows = split ? kStep : kRows;
  const int want_step = hd == 64    ? dq_step<64>()
                        : hd == 128 ? dq_step<128>()
                        : hd == 192 ? dq_step<192>()
                                    : dq_step<256>();
  const int want_stages_dq = hd == 64    ? dq_stages<64>()
                             : hd == 128 ? dq_stages<128>()
                             : hd == 192 ? dq_stages<192>()
                                         : dq_stages<256>();
  const int want_stages_kv = hd == 64    ? dkdv_stages<64>()
                             : hd == 128 ? dkdv_stages<128>()
                             : hd == 192 ? split_stages<192>()
                                         : split_stages<256>();
  if (!(square || rect) ||
      !make_params(&p, q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, Sk,
                   H, KV, strides, scale, causal, prefix, parts, 2) ||
      sched == nullptr || q_rows != kRows || kv_rows != want_kv_rows ||
      q_step != kStep || kv_step != want_step ||
      stages_dq != want_stages_dq || stages_dkdv != want_stages_kv)
    return (int)cudaErrorInvalidValue;
  const int64_t nq = (S + kRows - 1) / kRows;
  const int64_t nk = (Sk + want_kv_rows - 1) / want_kv_rows;
  const int64_t n_dq = (int64_t)B * H * nq;
  const int64_t n_kv = (int64_t)B * (split ? H : KV) * nk;
  if (n_dq >= (1ll << 31) || n_kv >= (1ll << 31) || ctas_dq < 1 ||
      ctas_dq > n_dq || ctas_kv < 1 || ctas_kv > n_kv)
    return (int)cudaErrorInvalidValue;
  p.s_pad = (int)(nq * kRows);
  p.lse2 = static_cast<float*>(scratch);
  p.dd = p.lse2 + (int64_t)B * H * p.s_pad;
  p.part = p.dd + (int64_t)B * H * p.s_pad;
  p.part_half = (int64_t)B * Sk * H * hd;
  p.sched_dq = static_cast<const int*>(sched);
  p.sched_kv = p.sched_dq + ctas_dq + 1 + n_dq;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (hd) {
    case 64:
      return launch_bf16<64, 64>(p, B, strides, ctas_dq, ctas_kv, parts,
                                 device, stream);
    case 128:
      return launch_bf16<128, 128>(p, B, strides, ctas_dq, ctas_kv, parts,
                                   device, stream);
    case 192:
      return launch_bf16<192, 128>(p, B, strides, ctas_dq, ctas_kv, parts,
                                   device, stream);
    default:
      return launch_bf16<256, 256>(p, B, strides, ctas_dq, ctas_kv, parts,
                                   device, stream);
  }
}

// float32 as 3xTF32 on mma.sync, hd == hv in {64, 128}.  Plan:
// q_rows = kv_rows = 64 (kF), q_step = kv_step = f32_step (of hd), 2 ring
// slots in each kernel, grids of one block an item: ctas_dq = B * H * nq
// and ctas_kv = B * H * nk (nq = ceil(S / 64), nk = ceil(Sk / 64)).
// scratch: float32 D [B, H, S], after the dK, dV partials 2 x [B, Sk, H,
// hd] when H > KV.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* dd, void* dq, void* dk, void* dv, int B,
                            int S, int Sk, int H, int KV, int hd, int hv,
                            const long long* strides, float scale, int causal,
                            int prefix, int q_rows, int kv_rows, int q_step,
                            int kv_step, int stages_dq, int stages_dkdv,
                            int ctas_dq, int ctas_kv, int parts, int device,
                            void* stream) {
  Params p;
  const bool square = hd == hv && (hd == 64 || hd == 128);
  const int step = hd == 64 ? f32_step<64>() : f32_step<128>();
  const int64_t nq = (S + kF - 1) / kF, nk = (Sk + kF - 1) / kF;
  if (!square ||
      !make_params(&p, q, k, v, o, dout, lse, dd, dq, dk, dv, B, S, Sk, H,
                   KV, strides, scale, causal, prefix, parts, 4) ||
      q_rows != kF || kv_rows != kF || q_step != step || kv_step != step ||
      stages_dq != kFStages || stages_dkdv != kFStages ||
      (int64_t)B * H * nq >= (1ll << 31) ||
      (int64_t)B * H * nk >= (1ll << 31) || ctas_dq != (int64_t)B * H * nq ||
      ctas_kv != (int64_t)B * H * nk)
    return (int)cudaErrorInvalidValue;
  // with GQA the scratch holds the dK, dV partials [B, Sk, H, hd], then D
  p.part_half = (int64_t)B * Sk * H * hd;
  p.part = static_cast<float*>(dd);
  if (H > KV) p.dd += 2 * p.part_half;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return hd == 64 ? launch_tf32<64, 64>(p, B, ctas_dq, ctas_kv, parts,
                                        device, stream)
                  : launch_tf32<128, 128>(p, B, ctas_dq, ctas_kv, parts,
                                          device, stream);
}

// float32 as 3xTF32 on wgmma, (hd, hv) = (192, 128) with H == KV, or hd =
// hv = 256 (GQA too).  Plan: q_rows = kv_rows = q_step = kv_step = 64, the
// ring slots of b3_slots (4 at (192, 128), 3 at 256) in each pass, grids of
// one block an item: ctas_dq = B * H * nq (the dQ pass) and ctas_kv = B * H
// * nk (the dK pass, then the dV pass), nq = ceil(S / 64), nk = ceil(Sk /
// 64).  scratch: float32, 16-byte aligned, laid out by b3_scratch: q, k, v,
// do split into TF32 hi and lo, q, k, do transposed and split, D [B H, S],
// with GQA the dK, dV partials -- 2 (B H S (hd + hv) + B KV Sk (hd + hv) +
// B H hd sp + B KV hd skp + B H hv sp) + B H S floats, the last rounded up
// to a multiple of 4, + 2 B Sk H hd with GQA; sp and skp S and Sk rounded
// up to 64.
int flash_attention_bwd_f32_tc(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* scratch, void* dq,
                               void* dk, void* dv, int B, int S, int Sk,
                               int H, int KV, int hd, int hv,
                               const long long* strides, float scale,
                               int causal, int prefix, int q_rows,
                               int kv_rows, int q_step, int kv_step,
                               int stages_dq, int stages_dkdv, int ctas_dq,
                               int ctas_kv, int parts, int device,
                               void* stream) {
  Params p;
  const int64_t nq = (S + kB3Rows - 1) / kB3Rows;
  const int64_t nk = (Sk + kB3Rows - 1) / kB3Rows;
  const bool rect = hd == 192 && hv == 128 && H == KV;
  const bool wide = hd == 256 && hv == 256;
  const int slots = wide ? b3_slots<256>() : b3_slots<192>();
  if (!(rect || wide) ||
      !make_params(&p, q, k, v, o, dout, lse, scratch, dq, dk, dv, B, S, Sk,
                   H, KV, strides, scale, causal, prefix, parts, 4) ||
      !aligned16(scratch) || q_rows != kB3Rows || kv_rows != kB3Rows ||
      q_step != kB3Rows || kv_step != kB3Rows || stages_dq != slots ||
      stages_dkdv != slots || (int64_t)B * H * nq >= (1ll << 31) ||
      (int64_t)B * H * nk >= (1ll << 31) || ctas_dq != (int64_t)B * H * nq ||
      ctas_kv != (int64_t)B * H * nk)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  float* sc = static_cast<float*>(scratch);
  return wide ? launch_b3<256, 256>(p, B, sc, ctas_dq, ctas_kv, parts,
                                    device, stream)
              : launch_b3<192, 128>(p, B, sc, ctas_dq, ctas_kv, parts,
                                    device, stream);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
