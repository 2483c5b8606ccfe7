// Flash-attention forward for NVIDIA Hopper (sm_90a), BSHD layout.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -Xptxas -v
// into a shared library with a plain C interface (loaded with ctypes; no
// PyTorch headers), WITH FMA contraction and without --use_fast_math: the
// kernels are held to their plain version by a tolerance; expf (float32)
// and exp2f (mma.sync) keep their accurate forms, and the wgmma kernel's
// ex2.approx is as accurate (2 ulp) but flushes results below 2^-126.
// Every entry point takes raw device pointers, element strides, the launch
// plan and the caller's CUDA stream, launches on that stream, does not
// synchronise, allocates nothing, and returns a CUDA error code:
// cudaErrorInvalidValue for a plan it refuses or a tensor map it cannot
// encode, else cudaGetLastError().
//
// ---------------------------------------------------------------------------
// K3   replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
//
//   o[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h, :] . k[b, j, h/G, :])
//                   * v[b, j, h/G, :],   G = H / KV,
//   over j <= i or j < P when causal (P = prefix: a bidirectional prefix of
//   P keys that every query row sees, PaliGemma's image patches, the
//   reference's layers._block_mask; P = 0 plain causal, P >= S full
//   attention), over all j < Sk otherwise.
//     in : q [B, S, H, hd], k [B, Sk, KV, hd], v [B, Sk, KV, hv] (T, any
//          strides with the last dimension dense, 16-byte aligned rows)
//     out: o [B, S, H, hv] (T)
//   The key length Sk may differ from the query length S (cross attention:
//   a decoder's queries over an encoder's keys) when the call is not
//   causal; causal needs Sk == S, and only a causal call takes a prefix.
//   Query rows (q-blocks, o and lse rows) run over S, keys (kv tiles, key
//   masks, the K / V tensor maps) over Sk.  A block of causal rows [q0,
//   q1) sees the keys up to max(q1, P) (causal_end): its kv loop covers
//   those and masks by position a key past its row and past the prefix.
//
//   The TPU kernel runs a (B*H, q-block, kv-block) grid with the kv axis
//   sequential on one core, carrying the running max m, the running sum l
//   and the float32 accumulator in VMEM scratch across grid steps; blocks
//   above the diagonal are skipped and the diagonal block is masked by
//   position.  Here one block owns one (q-block, b*h) tile at a time and
//   the kv-block loop runs inside it, so m, l and the accumulator stay in
//   registers and nothing is carried between blocks.  Under causal the loop
//   covers only the kv blocks a query row of the tile can see, and the
//   heaviest q-blocks go first.  The reference's GQA head
//   expansion (jnp.repeat of K and V) and its [B*H, S, hd] transposes are
//   gone: the block reads q, k, v in place and indexes the kv head as
//   h / (H / KV).  The reference's S % block == 0 rule is gone too: query
//   rows and keys past S are loaded as zeros, keys past S are masked and
//   rows past S are not stored.  Constants kept: NEG_INF = -1e30 (finite,
//   not -inf), the denominator clamped at 1e-30, l = l * corr + sum(p),
//   acc = acc * corr + p @ v, o = acc / max(l, 1e-30).
//
//   Bound on an H100: operations.  A causal prefill does
//   2 * B * H * S(S+1)/2 * (hd + hv) flops on (q, k, v, o) bytes: at
//   stablelm-1.6b's B=1, S=4096, H=32, hd=hv=64 that is 68.7 GFLOP on
//   34 MB, about 2,000 flops per byte, far above the card's ridge point
//   (~295 in bf16).  So bf16 runs on the tensor cores, and the only way to
//   their full rate is wgmma fed by loads that cost the multiplying threads
//   nothing.  At head dim 64 the softmax weighs as much as the products:
//   one exp2 on the SFU (16 a clock an SM) per 256 flops of the tensor
//   cores, so the design overlaps it with them.
//
//   The launch plan -- variant, tile, grid -- is made in Python
//   (repro_torch/kernels/flash_attention.py, plan()).  These entry points
//   check that a plan fits the shape and obey it; they choose nothing.
//
//   Variants (every kernel's name starts with flash_bf16_ or flash_f32_,
//   the profiler's symbol for K3 in each dtype):
//
//   flash_bf16_tc_kernel<HD, HV>   bf16, hd == hv in {64, 128, 256} or
//     (hd, hv) = (192, 128) (deepseek's MLA prefill: q / k of 128 nope + 64
//     rope columns, v of 128), q, k, v 16-byte aligned with strides of
//     whole 16 bytes: every model shape.  Below D is hd == hv; at (192,
//     128) Q and K tiles are 3 boxes, V and O 2, S = Q K^T 12 k16 steps
//     (hd 128's 8 and 4 more).  There P V runs in float32 accuracy: P is
//     split into bf16 hi = bf16(P) and lo = bf16(P - hi), two products a
//     16-key step, lo first (32 more registers a thread).  The MoE layer
//     after each MLA attention routes each token to its top-k experts, a
//     choice a last-bit change of the hidden state can flip, so the
//     kernel keeps to the plain path's float32 P V (the reference
//     kernel's arithmetic) as closely as the tensor cores allow; the
//     rounding of P to bf16 was the largest difference between them.
//     Persistent: one block an SM walks the tiles of 128 query rows of one
//     (b, h), the heaviest first, in rounds whose block order alternates so
//     that every block gets an even share of the work.  Where the K and V a
//     round streams pass what the L2 holds (deepseek: 128 heads of 2.6 MB
//     at S = 4096), the tiles run head by head (tc_group), so that the K
//     and V the blocks stream stay in the L2 and are not read from device
//     memory again for every q-block.  (64-key tiles with a ring of
//     3 or 4, as at 256, ran slower at (192, 128) than 128-key tiles with
//     2.)  Block = 3 warpgroups: warpgroup 0 loads, warpgroups 1 and 2 each
//     own 64 rows of a tile.  Warp specialisation: the loader drops to 24
//     registers (setmaxnreg) and one of its threads issues every TMA copy; the
//     consumers rise to 240, so an S tile of BN/2 floats, an O tile of D/2
//     floats and P's fragments stay in registers.
//       Loads: TMA over 4-D tensor maps of q, k, v as they lie, dims
//       (hd, heads, S, B), boxes of 64 x 1 x rows x 1 in the 128-byte
//       swizzle (a 128-byte box row is 64 bf16, so a tile of D columns is
//       D / 64 boxes).  A box never runs into the next sequence, and TMA's
//       zero fill covers rows and keys past S.  K and V tiles of BN =
//       tc_bn<D>() keys (128 at D = 64 and 128, 64 at D = 256) go through a
//       ring of tc_stages<D>() slots (3 at D = 64, 2 at D = 128 and 256; 2
//       to 6 ran alike at D = 64) with separate full / empty mbarriers for K
//       and V,
//       so S = Q K^T on a tile starts before its V has landed.  The ring
//       runs on from one tile of queries to the next, and Q has its own
//       full / empty pair: the next tile's Q, K and V load while the
//       consumers finish the last one.
//       S = Q K^T: wgmma.m64nBNk16, D / 16 steps, both operands from shared
//       memory; K as stored is already the K-major B operand.
//       O += P V: wgmma with A from registers.  The C fragments of two
//       adjacent 8-key column groups of S are the A fragment of one 16-key
//       step (the layout identity the mma.sync kernel uses), so P is
//       rounded to bf16 in place and never touches shared memory.  V is the
//       B operand in MN-major form (imm-trans-b = 1): 8-key groups 1 KB
//       apart (SBO), 64-wide hv boxes one box apart (LBO) -- K2 reads its
//       HWIO weights the same way; at D = 256 one wgmma.m64n256k16, the
//       widest, a 16-key step.
//       Head dim 256 (paligemma): the O tile alone is 128 registers a
//       thread, so kv tiles are 64 keys (S 32 registers, P 16): Q 64 KB, two
//       K / V stages of 64 KB, 193 KB in all.  Per kv tile each consumer
//       warpgroup does 16 m64n64k16 steps of S and 4 m64n256k16 of P V.
//       Overlap: each consumer issues S of kv tile j and P V of tile j-1
//       together and runs the softmax of tile j while P V is on the tensor
//       cores; the two consumer warpgroups take turns to issue (named
//       barriers, ping-pong), so one's softmax also runs under the other's
//       products.
//       Softmax on the accumulator fragments: row max and sum over the
//       four lanes of a quad by shuffles, in four partials a row; 2^x by
//       ex2.approx (MUFU); for scale > 0 the max is taken over the raw
//       scores and scale * log2(e) folds into one FFMA before each exp2.
//       Each warpgroup's kv loop runs from its rows' last visible tile down
//       (the diagonal one, or the prefix's last where that lies further),
//       so only its first tile (the diagonal, the prefix's end, a ragged
//       end) is masked by position -- by selects, a branch between elements
//       costs more than the softmax -- and every row sees a key in it: its
//       first key lies at or before the row, or inside the prefix
//       (tc_tiles_align).  With 64-key tiles under 128-row blocks the
//       block's first tile can lie wholly above the lower warpgroup's rows:
//       that warpgroup waits for it to land and releases it unread.
//       Epilogue: O * (1 / max(l, 1e-30)) rounded to bf16x2 straight from
//       the fragments, rows past S not written.
//
//   flash_bf16_mma_kernel<HD, HV>   the other bf16 shapes (hd or hv = 32,
//     hv != hd): mma.sync.aligned.m16n8k16 from ldmatrix fragments, four
//     warps per 64-query block, each owning 16 rows; K and V tiles of 64
//     keys double-buffered by cp.async in row-padded shared memory; P
//     re-used from the S fragments as above.
//
//   flash_f32_kernel<HD, HV>   float32, hd, hv in {32, 64, 128}, on the
//     CUDA cores in IEEE float32 (67 TFLOP/s).  One-pass TF32 (10 bits of
//     mantissa) would break the 1e-5 tolerance; 3xTF32, below, does not,
//     and runs at (192, 128) and at hd = hv = 256.
//     256 threads per 64-query block, tiles of 64 keys.  Q, K and V arrive
//     by 16-byte cp.async, K and V double-buffered (the next tile loads
//     while this one is multiplied out), all row-major as they lie.  Thread
//     (tx, ty) owns rows ty + 16 i and keys tx + 16 j (i, j < 4) of the
//     score tile, so the K reads of a quarter warp hit distinct banks; the
//     scores stay in registers, the row max and sum come from shuffles
//     across the 16 lanes of a row group, and only P goes through shared
//     memory, once, for the P V product.  Two barriers a tile.
//
//   flash_f32_tc_kernel<192, 128>   float32 at deepseek's (192, 128), every
//     product as 3xTF32 on wgmma: each operand x is split into TF32 hi =
//     cvt.rna(x) and lo = cvt.rna(x - hi) (x - hi is exact, lo keeps all
//     but ~2 of x's 24 bits), each product lo hi + hi lo + hi hi, the small
//     terms first, into a float32 accumulator: float32-accurate to ~1e-6
//     relative, as the backward's 3xTF32 (module header of
//     flash_attention_bwd.cu), at the TF32 tensor cores' 495 / 3 TFLOP/s.
//     Its output lies closer to float64 attention than the plain version's
//     float32 does (chip_smoke.py's scale cases print both distances): the
//     CUDA-core kernel it replaces summed each score in the plain version's
//     order and shared its rounding, so at a large scale (0.3) what the
//     1e-5 gate against the plain version sees is mostly the plain
//     version's own float32 scores.
//     TF32 wgmma takes both shared-memory operands K-major only (no
//     transpose), so a pre-pass writes the split K and V operands into a
//     float32 scratch: flash_f32_split_kernel k as hi, lo [B KV, Sk, 192],
//     and flash_f32_vt_kernel v transposed, V^T hi, lo [B KV, 128, Sk
//     rounded to 64], the keys of each group of 8 in the order 0 2 4 6 1 3
//     5 7 (tf32_key): the S accumulator gives a thread keys 2 t and 2 t + 1
//     of a group, the register A fragment wants k-slots t and t + 4, so
//     with V^T in that order P's fragments are the accumulator as it
//     stands.  The pre-pass reads k and v once and writes twice their size
//     (1.34 GB at deepseek's B=1 S=4096); the kernel's K and V tiles then
//     load by TMA with no work by the multiplying threads, where splitting
//     in the kernel would redo them once for every q tile that reads them.
//     A tile's Q is read by one block once, so the consumers split it in
//     shared memory as it lands (96 floats a thread), which saves the 805
//     MB its hi and lo would take in the scratch.
//     Shared memory sets the design.  At 192 float32 columns a 64-row Q
//     tile is 48 KB, hi and lo 96 KB; a 64-key K tile the same; V^T of 64
//     keys 64 KB: Q and one K / V tile split, 256 KB, pass the 227 KB.  So:
//     one consumer warpgroup on a 64-row tile (two would need two Q tiles,
//     192 KB) with Q's hi and lo resident (96 KB), and the kv tile of 64
//     keys streamed as five 32 KB chunks -- three of K (64 columns each),
//     two of V^T (32 keys each), hi and lo -- through a ring of four slots
//     (128 KB): 225 KB in all.  A chunk's slot is released as soon as its
//     products are done (wgmma_wait per commit group), so the loads run
//     about a chunk ahead of the products.  (Q's lo as a register A operand
//     would take 96 registers a thread beside O's 64; 32-key tiles make S
//     an m64n32 product, which reads its A tile from shared memory for half
//     the work.)  S = Q K^T: 24 k8 steps of wgmma.m64n64k8, each K chunk into
//     a fresh accumulator, the three added in float32; O += P V: 8 k8 steps
//     of wgmma.m64n128k8, P's hi and lo from registers, into a fresh
//     accumulator added to O in float32 (O = O corr + P V): the tensor
//     cores' float32 accumulation truncates, and chained over a whole row
//     (1,536 products at S = 4096) it drifts, as the backward found.  The
//     softmax is the bf16 kernel's (scale folded into one FFMA before each
//     exp2, masks by selects on a warpgroup's first kv tile only, kv tiles
//     from the diagonal down); it does not overlap the products.
//     Persistent: one 160-thread block (the consumer warpgroup, then a
//     loader warp, one of whose threads issues every TMA copy) an SM walks
//     the tiles of 64 query rows heaviest first, head by head where a
//     round's K and V hi and lo pass the L2 (tc_group), as the bf16 kernel.
//
//   flash_f32_tc_kernel<256, 256>   float32 at paligemma's hd = hv = 256
//     (8 heads over 1 kv head, the patches' bidirectional prefix), the
//     same kernel and pre-pass (k and V^T over the B KV kv heads, read in
//     place by every query head of the group).  Budgets at 256:
//     - Shared memory: Q's hi and lo are 128 KB, so the ring has 3 slots
//       of 32 KB (230,464 bytes in all).  A kv tile of 64 keys streams 8
//       chunks: 4 of K (64 columns each) and 4 of V^T, each 64 keys x 64
//       rows of V^T (64 of O's columns) in two boxes of 32 keys -- a V^T
//       chunk of 32 keys x 256 rows would be 64 KB.
//     - Registers: O is 128 a thread.  S beside it: chunks 0 and 1 chained
//       in one accumulator, 2 and 3 in another (64), added in float32 -- a
//       fresh accumulator a chunk (the (192, 128) order) would be 128, or
//       96 in turns.  P V beside O and P's hi and lo (64): 32 of O's
//       columns at a time (wgmma.m64n32k8, a fresh accumulator of 16),
//       added to O in float32; each V^T chunk's two halves run back to back
//       and its slot is released after both.  Peak 208 of the 255: with 64
//       columns at a
//       time (32) ptxas spilled (255 registers, 8 KB of spill stores) at
//       the same speed; the 32-column kernel takes 255, no spill.
//     The chained S pairs cost accuracy against fresh chunks: at scale 0.3
//     (the scores ~20) the emulated kernel lies 2.9e-6 of scale from
//     float64 attention against 0.9e-6 with a fresh accumulator a chunk,
//     as far as the plain version's float32 (2.8e-6), inside the 1e-5 gate
//     (tests/test_torch_flash_attention.py).
//
//   Training: flash_bf16_tc_kernel<HD, HV, true> (hd == hv in {64, 128,
//   256}, and (192, 128)), flash_f32_kernel<HD, HV, true> (hd == hv in {64,
//   128}) and flash_f32_tc_kernel<HD, HV, true> ((192, 128) and 256; entry
//   points *_lse) also write the row
//   log-sum-exp of the scaled scores, lse[b, h, i] = ln(sum_j exp(scale *
//   q_i . k_j)), float32 [B, H, S], from the final running max and sum --
//   what the backward
//   kernels (flash_attention_bwd.cu) recompute P from.  The <..., false>
//   instances, prefill's, are the code they were.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMinDenom = 1e-30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, Sk, H, KV;  // S query rows, Sk keys (== S when causal)
  int64_t qs_b, qs_s, qs_h;  // element strides of q, k, v, o
  int64_t ks_b, ks_s, ks_h;
  int64_t vs_b, vs_s, vs_h;
  int64_t os_b, os_s, os_h;
  float scale;
  int causal;
  int prefix;  // causal: keys [0, prefix) seen by every row
  int bh;      // tensor-core kernel: B * H
  int group;   // tensor-core kernel: heads of a tile group (tc_group)
  float* lse;  // [B, H, S] float32: the *_lse entry points only
};

// The (b * H + h, q-block) of tile `lin` of bh * nq: tiles run in groups
// of `group` consecutive heads (b * H + h; the last group may hold fewer),
// group after group, and inside a group q-block by q-block over its heads
// -- from the heaviest (last) q-block down under causal, so the long kv
// loops start early and the short ones fill the tail.  group == bh is one
// group of every head.
struct Tile {
  int bh, qb;
};
__device__ __forceinline__ Tile tile_of(const Params& p, int64_t lin, int bh,
                                        int nq, int group) {
  const int64_t per = (int64_t)group * nq;
  const int g = (int)(lin / per);
  const int size = min(group, bh - g * group);  // heads of this group
  const int64_t r = lin - g * per;
  const int qb = (int)(r / size);
  return {g * group + (int)(r % size), p.causal ? nq - 1 - qb : qb};
}
// the tile of a block of the (B * H, q-blocks) grid, in launch order, one
// group of every head
__device__ __forceinline__ Tile block_tile(const Params& p) {
  return tile_of(p, (int64_t)blockIdx.y * gridDim.x + blockIdx.x, gridDim.x,
                 gridDim.y, gridDim.x);
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&t);
}

// (a, b) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo holds x
// to 16 bits of mantissa
__device__ __forceinline__ void pack_hi_lo(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// max and sum over the four lanes of a quad (xor 1, 2): every lane of the
// quad ends with the same bits
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// --- bf16, wgmma: flash_bf16_tc_kernel ---------------------------------------

// 2^x by the SFU (ex2.approx: 2 ulp, as exp2f's; results below 2^-126
// flushed to 0, which no sum that P is rounded to bf16 for can see)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the tensor map's descriptor into the cache before its first copy
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// named barriers for the consumers' turns (0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// S[64 x 128] (=|+)= A[64 x 16] (K-major, descriptor da) * B[128 x 16]^T
// (K-major, descriptor db, imm-trans-b = 0); scale_d = 0 overwrites S
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

// O[64 x 64] += A[64 x 16] (registers: the m16n8k16 A fragment of each warp's
// 16 rows) * B[16 x 64] (MN-major, descriptor db, imm-trans-b = 1)
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

// O[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (MN-major)
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

// S[64 x 64] (=|+)= A[64 x 16] (K-major, descriptor da) * B[64 x 16]^T
// (K-major, descriptor db); scale_d = 0 overwrites S
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

// S (=|+)= Q K^T over a kv tile of N keys
template <int N>
__device__ __forceinline__ void wgmma_s(float (&d)[N / 2], uint64_t da,
                                        uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_s<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  wgmma_ss_m64n64k16(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_s<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_m64n128k16(d, da, db, scale_d);
}

// O += P V over D value columns
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_m64n64k16(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n128k16(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_m64n256k16(d, a, db);
}

constexpr int kTcBM = 128;        // query rows per block
constexpr int kTcThreads = 384;   // loader warpgroup + 2 consumer warpgroups
constexpr int kTcConsumerWarps = 8;

// keys per kv tile (D the Q K^T width): 128 at D = 64, 128 and 192 (whose
// O is 128 values wide); 64 at D = 256, where S of 128 keys (64 registers a
// thread) does not fit beside O's 128
template <int D>
__host__ __device__ constexpr int tc_bn() {
  return D == 256 ? 64 : 128;
}
// Each consumer warpgroup walks its own 64 rows' kv tiles from the last
// visible one down.  A tile of 128 keys starts at or below the block's
// first row, a tile of 64 at or below each warpgroup's: so a warpgroup's
// first tile (its rows' last, or the prefix's last where that lies
// further, or a ragged end) is the only one it masks, and every row sees
// a key in it -- the tile's first key lies at or before the row, or inside
// the prefix.  At D = 256 the block's first tile of 64 keys can lie wholly
// above warpgroup 0's rows (past the prefix): warpgroup 0 releases it
// without computing.
template <int D>
constexpr bool tc_tiles_align() {
  return tc_bn<D>() == kTcBM || 64 % tc_bn<D>() == 0;
}
static_assert(tc_tiles_align<64>() && tc_tiles_align<128>() &&
                  tc_tiles_align<192>() && tc_tiles_align<256>(),
              "a warpgroup's first kv tile is its only masked one");

// slots of the K / V ring: 3 at D = 64 (32 KB a K, V pair), 2 at D = 128,
// 192 (80 KB a pair) and 256 (64 KB a pair)
template <int D>
__host__ __device__ constexpr int tc_stages() {
  return D == 64 ? 3 : 2;
}

// shared memory: Q (128 rows of HD), the K slots (tc_bn rows of HD) and
// the V slots (tc_bn rows of HV), the barriers, 1 KiB to align the base to
// the swizzle's 1024-byte period; every tile is 64-column boxes of
// 128-byte rows.  (192, 128): Q 48 KB, two K stages 96 KB, two V stages
// 64 KB
template <int HD, int HV>
constexpr int tc_smem_bytes() {
  return 1024 + 128 * ((HD / 64) * kTcBM +
                       tc_stages<HD>() * tc_bn<HD>() * ((HD + HV) / 64)) +
         (2 + 4 * tc_stages<HD>()) * 8;
}
static_assert(tc_smem_bytes<64, 64>() <= 232448 &&
                  tc_smem_bytes<128, 128>() <= 232448 &&
                  tc_smem_bytes<192, 128>() <= 232448 &&
                  tc_smem_bytes<256, 256>() <= 232448,
              "a block's shared memory is 227 KB");

template <int HD, int HV, bool kLse>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bf16_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  static_assert((HD == HV && (HD == 64 || HD == 128 || HD == 256)) ||
                    (HD == 192 && HV == 128),
                "head dims of the wgmma kernel");
  constexpr int BN = tc_bn<HD>();
  constexpr int kBoxQ = kTcBM * 128;       // a 64-column box of Q
  constexpr int kBoxK = BN * 128;          // of a K or V tile
  constexpr int kTileQ = (HD / 64) * kBoxQ;
  constexpr int kTileK = (HD / 64) * kBoxK;
  constexpr int kTileV = (HV / 64) * kBoxK;
  // deepseek's MLA (192, 128): P V in float32 accuracy, P split into bf16
  // hi and lo parts (module header)
  constexpr bool kSplitP = HD != HV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int stages = tc_stages<HD>();
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + kTileQ;
  uint8_t* sV = sK + stages * kTileK;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + stages * kTileV);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* k_empty = k_full + stages;
  uint64_t* v_full = k_empty + stages;
  uint64_t* v_empty = v_full + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kTcConsumerWarps);
    for (int st = 0; st < stages; ++st) {
      mbar_init(&k_full[st], 1);  // the loader's expect_tx
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], kTcConsumerWarps);  // one lane per warp
      mbar_init(&v_empty[st], kTcConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's tiles: round j takes tile j * gridDim.x + blockIdx.x,
  // blocks in reverse order on odd rounds, so that the heaviest-first order
  // of tile_of spreads evenly over the blocks (within 4 % of the most even
  // split at the model shapes)
  const int nq = (p.S + kTcBM - 1) / kTcBM;
  const int64_t n_tiles = (int64_t)p.bh * nq;
  const int ctas = gridDim.x, c = blockIdx.x;
  const int n_mine = (int)(n_tiles / ctas) +
      ((n_tiles / ctas) % 2 == 0 ? c < n_tiles % ctas
                                 : ctas - 1 - c < n_tiles % ctas);
  auto tile_at = [&](int j) {
    return tile_of(p, (int64_t)j * ctas + (j % 2 == 0 ? c : ctas - 1 - c),
                   p.bh, nq, p.group);
  };
  auto kv_tiles = [&](const Tile& tl) {
    const int kv_end = p.causal ? causal_end(p, tl.qb * kTcBM + kTcBM) : p.Sk;
    return (kv_end + BN - 1) / BN;
  };

  if (tid < 128) {
    // ---- loader: one thread issues every copy; the ring of K / V slots
    // runs on across this block's tiles, so the next tile's Q, K and V load
    // while the consumers finish the last one ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      int ring = 0;
      for (int j = 0; j < n_mine; ++j) {
        const Tile tl = tile_at(j);
        const int b = tl.bh / p.H, h = tl.bh % p.H;
        const int kvh = h / (p.H / p.KV);
        const int n_kv = kv_tiles(tl);
        if (j > 0) mbar_wait(q_empty, (j - 1) & 1);  // the last Q is done
        mbar_arrive_expect_tx(q_full, kTileQ);
#pragma unroll
        for (int cc = 0; cc < HD / 64; ++cc)
          tma_load_4d(sQ + cc * kBoxQ, &tm_q, q_full, 64 * cc, h,
                      tl.qb * kTcBM, b);
        for (int it = 0; it < n_kv; ++it, ++ring) {
          const int st = ring % stages;
          const uint32_t free_parity = ((ring / stages) & 1) ^ 1;
          const int k0 = (n_kv - 1 - it) * BN;  // from the last down
          mbar_wait(&k_empty[st], free_parity);
          mbar_arrive_expect_tx(&k_full[st], kTileK);
#pragma unroll
          for (int cc = 0; cc < HD / 64; ++cc)
            tma_load_4d(sK + st * kTileK + cc * kBoxK, &tm_k,
                        &k_full[st], 64 * cc, kvh, k0, b);
          mbar_wait(&v_empty[st], free_parity);
          mbar_arrive_expect_tx(&v_full[st], kTileV);
#pragma unroll
          for (int cc = 0; cc < HV / 64; ++cc)
            tma_load_4d(sV + st * kTileV + cc * kBoxK, &tm_v,
                        &v_full[st], 64 * cc, kvh, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows [q0 + 64 cw, q0 + 64 cw + 64) of
  // each tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = tid / 128 - 1;
  const int t = tid & 127, lane = t & 31;
  const int t4 = lane & 3;
  // accumulator fragment: thread t holds rows 16 (t / 32) + (t % 32) / 4
  // and +8 of the warpgroup's 64, columns 8 n + 2 (t % 4) + {0, 1} in
  // [4 n + {0, 1}] and [4 n + {2, 3}]
  const int frag_row = (t >> 5) * 16 + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  const uint32_t q_addr = smem_u32(sQ) + cw * 64 * 128;
  int row_lo = 0, row0 = 0;  // the tile's first row of this warpgroup, thread

  float o[HV / 2];
  float m[2], l[2];                 // running max (log2 domain), this
                                    // thread's share of the running sum
  float s[BN / 2];                  // S, then P, of the tile in hand
  uint32_t pa[BN / 16][4];          // P in bf16 as the A fragments of P V
  // at (192, 128) also P - bf16(P) in bf16 (kSplitP): P V as two products
  uint32_t pl[kSplitP ? BN / 16 : 1][4];
  float corr[2];
  // S = Q K^T of slot st: 64 rows x BN keys, HD / 16 steps of 16 (a box per
  // 64 columns); K-major rows of 128 bytes, 8-row groups 1 KB apart, the
  // step's 16 columns at +32 bytes inside the swizzled row.  Committed, not
  // waited for.
  auto issue_s = [&](int st) {
    const uint32_t k_addr = smem_u32(sK + st * kTileK);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_s<BN>(s, smem_desc(q_addr + (kk / 4) * kBoxQ + (kk % 4) * 32, 16,
                               1024),
                  smem_desc(k_addr + (kk / 4) * kBoxK + (kk % 4) * 32, 16,
                            1024),
                  kk > 0);
    wgmma_commit();
  };
  // O += P V of slot st: V MN-major, step j = keys [16 j, 16 j + 16) at
  // +2 KB, the 64-wide column boxes one box apart (LBO).  Committed, not
  // waited for.
  auto issue_pv = [&](int st) {
    const uint32_t v_addr = smem_u32(sV + st * kTileV);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint64_t dv = smem_desc(v_addr + j * 2048, kBoxK, 1024);
      if constexpr (kSplitP) wgmma_pv<HV>(o, pl[j], dv);  // small terms first
      wgmma_pv<HV>(o, pa[j], dv);
    }
    wgmma_commit();
  };
  // The online softmax of s (keys [k0, k0 + BN)): mask by position where
  // `masked` (the diagonal tile, the prefix's end, a ragged end: only the
  // warpgroup's first tile), by selects, so that no branch sits between
  // elements; new row max,
  // corr, p in s, l updated.  Maxima and sums in four partials a row, so
  // that the dependency chains stay short.  For scale > 0 (every model) the
  // row max is taken over the raw scores and the scale folds into one FFMA
  // before each exp2 (masked scores -inf); other scales multiply first.
  const int seq = p.Sk;  // the keys
  const bool causal = p.causal;
  const int prefix = p.prefix;
  auto softmax = [&](int k0, bool masked, auto positive) {
    constexpr bool kFold = decltype(positive)::value;
    if constexpr (!kFold) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] *= sl2;
    }
    if (masked) {
      const float drop = kFold ? -INFINITY : kNegInf;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          const bool out = key >= seq || (causal && hidden(key, row, prefix));
          s[4 * n + e] = out ? drop : s[4 * n + e];
        }
    }
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int a = 0; a < 4; ++a) mx[i][a] = kFold ? -INFINITY : kNegInf;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& acc = mx[e >> 1][(n & 1) * 2 + (e & 1)];
        acc = fmaxf(acc, s[4 * n + e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float row_max = quad_max(fmaxf(fmaxf(mx[i][0], mx[i][1]),
                                     fmaxf(mx[i][2], mx[i][3])));
      if constexpr (kFold) row_max *= sl2;  // every row sees a key
      const float m_new = fmaxf(m[i], row_max);
      corr[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * n + e];
        const float m_row = m[e >> 1];
        const float pe = fast_exp2(kFold ? fmaf(x, sl2, -m_row) : x - m_row);
        s[4 * n + e] = pe;
        rs[e >> 1][(n & 1) * 2 + (e & 1)] += pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = l[i] * corr[i] + ((rs[i][0] + rs[i][1]) + (rs[i][2] + rs[i][3]));
  };
  // scale > 0 or not: one test a tile, the same for every thread
  auto softmax_tile = [&](int k0, bool masked) {
    if (sl2 > 0.0f)
      softmax(k0, masked, std::true_type());
    else
      softmax(k0, masked, std::false_type());
  };
  // O *= corr, then P in bf16: the C fragments of key groups 2j and 2j+1
  // are the A fragment of key step j
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int n = 0; n < HV / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      if constexpr (kSplitP) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pack_hi_lo(s[8 * j + 2 * e], s[8 * j + 2 * e + 1], pa[j][e],
                     pl[j][e]);
      } else {
        pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
        pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
    }
  };
  auto fence_pa = [&]() {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      fence_frag(pa[j]);
      if constexpr (kSplitP) fence_frag(pl[j]);
    }
  };

  // The two consumer warpgroups take turns to issue their products (named
  // barriers 1 and 2, 256 threads: one warpgroup syncs, the other arrives),
  // so one warpgroup's softmax runs while the other's products do.  Each
  // takes n_kv + 1 turns a tile (a tile it releases unread takes one that
  // issues nothing); warpgroup 1 opens warpgroup 0's first turn and gives
  // no turn after its very last.
  const int my_turn = 1 + cw, their_turn = 2 - cw;
  if (cw == 1) bar_arrive(1, 256);

  int ring = 0;  // the K / V slot sequence, as the loader's
  for (int j = 0; j < n_mine; ++j) {
    const Tile tl = tile_at(j);
    const int b = tl.bh / p.H, h = tl.bh % p.H;
    row_lo = tl.qb * kTcBM + cw * 64;
    row0 = row_lo + frag_row;
    // the block's kv tiles (the loader's), this warpgroup's: the first
    // `skip` (0 or 1; 0 at compile time where the tiles are as tall as
    // the block) lie above its rows and past the prefix
    const int n_kv = kv_tiles(tl);
    const int n = BN < kTcBM && causal
                      ? (causal_end(p, row_lo + 64) + BN - 1) / BN
                      : n_kv;
    const int skip = BN < kTcBM ? n_kv - n : 0;
    const bool last_tile = j + 1 == n_mine;
#pragma unroll
    for (int i = 0; i < HV / 2; ++i) o[i] = 0.0f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.0f;

    mbar_wait(q_full, j & 1);
    if (BN < kTcBM && skip) {
      // released once it has landed, so that no arrival runs ahead of the
      // slot's phase
      const int st = ring % stages;
      mbar_wait(&k_full[st], (ring / stages) & 1);
      mbar_wait(&v_full[st], (ring / stages) & 1);
      bar_sync(my_turn, 256);
      bar_arrive(their_turn, 256);
      if (lane == 0) {
        mbar_arrive(&k_empty[st]);
        mbar_arrive(&v_empty[st]);
      }
    }
    const int r0 = ring + skip;  // this warpgroup's first tile in the ring

    // its kv tile 0 (its rows' last, or the prefix's, under causal): S,
    // softmax, P
    {
      const int st = r0 % stages;
      mbar_wait(&k_full[st], (r0 / stages) & 1);
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_s(st);
      bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc(s);
      if (lane == 0) {
        mbar_arrive(&k_empty[st]);
        if (n == 1) mbar_arrive(q_empty);  // Q is done
      }
      // a tile below every row of the warpgroup hides no key from them
      const int k0 = (n - 1) * BN;
      softmax_tile(k0, k0 + BN > seq || (causal && k0 + BN - 1 > row_lo));
      rescale_and_pack();
    }

    // kv tile it: S = Q K_it^T and O += P_{it-1} V_{it-1} in flight
    // together, the softmax of tile it runs while the tensor cores do P V
    for (int it = 1; it < n; ++it) {
      const int r = r0 + it;
      const int st = r % stages, pst = (r - 1) % stages;
      mbar_wait(&k_full[st], (r / stages) & 1);
      mbar_wait(&v_full[pst], ((r - 1) / stages) & 1);
      fence_acc(o);
      fence_pa();
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_s(st);
      issue_pv(pst);
      bar_arrive(their_turn, 256);
      wgmma_wait<1>();  // S done (groups complete in order)
      fence_acc(s);
      if (lane == 0) {
        mbar_arrive(&k_empty[st]);
        if (it == n - 1) mbar_arrive(q_empty);  // Q is done
      }
      // below the diagonal, or inside the prefix: nothing hidden
      softmax_tile((n - 1 - it) * BN, false);
      wgmma_wait<0>();  // P V done: O and P may change
      fence_acc(o);
      fence_pa();
      if (lane == 0) mbar_arrive(&v_empty[pst]);
      rescale_and_pack();
    }
    {
      const int r = ring + n_kv - 1;
      const int st = r % stages;
      mbar_wait(&v_full[st], (r / stages) & 1);
      fence_acc(o);
      fence_pa();
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_pv(st);
      if (cw == 0 || !last_tile) bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc(o);
      fence_pa();
      if (lane == 0) mbar_arrive(&v_empty[st]);
    }
    ring += n_kv;

    // l over the quad, then o = acc / max(l, 1e-30), rounded to bf16 once
    bf16* op = static_cast<bf16*>(p.o) + b * p.os_b + h * p.os_h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + i * 8;
      const float den = fmaxf(quad_sum(l[i]), kMinDenom);
      const float inv = 1.0f / den;
      if (row >= p.S) continue;
      if constexpr (kLse) {  // m is in the log2 domain of the scaled scores
        if (t4 == 0)
          p.lse[(int64_t)tl.bh * p.S + row] = (m[i] + log2f(den)) * kLn2;
      }
      bf16* orow = op + row * p.os_s;
#pragma unroll
      for (int n = 0; n < HV / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + t4 * 2) =
            pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
  }
}

// --- bf16, mma.sync: flash_bf16_mma_kernel ----------------------------------

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per kv tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of row padding (16 bytes)

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
constexpr int mma_smem_bytes() {
  return (kBQ * (HD + kPad) + 2 * kBK * (HD + kPad) + 2 * kBK * (HV + kPad)) *
         2;
}

template <int HD, int HV>
__global__ void __launch_bounds__(kThreads)
flash_bf16_mma_kernel(const Params p) {
  static_assert(HD % 16 == 0 && HV % 16 == 0, "mma / ldmatrix tile shapes");
  constexpr int LDQ = HD + kPad, LDK = HD + kPad, LDV = HV + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LDQ]
  bf16* Ks = Qs + kBQ * LDQ;                      // [2][kBK][LDK]
  bf16* Vs = Ks + 2 * kBK * LDK;                  // [2][kBK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma group / thread in group
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix matrix / row
  const Tile tile = block_tile(p);
  const int q0 = tile.qb * kBQ;
  const int b = tile.bh / p.H, h = tile.bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.qs_b + h * p.qs_h;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  bf16* op = static_cast<bf16*>(p.o) + b * p.os_b + h * p.os_h;

  // one kv tile into buffer `buf` (keys past Sk zero-filled)
  auto load_kv = [&](int kb, int buf) {
    const int k0 = kb * kBK;
    bf16* kd = Ks + buf * kBK * LDK;
    bf16* vd = Vs + buf * kBK * LDV;
    for (int i = tid; i < kBK * (HD / 8); i += kThreads) {
      const int r = i / (HD / 8), c = i % (HD / 8);
      const bool ok = k0 + r < p.Sk;
      cp_async16(smem_u32(kd + r * LDK + c * 8),
                 ok ? kp + (k0 + r) * p.ks_s + c * 8 : kp, ok);
    }
    for (int i = tid; i < kBK * (HV / 8); i += kThreads) {
      const int r = i / (HV / 8), c = i % (HV / 8);
      const bool ok = k0 + r < p.Sk;
      cp_async16(smem_u32(vd + r * LDV + c * 8),
                 ok ? vp + (k0 + r) * p.vs_s + c * 8 : vp, ok);
    }
  };

  // the Q tile (rows past S zero-filled) travels with kv tile 0
  for (int i = tid; i < kBQ * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    const bool ok = q0 + r < p.S;
    cp_async16(smem_u32(Qs + r * LDQ + c * 8),
               ok ? qp + (q0 + r) * p.qs_s + c * 8 : qp, ok);
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
  const int kv_end = p.causal ? causal_end(p, q0 + kBQ) : p.Sk;
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

    // scale, mask (tiles past a row of the block, keys past Sk only), row
    // max
    const bool masked = (k0 + kBK > p.Sk) || (p.causal && k0 + kBK - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (masked) {
          const int row = q0 + rw + (e >> 1) * 8;
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          if (key >= p.Sk || (p.causal && hidden(key, row, p.prefix)))
            x = kNegInf;
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

// --- float32, CUDA cores: flash_f32_kernel -----------------------------------

constexpr int kFQ = 64;         // query rows per block
constexpr int kFK = 64;         // keys per kv tile
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 rows x 4 keys each
constexpr int kFPad = 4;        // float row padding (keeps float4 alignment)

// Q, two buffers of K and V (the next tile loads under this one's
// products), P
template <int HD, int HV>
constexpr int f32_smem_bytes() {
  return (kFQ * (HD + kFPad) + 2 * kFK * (HD + kFPad) +
          2 * kFK * (HV + kFPad) + kFK * (kFQ + kFPad)) * 4;
}
static_assert(f32_smem_bytes<128, 128>() <= 232448,
              "a block's shared memory is 227 KB");

// rows [r0, r0 + 64) of a [S, W] float32 view with row stride `st` into a
// [64][ld] shared tile by 16-byte cp.async; rows past S are zero-filled
template <int W>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* src, int64_t st,
                                              int r0, int S) {
  for (int i = threadIdx.x; i < 64 * (W / 4); i += kFThreads) {
    const int r = i / (W / 4), c = i % (W / 4);
    const bool ok = r0 + r < S;
    cp_async16(smem_u32(dst + r * ld + c * 4),
               ok ? src + (r0 + r) * st + c * 4 : src, ok);
  }
}

// max and sum over the 16 lanes of a half warp (xor 1, 2, 4, 8): every lane
// ends with the same bits
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// two blocks an SM where their shared memory fits (128 registers a thread),
// else one
template <int HD, int HV>
constexpr int f32_min_blocks() {
  return 2 * (f32_smem_bytes<HD, HV>() + 1024) <= 233472 ? 2 : 1;
}

template <int HD, int HV, bool kLse>
__global__ void __launch_bounds__(kFThreads, (f32_min_blocks<HD, HV>()))
flash_f32_kernel(const Params p) {
  static_assert(HD % 4 == 0 && HV % 32 == 0, "tile shapes");
  constexpr int LQ = HD + kFPad, LK = HD + kFPad, LV = HV + kFPad;
  constexpr int LP = kFQ + kFPad;
  // accumulator columns: NG groups of VW consecutive floats, group g at
  // 16 VW g + VW tx, so a quarter warp's V reads are 128 consecutive bytes
  constexpr int VW = HV >= 64 ? 4 : 2;
  constexpr int NG = HV / (16 * VW);
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;                 // [kFQ][LQ]
  float* Ks = Qs + kFQ * LQ;       // [2][kFK][LK]
  float* Vs = Ks + 2 * kFK * LK;   // [2][kFK][LV]
  float* Pt = Vs + 2 * kFK * LV;   // [kFK][LP]: p of row ty + 16 i at 4 ty + i

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const Tile tile = block_tile(p);
  const int q0 = tile.qb * kFQ;
  const int b = tile.bh / p.H, h = tile.bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const float* qp = static_cast<const float*>(p.q) + b * p.qs_b + h * p.qs_h;
  const float* kp = static_cast<const float*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const float* vp = static_cast<const float*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  float* op = static_cast<float*>(p.o) + b * p.os_b + h * p.os_h;

  const int kv_end = p.causal ? causal_end(p, q0 + kFQ) : p.Sk;
  const int n_kv = (kv_end + kFK - 1) / kFK;
  load_rows_f32<HD>(Qs, LQ, qp, p.qs_s, q0, p.S);
  load_rows_f32<HD>(Ks, LK, kp, p.ks_s, 0, p.Sk);
  load_rows_f32<HV>(Vs, LV, vp, p.vs_s, 0, p.Sk);
  cp_async_commit();

  float acc[4][NG * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NG * VW; ++c) acc[i][c] = 0.0f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }

  for (int kb = 0; kb < n_kv; ++kb) {
    const int buf = kb & 1, k0 = kb * kFK;
    cp_async_wait<0>();
    // tile kb (and Q) landed for every thread, and every thread is done with
    // tile kb - 1: its K / V buffer and P may be overwritten
    __syncthreads();
    if (kb + 1 < n_kv) {  // in flight during this tile's products
      load_rows_f32<HD>(Ks + (buf ^ 1) * kFK * LK, LK, kp, p.ks_s, k0 + kFK,
                        p.Sk);
      load_rows_f32<HV>(Vs + (buf ^ 1) * kFK * LV, LV, vp, p.vs_s, k0 + kFK,
                        p.Sk);
      cp_async_commit();
    }
    const float* Kb = Ks + buf * kFK * LK;
    const float* Vb = Vs + buf * kFK * LV;

    // scores of rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], k4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k4[j] = *reinterpret_cast<const float4*>(Kb + (tx + 16 * j) * LK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i].x * k4[j].x;
          s[i][j] += a[i].y * k4[j].y;
          s[i][j] += a[i].z * k4[j].z;
          s[i][j] += a[i].w * k4[j].w;
        }
    }

    // scale, mask (tiles across the diagonal and past the prefix, or past
    // Sk, only; by selects, so that no branch sits between elements),
    // online softmax with the row statistics over the 16 lanes that share
    // the rows
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] *= p.scale;
    if ((k0 + kFK > p.Sk) || (p.causal && k0 + kFK - 1 > q0 &&
                              k0 + kFK > p.prefix)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + ty + 16 * i, key = k0 + tx + 16 * j;
          const bool out =
              key >= p.Sk || (p.causal && hidden(key, row, p.prefix));
          s[i][j] = out ? kNegInf : s[i][j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_max(mx));
      const float c = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = expf(s[i][j] - m_new);
        s[i][j] = pe;
        sum += pe;
      }
      l[i] = l[i] * c + half_sum(sum);
#pragma unroll
      for (int cc = 0; cc < NG * VW; ++cc) acc[i][cc] *= c;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx + 16 * j) * LP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // P of the whole tile is visible

    // acc += P V for rows ty + 16 i, this thread's accumulator columns
#pragma unroll 4
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 pq = *reinterpret_cast<const float4*>(Pt + kk * LP + 4 * ty);
      const float pv[4] = {pq.x, pq.y, pq.z, pq.w};
      float vv[NG * VW];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* src = Vb + kk * LV + 16 * VW * g + VW * tx;
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          vv[4 * g] = t.x;
          vv[4 * g + 1] = t.y;
          vv[4 * g + 2] = t.z;
          vv[4 * g + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(src);
          vv[VW * g] = t.x;
          vv[VW * g + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < NG * VW; ++cc) acc[i][cc] += pv[i] * vv[cc];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.S) continue;
    const float den = fmaxf(l[i], kMinDenom);
    if constexpr (kLse) {
      if (tx == 0) p.lse[(int64_t)tile.bh * p.S + row] = m[i] + logf(den);
    }
    float* orow = op + row * p.os_s;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        orow[16 * VW * g + VW * tx + e] = acc[i][VW * g + e] / den;
  }
}

// --- float32, 3xTF32 on wgmma: flash_f32_tc_kernel ----------------------------
//
// (hd, hv) = (192, 128), deepseek's MLA, and hd = hv = 256, paligemma's;
// module header.  K and V come from a pre-pass (flash_f32_split_kernel,
// flash_f32_vt_kernel) that writes each float32 x as TF32 hi = cvt.rna(x)
// and lo = cvt.rna(x - hi) into a scratch, V transposed, so each is a
// K-major TF32 tile that TMA loads and wgmma reads as it lies; Q lands as
// float32 and the consumers split it in place.

constexpr int kF3Rows = 64;      // query rows of a tile: one consumer warpgroup
constexpr int kF3Keys = 64;      // keys of a kv tile
constexpr int kF3Threads = 160;  // the consumer warpgroup, then the loader warp
constexpr int kF3Slot = 32768;   // a slot: 64 keys x 64 K columns, or a V^T
                                 // chunk (32 keys x 128 rows at (192, 128),
                                 // 64 keys x 64 rows at 256); hi then lo
constexpr int kF3Box = 8192;     // a box: 64 rows of 32 floats (128 bytes)

// ring slots: 4 beside (192, 128)'s Q of 96 KB, 3 beside hd 256's 128 KB
template <int HD>
__host__ __device__ constexpr int f32_tc_slots() {
  return HD == 256 ? 3 : 4;
}
// rows of V^T (columns of O) a V^T chunk holds: all 128 at (192, 128), 64
// at hv 256 (a box of 32 keys, the tensor map's box height)
template <int HV>
__host__ __device__ constexpr int f32_tc_vt_rows() {
  return HV == 256 ? 64 : HV;
}

// shared memory: the 1 KiB alignment of the swizzle's period, Q's hi and lo
// (64 rows of HD), the ring, the barriers (Q full / empty, a full / empty
// pair a slot)
template <int HD, int HV>
__host__ __device__ constexpr int f32_tc_smem_bytes() {
  return 1024 + 2 * kF3Rows * HD * 4 + f32_tc_slots<HD>() * kF3Slot +
         (2 + 2 * f32_tc_slots<HD>()) * 8;
}
static_assert(f32_tc_smem_bytes<192, 128>() <= 232448 &&
                  f32_tc_smem_bytes<256, 256>() <= 232448,
              "a block's shared memory is 227 KB");

// k as TF32 hi and lo (hopper.cuh split_rows)
template <int D>
__global__ void __launch_bounds__(256)
flash_f32_split_kernel(const float* src, int64_t sb, int64_t ss, int64_t sh,
                       int S, int heads, int64_t total, float* dst,
                       int64_t half) {
  split_rows<D>(src, sb, ss, sh, S, heads, total, dst, half);
}

// V^T as TF32 hi and lo, keys in tf32_key order (hopper.cuh split_tile)
template <int HV>
__global__ void __launch_bounds__(256)
flash_f32_vt_kernel(const float* v, int64_t sb, int64_t ss, int64_t sh,
                    int Sk, int KV, int skp, float* dst, int64_t half) {
  split_tile<HV>(v, sb, ss, sh, Sk, KV, skp, dst, half, nullptr, 0);
}

template <int HD, int HV, bool kLse>
__global__ void __launch_bounds__(kF3Threads, 1)
flash_f32_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const Params p) {
  static_assert((HD == 192 && HV == 128) || (HD == 256 && HV == 256),
                "the (192, 128) and the hd-256 kernels");
  // hv 256: O in four column blocks of 64, one V^T chunk (64 keys x 64
  // rows) each; (192, 128): O whole, V^T in chunks of 32 keys x 128 rows
  constexpr bool kWide = HV == 256;
  constexpr int kSlots = f32_tc_slots<HD>();
  constexpr int KC = HD / 64;                         // K chunks of a kv tile
  constexpr int VC = kWide ? HV / 64 : kF3Keys / 32;  // V^T chunks of a tile
  constexpr int OB = kWide ? HV / 64 : 1;             // O's column blocks
  constexpr int OW = HV / 2 / OB;     // O's floats a thread in a block
  constexpr int SA = kWide ? 2 : KC;  // S accumulators: a chunk pair or chunk
  // P V's fresh accumulator: (192, 128) all of O's 128 columns; hv 256 32
  // of them, half a column block (m64n32k8: 16 registers a thread; a block
  // of 64, 32 registers, spilled beside O's 128 and P's 64)
  constexpr int PW = kWide ? 16 : OW;  // pv floats a thread
  constexpr int PH = OW / PW;          // pv halves a column block
  static_assert(KC == (kWide ? 4 : 3) && VC == (kWide ? 4 : 2),
                "the waits and releases below");
  constexpr int kTileQ = 2 * kF3Rows * HD * 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;                   // HD / 32 boxes of hi, lo
  uint8_t* ring = sQ + kTileQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kSlots * kF3Slot);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + kSlots;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4);              // one lane per consumer warp
    for (int st = 0; st < kSlots; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's tiles, as the bf16 kernel deals them
  const int nq = (p.S + kF3Rows - 1) / kF3Rows;
  const int64_t n_tiles = (int64_t)p.bh * nq;
  const int ctas = gridDim.x, c = blockIdx.x;
  const int n_mine = (int)(n_tiles / ctas) +
      ((n_tiles / ctas) % 2 == 0 ? c < n_tiles % ctas
                                 : ctas - 1 - c < n_tiles % ctas);
  auto tile_at = [&](int j) {
    return tile_of(p, (int64_t)j * ctas + (j % 2 == 0 ? c : ctas - 1 - c),
                   p.bh, nq, p.group);
  };
  auto kv_tiles = [&](const Tile& tl) {
    const int kv_end =
        p.causal ? causal_end(p, tl.qb * kF3Rows + kF3Rows) : p.Sk;
    return (kv_end + kF3Keys - 1) / kF3Keys;
  };

  if (tid >= 128) {
    // ---- loader: one thread issues every copy; per kv tile KC chunks of K
    // (64 columns each), then VC of V^T, through the ring, which runs on
    // from one tile of queries to the next ----
    if (tid == 128) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      int r = 0;
      auto acquire = [&]() {
        const int st = r % kSlots;
        mbar_wait(&empty[st], ((r / kSlots) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], kF3Slot);
        ++r;
        return st;
      };
      for (int j = 0; j < n_mine; ++j) {
        const Tile tl = tile_at(j);
        const int kvbh = (tl.bh / p.H) * p.KV + (tl.bh % p.H) / (p.H / p.KV);
        const int n_kv = kv_tiles(tl);
        if (j > 0) mbar_wait(q_empty, (j - 1) & 1);  // the last Q is done
        mbar_arrive_expect_tx(q_full, kTileQ / 2);
#pragma unroll
        for (int cb = 0; cb < HD / 32; ++cb)
          tma_load_4d(sQ + cb * 2 * kF3Box, &tm_q, q_full, 32 * cb,
                      tl.bh % p.H, tl.qb * kF3Rows, tl.bh / p.H);
        for (int it = 0; it < n_kv; ++it) {
          const int k0 = (n_kv - 1 - it) * kF3Keys;  // from the last down
#pragma unroll
          for (int cc = 0; cc < KC; ++cc) {
            const int st = acquire();
            tma_load_4d(ring + st * kF3Slot, &tm_k, &full[st], 64 * cc, k0,
                        kvbh, 0);
            tma_load_4d(ring + st * kF3Slot + 2 * kF3Box, &tm_k, &full[st],
                        64 * cc + 32, k0, kvbh, 0);
          }
#pragma unroll
          for (int vc = 0; vc < VC; ++vc) {
            const int st = acquire();
            if constexpr (kWide) {  // V^T rows [64 vc, +64), keys in 2 boxes
              tma_load_4d(ring + st * kF3Slot, &tm_v, &full[st], k0, 64 * vc,
                          kvbh, 0);
              tma_load_4d(ring + st * kF3Slot + 2 * kF3Box, &tm_v, &full[st],
                          k0 + 32, 64 * vc, kvbh, 0);
            } else {
              tma_load_4d(ring + st * kF3Slot, &tm_v, &full[st], k0 + 32 * vc,
                          0, kvbh, 0);
            }
          }
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 64 rows of each tile ----
  const int lane = tid & 31, t4 = lane & 3;
  // accumulator fragment: thread t holds rows 16 (t / 32) + (t % 32) / 4
  // and +8, columns 8 n + 2 (t % 4) + {0, 1} in [4 n + {0, 1}] and
  // [4 n + {2, 3}]
  const int frag_row = (tid >> 5) * 16 + (lane >> 2);
  const float sl2 = p.scale * kLog2e;
  const uint32_t q_addr = smem_u32(sQ), ring_addr = smem_u32(ring);
  const int seq = p.Sk;
  const bool causal = p.causal;
  const int prefix = p.prefix;

  float o[OB][OW];         // O, float32, summed tile by tile
  float pv[PW];            // one kv tile's P V (columns of it), fresh
  float sc[SA][32];        // one kv tile's S in fresh accumulators
  float s[32];             // S, then P
  uint32_t ph[8][4], pl[8][4];  // P in TF32 hi and lo: the A fragments
  float m[2], l[2], corr[2];

  // acc (+)= Q K^T over the 64 columns of K chunk cc in slot st, 8 k8
  // steps (acc overwritten where `first`): the small terms first -- lo hi
  // and hi lo of every step -- then hi hi of every step, so that only 8 of
  // the 24 products add into an accumulator as large as S (the tensor
  // cores' accumulation truncates: interleaved, the 24 cost 3x the error).
  // Q box cb holds columns [32 cb, 32 cb + 32), hi then lo 8 KB on; a K
  // slot holds two such boxes.  Committed, not waited for.
  auto issue_s = [&](float (&acc)[32], int cc, int st, bool first) {
    auto desc = [&](int ks, bool q_lo, bool k_lo, uint64_t& dq,
                    uint64_t& dk) {
      const uint32_t qa = q_addr + (2 * cc + ks / 4) * 2 * kF3Box +
                          (ks % 4) * 32;
      const uint32_t ka = ring_addr + st * kF3Slot + (ks / 4) * 2 * kF3Box +
                          (ks % 4) * 32;
      dq = smem_desc(qa + (q_lo ? kF3Box : 0), 16, 1024);
      dk = smem_desc(ka + (k_lo ? kF3Box : 0), 16, 1024);
    };
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint64_t dq, dk;
      desc(ks, true, false, dq, dk);
      wgmma_tf32_ss_m64n64k8(acc, dq, dk, !(first && ks == 0));
      desc(ks, false, true, dq, dk);
      wgmma_tf32_ss_m64n64k8(acc, dq, dk, 1);
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint64_t dq, dk;
      desc(ks, false, false, dq, dk);
      wgmma_tf32_ss_m64n64k8(acc, dq, dk, 1);
    }
    wgmma_commit();
  };
  // P V into a fresh pv, 8 k8 steps over the tile's 64 keys, small terms
  // first as in S: P lo V^T hi and P hi V^T lo of every step, then P hi
  // V^T hi.  (192, 128): all 128 columns, V^T chunks 0 and 1 in slots st0
  // and st1 (32 keys each; V^T hi, then lo 16 KB on).  hv 256: half hf =
  // st1 of a column block, its V^T chunk in slot st0 (two boxes of 32 keys
  // x 64 rows, each hi then lo 8 KB on; the half's 32 rows 4 KB on, whole
  // swizzle periods).  Committed, not waited for.
  auto issue_pv = [&](int st0, int st1) {
    if constexpr (kWide) {
      auto vt = [&](int n, bool lo) {
        return smem_desc(ring_addr + st0 * kF3Slot + (n / 4) * 2 * kF3Box +
                             (lo ? kF3Box : 0) + (n % 4) * 32 + st1 * 4096,
                         16, 1024);
      };
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        wgmma_tf32_rs_m64n32k8(pv, pl[n], vt(n, false), n > 0);
        wgmma_tf32_rs_m64n32k8(pv, ph[n], vt(n, true), 1);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
        wgmma_tf32_rs_m64n32k8(pv, ph[n], vt(n, false), 1);
    } else {
      auto vt = [&](int n, bool lo) {
        return smem_desc(ring_addr + (n < 4 ? st0 : st1) * kF3Slot +
                             (lo ? 2 * kF3Box : 0) + (n % 4) * 32,
                         16, 1024);
      };
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        wgmma_tf32_rs_m64n128k8(pv, pl[n], vt(n, false), n > 0);
        wgmma_tf32_rs_m64n128k8(pv, ph[n], vt(n, true), 1);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
        wgmma_tf32_rs_m64n128k8(pv, ph[n], vt(n, false), 1);
    }
    wgmma_commit();
  };
  auto release = [&](int r) {
    if (lane == 0) mbar_arrive(&empty[r % kSlots]);
  };
  auto wait_full = [&](int r) {
    mbar_wait(&full[r % kSlots], (r / kSlots) & 1);
  };
  // O = O corr + pv over half hf of column block cb, in float32
  auto add_pv = [&](int cb, int hf) {
#pragma unroll
    for (int n = 0; n < PW / 4; ++n) {
      float* oo = o[cb] + hf * PW;
      oo[4 * n] = fmaf(oo[4 * n], corr[0], pv[4 * n]);
      oo[4 * n + 1] = fmaf(oo[4 * n + 1], corr[0], pv[4 * n + 1]);
      oo[4 * n + 2] = fmaf(oo[4 * n + 2], corr[1], pv[4 * n + 2]);
      oo[4 * n + 3] = fmaf(oo[4 * n + 3], corr[1], pv[4 * n + 3]);
    }
  };
  // the online softmax of s (keys [k0, k0 + 64)), as the bf16 kernel's:
  // masked by selects where `masked`, the row max over the raw scores with
  // the scale folded into one FFMA before each exp2 when scale > 0
  auto softmax = [&](int k0, bool masked, int row0, auto positive) {
    constexpr bool kFold = decltype(positive)::value;
    if constexpr (!kFold) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= sl2;
    }
    if (masked) {
      const float drop = kFold ? -INFINITY : kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          const bool out = key >= seq || (causal && hidden(key, row, prefix));
          s[4 * n + e] = out ? drop : s[4 * n + e];
        }
    }
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int a = 0; a < 4; ++a) mx[i][a] = kFold ? -INFINITY : kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& acc = mx[e >> 1][(n & 1) * 2 + (e & 1)];
        acc = fmaxf(acc, s[4 * n + e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float row_max = quad_max(fmaxf(fmaxf(mx[i][0], mx[i][1]),
                                     fmaxf(mx[i][2], mx[i][3])));
      if constexpr (kFold) row_max *= sl2;
      const float m_new = fmaxf(m[i], row_max);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float rs[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * n + e];
        const float m_row = m[e >> 1];
        const float pe = exp2f(kFold ? fmaf(x, sl2, -m_row) : x - m_row);
        s[4 * n + e] = pe;
        rs[e >> 1][(n & 1) * 2 + (e & 1)] += pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = l[i] * corr[i] + ((rs[i][0] + rs[i][1]) + (rs[i][2] + rs[i][3]));
  };

  int r = 0;  // the ring's sequence, as the loader's
  for (int j = 0; j < n_mine; ++j) {
    const Tile tl = tile_at(j);
    const int b = tl.bh / p.H, h = tl.bh % p.H;
    const int row_lo = tl.qb * kF3Rows, row0 = row_lo + frag_row;
    const int n_kv = kv_tiles(tl);
#pragma unroll
    for (int cb = 0; cb < OB; ++cb)
#pragma unroll
      for (int i = 0; i < OW; ++i) o[cb][i] = 0.0f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.0f;
    mbar_wait(q_full, j & 1);
    // Q as it landed (float32 in each box's hi half) into TF32 hi and lo in
    // place: a box's lo half has the hi half's layout, so an element keeps
    // its offset; the writes reach the tensor cores' proxy by the fence
#pragma unroll
    for (int cb = 0; cb < HD / 32; ++cb)
#pragma unroll
      for (int e = 0; e < kF3Box / 16 / 128; ++e) {
        float4* hi = reinterpret_cast<float4*>(sQ + cb * 2 * kF3Box) +
                     e * 128 + tid;
        const float4 x = *hi;
        float4 h4, l4;
        split_f32(x.x, h4.x, l4.x);
        split_f32(x.y, h4.y, l4.y);
        split_f32(x.z, h4.z, l4.z);
        split_f32(x.w, h4.w, l4.w);
        *hi = h4;
        *reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(hi) +
                                   kF3Box) = l4;
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1, 128);

    for (int it = 0; it < n_kv; ++it, r += KC + VC) {
      const int k0 = (n_kv - 1 - it) * kF3Keys;
      // S: the K chunks' products back to back, each chunk's slot released
      // as soon as its products are done.  (192, 128): a fresh accumulator
      // a chunk; hd 256: chunks 0, 1 chained in sc[0] and 2, 3 in sc[1] (a
      // fresh accumulator a chunk beside O's 128 registers would not fit)
      if constexpr (kWide) {
#pragma unroll
        for (int cc = 0; cc < KC; ++cc) {
          wait_full(r + cc);
          wgmma_fence();
          issue_s(sc[cc / 2], cc, (r + cc) % kSlots, cc % 2 == 0);
          if (cc > 0) {
            wgmma_wait<1>();
            release(r + cc - 1);
          }
        }
        wgmma_wait<0>();
        release(r + KC - 1);
      } else {
#pragma unroll
        for (int cc = 0; cc < KC; ++cc) {
          wait_full(r + cc);
          wgmma_fence();
          issue_s(sc[cc], cc, (r + cc) % kSlots, true);
        }
        wgmma_wait<2>();
        release(r);
        wgmma_wait<1>();
        release(r + 1);
        wgmma_wait<0>();
        release(r + 2);
      }
#pragma unroll
      for (int a = 0; a < SA; ++a) fence_acc(sc[a]);
      if (it == n_kv - 1 && lane == 0) mbar_arrive(q_empty);  // Q is done
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (kWide)
          s[i] = sc[0][i] + sc[1][i];
        else
          s[i] = (sc[0][i] + sc[1][i]) + sc[2][i];
      }
      // only the first tile (the diagonal, the prefix's end, a ragged end)
      // hides a key from a row
      const bool masked =
          it == 0 && (k0 + kF3Keys > seq || (causal && k0 + kF3Keys - 1 >
                                                           row_lo));
      if (sl2 > 0.0f)
        softmax(k0, masked, row0, std::true_type());
      else
        softmax(k0, masked, row0, std::false_type());
      // P as TF32 hi and lo: the accumulator fragment of key group n is the
      // A fragment of k8 step n with k-slot t = key 2 t, t + 4 = key 2 t + 1
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        split_tf32<true>(s[4 * n], ph[n][0], pl[n][0]);
        split_tf32<true>(s[4 * n + 2], ph[n][1], pl[n][1]);
        split_tf32<true>(s[4 * n + 1], ph[n][2], pl[n][2]);
        split_tf32<true>(s[4 * n + 3], ph[n][3], pl[n][3]);
      }
      // P V into a fresh accumulator, added to O in float32: the tensor
      // cores' accumulation truncates, and over a whole row (1,536 wgmma
      // steps at S = 4096) it would drift.  hv 256: 32 columns at a time
      // (a fresh accumulator as wide as O would not fit beside it), each
      // column block's V^T chunk released after its two halves
      if constexpr (kWide) {
#pragma unroll
        for (int cb = 0; cb < OB; ++cb) {
          wait_full(r + KC + cb);
#pragma unroll
          for (int hf = 0; hf < PH; ++hf) {
            wgmma_fence();
            issue_pv((r + KC + cb) % kSlots, hf);
            wgmma_wait<0>();
            fence_acc(pv);
            add_pv(cb, hf);
          }
          release(r + KC + cb);
        }
      } else {
        wait_full(r + KC);
        wait_full(r + KC + 1);
        wgmma_fence();
        issue_pv((r + KC) % kSlots, (r + KC + 1) % kSlots);
        wgmma_wait<0>();
        release(r + KC);
        release(r + KC + 1);
        fence_acc(pv);
        add_pv(0, 0);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        fence_frag(ph[n]);
        fence_frag(pl[n]);
      }
    }

    // l over the quad, then o = acc / max(l, 1e-30)
    float* op = static_cast<float*>(p.o) + b * p.os_b + h * p.os_h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + i * 8;
      const float den = fmaxf(quad_sum(l[i]), kMinDenom);
      if (row >= p.S) continue;
      if constexpr (kLse) {  // m is in the log2 domain of the scaled scores
        if (t4 == 0)
          p.lse[(int64_t)tl.bh * p.S + row] = (m[i] + log2f(den)) * kLn2;
      }
      float* orow = op + row * p.os_s;
#pragma unroll
      for (int cb = 0; cb < OB; ++cb)
#pragma unroll
        for (int n = 0; n < OW / 4; ++n)
          *reinterpret_cast<float2*>(orow + 64 * cb + n * 8 + t4 * 2) =
              make_float2(o[cb][4 * n + 2 * i] / den,
                          o[cb][4 * n + 2 * i + 1] / den);
    }
  }
}

// --- launch ------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int smem, int threads, const Params& p, int gx,
           int gy, unsigned* smem_done, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = allow_smem(kernel, smem, device, smem_done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), threads, smem,
           (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD, int HV>
int launch_mma(const Params& p, int gx, int gy, int device, void* stream) {
  static unsigned done = 0;
  return launch(flash_bf16_mma_kernel<HD, HV>, mma_smem_bytes<HD, HV>(),
                kThreads, p, gx, gy, &done, device, stream);
}

template <int HD, int HV, bool kLse = false>
int launch_f32(const Params& p, int gx, int gy, int device, void* stream) {
  static unsigned done = 0;
  return launch(flash_f32_kernel<HD, HV, kLse>, f32_smem_bytes<HD, HV>(),
                kFThreads, p, gx, gy, &done, device, stream);
}

// the (hd, hv) instances: hd, hv in {32, 64, 128}
#define FLASH_DISPATCH(LAUNCH)                                    \
  switch (hd * 1000 + hv) {                                       \
    case 32032: return LAUNCH<32, 32>(p, gx, gy, device, stream);   \
    case 32064: return LAUNCH<32, 64>(p, gx, gy, device, stream);   \
    case 32128: return LAUNCH<32, 128>(p, gx, gy, device, stream);  \
    case 64032: return LAUNCH<64, 32>(p, gx, gy, device, stream);   \
    case 64064: return LAUNCH<64, 64>(p, gx, gy, device, stream);   \
    case 64128: return LAUNCH<64, 128>(p, gx, gy, device, stream);  \
    case 128032: return LAUNCH<128, 32>(p, gx, gy, device, stream); \
    case 128064: return LAUNCH<128, 64>(p, gx, gy, device, stream); \
    case 128128: return LAUNCH<128, 128>(p, gx, gy, device, stream);\
    default: return (int)cudaErrorInvalidValue;                   \
  }

Params make_params(const void* q, const void* k, const void* v, void* o,
                   int S, int Sk, int H, int KV, const long long* st,
                   float scale, int causal, int prefix) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.S = S; p.Sk = Sk; p.H = H; p.KV = KV;
  p.qs_b = st[0]; p.qs_s = st[1]; p.qs_h = st[2];
  p.ks_b = st[3]; p.ks_s = st[4]; p.ks_h = st[5];
  p.vs_b = st[6]; p.vs_s = st[7]; p.vs_h = st[8];
  p.os_b = st[9]; p.os_s = st[10]; p.os_h = st[11];
  p.scale = scale;
  p.causal = causal;
  p.prefix = prefix;
  p.bh = 0;         // set by the entry point that needs it
  p.group = 0;
  p.lse = nullptr;  // set by the *_lse entry points
  return p;
}

// the lengths every variant takes: S query rows, Sk keys, Sk == S when
// causal; a prefix (>= 0) only when causal
bool lengths_fit(int S, int Sk, int causal, int prefix) {
  return S >= 1 && Sk >= 1 && (!causal || Sk == S) && prefix >= 0 &&
         (causal || prefix == 0);
}

// the checks every variant shares: the plan's tile and grid fit the shape
bool plan_fits(int B, int S, int Sk, int H, int KV, int causal, int prefix,
               int block_q, int block_k, int want_q, int want_k, int gx,
               int gy) {
  return B >= 1 && lengths_fit(S, Sk, causal, prefix) && KV >= 1 &&
         H % KV == 0 &&
         block_q == want_q && block_k == want_k &&
         (int64_t)gx == (int64_t)B * H && gy == (S + block_q - 1) / block_q;
}

// every row of q, k, v, o starts on 16 bytes (TMA's and cp.async's rule)
bool rows_aligned16(const void* q, const void* k, const void* v,
                    const void* o, const long long* st, int elem) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return false;
  for (int i = 0; i < 12; ++i)
    if ((st[i] * elem) % 16) return false;
  return true;
}

// a 4-D tensor map over a BSHD bf16 tensor as it lies, dims (d, heads, S,
// B), boxes of 64 x 1 x rows x 1
bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int heads,
                 int d, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_bf16(map, base, 4, dims, strides, box);
}

template <int HD, int HV, bool kLse>
int launch_tc(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
              const CUtensorMap& tm_v, const Params& p, int gx, int gy,
              int device, void* stream) {
  static unsigned done = 0;
  auto kernel = flash_bf16_tc_kernel<HD, HV, kLse>;
  constexpr int smem = tc_smem_bytes<HD, HV>();
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = allow_smem(kernel, smem, device, &done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), kTcThreads, smem,
           (cudaStream_t)stream>>>(tm_q, tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

// The heads of a tile group (tile_of): one -- the tiles run head by head,
// every q-block of a head heaviest first, then the next head's -- where
// the K and V that one round of the grid streams in the order of a single
// group (gx heads at one q-block, their kv heads' K and V up to Sk) pass
// kL2Group, more than the 50 MB L2 holds; else every head.  Head by head,
// a round's blocks stream the K and V of the few heads it holds, which the
// L2 keeps: deepseek's prefill (128 heads, K and V of 2.6 MB each at S =
// 4096) reads them from device memory again for every q-block otherwise.
// The rounds' alternating block order keeps head by head within ~3 % of
// the even split at deepseek's shapes.
// elem: the bytes a column of K and V takes in the tiles the blocks stream
// (2 in bf16; 8 for the float32 wgmma kernel's TF32 hi and lo)
constexpr int64_t kL2Group = 64ll << 20;
int tc_group(int B, int Sk, int H, int KV, int hd, int hv, int gx,
             int elem = 2) {
  const int64_t heads = gx < (int64_t)B * H ? gx : (int64_t)B * H;
  const int64_t g = H / KV;
  const int64_t round_bytes = (heads + g - 1) / g * Sk * (hd + hv) * elem;
  return round_bytes > kL2Group ? 1 : B * H;
}

// the tensor-core entry points: checks, tensor maps, launch (lse nullptr:
// prefill's instance)
int tc_entry(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int Sk, int H, int KV, int hd, int hv,
             const long long* strides, float scale, int causal, int prefix,
             int block_q, int block_k, int gx, int gy, int device,
             void* stream) {
  const int64_t n_tiles = (int64_t)B * H * ((S + kTcBM - 1) / kTcBM);
  const int bn = hd == 64    ? tc_bn<64>()
                 : hd == 128 ? tc_bn<128>()
                 : hd == 192 ? tc_bn<192>()
                             : tc_bn<256>();
  const bool square = hd == hv && (hd == 64 || hd == 128 || hd == 256);
  if (!(square || (hd == 192 && hv == 128)) || B < 1 ||
      !lengths_fit(S, Sk, causal, prefix) || KV < 1 || H % KV ||
      block_q != kTcBM || block_k != bn || gx < 1 || gx > n_tiles ||
      gy != 1 || !rows_aligned16(q, k, v, o, strides, 2))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q = {}, tm_k = {}, tm_v = {};
  if (!encode_bshd(&tm_q, q, B, S, H, hd, strides, kTcBM) ||
      !encode_bshd(&tm_k, k, B, Sk, KV, hd, strides + 3, bn) ||
      !encode_bshd(&tm_v, v, B, Sk, KV, hv, strides + 6, bn))
    return (int)cudaErrorInvalidValue;
  Params p =
      make_params(q, k, v, o, S, Sk, H, KV, strides, scale, causal, prefix);
  p.bh = B * H;
  p.group = tc_group(B, Sk, H, KV, hd, hv, gx);
  p.lse = lse;
  switch (hd * 2 + (lse != nullptr)) {
    case 128: return launch_tc<64, 64, false>(tm_q, tm_k, tm_v, p, gx, gy,
                                              device, stream);
    case 129: return launch_tc<64, 64, true>(tm_q, tm_k, tm_v, p, gx, gy,
                                             device, stream);
    case 256: return launch_tc<128, 128, false>(tm_q, tm_k, tm_v, p, gx, gy,
                                                device, stream);
    case 257: return launch_tc<128, 128, true>(tm_q, tm_k, tm_v, p, gx, gy,
                                               device, stream);
    case 384: return launch_tc<192, 128, false>(tm_q, tm_k, tm_v, p, gx, gy,
                                                device, stream);
    case 385: return launch_tc<192, 128, true>(tm_q, tm_k, tm_v, p, gx, gy,
                                               device, stream);
    case 512: return launch_tc<256, 256, false>(tm_q, tm_k, tm_v, p, gx, gy,
                                                device, stream);
    default: return launch_tc<256, 256, true>(tm_q, tm_k, tm_v, p, gx, gy,
                                              device, stream);
  }
}

// the pre-pass (split k, split and transpose v into `scratch`), then
// the kernel over tensor maps of the scratch
template <int HD, int HV, bool kLse>
int launch_f32_tc(const void* q, const void* k, const void* v,
                  const long long* st, float* scratch, const Params& p,
                  int B, int gx, int device, void* stream) {
  static unsigned done = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t skp = (int64_t)(p.Sk + kF3Keys - 1) / kF3Keys * kF3Keys;
  const int64_t kn = (int64_t)B * p.KV * p.Sk * HD;
  const int64_t vn = (int64_t)B * p.KV * HV * skp;
  float* ks = scratch;
  float* vt = ks + 2 * kn;
  auto blocks = [](int64_t total) {
    const int64_t n = (total + 255) / 256;
    return (int)(n < 132 * 16 ? n : 132 * 16);
  };
  flash_f32_split_kernel<HD><<<blocks(kn / 4), 256, 0, s>>>(
      static_cast<const float*>(k), st[3], st[4], st[5], p.Sk, p.KV, kn / 4,
      ks, kn);
  flash_f32_vt_kernel<HV><<<dim3((unsigned)(skp / 64), HV / 64,
                                 (unsigned)(B * p.KV)), 256, 0, s>>>(
      static_cast<const float*>(v), st[6], st[7], st[8], p.Sk, p.KV,
      (int)skp, vt, vn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // q as it lies: dims (hd, heads, S, B), boxes of 32 columns (128 bytes)
  // x 1 x 64 rows x 1.  The scratch: dims innermost first (columns, rows,
  // b * heads, hi / lo); boxes of 32 columns x 64 rows (V^T's
  // f32_tc_vt_rows) x 1 x both
  CUtensorMap tm_q = {}, tm_k = {}, tm_v = {};
  const cuuint64_t qd[4] = {HD, (cuuint64_t)p.H, (cuuint64_t)p.S,
                            (cuuint64_t)B};
  const cuuint64_t qstr[3] = {(cuuint64_t)st[2] * 4, (cuuint64_t)st[1] * 4,
                              (cuuint64_t)st[0] * 4};
  const cuuint32_t box_q[4] = {32, 1, kF3Rows, 1};
  const cuuint64_t kd[4] = {HD, (cuuint64_t)p.Sk, (cuuint64_t)B * p.KV, 2};
  const cuuint64_t kstr[3] = {HD * 4, (cuuint64_t)p.Sk * HD * 4,
                              (cuuint64_t)kn * 4};
  const cuuint64_t vd[4] = {(cuuint64_t)skp, HV, (cuuint64_t)B * p.KV, 2};
  const cuuint64_t vstr[3] = {(cuuint64_t)skp * 4, (cuuint64_t)skp * HV * 4,
                              (cuuint64_t)vn * 4};
  const cuuint32_t box_rows[4] = {32, kF3Rows, 1, 2};
  const cuuint32_t box_vt[4] = {32, f32_tc_vt_rows<HV>(), 1, 2};
  if (!encode_f32(&tm_q, q, 4, qd, qstr, box_q) ||
      !encode_f32(&tm_k, ks, 4, kd, kstr, box_rows) ||
      !encode_f32(&tm_v, vt, 4, vd, vstr, box_vt))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_f32_tc_kernel<HD, HV, kLse>;
  constexpr int smem = f32_tc_smem_bytes<HD, HV>();
  err = allow_smem(kernel, smem, device, &done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)gx, 1), kF3Threads, smem, s>>>(tm_q, tm_k, tm_v,
                                                          p);
  return (int)cudaGetLastError();
}

// the float32 wgmma entry points: checks, then the launches (lse nullptr:
// prefill's instance)
int f32_tc_entry(const void* q, const void* k, const void* v, void* o,
                 float* lse, void* scratch, int B, int S, int Sk, int H,
                 int KV, int hd, int hv, const long long* strides,
                 float scale, int causal, int prefix, int block_q,
                 int block_k, int gx, int gy, int device, void* stream) {
  const int64_t n_tiles = (int64_t)B * H * ((S + kF3Rows - 1) / kF3Rows);
  const bool pair = (hd == 192 && hv == 128) || (hd == 256 && hv == 256);
  if (!pair || B < 1 ||
      !lengths_fit(S, Sk, causal, prefix) || KV < 1 || H % KV ||
      block_q != kF3Rows || block_k != kF3Keys || gx < 1 || gx > n_tiles ||
      gy != 1 || scratch == nullptr || !aligned16(scratch) ||
      !rows_aligned16(q, k, v, o, strides, 4))
    return (int)cudaErrorInvalidValue;
  Params p =
      make_params(q, k, v, o, S, Sk, H, KV, strides, scale, causal, prefix);
  p.bh = B * H;
  p.group = tc_group(B, Sk, H, KV, hd, hv, gx, 8);
  p.lse = lse;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  float* sc = static_cast<float*>(scratch);
  switch (hd * 2 + (lse != nullptr)) {
    case 384: return launch_f32_tc<192, 128, false>(q, k, v, strides, sc, p,
                                                    B, gx, device, stream);
    case 385: return launch_f32_tc<192, 128, true>(q, k, v, strides, sc, p,
                                                   B, gx, device, stream);
    case 512: return launch_f32_tc<256, 256, false>(q, k, v, strides, sc, p,
                                                    B, gx, device, stream);
    default: return launch_f32_tc<256, 256, true>(q, k, v, strides, sc, p,
                                                  B, gx, device, stream);
  }
}

}  // namespace

extern "C" {

// Every entry point: q, k, v, o device pointers; B, S (query rows), Sk
// (keys; == S when causal), H, KV, hd, hv;
// strides: 12 element strides, (batch, seq, head) of q, k, v, o in order;
// the softmax scale; causal; prefix (causal only: keys [0, prefix) seen by
// every row); the plan: block_q x block_k tile, grid (gx, gy); the device
// and the stream.

// bf16 on wgmma.  Plan: 128 query rows x 128 keys (64 keys at hd 256), a
// persistent grid (gx, 1) of gx <= B*H * ceil(S / 128) blocks that walk the
// tiles; hd == hv in {64, 128, 256} or (hd, hv) = (192, 128), every row
// 16-byte aligned.
int flash_attention_bf16_tc(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int Sk, int H, int KV,
                            int hd, int hv, const long long* strides,
                            float scale, int causal, int prefix, int block_q,
                            int block_k, int gx, int gy, int device,
                            void* stream) {
  return tc_entry(q, k, v, o, nullptr, B, S, Sk, H, KV, hd, hv, strides,
                  scale, causal, prefix, block_q, block_k, gx, gy, device,
                  stream);
}

// the same, also writing the row log-sum-exp lse [B, H, S] (float32)
int flash_attention_bf16_tc_lse(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int S, int Sk,
                                int H, int KV, int hd, int hv,
                                const long long* strides, float scale,
                                int causal, int prefix, int block_q,
                                int block_k, int gx, int gy, int device,
                                void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return tc_entry(q, k, v, o, static_cast<float*>(lse), B, S, Sk, H, KV, hd,
                  hv, strides, scale, causal, prefix, block_q, block_k, gx,
                  gy, device, stream);
}

// bf16 on mma.sync, hd, hv in {32, 64, 128}.  Plan: 64 x 64, grid (B*H,
// ceil(S / 64)); every row 16-byte aligned.
int flash_attention_bf16_mma(const void* q, const void* k, const void* v,
                             void* o, int B, int S, int Sk, int H, int KV,
                             int hd, int hv, const long long* strides,
                             float scale, int causal, int prefix,
                             int block_q, int block_k, int gx, int gy,
                             int device, void* stream) {
  if (!plan_fits(B, S, Sk, H, KV, causal, prefix, block_q, block_k, kBQ, kBK,
                 gx, gy) ||
      !rows_aligned16(q, k, v, o, strides, 2))
    return (int)cudaErrorInvalidValue;
  const Params p =
      make_params(q, k, v, o, S, Sk, H, KV, strides, scale, causal, prefix);
  FLASH_DISPATCH(launch_mma)
}

// float32 on the CUDA cores, hd, hv in {32, 64, 128}.  Plan: 64 x 64, grid
// (B*H, ceil(S / 64)); every row 16-byte aligned.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Sk, int H, int KV, int hd, int hv,
                        const long long* strides, float scale, int causal,
                        int prefix, int block_q, int block_k, int gx, int gy,
                        int device, void* stream) {
  if (!plan_fits(B, S, Sk, H, KV, causal, prefix, block_q, block_k, kFQ, kFK,
                 gx, gy) ||
      !rows_aligned16(q, k, v, o, strides, 4))
    return (int)cudaErrorInvalidValue;
  const Params p =
      make_params(q, k, v, o, S, Sk, H, KV, strides, scale, causal, prefix);
  FLASH_DISPATCH(launch_f32)
}

// the same, also writing the row log-sum-exp lse [B, H, S] (float32); hd ==
// hv in {64, 128}
int flash_attention_f32_lse(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int S, int Sk, int H,
                            int KV, int hd, int hv, const long long* strides,
                            float scale, int causal, int prefix, int block_q,
                            int block_k, int gx, int gy, int device,
                            void* stream) {
  const bool square = hd == hv && (hd == 64 || hd == 128);
  if (lse == nullptr || !square ||
      !plan_fits(B, S, Sk, H, KV, causal, prefix, block_q, block_k, kFQ, kFK,
                 gx, gy) ||
      !rows_aligned16(q, k, v, o, strides, 4))
    return (int)cudaErrorInvalidValue;
  Params p =
      make_params(q, k, v, o, S, Sk, H, KV, strides, scale, causal, prefix);
  p.lse = static_cast<float*>(lse);
  return hd == 64 ? launch_f32<64, 64, true>(p, gx, gy, device, stream)
                  : launch_f32<128, 128, true>(p, gx, gy, device, stream);
}

// float32 as 3xTF32 on wgmma, (hd, hv) = (192, 128) or hd = hv = 256.
// Plan: 64 query rows x 64 keys, a persistent grid (gx, 1) of gx <= B*H *
// ceil(S / 64) blocks that walk the tiles; every row 16-byte aligned.
// scratch: float32, 16-byte aligned, 2 (B KV Sk hd + B KV hv skp) floats,
// skp = Sk rounded up to a multiple of 64: k split into TF32 hi and lo, v
// transposed and split.
int flash_attention_f32_tc(const void* q, const void* k, const void* v,
                           void* o, void* scratch, int B, int S, int Sk,
                           int H, int KV, int hd, int hv,
                           const long long* strides, float scale, int causal,
                           int prefix, int block_q, int block_k, int gx,
                           int gy, int device, void* stream) {
  return f32_tc_entry(q, k, v, o, nullptr, scratch, B, S, Sk, H, KV, hd, hv,
                      strides, scale, causal, prefix, block_q, block_k, gx,
                      gy, device, stream);
}

// the same, also writing the row log-sum-exp lse [B, H, S] (float32)
int flash_attention_f32_tc_lse(const void* q, const void* k, const void* v,
                               void* o, void* lse, void* scratch, int B,
                               int S, int Sk, int H, int KV, int hd, int hv,
                               const long long* strides, float scale,
                               int causal, int prefix, int block_q,
                               int block_k, int gx, int gy, int device,
                               void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return f32_tc_entry(q, k, v, o, static_cast<float*>(lse), scratch, B, S,
                      Sk, H, KV, hd, hv, strides, scale, causal, prefix,
                      block_q, block_k, gx, gy, device, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
