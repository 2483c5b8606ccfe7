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
//   over j <= i when causal, over all j < S otherwise.
//     in : q [B, S, H, hd], k [B, S, KV, hd], v [B, S, KV, hv] (T, any
//          strides with the last dimension dense, 16-byte aligned rows)
//     out: o [B, S, H, hv] (T)
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
//   flash_bf16_tc_kernel<D>   bf16, hd == hv == D in {64, 128}, q, k, v
//     16-byte aligned with strides of whole 16 bytes: every model shape.
//     Persistent: one block an SM walks the tiles of 128 query rows of one
//     (b, h), the heaviest first, in rounds whose block order alternates so
//     that every block gets an even share of the work.  Block = 3
//     warpgroups: warpgroup 0 loads, warpgroups 1 and 2 each own 64 rows of
//     a tile.  Warp specialisation: the loader drops to 24 registers
//     (setmaxnreg) and one of its threads issues every TMA copy; the
//     consumers rise to 240, so an S tile of 64 floats, an O tile of D/2
//     floats and P's fragments stay in registers.
//       Loads: TMA over 4-D tensor maps of q, k, v as they lie, dims
//       (hd, heads, S, B), boxes of 64 x 1 x 128 x 1 in the 128-byte swizzle
//       (a 128-byte box row is 64 bf16, so D = 128 takes two boxes a tile).
//       A box never runs into the next sequence, and TMA's zero fill covers
//       rows and keys past S.  K and V tiles of 128 keys go through a ring
//       of tc_stages<D>() slots (3 at D = 64, 2 at D = 128; 2 to 6 ran
//       alike at D = 64) with separate full / empty mbarriers for K and V,
//       so S = Q K^T on a tile starts before its V has landed.  The ring
//       runs on from one tile of queries to the next, and Q has its own
//       full / empty pair: the next tile's Q, K and V load while the
//       consumers finish the last one.
//       S = Q K^T: wgmma.m64n128k16, both operands from shared memory; K as
//       stored is already the K-major B operand.
//       O += P V: wgmma with A from registers.  The C fragments of two
//       adjacent 8-key column groups of S are the A fragment of one 16-key
//       step (the layout identity the mma.sync kernel uses), so P is
//       rounded to bf16 in place and never touches shared memory.  V is the
//       B operand in MN-major form (imm-trans-b = 1): 8-key groups 1 KB
//       apart (SBO), 64-wide hv boxes 16 KB apart (LBO) -- K2 reads its HWIO
//       weights the same way.
//       Overlap: each consumer issues S of kv tile j and P V of tile j-1
//       together and runs the softmax of tile j while P V is on the tensor
//       cores; the two consumer warpgroups take turns to issue (named
//       barriers, ping-pong), so one's softmax also runs under the other's
//       products.
//       Softmax on the accumulator fragments: row max and sum over the
//       four lanes of a quad by shuffles, in four partials a row; 2^x by
//       ex2.approx (MUFU); for scale > 0 the max is taken over the raw
//       scores and scale * log2(e) folds into one FFMA before each exp2.
//       The kv loop runs from the diagonal tile down, so only its first tile
//       (the diagonal, a ragged end) is masked by position -- by selects, a
//       branch between elements costs more than the softmax -- and every row
//       sees a key in it.
//       Epilogue: O * (1 / max(l, 1e-30)) rounded to bf16x2 straight from
//       the fragments, rows past S not written.
//
//   flash_bf16_mma_kernel<HD, HV>   the other bf16 shapes (hd or hv = 32,
//     hv != hd): mma.sync.aligned.m16n8k16 from
//     ldmatrix fragments, four warps per 64-query block, each owning 16
//     rows; K and V tiles of 64 keys double-buffered by cp.async in
//     row-padded shared memory; P re-used from the S fragments as above.
//
//   flash_f32_kernel<HD, HV>   float32, hd, hv in {32, 64, 128}.  The
//     reference computes float32 attention in IEEE float32, so this stays on
//     the CUDA cores (67 TFLOP/s; TF32 would break the 1e-5 tolerance).
//     256 threads per 64-query block, tiles of 64 keys.  Q, K and V arrive
//     by 16-byte cp.async, K and V double-buffered (the next tile loads
//     while this one is multiplied out), all row-major as they lie.  Thread
//     (tx, ty) owns rows ty + 16 i and keys tx + 16 j (i, j < 4) of the
//     score tile, so the K reads of a quarter warp hit distinct banks; the
//     scores stay in registers, the row max and sum come from shuffles
//     across the 16 lanes of a row group, and only P goes through shared
//     memory, once, for the P V product.  Two barriers a tile.
//
//   Training: flash_bf16_tc_kernel<D, true> and flash_f32_kernel<D, D, true>
//   (entry points *_lse) also write the row log-sum-exp of the scaled
//   scores, lse[b, h, i] = ln(sum_j exp(scale * q_i . k_j)), float32
//   [B, H, S], from the final running max and sum -- what the backward
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
  int S, H, KV;
  int64_t qs_b, qs_s, qs_h;  // element strides of q, k, v, o
  int64_t ks_b, ks_s, ks_h;
  int64_t vs_b, vs_s, vs_h;
  int64_t os_b, os_s, os_h;
  float scale;
  int causal;
  int bh;      // tensor-core kernel: B * H
  float* lse;  // [B, H, S] float32: the *_lse entry points only
};

// The (b * H + h, q-block) of tile `lin` of bh * nq: tiles run q-block by
// q-block over every head -- from the heaviest (last) q-block down under
// causal, so the long kv loops start early and the short ones fill the
// tail.
struct Tile {
  int bh, qb;
};
__device__ __forceinline__ Tile tile_of(const Params& p, int64_t lin, int bh,
                                        int nq) {
  const int qb = (int)(lin / bh);
  return {(int)(lin % bh), p.causal ? nq - 1 - qb : qb};
}
// the tile of a block of the (B * H, q-blocks) grid, in launch order
__device__ __forceinline__ Tile block_tile(const Params& p) {
  return tile_of(p, (int64_t)blockIdx.y * gridDim.x + blockIdx.x, gridDim.x,
                 gridDim.y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&t);
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

constexpr int kTcBM = 128;        // query rows per block
constexpr int kTcBN = 128;        // keys per kv tile
// kTcBN == kTcBM keeps every q-block's first kv tile (the diagonal one) on
// a tile boundary: only that tile is ever masked, and every row sees a key
// in it
static_assert(kTcBN == kTcBM, "the first tile is the only masked one");
constexpr int kTcThreads = 384;   // loader warpgroup + 2 consumer warpgroups
constexpr int kTcConsumerWarps = 8;
constexpr int kTcBoxBytes = 128 * 128;  // one box: 128 rows of 128 bytes

// slots of the K / V ring: 3 at D = 64 (32 KB a K, V pair), 2 at D = 128
// (64 KB a pair)
template <int D>
__host__ __device__ constexpr int tc_stages() {
  return D == 64 ? 3 : 2;
}

// shared memory: Q, the K and V slots, barriers, 1 KiB to align the base to
// the swizzle's 1024-byte period
template <int D>
constexpr int tc_smem_bytes() {
  return 1024 + (D / 64) * kTcBoxBytes * (1 + 2 * tc_stages<D>()) +
         (2 + 4 * tc_stages<D>()) * 8;
}
static_assert(tc_smem_bytes<64>() <= 232448 && tc_smem_bytes<128>() <= 232448,
              "a block's shared memory is 227 KB");

template <int D, bool kLse>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bf16_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  static_assert(D == 64 || D == 128, "head dims of the wgmma kernel");
  constexpr int kTile = (D / 64) * kTcBoxBytes;  // one Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int stages = tc_stages<D>();
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + kTile;
  uint8_t* sV = sK + stages * kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + stages * kTile);
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
                   p.bh, nq);
  };
  auto kv_tiles = [&](const Tile& tl) {
    const int q0 = tl.qb * kTcBM;
    const int kv_end = p.causal ? min(q0 + kTcBM, p.S) : p.S;
    return (kv_end + kTcBN - 1) / kTcBN;
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
        mbar_arrive_expect_tx(q_full, kTile);
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc)
          tma_load_4d(sQ + cc * kTcBoxBytes, &tm_q, q_full, 64 * cc, h,
                      tl.qb * kTcBM, b);
        for (int it = 0; it < n_kv; ++it, ++ring) {
          const int st = ring % stages;
          const uint32_t free_parity = ((ring / stages) & 1) ^ 1;
          const int k0 = (n_kv - 1 - it) * kTcBN;  // from the diagonal down
          mbar_wait(&k_empty[st], free_parity);
          mbar_arrive_expect_tx(&k_full[st], kTile);
#pragma unroll
          for (int cc = 0; cc < D / 64; ++cc)
            tma_load_4d(sK + st * kTile + cc * kTcBoxBytes, &tm_k,
                        &k_full[st], 64 * cc, kvh, k0, b);
          mbar_wait(&v_empty[st], free_parity);
          mbar_arrive_expect_tx(&v_full[st], kTile);
#pragma unroll
          for (int cc = 0; cc < D / 64; ++cc)
            tma_load_4d(sV + st * kTile + cc * kTcBoxBytes, &tm_v,
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

  float o[D / 2];
  float m[2], l[2];                 // running max (log2 domain), this
                                    // thread's share of the running sum
  float s[kTcBN / 2];               // S, then P, of the tile in hand
  uint32_t pa[kTcBN / 16][4];       // P in bf16 as the A fragments of P V
  float corr[2];
  // S = Q K^T of slot st: 64 rows x 128 keys, D / 16 steps of 16 (two boxes
  // at D = 128); K-major rows of 128 bytes, 8-row groups 1 KB apart, the
  // step's 16 columns at +32 bytes inside the swizzled row.  Committed, not
  // waited for.
  auto issue_s = [&](int st) {
    const uint32_t k_addr = smem_u32(sK + st * kTile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTcBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n128k16(s, smem_desc(q_addr + off, 16, 1024),
                          smem_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of slot st: V MN-major, step j = keys [16 j, 16 j + 16) at
  // +2 KB.  Committed, not waited for.
  auto issue_pv = [&](int st) {
    const uint32_t v_addr = smem_u32(sV + st * kTile);
#pragma unroll
    for (int j = 0; j < kTcBN / 16; ++j)
      wgmma_pv<D>(o, pa[j], smem_desc(v_addr + j * 2048, kTcBoxBytes, 1024));
    wgmma_commit();
  };
  // The online softmax of s (keys [k0, k0 + 128)): mask by position where
  // `masked` (the diagonal tile, a ragged end: only the first tile of the
  // loop), by selects, so that no branch sits between elements; new row max,
  // corr, p in s, l updated.  Maxima and sums in four partials a row, so
  // that the dependency chains stay short.  For scale > 0 (every model) the
  // row max is taken over the raw scores and the scale folds into one FFMA
  // before each exp2 (masked scores -inf); other scales multiply first.
  const int seq = p.S;
  const bool causal = p.causal;
  auto softmax = [&](int k0, bool masked, auto positive) {
    constexpr bool kFold = decltype(positive)::value;
    if constexpr (!kFold) {
#pragma unroll
      for (int i = 0; i < kTcBN / 2; ++i) s[i] *= sl2;
    }
    if (masked) {
      const float drop = kFold ? -INFINITY : kNegInf;
#pragma unroll
      for (int n = 0; n < kTcBN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int key = k0 + n * 8 + t4 * 2 + (e & 1);
          const bool out = key >= seq || (causal && key > row);
          s[4 * n + e] = out ? drop : s[4 * n + e];
        }
    }
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int a = 0; a < 4; ++a) mx[i][a] = kFold ? -INFINITY : kNegInf;
#pragma unroll
    for (int n = 0; n < kTcBN / 8; ++n)
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
    for (int n = 0; n < kTcBN / 8; ++n)
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
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < kTcBN / 16; ++j) {
      pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
  };
  auto fence_pa = [&]() {
#pragma unroll
    for (int j = 0; j < kTcBN / 16; ++j) fence_frag(pa[j]);
  };

  // The two consumer warpgroups take turns to issue their products (named
  // barriers 1 and 2, 256 threads: one warpgroup syncs, the other arrives),
  // so one warpgroup's softmax runs while the other's products do.  Each
  // issues n_kv + 1 times a tile; warpgroup 1 opens warpgroup 0's first
  // turn and gives no turn after its very last.
  const int my_turn = 1 + cw, their_turn = 2 - cw;
  if (cw == 1) bar_arrive(1, 256);

  int ring = 0;  // the K / V slot sequence, as the loader's
  for (int j = 0; j < n_mine; ++j) {
    const Tile tl = tile_at(j);
    const int b = tl.bh / p.H, h = tl.bh % p.H;
    const int n_kv = kv_tiles(tl);
    row_lo = tl.qb * kTcBM + cw * 64;
    row0 = row_lo + frag_row;
    const bool last_tile = j + 1 == n_mine;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.0f;

    // kv tile 0 (the diagonal one under causal): S, softmax, P
    mbar_wait(q_full, j & 1);
    {
      const int st = ring % stages;
      mbar_wait(&k_full[st], (ring / stages) & 1);
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_s(st);
      bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_acc(s);
      if (lane == 0) {
        mbar_arrive(&k_empty[st]);
        if (n_kv == 1) mbar_arrive(q_empty);  // Q is done
      }
      const int k0 = (n_kv - 1) * kTcBN;
      softmax_tile(k0,
                   k0 + kTcBN > seq || (causal && k0 + kTcBN - 1 > row_lo));
      rescale_and_pack();
    }

    // kv tile it: S = Q K_it^T and O += P_{it-1} V_{it-1} in flight
    // together, the softmax of tile it runs while the tensor cores do P V
    for (int it = 1; it < n_kv; ++it) {
      const int r = ring + it;
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
        if (it == n_kv - 1) mbar_arrive(q_empty);  // Q is done
      }
      softmax_tile((n_kv - 1 - it) * kTcBN, false);  // below the diagonal
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
      for (int n = 0; n < D / 8; ++n)
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

  // one kv tile into buffer `buf` (keys past S zero-filled)
  auto load_kv = [&](int kb, int buf) {
    const int k0 = kb * kBK;
    bf16* kd = Ks + buf * kBK * LDK;
    bf16* vd = Vs + buf * kBK * LDV;
    for (int i = tid; i < kBK * (HD / 8); i += kThreads) {
      const int r = i / (HD / 8), c = i % (HD / 8);
      const bool ok = k0 + r < p.S;
      cp_async16(smem_u32(kd + r * LDK + c * 8),
                 ok ? kp + (k0 + r) * p.ks_s + c * 8 : kp, ok);
    }
    for (int i = tid; i < kBK * (HV / 8); i += kThreads) {
      const int r = i / (HV / 8), c = i % (HV / 8);
      const bool ok = k0 + r < p.S;
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

// --- float32, CUDA cores: flash_f32_kernel -----------------------------------

constexpr int kFQ = 64;         // query rows per block
constexpr int kFK = 64;         // keys per kv tile
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 rows x 4 keys each
constexpr int kFPad = 4;        // float row padding (keeps float4 alignment)

template <int HD, int HV>
constexpr int f32_smem_bytes() {
  return (kFQ * (HD + kFPad) + 2 * kFK * (HD + kFPad) +
          2 * kFK * (HV + kFPad) + kFK * (kFQ + kFPad)) * 4;
}

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
  float* Qs = fsm;                // [kFQ][LQ]
  float* Ks = Qs + kFQ * LQ;      // [2][kFK][LK]
  float* Vs = Ks + 2 * kFK * LK;  // [2][kFK][LV]
  float* Pt = Vs + 2 * kFK * LV;  // [kFK][LP]: p of row ty + 16 i at 4 ty + i

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const Tile tile = block_tile(p);
  const int q0 = tile.qb * kFQ;
  const int b = tile.bh / p.H, h = tile.bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const float* qp = static_cast<const float*>(p.q) + b * p.qs_b + h * p.qs_h;
  const float* kp = static_cast<const float*>(p.k) + b * p.ks_b + kvh * p.ks_h;
  const float* vp = static_cast<const float*>(p.v) + b * p.vs_b + kvh * p.vs_h;
  float* op = static_cast<float*>(p.o) + b * p.os_b + h * p.os_h;

  const int kv_end = p.causal ? min(q0 + kFQ, p.S) : p.S;
  const int n_kv = (kv_end + kFK - 1) / kFK;
  load_rows_f32<HD>(Qs, LQ, qp, p.qs_s, q0, p.S);
  load_rows_f32<HD>(Ks, LK, kp, p.ks_s, 0, p.S);
  load_rows_f32<HV>(Vs, LV, vp, p.vs_s, 0, p.S);
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
                        p.S);
      load_rows_f32<HV>(Vs + (buf ^ 1) * kFK * LV, LV, vp, p.vs_s, k0 + kFK,
                        p.S);
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

    // scale, mask (tiles across the diagonal or past S only, by selects, so
    // that no branch sits between elements), online softmax with the row
    // statistics over the 16 lanes that share the rows
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] *= p.scale;
    if ((k0 + kFK > p.S) || (p.causal && k0 + kFK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + ty + 16 * i, key = k0 + tx + 16 * j;
          const bool out = key >= p.S || (p.causal && key > row);
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
  p.bh = 0;         // set by the entry point that needs it
  p.lse = nullptr;  // set by the *_lse entry points
  return p;
}

// the checks every variant shares: the plan's tile and grid fit the shape
bool plan_fits(int B, int S, int H, int KV, int block_q, int block_k,
               int want_q, int want_k, int gx, int gy) {
  return B >= 1 && S >= 1 && KV >= 1 && H % KV == 0 && block_q == want_q &&
         block_k == want_k && (int64_t)gx == (int64_t)B * H &&
         gy == (S + block_q - 1) / block_q;
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

template <int D, bool kLse>
int launch_tc(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
              const CUtensorMap& tm_v, const Params& p, int gx, int gy,
              int device, void* stream) {
  static unsigned done = 0;
  auto kernel = flash_bf16_tc_kernel<D, kLse>;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = allow_smem(kernel, tc_smem_bytes<D>(), device, &done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), kTcThreads, tc_smem_bytes<D>(),
           (cudaStream_t)stream>>>(tm_q, tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

// the tensor-core entry points: checks, tensor maps, launch (lse nullptr:
// prefill's instance)
int tc_entry(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int H, int KV, int hd, int hv,
             const long long* strides, float scale, int causal, int block_q,
             int block_k, int gx, int gy, int device, void* stream) {
  const int64_t n_tiles = (int64_t)B * H * ((S + kTcBM - 1) / kTcBM);
  if (hd != hv || (hd != 64 && hd != 128) || B < 1 || S < 1 || KV < 1 ||
      H % KV || block_q != kTcBM || block_k != kTcBN || gx < 1 ||
      gx > n_tiles || gy != 1 || !rows_aligned16(q, k, v, o, strides, 2))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q = {}, tm_k = {}, tm_v = {};
  if (!encode_bshd(&tm_q, q, B, S, H, hd, strides, kTcBM) ||
      !encode_bshd(&tm_k, k, B, S, KV, hd, strides + 3, kTcBN) ||
      !encode_bshd(&tm_v, v, B, S, KV, hv, strides + 6, kTcBN))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, o, S, H, KV, strides, scale, causal);
  p.bh = B * H;
  p.lse = lse;
  if (lse != nullptr)
    return hd == 64
               ? launch_tc<64, true>(tm_q, tm_k, tm_v, p, gx, gy, device,
                                     stream)
               : launch_tc<128, true>(tm_q, tm_k, tm_v, p, gx, gy, device,
                                      stream);
  return hd == 64
             ? launch_tc<64, false>(tm_q, tm_k, tm_v, p, gx, gy, device,
                                    stream)
             : launch_tc<128, false>(tm_q, tm_k, tm_v, p, gx, gy, device,
                                     stream);
}

}  // namespace

extern "C" {

// Every entry point: q, k, v, o device pointers; B, S, H, KV, hd, hv;
// strides: 12 element strides, (batch, seq, head) of q, k, v, o in order;
// the softmax scale; causal; the plan: block_q x block_k tile, grid (gx,
// gy); the device and the stream.

// bf16 on wgmma.  Plan: 128 x 128, a persistent grid (gx, 1) of gx <= B*H *
// ceil(S / 128) blocks that walk the tiles; hd == hv in {64, 128}, every
// row 16-byte aligned.
int flash_attention_bf16_tc(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int H, int KV, int hd,
                            int hv, const long long* strides, float scale,
                            int causal, int block_q, int block_k, int gx,
                            int gy, int device, void* stream) {
  return tc_entry(q, k, v, o, nullptr, B, S, H, KV, hd, hv, strides, scale,
                  causal, block_q, block_k, gx, gy, device, stream);
}

// the same, also writing the row log-sum-exp lse [B, H, S] (float32)
int flash_attention_bf16_tc_lse(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int S, int H,
                                int KV, int hd, int hv,
                                const long long* strides, float scale,
                                int causal, int block_q, int block_k, int gx,
                                int gy, int device, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return tc_entry(q, k, v, o, static_cast<float*>(lse), B, S, H, KV, hd, hv,
                  strides, scale, causal, block_q, block_k, gx, gy, device,
                  stream);
}

// bf16 on mma.sync, hd, hv in {32, 64, 128}.  Plan: 64 x 64, grid (B*H,
// ceil(S / 64)); every row 16-byte aligned.
int flash_attention_bf16_mma(const void* q, const void* k, const void* v,
                             void* o, int B, int S, int H, int KV, int hd,
                             int hv, const long long* strides, float scale,
                             int causal, int block_q, int block_k, int gx,
                             int gy, int device, void* stream) {
  if (!plan_fits(B, S, H, KV, block_q, block_k, kBQ, kBK, gx, gy) ||
      !rows_aligned16(q, k, v, o, strides, 2))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, S, H, KV, strides, scale, causal);
  FLASH_DISPATCH(launch_mma)
}

// float32 on the CUDA cores, hd, hv in {32, 64, 128}.  Plan: 64 x 64, grid
// (B*H, ceil(S / 64)); every row 16-byte aligned.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KV, int hd, int hv,
                        const long long* strides, float scale, int causal,
                        int block_q, int block_k, int gx, int gy, int device,
                        void* stream) {
  if (!plan_fits(B, S, H, KV, block_q, block_k, kFQ, kFK, gx, gy) ||
      !rows_aligned16(q, k, v, o, strides, 4))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, S, H, KV, strides, scale, causal);
  FLASH_DISPATCH(launch_f32)
}

// the same, also writing the row log-sum-exp lse [B, H, S] (float32); hd ==
// hv in {64, 128}
int flash_attention_f32_lse(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int S, int H, int KV,
                            int hd, int hv, const long long* strides,
                            float scale, int causal, int block_q, int block_k,
                            int gx, int gy, int device, void* stream) {
  if (lse == nullptr || hd != hv || (hd != 64 && hd != 128) ||
      !plan_fits(B, S, H, KV, block_q, block_k, kFQ, kFK, gx, gy) ||
      !rows_aligned16(q, k, v, o, strides, 4))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, o, S, H, KV, strides, scale, causal);
  p.lse = static_cast<float*>(lse);
  return hd == 64 ? launch_f32<64, 64, true>(p, gx, gy, device, stream)
                  : launch_f32<128, 128, true>(p, gx, gy, device, stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
