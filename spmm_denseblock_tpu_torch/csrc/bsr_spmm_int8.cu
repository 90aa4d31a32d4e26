// Hand-written Hopper (sm_90a) kernels for the int8 BSR SpMM plan,
// C[nbr*b, F] (f32) = cs[f] * sum over slots of scale * (qA @ qB), with
// qA the packed b x b int8 blocks and qB the int8 operand (nbc*b x F),
// quantized per column with scales cs.
//
// K6 bsr_spmm_int8_flat replaces
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas_int8.py:_pallas_int8_spmm
//   (+ _kernel),
// K7 bsr_spmm_int8_sorted replaces
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas_int8.py:_pallas_int8_spmm_sorted
//   (+ _sorted_int8_kernel),
// K8 bsr_spmm_int8_rowgroup replaces
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas_int8.py:_pallas_int8_spmm_rowgroup
//   (+ _rowgroup_int8_kernel),
// K9 bsr_spmm_int8_resident replaces
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas_int8.py:_pallas_int8_spmm_resident
//   (+ _resident_int8_kernel).
// They read the JAX packers' arrays unchanged (plus the port's step and
// group pointers and K7's lane-valid mask), each with the scales of its
// own layout; at b = 64 and 128 they read the operand transposed
// (below). quantize_int8_kernel makes their operand from the f32 one:
// the work of the JAX plan's _quantize_cols / _quantize_cols_static
// (XLA code, not Pallas) and of the zero rows up to the block grid, in
// the layout the kernel reads.
//
// K9. On the TPU the resident kernel keeps the whole (nbc, b, f_tile)
// int8 operand slice in VMEM and indexes it per slot, on K6's flat
// layout. Hopper keeps nothing resident (as for K5 in csrc/bsr_spmm.cu):
// K9's entry launches K6's kernels on K6's packed arrays and the
// (nbc*b, F) view of the operand (transposed, (F, nbc*b), on the ring);
// it exists so that K9's launches are counted (and bound) apart from
// K6's.
//
// Numerics. The TPU multiplies int8 x int8 into int32 on the MXU. Here a
// slot's product is an exact int32 sum too: on the int8 tensor cores
// (wgmma ... .s32.s8.s8) for K6-K9 at b = 64 and 128, with __dp4a (four
// int8 pairs into an int32 an instruction) at b = 16 and 32. f32 FMA of
// widened ints would be exact for one slot (127^2 * 128 < 2^24) but not
// for K7's group-scale lane sum, which reaches 127^2 * 128 * gh
// (16,516,096 at gh = 8, 1.6% under 2^24, and past it for a larger
// explicit group), so the lane sum stays in int32.
// Per-slot scales (K6, K8, K7 without group scale): acc += s_slot *
// float(dot). Group scale (K7): acc += s_lane * float(sum of the
// lane-step's gh dots). The f32 sum is multiplied by the column scale
// cs[f] before the store. Both loops add the same f32 terms in the same
// order.
//
// The dp4a loop (K6-K9 at b = 16 and 32). One CTA owns one (b x 64)
// output tile for its life, stages each slot's block (transposed) and
// operand tile through shared memory in depth chunks of
// up to 32 int8 packed 4 to a 32-bit word, keeps int32 slot (or
// lane-step) sums and f32 tile sums in registers (b/16 x 4 each per
// thread), and stores once. No atomics, so results are deterministic.
// The F edge is masked in the kernel; offsets are 64-bit. Block words are
// aligned 32-bit loads (the wrapper checks that the blocks start 16-byte
// aligned). It is bound by issue, not by bytes: each operand word is four
// byte loads F apart, each chunk is staged between two barriers with
// nothing in flight, and dp4a does 4 multiply-adds an instruction. At the
// op shape (b=128, F=512) K6-K9 ran 37-48x their bytes bound on this loop
// on an H100.
//
// The int8 tensor-core ring (K6-K9 at b = 64 and 128), the design of
// csrc/bsr_spmm.cu's bf16 ring on int8: one CTA per (lane, F tile of BN =
// 64 or 128 columns, the wrapper's choice) owns its f32 output tile (no
// atomics, deterministic); b/64 consumer warpgroups, each issuing
// wgmma m64nBNk32.s32.s8.s8 on 64 output rows; one producer thread walks
// the lane's slots in the dp4a loop's order and streams each slot through
// a ring of stages in dynamic shared memory with TMA and mbarriers. s8
// wgmma takes both operands K-major only (the transpose flags exist for
// 16-bit types alone), so the ring reads the operand transposed: the
// wrapper hands it qdense^T, (F, N) contiguous int8, and a slot at block
// column `col` reads the box of BN rows at inner coordinate col*b. One
// stage is one slot: the (b x b) block and BN rows of b bytes of qdense^T,
// 32 KiB at b = 128, BN = 128; rows of 128 bytes take the 128-byte
// swizzle, rows of 64 (b = 64) the 64-byte one. Rows of qdense^T past F
// read as zeros (TMA's out-of-bounds fill) and the store masks columns >=
// F. Each slot's product runs from zero on the tensor cores (per-slot
// scales) or each lane-step's gh slots chain in s32 (group scale); CUDA
// cores then add the scaled sum into the f32 tile sums. The products are
// cheap here (2*S*b*b*F is about 0.2 ms at the card's int8 rate at the op
// shape); what bounds the ring is moving the blocks and operand slices,
// as for the bf16 ring (on an H100 at the op shape, K7 with its products
// cut runs within 2% of its time). Absent (K7) and phantom (K8) lanes
// return before any barrier is initialised. K6's walk (one block-row's
// steps through a step pointer) is K8's with one lane a group, so K6 and
// K9 launch the K8 instance with R = 1 and gh = group, in the dp4a loop's
// slot order (as bf16 K1 runs bf16 K4's ring in csrc/bsr_spmm.cu). wgmma's
// M of 64 does not fit b = 16 or 32, so every entry takes those to the
// dp4a loop, by a switch on b.
//
// The operand's quantization (quantize_int8_kernel). The ring reads the
// operand K-major, (F, N) int8; the dp4a loop reads it (N, F). One kernel
// reads the f32 operand (any row stride and alignment), quantizes it per
// column and writes the layout asked for, with zero rows from n_rows up
// to N (the block grid's pad). A CTA quantizes a tile of 128 rows x 64
// columns in registers (one column, so one scale, a thread; four rows
// packed into a 32-bit word), stages it in shared memory by column and
// writes each column's 128 bytes as eight 16-byte stores; row-major
// output is stored from registers. Numerics are quantize_per_column's
// (and JAX's): q = rint(x / s) with a true IEEE divide (no reciprocal,
// no fast-math), clamped to +-127, and 0 where the quotient is NaN.
// Dynamic scales need each column's
// absmax before any value quantizes: col_absmax_kernel reduces it first,
// one atomicMax a column and CTA on the bit pattern of |x| (non-negative
// floats order as their bits, and max does not depend on order, so the
// result is deterministic); the quantize pass turns it into s = absmax *
// f32(1/127), or 1 for a zero column and for a column with a NaN (a
// NaN's bits order above Inf's, and NaN > 0 fails, as in JAX), and
// writes the scales.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBN = 64;        // output columns per CTA

template <int BM>
struct Geom {
  static constexpr int TM = BM / 16;                  // tile rows per thread
  static constexpr int KW = (BM < 32 ? BM : 32) / 4;  // words per stage
};

template <int BM>
struct __align__(16) SmemI8 {
  int32_t a[Geom<BM>::KW][BM + 4];  // a[w][m] = blk[m][k0+4w .. k0+4w+3]
  int32_t b[Geom<BM>::KW][kBN];     // b[w][n] = dense[k0+4w .. k0+4w+3][n]
};

// iacc[b x 64 tile] += blk (b x b) @ brow (b x 64, row stride F), exact in
// int32. Thread (tx, ty) owns rows ty*TM .. ty*TM+TM-1, cols tx*4 .. +3.
template <int BM>
__device__ __forceinline__ void slot_dp4a(const int8_t* __restrict__ blk,
                                          const int8_t* __restrict__ brow,
                                          int64_t F, int n_valid,
                                          SmemI8<BM>& sm,
                                          int32_t (&iacc)[BM / 16][4]) {
  constexpr int TM = Geom<BM>::TM, KW = Geom<BM>::KW;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll 1
  for (int k0 = 0; k0 < BM; k0 += 4 * KW) {
    for (int e = tid; e < BM * KW; e += kThreads) {
      const int m = e / KW, w = e % KW;
      sm.a[w][m] = *reinterpret_cast<const int32_t*>(
          blk + (int64_t)m * BM + k0 + 4 * w);
    }
    for (int e = tid; e < KW * kBN; e += kThreads) {
      const int w = e / kBN, n = e % kBN;
      uint32_t word = 0;
      if (n < n_valid) {
        const int8_t* p = brow + (int64_t)(k0 + 4 * w) * F + n;
        word = (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[F] << 8) |
               ((uint32_t)(uint8_t)p[2 * F] << 16) |
               ((uint32_t)(uint8_t)p[3 * F] << 24);
      }
      sm.b[w][n] = (int32_t)word;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const int4 bv = *reinterpret_cast<const int4*>(&sm.b[w][tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int a = sm.a[w][ty * TM + i];
        iacc[i][0] = __dp4a(a, bv.x, iacc[i][0]);
        iacc[i][1] = __dp4a(a, bv.y, iacc[i][1]);
        iacc[i][2] = __dp4a(a, bv.z, iacc[i][2]);
        iacc[i][3] = __dp4a(a, bv.w, iacc[i][3]);
      }
    }
    __syncthreads();
  }
}

// acc += s * float(iacc); iacc = 0.
template <int BM>
__device__ __forceinline__ void add_scaled(float (&acc)[BM / 16][4],
                                           int32_t (&iacc)[BM / 16][4],
                                           float s) {
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] += s * (float)iacc[i][j];
      iacc[i][j] = 0;
    }
}

// One lane's walk: steps j0 .. j1-1, lane `lane` of R, gh slots per
// lane and step at (j*R + lane)*gh. Per-slot scales are scales[slot];
// group scales are scales[j*R + lane], one per lane-step.
template <int BM, bool kGroupScale>
__device__ __forceinline__ void lane_walk(
    int64_t j0, int64_t j1, int64_t R, int64_t lane, int64_t gh,
    const int32_t* __restrict__ slot_cols, const int8_t* __restrict__ qblocks,
    const float* __restrict__ scales, const int8_t* __restrict__ qdense,
    int64_t F, int64_t f0, int n_valid, SmemI8<BM>& sm,
    float (&acc)[BM / 16][4]) {
  int32_t iacc[BM / 16][4] = {};
  for (int64_t j = j0; j < j1; ++j) {
    for (int64_t s = (j * R + lane) * gh, s_end = s + gh; s < s_end; ++s) {
      const int64_t col = slot_cols[s];
      slot_dp4a<BM>(qblocks + s * BM * BM, qdense + col * BM * F + f0, F,
                    n_valid, sm, iacc);
      if constexpr (!kGroupScale) add_scaled<BM>(acc, iacc, scales[s]);
    }
    if constexpr (kGroupScale) add_scaled<BM>(acc, iacc, scales[j * R + lane]);
  }
}

// out tile = acc * cs[column]; out and cs point at the tile's column f0.
template <int BM>
__device__ __forceinline__ void store_scaled(float* __restrict__ out,
                                             const float* __restrict__ cs,
                                             int64_t F, int n_valid,
                                             float (&acc)[BM / 16][4]) {
  constexpr int TM = BM / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = tx * 4 + j;
    if (n >= n_valid) continue;
    const float c = cs[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) out[(int64_t)(ty * TM + i) * F + n] = acc[i][j] * c;
  }
}

// K6 at b = 16 and 32: one CTA per (block-row, F tile); the flat layout
// is one lane of `group` slots per step, and step_ptr (nbr+1,) gives each
// row's steps. Every row has >= 1 step (the plan covers empty rows with a
// zero block).
template <int BM>
__global__ void __launch_bounds__(kThreads)
    int8_flat_kernel(const int64_t* __restrict__ step_ptr,
                     const int32_t* __restrict__ slot_cols,
                     const int8_t* __restrict__ qblocks,
                     const float* __restrict__ scales,
                     const int8_t* __restrict__ qdense,
                     const float* __restrict__ cs, float* __restrict__ out,
                     int64_t F, int64_t group, int64_t n_ftiles) {
  __shared__ SmemI8<BM> sm;
  const int64_t row = blockIdx.x / n_ftiles;
  const int64_t f0 = (blockIdx.x % n_ftiles) * kBN;
  const int n_valid = (int)(F - f0 < kBN ? F - f0 : kBN);
  float acc[BM / 16][4] = {};
  lane_walk<BM, false>(step_ptr[row], step_ptr[row + 1], 1, 0, group,
                       slot_cols, qblocks, scales, qdense, F, f0, n_valid, sm,
                       acc);
  store_scaled<BM>(out + row * BM * F + f0, cs + f0, F, n_valid, acc);
}

// K7: one CTA per (group, lane, F tile) of the depth-sorted layout, as
// K2: the lane's sum belongs to block-row win_ids[j0]*window +
// pos[j0*R + lane]; absent lanes (lane_valid == 0, window padding at
// pos 0) store nothing.
template <int BM, bool kGroupScale>
__global__ void __launch_bounds__(kThreads)
    int8_sorted_kernel(const int64_t* __restrict__ group_ptr,
                       const int32_t* __restrict__ win_ids,
                       const int32_t* __restrict__ pos,
                       const uint8_t* __restrict__ lane_valid,
                       const int32_t* __restrict__ slot_cols,
                       const int8_t* __restrict__ qblocks,
                       const float* __restrict__ scales,
                       const int8_t* __restrict__ qdense,
                       const float* __restrict__ cs, float* __restrict__ out,
                       int64_t F, int64_t R, int64_t gh, int64_t window,
                       int64_t n_ftiles) {
  __shared__ SmemI8<BM> sm;
  const int64_t lane_id = blockIdx.x / n_ftiles;  // group * R + lane
  if (!lane_valid[lane_id]) return;               // uniform over the CTA
  const int64_t g = lane_id / R, lane = lane_id % R;
  const int64_t f0 = (blockIdx.x % n_ftiles) * kBN;
  const int n_valid = (int)(F - f0 < kBN ? F - f0 : kBN);
  const int64_t j0 = group_ptr[g], j1 = group_ptr[g + 1];
  const int64_t orow = (int64_t)win_ids[j0] * window + pos[j0 * R + lane];
  float acc[BM / 16][4] = {};
  lane_walk<BM, kGroupScale>(j0, j1, R, lane, gh, slot_cols, qblocks, scales,
                             qdense, F, f0, n_valid, sm, acc);
  store_scaled<BM>(out + orow * BM * F + f0, cs + f0, F, n_valid, acc);
}

// K8: one CTA per (lane, F tile) of the consecutive row-group layout, as
// K4: lane r of group g is block-row g*R + r; phantom lanes (row >=
// n_block_rows, padding of the last group) store nothing.
template <int BM>
__global__ void __launch_bounds__(kThreads)
    int8_rowgroup_kernel(const int64_t* __restrict__ group_ptr,
                         const int32_t* __restrict__ slot_cols,
                         const int8_t* __restrict__ qblocks,
                         const float* __restrict__ scales,
                         const int8_t* __restrict__ qdense,
                         const float* __restrict__ cs,
                         float* __restrict__ out, int64_t n_block_rows,
                         int64_t F, int64_t R, int64_t gh, int64_t n_ftiles) {
  __shared__ SmemI8<BM> sm;
  const int64_t row = blockIdx.x / n_ftiles;  // group * R + lane
  if (row >= n_block_rows) return;            // phantom lane
  const int64_t g = row / R, lane = row % R;
  const int64_t f0 = (blockIdx.x % n_ftiles) * kBN;
  const int n_valid = (int)(F - f0 < kBN ? F - f0 : kBN);
  float acc[BM / 16][4] = {};
  lane_walk<BM, false>(group_ptr[g], group_ptr[g + 1], R, lane, gh, slot_cols,
                       qblocks, scales, qdense, F, f0, n_valid, sm, acc);
  store_scaled<BM>(out + row * BM * F + f0, cs + f0, F, n_valid, acc);
}

// ---- the int8 tensor-core ring: K6-K9 at b = 64 and 128 -----------------

template <int BM, int BN>
struct I8Ring {
  static constexpr int kConsumers = BM / 64;  // warpgroups of 64 rows each
  static constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer
  static constexpr uint32_t kABytes = BM * BM;  // the block: BM rows of BM bytes
  static constexpr uint32_t kXBytes = BN * BM;  // BN rows of qdense^T
  static constexpr uint32_t kStageBytes = kABytes + kXBytes;
  // 8 rows of BM bytes, one swizzle atom: the descriptors' stride offset
  static constexpr uint32_t kAtom = 8 * BM;
  static constexpr uint32_t kLayout = BM == 128 ? 1 : 2;  // 128- / 64-byte swizzle
  // narrow tiles leave room for two CTAs an SM
  static constexpr int kMinBlocks = BN == 64 ? 2 : 1;
  // as many stages as fit, at most 6 (4 at b = 128, BN = 64): at the op
  // shape 6 read 5% faster than 4 and no slower than 7
  static constexpr int kMaxStages = 6;
  static constexpr int kFit = (kSmemPerBlock / kMinBlocks - 2048) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // + slack to align the ring to the 1024-byte period of the swizzle
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// D (64 x N, s32, registers) = A (64 x 32, K-major) @ B (32 x N, K-major)
// + (scale_d ? D : 0), A and B s8 in shared memory.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  __device__ __forceinline__ static void mma(int32_t (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ __forceinline__ static void mma(int32_t (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The lane's slots in the dp4a loop's order: the gh slots of step j sit
// at (j*R + lane)*gh. `slot` is the current one, `lane_step` its step's
// j*R + lane (the group scale's index) and `k` its place in the step.
struct SlotWalk {
  int64_t slot, lane_step, k = 0;
  const int64_t R, gh;
  __device__ SlotWalk(int64_t j0, int64_t R_, int64_t lane, int64_t gh_)
      : slot((j0 * R_ + lane) * gh_), lane_step(j0 * R_ + lane), R(R_), gh(gh_) {}
  __device__ void next() {
    if (++k == gh) {
      k = 0;
      lane_step += R;
      slot += (R - 1) * gh + 1;
    } else {
      ++slot;
    }
  }
};

// K7 (win_ids != nullptr) or K8 (win_ids == nullptr; K6 and K9 with R =
// 1) on the int8 tensor cores. One CTA per (lane, F tile of BN columns);
// warpgroups 0 .. kConsumers-1 run the products on 64 rows each, the last
// warpgroup's first thread runs the TMA producer. Stage i's `full` barrier completes
// when its bytes have landed, its `empty` barrier when every consumer warp
// has finished reading it.
template <int BM, int BN, bool kGroupScale>
__global__ void __launch_bounds__(I8Ring<BM, BN>::kThreads,
                                  I8Ring<BM, BN>::kMinBlocks)
    int8_ring_kernel(const __grid_constant__ CUtensorMap tm_blocks,
                     const __grid_constant__ CUtensorMap tm_dense_t,
                     const int64_t* __restrict__ group_ptr,
                     const int32_t* __restrict__ win_ids,
                     const int32_t* __restrict__ pos,
                     const uint8_t* __restrict__ lane_valid,
                     const int32_t* __restrict__ slot_cols,
                     const float* __restrict__ scales,
                     const float* __restrict__ cs, float* __restrict__ out,
                     int64_t F, int64_t n_block_rows, int64_t R, int64_t gh,
                     int64_t window, int64_t n_ftiles) {
  using G = I8Ring<BM, BN>;
  constexpr int kRing = G::kStages;
  __shared__ __align__(8) uint64_t full[kRing];
  __shared__ __align__(8) uint64_t empty[kRing];
  extern __shared__ __align__(1024) uint8_t ring_raw[];

  const int64_t lane_id = blockIdx.x / n_ftiles;  // group * R + lane
  const int64_t g = lane_id / R, lane = lane_id % R;
  const int64_t j0 = group_ptr[g];
  int64_t orow;
  if (win_ids != nullptr) {                   // K7: absent lanes store nothing
    if (!lane_valid[lane_id]) return;         // uniform over the CTA
    orow = (int64_t)win_ids[j0] * window + pos[j0 * R + lane];
  } else {                                    // K8: phantom lanes neither
    if (lane_id >= n_block_rows) return;
    orow = lane_id;
  }
  const int64_t n_slots = (group_ptr[g + 1] - j0) * gh;
  const int64_t f0 = (blockIdx.x % n_ftiles) * BN;
  const uint32_t ring = (smem_u32(ring_raw) + 1023u) & ~1023u;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], G::kConsumers * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  SlotWalk walk(j0, R, lane, gh);
  const int wg = threadIdx.x / 128;
  if (wg == G::kConsumers) {
    // The producer: one stage a slot, the block and the operand rows.
    if (threadIdx.x % 128 != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t = 0; t < n_slots; ++t, walk.next()) {
      const int32_t col = __ldg(slot_cols + walk.slot);
      mbar_wait(&empty[stage], phase ^ 1);
      const uint32_t a = ring + stage * G::kStageBytes;
      mbar_expect_tx(&full[stage], G::kStageBytes);
      tma_load_2d(a, &tm_blocks, &full[stage], 0, (int32_t)(walk.slot * BM));
      tma_load_2d(a + G::kABytes, &tm_dense_t, &full[stage], col * BM,
                  (int32_t)f0);
      if (++stage == kRing) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // A consumer warpgroup: rows wg*64 .. wg*64+63 of the tile. `part` is
    // the exact s32 product of one slot (per-slot scales) or of one
    // lane-step (group scale); `acc` the f32 sums of the scaled parts.
    const int wt = threadIdx.x % 128;
    int32_t part[BN / 2];
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      part[i] = 0;
      acc[i] = 0.f;
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t = 0; t < n_slots; ++t, walk.next()) {
      // a slot's product starts from zero, a lane-step's at its first slot;
      // it is scaled after its last
      const bool first = !kGroupScale || walk.k == 0;
      const bool last = !kGroupScale || walk.k == gh - 1;
      const float s =
          last ? __ldg(scales + (kGroupScale ? walk.lane_step : walk.slot)) : 0.f;
      mbar_wait(&full[stage], phase);
      // A: 64 rows of BM bytes, 8-row swizzle atoms kAtom bytes apart; B:
      // BN rows of BM bytes, the same atoms; a 32-deep slice is 32 bytes
      // into each row.
      const uint32_t a = ring + stage * G::kStageBytes + wg * 64 * BM;
      const uint32_t x = ring + stage * G::kStageBytes + G::kABytes;
      fence_operands(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BM / 32; ++k)
        WgmmaS8<BN>::mma(part, smem_desc(a + k * 32, 16, G::kAtom, G::kLayout),
                         smem_desc(x + k * 32, 16, G::kAtom, G::kLayout),
                         !first || k > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part);
      __syncwarp();
      if (wt % 32 == 0) mbar_arrive(&empty[stage]);  // the stage is read
      if (last) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] += s * (float)part[j];
      }
      if (++stage == kRing) {
        stage = 0;
        phase ^= 1;
      }
    }
    // The accumulator fragment of m64nNk32: thread wt holds rows
    // (wt/32)*16 + (wt%32)/4 (+8) and columns 8j + 2*(wt%4) (+1); each
    // column is multiplied by its operand scale.
    const int64_t row0 = orow * BM + wg * 64 + (wt / 32) * 16 + (wt % 32) / 4;
    const int64_t c0 = f0 + 2 * (wt % 4);
    const bool pairs = F % 2 == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int64_t col = c0 + j * 8;
      if (col >= F) continue;
      const bool two = col + 1 < F;
      const float s0 = __ldg(cs + col), s1 = two ? __ldg(cs + col + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = out + (row0 + 8 * h) * F + col;
        const float v0 = acc[4 * j + 2 * h] * s0, v1 = acc[4 * j + 2 * h + 1] * s1;
        if (two) {
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            p[1] = v1;
          }
        } else {
          p[0] = v0;
        }
      }
    }
  }
}

// ---- the operand's quantization -----------------------------------------

constexpr int kAbsRows = 512;  // rows of x per col_absmax_kernel CTA
constexpr int kQRows = 128;    // rows (output depth) per quantize tile
constexpr int kQCols = 64;     // columns per quantize tile
// What XLA makes of the JAX package's absmax / 127.0, and what
// quantize_per_column multiplies by: the f32 reciprocal of 127.
constexpr float kInv127 = (float)(1.0 / 127.0);

// absmax[f] = max(absmax[f], bits of max |x[r, f]|) over this CTA's rows:
// 32 columns (blockIdx.y) x kAbsRows rows (blockIdx.x), a warp a row.
__global__ void __launch_bounds__(256)
    col_absmax_kernel(const float* __restrict__ x, int64_t ldx, int64_t n_rows,
                      int64_t F, unsigned* __restrict__ absmax) {
  __shared__ unsigned part[8][32];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t f = blockIdx.y * 32 + tx;
  const int64_t r0 = blockIdx.x * (int64_t)kAbsRows;
  const int64_t r1 = r0 + kAbsRows < n_rows ? r0 + kAbsRows : n_rows;
  unsigned m = 0;
  if (f < F) {
#pragma unroll 8
    for (int64_t r = r0 + ty; r < r1; r += 8)
      m = max(m, __float_as_uint(fabsf(__ldg(x + r * ldx + f))));
  }
  part[ty][tx] = m;
  __syncthreads();
  if (ty != 0 || f >= F) return;
#pragma unroll
  for (int i = 1; i < 8; ++i) m = max(m, part[i][tx]);
  atomicMax(absmax + f, m);
}

// cvt.rni.s32.f32 (__float2int_rn) rounds half to even, saturates +-Inf
// and makes a NaN 0, so a NaN quotient (a NaN entry, or Inf / Inf in a
// dynamic column whose scale is Inf) is 0 as in JAX, and a static +-Inf
// entry clamps to +-127. (A float clamp first would turn a NaN into -127:
// fmaxf drops it; a NaN test beside it cost the kernel 13-42% on an
// H100: scripts/torch_kernel_variants.py int8.)
__device__ __forceinline__ uint32_t quantize(float v, float s) {
  const int t = min(max(__float2int_rn(v / s), -127), 127);
  return (uint32_t)(uint8_t)(int8_t)t;
}

// q = the quantized operand of n_out rows (rows >= n_rows are zeros),
// (F, n_out) with kTransposed, else (n_out, F). A CTA owns kQRows rows
// (blockIdx.x) and kQCols columns (blockIdx.y); thread t quantizes column
// t % 64, four rows at a time. Scales: static_scale[f] if given, else
// from absmax[f], written to col_scale by the CTAs of row tile 0.
template <bool kTransposed>
__global__ void __launch_bounds__(256)
    quantize_int8_kernel(const float* __restrict__ x, int64_t ldx,
                         int64_t n_rows, int64_t F, int64_t n_out,
                         const float* __restrict__ static_scale,
                         const unsigned* __restrict__ absmax,
                         int8_t* __restrict__ q, float* __restrict__ col_scale) {
  // st[c][w]: rows 4w .. 4w+3 of the tile's column c, one byte each; 33
  // words a column keep both the writes below and the 16-byte reads
  // after the barrier free of bank conflicts
  __shared__ uint32_t st[kQCols][kQRows / 4 + 1];
  const int c = threadIdx.x % kQCols, phase = threadIdx.x / kQCols;
  const int64_t k0 = blockIdx.x * (int64_t)kQRows;
  const int64_t f = blockIdx.y * (int64_t)kQCols + c;
  float s = 1.f;
  if (f < F) {
    if (static_scale != nullptr) {
      s = static_scale[f];
    } else {
      const float m = __uint_as_float(absmax[f]);
      s = m > 0.f ? m * kInv127 : 1.f;
      if (blockIdx.x == 0 && phase == 0) col_scale[f] = s;
    }
  }
  constexpr int kPhases = 256 / kQCols;
#pragma unroll
  for (int i = 0; i < kQRows / 4 / kPhases; ++i) {
    const int w = phase + i * kPhases;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = k0 + 4 * w + j;
      const float v = f < F && r < n_rows ? __ldg(x + r * ldx + f) : 0.f;
      const uint32_t qv = quantize(v, s);
      if constexpr (kTransposed) {
        word |= qv << (8 * j);
      } else if (f < F && r < n_out) {
        q[r * F + f] = (int8_t)qv;
      }
    }
    if constexpr (kTransposed) st[c][w] = word;
  }
  if constexpr (kTransposed) {
    __syncthreads();
    // each column's kQRows bytes as kQRows / 16 stores of 16 bytes
    constexpr int kChunks = kQRows / 16;
    for (int i = threadIdx.x; i < kQCols * kChunks; i += 256) {
      const int cc = i / kChunks, ch = i % kChunks;
      const int64_t fo = blockIdx.y * (int64_t)kQCols + cc, k = k0 + 16 * ch;
      if (fo >= F || k >= n_out) continue;
      const uint32_t* w4 = &st[cc][4 * ch];
      *reinterpret_cast<uint4*>(q + fo * n_out + k) =
          make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Grid of n_lanes * ceil(F / 64) CTAs, or an error for an empty or
// oversized grid (0 = nothing to launch).
cudaError_t grid_for(int64_t n_lanes, int64_t F, int64_t* n_ft, dim3* grid) {
  *n_ft = ceil_div(F, kBN);
  const int64_t n_ctas = n_lanes * *n_ft;
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)n_ctas);
  return cudaSuccess;
}

// Runs the statement with BM bound to the block size b, 16 or 32: the
// block sizes of the dp4a loop.
#define SDB_FOR_SMALL_BLOCK_SIZE(b, ...)                       \
  switch (b) {                                                 \
    case 16: { constexpr int BM = 16; __VA_ARGS__; break; }    \
    case 32: { constexpr int BM = 32; __VA_ARGS__; break; }    \
    default: return cudaErrorInvalidValue;                     \
  }

template <int BM, int BN, bool kGroupScale>
cudaError_t launch_ring_tile(const CUtensorMap& tb, const CUtensorMap& td,
                             const int64_t* gp, const int32_t* wi,
                             const int32_t* ps, const uint8_t* lv,
                             const int32_t* sc, const float* sl, const float* cv,
                             float* o, int64_t F, int64_t n_block_rows,
                             int64_t R, int64_t gh, int64_t window, int64_t n_ft,
                             dim3 grid, cudaStream_t stream) {
  using G = I8Ring<BM, BN>;
  // The shared-memory limit is set once per instantiation, before its
  // first launch, on the device current then (a refusal is returned on
  // every launch).
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      int8_ring_kernel<BM, BN, kGroupScale>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (smem_set != cudaSuccess) return smem_set;
  int8_ring_kernel<BM, BN, kGroupScale>
      <<<grid, G::kThreads, G::kSmemBytes, stream>>>(
          tb, td, gp, wi, ps, lv, sc, sl, cv, o, F, n_block_rows, R, gh, window,
          n_ft);
  return cudaGetLastError();
}

// K7 (win_ids != nullptr) or K8 (K6 and K9 with R = 1) on the int8 ring
// over n_lanes lanes of ceil(F / bn) tiles: qblocks holds n_slots (b x b)
// slots, qdense_t is the (F, n_dense_rows) transposed operand,
// contiguous, 16-byte aligned.
cudaError_t launch_ring(const void* group_ptr, const void* win_ids,
                        const void* pos, const void* lane_valid,
                        const void* slot_cols, const void* qblocks,
                        const void* scales, const void* qdense_t,
                        const void* cs, void* out, int64_t n_lanes,
                        int64_t n_block_rows, int64_t n_slots,
                        int64_t n_dense_rows, int64_t F, int64_t R, int64_t gh,
                        int64_t window, int64_t b, int64_t bn,
                        int64_t group_scale, cudaStream_t stream) {
  if (qdense_t == nullptr || (bn != 64 && bn != 128) ||
      n_slots * b > INT32_MAX || n_dense_rows > INT32_MAX ||
      n_dense_rows % 16 != 0 || F > INT32_MAX)
    return cudaErrorInvalidValue;
  const int64_t n_ft = ceil_div(F, bn);
  const int64_t n_ctas = n_lanes * n_ft;
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (n_ctas == 0) return cudaSuccess;
  const CUtensorMapSwizzle sw =
      b == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tb, td;
  if (cudaError_t e = tma_map_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qblocks,
                                 b, n_slots * b, (uint32_t)b, (uint32_t)b, sw))
    return e;
  if (cudaError_t e = tma_map_2d(&td, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qdense_t,
                                 n_dense_rows, F, (uint32_t)b, (uint32_t)bn, sw))
    return e;
  const dim3 grid((unsigned)n_ctas);
  const auto* gp = static_cast<const int64_t*>(group_ptr);
  const auto* wi = static_cast<const int32_t*>(win_ids);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* lv = static_cast<const uint8_t*>(lane_valid);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* sl = static_cast<const float*>(scales);
  const auto* cv = static_cast<const float*>(cs);
  auto* o = static_cast<float*>(out);
#define SDB_I8_RING(BM, BN, GS)                                               \
  if (b == BM && bn == BN && (group_scale != 0) == GS)                        \
    return launch_ring_tile<BM, BN, GS>(tb, td, gp, wi, ps, lv, sc, sl, cv, o, \
                                        F, n_block_rows, R, gh, window, n_ft, \
                                        grid, stream);
  SDB_I8_RING(64, 64, false)
  SDB_I8_RING(64, 128, false)
  SDB_I8_RING(128, 64, false)
  SDB_I8_RING(128, 128, false)
  SDB_I8_RING(64, 64, true)
  SDB_I8_RING(64, 128, true)
  SDB_I8_RING(128, 64, true)
  SDB_I8_RING(128, 128, true)
#undef SDB_I8_RING
  return cudaErrorInvalidValue;
}

// K6's and K9's launch on the flat layout, one CTA per (block-row, F
// tile): the ring (as K8 with R = 1, gh = group and the step pointer as
// the group pointer) at b = 64 and 128, the dp4a loop at b = 16 and 32.
cudaError_t launch_flat(const void* step_ptr, const void* slot_cols,
                        const void* qblocks, const void* scales,
                        const void* qdense, const void* qdense_t,
                        const void* cs, void* out, int64_t n_block_rows,
                        int64_t n_slots, int64_t n_dense_rows, int64_t F,
                        int64_t group, int64_t b, int64_t bn, cudaStream_t s) {
  if (b == 64 || b == 128)
    return launch_ring(step_ptr, nullptr, nullptr, nullptr, slot_cols, qblocks,
                       scales, qdense_t, cs, out, n_block_rows, n_block_rows,
                       n_slots, n_dense_rows, F, 1, group, 1, b, bn, 0, s);
  if (bn != kBN || qdense == nullptr) return cudaErrorInvalidValue;
  int64_t n_ft;
  dim3 grid;
  cudaError_t err = grid_for(n_block_rows, F, &n_ft, &grid);
  if (err != cudaSuccess) return err;
  if (grid.x == 0) return cudaSuccess;
  SDB_FOR_SMALL_BLOCK_SIZE(b, int8_flat_kernel<BM><<<grid, kThreads, 0, s>>>(
      static_cast<const int64_t*>(step_ptr),
      static_cast<const int32_t*>(slot_cols),
      static_cast<const int8_t*>(qblocks), static_cast<const float*>(scales),
      static_cast<const int8_t*>(qdense), static_cast<const float*>(cs),
      static_cast<float*>(out), F, group, n_ft))
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers; the
// stream is the caller's current stream. Returns the cudaError_t of the
// launch (0 on success).

// K6. b = 64 and 128 run the int8 ring on qdense_t, the (F, n_dense_rows)
// transposed operand (qdense is not read), at F tiles of bn = 64 or 128
// columns; b = 16 and 32 the dp4a loop on qdense (n_dense_rows, F), whose
// tiles are 64 columns (bn must be 64; qdense_t is not read). The operand
// the kernel reads must not be null. n_slots is the number of packed
// slots.
extern "C" int sdb_bsr_spmm_int8_flat(
    const void* step_ptr, const void* slot_cols, const void* qblocks,
    const void* scales, const void* qdense, const void* qdense_t,
    const void* cs, void* out, int64_t n_block_rows, int64_t n_slots,
    int64_t n_dense_rows, int64_t F, int64_t group, int64_t b, int64_t bn,
    void* stream) {
  return (int)launch_flat(step_ptr, slot_cols, qblocks, scales, qdense,
                          qdense_t, cs, out, n_block_rows, n_slots,
                          n_dense_rows, F, group, b, bn,
                          static_cast<cudaStream_t>(stream));
}

// K9: K6's kernels; qdense3 is the (nbc, b, F) operand, contiguous, read
// as its (nbc*b, F) view, and qdense_t its (F, nbc*b) transpose.
extern "C" int sdb_bsr_spmm_int8_resident(
    const void* step_ptr, const void* slot_cols, const void* qblocks,
    const void* scales, const void* qdense3, const void* qdense_t,
    const void* cs, void* out, int64_t n_block_rows, int64_t n_slots,
    int64_t n_dense_rows, int64_t F, int64_t group, int64_t b, int64_t bn,
    void* stream) {
  return (int)launch_flat(step_ptr, slot_cols, qblocks, scales, qdense3,
                          qdense_t, cs, out, n_block_rows, n_slots,
                          n_dense_rows, F, group, b, bn,
                          static_cast<cudaStream_t>(stream));
}

// The operand of K6-K9 from the f32 x (n_rows, F), row stride ldx
// elements (any alignment): q, n_out >= n_rows rows quantized per column
// (rows >= n_rows are zeros), (F, n_out) with `transposed` (the ring's
// operand; n_out must be a multiple of 16 and q 16-byte aligned), else
// (n_out, F). static_scale (F,) f32 fixes the scales (col_scale and
// absmax are not touched); with static_scale null the entry computes them
// into col_scale (F,) f32, using absmax (F,) 32-bit words as scratch.
extern "C" int sdb_quantize_int8(const void* x, const void* static_scale,
                                 void* absmax, void* q, void* col_scale,
                                 int64_t ldx, int64_t n_rows, int64_t F,
                                 int64_t n_out, int64_t transposed,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_out < n_rows || ldx < F ||
      (transposed && (n_out % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16)) ||
      (static_scale == nullptr && (absmax == nullptr || col_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t n_ctas_x = ceil_div(n_out, kQRows), n_ctas_y = ceil_div(F, kQCols);
  if (n_ctas_x > INT32_MAX || ceil_div(F, 32) > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (F == 0 || n_out == 0) return (int)cudaSuccess;
  const auto* xf = static_cast<const float*>(x);
  const auto* ss = static_cast<const float*>(static_scale);
  auto* am = static_cast<unsigned*>(absmax);
  if (ss == nullptr) {
    if (cudaError_t e = cudaMemsetAsync(am, 0, F * sizeof(unsigned), s))
      return (int)e;
    if (n_rows > 0) {
      col_absmax_kernel<<<dim3((unsigned)ceil_div(n_rows, kAbsRows),
                               (unsigned)ceil_div(F, 32)),
                          256, 0, s>>>(xf, ldx, n_rows, F, am);
      if (cudaError_t e = cudaGetLastError()) return (int)e;
    }
  }
  const dim3 grid((unsigned)n_ctas_x, (unsigned)n_ctas_y);
  auto* qo = static_cast<int8_t*>(q);
  auto* cs = static_cast<float*>(col_scale);
  if (transposed)
    quantize_int8_kernel<true><<<grid, 256, 0, s>>>(xf, ldx, n_rows, F, n_out,
                                                    ss, am, qo, cs);
  else
    quantize_int8_kernel<false><<<grid, 256, 0, s>>>(xf, ldx, n_rows, F, n_out,
                                                     ss, am, qo, cs);
  return (int)cudaGetLastError();
}

// K7 and K8. b = 64 and 128 run the int8 ring on qdense_t, the (F,
// n_dense_rows) transposed operand (qdense is not read), at F tiles of bn
// = 64 or 128 columns; b = 16 and 32 the dp4a loop on qdense (N, F),
// whose tiles are 64 columns (bn must be 64; qdense_t is not read). The
// operand the kernel reads must not be null. n_slots is the number of
// packed slots.
extern "C" int sdb_bsr_spmm_int8_sorted(
    const void* group_ptr, const void* win_ids, const void* pos,
    const void* lane_valid, const void* slot_cols, const void* qblocks,
    const void* scales, const void* qdense, const void* qdense_t,
    const void* cs, void* out, int64_t n_lanes, int64_t n_slots,
    int64_t n_dense_rows, int64_t F, int64_t R, int64_t gh, int64_t window,
    int64_t b, int64_t bn, int64_t group_scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 64 || b == 128)
    return (int)launch_ring(group_ptr, win_ids, pos, lane_valid, slot_cols,
                            qblocks, scales, qdense_t, cs, out, n_lanes, 0,
                            n_slots, n_dense_rows, F, R, gh, window, b, bn,
                            group_scale, s);
  if (bn != kBN || qdense == nullptr) return (int)cudaErrorInvalidValue;
  int64_t n_ft;
  dim3 grid;
  cudaError_t err = grid_for(n_lanes, F, &n_ft, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid.x == 0) return (int)cudaSuccess;
  const auto* gp = static_cast<const int64_t*>(group_ptr);
  const auto* wi = static_cast<const int32_t*>(win_ids);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* lv = static_cast<const uint8_t*>(lane_valid);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* qb = static_cast<const int8_t*>(qblocks);
  const auto* sl = static_cast<const float*>(scales);
  const auto* qd = static_cast<const int8_t*>(qdense);
  const auto* cv = static_cast<const float*>(cs);
  auto* o = static_cast<float*>(out);
  if (group_scale) {
    SDB_FOR_SMALL_BLOCK_SIZE(b, int8_sorted_kernel<BM, true><<<grid, kThreads, 0, s>>>(
        gp, wi, ps, lv, sc, qb, sl, qd, cv, o, F, R, gh, window, n_ft))
  } else {
    SDB_FOR_SMALL_BLOCK_SIZE(b, int8_sorted_kernel<BM, false><<<grid, kThreads, 0, s>>>(
        gp, wi, ps, lv, sc, qb, sl, qd, cv, o, F, R, gh, window, n_ft))
  }
  return (int)cudaGetLastError();
}

extern "C" int sdb_bsr_spmm_int8_rowgroup(
    const void* group_ptr, const void* slot_cols, const void* qblocks,
    const void* scales, const void* qdense, const void* qdense_t,
    const void* cs, void* out, int64_t n_lanes, int64_t n_block_rows,
    int64_t n_slots, int64_t n_dense_rows, int64_t F, int64_t R, int64_t gh,
    int64_t b, int64_t bn, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 64 || b == 128)
    return (int)launch_ring(group_ptr, nullptr, nullptr, nullptr, slot_cols,
                            qblocks, scales, qdense_t, cs, out, n_lanes,
                            n_block_rows, n_slots, n_dense_rows, F, R, gh, 1, b,
                            bn, 0, s);
  if (bn != kBN || qdense == nullptr) return (int)cudaErrorInvalidValue;
  int64_t n_ft;
  dim3 grid;
  cudaError_t err = grid_for(n_lanes, F, &n_ft, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid.x == 0) return (int)cudaSuccess;
  SDB_FOR_SMALL_BLOCK_SIZE(b, int8_rowgroup_kernel<BM><<<grid, kThreads, 0, s>>>(
      static_cast<const int64_t*>(group_ptr),
      static_cast<const int32_t*>(slot_cols),
      static_cast<const int8_t*>(qblocks), static_cast<const float*>(scales),
      static_cast<const int8_t*>(qdense), static_cast<const float*>(cs),
      static_cast<float*>(out), n_block_rows, F, R, gh, n_ft))
  return (int)cudaGetLastError();
}
