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
// own layout, and the operand transposed at every b (below).
// quantize_int8_kernel makes their operand from the f32 one:
// the work of the JAX plan's _quantize_cols / _quantize_cols_static
// (XLA code, not Pallas) and of the zero rows up to the block grid, in
// the layout the kernel reads.
//
// K9. On the TPU the resident kernel keeps the whole (nbc, b, f_tile)
// int8 operand slice in VMEM and indexes it per slot, on K6's flat
// layout. Hopper keeps nothing resident (as for K5 in csrc/bsr_spmm.cu):
// K9's entry launches K6's kernels on K6's packed arrays and the
// (nbc*b, F) view of the operand, transposed, (F, nbc*b); it exists so
// that K9's launches are counted (and bound) apart from K6's.
//
// Two loops serve them, picked by the entry on b: the small-block
// tensor-core loop at b = 16 and 32, the tensor-core ring at b = 64 and
// 128. Both keep one contract: one CTA owns the f32 (b x BN) output tile
// of one lane for its whole life and stores it once (no atomics, so
// results are deterministic); absent (K7) and phantom (K8) lanes return
// before any barrier; K6 and K9 run K8's walk with one lane a block-row
// (R = 1, gh = the flat group, the step pointer as group pointer); the F
// edge is masked on the store; offsets are 64-bit.
//
// Numerics. The TPU multiplies int8 x int8 into int32 on the MXU. Here a
// slot's product is an exact int32 sum too, on the int8 tensor cores
// (mma.sync ... .s32.s8.s8 at b = 16 and 32, wgmma ... .s32.s8.s8 at 64
// and 128). f32 FMA of widened ints would be exact for one slot (127^2 *
// 128 < 2^24) but not for K7's group-scale lane sum, which reaches 127^2
// * 128 * gh (16,516,096 at gh = 8, 1.6% under 2^24, and past it for a
// larger explicit group), so the lane sum stays in int32.
// Per-slot scales (K6, K8, K7 without group scale): acc += s_slot *
// float(dot). Group scale (K7): acc += s_lane * float(sum of the
// lane-step's gh dots). The f32 sum is multiplied by the column scale
// cs[f] before the store. Both loops add the same f32 terms in the same
// order (the slots' walk order; an int32 sum does not depend on its
// order), so an answer does not depend on the loop, the tile width or
// the lane order, and matches the dp4a loop these replaced bit for bit.
//
// The small-block tensor-core loop (int8_small_kernel: K6-K9 at b = 16
// and 32). wgmma's M of 64 does not fit a 16- or 32-row block; mma.sync
// m16n8k16 (s8) fits b = 16 exactly and m16n8k32 b = 32 as two m tiles,
// one k step a slot each. With the tensor cores the products cost little
// (2*S*b*b*F is 0.03-0.11 ms at the card's int8 rate on the arxiv
// stand-in); what bounds the loop is moving each slot's block (256 bytes
// or 1 KiB) and its BN operand rows of b bytes (mostly from L2) into
// shared memory and, on a reordered power-law graph, the hub lane: a
// lane's sum cannot be split across CTAs, so one CTA per F tile walks
// all of a lane's slots in order, at the rate one SM streams them. So,
// as bf16's small-block loop in bsr_spmm.cu:
//   - 4 warps a CTA at BN = 32, 64 or 128 columns (the wrapper's choice,
//     int8_small_geometry, with the plan's deepest lane in view); warp w
//     owns columns w*BN/4 .. on all b rows, b/16 x BN/32 fragments.
//   - s8 mma.sync takes B K-major (.col) and ldmatrix has no 8-bit
//     transpose, so the loop reads the operand transposed, as the ring
//     does: qdense^T, (F, N) contiguous, whose row f holds column f's
//     depth; a slot at block column `col` reads BN rows of b bytes at
//     inner offset col*b. A (the block, row-major as packed) and B are
//     then both k-contiguous rows, read with ldmatrix (no trans).
//   - Each slot is one shared-memory stage, the block's b rows and the BN
//     operand rows, padded by 16 bytes at b = 32 (rows of 48 bytes put
//     the 8 rows of an ldmatrix matrix on 8 distinct 16-byte bank groups;
//     16-byte rows at b = 16 already do). cp.async 16-byte copies keep
//     I8Mma::kStages - 1 slots in flight (3-16 stages in up to 48 KiB),
//     one barrier a slot; the operand rows go through L1 (lanes of one
//     SM share columns).
//   - No global read waits inside the loop: a stage also carries its
//     slot's scale and the column of the slot kStages - 1 further on,
//     both copied with it by cp.async, so a slot's column is in shared
//     memory when its copies issue and its scale when its product is
//     scaled. (Read from global memory inside the loop, each exposed one
//     L2 round trip a slot: ~0.57 us a slot on a hub lane, as bf16's
//     small-block loop, whose column read is exposed the same way, takes.)
//   - CTAs take their lanes from the plan's lane_order, deepest first,
//     so a hub lane starts at once instead of adding its length to the
//     tail.
// Rows of qdense^T past F are not read (zero-filled copies).
//
// The int8 tensor-core ring (K6-K9 at b = 64 and 128), the design of
// csrc/bsr_spmm.cu's bf16 ring on int8: one CTA per (lane, F tile of BN =
// 64 or 128 columns, the wrapper's choice) owns its f32 output tile (no
// atomics, deterministic); b/64 consumer warpgroups, each issuing
// wgmma m64nBNk32.s32.s8.s8 on 64 output rows; one producer thread walks
// the lane's slots in walk order and streams each slot through a ring of
// stages in dynamic shared memory with TMA and mbarriers. s8 wgmma takes
// both operands K-major only (the transpose flags exist for 16-bit types
// alone), so the ring reads the operand transposed too: a slot at block
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
// cut runs within 2% of its time). The ring takes its lanes in packed
// order.
//
// The operand's quantization (quantize_int8_kernel). Both loops read the
// operand K-major, (F, N) int8; the plain versions read it (N, F). One
// kernel reads the f32 operand (any row stride and alignment), quantizes
// it per column and writes the layout asked for, with zero rows from
// n_rows up to N (the block grid's pad). A CTA quantizes a tile of 128
// rows x 64 columns in registers (one column, so one scale, a thread;
// four rows packed into a 32-bit word), stages it in shared memory by
// column and writes each column's 128 bytes as eight 16-byte stores;
// row-major output is stored from registers. Numerics are quantize_per_column's
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

#include "cp_async.cuh"
#include "tma_ring.cuh"

namespace {

// ---- the small-block tensor-core loop: K6-K9 at b = 16 and 32 -----------

// The lane's slots in walk order, as the ring's SlotWalk below, in
// 32-bit indices (the small-block loop's registers): the gh slots of
// step j sit at (j*R + lane)*gh. `slot` is the current one, `lane_step`
// its step's j*R + lane (the group scale's index) and `k` its place in
// the step.
struct SmallWalk {
  int slot, lane_step, k;
  __device__ SmallWalk(int64_t j0, int64_t R, int64_t lane, int64_t gh)
      : slot((int)((j0 * R + lane) * gh)), lane_step((int)(j0 * R + lane)), k(0) {}
  __device__ void next(int R, int gh) {
    if (++k == gh) {
      k = 0;
      lane_step += R;
      slot += (R - 1) * gh + 1;
    } else {
      ++slot;
    }
  }
};

// One CTA per (b x BN) output tile of a real lane, 4 warps; warp w owns
// the tile's columns w*BN/4 .. +BN/4-1 on every row: BM/16 m tiles of 16
// rows by BN/32 n tiles of 8 columns, each an mma.sync output fragment
// (m16n8k16 at b = 16, m16n8k32 at b = 32: one k step a slot).
template <int BM, int BN>
struct I8Mma {
  static constexpr int kThreads = 128;
  static constexpr int MT = BM / 16;  // m tiles
  static constexpr int kWarpN = BN / 4;
  static constexpr int NT = kWarpN / 8;  // n tiles a warp
  // Shared rows of BM bytes, padded by 16 at b = 32: rows of 48 bytes put
  // the 8 rows of an ldmatrix 8x8 matrix on 8 distinct 16-byte bank
  // groups (rows of 32 would put two on each); rows of 16 bytes already do.
  static constexpr int kRow = BM == 32 ? 48 : 16;
  static constexpr int kChunks = BM / 16;  // 16-byte copies a row
  static constexpr int kABytes = BM * kRow;  // the block
  static constexpr int kXBytes = BN * kRow;  // its BN operand rows
  // a stage: 16 bytes of header (the slot's scale, the column of the slot
  // kStages - 1 further on), the block, the operand rows
  static constexpr int kHeader = 16;
  static constexpr int kStageBytes = kHeader + kABytes + kXBytes;
  // Stages in flight: as many as fit in 48 KiB, 3 to 16 (a deep lane's
  // CTA streams its slots one after another, so its speed is the bytes it
  // keeps in flight; 48 KiB leaves room for 4 CTAs an SM).
  static constexpr int kFitStages = 49152 / kStageBytes;
  static constexpr int kStages =
      kFitStages < 3 ? 3 : kFitStages > 16 ? 16 : kFitStages;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static_assert((BM == 16 || BM == 32) && NT >= 1 && NT <= 4, "warp tile");
};

// d (16 x 8 s32) += a (16 x 32 s8, row-major) @ b (32 x 8 s8, k-major)
__device__ __forceinline__ void mma_s8_k32(int32_t (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8 s32) += a (16 x 16 s8, row-major) @ b (16 x 8 s8, k-major)
__device__ __forceinline__ void mma_s8_k16(int32_t (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// K7 (win_ids != nullptr) or K8 (win_ids == nullptr; K6 and K9 are K8
// with R = 1, gh = the flat group and the step pointer as group_ptr) at b
// = 16 and 32. One CTA per lane and F tile of BN columns, its lane from
// lane_order (deepest first); absent (K7) and phantom (K8) lanes return
// before any barrier and store nothing; no atomics. qdense_t is the
// operand transposed, (F, n_dense_rows) int8 with n_dense_rows a multiple
// of 16 and a 16-byte aligned base, as are the blocks. Each slot's block
// and its BN operand rows of the tile (rows >= F zero-filled) are one
// stage, streamed through G::kStages shared stages by cp.async 16-byte
// copies, G::kStages - 1 slots ahead (the operand rows through L1); one
// barrier a slot. A warp reads A (the block's rows) and B (the operand
// rows, k-contiguous, so the .col operand) with ldmatrix and runs
// mma.sync on s8 into the exact s32 sums `part`: from zero each slot with
// per-slot scales, chained over a lane-step's gh slots with group scale.
// After a slot (or a lane-step's last slot) CUDA cores add s * part to
// the f32 sums `acc`, in walk order; the store multiplies by cs[f].
template <int BM, int BN, bool kGroupScale>
__global__ void __launch_bounds__(I8Mma<BM, BN>::kThreads, 4)
    int8_small_kernel(const int64_t* __restrict__ group_ptr,
                      const int32_t* __restrict__ win_ids,
                      const int32_t* __restrict__ pos,
                      const uint8_t* __restrict__ lane_valid,
                      const int32_t* __restrict__ slot_cols,
                      const int32_t* __restrict__ lane_order,
                      const int8_t* __restrict__ qblocks,
                      const float* __restrict__ scales,
                      const int8_t* __restrict__ qdense_t,
                      const float* __restrict__ cs, float* __restrict__ out,
                      int64_t F, int64_t n_dense_rows, int64_t n_block_rows,
                      int64_t R, int64_t gh, int64_t window, int64_t n_ftiles) {
  using G = I8Mma<BM, BN>;
  constexpr int MT = G::MT, NT = G::NT, kStages = G::kStages;
  extern __shared__ __align__(16) uint8_t i8_smem[];
  const int64_t lane_id = lane_order[blockIdx.x / n_ftiles];  // group * R + lane
  // absent (K7) and phantom (K8) lanes store nothing: uniform over the CTA
  if (win_ids != nullptr ? !lane_valid[lane_id] : lane_id >= n_block_rows)
    return;
  const int64_t g = lane_id / R, lane = lane_id % R;
  const int64_t f0 = (blockIdx.x % n_ftiles) * BN;
  const int64_t j0 = group_ptr[g];
  const int n_slots = (int)((group_ptr[g + 1] - j0) * gh);
  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  const uint32_t smem = smem_u32(i8_smem);

  // The loader walks the lane's slots in order (lw), G::kStages - 1
  // ahead of the products, and copies with slot u its scale and the column
  // of slot u + kStages - 1 (pw), into the stage's header: stage t %
  // kStages holds, once slot t has landed, slot t's scale and the column
  // of slot t + kStages - 1, the next to be issued.
  const int R32 = (int)R, gh32 = (int)gh;
  SmallWalk lw(j0, R, lane, gh), pw = lw;
  for (int c = 0; c < kStages - 1; ++c) pw.next(R32, gh32);
  int issued = 0;
  auto load_next = [&](int64_t col) {  // the next slot into stage issued % kStages
    const uint32_t st = smem + (uint32_t)(issued % kStages) * G::kStageBytes;
    if (tid == 0) {
      cp_async4(st, scales + (kGroupScale ? lw.lane_step : lw.slot));
      if (issued + kStages - 1 < n_slots) cp_async4(st + 4, slot_cols + pw.slot);
    }
    const uint32_t sa = st + G::kHeader;
    const int8_t* blk = qblocks + (int64_t)lw.slot * (BM * BM);
#pragma unroll
    for (int e = tid; e < BM * G::kChunks; e += G::kThreads)
      cp_async16(sa + e / G::kChunks * G::kRow + e % G::kChunks * 16, blk + e * 16,
                 true);
    const int8_t* xr = qdense_t + f0 * n_dense_rows + col * BM;
#pragma unroll
    for (int e = tid; e < BN * G::kChunks; e += G::kThreads) {
      const int r = e / G::kChunks, c = e % G::kChunks * 16;
      cp_async16_ca(sa + G::kABytes + r * G::kRow + c, xr + r * n_dense_rows + c,
                    f0 + r < F);
    }
    ++issued;
    lw.next(R32, gh32);
    pw.next(R32, gh32);
  };

  int32_t part[MT][NT][4];
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[m][n][i] = 0;
        acc[m][n][i] = 0.f;
      }
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (issued < n_slots) load_next(__ldg(slot_cols + lw.slot));
    cp_async_commit();
  }
  // This lane's ldmatrix row addresses. A (m16n8k32: rows wl % 16 at
  // depth bytes (wl / 16) * 16; m16n8k16: rows wl % 16). B, rows of the
  // warp's columns: m16n8k32 pairs of n tiles, row wl % 8 (+ 8 for lanes
  // 16-31) at depth bytes ((wl / 8) % 2) * 16; m16n8k16 up to four n
  // tiles, row wl % (8 NT).
  const uint32_t a_off =
      G::kHeader + (wl % 16) * G::kRow + (BM == 32 ? (wl / 16) * 16 : 0);
  const int x_row = BM == 32 ? wl % 8 + (NT > 1 ? (wl / 16) * 8 : 0) : wl % (8 * NT);
  const uint32_t x_off = G::kHeader + G::kABytes +
                         (warp * G::kWarpN + x_row) * G::kRow +
                         (BM == 32 ? (wl / 8) % 2 * 16 : 0);
  int k = 0;  // slot t's place in its lane-step
  for (int t = 0; t < n_slots; ++t) {
    cp_async_wait<kStages - 2>();  // slot t has landed (this thread's copies)
    __syncthreads();
    const uint32_t st = smem + (uint32_t)(t % kStages) * G::kStageBytes;
    const uint8_t* header = i8_smem + (t % kStages) * G::kStageBytes;
    if (issued < n_slots) load_next(*reinterpret_cast<const int32_t*>(header + 4));
    cp_async_commit();
    // a slot's product is scaled after it, a lane-step's after its last slot
    const bool last = !kGroupScale || k == gh32 - 1;
    k = k + 1 == gh32 ? 0 : k + 1;
    const float s = *reinterpret_cast<const float*>(header);
    if constexpr (BM == 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) ldmatrix_x4(a[m], st + a_off + m * 16 * G::kRow);
      if constexpr (NT == 1) {
        ldmatrix_x2(b[0], st + x_off);
      } else {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, st + x_off + n * 8 * G::kRow);
          b[n][0] = r[0], b[n][1] = r[1];
          b[n + 1][0] = r[2], b[n + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_s8_k32(part[m][n], a[m], b[n][0], b[n][1]);
    } else {
      uint32_t a[2], b[NT];
      ldmatrix_x2(a, st + a_off);
      if constexpr (NT == 1) {
        ldmatrix_x1(b[0], st + x_off);
      } else if constexpr (NT == 2) {
        uint32_t r[2];
        ldmatrix_x2(r, st + x_off);
        b[0] = r[0], b[1] = r[1];
      } else {
        uint32_t r[4];
        ldmatrix_x4(r, st + x_off);
#pragma unroll
        for (int n = 0; n < 4; ++n) b[n] = r[n];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_s8_k16(part[0][n], a[0], a[1], b[n]);
    }
    if (last) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[m][n][i] += s * (float)part[m][n][i];
            part[m][n][i] = 0;
          }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the trailing groups are empty)

  // The output block-row, read after the loop: K7's from its window and
  // position, K8's (and K6's and K9's) the lane itself. The accumulator
  // fragment of m16n8: lane wl holds rows wl/4 (+8) and columns 2*(wl%4)
  // (+1) of each 16 x 8 tile; each column is multiplied by its operand
  // scale.
  const int64_t orow =
      win_ids != nullptr ? (int64_t)win_ids[j0] * window + pos[j0 * R + lane]
                         : lane_id;
  const bool pairs = F % 2 == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int64_t col0 = f0 + warp * G::kWarpN + n * 8 + 2 * (wl % 4);
    if (col0 >= F) continue;
    const bool two = col0 + 1 < F;
    const float c0 = __ldg(cs + col0), c1 = two ? __ldg(cs + col0 + 1) : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = out + (orow * BM + m * 16 + wl / 4 + 8 * h) * F + col0;
        const float v0 = acc[m][n][2 * h] * c0, v1 = acc[m][n][2 * h + 1] * c1;
        if (two) {
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            o[1] = v1;
          }
        } else {
          o[0] = v0;
        }
      }
  }
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

// The lane's slots in walk order: the gh slots of step j sit at (j*R +
// lane)*gh. `slot` is the current one, `lane_step` its step's j*R + lane
// (the group scale's index) and `k` its place in the step.
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

// K7 (win_ids != nullptr) or K8 (K6 and K9 with R = 1) on the small-block
// tensor-core loop at b = 16 and 32, over n_lanes lanes of ceil(F / bn)
// tiles, bn = 32, 64 or 128; lane_order (n_lanes,) int32 may not be
// null; qdense_t (F, n_dense_rows) and qblocks start on 16 bytes.
template <int BM, int BN, bool kGroupScale>
cudaError_t launch_small_tile(const int64_t* gp, const int32_t* wi,
                              const int32_t* ps, const uint8_t* lv,
                              const int32_t* sc, const int32_t* lo,
                              const int8_t* qb, const float* sl,
                              const int8_t* qt, const float* cv, float* o,
                              int64_t F, int64_t n_dense_rows,
                              int64_t n_block_rows, int64_t R, int64_t gh,
                              int64_t window, int64_t n_ft, dim3 grid,
                              cudaStream_t stream) {
  using G = I8Mma<BM, BN>;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      int8_small_kernel<BM, BN, kGroupScale>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (smem_set != cudaSuccess) return smem_set;
  int8_small_kernel<BM, BN, kGroupScale>
      <<<grid, G::kThreads, G::kSmemBytes, stream>>>(
          gp, wi, ps, lv, sc, lo, qb, sl, qt, cv, o, F, n_dense_rows,
          n_block_rows, R, gh, window, n_ft);
  return cudaGetLastError();
}

cudaError_t launch_small(const void* group_ptr, const void* win_ids,
                         const void* pos, const void* lane_valid,
                         const void* slot_cols, const void* lane_order,
                         const void* qblocks, const void* scales,
                         const void* qdense_t, const void* cs, void* out,
                         int64_t n_lanes, int64_t n_block_rows,
                         int64_t n_dense_rows, int64_t F, int64_t R, int64_t gh,
                         int64_t window, int64_t b, int64_t bn,
                         int64_t group_scale, cudaStream_t stream) {
  if (lane_order == nullptr || qdense_t == nullptr || n_dense_rows % 16 != 0 ||
      reinterpret_cast<uintptr_t>(qdense_t) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(qblocks) % 16 != 0)
    return cudaErrorInvalidValue;
  const int64_t n_ft = ceil_div(F, bn);
  const int64_t n_ctas = n_lanes * n_ft;
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (n_ctas == 0) return cudaSuccess;
  const dim3 grid((unsigned)n_ctas);
  const auto* gp = static_cast<const int64_t*>(group_ptr);
  const auto* wi = static_cast<const int32_t*>(win_ids);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* lv = static_cast<const uint8_t*>(lane_valid);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* lo = static_cast<const int32_t*>(lane_order);
  const auto* qb = static_cast<const int8_t*>(qblocks);
  const auto* sl = static_cast<const float*>(scales);
  const auto* qt = static_cast<const int8_t*>(qdense_t);
  const auto* cv = static_cast<const float*>(cs);
  auto* o = static_cast<float*>(out);
#define SDB_I8_SMALL(BM, BN, GS)                                              \
  if (b == BM && bn == BN && (group_scale != 0) == GS)                        \
    return launch_small_tile<BM, BN, GS>(gp, wi, ps, lv, sc, lo, qb, sl, qt,  \
                                         cv, o, F, n_dense_rows, n_block_rows, \
                                         R, gh, window, n_ft, grid, stream);
  SDB_I8_SMALL(16, 32, false)
  SDB_I8_SMALL(16, 64, false)
  SDB_I8_SMALL(16, 128, false)
  SDB_I8_SMALL(32, 32, false)
  SDB_I8_SMALL(32, 64, false)
  SDB_I8_SMALL(32, 128, false)
  SDB_I8_SMALL(16, 32, true)
  SDB_I8_SMALL(16, 64, true)
  SDB_I8_SMALL(16, 128, true)
  SDB_I8_SMALL(32, 32, true)
  SDB_I8_SMALL(32, 64, true)
  SDB_I8_SMALL(32, 128, true)
#undef SDB_I8_SMALL
  return cudaErrorInvalidValue;
}

// Every int8 entry: the small-block tensor-core loop at b = 16 and 32
// (which reads lane_order), the ring at b = 64 and 128 (packed lane
// order). Arguments as launch_small's and launch_ring's.
cudaError_t launch_int8(const void* group_ptr, const void* win_ids,
                        const void* pos, const void* lane_valid,
                        const void* slot_cols, const void* lane_order,
                        const void* qblocks, const void* scales,
                        const void* qdense_t, const void* cs, void* out,
                        int64_t n_lanes, int64_t n_block_rows, int64_t n_slots,
                        int64_t n_dense_rows, int64_t F, int64_t R, int64_t gh,
                        int64_t window, int64_t b, int64_t bn,
                        int64_t group_scale, cudaStream_t stream) {
  if (b == 16 || b == 32)
    return n_slots > INT32_MAX  // the small loop's walk is 32-bit
               ? cudaErrorInvalidValue
               : launch_small(group_ptr, win_ids, pos, lane_valid, slot_cols,
                              lane_order, qblocks, scales, qdense_t, cs, out,
                              n_lanes, n_block_rows, n_dense_rows, F, R, gh,
                              window, b, bn, group_scale, stream);
  return launch_ring(group_ptr, win_ids, pos, lane_valid, slot_cols, qblocks,
                     scales, qdense_t, cs, out, n_lanes, n_block_rows, n_slots,
                     n_dense_rows, F, R, gh, window, b, bn, group_scale, stream);
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers; the
// stream is the caller's current stream. Returns the cudaError_t of the
// launch (0 on success).

// K6. qdense_t is the (F, n_dense_rows) transposed operand, contiguous,
// on 16 bytes, read at every b; lane_order (n_block_rows,) int32, the
// CTAs' block-rows deepest first, read at b = 16 and 32, where it may not
// be null. bn: 64 or 128 at b = 64 and 128 (the ring), 32, 64 or 128 at
// 16 and 32 (the small-block loop). n_slots is the number of packed
// slots.
extern "C" int sdb_bsr_spmm_int8_flat(
    const void* step_ptr, const void* slot_cols, const void* lane_order,
    const void* qblocks, const void* scales, const void* qdense_t,
    const void* cs, void* out, int64_t n_block_rows, int64_t n_slots,
    int64_t n_dense_rows, int64_t F, int64_t group, int64_t b, int64_t bn,
    void* stream) {
  return (int)launch_int8(step_ptr, nullptr, nullptr, nullptr, slot_cols,
                          lane_order, qblocks, scales, qdense_t, cs, out,
                          n_block_rows, n_block_rows, n_slots, n_dense_rows, F,
                          1, group, 1, b, bn, 0,
                          static_cast<cudaStream_t>(stream));
}

// K9: K6's kernels and arguments; qdense_t is the (F, nbc*b) transpose of
// the (nbc, b, F) operand.
extern "C" int sdb_bsr_spmm_int8_resident(
    const void* step_ptr, const void* slot_cols, const void* lane_order,
    const void* qblocks, const void* scales, const void* qdense_t,
    const void* cs, void* out, int64_t n_block_rows, int64_t n_slots,
    int64_t n_dense_rows, int64_t F, int64_t group, int64_t b, int64_t bn,
    void* stream) {
  return (int)launch_int8(step_ptr, nullptr, nullptr, nullptr, slot_cols,
                          lane_order, qblocks, scales, qdense_t, cs, out,
                          n_block_rows, n_block_rows, n_slots, n_dense_rows, F,
                          1, group, 1, b, bn, 0,
                          static_cast<cudaStream_t>(stream));
}

// The operand of K6-K9 from the f32 x (n_rows, F), row stride ldx
// elements (any alignment): q, n_out >= n_rows rows quantized per column
// (rows >= n_rows are zeros), (F, n_out) with `transposed` (the kernels'
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

// K7 and K8: qdense_t, lane_order (n_lanes,) and bn as for K6.
extern "C" int sdb_bsr_spmm_int8_sorted(
    const void* group_ptr, const void* win_ids, const void* pos,
    const void* lane_valid, const void* slot_cols, const void* lane_order,
    const void* qblocks, const void* scales, const void* qdense_t,
    const void* cs, void* out, int64_t n_lanes, int64_t n_slots,
    int64_t n_dense_rows, int64_t F, int64_t R, int64_t gh, int64_t window,
    int64_t b, int64_t bn, int64_t group_scale, void* stream) {
  return (int)launch_int8(group_ptr, win_ids, pos, lane_valid, slot_cols,
                          lane_order, qblocks, scales, qdense_t, cs, out,
                          n_lanes, 0, n_slots, n_dense_rows, F, R, gh, window, b,
                          bn, group_scale, static_cast<cudaStream_t>(stream));
}

extern "C" int sdb_bsr_spmm_int8_rowgroup(
    const void* group_ptr, const void* slot_cols, const void* lane_order,
    const void* qblocks, const void* scales, const void* qdense_t,
    const void* cs, void* out, int64_t n_lanes, int64_t n_block_rows,
    int64_t n_slots, int64_t n_dense_rows, int64_t F, int64_t R, int64_t gh,
    int64_t b, int64_t bn, void* stream) {
  return (int)launch_int8(group_ptr, nullptr, nullptr, nullptr, slot_cols,
                          lane_order, qblocks, scales, qdense_t, cs, out,
                          n_lanes, n_block_rows, n_slots, n_dense_rows, F, R, gh,
                          1, b, bn, 0, static_cast<cudaStream_t>(stream));
}
