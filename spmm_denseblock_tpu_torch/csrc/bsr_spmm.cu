// Hand-written Hopper (sm_90a) kernels for the BSR SpMM plan,
// C[nbr*b, F] (f32) = A (packed b x b blocks) @ dense[nbc*b, F].
//
// K1 bsr_spmm_flat (f32) and bsr_spmm_flat_bf16 replace the TPU kernel
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:_pallas_spmm (+ _kernel),
// K2 bsr_spmm_sorted (f32) and bsr_spmm_sorted_bf16 replace
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:_pallas_spmm_rowgroup_sorted
//   (+ _rowgroup_sorted_kernel),
// K4 bsr_spmm_rowgroup (f32) and bsr_spmm_rowgroup_bf16 replace
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:_pallas_spmm_rowgroup
//   (+ _rowgroup_kernel),
// K5 bsr_spmm_resident (f32) and bsr_spmm_resident_bf16 replace
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:_pallas_spmm_resident
//   (+ _resident_kernel),
// K3, the bf16x3 product of spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:
//   _dot3 (precision="high"), runs as its own instance of K1, K2 and K5
//   (the *_bf16x3 entries), with split_bf16_kernel, its operand split.
// All read the packed arrays of the JAX packers unchanged (plus the
// row/group step pointers and the K2 lane-valid mask the port's packer
// adds) and compute what the TPU kernels compute on them.
//
// Three main loops serve them, picked by the entry on b and the operands:
//
//   instance                    b = 16, 32               b = 64, 128
//   f32 K1, K2, K4, K5          pipelined FFMA loop,     pipelined FFMA loop
//                               its small instances
//   bf16 K1, K2, K4, K5; K3     small-block tensor-core  tensor-core ring
//                               loop (mma.sync)          (wgmma + TMA)
//
// Every loop keeps one contract: one CTA owns the f32 (b x BN) output
// tile of one lane for its whole life and stores it once, so there are no
// atomics and results are deterministic; absent (K2) and phantom (K4)
// lanes return before any barrier; K1 and K5 run K4's walk with one lane
// per block-row (R = 1, the step pointer as group pointer). One slot is
// 2*b*b*F FLOP against b*b block values plus b*F operand values. Offsets
// into blocks and dense are 64-bit; the F edge is masked on the store.
//
// The small-block tensor-core loop (mma_small_kernel: bf16 K1, K2, K4,
// K5 and K3 at b = 16 and 32). wgmma's M of 64 does not fit a 16- or
// 32-row block; mma.sync m16n8k16 fits b = 16 exactly (one m tile, one k
// step) and b = 32 as 2 x 2. With the tensor cores the FLOPs cost little;
// what bounds the loop is moving each slot's block (0.5 or 2 KiB) and its
// b operand rows of the tile (b*BN*2 bytes, mostly from L2) into shared
// memory, and, on a reordered power-law graph, the hub lane: one CTA per
// F tile walks all of a lane's slots in order (5,148 at b = 32 on the
// arxiv stand-in under gorder), at the rate one SM streams them. So:
//   - 4 warps a CTA at BN = 32, 64 or 128 columns (the wrapper's choice,
//     bf16_small_geometry, with the plan's deepest lane in view, as for
//     the small f32 instances); warp w owns columns w*BN/4 .. on all b
//     rows, b/16 x BN/32 fragments of 16 x 8.
//   - Each slot is one shared-memory stage: the block row-major, as packed
//     (A, read with ldmatrix), and the operand rows n-contiguous (B, read
//     with ldmatrix.trans), each row padded by 16 bytes so that ldmatrix
//     is free of bank conflicts. cp.async 16-byte copies keep 2-7 slots
//     in flight (Mma::kStages, up to 48 KiB a CTA), one barrier a slot;
//     the operand rows go through L1 (cp.async.ca: lanes on one SM share
//     columns; on the arxiv stand-in under rcmk it took 21% less time
//     than through L2 alone). At 76-128 registers a thread four CTAs
//     share an SM: more stages, or more state a thread (a read-ahead of
//     the next column, L2 requests for blocks 16 slots ahead), cost more
//     in occupancy than they won on the hub lane.
//   - CTAs take their lanes from the plan's lane_order, deepest first, so
//     a hub lane starts at once instead of adding its length to the tail.
//   - Two-level sums, as on the ring below: the tensor cores sum 64 deep
//     (2 slots at b = 32, 4 at 16) from zero, and CUDA cores add that
//     partial to the tile's f32 sums, round to nearest, in slot order.
//   - K3 runs three products per fragment, hi*lo and lo*hi before hi*hi.
//
// The pipelined FFMA loop (ffma_pipe_kernel: every exact-f32 instance, K2
// on its sorted walk, K4 on its row-group walk, K1 and K5 on K4's walk
// with R = 1). The same contract, each output's FFMA sum in slot and
// depth order (so every walk, tile width and lane order gives the same
// bits), built to keep the FMA units
// busy: register microtiles fed by float4 shared loads, 16-deep chunks
// streamed by cp.async through shared-memory stages, one barrier a chunk,
// at most 128 registers a thread. The 1e-4 gate and the "exact" contract
// rule out TF32, so it stays an FFMA kernel, bound by the FFMA rate.
//   - b = 64 and 128: 256 threads, tiles of BN = 64 or 128 columns (the
//     wrapper's choice, as for the tensor-core loop below: at F=512 a
//     block is read 4 times, not 8); 8 x 8 (b=128) or 4 x 8 (b=64)
//     microtiles at BN=128 (one 16-byte load per 16 FMAs at 8 x 8); 3
//     (BN=128) or 4 (BN=64) stages; two CTAs an SM.
//   - b = 16 and 32 (the small instances): 4*b threads at BN = 32, 64 or
//     128, microtiles of BN/4 outputs (2 x 4 to 4 x 8), 4 stages of
//     3.3-10.5 KiB, four CTAs an SM or more. On a reordered power-law
//     graph one block-row (a hub) holds
//     thousands of blocks while most hold a hundred: on the arxiv
//     stand-in under gorder the deepest of 814,720 slots' lanes walks
//     5,148 of them at b = 32. A lane's sum cannot be split across CTAs
//     without changing its order, so the hub's F tiles are its only
//     parallelism: the wrapper narrows BN until the hub CTA's work fits
//     its share of the grid (f32_small_geometry), which puts more warps
//     on the hub, and the CTAs take their lanes from the plan's
//     lane_order, deepest first, so the hub starts at once instead of
//     adding its whole length to the tail.
//
// K3 (bf16x3). The TPU runs three bf16 MXU passes, hi*hi + hi*lo +
// lo*hi, and drops lo*lo. Here the splits are made before the launch: a
// "high" plan holds its packed blocks as two bf16 planes, hi = bf16_rn(a)
// and lo = bf16_rn(a - hi) (round to nearest even, as jnp.astype and
// torch.to round; a - hi is exact in f32), and each call splits the f32
// operand into two such planes with split_bf16_kernel (rows of a multiple
// of 8, 16-byte aligned). A product of two bf16 values is exact in f32,
// so three bf16 products with f32 sums compute what the MXU passes
// compute, up to the order of the sums. K3 runs on the tensor cores at
// every b: on the ring below with two planes a stage at b = 64 and 128, on
// the small-block loop with two planes a slot at b = 16 and 32.
//
// K5. On the TPU the resident kernel keeps the whole (nbc, b, f_tile)
// operand slice in VMEM and indexes it per slot. Hopper has no 80 MB of
// on-chip memory to hold it, so nothing is kept resident: the layout
// only says which slots a CTA owns, and they are K1's (one block-row's
// steps, through a step pointer). So K5's entries launch K1's kernels on
// K1's packed arrays; they exist so that K5's launches are counted (and
// bound) apart from K1's.
//
// The tensor-core loop (bf16 K1, K2, K4 and K5 at b = 64 and 128:
// bsr_spmm_flat_bf16, bsr_spmm_sorted_bf16, bsr_spmm_rowgroup_bf16,
// bsr_spmm_resident_bf16; and K3 there, with two planes). K1's walk (one block-row's steps through a
// step pointer) is K4's with one lane per group, so the flat entries
// launch the K4 instance with R = 1 and gh = group. The JAX kernels run
// bf16 operands at Precision.DEFAULT with preferred_element_type=f32:
// bf16 products, exact in f32, summed in f32, which is what
// wgmma.mma_async...f32.bf16.bf16 computes. With the tensor cores the
// FLOPs cost little (2*S*b*b*F is about 0.4-0.6 ms at the card's bf16
// rate for S = 20-35k slots at b=128, F=512); what bounds the kernel is
// moving bytes: per slot and F tile a 32 KiB block and a (b x BN) slice
// of the operand, whose block columns are random and mostly miss the 50
// MB L2. So the design moves each byte once per CTA, keeps many loads in
// flight and overlaps them with the products:
//   - One CTA owns the f32 (b x BN) output tile of one lane, as in the
//     other loops, so there are no atomics and the result is deterministic.
//     BN (64 or 128) is chosen per launch by the wrapper: the wider one
//     the F extent needs whose grid still covers the card's SMs. At the
//     op shape (F=512, 1,024 lanes) BN=128 fetches each block 4 times,
//     not 8. The F tiles of one lane are adjacent in blockIdx, so the
//     later fetches of a block hit L2.
//   - b/64 consumer warpgroups, each issuing wgmma m64nBNk16 on 64 output
//     rows, and one
//     producer warp that walks the lane's slots exactly as the other loops
//     do and streams each slot's depth chunks of 64 through a ring of
//     stages in dynamic shared memory with TMA (cp.async.bulk.tensor,
//     128-byte swizzle, mbarrier completion). A stage holds the block's
//     (b x 64) depth chunk, K-major, and the operand's (64 x BN) rows,
//     MN-major (wgmma reads B transposed through its descriptor); at
//     b=128, BN=128 that is 32 KiB a stage, 4 stages, 128 KiB in all.
//     K3's stage holds both planes of each, 64 KiB at b=128, BN=128, so
//     that ring has 3 stages (192 KiB); each stage issues three chains
//     of wgmma, hi*lo and lo*hi first and hi*hi last, so the small terms
//     are summed before the large one joins them. K3 moves twice the
//     bytes of a bf16 product for three times its (still small) tensor
//     work, so it is bound, as the bf16 entries are, by moving bytes.
//   - Two-level sums: the tensor cores sum each stage (64 deep) from
//     zero, and CUDA cores add that partial sum into the tile's f32 sums
//     with round-to-nearest. The tensor cores' own f32 accumulation
//     truncates as it aligns its addends; chained over the 4,352-deep
//     rows of ddi it drifted 1.3e-5 from the plain version (an f32 sum),
//     past the 1e-5 gate. The two sets take BN registers a thread, which
//     caps BN at 128: at 256 (three warpgroups of 168 registers) ptxas
//     spilled 600 bytes even with setmaxnreg moving registers from the
//     producer, and ran 2x slower than 128; before the two-level sums,
//     BN=256 had been no faster than 128 either.
//   - The store goes straight from the accumulators' fragment positions,
//     masking columns >= F. TMA needs 16-byte operand rows, so the
//     wrapper pads a ragged F to a multiple of 8 (ld) and the kernel
//     masks the store; columns past ld read as zeros (TMA's out-of-bounds
//     fill).
//   - Absent (K2) and phantom (K4) lanes return before any barrier is
//     initialised; K1 and K5 have neither.
// wgmma's M of 64 does not fit b = 16 or 32 blocks, so the bf16 entries
// run those on the small-block loop above, picked on b (launch_bf16).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "tma_ring.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- the small-block tensor-core loop: bf16 K1, K2, K4, K5 and K3 at b = 16, 32

// One CTA per (b x BN) output tile of a real lane, 4 warps; warp w owns
// the tile's columns w*BN/4 .. +BN/4-1 on every row: BM/16 m tiles of 16
// rows by BN/32 n tiles of 8 columns, each an mma.sync m16n8k16 output
// fragment, P planes (1 for bf16 operands, 2, hi and lo, for K3).
template <int BM, int BN, int P>
struct Mma {
  static constexpr int kThreads = 128;
  static constexpr int MT = BM / 16;  // m tiles, and k steps a slot
  static constexpr int kWarpN = BN / 4;
  static constexpr int NT = kWarpN / 8;  // n tiles a warp
  // Slots whose products the tensor cores sum from zero before CUDA cores
  // add them to the tile's f32 sums: 64 deep, as the ring's stages.
  static constexpr int kPart = 64 / BM;
  // Shared rows padded by 16 bytes, so that the 8 rows of an ldmatrix
  // 8x8 matrix land on 8 distinct 16-byte bank groups (rows of 32, 64,
  // 128 or 256 bytes would put 2 to 8 of them on one).
  static constexpr int kARow = BM * 2 + 16;  // bytes
  static constexpr int kXRow = BN * 2 + 16;
  static constexpr int kABytes = BM * kARow;  // one plane of a slot's block
  static constexpr int kXBytes = BM * kXRow;  // one plane of its operand rows
  // a stage: one slot, the A planes then the operand planes
  static constexpr int kStageBytes = P * (kABytes + kXBytes);
  // Stages in flight: as many as fit in 48 KiB, 3 to 8 (a deep lane's
  // CTA streams its slots one after another, so its speed is the bytes it
  // keeps in flight; 48 KiB leaves room for 4 CTAs an SM).
  static constexpr int kFit = 49152 / kStageBytes;
  static constexpr int kStages = kFit < 3 ? 3 : kFit > 8 ? 8 : kFit;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static_assert(NT >= 1 && BM % 16 == 0, "warp tile");
};

// d (16 x 8 f32 fragment) += a (16 x 16 bf16, row-major) @ b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 K2 (win_ids != nullptr) or K4 (win_ids == nullptr; K1 and K5 are
// K4 with R = 1, gh = the flat group and the step pointer as group_ptr),
// and K3 on the same walks with P = 2 planes (the lo plane of the blocks
// a_lo elements after the hi plane, that of the operand x_lo elements
// after it), at b = 16 and 32. One CTA per lane and F tile of BN columns,
// its lane from lane_order (deepest first); absent (K2) and phantom (K4)
// lanes return before any barrier and store nothing; no atomics. Each
// slot's block and its BM operand rows of the tile (dense has rows of ld
// >= F bf16, ld a multiple of 8, and a 16-byte aligned base; columns >=
// ld are zero-filled) are one stage, streamed through G::kStages shared
// stages by cp.async 16-byte copies, G::kStages - 1 slots ahead (the
// operand rows through L1); one barrier a slot. A warp reads its A fragments with ldmatrix (the block
// row-major, as packed) and its B fragments with ldmatrix.trans (the
// operand's rows, n-contiguous), and runs mma.sync m16n8k16 (bf16
// products, exact in f32, summed in f32); K3 runs hi*lo and lo*hi before
// hi*hi on each fragment (lo*lo is dropped). Two-level sums, as on the
// ring: the tensor cores sum G::kPart slots (64 deep) from zero into
// `part`, which CUDA cores add, in slot order, to the f32 sums `acc`.
template <int BM, int BN, int P>
__global__ void __launch_bounds__(Mma<BM, BN, P>::kThreads, 4)
    mma_small_kernel(const int64_t* __restrict__ group_ptr,
                     const int32_t* __restrict__ win_ids,
                     const int32_t* __restrict__ pos,
                     const uint8_t* __restrict__ lane_valid,
                     const int32_t* __restrict__ slot_cols,
                     const int32_t* __restrict__ lane_order,
                     const bf16* __restrict__ blocks,
                     const bf16* __restrict__ dense, float* __restrict__ out,
                     int64_t F, int64_t ld, int64_t n_block_rows, int64_t R,
                     int64_t gh, int64_t window, int64_t n_ftiles, int64_t a_lo,
                     int64_t x_lo) {
  using G = Mma<BM, BN, P>;
  constexpr int MT = G::MT, NT = G::NT, kStages = G::kStages;
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const int64_t lane_id = lane_order[blockIdx.x / n_ftiles];  // group * R + lane
  // absent (K2) and phantom (K4) lanes store nothing: uniform over the CTA
  if (win_ids != nullptr ? !lane_valid[lane_id] : lane_id >= n_block_rows)
    return;
  const int64_t g = lane_id / R, lane = lane_id % R;
  const int64_t f0 = (blockIdx.x % n_ftiles) * BN;
  const int64_t j0 = group_ptr[g];
  const int n_slots = (int)((group_ptr[g + 1] - j0) * gh);
  const int tid = threadIdx.x, warp = tid / 32, wl = tid % 32;
  const uint32_t smem = smem_u32(mma_smem);

  // The loader walks the lane's slots in order, lr slots into step lj; it
  // runs kStages - 1 slots ahead of the products.
  int lr = 0, issued = 0;
  int64_t lj = j0, ls = (j0 * R + lane) * gh;
  auto load_next = [&]() {  // the next slot into stage issued % kStages
    const int64_t col = __ldg(slot_cols + ls);
    const uint32_t st = smem + (uint32_t)(issued % kStages) * G::kStageBytes;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const bf16* blk = blocks + p * a_lo + ls * (BM * BM);
#pragma unroll
      for (int e = tid; e < BM * BM / 8; e += G::kThreads)
        cp_async16(st + p * G::kABytes + e / (BM / 8) * G::kARow + e % (BM / 8) * 16,
                   blk + e * 8, true);
      const bf16* xr = dense + p * x_lo + col * BM * ld + f0;
#pragma unroll
      for (int e = tid; e < BM * BN / 8; e += G::kThreads) {
        const int r = e / (BN / 8), c = e % (BN / 8) * 8;
        cp_async16_ca(st + P * G::kABytes + p * G::kXBytes + r * G::kXRow + c * 2,
                      xr + r * ld + c, f0 + c < ld);
      }
    }
    ++issued;
    if (++lr == gh) {
      lr = 0;
      ls = (++lj * R + lane) * gh;
    } else {
      ++ls;
    }
  };

  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = part[m][n][i] = 0.f;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (issued < n_slots) load_next();
    cp_async_commit();
  }
  // This lane's ldmatrix row addresses: A rows wl % 16 at depth (wl / 16)
  // * 8, operand rows (depth) wl % 16 at the warp's columns + (wl / 16) * 8
  const uint32_t a_off = (wl % 16) * G::kARow + (wl / 16) * 16;
  const uint32_t x_off = P * G::kABytes + (wl % 16) * G::kXRow +
                         (warp * G::kWarpN + (NT > 1 ? (wl / 16) * 8 : 0)) * 2;
  for (int t = 0; t < n_slots; ++t) {
    cp_async_wait<kStages - 2>();  // slot t has landed (this thread's copies)
    __syncthreads();
    if (issued < n_slots) load_next();
    cp_async_commit();
    const uint32_t st = smem + (uint32_t)(t % kStages) * G::kStageBytes;
#pragma unroll
    for (int k = 0; k < MT; ++k) {  // 16-deep steps
      uint32_t a[P][MT][4], b[P][NT][2];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(a[p][m], st + p * G::kABytes + a_off + m * 16 * G::kARow +
                                   k * 32);
        const uint32_t xa = st + x_off + p * G::kXBytes + k * 16 * G::kXRow;
        if constexpr (NT == 1) {
          ldmatrix_x2_trans(b[p][0], xa);
        } else {
#pragma unroll
          for (int n = 0; n < NT; n += 2) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, xa + n * 16);
            b[p][n][0] = r[0], b[p][n][1] = r[1];
            b[p][n + 1][0] = r[2], b[p][n + 1][1] = r[3];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if constexpr (P == 2) {  // hi*lo, lo*hi, then hi*hi
            mma_bf16(part[m][n], a[0][m], b[1][n][0], b[1][n][1]);
            mma_bf16(part[m][n], a[1][m], b[0][n][0], b[0][n][1]);
          }
          mma_bf16(part[m][n], a[0][m], b[0][n][0], b[0][n][1]);
        }
    }
    if ((t + 1) % G::kPart == 0 || t + 1 == n_slots) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[m][n][i] += part[m][n][i];
            part[m][n][i] = 0.f;
          }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the trailing groups are empty)

  // The output block-row, read after the loop: K2's from its window and
  // position, K4's (and K1's and K5's) the lane itself. The accumulator
  // fragment of m16n8: lane wl holds rows wl/4 (+8) and columns 2*(wl%4)
  // (+1) of each 16 x 8 tile.
  const int64_t orow =
      win_ids != nullptr ? (int64_t)win_ids[j0] * window + pos[j0 * R + lane]
                         : lane_id;
  const bool pairs = F % 2 == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int64_t col = f0 + warp * G::kWarpN + n * 8 + 2 * (wl % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = out + (orow * BM + m * 16 + wl / 4 + 8 * h) * F + col;
        const float v0 = acc[m][n][2 * h], v1 = acc[m][n][2 * h + 1];
        if (col + 1 < F) {
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            o[1] = v1;
          }
        } else if (col < F) {
          o[0] = v0;
        }
      }
    }
}

// ---- the pipelined FFMA loop: exact f32 K1, K2, K4 and K5 ----------------

constexpr int kPipeK = 16;  // depth of one pipeline stage

// One CTA per (b x BN) output tile; thread (tx, ty) owns the TM x TN
// microtile of rows ty*TM .. +TM-1 and columns 4*NX*(j/4) + 4*tx + j%4 (j <
// TN), NX threads across, so that neighbouring threads read neighbouring
// float4 of an operand stage row. b = 64 and 128: 256 threads in a 16 x 16
// grid, TM = BM/16, TN = BN/16. b = 16 and 32 (the small instances): BM/8
// warps (128 threads at b = 32, 64 at 16), each an 8 x 4 patch of the
// thread grid (8 float4 of an operand row a warp: one shared-memory
// wavefront), microtiles of BN/4 outputs: 2 x 4, 4 x 4 and 4 x 8 at BN =
// 32, 64 and 128. A narrower tile puts more warps on a deep lane's
// output, at fewer FMAs a shared load.
template <int BM, int BN>
struct Pipe {
  static constexpr bool kSmall = BM < 64;
  static constexpr int kThreads = kSmall ? 4 * BM : 256;
  static constexpr int kOut = BM * BN / kThreads;  // outputs a thread
  static constexpr int TN = kSmall ? (kOut >= 32 ? 8 : 4) : BN / 16;
  static constexpr int TM = kSmall ? kOut / TN : BM / 16;
  static constexpr int NX = BN / TN;       // threads across the tile
  static constexpr int kAStride = BM + 4;  // floats per row of the A^T stage
  static constexpr int kAFloats = kPipeK * kAStride;
  static constexpr int kStageFloats = kAFloats + kPipeK * BN;
  // Stages in flight. On an H100, 3 ran K2, K1 and K4 2-3% faster than 4
  // at bench.py's op shape (BN = 128, 4,096 CTAs; its 8x8 instance
  // spills, and a smaller ring leaves more of the SM's memory to L1),
  // but cost f32 K2 2% at ddi (BN = 64, one CTA an SM), where a deeper
  // ring hides more latency: 3 at BN = 128, 4 at BN = 64
  // (scripts/torch_kernel_variants.py f32_k2, chip_smoke.py). The small
  // instances' stages are 3.3-10.5 KiB: 4 of them (3 and 6 ran within 1%
  // on the arxiv stand-in: scripts/torch_kernel_variants.py f32_small).
  static constexpr int kStages = kSmall ? 4 : BN == 128 ? 3 : 4;
  // CTAs an SM at <= 128 registers a thread
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
  static_assert(TM >= 1 && NX % 8 == 0 && NX * (BM / TM) == kThreads,
                "thread grid");
};

// f32 K2 (win_ids != nullptr) or K4 (win_ids == nullptr; K1 and K5 are
// K4 with R = 1, gh = the flat group and the step pointer as group_ptr,
// as on the tensor-core ring): one CTA per lane and F tile of BN columns;
// absent (K2) and phantom (K4) lanes return before any barrier and store
// nothing; no atomics. The small instances (b = 16, 32) take their lanes
// in lane_order (deepest first: the grid starts the longest CTAs first,
// so no deep lane starts last and adds its whole length to the tail);
// b = 64 and 128 in packed order. Each slot's depth chunks of 16 are
// streamed through G::kStages shared-memory stages by cp.async: the
// block chunk transposed element by element (A^T, rows of BM + 4
// floats), the operand's 16 rows x BN columns in 16-byte copies (dense
// has rows of ld >= F floats, ld a multiple of 4, and a 16-byte aligned
// base; columns >= ld are zero-filled). One barrier per chunk: after it
// the chunk has landed for every thread and the stage the next load
// overwrites has been read by every thread. Each output's FFMA sum runs
// in slot order and depth order, so every
// instance and every lane order gives the same bits.
template <int BM, int BN>
__global__ void __launch_bounds__(Pipe<BM, BN>::kThreads,
                                  Pipe<BM, BN>::kMinBlocks)
    ffma_pipe_kernel(const int64_t* __restrict__ group_ptr,
                     const int32_t* __restrict__ win_ids,
                     const int32_t* __restrict__ pos,
                     const uint8_t* __restrict__ lane_valid,
                     const int32_t* __restrict__ slot_cols,
                     const int32_t* __restrict__ lane_order,
                     const float* __restrict__ blocks,
                     const float* __restrict__ dense, float* __restrict__ out,
                     int64_t F, int64_t ld, int64_t n_block_rows, int64_t R,
                     int64_t gh, int64_t window, int64_t n_ftiles) {
  using G = Pipe<BM, BN>;
  constexpr int TM = G::TM, TN = G::TN, kStages = G::kStages;
  constexpr int kThreads = G::kThreads;
  constexpr int kChunks = BM / kPipeK;  // per slot
  extern __shared__ __align__(16) float pipe_smem[];
  const int64_t cta_lane = blockIdx.x / n_ftiles;
  const int64_t lane_id =  // group * R + lane
      G::kSmall ? (int64_t)lane_order[cta_lane] : cta_lane;
  // absent (K2) and phantom (K4) lanes store nothing: uniform over the CTA
  if (win_ids != nullptr ? !lane_valid[lane_id] : lane_id >= n_block_rows)
    return;
  const int64_t g = lane_id / R, lane = lane_id % R;
  const int64_t f0 = (blockIdx.x % n_ftiles) * BN;
  const int64_t j0 = group_ptr[g];
  const int n_chunks = (int)((group_ptr[g + 1] - j0) * gh) * kChunks;
  const int tid = threadIdx.x;
  int tx, ty;
  if constexpr (G::kSmall) {  // warps of 8 x 4 threads
    const int warp = tid / 32, wl = tid % 32;
    tx = warp % (G::NX / 8) * 8 + wl % 8;
    ty = warp / (G::NX / 8) * 4 + wl / 8;
  } else {
    tx = tid % 16;
    ty = tid / 16;
  }
  const uint32_t smem = smem_u32(pipe_smem);
  // This thread's copies: A^T elements (a_m + it * kARows, a_k), operand
  // float4 (x_k + it * kXRows, x_n); columns >= ld are zero-filled.
  constexpr int kARows = kThreads / kPipeK, kXRows = kThreads / (BN / 4);
  static_assert(BM % kARows == 0 && kPipeK % kXRows == 0, "copy shapes");
  const int a_m = tid / kPipeK, a_k = tid % kPipeK;
  const int x_k = tid / (BN / 4), x_n = tid % (BN / 4) * 4;
  const bool x_valid = f0 + x_n < ld;
  const int64_t x_col = x_valid ? f0 + x_n : 0;

  // The loader walks the lane's slots in order, chunk lk of slot ls, lr
  // slots into step lj; it runs kStages - 1 chunks ahead of the FMAs.
  int lk = 0, lr = 0, issued = 0;
  int64_t lj = j0, ls = (j0 * R + lane) * gh;
  auto load_next = [&]() {  // the next chunk into stage issued % kStages
    const int64_t col = __ldg(slot_cols + ls);
    const float* blk = blocks + ls * (BM * BM) + lk * kPipeK + a_m * BM + a_k;
    const uint32_t a_st = smem + (uint32_t)(issued % kStages) *
                                     (G::kStageFloats * 4);
#pragma unroll
    for (int it = 0; it < BM / kARows; ++it)
      cp_async4(a_st + (a_k * G::kAStride + a_m + it * kARows) * 4,
                blk + it * kARows * BM);
    const float* xrow = dense + (col * BM + lk * kPipeK + x_k) * ld + x_col;
    const uint32_t x_st = a_st + (G::kAFloats + x_k * BN + x_n) * 4;
#pragma unroll
    for (int it = 0; it < kPipeK / kXRows; ++it)
      cp_async16(x_st + it * kXRows * BN * 4, xrow + it * kXRows * ld, x_valid);
    ++issued;
    if (++lk == kChunks) {
      lk = 0;
      if (++lr == gh) {
        lr = 0;
        ls = (++lj * R + lane) * gh;
      } else {
        ++ls;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (issued < n_chunks) load_next();
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's)
    __syncthreads();
    if (issued < n_chunks) load_next();
    cp_async_commit();
    const float* as = pipe_smem + (c % kStages) * G::kStageFloats;
    const float* xs = as + G::kAFloats;
#pragma unroll
    for (int kk = 0; kk < kPipeK; ++kk) {
      float a[TM], x[TN];
      const float* ap = as + kk * G::kAStride + ty * TM;
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ap + i);
          a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
        }
      } else if constexpr (TM == 2) {
        const float2 v = *reinterpret_cast<const float2*>(ap);
        a[0] = v.x, a[1] = v.y;
      } else {
        a[0] = *ap;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + kk * BN + j / 4 * (4 * G::NX) + tx * 4);
        x[j] = v.x, x[j + 1] = v.y, x[j + 2] = v.z, x[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the trailing groups are empty)

  // The output block-row, read after the loop so that it holds no
  // registers there: K2's from its window and position, K4's (and K1's
  // and K5's) the lane itself.
  const int64_t orow =
      win_ids != nullptr ? (int64_t)win_ids[j0] * window + pos[j0 * R + lane]
                         : lane_id;
  const bool vec = F % 4 == 0;  // float4 stores stay 16-byte aligned
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* o = out + (orow * BM + ty * TM + i) * F;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int64_t col = f0 + j / 4 * (4 * G::NX) + tx * 4;
      if (vec && col + 3 < F) {
        *reinterpret_cast<float4*>(o + col) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < F) o[col + q] = acc[i][j + q];
      }
    }
  }
}

// ---- the tensor-core loop: bf16 K1, K2, K4 and K5, and K3, at b = 64, 128

constexpr int kDepth = 64;  // depth of one stage: one 128-byte row of bf16

// P planes: 1 for bf16 operands, 2 (hi and lo) for K3.
template <int BM, int BN, int P>
struct Ring {
  static constexpr int kConsumers = BM / 64;  // warpgroups of 64 rows each
  static constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer
  // a (64 x 64) TMA box of the operand is 64 rows of 128 bytes
  static constexpr uint32_t kXBox = kDepth * 64 * 2;
  static constexpr uint32_t kABytes = BM * kDepth * 2;  // one plane
  static constexpr uint32_t kXBytes = BN / 64 * kXBox;  // one plane
  // a stage: the A planes, then the operand planes
  static constexpr uint32_t kStageBytes = P * (kABytes + kXBytes);
  // narrow one-plane tiles leave room for two CTAs an SM
  static constexpr int kMinBlocks = BN == 64 && P == 1 ? 2 : 1;
  // as many stages as fit, at most 4 (3 at b = 128, BN = 128, two planes)
  static constexpr int kFit = (kSmemPerBlock / kMinBlocks - 2048) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // + slack to align the ring to the 1024-byte period of the swizzle
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// D (64 x N, f32, registers) = A (64 x 16, K-major) @ B (16 x N,
// MN-major, i.e. transposed: imm-trans-b = 1) + (scale_d ? D : 0), A and
// B bf16 in shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      " %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

// bf16 K2 (win_ids != nullptr) or K4 (win_ids == nullptr; K1 and K5 are
// K4 with R = 1) on the tensor cores, and K3 on the same walks with P = 2
// planes: the lo plane of the blocks starts a_plane rows of the blocks'
// map after the hi plane, that of the operand x_plane rows after it. One
// CTA per (lane, F tile of BN columns); warpgroups 0 .. kConsumers-1 run
// the products on 64 rows each, the last warpgroup's first thread runs
// the TMA producer. Stage i's `full` barrier completes when its bytes
// have landed, its `empty` barrier when every consumer warp has finished
// reading it.
template <int BM, int BN, int P>
__global__ void __launch_bounds__(Ring<BM, BN, P>::kThreads,
                                  Ring<BM, BN, P>::kMinBlocks)
    bf16_ring_kernel(const __grid_constant__ CUtensorMap tm_blocks,
                     const __grid_constant__ CUtensorMap tm_dense,
                     const int64_t* __restrict__ group_ptr,
                     const int32_t* __restrict__ win_ids,
                     const int32_t* __restrict__ pos,
                     const uint8_t* __restrict__ lane_valid,
                     const int32_t* __restrict__ slot_cols,
                     float* __restrict__ out, int64_t F,
                     int64_t n_block_rows, int64_t R, int64_t gh,
                     int64_t window, int64_t n_ftiles, int32_t a_plane,
                     int32_t x_plane) {
  using G = Ring<BM, BN, P>;
  constexpr int kRing = G::kStages;
  __shared__ __align__(8) uint64_t full[kRing];
  __shared__ __align__(8) uint64_t empty[kRing];
  extern __shared__ __align__(1024) uint8_t ring_raw[];

  const int64_t lane_id = blockIdx.x / n_ftiles;  // group * R + lane
  const int64_t g = lane_id / R, lane = lane_id % R;
  const int64_t j0 = group_ptr[g];
  int64_t orow;
  if (win_ids != nullptr) {                   // K2: absent lanes store nothing
    if (!lane_valid[lane_id]) return;         // uniform over the CTA
    orow = (int64_t)win_ids[j0] * window + pos[j0 * R + lane];
  } else {                                    // K4: phantom lanes neither
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

  const int wg = threadIdx.x / 128;
  if (wg == G::kConsumers) {
    // The producer: the lane's slots in the walk's order, each slot's
    // BM/64 depth chunks one ring stage each. The next slot's column is
    // read a slot ahead.
    if (threadIdx.x % 128 != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    auto slot = [&](int64_t t) { return ((j0 + t / gh) * R + lane) * gh + t % gh; };
    int32_t col = n_slots > 0 ? __ldg(slot_cols + slot(0)) : 0;
    for (int64_t t = 0; t < n_slots; ++t) {
      const int64_t s = slot(t);
      const int32_t next = t + 1 < n_slots ? __ldg(slot_cols + slot(t + 1)) : 0;
      for (int c = 0; c < BM / kDepth; ++c) {
        mbar_wait(&empty[stage], phase ^ 1);
        const uint32_t a = ring + stage * G::kStageBytes;
        mbar_expect_tx(&full[stage], G::kStageBytes);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load_2d(a + p * G::kABytes, &tm_blocks, &full[stage], c * kDepth,
                      (int32_t)(s * BM) + p * a_plane);
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            tma_load_2d(a + P * G::kABytes + p * G::kXBytes + q * G::kXBox,
                        &tm_dense, &full[stage], (int32_t)(f0 + q * 64),
                        col * BM + c * kDepth + p * x_plane);
        }
        if (++stage == kRing) {
          stage = 0;
          phase ^= 1;
        }
      }
      col = next;
    }
  } else {
    // A consumer warpgroup: rows wg*64 .. wg*64+63 of the tile. The
    // tensor cores sum each stage from zero into `part`, which CUDA cores
    // add to the f32 sums `acc` (the two-level sums of the note above).
    const int wt = threadIdx.x % 128;
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    const int64_t n_chunks = n_slots * (BM / kDepth);
    for (int64_t i = 0; i < n_chunks; ++i) {
      mbar_wait(&full[stage], phase);
      // A: BM rows of 128 bytes, 8-row swizzle atoms 1024 bytes apart;
      // a 16-deep slice is 32 bytes into each row. B: 64-column atoms of
      // 64 rows x 128 bytes, kXBox apart (LBO); 8-row groups 1024 bytes
      // apart (SBO); a 16-deep slice is 16 rows on.
      // K3's stage holds A_hi, A_lo, X_hi, X_lo; its three chains run
      // hi*lo and lo*hi first and hi*hi last, so that the small terms are
      // summed before the large one is added.
      const uint32_t a = ring + stage * G::kStageBytes + wg * 64 * 128;
      const uint32_t x = ring + stage * G::kStageBytes + P * G::kABytes;
      constexpr int kChains = P == 1 ? 1 : 3;
      fence_operands(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int chain = 0; chain < kChains; ++chain) {
        // (A plane, X plane) of this chain: (hi, lo), (lo, hi), (hi, hi)
        const uint32_t ap = a + (chain == 1 ? G::kABytes : 0);
        const uint32_t xp = x + (kChains == 3 && chain == 0 ? G::kXBytes : 0);
#pragma unroll
        for (int k = 0; k < kDepth / 16; ++k)
          Wgmma<BN>::mma(part, sw128_desc(ap + k * 32, 16, 1024),
                         sw128_desc(xp + k * 16 * 128, G::kXBox, 1024),
                         chain > 0 || k > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(part);
      __syncwarp();
      if (wt % 32 == 0) mbar_arrive(&empty[stage]);  // the stage is read
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] += part[j];
      if (++stage == kRing) {
        stage = 0;
        phase ^= 1;
      }
    }
    // The accumulator fragment of m64nNk16: thread wt holds rows
    // (wt/32)*16 + (wt%32)/4 (+8) and columns 8j + 2*(wt%4) (+1).
    const int64_t row0 = orow * BM + wg * 64 + (wt / 32) * 16 + (wt % 32) / 4;
    const int64_t c0 = f0 + 2 * (wt % 4);
    const bool pairs = F % 2 == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int64_t col = c0 + j * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = out + (row0 + 8 * h) * F + col;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (col + 1 < F) {
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            p[1] = v1;
          }
        } else if (col < F) {
          p[0] = v0;
        }
      }
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// A TMA map of a row-major (outer x inner) bf16 matrix, read in boxes of
// (box_outer x 64) with the 128-byte swizzle; out-of-bounds reads are 0.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int64_t inner,
                     int64_t outer, uint32_t box_outer) {
  return tma_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, inner, outer,
                    kDepth, box_outer, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BM, int BN, int P>
cudaError_t launch_ring_tile(const CUtensorMap& tb, const CUtensorMap& td,
                             const int64_t* gp, const int32_t* wi,
                             const int32_t* ps, const uint8_t* lv,
                             const int32_t* sc, float* o, int64_t F,
                             int64_t n_block_rows, int64_t R, int64_t gh,
                             int64_t window, int64_t n_ft, int32_t a_plane,
                             int32_t x_plane, dim3 grid, cudaStream_t stream) {
  using G = Ring<BM, BN, P>;
  // The shared-memory limit is set once per instantiation, before its
  // first launch, on the device current then (a refusal is returned on
  // every launch).
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      bf16_ring_kernel<BM, BN, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmemBytes);
  if (smem_set != cudaSuccess) return smem_set;
  bf16_ring_kernel<BM, BN, P><<<grid, G::kThreads, G::kSmemBytes, stream>>>(
      tb, td, gp, wi, ps, lv, sc, o, F, n_block_rows, R, gh, window, n_ft,
      a_plane, x_plane);
  return cudaGetLastError();
}

// The tensor-core loop over n_lanes lanes of ceil(F / bn) tiles, on
// `planes` planes (1, or 2 for K3). dense is planes x (n_dense_rows, ld)
// bf16 with ld >= F a multiple of 8; blocks hold planes x n_slots (b x b)
// slots. win_ids == nullptr selects K4 (and K1/K5).
cudaError_t launch_ring(const void* group_ptr, const void* win_ids,
                        const void* pos, const void* lane_valid,
                        const void* slot_cols, const void* blocks,
                        const void* dense, void* out, int64_t n_lanes,
                        int64_t n_block_rows, int64_t n_slots,
                        int64_t n_dense_rows, int64_t F, int64_t ld, int64_t R,
                        int64_t gh, int64_t window, int64_t b, int64_t bn,
                        int planes, cudaStream_t stream) {
  if ((bn != 64 && bn != 128) || (planes != 1 && planes != 2) || ld < F ||
      ld % 8 != 0 || planes * n_slots * b > INT32_MAX ||
      planes * n_dense_rows > INT32_MAX || ld > INT32_MAX)
    return cudaErrorInvalidValue;
  const int64_t n_ft = ceil_div(F, bn);
  const int64_t n_ctas = n_lanes * n_ft;
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  if (n_ctas == 0) return cudaSuccess;
  CUtensorMap tb, td;
  if (cudaError_t e = bf16_map(&tb, blocks, b, planes * n_slots * b, (uint32_t)b))
    return e;
  if (cudaError_t e = bf16_map(&td, dense, ld, planes * n_dense_rows, kDepth))
    return e;
  const dim3 grid((unsigned)n_ctas);
  const auto* gp = static_cast<const int64_t*>(group_ptr);
  const auto* wi = static_cast<const int32_t*>(win_ids);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* lv = static_cast<const uint8_t*>(lane_valid);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  auto* o = static_cast<float*>(out);
  const auto a_plane = (int32_t)(n_slots * b), x_plane = (int32_t)n_dense_rows;
#define SDB_RING(BM, BN, P)                                                  \
  if (b == BM && bn == BN && planes == P)                                    \
    return launch_ring_tile<BM, BN, P>(tb, td, gp, wi, ps, lv, sc, o, F,      \
                                       n_block_rows, R, gh, window, n_ft,    \
                                       a_plane, x_plane, grid, stream);
  SDB_RING(64, 64, 1)
  SDB_RING(64, 128, 1)
  SDB_RING(128, 64, 1)
  SDB_RING(128, 128, 1)
  SDB_RING(64, 64, 2)
  SDB_RING(64, 128, 2)
  SDB_RING(128, 64, 2)
  SDB_RING(128, 128, 2)
#undef SDB_RING
  return cudaErrorInvalidValue;
}

// The pipelined FFMA loop over n_lanes lanes of ceil(F / bn) tiles; dense
// is (n_dense_rows, ld) f32 with ld >= F a multiple of 4 and a
// 16-byte-aligned base. win_ids == nullptr selects K4's walk (and K1's
// and K5's). lane_order (n_lanes,) int32 is read by the small instances.
template <int BM, int BN>
cudaError_t launch_pipe_tile(const int64_t* gp, const int32_t* wi,
                             const int32_t* ps, const uint8_t* lv,
                             const int32_t* sc, const int32_t* lo,
                             const float* bl, const float* de, float* o,
                             int64_t F, int64_t ld, int64_t n_block_rows,
                             int64_t R, int64_t gh, int64_t window,
                             int64_t n_ft, dim3 grid, cudaStream_t stream) {
  using G = Pipe<BM, BN>;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      ffma_pipe_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmemBytes);
  if (smem_set != cudaSuccess) return smem_set;
  ffma_pipe_kernel<BM, BN><<<grid, G::kThreads, G::kSmemBytes, stream>>>(
      gp, wi, ps, lv, sc, lo, bl, de, o, F, ld, n_block_rows, R, gh, window,
      n_ft);
  return cudaGetLastError();
}

cudaError_t launch_pipe(const void* group_ptr, const void* win_ids,
                        const void* pos, const void* lane_valid,
                        const void* slot_cols, const void* lane_order,
                        const void* blocks, const void* dense, void* out,
                        int64_t n_lanes, int64_t n_block_rows, int64_t F,
                        int64_t ld, int64_t R, int64_t gh, int64_t window,
                        int64_t b, int64_t bn, cudaStream_t stream) {
  // the instances: bn = 64 and 128 at every b, and 32 at b = 16 and 32,
  // whose walk reads lane_order
  const bool small = b == 16 || b == 32;
  const bool instance = (small || b == 64 || b == 128) &&
                        (bn == 64 || bn == 128 || (small && bn == 32));
  if (!instance || (small && lane_order == nullptr) || ld < F || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dense) % 16 != 0)
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
  const auto* bl = static_cast<const float*>(blocks);
  const auto* de = static_cast<const float*>(dense);
  auto* o = static_cast<float*>(out);
#define SDB_PIPE(BM, BN)                                                     \
  if (b == BM && bn == BN)                                                   \
    return launch_pipe_tile<BM, BN>(gp, wi, ps, lv, sc, lo, bl, de, o, F, ld, \
                                    n_block_rows, R, gh, window, n_ft, grid,   \
                                    stream);
  SDB_PIPE(16, 32)
  SDB_PIPE(16, 64)
  SDB_PIPE(16, 128)
  SDB_PIPE(32, 32)
  SDB_PIPE(32, 64)
  SDB_PIPE(32, 128)
  SDB_PIPE(64, 64)
  SDB_PIPE(64, 128)
  SDB_PIPE(128, 64)
  SDB_PIPE(128, 128)
#undef SDB_PIPE
  return cudaErrorInvalidValue;
}

// K3's operand split: x (N, F) f32, any 4-byte alignment, into out (2N,
// ld) bf16, rows 0 .. N-1 hi = bf16_rn(x) and rows N .. 2N-1 lo =
// bf16_rn(x - hi) (x - hi is exact in f32), columns F .. ld-1 zero. One
// thread per pair of columns: two f32 reads, two 4-byte bf16x2 stores.
__global__ void __launch_bounds__(256)
    split_bf16_kernel(const float* __restrict__ x,
                      __nv_bfloat162* __restrict__ out, int64_t N, int64_t F,
                      int64_t ld) {
  const int64_t half = ld / 2;
  const int64_t n_pairs = N * half;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_pairs;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / half, c = 2 * (i % half);
    const float v0 = c < F ? x[r * F + c] : 0.f;
    const float v1 = c + 1 < F ? x[r * F + c + 1] : 0.f;
    const __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
    __nv_bfloat162 hi, lo;
    hi.x = h0;
    hi.y = h1;
    lo.x = __float2bfloat16_rn(v0 - __bfloat162float(h0));
    lo.y = __float2bfloat16_rn(v1 - __bfloat162float(h1));
    out[i] = hi;
    out[n_pairs + i] = lo;
  }
}

// The small-block tensor-core loop over n_lanes lanes of ceil(F / bn)
// tiles, on `planes` planes (1, or 2 for K3), at b = 16 and 32. dense is
// planes x (n_dense_rows, ld) bf16 with ld >= F a multiple of 8 and a
// 16-byte-aligned base; blocks hold planes x n_slots (b x b) slots, also
// on 16 bytes. win_ids == nullptr selects K4 (and K1/K5); lane_order
// (n_lanes,) int32, the CTA rows' lanes, may not be null.
template <int BM, int BN, int P>
cudaError_t launch_mma_tile(const int64_t* gp, const int32_t* wi,
                            const int32_t* ps, const uint8_t* lv,
                            const int32_t* sc, const int32_t* lo,
                            const bf16* bl, const bf16* de, float* o, int64_t F,
                            int64_t ld, int64_t n_block_rows, int64_t R,
                            int64_t gh, int64_t window, int64_t n_ft,
                            int64_t a_lo, int64_t x_lo, dim3 grid,
                            cudaStream_t stream) {
  using G = Mma<BM, BN, P>;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      mma_small_kernel<BM, BN, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::kSmemBytes);
  if (smem_set != cudaSuccess) return smem_set;
  mma_small_kernel<BM, BN, P><<<grid, G::kThreads, G::kSmemBytes, stream>>>(
      gp, wi, ps, lv, sc, lo, bl, de, o, F, ld, n_block_rows, R, gh, window,
      n_ft, a_lo, x_lo);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* group_ptr, const void* win_ids,
                       const void* pos, const void* lane_valid,
                       const void* slot_cols, const void* lane_order,
                       const void* blocks, const void* dense, void* out,
                       int64_t n_lanes, int64_t n_block_rows, int64_t n_slots,
                       int64_t n_dense_rows, int64_t F, int64_t ld, int64_t R,
                       int64_t gh, int64_t window, int64_t b, int64_t bn,
                       int planes, cudaStream_t stream) {
  if ((b != 16 && b != 32) || (bn != 32 && bn != 64 && bn != 128) ||
      (planes != 1 && planes != 2) || lane_order == nullptr || ld < F ||
      ld % 8 != 0 || reinterpret_cast<uintptr_t>(dense) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(blocks) % 16 != 0)
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
  const auto* bl = static_cast<const bf16*>(blocks);
  const auto* de = static_cast<const bf16*>(dense);
  auto* o = static_cast<float*>(out);
  const int64_t a_lo = n_slots * b * b, x_lo = n_dense_rows * ld;
#define SDB_MMA(BM, BN, P)                                                    \
  if (b == BM && bn == BN && planes == P)                                     \
    return launch_mma_tile<BM, BN, P>(gp, wi, ps, lv, sc, lo, bl, de, o, F, ld, \
                                      n_block_rows, R, gh, window, n_ft, a_lo, \
                                      x_lo, grid, stream);
  SDB_MMA(16, 32, 1)
  SDB_MMA(16, 64, 1)
  SDB_MMA(16, 128, 1)
  SDB_MMA(32, 32, 1)
  SDB_MMA(32, 64, 1)
  SDB_MMA(32, 128, 1)
  SDB_MMA(16, 32, 2)
  SDB_MMA(16, 64, 2)
  SDB_MMA(16, 128, 2)
  SDB_MMA(32, 32, 2)
  SDB_MMA(32, 64, 2)
  SDB_MMA(32, 128, 2)
#undef SDB_MMA
  return cudaErrorInvalidValue;
}

// f32 K1 and K5: the pipelined FFMA loop on the flat layout's walk,
// which is K4's walk with one lane per group (R = 1, gh = group, group_ptr
// = step_ptr: lane r's slot t is step_ptr[r]*group + t, and every lane is
// a real block-row).
cudaError_t launch_flat_f32(const void* step_ptr, const void* slot_cols,
                            const void* lane_order, const void* blocks,
                            const void* dense, void* out, int64_t n_block_rows,
                            int64_t F, int64_t ld, int64_t group, int64_t b,
                            int64_t bn, cudaStream_t s) {
  return launch_pipe(step_ptr, nullptr, nullptr, nullptr, slot_cols, lane_order,
                     blocks, dense, out, n_block_rows, n_block_rows, F, ld, 1,
                     group, 0, b, bn, s);
}

// The bf16 entries (K1, K2, K4, K5) and K3's (planes = 2): the
// small-block tensor-core loop at b = 16 and 32 (which reads lane_order),
// the tensor-core ring at b = 64 and 128 (packed lane order). Arguments as
// launch_mma's; K1 and K5 pass the flat walk as K4's with R = 1, gh = the
// group and the step pointer as group_ptr.
cudaError_t launch_bf16(const void* group_ptr, const void* win_ids,
                        const void* pos, const void* lane_valid,
                        const void* slot_cols, const void* lane_order,
                        const void* blocks, const void* dense, void* out,
                        int64_t n_lanes, int64_t n_block_rows, int64_t n_slots,
                        int64_t n_dense_rows, int64_t F, int64_t ld, int64_t R,
                        int64_t gh, int64_t window, int64_t b, int64_t bn,
                        int planes, cudaStream_t s) {
  if (b == 16 || b == 32)
    return launch_mma(group_ptr, win_ids, pos, lane_valid, slot_cols, lane_order,
                      blocks, dense, out, n_lanes, n_block_rows, n_slots,
                      n_dense_rows, F, ld, R, gh, window, b, bn, planes, s);
  return launch_ring(group_ptr, win_ids, pos, lane_valid, slot_cols, blocks, dense,
                     out, n_lanes, n_block_rows, n_slots, n_dense_rows, F, ld, R,
                     gh, window, b, bn, planes, s);
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers; the
// stream is the caller's current stream. Returns the cudaError_t of the
// launch (0 on success). The *_bf16 entries take bf16 blocks and dense
// only, the *_bf16x3 entries the two bf16 planes of each, the others
// float only. Every BSR entry takes lane_order, (n_lanes,) int32, the CTA
// rows' lanes, deepest first: read at b = 16 and 32, where a null one is
// refused.

// K1, f32 operands: the pipelined FFMA loop (tiles of bn columns: 64 or
// 128, and 32 too at b = 16 and 32; dense (n, ld) with ld >= F a multiple
// of 4 and a 16-byte-aligned base).
extern "C" int sdb_bsr_spmm_flat(const void* step_ptr, const void* slot_cols,
                                 const void* lane_order, const void* blocks,
                                 const void* dense, void* out,
                                 int64_t n_block_rows, int64_t F, int64_t ld,
                                 int64_t group, int64_t b, int64_t bn,
                                 void* stream) {
  return (int)launch_flat_f32(step_ptr, slot_cols, lane_order, blocks, dense,
                              out, n_block_rows, F, ld, group, b, bn,
                              static_cast<cudaStream_t>(stream));
}

// K1, bf16 operands: as sdb_bsr_spmm_rowgroup_bf16 on the flat layout's
// walk (one lane per block-row, the step pointer as group pointer).
extern "C" int sdb_bsr_spmm_flat_bf16(
    const void* step_ptr, const void* slot_cols, const void* lane_order,
    const void* blocks, const void* dense, void* out, int64_t n_block_rows,
    int64_t n_slots, int64_t n_dense_rows, int64_t F, int64_t ld, int64_t group,
    int64_t b, int64_t bn, void* stream) {
  return (int)launch_bf16(step_ptr, nullptr, nullptr, nullptr, slot_cols,
                          lane_order, blocks, dense, out, n_block_rows,
                          n_block_rows, n_slots, n_dense_rows, F, ld, 1, group,
                          0, b, bn, 1, static_cast<cudaStream_t>(stream));
}

// K3 on K1's layout: the arguments of sdb_bsr_spmm_flat_bf16, with the
// blocks' two bf16 planes (n_slots b x b slots of hi, then as many of lo)
// and the operand's ((n_dense_rows, ld) of hi, then of lo; ld >= F a
// multiple of 8).
extern "C" int sdb_bsr_spmm_flat_bf16x3(
    const void* step_ptr, const void* slot_cols, const void* lane_order,
    const void* planes, const void* xp, void* out, int64_t n_block_rows,
    int64_t n_slots, int64_t n_dense_rows, int64_t F, int64_t ld, int64_t group,
    int64_t b, int64_t bn, void* stream) {
  return (int)launch_bf16(step_ptr, nullptr, nullptr, nullptr, slot_cols,
                          lane_order, planes, xp, out, n_block_rows,
                          n_block_rows, n_slots, n_dense_rows, F, ld, 1, group,
                          0, b, bn, 2, static_cast<cudaStream_t>(stream));
}

// K5, f32 operands: K1's f32 launch on the (nbc*b, ld) view of dense3.
extern "C" int sdb_bsr_spmm_resident(const void* step_ptr,
                                     const void* slot_cols,
                                     const void* lane_order,
                                     const void* blocks, const void* dense3,
                                     void* out, int64_t n_block_rows,
                                     int64_t F, int64_t ld, int64_t group,
                                     int64_t b, int64_t bn, void* stream) {
  return (int)launch_flat_f32(step_ptr, slot_cols, lane_order, blocks, dense3,
                              out, n_block_rows, F, ld, group, b, bn,
                              static_cast<cudaStream_t>(stream));
}

// K5, bf16 operands: K1's bf16 launch on the (nbc*b, ld) view of dense3.
extern "C" int sdb_bsr_spmm_resident_bf16(
    const void* step_ptr, const void* slot_cols, const void* lane_order,
    const void* blocks, const void* dense3, void* out, int64_t n_block_rows,
    int64_t n_slots, int64_t n_dense_rows, int64_t F, int64_t ld, int64_t group,
    int64_t b, int64_t bn, void* stream) {
  return sdb_bsr_spmm_flat_bf16(step_ptr, slot_cols, lane_order, blocks, dense3,
                                out, n_block_rows, n_slots, n_dense_rows, F, ld,
                                group, b, bn, stream);
}

// K3 on K5's layout: as sdb_bsr_spmm_flat_bf16x3.
extern "C" int sdb_bsr_spmm_resident_bf16x3(
    const void* step_ptr, const void* slot_cols, const void* lane_order,
    const void* planes, const void* xp, void* out, int64_t n_block_rows,
    int64_t n_slots, int64_t n_dense_rows, int64_t F, int64_t ld, int64_t group,
    int64_t b, int64_t bn, void* stream) {
  return sdb_bsr_spmm_flat_bf16x3(step_ptr, slot_cols, lane_order, planes, xp,
                                  out, n_block_rows, n_slots, n_dense_rows, F,
                                  ld, group, b, bn, stream);
}

// K2, f32 operands: the pipelined FFMA loop on the sorted walk (tiles and
// operand as sdb_bsr_spmm_flat's).
extern "C" int sdb_bsr_spmm_sorted(const void* group_ptr, const void* win_ids,
                                   const void* pos, const void* lane_valid,
                                   const void* slot_cols,
                                   const void* lane_order, const void* blocks,
                                   const void* dense, void* out,
                                   int64_t n_lanes, int64_t F, int64_t ld,
                                   int64_t R, int64_t gh, int64_t window,
                                   int64_t b, int64_t bn, void* stream) {
  if (win_ids == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_pipe(group_ptr, win_ids, pos, lane_valid, slot_cols,
                          lane_order, blocks, dense, out, n_lanes, 0, F, ld, R,
                          gh, window, b, bn, static_cast<cudaStream_t>(stream));
}

// K2, bf16 operands: the small-block tensor-core loop at b = 16 and 32
// (tiles of bn = 32, 64 or 128 columns), the tensor-core ring at b = 64
// and 128 (bn = 64 or 128). dense is (n_dense_rows, ld), ld >= F a
// multiple of 8, on 16 bytes; F is the output's width.
extern "C" int sdb_bsr_spmm_sorted_bf16(
    const void* group_ptr, const void* win_ids, const void* pos,
    const void* lane_valid, const void* slot_cols, const void* lane_order,
    const void* blocks, const void* dense, void* out, int64_t n_lanes,
    int64_t n_slots, int64_t n_dense_rows, int64_t F, int64_t ld, int64_t R,
    int64_t gh, int64_t window, int64_t b, int64_t bn, void* stream) {
  if (win_ids == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_bf16(group_ptr, win_ids, pos, lane_valid, slot_cols,
                          lane_order, blocks, dense, out, n_lanes, 0, n_slots,
                          n_dense_rows, F, ld, R, gh, window, b, bn, 1,
                          static_cast<cudaStream_t>(stream));
}

// K3 on K2's layout: the arguments of sdb_bsr_spmm_sorted_bf16, with the
// two planes (as sdb_bsr_spmm_flat_bf16x3's).
extern "C" int sdb_bsr_spmm_sorted_bf16x3(
    const void* group_ptr, const void* win_ids, const void* pos,
    const void* lane_valid, const void* slot_cols, const void* lane_order,
    const void* planes, const void* xp, void* out, int64_t n_lanes,
    int64_t n_slots, int64_t n_dense_rows, int64_t F, int64_t ld, int64_t R,
    int64_t gh, int64_t window, int64_t b, int64_t bn, void* stream) {
  if (win_ids == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_bf16(group_ptr, win_ids, pos, lane_valid, slot_cols,
                          lane_order, planes, xp, out, n_lanes, 0, n_slots,
                          n_dense_rows, F, ld, R, gh, window, b, bn, 2,
                          static_cast<cudaStream_t>(stream));
}

// K3's operand split (split_bf16_kernel): x (N, F) f32 into out (2N, ld)
// bf16, ld >= F a multiple of 8.
extern "C" int sdb_split_bf16(const void* x, void* out, int64_t N, int64_t F,
                              int64_t ld, void* stream) {
  if (ld < F || ld % 8 != 0) return (int)cudaErrorInvalidValue;
  const int64_t n_pairs = N * (ld / 2);
  if (n_pairs == 0) return (int)cudaSuccess;
  const int64_t n_blocks = ceil_div(n_pairs, 256);
  const unsigned grid = (unsigned)(n_blocks < 65536 * 8 ? n_blocks : 65536 * 8);
  split_bf16_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat162*>(out), N, F,
      ld);
  return (int)cudaGetLastError();
}

// K4, f32 operands: the pipelined FFMA loop on the row-group walk (tiles
// and operand as sdb_bsr_spmm_flat's).
extern "C" int sdb_bsr_spmm_rowgroup(const void* group_ptr,
                                     const void* slot_cols,
                                     const void* lane_order,
                                     const void* blocks, const void* dense,
                                     void* out, int64_t n_lanes,
                                     int64_t n_block_rows, int64_t F,
                                     int64_t ld, int64_t R, int64_t gh,
                                     int64_t b, int64_t bn, void* stream) {
  return (int)launch_pipe(group_ptr, nullptr, nullptr, nullptr, slot_cols,
                          lane_order, blocks, dense, out, n_lanes, n_block_rows,
                          F, ld, R, gh, 0, b, bn,
                          static_cast<cudaStream_t>(stream));
}

// K4, bf16 operands: as sdb_bsr_spmm_sorted_bf16 on the row-group walk.
extern "C" int sdb_bsr_spmm_rowgroup_bf16(
    const void* group_ptr, const void* slot_cols, const void* lane_order,
    const void* blocks, const void* dense, void* out, int64_t n_lanes,
    int64_t n_block_rows, int64_t n_slots, int64_t n_dense_rows, int64_t F,
    int64_t ld, int64_t R, int64_t gh, int64_t b, int64_t bn, void* stream) {
  return (int)launch_bf16(group_ptr, nullptr, nullptr, nullptr, slot_cols,
                          lane_order, blocks, dense, out, n_lanes, n_block_rows,
                          n_slots, n_dense_rows, F, ld, R, gh, 0, b, bn, 1,
                          static_cast<cudaStream_t>(stream));
}
