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
// own layout.
//
// K9. On the TPU the resident kernel keeps the whole (nbc, b, f_tile)
// int8 operand slice in VMEM and indexes it per slot, on K6's flat
// layout. Hopper keeps nothing resident (as for K5 in csrc/bsr_spmm.cu):
// K9's entry launches K6's int8_flat_kernel on K6's packed arrays and the
// (nbc*b, F) view of the operand; it exists so that K9's launches are
// counted (and bound) apart from K6's.
//
// Numerics. The TPU multiplies int8 x int8 into int32 on the MXU. Here
// __dp4a multiplies four int8 pairs and adds them into an int32, so a
// slot's product is an exact integer, as on the TPU. f32 FMA of widened
// ints would be exact for one slot (127^2 * 128 < 2^24) but not for
// K7's group-scale lane sum, which reaches 127^2 * 128 * gh (16,516,096
// at gh = 8, 1.6% under 2^24, and past it for a larger explicit group),
// so the lane sum stays in int32. Per-slot scales (K6, K8, K7 without
// group scale): acc += s_slot * float(dot). Group scale (K7):
// acc += s_lane * float(sum of the lane-step's gh dots). The f32 sum is
// multiplied by the column scale cs[f] before the store.
//
// What bounds them on an H100. One slot at b=128, F=512 is 8.4 M
// multiply-adds against 16 KiB of int8 block and 64 KiB of int8 operand;
// with operand tiles shared through L2 by the CTAs of neighbouring rows
// the kernels are bound by the dp4a issue rate (4 multiply-adds per
// instruction), not by HBM. The int8 tensor-core path (wgmma s8) is the
// way past that, and is later work.
//
// Design. As in csrc/bsr_spmm.cu: one CTA owns one (b x 64) output tile
// for its life, stages each slot's block (transposed) and operand tile
// through shared memory in depth chunks of up to 32 int8 packed 4 to a
// 32-bit word, keeps int32 slot (or lane-step) sums and f32 tile sums in
// registers (b/16 x 4 each per thread), and stores once. No atomics, so
// results are deterministic. The F edge is masked in the kernel; offsets
// are 64-bit. Block words are aligned 32-bit loads (the wrapper checks
// that the blocks start 16-byte aligned).

#include <cuda_runtime.h>
#include <stdint.h>

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

// K6: one CTA per (block-row, F tile); the flat layout is one lane of
// `group` slots per step, and step_ptr (nbr+1,) gives each row's steps.
// Every row has >= 1 step (the plan covers empty rows with a zero block).
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

// Runs the statement with BM bound to the block size b.
#define SDB_FOR_BLOCK_SIZE(b, ...)                             \
  switch (b) {                                                 \
    case 16: { constexpr int BM = 16; __VA_ARGS__; break; }    \
    case 32: { constexpr int BM = 32; __VA_ARGS__; break; }    \
    case 64: { constexpr int BM = 64; __VA_ARGS__; break; }    \
    case 128: { constexpr int BM = 128; __VA_ARGS__; break; }  \
    default: return cudaErrorInvalidValue;                     \
  }

// K6's and K9's launch: one CTA per (block-row, F tile) of the flat
// layout.
cudaError_t launch_flat(const void* step_ptr, const void* slot_cols,
                        const void* qblocks, const void* scales,
                        const void* qdense, const void* cs, void* out,
                        int64_t n_block_rows, int64_t F, int64_t group,
                        int64_t b, cudaStream_t s) {
  int64_t n_ft;
  dim3 grid;
  cudaError_t err = grid_for(n_block_rows, F, &n_ft, &grid);
  if (err != cudaSuccess) return err;
  if (grid.x == 0) return cudaSuccess;
  SDB_FOR_BLOCK_SIZE(b, int8_flat_kernel<BM><<<grid, kThreads, 0, s>>>(
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
extern "C" int sdb_bsr_spmm_int8_flat(const void* step_ptr,
                                      const void* slot_cols,
                                      const void* qblocks, const void* scales,
                                      const void* qdense, const void* cs,
                                      void* out, int64_t n_block_rows,
                                      int64_t F, int64_t group, int64_t b,
                                      void* stream) {
  return (int)launch_flat(step_ptr, slot_cols, qblocks, scales, qdense, cs,
                          out, n_block_rows, F, group, b,
                          static_cast<cudaStream_t>(stream));
}

// K9: K6's kernel; qdense3 is the (nbc, b, F) operand, contiguous, read
// as its (nbc*b, F) view.
extern "C" int sdb_bsr_spmm_int8_resident(const void* step_ptr,
                                          const void* slot_cols,
                                          const void* qblocks,
                                          const void* scales,
                                          const void* qdense3, const void* cs,
                                          void* out, int64_t n_block_rows,
                                          int64_t F, int64_t group, int64_t b,
                                          void* stream) {
  return (int)launch_flat(step_ptr, slot_cols, qblocks, scales, qdense3, cs,
                          out, n_block_rows, F, group, b,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int sdb_bsr_spmm_int8_sorted(
    const void* group_ptr, const void* win_ids, const void* pos,
    const void* lane_valid, const void* slot_cols, const void* qblocks,
    const void* scales, const void* qdense, const void* cs, void* out,
    int64_t n_lanes, int64_t F, int64_t R, int64_t gh, int64_t window,
    int64_t b, int64_t group_scale, void* stream) {
  int64_t n_ft;
  dim3 grid;
  cudaError_t err = grid_for(n_lanes, F, &n_ft, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid.x == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
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
    SDB_FOR_BLOCK_SIZE(b, int8_sorted_kernel<BM, true><<<grid, kThreads, 0, s>>>(
        gp, wi, ps, lv, sc, qb, sl, qd, cv, o, F, R, gh, window, n_ft))
  } else {
    SDB_FOR_BLOCK_SIZE(b, int8_sorted_kernel<BM, false><<<grid, kThreads, 0, s>>>(
        gp, wi, ps, lv, sc, qb, sl, qd, cv, o, F, R, gh, window, n_ft))
  }
  return (int)cudaGetLastError();
}

extern "C" int sdb_bsr_spmm_int8_rowgroup(
    const void* group_ptr, const void* slot_cols, const void* qblocks,
    const void* scales, const void* qdense, const void* cs, void* out,
    int64_t n_lanes, int64_t n_block_rows, int64_t F, int64_t R, int64_t gh,
    int64_t b, void* stream) {
  int64_t n_ft;
  dim3 grid;
  cudaError_t err = grid_for(n_lanes, F, &n_ft, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid.x == 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  SDB_FOR_BLOCK_SIZE(b, int8_rowgroup_kernel<BM><<<grid, kThreads, 0, s>>>(
      static_cast<const int64_t*>(group_ptr),
      static_cast<const int32_t*>(slot_cols),
      static_cast<const int8_t*>(qblocks), static_cast<const float*>(scales),
      static_cast<const int8_t*>(qdense), static_cast<const float*>(cs),
      static_cast<float*>(out), n_block_rows, F, R, gh, n_ft))
  return (int)cudaGetLastError();
}
