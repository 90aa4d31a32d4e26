// Hand-written Hopper (sm_90a) kernels for the BSR SpMM plan,
// C[nbr*b, F] (f32) = A (packed b x b blocks) @ dense[nbc*b, F].
//
// K1 bsr_spmm_flat replaces the TPU kernel
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:_pallas_spmm (+ _kernel),
// K2 bsr_spmm_sorted replaces
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:_pallas_spmm_rowgroup_sorted
//   (+ _rowgroup_sorted_kernel),
// K4 bsr_spmm_rowgroup replaces
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:_pallas_spmm_rowgroup
//   (+ _rowgroup_kernel).
// All read the packed arrays of the JAX packers unchanged (plus the
// row/group step pointers and the K2 lane-valid mask the port's packer
// adds) and compute what the TPU kernels compute on them.
//
// What bounds them on an H100. One slot is 2*b*b*F FLOP against b*b
// block values plus b*F operand values: at b=128, F=512 that is 16.8
// MFLOP per 64 KiB of f32 block and 256 KiB of operand, about 50
// FLOP/byte, so with operand tiles shared through L2 by the CTAs of
// neighbouring rows an FFMA kernel is bound by the f32 FMA rate, not by
// HBM. The f32 tier must meet a 1e-4 gate against an f64 oracle, so the
// products run in FFMA on CUDA cores, never in TF32 tensor cores. bf16
// operands are widened to f32 while staged: a bf16 x bf16 product is
// exact in f32, so the bf16 tier is bf16 products with an f32 sum, as on
// the TPU.
//
// Design. On the TPU the grid runs in order and the output tile stays in
// VMEM across the steps that revisit it. Here CTAs run in no order, so
// one CTA owns one (b x 64) output tile for its whole life: it walks the
// slots that feed that tile, stages each slot's block (transposed) and
// operand tile through shared memory in depth chunks of 16, keeps the
// tile's accumulators in registers (b/16 x 4 per thread) and stores once.
// No atomics, so results are deterministic. The F edge is masked here;
// the F tiles of one row are adjacent in launch order so they share the
// block reads in L2. Offsets into blocks and dense are 64-bit.
//
// A simple, right kernel comes first: no wgmma, TMA or software
// pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBN = 64;        // output columns per CTA
constexpr int kBK = 16;        // depth of one shared-memory stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int BM>
struct __align__(16) Smem {
  float a[kBK][BM + 4];  // A^T stage: a[k][m] = blk[m][k0 + k]
  float b[kBK][kBN];     // operand stage
};

// acc[b x 64 tile] += blk (b x b) @ brow (b x 64, row stride F).
// Thread (tx, ty) owns rows ty*TM .. ty*TM+TM-1, cols tx*4 .. tx*4+3.
template <typename T, int BM>
__device__ __forceinline__ void slot_fma(const T* __restrict__ blk,
                                         const T* __restrict__ brow,
                                         int64_t F, int n_valid,
                                         Smem<BM>& sm,
                                         float (&acc)[BM / 16][4]) {
  constexpr int TM = BM / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll 1
  for (int k0 = 0; k0 < BM; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < BM * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int m = e / kBK, kk = e % kBK;
      sm.a[kk][m] = to_f32(blk[(int64_t)m * BM + k0 + kk]);
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int kk = e / kBN, n = e % kBN;
      sm.b[kk][n] =
          n < n_valid ? to_f32(brow[(int64_t)(k0 + kk) * F + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.a[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int BM>
__device__ __forceinline__ void store_tile(float* __restrict__ out, int64_t F,
                                           int n_valid,
                                           float (&acc)[BM / 16][4]) {
  constexpr int TM = BM / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx * 4 + j;
      if (n < n_valid) out[(int64_t)(ty * TM + i) * F + n] = acc[i][j];
    }
}

// K1: one CTA per (block-row, F tile). step_ptr (nbr+1,) gives each
// row's steps; step s holds slots s*group .. s*group+group-1. Every row
// has >= 1 step (the plan covers empty rows with a zero block), so every
// output row is written.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    flat_kernel(const int64_t* __restrict__ step_ptr,
                const int32_t* __restrict__ slot_cols,
                const T* __restrict__ blocks, const T* __restrict__ dense,
                float* __restrict__ out, int64_t F, int64_t group,
                int64_t n_ftiles) {
  __shared__ Smem<BM> sm;
  const int64_t row = blockIdx.x / n_ftiles;
  const int64_t f0 = (blockIdx.x % n_ftiles) * kBN;
  const int n_valid = (int)(F - f0 < kBN ? F - f0 : kBN);
  float acc[BM / 16][4] = {};
  const int64_t s_end = step_ptr[row + 1] * group;
  for (int64_t s = step_ptr[row] * group; s < s_end; ++s) {
    const int64_t col = slot_cols[s];
    slot_fma<T, BM>(blocks + s * BM * BM, dense + col * BM * F + f0, F,
                    n_valid, sm, acc);
  }
  store_tile<BM>(out + row * BM * F + f0, F, n_valid, acc);
}

// K2: one CTA per (group, lane, F tile). group_ptr (n_groups+1,) gives
// each group's steps; lane r of step j holds slots j*R*gh + r*gh ..
// +gh-1, and its sum belongs to block-row win_ids[j]*window +
// pos[j*R + r] (the same for every step of the group). Absent lanes
// (lane_valid == 0: window padding, whose pos is 0) store nothing, so
// they can never overwrite the real row at position 0.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    sorted_kernel(const int64_t* __restrict__ group_ptr,
                  const int32_t* __restrict__ win_ids,
                  const int32_t* __restrict__ pos,
                  const uint8_t* __restrict__ lane_valid,
                  const int32_t* __restrict__ slot_cols,
                  const T* __restrict__ blocks, const T* __restrict__ dense,
                  float* __restrict__ out, int64_t F, int64_t R, int64_t gh,
                  int64_t window, int64_t n_ftiles) {
  __shared__ Smem<BM> sm;
  const int64_t lane_id = blockIdx.x / n_ftiles;  // group * R + lane
  if (!lane_valid[lane_id]) return;               // uniform over the CTA
  const int64_t g = lane_id / R, lane = lane_id % R;
  const int64_t f0 = (blockIdx.x % n_ftiles) * kBN;
  const int n_valid = (int)(F - f0 < kBN ? F - f0 : kBN);
  const int64_t j0 = group_ptr[g], j1 = group_ptr[g + 1];
  const int64_t orow = (int64_t)win_ids[j0] * window + pos[j0 * R + lane];
  float acc[BM / 16][4] = {};
  for (int64_t j = j0; j < j1; ++j) {
    for (int64_t s = (j * R + lane) * gh, s_end = s + gh; s < s_end; ++s) {
      const int64_t col = slot_cols[s];
      slot_fma<T, BM>(blocks + s * BM * BM, dense + col * BM * F + f0, F,
                      n_valid, sm, acc);
    }
  }
  store_tile<BM>(out + orow * BM * F + f0, F, n_valid, acc);
}

// K4: one CTA per (lane, F tile) of the consecutive row-group layout.
// Lane r of group g is block-row g*R + r; group_ptr (n_groups+1,) gives
// the group's steps, and lane r of step j holds slots (j*R + r)*gh ..
// +gh-1. On the TPU all R lanes share one (R*b x F) output tile; here
// each lane is its own CTA, so no lane waits for a deeper one. The
// packer pads the last group to R lanes: a phantom lane (row >=
// n_block_rows) has only zero slots and no row of the output to own, so
// it returns before any work and stores nothing.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    rowgroup_kernel(const int64_t* __restrict__ group_ptr,
                    const int32_t* __restrict__ slot_cols,
                    const T* __restrict__ blocks, const T* __restrict__ dense,
                    float* __restrict__ out, int64_t n_block_rows, int64_t F,
                    int64_t R, int64_t gh, int64_t n_ftiles) {
  __shared__ Smem<BM> sm;
  const int64_t row = blockIdx.x / n_ftiles;  // group * R + lane
  if (row >= n_block_rows) return;            // phantom lane
  const int64_t g = row / R, lane = row % R;
  const int64_t f0 = (blockIdx.x % n_ftiles) * kBN;
  const int n_valid = (int)(F - f0 < kBN ? F - f0 : kBN);
  float acc[BM / 16][4] = {};
  for (int64_t j = group_ptr[g], j1 = group_ptr[g + 1]; j < j1; ++j) {
    for (int64_t s = (j * R + lane) * gh, s_end = s + gh; s < s_end; ++s) {
      const int64_t col = slot_cols[s];
      slot_fma<T, BM>(blocks + s * BM * BM, dense + col * BM * F + f0, F,
                      n_valid, sm, acc);
    }
  }
  store_tile<BM>(out + row * BM * F + f0, F, n_valid, acc);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t launch_flat(const void* step_ptr, const void* slot_cols,
                        const void* blocks, const void* dense, void* out,
                        int64_t n_block_rows, int64_t F, int64_t group,
                        int64_t b, cudaStream_t stream) {
  const int64_t n_ft = ceil_div(F, kBN);
  const int64_t n_ctas = n_block_rows * n_ft;
  if (n_ctas == 0) return cudaSuccess;
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  const auto* sp = static_cast<const int64_t*>(step_ptr);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* bl = static_cast<const T*>(blocks);
  const auto* de = static_cast<const T*>(dense);
  auto* o = static_cast<float*>(out);
  const dim3 grid((unsigned)n_ctas);
  switch (b) {
    case 16: flat_kernel<T, 16><<<grid, kThreads, 0, stream>>>(sp, sc, bl, de, o, F, group, n_ft); break;
    case 32: flat_kernel<T, 32><<<grid, kThreads, 0, stream>>>(sp, sc, bl, de, o, F, group, n_ft); break;
    case 64: flat_kernel<T, 64><<<grid, kThreads, 0, stream>>>(sp, sc, bl, de, o, F, group, n_ft); break;
    case 128: flat_kernel<T, 128><<<grid, kThreads, 0, stream>>>(sp, sc, bl, de, o, F, group, n_ft); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sorted(const void* group_ptr, const void* win_ids,
                          const void* pos, const void* lane_valid,
                          const void* slot_cols, const void* blocks,
                          const void* dense, void* out, int64_t n_lanes,
                          int64_t F, int64_t R, int64_t gh, int64_t window,
                          int64_t b, cudaStream_t stream) {
  const int64_t n_ft = ceil_div(F, kBN);
  const int64_t n_ctas = n_lanes * n_ft;
  if (n_ctas == 0) return cudaSuccess;
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  const auto* gp = static_cast<const int64_t*>(group_ptr);
  const auto* wi = static_cast<const int32_t*>(win_ids);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* lv = static_cast<const uint8_t*>(lane_valid);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* bl = static_cast<const T*>(blocks);
  const auto* de = static_cast<const T*>(dense);
  auto* o = static_cast<float*>(out);
  const dim3 grid((unsigned)n_ctas);
  switch (b) {
    case 16: sorted_kernel<T, 16><<<grid, kThreads, 0, stream>>>(gp, wi, ps, lv, sc, bl, de, o, F, R, gh, window, n_ft); break;
    case 32: sorted_kernel<T, 32><<<grid, kThreads, 0, stream>>>(gp, wi, ps, lv, sc, bl, de, o, F, R, gh, window, n_ft); break;
    case 64: sorted_kernel<T, 64><<<grid, kThreads, 0, stream>>>(gp, wi, ps, lv, sc, bl, de, o, F, R, gh, window, n_ft); break;
    case 128: sorted_kernel<T, 128><<<grid, kThreads, 0, stream>>>(gp, wi, ps, lv, sc, bl, de, o, F, R, gh, window, n_ft); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rowgroup(const void* group_ptr, const void* slot_cols,
                            const void* blocks, const void* dense, void* out,
                            int64_t n_lanes, int64_t n_block_rows, int64_t F,
                            int64_t R, int64_t gh, int64_t b,
                            cudaStream_t stream) {
  const int64_t n_ft = ceil_div(F, kBN);
  const int64_t n_ctas = n_lanes * n_ft;
  if (n_ctas == 0) return cudaSuccess;
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  const auto* gp = static_cast<const int64_t*>(group_ptr);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* bl = static_cast<const T*>(blocks);
  const auto* de = static_cast<const T*>(dense);
  auto* o = static_cast<float*>(out);
  const dim3 grid((unsigned)n_ctas);
  switch (b) {
    case 16: rowgroup_kernel<T, 16><<<grid, kThreads, 0, stream>>>(gp, sc, bl, de, o, n_block_rows, F, R, gh, n_ft); break;
    case 32: rowgroup_kernel<T, 32><<<grid, kThreads, 0, stream>>>(gp, sc, bl, de, o, n_block_rows, F, R, gh, n_ft); break;
    case 64: rowgroup_kernel<T, 64><<<grid, kThreads, 0, stream>>>(gp, sc, bl, de, o, n_block_rows, F, R, gh, n_ft); break;
    case 128: rowgroup_kernel<T, 128><<<grid, kThreads, 0, stream>>>(gp, sc, bl, de, o, n_block_rows, F, R, gh, n_ft); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers; the
// stream is the caller's current stream. Returns the cudaError_t of the
// launch (0 on success). is_bf16 selects __nv_bfloat16 over float for
// blocks and dense.
extern "C" int sdb_bsr_spmm_flat(const void* step_ptr, const void* slot_cols,
                                 const void* blocks, const void* dense,
                                 void* out, int64_t n_block_rows, int64_t F,
                                 int64_t group, int64_t b, int64_t is_bf16,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_flat<__nv_bfloat16>(step_ptr, slot_cols,
                                                    blocks, dense, out,
                                                    n_block_rows, F, group, b, s)
                       : launch_flat<float>(step_ptr, slot_cols, blocks,
                                            dense, out, n_block_rows, F,
                                            group, b, s));
}

extern "C" int sdb_bsr_spmm_sorted(const void* group_ptr, const void* win_ids,
                                   const void* pos, const void* lane_valid,
                                   const void* slot_cols, const void* blocks,
                                   const void* dense, void* out,
                                   int64_t n_lanes, int64_t F, int64_t R,
                                   int64_t gh, int64_t window, int64_t b,
                                   int64_t is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch_sorted<__nv_bfloat16>(group_ptr, win_ids, pos,
                                                  lane_valid, slot_cols,
                                                  blocks, dense, out, n_lanes,
                                                  F, R, gh, window, b, s)
                   : launch_sorted<float>(group_ptr, win_ids, pos, lane_valid,
                                          slot_cols, blocks, dense, out,
                                          n_lanes, F, R, gh, window, b, s));
}

extern "C" int sdb_bsr_spmm_rowgroup(const void* group_ptr,
                                     const void* slot_cols,
                                     const void* blocks, const void* dense,
                                     void* out, int64_t n_lanes,
                                     int64_t n_block_rows, int64_t F,
                                     int64_t R, int64_t gh, int64_t b,
                                     int64_t is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch_rowgroup<__nv_bfloat16>(group_ptr, slot_cols,
                                                    blocks, dense, out,
                                                    n_lanes, n_block_rows, F,
                                                    R, gh, b, s)
                   : launch_rowgroup<float>(group_ptr, slot_cols, blocks,
                                            dense, out, n_lanes,
                                            n_block_rows, F, R, gh, b, s));
}
