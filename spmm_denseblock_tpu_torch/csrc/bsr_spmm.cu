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
//   (+ _rowgroup_kernel),
// K5 bsr_spmm_resident replaces
//   spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:_pallas_spmm_resident
//   (+ _resident_kernel),
// K3, the bf16x3 product of spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:
//   _dot3 (precision="high"), is the Bf16x3 math policy below, exported
//   as its own instance of K1, K2 and K5 (the *_bf16x3 entries).
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
// K3 (bf16x3). The TPU runs three bf16 MXU passes, hi*hi + hi*lo +
// lo*hi, and drops lo*lo. Here each f32 element is split once, while it
// is staged into shared memory: hi = bf16_rn(x), lo = bf16_rn(x - hi)
// (round to nearest even, as jnp.astype and torch.to round), both kept
// widened to f32. A product of two bf16 values is exact in f32, so the
// three FFMAs per element compute what the MXU passes compute, up to
// the order of the f32 sums. That is three times K1/K2's FMA work; on
// the TPU bf16x3 halves the passes of exact f32, here it triples them.
// The tensor-core (wgmma) form, where bf16x3 would beat exact f32 on
// this card, is later work.
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
// K5. On the TPU the resident kernel keeps the whole (nbc, b, f_tile)
// operand slice in VMEM and indexes it per slot. Hopper has no 80 MB of
// on-chip memory to hold it, so nothing is kept resident: the layout
// only says which slots a CTA owns, and they are K1's (one block-row's
// steps, through a step pointer). So K5's entries launch K1's kernel on
// K1's packed arrays; they exist so that K5's launches are counted (and
// bound) apart from K1's.
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

// Math policies. Exact: one plane, each value widened to f32, one FFMA
// per product. Bf16x3 (K3): two planes, hi and lo, three FFMAs.
struct Exact {
  static constexpr int kPlanes = 1;
};
struct Bf16x3 {
  static constexpr int kPlanes = 2;
};

// Bf16x3's split of one f32 value: hi = bf16_rn(x), lo = bf16_rn(x - hi),
// both widened back to f32 (x - hi is exact in f32).
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

template <int BM, int P>
struct __align__(16) Smem {
  float a[P][kBK][BM + 4];  // A^T stage: a[p][k][m] = plane p of blk[m][k0 + k]
  float b[P][kBK][kBN];     // operand stage
};

// acc[b x 64 tile] += blk (b x b) @ brow (b x 64, row stride F).
// Thread (tx, ty) owns rows ty*TM .. ty*TM+TM-1, cols tx*4 .. tx*4+3.
template <typename T, int BM, typename M>
__device__ __forceinline__ void slot_fma(const T* __restrict__ blk,
                                         const T* __restrict__ brow,
                                         int64_t F, int n_valid,
                                         Smem<BM, M::kPlanes>& sm,
                                         float (&acc)[BM / 16][4]) {
  constexpr int TM = BM / 16;
  constexpr int P = M::kPlanes;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll 1
  for (int k0 = 0; k0 < BM; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < BM * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int m = e / kBK, kk = e % kBK;
      if constexpr (P == 1) {
        sm.a[0][kk][m] = to_f32(blk[(int64_t)m * BM + k0 + kk]);
      } else {
        split_bf16(to_f32(blk[(int64_t)m * BM + k0 + kk]), sm.a[0][kk][m],
                   sm.a[1][kk][m]);
      }
    }
#pragma unroll
    for (int it = 0; it < kBK * kBN / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int kk = e / kBN, n = e % kBN;
      if constexpr (P == 1) {
        sm.b[0][kk][n] =
            n < n_valid ? to_f32(brow[(int64_t)(k0 + kk) * F + n]) : 0.f;
      } else if (n < n_valid) {
        split_bf16(to_f32(brow[(int64_t)(k0 + kk) * F + n]), sm.b[0][kk][n],
                   sm.b[1][kk][n]);
      } else {
        sm.b[0][kk][n] = sm.b[1][kk][n] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[P][TM], b[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[p][i] = sm.a[p][kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[p][j] = sm.b[p][kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[0][i], b[0][j], acc[i][j]);
          if constexpr (P == 2) {  // hi*lo + lo*hi; lo*lo is dropped
            acc[i][j] = fmaf(a[0][i], b[1][j], acc[i][j]);
            acc[i][j] = fmaf(a[1][i], b[0][j], acc[i][j]);
          }
        }
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

// K1 (and K5, through its own entries): one CTA per (block-row, F
// tile). step_ptr (nbr+1,) gives each row's steps; step s holds slots
// s*group .. s*group+group-1, and slot s reads operand rows col*b ..
// +b-1, i.e. dense viewed as (nbc, b, F) at col. Every row has >= 1 step
// (the plan covers empty rows with a zero block), so every output row is
// written.
template <typename T, int BM, typename M>
__global__ void __launch_bounds__(kThreads)
    flat_kernel(const int64_t* __restrict__ step_ptr,
                const int32_t* __restrict__ slot_cols,
                const T* __restrict__ blocks, const T* __restrict__ dense,
                float* __restrict__ out, int64_t F, int64_t group,
                int64_t n_ftiles) {
  __shared__ Smem<BM, M::kPlanes> sm;
  const int64_t row = blockIdx.x / n_ftiles;
  const int64_t f0 = (blockIdx.x % n_ftiles) * kBN;
  const int n_valid = (int)(F - f0 < kBN ? F - f0 : kBN);
  float acc[BM / 16][4] = {};
  const int64_t s_end = step_ptr[row + 1] * group;
  for (int64_t s = step_ptr[row] * group; s < s_end; ++s) {
    const int64_t col = slot_cols[s];
    slot_fma<T, BM, M>(blocks + s * BM * BM, dense + col * BM * F + f0, F,
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
template <typename T, int BM, typename M>
__global__ void __launch_bounds__(kThreads)
    sorted_kernel(const int64_t* __restrict__ group_ptr,
                  const int32_t* __restrict__ win_ids,
                  const int32_t* __restrict__ pos,
                  const uint8_t* __restrict__ lane_valid,
                  const int32_t* __restrict__ slot_cols,
                  const T* __restrict__ blocks, const T* __restrict__ dense,
                  float* __restrict__ out, int64_t F, int64_t R, int64_t gh,
                  int64_t window, int64_t n_ftiles) {
  __shared__ Smem<BM, M::kPlanes> sm;
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
      slot_fma<T, BM, M>(blocks + s * BM * BM, dense + col * BM * F + f0, F,
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
  __shared__ Smem<BM, 1> sm;
  const int64_t row = blockIdx.x / n_ftiles;  // group * R + lane
  if (row >= n_block_rows) return;            // phantom lane
  const int64_t g = row / R, lane = row % R;
  const int64_t f0 = (blockIdx.x % n_ftiles) * kBN;
  const int n_valid = (int)(F - f0 < kBN ? F - f0 : kBN);
  float acc[BM / 16][4] = {};
  for (int64_t j = group_ptr[g], j1 = group_ptr[g + 1]; j < j1; ++j) {
    for (int64_t s = (j * R + lane) * gh, s_end = s + gh; s < s_end; ++s) {
      const int64_t col = slot_cols[s];
      slot_fma<T, BM, Exact>(blocks + s * BM * BM, dense + col * BM * F + f0,
                             F, n_valid, sm, acc);
    }
  }
  store_tile<BM>(out + row * BM * F + f0, F, n_valid, acc);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The grid of a launch over n_rows CTA rows of ceil(F / 64) F tiles, or
// an error for a grid CUDA cannot take.
cudaError_t tile_grid(int64_t n_rows, int64_t F, int64_t* n_ft, dim3* grid) {
  *n_ft = ceil_div(F, kBN);
  const int64_t n_ctas = n_rows * *n_ft;
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)n_ctas);
  return cudaSuccess;
}

// K1's CTA walk with math policy M; K5's entries launch it too.
template <typename T, typename M>
cudaError_t launch_rows(const void* step_ptr, const void* slot_cols,
                        const void* blocks, const void* dense, void* out,
                        int64_t n_block_rows, int64_t F, int64_t group,
                        int64_t b, cudaStream_t stream) {
  int64_t n_ft;
  dim3 grid;
  if (cudaError_t e = tile_grid(n_block_rows, F, &n_ft, &grid)) return e;
  if (grid.x == 0) return cudaSuccess;
  const auto* sp = static_cast<const int64_t*>(step_ptr);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* bl = static_cast<const T*>(blocks);
  const auto* de = static_cast<const T*>(dense);
  auto* o = static_cast<float*>(out);
  switch (b) {
    case 16: flat_kernel<T, 16, M><<<grid, kThreads, 0, stream>>>(sp, sc, bl, de, o, F, group, n_ft); break;
    case 32: flat_kernel<T, 32, M><<<grid, kThreads, 0, stream>>>(sp, sc, bl, de, o, F, group, n_ft); break;
    case 64: flat_kernel<T, 64, M><<<grid, kThreads, 0, stream>>>(sp, sc, bl, de, o, F, group, n_ft); break;
    case 128: flat_kernel<T, 128, M><<<grid, kThreads, 0, stream>>>(sp, sc, bl, de, o, F, group, n_ft); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename M>
cudaError_t launch_sorted(const void* group_ptr, const void* win_ids,
                          const void* pos, const void* lane_valid,
                          const void* slot_cols, const void* blocks,
                          const void* dense, void* out, int64_t n_lanes,
                          int64_t F, int64_t R, int64_t gh, int64_t window,
                          int64_t b, cudaStream_t stream) {
  int64_t n_ft;
  dim3 grid;
  if (cudaError_t e = tile_grid(n_lanes, F, &n_ft, &grid)) return e;
  if (grid.x == 0) return cudaSuccess;
  const auto* gp = static_cast<const int64_t*>(group_ptr);
  const auto* wi = static_cast<const int32_t*>(win_ids);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* lv = static_cast<const uint8_t*>(lane_valid);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* bl = static_cast<const T*>(blocks);
  const auto* de = static_cast<const T*>(dense);
  auto* o = static_cast<float*>(out);
  switch (b) {
    case 16: sorted_kernel<T, 16, M><<<grid, kThreads, 0, stream>>>(gp, wi, ps, lv, sc, bl, de, o, F, R, gh, window, n_ft); break;
    case 32: sorted_kernel<T, 32, M><<<grid, kThreads, 0, stream>>>(gp, wi, ps, lv, sc, bl, de, o, F, R, gh, window, n_ft); break;
    case 64: sorted_kernel<T, 64, M><<<grid, kThreads, 0, stream>>>(gp, wi, ps, lv, sc, bl, de, o, F, R, gh, window, n_ft); break;
    case 128: sorted_kernel<T, 128, M><<<grid, kThreads, 0, stream>>>(gp, wi, ps, lv, sc, bl, de, o, F, R, gh, window, n_ft); break;
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
  int64_t n_ft;
  dim3 grid;
  if (cudaError_t e = tile_grid(n_lanes, F, &n_ft, &grid)) return e;
  if (grid.x == 0) return cudaSuccess;
  const auto* gp = static_cast<const int64_t*>(group_ptr);
  const auto* sc = static_cast<const int32_t*>(slot_cols);
  const auto* bl = static_cast<const T*>(blocks);
  const auto* de = static_cast<const T*>(dense);
  auto* o = static_cast<float*>(out);
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
// blocks and dense; the *_bf16x3 entries (K3) take float only.
extern "C" int sdb_bsr_spmm_flat(const void* step_ptr, const void* slot_cols,
                                 const void* blocks, const void* dense,
                                 void* out, int64_t n_block_rows, int64_t F,
                                 int64_t group, int64_t b, int64_t is_bf16,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_rows<__nv_bfloat16, Exact>(
                             step_ptr, slot_cols, blocks, dense, out,
                             n_block_rows, F, group, b, s)
                       : launch_rows<float, Exact>(
                             step_ptr, slot_cols, blocks, dense, out,
                             n_block_rows, F, group, b, s));
}

extern "C" int sdb_bsr_spmm_flat_bf16x3(const void* step_ptr,
                                        const void* slot_cols,
                                        const void* blocks, const void* dense,
                                        void* out, int64_t n_block_rows,
                                        int64_t F, int64_t group, int64_t b,
                                        void* stream) {
  return (int)launch_rows<float, Bf16x3>(
      step_ptr, slot_cols, blocks, dense, out, n_block_rows, F, group, b,
      static_cast<cudaStream_t>(stream));
}

extern "C" int sdb_bsr_spmm_resident(const void* step_ptr,
                                     const void* slot_cols,
                                     const void* blocks, const void* dense3,
                                     void* out, int64_t n_block_rows,
                                     int64_t F, int64_t group, int64_t b,
                                     int64_t is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_rows<__nv_bfloat16, Exact>(
                             step_ptr, slot_cols, blocks, dense3, out,
                             n_block_rows, F, group, b, s)
                       : launch_rows<float, Exact>(
                             step_ptr, slot_cols, blocks, dense3, out,
                             n_block_rows, F, group, b, s));
}

extern "C" int sdb_bsr_spmm_resident_bf16x3(const void* step_ptr,
                                            const void* slot_cols,
                                            const void* blocks,
                                            const void* dense3, void* out,
                                            int64_t n_block_rows, int64_t F,
                                            int64_t group, int64_t b,
                                            void* stream) {
  return (int)launch_rows<float, Bf16x3>(
      step_ptr, slot_cols, blocks, dense3, out, n_block_rows, F, group, b,
      static_cast<cudaStream_t>(stream));
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
                   ? launch_sorted<__nv_bfloat16, Exact>(
                         group_ptr, win_ids, pos, lane_valid, slot_cols,
                         blocks, dense, out, n_lanes, F, R, gh, window, b, s)
                   : launch_sorted<float, Exact>(
                         group_ptr, win_ids, pos, lane_valid, slot_cols,
                         blocks, dense, out, n_lanes, F, R, gh, window, b, s));
}

extern "C" int sdb_bsr_spmm_sorted_bf16x3(
    const void* group_ptr, const void* win_ids, const void* pos,
    const void* lane_valid, const void* slot_cols, const void* blocks,
    const void* dense, void* out, int64_t n_lanes, int64_t F, int64_t R,
    int64_t gh, int64_t window, int64_t b, void* stream) {
  return (int)launch_sorted<float, Bf16x3>(
      group_ptr, win_ids, pos, lane_valid, slot_cols, blocks, dense, out,
      n_lanes, F, R, gh, window, b, static_cast<cudaStream_t>(stream));
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
