// Hand-written Hopper (sm_90a) kernel for the CSR SpMM plan,
// C[n_rows, F] (f32) = A (element-sparse CSR, f32 values) @ X[K, F] (f32).
//
// K10 csr_spmm replaces the TPU kernel
//   spmm_denseblock_tpu/ops/csr_spmm_pallas.py:_pallas_segment_matmul
//   (+ _seg_kernel).
// It reads the JAX packer's band layout unchanged (cols and vals padded
// per band of R rows to a multiple of C slots), through the port's
// row_ptr: row r's nonzeros are slots row_ptr[r] .. row_ptr[r] + deg - 1,
// deg = indptr[r+1] - indptr[r]. The pad dummies lie outside every span
// and are never read.
//
// What the TPU kernel does, and why this one does not. XLA gathers
// G = X[cols] for every padded slot into device memory, and per chunk of
// C slots the kernel builds the selector S[r, c] = val[c] * [row[c] == r]
// and adds S @ G (R x C by C x F) to its band on the MXU: R*2 flops per
// nonzero and column, spent to turn a scatter into a matmul. Hopper has
// no such need: a warp can own an output row and sum it in registers.
//
// Design (a row split, the idea of GE-SpMM, rewritten). The plan cuts
// each row's span into segments of at most SEGMENT_NNZ (512) slots; an
// empty row is one empty segment. One warp per (segment, F tile of 256
// columns); the lanes own the tile's columns, lane l the columns l*V +
// 32*V*j (V = 4 with float4 loads when F % 4 == 0 and X and C are 16-byte
// aligned, else V = 1), so each gathered row of X is read by the warp in
// 128-byte (or 512-byte) coalesced pieces. The segment's (col, val)
// pairs are read 32 at a time, one per lane, coalesced, and broadcast
// with __shfl_sync; each pair is one FFMA per column into f32 sums kept
// in registers (8 per lane), in the row's order. Each batch of 32 pairs
// sums apart and is then added into the segment's total. A row of one
// segment stores its total (0 if empty) straight into C; the segments of
// a longer row store partial rows into scratch, and a second kernel adds
// each such row's partials in segment order and stores it. Segments keep
// the warps' work even: the ogbl-ddi stand-in's rows hold 498 nonzeros
// on average but up to 61,693 (duplicate edges kept), and one warp per
// row would wait on that row alone. The sums stay short: with one
// running f32 sum per row the kernel was 3.4e-5 from a float64 sum on
// ddi (H100), with the batched sums 1.9e-7. No atomics:
// results are deterministic. Offsets (col * F, row * F) are 64-bit.
//
// What bounds it on an H100. 2*nnz*F FLOP of FFMA (67 TFLOP/s) against
// the gathers of X's rows: every nonzero reads a row of X (4*F bytes)
// from L2 or device memory. At ogbl-ddi (4,267 rows, 2.1 M nonzeros,
// F=256) the FFMA bound is 16 us and X (4.4 MB) stays in the 50 MB L2, so
// the L2 gather rate bounds the kernel. At the reference's test_csrmm
// shape (2^17 rows, 34.4 M nonzeros, F=512) X is 268 MB: the ~70 GB of
// row reads come mostly from device memory. Tiling rows so that a CTA
// reuses X's rows in shared memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kTileF = 256;             // output columns per warp

template <int V>
__device__ __forceinline__ void fma_row(float (&acc)[kTileF / 32], float v,
                                        const float* __restrict__ xr,
                                        int64_t n_valid, int lane) {
#pragma unroll
  for (int j = 0; j < kTileF / (32 * V); ++j) {
    const int64_t f = (int64_t)(32 * j + lane) * V;
    if (f >= n_valid) continue;  // with V = 4, n_valid % 4 == 0
    if constexpr (V == 4) {
      const float4 x = *reinterpret_cast<const float4*>(xr + f);
      acc[4 * j + 0] += v * x.x;
      acc[4 * j + 1] += v * x.y;
      acc[4 * j + 2] += v * x.z;
      acc[4 * j + 3] += v * x.w;
    } else {
      acc[j] += v * xr[f];
    }
  }
}

// row[f0 ..] = acc, the lane's columns of the tile.
template <int V>
__device__ __forceinline__ void store_row(float* __restrict__ row, int64_t f0,
                                          int64_t n_valid, int lane,
                                          const float (&acc)[kTileF / 32]) {
  float* o = row + f0;
#pragma unroll
  for (int j = 0; j < kTileF / (32 * V); ++j) {
    const int64_t f = (int64_t)(32 * j + lane) * V;
    if (f >= n_valid) continue;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(o + f) =
          make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      o[f] = acc[j];
    }
  }
}

// One (segment, F tile) per warp: the segment's sum, stored at row dest of
// C (dest >= 0) or at row -dest - 1 of the scratch of partial rows.
template <int V>
__global__ void __launch_bounds__(kThreads)
    csr_segment_kernel(const int64_t* __restrict__ seg_start,
                       const int64_t* __restrict__ seg_end,
                       const int64_t* __restrict__ seg_dest,
                       const int32_t* __restrict__ cols,
                       const float* __restrict__ vals,
                       const float* __restrict__ x, float* __restrict__ out,
                       float* __restrict__ partial, int64_t n_seg, int64_t F,
                       int64_t n_ftiles) {
  const int lane = threadIdx.x % 32;
  const int64_t task = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= n_seg * n_ftiles) return;  // uniform over the warp
  const int64_t seg = task / n_ftiles;
  const int64_t f0 = (task % n_ftiles) * kTileF;
  const int64_t n_valid = F - f0 < kTileF ? F - f0 : kTileF;
  const int64_t s0 = seg_start[seg], s1 = seg_end[seg];
  float acc[kTileF / 32] = {};
  for (int64_t base = s0; base < s1; base += 32) {
    const int n = (int)(s1 - base < 32 ? s1 - base : 32);
    float part[kTileF / 32] = {};
    int32_t c = 0;
    float v = 0.f;
    if (lane < n) {
      c = cols[base + lane];
      v = vals[base + lane];
    }
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const int64_t ck = __shfl_sync(0xffffffffu, c, k);
      const float vk = __shfl_sync(0xffffffffu, v, k);
      fma_row<V>(part, vk, x + ck * F + f0, n_valid, lane);
    }
#pragma unroll
    for (int i = 0; i < kTileF / 32; ++i) acc[i] += part[i];
  }
  const int64_t dest = seg_dest[seg];
  store_row<V>(dest >= 0 ? out + dest * F : partial + (-dest - 1) * F, f0,
               n_valid, lane, acc);
}

// One (split row, F tile) per warp: C[row] = the sum of its partial rows
// partial[part_ptr[h] .. part_ptr[h+1] - 1], in segment order.
template <int V>
__global__ void __launch_bounds__(kThreads)
    csr_reduce_kernel(const int64_t* __restrict__ split_row,
                      const int64_t* __restrict__ part_ptr,
                      const float* __restrict__ partial,
                      float* __restrict__ out, int64_t n_split, int64_t F,
                      int64_t n_ftiles) {
  const int lane = threadIdx.x % 32;
  const int64_t task = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= n_split * n_ftiles) return;
  const int64_t h = task / n_ftiles;
  const int64_t f0 = (task % n_ftiles) * kTileF;
  const int64_t n_valid = F - f0 < kTileF ? F - f0 : kTileF;
  float acc[kTileF / 32] = {};
  for (int64_t p = part_ptr[h]; p < part_ptr[h + 1]; ++p)
    fma_row<V>(acc, 1.0f, partial + p * F + f0, n_valid, lane);
  store_row<V>(out + split_row[h] * F, f0, n_valid, lane, acc);
}

int64_t n_ctas_for(int64_t n_tasks) { return (n_tasks + kWarps - 1) / kWarps; }

template <int V>
cudaError_t launch(const int64_t* ss, const int64_t* se, const int64_t* sd,
                   const int32_t* c, const float* v, const float* x, float* o,
                   float* partial, const int64_t* split_row,
                   const int64_t* part_ptr, int64_t n_seg, int64_t n_split,
                   int64_t F, int64_t n_ft, cudaStream_t s) {
  csr_segment_kernel<V><<<(unsigned)n_ctas_for(n_seg * n_ft), kThreads, 0, s>>>(
      ss, se, sd, c, v, x, o, partial, n_seg, F, n_ft);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return err;
  csr_reduce_kernel<V><<<(unsigned)n_ctas_for(n_split * n_ft), kThreads, 0, s>>>(
      split_row, part_ptr, partial, o, n_split, F, n_ft);
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers; the
// stream is the caller's current stream. seg_start, seg_end, seg_dest
// (n_seg,), split_row (n_split,) and part_ptr (n_split + 1,) are int64;
// partial is (part_ptr[n_split], F) f32 scratch (unused when n_split is
// 0). Launches the segment kernel, then the reduction if any row is
// split; returns the first cudaError_t (0 on success; nothing is
// launched for an empty output).
extern "C" int sdb_csr_spmm(const void* seg_start, const void* seg_end,
                            const void* seg_dest, const void* cols,
                            const void* vals, const void* dense, void* out,
                            void* partial, const void* split_row,
                            const void* part_ptr, int64_t n_seg,
                            int64_t n_split, int64_t F, void* stream) {
  if (n_seg <= 0 || F <= 0) return (int)cudaSuccess;
  const int64_t n_ft = (F + kTileF - 1) / kTileF;
  if (n_ctas_for(n_seg * n_ft) > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  const auto* ss = static_cast<const int64_t*>(seg_start);
  const auto* se = static_cast<const int64_t*>(seg_end);
  const auto* sd = static_cast<const int64_t*>(seg_dest);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const float*>(vals);
  const auto* x = static_cast<const float*>(dense);
  auto* o = static_cast<float*>(out);
  auto* pt = static_cast<float*>(partial);
  const auto* sr = static_cast<const int64_t*>(split_row);
  const auto* pp = static_cast<const int64_t*>(part_ptr);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(pt) % 16 == 0;
  return (int)(vec4 ? launch<4>(ss, se, sd, c, v, x, o, pt, sr, pp, n_seg,
                                n_split, F, n_ft, s)
                    : launch<1>(ss, se, sd, c, v, x, o, pt, sr, pp, n_seg,
                                n_split, F, n_ft, s));
}
