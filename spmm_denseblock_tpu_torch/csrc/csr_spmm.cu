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
// empty row is one empty segment. A group of lanes owns one (segment,
// F tile); lane l of the group owns the tile's columns l*V + L*V*j (V = 4
// with float4 loads when F % 4 == 0 and X, C and the scratch are 16-byte
// aligned, else V = 1), so each gathered row of X is read by the group
// in coalesced pieces. The segment's (col, val) pairs are read in batches
// of 32, one per lane of the group at a time (coalesced), and broadcast
// with __shfl_sync; each pair is one FFMA per column into f32 sums kept
// in registers, in the row's order. Four pairs' rows of X are loaded
// before their FFMAs, so each lane keeps four gathers in flight. Each
// batch of 32 pairs sums apart and is then added into the segment's
// total. A row of one segment stores its total (0 if empty) straight into
// C; the segments of a longer row store partial rows into scratch, and a
// second kernel adds each such row's partials in segment order and
// stores it. Segments keep the warps' work even: the ogbl-ddi stand-in's
// rows hold 498 nonzeros on average but up to 61,693 (duplicate edges
// kept), and one warp per row would wait on that row alone. The sums stay
// short: with one running f32 sum per row the kernel was 3.4e-5 from a
// float64 sum on ddi (H100), with the batched sums 1.9e-7. No atomics:
// results are deterministic. Offsets (col * F, row * F) are 64-bit.
//
// What bounds it on an H100. 2*nnz*F FLOP of FFMA (67 TFLOP/s) against
// the gathers of X's rows: every nonzero reads a row of X (4*F bytes)
// from L2 or device memory. At ogbl-ddi (4,267 rows, 2.1 M nonzeros,
// F=256) the FFMA bound is 16 us and X (4.4 MB) stays in the 50 MB L2, so
// the L2 gather rate bounds the kernel. At the reference's test_csrmm
// shape (2^17 rows, 34.3 M nonzeros, F=512) the gathers are 70 GB and X
// is 268 MB, 5x the L2: walked row by row over all of F, most gathers
// miss L2, and the walk took 19-20 ms (10-11 ms with more gathers in
// flight, at the cost of ddi's occupancy; H100). Tiling rows reuses
// nothing there (random_csr's columns are uniform, so two rows share
// almost no columns); what can be reused is X's columns. So the kernel
// walks X in column strips of W columns (the caller picks W so that a
// K x W strip of X fills about 70% of the L2), strip-major in blockIdx
// order: every segment of strip 0 runs before those of strip 1, and the
// gathers of a strip hit L2. Device memory then reads X once, the (col,
// val) pairs once per strip and C once, and the gathers come from L2
// (9.4 ms at the op shape with W = 64: 70 GB at 7.5 TB/s; W = 32 took
// 9.6 ms). One strip (W >= F; ddi) is a warp per (segment, 256
// columns); several strips are 8 lanes per (segment, 32 columns of a
// strip), so a strip of 64 columns keeps every lane busy with float4
// loads. Each output element sums the same terms in the same order
// whatever W is.
//
// One bf16 pass (precision="default", sdb_csr_spmm_bf16): the TPU kernel
// at jax.lax.Precision.DEFAULT rounds S and G to bf16 and sums f32
// products in f32. The same kernel instanced on bf16 X and bf16 values
// (the plan rounds the values once, each call the operand) computes just
// that: a bf16 value widened to f32 is exact (its bits shifted up 16),
// a product of two such values is exact in f32, and the sums are the f32
// FFMA sums above, in the same order. The partial rows, the reduction and
// C stay f32. Each gather then reads 2*F bytes instead of 4*F, and the
// caller's strips are twice as wide for the same share of the L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 32;              // pairs summed apart
constexpr int kWideTile = 256;          // one strip: columns per warp
constexpr int kStripTile = 32;          // strips: columns per 8 lanes
// CTAs an SM holds, which caps the registers a thread may use. The
// gathers are bound by their latency, so occupancy pays: at the op shape
// the strip loop ran 9.4 ms at 64 registers (4 CTAs), 12.5 ms at 85 (3),
// and spilled at 5 or more (11-33 ms); at 3 CTAs (80 registers) the
// one-strip loop keeps ddi's time (H100).
constexpr int kWideMinCtas = 3;         // one strip
constexpr int kStripMinCtas = 4;        // strips

// bf16 values are carried as their raw bits (uint16_t): widening one to
// f32 puts its bits in the high half of the word, exactly.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}

// V = 4 consecutive elements at p as f32: one 16-byte load of f32 or one
// 8-byte load of bf16 (p aligned to it).
__device__ __forceinline__ void load4(float* d, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
}
__device__ __forceinline__ void load4(float* d, const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  d[0] = __uint_as_float(u.x << 16);  // little-endian: element 0 is low
  d[1] = __uint_as_float(u.x & 0xffff0000u);
  d[2] = __uint_as_float(u.y << 16);
  d[3] = __uint_as_float(u.y & 0xffff0000u);
}

// The lane's N = TILE / L columns of a tile of TILE columns owned by L
// lanes, from row xr (columns f0 ..; f32 or bf16 elements, as f32);
// columns past n_valid read 0.
template <int V, int L, int TILE, typename T>
__device__ __forceinline__ void load_row(float (&xv)[TILE / L],
                                         const T* __restrict__ xr,
                                         int64_t n_valid, int gl) {
#pragma unroll
  for (int j = 0; j < TILE / (L * V); ++j) {
    const int64_t f = (int64_t)(L * j + gl) * V;  // with V = 4, n_valid % 4 == 0
    if constexpr (V == 4) {
      if (f < n_valid) {
        load4(&xv[4 * j], xr + f);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[4 * j + i] = 0.f;
      }
    } else {
      xv[j] = f < n_valid ? to_f32(xr[f]) : 0.f;
    }
  }
}

// row[f0 ..] = acc, the lane's columns of the tile.
template <int V, int L, int TILE>
__device__ __forceinline__ void store_row(float* __restrict__ row, int64_t f0,
                                          int64_t n_valid, int gl,
                                          const float (&acc)[TILE / L]) {
  float* o = row + f0;
#pragma unroll
  for (int j = 0; j < TILE / (L * V); ++j) {
    const int64_t f = (int64_t)(L * j + gl) * V;
    if (f >= n_valid) continue;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(o + f) =
          make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    } else {
      o[f] = acc[j];
    }
  }
}

// One (segment, tile) per group of L lanes: the segment's sum over the
// tile's columns, stored at row dest of C (dest >= 0) or at row -dest - 1
// of the scratch of partial rows. Task t is strip t / (n_tiles * n_seg),
// segment t / n_tiles % n_seg, tile t % n_tiles of the strip: strip-major.
// T is the type of X and of the values: float, or uint16_t for bf16.
template <typename T, int V, int L, int TILE>
__global__ void __launch_bounds__(kThreads, L == 32 ? kWideMinCtas : kStripMinCtas)
    csr_segment_kernel(const int64_t* __restrict__ seg_start,
                       const int64_t* __restrict__ seg_end,
                       const int64_t* __restrict__ seg_dest,
                       const int32_t* __restrict__ cols,
                       const T* __restrict__ vals,
                       const T* __restrict__ x, float* __restrict__ out,
                       float* __restrict__ partial, int64_t n_seg, int64_t F,
                       int64_t W, int64_t n_tiles, int64_t n_strips) {
  constexpr int N = TILE / L;  // columns per lane
  const int gl = threadIdx.x % L;
  const unsigned mask =  // the group's lanes
      (unsigned)(((1ull << L) - 1) << (threadIdx.x % 32 / L * L));
  const int64_t task = (int64_t)blockIdx.x * (kThreads / L) + threadIdx.x / L;
  if (task >= n_strips * n_seg * n_tiles) return;  // uniform over the group
  const int64_t seg = task / n_tiles % n_seg;
  const int64_t f0 = task / (n_tiles * n_seg) * W + task % n_tiles * TILE;
  if (f0 >= F) return;  // a tile of the last strip past F
  const int64_t n_valid = F - f0 < TILE ? F - f0 : TILE;
  const int64_t s0 = seg_start[seg], s1 = seg_end[seg];
  const T* xt = x + f0;
  float acc[N] = {};
  for (int64_t base = s0; base < s1; base += kBatch) {
    const int n = (int)(s1 - base < kBatch ? s1 - base : kBatch);
    float part[N] = {};
    // The batch's pairs in rows of L, lane gl holding pair q*L + gl.
#pragma unroll
    for (int q = 0; q < kBatch / L; ++q) {
      const int k = q * L + gl;
      const int32_t c = k < n ? cols[base + k] : 0;
      const float v = k < n ? to_f32(vals[base + k]) : 0.f;
      const int nr = n - q * L < L ? n - q * L : L;  // pairs in row q
      int r = 0;
      for (; r + 4 <= nr; r += 4) {
        float xv[4][N], vk[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int64_t ck = __shfl_sync(mask, c, r + u, L);
          vk[u] = __shfl_sync(mask, v, r + u, L);
          load_row<V, L, TILE>(xv[u], xt + ck * F, n_valid, gl);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < N; ++i) part[i] = fmaf(vk[u], xv[u][i], part[i]);
      }
      for (; r < nr; ++r) {
        float xv[N];
        const int64_t ck = __shfl_sync(mask, c, r, L);
        const float vk = __shfl_sync(mask, v, r, L);
        load_row<V, L, TILE>(xv, xt + ck * F, n_valid, gl);
#pragma unroll
        for (int i = 0; i < N; ++i) part[i] = fmaf(vk, xv[i], part[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += part[i];
  }
  const int64_t dest = seg_dest[seg];
  store_row<V, L, TILE>(dest >= 0 ? out + dest * F : partial + (-dest - 1) * F,
                        f0, n_valid, gl, acc);
}

// One (split row, 256 columns) per warp: C[row] = the sum of its partial
// rows partial[part_ptr[h] .. part_ptr[h+1] - 1], in segment order.
template <int V>
__global__ void __launch_bounds__(kThreads)
    csr_reduce_kernel(const int64_t* __restrict__ split_row,
                      const int64_t* __restrict__ part_ptr,
                      const float* __restrict__ partial,
                      float* __restrict__ out, int64_t n_split, int64_t F,
                      int64_t n_ftiles) {
  constexpr int N = kWideTile / 32;
  const int lane = threadIdx.x % 32;
  const int64_t task = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (task >= n_split * n_ftiles) return;
  const int64_t h = task / n_ftiles;
  const int64_t f0 = (task % n_ftiles) * kWideTile;
  const int64_t n_valid = F - f0 < kWideTile ? F - f0 : kWideTile;
  float acc[N] = {};
  for (int64_t p = part_ptr[h]; p < part_ptr[h + 1]; ++p) {
    float xv[N];
    load_row<V, 32, kWideTile>(xv, partial + p * F + f0, n_valid, lane);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += xv[i];
  }
  store_row<V, 32, kWideTile>(out + split_row[h] * F, f0, n_valid, lane, acc);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T, int V, int L, int TILE>
cudaError_t launch_segments(const int64_t* ss, const int64_t* se,
                            const int64_t* sd, const int32_t* c,
                            const T* v, const T* x, float* o,
                            float* partial, int64_t n_seg, int64_t F,
                            int64_t W, int64_t n_tiles, int64_t n_strips,
                            cudaStream_t s) {
  const int64_t n_ctas = ceil_div(n_strips * n_seg * n_tiles, kThreads / L);
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  csr_segment_kernel<T, V, L, TILE><<<(unsigned)n_ctas, kThreads, 0, s>>>(
      ss, se, sd, c, v, x, o, partial, n_seg, F, W, n_tiles, n_strips);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch(const int64_t* ss, const int64_t* se, const int64_t* sd,
                   const int32_t* c, const T* v, const T* x, float* o,
                   float* partial, const int64_t* split_row,
                   const int64_t* part_ptr, int64_t n_seg, int64_t n_split,
                   int64_t F, int64_t W, cudaStream_t s) {
  const int64_t n_ft = ceil_div(F, kWideTile);
  cudaError_t err =
      W >= F ? launch_segments<T, V, 32, kWideTile>(ss, se, sd, c, v, x, o, partial,
                                                    n_seg, F, F, n_ft, 1, s)
             : launch_segments<T, V, 8, kStripTile>(ss, se, sd, c, v, x, o, partial,
                                                    n_seg, F, W, W / kStripTile,
                                                    ceil_div(F, W), s);
  if (err != cudaSuccess || n_split == 0) return err;
  csr_reduce_kernel<V><<<(unsigned)ceil_div(n_split * n_ft, kWarps), kThreads, 0, s>>>(
      split_row, part_ptr, partial, o, n_split, F, n_ft);
  return cudaGetLastError();
}

// The C entries' body: T is float (sdb_csr_spmm) or uint16_t, bf16 X
// and values (sdb_csr_spmm_bf16). The vector loads need F % 4 == 0, X on
// 4 elements' bytes and the f32 outputs on 16.
template <typename T>
int csr_spmm(const void* seg_start, const void* seg_end, const void* seg_dest,
             const void* cols, const void* vals, const void* dense, void* out,
             void* partial, const void* split_row, const void* part_ptr,
             int64_t n_seg, int64_t n_split, int64_t F, int64_t W, void* stream) {
  if (W < F && (W <= 0 || W % kStripTile != 0)) return (int)cudaErrorInvalidValue;
  if (n_seg <= 0 || F <= 0) return (int)cudaSuccess;
  const auto* ss = static_cast<const int64_t*>(seg_start);
  const auto* se = static_cast<const int64_t*>(seg_end);
  const auto* sd = static_cast<const int64_t*>(seg_dest);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const T*>(vals);
  const auto* x = static_cast<const T*>(dense);
  auto* o = static_cast<float*>(out);
  auto* pt = static_cast<float*>(partial);
  const auto* sr = static_cast<const int64_t*>(split_row);
  const auto* pp = static_cast<const int64_t*>(part_ptr);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(pt) % 16 == 0;
  return (int)(vec4 ? launch<T, 4>(ss, se, sd, c, v, x, o, pt, sr, pp, n_seg,
                                   n_split, F, W, s)
                    : launch<T, 1>(ss, se, sd, c, v, x, o, pt, sr, pp, n_seg,
                                   n_split, F, W, s));
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers; the
// stream is the caller's current stream. seg_start, seg_end, seg_dest
// (n_seg,), split_row (n_split,) and part_ptr (n_split + 1,) are int64;
// partial is (part_ptr[n_split], F) f32 scratch (unused when n_split is
// 0). W is the strip width: W >= F walks all of F as one strip, else W
// must be a positive multiple of 32. Launches the segment kernel, then
// the reduction if any row is split; returns the first cudaError_t (0 on
// success; nothing is launched for an empty output).
// sdb_csr_spmm: f32 values and X (K10); sdb_csr_spmm_bf16: bf16 values
// and X (K10 at one bf16 pass), the same arguments otherwise. C is f32.
extern "C" int sdb_csr_spmm(const void* seg_start, const void* seg_end,
                            const void* seg_dest, const void* cols,
                            const void* vals, const void* dense, void* out,
                            void* partial, const void* split_row,
                            const void* part_ptr, int64_t n_seg,
                            int64_t n_split, int64_t F, int64_t W,
                            void* stream) {
  return csr_spmm<float>(seg_start, seg_end, seg_dest, cols, vals, dense, out,
                         partial, split_row, part_ptr, n_seg, n_split, F, W,
                         stream);
}

extern "C" int sdb_csr_spmm_bf16(const void* seg_start, const void* seg_end,
                                 const void* seg_dest, const void* cols,
                                 const void* vals, const void* dense, void* out,
                                 void* partial, const void* split_row,
                                 const void* part_ptr, int64_t n_seg,
                                 int64_t n_split, int64_t F, int64_t W,
                                 void* stream) {
  return csr_spmm<uint16_t>(seg_start, seg_end, seg_dest, cols, vals, dense,
                            out, partial, split_row, part_ptr, n_seg, n_split,
                            F, W, stream);
}
