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
// K10 at one bf16 pass (precision="default", sdb_csr_spmm_bf16) replaces
// the same TPU kernel at jax.lax.Precision.DEFAULT, which rounds S and G
// to bf16 and sums f32 products in f32. The plan rounds the values once,
// each call the operand; a bf16 value widened to f32 is exact (its bits
// shifted up 16), a product of two is exact in f32, and csr_bf16_kernel
// sums them as the f32 kernel does (f32 FFMA in the row's order inside
// batches of 32 pairs, batches added in order, a split row's partial rows
// added in segment order by csr_reduce_kernel), so every output is the f32
// kernel's on the rounded inputs, whatever the strip width or the packing.
//
// What bounds it on an H100. Where the bf16 X sits in the L2 (ddi; arxiv
// and the serve graph, 169,343 rows of ~8 nonzeros at F = 128: 43 MB), not
// the gather bytes but the load requests and each task's chain of
// dependent loads: the segment's words, then its pairs, then its rows of
// X, then the store. The f32 kernel's walk on bf16 made as many requests
// as on f32 (8-byte loads of 4 columns) for half the bytes, and cut each
// short row into tasks of 32 columns that each re-read the segment's
// words and pairs (six tasks a row on the serve graph, two of them empty).
// So this kernel
// - gathers 8 bf16 (16 bytes) a lane and load, keeps them packed (4
//   registers for 8 columns) until their FFMAs, and holds kBf16InFlight
//   rows of X in flight a lane, the next batch's pairs loading meanwhile;
// - runs one task per (segment, strip) over all of the strip's columns,
//   on L = W / 8 lanes rounded up to 4, 8, 16 or 32, so 32 / L segments
//   share a warp (2 at W = 128) and each reads its words and pairs once
//   a strip;
// - takes strips of equal width, a multiple of 8 and at most 256 columns
//   (csr_bf16_strip_width: one of 128 on the serve graph, 4 x 128 at the
//   op csr shape), strip-major in blockIdx order as above, so that a
//   strip's gathers hit the L2 and no lane idles;
// - walks a precision="default" plan's segments longest first
//   (row_segments(longest_first=True): by batches of 32 slots, row order
//   among equals), so a hub row's segments start first and do not hold up
//   the end, and small CTAs (kBf16Threads) free their SM's slot as soon
//   as their few segments end.
// With the gathers cut to 64 rows of X (always cached) the kernel still
// takes ~0.6x its time on the serve graph and ~0.75x at the op csr shape
// (scripts/torch_csr_bf16_probe.py): the walk's chain costs more than
// the gathers' bytes.
// F % 8 != 0, or X off 16 bytes (a view at an odd offset), takes 8-byte
// loads of 4 columns (V = 4) or 2-byte loads (V = 1) in the same kernel.
//
// The f32 ELL tier's kernel (sdb_ell_spmm, ell_row_kernel) replaces no TPU
// kernel: the JAX package's ELL tier (spmm_denseblock_tpu/ops/
// csr_spmm_ell.py, _ell_spmm_device) is XLA code. It gathers each degree
// class's (m, K, F) block of X's rows into device memory, multiplies it
// by the values and sums its K axis, class by class and chunk by chunk,
// then gathers the rows back into the caller's order; its torch-ops port
// made ~90 launches an SpMM on the arxiv graph and took 3.6 ms at F = 128,
// 64x its bytes bound (H100). The plan flattens the ELL layout once, on
// the host: the chunks' column ids and values class-major, each row's
// stored entries at the head of its K slots and its pads after them, and
// the rows' slot starts cut into segments of at most SEGMENT_NNZ stored
// entries, longest first. So a row's stored entries are a span of the
// flat arrays, as K10's are of the band layout's, and one launch gathers,
// multiplies and sums each segment in registers and stores it once, at
// its caller's row (or a partial row that csr_reduce_kernel adds, as in
// K10); pads are never read, so no zero row is appended to X, and a
// pattern-only layout (kValued false) reads no values: each term is X's
// row, what a product by 1.0 gives bit for bit.
//
// What bounds it on an H100. On the arxiv serve graph's remainder (1.99 M
// stored entries, 169,343 rows of ~12) the gathers: 1 GB of X's rows at F
// = 128 and 2 GB at 256, against a bytes bound of 0.057 and 0.109 ms.
// X (87 and 173 MB) is larger than the 50 MB L2, but the graph is
// reordered (gorder), so neighbouring rows gather neighbouring rows of X:
// K10's walk over the same arrays in strips of csr_strip_width's 32
// columns (X's strip in 70% of the L2) took 0.42 and 0.79 ms, and in one
// strip 0.37 and 0.57 (scripts/torch_ell_probe.py). The design is K10's
// one-bf16-pass kernel's, in f32: 16-byte gathers of 4 columns, one task
// a (segment, strip) over all of its columns on L = W / 4 lanes (4 to 32,
// so 32 / L segments share a warp), kEllInFlight rows of X in flight a
// lane while the next batch's pairs load, and the segments longest first
// so that the split rows' segments start first. Its strips
// (ell_strip_width) are equal, at most 128 columns, and each fills at
// most 85% of the L2 (64 columns on arxiv): 0.245-0.251 ms at F = 128 and
// 0.471-0.476 at 256 (strips of 128 within 3% of that; one strip of 256
// read with two loads a lane 0.527), against cuSPARSE's 0.323-0.329 and
// 0.619-0.632 on the same matrix. Each output sums its terms in K10's
// order (f32 FFMA in the row's order inside batches of 32 pairs, the
// batches added in order), whatever the strip width.
//
// Values per call and heads (a pattern plan, values="call"; the GAT's
// aggregation). A call's values come as (H, nnz) in the pattern's entry
// order, and head h's row multiplies column block h of X (F = H x D). A
// row's stored entries lead its slots in CSR order, so each segment's
// slots are its entries shifted by one offset (seg_delta, built on the
// host): the kernel reads the values where they lie, with no scatter into
// slot order, and one launch walks every head, its strips cut inside each
// block of D columns. Three heads of 250 make a 3,000-byte row whose
// second and third heads start 8 bytes past a 16-byte boundary: 8-byte
// loads (V = 2) serve them. On the gat-arxiv graph (2.45 M entries, F =
// 750 in strips of 64) the one launch took 2.13 ms, three launches of one
// head on contiguous head operands 2.15 (3.12 with the copies that make
// them), 4-byte loads 3.40, cuSPARSE 2.70; at F = 120 (3 x 40, 16-byte
// loads) 0.37-0.44, 0.37-0.42 (0.52-0.58), cuSPARSE 0.79 (H100,
// scripts/torch_gat_probe.py). One block (D = F, a plan's own values in
// slot order, no offsets) is the walk above, bit for bit.

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

// V = 4 consecutive f32 elements at p: one 16-byte load (p aligned to it).
__device__ __forceinline__ void load4(float* d, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  d[0] = x.x;
  d[1] = x.y;
  d[2] = x.z;
  d[3] = x.w;
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
// T is the type of X and of the values: float.
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

// sdb_csr_spmm's body (T = float). The vector loads need F % 4 == 0, X on
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

// ---- K10 at one bf16 pass ------------------------------------------------

// Rows in flight, CTA shape and CTAs an SM holds (the cap on registers),
// chosen on an H100 with scripts/torch_csr_bf16_probe.py at ddi, the serve
// graph and the op csr shape (the candidates' times are in PERF.md): at
// 64 registers (4 CTAs of 256) 8 rows in flight spill and the op shape
// takes 2.5x as long; at 80 the instances of 8 to 32 lanes do not spill,
// and small CTAs free an SM's slot as soon as their few segments end.
constexpr int kBf16InFlight = 4;     // gathered rows in flight a lane
constexpr int kBf16Threads = 64;     // threads a CTA
constexpr int kBf16MinCtas = 12;     // CTAs an SM holds: 80 registers
constexpr int kBf16Loads = 1;        // 16-byte loads a lane and row (V = 8)
constexpr int kBf16MaxStrip = 256;   // columns of a strip: 32 lanes x 8
constexpr int kBf16Unit = 8;         // a strip is a multiple of 8 columns

// V consecutive elements of X's row at p as bf16, packed two to a 32-bit
// word, element 2i in the low half of word i (little-endian): one 16-byte
// load for V = 8, one 8-byte load for V = 4 (p aligned to it). Templated
// on X's type so that scripts/torch_csr_bf16_probe.py can time f32 rows
// rounded to bf16 here, in the gather, against the cast before the call.
template <typename TX>
struct Rows;
template <>
struct Rows<uint16_t> {
  template <int V>
  static __device__ __forceinline__ void load(uint32_t (&w)[(V + 1) / 2],
                                              const uint16_t* p) {
    if constexpr (V == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else if constexpr (V == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x;
      w[1] = u.y;
    } else {
      w[0] = __ldg(p);
    }
  }
};

// Element i of packed words w, widened to f32 (exact).
__device__ __forceinline__ float widen(const uint32_t* w, int i) {
  return __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
}

// The pairs of the batch at slot b of a segment that ends at s1, lane gl
// of L holding pairs q * L + gl (0 past the end).
template <int L>
__device__ __forceinline__ void load_pairs(int32_t (&c)[kBatch / L], float (&v)[kBatch / L],
                                           const int32_t* __restrict__ cols,
                                           const uint16_t* __restrict__ vals,
                                           int64_t b, int64_t s1, int gl) {
#pragma unroll
  for (int q = 0; q < kBatch / L; ++q) {
    const int64_t k = b + q * L + gl;
    c[q] = k < s1 ? cols[k] : 0;
    v[q] = k < s1 ? to_f32(vals[k]) : 0.f;
  }
}

// One (segment, strip) per group of L lanes, strip-major: task t is strip
// t / n_seg, segment t % n_seg. Lane gl of the group owns the strip's
// columns (j * L + gl) * V .. + V - 1, j < J. The segment's (col, val)
// pairs are read in batches of 32 (the next batch's while this one's rows
// are gathered), lane gl holding pairs q * L + gl, and broadcast with
// __shfl_sync; kBf16InFlight rows of X are loaded, packed, before their
// FFMAs, which run in the row's order. Stores the segment's sum at row
// dest of C (dest >= 0) or at row -dest - 1 of the partial rows.
template <typename TX, int V, int L, int J>
__global__ void __launch_bounds__(kBf16Threads, kBf16MinCtas)
    csr_bf16_kernel(const int64_t* __restrict__ seg_start,
                    const int64_t* __restrict__ seg_end,
                    const int64_t* __restrict__ seg_dest,
                    const int32_t* __restrict__ cols,
                    const uint16_t* __restrict__ vals,
                    const TX* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ partial, int64_t n_seg, int64_t F,
                    int64_t W, int64_t n_strips) {
  constexpr int NW = (V + 1) / 2;  // packed words for V columns
  constexpr int N = J * V;         // columns a lane
  constexpr int Q = kBatch / L;    // pairs a lane and batch
  constexpr int U = kBf16InFlight;
  const int gl = threadIdx.x % L;
  const unsigned mask =  // the group's lanes
      (unsigned)(((1ull << L) - 1) << (threadIdx.x % 32 / L * L));
  const int64_t task = (int64_t)blockIdx.x * (kBf16Threads / L) + threadIdx.x / L;
  if (task >= n_strips * n_seg) return;  // uniform over the group
  const int64_t seg = task % n_seg;
  const int64_t f0 = task / n_seg * W;
  const int64_t n_valid = F - f0 < W ? F - f0 : W;
  const int64_t s0 = seg_start[seg], s1 = seg_end[seg];
  const TX* xs = x + f0;
  float acc[N] = {};
  int32_t c[Q];
  float v[Q];
  load_pairs<L>(c, v, cols, vals, s0, s1, gl);
  for (int64_t base = s0; base < s1; base += kBatch) {
    const int n = (int)(s1 - base < kBatch ? s1 - base : kBatch);
    int32_t cn[Q];
    float vn[Q];
    load_pairs<L>(cn, vn, cols, vals, base + kBatch, s1, gl);
    float part[N] = {};
#pragma unroll
    for (int k0 = 0; k0 < kBatch; k0 += U) {
      if (k0 >= n) break;
      uint32_t w[U][J][NW];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;  // pair k of the batch: lane k % L's q = k / L
        const int64_t ck = __shfl_sync(mask, c[k / L], k % L, L);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int64_t f = (int64_t)(j * L + gl) * V;
          if (k < n && f < n_valid) {
            Rows<TX>::template load<V>(w[u][j], xs + ck * F + f);
          } else {
#pragma unroll
            for (int i = 0; i < NW; ++i) w[u][j][i] = 0u;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;
        if (k >= n) break;
        const float vk = __shfl_sync(mask, v[k / L], k % L, L);
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int i = 0; i < V; ++i)
            part[j * V + i] = fmaf(vk, widen(w[u][j], i), part[j * V + i]);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += part[i];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      c[q] = cn[q];
      v[q] = vn[q];
    }
  }
  const int64_t dest = seg_dest[seg];
  float* o = (dest >= 0 ? out + dest * F : partial + (-dest - 1) * F) + f0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t f = (int64_t)(j * L + gl) * V;
    if (f >= n_valid) continue;
    if constexpr (V == 1) {
      o[f] = acc[j];
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(o + f + i) = make_float4(
            acc[j * V + i], acc[j * V + i + 1], acc[j * V + i + 2], acc[j * V + i + 3]);
    }
  }
}

template <typename TX, int V, int L, int J>
cudaError_t launch_bf16_tasks(const int64_t* ss, const int64_t* se,
                              const int64_t* sd, const int32_t* c,
                              const uint16_t* v, const TX* x, float* o,
                              float* partial, int64_t n_seg, int64_t F,
                              int64_t W, int64_t n_strips, cudaStream_t s) {
  const int64_t n_ctas = ceil_div(n_strips * n_seg, kBf16Threads / L);
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  csr_bf16_kernel<TX, V, L, J><<<(unsigned)n_ctas, kBf16Threads, 0, s>>>(
      ss, se, sd, c, v, x, o, partial, n_seg, F, W, n_strips);
  return cudaGetLastError();
}

// The group for strips of W columns read V columns a load, J loads a
// lane: the fewest of 4, 8, 16 and 32 lanes that cover a strip.
template <typename TX, int V, int J>
cudaError_t launch_bf16(const int64_t* ss, const int64_t* se,
                        const int64_t* sd, const int32_t* c,
                        const uint16_t* v, const TX* x, float* o,
                        float* partial, int64_t n_seg, int64_t F, int64_t W,
                        cudaStream_t s) {
  static_assert(32 * V * J >= kBf16MaxStrip, "32 lanes must cover a strip");
  const int64_t lanes = ceil_div(W, V * J), n_strips = ceil_div(F, W);
  return lanes <= 4    ? launch_bf16_tasks<TX, V, 4, J>(ss, se, sd, c, v, x, o, partial,
                                                         n_seg, F, W, n_strips, s)
         : lanes <= 8  ? launch_bf16_tasks<TX, V, 8, J>(ss, se, sd, c, v, x, o, partial,
                                                         n_seg, F, W, n_strips, s)
         : lanes <= 16 ? launch_bf16_tasks<TX, V, 16, J>(ss, se, sd, c, v, x, o, partial,
                                                          n_seg, F, W, n_strips, s)
                       : launch_bf16_tasks<TX, V, 32, J>(ss, se, sd, c, v, x, o, partial,
                                                          n_seg, F, W, n_strips, s);
}

// sdb_csr_spmm_bf16's body, on X of type TX (uint16_t: bf16). 16-byte
// loads (V = 8) need F % 8 == 0 and X on 16 bytes, 8-byte loads (V = 4)
// F % 4 == 0 and X on 8; both need the f32 outputs on 16. Then the
// reduction of split rows, shared with the f32 kernel.
template <typename TX>
int csr_bf16_spmm(const void* seg_start, const void* seg_end, const void* seg_dest,
                  const void* cols, const void* vals, const void* dense, void* out,
                  void* partial, const void* split_row, const void* part_ptr,
                  int64_t n_seg, int64_t n_split, int64_t F, int64_t W, void* stream) {
  if (W < F && (W <= 0 || W % kBf16Unit != 0)) return (int)cudaErrorInvalidValue;
  if (n_seg <= 0 || F <= 0) return (int)cudaSuccess;
  if (W > F) W = F;
  if (W > kBf16MaxStrip) return (int)cudaErrorInvalidValue;
  const auto* ss = static_cast<const int64_t*>(seg_start);
  const auto* se = static_cast<const int64_t*>(seg_end);
  const auto* sd = static_cast<const int64_t*>(seg_dest);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* v = static_cast<const uint16_t*>(vals);
  const auto* x = static_cast<const TX*>(dense);
  auto* o = static_cast<float*>(out);
  auto* pt = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const bool out16 = F % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(pt) % 16 == 0;
  constexpr size_t a8 = 8 * sizeof(TX) < 16 ? 8 * sizeof(TX) : 16;
  cudaError_t err =
      out16 && F % 8 == 0 && xa % a8 == 0
          ? launch_bf16<TX, 8, kBf16Loads>(ss, se, sd, c, v, x, o, pt, n_seg, F, W, s)
      : out16 && xa % (4 * sizeof(TX)) == 0
          ? launch_bf16<TX, 4, kBf16MaxStrip / 128>(ss, se, sd, c, v, x, o, pt, n_seg,
                                                    F, W, s)
          : launch_bf16<TX, 1, kBf16MaxStrip / 32>(ss, se, sd, c, v, x, o, pt, n_seg,
                                                   F, W, s);
  if (err != cudaSuccess || n_split == 0) return (int)err;
  const int64_t n_ft = ceil_div(F, kWideTile);
  const unsigned n_ctas = (unsigned)ceil_div(n_split * n_ft, kWarps);
  const auto* sr = static_cast<const int64_t*>(split_row);
  const auto* pp = static_cast<const int64_t*>(part_ptr);
  if (out16) {
    csr_reduce_kernel<4><<<n_ctas, kThreads, 0, s>>>(sr, pp, pt, o, n_split, F, n_ft);
  } else {
    csr_reduce_kernel<1><<<n_ctas, kThreads, 0, s>>>(sr, pp, pt, o, n_split, F, n_ft);
  }
  return (int)cudaGetLastError();
}

// ---- the f32 ELL tier -----------------------------------------------------

constexpr int kEllInFlight = 4;    // gathered rows in flight a lane
constexpr int kEllThreads = 64;    // threads a CTA
constexpr int kEllMinCtas = 12;    // CTAs an SM holds: 80 registers
constexpr int kEllMaxStrip = 128;  // columns of a strip: 32 lanes x 4

// The pairs of the batch at slot b of a segment that ends at s1, lane gl
// of L holding pairs q * L + gl (0 past the end); the value of slot k is
// vals[k + voff]; no values where the layout has none.
template <int L, bool kValued>
__device__ __forceinline__ void load_ell_pairs(int32_t (&c)[kBatch / L],
                                               float (&v)[kBatch / L],
                                               const int32_t* __restrict__ cols,
                                               const float* __restrict__ vals,
                                               int64_t voff, int64_t b, int64_t s1,
                                               int gl) {
#pragma unroll
  for (int q = 0; q < kBatch / L; ++q) {
    const int64_t k = b + q * L + gl;
    c[q] = k < s1 ? cols[k] : 0;
    v[q] = kValued && k < s1 ? vals[k + voff] : 0.f;
  }
}

// V = 2 consecutive f32 elements at p: one 8-byte load (p aligned to it).
__device__ __forceinline__ void load2(float* d, const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  d[0] = x.x;
  d[1] = x.y;
}

// One (segment, strip) per group of L lanes, strip-major: task t is strip
// t / n_seg, segment t % n_seg. The F columns are blocks of D, each cut
// into spb strips of W: strip s is block s / spb, and its values the
// block's row of them, vals[block * vstride + k + delta] for slot k,
// delta the segment's seg_delta (0 where it is null). Lane gl
// of the group owns the strip's columns (j * L + gl) * V .. + V - 1, j < J
// (V = 4: one 16-byte load, V = 2: one of 8). The segment's (col, val)
// pairs are read in batches of 32 (the next batch's while this one's rows
// are gathered), lane gl holding pairs q * L + gl, and broadcast with
// __shfl_sync; kEllInFlight rows of X are loaded before their FFMAs, which
// run in the row's order. Stores the segment's sum at row dest of C (dest
// >= 0) or at row -dest - 1 of the partial rows.
template <int V, int L, int J, bool kValued>
__global__ void __launch_bounds__(kEllThreads, kEllMinCtas)
    ell_row_kernel(const int64_t* __restrict__ seg_start,
                   const int64_t* __restrict__ seg_end,
                   const int64_t* __restrict__ seg_dest,
                   const int64_t* __restrict__ seg_delta,
                   const int32_t* __restrict__ cols,
                   const float* __restrict__ vals, const float* __restrict__ x,
                   float* __restrict__ out, float* __restrict__ partial,
                   int64_t n_seg, int64_t F, int64_t W, int64_t D, int64_t spb,
                   int64_t n_strips, int64_t vstride) {
  constexpr int N = J * V;       // columns a lane
  constexpr int Q = kBatch / L;  // pairs a lane and batch
  constexpr int U = kEllInFlight;
  const int gl = threadIdx.x % L;
  const unsigned mask =  // the group's lanes
      (unsigned)(((1ull << L) - 1) << (threadIdx.x % 32 / L * L));
  const int64_t task = (int64_t)blockIdx.x * (kEllThreads / L) + threadIdx.x / L;
  if (task >= n_strips * n_seg) return;  // uniform over the group
  const int64_t strip = task / n_seg;
  const int64_t seg = task - strip * n_seg;
  // the strip's block and its first column inside the block (one block,
  // D == F: no division)
  int64_t block = 0, fb = strip * W;
  if (D != F) {
    block = (int)strip / (int)spb;
    fb = (strip - block * spb) * W;
  }
  const int64_t f0 = block * D + fb;
  const int64_t n_valid = D - fb < W ? D - fb : W;
  const int64_t voff =
      kValued ? block * vstride + (seg_delta != nullptr ? seg_delta[seg] : 0) : 0;
  const int64_t s0 = seg_start[seg], s1 = seg_end[seg];
  const float* xs = x + f0;
  float acc[N] = {};
  int32_t c[Q];
  float v[Q];
  load_ell_pairs<L, kValued>(c, v, cols, vals, voff, s0, s1, gl);
  for (int64_t base = s0; base < s1; base += kBatch) {
    const int n = (int)(s1 - base < kBatch ? s1 - base : kBatch);
    int32_t cn[Q];
    float vn[Q];
    load_ell_pairs<L, kValued>(cn, vn, cols, vals, voff, base + kBatch, s1, gl);
    float part[N] = {};
#pragma unroll
    for (int k0 = 0; k0 < kBatch; k0 += U) {
      if (k0 >= n) break;
      float xv[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;  // pair k of the batch: lane k % L's q = k / L
        const int64_t ck = __shfl_sync(mask, c[k / L], k % L, L);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int64_t f = (int64_t)(j * L + gl) * V;
          if (k < n && f < n_valid) {
            if constexpr (V == 4) {
              load4(&xv[u][4 * j], xs + ck * F + f);
            } else if constexpr (V == 2) {
              load2(&xv[u][2 * j], xs + ck * F + f);
            } else {
              xv[u][j] = __ldg(xs + ck * F + f);
            }
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) xv[u][j * V + i] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;
        if (k >= n) break;
        const float vk = kValued ? __shfl_sync(mask, v[k / L], k % L, L) : 1.f;
#pragma unroll
        for (int i = 0; i < N; ++i) part[i] = fmaf(vk, xv[u][i], part[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += part[i];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      c[q] = cn[q];
      v[q] = vn[q];
    }
  }
  const int64_t dest = seg_dest[seg];
  float* o = (dest >= 0 ? out + dest * F : partial + (-dest - 1) * F) + f0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int64_t f = (int64_t)(j * L + gl) * V;
    if (f >= n_valid) continue;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(o + f) =
          make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(o + f) = make_float2(acc[2 * j], acc[2 * j + 1]);
    } else {
      o[f] = acc[j];
    }
  }
}

// The operands of one ell_row_kernel launch.
struct EllArgs {
  const int64_t *ss, *se, *sd, *delta;
  const int32_t* c;
  const float *v, *x;
  float *o, *partial;
  int64_t n_seg, F, W, D, spb, n_strips, vstride;
};

template <int V, int L, int J, bool kValued>
cudaError_t launch_ell_tasks(const EllArgs& a, cudaStream_t s) {
  const int64_t n_ctas = ceil_div(a.n_strips * a.n_seg, kEllThreads / L);
  if (n_ctas > INT32_MAX) return cudaErrorInvalidConfiguration;
  ell_row_kernel<V, L, J, kValued><<<(unsigned)n_ctas, kEllThreads, 0, s>>>(
      a.ss, a.se, a.sd, a.delta, a.c, a.v, a.x, a.o, a.partial, a.n_seg, a.F, a.W,
      a.D, a.spb, a.n_strips, a.vstride);
  return cudaGetLastError();
}

// The group for strips of W columns read V columns a load, J loads a
// lane: the fewest of 4, 8, 16 and 32 lanes that cover a strip.
template <int V, int J, bool kValued>
cudaError_t launch_ell(const EllArgs& a, cudaStream_t s) {
  static_assert(32 * V * J >= kEllMaxStrip, "32 lanes must cover a strip");
  const int64_t lanes = ceil_div(a.W, V * J);
  return lanes <= 4    ? launch_ell_tasks<V, 4, J, kValued>(a, s)
         : lanes <= 8  ? launch_ell_tasks<V, 8, J, kValued>(a, s)
         : lanes <= 16 ? launch_ell_tasks<V, 16, J, kValued>(a, s)
                       : launch_ell_tasks<V, 32, J, kValued>(a, s);
}

// sdb_ell_spmm's body. X, C and the partial rows are (., F), F = heads x D
// columns. 16-byte loads (V = 4, one a lane and row) need D % 4 == 0, X
// and the outputs on 16 bytes; 8-byte loads (V = 2, two a lane and row)
// D % 2 == 0 and them on 8 (D = 250: a 750-wide row of three heads,
// whose second and third start 8 bytes past a 16-byte boundary);
// otherwise 4-byte loads, 4 a lane and row. Every V sums each output's
// terms in the same order. Then the reduction of split rows, shared
// with K10.
template <bool kValued>
int ell_spmm(const void* seg_start, const void* seg_end, const void* seg_dest,
             const void* seg_delta, const void* cols, const void* vals,
             const void* dense, void* out, void* partial, const void* split_row,
             const void* part_ptr, int64_t n_seg, int64_t n_split, int64_t F,
             int64_t W, int64_t heads, int64_t vstride, void* stream) {
  if (heads <= 0 || F % heads != 0) return (int)cudaErrorInvalidValue;
  const int64_t D = F / heads;
  if (W < D && (W <= 0 || W % 4 != 0)) return (int)cudaErrorInvalidValue;
  if (n_seg <= 0 || F <= 0) return (int)cudaSuccess;
  if (W > D) W = D;
  if (W > kEllMaxStrip) return (int)cudaErrorInvalidValue;
  EllArgs a{static_cast<const int64_t*>(seg_start), static_cast<const int64_t*>(seg_end),
            static_cast<const int64_t*>(seg_dest), static_cast<const int64_t*>(seg_delta),
            static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
            static_cast<const float*>(dense), static_cast<float*>(out),
            static_cast<float*>(partial), n_seg, F, W, D, ceil_div(D, W),
            heads * ceil_div(D, W), vstride};
  auto s = static_cast<cudaStream_t>(stream);
  const auto aligned = [&](uintptr_t bytes) {
    return reinterpret_cast<uintptr_t>(a.x) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(a.o) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(a.partial) % bytes == 0;
  };
  const bool vec4 = D % 4 == 0 && aligned(16);
  const bool vec2 = !vec4 && D % 2 == 0 && aligned(8);
  cudaError_t err = vec4   ? launch_ell<4, kEllMaxStrip / 128, kValued>(a, s)
                    : vec2 ? launch_ell<2, kEllMaxStrip / 64, kValued>(a, s)
                           : launch_ell<1, kEllMaxStrip / 32, kValued>(a, s);
  if (err != cudaSuccess || n_split == 0) return (int)err;
  auto* o = a.o;
  auto* pt = a.partial;
  const int64_t n_ft = ceil_div(F, kWideTile);
  const unsigned n_ctas = (unsigned)ceil_div(n_split * n_ft, kWarps);
  const auto* sr = static_cast<const int64_t*>(split_row);
  const auto* pp = static_cast<const int64_t*>(part_ptr);
  if (vec4) {
    csr_reduce_kernel<4><<<n_ctas, kThreads, 0, s>>>(sr, pp, pt, o, n_split, F, n_ft);
  } else {
    csr_reduce_kernel<1><<<n_ctas, kThreads, 0, s>>>(sr, pp, pt, o, n_split, F, n_ft);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers; the
// stream is the caller's current stream. seg_start, seg_end, seg_dest
// (n_seg,), split_row (n_split,) and part_ptr (n_split + 1,) are int64;
// partial is (part_ptr[n_split], F) f32 scratch (unused when n_split is
// 0). W is the strip width: W >= F walks all of F as one strip. Launches
// the segment kernel, then the reduction if any row is split; returns the
// first cudaError_t (0 on success; nothing is launched for an empty
// output).
// sdb_csr_spmm: f32 values and X (K10); W < F must be a positive multiple
// of 32. sdb_csr_spmm_bf16: bf16 values and X (K10 at one bf16 pass), the
// same arguments otherwise; W < F must be a positive multiple of 8, and a
// strip at most 256 columns. sdb_ell_spmm: the f32 ELL tier's flattened
// layout, sdb_csr_spmm's arguments and three more: seg_delta (n_seg,)
// int64 or null, heads and vstride. F is heads blocks of D = F / heads
// columns; block h's terms take the values vals[h * vstride + k +
// seg_delta[seg]] at slot k of segment seg (one block, vstride 0 and a
// null seg_delta: the plan's own values in slot order; vals null for a
// pattern-only layout). W is the strip width inside a block: W < D must
// be a positive multiple of 4, and a strip at most 128 columns. C is f32.
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
  return csr_bf16_spmm<uint16_t>(seg_start, seg_end, seg_dest, cols, vals, dense,
                                 out, partial, split_row, part_ptr, n_seg, n_split,
                                 F, W, stream);
}

extern "C" int sdb_ell_spmm(const void* seg_start, const void* seg_end,
                            const void* seg_dest, const void* seg_delta,
                            const void* cols, const void* vals, const void* dense,
                            void* out, void* partial, const void* split_row,
                            const void* part_ptr, int64_t n_seg, int64_t n_split,
                            int64_t F, int64_t W, int64_t heads, int64_t vstride,
                            void* stream) {
  return vals != nullptr
             ? ell_spmm<true>(seg_start, seg_end, seg_dest, seg_delta, cols, vals,
                              dense, out, partial, split_row, part_ptr, n_seg, n_split,
                              F, W, heads, vstride, stream)
             : ell_spmm<false>(seg_start, seg_end, seg_dest, seg_delta, cols, vals,
                               dense, out, partial, split_row, part_ptr, n_seg,
                               n_split, F, W, heads, vstride, stream);
}
