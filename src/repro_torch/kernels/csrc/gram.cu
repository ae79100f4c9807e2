// Cross-Gram kernels on Hopper, all f32-accurate:
//   out[f] = X[lo_f:hi_f]ᵀ · Y[lo_f:hi_f]          (xty_folds, xty)
//   out[s] = (X · diag(w[:, s]))ᵀ · Z              (xty_folds_masked)
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gram.py:
//   * xty_folds (the per-fold [G | C] statistics of core/foldstats.py, one
//     launch per in-memory fit) and xty_folds_masked (every chunk update of
//     the streamed fit, foldstats._FixedShapeUpdate) run on the split-bf16
//     tensor-core engine (split_engine.cu): see "The engine's callers" at
//     the end of this note;
//   * xty (XᵀY; the dual path's XXᵀ and Xᵀα, the seed path's Grams) runs on
//     the CUDA-core row loop below: over one row range or, where the output
//     is too small to fill the card, over S contiguous row ranges whose S
//     partial products a second small kernel adds in order
//     (kernels/gram.py::row_splits picks S).
//
// The row loop.  What bounds it on this card: f32 arithmetic.  The
// reference accumulates in f32 (preferred_element_type) and the loop uses
// no TF32 `mma`; each output element costs 2·rows FLOPs of f32 FMA on the
// CUDA cores (67 TFLOP/s on an H100 SXM at 700 W) against 4 bytes read per
// input element.  A narrow output is bound by the blocks it can keep busy:
// the dual fit's XXᵀ (16,384 rows, a 1,000² output) is 64 tiles, under
// half the 132 SMs at 2 blocks each.
//
// What the design does about it:
//   * Each block owns one (row range, 128-row i tile, 128-column j tile)
//     output tile and loops over that range's rows itself.  The TPU kernel
//     carries its accumulator across a sequential grid axis; Hopper runs
//     blocks in parallel and in no order, so the row loop lives inside the
//     block.  Nothing is shared between blocks: no atomics, deterministic
//     results.
//   * xty with fewer than 2 × 132 output tiles cuts the rows into S equal
//     ranges (tiles × S ≥ 264, each range ≥ 256 rows, S ≤ 64) and launches
//     the row loop with them into an (S, p, q) scratch;
//     xty_split_sum_kernel adds the S partials in split order.  Repeated
//     launches are bitwise equal.  A full grid (S = 1) is the one-range
//     launch unchanged.
//   * Rows are read in place between the range bounds (int64, passed by
//     value as a kernel parameter, so a launch queues no host-to-device
//     copy and no stream synchronisation).  There is no repack and no zero
//     padding: ragged n, p and q are masked at the loads and the store.
//   * Register blocking: 256 threads, 8×8 f32 accumulators each, fed from a
//     double-buffered shared-memory stage of 8 rows × 128 columns per
//     operand, so each shared-memory float feeds 8 FMAs.  The next stage is
//     loaded from global memory into registers while the current one is
//     multiplied.
//   * bf16 inputs are converted to f32 with __bfloat162float at the load;
//     the product of two bf16 values is exact in f32.
//   * Every offset is int64.
// Not done yet (later work): the row loop reaches ~43 TFLOP/s of the 67,
// and xty (Xᵀα, the row-split XXᵀ) is to move onto the split engine, after
// which accumulate_rows has no caller.
//
// The engine's callers.  Each writes the bf16 terms of its two operands
// into scratch the wrapper allocates (split_engine::split), then sums the
// kept term products on the tensor cores (split_engine::product); the
// engine's note (split_engine.cu) has the split rule, the non-finite rule
// and what is not done yet.
//   * xty_folds: per fold f with lo < hi, x[lo:hi] is the Aᵀ side (rows p,
//     K = hi − lo) and y[lo:hi] the B side, read in place from lo rows in,
//     and their product lands in out[f]; the folds run one after another
//     on the stream, reusing one scratch sized for the largest fold.  An
//     empty fold is a cudaMemsetAsync of its slice: exact zeros.  f32
//     operands split into 3 + 3 terms, 6 products kept; bf16 ones are one
//     exact term each, 1 product.  Bound: tensor-core operations, 6 ×
//     2·n·p·q = 2.3e14 at the parcels fit (n = 69,202, p = 16,384,
//     q = 16,828): 231.5 ms at 989 TFLOP/s, against 569.5 ms at the f32
//     rate of the row loop it replaces.  Scratch: 3 × 16,384 × 13,856 ×
//     2 B = 1.36 GB for x and 3 × 16,896 × 13,856 × 2 B = 1.40 GB for
//     [X | Y], where one split of all 69,202 rows would take 13.8 GB.
//   * xty_folds_masked: the bf16 terms of x·w_s (the weight applied in f32
//     first, as the plain version's x.float() * w; all slots stacked as
//     the rows of one operand) and of z; one product over the kept term
//     pairs writes the (s·p, q) = (s, p, q) output.  f32 operands split
//     into 3 + 3 terms, 6 products kept; bf16 x·w (exact in f32) into 2 and
//     bf16 z into 1, 2 products.  Bound: 6 × 2·s·m·p·q = 5.4e13 at the
//     streamed fit's chunk (m = 8,192, p = 16,384, q = 16,828, s = 2): 54.7
//     ms at 989 TFLOP/s, against 134.8 ms at the f32 rate.  Scratch: 3 ×
//     32,768 × 8,192 × 2 B = 1.61 GB for x·w and 0.83 GB for z.  A 0 weight
//     on a NaN or Inf row gives NaN, as the reference keeps 0·Inf and 0·NaN
//     rows as NaN; an all-zero slot of finite rows gives an exact zero
//     tile.  Skipping a slot's all-zero stages is not done.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "split_engine.cuh"

namespace {

constexpr int kBlockI = 128;   // output rows per block (columns of x)
constexpr int kBlockJ = 128;   // output columns per block (columns of y)
constexpr int kStageRows = 8;  // input rows per shared-memory stage
constexpr int kThreads = 256;
constexpr int kMaxFolds = 64;  // 1 KiB of kernel parameters

// k × (lo, hi) row bounds, by value in the kernel's parameter space.
struct FoldBounds {
  long long v[2 * kMaxFolds];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One stage of one operand: rows [row0, row0 + 8) ∩ [.., row_end), columns
// [col0, col0 + 128) ∩ [.., ncols).  Thread t takes row t / 32 and columns
// lane, lane + 32, lane + 64, lane + 96, so each warp-wide load is 32
// consecutive elements of one row.
template <typename T>
__device__ __forceinline__ void load_stage(const T* __restrict__ src,
                                           long long ld, long long row0,
                                           long long row_end, long long col0,
                                           long long ncols, int tid,
                                           float (&reg)[4]) {
  const long long row = row0 + (tid >> 5);
  const int lane = tid & 31;
  const bool row_ok = row < row_end;
  const T* base = src + row * ld;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long col = col0 + lane + 32 * e;
    reg[e] = (row_ok && col < ncols) ? to_f32(base[col]) : 0.f;
  }
}

__device__ __forceinline__ void store_stage(float (*dst)[kBlockI], int tid,
                                            const float (&reg)[4]) {
  const int r = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[r][lane + 32 * e] = reg[e];
}

// Accumulates rows [lo, hi) of the (128 × 128) output tile at (i0, j0) into
// acc: acc += x[lo:hi, i0:i0+128]ᵀ · y[lo:hi, j0:j0+128].
template <typename T>
__device__ __forceinline__ void accumulate_rows(
    const T* __restrict__ x, const T* __restrict__ y, long long lo,
    long long hi, long long i0,
    long long j0, long long p, long long q, float (*xs)[kStageRows][kBlockI],
    float (*ys)[kStageRows][kBlockJ], float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group of the 8×8 micro-tile
  const int ty = tid >> 4;   // row group
  float rx[4], ry[4];
  load_stage(x, p, lo, hi, i0, p, tid, rx);
  load_stage(y, q, lo, hi, j0, q, tid, ry);
  store_stage(xs[0], tid, rx);
  store_stage(ys[0], tid, ry);
  __syncthreads();
  int buf = 0;
  for (long long r0 = lo; r0 < hi; r0 += kStageRows) {
    const bool has_next = r0 + kStageRows < hi;
    if (has_next) {
      load_stage(x, p, r0 + kStageRows, hi, i0, p, tid, rx);
      load_stage(y, q, r0 + kStageRows, hi, j0, q, tid, ry);
    }
#pragma unroll
    for (int kk = 0; kk < kStageRows; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&xs[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ys[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    if (has_next) {
      // The other buffer was last read before the previous barrier.
      store_stage(xs[buf ^ 1], tid, rx);
      store_stage(ys[buf ^ 1], tid, ry);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// Writes the whole (masked) tile, so an empty row range yields exact zeros
// and the wrapper may allocate the output uninitialised.
__device__ __forceinline__ void store_tile(float* __restrict__ o,
                                           long long i0, long long j0,
                                           long long p, long long q,
                                           const float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const bool vec = (q & 3) == 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const long long i = i0 + (m < 4 ? ty * 4 + m : 64 + ty * 4 + (m - 4));
    if (i >= p) continue;
    float* orow = o + i * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long j = j0 + h * 64 + tx * 4;
      if (vec && j + 3 < q) {
        *reinterpret_cast<float4*>(orow + j) =
            make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2],
                        acc[m][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < q) orow[j + e] = acc[m][4 * h + e];
      }
    }
  }
}

// grid = (ceil(q / 128), ceil(p / 128), k); block = 256 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    xty_folds_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     const FoldBounds bounds, float* __restrict__ out,
                     long long p, long long q) {
  __shared__ __align__(16) float xs[2][kStageRows][kBlockI];
  __shared__ __align__(16) float ys[2][kStageRows][kBlockJ];
  const long long fold = blockIdx.z;
  const long long i0 = static_cast<long long>(blockIdx.y) * kBlockI;
  const long long j0 = static_cast<long long>(blockIdx.x) * kBlockJ;
  const long long lo = bounds.v[2 * fold];
  const long long hi = bounds.v[2 * fold + 1];
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;
  if (lo < hi)
    accumulate_rows<T>(x, y, lo, hi, i0, j0, p, q, xs, ys, acc);
  store_tile(out + fold * p * q, i0, j0, p, q, acc);
}

// out[i] = part[0][i] + part[1][i] + … + part[splits − 1][i], in that
// order, for i < count.  grid-stride; float4 when count % 4 == 0.
__global__ void __launch_bounds__(kThreads)
    xty_split_sum_kernel(const float* __restrict__ part,
                         float* __restrict__ out, long long count,
                         int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((count & 3) == 0) {
    const long long n4 = count >> 2;
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (; i < n4; i += stride) {
      float4 acc = p4[i];
      for (int s = 1; s < splits; ++s) {
        const float4 v = p4[s * n4 + i];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      reinterpret_cast<float4*>(out)[i] = acc;
    }
  } else {
    for (; i < count; i += stride) {
      float acc = part[i];
      for (int s = 1; s < splits; ++s) acc += part[s * count + i];
      out[i] = acc;
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, const long long* bounds, void* out,
           long long p, long long q, int k, int device, void* stream) {
  if (k < 1 || k > kMaxFolds) return static_cast<int>(cudaErrorInvalidValue);
  FoldBounds fb = {};
  for (int i = 0; i < 2 * k; ++i) fb.v[i] = bounds[i];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((q + kBlockJ - 1) / kBlockJ),
                  static_cast<unsigned>((p + kBlockI - 1) / kBlockI),
                  static_cast<unsigned>(k));
  xty_folds_kernel<T><<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      fb, static_cast<float*>(out), p, q);
  return static_cast<int>(cudaGetLastError());
}

// Fold f of xty_folds on the engine: x[lo:hi] as the Aᵀ side (rows p,
// K = hi − lo), y[lo:hi] as the B side, their product into out[f]; both
// operands' sources start lo rows in, and each fold's split passes reuse
// the same scratch (the wrapper sizes it for the largest fold; the stream
// orders the passes).  An empty fold is an exact zero slice.
int launch_folds(bool bf16, const void* x, const void* y,
                 const long long* bounds, void* scratch_a, void* scratch_b,
                 void* out, long long p, long long q, int k, int device,
                 void* stream) {
  if (k < 1 || k > kMaxFolds || p < 1 || q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int planes = bf16 ? 1 : 3;
  const size_t esize = bf16 ? 2 : 4;
  for (int f = 0; f < k && err == cudaSuccess; ++f) {
    const long long lo = bounds[2 * f], hi = bounds[2 * f + 1];
    float* o = static_cast<float*>(out) + static_cast<long long>(f) * p * q;
    if (hi <= lo) {
      err = cudaMemsetAsync(o, 0, static_cast<size_t>(p * q) * 4, st);
      continue;
    }
    const split_engine::Operand xa = {
        static_cast<const char*>(x) + lo * p * esize, bf16, p, 1, p, p,
        nullptr, false, 0, 0, planes, scratch_a};
    const split_engine::Operand yb = {
        static_cast<const char*>(y) + lo * q * esize, bf16, q, 1, q, q,
        nullptr, false, 0, 0, planes, scratch_b};
    err = split_engine::split(xa, split_engine::kBM, hi - lo, st);
    if (err == cudaSuccess)
      err = split_engine::split(yb, split_engine::kBN, hi - lo, st);
    if (err == cudaSuccess)
      err = split_engine::product(scratch_a, planes, scratch_b, planes, p, q,
                                  hi - lo, o, q, q, 0, st);
  }
  return static_cast<int>(err);
}

// x·w_s of every slot s as the rows (s, i) of the Aᵀ side, z as the B side;
// out (s, p, q) is their (s·p, q) product.
int launch_masked(bool bf16, const void* x, const void* z, const void* w,
                  void* scratch_a, void* scratch_b, void* out, long long m,
                  long long p, long long q, long long s, int device,
                  void* stream) {
  if (s < 1 || m < 0 || p < 1 || q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const split_engine::Operand xa = {x, bf16, p, 1, s * p, p, w, bf16, s, 1,
                                    bf16 ? 2 : 3, scratch_a};
  const split_engine::Operand zb = {z, bf16, q, 1, q, q, nullptr, false, 0,
                                    0, bf16 ? 1 : 3, scratch_b};
  err = split_engine::split(xa, split_engine::kBM, m, st);
  if (err == cudaSuccess)
    err = split_engine::split(zb, split_engine::kBN, m, st);
  if (err == cudaSuccess)
    err = split_engine::product(scratch_a, xa.planes, scratch_b, zb.planes,
                                s * p, q, m, static_cast<float*>(out), q, q,
                                0, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The row loop (xty's kernel).  x: (n, p) row-major, y: (n, q) row-major,
// bounds: k × (lo, hi) int64 in host memory (1 ≤ k ≤ 64), out: (k, p, q)
// f32.  Launches on `stream` and returns the cudaGetLastError() code of the
// launch (0 on success).
int repro_xty_rows_f32(const void* x, const void* y, const long long* bounds,
                       void* out, long long p, long long q, int k, int device,
                       void* stream) {
  return launch<float>(x, y, bounds, out, p, q, k, device, stream);
}

int repro_xty_rows_bf16(const void* x, const void* y, const long long* bounds,
                        void* out, long long p, long long q, int k,
                        int device, void* stream) {
  return launch<__nv_bfloat16>(x, y, bounds, out, p, q, k, device, stream);
}

// xty_folds on the split engine.  x: (n, p), y: (n, q), row-major, one
// dtype; bounds: k × (lo, hi) int64 in host memory (1 ≤ k ≤ 64);
// scratch_a, scratch_b: the engine's bf16 term planes of x and y for the
// largest fold (kernels/split_engine.py sizes them); out: (k, p, q) f32.
// Launches each fold's split passes and product on `stream` and returns
// the first CUDA error code that is not 0 (0 on success).
int repro_xty_folds_f32(const void* x, const void* y, const long long* bounds,
                        void* scratch_a, void* scratch_b, void* out,
                        long long p, long long q, int k, int device,
                        void* stream) {
  return launch_folds(false, x, y, bounds, scratch_a, scratch_b, out, p, q, k,
                      device, stream);
}

int repro_xty_folds_bf16(const void* x, const void* y,
                         const long long* bounds, void* scratch_a,
                         void* scratch_b, void* out, long long p, long long q,
                         int k, int device, void* stream) {
  return launch_folds(true, x, y, bounds, scratch_a, scratch_b, out, p, q, k,
                      device, stream);
}

// x: (m, p), z: (m, q), w: (m, s) slot weights, all row-major and of one
// dtype; scratch_a, scratch_b: the engine's bf16 term planes of x·w and z
// (kernels/split_engine.py sizes them); out: (s, p, q) f32 with out[k] =
// (x · w[:, k])ᵀ z.  Launches the split passes and the product on `stream`
// and returns the first CUDA error code that is not 0 (0 on success).
int repro_xty_folds_masked_f32(const void* x, const void* z, const void* w,
                               void* scratch_a, void* scratch_b, void* out,
                               long long m, long long p, long long q,
                               long long s, int device, void* stream) {
  return launch_masked(false, x, z, w, scratch_a, scratch_b, out, m, p, q, s,
                       device, stream);
}

int repro_xty_folds_masked_bf16(const void* x, const void* z, const void* w,
                                void* scratch_a, void* scratch_b, void* out,
                                long long m, long long p, long long q,
                                long long s, int device, void* stream) {
  return launch_masked(true, x, z, w, scratch_a, scratch_b, out, m, p, q, s,
                       device, stream);
}

// part: (splits, count) f32, out: (count,) f32; out = Σ_s part[s], added
// in split order.  Launches on `stream` and returns the cudaGetLastError()
// code of the launch.
int repro_xty_split_sum(const void* part, void* out, long long count,
                        int splits, int device, void* stream) {
  if (count < 1 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = (count & 3) == 0 ? count >> 2 : count;
  const long long blocks = (work + kThreads - 1) / kThreads;
  xty_split_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(out), count,
      splits);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
