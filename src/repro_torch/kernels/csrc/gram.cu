// Cross-Gram kernels on Hopper, all f32-accurate, all on the split-bf16
// tensor-core engine (split_engine.cu):
//   out = Xᵀ · Y                                   (xty; gram is xty(x, x))
//   out[f] = X[lo_f:hi_f]ᵀ · Y[lo_f:hi_f]          (xty_folds)
//   out[s] = (X · diag(w[:, s]))ᵀ · Z              (xty_folds_masked)
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gram.py: xty (the
// dual fit's XXᵀ and Xᵀα, dual B-MOR's kernel matrix, every MOR target's
// dual fit, the seed CV path's primal Grams), xty_folds (the per-fold
// [G | C] statistics of core/foldstats.py, one launch per in-memory fit)
// and xty_folds_masked (every chunk update of the streamed fit,
// foldstats._FixedShapeUpdate).  Each writes the bf16 terms of its two
// operands into scratch the wrapper allocates (split_engine::split), then
// sums the kept term products on the tensor cores
// (split_engine::product); the engine's note has the split rule, the
// non-finite rule (NaN where the plain version is NaN, non-finite where it
// is ±Inf) and what is not done yet.  f32 operands split into 3 + 3 terms,
// 6 products kept; bf16 ones are one exact term each, 1 product.
//
//   * xty: x is the Aᵀ side (rows p, K = n) and y the B side, both read
//     in place through their element strides, so the dual XXᵀ passes the
//     transposed view of X (strides (1, p)) and copies nothing.  Where y
//     is x (gram, XXᵀ) one split, rows padded to 384 for the 128-row and
//     192-row tiles alike, serves both sides.  An output with few tiles
//     runs split-K: kernels/gram.py::row_splits cuts K = n into S ranges
//     of whole 32-row stages, one product launch runs every range's tiles
//     at once into an (S, p, q) scratch, and xty_split_sum_kernel adds the
//     S partials in split order: no atomics, repeated launches are bitwise
//     equal.  Bound: tensor-core operations, 6 × 2·n·p·q, or 6 × n·p·(p+1)
//     where y is x (the output is symmetric: its upper triangle is all the
//     function must compute): 90.2 ms for a seed-path fold Gram (n =
//     55,361, p = 16,384; 112.7 ms for the refit's 69,202 rows), 0.100 ms
//     for the dual XXᵀ (n = 16,384 after the transpose, p = q = 1,000) and
//     0.398 ms for its Xᵀα (n = 1,000, p = 16,384, q = 2,000), against
//     221.8, 277.3, 0.245 and 0.978 ms at the f32 CUDA-core rate of the
//     row loop this replaced.  The kernel computes the whole square where
//     y is x, twice that bound's work, so it reaches at most half of it
//     there (engine note, "not done yet"); MOR's Xᵀα (q = 1) is bound by
//     reading x once, 0.020 ms, and the split's round trip through ~100 MB
//     of planes holds it near 0.11 ms.  Scratch: one
//     split of 3 × 16,512 × 55,392 × 2 B = 5.49 GB at the fold Gram (6.86
//     GB at the refit's; the 1.07 GB output beside it), 0.11 GB at XXᵀ
//     (plus S × 4 MB of partials), 0.10 + 0.013 GB at Xᵀα.  On an H100
//     (chip_smoke.py phases 2 and 11) a fold-Gram launch allocates 6.11
//     GiB, and the seed CV path at parcels peaks at 15.30 GiB of device
//     memory (15.20 GiB with the scratch-free row loop it replaced).
//   * xty_folds: per fold f with lo < hi, x[lo:hi] is the Aᵀ side (rows p,
//     K = hi − lo) and y[lo:hi] the B side, read in place from lo rows in,
//     and their product lands in out[f]; the folds run one after another
//     on the stream, reusing one scratch sized for the largest fold.  An
//     empty fold is a cudaMemsetAsync of its slice: exact zeros.  Bound:
//     tensor-core operations, 6 × 2·n·p·q = 2.3e14 at the parcels fit (n =
//     69,202, p = 16,384, q = 16,828): 231.5 ms at 989 TFLOP/s, against
//     569.5 ms at the f32 rate.  Scratch: 3 × 16,384 × 13,856 × 2 B = 1.36
//     GB for x and 3 × 16,896 × 13,856 × 2 B = 1.40 GB for [X | Y], where
//     one split of all 69,202 rows would take 13.8 GB.
//   * xty_folds_masked: the bf16 terms of x·w_s (the weight applied in f32
//     first, as the plain version's x.float() * w; all slots stacked as
//     the rows of one operand) and of z; one product over the kept term
//     pairs writes the (s·p, q) = (s, p, q) output.  bf16 x·w (exact in
//     f32) splits into 2 terms and bf16 z into 1, 2 products.  Bound: 6 ×
//     2·s·m·p·q = 5.4e13 at the streamed fit's chunk (m = 8,192, p =
//     16,384, q = 16,828, s = 2): 54.7 ms at 989 TFLOP/s, against 134.8 ms
//     at the f32 rate.  Scratch: 3 × 32,768 × 8,192 × 2 B = 1.61 GB for x·w
//     and 0.83 GB for z.  A 0 weight on a NaN or Inf row gives NaN, as the
//     reference keeps 0·Inf and 0·NaN rows as NaN; an all-zero slot of
//     finite rows gives an exact zero tile.  Skipping a slot's all-zero
//     stages is not done.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "split_engine.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFolds = 64;
constexpr int kMaxSplits = 64;

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

// x: (n, p) with element strides (sx0, sx1), the Aᵀ side; y: (n, q) with
// (sy0, sy1), the B side, or x itself where `same` (then only scratch_a is
// written, rows padded for both tiles).  split_rows: rows per K range, a
// multiple of kBK (0: one range); S > 1 ranges write their partials to
// part (S, p, q) and the sum kernel adds them into out (p, q) in order.
int launch_xty(bool bf16, const void* x, long long sx0, long long sx1,
               const void* y, long long sy0, long long sy1, bool same,
               void* scratch_a, void* scratch_b, void* part, void* out,
               long long n, long long p, long long q, long long split_rows,
               int device, void* stream) {
  if (n < 0 || p < 1 || q < 1 || split_rows < 0 ||
      split_rows % split_engine::kBK != 0 || (same && p != q))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long splits =
      split_rows == 0 || split_rows >= n ? 1 : (n + split_rows - 1) /
                                                   split_rows;
  if (splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(
        cudaMemsetAsync(out, 0, static_cast<size_t>(p * q) * 4, st));
  const int planes = bf16 ? 1 : 3;
  const int bn = split_engine::tile_n(q);
  const long long pad_a = same ? split_engine::shared_pad(bn)
                               : split_engine::kBM;
  const split_engine::Operand xa = {x, bf16, sx0, sx1, p, p, nullptr, false,
                                    0, 0, planes, scratch_a};
  err = split_engine::split(xa, pad_a, n, st);
  if (err == cudaSuccess && !same) {
    const split_engine::Operand yb = {y, bf16, sy0, sy1, q, q, nullptr,
                                      false, 0, 0, planes, scratch_b};
    err = split_engine::split(yb, bn, n, st);
  }
  const split_engine::Product pr = {
      scratch_a, planes, split_engine::padded(p, pad_a),
      same ? scratch_a : scratch_b, planes,
      split_engine::padded(q, same ? pad_a : bn), p, q, n,
      splits > 1 ? split_rows : 0,
      static_cast<float*>(splits > 1 ? part : out), q, q, 0, p * q};
  if (err == cudaSuccess) err = split_engine::product(pr, st);
  if (err == cudaSuccess && splits > 1) {
    const long long count = p * q;
    const long long work = (count & 3) == 0 ? count >> 2 : count;
    const long long blocks = (work + kThreads - 1) / kThreads;
    xty_split_sum_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                               : 4096),
                           kThreads, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(out), count,
        static_cast<int>(splits));
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
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
  const int bn = split_engine::tile_n(q);
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
    if (err == cudaSuccess) err = split_engine::split(yb, bn, hi - lo, st);
    const split_engine::Product pr = {
        scratch_a, planes, split_engine::padded(p, split_engine::kBM),
        scratch_b, planes, split_engine::padded(q, bn), p, q, hi - lo, 0, o,
        q, q, 0, 0};
    if (err == cudaSuccess) err = split_engine::product(pr, st);
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
  const int bn = split_engine::tile_n(q);
  const split_engine::Operand xa = {x, bf16, p, 1, s * p, p, w, bf16, s, 1,
                                    bf16 ? 2 : 3, scratch_a};
  const split_engine::Operand zb = {z, bf16, q, 1, q, q, nullptr, false, 0,
                                    0, bf16 ? 1 : 3, scratch_b};
  err = split_engine::split(xa, split_engine::kBM, m, st);
  if (err == cudaSuccess) err = split_engine::split(zb, bn, m, st);
  const split_engine::Product pr = {
      scratch_a, xa.planes, split_engine::padded(s * p, split_engine::kBM),
      scratch_b, zb.planes, split_engine::padded(q, bn), s * p, q, m, 0,
      static_cast<float*>(out), q, q, 0, 0};
  if (err == cudaSuccess) err = split_engine::product(pr, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// xty on the split engine.  x: (n, p) and y: (n, q), one dtype, with
// element strides (sx0, sx1) and (sy0, sy1), any layout; same ≠ 0: y is x;
// scratch_a, scratch_b: the engine's bf16 term planes of x and y
// (kernels/split_engine.py sizes them; scratch_b unused where same);
// part: (S, p, q) f32 where split_rows cuts n into S > 1 ranges; out:
// (p, q) f32.  Launches the split passes, the product and the sum of the
// partials on `stream` and returns the first CUDA error code that is not 0
// (0 on success).
int repro_xty_f32(const void* x, long long sx0, long long sx1, const void* y,
                  long long sy0, long long sy1, int same, void* scratch_a,
                  void* scratch_b, void* part, void* out, long long n,
                  long long p, long long q, long long split_rows, int device,
                  void* stream) {
  return launch_xty(false, x, sx0, sx1, y, sy0, sy1, same != 0, scratch_a,
                    scratch_b, part, out, n, p, q, split_rows, device,
                    stream);
}

int repro_xty_bf16(const void* x, long long sx0, long long sx1, const void* y,
                   long long sy0, long long sy1, int same, void* scratch_a,
                   void* scratch_b, void* part, void* out, long long n,
                   long long p, long long q, long long split_rows, int device,
                   void* stream) {
  return launch_xty(true, x, sx0, sx1, y, sy0, sy1, same != 0, scratch_a,
                    scratch_b, part, out, n, p, q, split_rows, device,
                    stream);
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

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
