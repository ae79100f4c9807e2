// Per-target Pearson r on Hopper, from five f32 running sums per column:
//   r_j = (nΣxy − ΣxΣy) / max(√(max(nΣx² − (Σx)², 0)·max(nΣy² − (Σy)², 0)),
//                             1e-12)
// over the n rows of y_true (x) and y_pred (y), both (n, t) row-major.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pearsonr.py (pearson_r):
// the per-target correlation of brain-encoding evaluation, at whole-brain
// width t ≈ 265k targets × n ≈ 7.7k test rows.  The finalise is the TPU
// kernel's exactly (pearsonr.py:44-52): n is the true row count as f32, both
// variances are clamped at 0, the denominator is floored at 1e-12, so a
// constant column gives r = 0.  Its products and differences use the _rn
// intrinsics so that nvcc contracts none of them into an FMA: the raw-sums
// formula cancels where a column's mean is large against its spread, and
// rounding like the plain version keeps the two comparable there.
//
// What bounds it on this card: bytes.  Each input element is read once and
// costs 8 FLOPs; at the whole-brain shape (n = 7,689, t = 264,805, f32) the
// two inputs are 16.3 GB, 4.86 ms at 3.35 TB/s, against 0.24 ms of f32 FMA.
//
// What the design does about it:
//   * One thread per target column: consecutive threads read consecutive
//     columns of a row, so every warp load is 128 contiguous bytes (f32) and
//     nothing is read twice.  Rows are unrolled by 4 so each thread keeps 8
//     independent loads in flight.
//   * The TPU kernel walks the rows as a sequential grid axis with the sums
//     in scratch memory; here the rows are split across blockIdx.y as well,
//     so a narrow t (444 parcels: two blocks of columns) still fills the
//     card.  Each (split, column) writes its five partial sums to a
//     workspace, and a second small kernel adds them in split order and
//     finalises.  No float atomics: repeated launches give bitwise-equal r.
//   * bf16 inputs are converted with __bfloat162float at the load.  Every
//     offset is int64 (n·t is 2.0e9 at the whole-brain shape).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // columns per block
constexpr int kUnroll = 4;      // rows per step of the row loop

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid = (ceil(t / 256), splits); block = 256 threads.  Split s sums rows
// [s·rows_per_split, min(n, (s + 1)·rows_per_split)) into
// partial[s, c, col] for c = Σx, Σy, Σx², Σy², Σxy.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pearson_partial_kernel(const T* __restrict__ x, const T* __restrict__ y,
                           float* __restrict__ partial, long long n,
                           long long t, long long rows_per_split) {
  const long long col =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= t) return;
  const long long split = blockIdx.y;
  const long long lo = split * rows_per_split;
  const long long hi = lo + rows_per_split < n ? lo + rows_per_split : n;
  float sx = 0.f, sy = 0.f, sxx = 0.f, syy = 0.f, sxy = 0.f;
  const T* px = x + lo * t + col;
  const T* py = y + lo * t + col;
  long long row = lo;
  for (; row + kUnroll <= hi; row += kUnroll) {
    float xv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = to_f32(px[u * t]);
      yv[u] = to_f32(py[u * t]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      sx += xv[u];
      sy += yv[u];
      sxx = fmaf(xv[u], xv[u], sxx);
      syy = fmaf(yv[u], yv[u], syy);
      sxy = fmaf(xv[u], yv[u], sxy);
    }
    px += kUnroll * t;
    py += kUnroll * t;
  }
  for (; row < hi; ++row) {
    const float xv = to_f32(*px), yv = to_f32(*py);
    sx += xv;
    sy += yv;
    sxx = fmaf(xv, xv, sxx);
    syy = fmaf(yv, yv, syy);
    sxy = fmaf(xv, yv, sxy);
    px += t;
    py += t;
  }
  float* o = partial + split * 5 * t + col;
  o[0] = sx;
  o[t] = sy;
  o[2 * t] = sxx;
  o[3 * t] = syy;
  o[4 * t] = sxy;
}

// grid = ceil(t / 256); block = 256 threads.  Adds the splits' partial sums
// in split order and finalises with the true row count n.
__global__ void __launch_bounds__(kThreads)
    pearson_finalize_kernel(const float* __restrict__ partial,
                            float* __restrict__ out, long long t, int splits,
                            float n) {
  const long long col =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= t) return;
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {
    const float* src = partial + static_cast<long long>(sp) * 5 * t + col;
#pragma unroll
    for (int c = 0; c < 5; ++c) s[c] += src[c * t];
  }
  const float sx = s[0], sy = s[1], sxx = s[2], syy = s[3], sxy = s[4];
  const float num = __fsub_rn(__fmul_rn(n, sxy), __fmul_rn(sx, sy));
  const float var_x = fmaxf(__fsub_rn(__fmul_rn(n, sxx), __fmul_rn(sx, sx)),
                            0.f);
  const float var_y = fmaxf(__fsub_rn(__fmul_rn(n, syy), __fmul_rn(sy, sy)),
                            0.f);
  const float den = sqrtf(__fmul_rn(var_x, var_y));
  out[col] = __fdiv_rn(num, fmaxf(den, 1e-12f));
}

template <typename T>
int launch(const void* x, const void* y, void* partial, void* out,
           long long n, long long t, int splits, int device, void* stream) {
  if (n < 0 || t < 1 || splits < 1 || splits > 65535 ||
      (t + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows_per_split = n > 0 ? (n + splits - 1) / splits : 1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned col_blocks =
      static_cast<unsigned>((t + kThreads - 1) / kThreads);
  pearson_partial_kernel<T><<<dim3(col_blocks, splits), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<float*>(partial), n, t, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pearson_finalize_kernel<<<col_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), t, splits,
      static_cast<float>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x = y_true, y = y_pred: (n, t) row-major, one dtype; partial: (splits, 5,
// t) f32 workspace; out: (t,) f32.  The rows are split into `splits` ranges
// of ceil(n / splits) rows (the wrapper picks splits so none is empty).
// Launches both kernels on `stream` and returns the first cudaGetLastError()
// code that is not 0 (0 on success).
int repro_pearson_r_f32(const void* x, const void* y, void* partial,
                        void* out, long long n, long long t, int splits,
                        int device, void* stream) {
  return launch<float>(x, y, partial, out, n, t, splits, device, stream);
}

int repro_pearson_r_bf16(const void* x, const void* y, void* partial,
                         void* out, long long n, long long t, int splits,
                         int device, void* stream) {
  return launch<__nv_bfloat16>(x, y, partial, out, n, t, splits, device,
                               stream);
}

}  // extern "C"
