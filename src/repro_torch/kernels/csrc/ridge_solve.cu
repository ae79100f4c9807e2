// Fused multi-λ eigenbasis ridge solve on Hopper, f32 arithmetic:
//   out[r] = Q · diag(1 / (Λ + λ_r)) · A           (r, p, t)
//
// Replaces the Pallas TPU kernel src/repro/kernels/ridge_solve.py
// (solve_lambda_grid): the λ sweep of the seed per-fold CV path
// (core/ridge.py: solve_lambda_grid with use_pallas, reached from
// ridge_cv_reference), once per CV split of a primal fit.  Q is the p × p
// eigenbasis of the split's Gram, Λ its eigenvalues, A = Qᵀ·XᵀY (p × t).
// As in the TPU kernel, A is scaled by 1/(Λ_k + λ_r) as its tile is staged
// on chip, the reciprocal computed first in f32 and then multiplied, so the
// rescaled (r, p, t) operand never exists in memory: a first small kernel
// writes the r × p reciprocals (720 KB at the main path's shape), the main
// kernel multiplies each staged A row by its one.
//
// What bounds it on this card: f32 arithmetic.  The reference accumulates in
// f32 (preferred_element_type), so the port uses no TF32 tensor-core `mma`;
// each output element costs 2·p FLOPs of f32 FMA on the CUDA cores (67
// TFLOP/s on an H100 SXM at 700 W).  At the main path's shape (r = 11,
// p = 16,384, t = 444) that is 2.6e12 FLOPs against ~1.4 GB of Q, A and
// out: bound by operations (~39 ms against ~0.4 ms of bytes).
//
// What the design does about it:
//   * One block per (λ index r, 128-row i tile of Q, 128-column j tile of
//     A), 256 threads, 8×8 f32 accumulators each (the register blocking of
//     gram.cu).  The block loops over k in stages of 8: the Q tile
//     (128 rows × 8 k) and the scaled A tile (8 k × 128 columns) are
//     double-buffered in shared memory, the next stage loaded from global
//     memory into registers while the current one is multiplied.
//   * Q is read in place through its two strides.  torch.linalg.eigh
//     returns a column-major Q (strides (1, p)), and a row-major copy would
//     move 1 GiB per split at p = 16,384; with stride(0) == 1 consecutive
//     threads take consecutive rows i of one column k, otherwise (row-major
//     Q) consecutive k of one row.  Either way the stage lands as xs[k][i],
//     its rows padded to 132 floats so both store patterns are free of bank
//     conflicts and the 16-byte reads of the product stay aligned.
//   * The scale is applied when a prefetched stage is stored to shared
//     memory, after the current stage's FMAs, so the A and scale loads stay
//     in flight behind them, and the loop divides nothing.
//   * Ragged p and t are masked at the loads and the store: a k ≥ p loads
//     zeros and gets scale 0 (the TPU kernel pads Λ with 1.0 and A with
//     zeros instead); there are no padding copies.
//   * bf16 Q and A are converted with __bfloat162float at the load; Λ and λ
//     are f32.  Every offset is int64.
// Not done yet (later work): each Q tile is read once per λ (11 times from
// L2/HBM at the main path's shape); a block that keeps all r accumulators,
// or loops over r with the Q stage resident, would share it.  The t = 444
// columns fill 4 j tiles of 128 (13% of the last tile's work is masked).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockI = 128;   // output rows per block (rows of Q)
constexpr int kBlockJ = 128;   // output columns per block (columns of A)
constexpr int kStageK = 8;     // contraction indices per shared stage
constexpr int kThreads = 256;
constexpr int kLdq = kBlockI + 4;   // padded row of the Q stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Q stage: xs[kk][ii] = Q[i0 + ii, k0 + kk] for kk < 8, ii < 128 (0 outside
// the matrix).  Each thread holds 4 values in reg and their (kk, ii) slots.
template <typename T>
__device__ __forceinline__ void load_q(const T* __restrict__ q, long long sq0,
                                       long long sq1, bool k_contig,
                                       long long i0, long long k0,
                                       long long p, int tid, float (&reg)[4],
                                       int (&slot)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int kk, ii;
    if (k_contig) {            // row-major Q: 8 consecutive k of one row
      const int idx = tid + kThreads * e;
      kk = idx & (kStageK - 1);
      ii = idx >> 3;
    } else {                   // column-major Q: 32 consecutive rows of one k
      kk = tid >> 5;
      ii = (tid & 31) + 32 * e;
    }
    const long long i = i0 + ii;
    const long long k = k0 + kk;
    reg[e] = (i < p && k < p) ? to_f32(q[i * sq0 + k * sq1]) : 0.f;
    slot[e] = kk * kLdq + ii;
  }
}

// A stage, loaded: reg = A[k0 + kk, j0 + jj] for this thread's row kk and
// columns jj (0 outside the matrix), sc = 1/(Λ_k + λ) (0 for k ≥ p).  The
// scale is applied only when the stage is stored (store_a), after the
// product of the current stage: the loads stay in flight behind the FMAs
// instead of stalling the thread before them.
template <typename T>
__device__ __forceinline__ void load_a(const T* __restrict__ a,
                                       const float* __restrict__ scale,
                                       long long k0, long long j0,
                                       long long p, long long t, int tid,
                                       float (&reg)[4], float& sc) {
  const long long k = k0 + (tid >> 5);
  const int lane = tid & 31;
  const bool k_ok = k < p;
  sc = k_ok ? scale[k] : 0.f;
  const T* row = a + k * t;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long j = j0 + lane + 32 * e;
    reg[e] = (k_ok && j < t) ? to_f32(row[j]) : 0.f;
  }
}

__device__ __forceinline__ void store_q(float* xs, const float (&reg)[4],
                                        const int (&slot)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) xs[slot[e]] = reg[e];
}

// ys[kk][jj] = A[k, j] · (1 / (Λ_k + λ)), the product in f32.
__device__ __forceinline__ void store_a(float (*ys)[kBlockJ], int tid,
                                        float sc, const float (&reg)[4]) {
  const int kk = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int e = 0; e < 4; ++e) ys[kk][lane + 32 * e] = reg[e] * sc;
}

// scale[r, k] = 1 / (Λ_k + λ_r) in f32 (IEEE division, as the TPU kernel's
// 1.0 / (ev + lam)).  grid = ceil(r·p / 256); block = 256 threads.
__global__ void __launch_bounds__(kThreads)
    solve_scales_kernel(const float* __restrict__ evals,
                        const float* __restrict__ lambdas,
                        float* __restrict__ scale, long long p,
                        long long n) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx < n) scale[idx] = 1.0f / (evals[idx % p] + lambdas[idx / p]);
}

// grid = (ceil(t / 128), ceil(p / 128), r); block = 256 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    solve_lambda_grid_kernel(const T* __restrict__ q, long long sq0,
                             long long sq1, const T* __restrict__ a,
                             const float* __restrict__ scales,
                             float* __restrict__ out, long long p,
                             long long t) {
  __shared__ __align__(16) float xs[2][kStageK * kLdq];
  __shared__ __align__(16) float ys[2][kStageK][kBlockJ];
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group of the 8×8 micro-tile
  const int ty = tid >> 4;   // row group
  const long long r = blockIdx.z;
  const long long i0 = static_cast<long long>(blockIdx.y) * kBlockI;
  const long long j0 = static_cast<long long>(blockIdx.x) * kBlockJ;
  const float* scale = scales + r * p;
  const bool k_contig = sq1 == 1 && sq0 != 1;

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;

  float rq[4], ra[4], sc;
  int slot[4];
  load_q(q, sq0, sq1, k_contig, i0, 0, p, tid, rq, slot);
  load_a(a, scale, 0, j0, p, t, tid, ra, sc);
  store_q(xs[0], rq, slot);
  store_a(ys[0], tid, sc, ra);
  __syncthreads();
  int buf = 0;
  for (long long k0 = 0; k0 < p; k0 += kStageK) {
    const bool has_next = k0 + kStageK < p;
    if (has_next) {
      load_q(q, sq0, sq1, k_contig, i0, k0 + kStageK, p, tid, rq, slot);
      load_a(a, scale, k0 + kStageK, j0, p, t, tid, ra, sc);
    }
#pragma unroll
    for (int kk = 0; kk < kStageK; ++kk) {
      const float* xrow = xs[buf] + kk * kLdq;
      const float4 a0 = *reinterpret_cast<const float4*>(xrow + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xrow + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(&ys[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ys[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
    }
    if (has_next) {
      // The other buffer was last read before the previous barrier.
      store_q(xs[buf ^ 1], rq, slot);
      store_a(ys[buf ^ 1], tid, sc, ra);
    }
    __syncthreads();
    buf ^= 1;
  }

  float* o = out + r * p * t;
  const bool vec = (t & 3) == 0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const long long i = i0 + (m < 4 ? ty * 4 + m : 64 + ty * 4 + (m - 4));
    if (i >= p) continue;
    float* orow = o + i * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long j = j0 + h * 64 + tx * 4;
      if (vec && j + 3 < t) {
        *reinterpret_cast<float4*>(orow + j) =
            make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2],
                        acc[m][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < t) orow[j + e] = acc[m][4 * h + e];
      }
    }
  }
}

template <typename T>
int launch(const void* q, long long sq0, long long sq1, const void* evals,
           const void* a, const void* lambdas, void* scales, void* out,
           long long p, long long t, int r, int device, void* stream) {
  if (r < 1 || r > 65535 || p < 1 || t < 1 ||
      (p + kBlockI - 1) / kBlockI > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(r) * p;
  solve_scales_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(
      static_cast<const float*>(evals), static_cast<const float*>(lambdas),
      static_cast<float*>(scales), p, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((t + kBlockJ - 1) / kBlockJ),
                  static_cast<unsigned>((p + kBlockI - 1) / kBlockI),
                  static_cast<unsigned>(r));
  solve_lambda_grid_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), sq0, sq1, static_cast<const T*>(a),
      static_cast<const float*>(scales), static_cast<float*>(out), p, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (p, p) with element strides (sq0, sq1), any layout; evals: (p,) f32;
// a: (p, t) row-major, q's dtype; lambdas: (r,) f32, on the device; scales:
// (r, p) f32 workspace; out: (r, p, t) f32.  Launches both kernels on
// `stream` and returns the first cudaGetLastError() code that is not 0 (0
// on success).
int repro_solve_lambda_grid_f32(const void* q, long long sq0, long long sq1,
                                const void* evals, const void* a,
                                const void* lambdas, void* scales, void* out,
                                long long p, long long t, int r, int device,
                                void* stream) {
  return launch<float>(q, sq0, sq1, evals, a, lambdas, scales, out, p, t, r,
                       device, stream);
}

int repro_solve_lambda_grid_bf16(const void* q, long long sq0, long long sq1,
                                 const void* evals, const void* a,
                                 const void* lambdas, void* scales, void* out,
                                 long long p, long long t, int r, int device,
                                 void* stream) {
  return launch<__nv_bfloat16>(q, sq0, sq1, evals, a, lambdas, scales, out,
                               p, t, r, device, stream);
}

}  // extern "C"
