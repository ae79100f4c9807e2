// Fused multi-λ eigenbasis ridge solve on Hopper, f32-accurate:
//   out[r] = Q · diag(1 / (Λ + λ_r)) · A           (r, p, t)
//
// Replaces the Pallas TPU kernel src/repro/kernels/ridge_solve.py
// (solve_lambda_grid): the λ sweep of the seed per-fold CV path
// (core/ridge.py: solve_lambda_grid with use_pallas, reached from
// ridge_cv_reference), once per CV split of a primal fit.  Q is the p × p
// eigenbasis of the split's Gram, Λ its eigenvalues, A = Qᵀ·XᵀY (p × t).
//
// It runs on the split-bf16 tensor-core engine (split_engine.cu, whose note
// has the split rule and the non-finite behaviour) in four launches:
//   1. solve_scales_kernel writes the r × p reciprocals 1/(Λ_k + λ_r) in
//      IEEE f32, first, as the TPU kernel's 1.0 / (ev + lam);
//   2. a split pass writes the bf16 terms of Q, read in place through its
//      two strides (torch.linalg.eigh returns it column-major, and a
//      contiguous copy would move 1 GiB per split at p = 16,384): three
//      terms for f32, one for bf16;
//   3. a split pass writes the three bf16 terms of A[k, j]·(1/(Λ_k + λ_r)),
//      the product rounded to f32 first as the plain version's, with the λ
//      index folded into the columns: column r·t + j, one 4,884-column axis
//      at r = 11, t = 444 (108 of 4,992 columns in 192-column tiles are
//      padding, where 128-column tiles per λ masked 13%), so each Q tile
//      is read once per column tile and not once per λ;
//   4. one tensor-core product over the kept term pairs (6 for f32 Q, 3 for
//      bf16 Q) writes column r·t + j of row i to out[r, i, j].
//
// What bounds it on this card: tensor-core operations, 6 × 2·r·p²·t = 1.6e13
// at the main path's shape (r = 11, p = 16,384, t = 444): 15.9 ms at 989
// TFLOP/s, against 39.1 ms at the f32 CUDA-core rate of the kernel it
// replaces.  Scratch (bf16, allocated by the wrapper): 3 × 16,384² × 2 B =
// 1.61 GB for Q and 3 × 4,992 × 16,384 × 2 B = 0.49 GB for the scaled A.
// Ragged p and t are zero-filled by the split passes (the TPU kernel pads
// Λ with 1.0 and A with zeros instead); there are no padding copies.
// Non-finite values: NaN where the plain version gives NaN, NaN where it
// gives ±Inf (an Inf in A splits into (Inf, NaN, NaN)).
// Not done yet (later work): Q's split is the same for every call with one
// eigenbasis, and the engine's own open items (split_engine.cu).
#include <cuda_runtime.h>

#include "split_engine.cuh"

namespace {

constexpr int kThreads = 256;

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

int launch(bool bf16, const void* q, long long sq0, long long sq1,
           const void* evals, const void* a, const void* lambdas,
           void* scales, void* scratch_a, void* scratch_b, void* out,
           long long p, long long t, int r, int device, void* stream) {
  if (r < 1 || p < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(r) * p;
  const long long cols = static_cast<long long>(r) * t;
  solve_scales_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(
      static_cast<const float*>(evals), static_cast<const float*>(lambdas),
      static_cast<float*>(scales), p, n);
  err = cudaGetLastError();
  // Aᵀ side: element (k, i) = Q[i, k]; B side: element (k, r·t + j) =
  // A[k, j] · scales[r, k].
  const split_engine::Operand qa = {q, bf16, sq1, sq0, p, p, nullptr, false,
                                    0, 0, bf16 ? 1 : 3, scratch_a};
  const split_engine::Operand ab = {a, bf16, t, 1, cols, t, scales,
                                    false, 1, p, 3, scratch_b};
  const int bn = split_engine::tile_n(cols);
  if (err == cudaSuccess)
    err = split_engine::split(qa, split_engine::kBM, p, s);
  if (err == cudaSuccess) err = split_engine::split(ab, bn, p, s);
  const split_engine::Product pr = {
      scratch_a, qa.planes, split_engine::padded(p, split_engine::kBM),
      scratch_b, ab.planes, split_engine::padded(cols, bn), p, cols, p, 0,
      static_cast<float*>(out), t, t, p * t, 0};
  if (err == cudaSuccess) err = split_engine::product(pr, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q: (p, p) with element strides (sq0, sq1), any layout; evals: (p,) f32;
// a: (p, t) row-major, q's dtype; lambdas: (r,) f32, on the device; scales:
// (r, p) f32 workspace; scratch_a, scratch_b: the engine's bf16 term planes
// of Q and of the scaled A (kernels/split_engine.py sizes them); out:
// (r, p, t) f32.  Launches on `stream` and returns the first CUDA error
// code that is not 0 (0 on success).
int repro_solve_lambda_grid_f32(const void* q, long long sq0, long long sq1,
                                const void* evals, const void* a,
                                const void* lambdas, void* scales,
                                void* scratch_a, void* scratch_b, void* out,
                                long long p, long long t, int r, int device,
                                void* stream) {
  return launch(false, q, sq0, sq1, evals, a, lambdas, scales, scratch_a,
                scratch_b, out, p, t, r, device, stream);
}

int repro_solve_lambda_grid_bf16(const void* q, long long sq0, long long sq1,
                                 const void* evals, const void* a,
                                 const void* lambdas, void* scales,
                                 void* scratch_a, void* scratch_b, void* out,
                                 long long p, long long t, int r, int device,
                                 void* stream) {
  return launch(true, q, sq0, sq1, evals, a, lambdas, scales, scratch_a,
                scratch_b, out, p, t, r, device, stream);
}

}  // extern "C"
