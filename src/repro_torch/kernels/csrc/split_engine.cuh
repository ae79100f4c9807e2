// Host interface of the split-bf16 tensor-core engine (split_engine.cu):
//   out[b] = Aᵀ · diag(s_b) · B, f32-accurate, on wgmma (bf16 × bf16 → f32).
//
// A caller folds its batch b into the rows of Aᵀ or the columns of B, so
// the engine computes one product out = A'ᵀ · B' over a contraction index
// k.  It runs in two passes:
//   1. split(): per operand, each value v[k, row] (times its scale, in
//      f32) is cut into `planes` bf16 terms and written into scratch in the
//      K-major tile layout the product kernel copies as it is;
//   2. product(): a bf16 GEMM over the kept pairs of term planes.
// gram.cu (xty_folds, xty_folds_masked) and ridge_solve.cu
// (solve_lambda_grid) are its callers; kernels/split_engine.py sizes the
// scratch.
#pragma once

#include <cuda_runtime.h>

namespace split_engine {

constexpr int kBM = 128;  // output rows per block (the Aᵀ side's tile)
constexpr int kBN = 192;  // output columns per block (the B side's tile)
constexpr int kBK = 32;   // contraction indices per pipeline stage

// One operand, read as v[k, row] for k < K and row < rows:
//   v[k, row] = src[k·sk + (row % inner)·si]
//               · scale[k·ssk + (row / inner)·ssg]   (f32, if scale)
// Element strides are int64; src and scale are f32 or bf16.
struct Operand {
  const void* src;
  bool src_bf16;
  long long sk, si;
  long long rows, inner;
  const void* scale;  // null: no scale
  bool scale_bf16;
  long long ssk, ssg;
  int planes;         // bf16 terms kept per value: 1, 2 or 3
  void* scratch;      // planes · ⌈rows / tile⌉·tile · ⌈K / kBK⌉·kBK bf16
};

// Writes op's term planes for tiles of `tile_rows` rows (kBM for the Aᵀ
// side, kBN for B), zeros past rows and K.  Launches on `stream`.
cudaError_t split(const Operand& op, int tile_rows, long long K,
                  cudaStream_t stream);

// out = Σ_{(i, j) kept} A_iᵀ · B_j for the na planes of a (the split of
// an (K, M) operand) and the nb planes of b (K, N): element (row, col)
// lands at out[(col / nc)·cstride + row·ld + col % nc].  Launches on
// `stream`.
cudaError_t product(const void* a, int na, const void* b, int nb,
                    long long M, long long N, long long K, float* out,
                    long long ld, long long nc, long long cstride,
                    cudaStream_t stream);

}  // namespace split_engine
