// Host interface of the split-bf16 tensor-core engine (split_engine.cu):
//   out[b] = Aᵀ · diag(s_b) · B, f32-accurate, on wgmma (bf16 × bf16 → f32).
//
// A caller folds its batch b into the rows of Aᵀ or the columns of B, so
// the engine computes one product out = A'ᵀ · B' over a contraction index
// k.  It runs in two passes:
//   1. split(): per operand, each value v[k, row] (times its scale, in
//      f32) is cut into `planes` bf16 terms and written into scratch in the
//      layout the product kernel copies as it is;
//   2. product(): a bf16 GEMM over the kept pairs of term planes, over all
//      of K or, split-K, over S ranges of K at once into S partial slices.
// gram.cu (xty, xty_folds, xty_folds_masked) and ridge_solve.cu
// (solve_lambda_grid) are its callers; kernels/split_engine.py sizes the
// scratch.
#pragma once

#include <cuda_runtime.h>

namespace split_engine {

constexpr int kBM = 128;       // output rows per block (the Aᵀ side's tile)
constexpr int kBN = 192;       // output columns per block (the B side's tile)
constexpr int kBNNarrow = 32;  // the B side's tile where N ≤ 32
constexpr int kBK = 32;        // contraction indices per pipeline stage

// The B side's tile for an N-column product.
constexpr int tile_n(long long n) { return n <= kBNNarrow ? kBNNarrow : kBN; }

// rows rounded up to a multiple of `pad`.
constexpr long long padded(long long rows, long long pad) {
  return (rows + pad - 1) / pad * pad;
}

constexpr long long gcd(long long a, long long b) {
  return b == 0 ? a : gcd(b, a % b);
}

// The row padding of planes that both sides read (xty where y is x): a
// multiple of kBM and of the B side's tile bn (384 for kBN).
constexpr long long shared_pad(int bn) { return kBM / gcd(kBM, bn) * bn; }

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
  void* scratch;      // planes · padded(rows, pad) · padded(K, kBK) bf16
};

// Writes op's term planes with rows padded to a multiple of `pad` (a
// multiple of 8, and of every tile that reads the planes: kBM for the Aᵀ
// side, tile_n(N) for B, their least common multiple for planes both sides
// read), zeros past rows and K.  The layout does not depend on the tile:
// [K / kBK][rows / 8][plane][k % kBK / 8][row % 8][k % 8], so a tile's
// stage (all planes) is one contiguous block.  Launches on `stream`.
cudaError_t split(const Operand& op, long long pad, long long K,
                  cudaStream_t stream);

// out_s = Σ_{(i, j) kept} A_iᵀ · B_j over the contraction indices
// [s·split_k, (s + 1)·split_k) ∩ [0, K), for every split s at once (S =
// ⌈K / split_k⌉; one split when split_k is 0 or ≥ K): element (row, col)
// of split s lands at
//   out[s·split_stride + (col / nc)·cstride + row·ld + col % nc].
struct Product {
  const void* a;      // the na planes of A' ((K, M) operand), split with
  int na;             //   a_rows rows (a multiple of kBM, ≥ M)
  long long a_rows;
  const void* b;      // the nb planes of B' ((K, N)), split with b_rows
  int nb;             //   rows (a multiple of tile_n(N), ≥ N)
  long long b_rows;
  long long M, N, K;
  long long split_k;  // a multiple of kBK, or 0
  float* out;
  long long ld, nc, cstride, split_stride;
};

// Launches on `stream`.
cudaError_t product(const Product& pr, cudaStream_t stream);

}  // namespace split_engine
