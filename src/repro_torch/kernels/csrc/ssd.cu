// Mamba2 SSD within-chunk term on Hopper, f32 arithmetic:
//   y[n, q, h, p] = Σ_{k ≤ q} exp(la[n, q, h] − la[n, k, h]) · cb[n, q, k]
//                   · x[n, k, h, p]
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (ssd_intra): the
// attention-like term of every Mamba2 block's chunked SSD forward
// (models/ssm.py, when ssm.use_kernel is on and n_groups == 1).  cb (N, Q, Q)
// holds the chunk's C_q·B_k scores, la (N, Q, H) the within-chunk cumulative
// log decay, x (N, Q, H, P) the Δt-scaled inputs; the output is f32.  The
// mask k ≤ q is applied before the exp, as the reference does in log space,
// so the upper triangle never overflows; where the reference multiplies the
// masked zeros by cb, this kernel skips those products (the two differ only
// for a non-finite cb above the diagonal).
//
// What bounds it on this card: at the main path's shape (N = 128 chunks,
// Q = 256, H = 80, P = 64) the term needs 2·N·H·P·Q(Q+1)/2 = 4.3e10 f32
// FLOPs (0.64 ms at 67 TFLOP/s) against ~1.4 GB of x and y (0.42 ms at
// 3.35 TB/s): close to balanced, with operations the larger.  The
// reference's XLA chain (and the plain version) writes the (N, Q, Q, H)
// decay·score tensor, 2.7 GB, several times; this kernel never does.
//
// What the design does about it:
//   * One block per (chunk n, head h, 64-row q tile, 64-column p tile),
//     256 threads.  At Q = 256 a whole f32 cb tile is 256 KiB, more than a
//     block's 227 KB of shared memory, so the q rows are tiled: the block
//     walks k in stages of 16 up to the tile's last row (k ≤ q), staging
//     L[q, k] = exp(la_q − la_k)·cb[q, k] (built on the fly, masked) and
//     x[k, h, p0 : p0 + 64] in shared memory, 8 KB a stage.  Heavier (later)
//     q tiles start first.
//   * Register blocking: thread (ty, tx) owns rows 4·ty … 4·ty + 3 and
//     columns 4·tx … 4·tx + 3 of the 64 × 64 output tile, 16 FMAs per pair
//     of 16-byte shared loads.
//   * Each thread's four la_q values are read once; a stage needs one la_k
//     per thread and one exp per staged L element (4 per 256 FMAs).
//   * bf16 inputs are converted with __bfloat162float at the load.
// Not done yet (later work): sharing a cb stage across several heads, a
// double-buffered stage, tensor-core products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // q rows per block
constexpr int kCols = 64;      // p columns per block
constexpr int kStage = 16;     // k per shared-memory stage
constexpr int kThreads = 256;
constexpr int kLds = kRows + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid = (N, H, q tiles · p tiles); block = 256 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_kernel(const T* __restrict__ cb, const T* __restrict__ la,
                     const T* __restrict__ x, float* __restrict__ out, int Q,
                     int H, int P, int n_ptiles) {
  // Ls[kk][r] = L[q0 + r, k0 + kk];  Xs[kk][c] = x[k0 + kk, h, p0 + c].
  __shared__ __align__(16) float Ls[kStage][kLds];
  __shared__ __align__(16) float Xs[kStage][kCols];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long n = blockIdx.x;
  const int h = blockIdx.y;
  const int n_qtiles = gridDim.z / n_ptiles;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.z) / n_ptiles;
  const int q0 = qt * kRows;
  const int p0 = (static_cast<int>(blockIdx.z) % n_ptiles) * kCols;
  const long long HP = static_cast<long long>(H) * P;

  // This thread stages L rows r_e = ty + 16·e (e < 4) at column kk = tx.
  float la_q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int qq = q0 + ty + 16 * e;
    la_q[e] = qq < Q ? to_f32(la[(n * Q + qq) * H + h]) : 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int k_end = min(Q, q0 + kRows);
  for (int k0 = 0; k0 < k_end; k0 += kStage) {
    const int kk = tx;
    const int kpos = k0 + kk;
    const float la_k = kpos < Q ? to_f32(la[(n * Q + kpos) * H + h]) : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ty + 16 * e;
      const int qq = q0 + r;
      float val = 0.f;
      if (qq < Q && kpos <= qq)
        val = expf(la_q[e] - la_k) * to_f32(cb[(n * Q + qq) * Q + kpos]);
      Ls[kk][r] = val;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + kThreads * e;
      const int sk = idx / kCols, c = idx % kCols;
      const int kp = k0 + sk, pp = p0 + c;
      const long long off = (n * Q + kp) * HP +
                            static_cast<long long>(h) * P + pp;
      Xs[sk][c] = (kp < Q && pp < P) ? to_f32(x[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(&Ls[s][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Xs[s][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qq = q0 + ty * 4 + i;
    if (qq >= Q) continue;
    float* orow = out + (n * Q + qq) * HP + static_cast<long long>(h) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + tx * 4 + j;
      if (pp < P) orow[pp] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* cb, const void* la, const void* x, void* out,
           long long N, int Q, int H, int P, int device, void* stream) {
  const int n_qtiles = (Q + kRows - 1) / kRows;
  const int n_ptiles = (P + kCols - 1) / kCols;
  if (N < 1 || N > 0x7fffffffLL || Q < 1 || H < 1 || H > 65535 || P < 1 ||
      static_cast<long long>(n_qtiles) * n_ptiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(N), static_cast<unsigned>(H),
                  static_cast<unsigned>(n_qtiles * n_ptiles));
  ssd_intra_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(cb), static_cast<const T*>(la),
          static_cast<const T*>(x), static_cast<float*>(out), Q, H, P,
          n_ptiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cb: (N, Q, Q), la: (N, Q, H), x: (N, Q, H, P), all contiguous and of one
// dtype; out: (N, Q, H, P) f32.  Launches on `stream` and returns the
// cudaGetLastError() code of the launch (0 on success).
int repro_ssd_intra_f32(const void* cb, const void* la, const void* x,
                        void* out, long long N, int Q, int H, int P,
                        int device, void* stream) {
  return launch<float>(cb, la, x, out, N, Q, H, P, device, stream);
}

int repro_ssd_intra_bf16(const void* cb, const void* la, const void* x,
                         void* out, long long N, int Q, int H, int P,
                         int device, void* stream) {
  return launch<__nv_bfloat16>(cb, la, x, out, N, Q, H, P, device, stream);
}

}  // extern "C"
