// Streaming-softmax attention on Hopper, f32 arithmetic:
//   o[b, s, h] = Σ_t softmax_t(mask(softcap(q[b, s, h] · k[b, t, h / g])))
//                · v[b, t, h / g]
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, with its model-layout wrapper mha_flash): the attention
// of the shared transformer block of the hybrid backbones
// (models/layers.py, when cfg.flash_kernel is on).  q is pre-scaled; k and v
// carry n_kv heads, and query head h reads kv head h / g (g = H / n_kv), so
// grouped heads are indexed in place instead of expanded in memory.  The
// masking is the reference's: softcap tanh(s / c)·c before the mask, masked
// scores set to NEG = -1e30 (not −inf, so a row with nothing visible yet
// carries exp(0) = 1 terms that the first visible score's correction
// exp(NEG − m) = 0 wipes out), causal (t ≤ s), window (s − t < window), and
// the final acc / max(l, 1e-30).  Keys at t ≥ T are masked, so no length
// needs padding.
//
// What bounds it on this card: f32 arithmetic.  The reference keeps scores,
// probabilities and the accumulator in f32, so the port uses no tensor-core
// mma: each (query, visible key) pair costs 4·K FLOPs of f32 FMA on the CUDA
// cores (67 TFLOP/s on an H100 SXM at 700 W).  At the main path's shape
// (B·H = 256, S = T = 4,096, K = 80, causal) that is 6.9e11 FLOPs against
// ~0.5 GB of q, k, v and o: bound by operations by a factor of ~60.
//
// What the design does about it:
//   * One block per (batch·head, 64-query tile), 256 threads.  The q tile is
//     staged once in shared memory; the block loops over 64-key tiles with
//     the running max m, sum l and the (64 × K) accumulator in registers.
//     Blocks of the heaviest (last) query tiles start first.
//   * Tiles that lie wholly outside the causal band or the window are not
//     visited; the mask inside a visited tile is exact.
//   * Register blocking: thread (ty, tx) of a 16 × 16 grid owns score rows
//     4·ty … 4·ty + 3 and key columns 4·tx … 4·tx + 3 (16 FMAs per pair of
//     16-byte shared loads), the row max and sum reduce over the 16 lanes of
//     a half-warp with shuffles, and for P·V it owns the same 4 rows and
//     head-dimension columns tx, tx + 16, … (DPT of them, DPT = ⌈K / 16⌉
//     rounded up to 1, 2, 4, 5, 8 or 16, so K = 80 wastes nothing).
//   * Any K ≤ 256: the shared memory is sized at launch (dynamic, up to
//     222 KB at K = 256, 81 KB at K = 80).
//   * bf16 inputs are converted with __bfloat162float at the load; the
//     output is rounded to the input type (__float2bfloat16, nearest even).
// Not done yet (later work): bf16 tensor-core products (wgmma) for Q·Kᵀ, a
// TMA pipeline for the k/v tiles, and keeping the 4 query rows' q in
// registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;
constexpr int kLds = kBQ + 4;     // padded stride of the transposed tiles
constexpr float kNeg = -1e30f;
constexpr int kMaxK = 256;

// Element strides (batch, sequence, head) of q, k, v and o; the head
// dimension is contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           const Strides st, int H, int G, int S, int Tn,
                           int K, int causal, int window, float softcap) {
  constexpr int KP = 16 * DPT;    // head dimension padded for P·V
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [K][kLds]:  Qs[d][r] = q[q0 + r, d]
  float* Ks = Qs + K * kLds;      // [K][kLds]:  Ks[d][c] = k[k0 + c, d]
  float* Vs = Ks + K * kLds;      // [kBK][KP]:  Vs[c][d] = v[k0 + c, d]
  float* Ps = Vs + kBK * KP;      // [kBK][kLds]: Ps[c][r] = p[r, c]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long bh = blockIdx.x;
  const long long b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int n = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + n * st.k[2];
  const T* vb = v + b * st.v[0] + n * st.v[2];

  for (int idx = tid; idx < kBQ * K; idx += kThreads) {
    const int r = idx / K, d = idx - r * K;
    const int s = q0 + r;
    Qs[d * kLds + r] = s < S ? to_f32(qb[s * st.q[1] + d]) : 0.f;
  }

  int kt_end = (Tn + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    // A tile holds a pair with s − t < window iff k0 ≥ q0 − window − 62.
    const int lo = q0 - window - kBK + 2;
    kt_begin = lo > 0 ? (lo + kBK - 1) / kBK : 0;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P·V is done with Vs and Ps
    for (int idx = tid; idx < kBK * K; idx += kThreads) {
      const int c = idx / K, d = idx - c * K;
      const int t = k0 + c;
      Ks[d * kLds + c] = t < Tn ? to_f32(kb[t * st.k[1] + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * KP; idx += kThreads) {
      const int c = idx / KP, d = idx - c * KP;
      const int t = k0 + c;
      Vs[idx] = (t < Tn && d < K) ? to_f32(vb[t * st.v[1] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < K; ++d) {
      const float4 a =
          *reinterpret_cast<const float4*>(&Qs[d * kLds + ty * 4]);
      const float4 c =
          *reinterpret_cast<const float4*>(&Ks[d * kLds + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float val = s[i][j];
        if (softcap > 0.f) val = tanhf(val / softcap) * softcap;
        bool ok = kpos < Tn;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[i][j] = ok ? val : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * kLds + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(&Ps[c * kLds + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = Vs[c * KP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + b * st.o[0] + h * st.o[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < K) from_f32(acc[i][j] / den, &ob[s * st.o[1] + d]);
    }
  }
}

template <typename T, int DPT>
int launch_dpt(const void* q, const void* k, const void* v, void* o,
               const Strides& st, long long B, int H, int G, int S, int Tn,
               int K, int causal, int window, float softcap,
               cudaStream_t stream) {
  constexpr int KP = 16 * DPT;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(K) * kLds + kBK * KP +
                       kBK * kLds);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_attention_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, H, G, S, Tn, K,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* strides, long long B, int H, int n_kv, int S,
           int Tn, int K, int causal, int window, float softcap, int device,
           void* stream) {
  if (K < 1 || K > kMaxK || H < 1 || n_kv < 1 || H % n_kv != 0 || S < 1 ||
      Tn < 1 || B < 1 || B * H > 0x7fffffffLL || S > 65535LL * kBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / n_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dpt = (K + 15) / 16;
  if (dpt <= 1)
    return launch_dpt<T, 1>(q, k, v, o, st, B, H, G, S, Tn, K, causal,
                            window, softcap, s);
  if (dpt <= 2)
    return launch_dpt<T, 2>(q, k, v, o, st, B, H, G, S, Tn, K, causal,
                            window, softcap, s);
  if (dpt <= 4)
    return launch_dpt<T, 4>(q, k, v, o, st, B, H, G, S, Tn, K, causal,
                            window, softcap, s);
  if (dpt <= 5)
    return launch_dpt<T, 5>(q, k, v, o, st, B, H, G, S, Tn, K, causal,
                            window, softcap, s);
  if (dpt <= 8)
    return launch_dpt<T, 8>(q, k, v, o, st, B, H, G, S, Tn, K, causal,
                            window, softcap, s);
  return launch_dpt<T, 16>(q, k, v, o, st, B, H, G, S, Tn, K, causal, window,
                           softcap, s);
}

}  // namespace

extern "C" {

// q: (B, S, H, K), k/v: (B, T, n_kv, K), o: (B, S, H, K), all of one dtype,
// addressed through `strides` (12 int64 in host memory: the batch, sequence
// and head strides of q, k, v, o, in elements; the head dimension is
// contiguous).  1 ≤ K ≤ 256, H % n_kv == 0; window ≤ 0 means no window and
// softcap ≤ 0 no softcap.  Launches on `stream` and returns the
// cudaGetLastError() code of the launch (0 on success).
int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, const long long* strides, long long B,
                              int H, int n_kv, int S, int T, int K, int causal,
                              int window, float softcap, int device,
                              void* stream) {
  return launch<float>(q, k, v, o, strides, B, H, n_kv, S, T, K, causal,
                       window, softcap, device, stream);
}

int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, long long B,
                               int H, int n_kv, int S, int T, int K,
                               int causal, int window, float softcap,
                               int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, B, H, n_kv, S, T, K,
                               causal, window, softcap, device, stream);
}

}  // extern "C"
