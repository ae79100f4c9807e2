// Streaming-softmax attention on Hopper:
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
// needs padding; tiles wholly outside the causal band or the window are not
// visited.  The reference keeps scores, probabilities and the accumulator in
// f32.  There are two kernels, chosen by dtype (not a fallback: a bf16 launch
// that fails raises):
//
// bf16 inputs — tensor cores (flash_attention_tc_kernel).
//   What bounds it: at the main path's shape (B·H = 256, S = T = 4,096,
//   K = 80, causal) the four bf16 products below are 1.4e12 FLOPs, 1.39 ms at
//   989 TFLOP/s; the 2.1e9 exponentials take 0.56 ms at the SFU rate and the
//   bytes 0.2 ms.  In practice the softmax's per-score work on the CUDA
//   cores (max, exp, sum, the split below: ~12 instructions a score) is the
//   longer pole; the products run beside it.
//   What the design does:
//   * Q·Kᵀ: a product of two bf16 values is exact in f32, so wgmma
//     (bf16 × bf16 → f32) gives the reference's products; only the order of
//     summation changes.
//   * P·V: P is f32.  Each p splits into three bf16 terms, each the top 16
//     bits (bf16 rounded toward zero) of what is left: p₁ of p, p₂ of
//     p − p₁, p₃ of p − p₁ − p₂, with p₁ + p₂ + p₃ = p exactly (3 × 8
//     significand bits cover f32's 24; each residual is exact in f32; only
//     p < 2⁻¹¹⁰ can lose bits below 2⁻¹³³).  So each pᵢ·v is exact in f32,
//     and three wgmmas with A from registers (the S accumulator's layout is
//     the A fragment's; a pair's top halves pack with one byte-permute) into
//     one f32 accumulator give the reference's products, summed in another
//     order.  kernels/ref.py::bf16_split3 is the plain version of the split.
//   * One block per (batch·head, 192-query tile), heaviest tiles first,
//     as in the f32 kernel.  Three consumer warpgroups own 64 query rows
//     each, with the running max, sum and the (64 × K) output accumulator
//     in registers in the wgmma layout;
//     a producer warpgroup (setmaxnreg gives its registers to them) loads
//     the q tile once and each 64-key k/v tile into a ring of up to four
//     stages with TMA, handing tiles over through mbarriers (full: bytes
//     landed; empty: one arrival per consumer warp).  Strided q/k/v and
//     grouped kv heads are read in place: each operand's tensor map is 4-D
//     (head dimension, then rows, heads and batch in stride order).
//   * Shared memory holds each tile as [8-column group][rows][8] (wgmma's
//     no-swizzle core matrices, one TMA box per group): q and k K-major, so
//     K = 80 is five 16-column k-steps with nothing padded to 128, v
//     MN-major (the transposed-B operand).  The head dimension is
//     zero-padded to a multiple of 16 (up to 256: 96 → 2 × 48-column P·V
//     chunks, 112 → 128, 144/160 → 160, 176/192 → 192, above → 256); TMA
//     fills the padding and rows past S or T with zeros, which add exact
//     zeros.
//   * A warpgroup skips the diagonal tile wholly in its rows' future, the
//     mask and softcap run only on tiles that need them, exponentials are
//     ex2.approx of (s − m)·log₂e, and O is rescaled only when a warp's
//     running max moved.
//   * When TMA cannot take an operand (K % 8 ≠ 0, or a stride or base not
//     16-byte aligned) the producer's first warp copies it element by
//     element into the same layout.
// f32 inputs — CUDA cores (flash_attention_kernel).  A tensor-core Q·Kᵀ
//   would round f32 q and k, so each (query, visible key) pair costs 4·K
//   FLOPs of f32 FMA (67 TFLOP/s on an H100 SXM at 700 W).  One block per
//   (batch·head, 64-query tile), 256 threads; thread (ty, tx) of a 16 × 16
//   grid owns 4 score rows × 4 key columns and, for P·V, the same 4 rows ×
//   DPT head-dimension columns (DPT = ⌈K / 16⌉ rounded up to 1, 2, 4, 5, 8
//   or 16); row max and sum reduce over a half-warp with shuffles.  Shared
//   memory is sized at launch (up to 222 KB at K = 256).
// Not done yet (later work): overlapping a warpgroup's softmax with its own
// next products (measured slower here, with turn-taking between warpgroups
// too), swizzled 32-byte TMA boxes (half the row requests), a 128-key tile,
// and a lighter split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cuda.h>
#include <dlfcn.h>

#include <cstdint>

#include "hopper.cuh"

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

template <int DPT>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + n * st.k[2];
  const float* vb = v + b * st.v[0] + n * st.v[2];

  for (int idx = tid; idx < kBQ * K; idx += kThreads) {
    const int r = idx / K, d = idx - r * K;
    const int s = q0 + r;
    Qs[d * kLds + r] = s < S ? qb[s * st.q[1] + d] : 0.f;
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
      Ks[d * kLds + c] = t < Tn ? kb[t * st.k[1] + d] : 0.f;
    }
    for (int idx = tid; idx < kBK * KP; idx += kThreads) {
      const int c = idx / KP, d = idx - c * KP;
      const int t = k0 + c;
      Vs[idx] = (t < Tn && d < K) ? vb[t * st.v[1] + d] : 0.f;
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

  float* ob = o + b * st.o[0] + h * st.o[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < K) ob[s * st.o[1] + d] = acc[i][j] / den;
    }
  }
}

template <int DPT>
int launch_dpt(const void* q, const void* k, const void* v, void* o,
               const Strides& st, long long B, int H, int G, int S, int Tn,
               int K, int causal, int window, float softcap,
               cudaStream_t stream) {
  constexpr int KP = 16 * DPT;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(K) * kLds + kBK * KP +
                       kBK * kLds);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_attention_kernel<DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, H, G, S, Tn, K,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kTcWarpgroups = 3;               // consumer warpgroups
constexpr int kTcBQ = 64 * kTcWarpgroups;      // query rows per block
constexpr int kTcBK = 64;                      // keys per tile
constexpr int kTcSmemMax = 227 * 1024;         // a block's shared memory
constexpr int kTcConsumers = 128 * kTcWarpgroups;
constexpr int kTcThreads = kTcConsumers + 128;  // + the producer warpgroup
// setmaxnreg: the producer warpgroup gives registers to the consumers; the
// two counts fill the SM's 64 K registers at one block per SM.
constexpr int kTcProducerRegs = 56;
constexpr int kTcConsumerRegs = 152;
static_assert(128 * kTcProducerRegs + kTcConsumers * kTcConsumerRegs <=
                  65536,
              "registers");

// KP: the head dimension padded to a multiple of 16.  P·V runs in NCH
// chunks of NC output columns (one wgmma shape each).
template <int KP>
struct TcShape {
  static constexpr int NC = KP == 96    ? 48
                            : KP == 160 ? 80
                            : KP > 80   ? 64
                                        : KP;
  static constexpr int NCH = KP / NC;
  static constexpr int Q_ELEMS = kTcBQ * KP;
  static constexpr int KV_ELEMS = kTcBK * KP;  // one stage of k (or of v)
  // k/v ring depth: up to 4 stages, as many as shared memory holds (2 at
  // KP = 256).
  static constexpr int STAGES =
      (kTcSmemMax - 2 * Q_ELEMS - 64) / (4 * KV_ELEMS) < 4
          ? (kTcSmemMax - 2 * Q_ELEMS - 64) / (4 * KV_ELEMS)
          : 4;
  static constexpr size_t SMEM =
      2 * static_cast<size_t>(Q_ELEMS + 2 * STAGES * KV_ELEMS) +
      8 * (1 + 2 * STAGES);                    // + the mbarriers
  static_assert(STAGES >= 2 && SMEM <= kTcSmemMax, "tiles overflow");
};


// d (+)= A·Bᵀ for a 64 × 64 tile, A (64 × 16) and B (64 × 16) from shared
// memory, both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}


// Tile layout in shared memory, for q, k and v alike: one [R][8] block
// (R rows × 16 bytes) per 8-column group, groups R · 16 bytes apart, so that
// element (r, d) of an R-row tile sits at (d / 8) · R · 8 + r · 8 + d % 8.
// Each 8 × 8 block is a wgmma core matrix.  As the K-major operand (q, k)
// the 8-row groups are 128 bytes apart (SBO) and the column groups
// R · 16 bytes (LBO); as the MN-major one (v: keys are the K dimension) the
// key groups are 128 bytes apart (LBO) and the column groups R · 16 (SBO).
// A TMA box of 8 columns × R rows lands as one such block.

// One lane's share (of 32) of copying rows [row0, row0 + R) × columns
// [0, KP) of an operand (row stride ld elements) element by element, for
// operands TMA cannot take; rows ≥ nrows and columns ≥ K are zero.
template <int KP, int R>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int nrows,
                                          int K, int lane) {
  for (int idx = lane; idx < R * KP; idx += 32) {
    const int r = idx / KP, d = idx - r * KP;
    __nv_bfloat16 val = __float2bfloat16(0.f);
    if (row0 + r < nrows && d < K)
      val = src[static_cast<long long>(row0 + r) * ld + d];
    dst[(d >> 3) * (R * 8) + r * 8 + (d & 7)] = val;
  }
}

// TMA tensor maps of q, k and v: 4-D (K, and the row, head and batch
// dimensions in ascending stride order), boxes of 8 columns × the tile's
// rows; pos[i] holds the coordinate slot (1–3) of map i's row, head and
// batch index.
struct TmaMaps {
  CUtensorMap map[3];
  int pos[3][3];
};

// TMA: rows [row0, row0 + R) of head `head`, batch `b` into the tile layout
// above, one 8-column box per group; out-of-bounds rows and columns land as
// zeros.  Completes on `bar`.
template <int KP, int R>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst,
                                         const CUtensorMap& map,
                                         const int (&pos)[3], int row0,
                                         int head, int b, uint64_t* bar) {
  int c[4];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    c[i] = pos[0] == i ? row0 : pos[1] == i ? head : b;
#pragma unroll
  for (int cg = 0; cg < KP / 8; ++cg)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
            smem_u32(dst + cg * R * 8)),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(cg * 8), "r"(c[1]),
        "r"(c[2]), "r"(c[3]), "r"(smem_u32(bar))
        : "memory");
}

// eˣ as 2^(x·log₂e) on the SFU (ex2.approx, flushing results below 2⁻¹²⁶
// to 0).  Here x = s − m ≤ 0: masked scores give 0, or 1 where m is NEG too.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.44269504088896f));
  return y;
}

// grid = (B·H, ⌈S / 192⌉), 512 threads: warps 0–11 are three consumer
// warpgroups (64 query rows each), warp 12 the producer, warps 13–15 idle
// (setmaxnreg moves registers between whole warpgroups).
template <int KP>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o, const Strides st,
                              int H, int G, int S, int Tn, int K, int causal,
                              int window, float softcap, int vec,
                              const __grid_constant__ TmaMaps tma) {
  using Sh = TcShape<KP>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* Ks = Qs + Sh::Q_ELEMS;                  // [stage][64 × KP]
  __nv_bfloat16* Vs = Ks + Sh::STAGES * Sh::KV_ELEMS;    // [stage][64 × KP]
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(Vs + Sh::STAGES * Sh::KV_ELEMS);
  uint64_t* full = q_full + 1;                           // [stage]
  uint64_t* empty = full + Sh::STAGES;                   // [stage]

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const long long b = bh / H;
  const int h = static_cast<int>(bh % H);
  const int n = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest first

  int kt_end = (Tn + kTcBK - 1) / kTcBK;
  if (causal) kt_end = min(kt_end, (q0 + kTcBQ - 1) / kTcBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    // A tile holds a pair with s − t < window iff k0 ≥ q0 − window − 62.
    const int lo = q0 - window - kTcBK + 2;
    kt_begin = lo > 0 ? (lo + kTcBK - 1) / kTcBK : 0;
  }

  if (tid == 0) {
    // TMA: one arrival (with the bytes expected) per fill; else 32 lanes.
    mbar_init(q_full, vec ? 1 : 32);
    for (int i = 0; i < Sh::STAGES; ++i) {
      mbar_init(full + i, vec ? 1 : 32);
      mbar_init(empty + i, kTcConsumers / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // Producer warpgroup: it gives registers to the consumers.  With TMA
    // one thread loads the q tile once, then the k/v tiles into the ring;
    // otherwise the first warp copies them element by element.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kTcProducerRegs)
                 : "memory");
    const int lane = tid - kTcConsumers;
    constexpr int kKvBytes = 2 * Sh::KV_ELEMS * 2;
    if (vec && lane == 0) {
      mbar_expect_tx(q_full, Sh::Q_ELEMS * 2);
      tma_tile<KP, kTcBQ>(Qs, tma.map[0], tma.pos[0], q0, h,
                          static_cast<int>(b), q_full);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int stage = it % Sh::STAGES;
        // The first pass over the ring finds every stage free.
        mbar_wait(empty + stage, ((it / Sh::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + stage, kKvBytes);
        tma_tile<KP, kTcBK>(Ks + stage * Sh::KV_ELEMS, tma.map[1],
                            tma.pos[1], kt * kTcBK, n, static_cast<int>(b),
                            full + stage);
        tma_tile<KP, kTcBK>(Vs + stage * Sh::KV_ELEMS, tma.map[2],
                            tma.pos[2], kt * kTcBK, n, static_cast<int>(b),
                            full + stage);
      }
    } else if (!vec && lane < 32) {
      copy_tile<KP, kTcBQ>(Qs, q + b * st.q[0] + h * st.q[2], st.q[1], q0, S,
                           K, lane);
      fence_proxy_async();
      mbar_arrive(q_full);
      const __nv_bfloat16* kb = k + b * st.k[0] + n * st.k[2];
      const __nv_bfloat16* vb = v + b * st.v[0] + n * st.v[2];
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int stage = it % Sh::STAGES;
        mbar_wait(empty + stage, ((it / Sh::STAGES) & 1) ^ 1);
        copy_tile<KP, kTcBK>(Ks + stage * Sh::KV_ELEMS, kb, st.k[1],
                             kt * kTcBK, Tn, K, lane);
        copy_tile<KP, kTcBK>(Vs + stage * Sh::KV_ELEMS, vb, st.v[1],
                             kt * kTcBK, Tn, K, lane);
        fence_proxy_async();  // plain stores, read by wgmma
        mbar_arrive(full + stage);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     kTcConsumerRegs)
                 : "memory");
    // Consumer warpgroup wg: rows qw … qw + 63; this thread holds rows
    // row0 and row0 + 8 of the accumulators (g = lane / 4), columns 2·t4,
    // 2·t4 + 1 of every 8-column group.
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int qw = q0 + wg * 64;
    const int row0 = qw + ((tid >> 5) & 3) * 16 + g;
    // Stop before the diagonal tile wholly in these rows' future; rows
    // wholly past S compute nothing.
    int kt_stop = qw < S ? kt_end : kt_begin;
    if (causal) kt_stop = min(kt_stop, (qw + 63) / kTcBK + 1);
    const __nv_bfloat16* Qw = Qs + wg * 64 * 8;  // this warpgroup's rows

    // wgmma descriptors of stage 0's tiles; a byte offset δ (a multiple of
    // 16) moves a descriptor by δ / 16.
    const uint64_t qdesc = smem_desc(Qw, kTcBQ * 16, 128);
    const uint64_t kdesc = smem_desc(Ks, kTcBK * 16, 128);
    const uint64_t vdesc = smem_desc(Vs, 128, kTcBK * 16);
    constexpr uint64_t kStageStep = Sh::KV_ELEMS * 2 / 16;

    float oacc[Sh::NCH][Sh::NC / 2];
#pragma unroll
    for (int c = 0; c < Sh::NCH; ++c)
#pragma unroll
      for (int e = 0; e < Sh::NC / 2; ++e) oacc[c][e] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    uint32_t pa[4][3][4];      // P's A fragments: [16-key step][term][reg]

    // S = Q·Kᵀ (64 × 64, f32) of the tile in `stage`, KP / 16 k-steps,
    // issued and committed, not waited for.
    auto issue_qk = [&](float (&s)[32], int stage) {
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KP / 16; ++ks)
        wgmma_ss_n64(s, qdesc + ks * (kTcBQ * 32 / 16),
                     kdesc + stage * kStageStep + ks * (kTcBK * 32 / 16),
                     ks > 0);
      wg_commit();
    };
    // O += pᵢ·V for each term, 16 keys and NC columns per wgmma.
    auto issue_pv = [&](int stage) {
      wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int c = 0; c < Sh::NCH; ++c)
            wgmma_rs<Sh::NC>(oacc[c], pa[j][term],
                             vdesc + stage * kStageStep + j * (128 * 2 / 16) +
                                 c * (Sh::NC / 8) * (kTcBK * 16 / 16));
      wg_commit();
    };
    // A warp hands a stage back once all its lanes are done with it.
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    auto keep_pv = [&]() {
#pragma unroll
      for (int c = 0; c < Sh::NCH; ++c) keep(oacc[c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int term = 0; term < 3; ++term) keep(pa[j][term]);
    };

    // Local tiles t = 0 … nt − 1 are ring iterations kt_begin + t.
    const int nt = max(kt_stop - kt_begin, 0);
    float sacc[32];
    mbar_wait(q_full, 0);
#pragma unroll 1
    for (int t = 0; t < nt; ++t) {
      const int stage = t % Sh::STAGES;
      mbar_wait(full + stage, (t / Sh::STAGES) & 1);
      issue_qk(sacc, stage);
      wg_wait_all();
      keep(sacc);
      float (&s)[32] = sacc;

      // Softcap, mask, running max and sum, in the accumulator layout:
      // s[4i + 2r + c] is row row0 + 8r, key k0 + 8i + 2·t4 + c.
      const int k0 = (kt_begin + t) * kTcBK;
      const bool need_mask = k0 + kTcBK > Tn ||
                             (causal && k0 + kTcBK - 1 > qw) ||
                             (window > 0 && qw + 63 - k0 >= window);
      // Each option is a branch around a whole loop, so that a tile that
      // needs neither executes neither.
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = tanhf(s[e] / softcap) * softcap;
      }
      if (need_mask) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int qpos = row0 + 8 * ((e >> 1) & 1);
          const int kpos = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
          bool ok = kpos < Tn;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          if (!ok) s[e] = kNeg;
        }
      }
      // Row max and (below) row sum as trees over the thread's 16 values
      // of a row, then over the row's four threads.
      float mx[2], corr[2], rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int i = 0; i < w; ++i) v[i] = fmaxf(v[i], v[i + w]);
        mx[r] = v[0];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp_sfu(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = exp_sfu(s[e] - m[(e >> 1) & 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = s[4 * i + 2 * r] + s[4 * i + 2 * r + 1];
#pragma unroll
        for (int w = 4; w > 0; w >>= 1)
#pragma unroll
          for (int i = 0; i < w; ++i) v[i] += v[i + w];
        rs[r] = v[0];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * corr[r] + rs[r];
      }

      // O's rows are rescaled only where a warp's running max moved.
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < Sh::NCH; ++c)
#pragma unroll
          for (int e = 0; e < Sh::NC / 2; ++e)
            oacc[c][e] *= corr[(e >> 1) & 1];
      }

      // P = p₁ + p₂ + p₃, each term bf16 and the sum exact: p₁ is p cut to
      // its top 16 bits (bf16 rounded toward zero), p₂ the same of p − p₁,
      // p₃ = p − p₁ − p₂, which fits bf16 exactly (ref.bf16_split3).  The
      // A fragment of 16-key step j is s[8j … 8j + 7] in pairs: registers
      // (row, keys 2·t4, +1), (row + 8, same), (row, keys 8 + 2·t4, +1),
      // (row + 8, same); a pair's top halves pack into one register.
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          float x = s[8 * j + 2 * hh], y = s[8 * j + 2 * hh + 1];
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
            pa[j][term][hh] = __byte_perm(xb, yb, 0x7632);
            x -= __uint_as_float(xb & 0xffff0000u);
            y -= __uint_as_float(yb & 0xffff0000u);
          }
        }
      issue_pv(stage);
      wg_wait_all();
      keep_pv();
      release(empty + stage);
    }
    // Ring iterations past this warpgroup's last tile (the diagonal tile
    // wholly in its future): nothing to compute, the stage goes back.
    for (int it = nt; it < kt_end - kt_begin; ++it) {
      mbar_wait(full + it % Sh::STAGES, (it / Sh::STAGES) & 1);
      release(empty + it % Sh::STAGES);
    }

    __nv_bfloat16* ob = o + b * st.o[0] + h * st.o[2];
    const bool pairs = ((st.o[0] | st.o[1] | st.o[2] | K) & 1) == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = row0 + 8 * r;
      if (s >= S) continue;
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + s * st.o[1];
#pragma unroll
      for (int c = 0; c < Sh::NCH; ++c)
#pragma unroll
        for (int i = 0; i < Sh::NC / 8; ++i) {
          const int d = c * Sh::NC + 8 * i + 2 * t4;
          const float v0 = oacc[c][4 * i + 2 * r] / den;
          const float v1 = oacc[c][4 * i + 2 * r + 1] / den;
          if (pairs && d + 1 < K) {
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (d < K) orow[d] = __float2bfloat16(v0);
            if (d + 1 < K) orow[d + 1] = __float2bfloat16(v1);
          }
        }
    }
  }
}

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1 at first use (the
// library links the CUDA runtime only).
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Map `i` of `maps` over a bf16 operand with K columns, `size` = (rows,
// heads, batch) and element strides `st` = (batch, row, head), as Strides
// holds them; boxes of 8 columns × box_rows rows.
bool make_map(TmaMaps& maps, int i, const void* base, int K,
              const long long (&size)[3], const long long (&st)[3],
              int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long stride[3] = {st[1], st[2], st[0]};  // row, head, batch
  int order[3] = {0, 1, 2};
  for (int a = 0; a < 3; ++a)
    for (int c = a + 1; c < 3; ++c)
      if (stride[order[c]] < stride[order[a]]) {
        const int t = order[a];
        order[a] = order[c];
        order[c] = t;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(K), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {8, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int a = 0; a < 3; ++a) {
    const int d = order[a];
    dims[a + 1] = static_cast<cuuint64_t>(size[d]);
    gstride[a] = static_cast<cuuint64_t>(stride[d]) * 2;
    if (d == 0) box[a + 1] = static_cast<cuuint32_t>(box_rows);
    maps.pos[i][d] = a + 1;
  }
  return fn(&maps.map[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, gstride, box, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KP>
int launch_tc_kp(const void* q, const void* k, const void* v, void* o,
                 const Strides& st, long long B, int H, int G, int S, int Tn,
                 int K, int causal, int window, float softcap, int vec,
                 cudaStream_t stream) {
  TmaMaps maps = {};
  if (vec) {
    const long long qsize[3] = {S, H, B}, kvsize[3] = {Tn, H / G, B};
    if (!make_map(maps, 0, q, K, qsize, st.q, kTcBQ) ||
        !make_map(maps, 1, k, K, kvsize, st.k, kTcBK) ||
        !make_map(maps, 2, v, K, kvsize, st.v, kTcBK))
      return static_cast<int>(cudaErrorNotSupported);
  }
  constexpr size_t smem = TcShape<KP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<KP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kTcBQ - 1) / kTcBQ));
  flash_attention_tc_kernel<KP><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      st, H, G, S, Tn, K, causal, window, softcap, vec, maps);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* q, const void* k, const void* v, void* o,
              const Strides& st, long long B, int H, int G, int S, int Tn,
              int K, int causal, int window, float softcap,
              cudaStream_t s) {
  // TMA needs 16-byte aligned rows: K and every q/k/v stride a positive
  // multiple of 8 elements, and 16-byte aligned bases.
  bool vec = K % 8 == 0 &&
             ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
               reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  for (int i = 0; i < 3; ++i)
    vec = vec && st.q[i] % 8 == 0 && st.k[i] % 8 == 0 &&
          st.v[i] % 8 == 0 && st.q[i] > 0 && st.k[i] > 0 && st.v[i] > 0;
  const int kp = (K + 15) / 16 * 16;
#define REPRO_TC(KP_)                                                      \
  return launch_tc_kp<KP_>(q, k, v, o, st, B, H, G, S, Tn, K, causal,      \
                           window, softcap, vec ? 1 : 0, s)
  if (kp <= 16) REPRO_TC(16);
  if (kp <= 32) REPRO_TC(32);
  if (kp <= 48) REPRO_TC(48);
  if (kp <= 64) REPRO_TC(64);
  if (kp <= 80) REPRO_TC(80);
  if (kp <= 96) REPRO_TC(96);
  if (kp <= 128) REPRO_TC(128);
  if (kp <= 160) REPRO_TC(160);
  if (kp <= 192) REPRO_TC(192);
  REPRO_TC(256);
#undef REPRO_TC
}

// Checks the arguments common to both kernels and unpacks the strides;
// returns 0 or a CUDA error code.
int prepare(const long long* strides, long long B, int H, int n_kv, int S,
            int Tn, int K, int device, Strides& st) {
  if (K < 1 || K > kMaxK || H < 1 || n_kv < 1 || H % n_kv != 0 || S < 1 ||
      Tn < 1 || B < 1 || B * H > 0x7fffffffLL || S > 65535LL * kBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  return static_cast<int>(cudaSetDevice(device));
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Strides& st, long long B, int H, int G, int S, int Tn,
               int K, int causal, int window, float softcap,
               cudaStream_t s) {
  const int dpt = (K + 15) / 16;
  if (dpt <= 1)
    return launch_dpt<1>(q, k, v, o, st, B, H, G, S, Tn, K, causal, window,
                         softcap, s);
  if (dpt <= 2)
    return launch_dpt<2>(q, k, v, o, st, B, H, G, S, Tn, K, causal, window,
                         softcap, s);
  if (dpt <= 4)
    return launch_dpt<4>(q, k, v, o, st, B, H, G, S, Tn, K, causal, window,
                         softcap, s);
  if (dpt <= 5)
    return launch_dpt<5>(q, k, v, o, st, B, H, G, S, Tn, K, causal, window,
                         softcap, s);
  if (dpt <= 8)
    return launch_dpt<8>(q, k, v, o, st, B, H, G, S, Tn, K, causal, window,
                         softcap, s);
  return launch_dpt<16>(q, k, v, o, st, B, H, G, S, Tn, K, causal, window,
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
  Strides st;
  const int rc = prepare(strides, B, H, n_kv, S, T, K, device, st);
  if (rc != 0) return rc;
  return launch_f32(q, k, v, o, st, B, H, H / n_kv, S, T, K, causal, window,
                    softcap, static_cast<cudaStream_t>(stream));
}

int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, long long B,
                               int H, int n_kv, int S, int T, int K,
                               int causal, int window, float softcap,
                               int device, void* stream) {
  Strides st;
  const int rc = prepare(strides, B, H, n_kv, S, T, K, device, st);
  if (rc != 0) return rc;
  return launch_tc(q, k, v, o, st, B, H, H / n_kv, S, T, K, causal, window,
                   softcap, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
