// Mamba2 SSD within-chunk term on Hopper's tensor cores, f32 accuracy:
//   y[n, q, h, p] = Σ_{k ≤ q} exp(la[n, q, h] − la[n, k, h]) · cb[n, q, k]
//                   · x[n, k, h, p]
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (ssd_intra): the
// attention-like term of every Mamba2 block's chunked SSD forward
// (models/ssm.py, when ssm.use_kernel is on and n_groups == 1).  cb (N, Q, Q)
// holds the chunk's C_q·B_k scores, la (N, Q, H) the within-chunk cumulative
// log decay, x (N, Q, H, P) the Δt-scaled inputs; the output is f32.  Per
// (n, h) it is the product Y (Q × P) = L · X with L[q, k] = exp(la_q − la_k)
// · cb[q, k] for k ≤ q.  The mask is applied before the exp, as the
// reference does in log space, so the upper triangle never overflows: a
// masked entry is 0 · cb[q, k], as the reference's masked decay times cb.
//
// What bounds it on this card: at the main path's shape (N = 128 chunks,
// Q = 256, H = 80, P = 64; f32 cb and x, as the forward feeds them) the
// bytes, ~1.38 GB of cb, la, x and y: 0.41 ms at 3.35 TB/s.  The six bf16
// products below are 6 × 2·N·H·P·Q(Q+1)/2 = 2.6e11 operations, 0.26 ms at
// 989 TFLOP/s, and the N·H·Q(Q+1)/2 = 3.4e8 exponentials 0.09 ms at the
// SFU rate.  The f32 CUDA-core kernel this one replaces faced 0.64 ms of
// f32 FMAs (and reached 3.29 ms).
//
// What the design does:
//   * One warpgroup per block owns one 64-row q tile of one chunk n and a
//     group of up to 8 heads.  It stages cb's 64 rows × [0, kend) (kend =
//     the tile's last row + 1) in shared memory once, as f32 (columns
//     XOR-swizzled by row, so a warp's reads hit 32 banks), and reuses it
//     for every head of the group; la of the group's heads likewise.  The
//     q tiles of one (n, head group) are neighbouring blocks, heaviest
//     first, so they share x in L2.
//   * Per head it walks k in stages of 32 up to the tile's diagonal.  L is
//     formed on the CUDA cores in f32 in the registers of the wgmma A
//     fragment (rows 16·warp + lane / 4 and + 8, columns 2·(lane % 4),
//     + 1, + 8, + 9 of each 16-k step), then cut into three bf16 terms by
//     the rule of kernels/ref.py::bf16_split3 (each the top 16 bits of what
//     is left; their sum is L exactly), as flash's P.  The x stage (32 k ×
//     64 p) is cut the same way into three bf16 planes in shared memory,
//     MN-major, as the B operand (one plane for bf16 x: exact).
//   * Of the nine term products the six with i + j ≤ 2 are issued
//     (split_engine.cu's rule; the three dropped are below 2⁻²¹·|L||x|),
//     m64n64k16 wgmmas with A from registers (wgmma_rs<64>); bf16 x takes
//     three.  Each product of two bf16 terms is exact in f32.
//   * Pipelined: while stage s's products run, stage s + 1's L is formed
//     and split and its x planes written into the other of two
//     shared-memory slots, with its x loaded a stage earlier still; the
//     walk runs on across the heads and p tiles of the block without
//     draining, except to store a finished 64 × 64 output tile.  Every
//     branch around a wgmma operand is uniform (ptxas serializes all the
//     kernel's wgmmas otherwise).  Two blocks share an SM (~96 KB of shared
//     memory each at Q = 256).
//   * One f32 accumulator per output tile: K ≤ 256 here, at most 96
//     tensor-core additions into it, so the truncated accumulation (the
//     reason split_engine.cu folds each stage on the CUDA cores) stays
//     near 1e-6 of max|y| on the card, against the 2e-4 tolerance
//     (chip_smoke.py measures it against the plain version and the split
//     model).  Folding each stage into a running set as the engine does
//     was slower and barely more accurate.
//   * Exponentials by expf, as the reference's exp: ex2.approx on the SFU
//     was a few percent faster, but its error, carried through the 54
//     Mamba2 layers of the f32 forward, took chip_smoke.py's max|Δh| most
//     of the way to its 1e-3·max|h| limit (PERF.md §6).
//   * Non-finite values follow the split engine's rule: NaN where the plain
//     version gives NaN or ±Inf.  An Inf splits into (Inf, NaN, NaN), and a
//     masked entry is 0 · cb, so 0 · Inf and NaN propagate as the
//     reference's masked product does.  What the walk to the diagonal
//     skips: each block checks the rest of its cb rows once (a NaN or ±Inf
//     there makes the row NaN, every head, as 0 · cb does), and flags the
//     launch when an x value it splits is not finite (one OR a value);
//     only then does a second kernel make y[q, h, p] NaN for every q below
//     the last non-finite x[k, h, p], as 0 · Inf does in the reference.
//     Otherwise that kernel reads one flag and returns.
// Not done yet (later work; the kernel reaches ~31% of its byte bound, and
// the CUDA-core work of each stage is the long pole):
// splitting each head's x once for all q tiles (each tile block splits it
// again up to its diagonal, 2.5× the minimum), a producer warp with TMA,
// and more warps per SM (shared memory holds two blocks of four warps).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;       // q rows per block: wgmma's M
constexpr int kCols = 64;       // p columns per output tile: wgmma's N
constexpr int kStage = 32;      // k per pipeline stage: two 16-k steps
constexpr int kThreads = 128;   // one warpgroup
constexpr int kHeads = 8;       // heads per block, sharing one cb stage
constexpr int kSmemMax = 227 * 1024;
constexpr int kPlane = kStage * kCols;   // bf16 elements of one x plane

// The kept term pairs (term of L, term of x), i + j ≤ 2, largest first, as
// in split_engine.cu.
__host__ __device__ constexpr int pair_l(int i) {
  return i == 2 || i == 4 ? 1 : i == 5 ? 2 : 0;
}
__host__ __device__ constexpr int pair_x(int i) {
  return i == 1 || i == 4 ? 1 : i == 3 ? 2 : 0;
}

// Shared memory of a block, in bytes: the two x slots first (128-byte
// aligned for wgmma), then cb (64 × W f32, W = Q rounded up to 64), la
// (8 × W f32) and the row flags (64 ints).
struct Layout {
  int W;
  size_t cb, la, rowbad, total;
};

__host__ __device__ inline Layout layout(int Q, int nx) {
  Layout s;
  s.W = (Q + kRows - 1) / kRows * kRows;
  s.cb = static_cast<size_t>(2) * nx * kPlane * 2;
  s.la = s.cb + static_cast<size_t>(4) * kRows * s.W;
  s.rowbad = s.la + static_cast<size_t>(4) * kHeads * s.W;
  s.total = s.rowbad + 4 * kRows;
  return s;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}
__device__ __forceinline__ float top16(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffff0000u);
}

// One thread's share of a stage of x: 2 × 8 consecutive p of one k row.
template <typename T>
struct XRegs;
template <>
struct XRegs<float> {
  float v[2][8];
};
template <>
struct XRegs<__nv_bfloat16> {
  uint4 v[2];
};

// Loads x[k0 + kl, h, p0 + 8g … + 7] for this thread's units (kl = lane,
// g = warp + 4j), zero past Q and P.
__device__ __forceinline__ void load_x(XRegs<float>& r,
                                       const float* __restrict__ xh,
                                       long long HP, int Q, int P, int k0,
                                       int p0, int tid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = k0 + (tid & 31);
    const int p = p0 + 8 * ((tid >> 5) + 4 * j);
    const float* src = xh + static_cast<long long>(k) * HP + p;
    if (k < Q && p + 7 < P && (P & 3) == 0) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
      r.v[j][0] = a.x; r.v[j][1] = a.y; r.v[j][2] = a.z; r.v[j][3] = a.w;
      r.v[j][4] = b.x; r.v[j][5] = b.y; r.v[j][6] = b.z; r.v[j][7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        r.v[j][e] = k < Q && p + e < P ? __ldg(src + e) : 0.f;
    }
  }
}

__device__ __forceinline__ void load_x(XRegs<__nv_bfloat16>& r,
                                       const __nv_bfloat16* __restrict__ xh,
                                       long long HP, int Q, int P, int k0,
                                       int p0, int tid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = k0 + (tid & 31);
    const int p = p0 + 8 * ((tid >> 5) + 4 * j);
    const __nv_bfloat16* src = xh + static_cast<long long>(k) * HP + p;
    if (k < Q && p + 7 < P && (P & 7) == 0) {
      r.v[j] = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      uint32_t e16[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        e16[e] = k < Q && p + e < P ? __bfloat16_as_ushort(src[e]) : 0u;
      r.v[j] = make_uint4(e16[0] | (e16[1] << 16), e16[2] | (e16[3] << 16),
                          e16[4] | (e16[5] << 16), e16[6] | (e16[7] << 16));
    }
  }
}

// Writes the loaded stage into a slot: plane j, element (k, p) at
// j·kPlane + (p / 8)·256 + k·8 + p % 8 (wgmma's no-swizzle MN-major core
// matrices: 8 p × 8 k in 128 bytes; LBO 128 bytes along k, SBO 512 along
// p).  chk collects whether a value stored is NaN or ±Inf: for f32 the
// OR of the residuals after the three terms (0, or below 2⁻¹³³, unless
// the value is not finite: Inf − Inf is NaN), whose exponent bits are all
// set only then; for bf16, v·0 summed, NaN only then.
__device__ __forceinline__ bool nonfinite_chk(uint32_t chk) {
  return (chk & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ void store_x(const XRegs<float>& r,
                                        __nv_bfloat16* slot, int tid,
                                        uint32_t& chk) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = r.v[j][e];
    __nv_bfloat16* dst = slot + ((tid >> 5) + 4 * j) * 256 + (tid & 31) * 8;
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      uint4 w;
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        wp[h] = __byte_perm(__float_as_uint(v[2 * h]),
                            __float_as_uint(v[2 * h + 1]), 0x7632);
        v[2 * h] = __fsub_rn(v[2 * h], top16(v[2 * h]));
        v[2 * h + 1] = __fsub_rn(v[2 * h + 1], top16(v[2 * h + 1]));
      }
      *reinterpret_cast<uint4*>(dst + pl * kPlane) = w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) chk |= __float_as_uint(v[e]);
  }
}

__device__ __forceinline__ void store_x(const XRegs<__nv_bfloat16>& r,
                                        __nv_bfloat16* slot, int tid,
                                        uint32_t& chk) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    *reinterpret_cast<uint4*>(slot + ((tid >> 5) + 4 * j) * 256 +
                              (tid & 31) * 8) = r.v[j];
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&r.v[j]);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      sum = fmaf(__uint_as_float(w[h] << 16), 0.f, sum);
      sum = fmaf(__uint_as_float(w[h] & 0xffff0000u), 0.f, sum);
    }
  }
  chk |= __float_as_uint(sum);
}

// grid = N · ⌈H / 8⌉ · ⌈Q / 64⌉ blocks (the q tiles of one (n, head group)
// neighbouring, heaviest first), 128 threads.  NX: bf16 planes of x (3 for
// f32, 1 for bf16).  Sets *nonfinite if it stored a NaN or ±Inf of x.
template <typename T, int NX>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_kernel(const T* __restrict__ cb, const T* __restrict__ la,
                     const T* __restrict__ x, float* __restrict__ out, int Q,
                     int H, int P, int groups, int* __restrict__ nonfinite) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay = layout(Q, NX);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* cbs = reinterpret_cast<float*>(smem + lay.cb);
  float* las = reinterpret_cast<float*>(smem + lay.la);
  int* rowbad = reinterpret_cast<int*>(smem + lay.rowbad);
  const int W = lay.W;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_qtiles = (Q + kRows - 1) / kRows;
  const int unit = static_cast<int>(blockIdx.x) / n_qtiles;
  const int qt =
      n_qtiles - 1 - (static_cast<int>(blockIdx.x) - unit * n_qtiles);
  const long long n = unit / groups;
  const int h0 = (unit - static_cast<int>(n) * groups) * kHeads;
  const int hc = min(kHeads, H - h0);
  const int q0 = qt * kRows;
  const int kend = min(Q, q0 + kRows);
  const int nst = (kend + 2 * kStage - 1) / (2 * kStage) * 2;  // even
  const int kw = nst * kStage;
  const int n_ptiles = (P + kCols - 1) / kCols;
  const long long HP = static_cast<long long>(H) * P;
  const T* cbn = cb + n * Q * Q;
  const T* lan = la + n * Q * H;
  const T* xn = x + n * Q * HP;
  float* on = out + n * Q * HP;

  // Once per block: cb rows [q0, q0 + 64) × [0, kw) and la of the group's
  // heads over [0, kw) into shared memory, 8 loads in flight per thread.
  // The rest of the cb rows, [kend, Q), is only checked: a NaN or ±Inf
  // there flags its row.  4 consecutive k per unit of cb, which the
  // swizzle (it moves groups of 8) keeps together.
  if (tid < kRows) rowbad[tid] = 0;
  __syncthreads();
  const int kq = max(kw, (Q + 3) / 4 * 4);
  const int cb_units = kRows * kq / 4;
  for (int i0 = tid; i0 < cb_units; i0 += 8 * kThreads) {
    float v[8][4];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = i0 + b * kThreads;
      const int r = i / (kq / 4), k = (i - r * (kq / 4)) * 4;
      const T* src = cbn + static_cast<long long>(q0 + r) * Q + k;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[b][e] = i < cb_units && q0 + r < Q && k + e < Q
                      ? to_f32(__ldg(src + e))
                      : 0.f;
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = i0 + b * kThreads;
      const int r = i / (kq / 4), k = (i - r * (kq / 4)) * 4;
      if (i >= cb_units) continue;
      if (k < kw) {
        *reinterpret_cast<float4*>(cbs + r * W + (k ^ ((r & 3) << 3))) =
            make_float4(v[b][0], v[b][1], v[b][2], v[b][3]);
      } else {
        float chk = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) chk = fmaf(v[b][e], 0.f, chk);
        if (chk != chk) rowbad[r] = 1;
      }
    }
  }
  for (int i0 = tid; i0 < hc * kw; i0 += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = i0 + b * kThreads;
      const int k = i / hc, hh = i - k * hc;
      v[b] = i < hc * kw && k < Q
                 ? to_f32(__ldg(lan + static_cast<long long>(k) * H + h0 +
                                hh))
                 : 0.f;
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int i = i0 + b * kThreads;
      const int k = i / hc, hh = i - k * hc;
      if (i < hc * kw) las[hh * W + k] = v[b];
    }
  }
  __syncthreads();

  // This thread's rows of the tile (the wgmma fragment's): r0 and r0 + 8.
  const int r0 = 16 * warp + (lane >> 2), t4 = lane & 3;
  const int sw = (r0 & 3) << 3;   // r0 + 8 has the same swizzle
  const float* cb0 = cbs + r0 * W;
  const float* cb1 = cbs + (r0 + 8) * W;
  const uint64_t xdesc = smem_desc(ring, 128, 256 * 2);

  // L of stage c for head hh into the A fragments of its two 16-k steps,
  // cut into three bf16 terms: frag[ks][term][reg].
  auto make_l = [&](uint32_t (&frag)[2][3][4], int hh, int c) {
    const float* lah = las + hh * W;
    const int qa = q0 + r0, qb = qa + 8;
    const float lqa = qa < Q ? lah[qa] : 0.f, lqb = qb < Q ? lah[qb] : 0.f;
    const bool diag = c * kStage + kStage > q0;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = c * kStage + 16 * ks + 8 * half + 2 * t4;
        const float2 lk = *reinterpret_cast<const float2*>(lah + k);
        const float2 ca = *reinterpret_cast<const float2*>(cb0 + (k ^ sw));
        const float2 cc = *reinterpret_cast<const float2*>(cb1 + (k ^ sw));
        float v[2][2] = {{ca.x, ca.y}, {cc.x, cc.y}};
        const float lq[2] = {lqa, lqb};
        const int qq[2] = {qa, qb};
        const float lkv[2] = {lk.x, lk.y};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // exp(−∞) = 0: the reference's mask, without a branch.
            float d = lq[rr] - lkv[e];
            if (diag && !(k + e <= qq[rr] && qq[rr] < Q)) d = -INFINITY;
            v[rr][e] = expf(d) * v[rr][e];
          }
        // Registers: (r0, k), (r0 + 8, k), (r0, k + 8), (r0 + 8, k + 8).
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float a = v[rr][0], b = v[rr][1];
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            const uint32_t ab = __float_as_uint(a), bb = __float_as_uint(b);
            frag[ks][term][2 * half + rr] = __byte_perm(ab, bb, 0x7632);
            a = __fsub_rn(a, __uint_as_float(ab & 0xffff0000u));
            b = __fsub_rn(b, __uint_as_float(bb & 0xffff0000u));
          }
        }
      }
    }
  };

  float acc[32];
  uint32_t pa[2][2][3][4];
  auto issue = [&](uint32_t (&frag)[2][3][4], int slot) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int pp = 0; pp < 6; ++pp) {
        if (pair_x(pp) >= NX) continue;
        wgmma_rs<64>(acc, frag[ks][pair_l(pp)],
                     xdesc + ((slot * NX + pair_x(pp)) * kPlane * 2 +
                              ks * 256) / 16);
      }
  };
  auto keep_frag = [&](uint32_t (&frag)[2][3][4]) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int term = 0; term < 3; ++term) keep(frag[ks][term]);
  };
  // Stores the finished tile o of (head hh, p tile pt).
  auto epilogue = [&](const float (&o)[32], int hh, int pt) {
    const int h = h0 + hh;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf, q = q0 + r;
      if (q >= Q) continue;
      const bool bad = rowbad[r] != 0;
      float* orow = on + (static_cast<long long>(q) * H + h) * P;
#pragma unroll
      for (int c8 = 0; c8 < kCols / 8; ++c8) {
        const int p = pt * kCols + 8 * c8 + 2 * t4;
        const float nan = __int_as_float(0x7fc00000);
        const float v0 = bad ? nan : o[4 * c8 + 2 * hf];
        const float v1 = bad ? nan : o[4 * c8 + 2 * hf + 1];
        if (p + 1 < P && (P & 1) == 0) {
          *reinterpret_cast<float2*>(orow + p) = make_float2(v0, v1);
        } else {
          if (p < P) orow[p] = v0;
          if (p + 1 < P) orow[p + 1] = v1;
        }
      }
    }
  };

  // The walk over the (head, p tile) output tiles of the block and their
  // stages: stage c of a tile computes in slot c % 2 (nst is even).  Stages
  // past the last repeat it (their loads and L are never used).
  const int n_tiles = hc * n_ptiles;
  XRegs<T> xr[2];
  // Stage c of tile t, c < 2·nst: wrapped into the next tile, and past the
  // last tile held at its last stage.
  auto wrap = [&](int& t, int& c) {
    if (c >= nst) {
      c -= nst;
      ++t;
    }
    if (t >= n_tiles) {
      t = n_tiles - 1;
      c = nst - 1;
    }
  };
  auto head_of = [&](int t) { return n_ptiles == 1 ? t : t / n_ptiles; };
  auto load_item = [&](XRegs<T>& r, int t, int c) {
    wrap(t, c);
    const int hh = head_of(t), pt = t - hh * n_ptiles;
    load_x(r, xn + static_cast<long long>(h0 + hh) * P, HP, Q, P,
           c * kStage, pt * kCols, tid);
  };
  auto make_item = [&](uint32_t (&frag)[2][3][4], int t, int c) {
    wrap(t, c);
    make_l(frag, head_of(t), c);
  };
  uint32_t chk = 0;
  load_item(xr[0], 0, 0);
  load_item(xr[1], 0, 1);
  make_item(pa[0], 0, 0);
  store_x(xr[0], ring, tid, chk);
  fence_proxy_async();
  __syncthreads();

  // Every branch around a wgmma operand is uniform, with nothing in it
  // that depends on the thread: ptxas serializes every wgmma of a kernel
  // that touches their registers on a thread-dependent path.  Stage j's
  // x is loaded two stages ahead, its L formed and its x planes written
  // while stage j − 1's products run.
#pragma unroll 1
  for (int tile = 0; tile < n_tiles; ++tile) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nst; c += 2) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        load_item(xr[s], tile, c + s + 2);
        wg_fence();
        issue(pa[s], s);
        wg_commit();
        // The previous stage's products (slot s ^ 1, fragments pa[s ^ 1])
        // are done once every warp has waited for them.
        wg_wait<1>();
        keep_frag(pa[s ^ 1]);
        make_item(pa[s ^ 1], tile, c + s + 1);
        __syncthreads();
        store_x(xr[s ^ 1], ring + (s ^ 1) * NX * kPlane, tid, chk);
        fence_proxy_async();
        __syncthreads();
      }
    }
    wg_wait_all();
    keep(acc);
    keep_frag(pa[0]);
    keep_frag(pa[1]);
    float o[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] = acc[e];
    epilogue(o, head_of(tile), tile - head_of(tile) * n_ptiles);
  }
  if (nonfinite_chk(chk)) *nonfinite = 1;
}

// The reference multiplies every x[k] by L[q, k], 0 above the diagonal, so
// a NaN or ±Inf at x[n, k, h, p] makes y[n, q, h, p] NaN for q < k too
// (0·Inf), where the walk to the diagonal never reads x[k].  Runs after
// ssd_intra_kernel and does nothing unless that set *nonfinite: then it
// sets y[n, q, h, p] = NaN for q below the last non-finite row of each
// (n, h, p) column.  grid-stride over (n, h), threads over p.
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_intra_nonfinite_kernel(const T* __restrict__ x, float* __restrict__ out,
                         long long N, int Q, int H, int P,
                         const int* __restrict__ nonfinite) {
  if (*nonfinite == 0) return;
  const long long HP = static_cast<long long>(H) * P;
  for (long long nh = blockIdx.x; nh < N * H; nh += gridDim.x) {
    const long long n = nh / H;
    const int h = static_cast<int>(nh - n * H);
    const T* xb = x + n * Q * HP + static_cast<long long>(h) * P;
    float* ob = out + n * Q * HP + static_cast<long long>(h) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      int last = -1;
      for (int k = Q - 1; k >= 0 && last < 0; --k)
        if (!finite(to_f32(xb[k * HP + p]))) last = k;
      for (int q = 0; q < last; ++q)
        ob[q * HP + p] = __int_as_float(0x7fc00000);
    }
  }
}

template <typename T, int NX>
int launch(const void* cb, const void* la, const void* x, void* out,
           void* nonfinite, long long N, int Q, int H, int P, int device,
           void* stream) {
  if (N < 1 || Q < 1 || H < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(Q, NX);
  const long long groups = (H + kHeads - 1) / kHeads;
  const long long blocks = N * groups * ((Q + kRows - 1) / kRows);
  if (lay.total > static_cast<size_t>(kSmemMax) || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Two blocks share an SM: all of its shared memory goes to them.
  err = cudaFuncSetAttribute(ssd_intra_kernel<T, NX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(lay.total));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_intra_kernel<T, NX>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaMemsetAsync(nonfinite, 0, 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_intra_kernel<T, NX><<<static_cast<unsigned>(blocks), kThreads,
                            lay.total, st>>>(
      static_cast<const T*>(cb), static_cast<const T*>(la),
      static_cast<const T*>(x), static_cast<float*>(out), Q, H, P,
      static_cast<int>(groups), static_cast<int*>(nonfinite));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fix = N * H < 1024 ? N * H : 1024;
  ssd_intra_nonfinite_kernel<T><<<static_cast<unsigned>(fix), 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<float*>(out), N, Q, H, P,
      static_cast<const int*>(nonfinite));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cb: (N, Q, Q), la: (N, Q, H), x: (N, Q, H, P), all contiguous and of one
// dtype; out: (N, Q, H, P) f32; nonfinite: 4 bytes of device scratch.
// Q ≤ 704 (a 64 × Q block of cb and eight heads' la in shared memory).
// Launches on `stream` and returns the first CUDA error code that is not
// 0 (0 on success).
int repro_ssd_intra_f32(const void* cb, const void* la, const void* x,
                        void* out, void* nonfinite, long long N, int Q, int H,
                        int P, int device, void* stream) {
  return launch<float, 3>(cb, la, x, out, nonfinite, N, Q, H, P, device,
                          stream);
}

int repro_ssd_intra_bf16(const void* cb, const void* la, const void* x,
                         void* out, void* nonfinite, long long N, int Q,
                         int H, int P, int device, void* stream) {
  return launch<__nv_bfloat16, 1>(cb, la, x, out, nonfinite, N, Q, H, P,
                                  device, stream);
}

}  // extern "C"
