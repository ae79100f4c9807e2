// The split-bf16 tensor-core engine: out = A'ᵀ · B' in f32 accuracy on the
// bf16 tensor cores (interface and operand rules in split_engine.cuh).
//
// Serves three kernels, each of which folds its batch into one axis or
// into consecutive products:
//   * xty_folds (gram.cu; TPU kernel src/repro/kernels/gram.py xty_folds):
//     out[f] = x[lo:hi]ᵀ y[lo:hi], one product per fold over K = hi − lo
//     rows, the folds one after another on the stream sharing one scratch;
//   * xty_folds_masked (gram.cu; TPU kernel src/repro/kernels/gram.py
//     xty_folds_masked): out[s] = (x · diag(w[:, s]))ᵀ z, the slot s folded
//     into the rows of A' = [x·w_0 | x·w_1 | …], so the (s, p, q) output is
//     the (s·p, q) product itself;
//   * solve_lambda_grid (ridge_solve.cu; TPU kernel
//     src/repro/kernels/ridge_solve.py solve_lambda_grid):
//     out[r] = Q · diag(1/(Λ+λ_r)) · A, the λ index folded into the
//     columns of B' = [A·s_0 | A·s_1 | …] (one 4,884-column axis at
//     r = 11, t = 444), so Q is streamed once per column tile, not per λ.
//
// The split.  The reference accumulates in f32 and the port uses no TF32.
// A value v that is f32 after its scale (applied in f32 first, exactly as
// the plain versions do) is cut into bf16 terms by the rule of
// kernels/ref.py::bf16_split3: v₀ = v truncated to its top 16 bits (bf16
// rounded toward zero), v₁ the same of v − v₀, v₂ of v − v₀ − v₁, each
// residual exact in f32.  v₀ + v₁ + v₂ = v exactly (3 × 8 significand bits
// cover f32's 24) unless v needs bits below bf16's smallest subnormal
// 2⁻¹³³ (|v| < 2⁻¹¹⁰).  A bf16 input is one exact term; the f32 product of
// two bf16 values (x·w of a bf16 chunk) fits two.  Each term product
// aᵢ·bⱼ is exact in f32, and wgmma accumulates in f32.  Of the nine pairs
// the engine keeps the six with i + j ≤ 2 (three when one side has one
// term, two for a 2 × 1 split); the three it drops, a₁b₂ + a₂b₁ + a₂b₂,
// are below 2⁻²¹·|a||b| (|v₁| < 2⁻⁷|v|, |v₂| < 2⁻¹⁵|v|), under the f32
// sum's own rounding over K ≥ 8 terms.  kernels/ref.py::split_product is
// the plain model of this arithmetic.
//
// Non-finite values.  bf16_split3 turns ±Inf into (±Inf, NaN, NaN), since
// v − v₀ = Inf − Inf; a NaN stays NaN in some term; and Inf times a zero
// term of the other side is NaN.  So where the plain version's output is
// NaN the engine's is NaN, where it is ±Inf the engine's is non-finite
// (NaN), and finite entries agree within tolerance.  A 0 weight on a NaN or
// Inf row gives NaN terms (0·Inf in f32 before the split), as the
// reference keeps 0·Inf and 0·NaN rows as NaN.
//
// What bounds it on this card: bf16 tensor-core operations at the kept
// pair count, 6 × 2·M·N·K for f32 operands (989 TFLOP/s dense on an H100
// SXM at 700 W): 231.5 ms for the in-memory fit's five folds (p = 16,384,
// q = 16,828, K = 69,202 in all), 54.7 ms for the streamed fit's chunk
// (s·p = 32,768, q = 16,828, m = 8,192) and 15.9 ms for the seed path's
// solve (p = 16,384, r·t = 4,884), against 569.5, 134.8 and 39.1 ms at the
// f32 CUDA-core rate.  The split pass moves ~3.5 GB (~1 ms) at the chunk's
// shape.
//
// What the design does:
//   * split_kernel: one thread per 8 consecutive k of one row writes 16
//     bytes of each term plane, in the product kernel's shared-memory tile
//     layout: per (row tile, 32-k stage) one contiguous block of
//     [plane][k / 8][row][8] (wgmma's no-swizzle K-major core matrices).
//     Ragged rows and K are zero-filled here, so the product kernel needs
//     no masks on its loads, no tensor maps and no transposed descriptors,
//     and any layout of Q (read through its strides) lands the same way.
//   * product_kernel: one block per 128 × 192 output tile, rasterised in
//     groups of 16 row tiles so that the blocks running together share
//     operand panels in L2.  Thread 0 copies each stage's A and B blocks
//     (all planes: 60 KB for 3 × 3 terms) with two bulk copies into a ring
//     of 3 to 6 stages, handed over through mbarriers (full: bytes landed;
//     empty: one arrival per warp); it refills a slot while its own
//     products of the next stage run.  Two warpgroups own 64 rows each and
//     issue m64n192k16 wgmmas for every kept pair.  No atomics and no
//     split-K: repeated launches are bitwise equal.
//   * The tensor cores add each k16 product into their accumulator with
//     the sum truncated to the accumulator's exponent, not rounded.  One
//     accumulator over all K (a first version, 128 × 256 tiles) drifted
//     one way, up to the 1e-4·max|out| tolerance at both main shapes.  So
//     each stage's products go into a fresh set of 96 f32 registers,
//     which the warpgroup then adds to its running set on the CUDA cores,
//     rounded to nearest; the other warpgroup's products keep the tensor
//     cores busy meanwhile.  Two sets of 96 need more than the 168
//     registers a thread has beside a producer warp or warpgroup (the
//     register file is split between the SM's four schedulers, so 9 warps
//     get no more than 12), hence 192 columns and no producer warps: 256
//     threads, up to 255 registers each.
//   * Scratch (bf16, allocated by the wrapper with torch.empty): planes ×
//     rows and K padded to the tile.  At the folds' shape 1.36 GB for x and
//     1.40 GB for [X | Y] (the largest fold, 13,841 rows); at the chunk's
//     3 × 32,768 × 8,192 × 2 B = 1.61 GB for x·w and 3 × 16,896 × 8,192 ×
//     2 B = 0.83 GB for z; at the solve's, 1.61 GB for Q and 3 × 4,992 ×
//     16,384 × 2 B = 0.49 GB for the scaled A.
// Not done yet (later work): a persistent grid (the epilogue does not
// overlap the next tile's loads), thread-block clusters multicasting a
// shared panel, two part sets per warpgroup so it need not drain its own
// products before the fold, skipping all-zero stages of a slot (only where
// the x rows are finite), computing only half of a symmetric G_f or XᵀWX
// (it would change where rounding falls on mirrored entries, and needs
// square tiles), and moving xty onto this engine.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "split_engine.cuh"

namespace split_engine {
namespace {

constexpr int kSmemMax = 227 * 1024;   // a block's shared memory
constexpr int kThreads = 256;          // two warpgroups, 64 rows each
constexpr int kGroupM = 16;            // row tiles per rasterisation group
constexpr int kAcc = kBN / 2;          // f32 accumulators of a 64 × kBN tile

// The kept pairs (term of A', term of B'), i + j ≤ 2, largest first.
__host__ __device__ constexpr int pair_a(int i) {
  return i == 2 || i == 4 ? 1 : i == 5 ? 2 : 0;
}
__host__ __device__ constexpr int pair_b(int i) {
  return i == 1 || i == 4 ? 1 : i == 3 ? 2 : 0;
}

template <int NA, int NB>
struct Shape {
  static constexpr int A_STAGE = NA * kBM * kBK;  // elements of one stage
  static constexpr int B_STAGE = NB * kBN * kBK;
  static constexpr int STAGE_BYTES = 2 * (A_STAGE + B_STAGE);
  static constexpr int FIT = (kSmemMax - 1024) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr size_t SMEM =
      static_cast<size_t>(STAGES) * STAGE_BYTES + 16 * STAGES;
  static_assert(STAGES >= 3 && SMEM <= kSmemMax, "stages");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float top16(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffff0000u);
}

// grid-stride over (⌈K / 8⌉ k-groups) × (rows padded to the tile); block
// = 256 threads.  Consecutive threads take consecutive rows of one
// k-group, so row-contiguous sources are read and the tile blocks written
// in whole lines.
template <typename T, typename TS>
__global__ void __launch_bounds__(256)
    split_kernel(const Operand op, int tile_rows, long long K, long long nkb,
                 long long rpad) {
  const T* __restrict__ src = static_cast<const T*>(op.src);
  const TS* __restrict__ scale = static_cast<const TS*>(op.scale);
  __nv_bfloat16* __restrict__ dst = static_cast<__nv_bfloat16*>(op.scratch);
  const long long units = rpad * nkb * (kBK / 8);
  const long long tile_elems = static_cast<long long>(tile_rows) * kBK;
  for (long long u = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       u < units; u += static_cast<long long>(gridDim.x) * 256) {
    const long long row = u % rpad;
    const long long kg = u / rpad;
    const bool row_ok = row < op.rows;
    const long long g = row_ok ? row / op.inner : 0;
    const T* s = src + (row - g * op.inner) * op.si;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const long long k = kg * 8 + e;
      float x = 0.f;
      if (row_ok && k < K) {
        x = to_f32(s[k * op.sk]);
        // __fmul_rn: the product is rounded to f32 before the split, as
        // the plain version's, never contracted into the subtraction.
        if (scale != nullptr)
          x = __fmul_rn(x, to_f32(scale[k * op.ssk + g * op.ssg]));
      }
      v[e] = x;
    }
    const long long tile = row / tile_rows;
    const long long rr = row - tile * tile_rows;
    const long long kb = kg / (kBK / 8);
    const long long kc = kg - kb * (kBK / 8);
    __nv_bfloat16* out = dst + (tile * nkb + kb) * op.planes * tile_elems +
                         kc * tile_rows * 8 + rr * 8;
    for (int pl = 0; pl < op.planes; ++pl) {
      uint4 w;
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        wp[h] = __byte_perm(__float_as_uint(v[2 * h]),
                            __float_as_uint(v[2 * h + 1]), 0x7632);
        v[2 * h] = __fsub_rn(v[2 * h], top16(v[2 * h]));
        v[2 * h + 1] = __fsub_rn(v[2 * h + 1], top16(v[2 * h + 1]));
      }
      *reinterpret_cast<uint4*>(out + pl * tile_elems) = w;
    }
  }
}

// d (+)= A·Bᵀ for a 64 × 192 tile: A (64 × 16) and B (192 × 16) bf16 from
// shared memory, both K-major, f32 accumulators in registers; scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A warp hands a stage back once all its lanes are done with it.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// grid = ⌈M / 128⌉ · ⌈N / 192⌉ blocks, 256 threads: two warpgroups of 64
// output rows each; thread 0 also issues the copies.  a: the na planes of
// A' in (row tile, stage) blocks of na × 128 × 32, b: the nb planes of B'
// in blocks of nb × 192 × 32.
template <int NA, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    product_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   float* __restrict__ out, long long M, long long N,
                   int nkb, int mt, int nt, long long ld, long long nc,
                   long long cstride) {
  using Sh = Shape<NA, NB>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + Sh::STAGES * Sh::A_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + Sh::STAGES * Sh::B_STAGE);
  uint64_t* empty = full + Sh::STAGES;

  // Rasterisation: groups of kGroupM row tiles, column tiles within.
  const int pid = blockIdx.x;
  const int group = pid / (kGroupM * nt);
  const int first_m = group * kGroupM;
  const int gm = min(mt - first_m, kGroupM);
  const int in_group = pid - group * kGroupM * nt;
  const int tm = first_m + in_group % gm;
  const int tn = in_group / gm;
  const __nv_bfloat16* ga = a + static_cast<long long>(tm) * nkb * Sh::A_STAGE;
  const __nv_bfloat16* gb = b + static_cast<long long>(tn) * nkb * Sh::B_STAGE;
  // Stage kb's A and B blocks (all planes) into ring slot kb % STAGES.
  auto load = [&](int kb) {
    const int st = kb % Sh::STAGES;
    mbar_expect_tx(full + st, Sh::STAGE_BYTES);
    bulk_load(As + st * Sh::A_STAGE,
              ga + static_cast<long long>(kb) * Sh::A_STAGE, Sh::A_STAGE * 2,
              full + st);
    bulk_load(Bs + st * Sh::B_STAGE,
              gb + static_cast<long long>(kb) * Sh::B_STAGE, Sh::B_STAGE * 2,
              full + st);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < Sh::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kThreads / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kb = 0; kb < min(nkb, Sh::STAGES); ++kb) load(kb);
  }
  __syncthreads();

  const int wg = tid >> 7;
  const int lane = tid & 31;
  // Descriptors of stage 0, plane 0: K-major, LBO = the tile's rows × 16
  // bytes (the next 8-k column group), SBO = 128 (the next 8 rows); a byte
  // offset δ moves a descriptor by δ / 16.
  const uint64_t adesc = smem_desc(As + wg * 64 * 8, kBM * 16, 128);
  const uint64_t bdesc = smem_desc(Bs, kBN * 16, 128);
  // The tensor cores add each k16 product into the accumulator with the
  // sum truncated, not rounded, to the accumulator's exponent: summed over
  // all K into one set, that bias grows with K.  So each stage's 12
  // products (6 pairs × 2 k-steps) go into a fresh set `part`, which is
  // then added to `acc` on the CUDA cores, rounded to nearest.
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;

#pragma unroll 1
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb % Sh::STAGES;
    mbar_wait(full + st, (kb / Sh::STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
      for (int pp = 0; pp < 6; ++pp) {
        if (pair_a(pp) >= NA || pair_b(pp) >= NB) continue;
        wgmma_n192(part,
                   adesc + (st * Sh::A_STAGE + pair_a(pp) * kBM * kBK) / 8 +
                       ks * (kBM * 32 / 16),
                   bdesc + (st * Sh::B_STAGE + pair_b(pp) * kBN * kBK) / 8 +
                       ks * (kBN * 32 / 16),
                   ks > 0 || pp > 0);
      }
    wg_commit();
    // While the products run: once every warp has handed back the previous
    // stage's slot, refill it with the stage STAGES − 1 ahead.
    if (tid == 0 && kb > 0 && kb - 1 + Sh::STAGES < nkb) {
      mbar_wait(empty + (kb - 1) % Sh::STAGES, ((kb - 1) / Sh::STAGES) & 1);
      load(kb - 1 + Sh::STAGES);
    }
    __syncwarp();
    wg_wait_all();
    keep(part);
    // This stage's tiles are read: hand them back, then fold the part in.
    release(empty + st);
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] += part[e];
  }

  // acc[4c + 2h + e] is row row0 + 8h, column 8c + 2·(lane % 4) + e of
  // this warpgroup's 64 × 192 tile.
  const long long row0 = static_cast<long long>(tm) * kBM + wg * 64 +
                         ((tid >> 5) & 3) * 16 + (lane >> 2);
  const long long col0 = static_cast<long long>(tn) * kBN + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 8 * h;
    if (row >= M) continue;
    float* orow = out + row * ld;
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c) {
      const long long j = col0 + 8 * c;
      if (j >= N) continue;
      const long long grp = j / nc;
      const long long jj = j - grp * nc;
      float* o = orow + grp * cstride + jj;
      const float v0 = acc[4 * c + 2 * h], v1 = acc[4 * c + 2 * h + 1];
      if (j + 1 < N && jj + 1 < nc &&
          (reinterpret_cast<uintptr_t>(o) & 7) == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (j + 1 < N) {
          const long long g1 = (j + 1) / nc;
          orow[g1 * cstride + (j + 1 - g1 * nc)] = v1;
        }
      }
    }
  }
}

template <int NA, int NB>
cudaError_t launch_product(const void* a, const void* b, long long M,
                           long long N, long long K, float* out, long long ld,
                           long long nc, long long cstride,
                           cudaStream_t stream) {
  using Sh = Shape<NA, NB>;
  const long long mt = (M + kBM - 1) / kBM, nt = (N + kBN - 1) / kBN;
  const long long nkb = (K + kBK - 1) / kBK;
  if (mt * nt > 0x7fffffffLL || nkb > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      product_kernel<NA, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::SMEM));
  if (err != cudaSuccess) return err;
  product_kernel<NA, NB><<<static_cast<unsigned>(mt * nt), kThreads,
                           Sh::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), out, M, N,
      static_cast<int>(nkb), static_cast<int>(mt), static_cast<int>(nt), ld,
      nc, cstride);
  return cudaGetLastError();
}

}  // namespace

cudaError_t split(const Operand& op, int tile_rows, long long K,
                  cudaStream_t stream) {
  if (op.planes < 1 || op.planes > 3 || op.inner < 1 || op.rows < 0 ||
      (tile_rows != kBM && tile_rows != kBN) || K < 0)
    return cudaErrorInvalidValue;
  const long long rpad = (op.rows + tile_rows - 1) / tile_rows * tile_rows;
  const long long nkb = (K + kBK - 1) / kBK;
  const long long units = rpad * nkb * (kBK / 8);
  if (units == 0) return cudaSuccess;
  const long long want = (units + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want
                                                                 : 1 << 20);
  if (!op.src_bf16 && (op.scale == nullptr || !op.scale_bf16))
    split_kernel<float, float><<<blocks, 256, 0, stream>>>(op, tile_rows, K,
                                                           nkb, rpad);
  else if (op.src_bf16 && op.scale != nullptr && op.scale_bf16)
    split_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<blocks, 256, 0, stream>>>(op, tile_rows, K, nkb, rpad);
  else if (op.src_bf16)
    split_kernel<__nv_bfloat16, float><<<blocks, 256, 0, stream>>>(
        op, tile_rows, K, nkb, rpad);
  else
    return cudaErrorInvalidValue;   // f32 values, bf16 scale: not used
  return cudaGetLastError();
}

cudaError_t product(const void* a, int na, const void* b, int nb,
                    long long M, long long N, long long K, float* out,
                    long long ld, long long nc, long long cstride,
                    cudaStream_t stream) {
  if (M < 1 || N < 1 || nc < 1) return cudaErrorInvalidValue;
  if (na == 3 && nb == 3)
    return launch_product<3, 3>(a, b, M, N, K, out, ld, nc, cstride, stream);
  if (na == 2 && nb == 1)
    return launch_product<2, 1>(a, b, M, N, K, out, ld, nc, cstride, stream);
  if (na == 1 && nb == 3)
    return launch_product<1, 3>(a, b, M, N, K, out, ld, nc, cstride, stream);
  if (na == 1 && nb == 1)
    return launch_product<1, 1>(a, b, M, N, K, out, ld, nc, cstride, stream);
  return cudaErrorInvalidValue;
}

}  // namespace split_engine
