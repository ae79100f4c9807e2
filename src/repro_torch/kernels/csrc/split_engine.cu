// The split-bf16 tensor-core engine: out = A'ᵀ · B' in f32 accuracy on the
// bf16 tensor cores (interface and operand rules in split_engine.cuh).
//
// Serves four kernels, each of which folds its batch into one axis, into
// consecutive products or into ranges of K:
//   * xty (gram.cu; TPU kernel src/repro/kernels/gram.py xty, and gram):
//     out = xᵀ y, one product over K = n rows, split-K over S row ranges
//     where the output has too few tiles to fill the card; where y is x
//     (gram, the dual XXᵀ) one split serves both sides;
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
// the plain model of this arithmetic (ref.xty_split of xty's split-K).
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
// (s·p = 32,768, q = 16,828, m = 8,192), 15.9 ms for the seed path's
// solve (p = 16,384, r·t = 4,884), 90.2 ms for a seed-path fold Gram
// (p = 16,384, n = 55,361) and 0.100 + 0.398 ms for the dual fit's XXᵀ
// and Xᵀα (n = 1,000, p = 16,384, t = 2,000), against 569.5, 134.8, 39.1,
// 221.8 and 0.245 + 0.978 ms at the f32 CUDA-core rate.  Where x is y
// (the Gram, XXᵀ) the count is 6 × n·p·(p+1), the symmetric output's
// upper triangle; the engine computes the whole square, twice that.  The split pass
// moves ~3.5 GB (~1 ms) at the chunk's shape.
//
// What the design does:
//   * split_kernel: one thread per 8 consecutive k of one row writes 16
//     bytes of each term plane, in the layout
//     [K / 32][rows / 8][plane][k % 32 / 8][row % 8][k % 8]: per 32-k
//     stage, the 8-row groups one after another, each holding its planes'
//     wgmma no-swizzle K-major core matrices (8 rows × 8 k in 128 bytes;
//     LBO 128 bytes along k, SBO planes × 512 along rows).  A tile's stage,
//     all planes, is one contiguous block for any tile height, so one
//     split serves a 128-row Aᵀ tile and a 192-row B tile alike (xty's
//     x is y: rows padded to 384).  Ragged rows and K are zero-filled
//     here, so the product kernel needs no masks on its loads, no tensor
//     maps and no transposed descriptors, and any layout of an operand
//     (read through its strides: Q column-major, xty's transposed x of
//     the dual XXᵀ) lands the same way.
//   * product_kernel: one block per 128 × BN output tile and K range
//     (BN = 192, or 32 where N ≤ 32: MOR's single-target Xᵀα would waste
//     191 of 192 columns), rasterised in groups of 16 row tiles so that
//     the blocks running together share operand panels in L2.  Thread 0
//     copies each stage's A and B blocks (all planes: 60 KB for 3 × 3
//     terms at BN = 192) with two bulk copies into a ring of 3 to 6
//     stages, handed over through mbarriers (full: bytes landed; empty:
//     one arrival per warp); it refills a slot while its own products of
//     the next stage run.  Two warpgroups own 64 rows each and issue
//     m64nBNk16 wgmmas for every kept pair.  No atomics: repeated launches
//     are bitwise equal.
//   * Split-K (xty only): blockIdx.y picks the K range [s·split_k,
//     (s + 1)·split_k), whole stages of the one split, and the block
//     writes its partial tile to slice s; the caller adds the slices in
//     split order (gram.cu, xty_split_sum_kernel).  All ranges run in one
//     launch, so a 48-tile output (the dual XXᵀ) fills the card.
//   * The tensor cores add each k16 product into their accumulator with
//     the sum truncated to the accumulator's exponent, not rounded.  One
//     accumulator over all K (a first version, 128 × 256 tiles) drifted
//     one way, up to the 1e-4·max|out| tolerance at both main shapes.  So
//     each stage's products go into a fresh set of BN / 2 f32 registers,
//     which the warpgroup then adds to its running set on the CUDA cores,
//     rounded to nearest; the other warpgroup's products keep the tensor
//     cores busy meanwhile.  Two sets of 96 need more than the 168
//     registers a thread has beside a producer warp or warpgroup (the
//     register file is split between the SM's four schedulers, so 9 warps
//     get no more than 12), hence 192 columns and no producer warps: 256
//     threads, up to 255 registers each.
//   * Scratch (bf16, allocated by the wrapper with torch.empty): planes ×
//     rows and K padded.  At the folds' shape 1.36 GB for x and 1.40 GB
//     for [X | Y] (the largest fold, 13,841 rows); at the chunk's 3 ×
//     32,768 × 8,192 × 2 B = 1.61 GB for x·w and 3 × 16,896 × 8,192 × 2 B
//     = 0.83 GB for z; at the solve's, 1.61 GB for Q and 3 × 4,992 ×
//     16,384 × 2 B = 0.49 GB for the scaled A; xty's in gram.cu.
// Not done yet (later work): a persistent grid (the epilogue does not
// overlap the next tile's loads), thread-block clusters multicasting a
// shared panel, two part sets per warpgroup so it need not drain its own
// products before the fold, skipping all-zero stages of a slot (only where
// the x rows are finite), and computing only half of a symmetric output:
// xty(x, x) (the seed path's fold Grams, the dual XXᵀ: half the work of
// the whole square, the half their bound counts), G_f or XᵀWX (it would
// change where rounding falls on mirrored entries, and needs square
// tiles).
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
constexpr int kCore = 8 * kBK;         // elements of one 8-row group's plane

// The kept pairs (term of A', term of B'), i + j ≤ 2, largest first.
__host__ __device__ constexpr int pair_a(int i) {
  return i == 2 || i == 4 ? 1 : i == 5 ? 2 : 0;
}
__host__ __device__ constexpr int pair_b(int i) {
  return i == 1 || i == 4 ? 1 : i == 3 ? 2 : 0;
}

template <int NA, int NB, int BN>
struct Shape {
  static constexpr int A_STAGE = NA * kBM * kBK;  // elements of one stage
  static constexpr int B_STAGE = NB * BN * kBK;
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

// grid-stride over (⌈K / 8⌉ k-groups) × (rows padded); block = 256
// threads.  Consecutive threads take consecutive rows of one k-group, so
// row-contiguous sources are read in whole lines (a k-contiguous source,
// in 32-byte sectors) and each 8-row group's core matrix is written whole.
template <typename T, typename TS>
__global__ void __launch_bounds__(256)
    split_kernel(const Operand op, long long K, long long rpad) {
  const T* __restrict__ src = static_cast<const T*>(op.src);
  const TS* __restrict__ scale = static_cast<const TS*>(op.scale);
  __nv_bfloat16* __restrict__ dst = static_cast<__nv_bfloat16*>(op.scratch);
  const long long nkg = (K + kBK - 1) / kBK * (kBK / 8);
  const long long units = rpad * nkg;
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
    const long long kb = kg / (kBK / 8);
    const long long kc = kg - kb * (kBK / 8);
    __nv_bfloat16* out =
        dst + ((kb * (rpad / 8) + row / 8) * op.planes) * kCore + kc * 64 +
        (row % 8) * 8;
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
      *reinterpret_cast<uint4*>(out + pl * kCore) = w;
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

// The same for a 64 × 32 tile (B 32 × 16).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A warp hands a stage back once all its lanes are done with it.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// grid = (⌈M / 128⌉ · ⌈N / BN⌉, S) blocks, 256 threads: two warpgroups of
// 64 output rows each; thread 0 also issues the copies.  a, b: the planes
// in split()'s layout; a_stage, b_stage: the elements of one 32-k stage of
// each side (rows padded × planes × 32); block (·, s) runs the stages
// [s·kb_per, min((s + 1)·kb_per, nkb)) into out + s·split_stride.
template <int NA, int NB, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    product_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   float* __restrict__ out, long long M, long long N,
                   long long a_stage, long long b_stage, int nkb, int kb_per,
                   int mt, int nt, long long ld, long long nc,
                   long long cstride, long long split_stride) {
  using Sh = Shape<NA, NB, BN>;
  constexpr int kAcc = BN / 2;  // f32 accumulators of a 64 × BN tile
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
  // This block's K range: stages kb0 .. kb0 + nk − 1.
  const int kb0 = blockIdx.y * kb_per;
  const int nk = min(kb_per, nkb - kb0);
  const __nv_bfloat16* ga = a + static_cast<long long>(tm) * Sh::A_STAGE +
                            static_cast<long long>(kb0) * a_stage;
  const __nv_bfloat16* gb = b + static_cast<long long>(tn) * Sh::B_STAGE +
                            static_cast<long long>(kb0) * b_stage;
  out += blockIdx.y * split_stride;
  // Stage i of the range: its A and B blocks (all planes) into ring slot
  // i % STAGES.
  auto load = [&](int i) {
    const int st = i % Sh::STAGES;
    mbar_expect_tx(full + st, Sh::STAGE_BYTES);
    bulk_load(As + st * Sh::A_STAGE, ga + static_cast<long long>(i) * a_stage,
              Sh::A_STAGE * 2, full + st);
    bulk_load(Bs + st * Sh::B_STAGE, gb + static_cast<long long>(i) * b_stage,
              Sh::B_STAGE * 2, full + st);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < Sh::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kThreads / 32);  // one per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(nk, Sh::STAGES); ++i) load(i);
  }
  __syncthreads();

  const int wg = tid >> 7;
  const int lane = tid & 31;
  // Descriptors of stage 0, plane 0: K-major, LBO = 128 bytes (the next
  // 8-k core matrix), SBO = planes × 512 (the next 8 rows); a warpgroup's
  // 64 rows are 8 such groups.  An element offset δ moves a descriptor by
  // δ / 8 (16-byte units): plane by kCore, k16 step by 128.
  const uint64_t adesc = smem_desc(As + wg * 64 * NA * kBK, 128, NA * 512);
  const uint64_t bdesc = smem_desc(Bs, 128, NB * 512);
  // The tensor cores add each k16 product into the accumulator with the
  // sum truncated, not rounded, to the accumulator's exponent: summed over
  // all K into one set, that bias grows with K.  So each stage's products
  // (kept pairs × 2 k-steps) go into a fresh set `part`, which is then
  // added to `acc` on the CUDA cores, rounded to nearest.
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < nk; ++i) {
    const int st = i % Sh::STAGES;
    mbar_wait(full + st, (i / Sh::STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
      for (int pp = 0; pp < 6; ++pp) {
        if (pair_a(pp) >= NA || pair_b(pp) >= NB) continue;
        const uint64_t da =
            adesc + (st * Sh::A_STAGE + pair_a(pp) * kCore + ks * 128) / 8;
        const uint64_t db =
            bdesc + (st * Sh::B_STAGE + pair_b(pp) * kCore + ks * 128) / 8;
        if constexpr (BN == kBN)
          wgmma_n192(part, da, db, ks > 0 || pp > 0);
        else
          wgmma_n32(part, da, db, ks > 0 || pp > 0);
      }
    wg_commit();
    // While the products run: once every warp has handed back the previous
    // stage's slot, refill it with the stage STAGES − 1 ahead.
    if (tid == 0 && i > 0 && i - 1 + Sh::STAGES < nk) {
      mbar_wait(empty + (i - 1) % Sh::STAGES, ((i - 1) / Sh::STAGES) & 1);
      load(i - 1 + Sh::STAGES);
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
  // this warpgroup's 64 × BN tile.
  const long long row0 = static_cast<long long>(tm) * kBM + wg * 64 +
                         ((tid >> 5) & 3) * 16 + (lane >> 2);
  const long long col0 = static_cast<long long>(tn) * BN + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + 8 * h;
    if (row >= M) continue;
    float* orow = out + row * ld;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
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

template <int NA, int NB, int BN>
cudaError_t launch_product(const Product& pr, cudaStream_t stream) {
  using Sh = Shape<NA, NB, BN>;
  const long long mt = (pr.M + kBM - 1) / kBM, nt = (pr.N + BN - 1) / BN;
  const long long nkb = (pr.K + kBK - 1) / kBK;
  const long long kb_per = pr.split_k == 0 || pr.split_k >= pr.K
                               ? (nkb > 0 ? nkb : 1)
                               : pr.split_k / kBK;
  const long long splits = nkb > 0 ? (nkb + kb_per - 1) / kb_per : 1;
  if (mt * nt > 0x7fffffffLL || nkb > 0x7fffffffLL || splits > 65535 ||
      pr.a_rows % kBM != 0 || pr.a_rows < pr.M || pr.b_rows % BN != 0 ||
      pr.b_rows < pr.N)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      product_kernel<NA, NB, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sh::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(mt * nt),
                  static_cast<unsigned>(splits));
  product_kernel<NA, NB, BN><<<grid, kThreads, Sh::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(pr.a),
      static_cast<const __nv_bfloat16*>(pr.b), pr.out, pr.M, pr.N,
      pr.a_rows * NA * kBK, pr.b_rows * NB * kBK, static_cast<int>(nkb),
      static_cast<int>(kb_per), static_cast<int>(mt), static_cast<int>(nt),
      pr.ld, pr.nc, pr.cstride, pr.split_stride);
  return cudaGetLastError();
}

template <int BN>
cudaError_t product_bn(const Product& pr, cudaStream_t stream) {
  if (pr.na == 3 && pr.nb == 3) return launch_product<3, 3, BN>(pr, stream);
  if (pr.na == 2 && pr.nb == 1) return launch_product<2, 1, BN>(pr, stream);
  if (pr.na == 1 && pr.nb == 3) return launch_product<1, 3, BN>(pr, stream);
  if (pr.na == 1 && pr.nb == 1) return launch_product<1, 1, BN>(pr, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t split(const Operand& op, long long pad, long long K,
                  cudaStream_t stream) {
  if (op.planes < 1 || op.planes > 3 || op.inner < 1 || op.rows < 0 ||
      pad < 8 || pad % 8 != 0 || K < 0)
    return cudaErrorInvalidValue;
  const long long rpad = padded(op.rows, pad);
  const long long units = rpad * ((K + kBK - 1) / kBK) * (kBK / 8);
  if (units == 0) return cudaSuccess;
  const long long want = (units + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want
                                                                 : 1 << 20);
  if (!op.src_bf16 && (op.scale == nullptr || !op.scale_bf16))
    split_kernel<float, float><<<blocks, 256, 0, stream>>>(op, K, rpad);
  else if (op.src_bf16 && op.scale != nullptr && op.scale_bf16)
    split_kernel<__nv_bfloat16, __nv_bfloat16>
        <<<blocks, 256, 0, stream>>>(op, K, rpad);
  else if (op.src_bf16)
    split_kernel<__nv_bfloat16, float><<<blocks, 256, 0, stream>>>(op, K,
                                                                   rpad);
  else
    return cudaErrorInvalidValue;   // f32 values, bf16 scale: not used
  return cudaGetLastError();
}

cudaError_t product(const Product& pr, cudaStream_t stream) {
  if (pr.M < 1 || pr.N < 1 || pr.K < 0 || pr.nc < 1 || pr.split_k < 0 ||
      pr.split_k % kBK != 0)
    return cudaErrorInvalidValue;
  return tile_n(pr.N) == kBN ? product_bn<kBN>(pr, stream)
                             : product_bn<kBNNarrow>(pr, stream);
}

}  // namespace split_engine
