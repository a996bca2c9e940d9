// W4A16 fused matmul: y = (x @ unpack(q)) * s in one kernel, for Hopper.
//
// Replaces no TPU kernel. The JAX package stores a W4A16 weight as jnp.int4
// and XLA fuses the int4 -> bf16 convert into the matmul's operand load
// (cxl_speckv_tpu/ops/wquant.py, `mm` and `qeinsum`), so no Pallas kernel
// has this job. The port stores two signed nibbles a byte along the output
// axis, half-split: byte j of a row holds column j in its low nibble and
// column j + N/2 in its high nibble (ops/wquant.py).
//
// What bounds it: at decode (8 rows) bytes. The packed weight is 0.5 byte a
// value and the product does 2 * M operations a weight value, far below
// the card's ridge of ~295 bf16 operations a byte, so the least time is the
// packed weight's bytes over the HBM rate. The kernel reads every packed
// byte from HBM once and puts its two values only in registers: no bf16
// copy of the weight reaches shared or global memory.
//
// Design:
// - a CTA owns a strip of BP = 128 packed columns (32 a warp, side by
//   side), and with it both output strips those bytes feed, [p0, p0 + BP)
//   and [N/2 + p0, N/2 + p0 + BP), for MB rows of x (8 to 64): no warp
//   unpacks another warp's bytes;
// - [BK = 64 x BP]-byte tiles of q and the [MB x BK] tile of x go through a
//   ring of NSTAGE stages in shared memory, filled by 16-byte cp.async (the
//   q tile swizzled so that the fragment reads below are free of bank
//   conflicts); a shape that 16-byte copies cannot take (a ragged width, an
//   unaligned pointer) fills the ring with byte / element loads instead;
// - bf16 / f16: the weight is the 16-row side of mma.sync.m16n8k16 and x the
//   8-wide side, so decode's 8 rows fill the product. A thread reads four
//   32-bit words of the q tile (4 k rows x 4 packed columns), pairs k rows
//   with a byte permute and builds each A register by OR-ing two offset
//   nibbles into the exponent bias (0x4300 bf16, 0x6400 f16) and one fused
//   multiply-add that removes the bias; the same bytes give the low-nibble
//   and the high-nibble fragments, and every m-tile of the warp reuses
//   them. The k order inside a 16-deep product is a permutation, the same
//   for A and B;
// - float32 activations: IEEE float32 FMA on CUDA cores (no TF32), each
//   thread one packed column (both halves) for MB rows;
// - split-K where the strips are too few to fill the card: each split
//   writes float32 partials to a workspace, the last CTA of a tile to
//   arrive (a per-tile counter, reset by that CTA) sums them in split order,
//   so two calls give the same bits;
// - epilogue in the composition's rounding: float32 sum, rounded to the
//   activation type, times the scale rounded to that type, rounded again
//   (float32: the sum times the scale).
// The ring, its tile loaders, the product and split-K are shared with the
// int8 kernel (wq_mm.cuh, w8a16_mm.cu).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wq_mm.cuh"

namespace {

using namespace wq;

constexpr int BK = 64;             // k rows of a stage
constexpr int NSTAGE = 4;          // ring depth
constexpr int BP = STRIP;          // packed columns of a strip

struct W4Args {
  const void* x;     // [B, M, K] activation kind
  const int8_t* q;   // [B, K, H] packed
  Out o;             // y [B, M, N], s [B, N] (N = 2H), ws, cnt, splits
  int K, H, vec;
};

// the bias constants of the nibble conversion
template <int KIND>
struct Nib;
template <>
struct Nib<kBF16> {
  static constexpr uint32_t kMagic = 0x43004300u;   // 128.0, twice
  static constexpr uint32_t kOne = 0x3F803F80u;     // 1.0
  static constexpr uint32_t kBias = 0xC308C308u;    // -136.0 = -(128 + 8)
};
template <>
struct Nib<kF16> {
  static constexpr uint32_t kMagic = 0x64006400u;   // 1024.0
  static constexpr uint32_t kOne = 0x3C003C00u;     // 1.0
  static constexpr uint32_t kBias = 0xE408E408u;    // -1032.0
};

// one stage: q rows [k0, k0 + BK) x packed columns [p0, p0 + BP), x rows
// [m0, m0 + MB) x columns [k0, k0 + BK); out of range reads as zero
template <typename T, int MB, int XS>
__device__ __forceinline__ void load_stage(uint8_t* sq, T* sx, const T* x,
                                           const int8_t* q, const W4Args& a,
                                           int m0, int p0, int k0) {
  load_rows<BK>(sq, q, a.K, a.H, k0, p0, a.vec);
  load_x<T, MB, XS, BK>(sx, x, a.o.M, a.K, m0, k0, a.vec);
}

// a finished value (or, split, a partial) for output row m, packed column
// pc, half h (0: column pc, 1: column H + pc)
template <int KIND>
__device__ __forceinline__ void put_half(const W4Args& a, int b, int sp,
                                         int m, int pc, int h, float v) {
  if (m >= a.o.M || pc >= a.H) return;
  put<KIND>(a.o, b, sp, m, pc + h * a.H, v);
}

// two 16-bit values from the offset nibbles at bits [sh, sh + 4) and
// [16 + sh, 20 + sh) of w: (nibble | bias exponent) - (bias + 8)
template <int KIND, int SH>
__device__ __forceinline__ uint32_t nib2(uint32_t w) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(r)
      : "r"(w >> SH), "r"(0x000F000Fu), "r"(Nib<KIND>::kMagic));
  if constexpr (KIND == kBF16) {
    asm("fma.rn.bf16x2 %0, %0, %1, %2;\n"
        : "+r"(r)
        : "r"(Nib<KIND>::kOne), "r"(Nib<KIND>::kBias));
  } else {
    asm("fma.rn.f16x2 %0, %0, %1, %2;\n"
        : "+r"(r)
        : "r"(Nib<KIND>::kOne), "r"(Nib<KIND>::kBias));
  }
  return r;
}

// bf16 / f16 activations on the tensor cores. Warp w owns packed columns
// 32w .. 32w + 31 of the strip and all MT m-tiles of 8 rows, over the
// stage's BK / 16 k chunks of 16. Accumulator [u][mt][i]: u the product
// (0 / 1: columns 4g, 4g+1 low / high nibble; 2 / 3: 4g+2, 4g+3); i the
// mma's C element (rows g, g+8 of A = two packed columns; columns 2t, 2t+1
// of B = two rows of x).
template <int KIND, int MT>
__global__ void __launch_bounds__(THREADS)
    w4a16_mma_kernel(const W4Args a) {
  using T = typename Kind<KIND>::T;
  constexpr int MB = MT * 8, XS = BK + 16;
  constexpr int QT = BK * BP, XT = MB * XS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  T* sx = reinterpret_cast<T*>(smem + NSTAGE * QT);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * BP, m0 = blockIdx.y * MB;
  const int b = blockIdx.z / a.o.splits, sp = blockIdx.z % a.o.splits;
  const Span span = split_span(a.K, BK, a.o.splits, sp);
  const T* x = static_cast<const T*>(a.x) + (long long)b * a.o.M * a.K;
  const int8_t* q = a.q + (long long)b * a.K * a.H;

  float acc[4][MT][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][mt][i] = 0.f;

  auto load = [&](int slot, int i) {
    load_stage<T, MB, XS>(sq + slot * QT, sx + slot * XT, x, q, a, m0, p0,
                          (span.s0 + i) * BK);
  };
  auto step = [&](int slot) {
    const uint8_t* bq = sq + slot * QT;
    const T* bx = sx + slot * XT;
#pragma unroll
    for (int ch = 0; ch < BK / 16; ++ch) {
      // B: x rows, k = 16ch + 4t .. 4t+3 (the permuted k order)
      uint32_t xb[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            bx + (mt * 8 + g) * XS + ch * 16 + 4 * t);
        xb[mt][0] = v.x;
        xb[mt][1] = v.y;
      }
      const int r = ch * 16 + 4 * t, c = 32 * warp + 4 * g;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const uint32_t*>(bq + qoff(r + j, c));
      // k rows (0, 1) and (2, 3) paired byte by byte; nibbles to offset
      // binary (v + 8)
      const uint32_t p01a = __byte_perm(w[0], w[1], 0x5410) ^ 0x88888888u;
      const uint32_t p01b = __byte_perm(w[0], w[1], 0x7632) ^ 0x88888888u;
      const uint32_t p23a = __byte_perm(w[2], w[3], 0x5410) ^ 0x88888888u;
      const uint32_t p23b = __byte_perm(w[2], w[3], 0x7632) ^ 0x88888888u;
      uint32_t fa[4][4];
      fa[0][0] = nib2<KIND, 0>(p01a);
      fa[0][1] = nib2<KIND, 8>(p01a);
      fa[0][2] = nib2<KIND, 0>(p23a);
      fa[0][3] = nib2<KIND, 8>(p23a);
      fa[1][0] = nib2<KIND, 4>(p01a);
      fa[1][1] = nib2<KIND, 12>(p01a);
      fa[1][2] = nib2<KIND, 4>(p23a);
      fa[1][3] = nib2<KIND, 12>(p23a);
      fa[2][0] = nib2<KIND, 0>(p01b);
      fa[2][1] = nib2<KIND, 8>(p01b);
      fa[2][2] = nib2<KIND, 0>(p23b);
      fa[2][3] = nib2<KIND, 8>(p23b);
      fa[3][0] = nib2<KIND, 4>(p01b);
      fa[3][1] = nib2<KIND, 12>(p01b);
      fa[3][2] = nib2<KIND, 4>(p23b);
      fa[3][3] = nib2<KIND, 12>(p23b);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma<KIND>(acc[u][mt], fa[u], xb[mt][0], xb[mt][1]);
    }
  };
  ring<NSTAGE>(span.n, load, step);

  // C element i of product u, m-tile mt -> output row, packed column, half
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        put_half<KIND>(a, b, sp, m0 + mt * 8 + 2 * t + (i & 1),
                       p0 + 32 * warp + 4 * g + 2 * (u >> 1) + (i >> 1),
                       u & 1, acc[u][mt][i]);
  if (a.o.splits > 1)
    split_tail<KIND, MB, 2>(a.o, b, m0, p0, a.H, a.H, a.vec);
}

// float32 activations: IEEE FMA on CUDA cores. Thread: packed column
// p0 + tid, both halves, all MB rows (x values read as broadcasts).
template <int MB>
__global__ void __launch_bounds__(THREADS) w4a16_fma_kernel(const W4Args a) {
  static_assert(BP == THREADS, "a thread a packed column");
  constexpr int XS = BK + 8, QT = BK * BP, XT = MB * XS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  float* sx = reinterpret_cast<float*>(smem + NSTAGE * QT);

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * BP, m0 = blockIdx.y * MB;
  const int b = blockIdx.z / a.o.splits, sp = blockIdx.z % a.o.splits;
  const Span span = split_span(a.K, BK, a.o.splits, sp);
  const float* x =
      static_cast<const float*>(a.x) + (long long)b * a.o.M * a.K;
  const int8_t* q = a.q + (long long)b * a.K * a.H;

  float acc[MB][2];
#pragma unroll
  for (int i = 0; i < MB; ++i) acc[i][0] = acc[i][1] = 0.f;

  auto load = [&](int slot, int i) {
    load_stage<float, MB, XS>(sq + slot * QT, sx + slot * XT, x, q, a, m0,
                              p0, (span.s0 + i) * BK);
  };
  auto step = [&](int slot) {
    const uint8_t* bq = sq + slot * QT;
    const float* bx = sx + slot * XT;
#pragma unroll 2
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float lo[4], hi[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int v = static_cast<int8_t>(bq[qoff(k4 + kk, tid)]);
        lo[kk] = static_cast<float>(static_cast<int>(
                                        static_cast<uint32_t>(v) << 28) >> 28);
        hi[kk] = static_cast<float>(v >> 4);
      }
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(bx + i * XS + k4);
        acc[i][0] = fmaf(xv.x, lo[0], acc[i][0]);
        acc[i][1] = fmaf(xv.x, hi[0], acc[i][1]);
        acc[i][0] = fmaf(xv.y, lo[1], acc[i][0]);
        acc[i][1] = fmaf(xv.y, hi[1], acc[i][1]);
        acc[i][0] = fmaf(xv.z, lo[2], acc[i][0]);
        acc[i][1] = fmaf(xv.z, hi[2], acc[i][1]);
        acc[i][0] = fmaf(xv.w, lo[3], acc[i][0]);
        acc[i][1] = fmaf(xv.w, hi[3], acc[i][1]);
      }
    }
  };
  ring<NSTAGE>(span.n, load, step);
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    put_half<kF32>(a, b, sp, m0 + i, p0 + tid, 0, acc[i][0]);
    put_half<kF32>(a, b, sp, m0 + i, p0 + tid, 1, acc[i][1]);
  }
  if (a.o.splits > 1)
    split_tail<kF32, MB, 2>(a.o, b, m0, p0, a.H, a.H, a.vec);
}

// the kernel configurations (ops/w4a16_mm.py: MMA_BLOCKS, FMA_BLOCK): rows
// MB, dynamic shared memory, the kernel
template <int KIND, int MT>
struct MmaCfg {
  static constexpr int MB = MT * 8;
  static constexpr int SMEM = NSTAGE * (BK * BP + MB * (BK + 16) * 2);
  static auto kern() { return w4a16_mma_kernel<KIND, MT>; }
};
struct FmaCfg {
  static constexpr int MB = 16;
  static constexpr int SMEM = NSTAGE * (BK * BP + MB * (BK + 8) * 4);
  static auto kern() { return w4a16_fma_kernel<MB>; }
};

// f(config) for activation kind `kind` and config id `cfg`: 0-4 the
// tensor-core kernel (bf16, f16) at MB 8 / 16 / 32 / 48 / 64 rows, 5 the
// float32 kernel at 16
template <typename F>
int with_cfg(int kind, int cfg, F&& f) {
  auto mma = [&](auto kt) -> int {
    constexpr int K = decltype(kt)::value;
    switch (cfg) {
      case 0: return f(MmaCfg<K, 1>{});
      case 1: return f(MmaCfg<K, 2>{});
      case 2: return f(MmaCfg<K, 4>{});
      case 3: return f(MmaCfg<K, 6>{});
      case 4: return f(MmaCfg<K, 8>{});
      default: return -(int)cudaErrorInvalidValue;
    }
  };
  switch (kind) {
    case kBF16: return mma(std::integral_constant<int, kBF16>{});
    case kF16: return mma(std::integral_constant<int, kF16>{});
    case kF32:
      return cfg == 5 ? f(FmaCfg{}) : -(int)cudaErrorInvalidValue;
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, M, K] of kind `kind`, q [B, K, H] int8, s [B, 2H] float32, y
// [B, M, 2H] of kind `kind`, all contiguous; ws [B, splits, M, 2H] float32
// when splits > 1, cnt B * ceil(H / 128) * ceil(M / MB) zeroed ints; cfg the
// kernel configuration (`with_cfg`). vec: 16-byte copies may fill the ring
// (the wrapper checks widths and alignment). Returns a cudaError_t code (0
// = launched).
extern "C" int w4a16_mm_launch(const void* x, const void* q, const void* s,
                               void* y, void* ws, void* cnt, int B, int M,
                               int K, int H, int kind, int cfg, int splits,
                               int vec, void* stream) {
  if (splits < 1 || B < 1 || M < 1 || K < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const W4Args a{x, static_cast<const int8_t*>(q),
                 Out{y, static_cast<const float*>(s), static_cast<float*>(ws),
                     static_cast<int*>(cnt), M, 2 * H, splits},
                 K, H, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = with_cfg(kind, cfg, [&](auto c) -> int {
    using C = decltype(c);
    const cudaError_t e = allow_smem<C>();
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((H + BP - 1) / BP, (M + C::MB - 1) / C::MB, B * splits);
    const auto kern = C::kern();
    kern<<<grid, THREADS, C::SMEM, st>>>(a);
    return (int)cudaGetLastError();
  });
  return r < 0 ? -r : r;
}
