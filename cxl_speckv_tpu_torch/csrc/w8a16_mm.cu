// W8A16 fused matmul: y = (x @ q.to(dt)) * s.to(dt) in one kernel, for
// Hopper.
//
// Replaces no TPU kernel. The JAX package stores a W8A16 weight as int8 and
// XLA fuses the int8 -> bf16 convert into the matmul's operand load
// (cxl_speckv_tpu/ops/wquant.py, `mm` and `qeinsum`): no dequantized weight
// ever reaches HBM, and no Pallas kernel has the job. This kernel is the
// port's counterpart of that fusion, as w4a16_mm.cu is for int4.
//
// What bounds it: at decode (8 rows) bytes. The weight is one byte a value
// and the product does 2 * M operations a value, far below the card's ridge
// of ~295 bf16 operations a byte, so the least time is the weight's bytes
// over the HBM rate; at a prefill's 512 rows the operations. The kernel
// reads every weight byte from HBM once and converts it to the activation
// type in registers: no converted weight in global or shared memory.
//
// Two weight layouts, the same output tile (MB rows of x by BN = 128
// output columns, 32 a warp) and the same ring, loaders and split-K
// (wq_mm.cuh, shared with the int4 kernel):
// - dense, q [K, N] row-major (a matmul weight, or a batch of them: an MoE
//   expert stack [E, K, N] on grid z): [BK x BN]-byte tiles, the int4
//   kernel's swizzled layout. A thread reads four 32-bit words (4 k rows x
//   4 output columns) and builds the A registers of two 16-column products;
// - tied, q [N, K] (an embedding [V, H] read as its head [H, V]): the
//   weight's rows are output columns, K-contiguous, as mma.sync's row-major
//   A side wants them: [BN x 2 BK]-byte tiles, 16-byte chunks of a row
//   XOR-ed with its row bits so that a fragment's words fall in 32 banks
//   (the rows are read 128 bytes at a time, whole lines). A thread
//   reads one word of each of its A rows; nothing is transposed in memory.
// Conversion: the bytes are made offset binary (v + 128) once a word. bf16:
// each byte goes into the mantissa of 2^23 (a byte permute), a float32
// subtract of 2^23 + 128 leaves v exactly, and one cvt.rn.bf16x2.f32 packs
// two values (exact: |v| <= 128 fits bf16's 8 significant bits); a byte
// does not fit the int4 kernel's bf16 exponent-bias trick. f16: two bytes
// under the exponent of 1024 (a permute and a mask), one f16x2 subtract of
// 1152. bf16 / f16 products run on mma.sync.m16n8k16 (the weight the
// 16-row side, x the 8-wide side; k permuted alike in A and B); float32
// activations on IEEE FMA on CUDA cores (no TF32), a thread an output
// column. Split-K where the strips are too few to fill the card; the
// epilogue rounds as the composition does (the float32 sum rounded to the
// activation type, times the scale rounded to it, rounded again).
//
// Large M: the row block grows to 128 rows (16 m-tiles a warp), so a CTA
// converts each weight byte once for 128 rows of x, and a 512-row prefill
// converts the weight four times over, in registers; its ring is shorter,
// so that two such CTAs fit an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wq_mm.cuh"

namespace {

using namespace wq;

constexpr int BK = 64;             // k values of a stage (dense)
constexpr int NSTAGE = 4;          // ring depth
constexpr int BN = STRIP;          // output columns of a CTA

// k values of a stage: the tied layout reads each of its 128 rows in
// 2 * BK-byte pieces, whole 128-byte lines at BK 64 (64-byte pieces ran
// the tied head at 1.45x the time)
template <bool TIED>
constexpr int stage_k = TIED ? 2 * BK : BK;

struct W8Args {
  const void* x;     // [B, M, K] activation kind, batch stride xbs
  const int8_t* q;   // dense [B, K, N]; tied [N, K] (B = 1)
  Out o;             // y [B, M, N], s [B, N], ws, cnt, splits
  long long xbs;     // elements between batches of x (0: one x for all)
  int K, vec;
};

// byte offset of element (row r = output column, byte c = k) of a tied
// [BN x KB]-byte tile: a row's 16-byte chunk index XOR-ed with the row's
// position among the rows that share a bank line, so that rows g and
// g + 1, g + 2, ... of a fragment read land in different banks
template <int KB>
__device__ __forceinline__ int toff(int r, int c) {
  constexpr int CPR = KB / 16;                  // chunks a row
  return r * KB + (c ^ ((((r * KB) >> 7) % CPR) << 4));
}

// rows [n0, n0 + BN) x bytes [k0, k0 + KB) of a row-major int8 [N, K]
// matrix into a toff tile; out of range reads as zero. vec: 16-byte copies
// (K % 16 and a 16-byte aligned base checked by the wrapper)
template <int KB>
__device__ __forceinline__ void load_tied(uint8_t* sq, const int8_t* q,
                                          int N, int K, int n0, int k0,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CPR = KB / 16;
    for (int i = tid; i < BN * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 16;
      const bool ok = n0 + r < N && k0 + c < K;
      const int8_t* src = ok ? q + (long long)(n0 + r) * K + k0 + c : q;
      cp16(sq + toff<KB>(r, c), src, ok);
    }
  } else {
    for (int i = tid; i < BN * KB; i += THREADS) {
      const int r = i / KB, c = i % KB;
      const bool ok = n0 + r < N && k0 + c < K;
      sq[toff<KB>(r, c)] = ok ? q[(long long)(n0 + r) * K + k0 + c] : 0;
    }
  }
}

// one stage: the weight tile for k values [k0, k0 + KB) and columns
// [n0, n0 + BN), and x rows [m0, m0 + MB) x columns [k0, k0 + KB)
template <bool TIED, typename T, int MB, int XS>
__device__ __forceinline__ void load_stage(uint8_t* sq, T* sx, const T* x,
                                           const int8_t* q, const W8Args& a,
                                           int m0, int n0, int k0) {
  constexpr int KB = stage_k<TIED>;
  if constexpr (TIED)
    load_tied<KB>(sq, q, a.o.N, a.K, n0, k0, a.vec);
  else
    load_rows<KB>(sq, q, a.K, a.o.N, k0, n0, a.vec);
  load_x<T, MB, XS, KB>(sx, x, a.o.M, a.K, m0, k0, a.vec);
}

// one A register of two values: byte SA of wa (low half) and byte SB of wb
// (high half), both words offset binary (v + 128), in the activation type
template <int KIND, int SA, int SB>
__device__ __forceinline__ uint32_t cvt2(uint32_t wa, uint32_t wb) {
  if constexpr (KIND == kF16) {
    // [wa.SA, -, wb.SB, -] under the exponent of 1024: 1024 + v + 128
    const uint32_t p = __byte_perm(wa, wb, SA | ((4 + SB) << 8));
    const uint32_t h = (p & 0x00FF00FFu) | 0x64006400u;
    uint32_t r;
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(0x64806480u));
    return r;                                  // - 1152 = v, exact
  } else {
    // [wa.SA, 0, 0, 0x4B]: 2^23 + v + 128 as float32
    const float lo = __int_as_float(__byte_perm(wa, 0x4B000000u, 0x7650 | SA))
                     - 8388736.f;
    const float hi = __int_as_float(__byte_perm(wb, 0x4B000000u, 0x7650 | SB))
                     - 8388736.f;
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t offset_word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
}

// bf16 / f16 activations on the tensor cores. Warp w owns output columns
// 32w .. 32w + 31 of the CTA's BN and all MT m-tiles of 8 rows, over the
// stage's KB / 16 k chunks of 16. Accumulator [u][mt][i]: u the 16-column
// product (dense: A rows g / g + 8 are columns 4g + 2u / 4g + 2u + 1; tied:
// columns 16u + g / 16u + g + 8); i the mma's C element (rows g, g+8 of A;
// columns 2t, 2t+1 of B = two rows of x). A thread's k values in a chunk
// are 4t .. 4t + 3, in both A and B.
template <int KIND, int MT, bool TIED, int ST>
__global__ void __launch_bounds__(THREADS)
    w8a16_mma_kernel(const W8Args a) {
  using T = typename Kind<KIND>::T;
  constexpr int KB = stage_k<TIED>;
  constexpr int MB = MT * 8, XS = KB + 16;
  constexpr int QT = KB * BN, XT = MB * XS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  T* sx = reinterpret_cast<T*>(smem + ST * QT);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MB;
  const int b = blockIdx.z / a.o.splits, sp = blockIdx.z % a.o.splits;
  const Span span = split_span(a.K, KB, a.o.splits, sp);
  const T* x = static_cast<const T*>(a.x) + b * a.xbs;
  const int8_t* q = a.q + (long long)b * a.K * a.o.N;

  float acc[2][MT][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[u][mt][i] = 0.f;

  auto load = [&](int slot, int i) {
    load_stage<TIED, T, MB, XS>(sq + slot * QT, sx + slot * XT, x, q, a, m0,
                                n0, (span.s0 + i) * KB);
  };
  auto step = [&](int slot) {
    const uint8_t* bq = sq + slot * QT;
    const T* bx = sx + slot * XT;
#pragma unroll
    for (int ch = 0; ch < KB / 16; ++ch) {
      uint32_t fa[2][4];
      if constexpr (TIED) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = 32 * warp + 16 * u + g, c = ch * 16 + 4 * t;
          const uint32_t lo = offset_word(bq + toff<KB>(r, c));
          const uint32_t hi = offset_word(bq + toff<KB>(r + 8, c));
          fa[u][0] = cvt2<KIND, 0, 1>(lo, lo);
          fa[u][1] = cvt2<KIND, 0, 1>(hi, hi);
          fa[u][2] = cvt2<KIND, 2, 3>(lo, lo);
          fa[u][3] = cvt2<KIND, 2, 3>(hi, hi);
        }
      } else {
        const int r = ch * 16 + 4 * t, c = 32 * warp + 4 * g;
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = offset_word(bq + qoff(r + j, c));
        fa[0][0] = cvt2<KIND, 0, 0>(w[0], w[1]);
        fa[0][1] = cvt2<KIND, 1, 1>(w[0], w[1]);
        fa[0][2] = cvt2<KIND, 0, 0>(w[2], w[3]);
        fa[0][3] = cvt2<KIND, 1, 1>(w[2], w[3]);
        fa[1][0] = cvt2<KIND, 2, 2>(w[0], w[1]);
        fa[1][1] = cvt2<KIND, 3, 3>(w[0], w[1]);
        fa[1][2] = cvt2<KIND, 2, 2>(w[2], w[3]);
        fa[1][3] = cvt2<KIND, 3, 3>(w[2], w[3]);
      }
      // B: x rows mt * 8 + g, k = 16ch + 4t .. 4t+3
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            bx + (mt * 8 + g) * XS + ch * 16 + 4 * t);
        mma<KIND>(acc[0][mt], fa[0], v.x, v.y);
        mma<KIND>(acc[1][mt], fa[1], v.x, v.y);
      }
    }
  };
  ring<ST>(span.n, load, step);

  // C element i of product u, m-tile mt -> output row, column
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + mt * 8 + 2 * t + (i & 1);
        const int n = TIED ? n0 + 32 * warp + 16 * u + g + 8 * (i >> 1)
                           : n0 + 32 * warp + 4 * g + 2 * u + (i >> 1);
        if (m < a.o.M && n < a.o.N) put<KIND>(a.o, b, sp, m, n, acc[u][mt][i]);
      }
  if (a.o.splits > 1)
    split_tail<KIND, MB, 1>(a.o, b, m0, n0, a.o.N, 0, a.o.N % 4 == 0);
}

// float32 activations: IEEE FMA on CUDA cores. Thread: output column
// n0 + tid, all MB rows (x values read as broadcasts).
template <int MB, bool TIED>
__global__ void __launch_bounds__(THREADS) w8a16_fma_kernel(const W8Args a) {
  static_assert(BN == THREADS, "a thread an output column");
  constexpr int KB = stage_k<TIED>;
  constexpr int XS = KB + 8, QT = KB * BN, XT = MB * XS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sq = smem;
  float* sx = reinterpret_cast<float*>(smem + NSTAGE * QT);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MB;
  const int b = blockIdx.z / a.o.splits, sp = blockIdx.z % a.o.splits;
  const Span span = split_span(a.K, KB, a.o.splits, sp);
  const float* x = static_cast<const float*>(a.x) + b * a.xbs;
  const int8_t* q = a.q + (long long)b * a.K * a.o.N;

  float acc[MB];
#pragma unroll
  for (int i = 0; i < MB; ++i) acc[i] = 0.f;

  auto load = [&](int slot, int i) {
    load_stage<TIED, float, MB, XS>(sq + slot * QT, sx + slot * XT, x, q, a,
                                    m0, n0, (span.s0 + i) * KB);
  };
  auto step = [&](int slot) {
    const uint8_t* bq = sq + slot * QT;
    const float* bx = sx + slot * XT;
#pragma unroll 2
    for (int k4 = 0; k4 < KB; k4 += 4) {
      float w[4];
      if constexpr (TIED) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(
            bq + toff<KB>(tid, k4));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w[kk] = static_cast<float>(static_cast<int8_t>(v >> (8 * kk)));
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          w[kk] = static_cast<float>(
              static_cast<int8_t>(bq[qoff(k4 + kk, tid)]));
      }
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(bx + i * XS + k4);
        acc[i] = fmaf(xv.x, w[0], acc[i]);
        acc[i] = fmaf(xv.y, w[1], acc[i]);
        acc[i] = fmaf(xv.z, w[2], acc[i]);
        acc[i] = fmaf(xv.w, w[3], acc[i]);
      }
    }
  };
  ring<NSTAGE>(span.n, load, step);
  const int n = n0 + tid;
#pragma unroll
  for (int i = 0; i < MB; ++i)
    if (m0 + i < a.o.M && n < a.o.N) put<kF32>(a.o, b, sp, m0 + i, n, acc[i]);
  if (a.o.splits > 1)
    split_tail<kF32, MB, 1>(a.o, b, m0, n0, a.o.N, 0, a.o.N % 4 == 0);
}

// the kernel configurations (ops/w8a16_mm.py: MMA_BLOCKS, FMA_BLOCK): rows
// MB, ring depth ST, dynamic shared memory, the kernel. The ring is the
// deepest, up to NSTAGE (and at least 2), that lets two CTAs share an SM:
// the tied head's 40 and 512 rows ran 1.4x and 1.2x slower at one CTA an
// SM with NSTAGE stages than at two with fewer
constexpr int TWO_CTAS_SMEM = 113 * 1024;
template <int KIND, int MT, bool TIED>
struct MmaCfg {
  static constexpr int MB = MT * 8;
  static constexpr int KB = stage_k<TIED>;
  static constexpr int STAGE = KB * BN + MB * (KB + 16) * 2;
  static constexpr int ST = TWO_CTAS_SMEM / STAGE < 2 ? 2
                            : TWO_CTAS_SMEM / STAGE > NSTAGE
                                ? NSTAGE
                                : TWO_CTAS_SMEM / STAGE;
  static constexpr int SMEM = ST * STAGE;
  static auto kern() { return w8a16_mma_kernel<KIND, MT, TIED, ST>; }
};
template <bool TIED>
struct FmaCfg {
  static constexpr int MB = 16;
  static constexpr int KB = stage_k<TIED>;
  static constexpr int SMEM = NSTAGE * (KB * BN + MB * (KB + 8) * 4);
  static auto kern() { return w8a16_fma_kernel<MB, TIED>; }
};

// f(config) for activation kind `kind`, config id `cfg` and layout: 0-5
// the tensor-core kernel (bf16, f16) at MB 8 / 16 / 32 / 48 / 64 / 128
// rows, 6 the float32 kernel at 16
template <bool TIED, typename F>
int with_cfg(int kind, int cfg, F&& f) {
  auto mma = [&](auto kt) -> int {
    constexpr int K = decltype(kt)::value;
    switch (cfg) {
      case 0: return f(MmaCfg<K, 1, TIED>{});
      case 1: return f(MmaCfg<K, 2, TIED>{});
      case 2: return f(MmaCfg<K, 4, TIED>{});
      case 3: return f(MmaCfg<K, 6, TIED>{});
      case 4: return f(MmaCfg<K, 8, TIED>{});
      case 5: return f(MmaCfg<K, 16, TIED>{});
      default: return -(int)cudaErrorInvalidValue;
    }
  };
  switch (kind) {
    case kBF16: return mma(std::integral_constant<int, kBF16>{});
    case kF16: return mma(std::integral_constant<int, kF16>{});
    case kF32:
      return cfg == 6 ? f(FmaCfg<TIED>{}) : -(int)cudaErrorInvalidValue;
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, M, K] of kind `kind` (batch stride xbs elements, rows contiguous),
// q int8: [B, K, N] row-major (tied 0) or [N, K] row-major, read as its
// transpose (tied 1, B 1); s [B, N] float32; y [B, M, N] of kind `kind`;
// ws [B, splits, M, N] float32 when splits > 1, cnt B * ceil(N / 128) *
// ceil(M / MB) zeroed ints; cfg the kernel configuration (`with_cfg`).
// vec: 16-byte copies may fill the ring (the wrapper checks widths and
// alignment). Returns a cudaError_t code (0 = launched).
extern "C" int w8a16_mm_launch(const void* x, const void* q, const void* s,
                               void* y, void* ws, void* cnt, int B, int M,
                               int K, int N, int kind, int cfg, int splits,
                               int vec, int tied, long long xbs,
                               void* stream) {
  if (splits < 1 || B < 1 || M < 1 || K < 1 || N < 1 || (tied && B != 1))
    return (int)cudaErrorInvalidValue;
  const W8Args a{x, static_cast<const int8_t*>(q),
                 Out{y, static_cast<const float*>(s), static_cast<float*>(ws),
                     static_cast<int*>(cnt), M, N, splits},
                 xbs, K, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto c) -> int {
    using C = decltype(c);
    const cudaError_t e = allow_smem<C>();
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + BN - 1) / BN, (M + C::MB - 1) / C::MB, B * splits);
    const auto kern = C::kern();
    kern<<<grid, THREADS, C::SMEM, st>>>(a);
    return (int)cudaGetLastError();
  };
  const int r = tied ? with_cfg<true>(kind, cfg, go)
                     : with_cfg<false>(kind, cfg, go);
  return r < 0 ? -r : r;
}
