// P2: decode attention on the TPU's transposed-K pool (Hopper, sm_90a).
//
// Replaces the Pallas TPU probe `scripts/kernel_anatomy.py:360`
// (`run_v2.<locals>.loop`, body `v2_kernel`, `:237-317`). It computes what
// `run_v2` computes, on the JAX package's production layout:
//   K "kT" [S, D/pack, Hkv * bs] (row r of a token column holds element r;
//   INT4 packs element r in the low nibble and r + D/2 in the high nibble of
//   row r, the half-split), V token-major [S, Hkv, bs, D/pack] (INT4: byte
//   j holds elements j and j + D/2);
//   q rounded to bf16; s = (q . k) * ks * D^-0.5 per token column; tokens at
//   pos >= seq_len masked to -1e30; an online softmax in float32 over the
//   lane's blocks; p * vs rounded to bf16 before PV; out = acc / max(l, 1e-30)
//   (a lane with seq_len 0 gives zeros). Variants per launch:
//   v2       separate scales ks, vs [S, Hkv, bs] float32;
//   v3fused  one scale array [S, 2, Hkv, bs] (ks at 0, vs at 1);
//   w8a8     q8 = trunc(clip(bf16(bf16(q) * 127), -127, 127)) as int8; the
//            scores are int8 x int8 products summed in int32, times 1/127
//            in float32, then times ks and D^-0.5 as above.
// The output is the whole [B, Hq, D] in float32, so it can be held against
// K1; the TPU probe returned column 0 of it.
//
// Bound: the bytes. At the probe's geometry (B 8, Hq 32, Hkv 8, D 128,
// ctx 8192, INT8) a call moves 138 MB (41 us at 3.35 TB/s); its 1.07 GFLOP
// of products take ~1 us on the tensor cores. Design:
//   - tile_ring.cuh's grid of (lane, kv head, split): each CTA walks its
//     split of the lane's blocks (`split_range`) and leaves a partial state
//     (m, l, acc[G, D]); at more than one split a merge launch combines the
//     partials by log-sum-exp in split order (`tile_ring::merge_lse`, K1's
//     merge without sinks), so two calls give the same bits. An empty split
//     leaves m = -1e30, l = 0, acc = 0.
//   - a ring of DEPTH stages filled by one producer warp: the head's K tile,
//     which in kT is D/pack rows of bs elements at the pool row's stride, by
//     2-D TMA boxes {bs columns, D/pack rows} through a tensor map over kT
//     viewed as [S * D/pack rows, Hkv * bs elements] (the box is widened to
//     16 bytes where a head's row is narrower, the columns past the head
//     unused, zeros past the last head; bs > 256 takes 256-column boxes
//     side by side); V's bs * row bytes by one bulk copy; the scales by two
//     bulk copies of bs * 4 bytes (v2, w8a8) or, v3fused, one 2-D box {bs,
//     2} of a map over the fused array viewed as [S * 2 rows, Hkv * bs]:
//     both scale rows of the head in one copy.
//   - the products on the tensor cores, fed from the stages as they landed
//     (no transpose pass, no float tile): S^T[t, g] = K_t . q_g by
//     `mma.sync` m16n8k16 bf16 (w8a8: m16n8k32 s8 with an int32
//     accumulator, exact, so its scores equal the int32 dot products bit
//     for bit), the block's tokens on M and the G <= 8 query rows on N; a
//     32-bit word of a kT row holds one element of four neighbouring
//     tokens (two at BF16), and a lane's words of the rows its fragment
//     needs are `__byte_perm`ed into per-token element pairs (quads for
//     w8a8). Int8 -> bf16 takes two masks on the integer pipe and one
//     bf16x2 subtraction for two elements (`i8x2_bf16`), not the
//     conversion units; INT4 nibbles are moved to the top of their byte
//     (16 x the value: exact, undone by a power of 2).
//     Then out^T[d, g] += V^T[d, t] P^T[t, g] on the same instruction, V's
//     words read as they landed.
//   - each of the consumer warps takes whole blocks (one reading warp a
//     stage, as tile_ring.cuh's rule on barrier parity asks) and keeps its
//     own accumulator and sum. A block's scores are scaled, masked and
//     reduced to the block's max in registers (shuffles across the lanes
//     that hold its tokens; a block past 32 tokens takes a max pass over
//     its 32-token chunks first and its scores again after: the registers
//     of a 32-token chunk's scores keep three CTAs on an SM). The running
//     max of the split after block i is max(its value after block i - 1,
//     the block's max): the warp that took block i - 1 leaves it in shared
//     memory under a sequence number, the warp of block i waits for it
//     there (a spin on one word, no CTA barrier) and leaves its own. So p
//     = exp(s - that max) and bf16(p * vs) are what a sequential walk of
//     the split computes, rounding included, and the split form of the
//     plain version holds the kernel to rtol = atol = 2e-4. p * vs goes to
//     PV's fragments by shuffles. The warps' states are merged in warp
//     order at the end (each relative to the running max at its last
//     block).
//   - past D 128 (Gemma's 256) a pair of CTAs (grid z) takes each (lane,
//     head, split): both compute the scores, each accumulates PV for half
//     of D, so that a thread's accumulator stays at 32 registers and no
//     instantiation spills; the pair reads K and V twice. The q fragments
//     sit in shared memory, so one instantiation (storage kind, variant,
//     ring depth: 15 in all) serves every D.
// The kernel's fragment slots (which token and element each register
// holds) are mirrored in Python by `decode_anatomy.kt_fragment_slots`.

#include <cuda.h>
#include <cuda_runtime.h>

#include <chrono>
#include <cstring>

#include "kv_tile.cuh"
#include "mma_sync.cuh"
#include "tile_ring.cuh"

namespace {

using tile_ring::Ring;
using tile_ring::tile_row;
using tile_ring::Walk;
using tile_ring::walk_of;

constexpr int NC = 128;            // consumer threads (4 warps)
constexpr int NW = NC / 32;
constexpr int NT = NC + 32;        // + the producer warp
constexpr int MAX_G = 8;
constexpr int CHUNK = 32;          // tokens of a block a score pass holds
constexpr int MAX_SPLITS = 64;
constexpr int MERGE_NT = 128;
constexpr float NEG_INF = -1e30f;

// The stage of one block, laid out by the host (`stage_geometry`): the K
// boxes from offset 0, V behind them, the scales behind V (from a 128-byte
// boundary when they arrive by TMA).
struct Geo {
  int Dp;            // kT rows a head: D / pack
  int kpt;           // K box columns (elements) a box: the head's bs, and
                     // the columns before it back to a 16-byte boundary
  int kpieces;       // K boxes a block (1 up to bs 256)
  int krow;          // bytes of a K row in the stage: kpt * element bytes
  int kpiece_bytes;  // krow * Dp
  int vrow;          // bytes of a V token row: Dp * element bytes
  int voff;          // stage offset of V
  int soff;          // stage offset of the scales
  int sw;            // scale row width: ks(t) at float (t / sw) * 2 sw + t % sw
  int spieces;       // v3fused: scale boxes a block
  uint32_t tx;       // bytes the copies of a block bring
  uint32_t stage;    // stage stride (a multiple of 128)
};

struct Args {
  const float* q;
  const char* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* lens;
  float* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int Hq, Hkv, D, bs, width, S, fused;
  float sm_scale;
  Geo g;
};

__device__ __forceinline__ float bf16r(float x) { return round_cd(x, true); }

// Int8 -> bf16 on the integer pipe and one bf16x2 subtraction, exact: the
// int8 b in bytes 0 and 2 of `w` (the other bytes ignored) is k - 128 s
// (k its low 7 bits, s its sign bit), and k - 128 s = (128 + k) - (128 +
// 128 s), both of which are bf16 bit patterns built by masks: 0x4300 | k
// and 0x4300 | s << 7 (0x4380 = 256). Byte 0 lands in the low half.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w) {
  const uint32_t a = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// the bf16 pairs (byte j of xa, byte j of xb), j = 0 .. 3, of two words of
// int8 bytes
__device__ __forceinline__ void i8_pairs4(uint32_t xa, uint32_t xb,
                                          uint32_t (&o)[4]) {
  const uint32_t lo = __byte_perm(xa, xb, 0x5410);   // a0 a1 b0 b1
  const uint32_t hi = __byte_perm(xa, xb, 0x7632);   // a2 a3 b2 b3
  o[0] = i8x2_bf16(lo);
  o[1] = i8x2_bf16(lo >> 8);
  o[2] = i8x2_bf16(hi);
  o[3] = i8x2_bf16(hi >> 8);
}

__device__ __forceinline__ uint32_t f32_pair_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// INT4: the low / high nibbles of each byte moved to the byte's top, as
// int8 bytes of 16 x their value
__device__ __forceinline__ uint32_t lo_nib16(uint32_t x) {
  return (x << 4) & 0xF0F0F0F0u;
}
__device__ __forceinline__ uint32_t hi_nib16(uint32_t x) {
  return x & 0xF0F0F0F0u;
}

// c[16 x 8] += a[16 x 32] . b[32 x 8], int8 operands, int32 accumulator
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the barrier of the NC consumer threads (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// w8a8's int8 query element of q (float): trunc(clip(bf16(bf16(q) * 127)))
__device__ __forceinline__ uint32_t q8_byte(float x) {
  const float c = fminf(fmaxf(bf16r(bf16r(x) * 127.f), -127.f), 127.f);
  return (uint32_t)(int)c & 0xFFu;
}

// shared memory behind the ring: each warp's m and l [NW][8], the running
// max slots [NW][8] and their sequence numbers [NW], the warps' sum [8][D],
// and the q fragments [16][32][2]
__host__ __device__ constexpr size_t scratch_bytes(int d) {
  return sizeof(float) * ((size_t)3 * NW * MAX_G + NW + (size_t)MAX_G * d +
                          16 * 32 * 2);
}

// Fragment slots. Lane (gq, tq) = (lane / 4, lane % 4). A unit is 32 tokens
// (16 at BF16) of the block, two m-tiles (one at BF16); the lane holds
// tokens tb + JN gq + j, j < JN (JN = 4, 2 at BF16), token j on M row gq
// (j even) or gq + 8 (j odd) of m-tile j / 2. K-step kk of the bf16 product
// puts on k positions (2 tq, 2 tq + 1 | 2 tq + 8, 2 tq + 9) the kT rows
// 16 kk + tq + (0, 4 | 8, 12) (INT4: rows 8 kk + tq, 8 kk + tq + 4, each
// as its low then its high nibble); w8a8's k-step kk puts on k positions
// 4 tq + b (| + 16) the rows 32 kk + tq + 4 b (| + 16) (INT4: rows 16 kk +
// tq + 4 (b / 2) (| + 8), nibble b % 2). PV's k-step takes the tokens
// 16 ks + 4 tq + (0, 1 | 2, 3) of the chunk, each from the lane that holds
// them in S^T; its M rows (gq, gq + 8) of d-tile T hold the elements
// 32 (T / 2) + 4 gq + 2 (T % 2) + (0 | 1) (INT4: the same within each half
// of D; BF16: 16 T + 2 gq + (0 | 1)), from the CTA's first element (D past
// 128: the second CTA of the pair takes elements 128.., INT4 the high
// nibbles).
template <int KIND, bool W8A8, int DEPTH>
__device__ __forceinline__ void kt_body(const CUtensorMap& kmap,
                                        const CUtensorMap& smap,
                                        const Args& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool BF16 = KIND == KV_BF16;
  constexpr bool I4 = KIND == KV_INT4;
  constexpr int EB = BF16 ? 2 : 1;            // bytes an element
  constexpr int TU = BF16 ? 16 : 32;          // tokens a unit
  constexpr int JN = TU / 8;                  // tokens a lane holds a unit
  constexpr int MU = JN / 2;                  // m-tiles a unit
  constexpr int NUC = CHUNK / TU;             // units a chunk
  constexpr int KS = W8A8 ? 256 / 32 : 256 / 16;     // k-steps over D <= 256
  // D past 128 splits PV over two CTAs (grid z): each holds the
  // accumulator of 128 elements (INT4: of one nibble half of D)
  constexpr int NTILE = 8;                    // output d-tiles a CTA
  const Geo& geo = a.g;
  const int tid = threadIdx.x;
  const int bs = a.bs, Dp = geo.Dp, D = a.D;
  const Walk w = walk_of(a.lens, a.Hkv, bs, a.width, a.S);
  const int G = a.Hq / a.Hkv;
  const int DS = D > 128 ? 2 : 1;
  const int dh = blockIdx.z;                  // this CTA's half of D
  const int dbase = 128 * dh;                 // INT8 / BF16: its first element
  Ring<DEPTH> ring(smem, geo.stage);
  float* ms = reinterpret_cast<float*>(ring.stages + (size_t)DEPTH * geo.stage);
  float* ls = ms + NW * MAX_G;
  float* mrun = ls + NW * MAX_G;              // running max after block i
  int* seq = reinterpret_cast<int*>(mrun + NW * MAX_G);   // at i % CW: i + 1
  float* red = reinterpret_cast<float*>(seq + NW);
  // the q fragments in shared memory, not in registers, and the k-steps
  // of a score product unrolled by 8 (w8a8: not unrolled): the registers'
  // limit, no spills
  constexpr int KUNROLL = W8A8 ? 1 : 8;
  uint32_t* qsm = reinterpret_cast<uint32_t*>(red + MAX_G * D);
  // the head's first column sits `dtok` columns into its K box, which
  // starts on the 16-byte boundary at or before it
  const int hbytes = w.h * bs * EB;
  const int dtok = (hbytes % 16) / EB;
  if (tid < NW) seq[tid] = 0;
  ring.init(1);                               // one warp reads a stage
  if (tid >= NC) {                            // the producer warp
    ring.produce_tx(
        a.table + (size_t)w.b * a.width, w.sp.first, w.sp.count, tid % 32,
        geo.tx, [&](int slot, unsigned char* st, uint64_t* bar) {
          for (int j = 0; j < geo.kpieces; ++j)
            tile_ring::tma_load_2d(st + j * geo.kpiece_bytes, &kmap,
                                   w.h * bs - dtok + j * geo.kpt, slot * Dp,
                                   bar);
          const size_t t = tile_row(slot, a.Hkv, w.h, bs);
          tile_ring::bulk_copy(st + geo.voff, a.v_pool + t * geo.vrow,
                               (uint32_t)bs * geo.vrow, bar);
          if (a.fused) {
            for (int j = 0; j < geo.spieces; ++j)
              tile_ring::tma_load_2d(st + geo.soff + j * 8 * geo.sw, &smap,
                                     w.h * bs + j * geo.sw, slot * 2, bar);
          } else {
            tile_ring::bulk_copy(st + geo.soff, a.k_scale + t, 4 * bs, bar);
            tile_ring::bulk_copy(st + geo.soff + 4 * bs, a.v_scale + t, 4 * bs,
                                 bar);
          }
        });
    return;
  }
  constexpr int CW = DEPTH < NW ? DEPTH : NW; // warps reading stages
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const float* qrow = a.q + ((size_t)w.b * a.Hq + (size_t)w.h * G + gq) * D;
  const bool gok = gq < G;
  auto qv = [&](int row, int half) -> float {  // q at kT row `row`
    return gok && row < Dp ? qrow[row + half * Dp] : 0.f;
  };

  // q_g as B fragments, held for the whole walk in shared memory
  // ([k-step][lane][2], written by warp 0)
  for (int kk = 0; warp == 0 && kk < KS; ++kk) {
    uint32_t f0, f1;
    if constexpr (W8A8) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float v = I4 ? qv(16 * kk + 8 * hf + tq + 4 * (b >> 1), b & 1)
                             : qv(32 * kk + 16 * hf + tq + 4 * b, 0);
          x |= q8_byte(v) << (8 * b);
        }
        (hf ? f1 : f0) = x;
      }
    } else if constexpr (I4) {
      const int r = 8 * kk + tq;
      f0 = f32_pair_bf16(qv(r, 0), qv(r, 1));
      f1 = f32_pair_bf16(qv(r + 4, 0), qv(r + 4, 1));
    } else {
      const int r = 16 * kk + tq;
      f0 = f32_pair_bf16(qv(r, 0), qv(r + 4, 0));
      f1 = f32_pair_bf16(qv(r + 8, 0), qv(r + 12, 0));
    }
    qsm[(kk * 32 + lane) * 2] = f0;
    qsm[(kk * 32 + lane) * 2 + 1] = f1;
  }
  consumer_sync();
  auto qfrag = [&](int kk) -> uint2 {
    return *reinterpret_cast<const uint2*>(qsm + (kk * 32 + lane) * 2);
  };
  float acc[NTILE][4];
#pragma unroll
  for (int t = 0; t < NTILE; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int len = a.lens[w.b];

  // S^T of the units of the chunk from token cb of the block in stage st,
  // scaled and masked: s[u][j][e] is token cb + TU u + JN gq + j, query row
  // 2 tq + e (-1e30 where masked); vsc its V scale; mx the lane's max
  // over them, by query row.
  auto chunk_scores = [&](const unsigned char* st, int cb, int pos0,
                          float (&s)[NUC][JN][2], float (&vsc)[NUC][JN],
                          float (&mx)[2]) {
    const float* sc = reinterpret_cast<const float*>(st + geo.soff);
#pragma unroll
    for (int u = 0; u < NUC; ++u) {
      const int tb = cb + TU * u;
      if (tb >= bs) {
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          s[u][j][0] = s[u][j][1] = NEG_INF;
          vsc[u][j] = 0.f;
        }
        continue;
      }
      const int colw = dtok + tb + JN * gq;    // the lane's word's column
      const int piece = colw / geo.kpt;
      const bool kok = tb + JN * gq < bs;
      const unsigned char* kb =
          st + piece * geo.kpiece_bytes + (colw - piece * geo.kpt) * EB;
      auto kword = [&](int r) -> uint32_t {
        return kok && r < Dp
                   ? *reinterpret_cast<const uint32_t*>(kb + r * geo.krow)
                   : 0u;
      };
      float raw[MU][4];
      if constexpr (W8A8) {
        int ci[MU][4];
#pragma unroll
        for (int mt = 0; mt < MU; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c) ci[mt][c] = 0;
#pragma unroll (KUNROLL)
        for (int kk = 0; kk < KS; ++kk) {
          if (kk * (I4 ? 16 : 32) >= Dp) break;
          uint32_t T[2][4];                   // [k half][token j]
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t wv[4];
            if constexpr (I4) {
              const uint32_t x0 = kword(16 * kk + 8 * hf + tq);
              const uint32_t x1 = kword(16 * kk + 8 * hf + tq + 4);
              wv[0] = lo_nib16(x0); wv[1] = hi_nib16(x0);
              wv[2] = lo_nib16(x1); wv[3] = hi_nib16(x1);
            } else {
#pragma unroll
              for (int b = 0; b < 4; ++b)
                wv[b] = kword(32 * kk + 16 * hf + tq + 4 * b);
            }
            // 4 x 4 byte transpose: T[hf][j] = byte j of wv[0..3]
            const uint32_t p0 = __byte_perm(wv[0], wv[1], 0x5140);
            const uint32_t p1 = __byte_perm(wv[0], wv[1], 0x7362);
            const uint32_t p2 = __byte_perm(wv[2], wv[3], 0x5140);
            const uint32_t p3 = __byte_perm(wv[2], wv[3], 0x7362);
            T[hf][0] = __byte_perm(p0, p2, 0x5410);
            T[hf][1] = __byte_perm(p0, p2, 0x7632);
            T[hf][2] = __byte_perm(p1, p3, 0x5410);
            T[hf][3] = __byte_perm(p1, p3, 0x7632);
          }
          const uint2 qq = qfrag(kk);
#pragma unroll
          for (int mt = 0; mt < MU; ++mt) {
            const uint32_t af[4] = {T[0][2 * mt], T[0][2 * mt + 1],
                                    T[1][2 * mt], T[1][2 * mt + 1]};
            mma_s8(ci[mt], af, qq.x, qq.y);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MU; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            raw[mt][c] =
                (float)(I4 ? ci[mt][c] >> 4 : ci[mt][c]) * (1.f / 127.f);
      } else {
#pragma unroll
        for (int mt = 0; mt < MU; ++mt)
#pragma unroll
          for (int c = 0; c < 4; ++c) raw[mt][c] = 0.f;
#pragma unroll (KUNROLL)
        for (int kk = 0; kk < KS; ++kk) {
          if (kk * (I4 ? 8 : 16) >= Dp) break;
          uint32_t wv[4];
          if constexpr (I4) {
            const uint32_t x0 = kword(8 * kk + tq), x1 = kword(8 * kk + tq + 4);
            wv[0] = lo_nib16(x0); wv[1] = hi_nib16(x0);
            wv[2] = lo_nib16(x1); wv[3] = hi_nib16(x1);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) wv[b] = kword(16 * kk + tq + 4 * b);
          }
          const uint2 qq = qfrag(kk);
          if constexpr (BF16) {
            const uint32_t af[4] = {__byte_perm(wv[0], wv[1], 0x5410),
                                    __byte_perm(wv[0], wv[1], 0x7632),
                                    __byte_perm(wv[2], wv[3], 0x5410),
                                    __byte_perm(wv[2], wv[3], 0x7632)};
            mma_bf16(raw[0], af, qq.x, qq.y);
          } else {
            uint32_t p01[4], p23[4];          // (row pair, token j)
            i8_pairs4(wv[0], wv[1], p01);
            i8_pairs4(wv[2], wv[3], p23);
#pragma unroll
            for (int mt = 0; mt < MU; ++mt) {
              const uint32_t af[4] = {p01[2 * mt], p01[2 * mt + 1],
                                      p23[2 * mt], p23[2 * mt + 1]};
              mma_bf16(raw[mt], af, qq.x, qq.y);
            }
          }
        }
        if constexpr (I4) {
#pragma unroll
          for (int mt = 0; mt < MU; ++mt)
#pragma unroll
            for (int c = 0; c < 4; ++c) raw[mt][c] *= 0.0625f;
        }
      }
      // the lane's tokens' scales (one 16- or 8-byte read each)
      const int t0 = tb + JN * gq;
      float ksv[JN], vsv[JN];
      if (t0 < bs) {
        const int sp = t0 / geo.sw;
        const float* kr = sc + sp * 2 * geo.sw + (t0 - sp * geo.sw);
        if constexpr (JN == 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr);
          const float4 v4 = *reinterpret_cast<const float4*>(kr + geo.sw);
          ksv[0] = k4.x; ksv[1] = k4.y; ksv[2] = k4.z; ksv[3] = k4.w;
          vsv[0] = v4.x; vsv[1] = v4.y; vsv[2] = v4.z; vsv[3] = v4.w;
        } else {
          const float2 k2 = *reinterpret_cast<const float2*>(kr);
          const float2 v2 = *reinterpret_cast<const float2*>(kr + geo.sw);
          ksv[0] = k2.x; ksv[1] = k2.y;
          vsv[0] = v2.x; vsv[1] = v2.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < JN; ++j) ksv[j] = vsv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int t = t0 + j;
        const bool ok = t < bs && pos0 + t < len;
        vsc[u][j] = vsv[j];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = raw[j >> 1][2 * (j & 1) + e];
          const float v = ok ? x * ksv[j] * a.sm_scale : NEG_INF;
          s[u][j][e] = v;
          mx[e] = fmaxf(mx[e], v);
        }
      }
    }
  };

  for (int i = warp; warp < CW && i < w.sp.count; i += CW) {
    const unsigned char* st = ring.acquire(i);
    const unsigned char* vt = st + geo.voff;
    const int pos0 = (w.sp.first + i) * bs;
    float s[NUC][JN][2], vsc[NUC][JN];
    // ---- the block's max over its tokens (a block past one chunk: a pass
    // over its chunks first, their scores taken again below)
    float mx[2] = {NEG_INF, NEG_INF};
    for (int cb = 0; cb < bs; cb += CHUNK) chunk_scores(st, cb, pos0, s, vsc, mx);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o));
    // ---- the split's running max after this block: the walk's max before
    // it comes from the warp that took block i - 1, so p * vs rounds
    // against the max a sequential walk of the split has there
    float mn[2] = {mx[0], mx[1]};
    if (i > 0) {
      const int slot = (i - 1) % CW;
      if (lane == 0)
        while (*reinterpret_cast<volatile int*>(&seq[slot]) < i) {
        }
      __syncwarp();
      __threadfence_block();
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mn[e] = fmaxf(*reinterpret_cast<volatile float*>(
                          &mrun[slot * MAX_G + 2 * tq + e]),
                      mx[e]);
    }
    if (gq == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<volatile float*>(&mrun[(i % CW) * MAX_G + 2 * tq + e]) =
            mn[e];
      __threadfence_block();
    }
    __syncwarp();
    if (lane == 0) *reinterpret_cast<volatile int*>(&seq[i % CW]) = i + 1;
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      alpha[e] = expf(m[e] - mn[e]);
      m[e] = mn[e];
    }
#pragma unroll
    for (int t = 0; t < NTILE; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][c] *= alpha[c & 1];
    float lsum[2] = {0.f, 0.f};
    for (int cb = 0; cb < bs; cb += CHUNK) {
      if (bs > CHUNK) {
        float unused[2] = {NEG_INF, NEG_INF};
        chunk_scores(st, cb, pos0, s, vsc, unused);
      }
      // p, its sum, and bf16(p * vs) packed by token pairs: X[u][h][e] =
      // (token 2 h, token 2 h + 1) of the lane's unit-u tokens, row 2 tq + e
      uint32_t X[NUC][JN / 2][2];
#pragma unroll
      for (int u = 0; u < NUC; ++u)
#pragma unroll
        for (int h = 0; h < JN / 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float pv[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int j = 2 * h + k;
              const float x = s[u][j][e];
              const float p = x == NEG_INF ? 0.f : expf(x - m[e]);
              lsum[e] += p;
              pv[k] = p * vsc[u][j];
            }
            X[u][h][e] = f32_pair_bf16(pv[0], pv[1]);
          }
      // ---- out^T[d, g] += V^T[d, t] P^T[t, g], 16 tokens a k-step
#pragma unroll
      for (int ks = 0; ks < CHUNK / 16; ++ks) {
        if (cb + 16 * ks >= bs) break;
        uint32_t b0, b1;
        const bool odd = gq & 1;
        if constexpr (BF16) {
          const int s0 = 4 * (2 * tq) + (gq >> 1), s1 = s0 + 4;
          const uint32_t x00 = __shfl_sync(0xffffffffu, X[ks][0][0], s0);
          const uint32_t x01 = __shfl_sync(0xffffffffu, X[ks][0][1], s0);
          const uint32_t x10 = __shfl_sync(0xffffffffu, X[ks][0][0], s1);
          const uint32_t x11 = __shfl_sync(0xffffffffu, X[ks][0][1], s1);
          b0 = odd ? x01 : x00;
          b1 = odd ? x11 : x10;
        } else {
          const int src = 4 * (4 * (ks & 1) + tq) + (gq >> 1);
          const uint32_t x00 = __shfl_sync(0xffffffffu, X[ks >> 1][0][0], src);
          const uint32_t x01 = __shfl_sync(0xffffffffu, X[ks >> 1][0][1], src);
          const uint32_t x10 = __shfl_sync(0xffffffffu, X[ks >> 1][1][0], src);
          const uint32_t x11 = __shfl_sync(0xffffffffu, X[ks >> 1][1][1], src);
          b0 = odd ? x01 : x00;
          b1 = odd ? x11 : x10;
        }
        const int tk = cb + 16 * ks + 4 * tq;   // the lane's k-step tokens
        const unsigned char* vr = vt + (size_t)tk * geo.vrow;
        if constexpr (BF16) {
#pragma unroll
          for (int T = 0; T < NTILE; ++T) {
            const int c = dbase + 16 * T + 2 * gq;   // element pair of row gq
            if (dbase + 16 * T >= Dp) break;
            uint32_t x[4] = {0u, 0u, 0u, 0u};
            if (c < Dp) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (tk + j < bs)
                  x[j] = *reinterpret_cast<const uint32_t*>(
                      vr + j * geo.vrow + 2 * c);
            }
            const uint32_t af[4] = {__byte_perm(x[0], x[1], 0x5410),
                                    __byte_perm(x[0], x[1], 0x7632),
                                    __byte_perm(x[2], x[3], 0x5410),
                                    __byte_perm(x[2], x[3], 0x7632)};
            mma_bf16(acc[T], af, b0, b1);
          }
        } else {
          constexpr int NP = NTILE / 2;         // words a lane's row
          const int cbase = I4 ? 0 : dbase;
#pragma unroll
          for (int mp = 0; mp < NP; ++mp) {
            const int c = cbase + 32 * mp + 4 * gq;   // first byte of the word
            if (cbase + 32 * mp >= Dp) break;
            uint32_t x[4] = {0u, 0u, 0u, 0u};
            if (c < Dp) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (tk + j < bs)
                  x[j] = *reinterpret_cast<const uint32_t*>(
                      vr + j * geo.vrow + c);
            }
            // INT4: the low nibbles are elements c.., the high ones Dp + c..
            // (at D past 128 the CTA's half: hv = dh); tiles 4 hh + 2 mp
#pragma unroll
            for (int hh = 0; hh < (I4 ? 2 : 1); ++hh) {
              if (hh && DS == 2) break;
              const int hv = DS == 1 ? hh : dh;
              uint32_t y[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                y[j] = I4 ? (hv ? hi_nib16(x[j]) : lo_nib16(x[j])) : x[j];
              uint32_t p01[4], p23[4];        // (token pair, element j)
              i8_pairs4(y[0], y[1], p01);
              i8_pairs4(y[2], y[3], p23);
              const uint32_t fa[4] = {p01[0], p01[1], p23[0], p23[1]};
              const uint32_t fb[4] = {p01[2], p01[3], p23[2], p23[3]};
              const int T = 4 * hh + 2 * mp;
              mma_bf16(acc[T], fa, b0, b1);
              mma_bf16(acc[T + 1], fb, b0, b1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + lsum[e];
    __syncwarp();
    ring.release(i);
  }

  // ---- the warps' states merged in warp order 0, 1, 2, 3
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], o);
  if (gq == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ms[warp * MAX_G + 2 * tq + e] = m[e];
      ls[warp * MAX_G + 2 * tq + e] = l[e];
    }
  }
  consumer_sync();
  float M[2], L[2], wt[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int g = 2 * tq + e;
    M[e] = NEG_INF;
    for (int v = 0; v < NW; ++v) M[e] = fmaxf(M[e], ms[v * MAX_G + g]);
    L[e] = 0.f;
    for (int v = 0; v < NW; ++v)
      L[e] += ls[v * MAX_G + g] * expf(ms[v * MAX_G + g] - M[e]);
    wt[e] = expf(m[e] - M[e]) * (I4 ? 0.0625f : 1.f);
  }
  const size_t row0 = (size_t)w.b * a.Hq + (size_t)w.h * G;
  const int S = a.S, z = w.z;
  for (int v = 0; v < NW; ++v) {
    if (warp == v) {
#pragma unroll
      for (int T = 0; T < NTILE; ++T) {
        int d0;                                 // element of M row gq
        bool ok;
        if constexpr (BF16) {
          d0 = dbase + 16 * T + 2 * gq;
          ok = d0 < Dp;
        } else if constexpr (I4) {
          const int hh = DS == 1 ? T >> 2 : dh, r = DS == 1 ? T & 3 : T;
          const int c = 32 * (r >> 1) + 4 * gq;
          d0 = hh * Dp + c + 2 * (r & 1);
          ok = c < Dp;
        } else {
          const int c = dbase + 32 * (T >> 1) + 4 * gq;
          d0 = c + 2 * (T & 1);
          ok = c < Dp;
        }
        if (!ok) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int g = 2 * tq + (c & 1), d = d0 + (c >> 1);
          if (g >= G) continue;
          const float x = acc[T][c] * wt[c & 1];
          const float sum = v ? red[g * D + d] + x : x;
          if (v < NW - 1) {
            red[g * D + d] = sum;
          } else if (S == 1) {
            a.out[(row0 + g) * D + d] = sum / fmaxf(L[c & 1], 1e-30f);
          } else {
            a.part_acc[((row0 + g) * S + z) * D + d] = sum;
          }
        }
      }
      if (v == NW - 1 && S > 1 && gq == 0 && dh == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int g = 2 * tq + e;
          if (g < G) {
            a.part_m[(row0 + g) * S + z] = M[e];
            a.part_l[(row0 + g) * S + z] = L[e];
          }
        }
      }
    }
    consumer_sync();
  }
}

template <int KIND, int DEPTH>
__global__ void __launch_bounds__(NT)
kt_mma_kernel(__grid_constant__ const CUtensorMap kmap,
              __grid_constant__ const CUtensorMap smap,
              __grid_constant__ const Args a) {
  kt_body<KIND, false, DEPTH>(kmap, smap, a);
}

template <int KIND, int DEPTH>
__global__ void __launch_bounds__(NT)
kt_w8a8_kernel(__grid_constant__ const CUtensorMap kmap,
               __grid_constant__ const CUtensorMap smap,
               __grid_constant__ const Args a) {
  kt_body<KIND, true, DEPTH>(kmap, smap, a);
}

using Kernel = decltype(&kt_mma_kernel<KV_INT8, 2>);

template <int KIND, bool W8A8, int DEPTH>
Kernel kernel_of() {
  if constexpr (W8A8) return kt_w8a8_kernel<KIND, DEPTH>;
  else return kt_mma_kernel<KIND, DEPTH>;
}

template <int KIND, bool W8A8>
Kernel pick_depth(int depth) {
  switch (depth) {
    case 2: return kernel_of<KIND, W8A8, 2>();
    case 4: return kernel_of<KIND, W8A8, 4>();
    case 8: return kernel_of<KIND, W8A8, 8>();
  }
  return nullptr;
}

Kernel pick(int kind, bool w8a8, int depth) {
  switch (kind) {
    case KV_INT8:
      return w8a8 ? pick_depth<KV_INT8, true>(depth)
                  : pick_depth<KV_INT8, false>(depth);
    case KV_INT4:
      return w8a8 ? pick_depth<KV_INT4, true>(depth)
                  : pick_depth<KV_INT4, false>(depth);
    case KV_BF16:
      return w8a8 ? nullptr : pick_depth<KV_BF16, false>(depth);
  }
  return nullptr;
}

// the stage of one block (mirrored by decode_anatomy.kt_stage). A head's
// K box starts on the 16-byte boundary at or before its first column (TMA
// reads a box row from a 16-byte aligned address): up to 12 bytes of the
// head before it, and the box is rounded up to 16 bytes.
Geo stage_geometry(int kind, bool fused, int D, int bs, int Hkv) {
  const int eb = kind == KV_BF16 ? 2 : 1;
  Geo g{};
  g.Dp = kind == KV_INT4 ? D / 2 : D;
  int lead = 0;                               // most bytes before a head
  for (int h = 1; h < Hkv && h < 4; ++h)
    lead = (h * bs * eb) % 16 > lead ? (h * bs * eb) % 16 : lead;
  const int need = (lead + bs * eb + 15) / 16 * 16;
  g.kpieces = (need + 256 * eb - 1) / (256 * eb);
  g.kpt = g.kpieces == 1 ? need / eb : 256;
  g.krow = g.kpt * eb;
  g.kpiece_bytes = g.krow * g.Dp;
  g.vrow = g.Dp * eb;
  g.voff = g.kpieces * g.kpiece_bytes;
  const int vend = g.voff + bs * g.vrow;
  int sbytes;
  if (fused) {
    g.spieces = (bs + 255) / 256;
    g.sw = g.spieces == 1 ? bs : 256;
    g.soff = (vend + 127) / 128 * 128;
    sbytes = g.spieces * 8 * g.sw;
  } else {
    g.spieces = 0;
    g.sw = bs;
    g.soff = vend;
    sbytes = 8 * bs;
  }
  g.tx = (uint32_t)(g.voff + bs * g.vrow + sbytes);
  g.stage = (uint32_t)((g.soff + sbytes + 127) / 128 * 128);
  return g;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D map over `base` viewed as [rows, cols] elements of `type`
// (`esize` bytes), boxes {box_cols, box_rows}, zeros past the edges
CUresult encode_2d(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType type,
                   int esize, const void* base, uint64_t cols, uint64_t rows,
                   uint32_t box_cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// Returns 0 when launched, a cudaError_t code when a launch failed or a
// shape is refused, or -(1000 + CUresult) when the tensor maps could not be
// encoded (the driver has no cuTensorMapEncodeTiled: -1000). kv_kind is
// KV_INT8, KV_BF16 or KV_INT4 (kv_tile.cuh; w8a8 takes no BF16); fused:
// k_scale is the [S, 2, Hkv, bs] array and v_scale is unused. num_slots: S
// of the pools. out [B, Hq, D] float32; num_splits S >= 1 CTAs a (lane, kv
// head); at S > 1 part_m, part_l [B, Hq, S] and part_acc [B, Hq, S, D]
// are the float32 workspace and the merge launch follows on the same
// stream. depth: the ring's stages (2, 4, 8). host_us, when not null,
// receives the microseconds the host spent encoding the maps. The Python
// wrapper checks shapes: G <= 8, D <= 256, D % 8 == 0, bs % 4 == 0, and a
// kT row of Hkv * bs * element bytes a multiple of 16.
extern "C" int anatomy_kt_launch(
    const float* q, const void* kt_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* block_table,
    const int* seq_lens, float* out, float* part_m, float* part_l,
    float* part_acc, double* host_us, int B, int Hq, int Hkv, int D, int bs,
    int max_blocks, int num_slots, int kv_kind, int fused, int w8a8,
    int num_splits, int depth, float sm_scale, void* stream) {
  const int eb = kv_kind == KV_BF16 ? 2 : 1;
  const int S = num_splits;
  if ((kv_kind != KV_INT8 && kv_kind != KV_INT4 && kv_kind != KV_BF16) ||
      Hq % Hkv || Hq / Hkv > MAX_G || D > 256 || D % 8 || bs % 4 ||
      ((size_t)Hkv * bs * eb) % 16 || S < 1 || S > MAX_SPLITS ||
      (S > 1 && (!part_m || !part_l || !part_acc)))
    return (int)cudaErrorInvalidValue;
  const Kernel kern = pick(kv_kind, w8a8 != 0, depth);
  if (!kern) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Geo geo = stage_geometry(kv_kind, fused != 0, D, bs, Hkv);
  const size_t smem =
      tile_ring::ring_smem_bytes(depth, geo.stage) + scratch_bytes(D);
  if (smem > 232448) return (int)cudaErrorInvalidValue;

  const auto t0 = std::chrono::steady_clock::now();
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1000;
  CUtensorMap kmap, smap;
  memset(&smap, 0, sizeof(smap));
  CUresult r = encode_2d(
      enc, &kmap, eb == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      eb, kt_pool, (uint64_t)Hkv * bs, (uint64_t)num_slots * geo.Dp, geo.kpt,
      geo.Dp);
  if (r == CUDA_SUCCESS && fused)
    r = encode_2d(enc, &smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, k_scale,
                  (uint64_t)Hkv * bs, (uint64_t)num_slots * 2, geo.sw, 2);
  if (r != CUDA_SUCCESS) return -(1000 + (int)r);
  if (host_us != nullptr)
    *host_us = std::chrono::duration<double, std::micro>(
                   std::chrono::steady_clock::now() - t0)
                   .count();

  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  const Args args{q,        static_cast<const char*>(v_pool),
                  k_scale,  v_scale,
                  block_table, seq_lens,
                  out,      part_m,
                  part_l,   part_acc,
                  Hq,       Hkv,
                  D,        bs,
                  max_blocks, S,
                  fused,    sm_scale,
                  geo};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kern<<<dim3(B * Hkv, S, D > 128 ? 2 : 1), NT, smem, st>>>(kmap, smap, args);
  if ((e = cudaGetLastError()) != cudaSuccess || S == 1) return (int)e;
  tile_ring::merge_lse<MAX_SPLITS, MERGE_NT><<<B * Hq, MERGE_NT, 0, st>>>(
      part_m, part_l, part_acc, nullptr, out, Hq, D, S);
  return (int)cudaGetLastError();
}
