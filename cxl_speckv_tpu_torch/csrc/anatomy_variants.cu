// P1: K1's walk with parts stripped, one mode per launch (Hopper, sm_90a).
//
// Replaces the Pallas TPU probe `scripts/kernel_anatomy.py:204`
// (`run_variant.<locals>.loop`, body `variant_kernel`, `:100-171`). It walks
// K1's token-major pools K, V [S, Hkv, bs, D/pack] (int8 bytes or bf16;
// INT4 packs two elements a byte) and scales [S, Hkv, bs] float32 through
// each lane's block-table row. Each mode is "K1 minus something"; for kv
// head h of lane b it computes, over the tiles of the lane's blocks (raw =
// the stored elements as numbers: int8 bytes, INT4 packed bytes read as
// int8, bf16 values):
//   fetch     sum(raw K) + sum(raw V) + sum(ks) + sum(vs), float32;
//   fetchint  sum(raw K) + sum(raw V) as int32 (bf16 truncated toward 0);
//   fetchrow  moves each whole K / V tile into shared memory, as the TPU
//             DMA did, and sums only token row 0 of each, float32;
//   dequant   sum(bf16(deq(K) * bf16(ks))) + the same for V, float32; deq
//             is kv_tile.cuh's conversion (INT4 nibbles sign-extended);
//   matmul    acc[g, :] += bf16(q_g . K_t) V_t summed over the tokens t of
//             every block, q_g the group's query rows rounded to bf16, on
//             raw tiles (no dequantize, no softmax, no scales): [G, D/pack];
//   matmulT   acc[g, :] += bf16(exp(s_gt - max_t' s_gt')) V_t, the max taken
//             over each block's bs tokens (the transposed-score form).
// Output per (lane, kv head): one float32 (int32 for fetchint) for the sum
// modes, [G, D/pack] float32 for the products.
//
// Departure from the TPU body: the products are taken within a head. The
// TPU tile spans all Hkv heads, so its body multiplied every query row by
// all Hkv * bs columns; K1 on the card never does, so neither does this.
//
// Bound: the bytes, in every mode. At the probe's default geometry (B 8,
// Hq 32, Hkv 8, D 128, ctx 8192, INT8) a call reads 134 MB of K and V,
// 40 us at 3.35 TB/s; the products' 1.07 GFLOP take ~1 us on the tensor
// cores. Design (tile_ring.cuh):
//   - the grid is (lane, kv head, split): at the probe's 64 (lane, head)
//     pairs the wrapper's split count puts several CTAs on every SM, and a
//     merge launch adds the splits' partials in a fixed order (no atomics:
//     two calls give the same bits; fetchint's partials are exact int32);
//   - tiles arrive through a ring of DEPTH stages filled by TMA bulk copies
//     from one producer warp, the CTA's table slice staged in shared memory
//     first, so DEPTH blocks a CTA are in flight and no table read sits in
//     front of a copy; four consumer warps read the stages;
//   - fetch, fetchint and dequant may instead (DEPTH 0) read their tiles
//     straight into registers, four 16-byte K and four V vectors a thread
//     in flight, the CTA's table slice in shared memory;
//   - matmul and matmulT run on the tensor cores (`mma.sync` m16n8k16, bf16
//     operands, float32 accumulators): S^T[t, g] = K_t . q_g with the
//     block's tokens on M, the G <= 8 query rows on N = 8 and D/pack on K,
//     the q fragments held in registers for the whole walk; each consumer
//     warp takes whole blocks, its scores go through its own shared-memory
//     scratch (no CTA barrier inside the walk), are rounded (matmul:
//     bf16(s); matmulT: bf16(exp(s - the block's max of its row))) into
//     the B fragments of out^T[d, g] += V^T[d, t] P^T[t, g], and the warps'
//     sums are added in a fixed order at the end. Int8 bytes are exact in
//     bf16 (INT4 packed bytes read as int8, as the function says), bf16
//     pools are used as stored. K fragments come from 16-byte loads of row
//     chunks, V fragments from 16- / 32-bit loads, with D permuted within
//     each chunk (the sum does not depend on its order) and d pairs
//     (2i, 2i + 1) on fragment rows (i, i + 8), so no ldmatrix is needed for
//     the int8 transpose; int8 -> bf16 and the sums' conversions use the
//     integer and float pipes, not the conversion units.

#include <cuda_runtime.h>

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
constexpr int MAX_DP = 256;        // row elements: D / pack
constexpr int UNROLL = 4;          // register path: vectors in flight a tile

enum Mode { FETCHROW = 0, FETCHINT = 1, FETCH = 2, DEQUANT = 3, MATMUL = 4,
            MATMULT = 5 };

__device__ __forceinline__ float bf16r(float x) { return round_cd(x, true); }

// Integer and float pipes in place of the conversion units (which run at
// a quarter of their rate), with the same bits:
// byte k of `wx`, a word XORed with 0x80808080, as the float of its int8
// value: 2^23 + (b + 128) built from bits, less 2^23 + 128
__device__ __forceinline__ float sbyte_f(uint32_t wx, int k) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7650 | k)) -
         8388736.0f;
}

// bf16(x) for a finite x, round to nearest even, as a float
__device__ __forceinline__ float bf16r_int(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// the 16 bytes `w` of a tile as numbers, summed as int32: 16 int8 bytes
// (INT4's packed bytes too) by dp4a, or 8 bf16 values truncated toward zero
template <bool BF16>
__device__ __forceinline__ int raw_isum(const uint4& w) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  int s = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (BF16) {
      s += (int)__uint_as_float(u[c] << 16) +
           (int)__uint_as_float(u[c] & 0xFFFF0000u);
    } else {
      s = __dp4a((int)u[c], 0x01010101, s);
    }
  }
  return s;
}

// the 16 bytes `w` of a tile as numbers: 8 bf16 values or 16 int8 bytes
// (INT4's packed bytes too) -> their float32 sum. The 16 bytes' integer sum
// (dp4a) is exact in float32, as is every partial sum of the bytes one by
// one, so this equals their float32 sum in any order.
template <bool BF16>
__device__ __forceinline__ float raw_sum(const uint4& w) {
  if constexpr (BF16) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s += __uint_as_float(u[c] << 16) + __uint_as_float(u[c] & 0xFFFF0000u);
    return s;
  } else {
    return (float)raw_isum<false>(w);
  }
}

// sum of bf16(deq(x) * sc) over the 16 bytes `w` of one token row, sc the
// row's scale already rounded to bf16; the elements built from bits
// (sbyte_f) and rounded by bf16r_int, the same values as kv_tile.cuh's
// conversions and round_cd
template <int KIND>
__device__ __forceinline__ float dequant_sum(const uint4& w, float sc) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (KIND == KV_BF16) {
      s += bf16r_int(__uint_as_float(u[c] << 16) * sc) +
           bf16r_int(__uint_as_float(u[c] & 0xFFFF0000u) * sc);
    } else if constexpr (KIND == KV_INT4) {
      // nibble n (two's complement) + 8 = n ^ 8, in 0..15
      const uint32_t x = u[c] ^ 0x88888888u;
      const uint32_t lo = x & 0x0F0F0F0Fu, hi = (x >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7650 | k)) - 8388616.0f;
        const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7650 | k)) - 8388616.0f;
        s += bf16r_int(a * sc) + bf16r_int(b * sc);
      }
    } else {
      const uint32_t x = u[c] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += bf16r_int(sbyte_f(x, k) * sc);
    }
  }
  return s;
}

// the barrier of the NC consumer threads (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// sum of `v` over the NC consumer threads, valid in thread 0
template <typename T>
__device__ __forceinline__ T consumer_sum(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  consumer_sync();
  T r = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < NW; ++i) r += red[i];
  return r;
}

// ---------------------------------------------------------------------------
// fetchrow, fetchint, fetch, dequant through the ring. dst: [B * Hkv, S]
// partials (the output itself at S = 1)
// ---------------------------------------------------------------------------

template <int MODE, int KIND, int DEPTH>
__global__ void __launch_bounds__(NT)
sum_ring_kernel(const char* __restrict__ k_pool, const char* __restrict__ v_pool,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ block_table,
                const int* __restrict__ seq_lens, void* __restrict__ dst,
                int Hkv, int bs, int row_bytes, int width, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float redf[NW];
  __shared__ int redi[NW];
  constexpr bool BF16 = KIND == KV_BF16;
  constexpr bool SC = MODE == FETCH || MODE == DEQUANT;
  const int tid = threadIdx.x;
  const Walk w = walk_of(seq_lens, Hkv, bs, width, S);
  const uint32_t tile_bytes = (uint32_t)bs * row_bytes;
  Ring<DEPTH> ring(smem, 2 * tile_bytes + (SC ? 8u * bs : 0u));
  ring.init(NW);
  if (tid >= NC) {                            // the producer warp
    ring.produce(block_table + (size_t)w.b * width, w.sp.first, w.sp.count,
                 tid % 32, [&](int slot, unsigned char* st, uint64_t* bar) {
      const size_t t = tile_row(slot, Hkv, w.h, bs);
      tile_ring::bulk_copy(st, k_pool + t * row_bytes, tile_bytes, bar);
      tile_ring::bulk_copy(st + tile_bytes, v_pool + t * row_bytes, tile_bytes,
                           bar);
      if constexpr (SC) {
        tile_ring::bulk_copy(st + 2 * tile_bytes, k_scale + t, 4 * bs, bar);
        tile_ring::bulk_copy(st + 2 * tile_bytes + 4 * bs, v_scale + t, 4 * bs,
                             bar);
      }
    });
    return;
  }
  const int nvec = tile_bytes / 16;           // 16-byte vectors a tile
  const int row_vec = row_bytes / 16;
  float accf = 0.f;
  int acci = 0;
  for (int i = 0; i < w.sp.count; ++i) {
    const unsigned char* st = ring.acquire(i);
    const uint4* kt = reinterpret_cast<const uint4*>(st);
    const uint4* vt = kt + nvec;
    const float* ks = reinterpret_cast<const float*>(vt + nvec);
    const float* vs = ks + bs;
    if constexpr (MODE == FETCHROW) {
      for (int e = tid; e < row_vec; e += NC)
        accf += raw_sum<BF16>(kt[e]) + raw_sum<BF16>(vt[e]);
    } else {
      for (int e = tid; e < nvec; e += NC) {
        const uint4 kw = kt[e], vw = vt[e];
        if constexpr (MODE == FETCHINT) {
          acci += raw_isum<BF16>(kw) + raw_isum<BF16>(vw);
        } else if constexpr (MODE == FETCH) {
          accf += raw_sum<BF16>(kw) + raw_sum<BF16>(vw);
        } else {
          const int t = e / row_vec;
          accf += dequant_sum<KIND>(kw, bf16r(ks[t])) +
                  dequant_sum<KIND>(vw, bf16r(vs[t]));
        }
      }
      if constexpr (MODE == FETCH)
        for (int t = tid; t < bs; t += NC) accf += ks[t] + vs[t];
    }
    ring.release(i);
  }
  const size_t o = (size_t)blockIdx.x * S + w.z;
  if constexpr (MODE == FETCHINT) {
    const int s = consumer_sum(acci, redi);
    if (tid == 0) static_cast<int*>(dst)[o] = s;
  } else {
    const float s = consumer_sum(accf, redf);
    if (tid == 0) static_cast<float*>(dst)[o] = s;
  }
}

// ---------------------------------------------------------------------------
// fetchint, fetch, dequant into registers (DEPTH 0): UNROLL K and V vectors
// a thread in flight, the table slice in shared memory
// ---------------------------------------------------------------------------

template <int MODE, int KIND>
__global__ void __launch_bounds__(NC)
sum_regs_kernel(const char* __restrict__ k_pool, const char* __restrict__ v_pool,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                const int* __restrict__ block_table,
                const int* __restrict__ seq_lens, void* __restrict__ dst,
                int Hkv, int bs, int row_bytes, int width, int S) {
  __shared__ int win[tile_ring::TABLE_WINDOW];
  __shared__ float redf[NW];
  __shared__ int redi[NW];
  constexpr bool BF16 = KIND == KV_BF16;
  const int tid = threadIdx.x;
  const Walk w = walk_of(seq_lens, Hkv, bs, width, S);
  const int* row = block_table + (size_t)w.b * width + w.sp.first;
  const int nvec = bs * row_bytes / 16;
  const int row_vec = row_bytes / 16;
  float accf = 0.f;
  int acci = 0;
  for (int base = 0; base < w.sp.count; base += tile_ring::TABLE_WINDOW) {
    const int nb = min(w.sp.count - base, tile_ring::TABLE_WINDOW);
    __syncthreads();                          // the last window is read
    for (int j = tid; j < nb; j += NC) win[j] = row[base + j];
    __syncthreads();
    const int tv = nb * nvec;
    for (int v0 = tid; v0 < tv; v0 += NC * UNROLL) {
      uint4 kw[UNROLL], vw[UNROLL];
      size_t tr[UNROLL];
      int ev[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int v = v0 + u * NC;
        if (v < tv) {
          const int blk = v / nvec;
          ev[u] = v - blk * nvec;
          tr[u] = tile_row(win[blk], Hkv, w.h, bs);
          kw[u] = __ldg(reinterpret_cast<const uint4*>(
                      k_pool + tr[u] * row_bytes) + ev[u]);
          vw[u] = __ldg(reinterpret_cast<const uint4*>(
                      v_pool + tr[u] * row_bytes) + ev[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (v0 + u * NC >= tv) break;
        if constexpr (MODE == FETCHINT) {
          acci += raw_isum<BF16>(kw[u]) + raw_isum<BF16>(vw[u]);
        } else if constexpr (MODE == FETCH) {
          accf += raw_sum<BF16>(kw[u]) + raw_sum<BF16>(vw[u]);
        } else {
          const size_t t = tr[u] + ev[u] / row_vec;
          accf += dequant_sum<KIND>(kw[u], bf16r(__ldg(k_scale + t))) +
                  dequant_sum<KIND>(vw[u], bf16r(__ldg(v_scale + t)));
        }
      }
    }
    if constexpr (MODE == FETCH) {
      for (int v = tid; v < nb * bs; v += NC) {
        const size_t t = tile_row(win[v / bs], Hkv, w.h, bs) + v % bs;
        accf += __ldg(k_scale + t) + __ldg(v_scale + t);
      }
    }
  }
  const size_t o = (size_t)blockIdx.x * S + w.z;
  if constexpr (MODE == FETCHINT) {
    const int s = consumer_sum(acci, redi);
    if (tid == 0) static_cast<int*>(dst)[o] = s;
  } else {
    const float s = consumer_sum(accf, redf);
    if (tid == 0) static_cast<float*>(dst)[o] = s;
  }
}

// ---------------------------------------------------------------------------
// matmul, matmulT on the tensor cores. Dp = D / pack row elements, q
// [B, Hq, D]; dst [B * Hkv, S, G, Dp] partials (the output at S = 1).
// Each of the CW = min(4, DEPTH) first consumer warps takes whole blocks
// (warp w: the walk's blocks w, w + CW, ...), so no barrier sits inside
// the walk, and each stage has one reader, in the order of its phases (a
// warp must never wait on a stage's phase more than one ahead: the
// barrier's parity would alias); the warps' sums are added in the order
// 0, 1, 2, 3 at the end.
// ---------------------------------------------------------------------------

// two raw elements -> a bf16 pair (the first in the low half): a bf16
// word as it is, or bytes k0, k1 of int8 word `wx` (XORed with 0x80808080
// first), exact in bf16
__device__ __forceinline__ uint32_t i8_pair(uint32_t wx, int k0, int k1) {
  return __byte_perm(__float_as_uint(sbyte_f(wx, k0)),
                     __float_as_uint(sbyte_f(wx, k1)), 0x7632);
}

__device__ __forceinline__ uint32_t f32_pair_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// shared memory behind the ring: each consumer warp's scores [MAX_G]
// [bs_pad] float32, then the warps' sum [MAX_G][Dp] float32
__host__ __device__ constexpr size_t product_extra(int bs_pad, int dp) {
  return sizeof(float) * ((size_t)NW * MAX_G * bs_pad + (size_t)MAX_G * dp);
}

// The A fragments of S^T for token rows (t0, t0 + 8) come from 16-byte
// loads of one row chunk each: thread tq of a fragment row group loads
// chunk 4 kb + tq of its two rows, which holds E16 = 16 / element-bytes
// row elements, and its share of k-step kk = kb * (E16 / 4) + j is
// elements 4 j .. 4 j + 3 of that chunk (d = (4 kb + tq) * E16 + 4 j + 0..3;
// k positions 2 tq, 2 tq + 1 | 2 tq + 8, 2 tq + 9). The q fragments take
// the same d for each (k-step, tq), so the product is the same sum over d.
template <int MODE, bool BF16, int DEPTH, int DPMAX>
__global__ void __launch_bounds__(NT)
product_kernel(const float* __restrict__ q, const char* __restrict__ k_pool,
               const char* __restrict__ v_pool,
               const int* __restrict__ block_table,
               const int* __restrict__ seq_lens, float* __restrict__ dst,
               int Hq, int Hkv, int D, int Dp, int bs, int width, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int EB = BF16 ? 2 : 1;            // bytes an element
  constexpr int E16 = 16 / EB;                // elements a 16-byte chunk
  constexpr int JS = E16 / 4;                 // k-steps a chunk
  constexpr int KB_MAX = DPMAX / (4 * E16);   // chunk groups over Dp
  constexpr int MD_MAX = DPMAX / 16;          // d-tiles of the output
  const int tid = threadIdx.x;
  const Walk w = walk_of(seq_lens, Hkv, bs, width, S);
  const int G = Hq / Hkv;
  const int row_bytes = Dp * EB;
  const uint32_t tile_bytes = (uint32_t)bs * row_bytes;
  const int bs_pad = (bs + 15) / 16 * 16;
  Ring<DEPTH> ring(smem, 2 * tile_bytes);
  float* scores = reinterpret_cast<float*>(ring.stages +
                                           (size_t)DEPTH * 2 * tile_bytes);
  float* red = scores + NW * MAX_G * bs_pad;
  ring.init(1);                               // one warp consumes a block
  if (tid >= NC) {
    ring.produce(block_table + (size_t)w.b * width, w.sp.first, w.sp.count,
                 tid % 32, [&](int slot, unsigned char* st, uint64_t* bar) {
      const size_t t = tile_row(slot, Hkv, w.h, bs);
      tile_ring::bulk_copy(st, k_pool + t * row_bytes, tile_bytes, bar);
      tile_ring::bulk_copy(st + tile_bytes, v_pool + t * row_bytes, tile_bytes,
                           bar);
    });
    return;
  }
  constexpr int CW = DEPTH < NW ? DEPTH : NW; // warps reading stages
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;    // fragment row group, pair
  const int MT = bs_pad / 16;                 // token tiles
  const int MD = (Dp + 15) / 16;
  float* sw = scores + warp * MAX_G * bs_pad; // this warp's S^T, as [g][t]

  // q_g as B fragments; zero past G and Dp
  uint32_t qf[KB_MAX][JS][2];
  const float* qrow = q + ((size_t)w.b * Hq + (size_t)w.h * G + gq) * D;
#pragma unroll
  for (int kb = 0; kb < KB_MAX; ++kb)
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      const int d = (4 * kb + tq) * E16 + 4 * j;
      const bool ok = gq < G && d < Dp;
      qf[kb][j][0] = ok ? f32_pair_bf16(qrow[d], qrow[d + 1]) : 0u;
      qf[kb][j][1] = ok ? f32_pair_bf16(qrow[d + 2], qrow[d + 3]) : 0u;
    }
  float acc[MD_MAX][4];
#pragma unroll
  for (int m = 0; m < MD_MAX; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int i = warp; warp < CW && i < w.sp.count; i += CW) {
    const unsigned char* kt = ring.acquire(i);
    const unsigned char* vt = kt + tile_bytes;
    // S^T[t, g] = K_t . q_g, token tile by token tile, into sw
    float mx0 = -3.0e38f, mx1 = -3.0e38f;     // columns 2 tq, 2 tq + 1
    for (int mt = 0; mt < MT; ++mt) {
      const int t0 = 16 * mt + gq, t1 = t0 + 8;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < KB_MAX; ++kb) {
        const int chunk = 4 * kb + tq;
        uint4 x0 = make_uint4(0, 0, 0, 0), x1 = x0;
        if (chunk * E16 < Dp) {
          if (t0 < bs)
            x0 = *reinterpret_cast<const uint4*>(kt + t0 * row_bytes + chunk * 16);
          if (t1 < bs)
            x1 = *reinterpret_cast<const uint4*>(kt + t1 * row_bytes + chunk * 16);
        }
        const uint32_t u0[4] = {x0.x, x0.y, x0.z, x0.w};
        const uint32_t u1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          uint32_t a[4];
          if constexpr (BF16) {
            a[0] = u0[2 * j]; a[2] = u0[2 * j + 1];
            a[1] = u1[2 * j]; a[3] = u1[2 * j + 1];
          } else {
            const uint32_t w0 = u0[j] ^ 0x80808080u, w1 = u1[j] ^ 0x80808080u;
            a[0] = i8_pair(w0, 0, 1); a[2] = i8_pair(w0, 2, 3);
            a[1] = i8_pair(w1, 0, 1); a[3] = i8_pair(w1, 2, 3);
          }
          mma_bf16(c, a, qf[kb][j][0], qf[kb][j][1]);
        }
      }
      // c: (t0, 2 tq), (t0, 2 tq + 1), (t1, 2 tq), (t1, 2 tq + 1)
      if (t0 < bs) {
        sw[(2 * tq) * bs_pad + t0] = c[0];
        sw[(2 * tq + 1) * bs_pad + t0] = c[1];
        mx0 = fmaxf(mx0, c[0]);
        mx1 = fmaxf(mx1, c[1]);
      }
      if (t1 < bs) {
        sw[(2 * tq) * bs_pad + t1] = c[2];
        sw[(2 * tq + 1) * bs_pad + t1] = c[3];
        mx0 = fmaxf(mx0, c[2]);
        mx1 = fmaxf(mx1, c[3]);
      }
    }
    float rowmax = 0.f;                       // of row g = gq (matmulT)
    if constexpr (MODE == MATMULT) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float m0 = __shfl_sync(0xffffffffu, mx0, gq >> 1);
      const float m1 = __shfl_sync(0xffffffffu, mx1, gq >> 1);
      rowmax = gq & 1 ? m1 : m0;
    }
    __syncwarp();
    // out^T[d, g] += V^T[d, t] P^T[t, g]: k positions (2 tq, 2 tq + 1 |
    // + 8, + 9) of step ks hold t = 16 ks + 4 tq + (0, 1 | 2, 3); fragment
    // rows (gq, gq + 8) of d-tile md hold d = 16 md + 2 gq + (0 | 1)
    for (int ks = 0; ks < MT; ++ks) {
      const int t = 16 * ks + 4 * tq;
      const float4 s4 = *reinterpret_cast<const float4*>(sw + gq * bs_pad + t);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[j] = t + j >= bs ? 0.f
             : MODE == MATMUL ? sv[j] : expf(sv[j] - rowmax);
      const uint32_t b0 = f32_pair_bf16(p[0], p[1]);
      const uint32_t b1 = f32_pair_bf16(p[2], p[3]);
#pragma unroll
      for (int md = 0; md < MD_MAX; ++md) {
        if (md >= MD) break;
        const int dA = 16 * md + 2 * gq;
        uint32_t x[4] = {0u, 0u, 0u, 0u};
        if (dA < Dp) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (t + j < bs) {
              const unsigned char* r = vt + (t + j) * row_bytes + dA * EB;
              x[j] = BF16 ? *reinterpret_cast<const uint32_t*>(r)
                          : (uint32_t)*reinterpret_cast<const uint16_t*>(r);
            }
          }
        }
        uint32_t a[4];
        if constexpr (BF16) {
          a[0] = __byte_perm(x[0], x[1], 0x5410);
          a[1] = __byte_perm(x[0], x[1], 0x7632);
          a[2] = __byte_perm(x[2], x[3], 0x5410);
          a[3] = __byte_perm(x[2], x[3], 0x7632);
        } else {
          // bytes: x[j] = V[t + j][dA] | V[t + j][dA + 1] << 8
          const uint32_t lo = __byte_perm(x[0], x[1], 0x5140) ^ 0x80808080u;
          const uint32_t hi = __byte_perm(x[2], x[3], 0x5140) ^ 0x80808080u;
          a[0] = i8_pair(lo, 0, 1); a[1] = i8_pair(lo, 2, 3);
          a[2] = i8_pair(hi, 0, 1); a[3] = i8_pair(hi, 2, 3);
        }
        mma_bf16(acc[md], a, b0, b1);
      }
    }
    __syncwarp();                             // sw is read before rewritten
    ring.release(i);
  }
  // the warps' sums, added in the order 0, 1, 2, 3; acc[md]: (dA, 2 tq),
  // (dA, 2 tq + 1), (dA + 1, 2 tq), (dA + 1, 2 tq + 1)
  float* ob = dst + ((size_t)blockIdx.x * S + w.z) * G * Dp;
  for (int v = 0; v < NW; ++v) {
    if (warp == v) {
#pragma unroll
      for (int md = 0; md < MD_MAX; ++md) {
        const int dA = 16 * md + 2 * gq;
        if (md >= MD || dA >= Dp) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int g = 2 * tq + (c & 1);
          if (g >= G) continue;
          const int e = g * Dp + dA + (c >> 1);
          const float sum = v ? red[e] + acc[md][c] : acc[md][c];
          if (v == NW - 1)
            ob[e] = sum;
          else
            red[e] = sum;
        }
      }
    }
    consumer_sync();
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

using SumKernel = decltype(&sum_ring_kernel<FETCH, KV_INT8, 2>);
using ProductKernel = decltype(&product_kernel<MATMUL, false, 2, 128>);

template <int MODE, int KIND>
SumKernel pick_sum_depth(int depth) {
  switch (depth) {
    case 0:
      if constexpr (MODE != FETCHROW) return sum_regs_kernel<MODE, KIND>;
      return nullptr;
    case 2: return sum_ring_kernel<MODE, KIND, 2>;
    case 4: return sum_ring_kernel<MODE, KIND, 4>;
    case 8: return sum_ring_kernel<MODE, KIND, 8>;
  }
  return nullptr;
}

template <int MODE>
SumKernel pick_sum(int kind, int depth) {
  switch (kind) {
    case KV_INT8: return pick_sum_depth<MODE, KV_INT8>(depth);
    case KV_BF16: return pick_sum_depth<MODE, KV_BF16>(depth);
    case KV_INT4: return pick_sum_depth<MODE, KV_INT4>(depth);
  }
  return nullptr;
}

template <int MODE, bool BF16, int DPMAX>
ProductKernel pick_product_depth(int depth) {
  switch (depth) {
    case 2: return product_kernel<MODE, BF16, 2, DPMAX>;
    case 4: return product_kernel<MODE, BF16, 4, DPMAX>;
    case 8: return product_kernel<MODE, BF16, 8, DPMAX>;
  }
  return nullptr;
}

template <int MODE>
ProductKernel pick_product(bool bf16, int dp, int depth) {
  if (dp <= 128)
    return bf16 ? pick_product_depth<MODE, true, 128>(depth)
                : pick_product_depth<MODE, false, 128>(depth);
  return bf16 ? pick_product_depth<MODE, true, MAX_DP>(depth)
              : pick_product_depth<MODE, false, MAX_DP>(depth);
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Returns a cudaError_t code (0 = launched). kv_kind is KV_INT8, KV_BF16 or
// KV_INT4 (kv_tile.cuh); mode a Mode above; Dp = D / pack elements a pool
// row. out: [B, Hkv] float32 (int32 for fetchint) for the sum modes,
// [B, Hkv, G, Dp] float32 for matmul / matmulT. num_splits S >= 1 CTAs a
// (lane, kv head); at S > 1 `work` holds the partials (B * Hkv * S times
// an output row) and a merge launch adds them. depth: the ring's stages
// (2, 4, 8), or 0 for fetch / fetchint / dequant's register path. The
// Python wrapper checks shapes: G <= 8, Dp <= 256, Dp * element bytes a
// multiple of 16, bs % 4 == 0; the launch returns cudaErrorInvalidValue
// for what it cannot run (a ring over the 227 KB of shared memory).
extern "C" int anatomy_variants_launch(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* block_table,
    const int* seq_lens, void* out, void* work, int B, int Hq, int Hkv, int D,
    int Dp, int bs, int max_blocks, int kv_kind, int mode, int num_splits,
    int depth, void* stream) {
  const int elem = kv_kind == KV_BF16 ? 2 : 1;
  const int row_bytes = Dp * elem;
  const int S = num_splits;
  if (kv_kind != KV_INT8 && kv_kind != KV_BF16 && kv_kind != KV_INT4)
    return (int)cudaErrorInvalidValue;
  if (row_bytes % 16 || Dp % 4 || Dp > MAX_DP || bs % 4 || Hq % Hkv ||
      Hq / Hkv > MAX_G || mode < FETCHROW || mode > MATMULT || S < 1 ||
      (S > 1 && !work))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * Hkv, S);
  void* dst = S == 1 ? out : work;
  const char* kp = static_cast<const char*>(k_pool);
  const char* vp = static_cast<const char*>(v_pool);
  const size_t tile_bytes = (size_t)bs * row_bytes;
  cudaError_t e;
  if (mode == MATMUL || mode == MATMULT) {
    const bool bf16 = kv_kind == KV_BF16;
    const ProductKernel kern = mode == MATMUL
                                   ? pick_product<MATMUL>(bf16, Dp, depth)
                                   : pick_product<MATMULT>(bf16, Dp, depth);
    const int G = Hq / Hkv;
    const size_t smem = tile_ring::ring_smem_bytes(depth, 2 * tile_bytes) +
                        product_extra((bs + 15) / 16 * 16, Dp);
    if (!kern || smem > 232448) return (int)cudaErrorInvalidValue;
    if ((e = set_smem(kern, smem)) != cudaSuccess) return (int)e;
    kern<<<grid, NT, smem, st>>>(q, kp, vp, block_table, seq_lens,
                                 static_cast<float*>(dst), Hq, Hkv, D, Dp, bs,
                                 max_blocks, S);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (S > 1)
      return (int)tile_ring::launch_merge(static_cast<const float*>(work),
                                          static_cast<float*>(out), B * Hkv,
                                          S, G * Dp, st);
    return 0;
  }
  SumKernel kern = nullptr;
  switch (mode) {
    case FETCHROW: kern = pick_sum<FETCHROW>(kv_kind, depth); break;
    case FETCHINT: kern = pick_sum<FETCHINT>(kv_kind, depth); break;
    case FETCH: kern = pick_sum<FETCH>(kv_kind, depth); break;
    case DEQUANT: kern = pick_sum<DEQUANT>(kv_kind, depth); break;
  }
  if (!kern) return (int)cudaErrorInvalidValue;
  if (depth == 0) {
    kern<<<grid, NC, 0, st>>>(kp, vp, k_scale, v_scale, block_table, seq_lens,
                              dst, Hkv, bs, row_bytes, max_blocks, S);
  } else {
    const bool sc = mode == FETCH || mode == DEQUANT;
    const size_t smem = tile_ring::ring_smem_bytes(
        depth, 2 * tile_bytes + (sc ? 8 * (size_t)bs : 0));
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    if ((e = set_smem(kern, smem)) != cudaSuccess) return (int)e;
    kern<<<grid, NT, smem, st>>>(kp, vp, k_scale, v_scale, block_table,
                                 seq_lens, dst, Hkv, bs, row_bytes, max_blocks,
                                 S);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (S == 1) return 0;
  if (mode == FETCHINT)
    return (int)tile_ring::launch_merge(static_cast<const int*>(work),
                                        static_cast<int*>(out), B * Hkv, S, 1,
                                        st);
  return (int)tile_ring::launch_merge(static_cast<const float*>(work),
                                      static_cast<float*>(out), B * Hkv, S, 1,
                                      st);
}
