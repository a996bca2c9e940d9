// P1: K1's walk with parts stripped, one mode per launch (Hopper, sm_90a).
//
// Replaces the Pallas TPU probe `scripts/kernel_anatomy.py:204`
// (`run_variant.<locals>.loop`, body `variant_kernel`, `:100-171`). It runs
// on K1's grid (csrc/paged_attention.cu): one CTA per (lane, kv head),
// walking the lane's ceil(seq_len / bs) blocks through its block-table row,
// over K1's token-major pools K, V [S, Hkv, bs, D/pack] (int8 bytes or
// bf16; INT4 packs two elements a byte) and scales [S, Hkv, bs] float32.
// Each mode is "K1 minus something"; for the CTA's kv head h of lane b it
// computes, over the tiles of the lane's blocks (raw = the stored elements
// as numbers: int8 bytes, INT4 packed bytes read as int8, bf16 values):
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
// 40 us at 3.35 TB/s, while the products' 1.07 GFLOP take 16 us even at the
// float32 rate. Design: as K1, tiles are not double-buffered (the ring of
// csrc/anatomy_ring.cu keeps loads in flight); the sum modes read 16 bytes a
// thread per step straight into registers.

#include <cuda_runtime.h>

#include "kv_tile.cuh"

namespace {

constexpr int NT = 128;       // threads per CTA
constexpr int MAX_G = 8;      // query heads per kv head
constexpr int MAX_ACC = 2;    // row elements per thread: D / pack <= NT * 2

enum Mode { FETCHROW = 0, FETCHINT = 1, FETCH = 2, DEQUANT = 3, MATMUL = 4,
            MATMULT = 5 };

__device__ __forceinline__ float bf16r(float x) { return round_cd(x, true); }

// the 16 bytes `w` of a tile as numbers: 8 bf16 values or 16 int8 bytes
// (INT4's packed bytes too) -> their float32 sum
template <bool BF16>
__device__ __forceinline__ float raw_sum(const uint4& w) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (BF16) {
      s += __uint_as_float(u[c] << 16) + __uint_as_float(u[c] & 0xFFFF0000u);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) s += (float)(int8_t)(u[c] >> (8 * k));
    }
  }
  return s;
}

// the same as int32; a bf16 value truncated toward zero
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
#pragma unroll
      for (int k = 0; k < 4; ++k) s += (int)(int8_t)(u[c] >> (8 * k));
    }
  }
  return s;
}

// sum of bf16(deq(x) * sc) over the 16 bytes `w` of one token row, sc the
// row's scale already rounded to bf16
template <int KIND>
__device__ __forceinline__ float dequant_sum(const uint4& w, float sc) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if constexpr (KIND == KV_BF16) {
      s += bf16r(__uint_as_float(u[c] << 16) * sc) +
           bf16r(__uint_as_float(u[c] & 0xFFFF0000u) * sc);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t byte = (u[c] >> (8 * k)) & 0xFF;
        if constexpr (KIND == KV_INT4) {
          s += bf16r(nibble(byte & 0xF) * sc) + bf16r(nibble(byte >> 4) * sc);
        } else {
          s += bf16r((float)(int8_t)byte * sc);
        }
      }
    }
  }
  return s;
}

// sum of `v` over the CTA, valid in thread 0
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T r = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < NT / 32; ++i) r += red[i];
  return r;
}

// lane b's blocks, capped at the table's width
__device__ __forceinline__ int lane_blocks(const int* lens, int b, int bs,
                                           int max_blocks) {
  const int n = (lens[b] + bs - 1) / bs;
  return n < max_blocks ? n : max_blocks;
}

// fetchrow, fetchint, fetch, dequant. row_bytes: bytes of one token row
// (a multiple of 16, so a 16-byte step never leaves its row)
template <int MODE, int KIND>
__global__ void __launch_bounds__(NT)
sum_kernel(const void* __restrict__ k_pool, const void* __restrict__ v_pool,
           const float* __restrict__ k_scale, const float* __restrict__ v_scale,
           const int* __restrict__ block_table, const int* __restrict__ seq_lens,
           void* __restrict__ out, int Hkv, int bs, int row_bytes,
           int max_blocks) {
  extern __shared__ uint4 tile_s[];           // fetchrow: [K tile][V tile]
  __shared__ float redf[NT / 32];
  __shared__ int redi[NT / 32];
  constexpr bool BF16 = KIND == KV_BF16;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int nblk = lane_blocks(seq_lens, b, bs, max_blocks);
  const int nvec = bs * row_bytes / 16;       // 16-byte vectors a tile
  const int row_vec = row_bytes / 16;
  float accf = 0.f;
  int acci = 0;
  for (int blk = 0; blk < nblk; ++blk) {
    const int slot = block_table[(size_t)b * max_blocks + blk];
    const size_t tile = ((size_t)slot * Hkv + h) * bs;   // first token row
    const uint4* kt = reinterpret_cast<const uint4*>(
        static_cast<const char*>(k_pool) + tile * row_bytes);
    const uint4* vt = reinterpret_cast<const uint4*>(
        static_cast<const char*>(v_pool) + tile * row_bytes);
    if constexpr (MODE == FETCHROW) {
      __syncthreads();                        // the last block's row is read
      for (int i = tid; i < nvec; i += NT) {
        tile_s[i] = kt[i];
        tile_s[nvec + i] = vt[i];
      }
      __syncthreads();
      for (int i = tid; i < row_vec; i += NT)
        accf += raw_sum<BF16>(tile_s[i]) + raw_sum<BF16>(tile_s[nvec + i]);
    } else {
      for (int i = tid; i < nvec; i += NT) {
        const uint4 kw = kt[i], vw = vt[i];
        if constexpr (MODE == FETCHINT) {
          acci += raw_isum<BF16>(kw) + raw_isum<BF16>(vw);
        } else if constexpr (MODE == FETCH) {
          accf += raw_sum<BF16>(kw) + raw_sum<BF16>(vw);
        } else {
          const size_t t = tile + i / row_vec;
          accf += dequant_sum<KIND>(kw, bf16r(k_scale[t])) +
                  dequant_sum<KIND>(vw, bf16r(v_scale[t]));
        }
      }
      if constexpr (MODE == FETCH)
        for (int t = tid; t < bs; t += NT) accf += k_scale[tile + t] + v_scale[tile + t];
    }
  }
  if constexpr (MODE == FETCHINT) {
    const int s = block_sum(acci, redi);
    if (tid == 0) static_cast<int*>(out)[blockIdx.x] = s;
  } else {
    const float s = block_sum(accf, redf);
    if (tid == 0) static_cast<float*>(out)[blockIdx.x] = s;
  }
}

// matmul, matmulT on raw tiles; Dp = D / pack row elements, q [B, Hq, D]
template <int MODE, bool BF16>
__global__ void __launch_bounds__(NT)
product_kernel(const float* __restrict__ q, const void* __restrict__ k_pool,
               const void* __restrict__ v_pool,
               const int* __restrict__ block_table,
               const int* __restrict__ seq_lens, float* __restrict__ out,
               int Hq, int Hkv, int D, int Dp, int bs, int max_blocks) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int DK = Dp + 1;                      // padded K rows
  float* q_s = smem;                          // [G][Dp]
  float* k_s = q_s + G * Dp;                  // [bs][Dp + 1]
  float* v_s = k_s + bs * DK;                 // [bs][Dp]
  float* s_s = v_s + bs * Dp;                 // [G][bs]
  constexpr int LOAD = BF16 ? KV_BF16 : KV_INT8;   // raw: no INT4 unpack
  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int nblk = lane_blocks(seq_lens, b, bs, max_blocks);

  const float* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * Dp; i += NT)
    q_s[i] = bf16r(qb[(i / Dp) * D + i % Dp]);

  float acc[MAX_G][MAX_ACC];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int k = 0; k < MAX_ACC; ++k) acc[g][k] = 0.f;

  for (int blk = 0; blk < nblk; ++blk) {
    const int slot = block_table[(size_t)b * max_blocks + blk];
    const size_t tile = ((size_t)slot * Hkv + h) * bs;
    __syncthreads();
    load_kv_tiles<LOAD, NT>(k_pool, v_pool, tile, k_s, DK, v_s, Dp, bs, Dp);
    __syncthreads();
    for (int i = tid; i < G * bs; i += NT) {
      const int g = i / bs, t = i % bs;
      const float* qr = q_s + g * Dp;
      const float* kr = k_s + t * DK;
      float s = 0.f;
      for (int d = 0; d < Dp; ++d) s = fmaf(qr[d], kr[d], s);
      s_s[i] = MODE == MATMUL ? bf16r(s) : s;
    }
    __syncthreads();
    if (MODE == MATMULT && tid < G) {
      float* row = s_s + tid * bs;
      float mx = row[0];
      for (int t = 1; t < bs; ++t) mx = fmaxf(mx, row[t]);
      for (int t = 0; t < bs; ++t) row[t] = bf16r(expf(row[t] - mx));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_ACC; ++k) {
      const int d = tid + k * NT;
      if (d >= Dp) break;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        const float* pr = s_s + g * bs;
        float a = acc[g][k];
        for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * Dp + d], a);
        acc[g][k] = a;
      }
    }
  }
  float* ob = out + (size_t)blockIdx.x * G * Dp;
#pragma unroll
  for (int k = 0; k < MAX_ACC; ++k) {
    const int d = tid + k * NT;
    if (d >= Dp) break;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      ob[g * Dp + d] = acc[g][k];
    }
  }
}

using SumKernel = decltype(&sum_kernel<FETCH, KV_INT8>);
using ProductKernel = decltype(&product_kernel<MATMUL, false>);

template <int MODE>
SumKernel pick_sum(int kind) {
  switch (kind) {
    case KV_INT8: return sum_kernel<MODE, KV_INT8>;
    case KV_BF16: return sum_kernel<MODE, KV_BF16>;
    case KV_INT4: return sum_kernel<MODE, KV_INT4>;
  }
  return nullptr;
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
// [B, Hkv, G, Dp] float32 for matmul / matmulT. The Python wrapper checks
// shapes: G <= 8, Dp <= 256, Dp * element bytes a multiple of 16, Dp % 4.
extern "C" int anatomy_variants_launch(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* block_table,
    const int* seq_lens, void* out, int B, int Hq, int Hkv, int D, int Dp,
    int bs, int max_blocks, int kv_kind, int mode, void* stream) {
  const int elem = kv_kind == KV_BF16 ? 2 : 1;
  const int row_bytes = Dp * elem;
  if (kv_kind != KV_INT8 && kv_kind != KV_BF16 && kv_kind != KV_INT4)
    return (int)cudaErrorInvalidValue;
  if (row_bytes % 16 || Dp % 4 || Dp > NT * MAX_ACC || Hq % Hkv ||
      Hq / Hkv > MAX_G || mode < FETCHROW || mode > MATMULT)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * Hkv);
  if (mode == MATMUL || mode == MATMULT) {
    const bool bf16 = kv_kind == KV_BF16;
    const ProductKernel kern =
        mode == MATMUL ? (bf16 ? product_kernel<MATMUL, true>
                               : product_kernel<MATMUL, false>)
                       : (bf16 ? product_kernel<MATMULT, true>
                               : product_kernel<MATMULT, false>);
    const int G = Hq / Hkv;
    const size_t smem = sizeof(float) * ((size_t)G * Dp + (size_t)bs * (Dp + 1) +
                                         (size_t)bs * Dp + (size_t)G * bs);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, NT, smem, st>>>(q, k_pool, v_pool, block_table, seq_lens,
                                 static_cast<float*>(out), Hq, Hkv, D, Dp, bs,
                                 max_blocks);
    return (int)cudaGetLastError();
  }
  SumKernel kern = nullptr;
  switch (mode) {
    case FETCHROW: kern = pick_sum<FETCHROW>(kv_kind); break;
    case FETCHINT: kern = pick_sum<FETCHINT>(kv_kind); break;
    case FETCH: kern = pick_sum<FETCH>(kv_kind); break;
    case DEQUANT: kern = pick_sum<DEQUANT>(kv_kind); break;
  }
  const size_t smem = mode == FETCHROW ? (size_t)2 * bs * row_bytes : 0;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, NT, smem, st>>>(k_pool, v_pool, k_scale, v_scale, block_table,
                               seq_lens, out, Hkv, bs, row_bytes, max_blocks);
  return (int)cudaGetLastError();
}
