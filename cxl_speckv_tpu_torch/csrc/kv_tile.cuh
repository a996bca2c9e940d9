// The pool tile loaders shared by K1 (paged_attention.cu) and K2
// (chunk_attention.cu): a block's [bs, D] K and V tiles of the quantized
// pool, decoded into shared memory, for each storage kind the pool may
// hold. Counterpart of `_dequant_tile` in `cxl_speckv_tpu/ops/
// paged_attention.py`. `load_kv_tiles` writes float32 (K1, and K2 at
// float32 compute); `load_kv_tiles_bf16` writes bfloat16 (K2's tensor-core
// path). Every stored value is exact in both (int8 and int4 integers, bf16,
// e4m3 with its 3 mantissa bits), so a kernel's arithmetic does not depend
// on the kind; only the bytes it reads do (INT4 reads half of INT8's).
//
// Kinds (the launch argument `kv_kind`; the wrappers map MIXED8 with a
// scheme id onto INT8 or FP8):
//   KV_INT8  int8 integers;
//   KV_BF16  bfloat16;
//   KV_FP8   float8 e4m3fn bits in int8 bytes. A NaN byte ((b & 0x7F) ==
//            0x7F) decodes to 0: the guard slot, the tails of partly
//            filled blocks and blocks written under another scheme can hold
//            such bytes, and a NaN in V would poison the whole row through
//            p * v with p = 0 for masked tokens;
//   KV_INT4  D/2 bytes a row, half-split: byte j holds element j in its low
//            nibble and element j + D/2 in its high nibble, both signed.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

enum KvKind { KV_INT8 = 0, KV_BF16 = 1, KV_FP8 = 2, KV_INT4 = 3 };

__device__ __forceinline__ float round_cd(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// e4m3fn byte -> float, exact; NaN bytes -> 0
__device__ __forceinline__ float fp8_e4m3(uint32_t b) {
  const uint32_t e = (b >> 3) & 0xF, m = b & 7;
  if (e == 15 && m == 7) return 0.f;
  const float mag = e ? __uint_as_float(((e + 120) << 23) | (m << 20))
                      : (float)m * 0.001953125f;   // subnormal: m * 2^-9
  return (b & 0x80) ? -mag : mag;
}

// a 4-bit two's-complement nibble (0..15) -> float in [-8, 7]
__device__ __forceinline__ float nibble(uint32_t u) {
  return (float)((int)(u ^ 8u) - 8);
}

// four consecutive stored elements at element offset `off` of a byte or
// bf16 pool -> float
template <int KIND>
__device__ __forceinline__ void load_stored4(const void* pool, size_t off,
                                             float* o) {
  if constexpr (KIND == KV_BF16) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(pool) + off);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (KIND == KV_FP8) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(
        static_cast<const uint8_t*>(pool) + off);
    o[0] = fp8_e4m3(v.x); o[1] = fp8_e4m3(v.y);
    o[2] = fp8_e4m3(v.z); o[3] = fp8_e4m3(v.w);
  } else {
    const char4 v = *reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(pool) + off);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
}

// The K and V tiles `tile` (their first token row, (slot * Hkv + h) * bs)
// of the pools -> k_dst[t * k_ds + d] and v_dst[t * v_ds + d], for t < bs
// and d < D, in one pass: NT threads share the work, four stored elements
// (INT4: four bytes, eight elements) of K and of V each per step. Needs
// D % 4 == 0, and D % 8 == 0 for INT4.
template <int KIND, int NT>
__device__ __forceinline__ void load_kv_tiles(const void* k_pool,
                                              const void* v_pool, size_t tile,
                                              float* k_dst, int k_ds,
                                              float* v_dst, int v_ds, int bs,
                                              int D) {
  const int tid = threadIdx.x;
  if constexpr (KIND == KV_INT4) {
    const int H = D / 2;
    const uint8_t* ks = static_cast<const uint8_t*>(k_pool) + tile * H;
    const uint8_t* vs = static_cast<const uint8_t*>(v_pool) + tile * H;
    for (int i = tid * 4; i < bs * H; i += NT * 4) {
      const uchar4 kw = *reinterpret_cast<const uchar4*>(ks + i);
      const uchar4 vw = *reinterpret_cast<const uchar4*>(vs + i);
      const uint32_t kb[4] = {kw.x, kw.y, kw.z, kw.w};
      const uint32_t vb[4] = {vw.x, vw.y, vw.z, vw.w};
      const int t = i / H, j = i % H;
      float* kr = k_dst + t * k_ds + j;
      float* vr = v_dst + t * v_ds + j;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kr[c] = nibble(kb[c] & 0xF);
        kr[H + c] = nibble(kb[c] >> 4);
        vr[c] = nibble(vb[c] & 0xF);
        vr[H + c] = nibble(vb[c] >> 4);
      }
    }
  } else {
    for (int i = tid * 4; i < bs * D; i += NT * 4) {
      float kv[4], vv[4];
      load_stored4<KIND>(k_pool, tile * D + i, kv);
      load_stored4<KIND>(v_pool, tile * D + i, vv);
      const int t = i / D, d = i % D;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        k_dst[t * k_ds + d + c] = kv[c];
        v_dst[t * v_ds + d + c] = vv[c];
      }
    }
  }
}

// two floats -> a bf16x2 word, round to nearest even (exact for stored values)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four int8 / e4m3 bytes of a word (lowest address in the low byte) ->
// two bf16x2 words
template <int KIND>
__device__ __forceinline__ uint2 decode4_bf16(uint32_t w) {
  float f[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t b = (w >> (8 * c)) & 0xFFu;
    f[c] = KIND == KV_FP8 ? fp8_e4m3(b) : (float)(int8_t)b;
  }
  return make_uint2(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]));
}

// eight INT4 bytes (elements j .. j + 7 in the low nibbles, j + D/2 .. in
// the high ones) -> eight bf16 elements each
__device__ __forceinline__ void decode_int4_bf16(uint2 w, uint4& lo,
                                                 uint4& hi) {
  uint32_t l[4], h[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t x = ((c < 2 ? w.x : w.y) >> ((c & 1) * 16)) & 0xFFFFu;
    l[c] = bf16x2(nibble(x & 0xF), nibble((x >> 8) & 0xF));
    h[c] = bf16x2(nibble((x >> 4) & 0xF), nibble(x >> 12));
  }
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
}

// The K and V tiles `tile` of the pools -> bf16 k_dst[t * ld + d] and
// v_dst[t * ld + d], for t < bs and d < D, in one loop (two loops made
// ptxas spill in K1): NT threads share the work, each with U = 2 16-byte
// vectors of K and of V in flight (INT4: 8-byte vectors) before it decodes
// and stores them (an INT8 [32, 256] tile pair is 1024 vectors: one step
// of 256 threads). Needs D % 16 == 0 and ld % 8 == 0 (16-byte stores).
template <int KIND, int NT>
__device__ __forceinline__ void load_kv_tiles_bf16(
    const void* k_pool, const void* v_pool, size_t tile, __nv_bfloat16* k_dst,
    __nv_bfloat16* v_dst, int ld, int bs, int D) {
  constexpr int U = 2;
  const int tid = threadIdx.x;
  if constexpr (KIND == KV_INT4) {
    const int H = D / 2;                      // bytes a row, 8 a vector
    const uint2* ks = reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(k_pool) + tile * H);
    const uint2* vs = reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(v_pool) + tile * H);
    const int n = bs * H / 8;
    for (int i0 = tid; i0 < n; i0 += NT * U) {
      uint2 kw[U], vw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT;
        if (i < n) { kw[u] = __ldg(ks + i); vw[u] = __ldg(vs + i); }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT;
        if (i < n) {
          const int t = i * 8 / H, j = i * 8 % H;
          uint4 lo, hi;
          decode_int4_bf16(kw[u], lo, hi);
          *reinterpret_cast<uint4*>(k_dst + t * ld + j) = lo;
          *reinterpret_cast<uint4*>(k_dst + t * ld + j + H) = hi;
          decode_int4_bf16(vw[u], lo, hi);
          *reinterpret_cast<uint4*>(v_dst + t * ld + j) = lo;
          *reinterpret_cast<uint4*>(v_dst + t * ld + j + H) = hi;
        }
      }
    }
  } else {
    // 16-byte vectors: 8 bf16 elements, or 16 int8 / e4m3 bytes
    constexpr int E = KIND == KV_BF16 ? 8 : 16;
    const uint4* ks = reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(k_pool) + tile * D * (16 / E));
    const uint4* vs = reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(v_pool) + tile * D * (16 / E));
    const int n = bs * D / E;
    for (int i0 = tid; i0 < n; i0 += NT * U) {
      uint4 kw[U], vw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT;
        if (i < n) { kw[u] = __ldg(ks + i); vw[u] = __ldg(vs + i); }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT;
        if (i < n) {
          const int t = i * E / D, d = i * E % D;
          __nv_bfloat16* kr = k_dst + t * ld + d;
          __nv_bfloat16* vr = v_dst + t * ld + d;
          if constexpr (KIND == KV_BF16) {
            *reinterpret_cast<uint4*>(kr) = kw[u];
            *reinterpret_cast<uint4*>(vr) = vw[u];
          } else {
            const uint2 k0 = decode4_bf16<KIND>(kw[u].x),
                        k1 = decode4_bf16<KIND>(kw[u].y),
                        k2 = decode4_bf16<KIND>(kw[u].z),
                        k3 = decode4_bf16<KIND>(kw[u].w);
            *reinterpret_cast<uint4*>(kr) = make_uint4(k0.x, k0.y, k1.x, k1.y);
            *reinterpret_cast<uint4*>(kr + 8) =
                make_uint4(k2.x, k2.y, k3.x, k3.y);
            const uint2 v0 = decode4_bf16<KIND>(vw[u].x),
                        v1 = decode4_bf16<KIND>(vw[u].y),
                        v2 = decode4_bf16<KIND>(vw[u].z),
                        v3 = decode4_bf16<KIND>(vw[u].w);
            *reinterpret_cast<uint4*>(vr) = make_uint4(v0.x, v0.y, v1.x, v1.y);
            *reinterpret_cast<uint4*>(vr + 8) =
                make_uint4(v2.x, v2.y, v3.x, v3.y);
          }
        }
      }
    }
  }
}
