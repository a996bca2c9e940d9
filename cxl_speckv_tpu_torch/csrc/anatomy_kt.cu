// P2: decode attention on the TPU's transposed-K pool (Hopper, sm_90a).
//
// Replaces the Pallas TPU probe `scripts/kernel_anatomy.py:360`
// (`run_v2.<locals>.loop`, body `v2_kernel`, `:237-317`). It computes what
// `run_v2` computes, on the JAX package's production layout:
//   K "kT" [S, D/pack, Hkv * bs] (row r of a token column holds element r;
//   INT4 packs element r in the low nibble and r + D/2 in the high nibble of
//   row r, the half-split), V token-major [S, Hkv, bs, D/pack];
//   q rounded to bf16; s = (q . k) * ks * D^-0.5 per token column; tokens at
//   pos >= seq_len masked to -1e30; an online softmax in float32 over the
//   lane's blocks; p * vs rounded to bf16 before PV; out = acc / max(l, 1e-30)
//   (a lane with seq_len 0 gives zeros). Variants per launch:
//   v2       separate scales ks, vs [S, Hkv, bs] float32;
//   v3fused  one scale array [S, 2, Hkv, bs] (ks at 0, vs at 1);
//   w8a8     q8 = trunc(clip(bf16(bf16(q) * 127), -127, 127)) as int8; the
//            scores are int8 x int8 products summed in int32 (__dp4a), times
//            1/127 in float32, then times ks and D^-0.5 as above.
// The output is the whole [B, Hq, D] in float32, so it can be held against
// K1; the TPU probe returned column 0 of it.
//
// Design: K1's grid, one CTA per (lane, kv head), so the masks by head of the
// TPU body (its tile spans every head) fall away. The CTA reads its head's
// columns h * bs .. h * bs + bs - 1 of each kT row, four tokens at a time,
// and transposes them into token rows in shared memory; the rest is K1's
// arithmetic. Bound: the bytes (every context byte once; the products are
// 4 flops a K/V element per query head, under the card's float32 rate).
// It is the one kernel of the port that reads the JAX K layout.

#include <cuda_runtime.h>

#include "kv_tile.cuh"

namespace {

constexpr int NT = 128;
constexpr int MAX_G = 8;
constexpr int MAX_ACC = 2;    // D <= NT * 2
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16r(float x) { return round_cd(x, true); }

// four stored elements of the kT row at element offset `off` (four token
// columns) -> their values; INT4 gives the low nibbles in lo, high in hi
template <int KIND>
__device__ __forceinline__ void load_kt4(const void* pool, size_t off,
                                         float* lo, float* hi) {
  if constexpr (KIND == KV_INT4) {
    const uchar4 w = *reinterpret_cast<const uchar4*>(
        static_cast<const uint8_t*>(pool) + off);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      lo[c] = nibble(u[c] & 0xF);
      hi[c] = nibble(u[c] >> 4);
    }
  } else {
    load_stored4<KIND>(pool, off, lo);
  }
}

template <int KIND, bool FUSED, bool W8A8>
__global__ void __launch_bounds__(NT)
kt_kernel(const float* __restrict__ q, const void* __restrict__ kt_pool,
          const void* __restrict__ v_pool, const float* __restrict__ k_scale,
          const float* __restrict__ v_scale,
          const int* __restrict__ block_table,
          const int* __restrict__ seq_lens, float* __restrict__ out, int Hq,
          int Hkv, int D, int bs, int max_blocks, float sm_scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int DK = D + 1;                       // padded K rows
  const int DW = D / 4 + 1;                   // w8a8: int8 K rows in words
  float* q_s = smem;                          // [G][D]
  float* k_s = q_s + G * D;                   // [bs][D + 1] (w8a8: [bs][DW] words)
  float* v_s = k_s + bs * DK;                 // [bs][D]
  float* p_s = v_s + bs * D;                  // [G][bs]
  float* ks_s = p_s + G * bs;                 // [bs]
  float* vs_s = ks_s + bs;                    // [bs]
  float* m_s = vs_s + bs;                     // [G]
  float* l_s = m_s + G;                       // [G]
  float* a_s = l_s + G;                       // [G]
  int* q8_s = reinterpret_cast<int*>(a_s + G);        // [G][D / 4] w8a8
  int8_t* k8_s = reinterpret_cast<int8_t*>(k_s);

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int seq_len = seq_lens[b];
  int nblk = (seq_len + bs - 1) / bs;
  if (nblk > max_blocks) nblk = max_blocks;
  const int pack = KIND == KV_INT4 ? 2 : 1;
  const int Dp = D / pack;
  const int cols = Hkv * bs;

  const float* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const float x = bf16r(qb[i]);
    q_s[i] = x;
    if (W8A8) {
      const float c = fminf(fmaxf(bf16r(x * 127.f), -127.f), 127.f);
      reinterpret_cast<int8_t*>(q8_s)[i] = (int8_t)(int)c;   // toward zero
    }
  }
  if (tid < G) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }

  float acc[MAX_G][MAX_ACC];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int k = 0; k < MAX_ACC; ++k) acc[g][k] = 0.f;

  for (int blk = 0; blk < nblk; ++blk) {
    const int slot = block_table[(size_t)b * max_blocks + blk];
    const size_t tile = ((size_t)slot * Hkv + h) * bs;   // V row, scales
    __syncthreads();
    // K: kT rows r < Dp, this head's bs columns, four at a time
    for (int i = tid * 4; i < Dp * bs; i += NT * 4) {
      const int r = i / bs, t = i % bs;
      float lo[4], hi[4];
      load_kt4<KIND>(kt_pool, ((size_t)slot * Dp + r) * cols + h * bs + t,
                     lo, hi);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (W8A8) {
          k8_s[(t + c) * DW * 4 + r] = (int8_t)lo[c];
          if (KIND == KV_INT4) k8_s[(t + c) * DW * 4 + r + Dp] = (int8_t)hi[c];
        } else {
          k_s[(t + c) * DK + r] = lo[c];
          if (KIND == KV_INT4) k_s[(t + c) * DK + r + Dp] = hi[c];
        }
      }
    }
    // V: token rows, half-split nibbles for INT4
    if constexpr (KIND == KV_INT4) {
      const uint8_t* vb = static_cast<const uint8_t*>(v_pool) + tile * Dp;
      for (int i = tid * 4; i < bs * Dp; i += NT * 4) {
        const uchar4 w = *reinterpret_cast<const uchar4*>(vb + i);
        const uint32_t u[4] = {w.x, w.y, w.z, w.w};
        float* vr = v_s + (i / Dp) * D + i % Dp;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          vr[c] = nibble(u[c] & 0xF);
          vr[Dp + c] = nibble(u[c] >> 4);
        }
      }
    } else {
      for (int i = tid * 4; i < bs * D; i += NT * 4)
        load_stored4<KIND>(v_pool, tile * D + i, v_s + i);
    }
    for (int t = tid; t < bs; t += NT) {
      if (FUSED) {       // [S, 2, Hkv, bs]
        const size_t base = ((size_t)slot * 2 * Hkv + h) * bs + t;
        ks_s[t] = k_scale[base];
        vs_s[t] = k_scale[base + (size_t)Hkv * bs];
      } else {
        ks_s[t] = k_scale[tile + t];
        vs_s[t] = v_scale[tile + t];
      }
    }
    __syncthreads();

    for (int i = tid; i < G * bs; i += NT) {
      const int g = i / bs, t = i % bs;
      float s;
      if (W8A8) {
        const int* qr = q8_s + g * (D / 4);
        const int* kr = reinterpret_cast<const int*>(k8_s) + t * DW;
        int si = 0;
        for (int w = 0; w < D / 4; ++w) si = __dp4a(qr[w], kr[w], si);
        s = (float)si * (1.f / 127.f);
      } else {
        const float* qr = q_s + g * D;
        const float* kr = k_s + t * DK;
        s = 0.f;
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      s = s * ks_s[t] * sm_scale;
      p_s[i] = blk * bs + t < seq_len ? s : NEG_INF;
    }
    __syncthreads();

    if (tid < G) {
      const int g = tid;
      float* row = p_s + g * bs;
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, row[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(row[t] - mx);
        sum += p;
        row[t] = bf16r(p * vs_s[t]);
      }
      const float alpha = expf(m_prev - mx);
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = mx;
      a_s[g] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < MAX_ACC; ++k) {
      const int d = tid + k * NT;
      if (d >= D) break;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        const float* pr = p_s + g * bs;
        float a = acc[g][k] * a_s[g];
        for (int t = 0; t < bs; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
        acc[g][k] = a;
      }
    }
  }
  __syncthreads();

  float* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
#pragma unroll
  for (int k = 0; k < MAX_ACC; ++k) {
    const int d = tid + k * NT;
    if (d >= D) break;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      ob[g * D + d] = acc[g][k] / fmaxf(l_s[g], 1e-30f);
    }
  }
}

using Kernel = decltype(&kt_kernel<KV_INT8, false, false>);

template <bool FUSED, bool W8A8>
Kernel pick_kind(int kind) {
  switch (kind) {
    case KV_INT8: return kt_kernel<KV_INT8, FUSED, W8A8>;
    case KV_INT4: return kt_kernel<KV_INT4, FUSED, W8A8>;
    case KV_BF16:
      if (W8A8) return nullptr;       // w8a8 takes integer pools only
      return kt_kernel<KV_BF16, FUSED, false>;
  }
  return nullptr;
}

}  // namespace

// Returns a cudaError_t code (0 = launched). kv_kind is KV_INT8, KV_BF16 or
// KV_INT4 (kv_tile.cuh; w8a8 takes no BF16). fused: k_scale is the
// [S, 2, Hkv, bs] array and v_scale is unused. out [B, Hq, D] float32. The
// Python wrapper checks shapes: G <= 8, D <= 256, D % 8 == 0, bs % 4 == 0.
extern "C" int anatomy_kt_launch(
    const float* q, const void* kt_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* block_table,
    const int* seq_lens, float* out, int B, int Hq, int Hkv, int D, int bs,
    int max_blocks, int kv_kind, int fused, int w8a8, float sm_scale,
    void* stream) {
  Kernel kern = nullptr;
  if (fused) kern = w8a8 ? pick_kind<true, true>(kv_kind) : pick_kind<true, false>(kv_kind);
  else kern = w8a8 ? pick_kind<false, true>(kv_kind) : pick_kind<false, false>(kv_kind);
  if (!kern || Hq % Hkv || Hq / Hkv > MAX_G || D > NT * MAX_ACC || D % 8 ||
      bs % 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + bs * (D + 1) + (size_t)bs * D +
                       (size_t)G * bs + 2 * bs + 3 * G + (size_t)G * D / 4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * Hkv, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      q, kt_pool, v_pool, k_scale, v_scale, block_table, seq_lens, out, Hq,
      Hkv, D, bs, max_blocks, sm_scale);
  return (int)cudaGetLastError();
}
