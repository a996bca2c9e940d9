// K1: paged decode attention over the quantized KV pool (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `cxl_speckv_tpu/ops/paged_attention.py`
// (`paged_attention`, body `_decode_kernel`). Computes, for each lane b and
// query head, softmax(q . K^T * ks * sm_scale) (V * vs) over the lane's
// seq_len pool tokens, reached through its block-table row. Per-launch
// variants (one source serves every layer of a model that mixes them):
//   - the storage kind (`kv_kind`, kv_tile.cuh): INT8, BF16, FP8 or INT4.
//     A MIXED8 pool (a scheme per layer) launches INT8 or FP8 for the
//     layer's scheme id, which the TPU kernel reads from SMEM instead;
//   - sliding window (window > 0): the query at seq_len - 1 attends only
//     positions >= seq_len - window, and the CTA's block walk starts at
//     first = max((seq_len - window) / bs, 0), as the TPU kernel's index map
//     does. Table entries below `first` may be retired (the engine frees
//     out-of-window blocks; the row keeps a stale slot that may belong to
//     another sequence by now), so they are never read;
//   - tanh softcap (softcap > 0, Gemma-2): s = cap * tanh(s / cap), after
//     s * ks * sm_scale and before the mask, in IEEE float32 (tanhf);
//   - learned attention sinks (sinks != nullptr, GPT-OSS): one float32
//     logit per query head joins the softmax denominator at finalize, as
//     the TPU kernel merges it: m' = max(m, sk), l' = l * exp(m - m') +
//     exp(sk - m'), acc' = acc * exp(m - m'). The sink is a raw logit: not
//     scaled by sm_scale, not capped.
//
// Layout (per layer): K and V pools [S, Hkv, bs, D / pack] (int8 bytes or
// bf16, token-major; pack 2 for INT4), scales [S, Hkv, bs] float32,
// block_table [B, max_blocks]
// int32, seq_lens [B] int32, q [B, Hq, D] float32, sinks [Hq] float32 or
// nullptr, out [B, Hq, D] float32.
//
// Design: one CTA per (lane, kv head). The CTA keeps the G query rows of its
// kv head in shared memory, walks the lane's ceil(seq_len / bs) blocks
// through the table from `first` (never to max_blocks: rows past the last
// block hold the guard slot), converts each [bs, D] K/V tile to float in
// shared memory and runs an online softmax with float32 statistics and a
// float32 accumulator.
// Arithmetic follows the TPU kernel: q is rounded through the compute dtype,
// K scales multiply the scores after q.K, V scales multiply p before PV and
// p * vs is rounded through the compute dtype. Stored values (int8 and int4
// integers, bf16, e4m3) are exact in float, so the products match a bf16
// matmul with f32 accumulation. A lane with seq_len == 0 writes zeros (with a
// sink too: m stays -1e30, so l' = 1 and acc' = 0). Masked tokens get a
// score of -1e30 and p = 0, so a block wholly outside the window leaves m, l
// and the accumulator as they were (alpha = exp(m - m) = 1).
//
// Bound: decode reads every context byte once and does 4 flops per K/V
// element per query head of the group (8 per byte at G = 4 and int8, 16 at
// int4), under the H100's ~20 float32 flops per byte: it is bound by memory
// bytes, and INT4 halves them (the tiles in shared memory stay float). This
// first kernel is simple: one CTA per (lane, kv head) leaves SMs idle at
// small batch, and tiles are not double-buffered. Split-context
// (flash-decoding) grids, cp.async/TMA pipelining and wgmma are later work.

#include <cuda_runtime.h>

#include "kv_tile.cuh"

namespace {

constexpr int NT = 128;       // threads per CTA
constexpr int MAX_G = 8;      // query heads per kv head
constexpr int MAX_ACC = 2;    // head_dim elements per thread: D <= NT * 2
constexpr float NEG_INF = -1e30f;

template <int KIND, bool CD_BF16>
__global__ void __launch_bounds__(NT)
decode_kernel(const float* __restrict__ q, const void* __restrict__ k_pool,
              const void* __restrict__ v_pool, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int* __restrict__ block_table,
              const int* __restrict__ seq_lens,
              const float* __restrict__ sinks, float* __restrict__ out,
              int Hq, int Hkv, int D, int bs, int max_blocks, int window,
              float sm_scale, float softcap) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int DK = D + 1;                       // padded K rows: no bank conflicts
  float* q_s = smem;                          // [G][D]
  float* k_s = q_s + G * D;                   // [bs][D + 1]
  float* v_s = k_s + bs * DK;                 // [bs][D]
  float* p_s = v_s + bs * D;                  // [G][bs] scores, then p * vs
  float* ks_s = p_s + G * bs;                 // [bs]
  float* vs_s = ks_s + bs;                    // [bs]
  float* m_s = vs_s + bs;                     // [G]
  float* l_s = m_s + G;                       // [G]
  float* a_s = l_s + G;                       // [G] a block's / the sink's rescale

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int seq_len = seq_lens[b];
  int nblk = (seq_len + bs - 1) / bs;
  if (nblk > max_blocks) nblk = max_blocks;
  // lowest position the query attends; blocks wholly below it are skipped
  const int lo = window > 0 ? max(seq_len - window, 0) : 0;
  auto valid = [&](int pos) { return pos < seq_len && pos >= lo; };

  const float* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += NT) q_s[i] = round_cd(qb[i], CD_BF16);
  if (tid < G) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }

  float acc[MAX_G][MAX_ACC];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int k = 0; k < MAX_ACC; ++k) acc[g][k] = 0.f;

  for (int blk = lo / bs; blk < nblk; ++blk) {
    const int slot = block_table[(size_t)b * max_blocks + blk];
    const size_t tile = ((size_t)slot * Hkv + h) * bs;
    __syncthreads();                          // smem free from the last block
    load_kv_tiles<KIND, NT>(k_pool, v_pool, tile, k_s, DK, v_s, D, bs, D);
    for (int t = tid; t < bs; t += NT) {
      ks_s[t] = k_scale[tile + t];
      vs_s[t] = v_scale[tile + t];
    }
    __syncthreads();

    // scores: one (query row, token) dot product per thread
    for (int i = tid; i < G * bs; i += NT) {
      const int g = i / bs, t = i % bs;
      const float* qr = q_s + g * D;
      const float* kr = k_s + t * DK;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s = s * ks_s[t] * sm_scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      p_s[i] = valid(blk * bs + t) ? s : NEG_INF;
    }
    __syncthreads();

    // online-softmax statistics, one thread per query row
    if (tid < G) {
      const int g = tid;
      float* row = p_s + g * bs;
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, row[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = valid(blk * bs + t) ? expf(row[t] - mx) : 0.f;
        sum += p;
        row[t] = round_cd(p * vs_s[t], CD_BF16);
      }
      const float alpha = expf(m_prev - mx);
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = mx;
      a_s[g] = alpha;
    }
    __syncthreads();

    // PV: each thread owns head_dim columns tid, tid + NT
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

  // finalize: the sink logit joins max and denominator
  if (tid < G) {
    float a2 = 1.f;
    if (sinks != nullptr) {
      const float sk = sinks[h * G + tid];
      const float m_fin = fmaxf(m_s[tid], sk);
      a2 = expf(m_s[tid] - m_fin);
      l_s[tid] = l_s[tid] * a2 + expf(sk - m_fin);
    }
    a_s[tid] = a2;
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
      ob[g * D + d] = acc[g][k] * a_s[g] / fmaxf(l_s[g], 1e-30f);
    }
  }
}

using Kernel = decltype(&decode_kernel<KV_INT8, false>);

// the instantiation for a storage kind and compute dtype (nullptr: no such
// kind)
Kernel pick(int kind, bool bf16) {
  switch (kind) {
    case KV_INT8: return bf16 ? decode_kernel<KV_INT8, true>
                              : decode_kernel<KV_INT8, false>;
    case KV_BF16: return bf16 ? decode_kernel<KV_BF16, true>
                              : decode_kernel<KV_BF16, false>;
    case KV_FP8: return bf16 ? decode_kernel<KV_FP8, true>
                             : decode_kernel<KV_FP8, false>;
    case KV_INT4: return bf16 ? decode_kernel<KV_INT4, true>
                              : decode_kernel<KV_INT4, false>;
  }
  return nullptr;
}

}  // namespace

// Returns a cudaError_t code (0 = launched). Shapes are checked by the
// Python wrapper: G <= 8, D <= 256 and a multiple of 4 (of 8 for INT4).
// kv_kind is a KvKind (kv_tile.cuh); window <= 0 means no window, softcap
// <= 0 no cap; sinks nullptr no sinks.
extern "C" int paged_attention_launch(
    const float* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int* block_table,
    const int* seq_lens, const float* sinks, float* out, int B, int Hq,
    int Hkv, int D, int bs,
    int max_blocks, int kv_kind, int compute_bf16, int window,
    float sm_scale, float softcap, void* stream) {
  const Kernel kern = pick(kv_kind, compute_bf16 != 0);
  if (!kern || Hq / Hkv > MAX_G || D > NT * MAX_ACC || D % 4 ||
      (kv_kind == KV_INT4 && D % 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)G * D + bs * (D + 1) + (size_t)bs * D +
                       (size_t)G * bs + 2 * bs + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * Hkv, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens, sinks, out,
      Hq, Hkv, D, bs, max_blocks, window, sm_scale, softcap);
  return (int)cudaGetLastError();
}
