// K2: paged chunk attention for T fresh queries per lane (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `cxl_speckv_tpu/ops/chunk_attention_pallas.py`
// (`paged_chunk_attention_pallas`, body `_chunk_kernel`): batched chunked
// prefill (T up to the prefill chunk) and speculative verify (T = gamma + 1).
// Query t of lane b sits at absolute position start[b] + t and attends
//   - the lane's quantized pool context, positions < start[b], through the
//     block table, scaled as in K1 (ks after q.K, vs on p before PV, p * vs
//     rounded through the compute dtype), in any storage kind K1 reads
//     (`kv_kind`: INT8, BF16, FP8 or INT4, with the same tile loader,
//     kv_tile.cuh; MIXED8 launches INT8 or FP8 for the layer's scheme id);
//   - the fresh chunk causally (columns s <= t), in IEEE float32 with plain
//     FMAs: k_new / v_new arrive as quantize->dequantized float32, and
//     decode/verify agreement depends on no extra rounding there.
// q is rounded through the compute dtype first and then used as float32 in
// both parts, as the TPU kernel does. Per-launch variants, one source for
// every layer:
//   - sliding window (window > 0): query t attends positions
//     > start + t - window, i.e. context pos + window > start + t and fresh
//     columns t - s < window;
//   - tanh softcap (softcap > 0): s = cap * tanh(s / cap) in both parts,
//     after scaling and before the mask (tanhf: the fresh part stays IEEE
//     float32);
//   - learned attention sinks (sinks != nullptr, GPT-OSS): row r = t * G + g
//     of kv head h takes the raw logit sinks[h * G + g] (unscaled, uncapped)
//     into its max and denominator at finalize, as in K1.
// `tile_update`'s `valid` is the one place where both masks go.
//
// Layout: q [B, T, Hq, D] f32, k_new / v_new [B, T, Hkv, D] f32, pools
// [S, Hkv, bs, D / pack] (int8 bytes or bf16; pack 2 for INT4) with scales
// [S, Hkv, bs] f32, block_table
// [B, max_blocks] int32, start [B] int32, sinks [Hq] f32 or nullptr,
// out [B, T, Hq, D] f32.
//
// Design: one CTA per (lane, kv head, tile of R query rows), the rows of a
// kv head being (t, g) pairs, r = t * G + g. The CTA streams context blocks
// and then fresh column tiles of bs tokens through shared memory with an
// online softmax (float32 statistics and accumulator). Fresh tiles wholly
// above the row tile's last token are skipped. With a window, context
// blocks and fresh tiles wholly below the window of the row tile's earliest
// query (its first t) are skipped too, the per-tile form of the TPU kernel's
// index-map clamp: retired context blocks (the engine frees out-of-window
// blocks; their table entries may hold stale slots) are never read. A
// masked score is -1e30 with p = 0, so a tile that masks a row wholly
// leaves its m, l and accumulator unchanged (alpha = exp(m - m) = 1). A
// lane with start == 0 runs only the fresh part.
//
// Bound: at prefill widths (T = 64-128, G = 4) the work is operations, not
// bytes: every K/V element read serves R query rows. This first kernel does
// them as float32 FMAs from shared memory; tensor-core (wgmma) tiles for the
// context part, and a pipelined load of the next tile, are later work. The
// fresh part must stay IEEE float32 either way. Tiles are float in shared
// memory whatever the storage, so INT4 needs no more of it than INT8 (at
// Gemma-2's D = 256, R = 32: 103 KB).

#include <cuda_runtime.h>

#include "kv_tile.cuh"

namespace {

constexpr int NT = 256;         // threads per CTA
constexpr int MAX_ACC = 32;     // accumulator elements per thread: R*D <= 8192
constexpr float NEG_INF = -1e30f;

// four consecutive fresh float32 elements
__device__ __forceinline__ void load4(const float* p, float* o) {
  float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

struct Smem {
  float *q, *k, *v, *p, *ks, *vs, *m, *l, *a;
};

// One online-softmax update of the CTA's rows against a [bs]-token tile
// already in shared memory. valid(r, t) masks the tile; FRESH selects the
// float32 fresh-chunk arithmetic (no scales, no compute-dtype rounding).
template <bool CD_BF16, bool FRESH, typename Valid>
__device__ __forceinline__ void tile_update(const Smem& sm, float (&acc)[MAX_ACC],
                                            int R, int D, int bs,
                                            float sm_scale, float softcap,
                                            Valid valid) {
  const int tid = threadIdx.x;
  const int DK = D + 1;
  const int PB = bs + 1;
  for (int i = tid; i < R * bs; i += NT) {
    const int r = i / bs, t = i % bs;
    const float* qr = sm.q + r * D;
    const float* kr = sm.k + t * DK;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    s = FRESH ? s * sm_scale : s * sm.ks[t] * sm_scale;
    if (softcap > 0.f) s = softcap * tanhf(s / softcap);
    sm.p[r * PB + t] = valid(r, t) ? s : NEG_INF;
  }
  __syncthreads();
  for (int r = tid; r < R; r += NT) {
    float* row = sm.p + r * PB;
    const float m_prev = sm.m[r];
    float mx = m_prev;
    for (int t = 0; t < bs; ++t) mx = fmaxf(mx, row[t]);
    float sum = 0.f;
    for (int t = 0; t < bs; ++t) {
      const float p = valid(r, t) ? expf(row[t] - mx) : 0.f;
      sum += p;
      row[t] = FRESH ? p : round_cd(p * sm.vs[t], CD_BF16);
    }
    const float alpha = expf(m_prev - mx);
    sm.l[r] = sm.l[r] * alpha + sum;
    sm.m[r] = mx;
    sm.a[r] = alpha;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MAX_ACC; ++k) {
    const int e = tid + k * NT;
    const int r = e / D, d = e % D;
    if (r >= R) break;
    const float* pr = sm.p + r * PB;
    float a = acc[k] * sm.a[r];
    for (int t = 0; t < bs; ++t) a = fmaf(pr[t], sm.v[t * D + d], a);
    acc[k] = a;
  }
}

template <int KIND, bool CD_BF16>
__global__ void __launch_bounds__(NT)
chunk_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
             const float* __restrict__ v_new, const void* __restrict__ k_pool,
             const void* __restrict__ v_pool, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const int* __restrict__ block_table,
             const int* __restrict__ start_pos,
             const float* __restrict__ sinks, float* __restrict__ out,
             int Tn, int Hq, int Hkv, int D, int bs, int max_blocks, int R,
             int n_tiles, int window, float sm_scale, float softcap) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int DK = D + 1;
  Smem sm;
  sm.q = smem;                      // [R][D]
  sm.k = sm.q + R * D;              // [bs][D + 1]
  sm.v = sm.k + bs * DK;            // [bs][D]
  sm.p = sm.v + bs * D;             // [R][bs + 1]
  sm.ks = sm.p + R * (bs + 1);      // [bs]
  sm.vs = sm.ks + bs;               // [bs]
  sm.m = sm.vs + bs;                // [R]
  sm.l = sm.m + R;                  // [R]
  sm.a = sm.l + R;                  // [R]

  const int tid = threadIdx.x;
  const int tile_id = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / Hkv, h = bh % Hkv;
  const int r0 = tile_id * R;                 // first row (t * G + g)
  const int rows = Tn * G;
  const int start = start_pos[b];
  // the tile's earliest query t0 attends the lowest positions: context
  // from start + t0 - window + 1, fresh columns from t0 - window + 1
  const int t0 = r0 / G;
  const int ctx_lo = window > 0 ? max(start + t0 - window + 1, 0) : 0;
  const int new_lo = window > 0 ? max(t0 - window + 1, 0) : 0;

  // q rows of this tile, rounded through the compute dtype; padded rows 0
  for (int i = tid; i < R * D; i += NT) {
    const int r = r0 + i / D, d = i % D;
    float x = 0.f;
    if (r < rows) {
      const int t = r / G, g = r % G;
      x = q[(((size_t)b * Tn + t) * Hq + (size_t)h * G + g) * D + d];
    }
    sm.q[i] = round_cd(x, CD_BF16);
  }
  for (int r = tid; r < R; r += NT) { sm.m[r] = NEG_INF; sm.l[r] = 0.f; }

  float acc[MAX_ACC];
#pragma unroll
  for (int k = 0; k < MAX_ACC; ++k) acc[k] = 0.f;

  // ---- pool context: positions < start ----
  int nblk = (start + bs - 1) / bs;
  if (nblk > max_blocks) nblk = max_blocks;
  for (int blk = ctx_lo / bs; blk < nblk; ++blk) {
    const int slot = block_table[(size_t)b * max_blocks + blk];
    const size_t tile = ((size_t)slot * Hkv + h) * bs;
    __syncthreads();
    load_kv_tiles<KIND, NT>(k_pool, v_pool, tile, sm.k, DK, sm.v, D, bs, D);
    for (int t = tid; t < bs; t += NT) {
      sm.ks[t] = k_scale[tile + t];
      sm.vs[t] = v_scale[tile + t];
    }
    __syncthreads();
    const int pos0 = blk * bs;
    tile_update<CD_BF16, false>(
        sm, acc, R, D, bs, sm_scale, softcap, [&](int r, int t) {
          const int pos = pos0 + t;
          return pos < start &&
                 (window <= 0 || pos + window > start + (r0 + r) / G);
        });
  }

  // ---- fresh chunk: causal, IEEE float32 ----
  const int r_last = min(r0 + R, rows) - 1;
  const int t_last = r_last / G;
  for (int s0 = new_lo / bs * bs; s0 <= t_last; s0 += bs) {
    __syncthreads();
    for (int i = tid * 4; i < bs * D; i += NT * 4) {
      const int j = i / D, d = i % D;
      const int s = s0 + j;
      float kv[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (s < Tn) {
        const size_t off = (((size_t)b * Tn + s) * Hkv + h) * D + d;
        load4(k_new + off, kv);
        load4(v_new + off, vv);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sm.k[j * DK + d + c] = kv[c];
        sm.v[i + c] = vv[c];
      }
    }
    __syncthreads();
    tile_update<CD_BF16, true>(
        sm, acc, R, D, bs, sm_scale, softcap, [&](int r, int j) {
          const int ra = r0 + r;
          const int s = s0 + j;
          return ra < rows && s < Tn && s <= ra / G &&
                 (window <= 0 || ra / G - s < window);
        });
  }
  __syncthreads();

  // finalize: row r's sink logit joins its max and denominator
  for (int r = tid; r < R; r += NT) {
    float a2 = 1.f;
    if (sinks != nullptr && r0 + r < rows) {
      const float sk = sinks[h * G + (r0 + r) % G];
      const float m_fin = fmaxf(sm.m[r], sk);
      a2 = expf(sm.m[r] - m_fin);
      sm.l[r] = sm.l[r] * a2 + expf(sk - m_fin);
    }
    sm.a[r] = a2;
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < MAX_ACC; ++k) {
    const int e = tid + k * NT;
    const int r = e / D, d = e % D;
    if (r >= R) break;
    const int ra = r0 + r;
    if (ra >= rows) continue;
    const int t = ra / G, g = ra % G;
    out[(((size_t)b * Tn + t) * Hq + (size_t)h * G + g) * D + d] =
        acc[k] * sm.a[r] / fmaxf(sm.l[r], 1e-30f);
  }
}

using Kernel = decltype(&chunk_kernel<KV_INT8, false>);

// the instantiation for a storage kind and compute dtype (nullptr: no such
// kind)
Kernel pick(int kind, bool bf16) {
  switch (kind) {
    case KV_INT8: return bf16 ? chunk_kernel<KV_INT8, true>
                              : chunk_kernel<KV_INT8, false>;
    case KV_BF16: return bf16 ? chunk_kernel<KV_BF16, true>
                              : chunk_kernel<KV_BF16, false>;
    case KV_FP8: return bf16 ? chunk_kernel<KV_FP8, true>
                             : chunk_kernel<KV_FP8, false>;
    case KV_INT4: return bf16 ? chunk_kernel<KV_INT4, true>
                              : chunk_kernel<KV_INT4, false>;
  }
  return nullptr;
}

}  // namespace

// Returns a cudaError_t code (0 = launched). R is the query rows per CTA;
// the Python wrapper checks R * D <= 8192 and D a multiple of 4 (of 8 for
// INT4). kv_kind is a KvKind (kv_tile.cuh); window <= 0 means no window,
// softcap <= 0 no cap; sinks nullptr no sinks.
extern "C" int chunk_attention_launch(
    const float* q, const float* k_new, const float* v_new,
    const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* block_table, const int* start_pos,
    const float* sinks, float* out, int B, int Tn, int Hq, int Hkv, int D,
    int bs,
    int max_blocks, int R, int kv_kind, int compute_bf16, int window,
    float sm_scale, float softcap, void* stream) {
  const Kernel kern = pick(kv_kind, compute_bf16 != 0);
  if (!kern || R * D > NT * MAX_ACC || D % 4 || R <= 0 ||
      (kv_kind == KV_INT4 && D % 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tn == 0) return 0;
  const int G = Hq / Hkv;
  const int n_tiles = (Tn * G + R - 1) / R;
  const size_t smem =
      sizeof(float) * ((size_t)R * D + (size_t)bs * (D + 1) + (size_t)bs * D +
                       (size_t)R * (bs + 1) + 2 * bs + 3 * R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * Hkv * n_tiles, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, block_table,
      start_pos, sinks, out, Tn, Hq, Hkv, D, bs, max_blocks, R, n_tiles,
      window, sm_scale, softcap);
  return (int)cudaGetLastError();
}
