// K2: paged chunk attention for T fresh queries per lane (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel `cxl_speckv_tpu/ops/chunk_attention_pallas.py`
// (`paged_chunk_attention_pallas`, body `_chunk_kernel`): batched chunked
// prefill (T up to the prefill chunk) and speculative verify (T = gamma + 1).
// Query t of lane b sits at absolute position start[b] + t and attends
//   - the lane's quantized pool context, positions < start[b], through the
//     block table, scaled as in K1 (ks after q.K, vs on p before PV, p * vs
//     rounded through the compute dtype), in any storage kind K1 reads
//     (`kv_kind`: INT8, BF16, FP8 or INT4, kv_tile.cuh; MIXED8 launches
//     INT8 or FP8 for the layer's scheme id);
//   - the fresh chunk causally (columns s <= t), in IEEE float32 with plain
//     FMAs: k_new / v_new arrive as quantize->dequantized float32, and
//     decode/verify agreement depends on no extra rounding there.
// q is rounded through the compute dtype first and then used in both
// parts, as the TPU kernel does. Per-launch variants, one source for every
// layer:
//   - sliding window (window > 0): query t attends positions
//     > start + t - window, i.e. context pos + window > start + t and fresh
//     columns t - s < window;
//   - tanh softcap (softcap > 0): s = cap * tanh(s / cap) in both parts,
//     after scaling and before the mask (tanhf: the fresh part stays IEEE
//     float32);
//   - learned attention sinks (sinks != nullptr, GPT-OSS): row r = t * G + g
//     of kv head h takes the raw logit sinks[h * G + g] (unscaled, uncapped)
//     into its max and denominator at finalize, as in K1.
// A masked score is -1e30 with p = 0, so a tile that masks a row wholly
// leaves its m, l and accumulator unchanged (alpha = exp(m - m) = 1). With
// a window, context blocks and fresh tiles wholly below the window of the
// row tile's earliest query (its first t) are skipped, the per-tile form
// of the TPU kernel's index-map clamp: retired context blocks (the engine
// frees out-of-window blocks; their table entries may hold stale slots)
// are never read. A lane with start == 0 runs only the fresh part.
//
// Layout: q [B, T, Hq, D] f32, k_new / v_new [B, T, Hkv, D] f32, pools
// [S, Hkv, bs, D / pack] (int8 bytes or bf16; pack 2 for INT4) with scales
// [S, Hkv, bs] f32, block_table [B, max_blocks] int32, start [B] int32,
// sinks [Hq] f32 or nullptr, out [B, T, Hq, D] f32. Rows of a kv head are
// (t, g) pairs, r = t * G + g.
//
// Two kernels, chosen by the launch's compute dtype:
//
// `chunk_mma_kernel` (bf16 compute, the served path). Every stored value
// of every kind is exact in bf16 (int8 and int4 integers, e4m3, bf16), and
// so is q once rounded through bf16, so the context products q.K and
// round(p * vs).V are exact on the tensor cores; only the order of the
// float32 sums differs from the plain version. One CTA per (lane, kv head,
// tile of 64 query rows), four row groups of 16 rows. q is rounded once
// into a bf16 [64][D + 8] tile; each context block is decoded into bf16
// [bs][D + 8] K and V tiles (rows padded by 16 bytes, so that ldmatrix
// reads them without bank conflicts; for bs % 16 != 0 the tiles carry zero
// rows up to the next 16). Per 32 tokens a row group computes S = Q.K^T
// with mma.sync m16n8k16 (bf16 in, f32 accumulate; Q and K through
// ldmatrix), applies ks * sm_scale, the cap and the mask to the
// C-fragments in registers, reduces the row max over the quad by
// shuffles, rescales its accumulator fragments by alpha, packs
// round_bf16(p * vs) straight from the S fragments into A fragments (as
// FlashAttention-2 does) and adds P.V, V through ldmatrix.trans. l sums
// the unrounded p (each thread its own columns, added up at finalize).
// Up to D = 128 a row group is one warp holding all of D's accumulator (4
// warps a CTA). At D = 256 that accumulator (128 floats a thread) spilled,
// so a row group is a warp pair (8 warps): each warp scores 16 of the 32
// tokens and holds every other 8-column n-tile of the accumulator; the
// pair exchanges row maxima, P fragments and finally row sums through
// shared memory at a barrier of its own (bar.sync, 64 threads), so no
// score or exp is computed twice. Beside those, the only barriers are the
// two around each tile load. The fresh part continues the same m, l and
// accumulator in IEEE float32: 16-column tiles of k_new / v_new in float32
// shared memory (over the context tiles' space); each warp computes the
// scores of the fragment elements it owns with FMAs in the order of the
// float32 kernel (both warps of a pair all 16 columns; the first counts
// them in l), p broadcast over the quad by shuffles, and P.V into its
// accumulator n-tiles. Fresh tiles wholly above a row group's last query
// are skipped. The scales load beside their tiles.
//
// `chunk_kernel` (f32 compute): R query rows per CTA (R * D <= 8192), 256
// threads, float32 tiles in shared memory and float32 FMAs for both parts;
// its q is not bf16-exact, and TF32 or a bf16 split would change its
// products.
//
// Bound: at prefill widths the work is operations, not bytes: every K/V
// element read serves up to 64 query rows. At Gemma-2's long chunk (T 256,
// G 2, D 256, ~4.3k tokens of context) the context products are ~37 GFLOP
// a launch, 0.05 ms at the H100's bf16 tensor rate (989 TFLOP/s, 700 W);
// the float32 fresh part is ~1 GFLOP. Tile loads are still synchronous
// (one dependent table load and two barriers a block): cp.async / TMA
// pipelining, wgmma and tensor cores for the fresh part are later work.

#include <cuda_runtime.h>

#include "kv_tile.cuh"
#include "mma_sync.cuh"

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
// fresh-chunk arithmetic (no scales).
template <bool FRESH, typename Valid>
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
      row[t] = FRESH ? p : p * sm.vs[t];
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

template <int KIND>
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

  // q rows of this tile (float32); padded rows 0
  for (int i = tid; i < R * D; i += NT) {
    const int r = r0 + i / D, d = i % D;
    float x = 0.f;
    if (r < rows) {
      const int t = r / G, g = r % G;
      x = q[(((size_t)b * Tn + t) * Hq + (size_t)h * G + g) * D + d];
    }
    sm.q[i] = x;
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
    tile_update<false>(
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
    tile_update<true>(
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

// ---------------------------------------------------------------------------
// bf16 compute: tensor-core context products
// ---------------------------------------------------------------------------

// Four row groups of 16 query rows a CTA. Up to D = 128 (PAIR false) a
// row group is one warp, which scores all 32 tokens of a chunk and holds
// all of D's accumulator (D / 2 floats a thread): 4 warps. At D = 256 that
// accumulator spilled, so (PAIR true) a row group is a warp pair w, w ^ 4:
// of every 32 tokens warp w / 4 == j scores tokens 16 j .. 16 j + 15, and
// of the accumulator it holds the 8-column n-tiles n with n % 2 == j
// (D / 4 floats a thread); the pair exchanges row maxima and P fragments
// through shared memory under a barrier of its own. 8 warps. Pairs at
// D <= 128 were measured slower (one CTA an SM where solo warps fit two).
constexpr int MMA_R = 64;                // query rows per CTA
constexpr int FT = 16;                   // fresh columns per tile

__host__ __device__ constexpr bool mma_pair(int dmax) { return dmax > 128; }
__host__ __device__ constexpr int mma_threads(bool pair) {
  return pair ? 256 : 128;
}

// the barrier of row group rw's warp pair (barrier 0 is __syncthreads)
__device__ __forceinline__ void pair_sync(int rw) {
  asm volatile("bar.sync %0, 64;\n" : : "r"(1 + rw) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Score fragments s[H][2][4] of one warp, H halves of 16 tokens: rows g
// and g + 8 of its row group, element c of n-tile nt in column nt * 8 +
// 2 * tq + (c & 1) of its half, row g + 8 for c >= 2; bit nt * 4 + c of
// ok[half] marks the unmasked ones.

// the row maxima of m and this thread's elements, over the quad
template <int H>
__device__ __forceinline__ void frag_max(const float (&s)[H][2][4], float m0,
                                         float m1, float& mx0, float& mx1) {
  mx0 = m0;
  mx1 = m1;
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    mx0 = fmaxf(mx0, fmaxf(fmaxf(s[hh][0][0], s[hh][0][1]),
                           fmaxf(s[hh][1][0], s[hh][1][1])));
    mx1 = fmaxf(mx1, fmaxf(fmaxf(s[hh][0][2], s[hh][0][3]),
                           fmaxf(s[hh][1][2], s[hh][1][3])));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
}

// The online-softmax step to the row maxima mx0, mx1: l and the nd live
// accumulator n-tiles are rescaled by exp(m - mx), the scores become p
// (0 where masked), and this thread's p join its partial l if `count`.
template <int H, int NDT>
__device__ __forceinline__ void softmax_update(float (&s)[H][2][4],
                                               const uint32_t (&ok)[H],
                                               float mx0, float mx1,
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float (&acc)[NDT][4], int nd,
                                               bool count) {
  const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int hh = 0; hh < H; ++hh)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = (ok[hh] >> (nt * 4 + c)) & 1u
                            ? expf(s[hh][nt][c] - (c < 2 ? mx0 : mx1)) : 0.f;
        if (c < 2) ps0 += p; else ps1 += p;
        s[hh][nt][c] = p;
      }
  l0 = l0 * al0 + (count ? ps0 : 0.f);
  l1 = l1 * al1 + (count ? ps1 : 0.f);
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    if (n < nd) {
      acc[n][0] *= al0; acc[n][1] *= al0;
      acc[n][2] *= al1; acc[n][3] *= al1;
    }
  }
}

template <int KIND, int DMAX, bool PAIR>
__global__ void __launch_bounds__(mma_threads(PAIR), 1)
chunk_mma_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                 const float* __restrict__ v_new,
                 const void* __restrict__ k_pool,
                 const void* __restrict__ v_pool,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ block_table,
                 const int* __restrict__ start_pos,
                 const float* __restrict__ sinks, float* __restrict__ out,
                 int Tn, int Hq, int Hkv, int D, int bs, int max_blocks,
                 int n_tiles, int window, float sm_scale, float softcap) {
  constexpr int THREADS = mma_threads(PAIR);
  constexpr int H = PAIR ? 1 : 2;        // 16-token halves a warp scores
  constexpr int DS = PAIR ? 2 : 1;       // warps sharing an accumulator
  constexpr int NDT = DMAX / 8 / DS;     // accumulator n-tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = Hq / Hkv;
  const int LD = D + 8;                  // bf16 row stride of q, K, V tiles
  const int BT = (bs + 15) & ~15;        // token rows of the K / V tiles
  const int DF = D + 4;                  // float row stride of fresh K
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // the pairs' exchanges (PAIR): a float2 (row maxima, then row sums) and
  // a P fragment a lane of each warp
  float2* xm = reinterpret_cast<float2*>(smem_raw + (size_t)MMA_R * LD * 2);
  uint4* xp = reinterpret_cast<uint4*>(xm + THREADS);
  unsigned char* tiles =
      PAIR ? reinterpret_cast<unsigned char*>(xp + THREADS)
           : reinterpret_cast<unsigned char*>(xm);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(tiles);  // [BT][LD]
  __nv_bfloat16* v_s = k_s + BT * LD;                             // [BT][LD]
  float* ks_s = reinterpret_cast<float*>(v_s + BT * LD);          // [BT]
  float* vs_s = ks_s + BT;                                        // [BT]
  // the fresh part's float32 tiles reuse the context tiles' space
  float* kf_s = reinterpret_cast<float*>(tiles);                  // [FT][DF]
  float* vf_s = kf_s + FT * DF;                                   // [FT][D]

  const int tid = threadIdx.x, lane = tid & 31;
  const int rw = (tid >> 5) & 3;                  // row group
  const int dw = PAIR ? tid >> 7 : 0;             // its warp in the pair
  const int g = lane >> 2, tq = lane & 3;
  const int me = tid, other = tid ^ 128;          // exchange slots
  const int tile_id = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / Hkv, h = bh % Hkv;
  const int r0 = tile_id * MMA_R;             // first row (t * G + g)
  const int rows = Tn * G;
  const int start = start_pos[b];
  // the tile's earliest query t0 attends the lowest positions: context
  // from start + t0 - window + 1, fresh columns from t0 - window + 1
  const int t0 = r0 / G;
  const int ctx_lo = window > 0 ? max(start + t0 - window + 1, 0) : 0;
  const int new_lo = window > 0 ? max(t0 - window + 1, 0) : 0;
  // this thread's fragment rows g and g + 8 of its row group, and their
  // queries
  const int ra0 = r0 + rw * 16 + g, ra1 = ra0 + 8;
  const int qt0 = ra0 / G, qt1 = ra1 / G;
  const bool live = r0 + rw * 16 < rows;      // the pair has a real row
  const int w_last = min(r0 + rw * 16 + 15, rows - 1) / G;
  const int nd = D / 8 / DS;                  // live n-tiles of each warp

  // q rows, rounded to bf16 once; padded rows 0
  for (int i = tid * 4; i < MMA_R * D; i += THREADS * 4) {
    const int r = i / D, d = i % D;
    const int ra = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ra < rows) {
      const int t = ra / G, gg = ra % G;
      x = *reinterpret_cast<const float4*>(
          q + (((size_t)b * Tn + t) * Hq + (size_t)h * G + gg) * D + d);
    }
    *reinterpret_cast<uint2*>(q_s + r * LD + d) =
        make_uint2(bf16x2(x.x, x.y), bf16x2(x.z, x.w));
  }
  // K / V rows bs .. BT - 1 stay zero (their p is 0, and 0 * 0 adds nothing)
  for (int i = tid; i < (BT - bs) * LD; i += THREADS) {
    reinterpret_cast<unsigned short*>(k_s)[bs * LD + i] = 0;
    reinterpret_cast<unsigned short*>(v_s)[bs * LD + i] = 0;
  }

  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // m is the same in both warps of a pair; l sums this thread's columns
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // ldmatrix row addresses of this lane: Q rows of the row group (A
  // fragments), K token rows (B of Q.K^T), V token rows of the warp's
  // first accumulator n-tile (B of P.V, transposed); its n-th n-tile holds
  // columns (n * DS + dw) * 8 .. + 7
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t q_addr =
      smem_u32(q_s + (rw * 16 + mr + (mi & 1) * 8) * LD + (mi >> 1) * 8);
  const uint32_t k_addr =
      smem_u32(k_s + ((mi >> 1) * 8 + mr) * LD + (mi & 1) * 8);
  const uint32_t v_addr = smem_u32(v_s + ((mi & 1) * 8 + mr) * LD + dw * 8);

  // ---- pool context: positions < start, on the tensor cores ----
  int nblk = (start + bs - 1) / bs;
  if (nblk > max_blocks) nblk = max_blocks;
  for (int blk = ctx_lo / bs; blk < nblk; ++blk) {
    const int slot = block_table[(size_t)b * max_blocks + blk];
    const size_t tile = ((size_t)slot * Hkv + h) * bs;
    // the scales load beside the tiles, in the same round trip
    float ksc = 0.f, vsc = 0.f;
    if (tid < bs) {
      ksc = k_scale[tile + tid];
      vsc = v_scale[tile + tid];
    }
    __syncthreads();
    load_kv_tiles_bf16<KIND, THREADS>(k_pool, v_pool, tile, k_s, v_s, LD, bs,
                                      D);
    if (tid < bs) {
      ks_s[tid] = ksc;
      vs_s[tid] = vsc;
    }
    for (int t = tid + THREADS; t < bs; t += THREADS) {
      ks_s[t] = k_scale[tile + t];
      vs_s[t] = v_scale[tile + t];
    }
    __syncthreads();
    if (!live) continue;
    const int pos0 = blk * bs;
    for (int c0 = 0; c0 < BT; c0 += 32) {
      const int nk = min(2, (BT - c0) >> 4);   // halves of 16 tokens: 1, 2
      bool own[H];                             // the warp has tokens there
      int tb[H];                               // their first token
      float s[H][2][4];
#pragma unroll
      for (int hh = 0; hh < H; ++hh) {
        own[hh] = dw * H + hh < nk;
        tb[hh] = c0 + (dw * H + hh) * 16;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          s[hh][nt][0] = s[hh][nt][1] = s[hh][nt][2] = s[hh][nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (kk * 16 < D && own[0]) {
          uint32_t a[4];
          ldsm_x4(a, q_addr + kk * 32);
#pragma unroll
          for (int hh = 0; hh < H; ++hh) {
            if (own[hh]) {
              uint32_t kb[4];
              ldsm_x4(kb, k_addr + tb[hh] * LD * 2 + kk * 32);
              mma_bf16(s[hh][0], a, kb[0], kb[1]);
              mma_bf16(s[hh][1], a, kb[2], kb[3]);
            }
          }
        }
      }
      // scale, cap and mask in registers (a warp's tokens are < BT)
      uint32_t ok[H];
#pragma unroll
      for (int hh = 0; hh < H; ++hh) {
        ok[hh] = 0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int tok = tb[hh] + nt * 8 + 2 * tq + (c & 1);
            const int pos = pos0 + tok;
            bool v = false;
            float x = NEG_INF;
            if (own[hh]) {
              x = s[hh][nt][c] * ks_s[tok] * sm_scale;
              if (softcap > 0.f) x = softcap * tanhf(x / softcap);
              v = tok < bs && pos < start &&
                  (window <= 0 ||
                   pos + window > start + (c < 2 ? qt0 : qt1));
            }
            s[hh][nt][c] = v ? x : NEG_INF;
            ok[hh] |= (uint32_t)v << (nt * 4 + c);
          }
        }
      }
      float mx0, mx1;
      frag_max(s, m0, m1, mx0, mx1);
      if constexpr (PAIR) {                    // the pair's row maxima
        xm[me] = make_float2(mx0, mx1);
        pair_sync(rw);
        const float2 om = xm[other];
        mx0 = fmaxf(mx0, om.x);
        mx1 = fmaxf(mx1, om.y);
      }
      softmax_update(s, ok, mx0, mx1, m0, m1, l0, l1, acc, nd, true);
      // the P fragment of each half, round(p * vs)
      uint4 pa[H];
#pragma unroll
      for (int hh = 0; hh < H; ++hh) {
        float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (own[hh]) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int tok = tb[hh] + nt * 8 + 2 * tq + (c & 1);
              if ((ok[hh] >> (nt * 4 + c)) & 1u)
                pv[nt][c] = s[hh][nt][c] * vs_s[tok];
            }
        }
        pa[hh] = make_uint4(bf16x2(pv[0][0], pv[0][1]),
                            bf16x2(pv[0][2], pv[0][3]),
                            bf16x2(pv[1][0], pv[1][1]),
                            bf16x2(pv[1][2], pv[1][3]));
      }
      if constexpr (PAIR) {
        xp[me] = pa[0];
        pair_sync(rw);
      }
      // P.V over the chunk's tokens, into the warp's accumulator n-tiles
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        if (kc < nk) {
          uint4 f;
          if constexpr (PAIR) f = kc == dw ? pa[0] : xp[other];
          else f = pa[kc];
          const uint32_t a[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int n = 0; n < NDT; ++n) {
            if (n < nd) {
              uint32_t vb[2];
              ldsm_x2_t(vb, v_addr + (c0 + kc * 16) * LD * 2 + n * DS * 16);
              mma_bf16(acc[n], a, vb[0], vb[1]);
            }
          }
        }
      }
    }
  }

  // ---- fresh chunk: causal, IEEE float32 ----
  // both warps of a pair score all 16 columns of a tile (the same m); the
  // first counts them into l
  const int t_last = (min(r0 + MMA_R, rows) - 1) / G;
  const __nv_bfloat16* q0 = q_s + (rw * 16 + g) * LD;
  const __nv_bfloat16* q1 = q0 + 8 * LD;
  for (int s0 = new_lo / FT * FT; s0 <= t_last; s0 += FT) {
    __syncthreads();
    for (int i = tid * 4; i < FT * D; i += THREADS * 4) {
      const int j = i / D, d = i % D;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (s0 + j < Tn) {
        const size_t off = (((size_t)b * Tn + s0 + j) * Hkv + h) * D + d;
        kv = *reinterpret_cast<const float4*>(k_new + off);
        vv = *reinterpret_cast<const float4*>(v_new + off);
      }
      *reinterpret_cast<float4*>(kf_s + j * DF + d) = kv;
      *reinterpret_cast<float4*>(vf_s + i) = vv;
    }
    __syncthreads();
    if (!live || s0 > w_last) continue;
    // scores of this thread's fragment elements: columns 2tq, 2tq + 1,
    // 8 + 2tq, 9 + 2tq of rows g and g + 8, summed over d in order
    float s[1][2][4] = {{{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}}};
    // K row of element column (k & 1) + (k >> 1) * 8 + 2tq
    const float* kr = kf_s + 2 * tq * DF;
    for (int d = 0; d < D; d += 4) {
      const uint2 qa = *reinterpret_cast<const uint2*>(q0 + d);
      const uint2 qb = *reinterpret_cast<const uint2*>(q1 + d);
      const float2 a01 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qa.x));
      const float2 a23 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qa.y));
      const float2 b01 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qb.x));
      const float2 b23 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qb.y));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 kk = *reinterpret_cast<const float4*>(
            kr + ((k & 1) + (k >> 1) * 8) * DF + d);
        float& x = s[0][k >> 1][k & 1];
        x = fmaf(a01.x, kk.x, x); x = fmaf(a01.y, kk.y, x);
        x = fmaf(a23.x, kk.z, x); x = fmaf(a23.y, kk.w, x);
        float& y = s[0][k >> 1][2 + (k & 1)];
        y = fmaf(b01.x, kk.x, y); y = fmaf(b01.y, kk.y, y);
        y = fmaf(b23.x, kk.z, y); y = fmaf(b23.y, kk.w, y);
      }
    }
    uint32_t ok[1] = {0};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = s0 + nt * 8 + 2 * tq + (c & 1);
        const int ra = c < 2 ? ra0 : ra1, qt = c < 2 ? qt0 : qt1;
        float x = s[0][nt][c] * sm_scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool v = ra < rows && col < Tn && col <= qt &&
                       (window <= 0 || qt - col < window);
        s[0][nt][c] = v ? x : NEG_INF;
        ok[0] |= (uint32_t)v << (nt * 4 + c);
      }
    }
    float mx0, mx1;
    frag_max(s, m0, m1, mx0, mx1);
    softmax_update(s, ok, mx0, mx1, m0, m1, l0, l1, acc, nd, dw == 0);
    // P.V in float32: p of column j comes from the quad lane that owns it
#pragma unroll
    for (int j = 0; j < FT; ++j) {
      const int src = (lane & ~3) | ((j & 7) >> 1);
      const float pg = __shfl_sync(0xffffffffu, s[0][j >> 3][j & 1], src);
      const float ph =
          __shfl_sync(0xffffffffu, s[0][j >> 3][2 + (j & 1)], src);
      const float* vr = vf_s + j * D + dw * 8 + 2 * tq;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        if (n < nd) {
          const float2 vv =
              *reinterpret_cast<const float2*>(vr + n * DS * 8);
          acc[n][0] = fmaf(pg, vv.x, acc[n][0]);
          acc[n][1] = fmaf(pg, vv.y, acc[n][1]);
          acc[n][2] = fmaf(ph, vv.x, acc[n][2]);
          acc[n][3] = fmaf(ph, vv.y, acc[n][3]);
        }
      }
    }
  }
  if (!live) return;

  // finalize: the row sums of the quad and of the pair, then row r's sink
  // logit joins its max and denominator; padded rows are not written
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if constexpr (PAIR) {
    xm[me] = make_float2(l0, l1);
    pair_sync(rw);
    const float2 ol = xm[other];
    l0 += ol.x;
    l1 += ol.y;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ra = half ? ra1 : ra0;
    if (ra >= rows) continue;
    float m = half ? m1 : m0, l = half ? l1 : l0, a2 = 1.f;
    if (sinks != nullptr) {
      const float sk = sinks[h * G + ra % G];
      const float m_fin = fmaxf(m, sk);
      a2 = expf(m - m_fin);
      l = l * a2 + expf(sk - m_fin);
    }
    const float den = fmaxf(l, 1e-30f);
    const int t = ra / G, gg = ra % G;
    float* o = out + (((size_t)b * Tn + t) * Hq + (size_t)h * G + gg) * D +
               dw * 8 + 2 * tq;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n < nd)
        *reinterpret_cast<float2*>(o + n * DS * 8) =
            make_float2(acc[n][2 * half] * a2 / den,
                        acc[n][2 * half + 1] * a2 / den);
    }
  }
}

using Kernel = decltype(&chunk_kernel<KV_INT8>);
using MmaKernel = decltype(&chunk_mma_kernel<KV_INT8, 64, false>);

// the float32-compute instantiation for a storage kind (nullptr: no such
// kind)
Kernel pick(int kind) {
  switch (kind) {
    case KV_INT8: return chunk_kernel<KV_INT8>;
    case KV_BF16: return chunk_kernel<KV_BF16>;
    case KV_FP8: return chunk_kernel<KV_FP8>;
    case KV_INT4: return chunk_kernel<KV_INT4>;
  }
  return nullptr;
}

template <int DMAX>
MmaKernel pick_mma_d(int kind) {
  constexpr bool P = mma_pair(DMAX);
  switch (kind) {
    case KV_INT8: return chunk_mma_kernel<KV_INT8, DMAX, P>;
    case KV_BF16: return chunk_mma_kernel<KV_BF16, DMAX, P>;
    case KV_FP8: return chunk_mma_kernel<KV_FP8, DMAX, P>;
    case KV_INT4: return chunk_mma_kernel<KV_INT4, DMAX, P>;
  }
  return nullptr;
}

// the accumulator size class of a head dim (0: none fits)
int mma_dmax(int D) {
  if (D % 16 || D <= 0 || D > 256) return 0;
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// the bf16-compute instantiation for a storage kind and head dim (nullptr:
// none)
MmaKernel pick_mma(int kind, int D) {
  switch (mma_dmax(D)) {
    case 64: return pick_mma_d<64>(kind);
    case 128: return pick_mma_d<128>(kind);
    case 256: return pick_mma_d<256>(kind);
  }
  return nullptr;
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kern,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)
             : cudaSuccess;
}

}  // namespace

// Returns a cudaError_t code (0 = launched). compute_bf16 != 0 launches
// the tensor-core kernel, which needs R == 64 and D % 16 == 0, D <= 256;
// otherwise the float32 kernel, with R query rows per CTA, R * D <= 8192
// and D % 4 == 0 (% 8 for INT4). kv_kind is a KvKind (kv_tile.cuh);
// window <= 0 means no window, softcap <= 0 no cap; sinks nullptr no sinks.
extern "C" int chunk_attention_launch(
    const float* q, const float* k_new, const float* v_new,
    const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* block_table, const int* start_pos,
    const float* sinks, float* out, int B, int Tn, int Hq, int Hkv, int D,
    int bs,
    int max_blocks, int R, int kv_kind, int compute_bf16, int window,
    float sm_scale, float softcap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  if (compute_bf16) {
    const MmaKernel kern = pick_mma(kv_kind, D);
    if (!kern || R != MMA_R || bs <= 0 || bs % 8)
      return (int)cudaErrorInvalidValue;
    if (B == 0 || Tn == 0) return 0;
    const int n_tiles = (Tn * G + MMA_R - 1) / MMA_R;
    const size_t LD = D + 8, BT = (bs + 15) & ~15;
    const size_t ctx = 2 * BT * LD * 2 + 2 * BT * sizeof(float);
    const size_t fresh = sizeof(float) * ((size_t)FT * (D + 4) + (size_t)FT * D);
    const bool pair = mma_pair(mma_dmax(D));
    const int threads = mma_threads(pair);
    const size_t xchg = pair ? threads * (sizeof(float2) + sizeof(uint4)) : 0;
    const size_t smem =
        (size_t)MMA_R * LD * 2 + xchg + (ctx > fresh ? ctx : fresh);
    cudaError_t e = set_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<B * Hkv * n_tiles, threads, smem, st>>>(
        q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, block_table,
        start_pos, sinks, out, Tn, Hq, Hkv, D, bs, max_blocks, n_tiles,
        window, sm_scale, softcap);
    return (int)cudaGetLastError();
  }
  const Kernel kern = pick(kv_kind);
  if (!kern || R * D > NT * MAX_ACC || D % 4 || R <= 0 ||
      (kv_kind == KV_INT4 && D % 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tn == 0) return 0;
  const int n_tiles = (Tn * G + R - 1) / R;
  const size_t smem =
      sizeof(float) * ((size_t)R * D + (size_t)bs * (D + 1) + (size_t)bs * D +
                       (size_t)R * (bs + 1) + 2 * bs + 3 * R);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B * Hkv * n_tiles, NT, smem, st>>>(
      q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, block_table,
      start_pos, sinks, out, Tn, Hq, Hkv, D, bs, max_blocks, R, n_tiles,
      window, sm_scale, softcap);
  return (int)cudaGetLastError();
}
