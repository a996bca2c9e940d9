// P3: a ring of asynchronous copies keeping nbuf blocks in flight (Hopper,
// sm_90a).
//
// Replaces the Pallas TPU probe `scripts/kernel_anatomy.py:462`
// (`run_v5.<locals>.loop`, body `v5_kernel`, `:389-445`): a manual
// make_async_copy ring with DMA semaphores, nbuf blocks of K, V and both
// scales in flight, and one token row of each tile summed (`compute ==
// "row"`, `:421-424`). Here a ring of NBUF stages in dynamic shared memory,
// each holding one block's K tile, V tile and both scale rows of the CTA's
// kv head, is filled with 16-byte `cp.async.cg` copies, one commit group a
// block; `cp.async.wait_group<NBUF - 1>` (an immediate, hence the template
// parameter) waits for the oldest block while NBUF - 1 more stay in flight,
// and the stage is refilled with block i + NBUF once every thread has read
// it. For the CTA's kv head h of lane b it computes the float32 sum over the
// lane's blocks of token row 0 of the K tile and of the V tile (the stored
// elements as numbers: int8 bytes, INT4 packed bytes read as int8, bf16
// values) -- the same function as P1's fetchrow.
//
// Why K1's grid, one CTA per (lane, kv head), and not the TPU's (B,): the
// TPU has one core that runs the grid in order, while (B,) on the card
// would give 8 CTAs at the probe's batch and leave 124 of 132 SMs idle.
// Pools as in K1: token-major K, V [S, Hkv, bs, D/pack], scales
// [S, Hkv, bs]. A stage is 2 * bs * row_bytes + 8 * bs bytes (8 KB + 256 B
// at bs 32, D 128, INT8); a ring that does not fit in the 227 KB a block
// may have is refused (nbuf 16 at BF16 needs ~264 KB). Bound: the bytes of
// the blocks copied (K, V and both scales once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int NBUF, bool BF16>
__global__ void __launch_bounds__(NT)
ring_kernel(const char* __restrict__ k_pool, const char* __restrict__ v_pool,
            const char* __restrict__ k_scale, const char* __restrict__ v_scale,
            const int* __restrict__ block_table,
            const int* __restrict__ seq_lens, float* __restrict__ out, int Hkv,
            int bs, int row_bytes, int max_blocks) {
  extern __shared__ uint4 ring[];
  __shared__ float red[NT / 32];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  int nblk = (seq_lens[b] + bs - 1) / bs;
  if (nblk > max_blocks) nblk = max_blocks;
  const int tile_vec = bs * row_bytes / 16;   // 16-byte vectors a tile
  const int sc_vec = bs * 4 / 16;             // a scale row
  const int stage_vec = 2 * tile_vec + 2 * sc_vec;

  // every thread copies its share of block `blk` into stage `st`
  auto copy_block = [&](int blk, int st) {
    const int slot = block_table[(size_t)b * max_blocks + blk];
    const size_t tile = ((size_t)slot * Hkv + h) * bs;
    const char* src[4] = {k_pool + tile * row_bytes, v_pool + tile * row_bytes,
                          k_scale + tile * 4, v_scale + tile * 4};
    uint4* dst = ring + (size_t)st * stage_vec;
    for (int i = tid; i < stage_vec; i += NT) {
      const int part = i < tile_vec ? 0 : i < 2 * tile_vec ? 1
                     : i < 2 * tile_vec + sc_vec ? 2 : 3;
      const int off = part < 2 ? i - part * tile_vec
                               : i - 2 * tile_vec - (part - 2) * sc_vec;
      cp_async16(dst + i, src[part] + (size_t)off * 16);
    }
  };

  // fill the ring; one commit group a stage, empty ones too, so that group
  // i always holds block i
  for (int w = 0; w < NBUF; ++w) {
    if (w < nblk) copy_block(w, w);
    cp_async_commit();
  }
  float acc = 0.f;
  const int row_elems = row_bytes / (BF16 ? 2 : 1);
  for (int i = 0; i < nblk; ++i) {
    const int st = i % NBUF;
    cp_async_wait<NBUF - 1>();                // block i has landed
    __syncthreads();
    const char* stage = reinterpret_cast<const char*>(ring + (size_t)st * stage_vec);
    for (int e = tid; e < row_elems; e += NT) {
      if constexpr (BF16) {
        const uint16_t* k = reinterpret_cast<const uint16_t*>(stage);
        const uint16_t* v = reinterpret_cast<const uint16_t*>(
            stage + (size_t)tile_vec * 16);
        acc += __uint_as_float((uint32_t)k[e] << 16) +
               __uint_as_float((uint32_t)v[e] << 16);
      } else {
        acc += (float)(int8_t)stage[e] +
               (float)(int8_t)stage[(size_t)tile_vec * 16 + e];
      }
    }
    __syncthreads();                          // the stage is free again
    if (i + NBUF < nblk) copy_block(i + NBUF, st);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (tid % 32 == 0) red[tid / 32] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += red[w];
    out[blockIdx.x] = s;
  }
}

using Kernel = decltype(&ring_kernel<4, false>);

Kernel pick(int nbuf, bool bf16) {
  switch (nbuf) {
    case 4: return bf16 ? ring_kernel<4, true> : ring_kernel<4, false>;
    case 8: return bf16 ? ring_kernel<8, true> : ring_kernel<8, false>;
    case 16: return bf16 ? ring_kernel<16, true> : ring_kernel<16, false>;
  }
  return nullptr;
}

}  // namespace

// Returns a cudaError_t code (0 = launched). nbuf is 4, 8 or 16; elem_bytes
// 1 (int8 / INT4 bytes) or 2 (bf16); row_bytes = D / pack * elem_bytes, a
// multiple of 16; bs % 4 == 0 (a scale row is whole 16-byte vectors). out
// [B, Hkv] float32. The Python wrapper refuses a ring above 227 KB; the
// launch returns cudaErrorInvalidValue for one too.
extern "C" int anatomy_ring_launch(
    const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* block_table, const int* seq_lens,
    float* out, int B, int Hkv, int bs, int row_bytes, int max_blocks,
    int elem_bytes, int nbuf, void* stream) {
  const Kernel kern = pick(nbuf, elem_bytes == 2);
  const size_t smem = (size_t)nbuf * (2 * (size_t)bs * row_bytes + 8 * (size_t)bs);
  if (!kern || row_bytes % 16 || bs % 4 || (elem_bytes != 1 && elem_bytes != 2) ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * Hkv, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(k_pool), static_cast<const char*>(v_pool),
      reinterpret_cast<const char*>(k_scale),
      reinterpret_cast<const char*>(v_scale), block_table, seq_lens, out, Hkv,
      bs, row_bytes, max_blocks);
  return (int)cudaGetLastError();
}
