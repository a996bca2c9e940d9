// P3: a ring of bulk copies keeping nbuf blocks in flight (Hopper, sm_90a).
//
// Replaces the Pallas TPU probe `scripts/kernel_anatomy.py:462`
// (`run_v5.<locals>.loop`, body `v5_kernel`, `:389-445`): a manual
// make_async_copy ring with DMA semaphores, nbuf blocks of K, V and both
// scales in flight, and one token row of each tile summed (`compute ==
// "row"`, `:421-424`). Here the ring of tile_ring.cuh with NBUF stages
// (the template parameter; 4, 8 or 16), each holding one block's K tile, V
// tile and both scale rows of the CTA's kv head, filled by TMA bulk copies
// from one producer warp and read by four consumer warps, the CTA's slice
// of the block-table row staged in shared memory before the copies. For
// kv head h of lane b it computes the float32 sum over the lane's blocks
// of token row 0 of the K tile and of the V tile (the stored elements as
// numbers: int8 bytes, INT4 packed bytes read as int8, bf16 values) -- the
// same function as P1's fetchrow.
//
// Grid: (lane, kv head, split), as P1's (tile_ring.cuh: the split plan
// and the fixed-order merge of the partials), not the TPU's (B,): the TPU
// has one core that runs the grid in order, while (B,) on the card would
// give 8 CTAs at the probe's batch. Pools as in K1: token-major K, V
// [S, Hkv, bs, D/pack], scales [S, Hkv, bs]. A stage is
// 2 * bs * row_bytes + 8 * bs bytes (8 KB + 256 B at bs 32, D 128, INT8),
// and its two barriers 16 more; a ring that does not fit in the 227 KB a
// block may have is refused (nbuf 16 at BF16 needs ~264 KB). Bound: the
// bytes of the blocks copied (K, V and both scales once); what the kernel
// computes is only the rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

constexpr int NC = 128;            // consumer threads (4 warps)
constexpr int NT = NC + 32;        // + the producer warp

template <int NBUF, bool BF16>
__global__ void __launch_bounds__(NT)
ring_kernel(const char* __restrict__ k_pool, const char* __restrict__ v_pool,
            const float* __restrict__ k_scale, const float* __restrict__ v_scale,
            const int* __restrict__ block_table,
            const int* __restrict__ seq_lens, float* __restrict__ dst, int Hkv,
            int bs, int row_bytes, int width, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[NC / 32];
  const int tid = threadIdx.x;
  const tile_ring::Walk w = tile_ring::walk_of(seq_lens, Hkv, bs, width, S);
  const uint32_t tile_bytes = (uint32_t)bs * row_bytes;
  tile_ring::Ring<NBUF> ring(smem, 2 * tile_bytes + 8 * bs);
  ring.init(NC / 32);
  if (tid >= NC) {                            // the producer warp
    ring.produce(block_table + (size_t)w.b * width, w.sp.first, w.sp.count,
                 tid % 32, [&](int slot, unsigned char* st, uint64_t* bar) {
      const size_t t = tile_ring::tile_row(slot, Hkv, w.h, bs);
      tile_ring::bulk_copy(st, k_pool + t * row_bytes, tile_bytes, bar);
      tile_ring::bulk_copy(st + tile_bytes, v_pool + t * row_bytes, tile_bytes,
                           bar);
      tile_ring::bulk_copy(st + 2 * tile_bytes, k_scale + t, 4 * bs, bar);
      tile_ring::bulk_copy(st + 2 * tile_bytes + 4 * bs, v_scale + t, 4 * bs,
                           bar);
    });
    return;
  }
  float acc = 0.f;
  const int row_elems = row_bytes / (BF16 ? 2 : 1);
  for (int i = 0; i < w.sp.count; ++i) {
    const unsigned char* stage = ring.acquire(i);
    for (int e = tid; e < row_elems; e += NC) {
      if constexpr (BF16) {
        const uint16_t* k = reinterpret_cast<const uint16_t*>(stage);
        const uint16_t* v = reinterpret_cast<const uint16_t*>(stage + tile_bytes);
        acc += __uint_as_float((uint32_t)k[e] << 16) +
               __uint_as_float((uint32_t)v[e] << 16);
      } else {
        acc += (float)(int8_t)stage[e] + (float)(int8_t)stage[tile_bytes + e];
      }
    }
    ring.release(i);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (tid % 32 == 0) red[tid / 32] = acc;
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
  if (tid == 0) {
    float s = 0.f;
    for (int v = 0; v < NC / 32; ++v) s += red[v];
    dst[(size_t)blockIdx.x * S + w.z] = s;
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
// [B, Hkv] float32; num_splits S >= 1 CTAs a (lane, kv head), and at S > 1
// `work` [B * Hkv, S] holds the partials that a merge launch adds. The
// Python wrapper refuses a ring above 227 KB; the launch returns
// cudaErrorInvalidValue for one too.
extern "C" int anatomy_ring_launch(
    const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, const int* block_table, const int* seq_lens,
    float* out, float* work, int B, int Hkv, int bs, int row_bytes,
    int max_blocks, int elem_bytes, int nbuf, int num_splits, void* stream) {
  const Kernel kern = pick(nbuf, elem_bytes == 2);
  const int S = num_splits;
  const size_t smem = kern ? tile_ring::ring_smem_bytes(
      nbuf, 2 * (size_t)bs * row_bytes + 8 * (size_t)bs) : 0;
  if (!kern || row_bytes % 16 || bs % 4 || (elem_bytes != 1 && elem_bytes != 2) ||
      smem > 232448 || S < 1 || (S > 1 && !work))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kern<<<dim3(B * Hkv, S), NT, smem, st>>>(
      static_cast<const char*>(k_pool), static_cast<const char*>(v_pool),
      k_scale, v_scale, block_table, seq_lens, S == 1 ? out : work, Hkv, bs,
      row_bytes, max_blocks, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (S == 1) return 0;
  return (int)tile_ring::launch_merge<float>(work, out, B * Hkv, S, 1, st);
}
