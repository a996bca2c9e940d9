// The split walk of the decode-anatomy probes P1 (anatomy_variants.cu), P2
// (anatomy_kt.cu) and P3 (anatomy_ring.cu): a grid of (lane, kv head,
// split), each CTA walking its split's share of the lane's blocks through a
// ring of shared-memory stages filled by TMA copies, and the deterministic
// merges of the splits' partial results: a plain sum (`merge_splits`, P1 and
// P3) and the log-sum-exp merge of attention states (`merge_lse`, K1 and
// P2). K1's and K2's pipelined tiles (ROADMAP B1 / B3) are queued to take
// the same loader.
//
// Split plan. Lane b has n = min(ceil(seq_len / bs), width) blocks (width:
// the block table's row length). Split z of S takes blocks
// [z * per, min((z + 1) * per, n)) with per = ceil(n / S), so a lane with
// fewer blocks than splits leaves its last splits empty and a lane of 0
// tokens leaves all of them empty; an empty split writes a zero partial.
// `split_range` states it; `decode_anatomy.split_ranges` mirrors it in
// Python for the tests.
//
// The ring. A stage holds one block's tiles of the CTA's kv head: the K
// tile, the V tile (each one contiguous, 16-byte-aligned run of
// bs * row_bytes in the token-major pool) and, where the kernel reads them,
// both scale rows (bs * 4 bytes each). One elected thread of a producer
// warp issues `cp.async.bulk` copies (1-D TMA: no tensor map) into a stage
// and arms the stage's "full" mbarrier with the bytes expected
// (`expect_tx`); the consumers wait on that barrier's phase, read the
// stage, and each consumer warp arrives on the stage's "empty" barrier,
// which hands the stage back to the producer for the block DEPTH further
// on. The CTA's slice of the table row is staged in shared memory by the
// producer warp, TABLE_WINDOW entries at a time (once for any split of up
// to TABLE_WINDOW blocks) before the copies that use it, so no table read
// from device memory sits between a wait and the next issue.
//
// A stage may also be filled by 2-D TMA copies through a tensor map
// (`tma_load_2d`, P2's transposed K tile: rows of one head's columns at
// the pool row's stride); a kernel whose stages are padded past the bytes
// its copies bring (TMA wants each tensor destination on a 128-byte
// boundary) arms the barrier with those bytes (`produce_tx`).
//
// Shared memory of a ring kernel (`ring_smem_bytes`): the 2 * DEPTH
// barriers, the table window, then the DEPTH stages from a 128-byte
// boundary, then whatever the kernel adds behind them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_ring {

constexpr int TABLE_WINDOW = 256;      // table entries staged at once
constexpr int STAGE_ALIGN = 128;

// lane b's blocks, capped at the table's width
__device__ __forceinline__ int lane_blocks(const int* lens, int b, int bs,
                                           int width) {
  const int n = (lens[b] + bs - 1) / bs;
  return n < width ? n : width;
}

// blocks [first, first + count) of split z of S over a lane of n blocks
struct Split {
  int first, count;
};

__device__ __forceinline__ Split split_range(int n, int S, int z) {
  const int per = (n + S - 1) / S;
  const int first = z * per;
  const int left = n - first;
  return {first, left <= 0 ? 0 : (left < per ? left : per)};
}

// this CTA's walk on the grid (lane b * Hkv + kv head h, split z)
struct Walk {
  int b, h, z;
  Split sp;
};

__device__ __forceinline__ Walk walk_of(const int* lens, int Hkv, int bs,
                                        int width, int S) {
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv, z = blockIdx.y;
  return {b, h, z, split_range(lane_blocks(lens, b, bs, width), S, z)};
}

// the tile of kv head h at pool slot `slot` in a token-major pool
// [slots, Hkv, bs, row]: its first token row
__device__ __forceinline__ size_t tile_row(int slot, int Hkv, int h, int bs) {
  return ((size_t)slot * Hkv + h) * bs;
}

__host__ __device__ constexpr size_t stages_offset(int depth) {
  return ((size_t)16 * depth + TABLE_WINDOW * 4 + STAGE_ALIGN - 1) /
         STAGE_ALIGN * STAGE_ALIGN;
}

// dynamic shared memory of a ring of `depth` stages of `stage_bytes`
__host__ __device__ constexpr size_t ring_smem_bytes(int depth,
                                                     size_t stage_bytes) {
  return stages_offset(depth) + (size_t)depth * stage_bytes;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar))
               : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// the box at element coordinates (x, y) (x the inner dimension) of the
// tensor that `map` describes, into shared memory at `dst` (128-byte
// aligned), densely as [box rows][box columns]; elements past the tensor's
// edge arrive as zeros. Completes on `bar`'s transaction count with the
// whole box's bytes. `map` must be a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int x,
                                            int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(saddr(bar))
      : "memory");
}

// The ring in the kernel's dynamic shared memory. Threads [0, consumers)
// consume; the warp after them produces. Every thread of the CTA
// constructs it and calls `init`; then the producer warp calls `produce`
// and the consumers `acquire` / `release` blocks. `init`'s count is the
// warps that release each block. A waiter must take a stage's blocks in
// order and never wait more than one phase ahead of the stage (a parity
// wait on the phase after the current one passes at once), so consumers
// either all read every block, or each stage has one reading warp.
template <int DEPTH>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int* win;
  unsigned char* stages;
  uint32_t stage_bytes;

  __device__ Ring(unsigned char* smem, uint32_t stage_bytes_)
      : full(reinterpret_cast<uint64_t*>(smem)),
        empty(reinterpret_cast<uint64_t*>(smem) + DEPTH),
        win(reinterpret_cast<int*>(smem + 16 * DEPTH)),
        stages(smem + stages_offset(DEPTH)),
        stage_bytes(stage_bytes_) {}

  __device__ unsigned char* stage(int i) const {
    return stages + (size_t)(i % DEPTH) * stage_bytes;
  }

  // thread 0 initialises the barriers; every thread of the CTA must call
  // this before any other use (it ends with __syncthreads)
  __device__ void init(int consumer_warps) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < DEPTH; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], consumer_warps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // Producer warp: blocks first .. first + count - 1 of table row `row`,
  // in order. issue(slot, dst, bar) issues the bulk copies of the block at
  // pool slot `slot` into stage `dst` on barrier `bar`, stage_bytes in all.
  template <class Issue>
  __device__ void produce(const int* row, int first, int count, int lane,
                          Issue issue) {
    produce_tx(row, first, count, lane, stage_bytes, issue);
  }

  // the same, the copies of a block bringing `tx_bytes` (<= stage_bytes)
  template <class Issue>
  __device__ void produce_tx(const int* row, int first, int count, int lane,
                             uint32_t tx_bytes, Issue issue) {
    for (int base = 0; base < count; base += TABLE_WINDOW) {
      const int nb = count - base < TABLE_WINDOW ? count - base : TABLE_WINDOW;
      __syncwarp();
      for (int j = lane; j < nb; j += 32) win[j] = row[first + base + j];
      __syncwarp();
      if (lane == 0) {
        for (int j = 0; j < nb; ++j) {
          const int i = base + j;
          const int s = i % DEPTH;
          if (i >= DEPTH) mbar_wait(&empty[s], ((i / DEPTH) - 1) & 1);
          mbar_expect_tx(&full[s], tx_bytes);
          issue(win[j], stage(i), &full[s]);
        }
      }
    }
  }

  // Consumers: the stage of the walk's block i, once it has landed
  __device__ const unsigned char* acquire(int i) {
    mbar_wait(&full[i % DEPTH], (i / DEPTH) & 1);
    return stage(i);
  }

  // Consumers: each warp hands block i's stage back when done with it
  __device__ void release(int i) {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[i % DEPTH]);
  }
};

// out[r * E + e] = sum over z < S of part[(r * S + z) * E + e], adding the
// splits in order z = 0, 1, ...: the same bits on every call
template <typename T>
__global__ void merge_splits(const T* __restrict__ part, T* __restrict__ out,
                             int rows, int S, int E) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * E) return;
  const int r = i / E, e = i % E;
  const T* p = part + (size_t)r * S * E + e;
  T acc = p[0];
  for (int z = 1; z < S; ++z) acc += p[(size_t)z * E];
  out[i] = acc;
}

template <typename T>
cudaError_t launch_merge(const T* part, T* out, int rows, int S, int E,
                         cudaStream_t st) {
  const int n = rows * E;
  if (n == 0) return cudaSuccess;
  merge_splits<T><<<(n + 255) / 256, 256, 0, st>>>(part, out, rows, S, E);
  return cudaGetLastError();
}

// The splits' attention states of one output row (a lane's query head) ->
// the row, one CTA of NT threads a row: the split z of row r left its
// running max part_m[r * S + z], its sum part_l[r * S + z] and its
// accumulator part_acc[(r * S + z) * D + d], relative to its own max (an
// empty split: m = -1e30, l = 0, acc = 0). With M = max_z m_z (and the
// row's sink logit sk = sinks[r % Hq], where sinks is not null: M =
// max(M, sk)),
//   out = sum_z acc_z e^(m_z - M) / max(sum_z l_z e^(m_z - M) [+ e^(sk - M)],
//         1e-30),
// the sums over z = 0 .. S - 1 in that order: the same bits on every call.
// An empty split adds exactly 0 (e^(-1e30 - M) = 0; never exp(-inf + inf)),
// and a row every split of which is empty gives zeros.
constexpr float MERGE_NEG_INF = -1e30f;

template <int MAX_S, int NT>
__global__ void __launch_bounds__(NT)
merge_lse(const float* __restrict__ part_m, const float* __restrict__ part_l,
          const float* __restrict__ part_acc, const float* __restrict__ sinks,
          float* __restrict__ out, int Hq, int D, int S) {
  __shared__ float w_s[MAX_S];
  __shared__ float den_s;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* pm = part_m + row * S;
  float M = MERGE_NEG_INF;
  for (int s = 0; s < S; ++s) M = fmaxf(M, pm[s]);
  const float sk = sinks != nullptr ? sinks[row % Hq] : MERGE_NEG_INF;
  if (sinks != nullptr) M = fmaxf(M, sk);
  if (tid < S) w_s[tid] = expf(pm[tid] - M);
  __syncthreads();
  if (tid == 0) {
    const float* pl = part_l + row * S;
    float l = 0.f;
    for (int s = 0; s < S; ++s) l += pl[s] * w_s[s];
    if (sinks != nullptr) l += expf(sk - M);
    den_s = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* pa = part_acc + row * S * D;
  for (int d = tid; d < D; d += NT) {
    float a = 0.f;
    for (int s = 0; s < S; ++s) a += pa[(size_t)s * D + d] * w_s[s];
    out[row * D + d] = a / den_s;
  }
}

}  // namespace tile_ring
