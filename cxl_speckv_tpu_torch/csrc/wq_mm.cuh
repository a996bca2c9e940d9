// Pieces shared by the fused quantized-weight matmuls, W4A16
// (w4a16_mm.cu) and W8A16 (w8a16_mm.cu): the activation kinds and the
// composition's rounding in the epilogue, the cp.async ring of
// shared-memory stages and its tile loaders, the tensor-core product, and
// split-K (each split writes float32 partials; the last CTA of a tile to
// arrive sums them in split order, so two calls give the same bits).
//
// A CTA covers an output tile of MB rows by NS strips of STRIP columns
// (the int4 kernel's two strips are the low- and high-nibble halves of one
// packed strip); its grid is (strips, row blocks, batch * splits).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace wq {

// activation kinds (ops/w4a16_mm.py: KINDS)
constexpr int kF32 = 0;
constexpr int kF16 = 1;
constexpr int kBF16 = 2;

constexpr int THREADS = 128;
constexpr int STRIP = 128;         // weight bytes of a strip's tile row

template <int KIND>
struct Kind;
template <>
struct Kind<kBF16> {
  using T = __nv_bfloat16;
  __device__ static T finish(float acc, float sc) {
    const float a = __bfloat162float(__float2bfloat16_rn(acc));
    const float b = __bfloat162float(__float2bfloat16_rn(sc));
    return __float2bfloat16_rn(a * b);
  }
};
template <>
struct Kind<kF16> {
  using T = __half;
  __device__ static T finish(float acc, float sc) {
    const float a = __half2float(__float2half_rn(acc));
    const float b = __half2float(__float2half_rn(sc));
    return __float2half_rn(a * b);
  }
};
template <>
struct Kind<kF32> {
  using T = float;
  __device__ static T finish(float acc, float sc) { return acc * sc; }
};

template <typename T>
struct Raw;                         // the element's bits, for zero fills
template <>
struct Raw<__nv_bfloat16> { using R = uint16_t; };
template <>
struct Raw<__half> { using R = uint16_t; };
template <>
struct Raw<float> { using R = uint32_t; };

// the output and its split-K state
struct Out {
  void* y;           // [B, M, N] activation kind
  const float* s;    // [B, N] per-output-column scales
  float* ws;         // [B, splits, M, N] partials (splits > 1)
  int* cnt;          // per-tile arrival counters, zero between calls
  int M, N, splits;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the stages [s0, s0 + n) of BK rows that split sp of `splits` walks
struct Span {
  int s0, n;
};
__device__ __forceinline__ Span split_span(int K, int bk, int splits,
                                           int sp) {
  const int kst = (K + bk - 1) / bk;
  const int s0 = (int)((long long)sp * kst / splits);
  return {s0, (int)((long long)(sp + 1) * kst / splits) - s0};
}

// The ring: load(slot, i) fills ring slot `slot` with stage i (issuing
// cp.async copies), step(slot) computes on a filled slot. NSTAGE - 1 stages
// are in flight while one is computed; the barrier before each refill
// keeps a slot until every warp has read it.
template <int NSTAGE, typename Load, typename Step>
__device__ __forceinline__ void ring(int n, Load&& load, Step&& step) {
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < n) load(i, i);
    cp_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_wait<NSTAGE - 2>();
    __syncthreads();
    const int nx = it + NSTAGE - 1;
    if (nx < n) load(nx % NSTAGE, nx);
    cp_commit();
    step(it % NSTAGE);
  }
  cp_wait<0>();
}

// byte offset of element (row r, column c) of a [rows x STRIP]-byte tile in
// shared memory: the 32-byte units of a row are XOR-ed with bits 2-3 of r,
// so that the 32 lanes' words of one fragment read (rows 4t + j, columns 4g
// of one 32-byte unit) fall in 32 different banks; 16-byte chunks stay
// whole
__device__ __forceinline__ int qoff(int r, int c) {
  return r * STRIP + (c ^ (((r >> 2) & 3) << 5));
}

// rows [k0, k0 + BK) x columns [c0, c0 + STRIP) of a row-major int8 [K, ld]
// matrix into a qoff tile; out of range reads as zero. vec: 16-byte copies
// (the wrapper checked ld % 16 and a 16-byte aligned base, so a chunk is
// wholly in range or wholly out)
template <int BK>
__device__ __forceinline__ void load_rows(uint8_t* sq, const int8_t* q,
                                          int K, int ld, int k0, int c0,
                                          bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CQ = STRIP / 16;               // chunks a row
    for (int i = tid; i < BK * CQ; i += THREADS) {
      const int r = i / CQ, c = (i % CQ) * 16;
      const bool ok = k0 + r < K && c0 + c < ld;
      const int8_t* src = ok ? q + (long long)(k0 + r) * ld + c0 + c : q;
      cp16(sq + qoff(r, c), src, ok);
    }
  } else {
    for (int i = tid; i < BK * STRIP; i += THREADS) {
      const int r = i / STRIP, c = i % STRIP;
      const bool ok = k0 + r < K && c0 + c < ld;
      sq[qoff(r, c)] = ok ? q[(long long)(k0 + r) * ld + c0 + c] : 0;
    }
  }
}

// rows [m0, m0 + MB) x columns [k0, k0 + BK) of x [M, K] into a tile of
// row stride XS; out of range reads as zero. vec: 16-byte copies (the
// wrapper checked K * sizeof(T) % 16 and a 16-byte aligned base)
template <typename T, int MB, int XS, int BK>
__device__ __forceinline__ void load_x(T* sx, const T* x, int M, int K,
                                       int m0, int k0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);          // elements a chunk
    constexpr int CPR = BK / EPC;                // chunks a row
    for (int i = tid; i < MB * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      const bool ok = m0 + r < M && k0 + c < K;
      const T* src = ok ? x + (long long)(m0 + r) * K + k0 + c : x;
      cp16(sx + r * XS + c, src, ok);
    }
  } else {
    using R = typename Raw<T>::R;
    const R* xr = reinterpret_cast<const R*>(x);
    R* sr = reinterpret_cast<R*>(sx);
    for (int i = tid; i < MB * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const bool ok = m0 + r < M && k0 + c < K;
      sr[r * XS + c] = ok ? xr[(long long)(m0 + r) * K + k0 + c] : R(0);
    }
  }
}

// c[16 x 8] += a[16 x 16] . b[16 x 8] in bf16 or f16, float32 accumulator
template <int KIND>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (KIND == kBF16) {
    mma_bf16(c, a, b0, b1);
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// output (m, n) of batch b, in range: finished (one split) or split sp's
// partial
template <int KIND>
__device__ __forceinline__ void put(const Out& o, int b, int sp, int m, int n,
                                    float v) {
  const long long N = o.N;
  if (o.splits == 1) {
    using T = typename Kind<KIND>::T;
    T* y = static_cast<T*>(o.y) + ((long long)b * o.M + m) * N + n;
    *y = Kind<KIND>::finish(v, o.s[b * N + n]);
  } else {
    o.ws[(((long long)b * o.splits + sp) * o.M + m) * N + n] = v;
  }
}

// split-K: the last CTA of the tile sums the partials in split order and
// finishes the tile; it resets the tile's counter for the next call. The
// tile: rows [m0, m0 + MB), NS strips of STRIP columns, strip j's column c
// being output column c0 + c + j * sstride, in range while c0 + c < lim.
// vec: every four columns from a multiple of four are wholly in range or
// out, at 16-byte aligned partials (the caller checked); a thread then
// takes four columns at a time, V groups a pass, and keeps the loads of V
// groups and four splits in flight together
template <int KIND, int MB, int NS>
__device__ void split_tail(const Out& o, int b, int m0, int c0, int lim,
                           int sstride, bool vec) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int tile = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last = atomicAdd(o.cnt + tile, 1) == o.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  using T = typename Kind<KIND>::T;
  constexpr int W = NS * STRIP;                   // columns a tile row
  const long long N = o.N;
  const long long split_stride = (long long)o.M * N;
  const float* ws = o.ws + (long long)b * o.splits * split_stride;
  T* y = static_cast<T*>(o.y) + (long long)b * o.M * N;
  const float* s = o.s + b * N;
  if (vec) {
    constexpr int G = MB * W / 4;                 // float4 groups a tile
    constexpr int V = G / THREADS >= 4 ? 4 : G / THREADS;
    static_assert(G % (THREADS * V) == 0, "whole passes");
    for (int base = 0; base < G; base += THREADS * V) {
      long long off[V];
      bool ok[V];
      float4 v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int e = 4 * (base + i * THREADS + threadIdx.x);
        const int m = m0 + e / W, c = e % W;
        const int col = c0 + c % STRIP;
        ok[i] = m < o.M && col < lim;
        off[i] = m * N + col + (long long)(c / STRIP) * sstride;
        v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll 4
      for (int j = 0; j < o.splits; ++j) {
        float4 p[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (ok[i])
            p[i] = __ldcg(reinterpret_cast<const float4*>(
                ws + j * split_stride + off[i]));
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (!ok[i]) continue;
          v[i].x += p[i].x;
          v[i].y += p[i].y;
          v[i].z += p[i].z;
          v[i].w += p[i].w;
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (!ok[i]) continue;
        const long long q = off[i];
        const long long n = q % N;
        y[q] = Kind<KIND>::finish(v[i].x, s[n]);
        y[q + 1] = Kind<KIND>::finish(v[i].y, s[n + 1]);
        y[q + 2] = Kind<KIND>::finish(v[i].z, s[n + 2]);
        y[q + 3] = Kind<KIND>::finish(v[i].w, s[n + 3]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < MB * W; e += THREADS) {
      const int m = m0 + e / W, c = e % W;
      const int col = c0 + c % STRIP;
      if (m >= o.M || col >= lim) continue;
      const long long q = m * N + col + (long long)(c / STRIP) * sstride;
      float v = 0.f;
      for (int j = 0; j < o.splits; ++j) v += __ldcg(ws + j * split_stride + q);
      y[q] = Kind<KIND>::finish(v, s[q % N]);
    }
  }
  if (threadIdx.x == 0) o.cnt[tile] = 0;
}

// a configuration's dynamic shared memory allowed past the 48 KB default
template <typename C>
cudaError_t allow_smem() {
  if (C::SMEM <= 48 * 1024 - 64) return cudaSuccess;
  return cudaFuncSetAttribute(
      C::kern(), cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
}

}  // namespace wq
