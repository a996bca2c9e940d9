// W4A16 weight unpack: nibble-packed int4 weights -> the activation dtype.
//
// Replaces no TPU kernel. The JAX package stores a W4A16 weight as jnp.int4
// and XLA fuses the int4 -> bf16 convert into the matmul's operand load, so
// no Pallas kernel has this job. The port stores two signed nibbles a byte
// along the output axis, half-split (low nibble column j, high nibble column
// j + out/2, the order of the INT4 KV pack in ops/quant.py), and converts a
// weight before its torch.matmul (ops/wquant.py). Unpacking in eager PyTorch
// would be 4-5 launches with two int32 temporaries of the weight's size;
// this is one launch.
//
// What bounds it: bytes. It reads 0.5 byte an element and writes the
// element (2 bytes in bf16 / f16, 4 in f32): 2.5 bytes an element in bf16,
// at most 1/2.5 of an element an HBM byte. Design: each thread reads 16
// packed bytes with one 16-byte load and writes 16 low-nibble values to
// the row's first half and 16 high-nibble values to its second half, each
// as 16-byte stores, so neighbouring threads write neighbouring addresses
// in both halves. A row whose half width is not a multiple of 16 (or an
// unaligned pointer) takes the byte-at-a-time kernel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// output kinds (ops/w4_unpack.py: OUT_KINDS)
constexpr int kF32 = 0;
constexpr int kF16 = 1;
constexpr int kBF16 = 2;

template <int KIND>
struct Out;
template <>
struct Out<kF32> {
  using T = float;
  __device__ static T of(int v) { return static_cast<float>(v); }
};
template <>
struct Out<kF16> {
  using T = __half;
  __device__ static T of(int v) { return __int2half_rn(v); }
};
template <>
struct Out<kBF16> {
  using T = __nv_bfloat16;
  __device__ static T of(int v) { return __int2bfloat16_rn(v); }
};

__device__ __forceinline__ int lo_nibble(uint32_t b) {
  return static_cast<int>(b << 28) >> 28;
}
__device__ __forceinline__ int hi_nibble(uint32_t b) {
  return static_cast<int>(b << 24) >> 28;
}

// one thread: 16 packed bytes of a row -> 16 + 16 outputs
template <int KIND>
__global__ void unpack16_kernel(const uint4* __restrict__ q,
                                typename Out<KIND>::T* __restrict__ out,
                                long long rows, int half) {
  using T = typename Out<KIND>::T;
  const int per_row = half / 16;
  const long long n = rows * per_row;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / per_row;
    const int col = static_cast<int>(i - row * per_row) * 16;
    const uint4 v = q[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    alignas(16) T lo[16];
    alignas(16) T hi[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t b = (w[k / 4] >> (8 * (k % 4))) & 0xFFu;
      lo[k] = Out<KIND>::of(lo_nibble(b));
      hi[k] = Out<KIND>::of(hi_nibble(b));
    }
    T* base = out + row * 2 * (long long)half;
    uint4* dlo = reinterpret_cast<uint4*>(base + col);
    uint4* dhi = reinterpret_cast<uint4*>(base + half + col);
    const uint4* slo = reinterpret_cast<const uint4*>(lo);
    const uint4* shi = reinterpret_cast<const uint4*>(hi);
#pragma unroll
    for (int k = 0; k < (int)(16 * sizeof(T) / 16); ++k) {
      dlo[k] = slo[k];
      dhi[k] = shi[k];
    }
  }
}

// one thread: one packed byte -> its two outputs
template <int KIND>
__global__ void unpack1_kernel(const int8_t* __restrict__ q,
                               typename Out<KIND>::T* __restrict__ out,
                               long long rows, int half) {
  const long long n = rows * half;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / half;
    const int col = static_cast<int>(i - row * half);
    const uint32_t b = static_cast<uint8_t>(q[i]);
    typename Out<KIND>::T* base = out + row * 2 * (long long)half;
    base[col] = Out<KIND>::of(lo_nibble(b));
    base[half + col] = Out<KIND>::of(hi_nibble(b));
  }
}

template <int KIND>
void launch(const void* q, void* out, long long rows, int half, bool wide,
            cudaStream_t stream) {
  using T = typename Out<KIND>::T;
  constexpr int kThreads = 256;
  const long long work = wide ? rows * (half / 16) : rows * half;
  // a grid-stride loop: at most 16 blocks an SM's worth of a 132-SM card
  const long long blocks_needed = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks_needed < 132 * 16
                                          ? blocks_needed : 132 * 16);
  if (blocks == 0) return;
  if (wide) {
    unpack16_kernel<KIND><<<blocks, kThreads, 0, stream>>>(
        static_cast<const uint4*>(q), static_cast<T*>(out), rows, half);
  } else {
    unpack1_kernel<KIND><<<blocks, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<T*>(out), rows, half);
  }
}

}  // namespace

// q: [rows, half] int8, contiguous; out: [rows, 2 * half] of kind
// `out_kind`, contiguous. wide: half % 16 == 0 and both pointers 16-byte
// aligned (the wrapper decides). Returns a cudaError_t code (0 = launched).
extern "C" int w4_unpack_launch(const void* q, void* out, long long rows,
                                int half, int out_kind, int wide,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case kF32: launch<kF32>(q, out, rows, half, wide, s); break;
    case kF16: launch<kF16>(q, out, rows, half, wide, s); break;
    case kBF16: launch<kBF16>(q, out, rows, half, wide, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
