// Standalone DECA decompression for Hopper (sm_90a).
//
// Replaces repro/kernels/deca_decompress.py::decompress_pallas (body
// _decompress_kernel, tile decompress_block): a CompressedTensor's
// {codes, mask, scales} triplet to the dense (K, N) weight in f32 or bf16,
// every DECA stage (codec decode -> bitmask expansion -> group scale) of
// paper Fig. 11 in one pass. It serves the one bulk decompression of the
// system, the draft-tree build of self-speculative decode, which
// re-encodes the f32 weights at a cheaper codec.
//
// One thread per (group, column); the threads of a CTA hold neighbouring
// columns of one group. Code bytes of neighbouring columns are neighbours
// in the (K/32, ck, N) code plane, and so are their mask and scale words,
// so every load of a warp is one contiguous run; each of the group's 32
// output rows is one contiguous row store. Nothing is staged in shared
// memory: each byte is read once and each output written once, and the
// bound is those bytes over the memory rate. The f32 output keeps the
// product of value and scale unrounded (deca::decode_column<false>), as
// kernels/ref.py::decompress does; the bf16 output rounds that f32 once.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "deca_tile.cuh"

namespace {

constexpr int kThreads = 256;  // columns per CTA

template <bool kF32Out>
__global__ void __launch_bounds__(kThreads)
decompress_kernel(const uint8_t* __restrict__ codes,
                  const int32_t* __restrict__ mask,
                  const void* __restrict__ scales, int codec, int k_cap,
                  int ck, int N, void* __restrict__ out) {
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const long long g = blockIdx.y;
  const long long gn = g * N + n;
  const uint32_t bits = mask != nullptr ? (uint32_t)mask[gn] : 0u;
  uint32_t sbits = 0u;
  if (scales != nullptr)
    sbits = codec == deca::kMXFP4 ? (uint32_t)((const uint8_t*)scales)[gn]
                                  : (uint32_t)((const uint16_t*)scales)[gn];
  float w[deca::kGroup];
  deca::decode_column<false>(
      codec, codes + g * ck * N + n, N, k_cap, mask != nullptr, bits,
      scales != nullptr, deca::scale_value(codec, scales != nullptr, sbits), w);
  const long long row0 = g * deca::kGroup;
#pragma unroll
  for (int i = 0; i < deca::kGroup; ++i) {
    const long long at = (row0 + i) * N + n;
    if (kF32Out) ((float*)out)[at] = w[i];
    else ((__nv_bfloat16*)out)[at] = __float2bfloat16_rn(w[i]);
  }
}

}  // namespace

extern "C" int deca_decompress(const void* codes, const void* mask,
                               const void* scales, int codec, int k_cap,
                               int ck, int K, int N, void* out, int out_f32,
                               void* stream) {
  const int groups = K / deca::kGroup;
  if (K % deca::kGroup || groups < 1 || groups > 65535 || N < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)groups);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* c = (const uint8_t*)codes;
  const int32_t* m = (const int32_t*)mask;
  if (out_f32)
    decompress_kernel<true><<<grid, kThreads, 0, s>>>(c, m, scales, codec, k_cap, ck, N, out);
  else
    decompress_kernel<false><<<grid, kThreads, 0, s>>>(c, m, scales, codec, k_cap, ck, N, out);
  return (int)cudaGetLastError();
}
