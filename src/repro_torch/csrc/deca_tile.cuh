// DECA tile decode for Hopper: the three stages of the DECA PE (paper
// Fig. 11) as device functions, shared by the compressed GeMV/GeMM kernels
// and the paged-attention KV decode.
//
// Replaces repro/kernels/deca_decompress.py::decompress_block, which the
// Pallas kernels ran on a VMEM block with the VPU. Here one thread decodes
// one (group, column) of a compressed weight, from a code tile that the
// matmul kernels have staged in shared memory or, in the standalone
// decompression kernel, straight from device memory (column-major:
// neighbouring threads, holding neighbouring columns, read neighbouring
// bytes). The arithmetic is that of repro_torch/core/codecs.py
// (`decode_values`, `decode_scales`, `kv_decode`) and of the expansion in
// kernels/ref.py, so the decoded weight is bitwise the plain version's.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace deca {

// codec wire ids (repro_torch/core/codecs.py::_WIRE_IDS)
enum Codec : int { kNone = 0, kBF16 = 1, kBF8 = 2, kMXFP4 = 3, kINT8 = 4,
                   kINT4 = 5, kNF4 = 6 };

constexpr int kGroup = 32;           // elements per compression group
constexpr int kEmptyPos = 1 << 30;   // kernels/ref.py::CACHE_EMPTY_POS

__device__ __constant__ float kNF4Lut[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// E2M1 nibble: m/2 if e == 0 else (1 + m/2) * 2^(e-1); bit 3 is the sign.
__device__ __forceinline__ float fp4_value(uint32_t nib) {
  const uint32_t e = (nib >> 1) & 3u, m = nib & 1u;
  const float mag = e == 0 ? 0.5f * m
                           : (1.0f + 0.5f * m) * (float)(1u << e) * 0.5f;
  return (nib >> 3) & 1u ? -mag : mag;
}

__device__ __forceinline__ float int4_value(uint32_t nib) {
  return (float)((int)nib - (nib >= 8u ? 16 : 0));
}

// value of a 4-bit code: mxfp4, int4 or nf4
__device__ __forceinline__ float nibble_value(int codec, uint32_t nib) {
  if (codec == kMXFP4) return fp4_value(nib);
  if (codec == kINT4) return int4_value(nib);
  return kNF4Lut[nib];
}

// E8M0 scale 2^(u - 127), exact (u = 0 is the subnormal 2^-127)
__device__ __forceinline__ float e8m0_value(uint32_t u) {
  return u == 0 ? __uint_as_float(0x00400000u) : __uint_as_float(u << 23);
}

__device__ __forceinline__ float bf16_bits_value(uint32_t bits16) {
  return __uint_as_float((bits16 & 0xFFFFu) << 16);
}

// Stage 1: the j-th stored value of one column of one group; consecutive
// code bytes of the column are `n_cols` apart.
__device__ __forceinline__ float code_value(int codec, const uint8_t* col,
                                            int j, long long n_cols) {
  switch (codec) {
    case kBF16: {
      const uint32_t lo = col[(2LL * j) * n_cols];
      const uint32_t hi = col[(2LL * j + 1) * n_cols];
      return bf16_bits_value(lo | (hi << 8));
    }
    case kBF8:
      return __half2float(__ushort_as_half((unsigned short)(col[j * n_cols] << 8)));
    case kINT8:
      return (float)(int8_t)col[j * n_cols];
    default: {  // nibble codecs, even index = low nibble
      const uint32_t b = col[(long long)(j >> 1) * n_cols];
      return nibble_value(codec, (j & 1) ? (b >> 4) : (b & 0xFu));
    }
  }
}

// The group scale from its stored bits (1 for unscaled codecs).
__device__ __forceinline__ float scale_value(int codec, bool scaled, uint32_t bits) {
  if (!scaled) return 1.0f;
  return codec == kMXFP4 ? e8m0_value(bits) : bf16_bits_value(bits);
}

// Stages 1-3 for one column of one group: the 32 dense weights of the
// group's rows, scaled in f32 and then, with kRoundBf16 (the matmul
// kernels' operand), rounded to bf16; without it the f32 product is kept,
// as kernels/ref.py::decompress gives it for an f32 output. `col` points
// at the column's first code byte; consecutive code bytes are `stride`
// apart. Sparse groups expand with the bitmask: row i takes stored value
// min(popc(bits & ((1 << i) - 1)), k_cap - 1), and +0 where bit i is clear.
template <bool kRoundBf16 = true>
__device__ __forceinline__ void decode_column(
    int codec, const uint8_t* col, long long stride, int k_cap, bool sparse,
    uint32_t bits, bool scaled, float scale, float (&w)[kGroup]) {
  if (!sparse) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float v = code_value(codec, col, i, stride);
      const float s = scaled ? v * scale : v;
      w[i] = kRoundBf16 ? round_bf16(s) : s;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    float v = 0.0f;
    if ((bits >> i) & 1u) {
      const int below = __popc(bits & ((1u << i) - 1u));
      v = code_value(codec, col, below < k_cap ? below : k_cap - 1, stride);
      if (scaled) v *= scale;
    }
    w[i] = kRoundBf16 ? round_bf16(v) : v;
  }
}

}  // namespace deca
