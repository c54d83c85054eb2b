// DECA decode GeMV for Hopper (sm_90a).
//
// Replaces repro/kernels/deca_gemm.py::decompress_gemv_pallas (decode,
// M <= 32; body _gemm_kernel). It computes out (M, N) = bf16(x) @
// bf16(decompress(W)) with f32 accumulation and stores once in the output
// type. The dense weight never exists in device memory: a CTA streams the
// compressed triplet (codes, mask bits, scale bits) of its 128 columns
// through a ring in shared memory, and each value is decoded in registers
// right before its FMAs. The prefill GeMM (M > 32) is deca_gemm_sm90.cu.
//
// What bounds it on the H100. The compressed weight dwarfs x and out, so
// the floor is its bytes over 3.35 TB/s: gate/up (4096 x 14336) at bf8_50
// is 36.8 MB, 0.0110 ms. Three things kept the first version (PR 12) at
// 7 % of that (0.1511 ms at M = 4):
//   - Nothing was in flight while it decoded: a chunk was loaded, then a
//     barrier, then decoded. At 3.35 TB/s and ~0.8 us of latency, Little's
//     law asks for ~20 KB in flight on each SM all the time.
//   - The work followed the 32 positions of a group, not its stored values:
//     a popc, a byte load, a widen, a scale and a bf16 round per position,
//     then M FMAs each with a bf16 -> f32 convert of x, with the codec a
//     runtime switch inside every value. About 44 M warp-instructions a
//     gate/up call at M = 4: ~47 us at a perfect issue rate.
//   - nf4's table sat in constant memory, read with a different index in
//     every lane.
// What this design does:
//   - A stage of the ring holds up to 8 groups x 128 columns: code rows
//     (16 KB at most), mask words, scale bits, and the chunk's x as f32
//     already rounded to bf16 in a [k][MB] layout, so one 16-byte shared
//     load gives four rows of x and no convert is left in the inner loop.
//     Codes, masks and scales of chunk i + 1 are copied with cp.async
//     (16-byte pieces, zero fill past N) before chunk i is decoded; x
//     (tiny and L2-resident) is loaded into registers then and stored
//     after. One barrier a chunk. Rows that are not whole 16-byte runs
//     (N % 16 != 0 for codes) take a synchronous path into the same stage.
//   - The kernel is instantiated per codec and row bucket MB (6 x 6), so
//     the codec switch folds away. A sparse group with MB <= kSetBitMaxMB
//     walks its set mask bits from the top (one FLO a bit): the j-th stored
//     value meets x at its position, so the work follows the k_cap stored
//     values (16 of 32 at bf8_50). For a chunk whose x holds an inf or a
//     NaN (flagged as x is staged, told to the CTA by the chunk's barrier)
//     a rolled pass adds the x * +0 products of the clear positions, NaN
//     there as in the plain version. Dense groups, and sparse ones at larger
//     MB, walk the 32 positions, where x is one broadcast load for the
//     whole warp; there the FMAs, not the decode, set the pace (walking the
//     set bits at MB = 16 and 32 took 1.7x and 3.0x longer).
//   - The 4-bit tables (nf4, and mxfp4's E2M1 grid) are 16 floats in
//     shared memory, one per bank: divergent indices cannot conflict.
//     Integer codes widen through the f32 bits of 2^23 + code, with no
//     conversion instruction; only codes times a bf16 scale are rounded.
//   - 256 threads a CTA: two threads own a column and take alternating
//     groups of each chunk; their sums meet in shared memory in a fixed
//     order. At gate/up, M = 4, the plan (kernels/autotune.py) gives 112 x 3
//     = 336 CTAs of 48.1 KB of shared memory and 80 registers a thread, so
//     3 fit an SM and all are resident at once: 2.5 CTAs, 20 warps, a SM on
//     average (24 at most), each with one stage of 20 KB of compressed bytes
//     (16 KB codes, 4 KB masks) in flight while it decodes the other: about
//     51 KB in flight a SM.
// What bounds it now (chip runs of tools/gemv_bench.py, PERF.md): gate/up
// at M = 4 takes ~0.039 ms of device time, 28 % of the floor. Streaming
// alone (no decode) takes 0.021 ms, decoding alone (no loads) 0.033 ms;
// dropping any one part of a value's work (its FMAs, its FLO, its code
// load) saved 5-16 %, and neither more warps an SM nor two walks in flight
// a thread helped. The decode walk, not memory, sets the pace; which of
// its units does, these timings alone cannot tell.
// Split-K: when 128-column blocks give too few CTAs for 132 SMs (N = 1024
// gives 8), K is split over gridDim.y CTAs that write f32 partials to a
// workspace, and splitk_reduce sums them in split order, so the result is
// deterministic. With one split the kernel stores out itself: one launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "deca_tile.cuh"

namespace {

constexpr int kCols = 128;           // output columns per CTA
constexpr int kThreads = 2 * kCols;  // two threads per column
constexpr int kBatch = 8;            // loads a thread issues before it stores (ragged rows)
// x quads (4 columns of a row) a thread stages per chunk, at most: a stage
// holds <= 8 groups of x at MB <= 8 and 8 KB of x above (autotune.py)
template <int MB>
constexpr int kXQuads = MB <= 4 ? 1 : 2;
// CTAs an SM must hold at once, which sets a thread's register budget: 80
// up to MB = 16 (three CTAs an SM hold gate/up's 2.5 a SM in one wave), 128
// at MB = 32
template <int MB>
constexpr int kMinCtas = MB <= 16 ? 3 : 2;
constexpr int kSetBitMaxMB = 8;      // sparse groups walk their set bits up to this MB
constexpr int kMaxSmem = 232448;     // 227 KB, the most a CTA can opt in to

// scale bytes a group of the codec carries (its scales plane's dtype)
__host__ __device__ constexpr int scale_bytes_of(int codec) {
  return codec == deca::kMXFP4 ? 1 : codec >= deca::kINT8 ? 2 : 0;
}

__host__ __device__ constexpr int align16(int b) { return (b + 15) & ~15; }

// Byte offsets of one ring stage's planes, the stage size, and the whole
// CTA's dynamic shared memory: two stages (the halves' partial sums reuse
// them after the loop), then the 16-float nibble table. The same sum is
// kernels/autotune.py::gemv_smem_bytes; the launch checks the two agree.
struct Layout {
  int mask, scale, x, stage, lut, total;
};

__host__ __device__ inline Layout layout(int chunk, int ck, bool sparse, int scale_bytes,
                                         int mb) {
  Layout l;
  l.mask = align16(chunk * ck * kCols);
  l.scale = l.mask + (sparse ? chunk * kCols * 4 : 0);
  l.x = l.scale + align16(chunk * kCols * scale_bytes);
  l.stage = l.x + chunk * deca::kGroup * mb * 4;
  l.lut = 2 * l.stage > kCols * mb * 4 ? 2 * l.stage : kCols * mb * 4;
  l.total = l.lut + 16 * 4;
  return l;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  // bytes < 16 zero-fills the rest of the piece (0: a piece past N)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes) : "memory");
}

// `rows` rows of kRowBytes bytes each, `stride` bytes apart from `src`, into
// shared `dst` (packed); bytes at or past `valid` in a row read as 0.
// cp.async in 16-byte pieces when every row is a whole aligned run (then
// `valid` is a multiple of 16); else a synchronous, batched byte copy.
template <int kRowBytes>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const uint8_t* src, long long stride,
                                          int rows, int valid, bool aligned) {
  if (aligned) {
    constexpr int kPer = kRowBytes / 16;
    for (int i = threadIdx.x; i < rows * kPer; i += kThreads) {
      const int r = i / kPer, p = (i % kPer) * 16;
      const bool in = p < valid;
      cp_async16(dst + r * kRowBytes + p, src + r * stride + (in ? p : 0), in ? 16 : 0);
    }
    return;
  }
  const int total = rows * kRowBytes;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    uint8_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads, c = i % kRowBytes;
      v[u] = (i < total && c < valid) ? src[(i / kRowBytes) * stride + c] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) dst[i] = v[u];
    }
  }
}

// What every CTA of a launch shares.
struct Args {
  const void* x;
  const uint8_t* codes;
  const int32_t* mask;
  const void* scales;
  void* out;
  float* ws;
  int x_f32, out_f32, k_cap, ck, M, K, N, groups_per_split, chunk;
};

// Codes, masks and scales of groups [gc, gc + ngc) of this CTA's columns
// into one stage, as one cp.async group.
template <int kScaleBytes>
__device__ __forceinline__ void issue_planes(uint8_t* st, const Layout& l, const Args& a,
                                             int gc, int ngc, long long n0, int cols) {
  const long long N = a.N;
  copy_rows<kCols>(st, a.codes + (long long)gc * a.ck * N + n0, N, ngc * a.ck, cols,
                   N % 16 == 0);
  if (a.mask != nullptr)
    copy_rows<kCols * 4>(st + l.mask, reinterpret_cast<const uint8_t*>(a.mask + gc * N + n0),
                         N * 4, ngc, cols * 4, N % 4 == 0);
  if constexpr (kScaleBytes > 0)
    copy_rows<kCols * kScaleBytes>(
        st + l.scale, static_cast<const uint8_t*>(a.scales) + (gc * N + n0) * kScaleBytes,
        N * kScaleBytes, ngc, cols * kScaleBytes, (N * kScaleBytes) % 16 == 0);
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// x rows [0, MB) x columns [gc 32, (gc + ngc) 32) in quads of 4 columns
// (k % 4 == 0, so every quad is an aligned 16-byte f32 or 8-byte bf16
// load); rows at or past M are 0. fetch_x issues the loads, put_x stores
// them as bf16-rounded f32 into the stage's [k][MB] x and says whether
// any of the thread's values is an inf or a NaN.
template <int MB>
__device__ __forceinline__ void fetch_x(uint4 (&raw)[kXQuads<MB>], const Args& a, int gc,
                                        int ngc) {
  const int kq = ngc * deca::kGroup / 4;
#pragma unroll
  for (int u = 0; u < kXQuads<MB>; ++u) {
    const int q = threadIdx.x + u * kThreads, m = q / kq;
    raw[u] = make_uint4(0u, 0u, 0u, 0u);
    if (q < MB * kq && m < a.M) {
      const long long i = (long long)m * a.K + gc * deca::kGroup + (q % kq) * 4;
      if (a.x_f32) {
        raw[u] = *reinterpret_cast<const uint4*>(static_cast<const float*>(a.x) + i);
      } else {
        const uint2 h = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(a.x) + i);
        raw[u] = make_uint4(h.x, h.y, 0u, 0u);
      }
    }
  }
}

template <int MB>
__device__ __forceinline__ bool put_x(float* xs, const uint4 (&raw)[kXQuads<MB>], int x_f32,
                                      int ngc) {
  const int kq = ngc * deca::kGroup / 4;
  bool nonfinite = false;
#pragma unroll
  for (int u = 0; u < kXQuads<MB>; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q < MB * kq) {
      const int m = q / kq, k = (q % kq) * 4;
      float v[4];
      if (x_f32) {
        v[0] = deca::round_bf16(__uint_as_float(raw[u].x));
        v[1] = deca::round_bf16(__uint_as_float(raw[u].y));
        v[2] = deca::round_bf16(__uint_as_float(raw[u].z));
        v[3] = deca::round_bf16(__uint_as_float(raw[u].w));
      } else {  // two bf16 a word, the lower one first
        v[0] = __uint_as_float(raw[u].x << 16);
        v[1] = __uint_as_float(raw[u].x & 0xFFFF0000u);
        v[2] = __uint_as_float(raw[u].y << 16);
        v[3] = __uint_as_float(raw[u].y & 0xFFFF0000u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xs[(k + e) * MB + m] = v[e];
        nonfinite |= (__float_as_uint(v[e]) & 0x7F800000u) == 0x7F800000u;  // inf, NaN
      }
    }
  }
  return nonfinite;
}

// One stored code of a column, code bytes kCols apart: value j's byte (two
// bytes for bf16, a nibble for the 4-bit codecs, even j the low one).
template <int kCodec>
__device__ __forceinline__ uint32_t load_code(const uint8_t* col, int j) {
  if constexpr (kCodec == deca::kBF16)
    return col[2 * j * kCols] | ((uint32_t)col[(2 * j + 1) * kCols] << 8);
  else if constexpr (kCodec == deca::kBF8 || kCodec == deca::kINT8)
    return col[j * kCols];
  else
    return (col[(j >> 1) * kCols] >> ((j & 1) * 4)) & 0xFu;
}

// The weight of a code: its value times the group scale, rounded to bf16,
// bitwise the plain version's bf16 operand. Integer codes widen through
// the f32 bits of 2^23 + code (no conversion instruction); bf16 and bf8
// codes, and mxfp4's E2M1 value times a power of two, are exact in bf16
// and need no rounding.
template <int kCodec>
__device__ __forceinline__ float code_weight(uint32_t c, float scale, const float* lut) {
  if constexpr (kCodec == deca::kBF16) {
    return deca::bf16_bits_value(c);
  } else if constexpr (kCodec == deca::kBF8) {
    return __half2float(__ushort_as_half((unsigned short)(c << 8)));
  } else if constexpr (kCodec == deca::kMXFP4) {
    return lut[c] * scale;
  } else {
    float v;
    if constexpr (kCodec == deca::kINT8)
      v = __uint_as_float(0x4B000000u | (c ^ 0x80u)) - 8388736.0f;  // 2^23 + 128
    else if constexpr (kCodec == deca::kINT4)
      v = __uint_as_float(0x4B000000u | (c ^ 0x8u)) - 8388616.0f;   // 2^23 + 8
    else
      v = lut[c];
    return deca::round_bf16(v * scale);
  }
}

template <int kCodec>
__device__ __forceinline__ float weight(const uint8_t* col, int j, float scale,
                                        const float* lut) {
  return code_weight<kCodec>(load_code<kCodec>(col, j), scale, lut);
}

// acc[m] += x[k][m] w for the MB rows of x at one position (16-byte loads)
template <int MB>
__device__ __forceinline__ void fma_row(float (&acc)[MB], const float* xk, float w) {
  if constexpr (MB == 1) {
    acc[0] = fmaf(xk[0], w, acc[0]);
  } else if constexpr (MB == 2) {
    const float2 v = *reinterpret_cast<const float2*>(xk);
    acc[0] = fmaf(v.x, w, acc[0]);
    acc[1] = fmaf(v.y, w, acc[1]);
  } else {
#pragma unroll
    for (int q = 0; q < MB / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(xk)[q];
      acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
      acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
    }
  }
}

// the position of the highest set bit of a nonzero word (one FLO)
__device__ __forceinline__ int top_bit(uint32_t v) {
  int pos;
  asm("bfind.u32 %0, %1;" : "=r"(pos) : "r"(v));
  return pos;
}

template <int kCodec>
constexpr bool kNibbles = kCodec == deca::kMXFP4 || kCodec >= deca::kINT4;

// One group of one column, its x rows at xg ([32][MB]). A sparse group's
// row i holds stored value min(popc(bits below i), k_cap - 1) where bit i
// is set, else +0 (kernels/ref.py).
template <int kCodec, int MB>
__device__ __forceinline__ void fold_group(float (&acc)[MB], const uint8_t* col,
                                           const float* xg, bool sparse, uint32_t bits,
                                           int k_cap, float scale, const float* lut) {
  if (!sparse) {  // stored value i is row i
#pragma unroll
    for (int i = 0; i < deca::kGroup; ++i)
      fma_row<MB>(acc, xg + i * MB, weight<kCodec>(col, i, scale, lut));
    return;
  }
  if constexpr (MB <= kSetBitMaxMB) {  // the set bits: cost follows the stored values
    const int n = __popc(bits);
    uint32_t rest = bits;
    if (n <= k_cap && !(kNibbles<kCodec> && (n & 1))) {
      // Each set bit has a stored value of its own: walk them from the top,
      // the highest taking stored value n - 1. A value costs one FLO (its
      // bit's position) and three integer ops (clear the bit, address x).
      // (The code pointer steps down with an upward count: nvcc 12.8
      // mis-addressed the remainder of a downward-counted unrolled loop.)
      if constexpr (kNibbles<kCodec>) {  // byte p holds values 2p (low) and 2p + 1
        const uint8_t* c = col + (n / 2 - 1) * kCols;
#pragma unroll 2
        for (int k = 0; k < n / 2; ++k, c -= kCols) {
          const uint32_t b = *c;
          int pos = top_bit(rest);
          rest ^= 1u << pos;
          fma_row<MB>(acc, xg + pos * MB, code_weight<kCodec>(b >> 4, scale, lut));
          pos = top_bit(rest);
          rest ^= 1u << pos;
          fma_row<MB>(acc, xg + pos * MB, code_weight<kCodec>(b & 0xFu, scale, lut));
        }
      } else {
        constexpr int kStep = kCodec == deca::kBF16 ? 2 * kCols : kCols;  // rows a value
        const uint8_t* c = col + (n - 1) * kStep;
#pragma unroll 4
        for (int k = 0; k < n; ++k, c -= kStep) {
          const int pos = top_bit(rest);
          rest ^= 1u << pos;
          fma_row<MB>(acc, xg + pos * MB, weight<kCodec>(c, 0, scale, lut));
        }
      }
      return;
    }
    // more set bits than stored values (those past k_cap repeat value
    // k_cap - 1), or an odd count of nibbles: from the bottom
    for (int j = 0; rest != 0u; ++j) {
      const uint32_t next = rest & (rest - 1u);
      fma_row<MB>(acc, xg + top_bit(rest ^ next) * MB,
                  weight<kCodec>(col, j < k_cap ? j : k_cap - 1, scale, lut));
      rest = next;
    }
  } else {  // the positions: x is one broadcast load a warp; no branch
    int j = 0;
#pragma unroll
    for (int i = 0; i < deca::kGroup; ++i) {
      const bool on = (bits >> i) & 1u;
      const float w = weight<kCodec>(col, j < k_cap ? j : k_cap - 1, scale, lut);
      j += on;
      fma_row<MB>(acc, xg + i * MB, on ? w : 0.0f);
    }
  }
}

// x * +0 at every clear position of this thread's sparse groups of a chunk:
// the products the set-bit walk leaves out, exact to leave out unless x is
// an inf or a NaN there, where the plain version's x * +0 is NaN. Run only
// for a chunk whose x is not finite, so its loop stays rolled.
template <int MB>
__device__ __forceinline__ void add_clear_positions(float (&acc)[MB], const uint8_t* xs,
                                                    const uint32_t* ms, int ngc, int half,
                                                    int col) {
  for (int gl = half; gl < ngc; gl += 2) {
    const uint32_t clear = ~ms[gl * kCols + col];
    const float* xg = reinterpret_cast<const float*>(xs + gl * deca::kGroup * MB * 4);
#pragma unroll 1
    for (int i = 0; i < deca::kGroup; ++i)
      if ((clear >> i) & 1u) fma_row<MB>(acc, xg + i * MB, 0.0f);
  }
}

template <int kCodec, int MB>
__global__ void __launch_bounds__(kThreads, kMinCtas<MB>) gemv_kernel(Args a) {
  constexpr int kScaleBytes = scale_bytes_of(kCodec);
  extern __shared__ __align__(16) uint8_t smem[];
  const bool sparse = a.mask != nullptr;
  const Layout l = layout(a.chunk, a.ck, sparse, kScaleBytes, MB);
  const int t = threadIdx.x, col = t % kCols, half = t / kCols;
  const long long n0 = (long long)blockIdx.x * kCols;
  const int cols = (int)min((long long)kCols, a.N - n0);
  const int g_begin = blockIdx.y * a.groups_per_split;
  const int g_end = min(a.K / deca::kGroup, g_begin + a.groups_per_split);
  const int n_chunks = (g_end - g_begin + a.chunk - 1) / a.chunk;
  float* lut = reinterpret_cast<float*>(smem + l.lut);
  if constexpr (kCodec == deca::kNF4 || kCodec == deca::kMXFP4) {
    if (t < 16) lut[t] = kCodec == deca::kNF4 ? deca::kNF4Lut[t] : deca::fp4_value(t);
  }
  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.0f;

  uint4 raw[kXQuads<MB>];
  issue_planes<kScaleBytes>(smem, l, a, g_begin, min(a.chunk, g_end - g_begin), n0, cols);
  fetch_x<MB>(raw, a, g_begin, min(a.chunk, g_end - g_begin));
  bool bad_x = put_x<MB>(reinterpret_cast<float*>(smem + l.x), raw, a.x_f32,
                         min(a.chunk, g_end - g_begin));
  for (int c = 0; c < n_chunks; ++c) {
    const int gc = g_begin + c * a.chunk, ngc = min(a.chunk, g_end - gc);
    uint8_t* cur = smem + (c & 1) * l.stage;
    uint8_t* nxt = smem + ((c + 1) & 1) * l.stage;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    // chunk c landed, and every thread is done with chunk c - 1; the same
    // barrier tells every thread whether chunk c's x holds an inf or a NaN
    const bool nonfinite = __syncthreads_or(bad_x);
    const bool more = c + 1 < n_chunks;
    const int ngn = more ? min(a.chunk, g_end - gc - a.chunk) : 0;
    if (more) {  // chunk c + 1 into the stage chunk c - 1 used, in flight while c decodes
      issue_planes<kScaleBytes>(nxt, l, a, gc + a.chunk, ngn, n0, cols);
      fetch_x<MB>(raw, a, gc + a.chunk, ngn);
    }
    const uint32_t* ms = reinterpret_cast<const uint32_t*>(cur + l.mask);
    for (int gl = half; gl < ngc; gl += 2) {
      const int gi = gl * kCols + col;
      float scale = 1.0f;
      if constexpr (kScaleBytes == 1) scale = deca::e8m0_value(cur[l.scale + gi]);
      if constexpr (kScaleBytes == 2)
        scale = deca::bf16_bits_value(reinterpret_cast<const uint16_t*>(cur + l.scale)[gi]);
      const float* xg = reinterpret_cast<const float*>(cur + l.x + gl * deca::kGroup * MB * 4);
      fold_group<kCodec, MB>(acc, cur + gl * a.ck * kCols + col, xg, sparse,
                             sparse ? ms[gi] : 0u, a.k_cap, scale, lut);
    }
    if constexpr (MB <= kSetBitMaxMB) {
      if (sparse && nonfinite) add_clear_positions<MB>(acc, cur + l.x, ms, ngc, half, col);
    }
    if (more) bad_x = put_x<MB>(reinterpret_cast<float*>(nxt + l.x), raw, a.x_f32, ngn);
  }
  __syncthreads();  // every fold is done: the ring holds the halves' sums now
  float* part = reinterpret_cast<float*>(smem);
  if (half == 1) {
#pragma unroll
    for (int m = 0; m < MB; ++m) part[m * kCols + col] = acc[m];
  }
  __syncthreads();
  if (half == 1 || col >= cols) return;
  for (int m = 0; m < MB && m < a.M; ++m) {
    const float v = acc[m] + part[m * kCols + col];  // half 0's groups, then half 1's
    const long long i = (long long)m * a.N + n0 + col;
    if (a.ws != nullptr)
      a.ws[(long long)blockIdx.y * a.M * a.N + i] = v;
    else if (a.out_f32)
      static_cast<float*>(a.out)[i] = v;
    else
      static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
  }
}

__global__ void splitk_reduce(const float* ws, int splits, long long mn,
                              void* out, int out_f32) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += ws[(long long)k * mn + i];
  if (out_f32) ((float*)out)[i] = s;
  else ((__nv_bfloat16*)out)[i] = __float2bfloat16_rn(s);
}

template <int kCodec, int MB>
cudaError_t launch_gemv(const Args& a, int splits, int smem, cudaStream_t stream) {
  // once per instance: the whole carveout for shared memory, so that as
  // many CTAs fit an SM as their shared bytes allow; then opt in above 48 KB
  static int opted_in = -1;
  if (smem > opted_in) {
    cudaError_t err = cudaSuccess;
    if (opted_in < 0)
      err = cudaFuncSetAttribute(gemv_kernel<kCodec, MB>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(gemv_kernel<kCodec, MB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem > 48 * 1024 ? smem : 48 * 1024;
  }
  dim3 grid((a.N + kCols - 1) / kCols, splits);
  gemv_kernel<kCodec, MB><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MB>
cudaError_t launch_for_codec(int codec, const Args& a, int splits, int smem, cudaStream_t s) {
  switch (codec) {
    case deca::kBF16: return launch_gemv<deca::kBF16, MB>(a, splits, smem, s);
    case deca::kBF8: return launch_gemv<deca::kBF8, MB>(a, splits, smem, s);
    case deca::kMXFP4: return launch_gemv<deca::kMXFP4, MB>(a, splits, smem, s);
    case deca::kINT8: return launch_gemv<deca::kINT8, MB>(a, splits, smem, s);
    case deca::kINT4: return launch_gemv<deca::kINT4, MB>(a, splits, smem, s);
    case deca::kNF4: return launch_gemv<deca::kNF4, MB>(a, splits, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The plan (splits, chunk groups a ring stage, shared bytes) comes from
// kernels/autotune.py; ws holds splits x M x N floats when splits > 1 and
// may be null otherwise.
extern "C" int deca_gemv(const void* x, int x_f32, const void* codes,
                         const void* mask, const void* scales, int codec,
                         int k_cap, int ck, int M, int K, int N, int splits,
                         int chunk, int smem, void* ws, void* out, int out_f32,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int ng = K / deca::kGroup;
  if (M < 1 || M > 32 || K % deca::kGroup != 0 || N < 1 || splits < 1 || chunk < 1 ||
      ck < 1 || codec < deca::kBF16 || codec > deca::kNF4 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per = (ng + splits - 1) / splits;
  if ((ng + per - 1) / per != splits)  // every split owns >= 1 group
    return (int)cudaErrorInvalidValue;
  const int mb = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : M <= 16 ? 16 : 32;
  const Layout l = layout(chunk, ck, mask != nullptr, scale_bytes_of(codec), mb);
  if (l.total != smem || smem > kMaxSmem || chunk * 32 * mb / 4 > (mb <= 4 ? 1 : 2) * kThreads)
    return (int)cudaErrorInvalidValue;
  Args a{x, (const uint8_t*)codes, (const int32_t*)mask, scales, out,
         splits > 1 ? (float*)ws : nullptr, x_f32, out_f32, k_cap, ck, M, K, N, per, chunk};
  cudaError_t err;
  switch (mb) {
    case 1: err = launch_for_codec<1>(codec, a, splits, smem, s); break;
    case 2: err = launch_for_codec<2>(codec, a, splits, smem, s); break;
    case 4: err = launch_for_codec<4>(codec, a, splits, smem, s); break;
    case 8: err = launch_for_codec<8>(codec, a, splits, smem, s); break;
    case 16: err = launch_for_codec<16>(codec, a, splits, smem, s); break;
    default: err = launch_for_codec<32>(codec, a, splits, smem, s); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  splitk_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>((const float*)ws, splits, mn,
                                                             out, out_f32);
  return (int)cudaGetLastError();
}
