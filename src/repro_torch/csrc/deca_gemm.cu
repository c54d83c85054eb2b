// Fused DECA decompression + matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/deca_gemm.py: decompress_gemv_pallas (decode,
// M <= 32) and decompress_gemm_pallas (prefill, M > 32), body _gemm_kernel.
// Both compute out (M, N) = bf16(x) @ bf16(decompress(W)) with f32
// accumulation and store once in the output type. The dense weight never
// exists in device memory: a CTA stages a tile of the compressed triplet
// (codes, mask bits, scale bits) in shared memory, and each thread decodes
// one (group, column) of it with deca::decode_column right before use.
//
// What bounds them, and what the design does about it. Code bytes of one
// column are N apart, so a thread that fetched its own column byte by byte
// would wait a full memory latency per byte (the first version of these
// kernels did, and ran at 2-5 % of the memory rate). Instead every tile is
// copied cooperatively: neighbouring threads fetch neighbouring 16-byte
// pieces of a code row, and each thread issues a batch of kBatch loads
// before it stores any, so many loads are in flight per thread.
//
// GeMV. Bound by device-memory bytes: the compressed weight stream (about
// 5 bits per weight at bf8_50) dwarfs x and out. A CTA owns 128 output
// columns, one per thread, and walks its K range in chunks of up to 8
// groups: stage the chunk's codes, masks, scales and x rows, then each
// thread decodes its column group by group and keeps M f32 sums in
// registers. When 128-column blocks give too few CTAs for 132 SMs (N = 1024
// gives 8), K is split over gridDim.y CTAs that write f32 partials to a
// workspace, and a second pass sums them in split order, so the result is
// deterministic.
//
// GeMM. Bound by the tensor cores at prefill sizes. A CTA computes a 64x64
// output tile with 8 warps, each holding two 16x16 f32 WMMA accumulators.
// Per K step of 128 rows (4 groups) it stages x (cast to bf16) and the
// compressed tile, the 256 threads decode one (group, column) each into a
// bf16 shared tile, and the warps run WMMA bf16 16x16x16 over it. TMA,
// wgmma and a producer/consumer pipeline that overlaps the decode with the
// MMA are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "deca_tile.cuh"

namespace {

constexpr int kBatch = 8;         // loads a thread issues before it stores
constexpr int kGemvCols = 128;    // columns (threads) per GeMV CTA
constexpr int kChunkGroups = 8;   // groups staged per GeMV chunk, at most
constexpr int kCodeBytes = 16384; // code staging budget of a GeMV chunk

__device__ __forceinline__ float load_x(const void* x, int x_f32, long long i) {
  return x_f32 ? ((const float*)x)[i]
               : __bfloat162float(((const __nv_bfloat16*)x)[i]);
}

// Copy `rows` rows of a row-major byte matrix (row stride n_cols), columns
// [n0, n0 + W), into shared `dst` with pitch W; columns at or past `cols`
// read as 0. 16-byte loads when every row is a whole, aligned W-byte run.
template <int W, int THREADS>
__device__ __forceinline__ void stage_code_rows(
    uint8_t* dst, const uint8_t* src, long long row0, int rows,
    long long n_cols, long long n0, int cols) {
  if (cols == W && n_cols % 16 == 0) {
    constexpr int Q = W / 16;
    const int total = rows * Q;
    for (int base = threadIdx.x; base < total; base += THREADS * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * THREADS;
        if (i < total)
          v[u] = *reinterpret_cast<const uint4*>(
              src + (row0 + i / Q) * n_cols + n0 + (i % Q) * 16);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * THREADS;
        if (i < total) reinterpret_cast<uint4*>(dst)[i] = v[u];
      }
    }
    return;
  }
  const int total = rows * W;
  for (int base = threadIdx.x; base < total; base += THREADS * kBatch) {
    uint8_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * THREADS, c = i % W;
      v[u] = (i < total && c < cols) ? src[(row0 + i / W) * n_cols + n0 + c] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * THREADS;
      if (i < total) dst[i] = v[u];
    }
  }
}

// Mask and scale bits of `ngroups` groups from g0, columns [n0, n0 + W),
// into shared [group][column] arrays (0 past `cols` or where absent).
template <int W, int THREADS>
__device__ __forceinline__ void stage_group_bits(
    uint32_t* ms, uint32_t* ss, const int32_t* mask, const void* scales,
    int codec, int g0, int ngroups, long long n_cols, long long n0, int cols) {
  const int total = ngroups * W;
  const bool e8m0 = codec == deca::kMXFP4;
  for (int base = threadIdx.x; base < total; base += THREADS * kBatch) {
    uint32_t mv[kBatch], sv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * THREADS, c = i % W;
      const bool ok = i < total && c < cols;
      const long long gn = (long long)(g0 + i / W) * n_cols + n0 + c;
      mv[u] = (ok && mask != nullptr) ? (uint32_t)mask[gn] : 0u;
      sv[u] = (ok && scales != nullptr)
                  ? (e8m0 ? (uint32_t)((const uint8_t*)scales)[gn]
                          : (uint32_t)((const uint16_t*)scales)[gn])
                  : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * THREADS;
      if (i < total) {
        ms[i] = mv[u];
        ss[i] = sv[u];
      }
    }
  }
}

// rows [m0, m0 + rows) x columns [k0, k0 + W) of x (row stride K) as bf16
// into shared `dst` (pitch `pitch`, a multiple of 8), zero outside
// [0, M) x [0, k_end); k0 and k_end are whole groups. 16-byte loads when
// rows are whole 16-byte runs.
template <int W, int THREADS>
__device__ __forceinline__ void stage_x(__nv_bfloat16* dst, int pitch,
                                        const void* x, int x_f32, int rows,
                                        int M, int K, long long m0, int k0,
                                        int k_end) {
  if (!x_f32 && K % 8 == 0) {  // 8 bf16 per load
    constexpr int Q = W / 8;
    const int total = rows * Q;
    for (int base = threadIdx.x; base < total; base += THREADS * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * THREADS;
        const long long m = m0 + i / Q;
        const int k = k0 + (i % Q) * 8;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && m < M && k < k_end)
          v[u] = *reinterpret_cast<const uint4*>((const __nv_bfloat16*)x + m * K + k);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * THREADS;
        if (i < total)
          *reinterpret_cast<uint4*>(dst + (i / Q) * pitch + (i % Q) * 8) = v[u];
      }
    }
    return;
  }
  if (x_f32 && K % 4 == 0) {  // 4 f32 per load, rounded to bf16
    constexpr int Q = W / 4;
    const int total = rows * Q;
    for (int base = threadIdx.x; base < total; base += THREADS * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * THREADS;
        const long long m = m0 + i / Q;
        const int k = k0 + (i % Q) * 4;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < total && m < M && k < k_end)
          v[u] = *reinterpret_cast<const float4*>((const float*)x + m * K + k);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * THREADS;
        if (i < total) {
          __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(
              dst + (i / Q) * pitch + (i % Q) * 4);
          d[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
          d[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
        }
      }
    }
    return;
  }
  const int total = rows * W;
  for (int base = threadIdx.x; base < total; base += THREADS * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * THREADS;
      const long long m = m0 + i / W;
      const int k = k0 + i % W;
      v[u] = (i < total && m < M && k < k_end) ? load_x(x, x_f32, m * K + k) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * THREADS;
      if (i < total) dst[(i / W) * pitch + i % W] = __float2bfloat16_rn(v[u]);
    }
  }
}

template <int MB>
__global__ void __launch_bounds__(kGemvCols)
gemv_kernel(const void* x, int x_f32, const uint8_t* codes,
            const int32_t* mask, const void* scales, int codec, int k_cap,
            int ck, int M, int K, int N, int groups_per_split,
            int chunk_groups, float* ws) {
  __shared__ __align__(16) uint8_t cs[kCodeBytes];
  __shared__ uint32_t ms[kChunkGroups * kGemvCols];
  __shared__ uint32_t ss[kChunkGroups * kGemvCols];
  __shared__ __align__(16) __nv_bfloat16 xs[MB][kChunkGroups * deca::kGroup];
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * kGemvCols;
  const int cols = (int)min((long long)kGemvCols, N - n0);
  const int ng = K / deca::kGroup;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(ng, g_begin + groups_per_split);
  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.0f;

  for (int gc = g_begin; gc < g_end; gc += chunk_groups) {
    const int ngc = min(chunk_groups, g_end - gc);
    __syncthreads();  // the previous chunk is consumed
    stage_code_rows<kGemvCols, kGemvCols>(cs, codes, (long long)gc * ck, ngc * ck,
                                          N, n0, cols);
    stage_group_bits<kGemvCols, kGemvCols>(ms, ss, mask, scales, codec, gc, ngc,
                                           N, n0, cols);
    stage_x<kChunkGroups * deca::kGroup, kGemvCols>(
        &xs[0][0], kChunkGroups * deca::kGroup, x, x_f32, MB, M, K, 0,
        gc * deca::kGroup, (gc + ngc) * deca::kGroup);
    __syncthreads();
    if (tid < cols) {
      for (int gl = 0; gl < ngc; ++gl) {
        float w[deca::kGroup];
        const int gi = gl * kGemvCols + tid;
        deca::decode_column(codec, cs + gl * ck * kGemvCols + tid, kGemvCols,
                            k_cap, mask != nullptr, ms[gi], scales != nullptr,
                            deca::scale_value(codec, scales != nullptr, ss[gi]), w);
#pragma unroll
        for (int i = 0; i < deca::kGroup; ++i) {
#pragma unroll
          for (int m = 0; m < MB; ++m)
            acc[m] = fmaf(__bfloat162float(xs[m][gl * deca::kGroup + i]), w[i], acc[m]);
        }
      }
    }
  }
  if (tid < cols) {
    for (int m = 0; m < M && m < MB; ++m)
      ws[((long long)blockIdx.y * M + m) * N + n0 + tid] = acc[m];
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

template <int MB>
cudaError_t launch_gemv(const void* x, int x_f32, const uint8_t* codes,
                        const int32_t* mask, const void* scales, int codec,
                        int k_cap, int ck, int M, int K, int N, int splits,
                        float* ws, cudaStream_t stream) {
  const int ng = K / deca::kGroup;
  const int per = (ng + splits - 1) / splits;
  const int used = (ng + per - 1) / per;  // splits that own >= 1 group
  const int chunk = max(1, min(kChunkGroups, kCodeBytes / (ck * kGemvCols)));
  if (used != splits || ck * kGemvCols > kCodeBytes) return cudaErrorInvalidValue;
  dim3 grid((N + kGemvCols - 1) / kGemvCols, splits);
  gemv_kernel<MB><<<grid, kGemvCols, 0, stream>>>(
      x, x_f32, codes, mask, scales, codec, k_cap, ck, M, K, N, per, chunk, ws);
  return cudaGetLastError();
}

namespace wmma = nvcuda::wmma;
constexpr int kBM = 64, kBN = 64, kBK = 128, kGemmThreads = 256;
constexpr int kKGroups = kBK / deca::kGroup;  // groups per K step
constexpr int kAPitch = kBK + 8;   // bf16 elements; multiple of 8 for WMMA
constexpr int kBPitch = kBN + 8;
constexpr int kCPitch = kBN + 4;   // f32 elements; multiple of 4
constexpr int kABytes = kBM * kAPitch * 2;
constexpr int kBBytes = kBK * kBPitch * 2;
constexpr int kStageBytes = kKGroups * 64 * kBN;  // codes, ck <= 64
constexpr int kBitsBytes = 2 * kKGroups * kBN * 4;
constexpr int kCBytes = kBM * kCPitch * 4;
constexpr int kLoopBytes = kABytes + kBBytes + kStageBytes + kBitsBytes;
constexpr int kGemmSmem = kLoopBytes > kCBytes ? kLoopBytes : kCBytes;

__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const void* x, int x_f32, const uint8_t* codes,
            const int32_t* mask, const void* scales, int codec, int k_cap,
            int ck, int M, int K, int N, void* out, int out_f32) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + kABytes);
  uint8_t* cs = smem + kABytes + kBBytes;
  uint32_t* ms = reinterpret_cast<uint32_t*>(cs + kStageBytes);
  uint32_t* ss = ms + kKGroups * kBN;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps over 64 x 64
  const long long m0 = (long long)blockIdx.y * kBM;
  const long long n0 = (long long)blockIdx.x * kBN;
  const int cols = (int)min((long long)kBN, N - n0);
  const int ng = K / deca::kGroup;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  wmma::fill_fragment(c[0], 0.0f);
  wmma::fill_fragment(c[1], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int g0 = k0 / deca::kGroup;
    const int ngs = min(kKGroups, ng - g0);
    stage_x<kBK, kGemmThreads>(As, kAPitch, x, x_f32, kBM, M, K, m0, k0, K);
    stage_code_rows<kBN, kGemmThreads>(cs, codes, (long long)g0 * ck, ngs * ck,
                                       N, n0, cols);
    stage_group_bits<kBN, kGemmThreads>(ms, ss, mask, scales, codec, g0, ngs,
                                        N, n0, cols);
    __syncthreads();
    {
      const int gl = tid / kBN, cl = tid % kBN;  // 4 groups x 64 columns
      float w[deca::kGroup];
      if (gl < ngs && cl < cols) {
        const int gi = gl * kBN + cl;
        deca::decode_column(codec, cs + gl * ck * kBN + cl, kBN, k_cap,
                            mask != nullptr, ms[gi], scales != nullptr,
                            deca::scale_value(codec, scales != nullptr, ss[gi]), w);
      } else {
#pragma unroll
        for (int i = 0; i < deca::kGroup; ++i) w[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < deca::kGroup; ++i)
        Bs[(gl * deca::kGroup + i) * kBPitch + cl] = __float2bfloat16_rn(w[i]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + (wm * 16) * kAPitch + kk, kAPitch);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * kBPitch + wn * 32 + j * 16, kBPitch);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + (wm * 16) * kCPitch + wn * 32 + j * 16, c[j],
                            kCPitch, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kGemmThreads) {
    const int r = i / kBN, cc = i % kBN;
    const long long gm = m0 + r, gn = n0 + cc;
    if (gm < M && gn < N) {
      const float v = Cs[r * kCPitch + cc];
      if (out_f32) ((float*)out)[gm * N + gn] = v;
      else ((__nv_bfloat16*)out)[gm * N + gn] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

extern "C" int deca_gemv(const void* x, int x_f32, const void* codes,
                         const void* mask, const void* scales, int codec,
                         int k_cap, int ck, int M, int K, int N, int splits,
                         void* ws, void* out, int out_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* c = (const uint8_t*)codes;
  const int32_t* mk = (const int32_t*)mask;
  float* w = (float*)ws;
  cudaError_t err;
  if (M <= 1) err = launch_gemv<1>(x, x_f32, c, mk, scales, codec, k_cap, ck, M, K, N, splits, w, s);
  else if (M <= 2) err = launch_gemv<2>(x, x_f32, c, mk, scales, codec, k_cap, ck, M, K, N, splits, w, s);
  else if (M <= 4) err = launch_gemv<4>(x, x_f32, c, mk, scales, codec, k_cap, ck, M, K, N, splits, w, s);
  else if (M <= 8) err = launch_gemv<8>(x, x_f32, c, mk, scales, codec, k_cap, ck, M, K, N, splits, w, s);
  else if (M <= 16) err = launch_gemv<16>(x, x_f32, c, mk, scales, codec, k_cap, ck, M, K, N, splits, w, s);
  else if (M <= 32) err = launch_gemv<32>(x, x_f32, c, mk, scales, codec, k_cap, ck, M, K, N, splits, w, s);
  else return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const long long mn = (long long)M * N;
  splitk_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(w, splits, mn, out, out_f32);
  return (int)cudaGetLastError();
}

extern "C" int deca_gemm(const void* x, int x_f32, const void* codes,
                         const void* mask, const void* scales, int codec,
                         int k_cap, int ck, int M, int K, int N, void* out,
                         int out_f32, void* stream) {
  if (ck > 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<<<grid, kGemmThreads, kGemmSmem, (cudaStream_t)stream>>>(
      x, x_f32, (const uint8_t*)codes, (const int32_t*)mask, scales, codec,
      k_cap, ck, M, K, N, out, out_f32);
  return (int)cudaGetLastError();
}
