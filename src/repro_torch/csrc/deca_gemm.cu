// DECA decode GeMV for Hopper (sm_90a).
//
// Replaces repro/kernels/deca_gemm.py::decompress_gemv_pallas (decode,
// M <= 32; body _gemm_kernel). It computes out (M, N) = bf16(x) @
// bf16(decompress(W)) with f32 accumulation and stores once in the output
// type. The dense weight never exists in device memory: a CTA stages a tile
// of the compressed triplet (codes, mask bits, scale bits) in shared memory,
// and each thread decodes one (group, column) of it with deca::decode_column
// right before use. The prefill GeMM (M > 32) is deca_gemm_sm90.cu.
//
// What bounds it, and what the design does about it. Code bytes of one
// column are N apart, so a thread that fetched its own column byte by byte
// would wait a full memory latency per byte (the first version of these
// kernels did, and ran at 2-5 % of the memory rate). Instead every tile is
// copied cooperatively: neighbouring threads fetch neighbouring 16-byte
// pieces of a code row, and each thread issues a batch of kBatch loads
// before it stores any, so many loads are in flight per thread.
//
// Bound by device-memory bytes: the compressed weight stream (about 5 bits
// per weight at bf8_50) dwarfs x and out. A CTA owns 128 output columns,
// one per thread, and walks its K range in chunks of up to 8 groups: stage
// the chunk's codes, masks, scales and x rows, then each thread decodes its
// column group by group and keeps M f32 sums in registers. When 128-column
// blocks give too few CTAs for 132 SMs (N = 1024 gives 8), K is split over
// gridDim.y CTAs that write f32 partials to a workspace, and a second pass
// sums them in split order, so the result is deterministic.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
