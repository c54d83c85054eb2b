// Prefill GeMM with DECA decompression for Hopper (sm_90a): TMA ring,
// warp-specialized decode, wgmma.
//
// Replaces repro/kernels/deca_gemm.py::decompress_gemm_pallas (body
// _gemm_kernel, tile decode deca_decompress.py::decompress_block). It
// computes out (M, N) = bf16(x) @ bf16(decompress(W)) for M > 32 with f32
// accumulation and stores once in f32 or bf16. The dense weight never
// exists in device memory: each (BK x BN) weight tile is decoded from the
// compressed triplet straight into the bf16 operand ring in shared memory.
//
// What bounds it. At prefill sizes the product is far above the card's
// ridge (gate/up at M = 2048: 240.5 GFLOP against 36.7 MB of compressed
// weight), so the tensor cores would bound it, but every weight has to be
// decoded first, on the vector units, once per BM rows of x. This is the
// corner of the paper's 3D roofline where decode throughput, not memory or
// the matrix engine, sets the pace, and the tile shape is chosen so that
// the decode of a stage can hide under its MMA:
//
//   One stage is BK = 64 rows of K (2 compression groups) x BN = 128
//   columns: 8192 weights, 32 a decoder thread (one group of one column).
//   At ~10 instructions a value for a 50 %-sparse bf8 group (mask bit,
//   popc, clamp, shared-byte load, f16 widen, zero select, half a bf16
//   pack), that is ~320 issue cycles for each decoder warp, two on each of
//   the SM's 4 schedulers: ~640 cycles. The MMA of the stage is
//   2 BM BN BK flops; at 989 TFLOP/s / 132 SMs = 7.49 TFLOP/s per SM and
//   1.755 GHz:
//     BM = 128:  2.10 MFLOP = 0.28 us =  490 cycles  < 640: decode-bound
//     BM = 256:  4.19 MFLOP = 0.56 us =  980 cycles  > 640: decode hidden
//   So BM = 256: the decode per flop halves against BM = 128, and each
//   weight is decoded M / 256 times (8 at M = 2048, against 32 in the
//   64 x 64 WMMA kernel this replaces). BK = 128 would double both sides
//   and a 64 KB x stage leaves room for only 2 load stages.
//   On the H100 the kernel runs at well under a third of the tensor
//   cores' rate all the same (chip_smoke.py prints it; PERF.md): the
//   decode does not hide as this count of issue slots predicts.
//
// Roles (640 threads, one CTA per SM at 146-182 KB of shared memory):
//   warpgroup 0  producer: one thread keeps a ring of kLoadStages stages in
//                flight with TMA: the x tile (BM x BK bf16, 128-byte
//                swizzle), the code rows of the stage's 2 groups (2 ck x BN
//                bytes), their mask words and scale bits; OOB rows and
//                columns (ragged M, N, an odd group count) arrive as zeros.
//   warpgroups 1-2  decoders: thread t of decoder d decodes column t of
//                group d of a stage and writes its 32 bf16 values, K
//                contiguous, into row t of the B ring stage in the
//                canonical 128-byte-swizzled K-major layout that the wgmma
//                B descriptor names (16-byte chunk c of row t at
//                c ^ (t & 7)): the TMA tile of x has the same layout. A
//                dense group is decoded with deca::decode_column; a sparse
//                one walks its set mask bits (scatter_group), so its cost
//                follows the stored values, not the 32 positions.
//   warpgroups 3-4  consumers: each owns 128 rows of the tile (two m64
//                wgmmas, n128, k16, f32 accumulators in registers) and
//                releases the load stage and the B stage when its wgmmas
//                are done.
// setmaxnreg moves registers from the producer (24) and decoders (56) to
// the consumers (168), which hold 128 f32 accumulators each.
#include <cstdint>
#include <cstring>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "deca_tile.cuh"

namespace {

constexpr int kBM = 256, kBN = 128, kBK = 64;
constexpr int kKGroups = kBK / deca::kGroup;  // compression groups per stage
constexpr int kLoadStages = 3, kOpStages = 2;
constexpr int kDecoders = 2;                         // decoder warpgroups
constexpr int kThreads = 128 * (1 + kDecoders + 2);  // + producer, 2 consumers
// Registers per thread after setmaxnreg. The CTA keeps what it got at
// launch, 96 a thread (65536 / 640 in steps of 8): 24 + 2 x 56 + 2 x 168
// = 472 <= 5 x 96 per thread of a warpgroup.
constexpr int kProducerRegs = 24, kDecoderRegs = 56, kConsumerRegs = 168;
constexpr int kABytes = kBM * kBK * 2;               // x tile, bf16
constexpr int kBBytes = kBN * kBK * 2;               // decoded weight tile, bf16
constexpr int kMaskBytes = kKGroups * kBN * 4;
constexpr int kScaleBytes = kKGroups * kBN * 2;      // room for bf16 bits
constexpr int kBarBytes = 8 * 2 * (kLoadStages + kOpStages);

// Shared bytes for code bytes per group `ck`: 1 KB of alignment slack, the
// B ring, then per load stage x, codes, mask and scales, then the barriers.
// Per load stage at ck = 16 / 32 / 64 (bf8_50 or 4-bit dense / bf8 or int8
// dense / bf16 dense): 37.5 / 41.5 / 49.5 KiB; the CTA 145.6 / 157.6 /
// 181.6 KiB, so a fourth load stage would not fit the widest codes.
__host__ __device__ constexpr int smem_bytes(int ck) {
  return 1024 + kOpStages * kBBytes +
         kLoadStages * (kABytes + kKGroups * ck * kBN + kMaskBytes + kScaleBytes) +
         kBarBytes;
}
constexpr int kMaxSmem = 227 * 1024;  // per-CTA ceiling on Hopper
static_assert(smem_bytes(64) <= kMaxSmem, "the widest codes must fit one CTA");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

// Wait for the phase of `parity` to complete. A ring that never fills is a
// fault of the kernel: after ~10 s of polling it traps (a launch error)
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// 2D TMA tile load: box at (c0 innermost, c1) into dst, completion to bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0,
                                         int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte-swizzle
// atoms (8 rows of 128 bytes = 1024 bytes, atoms 1024 bytes apart): start
// address >> 4, LBO 1 (unused by swizzled K-major), SBO 1024 >> 4, layout
// type 1 (SWIZZLE_128B). A k16 step inside the atom adds 32 bytes to the
// start: the hardware applies the swizzle to the full address, and every
// ring stage is 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128 f32, this thread's 64) += A (64 x 16 bf16) * B (16 x 128 bf16),
// both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Rings {
  uint8_t* b;       // kOpStages decoded tiles
  uint8_t* a;       // kLoadStages x tiles
  uint8_t* codes;   // kLoadStages code tiles of code_bytes
  uint8_t* mask;
  uint8_t* scales;
  uint64_t* full;   // load stage landed (TMA transaction bytes)
  uint64_t* empty;  // load stage consumed (decoder threads + consumer warpgroups)
  uint64_t* bfull;  // decoded stage written (decoder threads)
  uint64_t* bempty; // decoded stage consumed (consumer warpgroups)
  int code_bytes;
};

// A sparse group of the thread's column, written straight into its row of
// the decoded tile: the group's 32 bf16 are zeroed, then the j-th stored
// value goes to the position of the j-th set mask bit, found by walking the
// set bits (ffs, clear lowest) instead of a popc per position; set bits past
// k_cap take stored value k_cap - 1. That is decode_column's expansion
// (min(popc(bits & ((1 << i) - 1)), k_cap - 1) for set bit i, +0 where
// clear) with the same code_value * scale and one round-to-nearest to
// bf16, so the operand is the same bits; the work follows the k_cap stored
// values, not the 32 positions. `sw` is the swizzle of the group's four
// 16-byte chunks in the row (chunk c of the group at c ^ sw).
template <int kCodec>
__device__ __forceinline__ void scatter_group(uint8_t* row, int gl, int t, const uint8_t* col,
                                              int k_cap, uint32_t bits, bool scaled,
                                              float scale) {
  const int sw = (gl * 4) ^ (t & 7);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<uint4*>(row + ((c ^ sw) << 4)) = make_uint4(0u, 0u, 0u, 0u);
  uint32_t rest = bits;
#pragma unroll 4
  for (int j = 0; j < k_cap; ++j) {
    if (rest == 0u) break;
    const int pos = __ffs(rest) - 1;
    rest &= rest - 1u;
    float v = deca::code_value(kCodec, col, j, kBN);
    if (scaled) v *= scale;
    *reinterpret_cast<__nv_bfloat16*>(row + (((pos >> 3) ^ sw) << 4) + ((pos & 7) << 1)) =
        __float2bfloat16_rn(v);
  }
  if (rest != 0u) {
    float v = deca::code_value(kCodec, col, k_cap - 1, kBN);
    if (scaled) v *= scale;
    const __nv_bfloat16 hv = __float2bfloat16_rn(v);
    while (rest != 0u) {
      const int pos = __ffs(rest) - 1;
      rest &= rest - 1u;
      *reinterpret_cast<__nv_bfloat16*>(row + (((pos >> 3) ^ sw) << 4) + ((pos & 7) << 1)) = hv;
    }
  }
}

// A decoder warpgroup's loop with the codec fixed at compile time, so the
// per-value codec switch of deca::code_value folds away. Thread t owns
// column t of the tile and decoder `dec` group `dec` of each stage. A dense
// group goes through decode_column<false>, which keeps the f32 product of
// code and scale; the one round-to-nearest pack to bf16 gives the bits of
// decode_column<true> (the plain version's bf16 operand). A sparse group
// goes through scatter_group.
template <int kCodec>
__device__ __forceinline__ void decode_loop(const Rings& r, int dec, int t, int n_k, int ng,
                                            int k_cap, int ck, bool sparse,
                                            int scale_bytes) {
  const bool scaled = scale_bytes != 0;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % kLoadStages, sb = i % kOpStages;
    mbar_wait(r.full + s, (i / kLoadStages) & 1);
    mbar_wait(r.bempty + sb, ((i / kOpStages) & 1) ^ 1);
    const uint8_t* cs = r.codes + s * r.code_bytes;
    const uint32_t* ms = reinterpret_cast<const uint32_t*>(r.mask + s * kMaskBytes);
    const uint8_t* ss = r.scales + s * kScaleBytes;
    uint8_t* row = r.b + sb * kBBytes + t * (kBK * 2);
    for (int gl = dec; gl < kKGroups; gl += kDecoders) {
      const int gi = gl * kBN + t;
      const bool live = i * kKGroups + gl < ng;
      const uint32_t sbits = scale_bytes == 1 ? (uint32_t)ss[gi]
                             : scale_bytes == 2 ? (uint32_t)reinterpret_cast<const uint16_t*>(ss)[gi]
                                                : 0u;
      const float scale = deca::scale_value(kCodec, scaled, sbits);
      if (live && sparse) {
        scatter_group<kCodec>(row, gl, t, cs + gl * ck * kBN + t, k_cap, ms[gi], scaled, scale);
        continue;
      }
      uint32_t packed[deca::kGroup / 2];
      if (live) {  // a dense group: stored value i is row i
        float w[deca::kGroup];
        deca::decode_column<false>(kCodec, cs + gl * ck * kBN + t, kBN, k_cap, false, 0u,
                                   scaled, scale, w);
#pragma unroll
        for (int j = 0; j < deca::kGroup / 2; ++j) packed[j] = pack_bf16(w[2 * j], w[2 * j + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < deca::kGroup / 2; ++j) packed[j] = 0u;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // 16-byte chunks gl*4 + c of the 128-byte row
        const int chunk = (gl * 4 + c) ^ (t & 7);
        *reinterpret_cast<uint4*>(row + chunk * 16) =
            make_uint4(packed[4 * c], packed[4 * c + 1], packed[4 * c + 2], packed[4 * c + 3]);
      }
    }
    // the generic-proxy stores must be visible to wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(r.bfull + sb);
    mbar_arrive(r.empty + s);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap code_map,
                 const __grid_constant__ CUtensorMap mask_map,
                 const __grid_constant__ CUtensorMap scale_map, int codec, int k_cap,
                 int ck, int sparse, int scale_bytes, int M, int K, int N, void* out,
                 int out_f32) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Rings r;
  r.code_bytes = kKGroups * ck * kBN;
  r.b = base;
  r.a = r.b + kOpStages * kBBytes;
  r.codes = r.a + kLoadStages * kABytes;
  r.mask = r.codes + kLoadStages * r.code_bytes;
  r.scales = r.mask + kLoadStages * kMaskBytes;
  r.full = reinterpret_cast<uint64_t*>(r.scales + kLoadStages * kScaleBytes);
  r.empty = r.full + kLoadStages;
  r.bfull = r.empty + kLoadStages;
  r.bempty = r.bfull + kOpStages;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int ng = K / deca::kGroup;
  const int n_k = (ng + kKGroups - 1) / kKGroups;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLoadStages; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, kDecoders * 128 + 2);
    }
    for (int s = 0; s < kOpStages; ++s) {
      mbar_init(r.bfull + s, kDecoders * 128);
      mbar_init(r.bempty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (t == 0) {
      const uint32_t tx = kABytes + r.code_bytes + (sparse ? kMaskBytes : 0) +
                          kKGroups * kBN * scale_bytes;
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kLoadStages;
        mbar_wait(r.empty + s, ((i / kLoadStages) & 1) ^ 1);
        mbar_expect_tx(r.full + s, tx);
        tma_load(r.a + s * kABytes, &x_map, i * kBK, m0, r.full + s);
        tma_load(r.codes + s * r.code_bytes, &code_map, n0, i * kKGroups * ck, r.full + s);
        if (sparse) tma_load(r.mask + s * kMaskBytes, &mask_map, n0, i * kKGroups, r.full + s);
        if (scale_bytes)
          tma_load(r.scales + s * kScaleBytes, &scale_map, n0, i * kKGroups, r.full + s);
      }
    }
  } else if (wg <= kDecoders) {  // decoders
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kDecoderRegs));
    const bool sp = sparse != 0;
    const int dec = wg - 1;
    switch (codec) {
      case deca::kBF16: decode_loop<deca::kBF16>(r, dec, t, n_k, ng, k_cap, ck, sp, scale_bytes); break;
      case deca::kBF8: decode_loop<deca::kBF8>(r, dec, t, n_k, ng, k_cap, ck, sp, scale_bytes); break;
      case deca::kMXFP4: decode_loop<deca::kMXFP4>(r, dec, t, n_k, ng, k_cap, ck, sp, scale_bytes); break;
      case deca::kINT8: decode_loop<deca::kINT8>(r, dec, t, n_k, ng, k_cap, ck, sp, scale_bytes); break;
      case deca::kINT4: decode_loop<deca::kINT4>(r, dec, t, n_k, ng, k_cap, ck, sp, scale_bytes); break;
      default: decode_loop<deca::kNF4>(r, dec, t, n_k, ng, k_cap, ck, sp, scale_bytes); break;
    }
  } else {  // consumers: rows [c * 128, c * 128 + 128) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int c = wg - 1 - kDecoders;
    float acc[2][64];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[mi][j] = 0.0f;
    for (int i = 0; i < n_k; ++i) {
      const int s = i % kLoadStages, sb = i % kOpStages;
      mbar_wait(r.full + s, (i / kLoadStages) & 1);
      mbar_wait(r.bfull + sb, (i / kOpStages) & 1);
      const uint32_t a0 = smem_u32(r.a + s * kABytes) + c * 128 * (kBK * 2);
      const uint32_t b0 = smem_u32(r.b + sb * kBBytes);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = sw128_desc(b0 + kk * 32);
        wgmma_m64n128k16(acc[0], sw128_desc(a0 + kk * 32), db);
        wgmma_m64n128k16(acc[1], sw128_desc(a0 + 64 * (kBK * 2) + kk * 32), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (t == 0) {
        mbar_arrive(r.empty + s);
        mbar_arrive(r.bempty + sb);
      }
    }
    // accumulator fragment: register 4j + 2h + e of thread (warp w, lane l)
    // holds row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e
    const int w = t / 32, l = t % 32;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const long long row0 = (long long)m0 + c * 128 + mi * 64 + w * 16 + l / 4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + j * 8 + (l % 4) * 2;
        if (col >= N) continue;  // N % 16 == 0, so col + 1 < N too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + 8 * h;
          if (row >= M) continue;
          const float v0 = acc[mi][4 * j + 2 * h], v1 = acc[mi][4 * j + 2 * h + 1];
          if (out_f32)
            *reinterpret_cast<float2*>((float*)out + row * N + col) = make_float2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>((__nv_bfloat16*)out + row * N + col) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API; reach it through the runtime so
// the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a row-major (rows, cols) matrix of `esize`-byte elements, read in
// (box_rows, box_cols) boxes; out-of-bounds elements read as zero
bool make_map(CUtensorMap* map, CUtensorMapDataType dt, int esize, const void* ptr,
              long long rows, long long cols, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * esize)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x is bf16 (the wrapper rounds an f32 x once); scale_bytes is 0 (no
// scales), 1 (E8M0) or 2 (bf16 bits).
extern "C" int deca_gemm(const void* x, const void* codes, const void* mask,
                         const void* scales, int codec, int k_cap, int ck,
                         int scale_bytes, int M, int K, int N, void* out, int out_f32,
                         void* stream) {
  if (ck < 1 || ck > 64 || N % 16 != 0 || K % deca::kGroup != 0 || M < 1 ||
      scale_bytes < 0 || scale_bytes > 2)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(ck);
  const int ng = K / deca::kGroup;
  CUtensorMap xm, cm, mm, sm;
  memset(&mm, 0, sizeof(mm));
  memset(&sm, 0, sizeof(sm));
  bool ok = make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, kBM, kBK,
                     CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map(&cm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, (long long)ng * ck, N,
                     kKGroups * ck, kBN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && mask != nullptr)
    ok = make_map(&mm, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, mask, ng, N, kKGroups, kBN,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && scale_bytes != 0)
    ok = make_map(&sm, scale_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                        : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                  scale_bytes, scales, ng, N, kKGroups, kBN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_sm90_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      xm, cm, mm, sm, codec, k_cap, ck, mask != nullptr, scale_bytes, M, K, N, out, out_f32);
  return (int)cudaGetLastError();
}
