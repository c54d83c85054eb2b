// Split-KV paged-attention decode for Hopper (sm_90a), with a fixed-order
// combine.
//
// Replaces repro/kernels/paged_attention.py::paged_attention_pallas (body
// _paged_attn_kernel). One query token per slot attends over the slot's
// pages of the block-paged, quantized KV pool:
//   kp/vp (P, bs, Hkv, W) uint8 codes (W = Dh, or Dh/2 for 4-bit codecs)
//         or bf16 values (unquantized pool),
//   ks/vs (P, bs, Hkv) bf16 scales for the scaled codecs, ppos (P, bs) i32.
//
// Bound by the bytes of the pages read (codes, scales, positions): 9.3 MB
// for 4 slots of llama3-8b at up to 2048 tokens in an int8 pool, 2.8 us at
// the memory rate. A CTA per (KV head, slot) walking its pages in series
// gives 32 CTAs on 132 SMs, each waiting on one page at a time; so the walk
// is split (flash-decoding):
//
//   split_kv_kernel, grid (Hkv, B, splits). `splits` and the pages per
//     split `pps` come from the host, from the shapes alone
//     (kernels/autotune.py::attention_splits: 32 splits of 2 pages at 4
//     slots of llama3-8b), never from kv_lens, which stay on the device:
//     no host sync. CTA (h, b, s) folds the pages
//     [s pps, (s+1) pps) clipped to [lo_page, n_pages), the pages the
//     slot's window can see up to ceil(kv_len / bs), and serves the head's
//     G query heads, so each K/V byte is read once for G heads. Pages come
//     in by cp.async into two buffers: the next page's bytes land while
//     this page is folded. K and V are decoded from the staged bytes into
//     registers with the codec's kv_decode arithmetic, rounded to bf16 as
//     kernels/ref.py::kv_decode_page does; no f32 rows are staged.
//       scores   warps own chunks of floor(32 / G) tokens; a lane holds
//                Dh/32 dims of the G query rows and of each token's K row,
//                and one butterfly of 31 shuffles sums the chunk's G x
//                floor(32 / G) dot products, one per lane (lanes past
//                them, 2 at G 6 and 4 at G 7, sum zeros that are dropped),
//                where reducing each dot product alone takes 5 shuffles.
//       softmax  a warp per query head, a lane per token: warp max and
//                warp sum, in the order of ref.paged_softmax_update: bf16
//                q.k with f32 sums times 1/sqrt(Dh), tanh softcap, the
//                sentinel / causal / window mask as an additive -1e30,
//                m_new = max(m, max s), p = exp(s - m_new) and 0 where
//                masked, alpha = exp(m - m_new), l = l alpha + sum p.
//       P.V      a thread per dim d (two, d and d + 128, at Dh > 128), G
//                sums: acc = acc alpha + sum p V[., d].
//     Each CTA writes its partial (m, l, acc) per query head; a CTA with no
//     page in its range writes the empty partial (-1e30, 0, 0).
//   combine_kernel, grid (Hq, B): merges the splits in split order,
//     M = max m_i, l = sum l_i e^(m_i - M), acc = sum acc_i e^(m_i - M),
//     out = acc / l, and 0 where l = 0 (a slot with no visible token),
//     stored in q's dtype (bf16 rounded to nearest even, as a cast of the
//     f32 result). No atomics: the result is the same bits from launch to
//     launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "deca_tile.cuh"

// Instances. The kernel is instantiated for each KV codec, each query
// group G in {1, 2, 4, 6, 7, 8, 16} (the groups of the reference's
// configs: grok-1 has G 6, qwen2-vl-7b G 7, recurrentgemma-9b G 16) and
// each of two head-dim tiers, Dh <= 128 and Dh <= 256 (gemma2-2b and
// recurrentgemma-9b have Dh 256): 6 x 7 x 2 = 84 instances, so the decode
// and the per-head loops have no runtime branches and a lane's q registers
// are sized by its tier (the Dh <= 128 tier keeps the registers it had
// with 24 instances). Instances per G rather than a runtime G up to 16:
// a runtime G would size every lane's q registers and sums for 16 heads.
// Any other G, or Dh > 256, is refused at launch. Built as one `nvcc -O3`
// the 84 instances took 184.6 s on the H100 machine's host, so the source
// compiles in seven parts, all at once (kernels/cuda.py `_PARTS`): one per
// KV codec (-DDECA_KV_CODEC=<wire id>: its 14 instances behind the C entry
// deca_attention_split_<id>) and the dispatch with the combine kernel
// (-DDECA_ATTN_MAIN), linked into one library.
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;   // head dim: Dh / 32 dims per lane, 1 or 2 dims per thread

#ifndef DECA_ATTN_MAIN  // the split kernels: every part but the dispatch

// decoded KV element d of one token's head vector `row` (its stored bytes),
// rounded to bf16 as kernels/ref.py::kv_decode_page does
__device__ __forceinline__ float kv_value(int codec, const uint8_t* row,
                                          float scale, int d) {
  if (codec == deca::kNone)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
  if (codec == deca::kBF8)
    return __half2float(__ushort_as_half((unsigned short)(row[d] << 8)));
  float v;
  if (codec == deca::kINT8) {
    v = (float)(int8_t)row[d];
  } else {
    const uint32_t b = row[d / 2];
    v = deca::nibble_value(codec, (d & 1) ? (b >> 4) : (b & 0xFu));
  }
  return deca::round_bf16(v * scale);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

// One page's staging buffer: K rows, V rows (rb bytes a token), then the
// words holding each token's K and V scale bits, then its positions.
struct Page {
  uint8_t* k;
  uint8_t* v;
  uint32_t* ksw;
  uint32_t* vsw;
  int* pos;
};

__device__ __forceinline__ Page page_at(uint8_t* buf, int bs, int rb) {
  Page p;
  p.k = buf;
  p.v = buf + bs * rb;
  p.ksw = reinterpret_cast<uint32_t*>(buf + 2 * bs * rb);
  p.vsw = p.ksw + bs;
  p.pos = reinterpret_cast<int*>(p.vsw + bs);
  return p;
}

// Copy head h of page `page` into `p` with cp.async (one group per call's
// commit). A scale is 2 bytes in a (P, bs, Hkv) plane: the aligned word
// holding it is copied and the half picked at use.
__device__ __forceinline__ void issue_page(const Page& p, const uint8_t* kp,
                                           const uint8_t* vp, const int32_t* ppos,
                                           const uint16_t* ks, const uint16_t* vs,
                                           long long page, int bs, int hkv, int h, int rb) {
  const int tid = threadIdx.x;
  if (rb % 16 == 0 && (reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16 == 0) {
    const int per = rb / 16;
    for (int i = tid; i < bs * per; i += kThreads) {
      const int t = i / per, c = (i % per) * 16;
      const long long off = ((page * bs + t) * hkv + h) * rb + c;
      cp_async16(p.k + t * rb + c, kp + off);
      cp_async16(p.v + t * rb + c, vp + off);
    }
  } else {
    const int per = rb / 4;
    for (int i = tid; i < bs * per; i += kThreads) {
      const int t = i / per, c = (i % per) * 4;
      const long long off = ((page * bs + t) * hkv + h) * rb + c;
      cp_async4(p.k + t * rb + c, kp + off);
      cp_async4(p.v + t * rb + c, vp + off);
    }
  }
  for (int t = tid; t < bs; t += kThreads) {
    cp_async4(p.pos + t, ppos + page * bs + t);
    if (ks != nullptr) {
      const long long e = (page * bs + t) * hkv + h;
      cp_async4(p.ksw + t, ks + (e & ~1LL));
      cp_async4(p.vsw + t, vs + (e & ~1LL));
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// token t's scale from the word issue_page copied: the high half when the
// scale's flat index (page bs + t) Hkv + h is odd; `odd0` is that parity at
// t = 0, and t Hkv is odd when both t and Hkv are
__device__ __forceinline__ float scale_of(const uint32_t* words, int t, bool scaled,
                                          int odd0, int hkv) {
  if (!scaled) return 1.0f;
  const uint32_t w = words[t];
  return deca::bf16_bits_value(((odd0 ^ (t & hkv)) & 1) ? (w >> 16) : w);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool visible(int kpos, int qp, int causal, int window) {
  bool ok = kpos != deca::kEmptyPos;
  if (causal) ok = ok && kpos <= qp;
  if (window > 0) ok = ok && kpos > qp - window;
  return ok;
}

// One step of butterfly_sum: lanes L and L ^ O swap halves of v[0, 2 O).
template <int O>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int m = 0; m < O; ++m) {
    const float keep = up ? v[m + O] : v[m];
    const float send = up ? v[m] : v[m + O];
    v[m] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// After butterfly_sum, lane L holds the warp-wide sum of its v[L]: each of
// the 5 steps keeps the half of the values whose index bit matches the lane
// bit and adds the partner lane's copy of it (31 shuffles for 32 sums,
// against 5 for each sum reduced alone). The steps are templates so that
// every index into v is a constant and v stays in registers.
__device__ __forceinline__ float butterfly_sum(float (&v)[32], int lane) {
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  return v[0];
}

// kDJ = dims a lane holds per query row (4: Dh <= 128, 8: Dh <= 256); a
// thread holds kDJ / 4 dims of the P.V sums.
template <int kCodec, int kG, int kDJ>
__global__ void __launch_bounds__(kThreads)
split_kv_kernel(const void* q, int q_f32, const uint8_t* kp, const uint8_t* vp,
                const int32_t* ppos, const uint16_t* ks, const uint16_t* vs,
                const int32_t* tables, const int32_t* kv_lens, const int32_t* q_pos,
                float* ws, int Hq, int Hkv, int Dh, int rb, int bs, int MB, int pps,
                int buf_bytes, int causal, int window, float softcap) {
  constexpr int kChunk = 32 / kG;      // tokens whose kG scores one butterfly sums
  constexpr int kLanes = kChunk * kG;  // lanes that receive a score
  constexpr int kDT = kDJ / 4;         // P.V dims a thread: d = tid + 128 e
  extern __shared__ __align__(16) uint8_t sm[];
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* S = reinterpret_cast<float*>(sm + 2 * buf_bytes);  // (kG, bs) scores, then p
  float* Mx = S + kG * bs;
  float* Ls = Mx + kG;
  float* Alpha = Ls + kG;
  const float scale = (float)(1.0 / sqrt((double)Dh));  // as the plain version
  const bool scaled = ks != nullptr;

  // this lane's dims d = lane + 32 j of the kG query rows, bf16-rounded
  float qr[kG][kDJ];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      const int d = lane + 32 * j;
      float v = 0.0f;
      if (d < Dh) {
        const long long qi = ((long long)b * Hq + (long long)h * kG + g) * Dh + d;
        v = q_f32 ? deca::round_bf16(((const float*)q)[qi])
                  : __bfloat162float(((const __nv_bfloat16*)q)[qi]);
      }
      qr[g][j] = v;
    }
  float acc[kDT][kG];
#pragma unroll
  for (int e = 0; e < kDT; ++e)
#pragma unroll
    for (int g = 0; g < kG; ++g) acc[e][g] = 0.0f;
  if (tid < kG) {
    Mx[tid] = -1e30f;
    Ls[tid] = 0.0f;
  }

  const int kv_len = kv_lens[b];
  const int qp = q_pos[b];
  const int n_pages = min((kv_len + bs - 1) / bs, MB);
  const int lo_page = window > 0 ? max(qp - window + 1, 0) / bs : 0;
  const int p_begin = max(split * pps, lo_page);
  const int p_end = min((split + 1) * pps, n_pages);
  const int* table = tables + (long long)b * MB;

  if (p_begin < p_end)
    issue_page(page_at(sm, bs, rb), kp, vp, ppos, ks, vs, table[p_begin], bs, Hkv, h, rb);
  for (int pg = p_begin; pg < p_end; ++pg) {
    const int cur = (pg - p_begin) & 1;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // this page landed, and every thread is done with the last
    if (pg + 1 < p_end)
      issue_page(page_at(sm + (cur ^ 1) * buf_bytes, bs, rb), kp, vp, ppos, ks, vs,
                 table[pg + 1], bs, Hkv, h, rb);
    const Page p = page_at(sm + cur * buf_bytes, bs, rb);
    const int odd0 = ((unsigned)table[pg] * bs * Hkv + h) & 1u;
    // scores: warp w takes token chunks w, w + 4, ...; lanes split the dims
    // of each token, then one butterfly sums the chunk's kChunk x kG dots
    for (int c = warp; c * kChunk < bs; c += kWarps) {
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int t = c * kChunk + i;
        if (t < bs) {
          const uint8_t* krow = p.k + t * rb;
          const float ksc = scale_of(p.ksw, t, scaled, odd0, Hkv);
#pragma unroll
          for (int j = 0; j < kDJ; ++j) {
            const int d = lane + 32 * j;
            if (d < Dh) {
              const float kv = kv_value(kCodec, krow, ksc, d);
#pragma unroll
              for (int g = 0; g < kG; ++g) v[i * kG + g] = fmaf(qr[g][j], kv, v[i * kG + g]);
            }
          }
        }
      }
      const int t = c * kChunk + lane / kG, g = lane % kG;
      float sc = butterfly_sum(v, lane) * scale;
      if (lane < kLanes && t < bs) {
        if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
        S[g * bs + t] = sc + (visible(p.pos[t], qp, causal, window) ? 0.0f : -1e30f);
      }
    }
    __syncthreads();
    // softmax statistics: warp w takes query heads w, w + 4, ...
    for (int g = warp; g < kG; g += kWarps) {
      float smax = -INFINITY;
      for (int t = lane; t < bs; t += 32) smax = fmaxf(smax, S[g * bs + t]);
      const float m_old = Mx[g];
      const float m_new = fmaxf(m_old, warp_max(smax));
      float psum = 0.0f;
      for (int t = lane; t < bs; t += 32) {
        const float pr = visible(p.pos[t], qp, causal, window) ? expf(S[g * bs + t] - m_new) : 0.0f;
        S[g * bs + t] = pr;
        psum += pr;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Alpha[g] = alpha;
        Ls[g] = Ls[g] * alpha + psum;
        Mx[g] = m_new;
      }
    }
    __syncthreads();
    // P.V: thread tid keeps the kG sums of dims tid + 128 e
#pragma unroll
    for (int e = 0; e < kDT; ++e) {
      const int d = tid + kThreads * e;
      if (d < Dh) {
#pragma unroll
        for (int g = 0; g < kG; ++g) acc[e][g] *= Alpha[g];
#pragma unroll 8
        for (int t = 0; t < bs; ++t) {
          const float vsc = scale_of(p.vsw, t, scaled, odd0, Hkv);
          const float v = kv_value(kCodec, p.v + t * rb, vsc, d);
#pragma unroll
          for (int g = 0; g < kG; ++g) acc[e][g] = fmaf(S[g * bs + t], v, acc[e][g]);
        }
      }
    }
  }
  __syncthreads();
  // the partial of this split: per query head g, [m, l, acc[0..Dh)]
  float* part = ws + (((long long)b * Hkv + h) * splits + split) * kG * (Dh + 2);
#pragma unroll
  for (int e = 0; e < kDT; ++e) {
    const int d = tid + kThreads * e;
    if (d < Dh) {
#pragma unroll
      for (int g = 0; g < kG; ++g) part[g * (Dh + 2) + 2 + d] = acc[e][g];
    }
  }
  if (tid < kG) {
    part[tid * (Dh + 2)] = Mx[tid];
    part[tid * (Dh + 2) + 1] = Ls[tid];
  }
}

template <int kCodec, int kG, int kDJ>
cudaError_t launch_split(dim3 grid, int smem, cudaStream_t s, const void* q, int q_f32,
                         const void* kp, const void* vp, const void* ppos, const void* ks,
                         const void* vs, const void* tables, const void* kv_lens,
                         const void* q_pos, void* ws, int Hq, int Hkv, int Dh, int rb,
                         int bs, int MB, int pps, int buf_bytes, int causal, int window,
                         float softcap) {
  // above the default limit: opt in, once per instance and size, so a
  // launch inside a CUDA graph capture makes no attribute call
  static int opted_in = 48 * 1024;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        split_kv_kernel<kCodec, kG, kDJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  split_kv_kernel<kCodec, kG, kDJ><<<grid, kThreads, smem, s>>>(
      q, q_f32, (const uint8_t*)kp, (const uint8_t*)vp, (const int32_t*)ppos,
      (const uint16_t*)ks, (const uint16_t*)vs, (const int32_t*)tables,
      (const int32_t*)kv_lens, (const int32_t*)q_pos, (float*)ws, Hq, Hkv, Dh, rb, bs, MB,
      pps, buf_bytes, causal, window, softcap);
  return cudaGetLastError();
}

// the kernel for `codec` with G = Hq / Hkv query heads a KV head (1, 2, 4,
// 6, 7, 8 or 16) in its head-dim tier
template <int kCodec, int kDJ, typename... Args>
cudaError_t launch_for_group(int G, Args... args) {
  switch (G) {
    case 1: return launch_split<kCodec, 1, kDJ>(args...);
    case 2: return launch_split<kCodec, 2, kDJ>(args...);
    case 4: return launch_split<kCodec, 4, kDJ>(args...);
    case 6: return launch_split<kCodec, 6, kDJ>(args...);
    case 7: return launch_split<kCodec, 7, kDJ>(args...);
    case 8: return launch_split<kCodec, 8, kDJ>(args...);
    case 16: return launch_split<kCodec, 16, kDJ>(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int kCodec, typename... Args>
cudaError_t launch_for_shape(int G, int Dh, Args... args) {
  return Dh <= 128 ? launch_for_group<kCodec, 4>(G, args...)
                   : launch_for_group<kCodec, 8>(G, args...);
}

#endif  // DECA_ATTN_MAIN

#ifndef DECA_KV_CODEC  // the combine and the dispatch

__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* ws, void* out, int out_bf16, int Hkv, int G, int Dh, int splits) {
  const int hq = blockIdx.x, b = blockIdx.y, h = hq / G, g = hq % G;
  const int Hq = Hkv * G;
  const long long stride = (long long)G * (Dh + 2);  // one split's partials
  const float* p0 = ws + ((long long)b * Hkv + h) * splits * stride + g * (Dh + 2);
  float m = -1e30f;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, p0[i * stride]);
  float l = 0.0f;
  for (int i = 0; i < splits; ++i) l += p0[i * stride + 1] * expf(p0[i * stride] - m);
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float a = 0.0f;
    for (int i = 0; i < splits; ++i) a += p0[i * stride + 2 + d] * expf(p0[i * stride] - m);
    const float o = l > 0.0f ? a / fmaxf(l, 1e-30f) : 0.0f;
    const long long i = ((long long)b * Hq + hq) * Dh + d;
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(o);
    else
      reinterpret_cast<float*>(out)[i] = o;
  }
}

#endif  // DECA_KV_CODEC

}  // namespace

#define SPLIT_PARAMS                                                                  \
  int G, int B, int splits, int smem, cudaStream_t s, const void *q, int q_f32,       \
      const void *kp, const void *vp, const void *ppos, const void *ks, const void *vs, \
      const void *tables, const void *kv_lens, const void *q_pos, void *ws, int Hq,     \
      int Hkv, int Dh, int rb, int bs, int MB, int pps, int buf_bytes, int causal,      \
      int window, float softcap
#define SPLIT_ARGS                                                                   \
  dim3(Hkv, B, splits), smem, s, q, q_f32, kp, vp, ppos, ks, vs, tables, kv_lens, q_pos, \
      ws, Hq, Hkv, Dh, rb, bs, MB, pps, buf_bytes, causal, window, softcap
#define SPLIT_NAMES                                                                   \
  G, B, splits, smem, s, q, q_f32, kp, vp, ppos, ks, vs, tables, kv_lens, q_pos, ws, Hq, \
      Hkv, Dh, rb, bs, MB, pps, buf_bytes, causal, window, softcap

// The split kernels of one KV codec (wire id ID) at (G, Dh), behind a plain
// C entry so that each codec's instances can be compiled on their own.
#define DECA_SPLIT_ENTRY_(ID) \
  extern "C" int deca_attention_split_##ID(SPLIT_PARAMS)
#define DECA_SPLIT_ENTRY(ID) DECA_SPLIT_ENTRY_(ID)

#ifdef DECA_KV_CODEC
DECA_SPLIT_ENTRY(DECA_KV_CODEC) {
  return (int)launch_for_shape<DECA_KV_CODEC>(G, Dh, SPLIT_ARGS);
}
#else
DECA_SPLIT_ENTRY(0);
DECA_SPLIT_ENTRY(2);
DECA_SPLIT_ENTRY(3);
DECA_SPLIT_ENTRY(4);
DECA_SPLIT_ENTRY(5);
DECA_SPLIT_ENTRY(6);

// ws holds B * Hkv * splits * G * (Dh + 2) floats; out is (B, Hq, Dh) in
// bf16 when out_bf16, else f32. Shared memory: two page buffers (page_at's
// layout, 16-byte aligned for cp.async), then the (G, bs) scores and
// (m, l, alpha) per query head.
extern "C" int deca_paged_attention(
    const void* q, int q_f32, const void* kp, const void* vp, const void* ppos,
    const void* ks, const void* vs, const void* tables, const void* kv_lens,
    const void* q_pos, void* ws, void* out, int out_bf16, int B, int Hq, int Hkv, int Dh,
    int rb, int bs, int MB, int splits, int pps, int codec, int causal, int window,
    float softcap, void* stream) {
  const int G = Hq / Hkv;
  if (rb % 4 != 0 || Hq % Hkv != 0 || Dh > kMaxDh || splits < 1 || pps < 1 ||
      (long long)splits * pps < MB)
    return (int)cudaErrorInvalidValue;
  const int buf_bytes = (2 * bs * rb + 12 * bs + 15) / 16 * 16;
  const int smem = 2 * buf_bytes + 4 * G * (bs + 3);
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (codec) {
    case deca::kNone: err = deca_attention_split_0(SPLIT_NAMES); break;
    case deca::kBF8: err = deca_attention_split_2(SPLIT_NAMES); break;
    case deca::kMXFP4: err = deca_attention_split_3(SPLIT_NAMES); break;
    case deca::kINT8: err = deca_attention_split_4(SPLIT_NAMES); break;
    case deca::kINT4: err = deca_attention_split_5(SPLIT_NAMES); break;
    case deca::kNF4: err = deca_attention_split_6(SPLIT_NAMES); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != (int)cudaSuccess) return err;
  combine_kernel<<<dim3(Hq, B), kThreads, 0, s>>>((const float*)ws, out, out_bf16, Hkv, G,
                                                   Dh, splits);
  return (int)cudaGetLastError();
}
#endif  // DECA_KV_CODEC
