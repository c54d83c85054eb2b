// Fused paged-attention decode for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention.py::paged_attention_pallas (body
// _paged_attn_kernel). One query token per slot attends over the slot's
// pages of the block-paged, quantized KV pool:
//   kp/vp (P, bs, Hkv, W) uint8 codes (W = Dh, or Dh/2 for 4-bit codecs)
//         or bf16 values (unquantized pool),
//   ks/vs (P, bs, Hkv) bf16 scales for the scaled codecs, ppos (P, bs) i32.
//
// One CTA per (KV head, slot) serves the head's g query heads. It walks
// pages from the first one the window can see (lo_page) up to
// ceil(kv_len / bs). For each page it copies the head's stored K and V
// bytes into shared memory (word loads, a batch in flight per thread), then
// decodes them with the codec's kv_decode arithmetic, rounded to bf16 as
// kernels/ref.py::kv_decode_page does, then folds the page into an f32
// (m, l, acc) online softmax in the order of ref.paged_softmax_update:
// bf16 q.k with f32 accumulation times 1/sqrt(Dh), tanh softcap, the
// sentinel / causal / window mask as an additive -1e30, m_new = max(m, max
// s), p = exp(s - m_new) zeroed where masked (so a fully masked page adds
// no mass), alpha = exp(m - m_new), l = l*alpha + sum p,
// acc = acc*alpha + p.V. The output is acc / l, and 0 where l = 0.
//
// Bound by the bytes of the pages read (codes, scales, positions). The walk
// is serial within a CTA and runs B * Hkv CTAs (32 at 4 slots of
// llama3-8b), far below the 132 SMs, with the softmax statistics on g
// threads; splitting the walk over more CTAs with a combine pass
// (flash-decoding) is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "deca_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 8;  // loads a thread issues before it stores

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

// The stored bytes of head h for the bs tokens of one page, K and V, into
// shared words: rows of `rb` bytes (rb % 4 == 0), kBatch loads in flight
// per thread before any store.
__device__ __forceinline__ void stage_page(uint32_t* kdst, uint32_t* vdst,
                                           const uint8_t* kp, const uint8_t* vp,
                                           long long page, int bs, int hkv,
                                           int h, int rb) {
  const int rw = rb / 4, total = bs * rw;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    uint32_t kv[kBatch], vv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) {
        const long long off = ((page * bs + i / rw) * hkv + h) * rb + (i % rw) * 4;
        kv[u] = *reinterpret_cast<const uint32_t*>(kp + off);
        vv[u] = *reinterpret_cast<const uint32_t*>(vp + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < total) {
        kdst[i] = kv[u];
        vdst[i] = vv[u];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const void* q, int q_f32, const uint8_t* kp,
                       const uint8_t* vp, const int32_t* ppos,
                       const uint16_t* ks, const uint16_t* vs,
                       const int32_t* tables, const int32_t* kv_lens,
                       const int32_t* q_pos, float* out, int Hq, int Hkv,
                       int Dh, int rb, int bs, int MB, int codec, int causal,
                       int window, float softcap) {
  extern __shared__ float sm[];
  const int G = Hq / Hkv;
  const int kpitch = Dh + 1;  // odd pitch: row-wise reads avoid bank conflicts
  float* Ks = sm;
  float* Vs = Ks + bs * kpitch;
  float* Qs = Vs + bs * kpitch;
  float* Acc = Qs + G * Dh;
  float* S = Acc + G * Dh;
  float* Mx = S + G * bs;
  float* Ls = Mx + G;
  float* Alpha = Ls + G;
  float* Ksc = Alpha + G;
  float* Vsc = Ksc + bs;
  int* Pos = reinterpret_cast<int*>(Vsc + bs);
  uint32_t* Kraw = reinterpret_cast<uint32_t*>(Pos + bs);
  uint32_t* Vraw = Kraw + bs * rb / 4;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float scale = (float)(1.0 / sqrt((double)Dh));  // as the plain version
  for (int i = tid; i < G * Dh; i += kThreads) {
    const long long qi = ((long long)b * Hq + (long long)h * G) * Dh + i;
    Qs[i] = q_f32 ? deca::round_bf16(((const float*)q)[qi])
                  : __bfloat162float(((const __nv_bfloat16*)q)[qi]);
    Acc[i] = 0.0f;
  }
  if (tid < G) {
    Mx[tid] = -1e30f;
    Ls[tid] = 0.0f;
  }
  const int kv_len = kv_lens[b];
  const int qp = q_pos[b];
  const int n_pages = min((kv_len + bs - 1) / bs, MB);
  const int lo_page = window > 0 ? max(qp - window + 1, 0) / bs : 0;
  const bool scaled = ks != nullptr;

  for (int pg = lo_page; pg < n_pages; ++pg) {
    const long long page = tables[(long long)b * MB + pg];
    __syncthreads();  // the previous page is consumed
    stage_page(Kraw, Vraw, kp, vp, page, bs, Hkv, h, rb);
    for (int t = tid; t < bs; t += kThreads) {
      const long long th = (page * bs + t) * Hkv + h;
      Pos[t] = ppos[page * bs + t];
      Ksc[t] = scaled ? deca::bf16_bits_value(ks[th]) : 1.0f;
      Vsc[t] = scaled ? deca::bf16_bits_value(vs[th]) : 1.0f;
    }
    __syncthreads();
    const uint8_t* kb = reinterpret_cast<const uint8_t*>(Kraw);
    const uint8_t* vb = reinterpret_cast<const uint8_t*>(Vraw);
    for (int i = tid; i < bs * Dh; i += kThreads) {
      const int t = i / Dh, d = i % Dh;
      Ks[t * kpitch + d] = kv_value(codec, kb + t * rb, Ksc[t], d);
      Vs[t * kpitch + d] = kv_value(codec, vb + t * rb, Vsc[t], d);
    }
    __syncthreads();
    for (int i = tid; i < G * bs; i += kThreads) {
      const int g = i / bs, t = i % bs;
      float s = 0.0f;
      for (int d = 0; d < Dh; ++d) s = fmaf(Qs[g * Dh + d], Ks[t * kpitch + d], s);
      s *= scale;
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      const int kpos = Pos[t];
      bool ok = kpos != deca::kEmptyPos;
      if (causal) ok = ok && kpos <= qp;
      if (window > 0) ok = ok && kpos > qp - window;
      S[i] = s + (ok ? 0.0f : -1e30f);
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      float smax = S[g * bs];
      for (int t = 1; t < bs; ++t) smax = fmaxf(smax, S[g * bs + t]);
      const float m_new = fmaxf(Mx[g], smax);
      float psum = 0.0f;
      for (int t = 0; t < bs; ++t) {
        const int kpos = Pos[t];
        bool ok = kpos != deca::kEmptyPos;
        if (causal) ok = ok && kpos <= qp;
        if (window > 0) ok = ok && kpos > qp - window;
        const float p = ok ? expf(S[g * bs + t] - m_new) : 0.0f;
        S[g * bs + t] = p;
        psum += p;
      }
      const float alpha = expf(Mx[g] - m_new);
      Alpha[g] = alpha;
      Ls[g] = Ls[g] * alpha + psum;
      Mx[g] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < G * Dh; i += kThreads) {
      const int g = i / Dh, d = i % Dh;
      float pv = 0.0f;
      for (int t = 0; t < bs; ++t) pv = fmaf(S[g * bs + t], Vs[t * kpitch + d], pv);
      Acc[i] = Acc[i] * Alpha[g] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * Dh; i += kThreads) {
    const float l = Ls[i / Dh];
    out[((long long)b * Hq + (long long)h * G) * Dh + i] =
        l > 0.0f ? Acc[i] / fmaxf(l, 1e-30f) : 0.0f;
  }
}

}  // namespace

extern "C" int deca_paged_attention(
    const void* q, int q_f32, const void* kp, const void* vp, const void* ppos,
    const void* ks, const void* vs, const void* tables, const void* kv_lens,
    const void* q_pos, void* out, int B, int Hq, int Hkv, int Dh, int rb, int bs,
    int MB, int codec, int causal, int window, float softcap, int smem,
    void* stream) {
  if (rb % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  paged_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, q_f32, (const uint8_t*)kp, (const uint8_t*)vp, (const int32_t*)ppos,
      (const uint16_t*)ks, (const uint16_t*)vs, (const int32_t*)tables,
      (const int32_t*)kv_lens, (const int32_t*)q_pos, (float*)out, Hq, Hkv, Dh,
      rb, bs, MB, codec, causal, window, softcap);
  return (int)cudaGetLastError();
}
