// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (body _paged_attn_kernel): one query token per sequence
// attends its paged KV with an fp32 online softmax, mask idx < cl, scale
// hd**-0.5, denominator clamped to 1e-20, output in q's dtype.  cl = 0
// gives zero rows, as the Pallas kernel does.
//
// Bound on this card.  Decode reads each context token's K and V row once
// per KV head: sum(cl) * KV * hd * 2 * sizeof(T) bytes of gathered pages,
// against 4 * sum(cl) * KV * G * hd flops, about 2 flops a byte at G = 2.
// The kernel is bound by HBM bytes; tensor cores would not help.  What
// it needs is enough bytes in flight on every SM for the whole call.
//
// Design: split contexts (flash-decoding) and a ring of async copies.
//   - Each sequence's context is cut into splits of split_tokens tokens
//     (the wrapper's SPLIT_TOKENS, a multiple of the 32-token stage).  The
//     grid is (B * KV, splits of the table width nb * bs), sized on the
//     host from nb alone, with no sync; a block whose split starts at or
//     past cl exits at once.  A long context is thus spread over many SMs
//     instead of walking 128 tiles on one.
//   - A block (sequence, KV head, split) streams its split through a ring
//     of kStages = 3 stages of 32 tokens: K and V rows of the head (hd *
//     sizeof(T) bytes each, one per token) arrive by 16-byte cp.async
//     copies gathered through the block table, with the next two stages
//     in flight while one is computed (in bf16 at hd 128, 32 KB in flight
//     per block and four blocks per SM).  Tokens past cl or past the split
//     are zero-filled and never read.
//   - Compute stays on the CUDA cores, bf16 in shared memory, fp32 in
//     registers, and uses every lane whatever G is: a token's hd is spread
//     over a group of hd / 8 lanes (8 elements each), a warp scores 32 /
//     group tokens at a time for all G query rows, and each of the four
//     warps keeps its own online-softmax state over its share of the
//     split's tokens.
//   - The four warps' states merge in shared memory.  A sequence with a
//     single split writes its output there.  Otherwise each split writes
//     its partial (m, l, acc) to a workspace the wrapper allocated, and
//     the last block to finish for (sequence, KV head), found with an
//     atomic counter, merges the partials, writes the output and resets
//     the counter to 0: one launch, no second kernel.  The merge reads
//     the partials in split order, so the output does not depend on which
//     block finishes last.
//
// What is left.  On the card the kernel runs at about half its byte
// bound, whatever the split size (128, 256 and 512 tokens timed the same).
// A block reads only its own KV head's hd * sizeof(T) bytes of each
// token, 256 B at a stride of KV * hd * sizeof(T), so the other heads'
// blocks fetch the rest of each page at other times; a block that covers
// all KV heads could bring each page in whole, with one cp.async.bulk on
// an mbarrier, and stream device memory in order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStageTokens = 32;
constexpr int kStages = 3;
constexpr float kNegInf = -1e30f;   // the JAX kernels' NEG_INF, not -inf
constexpr float kLog2e = 1.4426950408889634f;

// 8 consecutive elements as fp32: one 16-byte load of bf16, two of fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as astype does
}

template <typename T, int HD, int GMAX>
struct DecodeShape {
  static constexpr int kLanes = HD / 8;         // lanes per token
  static constexpr int kGroup = kLanes <= 4 ? 4 : kLanes <= 8 ? 8 : 16;
  static constexpr int kTokPerPass = 32 / kGroup;
  static constexpr int kPasses = kStageTokens / kWarps / kTokPerPass;
  static constexpr int kStageElems = kStageTokens * HD;
  static constexpr int kChunks = HD * (int)sizeof(T) / 16;   // 16 B per row
  static constexpr size_t kRingBytes = (size_t)2 * kStages * kStageElems * sizeof(T);
  // merge area (per-warp acc), reusing the ring once it is drained
  static constexpr size_t kMergeBytes = (size_t)kWarps * GMAX * HD * sizeof(float);
  static constexpr size_t kSmemBytes =
      (size_t)GMAX * HD * sizeof(float) +                     // q, fp32
      (size_t)2 * kWarps * GMAX * sizeof(float) +             // warp m, l
      (kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes);
  static_assert(kPasses >= 1, "stage too small for the lane groups");
};

// part_acc (B * KV * n_splits, g, HD) and part_ml (B * KV * n_splits, g, 2)
// are the split partials, counters (B * KV) the arrival counts; all three
// are touched only when n_splits > 1
template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ context_lens,
                             T* __restrict__ out, float* __restrict__ part_acc,
                             float* __restrict__ part_ml,
                             int* __restrict__ counters, int n_kv, int g,
                             int nb, int bs, int n_splits, int split_tokens,
                             float scale_log2) {
  using Shape = DecodeShape<T, HD, GMAX>;
  constexpr int kLanes = Shape::kLanes, kGroup = Shape::kGroup;
  constexpr int kTokPerPass = Shape::kTokPerPass, kPasses = Shape::kPasses;
  constexpr int kVec = 16 / (int)sizeof(T);      // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                  // [GMAX][HD]
  float* w_m = q_s + GMAX * HD;                                 // [warp][GMAX]
  float* w_l = w_m + kWarps * GMAX;                             // [warp][GMAX]
  T* k_s = reinterpret_cast<T*>(w_l + kWarps * GMAX);           // [stage]
  T* v_s = k_s + kStages * Shape::kStageElems;                  // [stage]
  float* w_acc = reinterpret_cast<float*>(k_s);   // [warp][GMAX][HD], after the ring
  __shared__ int is_last;

  const int bh = blockIdx.x;                     // b * n_kv + h
  const int b = bh / n_kv, h = bh % n_kv;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int cl = min(max(context_lens[b], 0), nb * bs);
  const int t_begin = split * split_tokens;
  const long long out_off = (long long)bh * g * HD;
  if (cl == 0) {                                 // nothing to attend: zero rows
    if (split == 0)
      for (int i = tid; i < g * HD; i += kThreads) store1(out + out_off + i, 0.f);
    return;
  }
  if (t_begin >= cl) return;                     // an empty split
  const int t_end = min(cl, t_begin + split_tokens);
  const int n_active = (cl + split_tokens - 1) / split_tokens;
  const int n_stage = (t_end - t_begin + kStageTokens - 1) / kStageTokens;
  const int* table = block_tables + (long long)b * nb;

  auto load_stage = [&](int st) {
    T* kd = k_s + (st % kStages) * Shape::kStageElems;
    T* vd = v_s + (st % kStages) * Shape::kStageElems;
    const int t0 = t_begin + st * kStageTokens;
    for (int idx = tid; idx < kStageTokens * Shape::kChunks; idx += kThreads) {
      const int r = idx / Shape::kChunks, c = idx % Shape::kChunks;
      const int tok = t0 + r;
      const T* ks = k_pool;
      const T* vs = v_pool;
      int bytes = 0;
      if (tok < t_end) {
        const long long off =
            (((long long)table[tok / bs] * bs + tok % bs) * n_kv + h) * HD + c * kVec;
        ks = k_pool + off;
        vs = v_pool + off;
        bytes = 16;
      }
      cp_async16(kd + r * HD + c * kVec, ks, bytes);
      cp_async16(vd + r * HD + c * kVec, vs, bytes);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stage) load_stage(st);
    cp_async_commit();
  }
  for (int i = tid; i < GMAX * HD; i += kThreads) {
    const int gi = i / HD;
    q_s[i] = gi < g ? to_f32(q[out_off + i]) : 0.f;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane / kGroup, sub = lane % kGroup;
  const bool active = sub < kLanes;              // hd 80 / 112: 10 / 14 of 16 lanes
  float m[GMAX], l[GMAX], acc[GMAX][8];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gi][e] = 0.f;
  }

  for (int st = 0; st < n_stage; ++st) {
    if (st + kStages - 1 < n_stage) load_stage(st + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                // stage st has landed
    __syncthreads();
    const T* kt = k_s + (st % kStages) * Shape::kStageElems;
    const T* vt = v_s + (st % kStages) * Shape::kStageElems;
    const int t0 = t_begin + st * kStageTokens;
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      // this lane group's token of the pass
      const int r = warp * (kStageTokens / kWarps) + pass * kTokPerPass + grp;
      const bool valid = t0 + r < t_end;
      float kv[8] = {};
      if (active) load8(kt + r * HD + sub * 8, kv);
      float sc[GMAX];
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        float d = 0.f;
        if (gi < g && active) {
          const float* qr = q_s + gi * HD + sub * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qr[e], kv[e], d);
        }
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        sc[gi] = valid ? d * scale_log2 : kNegInf;
      }
      if (active) load8(vt + r * HD + sub * 8, kv);
#pragma unroll
      for (int gi = 0; gi < GMAX; ++gi) {
        if (gi >= g) continue;
        float mx = sc[gi];
#pragma unroll
        for (int o = kGroup; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[gi], mx);
        const float alpha = fast_exp2(m[gi] - m_new);
        const float p = valid ? fast_exp2(sc[gi] - m_new) : 0.f;
        m[gi] = m_new;
        l[gi] = l[gi] * alpha + p;               // this group's tokens only
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[gi][e] = fmaf(p, kv[e], acc[gi][e] * alpha);
      }
    }
    __syncthreads();                             // stage free for the refill
  }
  cp_async_wait<0>();
  __syncthreads();                               // the ring is now merge space

  // the warp's groups saw different tokens under one running max: sum them
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi >= g) continue;
#pragma unroll
    for (int o = kGroup; o < 32; o <<= 1) {
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], o);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
    }
    if (lane == 0) {
      w_m[warp * GMAX + gi] = m[gi];
      w_l[warp * GMAX + gi] = l[gi];
    }
    if (grp == 0 && active) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        w_acc[(warp * GMAX + gi) * HD + sub * 8 + e] = acc[gi][e];
    }
  }
  __syncthreads();

  // merge the four warps: (M, L, O) of this split, O relative to M
  const bool single = n_active == 1;
  for (int i = tid; i < g * HD; i += kThreads) {
    const int gi = i / HD, d = i % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, w_m[w * GMAX + gi]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = fast_exp2(w_m[w * GMAX + gi] - mm);
      ll += w_l[w * GMAX + gi] * wt;
      oo += w_acc[(w * GMAX + gi) * HD + d] * wt;
    }
    if (single) {
      store1(out + out_off + i, oo / fmaxf(ll, 1e-20f));
    } else {
      const long long slot = (long long)bh * n_splits + split;
      part_acc[slot * g * HD + i] = oo;
      if (d == 0) {
        part_ml[(slot * g + gi) * 2] = mm;
        part_ml[(slot * g + gi) * 2 + 1] = ll;
      }
    }
  }
  if (single) return;

  // the last split block of (sequence, KV head) to arrive merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + bh, 1) == n_active - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const long long slot0 = (long long)bh * n_splits;
  for (int i = tid; i < g * HD; i += kThreads) {
    const int gi = i / HD;
    float mm = kNegInf;
    for (int sp = 0; sp < n_active; ++sp)
      mm = fmaxf(mm, __ldcg(part_ml + ((slot0 + sp) * g + gi) * 2));
    float ll = 0.f, oo = 0.f;
    for (int sp = 0; sp < n_active; ++sp) {
      const float* ml = part_ml + ((slot0 + sp) * g + gi) * 2;
      const float wt = fast_exp2(__ldcg(ml) - mm);
      ll += __ldcg(ml + 1) * wt;
      oo += __ldcg(part_acc + (slot0 + sp) * g * HD + i) * wt;
    }
    store1(out + out_off + i, oo / fmaxf(ll, 1e-20f));
  }
  if (tid == 0) counters[bh] = 0;                // ready for the next launch
}

template <typename T, int HD, int GMAX>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* context_lens,
                   void* out, void* part_acc, void* part_ml, void* counters,
                   int b, int n_kv, int g, int nb, int bs, int n_splits,
                   int split_tokens, cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  const size_t smem = DecodeShape<T, HD, GMAX>::kSmemBytes;
  auto kernel = paged_attention_split_kernel<T, HD, GMAX>;
  cudaError_t err = allow_dynamic_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b * n_kv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      static_cast<int*>(counters), n_kv, g, nb, bs, n_splits, split_tokens,
      (float)(kLog2e / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(int g, const void* q, const void* k_pool,
                       const void* v_pool, const void* block_tables,
                       const void* context_lens, void* out, void* part_acc,
                       void* part_ml, void* counters, int b, int n_kv, int nb,
                       int bs, int n_splits, int split_tokens,
                       cudaStream_t stream) {
  if (g <= 2)
    return launch<T, HD, 2>(q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, g, nb, bs, n_splits, split_tokens, stream);
  if (g <= 8)
    return launch<T, HD, 8>(q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, g, nb, bs, n_splits, split_tokens, stream);
  return launch<T, HD, 16>(q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, g, nb, bs, n_splits, split_tokens, stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, int g, const void* q, const void* k_pool,
                        const void* v_pool, const void* block_tables,
                        const void* context_lens, void* out, void* part_acc,
                        void* part_ml, void* counters, int b, int n_kv, int nb,
                        int bs, int n_splits, int split_tokens,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_g<T, 32>(g, q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, nb, bs, n_splits, split_tokens, stream);
    case 64: return dispatch_g<T, 64>(g, q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, nb, bs, n_splits, split_tokens, stream);
    case 80: return dispatch_g<T, 80>(g, q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, nb, bs, n_splits, split_tokens, stream);
    case 112: return dispatch_g<T, 112>(g, q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, nb, bs, n_splits, split_tokens, stream);
    case 128: return dispatch_g<T, 128>(g, q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, nb, bs, n_splits, split_tokens, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// n_splits splits of split_tokens tokens (a multiple of 32) must cover the
// table's nb * bs tokens.
// dtype: 0 = float32, 1 = bfloat16.  part_acc holds B * KV * n_splits * g *
// hd floats, part_ml B * KV * n_splits * g * 2, counters B * KV zeroed
// ints; with n_splits = 1 none of the three is touched.  Returns a
// cudaError_t (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* context_lens, void* out,
                                      void* part_acc, void* part_ml,
                                      void* counters, int b, int n_kv, int g,
                                      int hd, int nb, int bs, int n_splits,
                                      int split_tokens, int dtype,
                                      void* stream) {
  if (g < 1 || g > 16 || b < 1 || nb < 1 || n_splits < 1 || n_splits > 65535 ||
      split_tokens < kStageTokens || split_tokens % kStageTokens ||
      (long long)b * n_kv > 0x7fffffffLL ||
      (long long)n_splits * split_tokens < (long long)nb * bs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, g, q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, nb, bs, n_splits, split_tokens, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, g, q, k_pool, v_pool, block_tables, context_lens, out, part_acc, part_ml, counters, b, n_kv, nb, bs, n_splits, split_tokens, s);
  return (int)cudaErrorInvalidValue;
}
