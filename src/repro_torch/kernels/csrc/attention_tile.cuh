// Shared body of the two paged-attention kernels: one CUDA block runs an
// fp32 online softmax for up to R = 16 * RPT query rows of one KV head
// over the paged K/V of one sequence, 32 tokens at a time.
//
// The paged decode kernel (paged_attention.cu) and the ragged segment
// kernel (ragged_attention.cu) differ only in which query rows a block
// owns and where each row's causal bound comes from; both fill the
// per-row tables below and call attend_rows().
//
// Layout of the 256 threads: a 16 x 16 grid (ty, tx).  For scores, thread
// (ty, tx) owns rows ty + 16*i (i < RPT) and tile tokens tx and tx + 16.
// For the output accumulator it owns the same rows and the head-dim
// columns tx + 16*k (k < HD / 16), so the per-row rescale factor of the
// online softmax stays in the thread that needs it.  The 16 threads of
// one row sit in one half-warp, so row max and row sum are half-warp
// shuffles.  Shared memory holds q, one K and one V tile and the tile's
// probabilities, all in fp32, with rows padded by one float so the
// column reads of the score loop hit 16 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_attn {

constexpr int kThreads = 256;
constexpr int kTileTokens = 32;
constexpr float kNegInf = -1e30f;   // the JAX kernels' NEG_INF, not -inf

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// 16-byte load of 4 floats or 8 bf16 values, widened to fp32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as astype does
}

template <int HD, int RPT>
struct TileShape {
  static constexpr int R = 16 * RPT;            // query rows per block
  static constexpr int LD = HD + 1;             // padded row of q / K / V
  static constexpr int PLD = kTileTokens + 1;   // padded row of p
  static constexpr size_t kSmemBytes =
      R * sizeof(long long) + R * sizeof(int) +
      (size_t)(R * LD + 2 * kTileTokens * LD + R * PLD) * sizeof(float);
};

// Per-row tables in shared memory, filled by the calling kernel before a
// __syncthreads():
//   row_off[r]  element offset of row r's hd-vector in q and out; -1 for a
//               row this block does not own (never read, never written)
//   pos[r]      last token index row r may attend (inclusive); -1 for an
//               unowned row
// The block visits tokens [0, min(max(pos) + 1, nb * bs)) of its
// sequence: pages past the largest position of its own rows are never
// read, and no table entry past them is dereferenced.
template <typename T, int HD, int RPT>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, T* __restrict__ out,
    const int* __restrict__ table, int nb, int bs, int n_kv, int kvh,
    float scale, const long long* row_off, const int* pos,
    float* smem_f) {
  using Shape = TileShape<HD, RPT>;
  constexpr int R = Shape::R, LD = Shape::LD, PLD = Shape::PLD;
  constexpr int VN = VecWidth<T>::N;
  constexpr int VPR = HD / VN;       // 16-byte vectors per hd row
  constexpr int KC = HD / 16;        // accumulator columns per thread
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");

  float* q_s = smem_f;
  float* k_s = q_s + R * LD;
  float* v_s = k_s + kTileTokens * LD;
  float* p_s = v_s + kTileTokens * LD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int idx = tid; idx < R * VPR; idx += kThreads) {
    const int r = idx / VPR, c = idx % VPR;
    float buf[VN];
    if (row_off[r] >= 0) {
      load16(q + row_off[r] + c * VN, buf);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) buf[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) q_s[r * LD + c * VN + i] = buf[i];
  }

  int max_pos = -1;
  for (int r = 0; r < R; ++r) max_pos = max(max_pos, pos[r]);
  const int n_tok = min(max_pos + 1, nb * bs);

  float m[RPT], l[RPT], acc[RPT][KC];
  int my_pos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    my_pos[i] = pos[ty + 16 * i];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[i][k] = 0.f;
  }

  for (int t0 = 0; t0 < n_tok; t0 += kTileTokens) {
    __syncthreads();   // q_s is loaded / the last tile's readers are done
    for (int idx = tid; idx < kTileTokens * VPR; idx += kThreads) {
      const int t = idx / VPR, c = idx % VPR, tok = t0 + t;
      float kb[VN], vb[VN];
      if (tok < n_tok) {
        const long long blk = table[tok / bs];
        const long long off =
            ((blk * bs + tok % bs) * n_kv + kvh) * (long long)HD + c * VN;
        load16(k_pool + off, kb);
        load16(v_pool + off, vb);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kb[i] = vb[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        k_s[t * LD + c * VN + i] = kb[i];
        v_s[t * LD + c * VN + i] = vb[i];
      }
    }
    __syncthreads();

    float s[RPT][2];
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float k0 = k_s[tx * LD + d];
      const float k1 = k_s[(tx + 16) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qq = q_s[(ty + 16 * i) * LD + d];
        s[i][0] = fmaf(qq, k0, s[i][0]);
        s[i][1] = fmaf(qq, k1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int tok = t0 + tx + 16 * j;
        s[i][j] = (tok < n_tok && tok <= my_pos[i]) ? s[i][j] * scale
                                                    : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[i][k] *= alpha;
      p_s[(ty + 16 * i) * PLD + tx] = p0;
      p_s[(ty + 16 * i) * PLD + tx + 16] = p1;
    }
    __syncthreads();

    const int nt = min(kTileTokens, n_tok - t0);
    for (int t = 0; t < nt; ++t) {
      float vv[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) vv[k] = v_s[t * LD + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pp = p_s[(ty + 16 * i) * PLD + t];
#pragma unroll
        for (int k = 0; k < KC; ++k) acc[i][k] = fmaf(pp, vv[k], acc[i][k]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const long long off = row_off[ty + 16 * i];
    if (off < 0) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int k = 0; k < KC; ++k) store1(out + off + tx + 16 * k, acc[i][k] / denom);
  }
}

}  // namespace repro_attn
