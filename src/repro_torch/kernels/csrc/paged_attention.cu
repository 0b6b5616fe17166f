// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (body _paged_attn_kernel): one query token per sequence
// attends its paged KV with an fp32 online softmax, mask idx < cl, scale
// hd**-0.5, denominator clamped to 1e-20, output in q's dtype.  cl = 0
// gives zero rows, as the Pallas kernel does.
//
// Design.  The TPU grid (B, KV, pages) ran its page axis in order on one
// core, carrying m / l / acc in VMEM scratch.  Here the grid is (B, KV):
// one block per (sequence, KV head) loops over the sequence's tokens
// 0 .. cl-1 in 32-token tiles gathered through the block table, and keeps
// the G query rows and the m / l / acc state on chip (attention_tile.cuh).
// Pages at or past cl are never read.
//
// Bound.  Decode reads each context token's K and V row once per KV head:
// sum(cl) * KV * hd * 2 * sizeof(T) bytes of gathered pages, against
// 4 * sum(cl) * KV * G * hd flops, so the kernel is bound by HBM bytes.
//
// Left for later.  The simple design loads each tile with plain 16-byte
// loads and synchronises the block between load and compute, so only one
// tile is in flight per block; a cp.async / TMA ring of tiles would keep
// several in flight.  With G = 2 the 16-row tile leaves most of the score
// threads idle; a split of the token loop across blocks (flash-decoding)
// would raise occupancy for short batches.
#include "attention_tile.cuh"

namespace {

using namespace repro_attn;

constexpr int kDecodeRpt = 1;   // 16 query rows per block: G <= 16

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens,
                       T* __restrict__ out, int n_kv, int g, int nb, int bs,
                       float scale) {
  constexpr int R = TileShape<HD, kDecodeRpt>::R;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* row_off = reinterpret_cast<long long*>(smem);
  int* pos = reinterpret_cast<int*>(row_off + R);
  float* smem_f = reinterpret_cast<float*>(pos + R);
  const int b = blockIdx.x, h = blockIdx.y;
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const bool own = r < g;
    row_off[r] = own ? (((long long)b * n_kv + h) * g + r) * HD : -1;
    pos[r] = own ? context_lens[b] - 1 : -1;
  }
  __syncthreads();
  attend_rows<T, HD, kDecodeRpt>(q, k_pool, v_pool, out,
                                 block_tables + (long long)b * nb, nb, bs,
                                 n_kv, h, scale, row_off, pos, smem_f);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* context_lens,
                   void* out, int b, int n_kv, int g, int nb, int bs,
                   cudaStream_t stream) {
  const size_t smem = TileShape<HD, kDecodeRpt>::kSmemBytes;
  auto kernel = paged_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b, n_kv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<T*>(out), n_kv, g,
      nb, bs, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k_pool,
                        const void* v_pool, const void* block_tables,
                        const void* context_lens, void* out, int b, int n_kv,
                        int g, int nb, int bs, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k_pool, v_pool, block_tables, context_lens, out, b, n_kv, g, nb, bs, stream);
    case 64: return launch<T, 64>(q, k_pool, v_pool, block_tables, context_lens, out, b, n_kv, g, nb, bs, stream);
    case 112: return launch<T, 112>(q, k_pool, v_pool, block_tables, context_lens, out, b, n_kv, g, nb, bs, stream);
    case 128: return launch<T, 128>(q, k_pool, v_pool, block_tables, context_lens, out, b, n_kv, g, nb, bs, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* context_lens, void* out,
                                      int b, int n_kv, int g, int hd, int nb,
                                      int bs, int dtype, void* stream) {
  if (g < 1 || g > TileShape<32, kDecodeRpt>::R || b < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k_pool, v_pool, block_tables, context_lens, out, b, n_kv, g, nb, bs, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, block_tables, context_lens, out, b, n_kv, g, nb, bs, s);
  return (int)cudaErrorInvalidValue;
}
