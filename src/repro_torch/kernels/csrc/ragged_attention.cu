// Ragged segment attention for Hopper (sm_90a): the prefill chunks of a
// fused serving iteration.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ragged_attention.py:
// ragged_segment_attention (body _ragged_attn_kernel).  Segment s holds a
// prompt chunk of L query tokens; query (s, j) attends its own sequence's
// pool tokens at idx <= positions[s, j] through the segment's block table,
// with the same fp32 online softmax as the decode kernel.  Padding rows
// sit at position 0, attend token 0 and stay NaN-free.
//
// Design.  The Pallas kernel keeps a segment's whole (L*G, hd) query tile
// and fp32 accumulator in VMEM; at L = 512, G = 2, hd = 128 that is 1024
// rows and a 512 KB accumulator, beyond a block's 227 KB of shared
// memory.  So the query rows are tiled: the grid is
// (S, KV, ceil(L / (64 / G))), each block owns 64 query rows (64 / G
// tokens times G heads of one KV head) and loops over its segment's tokens
// in 32-token tiles (attention_tile.cuh).  A block bounds its token loop
// by the largest position in its own row tile, which is no looser than
// the segment bound max(positions[s]) // bs of the Pallas kernel, so
// pages past that bound are never read.
//
// Bound.  The pages a segment attends are read from HBM once per KV head
// ((max position + 1) * KV * hd * 2 * sizeof(T) bytes), against
// 4 * G * hd * sum over queries of (position + 1) flops per KV head: a
// chunk of L = 512 does hundreds of flops per byte, so the kernel is bound
// by operations.  This simple design does them in fp32 FMAs on the CUDA
// cores and re-reads a segment's pages once per row tile.
//
// Left for later.  Tensor-core products (mma / wgmma on bf16 tiles), a
// cp.async / TMA ring of K/V tiles, and skipping the fully-masked upper
// triangle inside the last tiles.
#include "attention_tile.cuh"

namespace {

using namespace repro_attn;

constexpr int kRaggedRpt = 4;   // 64 query rows per block: G <= 64

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ positions,
                        T* __restrict__ out, int seq_l, int n_kv, int g,
                        int nb, int bs, float scale) {
  constexpr int R = TileShape<HD, kRaggedRpt>::R;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* row_off = reinterpret_cast<long long*>(smem);
  int* pos = reinterpret_cast<int*>(row_off + R);
  float* smem_f = reinterpret_cast<float*>(pos + R);
  const int s = blockIdx.x, h = blockIdx.y;
  const int tok_per_block = R / g;
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const int j = blockIdx.z * tok_per_block + r / g;
    const bool own = r < tok_per_block * g && j < seq_l;
    const long long row = (long long)s * seq_l + j;
    row_off[r] = own ? ((row * n_kv + h) * g + r % g) * HD : -1;
    pos[r] = own ? positions[row] : -1;
  }
  __syncthreads();
  attend_rows<T, HD, kRaggedRpt>(q, k_pool, v_pool, out,
                                 block_tables + (long long)s * nb, nb, bs,
                                 n_kv, h, scale, row_off, pos, smem_f);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* positions,
                   void* out, int n_seg, int seq_l, int n_kv, int g, int nb,
                   int bs, cudaStream_t stream) {
  const size_t smem = TileShape<HD, kRaggedRpt>::kSmemBytes;
  auto kernel = ragged_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tok_per_block = TileShape<HD, kRaggedRpt>::R / g;
  const dim3 grid(n_seg, n_kv, (seq_l + tok_per_block - 1) / tok_per_block);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(positions), static_cast<T*>(out), seq_l, n_kv,
      g, nb, bs, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k_pool,
                        const void* v_pool, const void* block_tables,
                        const void* positions, void* out, int n_seg,
                        int seq_l, int n_kv, int g, int nb, int bs,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, stream);
    case 64: return launch<T, 64>(q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, stream);
    case 112: return launch<T, 112>(q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, stream);
    case 128: return launch<T, 128>(q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int ragged_attention_launch(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const void* block_tables,
                                       const void* positions, void* out,
                                       int n_seg, int seq_l, int n_kv, int g,
                                       int hd, int nb, int bs, int dtype,
                                       void* stream) {
  if (g < 1 || g > TileShape<32, kRaggedRpt>::R || n_seg < 1 || seq_l < 1 ||
      nb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, st);
  return (int)cudaErrorInvalidValue;
}
