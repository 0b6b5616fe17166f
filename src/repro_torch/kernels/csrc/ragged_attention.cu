// Ragged segment attention for Hopper (sm_90a): the prefill chunks of a
// fused serving iteration.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ragged_attention.py:
// ragged_segment_attention (body _ragged_attn_kernel).  Segment s holds a
// prompt chunk of L query tokens; query (s, j) attends its own sequence's
// pool tokens at idx <= positions[s, j] through the segment's block table,
// with an fp32 online softmax (NEG_INF = -1e30, scale hd**-0.5,
// denominator clamped to 1e-20).  Padding rows sit at position 0, attend
// token 0 and stay NaN-free.
//
// Bound on this card.  The pages a segment attends are read once per KV
// head ((max position + 1) * KV * hd * 2 * sizeof(T) bytes), against
// 4 * G * hd * sum over queries of (position + 1) flops per KV head: a
// chunk of L = 512 does hundreds of flops per byte, so the kernel is
// bound by operations, and in bf16 only the tensor cores reach the card's
// rate (989 TFLOP/s dense, against 67 for fp32 FMAs).
//
// Design (bfloat16).  A block of two warpgroups (256 threads) owns a tile
// of 128 query rows of one KV head of one segment, laid out as 128 / G
// tokens times their G heads, which share K/V and a causal position; each
// warpgroup owns 64 of the rows, and both multiply against the same K/V
// tiles, so the gathered pages cross from L2 once per 128 rows.  The
// block walks its segment's tokens in 64-token key tiles:
//   - S = Q K^T is 64 x 64 x hd per warpgroup on the tensor cores (wgmma
//     m64n64k16, q and K tiles in shared memory, fp32 accumulators);
//   - the online softmax runs on the accumulators in registers; P is
//     rounded to bf16, as the plain version rounds probabilities to v's
//     dtype, and becomes the register A operand of
//   - O += P V, 64 x hd x 64 per warpgroup (wgmma m64n{hd}k16, V read
//     MN-major from the same tile layout as K), into fp32 accumulators.
// q and the K/V tiles stay bf16 in shared memory in the 128-byte-swizzled
// layout of hopper.cuh (1.55x faster on the card than the unswizzled
// core-matrix layout); K/V tiles sit in a ring of two stages, filled by
// 16-byte cp.async copies through the block table (one table lookup per
// thread and tile).  The next tile's copies are issued right after the S
// product and fly while the current tile is multiplied; one barrier per
// tile both publishes a landed tile and frees the stage the next copies
// refill.  A block never reads a key tile past its rows' largest
// position, which is no looser than the Pallas segment bound
// max(positions[s]) // bs, so pages past that bound are never read;
// tokens of the last tile past the largest position are zero-filled, not
// read.  Only tiles that straddle a row's position (or that last bound)
// are masked.  Row tiles are issued latest first: a late tile of a chunk
// attends up to 32x the keys of an early one, and the long ones must not
// be left for last.  Every head dim of build.HEAD_DIMS (32, 64, 112, 128)
// runs on this body.
//
// float32 stays on the CUDA-core body of attention_tile.cuh (attend_rows:
// fp32 FMAs, 64 rows by 32-token tiles): tensor-core products cannot hold
// the 2e-5 float32 tolerance, and the float32 path serves the
// token-identity checks, not the served model.
//
// What is left.  The block runs its loads, its two products and its
// softmax in turn; only the second block on the SM overlaps them, and
// every tile pays a cp.async-to-wgmma proxy fence and a block barrier.
// Deeper rings (3-4 stages at one block per SM), q held in registers
// (one block per SM) and cutting long key ranges over more blocks were
// tried on the unswizzled layout and were slower.  What would help next
// is the shape of the card's fastest attention kernels: a producer warp
// issuing TMA copies (no proxy fence), and consumer warpgroups that
// overlap one tile's softmax with the next tile's products.
#include "attention_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_attn;
using namespace repro_hopper;

constexpr int kRaggedRpt = 4;   // fp32 body: 64 query rows per block: G <= 64

// ---------------------------------------------------------------- bf16 body

constexpr int kTcRows = 128;      // query rows per block: two warpgroups
constexpr int kTcThreads = 256;
constexpr int kKeyTile = 64;      // tokens per K/V tile
constexpr int kTcStages = 2;      // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcShape {
  static constexpr int kHdPad = (HD + 63) / 64 * 64;     // whole 128-byte rows
  static constexpr int kKvElems = kKeyTile * kHdPad;     // one K or V tile
  static constexpr size_t kTableBytes = 2048;            // row_off, pos, min / max
  static constexpr size_t kSmemBytes =
      1024 + kTableBytes +                               // + alignment slack
      (size_t)(kTcRows * kHdPad + 2 * kTcStages * kKvElems) * sizeof(__nv_bfloat16);
};

// element offset of the 16-byte piece (row r, columns 8c .. 8c+7) of a
// ROWS-row tile in the 128-byte-swizzled layout of hopper.cuh
template <int ROWS>
__device__ __forceinline__ int tile_offset(int r, int c) {
  return (c >> 3) * (ROWS * 64) + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// K-major operand (q or K) for k-step kk (columns 16 kk .. 16 kk + 15),
// rows row0 .. row0 + 63: inside a 128-byte row the step moves the start
// address by 32 bytes, and the hardware applies the swizzle
template <int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(const __nv_bfloat16* tile, int row0, int kk) {
  return smem_desc_sw128(tile + (kk >> 2) * (ROWS * 64) + row0 * 64 + (kk & 3) * 16,
                         16, 1024);
}

// MN-major V operand for the tile's tokens 16 kk .. 16 kk + 15: 8-token
// groups 1024 bytes apart, 64-column blocks a whole block apart
__device__ __forceinline__ uint64_t desc_v(const __nv_bfloat16* tile, int kk) {
  return smem_desc_sw128(tile + kk * 16 * 64, kKeyTile * 128, 1024);
}

// one row of a tile, 16 bytes a copy: thread (warp w, lane) copies pieces
// lane / 8 + 4j of row (lane % 8) + 8w (+ 64 per pass), so the eight
// neighbouring rows of one piece land in eight distinct bank groups and
// each row is read 64 contiguous bytes at a time.  A null src zero-fills
// (the copy then names `any`, a valid global address, and reads nothing).
template <int HD, int ROWS>
__device__ __forceinline__ void load_row(__nv_bfloat16* dst, int r,
                                         const __nv_bfloat16* src,
                                         const __nv_bfloat16* any, int lane) {
  constexpr int kCpr = HD / 8;                  // 16-byte pieces per row
#pragma unroll
  for (int j = 0; j < (kCpr + 3) / 4; ++j) {
    const int c = (lane >> 3) + 4 * j;
    if (c < kCpr)
      cp_async16(dst + tile_offset<ROWS>(r, c), src ? src + c * 8 : any, src ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
ragged_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k_pool,
                           const __nv_bfloat16* __restrict__ v_pool,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ positions,
                           __nv_bfloat16* __restrict__ out, int n_seg,
                           int seq_l, int n_kv, int g, int nb, int bs,
                           int n_row_tiles, float scale_log2) {
  using Shape = TcShape<HD>;
  constexpr int kAcc = HD / 2;                  // O accumulators per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =                         // 1024-byte aligned tiles
      smem_raw + ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) & 1023);
  long long* row_off = reinterpret_cast<long long*>(smem);
  int* pos = reinterpret_cast<int*>(row_off + kTcRows);
  int* red = pos + kTcRows;                     // min / max position
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + Shape::kTableBytes);
  __nv_bfloat16* k_s = q_s + kTcRows * Shape::kHdPad;        // [stage]
  __nv_bfloat16* v_s = k_s + kTcStages * Shape::kKvElems;    // [stage]

  // latest row tiles first: tile index runs down as the block id runs up
  const int per_tile = n_seg * n_kv;
  const int tile = n_row_tiles - 1 - (int)blockIdx.x / per_tile;
  const int s = ((int)blockIdx.x % per_tile) / n_kv;
  const int h = (int)blockIdx.x % n_kv;
  const int tid = threadIdx.x;
  const int tok_per_block = kTcRows / g;
  if (tid < kTcRows) {
    const int r = tid;
    const int j = tile * tok_per_block + r / g;
    const bool own = r < tok_per_block * g && j < seq_l;
    const long long row = (long long)s * seq_l + j;
    row_off[r] = own ? ((row * n_kv + h) * g + r % g) * HD : -1;
    pos[r] = own ? positions[row] : -1;
  }
  if (tid == 0) { red[0] = 0x7fffffff; red[1] = -1; }
  __syncthreads();
  if (tid < kTcRows && pos[tid] >= 0) {
    atomicMin(&red[0], pos[tid]);
    atomicMax(&red[1], pos[tid]);
  }
  __syncthreads();
  const int min_pos = red[0];
  const int n_tok = min(red[1] + 1, nb * bs);
  const int n_tiles = (n_tok + kKeyTile - 1) / kKeyTile;
  const int* table = block_tables + (long long)s * nb;
  const int warp = tid >> 5, lane = tid & 31;
  const int ld_row = (lane & 7) + 8 * warp;     // the K/V row this thread copies
#pragma unroll
  for (int pass = 0; pass < kTcRows / 64; ++pass) {
    const int r = ld_row + 64 * pass;
    load_row<HD, kTcRows>(q_s, r, row_off[r] >= 0 ? q + row_off[r] : nullptr, q, lane);
  }

  auto load_kv = [&](int t0, int stage) {
    const int tok = t0 + ld_row;
    const __nv_bfloat16 *ks = nullptr, *vs = nullptr;
    if (tok < n_tok) {
      const long long off =
          (((long long)table[tok / bs] * bs + tok % bs) * n_kv + h) * HD;
      ks = k_pool + off;
      vs = v_pool + off;
    }
    load_row<HD, kKeyTile>(k_s + stage * Shape::kKvElems, ld_row, ks, k_pool, lane);
    load_row<HD, kKeyTile>(v_s + stage * Shape::kKvElems, ld_row, vs, v_pool, lane);
  };
  load_kv(0, 0);
  cp_async_commit();                            // q and the first tile

  // this thread's accumulator rows, in its warpgroup's 64: r0 and r0 + 8
  const int wg = tid >> 7;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const int c0 = 2 * (lane & 3);                // its first column in each 8
  const int pos0 = pos[r0], pos1 = pos[r1];
  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int t0 = it * kKeyTile;
    // tile `it` has landed for every thread, and every warpgroup is done
    // with tile it - 1, whose stage the next copy refills
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T: 64 x 64 per warpgroup, hd / 16 steps of k16; the next
    // tile's copies are issued while the products run
    const __nv_bfloat16* kt = k_s + stage * Shape::kKvElems;
    const __nv_bfloat16* vt = v_s + stage * Shape::kKvElems;
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(sc, desc_kmajor<kTcRows>(q_s, wg * 64, kk),
                   desc_kmajor<kKeyTile>(kt, 0, kk), kk > 0);
    wgmma_commit();
    if (it + 1 < n_tiles) {
      load_kv(t0 + kKeyTile, stage ^ 1);
      cp_async_commit();
    }
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax in the log2 domain; sc[4j + v] is row (v < 2 ? r0 :
    // r1), token t0 + 8j + c0 + (v & 1).  Tile 0 holds token 0, which every
    // owned row attends, so a masked score's exp2 underflows to 0.
    const bool straddles = t0 + kKeyTile - 1 > min_pos || t0 + kKeyTile > n_tok;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float x = sc[4 * j + v] * scale_log2;
        if (straddles) {
          const int tok = t0 + 8 * j + c0 + (v & 1);
          if (tok > (v < 2 ? pos0 : pos1) || tok >= n_tok) x = kNegInf;
        }
        sc[4 * j + v] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
    uint32_t pa[4][4];                          // P as 4 k16 A fragments
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = fast_exp2(sc[4 * j] - mn0), p1 = fast_exp2(sc[4 * j + 1] - mn0);
      const float p2 = fast_exp2(sc[4 * j + 2] - mn1), p3 = fast_exp2(sc[4 * j + 3] - mn1);
      s0 += p0 + p1;
      s1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16x2(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
    // each thread keeps its own share of the row sums; the 4 threads of a
    // row see the same rescale factors and are summed at the end
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P V: 64 x hd per warpgroup, 4 steps of k16 over the tile's tokens
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk)
      WgmmaRS<HD>::run(o, pa[kk], desc_v(vt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const long long off0 = row_off[r0], off1 = row_off[r1];
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (off0 >= 0)
      *reinterpret_cast<__nv_bfloat162*>(out + off0 + 8 * j + c0) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (off1 >= 0)
      *reinterpret_cast<__nv_bfloat162*>(out + off1 + 8 * j + c0) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// ---------------------------------------------------------------- fp32 body

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
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

// ---------------------------------------------------------------- launchers

template <int HD>
cudaError_t launch_tc(const void* q, const void* k_pool, const void* v_pool,
                      const void* block_tables, const void* positions,
                      void* out, int n_seg, int seq_l, int n_kv, int g, int nb,
                      int bs, cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  const size_t smem = TcShape<HD>::kSmemBytes;
  auto kernel = ragged_attention_tc_kernel<HD>;
  cudaError_t err = allow_dynamic_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int tok_per_block = kTcRows / g;
  const int n_row_tiles = (seq_l + tok_per_block - 1) / tok_per_block;
  const long long blocks = (long long)n_row_tiles * n_seg * n_kv;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out),
      n_seg, seq_l, n_kv, g, nb, bs, n_row_tiles,
      (float)(kLog2e / sqrt((double)HD)));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k_pool, const void* v_pool,
                       const void* block_tables, const void* positions,
                       void* out, int n_seg, int seq_l, int n_kv, int g, int nb,
                       int bs, cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  const size_t smem = TileShape<HD, kRaggedRpt>::kSmemBytes;
  auto kernel = ragged_attention_kernel<float, HD>;
  cudaError_t err = allow_dynamic_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int tok_per_block = TileShape<HD, kRaggedRpt>::R / g;
  const dim3 grid(n_seg, n_kv, (seq_l + tok_per_block - 1) / tok_per_block);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(positions), static_cast<float*>(out), seq_l, n_kv,
      g, nb, bs, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k_pool,
                   const void* v_pool, const void* block_tables,
                   const void* positions, void* out, int n_seg, int seq_l,
                   int n_kv, int g, int nb, int bs, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<HD>(q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, stream);
  if (dtype == 1)
    return launch_tc<HD>(q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, stream);
  return cudaErrorInvalidValue;
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
  if (g < 1 || g > 64 || n_seg < 1 || seq_l < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return (int)launch<32>(dtype, q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, st);
    case 64: return (int)launch<64>(dtype, q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, st);
    case 80: return (int)launch<80>(dtype, q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, st);
    case 112: return (int)launch<112>(dtype, q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, st);
    case 128: return (int)launch<128>(dtype, q, k_pool, v_pool, block_tables, positions, out, n_seg, seq_l, n_kv, g, nb, bs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
