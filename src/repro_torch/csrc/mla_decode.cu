// Single-token latent attention (MLA's absorbed decode) against the latent
// cache, split across CTAs along the cache.
//
// Replaces no TPU kernel: the JAX package has no latent attention. In a
// DeepSeek-V3 block's decode step each head's key expansion is folded into
// its query, so all 16 heads score q = [q_lat (512), q_pe (64)] against the
// same cached row [c_kv (512), k_pe (64)] and sum the same c_kv rows by their
// probabilities: o_lat[h] = softmax(q[h] . row * scale) @ c_kv. Keys at or past
// kv_len[b] are masked; a sequence with kv_len 0 gets zeros.
//
// Bound on the H100: bytes. Each valid row (1152 B in bf16) is read once for
// all 16 heads; at the cell's shape (B = 64, 2049-2304 rows) that is 151-170
// MB a call, 45-51 us at 3.35 TB/s, against 5 GFLOP of products (2176 FLOP a
// row and head): 30 FLOP a byte, over what the CUDA cores sustain (~20 at
// fp32 FMA) but far under the tensor cores' ridge, so the products run on
// the tensor cores and the rows stream.
//
// Design: one launch, grid (n_split, B), 8 warps a CTA.
// - The 16 heads are the 16 rows of mma.sync m16n8k16 tiles (bf16 in, fp32
//   sums). Q (16 x 576) sits in shared memory for the whole call.
// - A CTA walks its range of cache rows 64 at a time. Tiles are copied into a
//   two-stage ring in shared memory with cp.async (16-byte copies, rows past
//   the valid range zero-filled), the next tile in flight while this one is
//   computed. Rows are padded by 16 bytes so that the fragment loads of the 8
//   row groups of a warp fall in distinct banks.
// - Scores: warp w takes keys 8w..8w+7 of the tile (36 k-steps over 576).
//   The tile's row maxima merge across warps in shared memory; every warp
//   then holds the same running max, so each rescales its own part of the
//   output alone. P goes to shared memory in bf16.
// - P @ c_kv: warp w owns output columns 64w..64w+63 (8 n-tiles, 32 fp32
//   accumulators a lane); the c_kv fragments come from the same tile with
//   ldmatrix.trans.
// - The n_split CTAs of one sequence form a thread-block cluster: CTA 0 reads
//   the others' partial (m, l, o[16][512]) from their shared memory, merges
//   them and writes o in bf16, so no workspace and no second kernel. A split
//   that starts at or past kv_len holds m = -inf, l = 0 and drops out.
// No host read: kv_len lives on the device, so the call can be captured in a
// CUDA graph.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int H = 16;            // heads: the rows of an mma tile
constexpr int R = 512;           // latent width (c_kv)
constexpr int P = 64;            // rope width (k_pe)
constexpr int D = R + P;         // a cached row
constexpr int LD = D + 8;        // padded row in shared memory (elements)
constexpr int TILE = 64;         // cache rows a step
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PLD = TILE + 8;    // padded row of P (elements)
constexpr int MAX_SPLITS = 8;

constexpr int Q_BYTES = H * LD * 2;
constexpr int K_BYTES = TILE * LD * 2;                   // one stage
constexpr int P_BYTES = H * PLD * 2;
constexpr int RED_BYTES = WARPS * H * 4;
constexpr int SMEM = Q_BYTES + 2 * K_BYTES + P_BYTES + 2 * RED_BYTES + 2 * H * 4;
static_assert(H * R * 4 <= 2 * K_BYTES, "the partial output reuses the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy cache rows [r0, r0 + TILE) of sequence b into a stage; rows at or past
// s1 are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks, const __nv_bfloat16* c_kv,
                                          const __nv_bfloat16* k_pe, long long csb,
                                          long long cst, long long psb, long long pst, int b,
                                          int r0, int s1) {
  constexpr int CHUNKS = D / 8;   // 16-byte copies a row: 64 of c_kv, 8 of k_pe
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int row = i / CHUNKS, ch = i % CHUNKS;
    const int t = r0 + row;
    const bool ok = t < s1;
    const __nv_bfloat16* src =
        !ok ? c_kv
            : (ch < R / 8 ? c_kv + b * csb + (long long)t * cst + ch * 8
                          : k_pe + b * psb + (long long)t * pst + (ch - R / 8) * 8);
    cp_async16(ks + row * LD + ch * 8, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mla_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ c_kv,
                  const __nv_bfloat16* __restrict__ k_pe, const int* __restrict__ kv_len,
                  __nv_bfloat16* __restrict__ o, int Tn, int chunk, long long csb,
                  long long cst, long long psb, long long pst, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + Q_BYTES);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + Q_BYTES + 2 * K_BYTES);
  float* red_m = reinterpret_cast<float*>(smem + Q_BYTES + 2 * K_BYTES + P_BYTES);
  float* red_l = red_m + WARPS * H;
  float* part_m = red_l + WARPS * H;
  float* part_l = part_m + H;
  float* part_o = reinterpret_cast<float*>(ring);   // after the loop: (H, R)

  const int split = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int len = max(0, min(kv_len[b], Tn));
  const int s0 = split * chunk;
  const int s1 = min(len, s0 + chunk);   // valid rows of this split: [s0, s1)

  // q: (B, H, D) contiguous
  const __nv_bfloat16* qb = q + (long long)b * H * D;
  for (int i = threadIdx.x; i < H * (D / 8); i += THREADS) {
    const int row = i / (D / 8), ch = i % (D / 8);
    cp_async16(qs + row * LD + ch * 8, qb + row * D + ch * 8, true);
  }
  if (s0 < s1) load_tile(ring, c_kv, k_pe, csb, cst, psb, pst, b, s0, s1);
  cp_async_commit();

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;   // running max of rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;               // this lane's part of the row sums

  int stage = 0;
  for (int r0 = s0; r0 < s1; r0 += TILE, stage ^= 1) {
    if (r0 + TILE < s1) {
      load_tile(ring + (stage ^ 1) * TILE * LD, c_kv, k_pe, csb, cst, psb, pst, b, r0 + TILE,
                s1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = ring + stage * TILE * LD;

    // scores of keys 8 * warp .. + 7 for the 16 heads
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* krow = ks + (warp * 8 + g) * LD + 2 * t4;
#pragma unroll 4
    for (int k0 = 0; k0 < D; k0 += 16) {
      const __nv_bfloat16* qa = qs + g * LD + k0 + 2 * t4;
      mma_bf16(s, lds32(qa), lds32(qa + 8 * LD), lds32(qa + 8), lds32(qa + 8 * LD + 8),
               lds32(krow + k0), lds32(krow + k0 + 8));
    }
    const int key = r0 + warp * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = (key + (e & 1) < s1) ? s[e] * scale_log2 : -INFINITY;
    float mx_lo = fmaxf(s[0], s[1]), mx_hi = fmaxf(s[2], s[3]);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    if (t4 == 0) {
      red_m[warp * H + g] = mx_lo;
      red_m[warp * H + g + 8] = mx_hi;
    }
    __syncthreads();
    float tm_lo = -INFINITY, tm_hi = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      tm_lo = fmaxf(tm_lo, red_m[w * H + g]);
      tm_hi = fmaxf(tm_hi, red_m[w * H + g + 8]);
    }
    const float mn_lo = fmaxf(m_lo, tm_lo), mn_hi = fmaxf(m_hi, tm_hi);
    const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float a_lo = exp2f(m_lo - mu_lo), a_hi = exp2f(m_hi - mu_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    const float p0 = exp2f(s[0] - mu_lo), p1 = exp2f(s[1] - mu_lo);
    const float p2 = exp2f(s[2] - mu_hi), p3 = exp2f(s[3] - mu_hi);
    l_lo = l_lo * a_lo + p0 + p1;
    l_hi = l_hi * a_hi + p2 + p3;
    *reinterpret_cast<uint32_t*>(ps + g * PLD + warp * 8 + 2 * t4) = pack_bf16(p0, p1);
    *reinterpret_cast<uint32_t*>(ps + (g + 8) * PLD + warp * 8 + 2 * t4) = pack_bf16(p2, p3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= a_lo;
      acc[j][1] *= a_lo;
      acc[j][2] *= a_hi;
      acc[j][3] *= a_hi;
    }
    __syncthreads();

    // P (16 x 64) @ c_kv (64 x 512), this warp's 64 columns
    const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
    for (int k0 = 0; k0 < TILE; k0 += 16) {
      const __nv_bfloat16* pa = ps + g * PLD + k0 + 2 * t4;
      const uint32_t a0 = lds32(pa), a1 = lds32(pa + 8 * PLD), a2 = lds32(pa + 8),
                     a3 = lds32(pa + 8 * PLD + 8);
      const __nv_bfloat16* vrow = ks + (k0 + ((mi & 1) << 3) + ri) * LD + warp * 64 +
                                  ((mi >> 1) << 3);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vrow + jj * 16);
        mma_bf16(acc[2 * jj], a0, a1, a2, a3, bf[0], bf[1]);
        mma_bf16(acc[2 * jj + 1], a0, a1, a2, a3, bf[2], bf[3]);
      }
    }
    __syncthreads();   // the stage and P are rewritten next step
  }

  cp_async_wait<0>();   // a split with no valid row still has q in flight
  __syncthreads();

  // this CTA's partial: row sums over lanes and warps, the max, the output
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  if (t4 == 0) {
    red_l[warp * H + g] = l_lo;
    red_l[warp * H + g + 8] = l_hi;
    if (warp == 0) {
      part_m[g] = m_lo;
      part_m[g + 8] = m_hi;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = warp * 64 + j * 8 + 2 * t4;
    *reinterpret_cast<float2*>(part_o + g * R + col) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(part_o + (g + 8) * R + col) = make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  if (threadIdx.x < H) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += red_l[w * H + threadIdx.x];
    part_l[threadIdx.x] = l;
  }

  // merge the splits: CTA 0 of the cluster reads the others' partials
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 0) {
    const int n_split = (int)cluster.num_blocks();
    __nv_bfloat16* ob = o + (long long)b * H * R;
    for (int i = threadIdx.x; i < H * R; i += THREADS) {
      const int h = i / R;
      float mx = -INFINITY;
      for (int r = 0; r < n_split; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(&part_m[h], r));
      const float mu = mx == -INFINITY ? 0.f : mx;
      float lsum = 0.f, a = 0.f;
      for (int r = 0; r < n_split; ++r) {
        const float c = exp2f(*cluster.map_shared_rank(&part_m[h], r) - mu);
        lsum += *cluster.map_shared_rank(&part_l[h], r) * c;
        a += *cluster.map_shared_rank(&part_o[i], r) * c;
      }
      ob[i] = __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);   // kv_len == 0 -> zeros
    }
  }
  cluster.sync();   // every CTA's shared memory stays until CTA 0 has read it
}

}  // namespace

// q: (B, 16, 576) contiguous; c_kv: rows of 512 at strides (batch, row) =
// strides[0], strides[1]; k_pe: rows of 64 at strides[2], strides[3]; o: (B,
// 16, 512) contiguous; all bf16. The caller has checked 16-byte alignment and
// chose n_split <= 8 and chunk with n_split * chunk >= T.
extern "C" int trims_mla_decode(const void* q, const void* c_kv, const void* k_pe,
                                const void* kv_len, void* o, long long B, long long Tn,
                                const long long* strides, float scale, int n_split, int chunk,
                                void* stream) {
  if (B <= 0) return 0;
  if (n_split <= 0 || n_split > MAX_SPLITS || chunk <= 0 || (long long)n_split * chunk < Tn)
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;   // once, before the first launch (never inside a capture)
  if (!smem_set) {
    const cudaError_t e = trims::allow_smem(mla_decode_kernel, SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_split, (unsigned)B, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, mla_decode_kernel, (const __nv_bfloat16*)q,
                                 (const __nv_bfloat16*)c_kv, (const __nv_bfloat16*)k_pe,
                                 (const int*)kv_len, (__nv_bfloat16*)o, (int)Tn, chunk,
                                 strides[0], strides[1], strides[2], strides[3],
                                 scale * 1.4426950408889634f);
}
