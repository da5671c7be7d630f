// Attention forward with online softmax (FlashAttention-3, arXiv:2407.08608).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (_fwd_kernel). Same function: fp32 running max / sum,
// scale 1/sqrt(D), GQA through h / group, a top-left aligned causal mask
// (row >= col), k tiles above the diagonal skipped, and rows whose softmax
// sum is 0 written as 0. Unlike the Pallas kernel it masks ragged S and T
// instead of asserting on them.
//
// Bound on the H100. At the slice's prefill shape (2, 512, 32, 128) bf16 the
// bytes that must move (q, k, v, o once) take 10 us at 3.35 TB/s and the
// causal products ~4.4 us at the 989 TFLOP/s bf16 tensor-core peak, so the
// kernel is bound by bytes if its products run on the tensor cores. The
// first port ran them on the fp32 FMA pipe (67 TFLOP/s) with one
// shared-memory load per FMA, 55x its bound.
//
// Design (bf16). One CTA owns one (q head, batch, 128-row q tile) and walks
// the k tiles up to the diagonal itself, so nothing crosses CTAs. The CTAs
// are launched longest tile first (the reverse of the causal order), so the
// hardware's scheduler hands the short tiles to the SMs that finish first:
// - one producer warp issues TMA loads: q once, then 64-key K and V tiles
//   into a 3-stage ring in shared memory, with a "full" and an "empty"
//   mbarrier per stage. The tensor maps are 4-D over the model's (B, L, H, D)
//   layout, read by strides, encoded on the host and passed by value as
//   __grid_constant__ parameters. A 128-byte swizzle caps a box at 128
//   bytes, so a D = 128 tile arrives as two 64-column boxes;
// - two consumer warpgroups, 64 q rows each, compute S = Q K^T with wgmma
//   m64n64k16 from shared memory into fp32 registers, run the online
//   softmax on that fragment (exp2 with log2(e) folded into the scale; row
//   max and sum across the 4 threads of a row), turn it into bf16 pairs in
//   place and compute O += P V with wgmma from registers, V read MN-major
//   (transposed descriptor);
// - only diagonal tiles and the ragged last tile are masked. TMA fills keys
//   at or past T with zeros, which would score 0, so those columns are set
//   to -inf explicitly. Head dims below the template's are zero-filled by
//   TMA, which leaves the products unchanged.
//
// The template takes the key width DK and the value width DV apart. Equal
// widths (64, 128) serve every GQA model; DK 192 with DV 128 is latent
// attention's prefill (DeepSeek-V3's non-absorbed form: each head's key is
// 128 values expanded from the latent plus the 64 RoPE values, its value
// 128). There q and K arrive as three 64-column boxes and V as two, and
// the output is DV wide; the fragments a thread holds are those of D = 128.
//
// float32 inputs are not on the serving path and wgmma would read them as
// TF32, which breaks the fp32 tolerance of 1e-4. They take the SIMT kernel
// below, chosen by dtype: an explicit dispatch, not a fallback.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace trims::sm90;

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int BQ = 128;                 // q rows per CTA
// 64-key tiles keep a consumer thread's fragments (O 64, S 32, P 16 values
// at D = 128) inside the 168 registers that 9 warps on one SM allow.
constexpr int BKV = 64;                 // keys per K/V tile
constexpr int STAGES = 3;               // K/V ring depth
constexpr int CONSUMER_WARPS = 8;       // two warpgroups
constexpr int TC_THREADS = CONSUMER_WARPS * 32 + 32;   // + one producer warp
constexpr int ROW_BYTES = 128;          // one swizzled box row: 64 bf16

template <int DK, int DV>
struct TcLayout {
  static constexpr int K_STRIPS = DK / 64;               // 64-column boxes of a q or K row
  static constexpr int V_STRIPS = DV / 64;               // of a V row
  static constexpr int Q_STRIP = BQ * ROW_BYTES;         // bytes of one q box
  static constexpr int KV_STRIP = BKV * ROW_BYTES;       // bytes of one K or V box
  static constexpr int Q_BYTES = K_STRIPS * Q_STRIP;
  static constexpr int K_BYTES = K_STRIPS * KV_STRIP;    // K tile
  static constexpr int V_BYTES = V_STRIPS * KV_STRIP;    // V tile
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

template <int D>
__device__ __forceinline__ void pv_product(float (&acc)[D / 2], const uint32_t (&a)[4],
                                           uint64_t desc_v);
template <>
__device__ __forceinline__ void pv_product<128>(float (&acc)[64], const uint32_t (&a)[4],
                                                uint64_t desc_v) {
  wgmma_rs_m64n128k16_tb(acc, a, desc_v);
}
template <>
__device__ __forceinline__ void pv_product<64>(float (&acc)[32], const uint32_t (&a)[4],
                                               uint64_t desc_v) {
  wgmma_rs_m64n64k16_tb(acc, a, desc_v);
}

// This CTA's tile: (q tile, batch, head), q tiles longest first.
struct Tile {
  int q0, b, h, n_kv;
  __device__ __forceinline__ Tile(int B, int Hq, int n_qt, int Tn, int causal) {
    const int t = blockIdx.x, per = B * Hq, r = t % per;
    q0 = (n_qt - 1 - t / per) * BQ;
    b = r / Hq;
    h = r % Hq;
    const int kv_end = causal ? min(Tn, q0 + BQ) : Tn;   // tiles above the diagonal are skipped
    n_kv = (kv_end + BKV - 1) / BKV;
  }
};

// Consumer warpgroups: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64);
// this thread holds rows r_lo and r_lo + 8 of the accumulator fragments.
template <int DK, int DV>
__device__ __forceinline__ void consume(const Tile& tile, __nv_bfloat16* __restrict__ o,
                                        uint32_t sq, uint32_t bar_q, uint32_t bar_full0,
                                        uint32_t bar_empty0, int S, int Tn, int Dv,
                                        long long osb, long long oss, long long osh,
                                        float scale_log2, int causal) {
  using L = TcLayout<DK, DV>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int cpair = (lane & 3) * 2;
  const uint32_t sq_wg = sq + wg * 64 * ROW_BYTES;
  const int q0 = tile.q0, b = tile.b, h = tile.h, n_tiles = tile.n_kv;
  const int row_min = q0 + wg * 64;
  const int r_lo = row_min + (warp & 3) * 16 + (lane >> 2);

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t sk = sq + L::Q_BYTES + s * L::STAGE_BYTES, sv = sk + L::K_BYTES;
    mbar_wait(bar_full0 + 8 * s, (j / STAGES) & 1);

    // S = Q K^T over DK in k16 steps; step kk reads box kk / 4 at byte 32 (kk % 4)
    float sc[BKV / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      const uint64_t da = desc_sw128(sq_wg + (kk >> 2) * L::Q_STRIP + off, 16, 1024);
      const uint64_t db = desc_sw128(sk + (kk >> 2) * L::KV_STRIP + off, 16, 1024);
      wgmma_ss_m64n64k16(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // fragment element i: row r_lo + 8 ((i >> 1) & 1), column k0 + 8 (i >> 2) + cpair + (i & 1)
    const int k0 = j * BKV;
    if (k0 + BKV > Tn || (causal && k0 + BKV - 1 > row_min)) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int col = k0 + (i >> 2) * 8 + cpair + (i & 1);
        const int row = r_lo + ((i >> 1) & 1) * 8;
        if (col >= Tn || (causal && col > row)) sc[i] = -INFINITY;
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);   // log2 units
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;   // nothing valid yet: p = 0
      alpha[r] = exp2f(m[r] - m_use);
      neg_m[r] = -m_use;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(fmaf(sc[i], scale_log2, neg_m[r]));
      sc[i] = p;
      l[r] += p;
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // P as the A operand: k16 step kk takes n8 blocks 2 kk and 2 kk + 1
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: step kk reads keys [16 kk, 16 kk + 16), i.e. rows at 2048 kk of each
    // box; the two 64-column boxes of V lie KV_STRIP apart (leading byte offset)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      pv_product<DV>(acc, pa[kk], desc_sw128(sv + kk * 16 * ROW_BYTES, L::KV_STRIP, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty0 + 8 * s);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
#pragma unroll
  for (int jn = 0; jn < DV / 8; ++jn) {
    const int col = jn * 8 + cpair;
    if (col >= Dv) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      if (row < S) {
        __nv_bfloat162 t = __floats2bfloat162_rn(acc[4 * jn + 2 * r] * inv[r],
                                                 acc[4 * jn + 2 * r + 1] * inv[r]);
        *reinterpret_cast<__nv_bfloat162*>(o + b * osb + (long long)row * oss + h * osh + col) = t;
      }
    }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o, int B,
             int Hq, int S, int Tn, int group, int Dv, long long osb, long long oss,
             long long osh, float scale_log2, int causal) {
  using L = TcLayout<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];   // q full, K/V full[], empty[]

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = raw + ((1024 - (raw & 1023)) & 1023);   // 1024-aligned for the swizzle
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_full0 = smem_addr(&bars[1]);
  const uint32_t bar_empty0 = smem_addr(&bars[1 + STAGES]);
  const Tile tile(B, Hq, (S + BQ - 1) / BQ, Tn, causal);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full0 + 8 * s, 1);
      mbar_init(bar_empty0 + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer warp: one thread loads q once and keeps the K/V ring full
    if (lane == 0) {
      prefetch_tensormap(&qmap);
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
      const int hk = tile.h / group;
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < L::K_STRIPS; ++c)
        tma_load_4d(sq + c * L::Q_STRIP, &qmap, bar_q, c * 64, tile.h, tile.q0, tile.b);
      for (int j = 0; j < tile.n_kv; ++j) {
        const int s = j % STAGES;
        mbar_wait(bar_empty0 + 8 * s, ((j / STAGES) & 1) ^ 1);
        const uint32_t sk = sq + L::Q_BYTES + s * L::STAGE_BYTES, sv = sk + L::K_BYTES;
        const uint32_t full = bar_full0 + 8 * s;
        mbar_expect_tx(full, L::STAGE_BYTES);
        for (int c = 0; c < L::K_STRIPS; ++c) {
          tma_load_4d(sk + c * L::KV_STRIP, &kmap, full, c * 64, hk, j * BKV, tile.b);
          if (c < L::V_STRIPS)
            tma_load_4d(sv + c * L::KV_STRIP, &vmap, full, c * 64, hk, j * BKV, tile.b);
        }
      }
    }
  } else {
    consume<DK, DV>(tile, o, sq, bar_q, bar_full0, bar_empty0, S, Tn, Dv, osb, oss, osh, scale_log2,
               causal);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library; the runtime hands out
// its entry point, so the build needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (B, L, H, D) bf16 tensor with strides (sb, sl, sh) in elements, D
// contiguous, as a 4-D map ordered (D, H, L, B); one box is 64 columns of
// `rows` consecutive positions of one head.
bool encode_bshd(CUtensorMap* map, const void* ptr, long long B, long long Lr, long long H,
                 long long D, long long sb, long long sl, long long sh, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Lr, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dk, Dv: the key and value widths of the tensors, at most DK and DV
template <int DK, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* o, long long B, long long S,
              long long Tn, long long Hq, long long Hkv, long long Dk, long long Dv,
              const long long* st, float scale, int causal, cudaStream_t stream) {
  static bool ready = false;   // per instantiation
  if (!ready) {
    cudaError_t e = trims::allow_smem(flash_fwd_tc<DK, DV>, TcLayout<DK, DV>::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  CUtensorMap qm, km, vm;
  if (!encode_bshd(&qm, q, B, S, Hq, Dk, st[0], st[1], st[2], BQ) ||
      !encode_bshd(&km, k, B, Tn, Hkv, Dk, st[3], st[4], st[5], BKV) ||
      !encode_bshd(&vm, v, B, Tn, Hkv, Dv, st[6], st[7], st[8], BKV))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((S + BQ - 1) / BQ * B * Hq);   // one CTA per tile
  flash_fwd_tc<DK, DV><<<grid, TC_THREADS, TcLayout<DK, DV>::SMEM, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, (int)B, (int)Hq, (int)S, (int)Tn, (int)(Hq / Hkv), (int)Dv,
      st[9], st[10], st[11], scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: SIMT kernel (products on the fp32 FMA pipe)
// ---------------------------------------------------------------------------

constexpr int BQ32 = 64;   // q rows per block
constexpr int BK32 = 64;   // k rows per tile
constexpr int NT32 = 256;  // threads: 4 per q row

template <int DMAX>
constexpr int smem_floats() {
  return BQ32 * (DMAX + 1) + BK32 * (DMAX + 1) + BK32 * DMAX + BQ32 * (BK32 + 1);
}

// One block owns one (b, q head, 64-row q tile); each group of 4 threads owns
// one q row, computes 16 of the 64 scores of a k tile and keeps D/4 output
// accumulators. Q, K and V are staged in shared memory.
template <int DMAX>
__global__ void __launch_bounds__(NT32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S, int Tn, int group, int D,
              int Dv, long long qsb, long long qss, long long qsh, long long ksb, long long kss,
              long long ksh, long long vsb, long long vss, long long vsh, long long osb,
              long long oss, long long osh, float scale, int causal) {
  constexpr int QP = DMAX + 1;  // padded row stride: rows land on different banks
  constexpr int PP = BK32 + 1;
  constexpr int NS = BK32 / 4;  // scores per thread per tile
  constexpr int NA = DMAX / 4;  // output accumulators per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ32][QP]
  float* Ks = Qs + BQ32 * QP;    // [BK32][QP]
  float* Vs = Ks + BK32 * QP;    // [BK32][DMAX]
  float* Ps = Vs + BK32 * DMAX;  // [BQ32][PP]

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ32;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int i = tid; i < BQ32 * DMAX; i += NT32) {
    const int r = i / DMAX, d = i % DMAX;
    Qs[r * QP + d] = (q0 + r < S && d < D) ? qb[(long long)(q0 + r) * qss + d] : 0.f;
  }

  const int r = tid >> 2;   // this thread's q row within the tile
  const int cq = tid & 3;   // its quarter of the columns
  const int row = q0 + r;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int kv_end = causal ? min(Tn, q0 + BQ32) : Tn;  // skip tiles above the diagonal
  for (int k0 = 0; k0 < kv_end; k0 += BK32) {
    __syncthreads();  // everyone is done with the previous K/V tile
    for (int i = tid; i < BK32 * DMAX; i += NT32) {
      const int c = i / DMAX, d = i % DMAX;
      const bool ok = k0 + c < Tn;
      Ks[c * QP + d] = ok && d < D ? kb[(long long)(k0 + c) * kss + d] : 0.f;
      Vs[c * DMAX + d] = ok && d < Dv ? vb[(long long)(k0 + c) * vss + d] : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; ++d) {
      const float qd = Qs[r * QP + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = fmaf(qd, Ks[(cq + 4 * j) * QP + d], s[j]);
    }

    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = k0 + cq + 4 * j;
      const bool ok = col < Tn && (!causal || row >= col);
      s[j] = ok ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    // m_new == -inf: nothing valid seen yet; acc and l are still 0
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      Ps[r * PP + cq + 4 * j] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * alpha + ps;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha;
    __syncwarp();  // a row's P is written and read by the same warp

#pragma unroll 4
    for (int c = 0; c < BK32; ++c) {
      const float p = Ps[r * PP + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(p, Vs[c * DMAX + cq + 4 * i], acc[i]);
    }
  }

  if (row < S) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* ob = o + b * osb + (long long)row * oss + h * osh;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int d = cq + 4 * i;
      if (d < Dv) ob[d] = acc[i] * inv;
    }
  }
}

template <int DMAX>
int launch_f32(const void* q, const void* k, const void* v, void* o, long long B, long long S,
               long long Tn, long long Hq, long long Hkv, long long D, long long Dv,
               const long long* st, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DMAX>() * (int)sizeof(float);
  static bool ready = false;  // per instantiation
  if (!ready) {
    cudaError_t e = trims::allow_smem(flash_fwd_f32<DMAX>, bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((unsigned)((S + BQ32 - 1) / BQ32), (unsigned)Hq, (unsigned)B);
  flash_fwd_f32<DMAX><<<grid, NT32, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (int)S, (int)Tn,
      (int)(Hq / Hkv), (int)D, (int)Dv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v, o in that order; the
// head dim is contiguous. D is the width of q and k, Dv that of v and o:
// equal and at most 128, or D in (128, 192] with Dv at most 128 (latent
// attention). bf16 takes the TMA + wgmma kernel (the caller has checked
// that TMA can read q, k and v: 16-byte aligned base and strides, T > 0);
// float32 takes the SIMT kernel.
extern "C" int trims_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     long long B, long long S, long long Tn, long long Hq,
                                     long long Hkv, long long D, long long Dv,
                                     const long long* strides, float scale, int causal, int dtype,
                                     void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || Dv <= 0) return (int)cudaErrorInvalidValue;
  const bool wide = D > 128 && D <= 192 && Dv <= 128;   // latent attention's prefill
  if (!wide && (D > 128 || Dv != D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == trims::kBF16) {
    if (Tn <= 0) return (int)cudaErrorInvalidValue;
    if (wide)
      return launch_tc<192, 128>(q, k, v, o, B, S, Tn, Hq, Hkv, D, Dv, strides, scale, causal, st);
    if (D <= 64)
      return launch_tc<64, 64>(q, k, v, o, B, S, Tn, Hq, Hkv, D, Dv, strides, scale, causal, st);
    return launch_tc<128, 128>(q, k, v, o, B, S, Tn, Hq, Hkv, D, Dv, strides, scale, causal, st);
  }
  if (dtype == trims::kF32) {
    if (wide)
      return launch_f32<192>(q, k, v, o, B, S, Tn, Hq, Hkv, D, Dv, strides, scale, causal, st);
    if (D <= 32)
      return launch_f32<32>(q, k, v, o, B, S, Tn, Hq, Hkv, D, Dv, strides, scale, causal, st);
    if (D <= 64)
      return launch_f32<64>(q, k, v, o, B, S, Tn, Hq, Hkv, D, Dv, strides, scale, causal, st);
    return launch_f32<128>(q, k, v, o, B, S, Tn, Hq, Hkv, D, Dv, strides, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
