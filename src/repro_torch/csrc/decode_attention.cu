// Single-token attention against a padded KV cache, split across CTAs along
// the cache (FlashDecoding, arXiv:2311.01282).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel). Same function: one query token per
// sequence, the `group` query heads of one KV head served by each K/V row
// read, keys at or past kv_len[b] masked, and a row whose softmax sum is 0
// (kv_len == 0) written as 0. Unlike the Pallas kernel it takes a cache
// length T that is not a multiple of a tile.
//
// Bound on the H100: bytes. Every valid K/V row is read once; at the slice's
// decode shape (B = 2, a 528-long cache, 32 KV heads, D = 128, bf16) that is
// 17.3 MB, 5.2 us at 3.35 TB/s, and the products are 1 FLOP per byte at
// group 1. The first port gave one CTA to each (KV head, sequence): 64 CTAs
// for 132 SMs, each walking its keys one 64-key tile at a time with 2-byte
// loads and four block barriers per tile, so it was bound by latency.
//
// Design: one launch.
// - Grid (n_split, Hkv x head chunks, B): each CTA takes one contiguous
//   range of cache rows of one (KV head, sequence). The caller picks
//   n_split on the host from T, B, Hkv and the SM count (2-4 CTAs per SM,
//   at most 8), never from kv_len, which lives on the device.
// - Lanes read the cache with 16-byte loads, neighbouring lanes on
//   neighbouring addresses along D (16 lanes per row at D = 128 bf16), so a
//   warp covers 32 / lanes-per-row rows per load. Keys are spread over the
//   warps; each warp runs its own online softmax (exp2, scale folded into q)
//   with q of up to 8 heads of the group in registers, and keeps 4 row
//   steps in flight (8 16-byte loads per lane). No block barrier inside the
//   loop: row slots merge by shuffles and warps merge once, at the end, in
//   shared memory, into the CTA's partial (m, l, acc[D]) in fp32.
// - The n_split CTAs of one (KV head, sequence) form a thread-block
//   cluster. CTA 0 reads the other partials from their shared memory
//   (distributed shared memory), merges them and writes the output in the
//   input dtype, so no workspace and no second kernel are needed. A split
//   that starts at or past kv_len[b] holds m = -inf, l = 0 and drops out.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;        // warps per CTA
constexpr int UNROLL = 4;       // row steps per warp in flight
constexpr int MAX_SPLITS = 8;   // CTAs of one split-KV cluster: the portable cluster size

template <typename T>
struct Pack;   // 16 bytes of T as floats
template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Merge the online-softmax state (m, l, acc) of another lane into this one.
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[E], float mo, float lo,
                                      const float (&acco)[E]) {
  const float mn = fmaxf(m, mo);
  const float mu = (mn == -INFINITY) ? 0.f : mn;
  const float a = exp2f(m - mu), c = exp2f(mo - mu);
  l = l * a + lo * c;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] * a + acco[e] * c;
  m = mn;
}

// LPR lanes read one row, NV 16-byte vectors each; GC query heads per CTA.
template <typename T, int LPR, int NV, int GC>
__global__ void __launch_bounds__(WARPS * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ kv_len, T* __restrict__ o, int Tn, int group,
                    int D, int chunk, long long qsb, long long qsh, long long ksb,
                    long long kst, long long ksh, long long vsb, long long vst, long long vsh,
                    long long osb, long long osh, float scale_log2) {
  constexpr int VEC = Pack<T>::N;
  constexpr int E = NV * VEC;          // elements of a row per lane
  constexpr int RPW = 32 / LPR;        // rows per warp per step
  constexpr int DMAX = LPR * E;
  __shared__ float sm_m[WARPS][GC], sm_l[WARPS][GC];
  __shared__ float sm_acc[WARPS][GC][DMAX];   // the block's partial ends in sm_acc[0]
  __shared__ float part_m[GC], part_l[GC];

  const int split = blockIdx.x;
  const int n_chunk = (group + GC - 1) / GC;
  const int g = blockIdx.y / n_chunk;
  const int h0 = g * group + (blockIdx.y % n_chunk) * GC;   // first q head of this CTA
  const int nh = min(GC, g * group + group - h0);
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / LPR, li = lane % LPR;
  const int len = max(0, min(kv_len[b], Tn));
  const int s0 = split * chunk;
  const int s1 = min(len, s0 + chunk);   // valid rows of this split: [s0, s1)

  float qr[GC][E], acc[GC][E], m[GC], l[GC];
#pragma unroll
  for (int hh = 0; hh < GC; ++hh) {
    m[hh] = -INFINITY;
    l[hh] = 0.f;
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
      const int d0 = (vv * LPR + li) * VEC;
      const bool ok = hh < nh && d0 < D;
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        qr[hh][vv * VEC + t] =
            ok ? trims::to_f(q[b * qsb + (long long)(h0 + hh) * qsh + d0 + t]) * scale_log2 : 0.f;
        acc[hh][vv * VEC + t] = 0.f;
      }
    }
  }

  const T* kb = k + b * ksb + g * ksh;
  const T* vb = v + b * vsb + g * vsh;
  for (int r0 = s0; r0 < s1; r0 += WARPS * RPW * UNROLL) {
    uint4 kx[UNROLL][NV], vx[UNROLL][NV];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = r0 + (u * WARPS + warp) * RPW + slot;
      ok[u] = row < s1;
#pragma unroll
      for (int vv = 0; vv < NV; ++vv) {
        const int d0 = (vv * LPR + li) * VEC;
        const bool on = ok[u] && d0 < D;
        kx[u][vv] = on ? __ldg(reinterpret_cast<const uint4*>(kb + (long long)row * kst + d0))
                       : make_uint4(0, 0, 0, 0);
        vx[u][vv] = on ? __ldg(reinterpret_cast<const uint4*>(vb + (long long)row * vst + d0))
                       : make_uint4(0, 0, 0, 0);
      }
    }
    float sc[UNROLL][GC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[E];
#pragma unroll
      for (int vv = 0; vv < NV; ++vv) Pack<T>::unpack(kx[u][vv], kf + vv * VEC);
#pragma unroll
      for (int hh = 0; hh < GC; ++hh) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[hh][e], kf[e], s);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        sc[u][hh] = ok[u] ? s : -INFINITY;
      }
    }
#pragma unroll
    for (int hh = 0; hh < GC; ++hh) {
      float mx = sc[0][hh];
#pragma unroll
      for (int u = 1; u < UNROLL; ++u) mx = fmaxf(mx, sc[u][hh]);
      const float mn = fmaxf(m[hh], mx);
      const float mu = (mn == -INFINITY) ? 0.f : mn;
      const float alpha = exp2f(m[hh] - mu);
      m[hh] = mn;
      l[hh] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[hh][e] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) sc[u][hh] = exp2f(sc[u][hh] - mu);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float vf[E];
#pragma unroll
      for (int vv = 0; vv < NV; ++vv) Pack<T>::unpack(vx[u][vv], vf + vv * VEC);
#pragma unroll
      for (int hh = 0; hh < GC; ++hh) {
        const float p = sc[u][hh];
        l[hh] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[hh][e] = fmaf(p, vf[e], acc[hh][e]);
      }
    }
  }

  // merge the row slots of the warp: lanes li, li + LPR, ... hold one column range
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int hh = 0; hh < GC; ++hh) {
      float ao[E];
#pragma unroll
      for (int e = 0; e < E; ++e) ao[e] = __shfl_xor_sync(0xffffffffu, acc[hh][e], off);
      const float mo = __shfl_xor_sync(0xffffffffu, m[hh], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[hh], off);
      merge(m[hh], l[hh], acc[hh], mo, lo, ao);
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int hh = 0; hh < GC; ++hh) {
#pragma unroll
      for (int vv = 0; vv < NV; ++vv)
#pragma unroll
        for (int t = 0; t < VEC; ++t)
          sm_acc[warp][hh][(vv * LPR + li) * VEC + t] = acc[hh][vv * VEC + t];
      if (li == 0) {
        sm_m[warp][hh] = m[hh];
        sm_l[warp][hh] = l[hh];
      }
    }
  }
  __syncthreads();

  // merge the warps: this block's partial (m, l, acc[D]) for each of its heads
  for (int i = threadIdx.x; i < nh * D; i += WARPS * 32) {
    const int hh = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][hh]);
    const float mu = (mx == -INFINITY) ? 0.f : mx;
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = exp2f(sm_m[w][hh] - mu);
      lsum += sm_l[w][hh] * c;
      a += sm_acc[w][hh][d] * c;
    }
    sm_acc[0][hh][d] = a;   // only this thread reads or writes element (hh, d)
    if (d == 0) {
      part_m[hh] = mx;
      part_l[hh] = lsum;
    }
  }

  // merge the splits: the blocks of one (KV head, sequence) form a cluster;
  // block 0 reads the others' partials from their shared memory and writes
  // the output. A split past kv_len[b] holds m = -inf, l = 0 and drops out.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 0) {
    const int n_split = (int)cluster.num_blocks();
    for (int i = threadIdx.x; i < nh * D; i += WARPS * 32) {
      const int hh = i / D, d = i % D;
      float mx = -INFINITY;
      for (int r = 0; r < n_split; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(&part_m[hh], r));
      const float mu = (mx == -INFINITY) ? 0.f : mx;
      float lsum = 0.f, a = 0.f;
      for (int r = 0; r < n_split; ++r) {
        const float c = exp2f(*cluster.map_shared_rank(&part_m[hh], r) - mu);
        lsum += *cluster.map_shared_rank(&part_l[hh], r) * c;
        a += *cluster.map_shared_rank(&sm_acc[0][hh][d], r) * c;
      }
      o[b * osb + (long long)(h0 + hh) * osh + d] =
          trims::from_f<T>(lsum > 0.f ? a / lsum : 0.f);   // kv_len == 0 -> zeros
    }
  }
  cluster.sync();   // every block's shared memory stays until block 0 has read it
}

template <typename T, int LPR, int NV, int GC>
int launch_split(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                 long long B, long long Tn, long long Hq, long long Hkv, long long D,
                 const long long* st, float scale_log2, int n_split, int chunk,
                 cudaStream_t stream) {
  const int group = (int)(Hq / Hkv);
  const int n_chunk = (group + GC - 1) / GC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_split, (unsigned)(Hkv * n_chunk), (unsigned)B);
  cfg.blockDim = dim3(WARPS * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_split_kernel<T, LPR, NV, GC>, (const T*)q,
                                 (const T*)k, (const T*)v, kv_len, (T*)o, (int)Tn, group,
                                 (int)D, chunk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
                                 st[7], st[8], st[9], scale_log2);
}

template <typename T, int LPR, int NV>
int dispatch_group(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                   long long B, long long Tn, long long Hq, long long Hkv, long long D,
                   const long long* st, float scale_log2, int n_split, int chunk,
                   cudaStream_t stream) {
  const long long group = Hq / Hkv;
  if (group == 1)
    return launch_split<T, LPR, NV, 1>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, scale_log2,
                                       n_split, chunk, stream);
  if (group == 2)
    return launch_split<T, LPR, NV, 2>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, scale_log2,
                                       n_split, chunk, stream);
  if (group <= 4)
    return launch_split<T, LPR, NV, 4>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, scale_log2,
                                       n_split, chunk, stream);
  return launch_split<T, LPR, NV, 8>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, scale_log2,
                                     n_split, chunk, stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
             long long B, long long Tn, long long Hq, long long Hkv, long long D,
             const long long* st, float scale, int n_split, int chunk, cudaStream_t stream) {
  constexpr int VEC = Pack<T>::N;
  const float sl2 = scale * 1.4426950408889634f;
  const long long nvec = D / VEC;   // 16-byte vectors per row
  if (nvec <= 4)
    return dispatch_group<T, 4, 1>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, sl2, n_split,
                                   chunk, stream);
  if (nvec <= 8)
    return dispatch_group<T, 8, 1>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, sl2, n_split,
                                   chunk, stream);
  if (nvec <= 16)
    return dispatch_group<T, 16, 1>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, sl2, n_split,
                                    chunk, stream);
  if (nvec <= 32)
    return dispatch_group<T, 32, 1>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, sl2, n_split,
                                    chunk, stream);
  if constexpr (VEC == 4)   // float32 past D = 128: two vectors per lane
    return dispatch_group<T, 32, 2>(q, k, v, kv_len, o, B, Tn, Hq, Hkv, D, st, sl2, n_split,
                                    chunk, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 10 values: q (batch, head), k (batch, seq, head), v (batch, seq,
// head), o (batch, head); the head dim is contiguous. The caller has checked
// that the caches take 16-byte loads (aligned base and strides) and that D is
// a multiple of 8 up to 256, and chose n_split <= 8 and chunk with
// n_split * chunk >= T.
extern "C" int trims_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* o, long long B, long long Tn,
                                      long long Hq, long long Hkv, long long D,
                                      const long long* strides, float scale, int n_split,
                                      int chunk, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D % 8 != 0 || D > 256 || n_split <= 0 ||
      n_split > MAX_SPLITS || chunk <= 0 || (long long)n_split * chunk < Tn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* len = (const int*)kv_len;
  if (dtype == trims::kF32)
    return dispatch<float>(q, k, v, len, o, B, Tn, Hq, Hkv, D, strides, scale, n_split, chunk, st);
  if (dtype == trims::kBF16)
    return dispatch<__nv_bfloat16>(q, k, v, len, o, B, Tn, Hq, Hkv, D, strides, scale, n_split,
                                   chunk, st);
  return (int)cudaErrorInvalidValue;
}
