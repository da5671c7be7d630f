// Single-token attention against a padded KV cache (FlashDecoding family,
// arXiv:2311.01282).
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel). Same function: one query token per
// sequence, the `group` query heads of one KV head processed together, keys
// at or past kv_len[b] masked, tiles past kv_len skipped, and a row whose
// softmax sum is 0 (kv_len == 0) written as 0. Unlike the Pallas kernel it
// takes a cache length T that is not a multiple of the tile.
//
// Design. One block owns one (KV head, sequence) pair and walks the cache up
// to kv_len[b] in 64-key tiles, so the sequential k axis of the TPU grid
// becomes a loop and (m, l, acc) live in shared memory for the whole walk.
// The cache is read by strides in the model's (B, T, Hkv, D) layout, which
// removes the per-step transpose copies of the JAX wrapper.
//
// Bound on the H100: bytes. Every valid K/V row is read once; at the slice's
// decode shape (B=2, 528-long cache, 32 KV heads, D=128, bf16) that is
// 17.3 MB, ~5 us at 3.35 TB/s. With B * Hkv = 64 blocks for 132 SMs and one
// tile in flight per block this kernel cannot reach that rate; splitting the
// cache across blocks (split-KV) is the redesign.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int DBK = 64;   // keys per tile
constexpr int DNT = 128;  // threads per block

__host__ __device__ inline int smem_floats(int group, int D) {
  return group * D            // q rows
         + DBK * (D + 1)      // K tile (padded)
         + DBK * D            // V tile
         + group * DBK        // scores / probabilities
         + group * D          // output accumulators
         + 3 * group;         // running max, running sum, rescale factor
}

template <typename T>
__global__ void __launch_bounds__(DNT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ kv_len, T* __restrict__ o, int Tn, int group, int D,
              long long qsb, long long qsh, long long ksb, long long kst, long long ksh,
              long long vsb, long long vst, long long vsh, long long osb, long long osh,
              float scale) {
  extern __shared__ float sm[];
  const int DP = D + 1;
  float* Qs = sm;                    // [group][D]
  float* Ks = Qs + group * D;        // [DBK][DP]
  float* Vs = Ks + DBK * DP;         // [DBK][D]
  float* Ss = Vs + DBK * D;          // [group][DBK]
  float* Acc = Ss + group * DBK;     // [group][D]
  float* Ms = Acc + group * D;       // [group]
  float* Ls = Ms + group;            // [group]
  float* Al = Ls + group;            // [group]

  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(kv_len[b], Tn));
  const int h0 = g * group;  // first query head of this KV head

  for (int i = tid; i < group * D; i += DNT) {
    const int gi = i / D, d = i % D;
    Qs[i] = trims::to_f(q[b * qsb + (long long)(h0 + gi) * qsh + d]);
    Acc[i] = 0.f;
  }
  for (int i = tid; i < group; i += DNT) {
    Ms[i] = -INFINITY;
    Ls[i] = 0.f;
  }
  const T* kb = k + b * ksb + g * ksh;
  const T* vb = v + b * vsb + g * vsh;

  for (int k0 = 0; k0 < len; k0 += DBK) {
    __syncthreads();
    for (int i = tid; i < DBK * D; i += DNT) {
      const int c = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < len) {
        kv = trims::to_f(kb[(long long)(k0 + c) * kst + d]);
        vv = trims::to_f(vb[(long long)(k0 + c) * vst + d]);
      }
      Ks[c * DP + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < group * DBK; i += DNT) {
      const int gi = i / DBK, c = i % DBK;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[gi * D + d], Ks[c * DP + d], s);
      Ss[i] = (k0 + c < len) ? s * scale : -INFINITY;
    }
    __syncthreads();
    for (int gi = warp; gi < group; gi += DNT / 32) {
      float* row = Ss + gi * DBK;
      const float mx = trims::warp_max(fmaxf(row[lane], row[lane + 32]));
      const float m_old = Ms[gi];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m_old - m_new);
      const float s0 = row[lane], s1 = row[lane + 32];
      const float p0 = (s0 == -INFINITY) ? 0.f : expf(s0 - m_new);
      const float p1 = (s1 == -INFINITY) ? 0.f : expf(s1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float ps = trims::warp_sum(p0 + p1);
      if (lane == 0) {
        Ls[gi] = Ls[gi] * alpha + ps;
        Ms[gi] = m_new;
        Al[gi] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < group * D; i += DNT) {
      const int gi = i / D, d = i % D;
      const float* p = Ss + gi * DBK;
      float a = Acc[i] * Al[gi];
      for (int c = 0; c < DBK; ++c) a = fmaf(p[c], Vs[c * D + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += DNT) {
    const int gi = i / D, d = i % D;
    const float l = Ls[gi];
    o[b * osb + (long long)(h0 + gi) * osh + d] = trims::from_f<T>(l > 0.f ? Acc[i] / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* o, long long B,
           long long Tn, long long Hq, long long Hkv, long long D, const long long* st,
           float scale, cudaStream_t stream) {
  const int group = (int)(Hq / Hkv);
  const int bytes = smem_floats(group, (int)D) * (int)sizeof(float);
  static int allowed = 48 * 1024;  // per instantiation
  if (bytes > allowed) {
    cudaError_t e = trims::allow_smem(decode_kernel<T>, bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  dim3 grid((unsigned)Hkv, (unsigned)B);
  decode_kernel<T><<<grid, DNT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, (int)Tn, group, (int)D, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long trims_decode_smem_bytes(long long group, long long D) {
  return (long long)smem_floats((int)group, (int)D) * (long long)sizeof(float);
}

// strides: 10 values: q (batch, head), k (batch, seq, head), v (batch, seq,
// head), o (batch, head); the head dim is contiguous.
extern "C" int trims_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* o, long long B, long long Tn,
                                      long long Hq, long long Hkv, long long D,
                                      const long long* strides, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* len = (const int*)kv_len;
  if (dtype == trims::kF32)
    return launch<float>(q, k, v, len, o, B, Tn, Hq, Hkv, D, strides, scale, st);
  if (dtype == trims::kBF16)
    return launch<__nv_bfloat16>(q, k, v, len, o, B, Tn, Hq, Hkv, D, strides, scale, st);
  return (int)cudaErrorInvalidValue;
}
