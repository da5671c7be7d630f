// Attention forward with online softmax (FlashAttention, arXiv:2205.14135).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (_fwd_kernel). Same function: fp32 running max / sum /
// accumulator, scale 1/sqrt(D), GQA through h / group, a top-left aligned
// causal mask (row >= col), k tiles above the diagonal skipped, and rows
// whose softmax sum is 0 written as 0. Unlike the Pallas kernel it masks
// ragged S and T instead of asserting on them.
//
// Design. The TPU kernel carries (m, l, acc) across a sequential grid axis;
// here one block owns one (b, q-head, 64-row q tile) and loops over the k
// tiles itself, so nothing crosses blocks. q/k/v are read by strides from the
// model's (B, S, H, D) layout (no transpose copies) and converted to fp32 in
// shared memory. Each group of 4 threads owns one q row: it computes 16 of
// the 64 scores of a k tile, reduces max and sum with two shuffles, and keeps
// D/4 output accumulators in registers. Products are plain fp32 FMAs.
//
// Bound on the H100. At the slice's prefill shape (2, 32, 512, 128) bf16 the
// bytes moved (q, k, v, o once) take ~10 us at 3.35 TB/s and the causal
// FLOPs ~4 us at the bf16 tensor-core peak, so a tensor-core kernel would be
// memory-bound. This one does its FLOPs on the fp32 FMA pipe (67 TFLOP/s),
// which makes it compute-bound; moving QK^T and PV to wgmma is the redesign.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // k rows per tile
constexpr int NT = 256;  // threads: 4 per q row

template <int DMAX>
constexpr int smem_floats() {
  return BQ * (DMAX + 1) + BK * (DMAX + 1) + BK * DMAX + BQ * (BK + 1);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int Tn, int group, int D,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh,
                 float scale, int causal) {
  constexpr int QP = DMAX + 1;  // padded row stride: rows land on different banks
  constexpr int PP = BK + 1;
  constexpr int NS = BK / 4;    // scores per thread per tile
  constexpr int NA = DMAX / 4;  // output accumulators per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][QP]
  float* Ks = Qs + BQ * QP;     // [BK][QP]
  float* Vs = Ks + BK * QP;     // [BK][DMAX]
  float* Ps = Vs + BK * DMAX;   // [BQ][PP]

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;

  for (int i = tid; i < BQ * DMAX; i += NT) {
    const int r = i / DMAX, d = i % DMAX;
    float val = 0.f;
    if (q0 + r < S && d < D) val = trims::to_f(qb[(long long)(q0 + r) * qss + d]);
    Qs[r * QP + d] = val;
  }

  const int r = tid >> 2;   // this thread's q row within the tile
  const int cq = tid & 3;   // its quarter of the columns
  const int row = q0 + r;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int kv_end = causal ? min(Tn, q0 + BQ) : Tn;  // skip tiles above the diagonal
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // everyone is done with the previous K/V tile
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int c = i / DMAX, d = i % DMAX;
      float kv = 0.f, vv = 0.f;
      if (k0 + c < Tn && d < D) {
        kv = trims::to_f(kb[(long long)(k0 + c) * kss + d]);
        vv = trims::to_f(vb[(long long)(k0 + c) * vss + d]);
      }
      Ks[c * QP + d] = kv;
      Vs[c * DMAX + d] = vv;
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
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * PP + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(p, Vs[c * DMAX + cq + 4 * i], acc[i]);
    }
  }

  if (row < S) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* ob = o + b * osb + (long long)row * oss + h * osh;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int d = cq + 4 * i;
      if (d < D) ob[d] = trims::from_f<T>(acc[i] * inv);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, long long B, long long S,
           long long Tn, long long Hq, long long Hkv, long long D, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DMAX>() * (int)sizeof(float);
  static bool ready = false;  // per instantiation
  if (!ready) {
    cudaError_t e = trims::allow_smem(flash_fwd_kernel<T, DMAX>, bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)Hq, (unsigned)B);
  flash_fwd_kernel<T, DMAX><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)S, (int)Tn, (int)(Hq / Hkv), (int)D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, long long B, long long S,
               long long Tn, long long Hq, long long Hkv, long long D, const long long* st,
               float scale, int causal, cudaStream_t stream) {
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, S, Tn, Hq, Hkv, D, st, scale, causal, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, S, Tn, Hq, Hkv, D, st, scale, causal, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, B, S, Tn, Hq, Hkv, D, st, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v, o in that order; the
// head dim is contiguous.
extern "C" int trims_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     long long B, long long S, long long Tn, long long Hq,
                                     long long Hkv, long long D, const long long* strides,
                                     float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == trims::kF32)
    return dispatch_d<float>(q, k, v, o, B, S, Tn, Hq, Hkv, D, strides, scale, causal, st);
  if (dtype == trims::kBF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, Tn, Hq, Hkv, D, strides, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
