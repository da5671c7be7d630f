// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale, fp32 inside.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel). On the H100 it is bound by bytes at prefill rows (read
// x and scale once, write out once) and by latency at decode rows (a few
// rows: one round trip to HBM is most of the time). Tensor cores, TMA and
// wgmma have no work here, and an mbarrier round would only add latency:
// what pays is memory in flight.
//
// Design. A row is cut into 16-byte vectors ("chunks": 8 bf16 or 4 fp32
// elements of x). A power-of-two group of 32..1024 threads owns one row;
// thread `lane` holds chunks lane, lane + tpr, ... (VPT of them, at most 8),
// so a warp's load covers 512 contiguous bytes. Each thread issues all its
// loads of x (ld.global.nc, uint4) and of scale before any arithmetic, keeps
// the raw vectors in registers, reduces the sum of squares (warp shuffle,
// then one shared-memory step across the row's warps), and writes the
// scaled product from registers with 16-byte stores: x is read from HBM
// once. The host (kernels/rmsnorm.py::plan_rmsnorm) picks the threads per
// row, rows per block and VPT from the shapes, the alignment and the SM
// count; a row of more than kPayload chunks per block streams its
// remainder through a second read. Where D, the row stride or a base
// pointer forbids 16-byte access, the same kernel runs its scalar branch
// (VEC = false) with masked element loads.
#include "common.cuh"

namespace {

constexpr int kPayload = 2048;  // chunks a block holds in registers (threads x VPT)

// Element k of a chunk held as raw 32-bit words, as float (bf16: the high
// half of a float).
template <typename E>
__device__ __forceinline__ float get(const uint32_t* w, int k) {
  if constexpr (sizeof(E) == 4) return __uint_as_float(w[k]);
  else return __uint_as_float((k & 1) ? (w[k >> 1] & 0xffff0000u) : (w[k >> 1] << 16));
}

template <typename E>
__device__ __forceinline__ void put(uint32_t* w, int k, float f) {
  if constexpr (sizeof(E) == 4) {
    w[k] = __float_as_uint(f);
  } else {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(f));
    w[k >> 1] = (k & 1) ? ((w[k >> 1] & 0xffffu) | (b << 16)) : ((w[k >> 1] & 0xffff0000u) | b);
  }
}

// Load N elements of E at p into w: 8- or 16-byte non-coherent vector loads
// (VEC), or element by element for the first n of them (zeros past n).
template <typename E, int N, bool VEC>
__device__ __forceinline__ void load(uint32_t* w, const E* p, int n) {
  constexpr int kBytes = N * (int)sizeof(E);
  if constexpr (VEC && kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
    }
  } else if constexpr (VEC) {  // 8 bytes: the bf16 scale of an fp32 chunk
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x; w[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) w[i] = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= n) break;
      if constexpr (sizeof(E) == 4)
        w[k] = __ldg(reinterpret_cast<const unsigned int*>(p) + k);
      else
        w[k >> 1] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p) + k)
                     << (16 * (k & 1));
    }
  }
}

template <typename E, int N, bool VEC>
__device__ __forceinline__ void store(E* p, const uint32_t* w, int n) {
  if constexpr (VEC) {  // a chunk of out is 16 bytes
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= n) break;
      if constexpr (sizeof(E) == 4)
        reinterpret_cast<unsigned int*>(p)[k] = w[k];
      else
        reinterpret_cast<unsigned short*>(p)[k] = (unsigned short)(w[k >> 1] >> (16 * (k & 1)));
    }
  }
}

template <typename T, typename S, int VPT, bool VEC>
__global__ void __launch_bounds__(kPayload / VPT < 1024 ? kPayload / VPT : 1024, 1)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               long long rows, int D, long long x_stride, long long o_stride, float eps,
               int tpr) {
  constexpr int V = 16 / (int)sizeof(T);          // elements in a chunk
  constexpr int XW = 4, SW = V * (int)sizeof(S) / 4;  // 32-bit words of a chunk
  __shared__ float red[32];
  const int lane = threadIdx.x & (tpr - 1);
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const int chunks = (D + V - 1) / V;
  const T* xr = x + (live ? row : 0) * x_stride;
  T* orow = out + (live ? row : 0) * o_stride;

  // 1. every load of x, then of scale, before any arithmetic
  uint32_t xv[VPT][XW], sv[VPT][SW];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = j * tpr + lane;
    if (live && c < chunks) load<T, V, VEC>(xv[j], xr + c * V, D - c * V);
    else for (int i = 0; i < XW; ++i) xv[j][i] = 0;
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = j * tpr + lane;
    if (live && c < chunks) load<S, V, VEC>(sv[j], scale + c * V, D - c * V);
  }
  // 2. the sum of squares in fp32 (rows longer than the payload stream the rest)
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = get<T>(xv[j], k);
      ss = fmaf(v, v, ss);
    }
  for (int c = VPT * tpr + lane; live && c < chunks; c += tpr) {
    uint32_t w[XW];
    load<T, V, VEC>(w, xr + c * V, D - c * V);
#pragma unroll
    for (int k = 0; k < V; ++k) ss = fmaf(get<T>(w, k), get<T>(w, k), ss);
  }
  // 3. reduce over the row's threads: shuffles, then its warps through shared memory
  ss = trims::warp_sum(ss);
  if (tpr > 32) {                                 // uniform over the block
    const int warp = threadIdx.x >> 5, nw = tpr >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = ss;
    __syncthreads();
    const int first = warp & ~(nw - 1);
    ss = 0.f;
    for (int i = 0; i < nw; ++i) ss += red[first + i];
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)D + eps);
  // 4. the scaled product from registers, 16-byte stores
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = j * tpr + lane;
    if (c >= chunks) break;
    uint32_t o[XW] = {};
#pragma unroll
    for (int k = 0; k < V; ++k) put<T>(o, k, get<T>(xv[j], k) * r * get<S>(sv[j], k));
    store<T, V, VEC>(orow + c * V, o, D - c * V);
  }
  for (int c = VPT * tpr + lane; c < chunks; c += tpr) {
    uint32_t w[XW], s[SW], o[XW] = {};
    load<T, V, VEC>(w, xr + c * V, D - c * V);
    load<S, V, VEC>(s, scale + c * V, D - c * V);
#pragma unroll
    for (int k = 0; k < V; ++k) put<T>(o, k, get<T>(w, k) * r * get<S>(s, k));
    store<T, V, VEC>(orow + c * V, o, D - c * V);
  }
}

template <typename T, typename S, bool VEC>
int launch_vpt(const void* x, const void* scale, void* out, long long rows, long long D,
               long long x_stride, long long o_stride, float eps, int tpr, int rpb, int vpt,
               cudaStream_t st) {
  const long long grid = (rows + rpb - 1) / rpb;
  const int threads = tpr * rpb;
  if (grid > 0x7fffffffLL || threads * vpt > kPayload) return (int)cudaErrorInvalidValue;
#define TRIMS_RMSNORM(N)                                                                  \
  rmsnorm_kernel<T, S, N, VEC><<<(unsigned)grid, threads, 0, st>>>(                        \
      (const T*)x, (const S*)scale, (T*)out, rows, (int)D, x_stride, o_stride, eps, tpr)
  switch (vpt) {
    case 1: TRIMS_RMSNORM(1); break;
    case 2: TRIMS_RMSNORM(2); break;
    case 4: TRIMS_RMSNORM(4); break;
    case 8: TRIMS_RMSNORM(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TRIMS_RMSNORM
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows, long long D,
           long long x_stride, long long o_stride, float eps, int tpr, int rpb, int vpt,
           int vec, cudaStream_t st) {
  if (vec) {
    // the 16-byte branch needs every chunk of every row on a 16-byte boundary
    constexpr int V = 16 / (int)sizeof(T);
    const uintptr_t a = (uintptr_t)x | (uintptr_t)scale | (uintptr_t)out;
    if (a % 16 || D % V || x_stride % V || o_stride % V) return (int)cudaErrorInvalidValue;
    return launch_vpt<T, S, true>(x, scale, out, rows, D, x_stride, o_stride, eps, tpr, rpb,
                                  vpt, st);
  }
  return launch_vpt<T, S, false>(x, scale, out, rows, D, x_stride, o_stride, eps, tpr, rpb,
                                 vpt, st);
}

}  // namespace

// out is contiguous (rows of D). vec, tpr, rpb and vpt are the launch that
// kernels/rmsnorm.py::plan_rmsnorm chose: the 16-byte branch, threads per
// row (a power of two, 32..1024), rows per block and chunks a thread holds
// (1, 2, 4 or 8).
extern "C" int trims_rmsnorm(const void* x, const void* scale, void* out, long long rows,
                             long long D, long long x_stride, float eps, int x_dtype,
                             int s_dtype, int vec, int tpr, int rpb, int vpt, void* stream) {
  using trims::kBF16;
  using trims::kF32;
  if (rows <= 0) return 0;
  if (tpr < 32 || tpr > 1024 || (tpr & (tpr - 1)) || rpb < 1 || tpr * rpb > 1024 ||
      D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == kF32 && s_dtype == kF32)
    return launch<float, float>(x, scale, out, rows, D, x_stride, D, eps, tpr, rpb, vpt, vec,
                                st);
  if (x_dtype == kBF16 && s_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, x_stride, D, eps, tpr,
                                                rpb, vpt, vec, st);
  if (x_dtype == kBF16 && s_dtype == kF32)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, D, x_stride, D, eps, tpr, rpb,
                                        vpt, vec, st);
  if (x_dtype == kF32 && s_dtype == kBF16)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, D, x_stride, D, eps, tpr, rpb,
                                        vpt, vec, st);
  return (int)cudaErrorInvalidValue;
}
