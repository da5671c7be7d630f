// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale, fp32 inside.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel). Bound on the H100 by bytes: each row is read once for
// the sum of squares and once more (from L1/L2) for the scaled write. One
// warp owns one row, so the reduction is a register shuffle with no shared
// memory or block barrier, and any row count works without padding copies.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block

template <typename T, typename S>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
               long long rows, int D, long long x_stride, long long o_stride, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * x_stride;
  T* orow = out + row * o_stride;
  float ss = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float v = trims::to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = trims::warp_sum(ss);
  const float r = rsqrtf(ss / (float)D + eps);
  for (int i = lane; i < D; i += 32)
    orow[i] = trims::from_f<T>(trims::to_f(xr[i]) * r * trims::to_f(scale[i]));
}

template <typename T, typename S>
void launch(const void* x, const void* scale, void* out, long long rows, long long D,
            long long x_stride, long long o_stride, float eps, cudaStream_t st) {
  const unsigned grid = (unsigned)((rows + kWarps - 1) / kWarps);
  rmsnorm_kernel<T, S><<<grid, kWarps * 32, 0, st>>>(
      (const T*)x, (const S*)scale, (T*)out, rows, (int)D, x_stride, o_stride, eps);
}

}  // namespace

extern "C" int trims_rmsnorm(const void* x, const void* scale, void* out, long long rows,
                             long long D, long long x_stride, long long o_stride, float eps,
                             int x_dtype, int s_dtype, void* stream) {
  using trims::kBF16;
  using trims::kF32;
  if (rows <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == kF32 && s_dtype == kF32)
    launch<float, float>(x, scale, out, rows, D, x_stride, o_stride, eps, st);
  else if (x_dtype == kBF16 && s_dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, D, x_stride, o_stride, eps, st);
  else if (x_dtype == kBF16 && s_dtype == kF32)
    launch<__nv_bfloat16, float>(x, scale, out, rows, D, x_stride, o_stride, eps, st);
  else if (x_dtype == kF32 && s_dtype == kBF16)
    launch<float, __nv_bfloat16>(x, scale, out, rows, D, x_stride, o_stride, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
