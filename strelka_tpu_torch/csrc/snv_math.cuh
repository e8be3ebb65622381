// Helpers of the SNV model kernels (snv_hist_tile.cu, somatic_grid.cu,
// somatic_posterior.cu): the elementwise semantics of the torch ops that
// their plain versions run, so that a kernel gives the plain version's
// bits on the card, and the size of a grid of resident blocks.
//
// - Every product that meets a sum is written __fmul_rn/__dmul_rn (and
//   every intended fused multiply-add __fmaf_rn): nvcc contracts a*b + c
//   into one FMA under its default -fmad=true, and the plain versions
//   round the product and the sum apart. The sources keep nvcc's default
//   flags, so exp, log, log1p and log10 come from the same CUDA math
//   library, built the same way, as torch's own CUDA kernels.
// - Divisions are true divisions (`/` on doubles), never a multiply by a
//   reciprocal.
// - amax/amin and argmax/argmin follow torch's reductions: a NaN wins
//   (the first NaN for the arg forms), else the first extreme index.
// - clamp keeps a NaN, as torch's clamp does, and a float-to-int32 cast
//   takes NaN to 0, as XLA's convert does (the plain versions map NaN to 0
//   before their casts).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace snv {

// Blocks of `threads` for a grid over `want` blocks' work: as many as the
// card holds at once where that is fewer (kernel's blocks walk the rest),
// with `dyn` bytes of dynamic shared memory a block (allowed past 48 KB
// before the call). Kept per kernel, device and byte count after its
// first query (kernels of one signature share this function's table), so
// that no query falls inside a graph capture of a launch made before.
template <typename Kernel>
long long resident_blocks(Kernel kernel, int threads, long long want,
                          size_t dyn = 0) {
    struct Cap {
        const void* fn;
        int dev;
        size_t dyn;
        long long cap;
    };
    static Cap caps[64];
    static int n = 0;
    const void* fn = reinterpret_cast<const void*>(kernel);
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return want;
    long long cap = 0;
    for (int i = 0; i < n && !cap; ++i)
        if (caps[i].fn == fn && caps[i].dev == dev && caps[i].dyn == dyn)
            cap = caps[i].cap;
    if (!cap) {
        int sms = 0, per_sm = 0;
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
                != cudaSuccess
            || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                             threads, dyn)
                != cudaSuccess
            || per_sm < 1)
            return want;
        cap = static_cast<long long>(sms) * per_sm;
        if (n < 64) caps[n++] = Cap{fn, dev, dyn, cap};
    }
    return want < cap ? want : cap;
}

constexpr double kF64Tiny = 2.2250738585072014e-308;   // finfo(f64).tiny

// NaN and finiteness tests that need no overload resolution (no fast math
// here, so x != x holds for a NaN alone)
template <typename T>
__device__ __forceinline__ bool is_nan(T x) { return x != x; }
__device__ __forceinline__ bool is_finite(double x) {
    return fabs(x) < INFINITY;
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
    return is_nan(a) ? a : (is_nan(b) ? b : (b > a ? b : a));
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
    return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
}

// torch.argmax over v[0..n): the first NaN, else the first maximum
template <typename T>
__device__ __forceinline__ int arg_max(const T* v, int n) {
    int best = 0;
    for (int i = 1; i < n; ++i) {
        if (is_nan(v[best])) break;
        if (is_nan(v[i]) || v[i] > v[best]) best = i;
    }
    return best;
}

// torch.argmin over v[0..n): the first NaN, else the first minimum
template <typename T>
__device__ __forceinline__ int arg_min(const T* v, int n) {
    int best = 0;
    for (int i = 1; i < n; ++i) {
        if (is_nan(v[best])) break;
        if (is_nan(v[i]) || v[i] < v[best]) best = i;
    }
    return best;
}

// torch.clamp_min / clamp_max / clamp with a NaN kept
__device__ __forceinline__ double clamp_min(double v, double lo) {
    return is_nan(v) ? v : fmax(v, lo);
}
__device__ __forceinline__ double clamp_max(double v, double hi) {
    return is_nan(v) ? v : fmin(v, hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return is_nan(v) ? v : fmaxf(v, lo);
}

// float -> int32 with NaN as 0 (v is integral and inside int32 otherwise)
__device__ __forceinline__ int to_i32(double v) {
    return is_nan(v) ? 0 : static_cast<int>(v);
}

// jnp.logaddexp in float64: max + log1p(exp(-|a-b|)), a + b where a - b is
// NaN (both -inf)
__device__ __forceinline__ double logaddexp(double a, double b) {
    const double d = a - b;
    if (is_nan(d)) return a + b;
    return nan_max(a, b) + log1p(exp(-fabs(d)));
}

}  // namespace snv
