// KS-P: the somatic SNV joint posterior, on Hopper (sm_90a).
//
// Replaces strelka_tpu/models/somatic_snv.py:250 somatic_snv_call, a jitted
// XLA program (no Pallas), whose plain version in the port is
// models/somatic_snv.somatic_snv_call_plain: it materialises the [L, 3, 2,
// 21, 21] f32 sums, their float64 copy and a power-of-two padded tree sum,
// about 96 KB a row. This kernel gives that version's bits in one launch
// and keeps a row's 441 terms on the chip. Per row of the normal and tumour
// lhoods [L, 30] f32 (nl, tl: their first 21 states):
//
//   lse[g] = f32(logsumexp64((pf[g] + nl[fn]) + tl[ft])) over the 441
//            (fn, ft) of each (ngt, somatic) group g, for 6 groups; the
//            max replaced by 0 where it is not finite, the exps summed by
//            the zero-padded halving tree s[i] += s[i + h], h = 256 .. 1
//   log_post = lse + gp; p = exp(log_post - max) / sequential sum (float64)
//   nonsom, the error of each normal genotype, its first argmin and min,
//   the phreds of both, the first argmax of log_post, the strand bias
//   (max strand state - max het state of the tumour, clamped at 0), and
//   the nonsomatic phred: a 21-wide logsumexp of (nl + tl) + eq (tree of
//   32, rounded to f32) against the 441-wide float64 off-diagonal one.
//
// Bound on the H100: it reads 240 bytes and writes 24 a row, against some
// 3,100 float64 exps and 3,600 adds a row; on the FP64 units (34 TFLOP/s
// on the H100 SXM, each exp counted as one operation) the operations bound
// it, not the bytes.
//
// Design: one warp a row, eight rows a block, no block barrier. Lane l
// holds the terms i = l + 32 m, m = 0..15, of a group in registers. The
// halving tree's first four steps (h = 256, 128, 64, 32) then pair terms
// of the same lane (m with m + 8, 4, 2, 1) and its last five (h = 16 .. 1)
// are __shfl_down_sync steps, so the sum is the plain version's tree, term
// for term. The maxima are butterflies (order-free). Lane 0 runs the
// 6-wide float64 tail.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "snv_math.cuh"

namespace {

constexpr int kF = 21;             // PRESTRAND_SIZE
constexpr int kGrid = 30;          // GRID_SIZE
constexpr int kN = kF * kF;        // terms of a group
constexpr int kGroups = 6;         // (ngt, somatic)
constexpr int kPer = 16;           // terms a lane: 512 / 32
constexpr int kWarps = 8;
constexpr unsigned kAll = 0xffffffffu;
constexpr double kLog10E = 0.4342944819032518;   // jnp.log10's constant

// logsumexp64 over the n terms lane + 32 m < n of v (M of them a lane),
// zero-padded to 32 M, as the plain version's _logsumexp64 runs it; every
// lane returns the result
template <int M>
__device__ double warp_logsumexp(const double (&v)[M], int lane, int n) {
    double mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < M; ++m)
        if (lane + 32 * m < n) mx = snv::nan_max(mx, v[m]);
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
        mx = snv::nan_max(mx, __shfl_xor_sync(kAll, mx, off));
    const double t = snv::is_finite(mx) ? mx : 0.0;
    double e[M];
#pragma unroll
    for (int m = 0; m < M; ++m)
        e[m] = lane + 32 * m < n ? exp(__dsub_rn(v[m], t)) : 0.0;
#pragma unroll
    for (int h = M / 2; h >= 1; h /= 2)
#pragma unroll
        for (int m = 0; m < h; ++m) e[m] = __dadd_rn(e[m], e[m + h]);
    double s = e[0];
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
        s = __dadd_rn(s, __shfl_down_sync(kAll, s, off));
    s = __shfl_sync(kAll, s, 0);
    return __dadd_rn(log(fabs(s)), t);
}

// min(floor(-10 log10(max(x, tiny)) + 0.5), 999) with log10 = log * 1/ln 10,
// as int32 with NaN as 0
__device__ __forceinline__ int phred64(double x) {
    const double lg = __dmul_rn(log(snv::clamp_min(x, snv::kF64Tiny)),
                                kLog10E);
    return snv::to_i32(snv::clamp_max(
        floor(__dadd_rn(__dmul_rn(-10.0, lg), 0.5)), 999.0));
}

struct Out {
    int* qphred;
    int* from_ntype_qphred;
    int* ntype;
    int* max_gt;
    float* strand_bias;
    int* nonsomatic_qphred;
};

__global__ void __launch_bounds__(kWarps * 32)
somatic_posterior_kernel(const float* __restrict__ normal,
                         const float* __restrict__ tumor,
                         const float* __restrict__ pf,
                         const float* __restrict__ gp,
                         const float* __restrict__ eq,
                         const double* __restrict__ off, long long L,
                         Out o) {
    __shared__ float nl_s[kWarps][kF], tl_s[kWarps][kF];
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
    if (row >= L) return;    // the whole warp: no block barrier follows
    const float* trow = tumor + row * kGrid;
    if (lane < kF) {
        nl_s[w][lane] = normal[row * kGrid + lane];
        tl_s[w][lane] = trow[lane];
    }
    __syncwarp();
    const float* nl = nl_s[w];
    const float* tl = tl_s[w];

    double v[kPer];
    float lse[kGroups];
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
            const int i = lane + 32 * m;
            v[m] = i < kN
                ? static_cast<double>(__fadd_rn(
                      __fadd_rn(pf[g * kN + i], nl[i / kF]), tl[i % kF]))
                : 0.0;
        }
        lse[g] = __double2float_rn(warp_logsumexp(v, lane, kN));
    }
    // the nonsomatic phred's off-diagonal terms: float64 (nl + tl) + off,
    // -inf on the diagonal
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
        const int i = lane + 32 * m, fn = i / kF, ft = i % kF;
        v[m] = i >= kN ? 0.0
             : fn == ft ? -INFINITY
             : __dadd_rn(static_cast<double>(__fadd_rn(nl[fn], tl[ft])),
                         off[i]);
    }
    const double lse_off = warp_logsumexp(v, lane, kN);
    double dv[1] = {lane < kF ? static_cast<double>(__fadd_rn(
                                    __fadd_rn(nl[lane], tl[lane]), eq[lane]))
                              : 0.0};
    const double lse_diag = static_cast<double>(
        __double2float_rn(warp_logsumexp(dv, lane, kF)));
    if (lane != 0) return;

    float log_post[kGroups];
    double p[kGroups];
    double mx = -INFINITY;
    for (int g = 0; g < kGroups; ++g) {
        log_post[g] = __fadd_rn(lse[g], gp[g]);
        mx = snv::nan_max(mx, static_cast<double>(log_post[g]));
    }
    for (int g = 0; g < kGroups; ++g)
        p[g] = exp(__dsub_rn(static_cast<double>(log_post[g]), mx));
    double s = p[0];
    for (int g = 1; g < kGroups; ++g) s = __dadd_rn(s, p[g]);
    for (int g = 0; g < kGroups; ++g) p[g] = p[g] / s;
    // p[2 n + somatic]
    const double nonsom = __dadd_rn(__dadd_rn(p[0], p[2]), p[4]);
    const double total_som = __dadd_rn(__dadd_rn(p[1], p[3]), p[5]);
    double err[3];
    double min_err = 0.0;
    for (int n = 0; n < 3; ++n) {
        err[n] = __dadd_rn(nonsom, __dsub_rn(total_som, p[2 * n + 1]));
        min_err = n == 0 ? err[0] : snv::nan_min(min_err, err[n]);
    }
    float symm = -INFINITY, strand = -INFINITY;
    for (int f = 3; f < kF; ++f) symm = snv::nan_max(symm, trow[f]);
    for (int f = kF; f < kGrid; ++f) strand = snv::nan_max(strand, trow[f]);
    const double denom = snv::logaddexp(lse_diag, lse_off);
    const double frac = exp(__dsub_rn(lse_diag, denom));

    o.qphred[row] = phred64(nonsom);
    o.from_ntype_qphred[row] = phred64(min_err);
    o.ntype[row] = snv::arg_min(err, 3);
    o.max_gt[row] = snv::arg_max(log_post, kGroups);
    o.strand_bias[row] = snv::clamp_min(__fsub_rn(strand, symm), 0.0f);
    o.nonsomatic_qphred[row] = phred64(__dsub_rn(1.0, frac));
}

}  // namespace

extern "C" {

// normal, tumor [L, 30] f32; joint_pf [3, 2, 21, 21] f32, joint_gp [3, 2]
// f32, eq [21] f32 (0 on the valid tumour states, else -inf), off [21, 21]
// float64 (the off-diagonal prior); all contiguous on one device, L >= 1.
// Out: qphred, from_ntype_qphred, ntype, max_gt [L] int32, strand_bias [L]
// f32, nonsomatic_qphred [L] int32. Launches on `stream`; returns
// cudaGetLastError().
int somatic_posterior_launch(const void* normal, const void* tumor,
                             const void* joint_pf, const void* joint_gp,
                             const void* eq, const void* off, long long L,
                             void* qphred, void* from_ntype_qphred,
                             void* ntype, void* max_gt, void* strand_bias,
                             void* nonsomatic_qphred, void* stream) {
    const Out o{static_cast<int*>(qphred),
                static_cast<int*>(from_ntype_qphred),
                static_cast<int*>(ntype), static_cast<int*>(max_gt),
                static_cast<float*>(strand_bias),
                static_cast<int*>(nonsomatic_qphred)};
    const long long blocks = (L + kWarps - 1) / kWarps;
    somatic_posterior_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(normal), static_cast<const float*>(tumor),
        static_cast<const float*>(joint_pf),
        static_cast<const float*>(joint_gp), static_cast<const float*>(eq),
        static_cast<const double*>(off), L, o);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
