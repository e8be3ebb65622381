// KS-G: the somatic SNV frequency-grid lhoods of one sample's pileup tile,
// on Hopper (sm_90a).
//
// Replaces strelka_tpu/models/somatic_snv.py:102 freq_grid_lhoods, a jitted
// XLA program (no Pallas), whose plain version in the port is
// models/somatic_snv.freq_grid_lhoods_plain: a scatter-add histogram, then
// 2 + 8 [L, 128] x [128, F] products summed in the XLA CPU dot's order with
// each FMA emulated exactly, a read-back of the live slots to the host and
// hundreds of launches a tile. This kernel gives that version's bits in one
// launch. Per row of base/qual/mask/is_fwd [L, D] and ref_gt [L]:
//
//   hist[q * 4 + (is_alt << 1 | is_fwd)] += 1 over the masked lanes
//     (q = clamp(qual, 0, 127), is_alt = base != ref_gt)
//   dot(h, tab)[f] = (a0 + a1) + (a2 + a3), a_j = fma(h[k], tab[k, f], a_j)
//     over k = j (mod 4), k ascending (a zero count adds exactly nothing:
//     the tables are finite, so no list of live slots is needed)
//   grid states f < 21: dot(h_ref, ref_m) + dot(h_alt, alt_m)
//   strand states s < 9: fwd = ((on_ref(ref_fwd) + on_alt(alt_fwd))
//     + off_ref(ref_rev)) + off_alt(alt_rev), rev the same with the strands
//     swapped, then f32(logaddexp(f64 fwd, f64 rev)) + f32 ln 0.5
//
// with the q = 0 -inf entries re-applied exactly (ln(1 - e) = ln 0).
//
// Bound on the H100: it reads the tile once (D lanes of base, qual, mask
// and strand: 5 bytes a lane) and writes 120 bytes
// a row, against 10 x 128 FMAs for each of 30 states (about 7,700 f32
// operations a row), so at the somatic caller's depths the bytes bound it.
//
// Design: one warp a row, eight rows a block. The lanes stride over the
// row's depth and count into a 512-bin int32 histogram in the warp's shared
// memory with shared atomics (integer counts: exact in any order); then
// lanes 0..20 take a grid state each and lanes 21..29 a strand state each,
// every chain of FMAs in registers, the tables read through the L1 cache.
// base is int8, qual int16 and ref_gt int32, as the native pileup holds
// them.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "snv_math.cuh"

namespace {

constexpr int kQ = 128;          // qscore bins (_QTAB_SIZE)
constexpr int kBins = 4 * kQ;    // (qscore, class) bins
constexpr int kF = 21;           // PRESTRAND_SIZE
constexpr int kS = 9;            // STRAND_STATE_SIZE
constexpr int kOut = kF + kS;    // GRID_SIZE
constexpr int kWarps = 8;
// histogram classes: (is_alt << 1) | is_fwd
constexpr int kRefRev = 0, kRefFwd = 1, kAltRev = 2, kAltFwd = 3;
constexpr int kNone = -1;

struct Tables {
    const float* ref_m;      // [128, 21]
    const float* alt_m;      // [128, 21]
    const float* on_ref;     // [128, 9]
    const float* on_alt;     // [128, 9]
    const float* off_ref;    // [128, 9]
    const float* off_alt;    // [128, 9]
};

// the count of slot k: class c0, plus class c1 where it is not kNone
__device__ __forceinline__ float count(const int* h, int k, int c0, int c1) {
    const int n = h[4 * k + c0] + (c1 == kNone ? 0 : h[4 * k + c1]);
    return static_cast<float>(n);
}

// sum_k count(k) * tab[k, col] in the XLA CPU dot's order
__device__ __forceinline__ float grid_dot(const int* h, int c0, int c1,
                                         const float* __restrict__ tab,
                                         int ncol, int col) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kQ; k += 4) {
        a0 = __fmaf_rn(count(h, k, c0, c1), __ldg(tab + k * ncol + col), a0);
        a1 = __fmaf_rn(count(h, k + 1, c0, c1),
                       __ldg(tab + (k + 1) * ncol + col), a1);
        a2 = __fmaf_rn(count(h, k + 2, c0, c1),
                       __ldg(tab + (k + 2) * ncol + col), a2);
        a3 = __fmaf_rn(count(h, k + 3, c0, c1),
                       __ldg(tab + (k + 3) * ncol + col), a3);
    }
    return __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
}

__global__ void __launch_bounds__(kWarps * 32)
somatic_grid_kernel(const int8_t* __restrict__ base,
                    const int16_t* __restrict__ qual,
                    const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ fwd,
                    const int32_t* __restrict__ ref, long long L, long long D,
                    Tables t, float ln_half, float* __restrict__ out) {
    __shared__ int h_s[kWarps][kBins];
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
    if (row >= L) return;    // the whole warp: no block barrier follows
    int* h = h_s[w];
    for (int i = lane; i < kBins; i += 32) h[i] = 0;
    __syncwarp();
    const int rg = ref[row];
    for (long long d = lane; d < D; d += 32) {
        const long long i = row * D + d;
        if (!mask[i]) continue;
        int q = qual[i];
        q = q < 0 ? 0 : (q > kQ - 1 ? kQ - 1 : q);
        const int cls = (base[i] != rg ? 2 : 0) | (fwd[i] ? 1 : 0);
        atomicAdd(&h[q * 4 + cls], 1);
    }
    __syncwarp();

    float* o = out + row * kOut;
    if (lane < kF) {
        const int f = lane;
        float lh = __fadd_rn(grid_dot(h, kRefRev, kRefFwd, t.ref_m, kF, f),
                             grid_dot(h, kAltRev, kAltFwd, t.alt_m, kF, f));
        if (f == 0 && (h[kRefFwd] > 0 || h[kRefRev] > 0)) lh = -INFINITY;
        if (f == 1 && h[kAltFwd] + h[kAltRev] > 0) lh = -INFINITY;
        o[f] = lh;
    } else if (lane < kOut) {
        const int s = lane - kF;
        float lf = __fadd_rn(
            __fadd_rn(__fadd_rn(grid_dot(h, kRefFwd, kNone, t.on_ref, kS, s),
                                grid_dot(h, kAltFwd, kNone, t.on_alt, kS, s)),
                      grid_dot(h, kRefRev, kNone, t.off_ref, kS, s)),
            grid_dot(h, kAltRev, kNone, t.off_alt, kS, s));
        float lr = __fadd_rn(
            __fadd_rn(__fadd_rn(grid_dot(h, kRefRev, kNone, t.on_ref, kS, s),
                                grid_dot(h, kAltRev, kNone, t.on_alt, kS, s)),
                      grid_dot(h, kRefFwd, kNone, t.off_ref, kS, s)),
            grid_dot(h, kAltFwd, kNone, t.off_alt, kS, s));
        if (h[kRefRev] > 0) lf = -INFINITY;    // q = 0 ref call, reverse
        if (h[kRefFwd] > 0) lr = -INFINITY;    // q = 0 ref call, forward
        const double v = snv::logaddexp(static_cast<double>(lf),
                                        static_cast<double>(lr));
        o[lane] = __fadd_rn(__double2float_rn(v), ln_half);   // kF + s
    }
}

}  // namespace

extern "C" {

// base [L, D] int8, qual [L, D] int16, mask and is_fwd [L, D] bool, ref_gt
// [L] int32,
// the six [128, F] f32 tables of convert.somatic_grid_tables
// (grid_ref, grid_alt: F = 21; grid_on_ref, grid_on_alt, grid_off_ref,
// grid_off_alt: F = 9), ln_half = f32 ln 0.5; all contiguous on one
// device, L >= 1. Out: [L, 30] f32. Launches on `stream`; returns
// cudaGetLastError().
int somatic_grid_launch(const void* base, const void* qual, const void* mask,
                        const void* is_fwd, const void* ref_gt, long long L,
                        long long D, const void* grid_ref,
                        const void* grid_alt, const void* grid_on_ref,
                        const void* grid_on_alt, const void* grid_off_ref,
                        const void* grid_off_alt, float ln_half, void* out,
                        void* stream) {
    const Tables t{static_cast<const float*>(grid_ref),
                   static_cast<const float*>(grid_alt),
                   static_cast<const float*>(grid_on_ref),
                   static_cast<const float*>(grid_on_alt),
                   static_cast<const float*>(grid_off_ref),
                   static_cast<const float*>(grid_off_alt)};
    const long long blocks = (L + kWarps - 1) / kWarps;
    somatic_grid_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(base), static_cast<const int16_t*>(qual),
        static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(is_fwd),
        static_cast<const int32_t*>(ref_gt), L, D, t, ln_half,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
