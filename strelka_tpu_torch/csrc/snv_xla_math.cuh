// XLA's CPU arithmetic as the port's RNA and strand-bias tiles follow it
// (models/snv_digt.py), shared by KG-SB (snv_strand_bias.cu) and KG-R
// (snv_rna_tile.cu), so that each kernel gives its plain version's bits:
//
// - exp_f32, log_f32: Cephes' polynomials as XLA's CPU backend emits
//   them (_xla_exp_f32, _xla_log_f32): each mul+add pair that LLVM
//   contracts an __fmaf_rn, every other product and sum rounded apart;
//   their constants rounded to f32 from the double, as torch.tensor(v,
//   float32) rounds them;
// - the sum orders over a row's calls: one at a time (_seq_terms), LLVM's
//   vectorized reductions of up to 32 terms (_vector_sum, _halves) and
//   XLA's tree-reduction rewrite past 32 (_xla_windows: windows of 32
//   terms, the padding split around them, each window and the window sums
//   added one at a time, windows of windows past 32 windows);
// - the genotype tables of models/digt.py (EXPECT2, EXPECT2_BIAS), the
//   low-ratio key remap 0,2,1,3 and _bias_index's wrap-then-clamp of a
//   base id;
// - a warp's staging of a row's calls, a window at a time, and the walk
//   that sums each lane's item over them in those orders, its terms one
//   at a time (row_sums, SmallSum).
//   tests/test_torch_snv_sb_rna.py holds a torch model of the walk
//   against xla_sum_minor and xla_sum_major.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "snv_math.cuh"

namespace snv_xla {

constexpr int kVals = 256;        // _VALS_Q: qscores of the value tables
// a het-VF table row (one step's value v0..v3 for every qscore) padded by
// one float in shared memory, so that the rows a warp's lanes read at one
// qscore fall in different banks
constexpr int kHetStride = kVals + 1;
constexpr int kMaxSteps = 40;     // het-ratio steps the kernels take
constexpr int kMaxDepth = 1 << 20;   // calls a row: three window levels

__device__ __forceinline__ float f32(double v) {
    return static_cast<float>(v);
}

// e^x (_xla_exp_f32): 2^n (x - n ln 2) with Cephes' polynomial
__device__ __forceinline__ float exp_f32(float x) {
    x = snv::is_nan(x) ? x : fminf(fmaxf(x, f32(-87.8)), f32(88.8));
    float n = floorf(__fmaf_rn(x, f32(1.44269504088896341), f32(0.5)));
    n = snv::is_nan(n) ? n : fminf(fmaxf(n, -127.0f), 127.0f);
    x = __fmaf_rn(f32(-0.693359375), n, x);
    x = __fmaf_rn(f32(2.12194440e-4), n, x);
    float z = __fmaf_rn(x, f32(1.9875691500e-4), f32(1.3981999507e-3));
    z = __fmaf_rn(z, x, f32(8.3334519073e-3));
    z = __fmaf_rn(z, x, f32(4.1665795894e-2));
    z = __fmaf_rn(z, x, f32(1.6666665459e-1));
    z = __fmaf_rn(z, x, f32(5.0000001201e-1));
    z = __fmaf_rn(z, __fmul_rn(x, x), x);
    z = __fadd_rn(1.0f, z);
    // 2^n from its exponent bits (0 for n = -127); a NaN's z stays NaN
    const int ni = snv::is_nan(n) ? 0 : static_cast<int>(n);
    return __fmul_rn(z, __int_as_float((ni + 127) << 23));
}

// ln x (_xla_log_f32): the mantissa folded below sqrt(1/2), Cephes'
// polynomial in three Horner chains, the exponent added back
__device__ __forceinline__ float log_f32(float x) {
    const int bits = __float_as_int(x);
    float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.0f);
    float t = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
    const bool fold = t < f32(0.707106781186547524);
    const float tmp = fold ? t : 0.0f;
    t = __fsub_rn(t, 1.0f);
    e = __fsub_rn(e, fold ? 1.0f : 0.0f);
    t = __fadd_rn(t, tmp);
    const float x2 = __fmul_rn(t, t);
    const float x3 = __fmul_rn(x2, t);
    float y = __fmaf_rn(t, f32(7.0376836292e-2), f32(-1.1514610310e-1));
    float y1 = __fmaf_rn(t, f32(-1.2420140846e-1), f32(1.4249322787e-1));
    float y2 = __fmaf_rn(t, f32(2.0000714765e-1), f32(-2.4999993993e-1));
    y = __fmaf_rn(y, t, f32(1.1676998740e-1));
    y1 = __fmaf_rn(y1, t, f32(-1.6668057665e-1));
    y2 = __fmaf_rn(y2, t, f32(3.3333331174e-1));
    y = __fmaf_rn(y, x3, y1);
    y = __fmaf_rn(y, x3, y2);
    y = __fmaf_rn(y, x3, __fmul_rn(f32(-2.12194440e-4), e));
    t = __fmaf_rn(-0.5f, x2, t);
    t = __fadd_rn(t, y);
    return __fmaf_rn(f32(0.693359375), e, t);
}

// the two alleles of genotype g (digt.ALLELES), two bits each
constexpr unsigned kAlleleLo = 0u | 1u << 2 | 2u << 4 | 3u << 6 | 0u << 8
    | 0u << 10 | 0u << 12 | 1u << 14 | 1u << 16 | 2u << 18;
constexpr unsigned kAlleleHi = 0u | 1u << 2 | 2u << 4 | 3u << 6 | 1u << 8
    | 2u << 10 | 3u << 12 | 2u << 14 | 3u << 16 | 3u << 18;

__device__ __forceinline__ int allele_lo(int g) {
    return (kAlleleLo >> (2 * g)) & 3;
}
__device__ __forceinline__ int allele_hi(int g) {
    return (kAlleleHi >> (2 * g)) & 3;
}

// digt.EXPECT2[g, b]: the copies of base b in genotype g (0, 1, 2)
__device__ __forceinline__ int expect2(int g, int b) {
    return (allele_lo(g) == b) + (allele_hi(g) == b);
}

// digt.EXPECT2_BIAS[g, b]: 3 for a hom genotype's base, 1 and 2 for a
// het's lower and higher allele, else 0
__device__ __forceinline__ int expect2_bias(int g, int b) {
    if (g < 4) return g == b ? 3 : 0;
    return b == allele_lo(g) ? 1 : (b == allele_hi(g) ? 2 : 0);
}

// _LOW_REMAP: a het's low-ratio value for each bias key
__device__ __forceinline__ int low_key(int k) {
    return k == 1 ? 2 : (k == 2 ? 1 : k);
}

// _bias_index: a negative id wraps once (-1 is 3), then 0..3
__device__ __forceinline__ int bias_index(int b) {
    b = b < 0 ? b + 4 : b;
    return b < 0 ? 0 : (b > 3 ? 3 : b);
}

// The sums of at most 32 terms (one window): one at a time, or LLVM's
// vectorized loops (_vector_sum with its vf, uf and epilogue)
enum Small { kSeq, kVec8x3, kVec4x4e4, kVec8x4e8 };

// the variant of XLA's sum over a minor axis of n <= 32 terms
// (_xla_minor_small)
__device__ __forceinline__ int minor_variant(long long n) {
    return n < 16 ? kSeq : (n >= 20 && n < 24 ? kVec4x4e4 : kVec8x4e8);
}

// the strand-bias tile's free-call sums (_sb_free_small)
__device__ __forceinline__ int sb_free_variant(long long n) {
    return n == 32 ? kVec8x3 : kSeq;
}

// _halves over a[0..n), n 4 or 8: the upper half added onto the lower
__device__ __forceinline__ float halves(float (&a)[8], int n) {
#pragma unroll
    for (int h = 4; h >= 1; h /= 2) {
        if (h < n) {
#pragma unroll
            for (int k = 0; k < h; ++k) a[k] = __fadd_rn(a[k], a[k + h]);
        }
    }
    return a[0];
}

// a[i] = first ? x : a[i] + x, with i a run-time lane (registers, no
// local memory)
__device__ __forceinline__ void lane_add(float (&a)[8], int i, bool first,
                                         float x) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
        if (k == i) a[k] = first ? x : __fadd_rn(a[k], x);
}

// _vector_sum(x, vf, uf, epi) of n <= 32 terms, taking them one at a time
// in order (there is at most one block of vf * uf terms): term d < nv
// goes to lane d % vf of the block's accumulators, which add their terms
// in order and reduce by halves; term d of the epilogue's ne goes to its
// lane (d - nv) % epi, lane 0 starting from the running sum; the rest
// are added one at a time. kSeq has no block and no epilogue.
struct SmallSum {
    float a[8];
    float s;
    int vf, nv, epi, ne;

    __device__ SmallSum(int v, int n) : s(0.0f) {
        const int uf = v == kVec8x3 ? 3 : 4;
        vf = v == kVec4x4e4 ? 4 : 8;
        epi = v == kVec8x4e8 ? 8 : (v == kVec4x4e4 ? 4 : 0);
        nv = v == kSeq ? 0 : n / (vf * uf) * (vf * uf);
        ne = epi && n - nv >= epi ? (n - nv) / epi * epi : 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = 0.0f;
    }
    __device__ void add(int d, float x) {
        if (d < nv) {
            lane_add(a, d % vf, d < vf, x);
            if (d == nv - 1) s = halves(a, vf);
        } else if (d < nv + ne) {
            const int j = d - nv;
            const bool first = j < epi;
            lane_add(a, j % epi, first, first && j == 0 ? __fadd_rn(s, x)
                                                        : x);
            if (d == nv + ne - 1) s = halves(a, epi);
        } else {
            s = __fadd_rn(s, x);
        }
    }
};

// XLA's tree-reduction rewrite of a sum of D > 32 terms (_xla_windows):
// level 0's items are the calls, level k + 1's the sums of level k's
// windows of 32 (n[k + 1] = ceil(n[k] / 32), lo[k] padding items before
// the first window), up to the top level of at most 32 items, which is
// summed one at a time. levels 0: D <= 32 (no windows).
struct Windows {
    long long n[4];
    long long lo[3];
    int levels;

    __device__ explicit Windows(long long D) : levels(0) {
        n[0] = D;
        n[1] = 1;     // one window of all the calls where levels is 0
        lo[0] = 0;
        while (levels < 3 && n[levels] > 32) {
            n[levels + 1] = (n[levels] + 31) / 32;
            lo[levels] = (n[levels + 1] * 32 - n[levels]) / 2;
            ++levels;
        }
    }
    // level k's item j ends its window (the padding after it adds +0)
    __device__ bool closes(int k, long long j) const {
        return (j + lo[k]) % 32 == 31 || j == n[k] - 1;
    }
};

// level 1's item j, the sum v of level 0's window j, into the upper
// levels' running sums (a1, a2: the open windows of levels 1 and 2; top:
// the top level's sum); every running sum starts at +0
__device__ __forceinline__ void push(const Windows& w, long long j, float v,
                                     float& a1, float& a2, float& top) {
    if (w.levels == 1) {
        top = __fadd_rn(top, v);
        return;
    }
    a1 = __fadd_rn(a1, v);
    if (!w.closes(1, j)) return;
    v = a1;
    a1 = 0.0f;
    j = (j + w.lo[1]) / 32;
    if (w.levels == 2) {
        top = __fadd_rn(top, v);
        return;
    }
    a2 = __fadd_rn(a2, v);
    if (!w.closes(2, j)) return;
    top = __fadd_rn(top, a2);
    a2 = 0.0f;
}

// A window of a row's calls, staged by its warp: call i of the window
// (lane i loaded it)
struct Calls {
    float dd[32];         // the dependent-eprob delta (0 without)
    int8_t b[32];         // base id as the lanes hold it
    uint8_t q[32];        // clamp(qual, 0, 255)
    uint8_t mf[32];       // mask | is_fwd << 1
};

template <typename Q>
__device__ __forceinline__ int qual255(Q q) {
    const int v = static_cast<int>(q);
    return v < 0 ? 0 : (v > kVals - 1 ? kVals - 1 : v);
}

// The sums of a row's D calls for its `items` items, one item a lane in
// passes of 32: res[it] = the sum over the calls of term(prep(it), i) (i:
// the call's place in the staged window) in variant(it)'s order for D <=
// 32 (SmallSum) and in XLA's windows past it (push). load(p0, n, first)
// stages the row's calls p0 .. p0 + n - 1 into the warp's Calls, call p0
// + l by lane l, `first` on the row's first pass over them; the warp
// synchronises around each window. A lane's terms meet one call site, so
// that each kernel holds one copy of its term.
template <class Load, class Prep, class Term, class Variant>
__device__ __forceinline__ void row_sums(const Windows& w, int items,
                                         int lane, Load load, Prep prep,
                                         Term term, Variant variant,
                                         float* res) {
    for (int it0 = 0; it0 < items; it0 += 32) {
        const int it = it0 + lane;
        const bool live = it < items;
        const auto item = prep(live ? it : 0);
        SmallSum small(live && w.levels == 0 ? variant(it) : kSeq,
                       static_cast<int>(w.levels == 0 ? w.n[0] : 0));
        float a1 = 0.0f, a2 = 0.0f, top = 0.0f;
        for (long long j = 0; j < w.n[1]; ++j) {
            const long long lo = 32 * j - w.lo[0];
            const long long p0 = lo < 0 ? 0 : lo;
            const long long p1 = lo + 32 < w.n[0] ? lo + 32 : w.n[0];
            const int n = static_cast<int>(p1 - p0);
            load(p0, n, it0 == 0);
            __syncwarp();
            if (live) {
                float s = 0.0f;
                for (int i = 0; i < n; ++i) {
                    const float x = term(item, i);
                    if (w.levels == 0)
                        small.add(i, x);
                    else
                        s = __fadd_rn(s, x);
                }
                if (w.levels > 0) push(w, j, s, a1, a2, top);
            }
            __syncwarp();
        }
        if (live) res[it] = w.levels == 0 ? small.s : top;
    }
}

// _het_vf_combine for one het genotype: logsumexp of its lhood x0 and its
// 2 * n_steps extension terms ext[0..), in order, minus ln(1 + 2 n_steps)
__device__ __forceinline__ float het_combine(float x0, const float* ext,
                                             int n_steps) {
    const int m = 2 * n_steps;
    float mx = x0;
    for (int k = 0; k < m; ++k) mx = snv::nan_max(mx, ext[k]);
    mx = fabsf(mx) < INFINITY ? mx : 0.0f;
    float tot = exp_f32(__fsub_rn(x0, mx));
    for (int k = 0; k < m; ++k)
        tot = __fadd_rn(tot, exp_f32(__fsub_rn(ext[k], mx)));
    const float lse = __fadd_rn(log_f32(tot), mx);
    return __fsub_rn(lse, log_f32(static_cast<float>(m + 1)));
}

// Stage the het-VF table [n_steps, 4, 256] into shared memory (rows
// kHetStride apart), each block once.
__device__ __forceinline__ void stage_het(float* dst, const float* src,
                                          int n_steps) {
    for (int i = threadIdx.x; i < n_steps * 4 * kVals; i += blockDim.x)
        dst[(i / kVals) * kHetStride + i % kVals] = src[i];
}

// The dynamic shared memory a launch asks for, allowed past 48 KB
// (cudaFuncAttributeMaxDynamicSharedMemorySize) before it.
template <typename Kernel>
cudaError_t allow_dynamic(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace snv_xla
