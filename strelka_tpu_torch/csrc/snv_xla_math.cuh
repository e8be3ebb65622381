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
// - a warp's walk over a row's calls (walk): each window of calls is
//   fetched into registers a window ahead, then written once into the
//   warp's shared memory as one row of values a call (its columns: every
//   value that any of the row's sums can take from it), and each lane
//   adds kPer sums (its items) over the window together, a term being one
//   read of the call's row at the column that the item's map gives for
//   the call's class; each sum in XLA's order (SmallSum at D <= 32, the
//   windows and push past it);
// - a logsumexp of several groups spread over the warp's lanes
//   (lse_spread: the exps one to a lane, each group's sum in order on one
//   lane).
//   tests/test_torch_snv_sb_rna.py holds torch models of the walk and of
//   the spread against xla_sum_minor, xla_sum_major and the plain versions.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "snv_math.cuh"

namespace snv_xla {

constexpr int kVals = 256;        // _VALS_Q: qscores of the value tables
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

    __device__ void init(int v, int n) {
        s = 0.0f;
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

template <typename Q>
__device__ __forceinline__ int qual255(Q q) {
    const int v = static_cast<int>(q);
    return v < 0 ? 0 : (v > kVals - 1 ? kVals - 1 : v);
}

// the calls [p0, p0 + n) of level 0's window j
__device__ __forceinline__ int window_calls(const Windows& w, long long j,
                                            long long& p0) {
    const long long lo = 32 * j - w.lo[0];
    p0 = lo < 0 ? 0 : lo;
    const long long p1 = lo + 32 < w.n[0] ? lo + 32 : w.n[0];
    return static_cast<int>(p1 - p0);
}

// The selector of byte b (0..3) of a word for __byte_perm(word, 0, sel):
// the byte, zero-extended (the selector's bits past 15 are not read, so a
// call's class word keeps other fields there)
__device__ __forceinline__ unsigned byte_sel(int b) {
    return 0x4440u | static_cast<unsigned>(b);
}

// One pass of a warp over a row's calls: the sums of each lane's kPer
// items, each in XLA's order, into out. fetch(p0, n) loads call p0 + lane
// of a window of n calls into registers (a window ahead of its sums);
// commit(f, n) writes them into the warp's rows, the warp synchronised
// after it; term(i, x) gives each item's term of the window's call i.
// kSmall (D <= 32): one window, each item's terms in its vectorized order
// (SmallSum with variant(k)); else windows of 32 summed in order from +0
// and folded into the upper levels (push). Ends synchronised, the rows
// free.
template <int kPer, bool kSmall, class Fetch, class Commit, class Term,
          class Variant>
__device__ __forceinline__ void walk(const Windows& w, Fetch fetch,
                                     Commit commit, Term term,
                                     Variant variant, float (&out)[kPer]) {
    long long p0;
    int n = window_calls(w, 0, p0);
    auto f = fetch(p0, n);
    if constexpr (kSmall) {
        commit(f, n);
        __syncwarp();
        SmallSum sm[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) sm[k].init(variant(k), n);
        for (int i = 0; i < n; ++i) {
            float x[kPer];
            term(i, x);
#pragma unroll
            for (int k = 0; k < kPer; ++k) sm[k].add(i, x[k]);
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k) out[k] = sm[k].s;
    } else {
        float a1[kPer], a2[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) a1[k] = a2[k] = out[k] = 0.0f;
        for (long long j = 0; j < w.n[1]; ++j) {
            commit(f, n);
            __syncwarp();
            const int nj = n;
            if (j + 1 < w.n[1]) {
                n = window_calls(w, j + 1, p0);
                f = fetch(p0, n);
            }
            float s[kPer];
#pragma unroll
            for (int k = 0; k < kPer; ++k) s[k] = 0.0f;
#pragma unroll 4
            for (int i = 0; i < nj; ++i) {
                float x[kPer];
                term(i, x);
#pragma unroll
                for (int k = 0; k < kPer; ++k) s[k] = __fadd_rn(s[k], x[k]);
            }
#pragma unroll
            for (int k = 0; k < kPer; ++k)
                push(w, j, s[k], a1[k], a2[k], out[k]);
            __syncwarp();
        }
    }
    __syncwarp();
}

// _het_vf_combine over `groups` groups, spread over the warp: group c's
// lhood x0 on its owner lane (own: c, -1 on other lanes), its m terms at
// ext(c, k) in shared memory, k < m. The owner takes its group's max in
// four interleaved chains (the NaN-first max of any order: a NaN, and
// then any non-finite max, becomes 0, and a +0 or -0 max shifts every
// term alike), the lanes take the groups' exps, term t = c (m + 1) + k on
// lane t % 32 (x0's into x0s[c], the terms' in place), then the owner adds
// its exps in order and returns log(sum) + max - ln(1 + m); other lanes
// get x0 back. x0s and mxs hold `groups` floats of the warp's scratch.
template <class Ext>
__device__ __forceinline__ float lse_spread(float x0, int own, int groups,
                                            int m, Ext ext, float* x0s,
                                            float* mxs, int lane) {
    if (own >= 0) {
        float mx[4] = {x0, x0, x0, x0};
        int k = 0;
        for (; k + 4 <= m; k += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                mx[u] = snv::nan_max(mx[u], *ext(own, k + u));
        }
        for (; k < m; ++k) mx[0] = snv::nan_max(mx[0], *ext(own, k));
        const float top = snv::nan_max(snv::nan_max(mx[0], mx[1]),
                                       snv::nan_max(mx[2], mx[3]));
        x0s[own] = x0;
        mxs[own] = fabsf(top) < INFINITY ? top : 0.0f;
    }
    __syncwarp();
    const int w = m + 1;
    int c = lane / w, k = lane % w;
    for (int t = lane; t < groups * w; t += 32) {
        float* p = k == 0 ? x0s + c : ext(c, k - 1);
        *p = exp_f32(__fsub_rn(*p, mxs[c]));
        for (k += 32; k >= w; k -= w) ++c;
    }
    __syncwarp();
    float r = x0;
    if (own >= 0) {
        float tot = x0s[own];
#pragma unroll 4
        for (int j = 0; j < m; ++j) tot = __fadd_rn(tot, *ext(own, j));
        r = __fsub_rn(__fadd_rn(log_f32(tot), mxs[own]),
                      log_f32(static_cast<float>(m + 1)));
    }
    __syncwarp();
    return r;
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
