// KS-P: the somatic SNV joint posterior, on Hopper (sm_90a).
//
// Replaces strelka_tpu/models/somatic_snv.py:250 somatic_snv_call, a jitted
// XLA program (no Pallas), whose plain version in the port is
// models/somatic_snv.somatic_snv_call_plain: it materialises the [L, 3, 2,
// 21, 21] f32 sums, their float64 copy and a power-of-two padded tree sum,
// about 96 KB a row. This kernel gives that version's bits in one launch
// and keeps a row's terms on the chip. Per row of the normal and tumour
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
// Bound on the H100: it reads 240 bytes and writes 24 a row; the yardstick
// counts 3,100 float64 exps and 3,600 adds a row (each exp one operation,
// FP64 at 34 TFLOP/s), so the operations bound it. Most of those terms are
// -inf: the priors pf and off allow 20-34 (fn, ft) pairs of a group's 441
// and 36 of the off-diagonal ones, so a row of finite lhoods needs about
// 200 exps.
//
// Design: one warp a row, eight warps a block, a grid of as many blocks as
// fit the card at once, each warp walking rows.
// - Lists of live terms. Each block first lists, once, the terms whose
//   prior is not -inf (warp g for list g: the six groups, then the
//   off-diagonal terms), in shared memory. On a row whose 42 lhoods are
//   all below +inf (no NaN), every other term is -inf and its exp exactly
//   +0, so the warp takes exps of the listed terms only, spread over the
//   lanes (one or two a lane). A row with a NaN or a +inf lhood takes
//   every one of the 441 terms of each list, as the plain version does.
// - The same tree. The exps go to the warp's 448-slot float64 scratch in
//   shared memory at their term index i; lane l then reads the terms i = l
//   + 32 m, m = 0..13, that it holds in the tree (a term off the list is
//   0, never read) and runs the tree's first four halvings (h = 256 .. 32:
//   m with m + 8, 4, 2, 1; slots 14 and 15 are padding, zeros at compile
//   time, not added) in registers. The last five (h = 16 .. 1) of all
//   eight trees (the six groups, the off-diagonal, the diagonal) run at
//   once: through the scratch, lane 4 g + q adds tree g's eight lane sums
//   q + 4 i as the steps h = 16, 8, 4 pair them, and two shuffles take h =
//   2 and 1. Term for term, the plain version's tree.
// - One log for the eight logsumexps: lane 4 g takes the log of sum g.
// - Maxima by reductions: a group's terms are f32 values, so their max is
//   one __reduce_max_sync of keys whose int order is the values' (the
//   off-diagonal's float64 terms take a butterfly). The first argmax of
//   the log posteriors and the strand bias's two maxima are a key
//   reduction and a reduction of the lanes at the top key: the first NaN,
//   else the first of the largest, as torch's reductions take them.
// - The tail over the lanes. Lane g < 6 holds group g's log_post, so one
//   exp gives the six probabilities (lane 6 the nonsomatic logaddexp's
//   exp), one division normalises them, and one log the three phreds
//   (lanes 0-2). The six-term sums stay sequential, over the scratch.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "snv_math.cuh"

namespace {

constexpr int kF = 21;             // PRESTRAND_SIZE
constexpr int kGrid = 30;          // GRID_SIZE
constexpr int kN = kF * kF;        // terms of a group
constexpr int kGroups = 6;         // (ngt, somatic)
constexpr int kLists = kGroups + 1;   // the groups, then the off-diagonal
constexpr int kSlots = 14;         // tree slots a lane: ceil(441 / 32)
constexpr int kWarps = 8;
constexpr unsigned kAll = 0xffffffffu;
constexpr double kLog10E = 0.4342944819032518;   // jnp.log10's constant

struct Smem {
    // list entries: term i | fn << 9 | ft << 14
    unsigned list[kLists][kN];
    int n[kLists];
    double scratch[kWarps][32 * kSlots];
    float nl[kWarps][32], tl[kWarps][32];
};

__device__ __forceinline__ unsigned entry(int i) {
    return static_cast<unsigned>(i | (i / kF) << 9 | (i % kF) << 14);
}

// whether term i < kN of list g has a prior other than -inf (the
// off-diagonal list leaves out the diagonal, -inf by definition)
__device__ __forceinline__ bool listed(int g, int i, const float* pf,
                                       const double* off) {
    if (g < kGroups) return __ldg(pf + g * kN + i) != -INFINITY;
    return i / kF != i % kF && __ldg(off + i) != -INFINITY;
}

// term `e` of list g: float64 of f32 (pf + nl) + tl for a group, float64
// (nl + tl) + off for the off-diagonal list (-inf on the diagonal)
__device__ __forceinline__ double term(int g, unsigned e, const float* nl,
                                       const float* tl, const float* pf,
                                       const double* off) {
    const int i = e & 511, fn = (e >> 9) & 31, ft = e >> 14;
    if (g < kGroups)
        return static_cast<double>(__fadd_rn(
            __fadd_rn(__ldg(pf + g * kN + i), nl[fn]), tl[ft]));
    return fn == ft ? -INFINITY
                    : __dadd_rn(static_cast<double>(__fadd_rn(nl[fn], tl[ft])),
                                __ldg(off + i));
}

// a key of f32 v whose int order is v's, -0 and +0 one key, a NaN above
// every other
__device__ __forceinline__ int order_key(float v) {
    const int b = __float_as_int(v);
    return v != v ? INT_MAX : (b >= 0 ? b : (b ^ 0x7fffffff) + 1);
}

// the shift of a logsumexp whose largest term has key k: that term where
// it is finite, else 0 (the key of +-0 gives +0: a shift's zero sign
// changes no result)
__device__ __forceinline__ double key_shift(int k) {
    const float v = __int_as_float(k >= 0 ? k : (k - 1) ^ 0x7fffffff);
    return k != INT_MAX && fabsf(v) < INFINITY ? static_cast<double>(v)
                                               : 0.0;
}

// the lane of the first maximum of v over the lanes where `in`, as
// torch's argmax takes it: the first NaN, else the first of the largest
// (-0 equal to +0)
__device__ __forceinline__ int first_max_lane(float v, bool in, int lane) {
    const int k = in ? order_key(v) : INT_MIN;
    const int top = __reduce_max_sync(kAll, k);
    return __reduce_min_sync(kAll, in && k == top ? lane : 32);
}

// the halving tree's first four steps (h = 256 .. 32) over lane l's
// slots e[m] = s[l + 32 m] (slots 14 and 15 zero)
__device__ __forceinline__ double lane_tree(double (&e)[kSlots]) {
#pragma unroll
    for (int m = 0; m < 6; ++m) e[m] = __dadd_rn(e[m], e[m + 8]);   // h 256
#pragma unroll
    for (int h = 4; h >= 1; h /= 2)                                 // 128..32
#pragma unroll
        for (int m = 0; m < h; ++m) e[m] = __dadd_rn(e[m], e[m + h]);
    return e[0];
}

// the plain version's _logsumexp64 over list g's terms (every one of the
// 441 where `full`) up to its tree's last five steps: returns lane's
// partial sum (s[lane] after h = 32) and sets t to the shift (the max, 0
// where it is not finite). `bits` marks lane's tree slots that hold a
// listed term. A group's terms are f32 values, so their max is one
// reduction of their keys; the off-diagonal's is a butterfly.
__device__ __forceinline__ double list_part(
    int g, bool full, unsigned bits, const Smem& sm, double* sc,
    const float* nl, const float* tl, const float* pf, const double* off,
    int lane, double& t) {
    const int n = full ? kN : sm.n[g];
    const unsigned* list = sm.list[g];
    int top = order_key(-INFINITY);
    double mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
        const unsigned e = full ? entry(j) : list[j];
        const double v = term(g, e, nl, tl, pf, off);
        sc[e & 511] = v;
        if (g < kGroups)
            top = max(top, order_key(static_cast<float>(v)));
        else
            mx = snv::nan_max(mx, v);
    }
    if (g < kGroups) {
        t = key_shift(__reduce_max_sync(kAll, top));
    } else {
#pragma unroll
        for (int o = 16; o >= 1; o /= 2)
            mx = snv::nan_max(mx, __shfl_xor_sync(kAll, mx, o));
        t = snv::is_finite(mx) ? mx : 0.0;
    }
    for (int j = lane; j < n; j += 32) {
        const int i = (full ? j : list[j]) & 511;
        sc[i] = exp(__dsub_rn(sc[i], t));
    }
    __syncwarp();
    double e[kSlots];
#pragma unroll
    for (int m = 0; m < kSlots; ++m)
        e[m] = (bits >> m) & 1u ? sc[lane + 32 * m] : 0.0;
    __syncwarp();    // before the next list writes its terms
    return lane_tree(e);
}

// The last five steps (h = 16 .. 1) of eight trees at once: lane l holds
// part[g] = s_g[l] of tree g. Through the scratch, lane 4 g + q adds tree
// g's eight slots q + 4 i as the steps h = 16, 8, 4 pair them, and two
// shuffles take h = 2, 1. Returns tree g's sum on lane 4 g.
__device__ __forceinline__ double eight_trees(
    const double (&part)[kLists + 1], double* sc, int lane) {
#pragma unroll
    for (int g = 0; g <= kLists; ++g) sc[32 * g + lane] = part[g];
    __syncwarp();
    const double* x = sc + 32 * (lane >> 2) + (lane & 3);
    double u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __dadd_rn(x[4 * i], x[4 * i + 16]);
#pragma unroll
    for (int i = 0; i < 2; ++i) u[i] = __dadd_rn(u[i], u[i + 2]);
    double s = __dadd_rn(u[0], u[1]);
    s = __dadd_rn(s, __shfl_down_sync(kAll, s, 2));
    s = __dadd_rn(s, __shfl_down_sync(kAll, s, 1));
    __syncwarp();    // before the scratch is written again
    return s;
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
    __shared__ Smem sm;
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (w < kLists) {
        int cnt = 0;
        for (int b = 0; b < kN; b += 32) {
            const int i = b + lane;
            const bool keep = i < kN && listed(w, i, pf, off);
            const unsigned bal = __ballot_sync(kAll, keep);
            if (keep)
                sm.list[w][cnt + __popc(bal & ((1u << lane) - 1u))] =
                    entry(i);
            cnt += __popc(bal);
        }
        if (lane == 0) sm.n[w] = cnt;
    }
    // lane's tree slots that hold a listed term, for each list, and for
    // every term (i = lane + 32 m < 441)
    unsigned bits[kLists];
#pragma unroll
    for (int g = 0; g < kLists; ++g) {
        bits[g] = 0u;
        for (int m = 0; m < kSlots; ++m) {
            const int i = lane + 32 * m;
            if (i < kN && listed(g, i, pf, off)) bits[g] |= 1u << m;
        }
    }
    const unsigned all_bits = lane + 32 * (kSlots - 1) < kN ? 0x3fffu : 0x1fffu;
    __syncthreads();

    double* sc = sm.scratch[w];
    float* nl = sm.nl[w];
    float* tl = sm.tl[w];
    const long long step = static_cast<long long>(gridDim.x) * kWarps;
    for (long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
         row < L; row += step) {
        const float nlv = lane < kF ? normal[row * kGrid + lane] : 0.0f;
        const float tv = lane < kGrid ? tumor[row * kGrid + lane] : 0.0f;
        nl[lane] = nlv;
        tl[lane] = tv;
        __syncwarp();
        // a NaN or +inf lhood makes every term count (no -inf prior
        // makes its term -inf then)
        const bool full = !__all_sync(
            kAll, lane >= kF || (nlv < INFINITY && tv < INFINITY));

        // lane's partials of the six groups' trees, the off-diagonal's
        // and the diagonal's (21 terms (nl + tl) + eq, a tree of 32), and
        // their shifts
        double part[kLists + 1], shift[kLists + 1];
#pragma unroll
        for (int g = 0; g < kLists; ++g)
            part[g] = list_part(g, full, full ? all_bits : bits[g], sm, sc,
                                nl, tl, pf, off, lane, shift[g]);
        const float dv = lane < kF ? __fadd_rn(__fadd_rn(nlv, tv),
                                               __ldg(eq + lane))
                                   : -INFINITY;
        shift[kLists] = key_shift(__reduce_max_sync(kAll, order_key(dv)));
        part[kLists] = lane < kF
            ? exp(__dsub_rn(static_cast<double>(dv), shift[kLists])) : 0.0;
        // lane 4 g takes the log of tree g's sum, lane g < 8 gathers it
        const double lg = __shfl_sync(
            kAll, log(fabs(eight_trees(part, sc, lane))), 4 * (lane & 7));
        double my_shift = shift[0];
#pragma unroll
        for (int g = 1; g <= kLists; ++g)
            my_shift = (lane & 7) == g ? shift[g] : my_shift;
        const double lse = __dadd_rn(lg, my_shift);
        const double lse_off = __shfl_sync(kAll, lse, kGroups);
        const double lse_diag = static_cast<double>(
            __double2float_rn(__shfl_sync(kAll, lse, kLists)));

        // the tail: lane g < 6 holds group g
        const float lp = __fadd_rn(__double2float_rn(lse),
                                   __ldg(gp + (lane < kGroups ? lane : 0)));
        const int max_gt = first_max_lane(lp, lane < kGroups, lane);
        const double mx = static_cast<double>(__shfl_sync(kAll, lp, max_gt));
        const double dd = lse_diag - lse_off;
        const double ex = exp(lane < kGroups
                                  ? __dsub_rn(static_cast<double>(lp), mx)
                                  : -fabs(dd));
        if (lane <= kGroups) sc[lane] = ex;
        __syncwarp();
        double s = sc[0];
#pragma unroll
        for (int g = 1; g < kGroups; ++g) s = __dadd_rn(s, sc[g]);
        const double e6 = sc[kGroups];
        if (lane < kGroups) sc[8 + lane] = ex / s;
        __syncwarp();
        double p[kGroups];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) p[g] = sc[8 + g];
        // p[2 n + somatic]
        const double nonsom = __dadd_rn(__dadd_rn(p[0], p[2]), p[4]);
        const double total_som = __dadd_rn(__dadd_rn(p[1], p[3]), p[5]);
        double err[3];
        double min_err = 0.0;
#pragma unroll
        for (int n = 0; n < 3; ++n) {
            err[n] = __dadd_rn(nonsom, __dsub_rn(total_som, p[2 * n + 1]));
            min_err = n == 0 ? err[0] : snv::nan_min(min_err, err[n]);
        }
        // snv::logaddexp(lse_diag, lse_off), its exp taken above on lane 6
        const double denom = snv::is_nan(dd)
            ? lse_diag + lse_off
            : snv::nan_max(lse_diag, lse_off) + log1p(e6);
        const double frac = exp(__dsub_rn(lse_diag, denom));
        const int ph = phred64(lane == 0 ? nonsom
                               : lane == 1 ? min_err
                                           : __dsub_rn(1.0, frac));
        // the strand bias: the first max of states 3..20 and of 21..29
        const float symm = __shfl_sync(
            kAll, tv, first_max_lane(tv, lane >= 3 && lane < kF, lane));
        const float strand = __shfl_sync(
            kAll, tv, first_max_lane(tv, lane >= kF && lane < kGrid, lane));

        if (lane == 0) o.qphred[row] = ph;
        if (lane == 1) o.from_ntype_qphred[row] = ph;
        if (lane == 2) o.nonsomatic_qphred[row] = ph;
        if (lane == 3) o.ntype[row] = snv::arg_min(err, 3);
        if (lane == 4) o.max_gt[row] = max_gt;
        if (lane == 5)
            o.strand_bias[row] =
                snv::clamp_min(__fsub_rn(strand, symm), 0.0f);
        __syncwarp();    // nl, tl are the next row's
    }
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
    const long long blocks = snv::resident_blocks(
        somatic_posterior_kernel, kWarps * 32, (L + kWarps - 1) / kWarps);
    somatic_posterior_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(normal), static_cast<const float*>(tumor),
        static_cast<const float*>(joint_pf),
        static_cast<const float*>(joint_gp), static_cast<const float*>(eq),
        static_cast<const double*>(off), L, o);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
