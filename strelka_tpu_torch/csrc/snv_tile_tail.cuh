// The germline SNV tile's float64 tail, shared by KG-H
// (snv_hist_tile.cu) and KG-R (snv_rna_tile.cu): the tables a block
// stages, a row's inputs beside its lhoods, the warp's histogram counted
// from the lanes and its live-slot walk, and the tail (_tile_tail) of a
// batch of a warp's rows, a row to each 10 lanes. Both kernels give
// models/snv_digt._tile_tail's bits from the [L, 10] f32 lhoods they
// compute (the genomic and the polymorphic result sets, the phreds, ln of
// the ref posterior and the PLs), under csrc/snv_math.cuh's rules.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "snv_math.cuh"

namespace snv_tile {

constexpr int kSlots = 512;      // _SNV_QTAB_SIZE * 4
constexpr int kQ = 128;          // _SNV_QTAB_SIZE
constexpr int kGt = 10;          // genotypes
constexpr int kBases = 4;
constexpr int kPrior = 5 * kGt;  // a [5, 10] prior table
constexpr unsigned kAll = 0xffffffffu;
constexpr double kLn10 = 2.302585092994046;   // math.log(10.0)

struct Out {
    float* lhood;        // [L, 10]
    int* g_max;          // [L]
    int* p_max;
    int* snv_q;
    int* g_qmax;
    int* p_qmax;
    int* pl;             // [L, 10]
    double* ln_ref;      // [L]
};

struct Tables {
    const float* qtab;   // [512, 10]
    const float* e0;     // [4, 10]
    const double* prior[4];   // genome, poly, genome_haploid, poly_haploid
};

struct Row {             // a row's inputs beside its counts
    const int* ref_gt;
    const uint8_t* hap;
    const float* s_mis;
};

// the tables in shared memory, staged once a block
struct __align__(16) Staged {
    float qtab[kSlots * kGt];
    float e0[kBases * kGt];
    double prior[4][kPrior];
};

__device__ void stage(Staged& s, const Tables& t) {
    const uint4* q4 = reinterpret_cast<const uint4*>(t.qtab);
    for (int i = threadIdx.x; i < kSlots * kGt / 4; i += blockDim.x)
        reinterpret_cast<uint4*>(s.qtab)[i] = q4[i];
    for (int i = threadIdx.x; i < kBases * kGt; i += blockDim.x)
        s.e0[i] = t.e0[i];
    for (int i = threadIdx.x; i < 4 * kPrior; i += blockDim.x)
        s.prior[i / kPrior][i % kPrior] = t.prior[i / kPrior][i % kPrior];
    __syncthreads();
}

// A warp's (qscore, base) histogram from the lanes (KG-H's lanes entry,
// KG-R): 512 int32 bins in shared memory, integer counts (exact in any
// order).

// count a call where it is masked in and 0 <= b < 4: bin clamp(q, 0, 127)
// * 4 + b (_tile_hist's)
__device__ __forceinline__ void count_call(int* h, bool m, int b, int q) {
    if (m && b >= 0 && b < kBases)
        atomicAdd(&h[(q < 0 ? 0 : (q > kQ - 1 ? kQ - 1 : q)) * kBases + b],
                  1);
}

// zero the warp's bins, lane l bins 16 l .. 16 l + 15, then __syncwarp
__device__ __forceinline__ void clear_bins(int* h, int lane) {
    int4* h4 = reinterpret_cast<int4*>(h);
#pragma unroll
    for (int j = 0; j < 4; ++j) h4[4 * lane + j] = make_int4(0, 0, 0, 0);
    __syncwarp();
}

// f(k) on every lane for each live slot k of the warp's bins, ascending:
// bit l of word x for slot 32 x + l, word x kept by lane x, the words
// without a live slot skipped
template <typename F>
__device__ __forceinline__ void for_live_slots(const int* h, int lane, F f) {
    unsigned word = 0;
#pragma unroll
    for (int x = 0; x < kSlots / 32; ++x) {
        const unsigned b = __ballot_sync(kAll, h[32 * x + lane] != 0);
        word = lane == x ? b : word;
    }
    unsigned words = __ballot_sync(kAll, word != 0);
    while (words) {
        const int x = __ffs(words) - 1;
        words &= words - 1;
        unsigned bits = __shfl_sync(kAll, word, x);
        while (bits) {
            const int k = 32 * x + __ffs(bits) - 1;
            bits &= bits - 1;
            f(k);
        }
    }
}

// -10 log10(max(x, tiny)) + 0.5, floored, at most 999 (as torch runs it)
__device__ __forceinline__ double phred10(double x) {
    const double lg = log10(snv::clamp_min(x, snv::kF64Tiny));
    return snv::clamp_max(floor(__dadd_rn(__dmul_rn(-10.0, lg), 0.5)),
                          999.0);
}

// order-preserving keys: unsigned order of the values, -0 as +0, a NaN
// above all (a real value's key is never 0)
__device__ __forceinline__ unsigned long long key64(double v) {
    if (snv::is_nan(v)) return ~0ull;
    const unsigned long long b = __double_as_longlong(v == 0.0 ? 0.0 : v);
    return (b >> 63) ? ~b : (b | (1ull << 63));
}
__device__ __forceinline__ unsigned key32(float v) {
    if (snv::is_nan(v)) return kAll;
    const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
    return (b >> 31) ? ~b : (b | 0x80000000u);
}

// a group's 10-wide sum in ascending g (_seq_sum): lane base + g holds
// x_g; the values meet in the warp's scratch x[32] in shared memory
__device__ __forceinline__ double seq_sum10(double v, int base, double* x,
                                            int lane) {
    x[lane] = v;
    __syncwarp();
    double s = x[base];
#pragma unroll
    for (int g = 1; g < kGt; ++g) s = __dadd_rn(s, x[(base + g) & 31]);
    __syncwarp();     // the scratch is rewritten
    return s;
}

// a row's inputs beside its counts, loaded before its walk so that their
// latency hides behind it
struct RowVals {
    float sm[kBases];
    int ref;
    bool hap;
};

__device__ __forceinline__ RowVals load_row(const Row& in, long long row) {
    RowVals v;
    v.ref = in.ref_gt[row];
    v.hap = in.hap && in.hap[row];
#pragma unroll
    for (int b = 0; b < kBases; ++b)
        v.sm[b] = in.s_mis ? in.s_mis[row * kBases + b] : 0.0f;
    return v;
}

// the s_mis term (_add_smis): genotype g's lhood plus the 4-term sum, b
// ascending, added once
__device__ __forceinline__ float add_smis(const Staged& s, float lh,
                                          const RowVals& v, const Row& in,
                                          int g) {
    if (!in.s_mis) return lh;
    float m = 0.0f;
#pragma unroll
    for (int b = 0; b < kBases; ++b)
        m = __fadd_rn(m, __fmul_rn(v.sm[b], s.e0[b * kGt + g]));
    return __fadd_rn(lh, m);
}

// A group's max and first argmax over its lanes (gmask) where `inside`,
// by the keys' order: the lowest lane of the top key (base where none).
__device__ __forceinline__ int first_max_lane(unsigned gmask, bool inside,
                                              unsigned hi, unsigned lo,
                                              int base) {
    hi = inside ? hi : 0u;
    lo = inside ? lo : 0u;
    const unsigned top_hi = __reduce_max_sync(gmask, hi);
    const unsigned top_lo = __reduce_max_sync(gmask, hi == top_hi ? lo : 0u);
    const unsigned win = __ballot_sync(
        kAll, inside && hi == top_hi && lo == top_lo) & gmask;
    return win ? __ffs(win) - 1 : base;
}

// The rows of a warp whose lhoods wait for the tail: up to kBatch rows,
// row first + i * step in lh[i] (written by lanes 0-9).
constexpr int kBatch = 3;
struct Batch {
    float (*lh)[kGt];
    int* ref;          // [kBatch]
    uint8_t* hap;      // [kBatch]
    double* x;         // [32], the sums' scratch
    long long first;
    int n;
};

// The tail (_tile_tail) of a batch, a row to each 10 lanes: lane 10 r + g
// holds row r's genotype g (lanes 30-31 and the groups past the batch's
// rows repeat its last row and store nothing).
__device__ void batch_tail(const Staged& s, const Batch& b, long long step,
                           const Out& o, int lane) {
    const int r = min(lane / kGt, b.n - 1), g = lane % kGt;
    const bool live = lane / kGt < b.n;
    const int base = (lane / kGt) * kGt;
    const unsigned gmask = lane >= 3 * kGt ? 0xc0000000u : 0x3ffu << base;
    const long long row = b.first + r * step;
    const float lh = b.lh[r][g];
    // ref_gt outside 0..4 is outside the function (the plain version's
    // table lookup raises); clamped here to stay inside the tables
    const int ref = min(max(b.ref[r], 0), kBases);
    const int refc = min(ref, kBases - 1);
    const bool hap = b.hap[r];

    // the genomic and the polymorphic result sets (_result_set)
    double pref = 0.0, comp_g = 0.0, comp_p = 0.0;
    int am_g = 0, am_p = 0;
#pragma unroll
    for (int set = 0; set < 2; ++set) {
        const double pp = __dadd_rn(
            static_cast<double>(lh),
            s.prior[(hap ? 2 : 0) + set][ref * kGt + g]);
        const unsigned long long k = key64(pp);
        const int win = first_max_lane(gmask, true,
                                       static_cast<unsigned>(k >> 32),
                                       static_cast<unsigned>(k), base);
        const double mx = __shfl_sync(kAll, pp, win);
        const double e = exp(__dsub_rn(pp, mx));
        const double p = e / seq_sum10(e, base, b.x, lane);
        const double total = seq_sum10(p, base, b.x, lane);
        const double pmax = __shfl_sync(kAll, p, win);
        const double pr = __shfl_sync(kAll, p, base + refc);
        const double comp = snv::clamp_min(__dsub_rn(total, pmax), 0.0);
        if (set == 0) {
            pref = pr;
            comp_g = comp;
            am_g = win - base;
        } else {
            comp_p = comp;
            am_p = win - base;
        }
    }
    if (live && g == 0) {
        o.g_max[row] = am_g;
        o.p_max[row] = am_p;
    }

    // PLs: f32 (lh - lmax) * -10 over ln 10 in float64; haploid rows
    // normalise against the hom-only max
    const int win = first_max_lane(gmask, !hap || g < kBases, key32(lh), 0u,
                                   base);
    const float lmax = __shfl_sync(kAll, lh, win);
    const float d = __fmul_rn(__fsub_rn(lh, lmax), -10.0f);
    double v = floor(__dadd_rn(static_cast<double>(d) / kLn10, 0.5));
    v = snv::is_nan(v) ? v : fmin(fmax(v, 0.0), 999.0);
    if (live) o.pl[row * kGt + g] = snv::to_i32(v);

    // the phreds and ln of the ref posterior on the lanes that own them:
    // lane 3 i + j, j = 0, 1, 2: row i's snv_qphred, genome_max_gt_qphred,
    // poly_max_gt_qphred; lane 9 + i: row i's ln_ref_pprob
    const int i = lane < 3 * kBatch ? lane / 3 : min(lane - 3 * kBatch,
                                                     kBatch - 1);
    const int j = lane % 3;
    const double x_ref = __shfl_sync(kAll, pref, i * kGt);
    const double x_g = __shfl_sync(kAll, comp_g, i * kGt);
    const double x_p = __shfl_sync(kAll, comp_p, i * kGt);
    const long long row_i = b.first + i * step;
    if (lane < 3 * b.n) {
        const int q = snv::to_i32(phred10(j == 0 ? x_ref
                                          : (j == 1 ? x_g : x_p)));
        int* out = j == 0 ? o.snv_q : (j == 1 ? o.g_qmax : o.p_qmax);
        out[row_i] = q;
    } else if (lane >= 3 * kBatch && lane < 3 * kBatch + b.n) {
        o.ln_ref[row_i] = log(snv::clamp_min(x_ref, snv::kF64Tiny));
    }
}

// row i of the warp's batch: its lhoods (lanes 0-9: genotype g = lane),
// ref_gt and is_haploid; the lhoods are stored as they come
__device__ __forceinline__ void stage_row(Batch& b, int i, float lh,
                                          const RowVals& v, long long row,
                                          const Out& o, int lane) {
    if (lane < kGt) {
        o.lhood[row * kGt + lane] = lh;
        b.lh[i][lane] = lh;
    }
    if (lane == 0) {
        b.ref[i] = v.ref;
        b.hap[i] = v.hap;
    }
}

// the launch entries' pointers as the kernels take them
inline Tables tables(const void* qtab, const void* e0,
                     const void* prior_genome, const void* prior_poly,
                     const void* prior_genome_haploid,
                     const void* prior_poly_haploid) {
    return Tables{static_cast<const float*>(qtab),
                  static_cast<const float*>(e0),
                  {static_cast<const double*>(prior_genome),
                   static_cast<const double*>(prior_poly),
                   static_cast<const double*>(prior_genome_haploid),
                   static_cast<const double*>(prior_poly_haploid)}};
}

inline Out outputs(void* lhood, void* g_max, void* p_max, void* snv_q,
                   void* g_qmax, void* p_qmax, void* pl, void* ln_ref) {
    return Out{static_cast<float*>(lhood), static_cast<int*>(g_max),
               static_cast<int*>(p_max), static_cast<int*>(snv_q),
               static_cast<int*>(g_qmax), static_cast<int*>(p_qmax),
               static_cast<int*>(pl), static_cast<double*>(ln_ref)};
}

inline Row row_inputs(const void* ref_gt, const void* hap, const void* s_mis) {
    return Row{static_cast<const int*>(ref_gt),
               static_cast<const uint8_t*>(hap),
               static_cast<const float*>(s_mis)};
}

}  // namespace snv_tile
