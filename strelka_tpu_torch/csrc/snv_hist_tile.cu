// KG-H: the germline SNV genotype tile from a (qscore, base) histogram, on
// Hopper (sm_90a).
//
// Replaces strelka_tpu/models/snv_digt.py:506 call_snv_hist_tile, a jitted
// XLA program (no Pallas), whose plain version in the port is
// models/snv_digt.call_snv_hist_tile_plain: hundreds of launches a tile,
// one exactly emulated f32 FMA per live slot of 512, then the float64
// posterior tail. This kernel gives that version's bits in one launch. Per
// row of hist [L, 512] (int8 or int32 counts):
//
//   lhood[g] = fma(count_k, qtab[k, g], lhood[g]) for k = 0..511 ascending
//              (a zero count adds exactly nothing: the table is finite)
//   lhood[g] += sum_b s_mis[b] * e0[b, g]   (b ascending, then one add)
//
// then the genomic and the polymorphic result sets (float64 posterior with
// sequential 10-wide sums, first argmax, the ref and the max-genotype
// phreds, ln of the ref posterior) and the ten PLs, whose f32 (lhood -
// lmax) * -10 is divided by ln 10 in float64.
//
// Bound on the H100: the histogram is read once (512 bytes a row as int8)
// and 240 bytes a row are written, against 5,120 f32 FMAs and some 60
// float64 operations a row, so the card could do it at its HBM rate.
//
// Design: a block takes R rows and 10 R threads; the rows' histograms (one
// contiguous piece of memory) and the [512, 10] table are staged in shared
// memory with 16-byte loads, each thread runs one genotype's chain of 512
// __fmaf_rn in registers, and one thread a row runs the tail. The rows of
// the staged histogram are padded by 16 bytes, so the threads of one warp,
// which read the same slot of 3 or 4 rows, hit different banks. int8
// counts take 32 rows a block, int32 counts 8, which keeps the static
// shared memory under 48 KB.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "snv_math.cuh"

namespace {

constexpr int kSlots = 512;      // _SNV_QTAB_SIZE * 4
constexpr int kGt = 10;          // genotypes
constexpr int kBases = 4;
constexpr int kRowPad = 16;      // bytes after each staged row
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

// -10 log10(max(x, tiny)) + 0.5, floored, at most 999 (as torch runs it)
__device__ __forceinline__ double phred10(double x) {
    const double lg = log10(snv::clamp_min(x, snv::kF64Tiny));
    return snv::clamp_max(floor(__dadd_rn(__dmul_rn(-10.0, lg), 0.5)),
                          999.0);
}

// _result_set: posterior, first argmax, ref and max-genotype phreds, ln ref
__device__ void result_set(const float* lh, const double* prior, int refc,
                           int* max_gt, int* q_ref, int* q_max,
                           double* ln_ref) {
    double pp[kGt], p[kGt];
    double mx = -INFINITY;
    for (int g = 0; g < kGt; ++g) {
        pp[g] = __dadd_rn(static_cast<double>(lh[g]), prior[g]);
        mx = snv::nan_max(mx, pp[g]);
    }
    for (int g = 0; g < kGt; ++g) p[g] = exp(__dsub_rn(pp[g], mx));
    double s = p[0];
    for (int g = 1; g < kGt; ++g) s = __dadd_rn(s, p[g]);
    for (int g = 0; g < kGt; ++g) p[g] = p[g] / s;
    const int am = snv::arg_max(pp, kGt);
    double total = p[0];
    for (int g = 1; g < kGt; ++g) total = __dadd_rn(total, p[g]);
    const double comp = snv::clamp_min(__dsub_rn(total, p[am]), 0.0);
    *max_gt = am;
    *q_ref = snv::to_i32(phred10(p[refc]));
    *q_max = snv::to_i32(phred10(comp));
    if (ln_ref) *ln_ref = log(snv::clamp_min(p[refc], snv::kF64Tiny));
}

__device__ void tile_tail(const float* lh, int ref, bool hap,
                          const Tables& t, long long row, const Out& o) {
    // ref_gt outside 0..4 is outside the function (the plain version's
    // table lookup raises); clamped here to stay inside the tables
    ref = min(max(ref, 0), kBases);
    const int refc = min(ref, kBases - 1);
    const double* gp = t.prior[hap ? 2 : 0] + ref * kGt;
    const double* pp = t.prior[hap ? 3 : 1] + ref * kGt;
    int q_unused;
    result_set(lh, gp, refc, o.g_max + row, o.snv_q + row, o.g_qmax + row,
               o.ln_ref + row);
    result_set(lh, pp, refc, o.p_max + row, &q_unused, o.p_qmax + row,
               nullptr);
    // PLs: haploid rows normalise against the hom-only max
    float lmax = -INFINITY;
    for (int g = 0; g < (hap ? kBases : kGt); ++g)
        lmax = snv::nan_max(lmax, lh[g]);
    for (int g = 0; g < kGt; ++g) {
        const float d = __fmul_rn(__fsub_rn(lh[g], lmax), -10.0f);
        double v = floor(__dadd_rn(static_cast<double>(d) / kLn10, 0.5));
        v = snv::is_nan(v) ? v : fmin(fmax(v, 0.0), 999.0);
        o.pl[row * kGt + g] = snv::to_i32(v);
    }
}

template <typename T, int R>
__global__ void __launch_bounds__(R * kGt)
snv_hist_tile_kernel(const T* __restrict__ hist,
                     const int* __restrict__ ref_gt,
                     const uint8_t* __restrict__ hap,
                     const float* __restrict__ s_mis, Tables t,
                     long long L, Out o) {
    constexpr int kRowBytes = kSlots * static_cast<int>(sizeof(T)) + kRowPad;
    constexpr int kPieces = kSlots * static_cast<int>(sizeof(T)) / 16;
    __shared__ __align__(16) unsigned char h_s[R * kRowBytes];
    __shared__ __align__(16) float q_s[kSlots * kGt];
    __shared__ float lh_s[R * kGt];

    const int tid = threadIdx.x;
    const long long row0 = static_cast<long long>(blockIdx.x) * R;
    const int nrows = static_cast<int>(min(static_cast<long long>(R),
                                           L - row0));
    const uint4* q4 = reinterpret_cast<const uint4*>(t.qtab);
    for (int i = tid; i < kSlots * kGt / 4; i += blockDim.x)
        reinterpret_cast<uint4*>(q_s)[i] = q4[i];
    const uint4* h4 = reinterpret_cast<const uint4*>(hist + row0 * kSlots);
    for (int i = tid; i < nrows * kPieces; i += blockDim.x) {
        const int r = i / kPieces, piece = i % kPieces;
        *reinterpret_cast<uint4*>(h_s + r * kRowBytes + piece * 16) = h4[i];
    }
    __syncthreads();

    const int r = tid / kGt, g = tid % kGt;
    if (r < nrows) {
        const T* h = reinterpret_cast<const T*>(h_s + r * kRowBytes);
        float lh = 0.0f;
#pragma unroll 8
        for (int k = 0; k < kSlots; ++k)
            lh = __fmaf_rn(static_cast<float>(h[k]), q_s[k * kGt + g], lh);
        if (s_mis) {
            const float* s = s_mis + (row0 + r) * kBases;
            float m = 0.0f;
            for (int b = 0; b < kBases; ++b)
                m = __fadd_rn(m, __fmul_rn(s[b], t.e0[b * kGt + g]));
            lh = __fadd_rn(lh, m);
        }
        lh_s[r * kGt + g] = lh;
        o.lhood[(row0 + r) * kGt + g] = lh;
    }
    __syncthreads();
    if (tid < nrows) {
        const long long row = row0 + tid;
        tile_tail(lh_s + tid * kGt, ref_gt[row], hap && hap[row], t, row, o);
    }
}

template <typename T, int R>
int launch(const void* hist, const void* ref_gt, const void* hap,
           const void* s_mis, const Tables& t, long long L, const Out& o,
           void* stream) {
    const long long blocks = (L + R - 1) / R;
    snv_hist_tile_kernel<T, R><<<static_cast<unsigned>(blocks), R * kGt, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(hist), static_cast<const int*>(ref_gt),
        static_cast<const uint8_t*>(hap), static_cast<const float*>(s_mis),
        t, L, o);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// hist [L, 512] int8 (hist_bytes 1) or int32 (hist_bytes 4), 16-byte
// aligned; ref_gt [L] int32 in 0..4; hap [L] bool or null; s_mis [L, 4] f32
// or null; qtab [512, 10] f32 (16-byte aligned), e0 [4, 10] f32, the four
// [5, 10] float64 ln prior tables (genome, poly, genome_haploid,
// poly_haploid); all contiguous on one device, L >= 1. Out: lhood [L, 10]
// f32, genome_max_gt, poly_max_gt, snv_qphred, genome_max_gt_qphred,
// poly_max_gt_qphred [L] int32, phred_loghood [L, 10] int32, ln_ref_pprob
// [L] float64. Launches on `stream`; returns cudaGetLastError().
int snv_hist_tile_launch(const void* hist, int hist_bytes,
                         const void* ref_gt, const void* hap,
                         const void* s_mis, const void* qtab,
                         const void* e0, const void* prior_genome,
                         const void* prior_poly,
                         const void* prior_genome_haploid,
                         const void* prior_poly_haploid, long long L,
                         void* lhood, void* g_max, void* p_max, void* snv_q,
                         void* g_qmax, void* p_qmax, void* pl, void* ln_ref,
                         void* stream) {
    const Tables t{static_cast<const float*>(qtab),
                   static_cast<const float*>(e0),
                   {static_cast<const double*>(prior_genome),
                    static_cast<const double*>(prior_poly),
                    static_cast<const double*>(prior_genome_haploid),
                    static_cast<const double*>(prior_poly_haploid)}};
    const Out o{static_cast<float*>(lhood), static_cast<int*>(g_max),
                static_cast<int*>(p_max), static_cast<int*>(snv_q),
                static_cast<int*>(g_qmax), static_cast<int*>(p_qmax),
                static_cast<int*>(pl), static_cast<double*>(ln_ref)};
    if (hist_bytes == 1)
        return launch<int8_t, 32>(hist, ref_gt, hap, s_mis, t, L, o, stream);
    if (hist_bytes == 4)
        return launch<int32_t, 8>(hist, ref_gt, hap, s_mis, t, L, o, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
