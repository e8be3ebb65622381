// KG-SB: the germline strand-bias tile, on Hopper (sm_90a).
//
// Replaces strelka_tpu/models/snv_digt.py:457 snv_strand_bias_tile, a
// jitted XLA program (no Pallas), whose plain version in the port is
// models/snv_digt.snv_strand_bias_tile_plain: hundreds of torch ops a
// call that follow XLA's CPU arithmetic (per-call values from host
// tables, its sum orders, Cephes' exp and log). This kernel gives that
// version's bits in one launch. Per SNP row, with tgt its genome max
// genotype and each strand's forced calls (the other strand's, scored
// against the reference genotype; position_snp_call_pprob_digt.cpp:
// 356-361, 520-534):
//
//   vals[k] = call_vals[q][k], vals[0] + dep_delta       (q = clamp(qual))
//   ws[m] = sum over the free calls of [base == m / 3] * vals[m % 3]
//           (12 sums, m = obs * 3 + k; _sb_free_small, XLA's windows)
//   fs = sum over the forced calls of vals[EXPECT2[ref, base]]
//                                                       (xla_sum_minor)
//   lh = (a0 + a1) + (a2 + a3) + fs, a_j the chain of ws[m] * T12[m, tgt]
//        over m = j (mod 4)
//   RNA mode, tgt a het: lh = logsumexp(lh, the 2 n_steps het-VF sums of
//        tgt, forced calls keyed against the reference) - ln(1 + 2
//        n_steps)                               (_het_vf_combine)
//   out = max(lh_fwd, lh_rev) - lt
//
// Only tgt's column is computed: the plain version gathers it, and each
// genotype's column is its own.
//
// Bound on the H100: the bytes, some 9 a call (base, int16 qual, strand,
// mask, the f32 delta) and 16 a row; a 4 Mb germline run's calls have
// 512 rows at D = 64, a third of a megabyte, so the launch and one row's
// chain of dependent sums on its warp decide the time.
//
// Design (simple, right first): one warp a row, eight warps a block, the
// blocks walking rows. A strand's sums are items, one to a lane (2 x 13
// a row, 2 x (13 + 2 n_steps) where tgt is a het in RNA mode, in passes
// of 32). The warp stages the row's calls a window of 32 at a time in
// shared memory (lane l loads call l of the window, coalesced), then
// each lane adds its item's terms of the window in order and folds the
// window's sum into XLA's upper levels (csrc/snv_xla_math.cuh,
// row_sums); at D <= 32 each lane feeds its item's terms, one at a time,
// into its vectorized order (SmallSum). The value tables (call_vals
// [256, 3], the het-VF table [n_steps, 4, 256] with rows a float apart)
// are staged once a block; lanes 0 and 1 then take the T12 chains and the
// logsumexp of strands 0 and 1. Products that meet a sum are __fmul_rn,
// sums __fadd_rn (csrc/snv_math.cuh's rules).
#include <cuda_runtime.h>

#include <cstdint>

#include "snv_math.cuh"
#include "snv_xla_math.cuh"

namespace {

using namespace snv_xla;

constexpr int kWarps = 8;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kOwn = 13;          // a strand's 12 free sums and forced sum

// a sum of the row: its strand and its role (0-11 the free sums, 12 the
// forced sum, then the het-VF sums, high and low ratio by step)
struct SbItem {
    int strand, role;
};

struct Lanes {
    const int8_t* base;
    const uint8_t* fwd;
    const uint8_t* mask;
    const float* dep;             // [L, D] or null
    long long D;
};

// T12[m, g]: 1 where EXPECT2[g, obs] == k for m = obs * 3 + k
__device__ __forceinline__ float t12(int m, int g) {
    return expect2(g, m / 3) == m % 3 ? 1.0f : 0.0f;
}

// items a strand: its 13 own sums, then its het-VF sums where tgt is a het
__device__ __forceinline__ int strand_items(int g, int n_steps) {
    return kOwn + (n_steps > 0 && g >= 4 ? 2 * n_steps : 0);
}

template <typename Q>
__global__ void __launch_bounds__(kWarps * 32)
snv_strand_bias_kernel(Lanes in, const Q* __restrict__ qual,
                       const int* __restrict__ ref_gt,
                       const int* __restrict__ tgt,
                       const float* __restrict__ lt,
                       const float* __restrict__ vals,
                       const float* __restrict__ het, int n_steps,
                       int res_stride, long long L, float* __restrict__ out) {
    __shared__ float cv_s[kVals * 3];
    __shared__ Calls calls_s[kWarps];
    extern __shared__ __align__(16) float dyn_s[];
    for (int i = threadIdx.x; i < kVals * 3; i += blockDim.x)
        cv_s[i] = vals[i];
    stage_het(dyn_s, het, n_steps);
    __syncthreads();
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    Calls& c = calls_s[w];
    float* res = dyn_s + n_steps * 4 * kHetStride + w * res_stride;
    const float* het_s = dyn_s;
    const bool dep = in.dep != nullptr;
    const Windows win(in.D);
    const long long step = static_cast<long long>(gridDim.x) * kWarps;
    for (long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
         row < L; row += step) {
        const int refc = min(max(ref_gt[row], 0), 3);
        const int g = min(max(tgt[row], 0), 9);
        const int per = strand_items(g, n_steps);
        const long long off = row * in.D;
        auto load = [&](long long p0, int n, bool) {
            if (lane < n) {
                const long long i = off + p0 + lane;
                c.b[lane] = in.base[i];
                c.q[lane] = static_cast<uint8_t>(qual255(qual[i]));
                c.mf[lane] = (in.mask[i] ? 1 : 0) | (in.fwd[i] ? 2 : 0);
                c.dd[lane] = dep ? in.dep[i] : 0.0f;
            }
        };
        // item it: strand it / per's sum it % per
        auto prep = [&](int it) { return SbItem{it / per, it % per}; };
        auto variant = [&](int it) {
            return it % per < 12 ? sb_free_variant(in.D) : minor_variant(in.D);
        };
        auto term = [&](const SbItem& d, int i) -> float {
            const int b = c.b[i], q = c.q[i];
            const bool m = c.mf[i] & 1, f = c.mf[i] & 2;
            const bool force = d.strand == 0 ? !f : f;
            const int k = d.role;
            if (k < 12) {       // a free sum: [base == obs] vals[k % 3]
                float v = cv_s[q * 3 + k % 3];
                if (dep && k % 3 == 0) v = __fadd_rn(v, c.dd[i]);
                return __fmul_rn(__fmul_rn(b == k / 3 ? 1.0f : 0.0f, v),
                                 !force && m ? 1.0f : 0.0f);
            }
            const int bi = bias_index(b);
            if (k == 12) {      // the forced sum
                const int kf = expect2(refc, bi);
                float v = cv_s[q * 3 + kf];
                if (dep && kf == 0) v = __fadd_rn(v, c.dd[i]);
                return __fmul_rn(v, force && m ? 1.0f : 0.0f);
            }
            const int s = (k - kOwn) >> 1;   // a het-VF sum
            int key = expect2_bias(force ? refc : g, bi);
            if ((k - kOwn) & 1) key = low_key(key);
            float v = het_s[(s * 4 + key) * kHetStride + q];
            if (dep && key == 0) v = __fadd_rn(v, c.dd[i]);
            return m ? v : 0.0f;
        };
        row_sums(win, 2 * per, lane, load, prep, term, variant, res);
        __syncwarp();
        float lh = 0.0f;
        if (lane < 2) {      // strand `lane`'s lhood of tgt
            const float* ws = res + lane * per;
            float a[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                a[j] = __fmul_rn(ws[j], t12(j, g));
                a[j] = __fadd_rn(a[j], __fmul_rn(ws[j + 4], t12(j + 4, g)));
                a[j] = __fadd_rn(a[j], __fmul_rn(ws[j + 8], t12(j + 8, g)));
            }
            lh = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]),
                                     __fadd_rn(a[2], a[3])), ws[12]);
            if (per > kOwn) lh = het_combine(lh, ws + kOwn, n_steps);
        }
        const float rev = __shfl_sync(kAll, lh, 1);
        if (lane == 0) {    // torch.maximum: a NaN wins
            const float mx = snv::is_nan(lh) ? lh
                             : (snv::is_nan(rev) ? rev : fmaxf(lh, rev));
            out[row] = __fsub_rn(mx, lt[row]);
        }
        __syncwarp();       // the results and the calls are rewritten
    }
}

template <typename Q>
int launch(long long L, int n_steps, void* stream, Lanes in, const Q* qual,
           const void* ref_gt, const void* tgt, const void* lt,
           const void* vals, const void* het, void* out) {
    if (n_steps < 0 || n_steps > kMaxSteps || in.D < 0 || in.D > kMaxDepth)
        return static_cast<int>(cudaErrorInvalidValue);
    const int res_stride = (2 * (kOwn + 2 * n_steps) + 1) & ~1;
    const size_t dyn = sizeof(float) * (static_cast<size_t>(n_steps) * 4
                                        * kHetStride
                                        + kWarps * res_stride);
    auto kernel = snv_strand_bias_kernel<Q>;
    cudaError_t err = allow_dynamic(kernel, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = snv::resident_blocks(
        kernel, kWarps * 32, (L + kWarps - 1) / kWarps);
    kernel<<<static_cast<unsigned>(blocks), kWarps * 32, dyn,
             static_cast<cudaStream_t>(stream)>>>(
        in, qual, static_cast<const int*>(ref_gt),
        static_cast<const int*>(tgt), static_cast<const float*>(lt),
        static_cast<const float*>(vals), static_cast<const float*>(het),
        n_steps, res_stride, L, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// base [L, D] int8, qual [L, D] uint8 (qual_bytes 1) or int16 (2), fwd
// and mask [L, D] bool, D in 0 .. 2^20; ref_gt, tgt [L] int32 (ref_gt in
// 0..4, tgt in 0..9), lt [L] f32, dep [L, D] f32 or null; vals [256, 3]
// f32 (_call_vals_table), het [n_steps, 4, 256] f32 (_het_vf_table) or
// null with n_steps 0 (no het-VF extension), n_steps <= 40; all
// contiguous on one device, L >= 1. Out: [L] f32. Launches on `stream`;
// returns cudaGetLastError() (or an invalid-value error for operands
// out of range).
int snv_strand_bias_tile_launch(const void* base, const void* qual,
                                int qual_bytes, const void* fwd,
                                const void* mask, long long D,
                                const void* ref_gt, const void* tgt,
                                const void* lt, const void* dep,
                                const void* vals, const void* het,
                                int n_steps, long long L, void* out,
                                void* stream) {
    const Lanes in{static_cast<const int8_t*>(base),
                   static_cast<const uint8_t*>(fwd),
                   static_cast<const uint8_t*>(mask),
                   static_cast<const float*>(dep), D};
    if (qual_bytes == 1)
        return launch(L, n_steps, stream, in,
                      static_cast<const uint8_t*>(qual), ref_gt, tgt, lt,
                      vals, het, out);
    if (qual_bytes == 2)
        return launch(L, n_steps, stream, in,
                      static_cast<const int16_t*>(qual), ref_gt, tgt, lt,
                      vals, het, out);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
