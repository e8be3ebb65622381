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
//   ws[m] = sum over the calls of ([base == m / 3] vals[m % 3]) [free]
//           (12 sums, m = obs * 3 + k; _sb_free_small, XLA's windows)
//   fs = sum over the calls of vals[EXPECT2[ref, base]] [forced]
//                                                       (xla_sum_minor)
//   lh = (a0 + a1) + (a2 + a3) + fs, a_j the chain of ws[m] * T12[m, tgt]
//        over m = j (mod 4)
//   RNA mode, tgt a het: lh = logsumexp(lh, the 2 n_steps het-VF sums of
//        tgt, forced calls keyed against the reference) - ln(1 + 2
//        n_steps)                               (_het_vf_combine)
//   out = max(lh_fwd, lh_rev) - lt
//
// Only tgt's column is computed: the plain version gathers it, and each
// genotype's column is its own. A free or forced sum's term is the plain
// product: the value where the call counts, else the value times 0 (a
// signed zero, NaN for an infinite value).
//
// Bound on the H100: the bytes, some 9 a call (base, int16 qual, strand,
// mask, the f32 delta) and 16 a row; a germline run's calls have 512
// rows at D = 64, a third of a megabyte, so the launch and one row's
// chain of dependent sums decide the time.
//
// Design: one warp a row, four warps a block, the grid as many blocks as
// the rows need (the card holds them all at once at the CLI's 512 rows),
// so that a call's rows spread over the SMs. A strand's sums are items,
// strand-major (13 a strand, 13 + 2 n_steps where tgt is a het in RNA
// mode), two to a lane in passes of 64. The warp walks the row's calls a
// window of 32 at a time (walk, csrc/snv_xla_math.cuh): lane l fetches
// call l of the next window into registers while the current one is
// summed, then decodes it once into a row of values in shared memory
// (the three values, their products by 0, the het-VF mismatch value plus
// its delta, v3 and each step's key 1 and 2 values, the het-VF ones +0
// for a call masked out), read from the tables in global memory, and a
// word of its bias index and its class (used, strand, base). An item
// keeps two column maps (where the call counts for it, and where not) and
// the set of classes that count, fixed once a row, so that a term is a
// bit test, a select, a byte select, one shared read and one add. Lanes 0
// and 1 then take the T12 chains of strands 0 and 1 and the logsumexp's
// exps are spread over the lanes (lse_spread). Products that meet a sum
// are __fmul_rn, sums __fadd_rn (csrc/snv_math.cuh's rules).
#include <cuda_runtime.h>

#include <cstdint>

#include "snv_math.cuh"
#include "snv_xla_math.cuh"

namespace {

using namespace snv_xla;

constexpr int kWarps = 4;
constexpr int kPer = 2;             // items a lane in a pass
constexpr int kPass = 32 * kPer;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kOwn = 13;          // a strand's 12 free sums and forced sum
// the columns of a call's row: vals[0..2] (the delta on vals[0]), each
// times 0, the het-VF mismatch value plus the delta, v3, then each step's
// key 1 and key 2 values
constexpr int kZ = 3, kH0 = 6, kH3 = 7, kHStep = 8;
constexpr int kScratch = 4;       // the logsumexp's x0s and maxima

struct Lanes {
    const int8_t* base;
    const uint8_t* fwd;
    const uint8_t* mask;
    const float* dep;             // [L, D] or null
    long long D;
};

// A window's call as a lane fetches it
struct Call {
    int b, q;
    bool m, f;
    float dd;
};

// An item: its column maps (byte bi: the column for bias index bi) where
// the call counts for it (t) and where not (f), and the classes that
// count (bit c: call class c)
struct Item {
    unsigned t, f, count;
};

// A call's class: 0 unused, 1 + is_fwd used; plus 3 x (its base where 0
// to 3, else 4)
__device__ __forceinline__ int call_class(const Call& c) {
    return (c.m ? 1 + c.f : 0) + 3 * (c.b >= 0 && c.b < 4 ? c.b : 4);
}

// the classes of the used calls of strand bit fs (1: forward), any base
__device__ __forceinline__ unsigned used_classes(int fs) {
    unsigned bits = 0;
#pragma unroll
    for (int b = 0; b < 5; ++b) bits |= 1u << (1 + fs + 3 * b);
    return bits;
}

// T12[m, g]: 1 where EXPECT2[g, obs] == k for m = obs * 3 + k
__device__ __forceinline__ float t12(int m, int g) {
    return expect2(g, m / 3) == m % 3 ? 1.0f : 0.0f;
}

// items a strand: its 13 own sums, then its het-VF sums where tgt is a het
__device__ __forceinline__ int strand_items(int g, int n_steps) {
    return kOwn + (n_steps > 0 && g >= 4 ? 2 * n_steps : 0);
}

// het-VF key `key` at step st, r = 1 the low ratio: its column
__device__ __forceinline__ unsigned het_col(int key, int r, int st) {
    if (r) key = low_key(key);
    return key == 0 ? kH0 : (key == 3 ? kH3 : kHStep + 2 * st + key - 1);
}

// item `role` of strand `strand` (0 counts the forward calls free, the
// reverse ones forced against refc; 1 the other way round), tgt g
__device__ __forceinline__ Item make_item(int strand, int role, int refc,
                                          int g) {
    Item it{0, 0, 0};
    const int fs = strand == 0 ? 1 : 0;    // the strand of its free calls
    if (role < 12) {          // [base == obs] vals[k] over the free calls
        const int obs = role / 3, k = role % 3;
        it.t = 0x01010101u * k;
        it.f = 0x01010101u * (kZ + k);
        it.count = 1u << (1 + fs + 3 * obs);
        return it;
    }
    it.count = used_classes(1 - fs);       // the forced calls
#pragma unroll
    for (int bi = 0; bi < 4; ++bi) {
        if (role == 12) {     // vals[EXPECT2[ref, base]] over the forced
            const unsigned kf = expect2(refc, bi);
            it.t |= kf << 8 * bi;
            it.f |= (kZ + kf) << 8 * bi;
        } else {              // a het-VF sum: forced calls keyed on refc
            const int st = (role - kOwn) >> 1, r = (role - kOwn) & 1;
            it.t |= het_col(expect2_bias(refc, bi), r, st) << 8 * bi;
            it.f |= het_col(expect2_bias(g, bi), r, st) << 8 * bi;
        }
    }
    return it;
}

template <typename Q, bool kSmall>
__global__ void __launch_bounds__(kWarps * 32)
snv_strand_bias_kernel(Lanes in, const Q* __restrict__ qual,
                       const int* __restrict__ ref_gt,
                       const int* __restrict__ tgt,
                       const float* __restrict__ lt,
                       const float* __restrict__ vals,
                       const float* __restrict__ het, int n_steps,
                       int rs, int stride, long long L,
                       float* __restrict__ out) {
    extern __shared__ __align__(16) float dyn_s[];
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* res = dyn_s + w * stride;
    const int n_res = 2 * (kOwn + 2 * n_steps);
    float* x0s = res + ((n_res + 1) & ~1);
    float* mxs = x0s + kScratch / 2;
    unsigned* cw_s = reinterpret_cast<unsigned*>(x0s + kScratch);
    float* rows = x0s + kScratch + 32;
    const bool dep = in.dep != nullptr;
    const Windows win(in.D);
    const long long step = static_cast<long long>(gridDim.x) * kWarps;
    for (long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
         row < L; row += step) {
        const int refc = min(max(ref_gt[row], 0), 3);
        const int g = min(max(tgt[row], 0), 9);
        const int per = strand_items(g, n_steps);
        const bool hets = per > kOwn;
        const long long off = row * in.D;
        for (int it0 = 0; it0 < 2 * per; it0 += kPass) {
            Item item[kPer];
#pragma unroll
            for (int k = 0; k < kPer; ++k) {
                const int it = it0 + 32 * k + lane;
                item[k] = it < 2 * per ? make_item(it / per, it % per, refc, g)
                                       : Item{0, 0, 0};
            }
            auto fetch = [&](long long p0, int n) {
                Call c{0, 0, false, false, 0.0f};
                if (lane < n) {
                    const long long i = off + p0 + lane;
                    c.b = in.base[i];
                    c.q = qual255(qual[i]);
                    c.m = in.mask[i];
                    c.f = in.fwd[i];
                    if (dep) c.dd = in.dep[i];
                }
                return c;
            };
            auto commit = [&](const Call& c, int n) {
                if (lane >= n) return;
                float* r = rows + lane * rs;
                const float* cv = vals + c.q * 3;
                float v0 = __ldg(cv);
                if (dep) v0 = __fadd_rn(v0, c.dd);
                const float v1 = __ldg(cv + 1), v2 = __ldg(cv + 2);
                r[0] = v0;
                r[1] = v1;
                r[2] = v2;
                r[kZ] = __fmul_rn(v0, 0.0f);
                r[kZ + 1] = __fmul_rn(v1, 0.0f);
                r[kZ + 2] = __fmul_rn(v2, 0.0f);
                if (hets) {
                    const float* hq = het + c.q;
                    float h0 = __ldg(hq);
                    if (dep) h0 = __fadd_rn(h0, c.dd);
                    const float h3 = __ldg(hq + 3 * kVals);
                    r[kH0] = c.m ? h0 : 0.0f;
                    r[kH3] = c.m ? h3 : 0.0f;
                    for (int st = 0; st < n_steps; ++st) {
                        const float k1 = __ldg(hq + (st * 4 + 1) * kVals);
                        const float k2 = __ldg(hq + (st * 4 + 2) * kVals);
                        r[kHStep + 2 * st] = c.m ? k1 : 0.0f;
                        r[kHStep + 2 * st + 1] = c.m ? k2 : 0.0f;
                    }
                }
                cw_s[lane] = byte_sel(bias_index(c.b))
                             | static_cast<unsigned>(call_class(c)) << 16;
            };
            auto term = [&](int i, float (&x)[kPer]) {
                const unsigned cw = cw_s[i];
                const float* r = rows + i * rs;
#pragma unroll
                for (int k = 0; k < kPer; ++k) {
                    const unsigned map = (item[k].count >> (cw >> 16)) & 1u
                        ? item[k].t : item[k].f;
                    x[k] = r[__byte_perm(map, 0, cw)];
                }
            };
            auto variant = [&](int k) {
                return (it0 + 32 * k + lane) % per < 12
                    ? sb_free_variant(in.D) : minor_variant(in.D);
            };
            float sums[kPer];
            walk<kPer, kSmall>(win, fetch, commit, term, variant, sums);
#pragma unroll
            for (int k = 0; k < kPer; ++k)
                if (it0 + 32 * k + lane < 2 * per)
                    res[it0 + 32 * k + lane] = sums[k];
        }
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
        }
        if (hets)
            lh = lse_spread(
                lh, lane < 2 ? lane : -1, 2, 2 * n_steps,
                [&](int c, int k) { return res + c * per + kOwn + k; },
                x0s, mxs, lane);
        const float rev = __shfl_sync(kAll, lh, 1);
        if (lane == 0) {    // torch.maximum: a NaN wins
            const float mx = snv::is_nan(lh) ? lh
                             : (snv::is_nan(rev) ? rev : fmaxf(lh, rev));
            out[row] = __fsub_rn(mx, lt[row]);
        }
        __syncwarp();       // the results are rewritten
    }
}

// A call row's floats (odd: a lane's writes of one column fall in
// distinct banks) and a warp's share of the dynamic shared memory: the
// row's sums, the scratch, the class words and 32 call rows
int row_floats(int n_steps) {
    return (n_steps ? kHStep + 2 * n_steps : kH0) | 1;
}

int warp_floats(int n_steps) {
    return ((2 * (kOwn + 2 * n_steps) + 1) & ~1) + kScratch + 32
           + 32 * row_floats(n_steps);
}

template <typename Q, bool kSmall>
cudaError_t grid(long long L, int n_steps, long long* blocks,
                 long long* per_sm) {
    auto kernel = snv_strand_bias_kernel<Q, kSmall>;
    const size_t dyn = sizeof(float) * kWarps * warp_floats(n_steps);
    cudaError_t err = allow_dynamic(kernel, dyn);
    if (err != cudaSuccess) return err;
    *blocks = snv::resident_blocks(kernel, kWarps * 32,
                                   (L + kWarps - 1) / kWarps, dyn);
    if (per_sm) {
        int n = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, kWarps * 32, dyn);
        *per_sm = n;
    }
    return err;
}

template <typename Q, bool kSmall>
int launch(long long L, int n_steps, void* stream, Lanes in, const Q* qual,
           const void* ref_gt, const void* tgt, const void* lt,
           const void* vals, const void* het, void* out) {
    long long blocks = 0;
    const cudaError_t err = grid<Q, kSmall>(L, n_steps, &blocks, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    snv_strand_bias_kernel<Q, kSmall>
        <<<static_cast<unsigned>(blocks), kWarps * 32,
           sizeof(float) * kWarps * warp_floats(n_steps),
           static_cast<cudaStream_t>(stream)>>>(
        in, qual, static_cast<const int*>(ref_gt),
        static_cast<const int*>(tgt), static_cast<const float*>(lt),
        static_cast<const float*>(vals), static_cast<const float*>(het),
        n_steps, row_floats(n_steps), warp_floats(n_steps), L,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename Q>
int launch(long long L, int n_steps, void* stream, Lanes in, const Q* qual,
           const void* ref_gt, const void* tgt, const void* lt,
           const void* vals, const void* het, void* out) {
    if (n_steps < 0 || n_steps > kMaxSteps || in.D < 0 || in.D > kMaxDepth)
        return static_cast<int>(cudaErrorInvalidValue);
    return in.D <= 32
        ? launch<Q, true>(L, n_steps, stream, in, qual, ref_gt, tgt, lt,
                          vals, het, out)
        : launch<Q, false>(L, n_steps, stream, in, qual, ref_gt, tgt, lt,
                           vals, het, out);
}

}  // namespace

extern "C" {

// base [L, D] int8, qual [L, D] uint8 (qual_bytes 1) or int16 (2), fwd
// and mask [L, D] bool, D in 0 .. 2^20; ref_gt, tgt [L] int32 (ref_gt in
// 0..4, tgt in 0..9), lt [L] f32, dep [L, D] f32 or null; vals [256, 3]
// f32 (_call_vals_table), het [n_steps, 4, 256] f32 (_het_vf_table: its
// key 0 and key 3 values the same at every step, as it builds them) or
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

// The grid snv_strand_bias_tile_launch takes for L rows at n_steps and D
// (int16 qual): out[0] its blocks, out[1] the blocks an SM holds by the
// occupancy API with the launch's dynamic shared memory, out[2] the SMs.
// Returns a CUDA error code (0 on success).
int snv_strand_bias_tile_grid(long long L, int n_steps, long long D,
                              long long* out) {
    if (n_steps < 0 || n_steps > kMaxSteps || L < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = D <= 32
        ? grid<int16_t, true>(L, n_steps, out, out + 1)
        : grid<int16_t, false>(L, n_steps, out, out + 1);
    int dev = 0, sms = 0;
    if (err != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
        return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
    out[2] = sms;
    return 0;
}

}  // extern "C"
