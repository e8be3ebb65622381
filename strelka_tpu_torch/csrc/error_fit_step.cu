// KE-F: the indel error fit's step, on Hopper (sm_90a).
//
// Replaces strelka_tpu/models/error_fit.py:171, the step that
// fit_context jits (jax.value_and_grad of neg_lhood, then optax.adam's
// update: one XLA program a step, no Pallas), whose plain version in the
// port is models/error_fit.fit_step_plain: the loss as dozens of torch
// ops, torch.autograd's backward through them and utils/special.Adam,
// some 437 kernels a step. Two entries:
//
// - error_fit_prep, once a fit: each deduplicated locus's
//   parameter-free values, bit for bit with the plain expressions
//   (models/error_fit.fit_prep_plain): ref_obs, ins_tot, del_tot, the
//   rem_* counts after the first and second most frequent alt slots
//   (first max, as torch.argmax), the parameter-free left prefixes of the
//   hom, het and alt-het sums, the whole clean mixture (it holds no
//   parameter) and the instance count, as 12 rows of N float64 (loc);
// - error_fit_step, once an Adam step: the loss at the state's
//   parameters, -sum(inst * logaddexp(log_clean_locus + clean_mix,
//   log_noisy + noisy_mix)), its gradient in closed form (the chain that
//   torch.autograd takes: the smoother's where, abs's sign with
//   sign(0) = sign(NaN) = 0 and log1p's 1/(1 + x); the log(1 - e - e)
//   and log1p(-e) rates; jnp.logaddexp's custom JVP with +inf replaced
//   by 0; the logsumexp's detached max and abs's sign), then optax's
//   Adam in special.Adam's order (__fma_rn for its three FMAs,
//   __dsqrt_rn, IEEE division, the bias corrections from a table that
//   the host fills with Python's **), then the best-step rule (the first
//   step always kept, a later one on a strict v < best, the parameters
//   after the step kept), all in the state buffer on the card.
//
// The sum over loci runs in one fixed order with no float atomics:
// thread t of block b adds the terms of loci (b * per + i) * 256 + t,
// i = 0..per-1, from 0.0 (a locus past N adds +0.0); a warp folds its
// lanes by xor shuffles (16, 8, 4, 2, 1); thread 0 adds the 8 warps'
// sums in warp order and writes the block's partial; the last block to
// finish, found by an integer ticket, adds the partials in block order
// and runs the scalar chain, Adam and the best-step rule, then sets the
// ticket back to 0. One step is one launch. ops/fit_kernels.fit_step_model
// is this order written in torch ops.
//
// Every elementwise value is the plain version's: products that meet a
// sum are __dmul_rn, sums __dadd_rn/__dsub_rn (nvcc contracts a*b + c
// under its default -fmad=true), and exp, log and log1p are the CUDA math
// library's, built with nvcc's default flags as torch's own kernels are
// (csrc/snv_math.cuh's rules). Only the order of the sums over loci
// differs from the plain version's.
//
// Bound on the H100: a step reads loc once (96 bytes a locus) and does
// 76 float64 operations a locus (7 exps, a log, a log1p and a division
// among them; ops/fit_kernels.F64_PER_LOCUS); at the CLI's contexts (10^2 to 10^5 patterns)
// both take well under a microsecond, so the launch, the ticket and the
// last block's chain decide the time. The design keeps a step to one
// launch with no host read: the host enqueues all of a fit's steps and
// reads the best parameters once.
#include <cuda_runtime.h>

#include <cstring>

#include "snv_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 6;          // loss, d/dli, d/dld, d/dlr, g1, g2
constexpr int kRows = 12;         // loc's rows
constexpr unsigned kAll = 0xffffffffu;

// loc's rows
enum Row {
    kRef, kIns, kDel, kRemIns, kRemDel, kRemIns2, kRemDel2,
    kHomPre, kHetPre, kAltPre, kClean, kInst
};

// The host's doubles, in ops/fit_kernels.CONSTS's order
struct Consts {
    double log_hom_alt, log_hom_ref, log_het, log_clean, log_clean_ref;
    double prior[4];              // hom, het, noindel, althet
    double trig_rate, trig_locus, max_rate, max_locus;
    double lr, b1, b2, omb1, omb2, eps;
};
constexpr int kConsts = 19;
static_assert(sizeof(Consts) == kConsts * sizeof(double), "Consts layout");

// the state buffer's slots (ops/fit_kernels.STATE)
enum Slot {
    kParams = 0, kMu = 3, kNu = 6, kBestV = 9, kBestParams = 10, kV = 13,
    kGrad = 14
};

__device__ __forceinline__ double dmul(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ double dsub(double a, double b) {
    return __dsub_rn(a, b);
}

// torch.sign of a float64: 1, -1, else 0 (a zero or a NaN)
__device__ __forceinline__ double sgn(double x) {
    return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : 0.0);
}

// logsumexp of four terms as special.logsumexp: the max (0 where it is
// not finite), the exps of the differences summed in index order; sets
// e (the exps), s (their sum) and returns log|s| + max
__device__ __forceinline__ double lse4(const double (&t)[4], double (&e)[4],
                                      double& s) {
    double m = snv::nan_max(snv::nan_max(snv::nan_max(t[0], t[1]), t[2]),
                            t[3]);
    m = snv::is_finite(m) ? m : 0.0;
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = exp(dsub(t[k], m));
    s = dadd(dadd(dadd(e[0], e[1]), e[2]), e[3]);
    return dadd(log(fabs(s)), m);
}

// _rate_smoother's values: a, x = a - trigger, b (after the log1p
// branch), d = b - max and the output c
struct Smooth {
    double a, x, b, d, c;
};

__device__ __forceinline__ Smooth smooth(double a, double trig, double mx) {
    Smooth s;
    s.a = a;
    s.x = dsub(a, trig);
    const double l = dadd(log1p(s.x), trig);
    s.b = a > trig ? l : a;
    s.d = dsub(s.b, mx);
    s.c = s.b > mx ? dsub(mx, fabs(s.d)) : s.b;
    return s;
}

// the smoother's input gradient from its output's, g: each where passes
// g to its taken branch and 0 to the other; the fold's branch through
// rsub (-) and abs (* sign(d)); the log1p branch through 1 / (x + 1)
// (0 / 0 = NaN where x = -1, as autograd's)
__device__ __forceinline__ double smooth_grad(const Smooth& s, double trig,
                                              double mx, double g) {
    const bool fold = s.b > mx;
    const double gb = dadd(dmul(-(fold ? g : 0.0), sgn(s.d)),
                           fold ? 0.0 : g);
    const bool up = s.a > trig;
    return dadd((up ? gb : 0.0) / dadd(s.x, 1.0), up ? 0.0 : gb);
}

// the step's parameter-dependent scalars
struct Rates {
    Smooth si, sd, sn;
    double e_li, e_ld, vr, lr, e_ln, u, lcl;
};

__device__ __forceinline__ Rates rates(const double* p, const Consts& c) {
    Rates r;
    r.si = smooth(p[0], c.trig_rate, c.max_rate);
    r.sd = smooth(p[1], c.trig_rate, c.max_rate);
    r.sn = smooth(p[2], c.trig_locus, c.max_locus);
    r.e_li = exp(r.si.c);
    r.e_ld = exp(r.sd.c);
    r.vr = dsub(dsub(1.0, r.e_li), r.e_ld);     // 1 - exp(li) - exp(ld)
    r.lr = log(r.vr);
    r.e_ln = exp(r.sn.c);
    r.u = -r.e_ln;
    r.lcl = log1p(r.u);                         // log1p(-exp(ln))
    return r;
}

// One locus's six terms: its loss term mix * inst and its parts of the
// gradients on li, ld, lr, log_clean_locus (g1) and log_noisy (g2)
__device__ __forceinline__ void locus_terms(const double* __restrict__ loc,
                                            long long n, long long j,
                                            const Rates& r, const Consts& c,
                                            double (&out)[kSums]) {
    double v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) v[k] = loc[k * n + j];
    const double li = r.si.c, ld = r.sd.c;
    const double pi = dmul(li, v[kRemIns]), pd = dmul(ld, v[kRemDel]);
    double t[4], e[4], s;
    t[0] = dadd(dadd(dadd(v[kHomPre], pi), pd), c.prior[0]);
    t[1] = dadd(dadd(dadd(v[kHetPre], pi), pd), c.prior[1]);
    t[2] = dadd(dadd(dadd(dmul(li, v[kIns]), dmul(ld, v[kDel])),
                     dmul(r.lr, v[kRef])), c.prior[2]);
    t[3] = dadd(dadd(dadd(v[kAltPre], dmul(li, v[kRemIns2])),
                     dmul(ld, v[kRemDel2])), c.prior[3]);
    const double noisy = lse4(t, e, s);
    const double x1 = dadd(r.lcl, v[kClean]);
    const double x2 = dadd(r.sn.c, noisy);
    const double d = dsub(x1, x2);
    const double mix = snv::is_nan(d)
        ? dadd(x1, x2)
        : dadd(snv::nan_max(x1, x2), log1p(exp(-fabs(d))));
    const double w = v[kInst];
    out[0] = dmul(mix, w);
    // backward: d loss / d mix = -inst; the logaddexp's custom JVP
    const double g = -w;
    const double ro = mix == INFINITY ? 0.0 : mix;
    const double g1 = dmul(g, exp(dsub(x1 == INFINITY ? 0.0 : x1, ro)));
    const double g2 = dmul(g, exp(dsub(x2 == INFINITY ? 0.0 : x2, ro)));
    // the logsumexp: log's 1/|s|, abs's sign, exp's result
    const double gs = dmul(g2 / fabs(s), sgn(s));
    double gk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) gk[k] = dmul(gs, e[k]);
    out[1] = dadd(dadd(dadd(dmul(gk[0], v[kRemIns]), dmul(gk[1], v[kRemIns])),
                       dmul(gk[2], v[kIns])), dmul(gk[3], v[kRemIns2]));
    out[2] = dadd(dadd(dadd(dmul(gk[0], v[kRemDel]), dmul(gk[1], v[kRemDel])),
                       dmul(gk[2], v[kDel])), dmul(gk[3], v[kRemDel2]));
    out[3] = dmul(gk[2], v[kRef]);
    out[4] = g1;
    out[5] = g2;
}

__global__ void __launch_bounds__(kThreads)
error_fit_prep_kernel(const double* __restrict__ ref_obs,
                      const double* __restrict__ alt_obs,
                      const double* __restrict__ inst, long long n,
                      Consts c, double* __restrict__ loc) {
    const long long j = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
    if (j >= n) return;
    double a[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = alt_obs[j * 6 + k];
    const double ref = ref_obs[j];
    // sums of three counts: exact in any order
    const double ins_tot = dadd(dadd(a[0], a[1]), a[2]);
    const double del_tot = dadd(dadd(a[3], a[4]), a[5]);
    const int mi = snv::arg_max(a, 6);
    const double mv = a[mi];
    const bool ins_max = mi < 3;
    const double rem_ins = dsub(ins_tot, ins_max ? mv : 0.0);
    const double rem_del = dsub(del_tot, ins_max ? 0.0 : mv);
    double b[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = k == mi ? -1.0 : a[k];
    const int mi2 = snv::arg_max(b, 6);
    const double mv2 = snv::nan_max(b[mi2], 0.0);
    const bool ins_max2 = mi2 < 3;
    const double rem_ins2 = dsub(rem_ins, ins_max2 ? mv2 : 0.0);
    const double rem_del2 = dsub(rem_del, ins_max2 ? 0.0 : mv2);
    const double hom_pre = dadd(dmul(c.log_hom_alt, mv),
                                dmul(c.log_hom_ref, ref));
    const double het_pre = dmul(c.log_het, dadd(ref, mv));
    const double alt_pre = dadd(dmul(c.log_het, dadd(mv, mv2)),
                                dmul(c.log_hom_ref, ref));
    // the clean mixture: _obs_log_lhood at the clean rates
    const double lc = c.log_clean;
    double t[4], e[4], s;
    t[0] = dadd(dadd(dadd(hom_pre, dmul(lc, rem_ins)), dmul(lc, rem_del)),
                c.prior[0]);
    t[1] = dadd(dadd(dadd(het_pre, dmul(lc, rem_ins)), dmul(lc, rem_del)),
                c.prior[1]);
    t[2] = dadd(dadd(dadd(dmul(lc, ins_tot), dmul(lc, del_tot)),
                     dmul(c.log_clean_ref, ref)), c.prior[2]);
    t[3] = dadd(dadd(dadd(alt_pre, dmul(lc, rem_ins2)), dmul(lc, rem_del2)),
                c.prior[3]);
    const double vals[kRows] = {ref, ins_tot, del_tot, rem_ins, rem_del,
                                rem_ins2, rem_del2, hom_pre, het_pre,
                                alt_pre, lse4(t, e, s), inst[j]};
#pragma unroll
    for (int k = 0; k < kRows; ++k) loc[k * n + j] = vals[k];
}

__global__ void __launch_bounds__(kThreads)
error_fit_step_kernel(const double* __restrict__ loc, long long n, int per,
                      Consts c, const double* __restrict__ bias, int t,
                      double* state, double* partials, unsigned* ticket) {
    __shared__ double warp_sums[kSums][kWarps];
    __shared__ double totals[kSums];
    __shared__ bool last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // every block has read the parameters before it takes its ticket,
    // and the last block writes them after every ticket is taken
    const double p[3] = {state[kParams], state[kParams + 1],
                         state[kParams + 2]};
    const Rates r = rates(p, c);

    double acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
    const long long first = static_cast<long long>(blockIdx.x) * per
                            * kThreads + tid;
    for (int i = 0; i < per; ++i) {
        const long long j = first + static_cast<long long>(i) * kThreads;
        double term[kSums];
        if (j < n) {
            locus_terms(loc, n, j, r, c, term);
        } else {
#pragma unroll
            for (int k = 0; k < kSums; ++k) term[k] = 0.0;
        }
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] = dadd(acc[k], term[k]);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
        for (int k = 0; k < kSums; ++k)
            acc[k] = dadd(acc[k], __shfl_xor_sync(kAll, acc[k], off));
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < kSums; ++k) warp_sums[k][warp] = acc[k];
    __syncthreads();
    if (tid == 0) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) {
            double s = warp_sums[k][0];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) s = dadd(s, warp_sums[k][w]);
            partials[static_cast<long long>(blockIdx.x) * kSums + k] = s;
        }
        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        __threadfence();
    }
    __syncthreads();
    if (!last) return;

    // the last block: the partials in block order, a sum a thread
    if (tid < kSums) {
        double s = __ldcg(partials + tid);
        for (unsigned b = 1; b < gridDim.x; ++b)
            s = dadd(s, __ldcg(partials + static_cast<long long>(b) * kSums
                               + tid));
        totals[tid] = s;
    }
    __syncthreads();
    if (tid != 0) return;
    const double v = -totals[0];
    // the rates' chains: log(1 - e_li - e_ld) and log1p(-e_ln)
    const double q = -(totals[3] / r.vr);
    const double g_li = dadd(totals[1], dmul(q, r.e_li));
    const double g_ld = dadd(totals[2], dmul(q, r.e_ld));
    const double g_ln = dadd(totals[5],
                             dmul(-(totals[4] / dadd(r.u, 1.0)), r.e_ln));
    const double g[3] = {
        smooth_grad(r.si, c.trig_rate, c.max_rate, g_li),
        smooth_grad(r.sd, c.trig_rate, c.max_rate, g_ld),
        smooth_grad(r.sn, c.trig_locus, c.max_locus, g_ln)};
    // Adam (special.Adam's order), the bias corrections of step t
    const double c1 = bias[2 * (t - 1)], c2 = bias[2 * (t - 1) + 1];
    double np_[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const double mu = __fma_rn(g[i], c.omb1, dmul(state[kMu + i], c.b1));
        const double nu = __fma_rn(dmul(g[i], g[i]), c.omb2,
                                   dmul(state[kNu + i], c.b2));
        const double nu_hat = nu / c2;
        const double upd = mu / dmul(c1, dadd(__dsqrt_rn(nu_hat), c.eps));
        np_[i] = __fma_rn(upd, -c.lr, p[i]);
        state[kMu + i] = mu;
        state[kNu + i] = nu;
        state[kParams + i] = np_[i];
        state[kGrad + i] = g[i];
    }
    state[kV] = v;
    // the best step: the first, then a strict v < best (a NaN never wins)
    if (t == 1 || v < state[kBestV]) {
        state[kBestV] = v;
#pragma unroll
        for (int i = 0; i < 3; ++i) state[kBestParams + i] = np_[i];
    }
    *ticket = 0u;
}

}  // namespace

extern "C" {

// ref_obs [N], alt_obs [N, 6], inst [N] float64 on one card, N >= 1;
// consts: kConsts host doubles (ops/fit_kernels.CONSTS). Out: loc [12, N]
// float64. Launches on `stream`; returns cudaGetLastError().
int error_fit_prep_launch(const void* ref_obs, const void* alt_obs,
                          const void* inst, long long n, const double* consts,
                          void* loc, void* stream) {
    Consts c;
    std::memcpy(&c, consts, sizeof c);
    const long long blocks = (n + kThreads - 1) / kThreads;
    error_fit_prep_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(ref_obs),
        static_cast<const double*>(alt_obs), static_cast<const double*>(inst),
        n, c, static_cast<double*>(loc));
    return static_cast<int>(cudaGetLastError());
}

// loc [12, N] float64 (error_fit_prep's), N >= 1, on a grid of `blocks`
// blocks of 256 threads, `per` loci a thread (blocks * per * 256 >= N);
// consts as error_fit_prep's; bias [n_steps, 2] float64 (1 - b1**s,
// 1 - b2**s for s = 1..n_steps), t the step (1..n_steps); state [17]
// float64 (ops/fit_kernels.STATE), partials [blocks, 6] float64 scratch,
// ticket one uint32, 0 between launches. Launches on `stream`; returns
// cudaGetLastError().
int error_fit_step_launch(const void* loc, long long n, int blocks, int per,
                          const double* consts, const void* bias, int t,
                          void* state, void* partials, void* ticket,
                          void* stream) {
    Consts c;
    std::memcpy(&c, consts, sizeof c);
    error_fit_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(loc), n, per, c,
        static_cast<const double*>(bias), t, static_cast<double*>(state),
        static_cast<double*>(partials), static_cast<unsigned*>(ticket));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
