// KE-F: the indel error fit on Hopper (sm_90a), a whole fit in one launch.
//
// Replaces strelka_tpu/models/error_fit.py:171, the step that
// fit_context jits (jax.value_and_grad of neg_lhood, then optax.adam's
// update: one XLA program a step, no Pallas), whose plain version in the
// port is models/error_fit.fit_step_plain: the loss as dozens of torch
// ops, torch.autograd's backward through them and utils/special.Adam,
// some 437 kernels a step. Two entries:
//
// - error_fit_run, once a fit: n_steps Adam steps in one launch. Each
//   block first computes its loci's parameter-free values (prep_locus)
//   and keeps them on chip, in shared memory, for the whole fit; then
//   every step takes the loss at the state's parameters,
//   -sum(inst * logaddexp(log_clean_locus + clean_mix, log_noisy +
//   noisy_mix)), its gradient in closed form (the chain that
//   torch.autograd takes: the smoother's where, abs's sign with sign(0) =
//   sign(NaN) = 0 and log1p's 1/(1 + x); the log(1 - e - e) and
//   log1p(-e) rates; jnp.logaddexp's custom JVP with +inf replaced by 0;
//   the logsumexp's detached max and abs's sign), then optax's Adam in
//   special.Adam's order (__fma_rn for its three FMAs, __dsqrt_rn, IEEE
//   division, the bias corrections from a table that the host fills with
//   Python's **), then the best-step rule (the first step always kept, a
//   later one on a strict v < best, the parameters after the step kept).
//   The state is written once, at the end;
// - error_fit_prep: the same prep_locus as loc [12, N] float64 in global
//   memory, bit for bit with models/error_fit.fit_prep_plain (the tested
//   form of the fit entry's prep; on no CLI path).
//
// The sum over loci runs in one fixed order with no float atomics:
// thread t of block b adds the terms of loci (b * per + i) * 256 + t,
// i = 0..per-1, from 0.0 (a locus past N adds +0.0); a warp folds its
// lanes by xor shuffles (16, 8, 4, 2, 1); thread 0 adds the 8 warps' sums
// in warp order into the block's partial; every block then adds all the
// blocks' partials in block order and runs the scalar tail itself (the
// rates' chains, smooth_grad, Adam and the next step's smoother, the
// three parameters on three lanes of warp 0, then the best step and the
// next step's rates), so every block holds the same bits and no second
// barrier broadcasts the parameters. ops/fit_kernels.fit_model is this order
// written in torch ops; fit_grid picks (blocks, per) and the regime:
//
// - cluster: up to 16 blocks (fit_kernels.CLUSTER_MAX; 1-2 at the
//   CLI's 93-275 patterns), the whole grid one thread-block cluster; a
//   block's partial in its shared memory, read by the others through
//   distributed shared memory after barrier.cluster (cooperative_groups'
//   cluster.sync; a block barrier where the grid is one block);
// - grid: more blocks, a cooperative launch (every block co-resident, or
//   the launch is refused), the partials in global memory and one
//   hand-written barrier a step on an integer counter (the step's target
//   t * blocks; no -rdc);
// - global: where N is past what the co-resident grid holds on chip
//   (more than kOnChipPer loci a thread), the loci go to loc in global
//   memory once and are read from there (through L2) every step, with
//   the grid regime's barrier.
//
// The partials go to one of two buffers by the step's parity: a block
// writes a buffer again only after every block has passed the next
// barrier, by which time every block has read it, so one barrier a step
// is enough.
//
// Every elementwise value is the plain version's: products that meet a
// sum are __dmul_rn, sums __dadd_rn/__dsub_rn (nvcc contracts a*b + c
// under its default -fmad=true), and exp, log and log1p are the CUDA math
// library's, built with nvcc's default flags as torch's own kernels are
// (csrc/snv_math.cuh's rules). Only the order of the sums over loci
// differs from the plain version's.
//
// Bound on the H100: a fit reads the observations once (64 bytes a
// locus) and does 76 float64 operations a locus a step (7 exps, a log, a
// log1p and a division among them; ops/fit_kernels.F64_PER_LOCUS): at
// the CLI's contexts (10^2 to 10^5 patterns) a step needs well under a
// microsecond, so the step's dependent chain decides the time: the
// locus's transcendentals, the folds, the barrier and the scalar tail.
// The design takes the host, the launches and the loci's reloads out of
// it: one launch a fit, the loci on chip, one barrier a step.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstring>

#include "snv_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 6;          // loss, d/dli, d/dld, d/dlr, g1, g2
constexpr int kRows = 12;         // loc's rows
constexpr int kState = 17;        // the state buffer's doubles
constexpr unsigned kAll = 0xffffffffu;
// the fit entry's grid: at most kMaxBlocks blocks (two an SM on the
// H100's 132; the stage of partials), kOnChipPer loci a thread held in
// shared memory (96 KB a block, so two blocks share an SM); the cluster
// regime's size is the card's to refuse (16 on the H100, a non-portable
// size past 8)
constexpr int kMaxBlocks = 264;
constexpr int kOnChipPer = 4;
constexpr size_t kLocusBytes = kRows * sizeof(double);

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

// a step's parameter-dependent scalars: the smoothers of li, ld and ln
// and their exps, 1 - exp(li) - exp(ld) and its log, -exp(ln) and
// log1p(-exp(ln))
struct Rates {
    Smooth s[3];
    double e[3], vr, lr, u, lcl;
};

// parameter i's smoother (ln's triggers for i = 2, the rates' else)
__device__ __forceinline__ double trigger(int i, const Consts& c) {
    return i == 2 ? c.trig_locus : c.trig_rate;
}
__device__ __forceinline__ double max_log(int i, const Consts& c) {
    return i == 2 ? c.max_locus : c.max_rate;
}

// the rates' chains once the smoothers and their exps are in r
__device__ __forceinline__ void rate_logs(Rates& r) {
    r.vr = dsub(dsub(1.0, r.e[0]), r.e[1]);
    r.lr = log(r.vr);
    r.u = -r.e[2];
    r.lcl = log1p(r.u);
}

// One locus's parameter-free values (loc's rows) from its observations:
// ref_obs, ins_tot, del_tot, the rem_* counts after the first and second
// most frequent alt slots (first max, as torch.argmax), the parameter-free
// left prefixes of the hom, het and alt-het sums, the whole clean mixture
// (it holds no parameter) and the instance count
__device__ __forceinline__ void prep_locus(const double* __restrict__ ref_obs,
                                           const double* __restrict__ alt_obs,
                                           const double* __restrict__ inst,
                                           long long j, const Consts& c,
                                           double (&vals)[kRows]) {
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
    vals[kRef] = ref;
    vals[kIns] = ins_tot;
    vals[kDel] = del_tot;
    vals[kRemIns] = rem_ins;
    vals[kRemDel] = rem_del;
    vals[kRemIns2] = rem_ins2;
    vals[kRemDel2] = rem_del2;
    vals[kHomPre] = hom_pre;
    vals[kHetPre] = het_pre;
    vals[kAltPre] = alt_pre;
    vals[kClean] = lse4(t, e, s);
    vals[kInst] = inst[j];
}

// One locus's six terms at the step's rates (li, ld, lr, ln, lcl): its
// loss term mix * inst and its parts of the gradients on li, ld, lr,
// log_clean_locus (g1) and log_noisy (g2)
__device__ __forceinline__ void locus_terms(const double (&v)[kRows],
                                            double li, double ld, double lr,
                                            double ln, double lcl,
                                            const Consts& c,
                                            double (&out)[kSums]) {
    const double pi = dmul(li, v[kRemIns]), pd = dmul(ld, v[kRemDel]);
    double t[4], e[4], s;
    t[0] = dadd(dadd(dadd(v[kHomPre], pi), pd), c.prior[0]);
    t[1] = dadd(dadd(dadd(v[kHetPre], pi), pd), c.prior[1]);
    t[2] = dadd(dadd(dadd(dmul(li, v[kIns]), dmul(ld, v[kDel])),
                     dmul(lr, v[kRef])), c.prior[2]);
    t[3] = dadd(dadd(dadd(v[kAltPre], dmul(li, v[kRemIns2])),
                     dmul(ld, v[kRemDel2])), c.prior[3]);
    const double noisy = lse4(t, e, s);
    const double x1 = dadd(lcl, v[kClean]);
    const double x2 = dadd(ln, noisy);
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
    double v[kRows];
    prep_locus(ref_obs, alt_obs, inst, j, c, v);
#pragma unroll
    for (int k = 0; k < kRows; ++k) loc[k * n + j] = v[k];
}

// the fit entry's regimes (fit_grid's)
enum Sync { kCluster, kGrid };

struct FitArgs {
    const double* ref_obs;
    const double* alt_obs;
    const double* inst;
    long long n;
    int per, n_steps;
    const double* bias;     // [n_steps, 2]
    double* state;          // [kState]
    double* loc;            // [12, n], the global regime's
    double* partials;       // [2, blocks, 6], the grid regimes'
    unsigned* arrivals;     // [2] the grid barrier's arrivals and
                            // exits, 0 at launch and left at 0
};

// thread 0 of every block: arrive at step t's barrier (after this
// block's partial is written) and wait for all `blocks`; then the block
__device__ __forceinline__ void grid_barrier(unsigned* arrivals,
                                             unsigned target) {
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(arrivals, 1u);
        unsigned seen;
        do {
            asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                         : "=r"(seen) : "l"(arrivals) : "memory");
        } while (seen < target);
        __threadfence();
    }
    __syncthreads();
}

template <Sync kSync, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 2)
error_fit_run_kernel(FitArgs a, Consts c) {
    extern __shared__ double on_chip[];          // [12][per * 256]
    constexpr int kStage = kMaxBlocks * kSums;
    __shared__ double warp_sums[kSums][kWarps];
    __shared__ double xpart[2][kSums];           // the cluster's partials
    __shared__ double stage[kStage];             // every block's, in order
    __shared__ double st[kState];                // the state, warp 0's
    __shared__ Rates rs[2];                      // step t's in rs[t & 1]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned blocks = gridDim.x;
    const int per = a.per;
    const long long n = a.n;
    const long long first = static_cast<long long>(blockIdx.x) * per
                            * kThreads + tid;
    // this thread's loci, once a fit: on chip, or in loc past it
    double* rows = kOnChip ? on_chip : a.loc;
    const long long stride = kOnChip ? static_cast<long long>(per) * kThreads
                                     : n;
    for (int i = 0; i < per; ++i) {
        const long long j = first + static_cast<long long>(i) * kThreads;
        if (j < n) {
            double v[kRows];
            prep_locus(a.ref_obs, a.alt_obs, a.inst, j, c, v);
            const long long at = kOnChip ? i * kThreads + tid : j;
#pragma unroll
            for (int k = 0; k < kRows; ++k) rows[k * stride + at] = v[k];
        }
    }
    if (tid == 0) {
#pragma unroll
        for (int k = 0; k < kBestV; ++k) st[k] = a.state[k];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            rs[1].s[i] = smooth(st[kParams + i], trigger(i, c),
                                max_log(i, c));
            rs[1].e[i] = exp(rs[1].s[i].c);
        }
        rate_logs(rs[1]);
    }
    __syncthreads();

    for (int t = 1; t <= a.n_steps; ++t) {
        const int par = t & 1;
        double c1 = 0.0, c2 = 0.0;
        if (tid < 3) {
            c1 = a.bias[2 * (t - 1)];
            c2 = a.bias[2 * (t - 1) + 1];
        }
        const Rates& r = rs[par];
        const double li = r.s[0].c, ld = r.s[1].c, lr = r.lr, ln = r.s[2].c,
                     lcl = r.lcl;
        double acc[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
        for (int i = 0; i < per; ++i) {
            const long long j = first + static_cast<long long>(i) * kThreads;
            double term[kSums];
            if (j < n) {
                const long long at = kOnChip ? i * kThreads + tid : j;
                double v[kRows];
#pragma unroll
                for (int k = 0; k < kRows; ++k) v[k] = rows[k * stride + at];
                locus_terms(v, li, ld, lr, ln, lcl, c, term);
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
                if constexpr (kSync == kCluster)
                    xpart[par][k] = s;
                else
                    a.partials[(static_cast<long long>(par) * blocks
                                + blockIdx.x) * kSums + k] = s;
            }
        }
        // the step's barrier, then every block's partials into the stage
        if constexpr (kSync == kCluster) {
            cg::cluster_group cluster = cg::this_cluster();
            if (blocks > 1)
                cluster.sync();
            else
                __syncthreads();
            for (unsigned i = tid; i < blocks * kSums; i += kThreads)
                stage[i] = *cluster.map_shared_rank(&xpart[par][i % kSums],
                                                    i / kSums);
        } else {
            grid_barrier(a.arrivals, static_cast<unsigned>(t) * blocks);
            const double* part = a.partials
                                 + static_cast<long long>(par) * blocks
                                   * kSums;
            for (unsigned i = tid; i < blocks * kSums; i += kThreads)
                stage[i] = __ldcg(part + i);
        }
        __syncthreads();
        if (warp == 0) {
            // the partials in block order, a sum a lane
            double s = 0.0;
            if (lane < kSums) {
                s = stage[lane];
                for (unsigned b = 1; b < blocks; ++b)
                    s = dadd(s, stage[b * kSums + lane]);
            }
            double tot[kSums];
#pragma unroll
            for (int k = 0; k < kSums; ++k) tot[k] = __shfl_sync(kAll, s, k);
            // the three parameters' chains side by side, parameter i on
            // lane i: the rates' chain (log(1 - e_li - e_ld) for li and
            // ld, log1p(-e_ln) for ln), the smoother's backward, Adam
            // (special.Adam's order, the bias corrections of t) and the
            // next step's smoother and exp
            if (lane < 3) {
                const int i = lane;
                const bool locus = i == 2;
                const double trig = trigger(i, c), mx = max_log(i, c);
                const double q = -((locus ? tot[4] : tot[3])
                                   / (locus ? dadd(r.u, 1.0) : r.vr));
                const double gi = dadd(
                    i == 0 ? tot[1] : (i == 1 ? tot[2] : tot[5]),
                    dmul(q, r.e[i]));
                const double g = smooth_grad(r.s[i], trig, mx, gi);
                const double mu = __fma_rn(g, c.omb1,
                                           dmul(st[kMu + i], c.b1));
                const double nu = __fma_rn(dmul(g, g), c.omb2,
                                           dmul(st[kNu + i], c.b2));
                const double nu_hat = nu / c2;
                const double upd = mu / dmul(c1, dadd(__dsqrt_rn(nu_hat),
                                                      c.eps));
                const double np = __fma_rn(upd, -c.lr, st[kParams + i]);
                st[kMu + i] = mu;
                st[kNu + i] = nu;
                st[kParams + i] = np;
                st[kGrad + i] = g;
                Rates& next = rs[par ^ 1];
                next.s[i] = smooth(np, trig, mx);
                next.e[i] = exp(next.s[i].c);
            }
            __syncwarp();
            if (lane == 0) {
                const double v = -tot[0];
                st[kV] = v;
                // the best step: the first, then a strict v < best (a
                // NaN never wins)
                if (t == 1 || v < st[kBestV]) {
                    st[kBestV] = v;
#pragma unroll
                    for (int i = 0; i < 3; ++i)
                        st[kBestParams + i] = st[kParams + i];
                }
                rate_logs(rs[par ^ 1]);
            }
        }
        __syncthreads();
    }
    if constexpr (kSync == kCluster) {
        // no block leaves while another may still read its partials
        cg::this_cluster().sync();
    } else if (tid == 0) {
        // the last block out sets the counters back to 0 for the next
        // launch: every block has left its last wait by then
        if (atomicAdd(a.arrivals + 1, 1u) == blocks - 1) {
            a.arrivals[0] = 0u;
            a.arrivals[1] = 0u;
        }
    }
    if (blockIdx.x == 0 && tid == 0)
#pragma unroll
        for (int k = 0; k < kState; ++k) a.state[k] = st[k];
}

size_t on_chip_bytes(int per) { return per * kThreads * kLocusBytes; }

// the fit entry's attributes: dynamic shared memory up to kOnChipPer loci
// a thread, the shared-memory carveout at its most, clusters past 8 (as
// far as the card takes them)
cudaError_t configure() {
    const int dyn = static_cast<int>(on_chip_bytes(kOnChipPer));
    cudaError_t e = cudaSuccess;
    auto set = [&](auto kernel) {
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
    };
    set(&error_fit_run_kernel<kCluster, true>);
    set(&error_fit_run_kernel<kGrid, true>);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(&error_fit_run_kernel<kCluster, true>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    return e;
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

// The fit entry's co-resident blocks on the current card, at most
// kMaxBlocks: the occupancy of its grid kernels (on chip at kOnChipPer
// loci a thread, and the global regime's) times the SMs. Returns a
// cudaError_t.
int error_fit_resident_blocks(int* out) {
    int dev = 0, sms = 0, on_chip = 0, global = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = configure();
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &on_chip, error_fit_run_kernel<kGrid, true>, kThreads,
            on_chip_bytes(kOnChipPer));
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &global, error_fit_run_kernel<kGrid, false>, kThreads, 0);
    const int per_sm = on_chip < global ? on_chip : global;
    *out = per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
    return static_cast<int>(e);
}

// One whole fit: ref_obs [N], alt_obs [N, 6], inst [N] float64 on one
// card, N >= 1; consts as error_fit_prep's; bias [n_steps, 2] float64
// (1 - b1**s, 1 - b2**s for s = 1..n_steps); state [17] float64
// (ops/fit_kernels.STATE: the parameters and Adam's moments in, every
// slot out). The grid: `blocks` blocks of 256 threads, `per` loci a
// thread (blocks * per * 256 >= N, blocks <= kMaxBlocks), the loci on
// chip where per <= kOnChipPer; `cluster` 1: the grid one thread-block
// cluster (on chip only; the card refuses a size it cannot place), else
// a cooperative launch (the card refuses a grid that is not
// co-resident), with partials [2, blocks, 6] float64 scratch and
// arrivals two uint32 at 0 (left at 0); loc [12, N] float64 scratch
// where per > kOnChipPer. Launches on `stream`; returns a cudaError_t.
int error_fit_run_launch(const void* ref_obs, const void* alt_obs,
                         const void* inst, long long n, int blocks, int per,
                         int n_steps, int cluster, const double* consts,
                         const void* bias, void* state, void* loc,
                         void* partials, void* arrivals, void* stream) {
    const bool on_chip = per <= kOnChipPer;
    if (n < 1 || blocks < 1 || blocks > kMaxBlocks || per < 1
        || n_steps < 1
        || static_cast<long long>(blocks) * per * kThreads < n
        || (cluster && !on_chip)
        || (!cluster && (partials == nullptr || arrivals == nullptr))
        || (!on_chip && loc == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    Consts c;
    std::memcpy(&c, consts, sizeof c);
    cudaError_t e = configure();
    if (e != cudaSuccess) return static_cast<int>(e);
    const FitArgs args{static_cast<const double*>(ref_obs),
                       static_cast<const double*>(alt_obs),
                       static_cast<const double*>(inst), n, per, n_steps,
                       static_cast<const double*>(bias),
                       static_cast<double*>(state), static_cast<double*>(loc),
                       static_cast<double*>(partials),
                       static_cast<unsigned*>(arrivals)};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = on_chip ? on_chip_bytes(per) : 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    if (cluster) {
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
    } else {
        attr[0].id = cudaLaunchAttributeCooperative;
        attr[0].val.cooperative = 1;
    }
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cluster)
        e = cudaLaunchKernelEx(&cfg, error_fit_run_kernel<kCluster, true>,
                               args, c);
    else if (on_chip)
        e = cudaLaunchKernelEx(&cfg, error_fit_run_kernel<kGrid, true>, args,
                               c);
    else
        e = cudaLaunchKernelEx(&cfg, error_fit_run_kernel<kGrid, false>,
                               args, c);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
