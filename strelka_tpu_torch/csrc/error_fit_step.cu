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
// The sum over loci runs in one fixed order with no float atomics, and
// the fit runs in one of three regimes (cluster, grid, global), as
// csrc/fit_grid.cuh sets out: that header holds the fit's loop, its sums,
// barriers and Adam, and this file the loss (the ErrorFit policy). Each
// block runs the scalar tail itself (the rates' chains, smooth_grad, Adam
// and the next step's smoother, the three parameters on three lanes of
// warp 0, then the best step and the next step's rates).
// ops/fit_kernels.fit_model is this order written in torch ops; fit_grid
// picks (blocks, per) and the regime (cluster up to 16 blocks, 1-2 at the
// CLI's 93-275 patterns; grid past it; global past kOnChipPer loci a
// thread).
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
#include <cuda_runtime.h>

#include <cstring>

#include "fit_grid.cuh"

namespace {

// (inside this namespace, so that they hide CUDA's dadd and dmul of
// another signature)
using fitgrid::dadd;
using fitgrid::dmul;
using fitgrid::dsub;
using fitgrid::sgn;

constexpr int kThreads = fitgrid::kThreads;
constexpr int kSums = 6;          // loss, d/dli, d/dld, d/dlr, g1, g2
constexpr int kRows = 12;         // loc's rows
constexpr int kState = 17;        // the state buffer's doubles
// the fit entry's loci a thread on chip (96 KB a block, so two blocks
// share an SM); at most fitgrid::kMaxBlocks blocks; the cluster regime's
// size is the card's to refuse (16 on the H100, a non-portable size past
// 8)
constexpr int kOnChipPer = fitgrid::on_chip_per(kRows);
static_assert(kOnChipPer == 4, "KE-F holds 4 loci a thread on chip");

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
    vals[kClean] = fitgrid::lse<4>(t, e, s);
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
    const double noisy = fitgrid::lse<4>(t, e, s);
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

// The fit entry's loss, a fit_grid.cuh policy: the observations' three
// pointers, prep_locus's rows, locus_terms's six sums, and the tail: the
// three parameters' chains side by side on lanes 0-2, Adam, the next
// step's smoothers, then the best step and the next step's rates on lane 0
struct Obs {
    const double* ref_obs;
    const double* alt_obs;
    const double* inst;
};

struct ErrorFit {
    using Obs = ::Obs;
    using Consts = ::Consts;
    using Scalars = Rates;
    // kParams and kState here are the policy's: the state's slots are
    // Slot's (Slot::kParams)
    static constexpr int kRows = ::kRows, kSums = ::kSums, kParams = 3;
    static constexpr int kState = ::kState;
    static constexpr bool kFinalLoss = false;

    static __device__ __forceinline__ void prep(const Obs& o, long long j,
                                                const Consts& c,
                                                double (&v)[kRows]) {
        prep_locus(o.ref_obs, o.alt_obs, o.inst, j, c, v);
    }

    static __device__ __forceinline__ void terms(const double (&v)[kRows],
                                                 const Rates& r,
                                                 const Consts& c,
                                                 double (&out)[kSums]) {
        locus_terms(v, r.s[0].c, r.s[1].c, r.lr, r.s[2].c, r.lcl, c, out);
    }

    // the parameters and moments from the state buffer; step 1's rates
    // (lane 0 of warp 0)
    static __device__ __forceinline__ void start(const double* state,
                                                 double* st, Rates& r,
                                                 const Consts& c, int lane) {
        if (lane != 0) return;
#pragma unroll
        for (int k = 0; k < kBestV; ++k) st[k] = state[k];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            r.s[i] = smooth(st[Slot::kParams + i], trigger(i, c),
                            max_log(i, c));
            r.e[i] = exp(r.s[i].c);
        }
        rate_logs(r);
    }

    // the three parameters' chains side by side, parameter i on lane i:
    // the rates' chain (log(1 - e_li - e_ld) for li and ld, log1p(-e_ln)
    // for ln), the smoother's backward, Adam (the bias corrections of t)
    // and the next step's smoother and exp; then the best step: the
    // first, then a strict v < best (a NaN never wins)
    static __device__ __forceinline__ void step(int t,
                                                const double (&tot)[kSums],
                                                double* st, const Rates& r,
                                                Rates& next, int lane,
                                                double c1, double c2,
                                                const Consts& c) {
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
            double mu = st[kMu + i], nu = st[kNu + i];
            const double np = fitgrid::adam(g, mu, nu,
                                            st[Slot::kParams + i], c1, c2,
                                            c.lr, c.b1, c.b2, c.omb1, c.omb2,
                                            c.eps);
            st[kMu + i] = mu;
            st[kNu + i] = nu;
            st[Slot::kParams + i] = np;
            st[kGrad + i] = g;
            next.s[i] = smooth(np, trig, mx);
            next.e[i] = exp(next.s[i].c);
        }
        __syncwarp();
        if (lane == 0) {
            const double v = -tot[0];
            st[kV] = v;
            if (t == 1 || v < st[kBestV]) {
                st[kBestV] = v;
#pragma unroll
                for (int i = 0; i < 3; ++i)
                    st[kBestParams + i] = st[Slot::kParams + i];
            }
            rate_logs(next);
        }
    }

    static __device__ __forceinline__ void finish(const double (&)[kSums],
                                                  double*, int) {}
};

using fitgrid::kCluster;
using fitgrid::kGrid;
using fitgrid::Sync;
using FitArgs = fitgrid::FitArgs<Obs>;

template <Sync kSync, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 2)
error_fit_run_kernel(FitArgs a, Consts c) {
    fitgrid::fit_body<ErrorFit, kSync, kOnChip>(a, c);
}

const fitgrid::Kernels<Obs, Consts> kRun = {
    &error_fit_run_kernel<kCluster, true>, &error_fit_run_kernel<kGrid, true>,
    &error_fit_run_kernel<kGrid, false>};

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
// fitgrid::kMaxBlocks: the occupancy of its grid kernels (on chip at
// kOnChipPer loci a thread, and the global regime's) times the SMs.
// Returns a cudaError_t.
int error_fit_resident_blocks(int* out) {
    return fitgrid::resident_blocks(
        kRun, kOnChipPer * kThreads * kRows * sizeof(double), out);
}

// One whole fit: ref_obs [N], alt_obs [N, 6], inst [N] float64 on one
// card, N >= 1; consts as error_fit_prep's; bias [n_steps, 2] float64
// (1 - b1**s, 1 - b2**s for s = 1..n_steps); state [17] float64
// (ops/fit_kernels.STATE: the parameters and Adam's moments in, every
// slot out). The grid: `blocks` blocks of 256 threads, `per` loci a
// thread (blocks * per * 256 >= N, blocks <= fitgrid::kMaxBlocks), the
// loci on chip where per <= kOnChipPer; `cluster` 1: the grid one
// thread-block cluster (on chip only; the card refuses a size it cannot
// place), else a cooperative launch (the card refuses a grid that is not
// co-resident), with partials [2, blocks, 6] float64 scratch and
// arrivals two uint32 at 0 (left at 0); loc [12, N] float64 scratch
// where per > kOnChipPer. Launches on `stream`; returns a cudaError_t.
int error_fit_run_launch(const void* ref_obs, const void* alt_obs,
                         const void* inst, long long n, int blocks, int per,
                         int n_steps, int cluster, const double* consts,
                         const void* bias, void* state, void* loc,
                         void* partials, void* arrivals, void* stream) {
    Consts c;
    std::memcpy(&c, consts, sizeof c);
    const FitArgs args{Obs{static_cast<const double*>(ref_obs),
                           static_cast<const double*>(alt_obs),
                           static_cast<const double*>(inst)},
                       n, per, n_steps,
                       static_cast<const double*>(bias),
                       static_cast<double*>(state), static_cast<double*>(loc),
                       static_cast<double*>(partials),
                       static_cast<unsigned*>(arrivals)};
    return fitgrid::launch(kRun, args, c, blocks, cluster, kRows,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
