// KZ: the error-model zoo's indel fits on Hopper (sm_90a): a tool run's
// fit starts side by side, one thread-block cluster a fit start.
//
// Replaces strelka_tpu/models/error_zoo.py:294-297, the step that the
// zoo's _fit jits (jax.value_and_grad of a model's negative log
// likelihood, then optax.adam's update: one XLA program a step, no
// Pallas), whose plain version in the port is models/error_zoo._fit_plain:
// the loss as torch ops, torch.autograd's backward and utils/special.Adam,
// some 350 kernels a step. Three kernels, each a fit_grid.cuh policy, run
// a whole fit start in its blocks: the loci's parameter-free values
// computed once and held on chip, every step's loss and its gradient in
// closed form summed over the loci in fit_grid.cuh's fixed order, Adam on
// the 2-4 parameters (theta's slot left as it is where theta is locked),
// the last step kept (the zoo has no best-step rule), and after the last
// step the loss once more at the final parameters, as _fit takes it.
// `tools estimate-parameters` fits every context of a counts file at once
// (ops/zoo_kernels.ZooBatch): its fit starts that a cluster of up to 16
// blocks holds run side by side in one batched launch, padded to the
// widest cluster (zoo_fit_batch_launch, fit_grid.cuh's batch_body: cluster
// c runs start c of the work list; a start alone is a batch of one), the
// larger ones one launch each (zoo_fit_launch, the grid regimes). The
// kernels:
//
// - KZ-4 <kClean>: the 4-state genotype mixture {hom, het, no-indel,
//   alt-het}: indelIndy (kClean false: ins, del, theta) and
//   indelBinomialMixture (kClean true: a clean locus at rate 1e-8 and a
//   noisy one, logaddexp'd a pattern: ins, del, noisy, theta);
// - KZ-3 <kClean>: the NoOverlap 3-state mixture {hom, het, no-indel} on
//   one indel type (is_insert): indelIndyNoOverlap* (rate, theta) and
//   indelBinomialMixtureNoOverlap* (rate, noisy, theta);
// - KZ-B: the 3-state mixture with a beta-binomial no-indel likelihood
//   betaln(k + alpha, ref + beta) - betaln(alpha, beta):
//   indelBetaBinomial* (mean, concentration, theta).
//
// Each parameter is ln limit + log_sigmoid(x) (error_zoo._ln_bounded),
// log_sigmoid(x) = -logaddexp(-x, 0), its derivative in x exp(-x -
// logaddexp(-x, 0)) (utils/special._LogAddExp's backward, +inf replaced
// by 0). The gradient is the chain that torch.autograd takes through the
// plain version: the logsumexps' detached max and abs's sign, jnp's
// logaddexp's custom JVP, log(1 - e - e), log(1 - e) and log1p(-e)
// rates, theta's priors (ln theta - ln 2, ln theta, ln(1 - 1.5 theta
// [- theta^2]), 2 ln theta), alpha = mean * conc and beta = conc * (1 -
// mean); the per-locus sums become per-parameter sums in the tail. Only
// the order of sums differs from autograd's.
//
// KZ-B's betaln is special.betaln's (jax 0.9.0's): lgamma differences for
// max < 8, lgamma plus algdiv past it, the branch taken alone (the other's
// value is discarded by jnp.where and its gradient is 0 there, so none of
// its NaNs can reach the sums), torch.minimum/maximum's halves on a tie.
// lgamma is the CUDA math library's, as torch.lgamma's CUDA kernel. Its
// derivative is digamma, which this file computes by ATen's algorithm
// (the recurrence up to x >= 10, PSI_10 at 10, the asymptotic series past
// it) with every product and sum rounded on its own: torch.digamma's
// kernel lets the compiler contract the series into FMAs, so the two
// differ by a few ulps, within the gradient's bound against the plain
// version (tests/test_torch_zoo_kernel.py) and not bit for bit.
// ops/zoo_kernels.zoo_fit_model is all of it in torch ops, bit for bit.
//
// Each step's tail (warp 0 of every block) spreads the next step's scalars
// over the lanes: a parameter a lane (its gradient chain, Adam and
// log_sigmoid), then combine's independent transcendentals a lane each
// (log(wr), log(wc) and the no-indel prior's log(wt); KZ-B's lgamma or
// algdiv and digamma of betaln(alpha, beta)'s arguments), gathered by
// __shfl_sync into lane 0, which adds them in the order of one lane's
// chain: each value is the same operation on the same operands, so no
// bit moves.
//
// Bound on the H100: a fit reads the observations once and does a few
// dozen to a few hundred float64 operations a locus a step
// (ops/zoo_kernels.F64_PER_LOCUS); at the tool's contexts (10^2 to 10^5
// patterns) the step's dependent chain decides the time, as for KE-F, so
// a tool run's fits go side by side rather than one after another.
#include <cuda_runtime.h>

#include <cstddef>
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

// The host's doubles, in ops/zoo_kernels.CONSTS's order, and two flags
struct ZooConsts {
    double log_hom_alt, log_hom_ref, log_het, ln2;
    double log_clean, log_clean_ref;   // the clean locus's ln rate, ln ref
    double prior[4];        // theta locked: the host's priors (hom, het,
                            // no-indel, alt-het)
    double lim[4];          // ln of each parameter's limit, in x's order
    double lr, b1, b2, omb1, omb2, eps;
    int lock_theta, is_insert;
};
constexpr int kDoubles = 20;
static_assert(offsetof(ZooConsts, lock_theta) == kDoubles * sizeof(double),
              "ZooConsts layout");

struct Obs {
    const double* ref_obs;     // [N]
    const double* alt_obs;     // [N, 6]
    const double* inst;        // [N]
    const long long* max1;     // [N] the most frequent alt slot
    const long long* max2;     // [N] the second
};

// a step's parameter-dependent scalars, computed from the parameters by
// the tail (bounded a parameter a lane, then combine over the lanes)
struct Scalars {
    double lnb[4];    // each parameter's ln limit + log_sigmoid(x)
    double dx[4];     // d lnb / d x
    double e[4];      // exp(lnb)
    double prior[4];  // hom, het, no-indel, alt-het
    double wt;        // theta's 1 - (1.5 theta + theta^2) or 1 - 1.5 theta
    double wr, lref;  // the reference rate: 1 - e_ins - e_del and its log
                      // (KZ-4); -e + 1 and log1p(-e) (KZ-3)
    double wc, lcl;   // the clean locus: 1 - e_noisy and its log (KZ-4);
                      // -e + 1 and log1p(-e) (KZ-3)
    double alpha, beta, b0, db0a, db0b;   // KZ-B: betaln(alpha, beta)
};

// x's scalars: lnb = lim + (-logaddexp(-x, 0)), dx = exp(-x - that)
// (+inf replaced by 0), e = exp(lnb)
__device__ __forceinline__ void bounded(double x, double lim, double& lnb,
                                        double& dx, double& e) {
    const double x1 = -x;
    const double d = dsub(x1, 0.0);
    const double sp = snv::is_nan(d)
        ? dadd(x1, 0.0)
        : dadd(snv::nan_max(x1, 0.0), log1p(exp(-fabs(d))));
    lnb = dadd(lim, -sp);
    dx = exp(dsub(x1 == INFINITY ? 0.0 : x1, sp == INFINITY ? 0.0 : sp));
    e = exp(lnb);
}

// the no-indel prior's weight from theta's slot: 1 - (1.5 theta +
// theta^2) with the alt-het state, else 1 - 1.5 theta
template <bool kAltHet>
__device__ __forceinline__ double theta_weight(const Scalars& r, int slot) {
    const double th = r.e[slot];
    return kAltHet ? dsub(1.0, dadd(dmul(th, 1.5), dmul(th, th)))
                   : dsub(1.0, dmul(th, 1.5));
}

// theta's priors from its slot, its weight wt and log(wt) (free theta), or
// the host's (locked)
__device__ __forceinline__ void priors(Scalars& r, int slot, double wt,
                                       double log_wt, const ZooConsts& c) {
    if (c.lock_theta) {
#pragma unroll
        for (int k = 0; k < 4; ++k) r.prior[k] = c.prior[k];
        return;
    }
    const double lt = r.lnb[slot];
    r.wt = wt;
    r.prior[0] = dsub(lt, c.ln2);
    r.prior[1] = lt;
    r.prior[2] = log_wt;
    r.prior[3] = dmul(lt, 2.0);
}

// lane k's v: every lane of warp 0 calls it
__device__ __forceinline__ double from_lane(double v, int k) {
    return __shfl_sync(fitgrid::kAll, v, k);
}

// d loss / d ln theta from the prior sums (hom, het, no-indel, alt-het)
template <bool kAltHet>
__device__ __forceinline__ double theta_chain(double ph, double pe,
                                              double pn, double pa,
                                              const Scalars& r, int slot) {
    const double th = r.e[slot];
    const double h = -(pn / r.wt);
    if (kAltHet) {
        const double gth = dadd(dmul(h, 1.5), dadd(dmul(h, th), dmul(h, th)));
        return dadd(dadd(dadd(ph, pe), dmul(pa, 2.0)), dmul(gth, th));
    }
    return dadd(dadd(ph, pe), dmul(dmul(h, 1.5), th));
}

// digamma(x) by ATen's algorithm, each product and sum rounded on its own;
// x > 0 (0 gives -inf; the fits reach no negative argument, which gives
// NaN here)
__device__ double digamma(double x) {
    const double kPsi10 = 2.25175258906672110764;
    const double kA[7] = {8.33333333333333333333E-2,
                          -2.10927960927960927961E-2,
                          7.57575757575757575758E-3,
                          -4.16666666666666666667E-3,
                          3.96825396825396825397E-3,
                          -8.33333333333333333333E-3,
                          8.33333333333333333333E-2};
    if (x == 0.0) return -INFINITY;
    if (!(x > 0.0)) return NAN;
    double result = 0.0;
    while (x < 10.0) {
        result = dsub(result, 1.0 / x);
        x = dadd(x, 1.0);
    }
    if (x == 10.0) return dadd(result, kPsi10);
    double y = 0.0;
    if (x < 1.0e17) {
        const double z = 1.0 / dmul(x, x);
        double p = 0.0;
#pragma unroll
        for (int i = 0; i < 7; ++i) p = dadd(dmul(p, z), kA[i]);
        y = dmul(z, p);
    }
    return dsub(dsub(dadd(result, log(x)), 0.5 / x), y);
}

// special._algdiv(a, b) (b >= 8, a <= b) in its order, with its partial
// derivatives in a and b
__device__ void algdiv(double a, double b, double& val, double& da,
                       double& db) {
    const double c0 = 0.833333333333333e-01, c1 = -0.277777777760991e-02,
                 c2 = 0.793650666825390e-03, c3 = -0.595202931351870e-03,
                 c4 = 0.837308034031215e-03, c5 = -0.165322962780713e-02;
    const double h = a / b;
    const double op = dadd(1.0, h);
    const double x = h / op;          // c and x of the reference: the same
    const double d = dadd(b, dsub(a, 0.5));
    const double x2 = dmul(x, x);
    const double s3 = dadd(1.0, dadd(x, x2));
    const double s5 = dadd(1.0, dadd(x, dmul(x2, s3)));
    const double s7 = dadd(1.0, dadd(x, dmul(x2, s5)));
    const double s9 = dadd(1.0, dadd(x, dmul(x2, s7)));
    const double s11 = dadd(1.0, dadd(x, dmul(x2, s9)));
    const double rb = 1.0 / b;
    const double t = dmul(rb, rb);
    double wp = dadd(dmul(dmul(c5, s11), t), dmul(c4, s9));
    wp = dadd(dmul(wp, t), dmul(c3, s7));
    wp = dadd(dmul(wp, t), dmul(c2, s5));
    wp = dadd(dmul(wp, t), dmul(c1, s3));
    wp = dadd(dmul(wp, t), c0);
    const double q = x / b;
    const double w = dmul(wp, q);
    const double lp = log1p(a / b);
    const double u = dmul(d, lp);
    const double lb = log(b);
    const double v = dmul(a, dsub(lb, 1.0));
    val = u <= v ? dsub(dsub(w, v), u) : dsub(dsub(w, u), v);
    // the derivatives: h = a / b, x = h / (1 + h), t = b^-2, w = wp * x / b
    const double x2d = dmul(2.0, x);
    const double ds3 = dadd(1.0, x2d);
    const double ds5 = dadd(1.0, dadd(dmul(x2d, s3), dmul(x2, ds3)));
    const double ds7 = dadd(1.0, dadd(dmul(x2d, s5), dmul(x2, ds5)));
    const double ds9 = dadd(1.0, dadd(dmul(x2d, s7), dmul(x2, ds7)));
    const double ds11 = dadd(1.0, dadd(dmul(x2d, s9), dmul(x2, ds9)));
    double wx = dadd(dmul(dmul(c5, ds11), t), dmul(c4, ds9));
    wx = dadd(dmul(wx, t), dmul(c3, ds7));
    wx = dadd(dmul(wx, t), dmul(c2, ds5));
    wx = dadd(dmul(wx, t), dmul(c1, ds3));
    wx = dmul(wx, t);
    double wt = dadd(dmul(dmul(5.0, c5), dmul(s11, t)),
                     dmul(4.0, dmul(c4, s9)));
    wt = dadd(dmul(wt, t), dmul(3.0, dmul(c3, s7)));
    wt = dadd(dmul(wt, t), dmul(2.0, dmul(c2, s5)));
    wt = dadd(dmul(wt, t), dmul(c1, s3));
    const double dh_da = rb;
    const double dh_db = -dmul(h, rb);
    const double dx_dh = 1.0 / dmul(op, op);
    const double dx_da = dmul(dx_dh, dh_da), dx_db = dmul(dx_dh, dh_db);
    const double dt_db = -dmul(dmul(2.0, t), rb);
    const double dw_da = dadd(dmul(dmul(wx, dx_da), q),
                              dmul(wp, dmul(dx_da, rb)));
    const double dw_db = dadd(
        dmul(dadd(dmul(wx, dx_db), dmul(wt, dt_db)), q),
        dmul(wp, dsub(dmul(dx_db, rb), dmul(q, rb))));
    const double du_da = dadd(lp, dmul(d, dh_da / op));
    const double du_db = dadd(lp, dmul(d, dh_db / op));
    da = dsub(dsub(dw_da, dsub(lb, 1.0)), du_da);
    db = dsub(dsub(dw_db, dmul(a, rb)), du_db);
}

// special.betaln(x, y)'s arguments: a = min, b = max, s = a + b, and its
// branch (algdiv past b < 8, a NaN b included)
struct BetaArgs {
    double a, b, s;
    bool large;
};
__device__ __forceinline__ BetaArgs beta_args(double x, double y) {
    const double a = snv::nan_min(x, y), b = snv::nan_max(x, y);
    return {a, b, dadd(a, b), !(b < 8.0)};
}

// betaln's value and partial derivatives in x and y from its parts: lgamma
// (lg) and digamma (dg) of a, b and s (b's and s's on the small branch
// alone), algdiv(a, b) and its partials (the large branch's)
__device__ __forceinline__ void betaln_join(double x, double y,
                                            const BetaArgs& g,
                                            const double (&lg)[3],
                                            const double (&dg)[3], double ad,
                                            double ada, double adb,
                                            double& val, double& dx,
                                            double& dy) {
    double ga, gb;
    if (!g.large) {
        val = dadd(lg[0], dsub(lg[1], lg[2]));
        ga = dsub(dg[0], dg[2]);
        gb = dsub(dg[1], dg[2]);
    } else {
        val = dadd(lg[0], ad);
        ga = dadd(dg[0], ada);
        gb = adb;
    }
    if (x == y) {
        dx = dy = dadd(dmul(ga, 0.5), dmul(gb, 0.5));
    } else if (x < y) {
        dx = ga;
        dy = gb;
    } else {
        dx = gb;
        dy = ga;
    }
}

// special.betaln(x, y) and its partial derivatives in x and y, on one
// thread, the branch taken alone
__device__ void betaln(double x, double y, double& val, double& dx,
                       double& dy) {
    const BetaArgs g = beta_args(x, y);
    double lg[3] = {lgamma(g.a), 0.0, 0.0}, dg[3] = {digamma(g.a), 0.0, 0.0};
    double ad = 0.0, ada = 0.0, adb = 0.0;
    if (g.large) {
        algdiv(g.a, g.b, ad, ada, adb);
    } else {
        lg[1] = lgamma(g.b);
        lg[2] = lgamma(g.s);
        dg[1] = digamma(g.b);
        dg[2] = digamma(g.s);
    }
    betaln_join(x, y, g, lg, dg, ad, ada, adb, val, dx, dy);
}

// the logsumexp's gradient: d mix / d t_k = (g / |s|) sign(s) e_k
template <int K>
__device__ __forceinline__ void lse_grad(double g, double s,
                                         const double (&e)[K],
                                         double (&gk)[K]) {
    const double gs = dmul(g / fabs(s), sgn(s));
#pragma unroll
    for (int k = 0; k < K; ++k) gk[k] = dmul(gs, e[k]);
}

// jnp.logaddexp(x1, x2) of the clean and noisy mixtures and its custom
// JVP's two factors times g (+inf replaced by 0)
__device__ __forceinline__ double mix2(double x1, double x2, double g,
                                       double& g1, double& g2) {
    const double d = dsub(x1, x2);
    const double mix = snv::is_nan(d)
        ? dadd(x1, x2)
        : dadd(snv::nan_max(x1, x2), log1p(exp(-fabs(d))));
    const double ro = mix == INFINITY ? 0.0 : mix;
    g1 = dmul(g, exp(dsub(x1 == INFINITY ? 0.0 : x1, ro)));
    g2 = dmul(g, exp(dsub(x2 == INFINITY ? 0.0 : x2, ro)));
    return mix;
}

// the alt counts' sums of a locus: insertions (slots 0-2), deletions
// (3-5), in index order (exact: integer counts)
__device__ __forceinline__ void alt_sums(const Obs& o, long long j,
                                         double (&a)[6], double& ins,
                                         double& del) {
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = o.alt_obs[j * 6 + k];
    ins = dadd(dadd(a[0], a[1]), a[2]);
    del = dadd(dadd(a[3], a[4]), a[5]);
}

// The parts of a zoo policy that do not depend on the loss: the state
// layout (the parameters, Adam's moments, the last step's loss and
// gradient, the final loss), start, the lanes' Adam and next scalars, and
// finish. D supplies kP, chain(i, tot, r, c) (d loss / d lnb_i) and
// combine(r, c, lane) (warp 0: the scalars past each parameter's own, a
// transcendental a lane, written by lane 0).
template <class D, int kP_>
struct ZooFit {
    using Obs = ::Obs;
    using Consts = ZooConsts;
    using Scalars = ::Scalars;
    static constexpr int kParams = kP_;
    static constexpr int kMu = kP_, kNu = 2 * kP_, kV = 3 * kP_,
                         kGrad = 3 * kP_ + 1, kFinal = 4 * kP_ + 1;
    static constexpr int kState = 4 * kP_ + 2;
    static constexpr bool kFinalLoss = true;
    static constexpr int kTheta = kP_ - 1;

    static __device__ __forceinline__ void start(const double* state,
                                                 double* st, Scalars& r,
                                                 const ZooConsts& c,
                                                 int lane) {
        for (int k = lane; k < 3 * kP_; k += 32) st[k] = state[k];
        __syncwarp();
        if (lane < kP_)
            bounded(st[lane], c.lim[lane], r.lnb[lane], r.dx[lane],
                    r.e[lane]);
        __syncwarp();
        D::combine(r, c, lane);
    }

    template <int kSums>
    static __device__ __forceinline__ void step(
        int, const double (&tot)[kSums], double* st, const Scalars& r,
        Scalars& next, int lane, double c1, double c2, const ZooConsts& c) {
        if (lane < kP_) {
            const int i = lane;
            double np = st[i];
            if (i == kTheta && c.lock_theta) {
                st[kGrad + i] = 0.0;
            } else {
                const double g = dmul(D::chain(i, tot, r, c), r.dx[i]);
                double mu = st[kMu + i], nu = st[kNu + i];
                np = fitgrid::adam(g, mu, nu, np, c1, c2, c.lr, c.b1, c.b2,
                                   c.omb1, c.omb2, c.eps);
                st[kMu + i] = mu;
                st[kNu + i] = nu;
                st[i] = np;
                st[kGrad + i] = g;
            }
            bounded(np, c.lim[i], next.lnb[i], next.dx[i], next.e[i]);
        }
        __syncwarp();
        if (lane == 0) st[kV] = -tot[0];
        D::combine(next, c, lane);
    }

    template <int kSums>
    static __device__ __forceinline__ void finish(const double (&tot)[kSums],
                                                  double* st, int lane) {
        if (lane == 0) st[kFinal] = -tot[0];
    }
};

// KZ-4: the 4-state mixture; kClean adds the clean locus
template <bool kClean>
struct Kz4 : ZooFit<Kz4<kClean>, kClean ? 4 : 3> {
    using Base = ZooFit<Kz4<kClean>, kClean ? 4 : 3>;
    enum Row {
        kRef, kIns, kDel, kRi1, kRd1, kRi2, kRd2, kHomPre, kHetPre, kAltPre,
        kInst, kHomC, kHetC, kNdC, kAltC
    };
    static constexpr int kRows = kClean ? 15 : 11;
    static constexpr int kSums = kClean ? 10 : 8;   // loss, ins, del, ref,
                                                    // 4 priors, g1, g2

    static __device__ __forceinline__ void prep(const Obs& o, long long j,
                                                const ZooConsts& c,
                                                double (&v)[kRows]) {
        double a[6], ins, del;
        alt_sums(o, j, a, ins, del);
        const double ref = o.ref_obs[j];
        const int m1 = static_cast<int>(o.max1[j]);
        const int m2 = static_cast<int>(o.max2[j]);
        const double a1 = a[m1], a2 = a[m2];
        const double ri1 = dsub(ins, m1 < 3 ? a1 : 0.0);
        const double rd1 = dsub(del, m1 < 3 ? 0.0 : a1);
        const double ri2 = dsub(ri1, m2 < 3 ? a2 : 0.0);
        const double rd2 = dsub(rd1, m2 < 3 ? 0.0 : a2);
        v[kRef] = ref;
        v[kIns] = ins;
        v[kDel] = del;
        v[kRi1] = ri1;
        v[kRd1] = rd1;
        v[kRi2] = ri2;
        v[kRd2] = rd2;
        v[kHomPre] = dadd(dmul(c.log_hom_alt, a1), dmul(c.log_hom_ref, ref));
        v[kHetPre] = dmul(c.log_het, dadd(ref, a1));
        v[kAltPre] = dadd(dmul(c.log_het, dadd(a1, a2)),
                          dmul(c.log_hom_ref, ref));
        v[kInst] = o.inst[j];
        if constexpr (kClean) {
            const double lc = c.log_clean;
            v[kHomC] = dadd(dadd(v[kHomPre], dmul(lc, ri1)), dmul(lc, rd1));
            v[kHetC] = dadd(dadd(v[kHetPre], dmul(lc, ri1)), dmul(lc, rd1));
            v[kNdC] = dadd(dadd(dmul(lc, ins), dmul(lc, del)),
                           dmul(c.log_clean_ref, ref));
            v[kAltC] = dadd(dadd(v[kAltPre], dmul(lc, ri2)), dmul(lc, rd2));
        }
    }

    static __device__ __forceinline__ void terms(const double (&v)[kRows],
                                                 const Scalars& r,
                                                 const ZooConsts&,
                                                 double (&out)[kSums]) {
        const double li = r.lnb[0], ld = r.lnb[1];
        const double pi = dmul(li, v[kRi1]), pd = dmul(ld, v[kRd1]);
        double t[4], e[4], s;
        t[0] = dadd(r.prior[0], dadd(dadd(v[kHomPre], pi), pd));
        t[1] = dadd(r.prior[1], dadd(dadd(v[kHetPre], pi), pd));
        t[2] = dadd(r.prior[2], dadd(dadd(dmul(li, v[kIns]),
                                          dmul(ld, v[kDel])),
                                     dmul(r.lref, v[kRef])));
        t[3] = dadd(r.prior[3], dadd(dadd(v[kAltPre], dmul(li, v[kRi2])),
                                     dmul(ld, v[kRd2])));
        const double noisy = fitgrid::lse<4>(t, e, s);
        const double w = v[kInst];
        const double g = -w;
        double mix, g1 = 0.0, g2 = g, gc[4] = {0.0, 0.0, 0.0, 0.0};
        if constexpr (kClean) {
            double tc[4], ec[4], sc;
#pragma unroll
            for (int k = 0; k < 4; ++k)
                tc[k] = dadd(r.prior[k], v[kHomC + k]);
            const double clean = fitgrid::lse<4>(tc, ec, sc);
            mix = mix2(dadd(r.lcl, clean), dadd(r.lnb[2], noisy), g, g1, g2);
            lse_grad<4>(g1, sc, ec, gc);
        } else {
            mix = noisy;
        }
        double gk[4];
        lse_grad<4>(g2, s, e, gk);
        out[0] = dmul(mix, w);
        out[1] = dadd(dadd(dadd(dmul(gk[0], v[kRi1]), dmul(gk[1], v[kRi1])),
                           dmul(gk[2], v[kIns])), dmul(gk[3], v[kRi2]));
        out[2] = dadd(dadd(dadd(dmul(gk[0], v[kRd1]), dmul(gk[1], v[kRd1])),
                           dmul(gk[2], v[kDel])), dmul(gk[3], v[kRd2]));
        out[3] = dmul(gk[2], v[kRef]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            out[4 + k] = kClean ? dadd(gk[k], gc[k]) : gk[k];
        if constexpr (kClean) {
            out[8] = g1;
            out[9] = g2;
        }
    }

    // d loss / d lnb_i: ins and del through their own sums and log(1 -
    // e_ins - e_del); noisy through its own and log(1 - e_noisy); theta
    // through the priors
    static __device__ __forceinline__ double chain(int i,
                                                   const double (&tot)[kSums],
                                                   const Scalars& r,
                                                   const ZooConsts&) {
        if (i < 2)
            return dadd(tot[1 + i], dmul(-(tot[3] / r.wr), r.e[i]));
        if (kClean && i == 2)
            return dadd(tot[kSums - 1], dmul(-(tot[kSums - 2] / r.wc),
                                             r.e[2]));
        return theta_chain<true>(tot[4], tot[5], tot[6], tot[7], r,
                                 Base::kTheta);
    }

    // log(wr) on lane 0, log(wc) on lane 1, log(wt) on the others: one
    // log call a lane
    static __device__ __forceinline__ void combine(Scalars& r,
                                                   const ZooConsts& c,
                                                   int lane) {
        const double wr = dsub(dsub(1.0, r.e[0]), r.e[1]);
        const double wc = kClean ? dsub(1.0, r.e[2]) : 1.0;
        const double wt = theta_weight<true>(r, Base::kTheta);
        const double lx = log(lane == 0 ? wr : (lane == 1 ? wc : wt));
        const double lref = from_lane(lx, 0), lcl = from_lane(lx, 1);
        const double lwt = from_lane(lx, 2);
        if (lane == 0) {
            r.wr = wr;
            r.lref = lref;
            if constexpr (kClean) {
                r.wc = wc;
                r.lcl = lcl;
            }
            priors(r, Base::kTheta, wt, lwt, c);
        }
    }

    static __device__ __forceinline__ void step(int t,
                                                const double (&tot)[kSums],
                                                double* st, const Scalars& r,
                                                Scalars& next, int lane,
                                                double c1, double c2,
                                                const ZooConsts& c) {
        Base::template step<kSums>(t, tot, st, r, next, lane, c1, c2, c);
    }
    static __device__ __forceinline__ void finish(const double (&tot)[kSums],
                                                  double* st, int lane) {
        Base::template finish<kSums>(tot, st, lane);
    }
};

// KZ-3: the NoOverlap 3-state mixture on one indel type; kClean adds the
// clean locus
template <bool kClean>
struct Kz3 : ZooFit<Kz3<kClean>, kClean ? 3 : 2> {
    using Base = ZooFit<Kz3<kClean>, kClean ? 3 : 2>;
    enum Row { kRef, kK, kHet, kHom, kInst, kNdC };
    static constexpr int kRows = kClean ? 6 : 5;
    static constexpr int kSums = kClean ? 8 : 6;   // loss, k, ref, 3
                                                   // priors, g1, g2

    static __device__ __forceinline__ void prep(const Obs& o, long long j,
                                                const ZooConsts& c,
                                                double (&v)[kRows]) {
        double a[6], ins, del;
        alt_sums(o, j, a, ins, del);
        const double ref = o.ref_obs[j], k = c.is_insert ? ins : del;
        v[kRef] = ref;
        v[kK] = k;
        v[kHet] = dmul(c.log_het, dadd(ref, k));
        v[kHom] = dadd(dmul(c.log_hom_alt, k), dmul(c.log_hom_ref, ref));
        v[kInst] = o.inst[j];
        if constexpr (kClean)
            v[kNdC] = dadd(dmul(c.log_clean, k), dmul(c.log_clean_ref, ref));
    }

    static __device__ __forceinline__ void terms(const double (&v)[kRows],
                                                 const Scalars& r,
                                                 const ZooConsts&,
                                                 double (&out)[kSums]) {
        double t[3], e[3], s;
        t[0] = dadd(r.prior[0], v[kHom]);
        t[1] = dadd(r.prior[1], v[kHet]);
        t[2] = dadd(r.prior[2], dadd(dmul(r.lnb[0], v[kK]),
                                     dmul(r.lref, v[kRef])));
        const double noisy = fitgrid::lse<3>(t, e, s);
        const double w = v[kInst];
        const double g = -w;
        double mix, g1 = 0.0, g2 = g, gc[3] = {0.0, 0.0, 0.0};
        if constexpr (kClean) {
            double tc[3], ec[3], sc;
            tc[0] = t[0];
            tc[1] = t[1];
            tc[2] = dadd(r.prior[2], v[kNdC]);
            const double clean = fitgrid::lse<3>(tc, ec, sc);
            mix = mix2(dadd(r.lcl, clean), dadd(r.lnb[1], noisy), g, g1, g2);
            lse_grad<3>(g1, sc, ec, gc);
        } else {
            mix = noisy;
        }
        double gk[3];
        lse_grad<3>(g2, s, e, gk);
        out[0] = dmul(mix, w);
        out[1] = dmul(gk[2], v[kK]);
        out[2] = dmul(gk[2], v[kRef]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
            out[3 + k] = kClean ? dadd(gk[k], gc[k]) : gk[k];
        if constexpr (kClean) {
            out[6] = g1;
            out[7] = g2;
        }
    }

    // d loss / d lnb_i: the rate through its own sum and log1p(-e_rate);
    // noisy through its own and log1p(-e_noisy); theta through the priors
    static __device__ __forceinline__ double chain(int i,
                                                   const double (&tot)[kSums],
                                                   const Scalars& r,
                                                   const ZooConsts&) {
        if (i == 0) return dadd(tot[1], dmul(-(tot[2] / r.wr), r.e[0]));
        if (kClean && i == 1)
            return dadd(tot[7], dmul(-(tot[6] / r.wc), r.e[1]));
        return theta_chain<false>(tot[3], tot[4], tot[5], 0.0, r,
                                  Base::kTheta);
    }

    // log1p(-e_rate) on lane 0, log1p(-e_noisy) on lane 1, log(wt) on the
    // others
    static __device__ __forceinline__ void combine(Scalars& r,
                                                   const ZooConsts& c,
                                                   int lane) {
        const double wt = theta_weight<false>(r, Base::kTheta);
        const double lx = lane < 2 ? log1p(-r.e[lane]) : log(wt);
        const double lref = from_lane(lx, 0), lcl = from_lane(lx, 1);
        const double lwt = from_lane(lx, 2);
        if (lane == 0) {
            r.wr = dadd(-r.e[0], 1.0);
            r.lref = lref;
            if constexpr (kClean) {
                r.wc = dadd(-r.e[1], 1.0);
                r.lcl = lcl;
            }
            priors(r, Base::kTheta, wt, lwt, c);
        }
    }

    static __device__ __forceinline__ void step(int t,
                                                const double (&tot)[kSums],
                                                double* st, const Scalars& r,
                                                Scalars& next, int lane,
                                                double c1, double c2,
                                                const ZooConsts& c) {
        Base::template step<kSums>(t, tot, st, r, next, lane, c1, c2, c);
    }
    static __device__ __forceinline__ void finish(const double (&tot)[kSums],
                                                  double* st, int lane) {
        Base::template finish<kSums>(tot, st, lane);
    }
};

// KZ-B: the 3-state mixture with the beta-binomial no-indel likelihood
struct KzB : ZooFit<KzB, 3> {
    enum Row { kRef, kK, kHet, kHom, kInst };
    static constexpr int kRows = 5;
    static constexpr int kSums = 6;   // loss, d/da, d/db, no-indel (its
                                      // prior's too), hom and het priors

    static __device__ __forceinline__ void prep(const Obs& o, long long j,
                                                const ZooConsts& c,
                                                double (&v)[kRows]) {
        double a[6], ins, del;
        alt_sums(o, j, a, ins, del);
        const double ref = o.ref_obs[j], k = c.is_insert ? ins : del;
        v[kRef] = ref;
        v[kK] = k;
        v[kHet] = dmul(c.log_het, dadd(ref, k));
        v[kHom] = dadd(dmul(c.log_hom_alt, k), dmul(c.log_hom_ref, ref));
        v[kInst] = o.inst[j];
    }

    static __device__ __forceinline__ void terms(const double (&v)[kRows],
                                                 const Scalars& r,
                                                 const ZooConsts&,
                                                 double (&out)[kSums]) {
        double bl, da, db;
        betaln(dadd(v[kK], r.alpha), dadd(v[kRef], r.beta), bl, da, db);
        double t[3], e[3], s;
        t[0] = dadd(r.prior[0], v[kHom]);
        t[1] = dadd(r.prior[1], v[kHet]);
        t[2] = dadd(r.prior[2], dsub(bl, r.b0));
        const double mix = fitgrid::lse<3>(t, e, s);
        const double w = v[kInst];
        double gk[3];
        lse_grad<3>(-w, s, e, gk);
        out[0] = dmul(mix, w);
        out[1] = dmul(gk[2], da);
        out[2] = dmul(gk[2], db);
        out[3] = gk[2];
        out[4] = gk[0];
        out[5] = gk[1];
    }

    // d loss / d lnb_i: alpha's and beta's sums less betaln(alpha, beta)'s
    // part, through alpha = mean * conc, beta = conc * (1 - mean) and
    // mean = e_0, conc = e_1; theta through the priors
    static __device__ __forceinline__ double chain(int i,
                                                   const double (&tot)[kSums],
                                                   const Scalars& r,
                                                   const ZooConsts&) {
        if (i < 2) {
            const double ga = dsub(tot[1], dmul(tot[3], r.db0a));
            const double gb = dsub(tot[2], dmul(tot[3], r.db0b));
            const double mean = r.e[0], conc = r.e[1];
            if (i == 0)
                return dmul(dadd(dmul(ga, conc), -dmul(gb, conc)), mean);
            return dmul(dadd(dmul(ga, mean), dmul(gb, dsub(1.0, mean))),
                        conc);
        }
        return theta_chain<false>(tot[4], tot[5], tot[3], 0.0, r, kTheta);
    }

    // betaln(alpha, beta)'s parts a lane: lgamma of a, b and s on lanes
    // 0-2 (algdiv(a, b) on lane 1 in its large branch), digamma of a, b and
    // s on lanes 3-5, the prior's log(wt) on the others
    static __device__ __forceinline__ void combine(Scalars& r,
                                                   const ZooConsts& c,
                                                   int lane) {
        const double alpha = dmul(r.e[0], r.e[1]);
        const double beta = dmul(r.e[1], dsub(1.0, r.e[0]));
        const double wt = theta_weight<false>(r, kTheta);
        const BetaArgs g = beta_args(alpha, beta);
        const int k = lane < 3 ? lane : lane - 3;
        const double x = k == 0 ? g.a : (k == 1 ? g.b : g.s);
        double v = 0.0, v1 = 0.0, v2 = 0.0;
        if (lane == 1 && g.large)
            algdiv(g.a, g.b, v, v1, v2);
        else if (lane < 3)
            v = lgamma(x);
        else if (lane < 6)
            v = digamma(x);
        else
            v = log(wt);
        double lg[3], dg[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            lg[i] = from_lane(v, i);
            dg[i] = from_lane(v, 3 + i);
        }
        const double ada = from_lane(v1, 1), adb = from_lane(v2, 1);
        const double lwt = from_lane(v, 6);
        if (lane == 0) {
            r.alpha = alpha;
            r.beta = beta;
            // lane 1's value is algdiv's on the large branch
            betaln_join(alpha, beta, g, lg, dg, lg[1], ada, adb, r.b0,
                        r.db0a, r.db0b);
            priors(r, kTheta, wt, lwt, c);
        }
    }

    static __device__ __forceinline__ void step(int t,
                                                const double (&tot)[kSums],
                                                double* st, const Scalars& r,
                                                Scalars& next, int lane,
                                                double c1, double c2,
                                                const ZooConsts& c) {
        ZooFit::template step<kSums>(t, tot, st, r, next, lane, c1, c2, c);
    }
    static __device__ __forceinline__ void finish(const double (&tot)[kSums],
                                                  double* st, int lane) {
        ZooFit::template finish<kSums>(tot, st, lane);
    }
};

using fitgrid::kGrid;
using FitArgs = fitgrid::FitArgs<Obs>;
using Kernels = fitgrid::Kernels<Obs, ZooConsts>;

// a fit start past the cluster: the grid regimes, one launch a start
template <class P, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 2)
zoo_grid_kernel(FitArgs a, ZooConsts c) {
    fitgrid::fit_body<P, kGrid, kOnChip>(a, c);
}

// the cluster regime: cluster c of a launch runs fit start c of the work
// list
template <class P>
__global__ void __launch_bounds__(kThreads, 2)
zoo_batch_kernel(fitgrid::BatchArgs<Obs> a, ZooConsts c) {
    fitgrid::batch_body<P>(a, c);
}

template <class P>
constexpr int kLayout[5] = {P::kRows, P::kSums, P::kParams, P::kState,
                            fitgrid::on_chip_per(P::kRows)};

// a family's kernels: the batched launch's (the cluster regime), the
// grid regimes' (fitgrid::Kernels, no cluster kernel) and the layout
struct Zoo {
    void (*batch)(fitgrid::BatchArgs<Obs>, ZooConsts);
    Kernels k;
    const int* layout;
};

template <class P>
Zoo zoo() {
    return {&zoo_batch_kernel<P>,
            {nullptr, &zoo_grid_kernel<P, true>, &zoo_grid_kernel<P, false>},
            kLayout<P>};
}

// kind 0: KZ-4, 1: KZ-3, 2: KZ-B; clean 0/1 (KZ-B: 0). Returns false on
// another pair.
bool pick(int kind, int clean, Zoo& z) {
    if (kind == 0 && clean == 0)
        z = zoo<Kz4<false>>();
    else if (kind == 0 && clean == 1)
        z = zoo<Kz4<true>>();
    else if (kind == 1 && clean == 0)
        z = zoo<Kz3<false>>();
    else if (kind == 1 && clean == 1)
        z = zoo<Kz3<true>>();
    else if (kind == 2 && clean == 0)
        z = zoo<KzB>();
    else
        return false;
    return true;
}

ZooConsts host_consts(const double* consts, int lock_theta, int is_insert) {
    ZooConsts c;
    std::memcpy(&c, consts, kDoubles * sizeof(double));
    c.lock_theta = lock_theta;
    c.is_insert = is_insert;
    return c;
}

Obs host_obs(const void* ref_obs, const void* alt_obs, const void* inst,
             const void* max1, const void* max2) {
    return Obs{static_cast<const double*>(ref_obs),
               static_cast<const double*>(alt_obs),
               static_cast<const double*>(inst),
               static_cast<const long long*>(max1),
               static_cast<const long long*>(max2)};
}

}  // namespace

extern "C" {

// A kernel's layout (ops/zoo_kernels.LAYOUT): out[5] = the rows a locus,
// the sums a step, the parameters, the state's doubles and the loci a
// thread held on chip. Returns a cudaError_t (invalid value for an
// unknown kind or clean).
int zoo_fit_layout(int kind, int clean, int* out) {
    Zoo z;
    if (!pick(kind, clean, z)) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < 5; ++i) out[i] = z.layout[i];
    return 0;
}

// A kernel's co-resident blocks on the current card, at most
// fitgrid::kMaxBlocks (fitgrid::resident_blocks). Returns a cudaError_t.
int zoo_fit_resident_blocks(int kind, int clean, int* out) {
    Zoo z;
    if (!pick(kind, clean, z)) return static_cast<int>(cudaErrorInvalidValue);
    return fitgrid::resident_blocks(
        z.k, static_cast<size_t>(z.layout[4]) * kThreads * z.layout[0]
                 * sizeof(double), out);
}

// One fit start: ref_obs [N], alt_obs [N, 6], inst [N] float64 and max1,
// max2 [N] int64 on one card, N >= 1; consts: kDoubles host doubles
// (ops/zoo_kernels.CONSTS); lock_theta, is_insert 0/1; bias [n_steps, 2]
// float64 (1 - b1**s, 1 - b2**s); state [kState] float64 (the parameters
// and zero moments in; the parameters, moments, last step's loss and
// gradient and the final loss out). The grid regimes, as
// error_fit_run_launch's past its cluster: a cooperative launch of
// `blocks` blocks of 256 threads, `per` loci a thread, on chip up to the
// layout's loci a thread, with partials [2, blocks, sums] float64 and
// arrivals two uint32 at 0; loc [rows, N] float64 past on chip (a start
// in the cluster regime goes through zoo_fit_batch_launch). Launches on
// `stream`; returns a cudaError_t.
int zoo_fit_launch(int kind, int clean, const void* ref_obs,
                   const void* alt_obs, const void* inst, const void* max1,
                   const void* max2, long long n, int blocks, int per,
                   int n_steps, const double* consts,
                   int lock_theta, int is_insert, const void* bias,
                   void* state, void* loc, void* partials, void* arrivals,
                   void* stream) {
    Zoo z;
    if (!pick(kind, clean, z)) return static_cast<int>(cudaErrorInvalidValue);
    const FitArgs args{host_obs(ref_obs, alt_obs, inst, max1, max2),
                       n, per, n_steps,
                       static_cast<const double*>(bias),
                       static_cast<double*>(state), static_cast<double*>(loc),
                       static_cast<double*>(partials),
                       static_cast<unsigned*>(arrivals)};
    return fitgrid::launch(z.k, args, host_consts(consts, lock_theta,
                                                  is_insert),
                           blocks, 0, z.layout[0],
                           static_cast<cudaStream_t>(stream));
}

// A batched launch of fit starts side by side: the observations of every
// context concatenated (ref_obs [N], alt_obs [N, 6], inst [N] float64,
// max1, max2 [N] int64, N >= 1); work [items, 5] int64, a fit start a row
// (fitgrid::BatchArgs: its first pattern, patterns, blocks, loci a thread
// and state slot); `items` clusters of `width` blocks (<= 16), cluster c
// running row c, each row's blocks <= width and loci a thread <= max_per
// <= the layout's on-chip loci a thread, blocks * per * 256 covering its
// patterns; consts, lock_theta, is_insert and bias as zoo_fit_launch's,
// shared by every start; states [slots, kState] float64 (each start's
// parameters and zero moments in, every slot out). Launches on `stream`;
// returns a cudaError_t (invalid value for an unknown kind or clean or a
// width, items or max_per out of range; the card refuses a cluster width
// it cannot place).
int zoo_fit_batch_launch(int kind, int clean, const void* ref_obs,
                         const void* alt_obs, const void* inst,
                         const void* max1, const void* max2,
                         const void* work, int items, int width, int max_per,
                         int n_steps, const double* consts, int lock_theta,
                         int is_insert, const void* bias, void* states,
                         void* stream) {
    Zoo z;
    if (!pick(kind, clean, z)) return static_cast<int>(cudaErrorInvalidValue);
    const fitgrid::BatchArgs<Obs> args{
        host_obs(ref_obs, alt_obs, inst, max1, max2),
        static_cast<const long long*>(work), n_steps,
        static_cast<const double*>(bias), static_cast<double*>(states)};
    return fitgrid::launch_batch(z.batch, args,
                                 host_consts(consts, lock_theta, is_insert),
                                 items, width, max_per, z.layout[0],
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
