// The loss-independent parts of a whole Adam fit in one launch on Hopper
// (sm_90a), shared by KE-F (error_fit_step.cu, the indel error fit) and
// KZ (error_zoo_fit.cu, the error-model zoo's fits).
//
// A fit is a loss summed over loci, its gradient in closed form and
// optax's Adam, n_steps times, in one launch. A policy P (the loss) says
// what a locus holds and adds; this header runs the fit:
//
// - each thread's loci, once a fit: P::prep's kRows parameter-free values
//   a locus, held in shared memory (on chip) for the whole fit, or in loc
//   in global memory past what the grid holds on chip;
// - each step: P::terms's kSums values a locus at the step's scalars
//   (P::Scalars, in shared memory), summed over the loci in one fixed
//   order with no float atomics: thread t of block b adds the terms of
//   loci (b * per + i) * 256 + t, i = 0..per-1, from 0.0 (a locus past N
//   adds +0.0); a warp folds its lanes by xor shuffles (16, 8, 4, 2, 1);
//   thread 0 adds the 8 warps' sums in warp order into the block's
//   partial; every block then adds all the blocks' partials in block
//   order and runs the scalar tail itself (P::step on warp 0: the
//   gradient chains, Adam, the next step's scalars), so every block
//   holds the same bits and no second barrier broadcasts them;
// - after the last step, where P::kFinalLoss, one more pass of the loci
//   at the final parameters' scalars and P::finish (the loss there);
// - the state (P::kState doubles) written once, at the end, by block 0.
//
// A batched launch (batch_body) runs a work list of fits side by side, one
// thread-block cluster a fit: cluster c runs fit c of the list on its own
// loci (a slice of the concatenated operands) and state. A fit's blocks
// are its cluster's first ranks; where the launch's clusters are wider
// than a fit's grid, the ranks past it hold no locus, add no partial to
// the fit's sums and only meet the fit's barriers.
//
// The regimes (ops/fit_kernels.fit_grid picks one from N):
// - cluster: up to 16 blocks, the whole grid one thread-block cluster; a
//   block's partial in its shared memory, read by the others through
//   distributed shared memory after barrier.cluster (cooperative_groups'
//   cluster.sync; a block barrier where the grid is one block);
// - grid: more blocks, a cooperative launch (every block co-resident, or
//   the launch is refused), the partials in global memory and one
//   hand-written barrier a step on an integer counter (the step's target
//   t * blocks; no -rdc);
// - global: the loci in loc in global memory, read (through L2) every
//   step, with the grid regime's barrier.
// The partials go to one of two buffers by the step's parity: a block
// writes a buffer again only after every block has passed the next
// barrier, by which time every block has read it, so one barrier a step
// is enough.
//
// Arithmetic rules (csrc/snv_math.cuh's): products that meet a sum are
// __dmul_rn, sums __dadd_rn/__dsub_rn (nvcc contracts a*b + c under its
// default -fmad=true); exp, log, log1p and lgamma are the CUDA math
// library's under nvcc's default flags, as torch's own kernels are.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "snv_math.cuh"

namespace fitgrid {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// at most kMaxBlocks blocks (two an SM on the H100's 132; the stage of
// partials); each block's loci on chip in up to kOnChipBytes of dynamic
// shared memory, so two blocks share an SM
constexpr int kMaxBlocks = 264;
constexpr size_t kOnChipBytes = 96 * 1024;
// the H100's largest thread-block cluster (non-portable past 8)
constexpr int kMaxCluster = 16;

// loci a thread that a policy of kRows values a locus holds on chip
constexpr int on_chip_per(int rows) {
    return static_cast<int>(kOnChipBytes
                            / (rows * sizeof(double) * kThreads));
}

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

// logsumexp of K terms as special.logsumexp: the max (0 where it is not
// finite), the exps of the differences summed in index order; sets e
// (the exps), s (their sum) and returns log|s| + max
template <int K>
__device__ __forceinline__ double lse(const double (&t)[K], double (&e)[K],
                                      double& s) {
    double m = t[0];
#pragma unroll
    for (int k = 1; k < K; ++k) m = snv::nan_max(m, t[k]);
    m = snv::is_finite(m) ? m : 0.0;
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = exp(dsub(t[k], m));
    s = e[0];
#pragma unroll
    for (int k = 1; k < K; ++k) s = dadd(s, e[k]);
    return dadd(log(fabs(s)), m);
}

// optax's Adam on one parameter in special.Adam's order (__fma_rn for its
// three FMAs, __dsqrt_rn, IEEE division; c1 = 1 - b1**t, c2 = 1 - b2**t
// from the host's table): updates mu and nu, returns the parameter
__device__ __forceinline__ double adam(double g, double& mu, double& nu,
                                       double p, double c1, double c2,
                                       double lr, double b1, double b2,
                                       double omb1, double omb2,
                                       double eps) {
    mu = __fma_rn(g, omb1, dmul(mu, b1));
    nu = __fma_rn(dmul(g, g), omb2, dmul(nu, b2));
    const double nu_hat = nu / c2;
    const double upd = mu / dmul(c1, dadd(__dsqrt_rn(nu_hat), eps));
    return __fma_rn(upd, -lr, p);
}

enum Sync { kCluster, kGrid };

// Where a fit's blocks sit: its first locus in the operands, this block's
// rank among its blocks, the fit's blocks, and the blocks that meet at its
// barrier (its cluster's; `blocks` but where a batched launch's clusters
// are wider)
struct Place {
    long long base;
    unsigned rank, blocks, width;
};

template <class Obs>
struct FitArgs {
    Obs obs;                // the policy's operands
    long long n;
    int per, n_steps;
    const double* bias;     // [n_steps, 2]
    double* state;          // [P::kState]
    double* loc;            // [P::kRows, n], the global regime's
    double* partials;       // [2, blocks, P::kSums], the grid regimes'
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

// The body of a fit kernel (a __global__ of 256 threads calls it) at
// place `at`. P:
//   Obs, Consts, Scalars; kRows, kSums (<= 32), kParams (<= 32), kState;
//   kFinalLoss;
//   prep(obs, j, consts, v[kRows]): locus j's parameter-free values;
//   terms(v, scalars, consts, out[kSums]): a locus's terms at a step;
//   start(state, st, scalars, consts, lane): warp 0, before step 1: st
//     from the state buffer, step 1's scalars;
//   step(t, tot[kSums], st, scalars, next, lane, c1, c2, consts): warp
//     0's tail of step t (the sums in tot): the state in st, the next
//     step's scalars in next;
//   finish(tot[kSums], st, lane): warp 0, after the final loss's pass.
template <class P, Sync kSync, bool kOnChip>
__device__ __forceinline__ void fit_body(const FitArgs<typename P::Obs>& a,
                                         const typename P::Consts& c,
                                         const Place& at) {
    constexpr int kSums = P::kSums, kRows = P::kRows;
    // every block's partials, in order: a cluster's up to kMaxCluster
    constexpr int kStage = (kSync == kCluster ? kMaxCluster : kMaxBlocks)
                           * kSums;
    extern __shared__ double on_chip[];          // [kRows][per * 256]
    __shared__ double warp_sums[kSums][kWarps];
    __shared__ double xpart[2][kSums];           // the cluster's partials
    __shared__ double stage[kStage];
    __shared__ double st[P::kState];             // the state, warp 0's
    __shared__ typename P::Scalars rs[2];        // step t's in rs[t & 1]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned blocks = at.blocks;
    const int per = a.per;
    const long long n = a.n;
    const long long first = static_cast<long long>(at.rank) * per
                            * kThreads + tid;
    // this thread's loci, once a fit: on chip, or in loc past it
    double* rows = kOnChip ? on_chip : a.loc;
    const long long stride = kOnChip ? static_cast<long long>(per) * kThreads
                                     : n;
    for (int i = 0; i < per; ++i) {
        const long long j = first + static_cast<long long>(i) * kThreads;
        if (j < n) {
            double v[kRows];
            P::prep(a.obs, at.base + j, c, v);
            const long long to = kOnChip ? i * kThreads + tid : j;
#pragma unroll
            for (int k = 0; k < kRows; ++k) rows[k * stride + to] = v[k];
        }
    }
    if (warp == 0) P::start(a.state, st, rs[1], c, lane);
    __syncthreads();

    const int last = a.n_steps + (P::kFinalLoss ? 1 : 0);
    for (int t = 1; t <= last; ++t) {
        const int par = t & 1;
        const bool adam_step = t <= a.n_steps;
        double c1 = 0.0, c2 = 0.0;
        if (tid < P::kParams && adam_step) {
            c1 = a.bias[2 * (t - 1)];
            c2 = a.bias[2 * (t - 1) + 1];
        }
        const typename P::Scalars& r = rs[par];
        double acc[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
        for (int i = 0; i < per; ++i) {
            const long long j = first + static_cast<long long>(i) * kThreads;
            double term[kSums];
            if (j < n) {
                const long long from = kOnChip ? i * kThreads + tid : j;
                double v[kRows];
#pragma unroll
                for (int k = 0; k < kRows; ++k) v[k] = rows[k * stride + from];
                P::terms(v, r, c, term);
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
                                + at.rank) * kSums + k] = s;
            }
        }
        // the step's barrier, then every block's partials into the stage
        if constexpr (kSync == kCluster) {
            cg::cluster_group cluster = cg::this_cluster();
            if (at.width > 1)
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
            if (adam_step)
                P::step(t, tot, st, r, rs[par ^ 1], lane, c1, c2, c);
            else
                P::finish(tot, st, lane);
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
    if (at.rank == 0 && tid == 0)
#pragma unroll
        for (int k = 0; k < P::kState; ++k) a.state[k] = st[k];
}

// fit_body of a launch that runs one fit on its whole grid
template <class P, Sync kSync, bool kOnChip>
__device__ __forceinline__ void fit_body(const FitArgs<typename P::Obs>& a,
                                         const typename P::Consts& c) {
    fit_body<P, kSync, kOnChip>(a, c,
                                Place{0, blockIdx.x, gridDim.x, gridDim.x});
}

// A batched launch's operands: every fit's observations concatenated;
// work [items, kWorkCols] int64, a fit a row: its first locus in obs, its
// loci, its blocks, its loci a thread (on chip) and its state's slot in
// states [slots, P::kState] (its start in, every slot out); the bias
// corrections [n_steps, 2] of every fit
constexpr int kWorkCols = 5;
template <class Obs>
struct BatchArgs {
    Obs obs;
    const long long* work;
    int n_steps;
    const double* bias;
    double* states;
};

// The body of a batched fit kernel: cluster c of the launch runs fit c of
// the work list in the cluster regime, its blocks the cluster's first
// ranks
template <class P>
__device__ __forceinline__ void batch_body(
    const BatchArgs<typename P::Obs>& a, const typename P::Consts& c) {
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned width = cluster.num_blocks();
    const long long* w = a.work + kWorkCols * (blockIdx.x / width);
    const FitArgs<typename P::Obs> f{
        a.obs, w[1], static_cast<int>(w[3]), a.n_steps, a.bias,
        a.states + w[4] * P::kState, nullptr, nullptr, nullptr};
    fit_body<P, kCluster, true>(
        f, c, Place{w[0], cluster.block_rank(), static_cast<unsigned>(w[2]),
                    width});
}

// a fit kernel's three instantiations: <kCluster, true>, <kGrid, true>,
// <kGrid, false>; cluster null where the policy's cluster-regime fits run
// through batch_body (launch_batch, one cluster a fit) and launch() takes
// the grid regimes only
template <class Obs, class Consts>
struct Kernels {
    using Fn = void (*)(FitArgs<Obs>, Consts);
    Fn cluster, grid, global;
};

// the kernels' attributes: dynamic shared memory up to `dyn` bytes (the
// on-chip rows at their most), the shared-memory carveout at its most,
// clusters past 8 (as far as the card takes them)
template <class Obs, class Consts>
cudaError_t configure(const Kernels<Obs, Consts>& k, size_t dyn) {
    cudaError_t e = cudaSuccess;
    auto set = [&](typename Kernels<Obs, Consts>::Fn fn) {
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(dyn));
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
    };
    if (k.cluster) set(k.cluster);
    set(k.grid);
    if (e == cudaSuccess && k.cluster)
        e = cudaFuncSetAttribute(
            k.cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
}

// The co-resident blocks of a fit's kernels on the current card, at most
// kMaxBlocks: the occupancy of its grid kernels (on chip at `dyn` bytes,
// and the global regime's) times the SMs. Returns a cudaError_t.
template <class Obs, class Consts>
int resident_blocks(const Kernels<Obs, Consts>& k, size_t dyn, int* out) {
    int dev = 0, sms = 0, on_chip = 0, global = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = configure(k, dyn);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&on_chip, k.grid,
                                                          kThreads, dyn);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&global, k.global,
                                                          kThreads, 0);
    const int per_sm = on_chip < global ? on_chip : global;
    *out = per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
    return static_cast<int>(e);
}

// A batched launch on `stream`: `items` thread-block clusters of `width`
// blocks, cluster c running fit c of a.work (each fit's blocks <= width,
// its loci a thread <= max_per <= on_chip_per(rows), blocks * per * 256
// covering its loci: the caller's to hold), the dynamic shared memory of
// max_per loci a thread. The card refuses a cluster width it cannot
// place; the clusters need no co-residency. Returns a cudaError_t.
template <class Obs, class Consts>
int launch_batch(void (*fn)(BatchArgs<Obs>, Consts), const BatchArgs<Obs>& a,
                 const Consts& c, int items, int width, int max_per,
                 int rows, cudaStream_t stream) {
    const int cap = on_chip_per(rows);
    if (items < 1 || width < 1 || width > kMaxCluster || max_per < 1
        || max_per > cap || a.n_steps < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t row_bytes = static_cast<size_t>(rows) * sizeof(double);
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(cap * kThreads * row_bytes));
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(items) * width);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = max_per * kThreads * row_bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(width);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, fn, a, c);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// One whole fit on `stream`: `blocks` blocks of 256 threads, a.per loci a
// thread (blocks * per * 256 >= n, blocks <= kMaxBlocks), the loci on
// chip where per <= on_chip_per(rows) (row_bytes = rows * 8 a locus);
// `cluster` 1: the grid one thread-block cluster (on chip only, k.cluster
// not null; the card refuses a size it cannot place), else a cooperative
// launch (the card
// refuses a grid that is not co-resident), with a.partials and
// a.arrivals; a.loc where not on chip. Returns a cudaError_t.
template <class Obs, class Consts>
int launch(const Kernels<Obs, Consts>& k, const FitArgs<Obs>& a,
           const Consts& c, int blocks, int cluster, int rows,
           cudaStream_t stream) {
    const int max_per = on_chip_per(rows);
    const bool on_chip = a.per <= max_per;
    if (a.n < 1 || blocks < 1 || blocks > kMaxBlocks || a.per < 1
        || a.n_steps < 1
        || static_cast<long long>(blocks) * a.per * kThreads < a.n
        || (cluster && (!on_chip || k.cluster == nullptr))
        || (!cluster && (a.partials == nullptr || a.arrivals == nullptr))
        || (!on_chip && a.loc == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t row_bytes = static_cast<size_t>(rows) * sizeof(double);
    cudaError_t e = configure(k, max_per * kThreads * row_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = on_chip ? a.per * kThreads * row_bytes : 0;
    cfg.stream = stream;
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
        e = cudaLaunchKernelEx(&cfg, k.cluster, a, c);
    else if (on_chip)
        e = cudaLaunchKernelEx(&cfg, k.grid, a, c);
    else
        e = cudaLaunchKernelEx(&cfg, k.global, a, c);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace fitgrid
