// KG-R: RNA mode's germline SNV genotype tile, on Hopper (sm_90a).
//
// Replaces the RNA branch (het_vf_extension > 0) of
// strelka_tpu/models/snv_digt.py:536 call_snv_tile, a jitted XLA program
// (no Pallas), whose plain version in the port is
// models/snv_digt.call_snv_rna_tile_plain: torch ops a chunk that follow
// XLA's CPU arithmetic, and a read-back of the chunk's live (qscore,
// base) slots to the host. This kernel gives that version's bits in one
// launch, with nothing read back. Per row of base, qual, mask [L, D] and
// the optional per-call dependent-eprob deltas dep [L, D]:
//
//   hist[min(q, 127) * 4 + base] += 1 over the masked calls, 0 <= base < 4
//   lhood[g] = (a0 + a1) + (a2 + a3), a_j = fma(hist[k], qtab[k, g], a_j)
//     over the slots k = j (mod 4) ascending       (_xla_hist_lhood)
//   with dep: s[b] = sum of dep over base b's masked calls (xla_sum_major),
//     lhood[g] += (s0 e0[0,g] + s1 e0[1,g]) + (s2 e0[2,g] + s3 e0[3,g])
//   het g: lhood[g] = logsumexp(lhood[g], its 2 n_steps het-VF sums) -
//     ln(1 + 2 n_steps), a sum taking each masked call's het-VF value of
//     its bias key (xla_sum_minor)      (_het_vf_extension_lhoods, _combine)
//   then the float64 tail (_tile_tail) of csrc/snv_tile_tail.cuh, KG-H's.
//
// A slot whose count is 0 adds exactly nothing (fma(0, q, a) == a: qtab
// is finite and a chain never -0; tests/test_torch_kgh_schedule.py), so a
// row walks its own live slots where the plain version walks the chunk's.
//
// Bound on the H100: the bytes, 8 a call (base, int16 qual, mask, the f32
// delta) and 113 a row; its f32 work, 12 n_steps + 4 sums of D terms a
// row and 6 logsumexps of 2 n_steps + 1 terms, is below them at 67
// TFLOP/s. What holds it above the bound is that each sum is a serial
// chain in XLA's order: D terms a sum, 12 n_steps + 4 sums a row, each
// term a read of a value that depends on the call and the sum; its
// design floor is the shared-memory reads, one a term.
//
// Design: one warp a row, eight warps a block, a grid of as many blocks
// as the card holds at once (the launch's dynamic shared memory counted),
// each warp walking rows. A row's sums are items, laid out step-major
// (item st * 12 + 2 h + r: het genotype 4 + h's sum at step st, r = 1
// the low ratio; then the 4 delta sums): lane l takes items it0 + 4 l ..
// it0 + 4 l + 3, two pairs of neighbours, in passes of 128 (one pass at
// n_steps <= 10). The warp walks the row's calls a window of 32 at a time
// (walk, csrc/snv_xla_math.cuh): lane l fetches call l of the next window
// into registers while the lanes sum the current one, then decodes it
// once into a row of values in shared memory, in pairs of floats (+0 +0;
// the mismatch value plus its delta, twice; the delta of a used call of
// base 0-3 beside +0 and after it; each of the pass's steps' key 1 and
// key 2 values, in both orders; all +0 for a call masked out), read from
// the het-VF table in global memory and written by 128-bit stores, and
// its bias index, and counts it into the warp's 512-bin histogram on the
// first pass. A pair of items takes its two values from one pair of columns: a
// het genotype's high and low ratio are keys (k, low(k)), that is (0,
// 0), (1, 2) or (2, 1); the delta sums of bases x and x + 1 are (d, 0),
// (0, d) or (0, 0). A pair's map holds, for each bias index, the byte
// offset of its pair (EXPECT2_BIAS, the low-ratio remap), fixed once a
// pass, so that two terms are one byte select, one 64-bit shared read
// and two adds, with no branch; each lane's four sums run side by side.
// Then KG-H's
// walk over the histogram's live slots (count_call and for_live_slots,
// csrc/snv_tile_tail.cuh), with the four chains of the dot order on every
// lane g = lane % 10, the delta term, and the six logsumexps spread over
// the lanes (lse_spread); the row's lhoods wait in the warp's batch for
// KG-H's three-row tail. qtab, e0 and the priors are staged once a block
// as KG-H stages them.
#include <cuda_runtime.h>

#include <cstdint>

#include "snv_math.cuh"
#include "snv_tile_tail.cuh"
#include "snv_xla_math.cuh"

namespace {

using namespace snv_tile;
using namespace snv_xla;

constexpr int kWarps = 8;
constexpr int kPer = 4;             // items a lane in a pass
constexpr int kPass = 32 * kPer;
constexpr int kHets = 6;
constexpr int kStepItems = 2 * kHets;   // a step's sums: 6 hets x 2 ratios
// the pairs of columns of a call's row: pair 0 (+0, +0), then (v0 +
// delta, the same), (delta, +0), (+0, delta) (the delta of a used call of
// base 0-3, +0 otherwise), then each of the pass's steps' (key 1, key 2)
// and (key 2, key 1)
constexpr int kV0 = 1, kDeltaLo = 2, kDeltaHi = 3, kStep0 = 4;
constexpr int kScratch = 16;        // the logsumexp's x0s and maxima

struct Lanes {
    const int8_t* base;
    const uint8_t* mask;
    const float* dep;             // [L, D] or null
    long long D;
};

// A window's call as a lane fetches it
struct Call {
    int b, q;
    bool m;
    float dd;
};

// The warp's dynamic shared memory, in floats: res (the row's sums, at
// least the tail's 32 doubles), the logsumexp's scratch, the calls' bias
// selectors and their rows
struct Layout {
    int res, rs, stride;     // res floats, a call row's floats, a warp's
};

// the byte offset of het genotype 4 + h's pair at step st (of the pass)
// for bias index bi: keys (0, 0), (1, 2) or (2, 1) at the high and the
// low ratio
__device__ __forceinline__ unsigned het_pair(int h, int st, int bi) {
    const int key = expect2_bias(kBases + h, bi);
    return 8u * (key == 0 ? kV0 : kStep0 + 2 * st + key - 1);
}

// the steps [s0, s1) of the pass's het items from it0
__device__ __forceinline__ void pass_steps(int it0, int n_het, int& s0,
                                           int& s1) {
    s0 = it0 / kStepItems;
    const int last = min(it0 + kPass, n_het) - 1;
    s1 = it0 < n_het ? last / kStepItems + 1 : s0;
}

template <typename Q, bool kSmall>
__global__ void __launch_bounds__(kWarps * 32, 2)
snv_rna_tile_kernel(Lanes in, const Q* __restrict__ qual, Row rin, Tables t,
                    const float* __restrict__ het, int n_steps, Layout lay,
                    long long L, Out o) {
    __shared__ Staged s;
    __shared__ __align__(16) int h_s[kWarps][kSlots];
    __shared__ float lh_s[kWarps][kBatch][kGt];
    __shared__ int ref_s[kWarps][kBatch];
    __shared__ uint8_t hap_s[kWarps][kBatch];
    extern __shared__ __align__(16) float dyn_s[];
    stage(s, t);     // ends in __syncthreads()
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane % kGt;
    int* h = h_s[w];
    float* res = dyn_s + w * lay.stride;
    float* x0s = res + lay.res;
    float* mxs = x0s + kScratch / 2;
    unsigned* sel_s = reinterpret_cast<unsigned*>(x0s + kScratch);
    float* rows = x0s + kScratch + 32;
    Batch batch{lh_s[w], ref_s[w], hap_s[w], reinterpret_cast<double*>(res),
                0, 0};
    clear_bins(h, lane);
    const bool dep = in.dep != nullptr;
    const int n_het = kStepItems * n_steps;
    const int n_items = n_het + (dep ? kBases : 0);
    const Windows win(in.D);
    const long long step = static_cast<long long>(gridDim.x) * kWarps;
    long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
    while (row < L) {    // a batch: up to kBatch of the warp's rows
        batch.first = row;
        for (batch.n = 0; batch.n < kBatch && row < L; ++batch.n) {
            const RowVals v = load_row(rin, row);
            const long long off = row * in.D;
            for (int it0 = 0; it0 < n_items; it0 += kPass) {
                int s0, s1;
                pass_steps(it0, n_het, s0, s1);
                // each pair's byte offset for bias index b in byte b
                unsigned map[kPer / 2];
#pragma unroll
                for (int k = 0; k < kPer / 2; ++k) {
                    const int it = it0 + kPer * lane + 2 * k;
                    unsigned mp = 0;
                    if (it < n_het) {
                        const int st = it / kStepItems - s0;
                        const int h = it % kStepItems >> 1;
#pragma unroll
                        for (int bi = 0; bi < kBases; ++bi)
                            mp |= het_pair(h, st, bi) << 8 * bi;
                    } else if (it < n_items) {   // bases x, x + 1
                        const int x = it - n_het;
                        mp = 8u * kDeltaLo << 8 * x
                             | 8u * kDeltaHi << 8 * (x + 1);
                    }
                    map[k] = mp;
                }
                auto fetch = [&](long long p0, int n) {
                    Call c{0, 0, false, 0.0f};
                    if (lane < n) {
                        const long long i = off + p0 + lane;
                        c.b = in.base[i];
                        c.q = qual255(qual[i]);
                        c.m = in.mask[i];
                        if (dep) c.dd = in.dep[i];
                    }
                    return c;
                };
                auto commit = [&](const Call& c, int n) {
                    if (lane >= n) return;
                    float4* r = reinterpret_cast<float4*>(rows + lane
                                                          * lay.rs);
                    const float* hq = het + c.q;
                    const float v0 = __ldg(hq);
                    const float vd = c.m ? (dep ? __fadd_rn(v0, c.dd) : v0)
                                         : 0.0f;
                    const float dx = c.m && c.b >= 0 && c.b < kBases
                        ? c.dd : 0.0f;
                    r[0] = make_float4(0.0f, 0.0f, vd, vd);
                    r[1] = make_float4(dx, 0.0f, 0.0f, dx);
                    for (int st = s0; st < s1; ++st) {
                        const float k1 = __ldg(hq + (st * 4 + 1) * kVals);
                        const float k2 = __ldg(hq + (st * 4 + 2) * kVals);
                        r[kStep0 / 2 + st - s0] = c.m
                            ? make_float4(k1, k2, k2, k1)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                    }
                    sel_s[lane] = byte_sel(bias_index(c.b));
                    if (it0 == 0) count_call(h, c.m, c.b, c.q);
                };
                auto term = [&](int i, float (&x)[kPer]) {
                    const unsigned sel = sel_s[i];
                    const char* r = reinterpret_cast<const char*>(
                        rows + i * lay.rs);
#pragma unroll
                    for (int k = 0; k < kPer / 2; ++k) {
                        const float2 v = *reinterpret_cast<const float2*>(
                            r + __byte_perm(map[k], 0, sel));
                        x[2 * k] = v.x;
                        x[2 * k + 1] = v.y;
                    }
                };
                auto variant = [&](int k) {
                    return it0 + kPer * lane + k < n_het
                        ? minor_variant(in.D) : static_cast<int>(kSeq);
                };
                float out[kPer];
                walk<kPer, kSmall>(win, fetch, commit, term, variant, out);
#pragma unroll
                for (int k = 0; k < kPer; ++k)
                    if (it0 + kPer * lane + k < n_items)
                        res[it0 + kPer * lane + k] = out[k];
            }
            __syncwarp();
            // XLA's dot order: four chains, slot k on chain k mod 4
            float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
            for_live_slots(h, lane, [&](int k) {
                const float cnt = static_cast<float>(h[k]);
                const float tq = s.qtab[k * kGt + g];
                switch (k & 3) {
                case 0: a0 = __fmaf_rn(cnt, tq, a0); break;
                case 1: a1 = __fmaf_rn(cnt, tq, a1); break;
                case 2: a2 = __fmaf_rn(cnt, tq, a2); break;
                default: a3 = __fmaf_rn(cnt, tq, a3); break;
                }
            });
            float lh = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
            if (dep) {
                const float* sm = res + n_het;
                const float d = __fadd_rn(
                    __fadd_rn(__fmul_rn(sm[0], s.e0[g]),
                              __fmul_rn(sm[1], s.e0[kGt + g])),
                    __fadd_rn(__fmul_rn(sm[2], s.e0[2 * kGt + g]),
                              __fmul_rn(sm[3], s.e0[3 * kGt + g])));
                lh = __fadd_rn(lh, d);
            }
            // het genotype 4 + hh's sums: items st * 12 + 2 hh + r
            lh = lse_spread(
                lh, lane >= kBases && lane < kGt ? lane - kBases : -1, kHets,
                2 * n_steps,
                [&](int hh, int k) {
                    return res + (k >> 1) * kStepItems + 2 * hh + (k & 1);
                },
                x0s, mxs, lane);
            clear_bins(h, lane);    // for the next row
            stage_row(batch, batch.n, lh, v, row, o, lane);
            row += step;
        }
        __syncwarp();
        batch_tail(s, batch, step, o, lane);
        __syncwarp();
    }
}

// The warp's dynamic shared memory at n_steps: the row's sums (at least
// the tail's 32 doubles), the scratch, the selectors and 32 call rows of
// 4 x an odd count of floats (a quarter warp's 128-bit writes of one
// column fall in distinct banks), the widest pass's
Layout layout(int n_steps) {
    const int items = 12 * n_steps + kBases;
    int steps = 0;
    for (int it0 = 0; it0 < items; it0 += kPass) {
        const int n_het = kStepItems * n_steps;
        if (it0 >= n_het) break;
        const int last = (it0 + kPass < n_het ? it0 + kPass : n_het) - 1;
        const int w = last / kStepItems + 1 - it0 / kStepItems;
        steps = w > steps ? w : steps;
    }
    Layout lay;
    lay.res = ((items > 64 ? items : 64) + 3) & ~3;   // rows 16-byte aligned
    lay.rs = 4 * ((kStep0 / 2 + steps) | 1);
    lay.stride = lay.res + kScratch + 32 + 32 * lay.rs;
    return lay;
}

size_t dynamic_bytes(const Layout& lay) {
    return sizeof(float) * static_cast<size_t>(kWarps) * lay.stride;
}

template <typename Q, bool kSmall>
cudaError_t grid(long long L, const Layout& lay, long long* blocks,
                 long long* per_sm) {
    auto kernel = snv_rna_tile_kernel<Q, kSmall>;
    const size_t dyn = dynamic_bytes(lay);
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
           Row rin, Tables t, const void* het, Out o) {
    const Layout lay = layout(n_steps);
    long long blocks = 0;
    cudaError_t err = grid<Q, kSmall>(L, lay, &blocks, nullptr);
    if (err != cudaSuccess) return static_cast<int>(err);
    snv_rna_tile_kernel<Q, kSmall>
        <<<static_cast<unsigned>(blocks), kWarps * 32, dynamic_bytes(lay),
           static_cast<cudaStream_t>(stream)>>>(
        in, qual, rin, t, static_cast<const float*>(het), n_steps, lay, L,
        o);
    return static_cast<int>(cudaGetLastError());
}

template <typename Q>
int launch(long long L, int n_steps, void* stream, Lanes in, const Q* qual,
           Row rin, Tables t, const void* het, Out o) {
    if (n_steps < 1 || n_steps > kMaxSteps || in.D < 0 || in.D > kMaxDepth)
        return static_cast<int>(cudaErrorInvalidValue);
    return in.D <= 32
        ? launch<Q, true>(L, n_steps, stream, in, qual, rin, t, het, o)
        : launch<Q, false>(L, n_steps, stream, in, qual, rin, t, het, o);
}

}  // namespace

extern "C" {

// base [L, D] int8, qual [L, D] uint8 (qual_bytes 1) or int16 (2), mask
// [L, D] bool, D in 0 .. 2^20; het [n_steps, 4, 256] f32
// (_het_vf_table: its key 0 values the same at every step, as it builds
// them), 1 <= n_steps <= 40; ref_gt [L] int32 in 0..4; hap [L] bool or
// null; dep [L, D] f32 or null; qtab [512, 10] f32, e0 [4, 10] f32, the
// four [5, 10] float64 ln prior tables (genome, poly, genome_haploid,
// poly_haploid); all contiguous on one device, L >= 1. Out: as
// snv_hist_tile_launch's (lhood [L, 10] f32, genome_max_gt, poly_max_gt,
// snv_qphred, genome_max_gt_qphred, poly_max_gt_qphred [L] int32,
// phred_loghood [L, 10] int32, ln_ref_pprob [L] float64). Launches on
// `stream`; returns cudaGetLastError() (or an invalid-value error for
// operands out of range).
int snv_rna_tile_launch(const void* base, const void* qual, int qual_bytes,
                        const void* mask, long long D, const void* het,
                        int n_steps, const void* ref_gt, const void* hap,
                        const void* dep, const void* qtab, const void* e0,
                        const void* prior_genome, const void* prior_poly,
                        const void* prior_genome_haploid,
                        const void* prior_poly_haploid, long long L,
                        void* lhood, void* g_max, void* p_max, void* snv_q,
                        void* g_qmax, void* p_qmax, void* pl, void* ln_ref,
                        void* stream) {
    const Lanes in{static_cast<const int8_t*>(base),
                   static_cast<const uint8_t*>(mask),
                   static_cast<const float*>(dep), D};
    const Tables t = tables(qtab, e0, prior_genome, prior_poly,
                            prior_genome_haploid, prior_poly_haploid);
    const Out o = outputs(lhood, g_max, p_max, snv_q, g_qmax, p_qmax, pl,
                          ln_ref);
    const Row rin = row_inputs(ref_gt, hap, nullptr);
    if (qual_bytes == 1)
        return launch(L, n_steps, stream, in,
                      static_cast<const uint8_t*>(qual), rin, t, het, o);
    if (qual_bytes == 2)
        return launch(L, n_steps, stream, in,
                      static_cast<const int16_t*>(qual), rin, t, het, o);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The grid snv_rna_tile_launch takes for L rows at n_steps and D (int16
// qual): out[0] its blocks, out[1] the blocks an SM holds by the
// occupancy API with the launch's dynamic shared memory, out[2] the SMs.
// Returns a CUDA error code (0 on success).
int snv_rna_tile_grid(long long L, int n_steps, long long D,
                      long long* out) {
    if (n_steps < 1 || n_steps > kMaxSteps || L < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const Layout lay = layout(n_steps);
    const cudaError_t err = D <= 32
        ? grid<int16_t, true>(L, lay, out, out + 1)
        : grid<int16_t, false>(L, lay, out, out + 1);
    int dev = 0, sms = 0;
    if (err != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
        return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
    out[2] = sms;
    return 0;
}

}  // extern "C"
