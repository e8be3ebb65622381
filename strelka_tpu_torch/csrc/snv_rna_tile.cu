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
// TFLOP/s. What holds it above the bound is each lane's serial chain of
// adds and table reads (some 4 D a row), and the float64 tail.
//
// Design (simple, right first): one warp a row, eight warps a block, a
// grid of as many blocks as the card holds at once, each warp walking
// rows. The row's 12 n_steps het-VF sums (6 het genotypes x n_steps x
// high and low ratio) and 4 delta sums are items, one to a lane, in
// passes of 32 (four at the CLI's n_steps = 9). The warp stages the
// row's calls a window of 32 at a time in shared memory (lane l loads
// call l, coalesced, and counts it into the warp's 512-bin histogram by
// a shared atomic on the first pass), each lane adds its item's terms in
// order and folds a window's sum into XLA's upper levels
// (csrc/snv_xla_math.cuh, row_sums; SmallSum at D <= 32). Then KG-H's
// lanes-entry walk over the histogram's live slots (count_call and
// for_live_slots, csrc/snv_tile_tail.cuh), with the four chains of the
// dot order on every lane g = lane % 10, the delta term and the
// logsumexp; the row's
// lhoods wait in the warp's batch for KG-H's three-row tail. The tables
// (qtab, e0 and the priors as KG-H stages them; the het-VF table
// [n_steps, 4, 256] with rows a float apart) are staged once a block.
#include <cuda_runtime.h>

#include <cstdint>

#include "snv_math.cuh"
#include "snv_tile_tail.cuh"
#include "snv_xla_math.cuh"

namespace {

using namespace snv_tile;
using namespace snv_xla;

constexpr int kWarps = 8;

// a sum of the row: het genotype gt's het-VF sum at a step, x = 1 for
// the low ratio; or (gt -1) the delta sum of base x
struct RnaItem {
    int gt, step, x;
};

struct Lanes {
    const int8_t* base;
    const uint8_t* mask;
    const float* dep;             // [L, D] or null
    long long D;
};

template <typename Q>
__global__ void __launch_bounds__(kWarps * 32)
snv_rna_tile_kernel(Lanes in, const Q* __restrict__ qual, Row rin, Tables t,
                    const float* __restrict__ het, int n_steps,
                    int res_stride, long long L, Out o) {
    __shared__ Staged s;
    __shared__ __align__(16) int h_s[kWarps][kSlots];
    __shared__ Calls calls_s[kWarps];
    __shared__ float lh_s[kWarps][kBatch][kGt];
    __shared__ int ref_s[kWarps][kBatch];
    __shared__ uint8_t hap_s[kWarps][kBatch];
    extern __shared__ __align__(16) float dyn_s[];
    stage_het(dyn_s, het, n_steps);
    stage(s, t);     // ends in __syncthreads()
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane % kGt;
    Calls& c = calls_s[w];
    int* h = h_s[w];
    const float* het_s = dyn_s;
    // the row's sums; the tail's scratch between a batch's rows
    float* res = dyn_s + n_steps * 4 * kHetStride + w * res_stride;
    Batch batch{lh_s[w], ref_s[w], hap_s[w], reinterpret_cast<double*>(res),
                0, 0};
    clear_bins(h, lane);
    const bool dep = in.dep != nullptr;
    const int n_het = 12 * n_steps;          // 6 hets x n_steps x 2
    const int n_items = n_het + (dep ? kBases : 0);
    const Windows win(in.D);
    const long long step = static_cast<long long>(gridDim.x) * kWarps;
    long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
    while (row < L) {    // a batch: up to kBatch of the warp's rows
        batch.first = row;
        for (batch.n = 0; batch.n < kBatch && row < L; ++batch.n) {
            const RowVals v = load_row(rin, row);
            const long long off = row * in.D;
            auto load = [&](long long p0, int n, bool count) {
                if (lane < n) {
                    const long long i = off + p0 + lane;
                    const int b = in.base[i];
                    const int q = qual255(qual[i]);
                    const bool m = in.mask[i];
                    c.b[lane] = static_cast<int8_t>(b);
                    c.q[lane] = static_cast<uint8_t>(q);
                    c.mf[lane] = m ? 1 : 0;
                    c.dd[lane] = dep ? in.dep[i] : 0.0f;
                    if (count) count_call(h, m, b, q);
                }
            };
            auto prep = [&](int it) {
                return it < n_het
                    ? RnaItem{kBases + it / (2 * n_steps),
                              (it % (2 * n_steps)) >> 1,
                              (it % (2 * n_steps)) & 1}
                    : RnaItem{-1, 0, it - n_het};   // base it - n_het's deltas
            };
            auto variant = [&](int it) {
                return it < n_het ? minor_variant(in.D)
                                  : static_cast<int>(kSeq);
            };
            auto term = [&](const RnaItem& d, int i) -> float {
                const bool m = c.mf[i] & 1;
                if (d.gt < 0)
                    return m && c.b[i] == d.x ? c.dd[i] : 0.0f;
                int key = expect2_bias(d.gt, bias_index(c.b[i]));
                if (d.x) key = low_key(key);
                float v = het_s[(d.step * 4 + key) * kHetStride + c.q[i]];
                if (dep && key == 0) v = __fadd_rn(v, c.dd[i]);
                return m ? v : 0.0f;
            };
            row_sums(win, n_items, lane, load, prep, term, variant, res);
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
            if (g >= kBases)
                lh = het_combine(lh, res + (g - kBases) * 2 * n_steps,
                                 n_steps);
            __syncwarp();
            clear_bins(h, lane);    // for the next row
            stage_row(batch, batch.n, lh, v, row, o, lane);
            row += step;
        }
        __syncwarp();
        batch_tail(s, batch, step, o, lane);
        __syncwarp();
    }
}

template <typename Q>
int launch(long long L, int n_steps, void* stream, Lanes in, const Q* qual,
           Row rin, Tables t, const void* het, Out o) {
    if (n_steps < 1 || n_steps > kMaxSteps || in.D < 0 || in.D > kMaxDepth)
        return static_cast<int>(cudaErrorInvalidValue);
    // the row's sums, at least the tail's 32 doubles, 8-byte aligned
    const int items = 12 * n_steps + kBases;
    const int res_stride = ((items > 64 ? items : 64) + 1) & ~1;
    const size_t dyn = sizeof(float) * (static_cast<size_t>(n_steps) * 4
                                        * kHetStride
                                        + kWarps * res_stride);
    auto kernel = snv_rna_tile_kernel<Q>;
    cudaError_t err = allow_dynamic(kernel, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = snv::resident_blocks(
        kernel, kWarps * 32, (L + kWarps - 1) / kWarps);
    kernel<<<static_cast<unsigned>(blocks), kWarps * 32, dyn,
             static_cast<cudaStream_t>(stream)>>>(
        in, qual, rin, t, static_cast<const float*>(het), n_steps,
        res_stride, L, o);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// base [L, D] int8, qual [L, D] uint8 (qual_bytes 1) or int16 (2), mask
// [L, D] bool, D in 0 .. 2^20; het [n_steps, 4, 256] f32
// (_het_vf_table), 1 <= n_steps <= 40; ref_gt [L] int32 in 0..4; hap [L]
// bool or null; dep [L, D] f32 or null; qtab [512, 10] f32, e0 [4, 10]
// f32, the four [5, 10] float64 ln prior tables (genome, poly,
// genome_haploid, poly_haploid); all contiguous on one device, L >= 1.
// Out: as snv_hist_tile_launch's (lhood [L, 10] f32, genome_max_gt,
// poly_max_gt, snv_qphred, genome_max_gt_qphred, poly_max_gt_qphred [L]
// int32, phred_loghood [L, 10] int32, ln_ref_pprob [L] float64).
// Launches on `stream`; returns cudaGetLastError() (or an invalid-value
// error for operands out of range).
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

}  // extern "C"
