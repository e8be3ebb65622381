// KS-G: the somatic SNV frequency-grid lhoods of one sample's pileup tile,
// on Hopper (sm_90a).
//
// Replaces strelka_tpu/models/somatic_snv.py:102 freq_grid_lhoods, a jitted
// XLA program (no Pallas), whose plain version in the port is
// models/somatic_snv.freq_grid_lhoods_plain: a scatter-add histogram, then
// 2 + 8 [L, 128] x [128, F] products summed in the XLA CPU dot's order with
// each FMA emulated exactly, a read-back of the live slots to the host and
// hundreds of launches a tile. This kernel gives that version's bits in one
// launch. Per row of base/qual/mask/is_fwd [L, D] and ref_gt [L]:
//
//   hist[q * 4 + (is_alt << 1 | is_fwd)] += 1 over the masked lanes
//     (q = clamp(qual, 0, 127), is_alt = base != ref_gt)
//   dot(h, tab)[f] = (a0 + a1) + (a2 + a3), a_j = fma(h[k], tab[k, f], a_j)
//     over k = j (mod 4), k ascending
//   grid states f < 21: dot(h_ref, ref_m) + dot(h_alt, alt_m)
//   strand states s < 9: fwd = ((on_ref(ref_fwd) + on_alt(alt_fwd))
//     + off_ref(ref_rev)) + off_alt(alt_rev), rev the same with the strands
//     swapped, then f32(logaddexp(f64 fwd, f64 rev)) + f32 ln 0.5
//
// with the q = 0 -inf entries re-applied exactly (ln(1 - e) = ln 0).
//
// Bound on the H100: it reads the tile once (D lanes of base, qual, mask
// and strand: 5 bytes a lane) and writes 120 bytes a row; its FMAs are 114
// a live qscore slot, and a row of the somatic CLI has 1-2 live slots (all
// reads at one base quality), so the bytes bound it.
//
// Design: one warp a row, eight warps a block, a grid of as many blocks as
// fit the card at once, each warp walking rows. A slot whose four counts
// are zero adds exactly nothing (fma(0, t, a) == a: the tables are finite
// and never -0), so a row walks only its live slots:
// - Counting: the lanes stride over the row's depth and add its calls
//   into the warp's 512-bin int32 histogram in shared memory with shared
//   atomics (integer counts: exact in any order). On the H100 this beat
//   counting by ballots (a ballot a live slot and stride) at one, five
//   and 128 live slots a row, even where all of a row's calls share one
//   bin. A ballot a 32-slot word then gives the row's 128-bit mask of
//   live slots.
// - The walk: the row's live slots in ascending order (__ffs over the
//   mask), one residue j = k mod 4 after the other, so that every
//   accumulator takes its slots in the plain version's order. Each live
//   slot's four counts are one broadcast read of the histogram.
// - Balanced lanes: the 21 x 2 grid dots and the 9 x 8 strand dots, 114
//   chains of four accumulators, lie four to a lane (chain slots 0-3, the
//   layout below), so that every lane does the same work a live slot
//   instead of 2 or 8 dots of 128 steps.
// - The combine: lanes 0-20 add their grid state's two dots, lanes 21-29
//   gather their strand state's other six dots by shuffles and add them in
//   the plain version's order, then take the float64 logaddexp.
// base is int8, qual int16 and ref_gt int32, as the native pileup holds
// them.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "snv_math.cuh"

namespace {

constexpr int kQ = 128;          // qscore bins (_QTAB_SIZE)
constexpr int kBins = 4 * kQ;    // (qscore, class) bins
constexpr int kF = 21;           // PRESTRAND_SIZE
constexpr int kS = 9;            // STRAND_STATE_SIZE
constexpr int kOut = kF + kS;    // GRID_SIZE
constexpr int kWarps = 8;
constexpr unsigned kAll = 0xffffffffu;
// histogram classes: (is_alt << 1) | is_fwd, so that a slot's four bins
// read as an int4 (rr, rf, ar, af): ref reverse, ref forward, alt
// reverse, alt forward

// The chains of lane l (tables: ref_m, alt_m [128, 21]; on_ref, on_alt,
// off_ref, off_alt [128, 9]; counts: ref = rr + rf, alt = ar + af):
//   slot 0: l < 21  ref_m col l, count ref       (grid state l)
//           l 21-29 on_ref col l-21, count rf    (strand l-21, fwd)
//   slot 1: l < 21  alt_m col l, count alt       (grid state l)
//           l 21-29 on_alt col l-21, count af    (fwd)
//   slot 2: l 0-8   off_ref col l, count rr      (fwd)
//           l 9-17  off_alt col l-9, count ar    (fwd)
//           l 18-26 on_ref col l-18, count rr    (rev)
//           l 27-31 on_alt col l-27, count ar    (rev, s 0-4)
//   slot 3: l 0-3   on_alt col l+5, count ar     (rev, s 5-8)
//           l 4-12  off_ref col l-4, count rf    (rev)
//           l 13-21 off_alt col l-13, count af   (rev)
//           l 22-31 none (count 0)
// tests/test_torch_somatic_schedule.py holds a numpy model of this layout.
struct Tables {
    const float* ref_m;      // [128, 21]
    const float* alt_m;      // [128, 21]
    const float* on_ref;     // [128, 9]
    const float* on_alt;     // [128, 9]
    const float* off_ref;    // [128, 9]
    const float* off_alt;    // [128, 9]
};

struct Chains {
    const float* tab[4];     // the table's column of each chain slot
    int ncol[4];             // its row stride
    bool grid;               // slots 0-1 hold grid dots (l < 21)
    bool slot2_alt;          // slot 2's count is ar, else rr
    bool slot3_ar, slot3_rf; // slot 3's count: ar, rf, else af
    bool slot3_live;
};

__device__ Chains lane_chains(const Tables& t, int l) {
    Chains c;
    c.grid = l < kF;
    const int s = l - kF;
    c.tab[0] = c.grid ? t.ref_m + l : t.on_ref + (s < kS ? s : 0);
    c.ncol[0] = c.grid ? kF : kS;
    c.tab[1] = c.grid ? t.alt_m + l : t.on_alt + (s < kS ? s : 0);
    c.ncol[1] = c.ncol[0];
    c.tab[2] = l < 9 ? t.off_ref + l
             : l < 18 ? t.off_alt + (l - 9)
             : l < 27 ? t.on_ref + (l - 18) : t.on_alt + (l - 27);
    c.ncol[2] = kS;
    c.slot2_alt = (l >= 9 && l < 18) || l >= 27;
    c.tab[3] = l < 4 ? t.on_alt + (l + 5)
             : l < 13 ? t.off_ref + (l - 4)
             : l < 22 ? t.off_alt + (l - 13) : t.off_alt;
    c.ncol[3] = kS;
    c.slot3_ar = l < 4;
    c.slot3_rf = l >= 4 && l < 13;
    c.slot3_live = l < 22;
    return c;
}

__global__ void __launch_bounds__(kWarps * 32)
somatic_grid_kernel(const int8_t* __restrict__ base,
                    const int16_t* __restrict__ qual,
                    const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ fwd,
                    const int32_t* __restrict__ ref, long long L, long long D,
                    Tables t, float ln_half, float* __restrict__ out) {
    __shared__ __align__(16) int h_s[kWarps][kBins];
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    int* h = h_s[w];
    int4* h4 = reinterpret_cast<int4*>(h);
    const Chains c = lane_chains(t, lane);
    const int s = lane >= kF && lane < kOut ? lane - kF : 0;   // strand
    const long long step = static_cast<long long>(gridDim.x) * kWarps;

    for (long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
         row < L; row += step) {
        for (int i = lane; i < kBins / 4; i += 32)
            h4[i] = make_int4(0, 0, 0, 0);
        __syncwarp();
        const int rg = ref[row];
        for (long long d = lane; d < D; d += 32) {
            const long long i = row * D + d;
            if (!mask[i]) continue;
            int q = qual[i];
            q = q < 0 ? 0 : (q > kQ - 1 ? kQ - 1 : q);
            atomicAdd(&h[q * 4 + (base[i] != rg ? 2 : 0) + (fwd[i] ? 1 : 0)],
                      1);
        }
        __syncwarp();
        // the row's live slots: bit l of word x for slot 32 x + l
        unsigned live[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int4 n = h4[32 * x + lane];
            live[x] = __ballot_sync(kAll, (n.x | n.y | n.z | n.w) != 0);
        }

        // the walk: a[i][j] is chain slot i's accumulator j = k mod 4
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                unsigned bits = live[x] & (0x11111111u << j);
                while (bits) {
                    const int k = 32 * x + __ffs(bits) - 1;
                    bits &= bits - 1;
                    const int4 n = h4[k];    // (rr, rf, ar, af) of slot k
                    const float rr = static_cast<float>(n.x);
                    const float rf = static_cast<float>(n.y);
                    const float ar = static_cast<float>(n.z);
                    const float af = static_cast<float>(n.w);
                    const float cnt[4] = {
                        c.grid ? static_cast<float>(n.x + n.y) : rf,
                        c.grid ? static_cast<float>(n.z + n.w) : af,
                        c.slot2_alt ? ar : rr,
                        !c.slot3_live ? 0.0f
                            : c.slot3_ar ? ar : (c.slot3_rf ? rf : af)};
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        a[i][j] = __fmaf_rn(
                            cnt[i], __ldg(c.tab[i] + k * c.ncol[i]),
                            a[i][j]);
                }
            }
        }
        float dot[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            dot[i] = __fadd_rn(__fadd_rn(a[i][0], a[i][1]),
                               __fadd_rn(a[i][2], a[i][3]));

        // a strand state's other six dots (lanes 21-29 read them)
        const float off_ref_f = __shfl_sync(kAll, dot[2], s);
        const float off_alt_f = __shfl_sync(kAll, dot[2], 9 + s);
        const float on_ref_r = __shfl_sync(kAll, dot[2], 18 + s);
        const float on_alt_lo = __shfl_sync(kAll, dot[2], 27 + (s < 5 ? s : 0));
        const float on_alt_hi = __shfl_sync(kAll, dot[3], s >= 5 ? s - 5 : 0);
        const float off_ref_r = __shfl_sync(kAll, dot[3], 4 + s);
        const float off_alt_r = __shfl_sync(kAll, dot[3], 13 + s);
        const int4 h0 = h4[0];       // the q = 0 counts
        float* o = out + row * kOut;
        if (lane < kF) {
            float lh = __fadd_rn(dot[0], dot[1]);
            if (lane == 0 && (h0.y > 0 || h0.x > 0)) lh = -INFINITY;
            if (lane == 1 && h0.w + h0.z > 0) lh = -INFINITY;
            o[lane] = lh;
        } else if (lane < kOut) {
            float lf = __fadd_rn(
                __fadd_rn(__fadd_rn(dot[0], dot[1]), off_ref_f), off_alt_f);
            float lr = __fadd_rn(
                __fadd_rn(__fadd_rn(on_ref_r, s < 5 ? on_alt_lo : on_alt_hi),
                          off_ref_r),
                off_alt_r);
            if (h0.x > 0) lf = -INFINITY;    // q = 0 ref call, reverse
            if (h0.y > 0) lr = -INFINITY;    // q = 0 ref call, forward
            const double v = snv::logaddexp(static_cast<double>(lf),
                                            static_cast<double>(lr));
            o[lane] = __fadd_rn(__double2float_rn(v), ln_half);
        }
        __syncwarp();    // the histogram is cleared for the next row
    }
}

}  // namespace

extern "C" {

// base [L, D] int8, qual [L, D] int16, mask and is_fwd [L, D] bool, ref_gt
// [L] int32,
// the six [128, F] f32 tables of convert.somatic_grid_tables
// (grid_ref, grid_alt: F = 21; grid_on_ref, grid_on_alt, grid_off_ref,
// grid_off_alt: F = 9), ln_half = f32 ln 0.5; all contiguous on one
// device, L >= 1. Out: [L, 30] f32. Launches on `stream`; returns
// cudaGetLastError().
int somatic_grid_launch(const void* base, const void* qual, const void* mask,
                        const void* is_fwd, const void* ref_gt, long long L,
                        long long D, const void* grid_ref,
                        const void* grid_alt, const void* grid_on_ref,
                        const void* grid_on_alt, const void* grid_off_ref,
                        const void* grid_off_alt, float ln_half, void* out,
                        void* stream) {
    const Tables t{static_cast<const float*>(grid_ref),
                   static_cast<const float*>(grid_alt),
                   static_cast<const float*>(grid_on_ref),
                   static_cast<const float*>(grid_on_alt),
                   static_cast<const float*>(grid_off_ref),
                   static_cast<const float*>(grid_off_alt)};
    const long long blocks = snv::resident_blocks(
        somatic_grid_kernel, kWarps * 32, (L + kWarps - 1) / kWarps);
    somatic_grid_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(base), static_cast<const int16_t*>(qual),
        static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(is_fwd),
        static_cast<const int32_t*>(ref_gt), L, D, t, ln_half,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
