// KG-H: the germline SNV genotype tile, on Hopper (sm_90a). Two entries,
// one function:
//
// - the dense entry, snv_hist_tile_launch, replaces
//   strelka_tpu/models/snv_digt.py:506 call_snv_hist_tile, a jitted XLA
//   program (no Pallas): a tile given as its (qscore, base) histogram
//   hist [L, 512], int8 or int32 counts;
// - the lanes entry, snv_lanes_tile_launch, replaces the non-RNA pass of
//   strelka_tpu/models/snv_digt.py:536 call_snv_tile: a tile given as the
//   pileup's lanes base [L, D] int8, qual [L, D] int16 (the native
//   pileup's width) or uint8, mask [L, D] bool, whose histogram it counts
//   itself (q = clamp(qual, 0, 127); a call counts where mask and
//   0 <= base < 4, bin q * 4 + base).
//
// Their plain version in the port is models/snv_digt.call_snv_hist_tile_
// plain (after _tile_hist for the lanes): one exactly emulated f32 FMA a
// live slot, then the float64 posterior tail. Both entries give its bits
// in one launch. Per row:
//
//   lhood[g] = fma(count_k, qtab[k, g], lhood[g]) over k ascending
//   lhood[g] += sum_b s_mis[b] * e0[b, g]   (b ascending, then one add)
//
// then the genomic and the polymorphic result sets (float64 posterior with
// sequential 10-wide sums, first argmax, the ref and the max-genotype
// phreds, ln of the ref posterior) and the ten PLs, whose f32 (lhood -
// lmax) * -10 is divided by ln 10 in float64.
//
// The skip: a slot whose count is 0 adds exactly nothing, fma(0, q, lh) ==
// lh, because qtab holds no non-finite entry (0 * inf would be NaN) and
// lh starts at +0 and never becomes -0 (a sum that cancels rounds to +0);
// tests/test_torch_kgh_schedule.py checks the table at the CLIs' thetas.
// So a row walks only its live slots: 1-4 on a germline CLI row (all
// reads at one base quality), at most D.
//
// Bound on the H100: the bytes. The dense entry reads 512 bytes a row
// (int8), the lanes entry 4 bytes a lane at int16 qual (256 a row at the
// CLI's D = 64), and both write 108 bytes a row; their operations are 20
// f32 a live slot and some 140 float64 a row.
//
// Design: a warp walks one row at a time, eight warps a block, a grid of
// as many blocks as the card holds at once, each warp walking rows; each
// block stages qtab (20 KB), e0 and the four float64 prior tables in
// shared memory once.
// - The dense entry: lane l loads slots 16 l .. 16 l + 15 of the row (one
//   16-byte load for int8, four for int32, the next row's prefetched into
//   registers), takes the mask of its nonzero counts, and an exclusive
//   warp prefix of the masks' popcounts (shuffles) places its (slot,
//   count) pairs in the warp's live list in shared memory, in ascending
//   slot order.
// - The lanes entry: the lanes stride over the row's calls and add them
//   into the warp's 512-bin int32 histogram in shared memory with shared
//   atomics (integer counts: exact in any order, at any D); a ballot a
//   32-slot word gives the row's 512-bit live mask, walked in ascending
//   order (__ffs), the words without a live slot skipped (count_call and
//   for_live_slots, csrc/snv_tile_tail.cuh, which KG-R shares).
// - The walk: lane l < 30 runs genotype g = l % 10's chain over the live
//   slots (lanes 10-29 repeat lanes 0-9's chains at no cost: a warp
//   issues one instruction for all of them). A row's ref_gt, is_haploid
//   and s_mis are loaded before its walk, so that their latency hides
//   behind it.
// - The tail (csrc/snv_tile_tail.cuh, which KG-R's RNA tile shares),
//   three rows of a warp at once: a row's lhoods wait in the
//   warp's batch in shared memory until three of its rows have walked,
//   then row r's tail runs on lanes 10 r + g, the genomic and the
//   polymorphic result sets side by side and then the PLs, and lanes 0-8
//   take the three rows' nine phreds, lanes 9-11 their ln of the ref
//   posterior. A group's max and first argmax are a __reduce_max_sync
//   over order-preserving keys (64-bit for the float64 posteriors, in two
//   rounds; -0 as +0, a NaN above all) and a ballot (the lowest lane wins
//   a tie, torch's first index); each 10-wide sum gathers the group's
//   values through the warp's scratch in shared memory and adds them in
//   ascending g.
// What holds it above its bound on the H100 is the tail: a row's chain
// of FP64 library calls (exp, divisions, log10, log), keys, reductions
// and shared-memory sums issues at a low rate for want of independent
// work, and the three-row batch shares each instruction among three
// rows. Neither more resident warps (launch bounds of 5 and 6 blocks an
// SM) nor data held in L2 moved it (chip_smoke.py, PERF.md §6).
// Tensor cores do not apply: a row has a handful of live slots against
// 10 columns, and the sum's order is fixed to the bit.
// The arithmetic follows csrc/snv_math.cuh's rules (__fmul_rn, __dmul_rn
// and __fmaf_rn where nvcc would contract; default flags; NaN to 0 before
// an int cast).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "snv_math.cuh"

#include "snv_tile_tail.cuh"

namespace {

using namespace snv_tile;

constexpr int kWarps = 8;

// the dense entry's 16 counts of a lane: slots 16 l .. 16 l + 15
template <typename T> struct Counts;

template <> struct Counts<int8_t> {
    uint4 v;
    __device__ void load(const int8_t* row, int lane) {
        v = __ldg(reinterpret_cast<const uint4*>(row) + lane);
    }
    // bit i for a nonzero count at slot 16 l + i
    __device__ unsigned mask() const {
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            // 0x01 a nonzero byte, gathered to bits 24-27 (no carries)
            const unsigned nz = __vcmpne4(w[j], 0u) & 0x01010101u;
            m |= ((nz * 0x01020408u) >> 24) << (4 * j);
        }
        return m;
    }
    __device__ float at(int i) const {
        const unsigned w = i < 8 ? (i < 4 ? v.x : v.y)
                                 : (i < 12 ? v.z : v.w);
        return static_cast<float>(
            static_cast<int8_t>(w >> (8 * (i & 3))));
    }
};

template <> struct Counts<int32_t> {
    uint4 v[4];
    __device__ void load(const int32_t* row, int lane) {
        const uint4* p = reinterpret_cast<const uint4*>(row) + 4 * lane;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __ldg(p + j);
    }
    __device__ unsigned mask() const {
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            m |= (v[j].x != 0u ? 1u : 0u) << (4 * j)
               | (v[j].y != 0u ? 2u : 0u) << (4 * j)
               | (v[j].z != 0u ? 4u : 0u) << (4 * j)
               | (v[j].w != 0u ? 8u : 0u) << (4 * j);
        return m;
    }
    __device__ float at(int i) const {
        const uint4 q = i < 8 ? (i < 4 ? v[0] : v[1])
                              : (i < 12 ? v[2] : v[3]);
        const unsigned w = (i & 2) ? ((i & 1) ? q.w : q.z)
                                   : ((i & 1) ? q.y : q.x);
        return static_cast<float>(static_cast<int>(w));
    }
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
snv_hist_tile_kernel(const T* __restrict__ hist, Row in, Tables t,
                     long long L, Out o) {
    __shared__ Staged s;
    __shared__ __align__(16) float cnt_s[kWarps][kSlots];
    __shared__ uint16_t slot_s[kWarps][kSlots];
    __shared__ float lh_s[kWarps][kBatch][kGt];
    __shared__ int ref_s[kWarps][kBatch];
    __shared__ uint8_t hap_s[kWarps][kBatch];
    stage(s, t);
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane % kGt;
    float* cnt = cnt_s[w];
    uint16_t* slot = slot_s[w];
    // the tail's scratch: the list's space, free between a batch's walks
    Batch batch{lh_s[w], ref_s[w], hap_s[w], reinterpret_cast<double*>(cnt),
                0, 0};
    const long long step = static_cast<long long>(gridDim.x) * kWarps;
    long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
    Counts<T> c;
    if (row < L) c.load(hist + row * kSlots, lane);
    while (row < L) {    // a batch: up to kBatch of the warp's rows
        batch.first = row;
        for (batch.n = 0; batch.n < kBatch && row < L; ++batch.n) {
            const Counts<T> cur = c;
            if (row + step < L) c.load(hist + (row + step) * kSlots, lane);
            const RowVals v = load_row(in, row);
            // the live list: this lane's pairs after the lower lanes'
            unsigned m = cur.mask();
            const int n = __popc(m);
            int incl = n;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(kAll, incl, d);
                if (lane >= d) incl += y;
            }
            const int live = __shfl_sync(kAll, incl, 31);
            for (int pos = incl - n; m; ++pos) {
                const int i = __ffs(m) - 1;
                m &= m - 1;
                slot[pos] = static_cast<uint16_t>(16 * lane + i);
                cnt[pos] = cur.at(i);
            }
            __syncwarp();
            float lh = 0.0f;
#pragma unroll 4
            for (int i = 0; i < live; ++i)
                lh = __fmaf_rn(cnt[i], s.qtab[slot[i] * kGt + g], lh);
            __syncwarp();    // the list is rewritten
            stage_row(batch, batch.n, add_smis(s, lh, v, in, g), v, row, o,
                      lane);
            row += step;
        }
        __syncwarp();
        batch_tail(s, batch, step, o, lane);
        __syncwarp();
    }
}

// the lanes entry: the warp's histogram counted from the row's calls
template <typename Q>
__global__ void __launch_bounds__(kWarps * 32)
snv_lanes_tile_kernel(const int8_t* __restrict__ base,
                      const Q* __restrict__ qual,
                      const uint8_t* __restrict__ mask, long long D, Row in,
                      Tables t, long long L, Out o) {
    __shared__ Staged s;
    __shared__ __align__(16) int h_s[kWarps][kSlots];
    __shared__ float lh_s[kWarps][kBatch][kGt];
    __shared__ int ref_s[kWarps][kBatch];
    __shared__ uint8_t hap_s[kWarps][kBatch];
    __shared__ double x_s[kWarps][32];
    stage(s, t);
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane % kGt;
    int* h = h_s[w];
    Batch batch{lh_s[w], ref_s[w], hap_s[w], x_s[w], 0, 0};
    clear_bins(h, lane);
    const long long step = static_cast<long long>(gridDim.x) * kWarps;
    long long row = static_cast<long long>(blockIdx.x) * kWarps + w;
    while (row < L) {    // a batch: up to kBatch of the warp's rows
        batch.first = row;
        for (batch.n = 0; batch.n < kBatch && row < L; ++batch.n) {
            const RowVals v = load_row(in, row);
            // a call's three loads at once, then its count
            for (long long d = lane; d < D; d += 32) {
                const long long i = row * D + d;
                const bool m = mask[i];
                const int b = base[i];
                count_call(h, m, b, qual[i]);
            }
            __syncwarp();
            float lh = 0.0f;
            for_live_slots(h, lane, [&](int k) {
                lh = __fmaf_rn(static_cast<float>(h[k]), s.qtab[k * kGt + g],
                               lh);
            });
            __syncwarp();
            clear_bins(h, lane);    // for the next row
            stage_row(batch, batch.n, add_smis(s, lh, v, in, g), v, row, o,
                      lane);
            row += step;
        }
        __syncwarp();
        batch_tail(s, batch, step, o, lane);
        __syncwarp();
    }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long L, void* stream, Args... args) {
    const long long blocks = snv::resident_blocks(
        kernel, kWarps * 32, (L + kWarps - 1) / kWarps);
    kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The dense entry. hist [L, 512] int8 (hist_bytes 1) or int32 (hist_bytes
// 4), 16-byte aligned; ref_gt [L] int32 in 0..4; hap [L] bool or null;
// s_mis [L, 4] f32 or null; qtab [512, 10] f32 (16-byte aligned), e0 [4,
// 10] f32, the four [5, 10] float64 ln prior tables (genome, poly,
// genome_haploid, poly_haploid); all contiguous on one device, L >= 1.
// Out: lhood [L, 10] f32, genome_max_gt, poly_max_gt, snv_qphred,
// genome_max_gt_qphred, poly_max_gt_qphred [L] int32, phred_loghood [L,
// 10] int32, ln_ref_pprob [L] float64. Launches on `stream`; returns
// cudaGetLastError().
int snv_hist_tile_launch(const void* hist, int hist_bytes,
                         const void* ref_gt, const void* hap,
                         const void* s_mis, const void* qtab,
                         const void* e0, const void* prior_genome,
                         const void* prior_poly,
                         const void* prior_genome_haploid,
                         const void* prior_poly_haploid, long long L,
                         void* lhood, void* g_max, void* p_max, void* snv_q,
                         void* g_qmax, void* p_qmax, void* pl, void* ln_ref,
                         void* stream) {
    const Tables t = tables(qtab, e0, prior_genome, prior_poly,
                            prior_genome_haploid, prior_poly_haploid);
    const Out o = outputs(lhood, g_max, p_max, snv_q, g_qmax, p_qmax, pl,
                          ln_ref);
    const Row in = row_inputs(ref_gt, hap, s_mis);
    if (hist_bytes == 1)
        return launch(snv_hist_tile_kernel<int8_t>, L, stream,
                      static_cast<const int8_t*>(hist), in, t, L, o);
    if (hist_bytes == 4)
        return launch(snv_hist_tile_kernel<int32_t>, L, stream,
                      static_cast<const int32_t*>(hist), in, t, L, o);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The lanes entry. base [L, D] int8, qual [L, D] uint8 (qual_bytes 1) or
// int16 (qual_bytes 2), mask [L, D] bool, D >= 0; the rest as the dense
// entry's.
int snv_lanes_tile_launch(const void* base, const void* qual, int qual_bytes,
                          const void* mask, long long D, const void* ref_gt,
                          const void* hap, const void* s_mis,
                          const void* qtab, const void* e0,
                          const void* prior_genome, const void* prior_poly,
                          const void* prior_genome_haploid,
                          const void* prior_poly_haploid, long long L,
                          void* lhood, void* g_max, void* p_max,
                          void* snv_q, void* g_qmax, void* p_qmax, void* pl,
                          void* ln_ref, void* stream) {
    const Tables t = tables(qtab, e0, prior_genome, prior_poly,
                            prior_genome_haploid, prior_poly_haploid);
    const Out o = outputs(lhood, g_max, p_max, snv_q, g_qmax, p_qmax, pl,
                          ln_ref);
    const Row in = row_inputs(ref_gt, hap, s_mis);
    const int8_t* b = static_cast<const int8_t*>(base);
    const uint8_t* m = static_cast<const uint8_t*>(mask);
    if (qual_bytes == 1)
        return launch(snv_lanes_tile_kernel<uint8_t>, L, stream, b,
                      static_cast<const uint8_t*>(qual), m, D, in, t, L, o);
    if (qual_bytes == 2)
        return launch(snv_lanes_tile_kernel<int16_t>, L, stream, b,
                      static_cast<const int16_t*>(qual), m, D, in, t, L, o);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
