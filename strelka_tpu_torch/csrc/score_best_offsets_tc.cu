// Read x haplotype best-offset scoring on Hopper's u8 tensor cores (sm_90a).
//
// Replaces the TPU kernel strelka_tpu/ops/pallas_readlik.py:_score_kernel
// (mode="exact", launched by _score_best_offsets). For each locus-haplotype
// pair b and read r it computes, over window offsets w,
//
//   S_j[w] = sum_l limb_j(d_int[r,l]) * [codes[r,l] < 4 && codes[r,l] == win[l,w]]
//   s[w]   = RN(S_1 * 256 + S_0) * 2^-11 + lnmis[r]
//
// with d_int = (int)(delta * 2^11), limb_1 = bits 8-15, limb_0 = bits 0-7,
// and returns max_w s[w] and its first (lowest-w) argmax, bit for bit as
// the reference: RN(RN(f32(S_1) * 256) + f32(S_0)) equals RN(S_1*256 + S_0)
// for every sum below 2^31, since f32(S_1) * 256 is exact.
//
// The same kernel, instantiated on packed operands, is KX-P: it replaces
// the K1-x harness's packed bodies benchmarks/exp_exact_kernel.py
// _kernel_fused :418 / build_fused.kern :451 (pallas_call :489) and
// build_packedin.kern :579 (pallas_call :625): K1's function from one int32
// per base, p = (d_int << 3) | code (code p & 7, where 4..7 match nothing;
// d_int p >> 3), with lnmis f32 [B,R] (kPacked) or as raw f32 bits in
// ceil(R/L) extra rows of the packed operand, read r at row R + r/L, column
// r % L (kPackedFold); out f32 [B,R,2] = (best, the bits of the offset).
//
// With the hap output form it is KX-H: it replaces the harness's
// build_hap2.kern :860 (pallas_call :889), whose idea is to build the A
// operand once per locus, not once per haplotype. One locus's reads [B,R,L]
// face H windows side by side, win [B,L,H*W]; best and off [B,R,H] hold K1's
// result against each window, the offset within the window. The N tiles
// walk window 0's ceil(W/64) tiles, then window 1's (tc_pipeline.cuh), so a
// tile never straddles two windows, and the A words, resident for the whole
// read length at the harness's and the main path's L, serve every window.
// At a window's last tile the first max is merged over the 4 lanes of a
// read, stored and reset.
//
// With source kClamped it is KX-I: it replaces the harness's _kernel_int8
// :109 (pallas_call :720), K1's function on limbs clamped to 0..127 (the
// body's clamp, :122), which the Pallas body fed to the int8 MXU. Every
// clamped limb is a u8 value, so K1's .s32.u8.u8 product computes the
// clamped function exactly: only the A words differ (a_words_clamped,
// min(limb, 127) after the & 255).
//
// The four timing ablations of the K1-x harness run on it too (KX-A), each
// computing its Pallas body's result and timed beside K1:
// - noA (source kUnmasked) replaces _kernel_limb2_noA :310: the limbs count
//   against every window code 0..3 whatever the read's code, S_j[w] =
//   sum_l limb_j * [win[l,w] in 0..3]. Its A words hold the limb in all
//   four code bytes (limb * 0x01010101) and read no codes; since sum_c
//   limb * [win == c] = limb * [win < 4], the u8 product is that sum,
//   exactly. K1 minus the code load and the mask: its time beside K1's is
//   what masking costs.
// - nodot (product kSlabSlice) replaces _kernel_limb2_nodot :386, "full
//   slab build, dot replaced by a slab row-slice": s[r,w] = (A[r,w] +
//   Wo[r,w]) * 2^-11 + lnmis[r] for R, W <= 4L, with A[r, c*L + l] the
//   limb-1 slab (limb_1 where code[r,l] == c) and Wo[c*L + l, w] =
//   [win[l,w] == c]. The whole slab build stays (A words, the window ring,
//   each step's Bw); the wgmma is replaced by reads of the slabs it built
//   (slab_slice): K1's pipeline without the tensor cores.
// - nomax (output kBestOnly) replaces _kernel_limb2_nomax :360: K1's best,
//   offset 0. The tile loop keeps the strict > running max and tracks no
//   offset, the lanes merge by max alone (merge_max) and off is stored 0:
//   its time beside K1's is what the first-max bookkeeping costs.
// - noW (window kGroupRing or kGroupSlab) replaces _kernel_limb2_noW :333,
//   "W slab written once from tile 0 only": pair b faces the window of
//   pair b/G*G, the first of its group of G (the last group may be
//   partial). Plan S (kGroupSlab), the ablation itself: one CTA serves a
//   group's pairs for one block of reads. Its first pair walks K1's
//   pipeline, with each step's Bw expanded into a slab of all nT*nK step
//   tiles instead of the ring; every later pair expands only its A words
//   and lnmis and runs the wgmma chain over the slab, with no staging, no
//   waits on the ring, no Bw expansion and no barrier a step. Plan R
//   (kGroupRing) is K1's kernel staging the group's window, for shapes
//   whose slab does not fit beside K1's resident A (now_slab_fits). Its
//   time beside K1's is what building the window costs; the host chooses
//   the plan and reports it (score_now_tc_plan).
//
// Only the reads' expansion into A words, lnmis, the window's columns, the
// product and the output store differ (template parameters); K1's
// instantiation is the code it was.
//
// As a product: S_j = A_j . Bw over a contraction axis k = 4l + c of 4L
// bytes, with A_j[r, 4l+c] = limb_j(d_int[r,l]) * [code[r,l] == c] (u8,
// 0..255) and Bw[4l+c, w] = [win[l,w] == c] (u8). A read code >= 4 is a zero
// column of A, a window code >= 4 a zero row of Bw. The s32 sums are exact.
//
// Bound on the H100: bytes. It moves B*(5*R*L + L*W + 12*R) bytes, ~11 us at
// the main path's 256,128,160,256 at 3.35 TB/s, against 2*B*R*L*W = 2.7 G
// compare-adds (the one-hot product does 16*B*R*L*W = 21.5 G u8 operations,
// ~11 us at 1,979 TOP/s). KX-P moves 4 bytes a base instead of 5; KX-H
// B*(5*R*L + 4*R + L*H*W + 8*R*H) for H times the compare-adds; noA 4
// bytes a base (no codes). nodot's function needs only the bases and
// window rows its slices touch, B*(5*R*min(L,W) + min(R,L)*W + 12*R)
// bytes, and 2 f32 operations a score; its time is that of the slab build
// it keeps, as the ablation asks. nomax and KX-I move K1's bytes; noW
// reads one window a group, B*(5*R*L + 12*R) + ceil(B/G)*L*W bytes.
//
// Design:
// - wgmma.mma_async m64n64k32 .s32.u8.u8, both operands K-major in shared
//   memory without swizzle (8-bit wgmma takes no transpose). The 64 rows of
//   a warpgroup's A are 32 reads x 2 limbs, interleaved so that warp q's
//   rows 16q+g and 16q+8+g are limb 1 and limb 0 of read 8q+g: a thread's
//   accumulator registers 4j+e and 4j+2+e hold both limbs of one (read,
//   offset), combined in int32 and converted once.
// - One CTA per (pair, up to 4 warpgroups of 32 reads); it walks the N tiles
//   of 64 offsets (64 divides W = 128..320 of the main path) and, inside
//   each, the contraction in chunks of 32 bases (128 bytes of K), as one
//   flat sequence of steps so the pipeline does not drain between tiles.
// - The CTA's reads are turned into A words once: for the whole read length
//   when they fit in shared memory (the main path's L), else one chunk per
//   step (long reads; nothing in shared memory grows with L then).
// - The window comes in by 16-byte cp.async into a ring of 3 raw stages,
//   each completed on an mbarrier, two steps ahead (tc_pipeline.cuh). Each
//   step's raw window is expanded into the K-major one-hot Bw tile of a
//   3-slot ring while the tensor cores run the step before it. One
//   __syncthreads a step guards the slots.
// - First max: strict > over a thread's ascending offsets across N tiles,
//   then better() over the 4 lanes that share a read.
#include "tc_pipeline.cuh"

namespace {

// Output forms: best [B,R] and off [B,R] apart (K1), interleaved [B,R,2]
// (KX-P), best and off [B,R,H] against H windows (KX-H), best [B,R] with
// off 0 (nomax: no argmax)
enum Output { kBestOff, kPairOut, kHapOut, kBestOnly };

// What a step does with its operands: the u8 wgmma (K1), or nodot's reads
// of the slabs' terms (slab_slice)
enum Product { kProduct, kSlabSlice };

// The window a pair faces: its own (K1), or noW's, that of the first pair
// of its group of G, staged through K1's ring (plan R) or expanded once
// into a slab that the group's pairs share (plan S)
enum Window { kOwn, kGroupRing, kGroupSlab };

constexpr int kReadsPerWg = 32;                 // m64 = 32 reads x 2 limbs
constexpr int kMaxWg = 4;
constexpr int kChunkK = 4 * kChunkBases;        // 128 bytes of K
constexpr int kSteps = kChunkK / 32;            // k32 steps per chunk
constexpr int kOpBytes = 64 * kChunkK;          // a 64-row operand chunk

// d (+)= A (64x32 u8, K-major) * B (32x64 u8, K-major), s32
__device__ __forceinline__ void wgmma_u8(int (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A words of one base: (limb_1, limb_0) << 8c for a code c in 0..3, else 0
__device__ __forceinline__ void a_words_int(int c, int di, unsigned& w1,
                                            unsigned& w0) {
    const bool ok = (unsigned)c < 4u;
    const unsigned sh = 8u * ((unsigned)c & 3u);
    w1 = ok ? ((unsigned)(di >> 8) & 255u) << sh : 0u;
    w0 = ok ? ((unsigned)di & 255u) << sh : 0u;
}

__device__ __forceinline__ void a_words(int c, float d, unsigned& w1,
                                        unsigned& w0) {
    a_words_int(c, (int)__fmul_rn(d, 2048.0f), w1, w0);
}

// KX-I's A words of one base: K1's with each limb clamped to 127 after
// the & 255, as clamp_limbs does (a negative d_int clamps its two's
// complement bytes)
__device__ __forceinline__ void a_words_clamped(int c, float d, unsigned& w1,
                                                unsigned& w0) {
    const int di = (int)__fmul_rn(d, 2048.0f);
    const bool ok = (unsigned)c < 4u;
    const unsigned sh = 8u * ((unsigned)c & 3u);
    w1 = ok ? min((unsigned)(di >> 8) & 255u, 127u) << sh : 0u;
    w0 = ok ? min((unsigned)di & 255u, 127u) << sh : 0u;
}

// noA's A words of one base: its limbs in all four code bytes, whatever
// the read's code
__device__ __forceinline__ void a_words_unmasked(float d, unsigned& w1,
                                                 unsigned& w0) {
    const int di = (int)__fmul_rn(d, 2048.0f);
    w1 = ((unsigned)(di >> 8) & 255u) * 0x01010101u;
    w0 = ((unsigned)di & 255u) * 0x01010101u;
}

// A words of base quads q0 .. q0+nq-1 of the CTA's reads into `dst`: the 8
// row groups of warpgroup q's A at dst + (8q + group) * sbo, group 2i (limb
// 1) and 2i+1 (limb 0) for its reads 8i..8i+7, quad q0+kq at kq * kCore.
template <int kSrc>
__device__ void expand_a(const Args& a, int b, long long r0, int n_reads,
                         int q0, int nq, unsigned char* dst, uint32_t sbo) {
    const int items = n_reads * nq;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
        // 8 reads fastest: a quarter-warp stores 128 contiguous bytes
        const int i8 = it & 7;
        const int kq = (it >> 3) % nq;
        const int ig = (it >> 3) / nq;   // group of 8 reads
        const long long r = r0 + 8 * ig + i8;
        const int l = 4 * (q0 + kq);
        uint4 v1 = make_uint4(0u, 0u, 0u, 0u), v0 = v1;
        if (r < a.R && l < a.L) {
            if constexpr (kSrc == kStandard || kSrc == kClamped) {
                const size_t o = ((size_t)b * a.R + r) * a.L + l;
                int c[4];
                float d[4];
                if (a.read_vec) {   // L % 4 == 0: the quad lies inside the read
                    const unsigned cw =
                        *reinterpret_cast<const unsigned*>(a.codes + o);
                    const float4 dv =
                        *reinterpret_cast<const float4*>(a.delta + o);
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        c[k] = (int)(int8_t)(cw >> (8 * k));
                    d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
                } else {
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const bool in = l + k < a.L;
                        c[k] = in ? (int)a.codes[o + k] : 4;
                        d[k] = in ? a.delta[o + k] : 0.0f;
                    }
                }
                if constexpr (kSrc == kClamped) {
                    a_words_clamped(c[0], d[0], v1.x, v0.x);
                    a_words_clamped(c[1], d[1], v1.y, v0.y);
                    a_words_clamped(c[2], d[2], v1.z, v0.z);
                    a_words_clamped(c[3], d[3], v1.w, v0.w);
                } else {
                    a_words(c[0], d[0], v1.x, v0.x);
                    a_words(c[1], d[1], v1.y, v0.y);
                    a_words(c[2], d[2], v1.z, v0.z);
                    a_words(c[3], d[3], v1.w, v0.w);
                }
            } else if constexpr (kSrc == kUnmasked) {   // no codes read
                const size_t o = ((size_t)b * a.R + r) * a.L + l;
                float d[4];
                if (a.read_vec) {
                    const float4 dv =
                        *reinterpret_cast<const float4*>(a.delta + o);
                    d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
                } else {   // bases past L: limbs 0, zero words
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        d[k] = l + k < a.L ? a.delta[o + k] : 0.0f;
                }
                a_words_unmasked(d[0], v1.x, v0.x);
                a_words_unmasked(d[1], v1.y, v0.y);
                a_words_unmasked(d[2], v1.z, v0.z);
                a_words_unmasked(d[3], v1.w, v0.w);
            } else {   // packed: code p & 7, d_int p >> 3
                static_assert(kSrc == kPacked || kSrc == kPackedFold,
                              "expand_a: a source it does not name");
                const size_t o = ((size_t)b * a.Rp + r) * a.L + l;
                int p[4];
                if (a.read_vec) {
                    const int4 pv = *reinterpret_cast<const int4*>(a.packed + o);
                    p[0] = pv.x; p[1] = pv.y; p[2] = pv.z; p[3] = pv.w;
                } else {
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        p[k] = l + k < a.L ? a.packed[o + k] : 4;
                }
                a_words_int(p[0] & 7, p[0] >> 3, v1.x, v0.x);
                a_words_int(p[1] & 7, p[1] >> 3, v1.y, v0.y);
                a_words_int(p[2] & 7, p[2] >> 3, v1.z, v0.z);
                a_words_int(p[3] & 7, p[3] >> 3, v1.w, v0.w);
            }
        }
        unsigned char* p = dst + (size_t)(2 * ig) * sbo + kq * kCore + 16 * i8;
        *reinterpret_cast<uint4*>(p) = v1;
        *reinterpret_cast<uint4*>(p + sbo) = v0;
    }
}

// lnmis of read r (r < R): the [B,R] operand, or the folded row's bits
template <int kSrc>
__device__ __forceinline__ float read_lnmis(const Args& a, int b,
                                            long long r) {
    if constexpr (kSrc == kPackedFold)
        return __int_as_float(
            a.packed[((size_t)b * a.Rp + a.R + r / a.L) * a.L + r % a.L]);
    else
        return a.lnmis[(size_t)b * a.R + r];
}

// step `it`'s K-major one-hot Bw tile [64 offsets][128 bytes of K] from its
// raw window; bases past L and offsets past W (of its window) are zero rows
template <bool kHap = false>
__device__ void expand_w(const Args& a, int it, const unsigned char* raw,
                         unsigned char* bw) {
    const int nt = it / a.nK;
    const int l0 = (it - nt * a.nK) * kChunkBases;
    const int w0 = tile_w0<kHap>(a, nt);
    for (int e = threadIdx.x; e < kNTile * (kChunkBases / 4);
         e += blockDim.x) {
        const int w = e % kNTile;   // 8 offsets fastest: 128 contiguous bytes
        const int kq = e / kNTile;
        const bool in_w = w0 + w < a.W;
        unsigned v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int l = 4 * kq + k;
            const unsigned x = raw[l * kNTile + w];
            v[k] = (in_w && l0 + l < a.L && x < 4u) ? 1u << (8u * x) : 0u;
        }
        *reinterpret_cast<uint4*>(bw + (w >> 3) * (8 * kCore) + kq * kCore +
                                  16 * (w & 7)) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
}

// nodot's keys of N tile nt, made at its first step: the thread holds
// read r at the offsets w = w0 + 8j + 2*t4 + e of the tile (K1's
// accumulator layout); the 16-bit key of offset w places the term A[r,w]
// = A[r, c*L + l] (l = w mod L, c = w div L: byte c of read r's limb-1 A
// word at base l) as (the K chunk of base l << 10) | (its byte in that
// chunk's A row, K-major, k = 4l + c), kNoKey past W. key[j] holds e = 0
// in its low half, e = 1 in its high half (8 registers, not 16).
constexpr int kNoKey = 0xFFFF;   // chunk 63: L <= kMaxLen has 57 chunks

__device__ __forceinline__ void slab_keys(const Args& a, int w0, int t4,
                                          unsigned (&key)[8]) {
#pragma unroll
    for (int j = 0; j < kNTile / 8; ++j) {
        key[j] = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int w = w0 + 8 * j + 2 * t4 + e;
            const int c = (w >= a.L) + (w >= 2 * a.L) + (w >= 3 * a.L);
            const int l = w - c * a.L;   // W <= 4L: c in 0..3
            const int byte = ((l % kChunkBases) >> 2) * kCore +
                             4 * (l & 3) + c;   // < 1024
            const unsigned k =
                w < a.W ? (unsigned)((l / kChunkBases) << 10 | byte) : kNoKey;
            key[j] |= k << (16 * e);
        }
    }
}

// nodot's step (nt, kc) in the wgmma's place: the thread adds each term
// of s[r,w] = A[r,w] + Wo[r,w] whose base lies in chunk kc. A[r,w] is a
// byte of `a_rows` (read r's row of chunk kc's A words) where the key of w
// names chunk kc; Wo[c*L + l, w] (l = r mod L = rl, c = r div L = rc) is
// the byte at k = 4l + c of offset w in the step's Bw tile where base l
// lies in chunk kc. A base lies in one chunk, so each term is added once
// over the tile's steps, from the resident A or the ring alike. The sum
// (<= 256) goes to the weight-1 accumulators acc[4j+2+e]; the limb-1 ones
// acc[4j+e] stay 0, so K1's epilogue is the function's.
__device__ __forceinline__ void slab_slice(int kc, const unsigned (&key)[8],
                                           const unsigned char* a_rows,
                                           const unsigned char* b_op,
                                           bool r_in, int rl, int rc, int t4,
                                           int (&acc)[32]) {
    const int lr = rl - kc * kChunkBases;   // read r's base in the chunk
    const bool r_here = r_in && (unsigned)lr < (unsigned)kChunkBases;
    // offset 2*t4 + e of 8-offset group j at j*8*kCore + 16*(2*t4 + e);
    // past W the Bw bytes are 0
    const unsigned char* wo = b_op + (lr >> 2) * kCore + 4 * (lr & 3) + rc +
                              32 * t4;
#pragma unroll
    for (int j = 0; j < kNTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const unsigned k = (key[j] >> (16 * e)) & 0xFFFFu;
            int add = (int)(k >> 10) == kc ? a_rows[k & 1023u] : 0;
            if (r_here) add += wo[j * (8 * kCore) + 16 * e];
            acc[4 * j + 2 + e] = (kc == 0 ? 0 : acc[4 * j + 2 + e]) + add;
        }
    }
}

// the first max over the 4 lanes that share a read
__device__ __forceinline__ void merge_lanes(float& run_s, int& run_w) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, run_s, o);
        const int ow = __shfl_xor_sync(0xffffffffu, run_w, o);
        if (better(os, ow, run_s, run_w)) {
            run_s = os;
            run_w = ow;
        }
    }
}

// the max over the 4 lanes that share a read (nomax): the same strict > as
// merge_lanes, so NaN and signed zeros fare as in K1 (s is never -0)
__device__ __forceinline__ void merge_max(float& run_s) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, run_s, o);
        if (os > run_s) run_s = os;
    }
}

// N tile w0's sums into the thread's running first max: the thread holds
// read r at offsets w0 + 8j + 2*t4 + e, limb 1 in acc[4j+e], limb 0 in
// acc[4j+2+e], visited in ascending order; nomax tracks no offset
template <int kOut>
__device__ __forceinline__ void tile_max(const Args& a, const int (&acc)[32],
                                         int w0, int t4, float ls,
                                         float& run_s, int& run_w) {
#pragma unroll
    for (int j = 0; j < kNTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int w = w0 + 8 * j + 2 * t4 + e;   // ascending
            const int S = acc[4 * j + e] * 256 + acc[4 * j + 2 + e];
            const float s =
                __fadd_rn(__fmul_rn(__int2float_rn(S), kQuantInv), ls);
            if (w < a.W && s > run_s) {   // strict keeps the first
                run_s = s;
                if constexpr (kOut != kBestOnly) run_w = w;
            }
        }
    }
}

// pair b's result for read r: the lanes of the read merged, lane 0 stores
// (every form but KX-H's, which stores at each window's last tile)
template <int kOut>
__device__ __forceinline__ void store_pair(const Args& a, int b, long long r,
                                           int t4, float run_s, int run_w) {
    if constexpr (kOut == kBestOnly)
        merge_max(run_s);
    else
        merge_lanes(run_s, run_w);
    if (t4 == 0 && r < a.R) {
        const size_t o = (size_t)b * a.R + r;
        if constexpr (kOut == kPairOut) {
            a.out[2 * o] = run_s;
            a.out[2 * o + 1] = __int_as_float(run_w);
        } else {
            a.best[o] = run_s;
            a.off[o] = kOut == kBestOnly ? 0 : run_w;
        }
    }
}

template <int kSrc, int kOut, int kProd = kProduct, int kWin = kOwn>
__global__ void __launch_bounds__(kMaxWg* kWgThreads)
    score_best_offsets_tc_kernel(const Args a) {
    constexpr bool kHap = kOut == kHapOut;
    constexpr bool kSlab = kWin == kGroupSlab;
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [kStages]
    // Bw: a ring of kStages step tiles, or (plan S) the slab of all nT*nK
    unsigned char* bw = smem + kBarBytes;
    unsigned char* raw =                                  // [kStages][kRawBytes]
        bw + (kSlab ? a.nT * a.nK : kStages) * kOpBytes;
    unsigned char* as = raw + kStages * kRawBytes;        // A words
    const int tid = threadIdx.x;
    const int n_wg = blockDim.x / kWgThreads;
    const int wg = tid / kWgThreads;
    const int n_reads = n_wg * kReadsPerWg;
    // the pair (plan S: the first of the CTA's group), and the pair whose
    // window it faces
    const int b = kSlab ? blockIdx.y * a.G : blockIdx.y;
    const int b_win = kWin == kGroupRing ? b / a.G * a.G : b;
    const long long r0 = (long long)blockIdx.x * n_reads;
    const int total = a.nT * a.nK;   // steps: N tiles x K chunks, K fastest
    // A: the whole read length (row group stride 32*Lp), or a 3-slot ring
    // of chunks (stride 8*kChunkK)
    const uint32_t sbo_a = a.resident ? 32u * a.Lp : 8u * kChunkK;
    const size_t a_slot = (size_t)n_wg * kOpBytes;

    init_ring(full);
    for (int s = 0; s < 2 && s < total; ++s)
        stage_window<kHap>(a, b_win, s, raw + s * kRawBytes, &full[s]);
    expand_a<kSrc>(a, b, r0, n_reads, 0,
                   a.resident ? a.Lp / 4 : kChunkBases / 4, as, sbo_a);
    mbar_wait(&full[0], 0);
    expand_w<kHap>(a, 0, raw, bw);
    fence_proxy_async();
    __syncthreads();

    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int q = (tid >> 5) & 3;   // the warp in its warpgroup
    const long long r = r0 + wg * kReadsPerWg + q * 8 + g;
    const float ls = r < a.R ? read_lnmis<kSrc>(a, b, r) : 0.0f;
    // nodot: read r's row of the Wo slab, r = rc*L + rl (r < R <= 4L)
    const int rc = (r >= a.L) + (r >= 2 * a.L) + (r >= 3 * a.L);
    const int rl = (int)(r - (long long)rc * a.L);
    float run_s = -INFINITY;
    int run_w = INT_MAX;
    int acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;
    unsigned key[8];   // nodot's keys of the tile (slab_keys)

    for (int it = 0; it < total; ++it) {
        const int nt = it / a.nK;
        const int kc = it - nt * a.nK;
        const int slot = it % kStages;
        const unsigned char* a_op =
            (a.resident ? as + (size_t)kc * (kChunkK / 16) * kCore
                        : as + slot * a_slot) +
            (size_t)wg * 8 * sbo_a;
        const unsigned char* b_op = bw + (kSlab ? it : slot) * kOpBytes;
        if constexpr (kProd == kProduct) {
            // the tensor cores on step it (asynchronous)
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < kSteps; ++s)
                wgmma_u8(acc, desc(a_op + 2 * s * kCore, kCore, sbo_a),
                         desc(b_op + 2 * s * kCore, kCore, 8 * kChunkK),
                         kc > 0 || s > 0);
            wgmma_commit();
        } else {   // nodot: the slabs' terms of step it, read by the threads
            if (kc == 0) slab_keys(a, tile_w0<kHap>(a, nt), t4, key);
            slab_slice(kc, key, a_op + (size_t)2 * q * sbo_a + 16 * g, b_op,
                       r < a.R, rl, rc, t4, acc);
        }
        // the window two steps ahead
        if (it + 2 < total)
            stage_window<kHap>(a, b_win, it + 2,
                               raw + ((it + 2) % kStages) * kRawBytes,
                               &full[(it + 2) % kStages]);
        // the operands of step it+1, into the slot step it-2 read (plan
        // S: into its own slot of the slab)
        if (it + 1 < total) {
            const int s1 = (it + 1) % kStages;
            if (!a.resident) {
                const int k1 = (it + 1) % a.nK;
                expand_a<kSrc>(a, b, r0, n_reads, k1 * (kChunkBases / 4),
                               kChunkBases / 4, as + s1 * a_slot, sbo_a);
            }
            mbar_wait(&full[s1], ((it + 1) / kStages) & 1);
            expand_w<kHap>(a, it + 1, raw + s1 * kRawBytes,
                           bw + (kSlab ? it + 1 : s1) * kOpBytes);
            fence_proxy_async();
        }
        if (kc == a.nK - 1) {
            // the tile's sums
            const int w0 = tile_w0<kHap>(a, nt);
            if constexpr (kProd == kProduct) {
                wgmma_wait<0>();
                fence_acc(acc);
            }
            tile_max<kOut>(a, acc, w0, t4, ls, run_s, run_w);
            if (kHap && w0 + kNTile >= a.W) {   // its window's last tile
                merge_lanes(run_s, run_w);
                if (t4 == 0 && r < a.R) {
                    const size_t o = ((size_t)b * a.R + r) * a.H +
                                     tile_window<kHap>(a, nt);
                    a.best[o] = run_s;
                    a.off[o] = run_w;
                }
                run_s = -INFINITY;
                run_w = INT_MAX;
            }
        } else if constexpr (kProd == kProduct) {
            wgmma_wait<1>();   // step it-1 done: its slots are free
        }
        __syncthreads();
    }

    if constexpr (!kHap) store_pair<kOut>(a, b, r, t4, run_s, run_w);

    if constexpr (kSlab) {
        // plan S: the group's later pairs against the slab the first
        // pair's walk filled (A resident), one wgmma chain a tile
        const int n_pairs = a.B - b < a.G ? a.B - b : a.G;
        for (int p = b + 1; p < b + n_pairs; ++p) {
            wgmma_wait<0>();
            __syncthreads();   // no warpgroup reads the resident A any more
            expand_a<kSrc>(a, p, r0, n_reads, 0, a.Lp / 4, as, sbo_a);
            fence_proxy_async();
            __syncthreads();
            const float lp = r < a.R ? read_lnmis<kSrc>(a, p, r) : 0.0f;
            float ps = -INFINITY;
            int pw = INT_MAX;
            for (int nt = 0; nt < a.nT; ++nt) {
                fence_acc(acc);
                wgmma_fence();
                for (int kc = 0; kc < a.nK; ++kc) {
                    const unsigned char* pa =
                        as + (size_t)kc * (kChunkK / 16) * kCore +
                        (size_t)wg * 8 * sbo_a;
                    const unsigned char* pb =
                        bw + (size_t)(nt * a.nK + kc) * kOpBytes;
#pragma unroll
                    for (int s = 0; s < kSteps; ++s)
                        wgmma_u8(acc, desc(pa + 2 * s * kCore, kCore, sbo_a),
                                 desc(pb + 2 * s * kCore, kCore,
                                      8 * kChunkK),
                                 kc > 0 || s > 0);
                }
                wgmma_commit();
                wgmma_wait<0>();
                fence_acc(acc);
                tile_max<kOut>(a, acc, tile_w0<false>(a, nt), t4, lp, ps, pw);
            }
            store_pair<kOut>(a, p, r, t4, ps, pw);
        }
    }
}

// CTA's warpgroups for R reads: one per 32, at most kMaxWg
inline int warpgroups(long long R) {
    const long long want = (R + kReadsPerWg - 1) / kReadsPerWg;
    return (int)(want < kMaxWg ? want : kMaxWg);
}

// plan S's shared memory: the barriers, the raw ring, the slab of all
// nT*nK step tiles and the resident A of n_wg warpgroups (`a` planned)
inline size_t slab_smem(const Args& a, int n_wg) {
    return kBarBytes + (size_t)kStages * kRawBytes +
           (size_t)a.nT * a.nK * kOpBytes + (size_t)n_wg * 64 * 4 * a.Lp;
}

// noW's plan for R reads of L bases against W offsets: S (the slab beside
// K1's resident A, of K1's warpgroup count) where it fits, else R
inline bool now_slab_fits(long long R, long long L, long long W) {
    Args a = {};
    a.R = (int)R;
    a.L = (int)L;
    a.W = (int)W;
    plan_steps(a);
    return slab_smem(a, warpgroups(R)) <= (size_t)kSmemLimit;
}

// Launches the instantiation on `a` (operand pointers, R, Rp, L, W set;
// noW: B and G too) for B pairs (KX-H: B loci against H windows each);
// returns cudaGetLastError().
template <int kSrc, int kOut, int kProd = kProduct, int kWin = kOwn>
int launch(Args a, long long B, void* stream, int H = 1) {
    plan_steps(a, H);
    const int n_wg = warpgroups(a.R);
    const size_t fixed = kBarBytes + (size_t)kStages * (kOpBytes + kRawBytes);
    const size_t resident = fixed + (size_t)n_wg * 64 * 4 * a.Lp;
    a.resident = kWin == kGroupSlab || resident <= (size_t)kSmemLimit;
    const size_t smem =
        kWin == kGroupSlab ? slab_smem(a, n_wg)
        : a.resident       ? resident
                           : fixed + (size_t)kStages * n_wg * kOpBytes;
    if constexpr (kSrc == kStandard || kSrc == kClamped)
        a.read_vec = a.L % 4 == 0 && (uintptr_t)a.codes % 4 == 0 &&
                     (uintptr_t)a.delta % 16 == 0;
    else if constexpr (kSrc == kUnmasked)
        a.read_vec = a.L % 4 == 0 && (uintptr_t)a.delta % 16 == 0;
    else
        a.read_vec = a.L % 4 == 0 && (uintptr_t)a.packed % 16 == 0;
    auto kernel = score_best_offsets_tc_kernel<kSrc, kOut, kProd, kWin>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long per_cta = (long long)n_wg * kReadsPerWg;
    // plan S: a CTA a group of G pairs
    const long long ny = kWin == kGroupSlab ? (B + a.G - 1) / a.G : B;
    const dim3 grid((unsigned)((a.R + per_cta - 1) / per_cta), (unsigned)ny);
    kernel<<<grid, n_wg * kWgThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

bool in_range(long long B, long long R, long long L, long long W) {
    return B >= 1 && R >= 1 && L >= 1 && W >= 1 && B <= 65535 &&
           R <= INT_MAX && L <= kMaxLen && W <= INT_MAX;
}

}  // namespace

extern "C" {

// Largest read length the launches take.
int score_best_offsets_tc_max_len() { return kMaxLen; }

// codes [B,R,L] int8, delta [B,R,L] f32, lnmis [B,R] f32, win [B,L,W] int8,
// all contiguous on the device; best [B,R] f32 and off [B,R] int32 out.
// Launches on `stream` and returns cudaGetLastError().
int score_best_offsets_tc_launch(const void* codes, const void* delta,
                                 const void* lnmis, const void* win,
                                 long long B, long long R, long long L,
                                 long long W, void* best, void* off,
                                 void* stream) {
    if (!in_range(B, R, L, W)) return (int)cudaErrorInvalidValue;
    Args a = {};
    a.codes = (const int8_t*)codes;
    a.delta = (const float*)delta;
    a.lnmis = (const float*)lnmis;
    a.win = (const int8_t*)win;
    a.best = (float*)best;
    a.off = (int32_t*)off;
    a.R = a.Rp = (int)R;
    a.L = (int)L;
    a.W = (int)W;
    return launch<kStandard, kBestOff>(a, B, stream);
}

// KX-P: packed [B,Rp,L] int32, lnmis [B,R] f32 or NULL (then folded: Rp =
// R + ceil(R/L)), win [B,L,W] int8; out [B,R,2] f32. All contiguous on the
// device. Launches on `stream`, returns cudaGetLastError().
int score_packed_tc_launch(const void* packed, const void* lnmis,
                           const void* win, long long B, long long R,
                           long long Rp, long long L, long long W, void* out,
                           void* stream) {
    const bool fold = lnmis == nullptr;
    if (!in_range(B, R, L, W) || Rp != (fold ? R + (R + L - 1) / L : R) ||
        Rp > INT_MAX)
        return (int)cudaErrorInvalidValue;
    Args a = {};
    a.packed = (const int32_t*)packed;
    a.lnmis = (const float*)lnmis;
    a.win = (const int8_t*)win;
    a.out = (float*)out;
    a.R = (int)R;
    a.Rp = (int)Rp;
    a.L = (int)L;
    a.W = (int)W;
    return fold ? launch<kPackedFold, kPairOut>(a, B, stream)
                : launch<kPacked, kPairOut>(a, B, stream);
}

// KX-H: codes [B,R,L] int8, delta [B,R,L] f32, lnmis [B,R] f32 of B loci
// against H windows of W offsets, win [B,L,H*W] int8; best [B,R,H] f32 and
// off [B,R,H] int32 out (the offset within each window). All contiguous on
// the device. Launches on `stream`, returns cudaGetLastError().
int score_hap_tc_launch(const void* codes, const void* delta,
                        const void* lnmis, const void* win, long long B,
                        long long R, long long L, long long W, long long H,
                        void* best, void* off, void* stream) {
    if (!in_range(B, R, L, W) || H < 1 || H * W > INT_MAX)
        return (int)cudaErrorInvalidValue;
    Args a = {};
    a.codes = (const int8_t*)codes;
    a.delta = (const float*)delta;
    a.lnmis = (const float*)lnmis;
    a.win = (const int8_t*)win;
    a.best = (float*)best;
    a.off = (int32_t*)off;
    a.R = a.Rp = (int)R;
    a.L = (int)L;
    a.W = (int)W;
    return launch<kStandard, kHapOut>(a, B, stream, (int)H);
}

// KX-I: K1's function on limbs clamped to 0..127, the operands and
// results of score_best_offsets_tc_launch. Launches on `stream`, returns
// cudaGetLastError().
int score_int8_tc_launch(const void* codes, const void* delta,
                         const void* lnmis, const void* win, long long B,
                         long long R, long long L, long long W, void* best,
                         void* off, void* stream) {
    if (!in_range(B, R, L, W)) return (int)cudaErrorInvalidValue;
    Args a = {};
    a.codes = (const int8_t*)codes;
    a.delta = (const float*)delta;
    a.lnmis = (const float*)lnmis;
    a.win = (const int8_t*)win;
    a.best = (float*)best;
    a.off = (int32_t*)off;
    a.R = a.Rp = (int)R;
    a.L = (int)L;
    a.W = (int)W;
    return launch<kClamped, kBestOff>(a, B, stream);
}

// KX-A on K1's pipeline: `which` 0 is noA (codes not read), 1 noW (pair b
// scores against the window of pair b/G*G, G >= 1; plan S or R as
// score_now_tc_plan says), 2 nomax (off 0), 3 nodot (R <= 4L and W <= 4L),
// the codes and arguments of score_ablation_launch (score_variants.cu).
// codes [B,R,L] int8, delta [B,R,L] f32, lnmis [B,R] f32, win [B,L,W] int8;
// best [B,R] f32 and off [B,R] int32 out. All contiguous on the device.
// Launches on `stream`, returns cudaGetLastError().
int score_ablation_tc_launch(const void* codes, const void* delta,
                             const void* lnmis, const void* win, long long B,
                             long long R, long long L, long long W,
                             long long G, int which, void* best, void* off,
                             void* stream) {
    if (!in_range(B, R, L, W) || G < 1 ||
        (which == 3 && (R > 4 * L || W > 4 * L)))
        return (int)cudaErrorInvalidValue;
    Args a = {};
    a.codes = (const int8_t*)codes;
    a.delta = (const float*)delta;
    a.lnmis = (const float*)lnmis;
    a.win = (const int8_t*)win;
    a.best = (float*)best;
    a.off = (int32_t*)off;
    a.R = a.Rp = (int)R;
    a.L = (int)L;
    a.W = (int)W;
    a.B = (int)B;
    a.G = (int)(G < B ? G : B);   // a group of B or more: all B pairs
    switch (which) {
        case 0: return launch<kUnmasked, kBestOff>(a, B, stream);
        case 1:
            return now_slab_fits(R, L, W)
                       ? launch<kStandard, kBestOff, kProduct, kGroupSlab>(
                             a, B, stream)
                       : launch<kStandard, kBestOff, kProduct, kGroupRing>(
                             a, B, stream);
        case 2: return launch<kStandard, kBestOnly>(a, B, stream);
        case 3: return launch<kStandard, kBestOff, kSlabSlice>(a, B, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The plan a noW launch of this shape takes: 1 for S (one expanded window,
// the slab, a group of G pairs; the shared memory of the barriers, the raw
// ring, the slab and K1's resident A fits in 232,448 bytes), 0 for R (K1's
// ring on the group's window); -1 for a shape the launch refuses.
int score_now_tc_plan(long long B, long long R, long long L, long long W,
                      long long G) {
    if (!in_range(B, R, L, W) || G < 1) return -1;
    return now_slab_fits(R, L, W) ? 1 : 0;
}

}  // extern "C"
