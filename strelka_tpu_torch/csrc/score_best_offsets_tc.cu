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
// Only the reads' expansion into A words, lnmis, the window's columns and
// the output store differ (template parameters); K1's instantiation is the
// code it was.
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
// B*(5*R*L + 4*R + L*H*W + 8*R*H) for H times the compare-adds.
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
// (KX-P), best and off [B,R,H] against H windows (KX-H)
enum Output { kBestOff, kPairOut, kHapOut };

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
            if constexpr (kSrc == kStandard) {
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
                a_words(c[0], d[0], v1.x, v0.x);
                a_words(c[1], d[1], v1.y, v0.y);
                a_words(c[2], d[2], v1.z, v0.z);
                a_words(c[3], d[3], v1.w, v0.w);
            } else {   // packed: code p & 7, d_int p >> 3
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

template <int kSrc, int kOut>
__global__ void __launch_bounds__(kMaxWg* kWgThreads)
    score_best_offsets_tc_kernel(const Args a) {
    constexpr bool kHap = kOut == kHapOut;
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [kStages]
    unsigned char* bw = smem + kBarBytes;                 // [kStages][kOpBytes]
    unsigned char* raw = bw + kStages * kOpBytes;         // [kStages][kRawBytes]
    unsigned char* as = raw + kStages * kRawBytes;        // A words
    const int tid = threadIdx.x;
    const int n_wg = blockDim.x / kWgThreads;
    const int wg = tid / kWgThreads;
    const int n_reads = n_wg * kReadsPerWg;
    const int b = blockIdx.y;
    const long long r0 = (long long)blockIdx.x * n_reads;
    const int total = a.nT * a.nK;   // steps: N tiles x K chunks, K fastest
    // A: the whole read length (row group stride 32*Lp), or a 3-slot ring
    // of chunks (stride 8*kChunkK)
    const uint32_t sbo_a = a.resident ? 32u * a.Lp : 8u * kChunkK;
    const size_t a_slot = (size_t)n_wg * kOpBytes;

    init_ring(full);
    for (int s = 0; s < 2 && s < total; ++s)
        stage_window<kHap>(a, b, s, raw + s * kRawBytes, &full[s]);
    expand_a<kSrc>(a, b, r0, n_reads, 0,
                   a.resident ? a.Lp / 4 : kChunkBases / 4, as, sbo_a);
    mbar_wait(&full[0], 0);
    expand_w<kHap>(a, 0, raw, bw);
    fence_proxy_async();
    __syncthreads();

    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const long long r = r0 + wg * kReadsPerWg + ((tid >> 5) & 3) * 8 + g;
    const float ls = r < a.R ? read_lnmis<kSrc>(a, b, r) : 0.0f;
    float run_s = -INFINITY;
    int run_w = INT_MAX;
    int acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0;

    for (int it = 0; it < total; ++it) {
        const int nt = it / a.nK;
        const int kc = it - nt * a.nK;
        const int slot = it % kStages;
        // the tensor cores on step it (asynchronous)
        const unsigned char* a_op =
            (a.resident ? as + (size_t)kc * (kChunkK / 16) * kCore
                        : as + slot * a_slot) +
            (size_t)wg * 8 * sbo_a;
        const unsigned char* b_op = bw + slot * kOpBytes;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
            wgmma_u8(acc, desc(a_op + 2 * s * kCore, kCore, sbo_a),
                     desc(b_op + 2 * s * kCore, kCore, 8 * kChunkK),
                     kc > 0 || s > 0);
        wgmma_commit();
        // the window two steps ahead
        if (it + 2 < total)
            stage_window<kHap>(a, b, it + 2,
                               raw + ((it + 2) % kStages) * kRawBytes,
                               &full[(it + 2) % kStages]);
        // the operands of step it+1, into the slot step it-2 read
        if (it + 1 < total) {
            const int s1 = (it + 1) % kStages;
            if (!a.resident) {
                const int k1 = (it + 1) % a.nK;
                expand_a<kSrc>(a, b, r0, n_reads, k1 * (kChunkBases / 4),
                               kChunkBases / 4, as + s1 * a_slot, sbo_a);
            }
            mbar_wait(&full[s1], ((it + 1) / kStages) & 1);
            expand_w<kHap>(a, it + 1, raw + s1 * kRawBytes,
                           bw + s1 * kOpBytes);
            fence_proxy_async();
        }
        if (kc == a.nK - 1) {
            // the tile's sums: thread holds read r at offsets
            // 8j + 2*t4 + e, limb 1 in acc[4j+e], limb 0 in acc[4j+2+e]
            const int w0 = tile_w0<kHap>(a, nt);
            wgmma_wait<0>();
            fence_acc(acc);
#pragma unroll
            for (int j = 0; j < kNTile / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int w = w0 + 8 * j + 2 * t4 + e;   // ascending
                    const int S = acc[4 * j + e] * 256 + acc[4 * j + 2 + e];
                    const float s = __fadd_rn(
                        __fmul_rn(__int2float_rn(S), kQuantInv), ls);
                    if (w < a.W && s > run_s) {   // strict keeps the first
                        run_s = s;
                        run_w = w;
                    }
                }
            }
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
        } else {
            wgmma_wait<1>();   // step it-1 done: its slots are free
        }
        __syncthreads();
    }

    if constexpr (!kHap) {
        merge_lanes(run_s, run_w);
        if (t4 == 0 && r < a.R) {
            const size_t o = (size_t)b * a.R + r;
            if constexpr (kOut == kPairOut) {
                a.out[2 * o] = run_s;
                a.out[2 * o + 1] = __int_as_float(run_w);
            } else {
                a.best[o] = run_s;
                a.off[o] = run_w;
            }
        }
    }
}

// Launches the instantiation on `a` (operand pointers, R, Rp, L, W set)
// for B pairs (KX-H: B loci against H windows each); returns
// cudaGetLastError().
template <int kSrc, int kOut>
int launch(Args a, long long B, void* stream, int H = 1) {
    plan_steps(a, H);
    const long long want = (a.R + kReadsPerWg - 1) / kReadsPerWg;
    const int n_wg = (int)(want < kMaxWg ? want : kMaxWg);
    const size_t fixed = kBarBytes + (size_t)kStages * (kOpBytes + kRawBytes);
    const size_t resident = fixed + (size_t)n_wg * 64 * 4 * a.Lp;
    a.resident = resident <= (size_t)kSmemLimit;
    const size_t smem =
        a.resident ? resident : fixed + (size_t)kStages * n_wg * kOpBytes;
    if constexpr (kSrc == kStandard)
        a.read_vec = a.L % 4 == 0 && (uintptr_t)a.codes % 4 == 0 &&
                     (uintptr_t)a.delta % 16 == 0;
    else
        a.read_vec = a.L % 4 == 0 && (uintptr_t)a.packed % 16 == 0;
    auto kernel = score_best_offsets_tc_kernel<kSrc, kOut>;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long per_cta = (long long)n_wg * kReadsPerWg;
    const dim3 grid((unsigned)((a.R + per_cta - 1) / per_cta), (unsigned)B);
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

}  // extern "C"
