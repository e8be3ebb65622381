// Variants of the read x haplotype best-offset scorer on Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's A/B harness
// benchmarks/exp_exact_kernel.py that compute a function or take operands
// that K1 (csrc/score_best_offsets_tc.cu) does not. The two packed kernels
// are KX-P's SIMT design, which K1's tensor-core pipeline replaced on every
// path (score_best_offsets_tc.cu, score_packed_tc_launch); they stay as its
// before-numbers (ops/score_variants.KERNELS["packed_simt"],
// ["packed_fold_simt"]). So do score_onesum_kernel (KX-K-s) and
// score_hap_kernel (KX-H-s), replaced on every path by K1-h's bf16 pipeline
// on two pieces (score_highest_tc.cu, score_onesum_tc_launch) and by K1's
// u8 pipeline walking H windows (score_best_offsets_tc.cu,
// score_hap_tc_launch): KERNELS["onesum_simt"], ["hap_simt"].
//
//   score_packed_kernel<false>  build_fused.kern :451 / _kernel_fused :418,
//                               build_packedin.kern :579 (pallas_call :489,
//                               :625): K1 on one int32 per base,
//                               p = (d_int << 3) | code, with lnmis f32 [B,R];
//                               out f32 [B,R,2] = (best, bits of the offset).
//   score_packed_kernel<true>   build_packedin(fold_lnmis=True) (:625): the
//                               same with the bits of lnmis folded in as
//                               ceil(R/L) extra rows of the packed operand.
//   score_onesum_kernel         _kernel_limb2k :241 (:720): one int32 sum of
//                               (d_int & 0xFFFF) = limb_1*256 + limb_0 per
//                               offset, s = f32(S) * 2^-11 + lnmis, L <= 256.
//   score_hap_kernel            build_hap2.kern :860 (:889): reads [B,R,L]
//                               against H windows win [B,L,H*W]; best and off
//                               [B,R,H], the offset within each window.
//   score_ablation_kernel<V>    the timing ablations of _kernel_limb2 (:720),
//                               each dropping the stage its Pallas body drops
//                               and computing that body's (wrong by design)
//                               result: kNoA _kernel_limb2_noA :310 (limbs
//                               not masked by the read's code), kNoW
//                               _kernel_limb2_noW :333 (pair b scores against
//                               the window of pair b/G*G, the first of its
//                               grid step of G), kNoMax _kernel_limb2_nomax
//                               :360 (no argmax: off = 0), kNoDot
//                               _kernel_limb2_nodot :386 (no product; see
//                               nodot_sum).
//   score_int8_mma_kernel       _kernel_int8 :109 (:720): K1 with each limb
//                               clamped to 0..127, on the int8 tensor cores.
//
// For each pair b and read r, over window offsets w, with
// match = [code[r,l] < 4 && code[r,l] == win[l,w]]:
//   K1 form:  S_j[w] = sum_l limb_j(d_int) * match,
//             s[w] = (f32(S_1) * 256 + f32(S_0)) * 2^-11 + lnmis[r]
//   one sum:  S[w] = sum_l (d_int & 0xFFFF) * match, s[w] = f32(S) * 2^-11 + lnmis
// and best = max_w s[w] at its first (lowest) w. The sums are exact integers;
// for L <= 256, S = 256*S_1 + S_0 < 2^24, so f32(S) is exact and equals
// RN(f32(S_1)*256 + f32(S_0)): the one-sum form gives K1's bits. The f32
// steps are written with __fmul_rn/__fadd_rn so nvcc cannot contract them.
//
// Bound on the H100: bytes. At the harness's shape (B,R,L,W =
// 512,128,128,128) the packed form moves B*(4RL + LW + 12R) bytes, ~13 us at
// 3.35 TB/s, against ~2 us of int8 tensor-core work for its 2*B*R*L*W
// compare-adds; the one-sum form and the ablations move about K1's
// B*(5RL + LW + 12R) (noA reads no codes, noW one window in G); the hap form
// B*(5RL + 4R + L*H*W + 8RH) for 2*B*R*L*H*W compare-adds.
//
// Design of score_body, the simple one of K1: one block per (pair, 32 reads),
// 8 warps of 4 reads, the window staged in shared memory 128 offsets at a
// time, each lane scoring 4 consecutive offsets with int32 accumulators and a
// running best per read in registers, so nothing crosses blocks. Unlike K1,
// each block first builds its reads' operand once into shared memory as one
// word per base, (code << 16) | (d_int & 0xFFFF), which every later chunk and
// window (H of them in the hap form) reads by broadcast: the read bytes come
// from device memory once per block, not once per window. The compare-adds
// run on the CUDA cores, far above the byte bound. score_int8_mma_kernel's
// own design note is at its definition below.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kSmemLimit = 232448;        // dynamic shared memory a block
constexpr unsigned char kNoWin = 0xFEu;   // window past W (masked anyway)
constexpr float kQuantInv = 1.0f / 2048.0f;

constexpr int kWarps = 8;
constexpr int kReadsPerWarp = 4;
constexpr int kReadsPerBlock = kWarps * kReadsPerWarp;
constexpr int kWChunk = 128;              // offsets per shared-memory chunk
constexpr unsigned kNoRead = 0x100u;      // read code >= 4: equals no byte
// shared memory: the reads' words, their lnmis, one window chunk
constexpr int kMaxLen = (kSmemLimit - kReadsPerBlock * 4) / (kReadsPerBlock * 4 + kWChunk);
constexpr int kOneSumMaxLen = 256;         // the one sum S < 2^24

enum Variant { kPacked, kPackedFold, kOneSum, kHap, kNoA, kNoW, kNoMax, kNoDot };

struct Args {
    const int8_t* codes;    // [B,R,L]            (all but the packed forms)
    const float* delta;     // [B,R,L]            (all but the packed forms)
    const int32_t* packed;  // [B,Rp,L]           (kPacked, kPackedFold)
    const float* lnmis;     // [B,R]              (all but kPackedFold)
    const int8_t* win;      // [B,L,H*W]
    int R, Rp, L, W, H;
    int G;                  // pairs a window serves (kNoW), else 1
    float* best;            // [B,R,H]            (all but the packed forms)
    int32_t* off;           // [B,R,H]            (all but the packed forms)
    float* out;             // [B,R,2]            (kPacked, kPackedFold)
};

// (s, w) beats (bs, bw): larger score, or the same score at a lower offset
__device__ __forceinline__ bool better(float s, int w, float bs, int bw) {
    return s > bs || (s == bs && w < bw);
}

// _kernel_limb2_nodot's s[r, w] before scaling: its A slab [2R, 4L] (row
// j*R + r, column c*L + l: limb j of base l where the read's code is c) plus
// its window slab [4L, W] (row c*L + l, column w: [win[l, w] == c]), both
// read at row r and column w; valid for R <= 4L and W <= 4L. p is the read
// word of base w % L, wc the window code at row r % L, offset w.
__device__ __forceinline__ int nodot_sum(unsigned p, unsigned wc, int r,
                                         int w, int L) {
    const int a = (p >> 16) == (unsigned)(w / L) ? (int)((p >> 8) & 255u) : 0;
    return a + (wc == (unsigned)(r / L) ? 1 : 0);
}

template <int kVar>
__device__ __forceinline__ void score_body(const Args& a) {
    constexpr bool kPackedIn = kVar == kPacked || kVar == kPackedFold;
    extern __shared__ __align__(16) unsigned char smem[];
    const int L = a.L;
    unsigned* rd_s = reinterpret_cast<unsigned*>(smem);      // [32][L]
    float* ls_s = reinterpret_cast<float*>(rd_s + kReadsPerBlock * L);
    unsigned char* win_s =
        reinterpret_cast<unsigned char*>(ls_s + kReadsPerBlock);  // [L][128]
    const int b = blockIdx.y;
    const int rb = blockIdx.x * kReadsPerBlock;

    // the block's reads, once: (code << 16) | (d_int & 0xFFFF)
    for (int idx = threadIdx.x; idx < kReadsPerBlock * L; idx += blockDim.x) {
        const int i = idx / L;
        const int l = idx - i * L;
        const int r = rb + i;
        unsigned word = kNoRead << 16;
        if (r < a.R) {
            int c = 0, d;   // kNoA reads no codes: its limbs are unmasked
            if constexpr (kPackedIn) {
                const int p = a.packed[((size_t)b * a.Rp + r) * L + l];
                c = p & 7;
                d = p >> 3;
            } else {
                const size_t o = ((size_t)b * a.R + r) * L + l;
                if constexpr (kVar != kNoA) c = a.codes[o];
                d = (int)(a.delta[o] * 2048.0f);
            }
            const unsigned cc = (c >= 0 && c < 4) ? (unsigned)c : kNoRead;
            word = (cc << 16) | ((unsigned)d & 0xFFFFu);
        }
        rd_s[idx] = word;
    }
    for (int i = threadIdx.x; i < kReadsPerBlock; i += blockDim.x) {
        const int r = rb + i;
        float ls = 0.0f;
        if (r < a.R) {
            if constexpr (kVar == kPackedFold) {
                // raw f32 bits in row R + r/L, column r%L
                ls = __int_as_float(
                    a.packed[((size_t)b * a.Rp + a.R + r / L) * L + r % L]);
            } else {
                ls = a.lnmis[(size_t)b * a.R + r];
            }
        }
        ls_s[i] = ls;
    }

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = a.H * a.W;   // window row stride
    const int wb = kVar == kNoW ? b / a.G * a.G : b;
    const int8_t* win_b = a.win + (size_t)wb * L * row;

    for (int h = 0; h < a.H; ++h) {
        float run_s[kReadsPerWarp];
        int run_w[kReadsPerWarp];
#pragma unroll
        for (int i = 0; i < kReadsPerWarp; ++i) {
            run_s[i] = -INFINITY;
            run_w[i] = INT_MAX;
        }
        for (int w0 = 0; w0 < a.W; w0 += kWChunk) {
            __syncthreads();
            for (int idx = threadIdx.x; idx < L * kWChunk; idx += blockDim.x) {
                const int l = idx / kWChunk;
                const int w = w0 + (idx - l * kWChunk);
                win_s[idx] = w < a.W
                    ? (unsigned char)win_b[(size_t)l * row + h * a.W + w]
                    : kNoWin;
            }
            __syncthreads();

#pragma unroll
            for (int i = 0; i < kReadsPerWarp; ++i) {
                const int li = warp * kReadsPerWarp + i;
                if (rb + li >= a.R) break;  // warp-uniform
                const unsigned* rw = rd_s + li * L;
                int s1[4] = {0, 0, 0, 0};   // the one sum in kOneSum
                int s0[4] = {0, 0, 0, 0};
                if constexpr (kVar != kNoDot) {
#pragma unroll 4
                    for (int l = 0; l < L; ++l) {
                        const unsigned p = rw[l];   // broadcast
                        const unsigned c = p >> 16;
                        const unsigned wv = *reinterpret_cast<const unsigned*>(
                            &win_s[l * kWChunk + 4 * lane]);
                        if constexpr (kVar == kOneSum) {
                            const int dv = (int)(p & 0xFFFFu);
#pragma unroll
                            for (int k = 0; k < 4; ++k)
                                s1[k] += ((wv >> (8 * k)) & 255u) == c ? dv : 0;
                        } else {
                            const int limb1 = (int)((p >> 8) & 255u);
                            const int limb0 = (int)(p & 255u);
#pragma unroll
                            for (int k = 0; k < 4; ++k) {
                                const unsigned wc = (wv >> (8 * k)) & 255u;
                                const bool m = kVar == kNoA ? wc < 4u : wc == c;
                                s1[k] += m ? limb1 : 0;
                                s0[k] += m ? limb0 : 0;
                            }
                        }
                    }
                }
                const float ls = ls_s[li];
                float bs = -INFINITY;
                int bw = INT_MAX;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int w = w0 + 4 * lane + k;
                    if (w < a.W) {
                        float comb;
                        if constexpr (kVar == kOneSum) {
                            comb = (float)s1[k];   // exact: S < 2^24
                        } else if constexpr (kVar == kNoDot) {
                            const int r = rb + li;
                            comb = (float)nodot_sum(
                                rw[w % L], win_s[(r % L) * kWChunk + 4 * lane + k],
                                r, w, L);
                        } else {
                            comb = __fadd_rn(__fmul_rn((float)s1[k], 256.0f),
                                             (float)s0[k]);
                        }
                        const float s = __fadd_rn(__fmul_rn(comb, kQuantInv),
                                                  ls);
                        if (s > bs) {  // k ascending: strict keeps the first
                            bs = s;
                            if constexpr (kVar != kNoMax) bw = w;
                        }
                    }
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    const float os = __shfl_xor_sync(0xffffffffu, bs, o);
                    if constexpr (kVar == kNoMax) {
                        if (os > bs) bs = os;
                    } else {
                        const int ow = __shfl_xor_sync(0xffffffffu, bw, o);
                        if (better(os, ow, bs, bw)) {
                            bs = os;
                            bw = ow;
                        }
                    }
                }
                if constexpr (kVar == kNoMax) {
                    if (bs > run_s[i]) run_s[i] = bs;
                } else if (better(bs, bw, run_s[i], run_w[i])) {
                    run_s[i] = bs;
                    run_w[i] = bw;
                }
            }
        }

        if (lane == 0) {
#pragma unroll
            for (int i = 0; i < kReadsPerWarp; ++i) {
                const int r = rb + warp * kReadsPerWarp + i;
                if (r >= a.R) break;
                const size_t o = (size_t)b * a.R + r;
                if constexpr (kPackedIn) {
                    a.out[2 * o] = run_s[i];
                    a.out[2 * o + 1] = __int_as_float(run_w[i]);
                } else {
                    a.best[o * a.H + h] = run_s[i];
                    a.off[o * a.H + h] = kVar == kNoMax ? 0 : run_w[i];
                }
            }
        }
    }
}

template <bool kFoldLnmis>
__global__ void __launch_bounds__(kWarps * 32) score_packed_kernel(Args a) {
    score_body<kFoldLnmis ? kPackedFold : kPacked>(a);
}

__global__ void __launch_bounds__(kWarps * 32) score_onesum_kernel(Args a) {
    score_body<kOneSum>(a);
}

__global__ void __launch_bounds__(kWarps * 32) score_hap_kernel(Args a) {
    score_body<kHap>(a);
}

template <int kVar>
__global__ void __launch_bounds__(kWarps * 32) score_ablation_kernel(Args a) {
    score_body<kVar>(a);
}

int launch(void (*kernel)(Args), const Args& a, long long B, void* stream) {
    if (B < 1 || B > 65535 || a.R < 1 || a.L < 1 || a.L > kMaxLen ||
        a.W < 1 || a.H < 1 || a.G < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)kReadsPerBlock * 4 * (a.L + 1) +
                        (size_t)a.L * kWChunk;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((unsigned)((a.R + kReadsPerBlock - 1) / kReadsPerBlock),
                    (unsigned)B);
    kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

bool fits_int(long long v) { return v >= 0 && v <= INT_MAX; }

Args standard_args(const void* codes, const void* delta, const void* lnmis,
                   const void* win, long long R, long long L, long long W,
                   void* best, void* off) {
    Args a = {};
    a.codes = (const int8_t*)codes;
    a.delta = (const float*)delta;
    a.lnmis = (const float*)lnmis;
    a.win = (const int8_t*)win;
    a.R = (int)R; a.Rp = (int)R; a.L = (int)L; a.W = (int)W; a.H = 1; a.G = 1;
    a.best = (float*)best;
    a.off = (int32_t*)off;
    return a;
}

// --- score_int8_mma_kernel ----------------------------------------------------
//
// _kernel_int8's function: K1's with each base-256 limb of
// d_int = (int)(delta * 2^11) clamped to 0..127, so that it fits a signed
// int8 operand:
//
//   S_j[w] = sum_l min(limb_j(d_int[r,l]), 127) * [code[r,l] < 4 && code[r,l] == win[l,w]]
//   s[w]   = (f32(S_1) * 256 + f32(S_0)) * 2^-11 + lnmis[r]
//
// As a product: A [2R, 4L] s8 (row (j, r), column (l, c): the clamped limb j
// of base l where its code is c, else 0) times B [4L, W] s8 (the window's
// one-hot: B[(l, c), w] = [win[l,w] == c]), summed in s32, which is exact.
// With .u8.u8 operands and no clamp the same product would give K1's own
// function; whether K1 should move to the tensor cores is the redesign's
// question, not this kernel's.
//
// Bound: bytes. It moves K1's B*(5RL + LW + 12R) bytes, ~15 us at the
// harness's shape at 3.35 TB/s, against 2*(2R)*(4L)*W*B = 17.2 G int8
// operations, ~9 us at 1,979 TOP/s.
//
// Design, the simple one: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 by
// inline PTX. The contraction axis is ordered k = 4*l + c, so one 32-bit
// register of an A fragment is one base of one read, limb << (8*code), and
// one register of a B fragment is one window base's one-hot, 1 << (8*code):
// neither operand is materialised as a one-hot slab. One block per (pair, 64
// reads), 4 warps of 16 reads; each block first stages its reads' two A words
// per base in shared memory (rows padded so fragment loads hit distinct
// banks), then walks the window 64 offsets at a time: it stages the chunk's
// codes in shared memory, and each warp runs 8 n-tiles x 2 limbs of s32
// accumulators over the whole contraction, then combines and keeps the first
// max per read, reduced over the 4 lanes that share a row and merged across
// chunks in registers. Occupancy is low (2 blocks an SM at L=160); TMA,
// wgmma and a deeper pipeline are the later work.

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16;                            // reads: the m16 tile
constexpr int kMmaReadsPerBlock = kMmaWarps * kMmaRows;
constexpr int kNChunk = 64;                             // offsets per chunk
constexpr int kNTiles = kNChunk / 8;                    // n8 tiles per chunk
constexpr int kWinStride = kNChunk + 4;                 // bytes per window row

// four s8 lanes: byte c set to 1 for a window code c in 0..3
__device__ __forceinline__ unsigned onehot(unsigned v) {
    return v < 4u ? 1u << (8u * v) : 0u;
}

// c += A (16x32 s8, row) * B (32x8 s8, col), s32
__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float combine(int s1, int s0, float ls) {
    const float comb = __fadd_rn(__fmul_rn((float)s1, 256.0f), (float)s0);
    return __fadd_rn(__fmul_rn(comb, kQuantInv), ls);
}

// Lp: L rounded up to a multiple of 8 (one k32 step covers 8 bases)
__global__ void __launch_bounds__(kMmaWarps * 32)
score_int8_mma_kernel(const int8_t* __restrict__ codes,
                      const float* __restrict__ delta,
                      const float* __restrict__ lnmis,
                      const int8_t* __restrict__ win, int R, int L, int Lp,
                      int W, float* __restrict__ best,
                      int32_t* __restrict__ off) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int stride = Lp + 4;   // uint2 per read row: banks differ by row
    uint2* a_s = reinterpret_cast<uint2*>(smem);   // [64][stride]
    unsigned char* win_s = reinterpret_cast<unsigned char*>(
        a_s + kMmaReadsPerBlock * stride);         // [Lp][kWinStride]
    const int b = blockIdx.y;
    const int rb = blockIdx.x * kMmaReadsPerBlock;

    // A words of the block's reads: (clamped limb_1, clamped limb_0) << 8c
    for (int idx = threadIdx.x; idx < kMmaReadsPerBlock * Lp;
         idx += blockDim.x) {
        const int i = idx / Lp;
        const int l = idx - i * Lp;
        const int r = rb + i;
        uint2 v = make_uint2(0u, 0u);
        if (r < R && l < L) {
            const size_t o = ((size_t)b * R + r) * L + l;
            const int c = codes[o];
            if (c >= 0 && c < 4) {
                const int d = (int)(delta[o] * 2048.0f);
                const unsigned sh = 8u * (unsigned)c;
                v.x = (unsigned)min((d >> 8) & 255, 127) << sh;
                v.y = (unsigned)min(d & 255, 127) << sh;
            }
        }
        a_s[i * stride + l] = v;
    }

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;   // fragment row (and n column of B)
    const int t4 = lane & 3;   // thread in group
    const int ra = warp * kMmaRows + g;   // local reads of c0,c1 / c2,c3
    const int rc = ra + 8;
    const float ls_a = rb + ra < R ? lnmis[(size_t)b * R + rb + ra] : 0.0f;
    const float ls_c = rb + rc < R ? lnmis[(size_t)b * R + rb + rc] : 0.0f;
    float run_a = -INFINITY, run_c = -INFINITY;
    int wa = INT_MAX, wc = INT_MAX;
    const int8_t* win_b = win + (size_t)b * L * W;

    for (int w0 = 0; w0 < W; w0 += kNChunk) {
        __syncthreads();
        for (int idx = threadIdx.x; idx < Lp * kNChunk; idx += blockDim.x) {
            const int l = idx / kNChunk;
            const int j = idx - l * kNChunk;
            const int w = w0 + j;
            win_s[l * kWinStride + j] =
                (l < L && w < W) ? (unsigned char)win_b[(size_t)l * W + w]
                                 : kNoWin;
        }
        __syncthreads();

        int c1[kNTiles][4], c0[kNTiles][4];
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                c1[t][q] = 0;
                c0[t][q] = 0;
            }
        }
        for (int l0 = 0; l0 < Lp; l0 += 8) {
            // A: rows g / g+8, k = 4*(l0 + t4) + c and 16 + 4*(l0 + t4) + c
            const uint2 p0 = a_s[ra * stride + l0 + t4];
            const uint2 p1 = a_s[rc * stride + l0 + t4];
            const uint2 p2 = a_s[ra * stride + l0 + 4 + t4];
            const uint2 p3 = a_s[rc * stride + l0 + 4 + t4];
            // B: column n = g, the same two bases
            const unsigned char* w_0 = win_s + (l0 + t4) * kWinStride + g;
            const unsigned char* w_1 = win_s + (l0 + 4 + t4) * kWinStride + g;
#pragma unroll
            for (int t = 0; t < kNTiles; ++t) {
                const unsigned b0 = onehot(w_0[8 * t]);
                const unsigned b1 = onehot(w_1[8 * t]);
                mma_s8(c1[t], p0.x, p1.x, p2.x, p3.x, b0, b1);
                mma_s8(c0[t], p0.y, p1.y, p2.y, p3.y, b0, b1);
            }
        }

        // c[t][0..1]: read ra, offsets 8t + 2*t4 + {0,1}; c[t][2..3]: read rc
        float ba = -INFINITY, bc = -INFINITY;
        int bwa = INT_MAX, bwc = INT_MAX;
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int w = w0 + 8 * t + 2 * t4 + j;   // ascending
                if (w < W) {
                    const float sa = combine(c1[t][j], c0[t][j], ls_a);
                    const float sc = combine(c1[t][2 + j], c0[t][2 + j], ls_c);
                    if (sa > ba) {   // strict keeps the first
                        ba = sa;
                        bwa = w;
                    }
                    if (sc > bc) {
                        bc = sc;
                        bwc = w;
                    }
                }
            }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {   // the 4 lanes of a row
            const float oa = __shfl_xor_sync(0xffffffffu, ba, o);
            const int owa = __shfl_xor_sync(0xffffffffu, bwa, o);
            const float oc = __shfl_xor_sync(0xffffffffu, bc, o);
            const int owc = __shfl_xor_sync(0xffffffffu, bwc, o);
            if (better(oa, owa, ba, bwa)) {
                ba = oa;
                bwa = owa;
            }
            if (better(oc, owc, bc, bwc)) {
                bc = oc;
                bwc = owc;
            }
        }
        if (better(ba, bwa, run_a, wa)) {
            run_a = ba;
            wa = bwa;
        }
        if (better(bc, bwc, run_c, wc)) {
            run_c = bc;
            wc = bwc;
        }
    }

    if (t4 == 0) {
        if (rb + ra < R) {
            best[(size_t)b * R + rb + ra] = run_a;
            off[(size_t)b * R + rb + ra] = wa;
        }
        if (rb + rc < R) {
            best[(size_t)b * R + rb + rc] = run_c;
            off[(size_t)b * R + rb + rc] = wc;
        }
    }
}

size_t mma_smem_bytes(int Lp) {
    return (size_t)kMmaReadsPerBlock * (Lp + 4) * sizeof(uint2) +
           (size_t)Lp * kWinStride;
}

int mma_max_len() {
    int Lp = 8;
    while (mma_smem_bytes(Lp + 8) <= (size_t)kSmemLimit) Lp += 8;
    return Lp;
}

}  // namespace

extern "C" {

// Largest read length every launch here takes (shared memory).
int score_variants_max_len() {
    return kMaxLen < mma_max_len() ? kMaxLen : mma_max_len();
}

// Largest read length score_onesum_launch takes.
int score_onesum_max_len() {
    const int n = score_variants_max_len();
    return kOneSumMaxLen < n ? kOneSumMaxLen : n;
}

// packed [B,Rp,L] int32, lnmis [B,R] f32 or NULL (then folded: Rp = R +
// ceil(R/L)), win [B,L,W] int8; out [B,R,2] f32. All contiguous on the
// device. Launches on `stream`, returns cudaGetLastError().
int score_packed_launch(const void* packed, const void* lnmis,
                        const void* win, long long B, long long R,
                        long long Rp, long long L, long long W, void* out,
                        void* stream) {
    if (!fits_int(R) || !fits_int(Rp) || !fits_int(L) || !fits_int(W) ||
        !fits_int(L * W))
        return (int)cudaErrorInvalidValue;
    const bool fold = lnmis == nullptr;
    if (Rp != (fold ? R + (R + L - 1) / L : R))
        return (int)cudaErrorInvalidValue;
    Args a = {};
    a.packed = (const int32_t*)packed;
    a.lnmis = (const float*)lnmis;
    a.win = (const int8_t*)win;
    a.R = (int)R; a.Rp = (int)Rp; a.L = (int)L; a.W = (int)W; a.H = 1; a.G = 1;
    a.out = (float*)out;
    return fold ? launch(score_packed_kernel<true>, a, B, stream)
                : launch(score_packed_kernel<false>, a, B, stream);
}

// codes [B,R,L] int8, delta [B,R,L] f32, lnmis [B,R] f32, win [B,L,W] int8;
// best [B,R] f32, off [B,R] int32. L <= 256 (the one sum is exact below
// 2^24).
int score_onesum_launch(const void* codes, const void* delta,
                        const void* lnmis, const void* win, long long B,
                        long long R, long long L, long long W, void* best,
                        void* off, void* stream) {
    if (!fits_int(R) || L > kOneSumMaxLen || !fits_int(W) ||
        !fits_int(L * W))
        return (int)cudaErrorInvalidValue;
    return launch(score_onesum_kernel,
                  standard_args(codes, delta, lnmis, win, R, L, W, best, off),
                  B, stream);
}

// codes/delta [B,R,L], lnmis [B,R], win [B,L,H*W] int8 (window h in columns
// h*W .. h*W+W-1); best [B,R,H] f32, off [B,R,H] int32 (0 <= off < W).
int score_hap_launch(const void* codes, const void* delta, const void* lnmis,
                     const void* win, long long B, long long R, long long L,
                     long long W, long long H, void* best, void* off,
                     void* stream) {
    if (!fits_int(R) || !fits_int(L) || !fits_int(W) || !fits_int(H) ||
        !fits_int(H * W) || !fits_int(L * H * W))
        return (int)cudaErrorInvalidValue;
    Args a = standard_args(codes, delta, lnmis, win, R, L, W, best, off);
    a.H = (int)H;
    return launch(score_hap_kernel, a, B, stream);
}

// The timing ablations, `which` 0 noA, 1 noW, 2 nomax, 3 nodot, on the
// operands of score_onesum_launch (any L the kernel takes). noW: pair b
// scores against the window of pair b/G*G, G >= 1. nodot: R <= 4L and
// W <= 4L.
int score_ablation_launch(const void* codes, const void* delta,
                          const void* lnmis, const void* win, long long B,
                          long long R, long long L, long long W, long long G,
                          int which, void* best, void* off, void* stream) {
    if (!fits_int(R) || !fits_int(L) || !fits_int(W) || !fits_int(L * W) ||
        !fits_int(G) || G < 1 || (which == 3 && (R > 4 * L || W > 4 * L)))
        return (int)cudaErrorInvalidValue;
    Args a = standard_args(codes, delta, lnmis, win, R, L, W, best, off);
    switch (which) {
        case 0: return launch(score_ablation_kernel<kNoA>, a, B, stream);
        case 1:
            a.G = (int)G;
            return launch(score_ablation_kernel<kNoW>, a, B, stream);
        case 2: return launch(score_ablation_kernel<kNoMax>, a, B, stream);
        case 3: return launch(score_ablation_kernel<kNoDot>, a, B, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// codes [B,R,L] int8, delta [B,R,L] f32, lnmis [B,R] f32, win [B,L,W] int8,
// all contiguous on the device; best [B,R] f32 and off [B,R] int32 out.
// Launches on `stream` and returns cudaGetLastError().
int score_int8_mma_launch(const void* codes, const void* delta,
                          const void* lnmis, const void* win, long long B,
                          long long R, long long L, long long W, void* best,
                          void* off, void* stream) {
    if (B < 1 || B > 65535 || R < 1 || R > INT_MAX || L < 1 ||
        L > mma_max_len() || W < 1 || W > INT_MAX / L)
        return (int)cudaErrorInvalidValue;
    const int Lp = (int)((L + 7) / 8 * 8);
    const size_t smem = mma_smem_bytes(Lp);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            score_int8_mma_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(
        (unsigned)((R + kMmaReadsPerBlock - 1) / kMmaReadsPerBlock),
        (unsigned)B);
    score_int8_mma_kernel<<<grid, kMmaWarps * 32, smem,
                            (cudaStream_t)stream>>>(
        (const int8_t*)codes, (const float*)delta, (const float*)lnmis,
        (const int8_t*)win, (int)R, (int)L, Lp, (int)W, (float*)best,
        (int32_t*)off);
    return (int)cudaGetLastError();
}

}  // extern "C"
