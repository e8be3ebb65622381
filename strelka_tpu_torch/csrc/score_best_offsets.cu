// Read x haplotype best-offset scoring on Hopper (sm_90a).
//
// Replaces the TPU kernel strelka_tpu/ops/pallas_readlik.py:_score_kernel
// (mode="exact", launched by _score_best_offsets). For each locus-haplotype
// pair b and read r it computes, over window offsets w,
//
//   S_j[w] = sum_l limb_j(d_int[r,l]) * [codes[r,l] < 4 && codes[r,l] == win[l,w]]
//   s[w]   = ((float)S_1 * 256 + (float)S_0) * 2^-11 + lnmis[r]
//
// with d_int = (int)(delta * 2^11), limb_1 = bits 8-15, limb_0 = bits 0-7,
// and returns max_w s[w] and its first (lowest-w) argmax. The per-limb sums
// are exact integers, so the f32 combination below, written with
// __fmul_rn/__fadd_rn so nvcc cannot contract it, gives the reference's
// bits. A read code >= 4 matches nothing, a window code of 4 included.
//
// Bound on the H100: it moves B*(5*R*L + L*W + 12*R) bytes (lnmis in, best
// and off out: 4 bytes each a read) and does 2*B*R*L*W compare-adds. At the
// main path's shapes (R=128, L=160, W=256) that is ~11 us of HBM traffic
// against ~1.4 us of int8 tensor-core work per 256 pairs, so a fast kernel
// would be bound by bytes.
//
// This is K1-s, the SIMT design that the tensor-core kernel
// (score_best_offsets_tc.cu) replaced on every path; it stays as that
// kernel's before-number (ops/score_variants.KERNELS["simt"]). One block
// per (pair, 32 reads), the window staged in shared memory 128 offsets at a
// time, each warp scoring 4 reads with its lanes over 4 consecutive offsets
// each, int32 accumulators in registers and the running best per read kept
// in registers across chunks, so nothing crosses blocks. The compare-adds
// run on the CUDA cores, well above the byte bound.
//
// The same kernel, instantiated with kHighest, is K1-h-s: the SIMT port of
// the TPU kernel's mode="highest" path (pallas_readlik.py:170-177, an f32
// HIGHEST matmul of one-hot deltas), s[w] = sum_l delta[r,l] *
// [codes[r,l] == win[l,w]] + lnmis[r] with unquantized f32 deltas. The
// bf16 tensor-core kernel (score_highest_tc.cu) replaced it on every path;
// it stays as that kernel's before-number
// (ops/score_kernel.KERNEL_FUNCTIONS["highest_simt"]). Each lane keeps four f32 sums and
// adds every matching delta in ascending l with __fadd_rn, so the order is
// fixed and nvcc cannot contract it; the result is an f32 sum in another
// order than the reference's matmul, equal to it within rounding, not bit
// for bit. It moves the same bytes as the exact mode and does 2*B*R*L*W f32
// operations, which on the CUDA cores (67 TFLOP/s) bound it by operations.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kReadsPerWarp = 4;
constexpr int kReadsPerBlock = kWarps * kReadsPerWarp;
constexpr int kWChunk = 128;              // offsets per shared-memory chunk
constexpr unsigned kNoRead = 0x100u;      // read code >= 4: equals no byte
constexpr unsigned char kNoWin = 0xFEu;   // window past W (masked anyway)
constexpr float kQuantInv = 1.0f / 2048.0f;

// (s, w) beats (bs, bw): larger score, or the same score at a lower offset
__device__ __forceinline__ bool better(float s, int w, float bs, int bw) {
    return s > bs || (s == bs && w < bw);
}

template <bool kHighest>
__global__ void __launch_bounds__(kWarps * 32)
score_best_offsets_kernel(const int8_t* __restrict__ codes,
                          const float* __restrict__ delta,
                          const float* __restrict__ lnmis,
                          const int8_t* __restrict__ win,
                          int R, int L, int W,
                          float* __restrict__ best,
                          int32_t* __restrict__ off) {
    extern __shared__ unsigned char win_s[];  // [L][kWChunk]
    const int b = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int r0 = blockIdx.x * kReadsPerBlock + warp * kReadsPerWarp;
    const int8_t* codes_b = codes + (size_t)b * R * L;
    const float* delta_b = delta + (size_t)b * R * L;
    const int8_t* win_b = win + (size_t)b * L * W;

    float run_s[kReadsPerWarp];
    int run_w[kReadsPerWarp];
#pragma unroll
    for (int i = 0; i < kReadsPerWarp; ++i) {
        run_s[i] = -INFINITY;
        run_w[i] = INT_MAX;
    }

    for (int w0 = 0; w0 < W; w0 += kWChunk) {
        __syncthreads();
        for (int idx = threadIdx.x; idx < L * kWChunk; idx += blockDim.x) {
            const int l = idx / kWChunk;
            const int w = w0 + (idx - l * kWChunk);
            win_s[idx] = w < W ? (unsigned char)win_b[(size_t)l * W + w]
                               : kNoWin;
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < kReadsPerWarp; ++i) {
            const int r = r0 + i;
            if (r >= R) break;  // warp-uniform
            const int8_t* cr = codes_b + (size_t)r * L;
            const float* dr = delta_b + (size_t)r * L;
            int s1[4] = {0, 0, 0, 0};
            int s0[4] = {0, 0, 0, 0};
            float fs[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // kHighest sums
            for (int l0 = 0; l0 < L; l0 += 32) {
                // lane t holds base l0+t as (code << 16) | d_int bits 0-15
                // (kHighest: code << 16, and the f32 delta in dv)
                const int l = l0 + lane;
                unsigned packed = kNoRead << 16;
                float dv = 0.0f;
                if (l < L) {
                    const int c = cr[l];
                    const unsigned cc = (c >= 0 && c < 4) ? (unsigned)c
                                                          : kNoRead;
                    if constexpr (kHighest) {
                        dv = dr[l];
                        packed = cc << 16;
                    } else {
                        const int d = (int)(dr[l] * 2048.0f);
                        packed = (cc << 16) | ((unsigned)d & 0xFFFFu);
                    }
                }
                const int n = min(32, L - l0);
                for (int t = 0; t < n; ++t) {
                    const unsigned p = __shfl_sync(0xffffffffu, packed, t);
                    const unsigned c = p >> 16;
                    const unsigned wv = *reinterpret_cast<const unsigned*>(
                        &win_s[(l0 + t) * kWChunk + 4 * lane]);
                    if constexpr (kHighest) {
                        const float d = __shfl_sync(0xffffffffu, dv, t);
#pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            if (((wv >> (8 * k)) & 255u) == c)
                                fs[k] = __fadd_rn(fs[k], d);
                        }
                    } else {
                        const int limb1 = (int)((p >> 8) & 255u);
                        const int limb0 = (int)(p & 255u);
#pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            const bool m = ((wv >> (8 * k)) & 255u) == c;
                            s1[k] += m ? limb1 : 0;
                            s0[k] += m ? limb0 : 0;
                        }
                    }
                }
            }
            const float ls = lnmis[(size_t)b * R + r];
            float bs = -INFINITY;
            int bw = INT_MAX;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int w = w0 + 4 * lane + k;
                if (w < W) {
                    float s;
                    if constexpr (kHighest) {
                        s = __fadd_rn(fs[k], ls);
                    } else {
                        const float comb = __fadd_rn(
                            __fmul_rn((float)s1[k], 256.0f), (float)s0[k]);
                        s = __fadd_rn(__fmul_rn(comb, kQuantInv), ls);
                    }
                    if (s > bs) {  // k ascending: strict keeps the first
                        bs = s;
                        bw = w;
                    }
                }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                const float os = __shfl_xor_sync(0xffffffffu, bs, o);
                const int ow = __shfl_xor_sync(0xffffffffu, bw, o);
                if (better(os, ow, bs, bw)) {
                    bs = os;
                    bw = ow;
                }
            }
            if (better(bs, bw, run_s[i], run_w[i])) {
                run_s[i] = bs;
                run_w[i] = bw;
            }
        }
    }

    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kReadsPerWarp; ++i) {
            const int r = r0 + i;
            if (r < R) {
                best[(size_t)b * R + r] = run_s[i];
                off[(size_t)b * R + r] = run_w[i];
            }
        }
    }
}

constexpr int kMaxLen = 232448 / kWChunk;  // L * kWChunk bytes of smem

template <bool kHighest>
int launch(const void* codes, const void* delta, const void* lnmis,
           const void* win, long long B, long long R, long long L,
           long long W, void* best, void* off, void* stream) {
    if (B < 1 || R < 1 || L < 1 || W < 1 || B > 65535 || R > INT_MAX ||
        L > kMaxLen || W > INT_MAX)
        return (int)cudaErrorInvalidValue;
    auto kernel = score_best_offsets_kernel<kHighest>;
    const size_t smem = (size_t)L * kWChunk;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((unsigned)((R + kReadsPerBlock - 1) / kReadsPerBlock),
                    (unsigned)B);
    kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
        (const int8_t*)codes, (const float*)delta, (const float*)lnmis,
        (const int8_t*)win, (int)R, (int)L, (int)W, (float*)best,
        (int32_t*)off);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest read length the launch takes: L * kWChunk bytes of shared memory.
int score_best_offsets_max_len() { return kMaxLen; }

// codes [B,R,L] int8, delta [B,R,L] f32, lnmis [B,R] f32, win [B,L,W] int8,
// all contiguous on the device; best [B,R] f32 and off [B,R] int32 out.
// Launches on `stream` and returns cudaGetLastError().
int score_best_offsets_launch(const void* codes, const void* delta,
                              const void* lnmis, const void* win,
                              long long B, long long R, long long L,
                              long long W, void* best, void* off,
                              void* stream) {
    return launch<false>(codes, delta, lnmis, win, B, R, L, W, best, off,
                         stream);
}

// The mode="highest" function: the same arguments, deltas any f32.
int score_best_offsets_highest_launch(const void* codes, const void* delta,
                                      const void* lnmis, const void* win,
                                      long long B, long long R, long long L,
                                      long long W, void* best, void* off,
                                      void* stream) {
    return launch<true>(codes, delta, lnmis, win, B, R, L, W, best, off,
                        stream);
}

}  // extern "C"
