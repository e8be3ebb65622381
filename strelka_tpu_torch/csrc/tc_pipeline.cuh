// The tensor-core scorers' shared pipeline on Hopper (sm_90a): the
// operands' descriptor, the wgmma fences, the mbarrier ring and the
// window's staging by cp.async. Included by score_best_offsets_tc.cu (K1,
// KX-P and KX-H, u8 operands) and score_highest_tc.cu (K1-h and KX-K, bf16
// operands); each source compiles into a library of its own, so everything
// here has internal linkage.
//
// A CTA scores the reads of one locus-haplotype pair b against its window
// win [L,W] in steps: N tiles of kNTile offsets, each over the read length
// in chunks of kChunkBases bases, K fastest. Step it's raw window (bases
// l0.., offsets w0..; kChunkBases x kNTile bytes) comes in by 16-byte
// cp.async (plain loads where rows are not 16-byte aligned) into a ring of
// kStages raw slots, each completed on an mbarrier. KX-H's reads of one
// locus face H windows side by side in rows of H*W bytes (win [L,H*W]): its
// N tiles walk window 0's ceil(W/kNTile) tiles, then window 1's, and so on
// (tile_window<true>); a tile never holds offsets of two windows.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kWgThreads = 128;
constexpr int kNTile = 64;                      // offsets per N tile
constexpr int kChunkBases = 32;                 // bases per K chunk
constexpr int kStages = 3;
constexpr int kCore = 128;                      // 8 rows x 16 bytes
constexpr int kRawBytes = kChunkBases * kNTile; // a raw window chunk
constexpr int kBarBytes = 128;
constexpr int kSmemLimit = 232448;
constexpr int kMaxLen = 1816;   // the range of the SIMT kernels they replaced
constexpr float kQuantInv = 1.0f / 2048.0f;

// Operand sources of the u8 kernel (K1's codes and delta, or KX-P's packed
// words with lnmis beside them or folded into extra rows)
enum Source { kStandard, kPacked, kPackedFold };

struct Args {
    const int8_t* codes;    // [B,R,L]      (kStandard)
    const float* delta;     // [B,R,L]      (kStandard)
    const int32_t* packed;  // [B,Rp,L]     (kPacked, kPackedFold)
    const float* lnmis;     // [B,R]        (all but kPackedFold)
    const int8_t* win;      // [B,L,W]
    float* best;            // [B,R]        (best and offset apart)
    int32_t* off;           // [B,R]
    float* out;             // [B,R,2]      (interleaved: best, offset bits)
    int R, Rp, L, W;
    int Lp;                 // L rounded up to kChunkBases
    int nK, nT;             // K chunks, N tiles (H * nTw)
    int H, nTw;             // windows (KX-H; else 1), N tiles a window
    int resident;           // A words of the whole read length stay
    int win_vec;            // window rows 16-byte aligned
    int read_vec;           // reads 4 bases a load
};

// (s, w) beats (bs, bw): larger score, or the same score at a lower offset
__device__ __forceinline__ bool better(float s, int w, float bs, int bw) {
    return s > bs || (s == bs && w < bw);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, no swizzle: LBO = stride between the core
// matrices adjacent in K, SBO = stride between 8-row groups, in bytes
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
    return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_u32(bar))
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
        "r"(parity)
        : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}

// N tile nt's window: one of KX-H's H windows of nTw tiles each (kHap),
// else the one window 0
template <bool kHap>
__device__ __forceinline__ int tile_window(const Args& a, int nt) {
    return kHap ? nt / a.nTw : 0;
}

// N tile nt's first offset within its window
template <bool kHap>
__device__ __forceinline__ int tile_w0(const Args& a, int nt) {
    return (nt - tile_window<kHap>(a, nt) * a.nTw) * kNTile;
}

// the raw window of step `it` (bases l0.., offsets w0.. of window h) into
// `raw` ([kChunkBases][kNTile] bytes); every thread arrives on `bar` once.
// A window row is H*W bytes apart (kHap), window h starts at column h*W.
template <bool kHap = false>
__device__ void stage_window(const Args& a, int b, int it,
                             unsigned char* raw, uint64_t* bar) {
    const int nt = it / a.nK;
    const int l0 = (it - nt * a.nK) * kChunkBases;
    const int w0 = tile_w0<kHap>(a, nt);
    const int ldw = kHap ? a.H * a.W : a.W;   // row stride
    const int8_t* wb = a.win + (size_t)b * a.L * ldw +
                       (size_t)tile_window<kHap>(a, nt) * a.W;
    if (a.win_vec) {   // W % 16 == 0: a 16-byte piece is all in or all out
        for (int v = threadIdx.x; v < kChunkBases * (kNTile / 16);
             v += blockDim.x) {
            const int l = v / (kNTile / 16);
            const int col = 16 * (v % (kNTile / 16));
            if (l0 + l < a.L && w0 + col < a.W)
                cp_async16(raw + l * kNTile + col,
                           wb + (size_t)(l0 + l) * ldw + w0 + col);
        }
        cp_async_arrive(bar);
    } else {
        for (int e = threadIdx.x; e < kRawBytes; e += blockDim.x) {
            const int l = e / kNTile;
            const int col = e - l * kNTile;
            if (l0 + l < a.L && w0 + col < a.W)
                raw[e] = (unsigned char)wb[(size_t)(l0 + l) * ldw + w0 + col];
        }
        mbar_arrive(bar);
    }
}

// the ring's barriers: one arrival a thread completes a phase
__device__ __forceinline__ void init_ring(uint64_t* full) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) mbar_init(&full[s], blockDim.x);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
}

// window steps and N tiles of a launch against H windows of W offsets
// each; `a` holds R, L, W (and the operand pointers) on entry. With W % 16
// == 0 every window row and window start is 16-byte aligned too.
__host__ inline void plan_steps(Args& a, int H = 1) {
    a.Lp = (a.L + kChunkBases - 1) / kChunkBases * kChunkBases;
    a.nK = a.Lp / kChunkBases;
    a.H = H;
    a.nTw = (a.W + kNTile - 1) / kNTile;
    a.nT = H * a.nTw;
    a.win_vec = a.W % 16 == 0 && (uintptr_t)a.win % 16 == 0;
}

}  // namespace
