// Read x haplotype best-offset scoring in f32, mode="highest", on Hopper's
// bf16 tensor cores (sm_90a): K1-h.
//
// Replaces the TPU kernel strelka_tpu/ops/pallas_readlik.py:_score_kernel,
// its mode="highest" branch (:170-177, pallas_call :240), whose oracle is
// reference_best_offsets (:303-315). For each locus-haplotype pair b and
// read r, over window offsets w,
//
//   s[r,w] = sum_l delta[r,l] * [codes[r,l] == win[l,w]] + lnmis[r]
//
// with delta any f32 and a code >= 4 matching nothing; it returns max_w s
// and the first (lowest-w) argmax. On the TPU this is a one-hot matmul at
// Precision.HIGHEST: six bf16 passes. One factor is a {0,1} one-hot, which
// bf16 holds exactly, so three of those passes are zero; this kernel runs
// the other three:
//
// - Split: hi = bf16_rn(d), mid = bf16_rn(d - hi), lo = bf16_rn(d - hi -
//   mid). Each difference is exact in f32, and hi + mid + lo == d exactly
//   (3 x 8 significand bits cover f32's 24).
// - Product: wgmma.mma_async m64n64k16 .f32.bf16.bf16 over k = (base,
//   code): the three A slabs A_j[r, (l,c)] = piece_j(delta[r,l]) *
//   [codes[r,l] == c] share one K-major one-hot Bw[(l,c), w] = [win[l,w] ==
//   c] and accumulate into one f32 accumulator. Every product is exact; the
//   only rounding is the tensor cores' f32 accumulation and the + lnmis.
//   With the quantized LUT's deltas (multiples of 2^-11, partial sums below
//   2^13) every partial sum is exact in any order, so the result equals the
//   reference bit for bit. With unquantized deltas the sums round in the
//   tensor cores' own order (one rounding per k16 block and piece, 3L/4 a
//   score), held to the f32 bound stated in chip_smoke.py.
//
// Bound on the H100: operations. It moves B*(5*R*L + L*W + 12*R) bytes
// (0.0153 ms at 512,128,128,128 at 3.35 TB/s); the least time over the
// engines that compute it at f32 accuracy is the larger, the tensor cores'
// 3 * 2*B*R*4L*W bf16 operations at 989 TFLOP/s (0.0261 ms; the CUDA
// cores' 2*B*R*L*W f32 operations at 67 TFLOP/s take 0.0321 ms).
//
// Design, on K1's pipeline (score_best_offsets_tc.cu, tc_pipeline.cuh):
// - A from registers, never in shared memory. Three bf16 slabs are 6x K1's
//   bytes a (read, k); a 64-read A at L=160 would be ~245 KB, over the 227
//   KB a block may have. wgmma takes a 16-bit A as registers: each thread
//   loads its two reads' codes and deltas (4 bases a 16-byte load) once a
//   K chunk, splits each delta and builds the fragments of each k16 step
//   itself, so shared memory holds only the Bw ring and the raw window:
//   3 x 16 KB + 3 x 2 KB + 128 B = 55,424 bytes, whatever L.
// - k order: in k16 step q of a 32-base chunk, thread t (of the 4 that
//   share a row) holds base 16*(q/4) + 4t + q%4 with codes 0,1 in one
//   register and 2,3 in another, so its 4 bases of a 16-base group come
//   from one float4 and one 32-bit word of codes; Bw is expanded in the
//   same order.
// - One CTA per (pair, up to 2 warpgroups of 64 reads, one read a row);
//   the steps (N tiles of 64 offsets x K chunks of 32 bases) and the
//   window's cp.async ring are K1's. The fragments of a k16 step live in
//   one of two register sets: a step waits for the wgmma group two steps
//   back, so the tensor cores run one step while the next is built.
// - First max: strict > over a thread's ascending offsets across N tiles,
//   then better() over the 4 lanes that share a read.
#include <cuda_bf16.h>

#include "tc_pipeline.cuh"

namespace {

constexpr int kHReadsPerWg = 64;                // m64: one read a row
constexpr int kHMaxWg = 2;
constexpr int kK16 = 4 * kChunkBases / 16;      // k16 steps a chunk
constexpr int kHRowBytes = 2 * 4 * kChunkBases; // one offset's chunk of K
constexpr int kHSbo = 8 * kHRowBytes;           // 8-offset group stride
constexpr int kHOpBytes = kNTile * kHRowBytes;  // a Bw slot
constexpr unsigned kOne = 0x3F80u;              // bf16 1.0

// d (+)= A (64x16 bf16, registers) * B (16x64 bf16, K-major), f32
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const unsigned (&a)[4],
                                           uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

// keep the compiler from moving accumulator or fragment accesses across a
// wgmma fence or wait
__device__ __forceinline__ void fence_f32(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_frag(unsigned (&f)[3][4]) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[j][i])::"memory");
}

// bf16 bits of hi, mid, lo: each the bf16 rounding of what the ones before
// leave of d, so hi + mid + lo == d
__device__ __forceinline__ void split3(float d, unsigned (&p)[3]) {
    float rest = d;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const __nv_bfloat16 h = __float2bfloat16_rn(rest);
        p[j] = __bfloat16_as_ushort(h);
        rest = __fsub_rn(rest, __bfloat162float(h));
    }
}

// bf16 value v at code c's half of the register of codes 0,1 or 2,3 (any
// other code, negative ones included, matches neither)
__device__ __forceinline__ unsigned pick01(unsigned c, unsigned v) {
    return c < 2u ? v << (16u * c) : 0u;
}

__device__ __forceinline__ unsigned pick23(unsigned c, unsigned v) {
    return c - 2u < 2u ? v << (16u * (c - 2u)) : 0u;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the chunk at l0 of this thread's reads ra (row g) and ra + 8 (row g+8):
// deltas and codes of bases l0 + 16*grp + 4*t4 + 0..3; past R or L code 4
__device__ __forceinline__ void load_reads(const Args& a, int b,
                                           long long ra, int l0, int t4,
                                           float4 (&dv)[2][2],
                                           unsigned (&cv)[2][2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long r = ra + 8 * i;
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
            const int l = l0 + 16 * grp + 4 * t4;
            float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            unsigned c = 0x04040404u;
            if (r < a.R && l < a.L) {
                const size_t o = ((size_t)b * a.R + r) * a.L + l;
                if (a.read_vec) {   // L % 4 == 0: the quad lies inside the read
                    c = *reinterpret_cast<const unsigned*>(a.codes + o);
                    d = *reinterpret_cast<const float4*>(a.delta + o);
                } else {
                    float e[4];
                    c = 0u;
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const bool in = l + k < a.L;
                        const unsigned x =
                            in ? (unsigned)(unsigned char)a.codes[o + k] : 4u;
                        c |= x << (8 * k);
                        e[k] = in ? a.delta[o + k] : 0.0f;
                    }
                    d = make_float4(e[0], e[1], e[2], e[3]);
                }
            }
            dv[i][grp] = d;
            cv[i][grp] = c;
        }
    }
}

// step `it`'s K-major one-hot Bw tile [64 offsets][128 bf16 of K] from its
// raw window, in the k order of the A fragments; bases past L and offsets
// past W are zero rows
__device__ void expand_wh(const Args& a, int it, const unsigned char* raw,
                          unsigned char* bw) {
    const int nt = it / a.nK;
    const int l0 = (it - nt * a.nK) * kChunkBases;
    const int w0 = nt * kNTile;
    for (int e = threadIdx.x; e < kNTile * kK16; e += blockDim.x) {
        const int w = e % kNTile;   // 8 offsets fastest: 128 contiguous bytes
        const int q = e / kNTile;   // k16 step
        const int base = 16 * (q >> 2) + (q & 3);
        const bool in_w = w0 + w < a.W;
        unsigned v01[4], v23[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int l = base + 4 * t;
            const unsigned x = raw[l * kNTile + w];
            const bool ok = in_w && l0 + l < a.L;
            v01[t] = ok ? pick01(x, kOne) : 0u;
            v23[t] = ok ? pick23(x, kOne) : 0u;
        }
        unsigned char* p = bw + (w >> 3) * kHSbo + 2 * q * kCore + 16 * (w & 7);
        *reinterpret_cast<uint4*>(p) = make_uint4(v01[0], v01[1], v01[2], v01[3]);
        *reinterpret_cast<uint4*>(p + kCore) =
            make_uint4(v23[0], v23[1], v23[2], v23[3]);
    }
}

__global__ void __launch_bounds__(kHMaxWg* kWgThreads)
    score_highest_tc_kernel(const Args a) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [kStages]
    unsigned char* bw = smem + kBarBytes;                 // [kStages][kHOpBytes]
    unsigned char* raw = bw + kStages * kHOpBytes;        // [kStages][kRawBytes]
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int b = blockIdx.y;
    // rows g and g+8 of warp (tid/32)%4 of warpgroup tid/128
    const long long ra =
        (long long)blockIdx.x * (blockDim.x / kWgThreads) * kHReadsPerWg +
        (tid / kWgThreads) * kHReadsPerWg + ((tid >> 5) & 3) * 16 + g;
    const int steps = a.nT * a.nK;   // N tiles x K chunks, K fastest

    init_ring(full);
    for (int s = 0; s < 2 && s < steps; ++s)
        stage_window(a, b, s, raw + s * kRawBytes, &full[s]);
    float4 dv[2][2];
    unsigned cv[2][2];
    load_reads(a, b, ra, 0, t4, dv, cv);
    mbar_wait(&full[0], 0);
    expand_wh(a, 0, raw, bw);
    fence_proxy_async();
    __syncthreads();

    float ls[2], run_s[2];
    int run_w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const long long r = ra + 8 * i;
        ls[i] = r < a.R ? a.lnmis[(size_t)b * a.R + r] : 0.0f;
        run_s[i] = -INFINITY;
        run_w[i] = INT_MAX;
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    unsigned frag[2][3][4];   // two sets of (hi, mid, lo) x 4 registers

    for (int it = 0; it < steps; ++it) {
        const int nt = it / a.nK;
        const int kc = it - nt * a.nK;
        const unsigned char* b_op = bw + (it % kStages) * kHOpBytes;
#pragma unroll
        for (int q = 0; q < kK16; ++q) {
            unsigned (&f)[3][4] = frag[q & 1];
            wgmma_wait<1>();   // the group two k16 steps back read f
            fence_frag(f);
            const int grp = q >> 2;
            const int sp = q & 3;
            unsigned pa[3], pb[3];
            split3(lane_of(dv[0][grp], sp), pa);
            split3(lane_of(dv[1][grp], sp), pb);
            const unsigned ca = (cv[0][grp] >> (8 * sp)) & 255u;
            const unsigned cb = (cv[1][grp] >> (8 * sp)) & 255u;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                f[j][0] = pick01(ca, pa[j]);
                f[j][1] = pick01(cb, pb[j]);
                f[j][2] = pick23(ca, pa[j]);
                f[j][3] = pick23(cb, pb[j]);
            }
            fence_frag(f);
            fence_f32(acc);
            wgmma_fence();
            const uint64_t db = desc(b_op + 2 * q * kCore, kCore, kHSbo);
#pragma unroll
            for (int j = 0; j < 3; ++j)
                wgmma_bf16(acc, f[j], db, kc > 0 || q > 0 || j > 0);
            wgmma_commit();
        }
        // the same reads' next chunk, then the window two steps ahead
        if (it + 1 < steps)
            load_reads(a, b, ra, ((it + 1) % a.nK) * kChunkBases, t4, dv, cv);
        if (it + 2 < steps) {
            const int ahead = (it + 2) % kStages;
            stage_window(a, b, it + 2, raw + ahead * kRawBytes, &full[ahead]);
        }
        // step it+1's Bw, into the slot step it-2 read
        if (it + 1 < steps) {
            const int nxt = (it + 1) % kStages;
            mbar_wait(&full[nxt], ((it + 1) / kStages) & 1);
            expand_wh(a, it + 1, raw + nxt * kRawBytes, bw + nxt * kHOpBytes);
            fence_proxy_async();
        }
        if (kc == a.nK - 1) {
            // the tile's scores: offset 8j + 2*t4 + e of row g in
            // acc[4j+e], of row g+8 in acc[4j+2+e]
            wgmma_wait<0>();
            fence_f32(acc);
#pragma unroll
            for (int j = 0; j < kNTile / 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int w = nt * kNTile + 8 * j + 2 * t4 + e;   // ascending
                    if (w < a.W) {
#pragma unroll
                        for (int i = 0; i < 2; ++i) {
                            const float s =
                                __fadd_rn(acc[4 * j + 2 * i + e], ls[i]);
                            if (s > run_s[i]) {   // strict keeps the first
                                run_s[i] = s;
                                run_w[i] = w;
                            }
                        }
                    }
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {   // the 4 lanes of a read
            const float os = __shfl_xor_sync(0xffffffffu, run_s[i], o);
            const int ow = __shfl_xor_sync(0xffffffffu, run_w[i], o);
            if (better(os, ow, run_s[i], run_w[i])) {
                run_s[i] = os;
                run_w[i] = ow;
            }
        }
        const long long r = ra + 8 * i;
        if (t4 == 0 && r < a.R) {
            a.best[(size_t)b * a.R + r] = run_s[i];
            a.off[(size_t)b * a.R + r] = run_w[i];
        }
    }
}

}  // namespace

extern "C" {

// Largest read length the launch takes (that of the SIMT kernel it
// replaced; nothing in shared memory grows with L).
int score_highest_tc_max_len() { return kMaxLen; }

// codes [B,R,L] int8, delta [B,R,L] f32 (any values), lnmis [B,R] f32,
// win [B,L,W] int8, all contiguous on the device; best [B,R] f32 and off
// [B,R] int32 out. Launches on `stream` and returns cudaGetLastError().
int score_highest_tc_launch(const void* codes, const void* delta,
                            const void* lnmis, const void* win, long long B,
                            long long R, long long L, long long W,
                            void* best, void* off, void* stream) {
    if (B < 1 || R < 1 || L < 1 || W < 1 || B > 65535 || R > INT_MAX ||
        L > kMaxLen || W > INT_MAX)
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
    plan_steps(a);
    a.read_vec = L % 4 == 0 && (uintptr_t)codes % 4 == 0 &&
                 (uintptr_t)delta % 16 == 0;
    const long long want = (R + kHReadsPerWg - 1) / kHReadsPerWg;
    const int n_wg = (int)(want < kHMaxWg ? want : kHMaxWg);
    const size_t smem = kBarBytes + (size_t)kStages * (kHOpBytes + kRawBytes);
    const cudaError_t e = cudaFuncSetAttribute(
        score_highest_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long per_cta = (long long)n_wg * kHReadsPerWg;
    const dim3 grid((unsigned)((R + per_cta - 1) / per_cta), (unsigned)B);
    score_highest_tc_kernel<<<grid, n_wg * kWgThreads, smem,
                              (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
