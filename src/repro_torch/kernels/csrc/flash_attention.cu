// Hand-written Hopper (sm_90a) flash attention, forward.
//
// Replaces the reference's Pallas TPU kernel `_flash_kernel` /
// `flash_attention_grouped` (src/repro/kernels/flash_attention.py). Same
// function: scores q.k^T * scale; keys masked to k <= q + (Sk - Sq) when
// causal and to k > q + (Sk - Sq) - window when window > 0 (the last q row
// aligns with the last k row); softmax over the unmasked keys; a row with no
// unmasked key gives zeros; sums in f32, output in q's dtype.
//
// Layouts are read through strides (in elements; the head dim is contiguous):
// q and o are (B, Sq, H, D) as the model makes them, or (B, H, Sq, D) for the
// user-layout entry; k and v are (B, Sk, KVH, D) or (B, KVH, Sk, D). GQA:
// head h uses kv head h / G, G = H / KVH.
//
// Design. On the TPU the KV axis was the innermost grid dimension and the
// running max, denominator and accumulator persisted in VMEM scratch across
// grid steps. Here blocks run in parallel and carry nothing between them, so
// one block owns BQ = 64 q rows of one (batch, kv head) pair and loops over
// the KV tiles itself, with the running statistics in registers. The block's
// rows are the (position, group head) pairs of that kv head flattened
// position-major (row = i * G + g), so all G heads that share a K/V tile
// read it from shared memory once, and the G = 4 heads of h2o-danube need no
// repeated K/V in device memory. Tile pruning becomes the loop bounds: the
// loop runs from the first to the last KV tile that the causal/window band of
// the block's positions touches, and only tiles that straddle an edge of the
// band (or the ragged end of Sk) apply the elementwise mask. Ragged Sq and Sk
// need no padding: rows past Sq * G and keys past Sk are zero-filled in
// shared memory, and out-of-range rows are not stored.
//
// flash_bf16: four warps, 16 q rows each. Both products run on the tensor
//   cores with mma.sync m16n8k16 (bf16 in, f32 accumulate): S = Q K^T with Q
//   fragments held in registers for the whole loop, K fragments read from
//   shared memory; the f32 S accumulator is rescaled, masked and
//   exponentiated (exp2 with log2(e) folded into the scale) in registers and
//   re-packed as the bf16 A operand of O += P V, whose V fragments come from
//   shared memory through ldmatrix.trans. Shared rows are padded by 8
//   elements so that both fragment reads are free of bank conflicts.
// flash_f32: the f32 variant (tests and the plain comparison) on the CUDA
//   cores: four threads per q row, each holding D/4 interleaved dims of q and
//   of the accumulator; a dot product is reduced across the four with two
//   shuffles; exp in full precision.
//
// Bound at the prefill shape of h2o-danube-1.8b (B = 1, H = 32, KVH = 8,
// D = 80, Sq = Sk = 4608, window 4096): the two products are 4 H D x
// (unmasked pairs) = 1.07e11 FLOP against 2.4 MB of q, k, v and o, so the
// kernel is bound by operations: 0.11 ms at the bf16 tensor-core rate
// (989 TFLOP/s, NVIDIA H100 SXM data sheet). This first kernel loads each KV
// tile synchronously (no cp.async/TMA pipeline) and uses mma.sync, which
// cannot reach the wgmma rate; a warp-specialised wgmma/TMA pipeline is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // q rows (position x group head) per block
constexpr int BK = 64;             // keys per tile, bf16 kernel
constexpr int BK_F32 = 32;         // keys per tile, f32 kernel
constexpr int THREADS_BF16 = 128;  // 4 warps x 16 rows
constexpr int THREADS_F32 = 256;   // 64 rows x 4 threads
constexpr int PAD = 8;             // bf16 elements of padding per shared row
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    int kvh, g, sq, sk;
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_ss, o_sh;
    int causal, window;
    float scale;
};

// Keys [k_begin, k_end) that any row of the block may attend to, and the
// global positions of its first and last rows.
struct Band {
    int k_begin, k_end, p_lo, p_hi;
};

__device__ __forceinline__ Band block_band(const Args& a, int r0) {
    const int nrows = a.sq * a.g;
    const int off = a.sk - a.sq;
    Band band;
    band.p_lo = r0 / a.g + off;
    band.p_hi = (min(r0 + BQ, nrows) - 1) / a.g + off;
    band.k_begin = a.window > 0 ? max(0, band.p_lo - a.window + 1) : 0;
    band.k_end = a.causal ? min(a.sk, band.p_hi + 1) : a.sk;
    return band;
}

// Whether the tile [kt, kt + bk) needs the elementwise mask for some row.
__device__ __forceinline__ bool tile_needs_mask(const Args& a, const Band& band, int kt, int bk) {
    return kt + bk > a.sk || (a.causal && kt + bk - 1 > band.p_lo) ||
           (a.window > 0 && kt <= band.p_hi - a.window);
}

__device__ __forceinline__ bool key_ok(const Args& a, int key, int p) {
    return key < a.sk && (!a.causal || key <= p) && (a.window <= 0 || key > p - a.window);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 values as a bf16 pair, the first in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS_BF16) flash_bf16(Args a) {
    static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16, at most 128");
    constexpr int LDS = D + PAD;     // shared row stride, elements
    constexpr int KSTEPS = D / 16;   // k-steps of Q K^T
    constexpr int NT_S = BK / 8;     // n-tiles of S
    constexpr int NT_O = D / 8;      // n-tiles of O
    constexpr int CHUNKS = D / 8;    // 16-byte chunks per row
    __shared__ __align__(16) __nv_bfloat16 ks[BK * LDS];
    __shared__ __align__(16) __nv_bfloat16 vs[BK * LDS];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = lane >> 2, tq = lane & 3;
    const int b = blockIdx.y / a.kvh, kh = blockIdx.y % a.kvh;
    const int nrows = a.sq * a.g;
    const int r0 = blockIdx.x * BQ;
    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + (long long)kh * a.g * a.q_sh;
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kh * a.k_sh;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kh * a.v_sh;
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + (long long)kh * a.g * a.o_sh;

    // The Q tile passes through ks into registers (A fragments).
    for (int c = tid; c < BQ * CHUNKS; c += THREADS_BF16) {
        const int r = c / CHUNKS, ch = c % CHUNKS, row = r0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < nrows) {
            val = *reinterpret_cast<const uint4*>(
                qb + (row / a.g) * a.q_ss + (row % a.g) * a.q_sh + ch * 8);
        }
        *reinterpret_cast<uint4*>(&ks[r * LDS + ch * 8]) = val;
    }
    __syncthreads();
    const int wr = warp * 16;
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
        qf[kk][0] = ld32(&ks[(wr + grp) * LDS + kk * 16 + 2 * tq]);
        qf[kk][1] = ld32(&ks[(wr + grp + 8) * LDS + kk * 16 + 2 * tq]);
        qf[kk][2] = ld32(&ks[(wr + grp) * LDS + kk * 16 + 8 + 2 * tq]);
        qf[kk][3] = ld32(&ks[(wr + grp + 8) * LDS + kk * 16 + 8 + 2 * tq]);
    }
    __syncthreads();

    const int off = a.sk - a.sq;
    const int row_a = r0 + wr + grp, row_b = row_a + 8;  // this thread's two rows
    const int pos_a = row_a / a.g + off, pos_b = row_b / a.g + off;
    const Band band = block_band(a, r0);
    const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)

    float o[NT_O][4];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    for (int kt = (band.k_begin / BK) * BK; kt < band.k_end; kt += BK) {
        for (int c = tid; c < BK * CHUNKS; c += THREADS_BF16) {
            const int r = c / CHUNKS, ch = c % CHUNKS, key = kt + r;
            uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
            if (key < a.sk) {
                kv = *reinterpret_cast<const uint4*>(kb + key * a.k_ss + ch * 8);
                vv = *reinterpret_cast<const uint4*>(vb + key * a.v_ss + ch * 8);
            }
            *reinterpret_cast<uint4*>(&ks[r * LDS + ch * 8]) = kv;
            *reinterpret_cast<uint4*>(&vs[r * LDS + ch * 8]) = vv;
        }
        __syncthreads();

        // S = Q K^T (f32)
        float s[NT_S][4];
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            const __nv_bfloat16* krow = &ks[(n * 8 + grp) * LDS + 2 * tq];
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
                mma_bf16(s[n], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
            }
        }

        const bool masked = tile_needs_mask(a, band, kt, BK);
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[n][e] * sl2;
                if (masked && !key_ok(a, kt + n * 8 + 2 * tq + (e & 1), e < 2 ? pos_a : pos_b)) {
                    x = -INFINITY;
                }
                s[n][e] = x;
            }
            mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
            mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
        // a row with no unmasked key so far keeps max -inf: exponentiate
        // against 0 instead, so its p and correction are exactly 0
        const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
        const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
        const float corr_a = exp2f(m_a - base_a), corr_b = exp2f(m_b - base_b);
        m_a = mx_a;
        m_b = mx_b;
        l_a *= corr_a;
        l_b *= corr_b;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
            o[n][0] *= corr_a;
            o[n][1] *= corr_a;
            o[n][2] *= corr_b;
            o[n][3] *= corr_b;
        }

        // P as the A operand of O += P V: the accumulator layout of two
        // adjacent n8 tiles is the A layout of one k16 step.
        uint32_t pf[BK / 16][4];
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
            const float p0 = exp2f(s[n][0] - base_a), p1 = exp2f(s[n][1] - base_a);
            const float p2 = exp2f(s[n][2] - base_b), p3 = exp2f(s[n][3] - base_b);
            l_a += p0 + p1;
            l_b += p2 + p3;
            pf[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
            pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const __nv_bfloat16* vrow =
                &vs[(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8];
#pragma unroll
            for (int np = 0; np < NT_O / 2; ++np) {
                uint32_t vf[4];
                ldmatrix_x4_trans(vf, vrow + np * 16);
                mma_bf16(o[2 * np], pf[kk], vf[0], vf[1]);
                mma_bf16(o[2 * np + 1], pf[kk], vf[2], vf[3]);
            }
        }
        __syncthreads();
    }

    l_a += __shfl_xor_sync(FULL, l_a, 1);
    l_a += __shfl_xor_sync(FULL, l_a, 2);
    l_b += __shfl_xor_sync(FULL, l_b, 1);
    l_b += __shfl_xor_sync(FULL, l_b, 2);
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;  // fully masked row -> 0
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    __nv_bfloat16* out_a = ob + (row_a / a.g) * a.o_ss + (row_a % a.g) * a.o_sh + 2 * tq;
    __nv_bfloat16* out_b = ob + (row_b / a.g) * a.o_ss + (row_b % a.g) * a.o_sh + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
        if (row_a < nrows) {
            *reinterpret_cast<uint32_t*>(out_a + n * 8) = pack_bf16(o[n][0] * inv_a, o[n][1] * inv_a);
        }
        if (row_b < nrows) {
            *reinterpret_cast<uint32_t*>(out_b + n * 8) = pack_bf16(o[n][2] * inv_b, o[n][3] * inv_b);
        }
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, four threads per row
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS_F32) flash_f32(Args a) {
    static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16, at most 128");
    constexpr int DPT = D / 4;  // dims per thread: d = t * 4 + tq
    __shared__ __align__(16) float ks[BK_F32 * D];
    __shared__ __align__(16) float vs[BK_F32 * D];

    const int tid = threadIdx.x, tq = tid & 3;
    const int b = blockIdx.y / a.kvh, kh = blockIdx.y % a.kvh;
    const int nrows = a.sq * a.g;
    const int r0 = blockIdx.x * BQ;
    const int row = r0 + (tid >> 2);
    const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
    const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;

    float q[DPT], acc[DPT];
    {
        const float* qrow = static_cast<const float*>(a.q) + b * a.q_sb +
                            (long long)kh * a.g * a.q_sh + (row / a.g) * a.q_ss +
                            (row % a.g) * a.q_sh;
#pragma unroll
        for (int t = 0; t < DPT; ++t) {
            q[t] = row < nrows ? qrow[t * 4 + tq] : 0.f;
            acc[t] = 0.f;
        }
    }
    const int pos = row / a.g + (a.sk - a.sq);
    const Band band = block_band(a, r0);
    float m = -INFINITY, l = 0.f;

    for (int kt = (band.k_begin / BK_F32) * BK_F32; kt < band.k_end; kt += BK_F32) {
        for (int c = tid; c < BK_F32 * (D / 4); c += THREADS_F32) {
            const int r = c / (D / 4), ch = c % (D / 4), key = kt + r;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (key < a.sk) {
                kv = *reinterpret_cast<const float4*>(kb + key * a.k_ss + ch * 4);
                vv = *reinterpret_cast<const float4*>(vb + key * a.v_ss + ch * 4);
            }
            *reinterpret_cast<float4*>(&ks[r * D + ch * 4]) = kv;
            *reinterpret_cast<float4*>(&vs[r * D + ch * 4]) = vv;
        }
        __syncthreads();

        const bool masked = tile_needs_mask(a, band, kt, BK_F32);
        float s[BK_F32];
        float mx = m;
#pragma unroll
        for (int j = 0; j < BK_F32; ++j) {
            float dot = 0.f;
#pragma unroll
            for (int t = 0; t < DPT; ++t) dot = fmaf(q[t], ks[j * D + t * 4 + tq], dot);
            dot += __shfl_xor_sync(FULL, dot, 1);  // the four partial sums, in
            dot += __shfl_xor_sync(FULL, dot, 2);  // the same order on all four
            float x = dot * a.scale;
            if (masked && !key_ok(a, kt + j, pos)) x = -INFINITY;
            s[j] = x;
            mx = fmaxf(mx, x);
        }
        const float base = mx == -INFINITY ? 0.f : mx;
        const float corr = expf(m - base);
        m = mx;
        l *= corr;
#pragma unroll
        for (int t = 0; t < DPT; ++t) acc[t] *= corr;
#pragma unroll
        for (int j = 0; j < BK_F32; ++j) {
            const float p = expf(s[j] - base);
            l += p;
#pragma unroll
            for (int t = 0; t < DPT; ++t) acc[t] = fmaf(p, vs[j * D + t * 4 + tq], acc[t]);
        }
        __syncthreads();
    }

    if (row < nrows) {
        const float inv = l > 0.f ? 1.f / l : 0.f;  // fully masked row -> 0
        float* orow = static_cast<float*>(a.o) + b * a.o_sb + (long long)kh * a.g * a.o_sh +
                      (row / a.g) * a.o_ss + (row % a.g) * a.o_sh;
#pragma unroll
        for (int t = 0; t < DPT; ++t) orow[t * 4 + tq] = acc[t] * inv;
    }
}

template <int D>
cudaError_t launch(const Args& a, int bf16, int batch, cudaStream_t st) {
    const dim3 grid((a.sq * a.g + BQ - 1) / BQ, batch * a.kvh);
    if (bf16) {
        flash_bf16<D><<<grid, THREADS_BF16, 0, st>>>(a);
    } else {
        flash_f32<D><<<grid, THREADS_F32, 0, st>>>(a);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/o strides (batch, seq, head) and k/v strides (batch, seq, kv head) are in
// elements; the head dim must be contiguous and every row 16-byte aligned
// (the wrapper checks). bf16 = 1 takes bf16 tensors, 0 takes f32. Returns a
// cudaError_t (0 on success); nothing is synchronised.
int flash_attention_fwd(int bf16, const void* q, const void* k, const void* v, void* o, int batch,
                        int heads, int kv_heads, int sq, int sk, int d, long long q_sb,
                        long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh, int causal, int window,
                        float scale, cudaStream_t stream) {
    if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 || sq < 1 || sk < 1 || window < 0 ||
        (long long)batch * kv_heads > 65535) {
        return cudaErrorInvalidValue;
    }
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    a.kvh = kv_heads;
    a.g = heads / kv_heads;
    a.sq = sq;
    a.sk = sk;
    a.q_sb = q_sb, a.q_ss = q_ss, a.q_sh = q_sh;
    a.k_sb = k_sb, a.k_ss = k_ss, a.k_sh = k_sh;
    a.v_sb = v_sb, a.v_ss = v_ss, a.v_sh = v_sh;
    a.o_sb = o_sb, a.o_ss = o_ss, a.o_sh = o_sh;
    a.causal = causal;
    a.window = window;
    a.scale = scale;
    switch (d) {
        case 32: return launch<32>(a, bf16, batch, stream);
        case 64: return launch<64>(a, bf16, batch, stream);
        case 80: return launch<80>(a, bf16, batch, stream);
        case 96: return launch<96>(a, bf16, batch, stream);
        case 128: return launch<128>(a, bf16, batch, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // extern "C"
