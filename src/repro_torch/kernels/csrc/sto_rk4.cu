// Hand-written Hopper (sm_90a) kernels for the coupled-STO RK4 step.
//
// Layouts (kernels/ref.py): m (3, N, E) f32; W (N, N) f32 or bf16;
// params (NP = 10, E) f32 in PARAM_LAYOUT order; input drive h (N, E) per
// tick; masks (K, E) f32 0/1. N and E are padded by the caller
// (kernels/ops.py) to multiples of TILE_N and TILE_E (64, the padding
// multiple every kernel here takes).
//
// Every kernel computes the coupling product of W with a stage x-plane and
// then the elementwise LLG epilogue of `_field_planes` (the reference's
// kernels/sto_step.py:58-81) in its op order. A bf16 W rounds the x-plane
// operand to bf16 as well (round to nearest even) and accumulates in f32;
// all elementwise math and the state carry stay f32.
//
// rk4_chunk and rk4_fused (the reference's kernels/sto_step.py
// `_rk4_chunk_kernel` and `_rk4_fused_kernel`): rk4_coop_kernel
//   One COOPERATIVE launch runs every tick x step x stage of the call
//   (rk4_fused is the same body with K = 1, a constant h, no mask and no
//   states output). Every stage's coupling needs the WHOLE stage x-plane, so
//   one grid.sync() separates the stages; the epilogue writes the next
//   stage's x-plane into a double-buffered global plane (for a bf16 W as a
//   bf16 plane, so the operand is staged without converting on load), and
//   the RK4 accumulator and stage y/z planes, which only their owner reads. A
//   lane mask is a select at every step, so a frozen lane keeps its bits;
//   states[t] is written at each tick's end.
//
//   What bounds it at the serving shape (N = 2500 -> 2560, E = 256, K = 8,
//   hold_steps = 5: 160 stages of 2 N^2 E = 3.4 GFLOP, W 26 MB in f32):
//   - f32 W: FP32 operations on the CUDA cores (precision "highest": no TF32,
//     no 3xTF32), 67 TFLOP/s on an H100 SXM: 8.0 ms, 50 us a stage.
//   - bf16 W: the tensor rate gives 0.54 ms, out of reach: each stage moves
//     its operands (W once, the x-plane once per row tile) and ~43 MB of
//     epilogue planes (state, stage y, accumulator, drive) through L2 and
//     ends in a grid.sync(), 160 times. Those bytes set its pace.
//
//   The design, for those limits:
//   1. Work split. A stage's output is 2560 x 256, too small to give each of
//      132 SMs a register-blocked tile of its own, so the contraction is
//      split. An output tile is ROWS rows x 256 lanes (all lanes of the
//      serving shape, so each block reads its W rows once a stage); a
//      THREAD-BLOCK CLUSTER of C blocks shares one tile, rank r summing the
//      contraction slice of 64-deep units [r U / C, (r + 1) U / C), U = N / 64.
//      The partials meet through DISTRIBUTED SHARED MEMORY: rank r reduces
//      tile rows [ROWS r / C, ROWS (r + 1) / C) over ranks 0..C-1 in that
//      order and runs the epilogue for them. No atomics, so a rerun is
//      bit-identical; C and the slices depend on N (and the card), never on
//      E, so a lane's result does not depend on how many lanes share the
//      launch. The host (kernels/sto_step.py `coop_split`) picks C from the
//      co-resident clusters that cudaOccupancyMaxActiveClusters reports for
//      each C and passes C and the cluster count here; tiles past the
//      co-resident clusters are taken in rounds. On an H100 SXM only 39
//      clusters of 3 are co-resident (clusters stay inside a GPC), so at
//      N = 2560 the f32 kernel runs 15 clusters of 8 over 40 tiles in three
//      rounds and the bf16 kernel 20 clusters of 5 over 20 tiles in one.
//   2. f32 product on the CUDA cores, 64-row tiles: 8 x 8 outputs per thread
//      (a warp owns 8 rows x 256 lanes), read as float4: per 4-deep k step a
//      thread loads 8 float4 of W (one address per warp, a broadcast) and 8
//      float4 of x for 256 FMAs.
//   3. bf16 W on the tensor cores, 128-row tiles (half the x-plane traffic
//      of 64-row ones): mma.sync m16n8k16 (bf16 in, f32 accumulate), each
//      warp 64 rows x 64 lanes, A fragments by ldmatrix, B fragments of the
//      row-major bf16 x-plane by ldmatrix.trans, rows padded by 16 bytes so
//      both fragment reads are free of bank conflicts.
//   Both products are fed by a 3-stage ring of 16-byte cp.async copies that
//   bypass L1 (32-deep k tiles in f32, 64-deep in bf16), one __syncthreads()
//   per k tile. W is copied with an L2 evict_first policy and the x-plane
//   and every working plane with evict_last: W is read once a stage, while
//   the planes are read again at the next one, and keeping them resident is
//   what the epilogue's time depends on.
//   4. Each lane's 10 parameters are staged in shared memory once per launch
//      (once per tile when a block takes several lane tiles in rounds).
//   What stays open: the epilogue's plane traffic and the grid sync (~16 us
//   of a bf16 stage), the f32 FMA loop's share of the SM's rate, and
//   mma.sync instead of wgmma.
//   grid.sync() compiles and links without -rdc=true with the CUDA 12 nvcc
//   the build uses. The launch is cudaLaunchKernelEx with the cooperative and
//   cluster-dimension attributes.
//
// field_tiled and rk4_tiled_step (the reference's kernels/sto_step.py
// `_field_tiled_kernel`, which `rk4_tiled_step` drives): field_stage_kernel
//   One ordinary launch per RK4 stage computes k = f(m + c k_prev) with the
//   coupling taken against the whole stage x-plane. Its epilogue also
//   writes, when asked, the next stage's x-plane m^x + c_next k^x (in W's
//   type, so a bf16 operand is copied without converting), the running sum
//   k1 + 2 k2 + 2 k3 (in place) and, at stage 4, m + (dt/6)(sum + k4), in
//   the reference's left-to-right order: rk4_tiled_step is four launches and
//   no elementwise torch op, and field_tiled is the same kernel with those
//   outputs off. Stage 4 also writes, when asked, the new state's x-plane in
//   W's type (x_next: for a bf16 W the value it stores in m_out, rounded as
//   round_bf16_kernel rounds it), which is the next step's first operand: a
//   tiled hold window rounds once, where its first step's x-plane comes from
//   the caller (or from a lane mask's select) in f32 and round_bf16_kernel
//   rounds it.
//
//   What bounds one stage (N = 2500 -> 2560, E = 256, 2 N^2 E = 3.2 GFLOP):
//   - f32 W: FP32 operations on the CUDA cores, 48 us at 67 TFLOP/s;
//   - bf16 W: bytes, 41 MB (W 12.5 MB and the planes) = 12 us at 3.35 TB/s
//     (the bf16 tensor rate would take 3 us); at N = 10048 W alone is 202 MB
//     and streams from HBM every stage.
//
//   The design, for those limits: rk4_coop_kernel's split and products with
//   one output tile per cluster. A cluster of C blocks (C from N alone:
//   kernels/sto_step.py field_split) owns a 64 x 256 (f32) or 128 x 256
//   (bf16) tile, so W's rows are read once a stage for all 256 lanes; rank r
//   sums one contraction slice through the 3-deep cp.async ring (W
//   evict_first, planes evict_last; bf16 on mma.sync m16n8k16), and the
//   partials are reduced in rank order in distributed shared memory (no
//   atomics: reruns are bit-identical and a lane's bits do not depend on
//   E). Without a grid barrier, the tiles past the co-resident clusters run
//   in waves. One 8-warp block an SM: two would cap the registers at 128,
//   where the f32 tile spills. At N = 2560 f32 runs 40 tiles in clusters of
//   8 (3 waves of 15) and bf16 20 tiles in clusters of 5 (one wave).
//   What stays open: the FP32 loop's share of the SM's FMA rate (as in
//   rk4_coop_kernel), the last wave's idle SMs, and mma.sync's per-SM rate
//   for bf16 at N = 10048 (wgmma).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Phase timing (tools/sto_phase_times.py builds with -DSTO_PHASE_TIMES):
// thread 0 of each block reads %globaltimer at every PHASE_MARK(i) of
// rk4_coop_kernel and adds the time since the previous mark to
// g_phase[block][i]. Without the define the marks compile to nothing.
#ifdef STO_PHASE_TIMES
__device__ unsigned long long g_phase[1024][8];
__device__ __forceinline__ unsigned long long phase_clock() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define PHASE_START unsigned long long phase_mark = phase_clock();
#define PHASE_MARK(i)                                          \
    if (threadIdx.x == 0) {                                    \
        const unsigned long long now = phase_clock();          \
        g_phase[blockIdx.x][i] += now - phase_mark;            \
        phase_mark = now;                                      \
    }
#else
#define PHASE_START
#define PHASE_MARK(i)
#endif

// L2 eviction priorities of the cooperative kernel's copies and plane
// traffic; -DSTO_L2_EVICT_NORMAL sets them all to evict_normal, to compare.
#ifdef STO_L2_EVICT_NORMAL
#define STO_EVICT_FIRST "evict_normal"
#define STO_EVICT_LAST "evict_normal"
#else
#define STO_EVICT_FIRST "evict_first"
#define STO_EVICT_LAST "evict_last"
#endif

namespace {

constexpr int TILE_N = 64;   // padding multiple of N
constexpr int TILE_E = 64;   // padding multiple of E

// rk4_coop_kernel and field_stage_kernel
constexpr int SLICE = 64;                // contraction slice unit (= the padding multiple)
constexpr int CO_LANES = 256;            // lanes per output tile
constexpr int CO_RING = 3;               // cp.async ring depth
constexpr int MAX_CLUSTER = 8;           // portable cluster size
constexpr int PART_STRIDE = CO_LANES + 8;  // f32 partial tile row stride (bank spread)

// PARAM_LAYOUT rows (kernels/ref.py)
enum { P_PREF, P_ALPHA, P_HS, P_LAM, P_HAPPL, P_DEMAG, P_ACP, P_PX, P_PY, P_PZ, NP };

struct Params {
    float pref, alpha, hs, lam, happl, demag, acp, px, py, pz;
};

// Elementwise LLG slope, in the op order of the reference's _field_planes.
__device__ __forceinline__ void llg(float mx, float my, float mz, float hx, const Params& p,
                                    float& kx, float& ky, float& kz) {
    const float hz = p.happl + p.demag * mz;
    const float mdotp = p.px * mx + p.py * my + p.pz * mz;
    const float hs = p.hs / (1.0f + p.lam * mdotp);
    const float bx = hx + hs * (p.py * mz - p.pz * my);
    const float by = hs * (p.pz * mx - p.px * mz);
    const float bz = hz + hs * (p.px * my - p.py * mx);
    const float cx = my * bz - mz * by;
    const float cy = mz * bx - mx * bz;
    const float cz = mx * by - my * bx;
    const float dx = my * cz - mz * cy;
    const float dy = mz * cx - mx * cz;
    const float dz = mx * cy - my * cx;
    const float napref = -p.pref;
    kx = napref * (cx + p.alpha * dx);
    ky = napref * (cy + p.alpha * dy);
    kz = napref * (cz + p.alpha * dz);
}

// ---------------------------------------------------------------------------
// rk4_coop_kernel: copies, fragments, the two products
// ---------------------------------------------------------------------------

// L2 eviction priorities: W is read once a stage and goes first; the
// working planes, read again the next stage, stay (evict_last).
__device__ __forceinline__ uint64_t l2_evict_first() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::" STO_EVICT_FIRST ".b64 %0, 1.0;\n" : "=l"(p));
    return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::" STO_EVICT_LAST ".b64 %0, 1.0;\n" : "=l"(p));
    return p;
}

// 16-byte global -> shared copy that bypasses L1 (the x-plane is written by
// other blocks within the launch), with an L2 eviction policy; src_bytes = 0
// fills the 16 bytes with 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes,
                                           uint64_t policy) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes), "l"(policy)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const __nv_bfloat16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One contraction slice of one output tile: acc = W[r0:r0+ROWS, k] x[k, c0:c0+256]
// summed over k in [k_begin, k_end) in ascending k tiles, then stored into
// the block's f32 partial tile (row stride PART_STRIDE) in shared memory,
// which aliases the ring. Lanes past E (ncols < 256) and rows past N load
// as zeros. Traits per W type: the tile height, the k tile, the ring's
// layout, the tile product.
template <typename WT> struct Product;

// f32 W: CUDA-core FMAs on 64-row tiles. Warp w owns rows [8w, 8w + 8);
// lane l owns lanes [4l, 4l + 4) and [128 + 4l, 128 + 4l + 4).
template <> struct Product<float> {
    static constexpr int ROWS = 64;
    static constexpr int THREADS = 256;
    static constexpr int KT = 32;
    static constexpr int A_STRIDE = KT;        // floats; read by broadcast, no pad
    static constexpr int B_STRIDE = CO_LANES;  // floats; float4 rows, conflict-free
    static constexpr int A_BYTES = ROWS * A_STRIDE * 4;
    static constexpr int STAGE_BYTES = A_BYTES + KT * B_STRIDE * 4;
    using XT = float;

    __device__ static void load(unsigned char* stage, const float* __restrict__ w, const float* x,
                                int n, int e, int r0, int c0, int k0, uint64_t w_pol,
                                uint64_t x_pol) {
        float* as = reinterpret_cast<float*>(stage);
        float* bs = reinterpret_cast<float*>(stage + A_BYTES);
        const int tid = threadIdx.x;
#pragma unroll
        for (int q = 0; q < (ROWS * KT / 4) / THREADS; ++q) {
            const int c = tid + q * THREADS, row = c / (KT / 4), ch = c % (KT / 4);
            cp_async16(as + row * A_STRIDE + ch * 4, w + (long long)(r0 + row) * n + k0 + ch * 4, 16,
                       w_pol);
        }
#pragma unroll
        for (int q = 0; q < (KT * CO_LANES / 4) / THREADS; ++q) {
            const int c = tid + q * THREADS, kr = c / (CO_LANES / 4), ch = c % (CO_LANES / 4);
            const int col = c0 + ch * 4;
            const bool ok = col < e;
            cp_async16(bs + kr * B_STRIDE + ch * 4, ok ? x + (long long)(k0 + kr) * e + col : x,
                       ok ? 16 : 0, x_pol);
        }
    }

    struct Acc {
        float v[8][8];
    };

    __device__ static void zero(Acc& acc) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc.v[i][j] = 0.0f;
    }

    __device__ static void compute(const unsigned char* stage, Acc& acc) {
        const float* as = reinterpret_cast<const float*>(stage);
        const float* bs = reinterpret_cast<const float*>(stage + A_BYTES);
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const float* arow = as + warp * 8 * A_STRIDE;
#pragma unroll
        for (int kk = 0; kk < KT; kk += 4) {
            float4 a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                a[i] = *reinterpret_cast<const float4*>(arow + i * A_STRIDE + kk);
#pragma unroll
            for (int kq = 0; kq < 4; ++kq) {
                const float* brow = bs + (kk + kq) * B_STRIDE + lane * 4;
                const float4 b0 = *reinterpret_cast<const float4*>(brow);
                const float4 b1 = *reinterpret_cast<const float4*>(brow + CO_LANES / 2);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float av = lane_of(a[i], kq);
                    acc.v[i][0] += av * b0.x;
                    acc.v[i][1] += av * b0.y;
                    acc.v[i][2] += av * b0.z;
                    acc.v[i][3] += av * b0.w;
                    acc.v[i][4] += av * b1.x;
                    acc.v[i][5] += av * b1.y;
                    acc.v[i][6] += av * b1.z;
                    acc.v[i][7] += av * b1.w;
                }
            }
        }
    }

    __device__ static void store(const Acc& acc, float* part) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float* row = part + (warp * 8 + i) * PART_STRIDE + lane * 4;
            *reinterpret_cast<float4*>(row) =
                make_float4(acc.v[i][0], acc.v[i][1], acc.v[i][2], acc.v[i][3]);
            *reinterpret_cast<float4*>(row + CO_LANES / 2) =
                make_float4(acc.v[i][4], acc.v[i][5], acc.v[i][6], acc.v[i][7]);
        }
    }
};

// bf16 W: mma.sync m16n8k16 on the tensor cores, on 128-row tiles (half
// the x-plane traffic of 64-row tiles). Warp w owns rows [64 (w / 4), +64) x
// lanes [64 (w % 4), +64): 4 m16 x 8 n8 tiles, 32 MMAs per 8 ldmatrix.
template <> struct Product<__nv_bfloat16> {
    static constexpr int ROWS = 128;
    static constexpr int THREADS = 256;
    static constexpr int KT = 64;
    static constexpr int A_STRIDE = KT + 8;        // bf16; 144-byte rows
    static constexpr int B_STRIDE = CO_LANES + 8;  // bf16; 528-byte rows
    static constexpr int A_BYTES = ROWS * A_STRIDE * 2;
    static constexpr int STAGE_BYTES = A_BYTES + KT * B_STRIDE * 2;
    using XT = __nv_bfloat16;

    __device__ static void load(unsigned char* stage, const __nv_bfloat16* __restrict__ w,
                                const __nv_bfloat16* x, int n, int e, int r0, int c0, int k0,
                                uint64_t w_pol, uint64_t x_pol) {
        __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(stage);
        __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(stage + A_BYTES);
        const int tid = threadIdx.x;
#pragma unroll
        for (int q = 0; q < (ROWS * KT / 8) / THREADS; ++q) {
            const int c = tid + q * THREADS, row = c / (KT / 8), ch = c % (KT / 8);
            const bool ok = r0 + row < n;
            cp_async16(as + row * A_STRIDE + ch * 8,
                       ok ? w + (long long)(r0 + row) * n + k0 + ch * 8 : w, ok ? 16 : 0, w_pol);
        }
#pragma unroll
        for (int q = 0; q < (KT * CO_LANES / 8) / THREADS; ++q) {
            const int c = tid + q * THREADS, kr = c / (CO_LANES / 8), ch = c % (CO_LANES / 8);
            const int col = c0 + ch * 8;
            const bool ok = col < e;
            cp_async16(bs + kr * B_STRIDE + ch * 8, ok ? x + (long long)(k0 + kr) * e + col : x,
                       ok ? 16 : 0, x_pol);
        }
    }

    struct Acc {
        float v[4][8][4];  // [m16 tile][n8 tile][fragment]
    };

    __device__ static void zero(Acc& acc) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc.v[i][j][q] = 0.0f;
    }

    __device__ static void compute(const unsigned char* stage, Acc& acc) {
        const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(stage);
        const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(stage + A_BYTES);
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const __nv_bfloat16* arow =
            as + (64 * (warp >> 2) + (lane & 15)) * A_STRIDE + (lane >> 4) * 8;
        const __nv_bfloat16* brow = bs + ((lane & 7) + ((lane >> 3) & 1) * 8) * B_STRIDE +
                                    64 * (warp & 3) + (lane >> 4) * 8;
#pragma unroll
        for (int ks = 0; ks < KT / 16; ++ks) {
            uint32_t af[4][4], bf[4][4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(af[mi], arow + mi * 16 * A_STRIDE + ks * 16);
#pragma unroll
            for (int np = 0; np < 4; ++np)
                ldmatrix_x4_trans(bf[np], brow + ks * 16 * B_STRIDE + np * 16);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 8; ++ni)
                    mma_bf16(acc.v[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                             bf[ni >> 1][(ni & 1) * 2 + 1]);
        }
    }

    __device__ static void store(const Acc& acc, float* part) {
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const int grp = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                float* p = part + (64 * (warp >> 2) + mi * 16 + grp) * PART_STRIDE +
                           64 * (warp & 3) + ni * 8 + 2 * tq;
                *reinterpret_cast<float2*>(p) = make_float2(acc.v[mi][ni][0], acc.v[mi][ni][1]);
                *reinterpret_cast<float2*>(p + 8 * PART_STRIDE) =
                    make_float2(acc.v[mi][ni][2], acc.v[mi][ni][3]);
            }
    }
};

template <typename WT>
__host__ __device__ constexpr int ring_bytes() {
    return CO_RING * Product<WT>::STAGE_BYTES;
}
constexpr int PARAM_BYTES = NP * CO_LANES * 4;
template <typename WT>
__host__ __device__ constexpr int coop_smem_bytes() {
    return ring_bytes<WT>() + PARAM_BYTES;
}
static_assert(Product<float>::ROWS * PART_STRIDE * 4 <= CO_RING * Product<float>::STAGE_BYTES,
              "the partial tile must fit the f32 ring it aliases");
static_assert(Product<__nv_bfloat16>::ROWS * PART_STRIDE * 4 <=
                  CO_RING * Product<__nv_bfloat16>::STAGE_BYTES,
              "the partial tile must fit the bf16 ring it aliases");
static_assert(SLICE % Product<float>::KT == 0 && SLICE % Product<__nv_bfloat16>::KT == 0,
              "a slice unit is a whole number of k tiles");

// The ring over one contraction slice [k_begin, k_end) (a multiple of KT
// long), then the partial tile into shared memory. One __syncthreads() per
// k tile: after it, tile j has landed for every thread and every thread has
// finished tile j - 1, whose buffer the next copy reuses.
template <typename WT>
__device__ __forceinline__ void slice_product(unsigned char* ring, const WT* __restrict__ w,
                                              const typename Product<WT>::XT* x, int n, int e,
                                              int r0, int c0, int k_begin, int k_end, float* part) {
    using P = Product<WT>;
    const uint64_t w_pol = l2_evict_first(), x_pol = l2_evict_last();
    typename P::Acc acc;
    P::zero(acc);
    const int tiles = (k_end - k_begin) / P::KT;
#pragma unroll
    for (int s = 0; s < CO_RING - 1; ++s) {
        if (s < tiles)
            P::load(ring + s * P::STAGE_BYTES, w, x, n, e, r0, c0, k_begin + s * P::KT, w_pol, x_pol);
        cp_async_commit();
    }
    for (int j = 0; j < tiles; ++j) {
        cp_async_wait<CO_RING - 2>();
        __syncthreads();
        const int nj = j + CO_RING - 1;
        if (nj < tiles)
            P::load(ring + (nj % CO_RING) * P::STAGE_BYTES, w, x, n, e, r0, c0, k_begin + nj * P::KT,
                    w_pol, x_pol);
        cp_async_commit();
        P::compute(ring + (j % CO_RING) * P::STAGE_BYTES, acc);
    }
    cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring the partial tile aliases
    P::store(acc, part);
}

struct CoopArgs {
    const float* params;  // (NP, E)
    const void* w;        // (N, N) f32 or bf16
    const float* h;       // input drive, (N, E) per tick
    long long h_stride;   // per-tick stride of h; 0 = constant
    const float* mask;    // (K, E) or nullptr (all lanes live)
    float* m;             // (3, N, E) in/out
    float* states;        // (K, N, E) or nullptr
    float* scratch;       // 7 planes: x-plane (f32 x2, or f32 + bf16 x2), y/z, accumulator x3
    int n, e, k_ticks, steps;
    float c_half, c_full, c_sixth;
    int col_tiles;        // ceil(E / CO_LANES)
};


__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
// working-plane loads and stores through L2 with a policy (ldp4 also skips L1)
__device__ __forceinline__ float4 ldp4(const float* p, uint64_t pol) {
    float4 v;
    asm volatile("ld.global.cg.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p), "l"(pol));
    return v;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4], uint64_t pol) {
    asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "l"(pol)
                 : "memory");
}
__device__ __forceinline__ void st4_bf16(__nv_bfloat16* p, const float (&v)[4], uint64_t pol) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    asm volatile("st.global.L2::cache_hint.v2.b32 [%0], {%1, %2}, %3;\n" ::"l"(p),
                 "r"(*reinterpret_cast<uint32_t*>(&lo)), "r"(*reinterpret_cast<uint32_t*>(&hi)),
                 "l"(pol)
                 : "memory");
}
__device__ __forceinline__ void unpack(const float4& v, float (&o)[4]) {
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}

template <typename WT>
__global__ void __launch_bounds__(Product<WT>::THREADS, 1) rk4_coop_kernel(CoopArgs a) {
    using XT = typename Product<WT>::XT;
    constexpr bool BF16 = sizeof(WT) == 2;
    constexpr int ROWS = Product<WT>::ROWS;
    constexpr int THREADS = Product<WT>::THREADS;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* ring = smem;
    float* part = reinterpret_cast<float*>(smem);  // aliases the ring after each slice
    float* ps = reinterpret_cast<float*>(smem + ring_bytes<WT>());  // (NP, CO_LANES)
    cg::grid_group grid = cg::this_grid();
    cg::cluster_group cluster = cg::this_cluster();

    const int n = a.n, e = a.e, tid = threadIdx.x;
    const long long plane = (long long)n * e;
    const int csize = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int cid = blockIdx.x / csize, nclusters = gridDim.x / csize;
    const int units = n / SLICE;
    const int items = ((n + ROWS - 1) / ROWS) * a.col_tiles;
    // this rank's contraction slice and the tile rows it reduces (the same
    // formulas as kernels/sto_step.py coop_block_work)
    const int k_begin = SLICE * (rank * units / csize);
    const int k_end = SLICE * ((rank + 1) * units / csize);
    const int red_lo = rank * ROWS / csize, red_hi = (rank + 1) * ROWS / csize;

    const WT* w = static_cast<const WT*>(a.w);
    float* m = a.m;
    // Scratch planes 0-1: for an f32 W, the stage x-plane (the operand every
    // block reads), double-buffered; for a bf16 W, plane 0 is the stage x-plane
    // in f32, which only its owner reads (in place), and plane 1 holds the
    // double-buffered bf16 operand. Planes 2-6: stage y/z, RK4 accumulator.
    float* xbuf = a.scratch;
    __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(a.scratch + plane);
    float* yy = a.scratch + 2 * plane;    // stage y plane
    float* yz = a.scratch + 3 * plane;    // stage z plane
    float* kacc = a.scratch + 4 * plane;  // k1 + 2 k2 + 2 k3, three planes

    // the working planes stay in L2; the states output, read after the launch, goes first
    const uint64_t keep_pol = l2_evict_last(), out_pol = l2_evict_first();
    // first stage operand: the state's own x-plane
    for (long long i = 4 * ((long long)blockIdx.x * THREADS + tid); i < plane;
         i += 4LL * gridDim.x * THREADS) {
        float v[4];
        unpack(ld4(m + i), v);
        if (BF16) {
            st4_bf16(xb + i, v, keep_pol);
        } else {
            st4(xbuf + i, v, keep_pol);
        }
    }
    grid.sync();

    int buf = 0, staged_tile = -1;
    PHASE_START
    for (int t = 0; t < a.k_ticks; ++t) {
        const float* h_t = a.h + t * a.h_stride;
        for (int step = 0; step < a.steps; ++step) {
            const bool tick_end = step == a.steps - 1;
            for (int stage = 0; stage < 4; ++stage) {
                const float* x_cur = BF16 ? xbuf : xbuf + buf * plane;
                float* x_next = BF16 ? xbuf : xbuf + (buf ^ 1) * plane;
                __nv_bfloat16* xb_next = xb + (buf ^ 1) * plane;
                const XT* x_op;
                if constexpr (BF16) {
                    x_op = xb + buf * plane;
                } else {
                    x_op = x_cur;
                }
                for (int item = cid; item < items; item += nclusters) {
                    const int r0 = (item / a.col_tiles) * ROWS;
                    const int ct = item % a.col_tiles, c0 = ct * CO_LANES;
                    const int ncols = min(CO_LANES, e - c0);
                    // this rank's rows of the tile (rows past N are padding of the last tile)
                    const int rows = min(red_hi, n - r0) - red_lo;
                    PHASE_MARK(0)  // setup
                    slice_product<WT>(ring, w, x_op, n, e, r0, c0, k_begin, k_end, part);
                    PHASE_MARK(1)  // product
                    if (ct != staged_tile) {  // block-uniform; once per launch for one lane tile
                        for (int i = tid; i < NP * (CO_LANES / 4); i += THREADS) {
                            const int p = i / (CO_LANES / 4), c = 4 * (i % (CO_LANES / 4));
                            if (c < ncols)
                                *reinterpret_cast<float4*>(ps + p * CO_LANES + c) =
                                    ld4(a.params + (long long)p * e + c0 + c);
                        }
                        staged_tile = ct;
                    }
                    cluster.sync();  // every rank's partial tile (and the params) visible
                    PHASE_MARK(2)  // csync1

                    const int quads = ncols / 4;
                    for (int q = tid; q < rows * quads; q += THREADS) {
                        const int rr = red_lo + q / quads, cq = 4 * (q % quads);
                        const long long idx = (long long)(r0 + rr) * e + c0 + cq;
                        // partials summed in rank order: a fixed order, no atomics
                        float4 s4 = ld4(cluster.map_shared_rank(part, 0) + rr * PART_STRIDE + cq);
                        for (int r = 1; r < csize; ++r) {
                            const float4 v =
                                ld4(cluster.map_shared_rank(part, r) + rr * PART_STRIDE + cq);
                            s4.x += v.x, s4.y += v.y, s4.z += v.z, s4.w += v.w;
                        }
                        float acc[4], hv[4], mx[4], my[4], mz[4], yx[4], yyv[4], yzv[4];
                        float ax[4], ay[4], az[4];
                        unpack(s4, acc);
                        unpack(ldp4(h_t + idx, keep_pol), hv);
                        unpack(ldp4(m + idx, keep_pol), mx);
                        unpack(ldp4(m + plane + idx, keep_pol), my);
                        unpack(ldp4(m + 2 * plane + idx, keep_pol), mz);
                        if (stage > 0) {
                            unpack(ldp4(x_cur + idx, keep_pol), yx);
                            unpack(ldp4(yy + idx, keep_pol), yyv);
                            unpack(ldp4(yz + idx, keep_pol), yzv);
                            unpack(ldp4(kacc + idx, keep_pol), ax);
                            unpack(ldp4(kacc + plane + idx, keep_pol), ay);
                            unpack(ldp4(kacc + 2 * plane + idx, keep_pol), az);
                        } else {
#pragma unroll
                            for (int j = 0; j < 4; ++j) yx[j] = mx[j], yyv[j] = my[j], yzv[j] = mz[j];
                        }
                        float keep[4] = {1.0f, 1.0f, 1.0f, 1.0f};
                        if (stage == 3 && a.mask != nullptr)
                            unpack(ld4(a.mask + (long long)t * e + c0 + cq), keep);

                        float ox[4], oy[4], oz[4];
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            Params p;
                            const float* pc = ps + cq + j;
                            p.pref = pc[P_PREF * CO_LANES];
                            p.alpha = pc[P_ALPHA * CO_LANES];
                            p.hs = pc[P_HS * CO_LANES];
                            p.lam = pc[P_LAM * CO_LANES];
                            p.happl = pc[P_HAPPL * CO_LANES];
                            p.demag = pc[P_DEMAG * CO_LANES];
                            p.acp = pc[P_ACP * CO_LANES];
                            p.px = pc[P_PX * CO_LANES];
                            p.py = pc[P_PY * CO_LANES];
                            p.pz = pc[P_PZ * CO_LANES];
                            const float hx = p.acp * acc[j] + hv[j];
                            float kx, ky, kz;
                            llg(yx[j], yyv[j], yzv[j], hx, p, kx, ky, kz);
                            if (stage < 3) {
                                if (stage > 0) {
                                    ax[j] = ax[j] + 2.0f * kx;
                                    ay[j] = ay[j] + 2.0f * ky;
                                    az[j] = az[j] + 2.0f * kz;
                                } else {
                                    ax[j] = kx, ay[j] = ky, az[j] = kz;
                                }
                                const float c = stage == 2 ? a.c_full : a.c_half;
                                ox[j] = mx[j] + c * kx;
                                oy[j] = my[j] + c * ky;
                                oz[j] = mz[j] + c * kz;
                            } else {
                                // select, never a blend: a frozen lane keeps its bits
                                const bool live = keep[j] > 0.5f;
                                ox[j] = live ? mx[j] + a.c_sixth * (ax[j] + kx) : mx[j];
                                oy[j] = live ? my[j] + a.c_sixth * (ay[j] + ky) : my[j];
                                oz[j] = live ? mz[j] + a.c_sixth * (az[j] + kz) : mz[j];
                            }
                        }
                        if (stage < 3) {
                            st4(kacc + idx, ax, keep_pol);
                            st4(kacc + plane + idx, ay, keep_pol);
                            st4(kacc + 2 * plane + idx, az, keep_pol);
                            st4(yy + idx, oy, keep_pol);
                            st4(yz + idx, oz, keep_pol);
                        } else {
                            st4(m + idx, ox, keep_pol);
                            st4(m + plane + idx, oy, keep_pol);
                            st4(m + 2 * plane + idx, oz, keep_pol);
                            if (a.states != nullptr && tick_end)
                                st4(a.states + t * plane + idx, ox, out_pol);
                        }
                        if (BF16) {
                            st4_bf16(xb_next + idx, ox, keep_pol);
                            if (stage < 3) st4(x_next + idx, ox, keep_pol);  // the next stage's y_x
                        } else {
                            st4(x_next + idx, ox, keep_pol);
                        }
                    }
                    PHASE_MARK(3)  // epilogue
                    // every rank is done reading the partial tiles before the ring
                    // they alias is refilled; after a cluster's last tile of the
                    // stage the grid.sync() below orders that
                    if (item + nclusters < items) cluster.sync();
                    PHASE_MARK(4)  // csync2
                }
                PHASE_MARK(5)  // tail
                grid.sync();
                PHASE_MARK(6)  // grid
                buf ^= 1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// field_tiled and the tiled RK4 stage: field_stage_kernel
// ---------------------------------------------------------------------------

// One launch = one RK4 stage (or one field_tiled call). A null pointer turns
// its input or output off.
struct FieldArgs {
    const float* params;     // (NP, E)
    const void* w;           // (N, N) f32 or bf16
    const void* x;           // (N, E) coupling operand y^x: f32, or bf16 for a bf16 W
    const float* h;          // (N, E) input drive
    const float* m;          // (3, N, E) base state
    const float* kprev;      // (3, N, E): y = m + c kprev; null: y = m
    const float* acc_in;     // (3, N, E) RK4 sum so far; null: kprev (stage 2)
    float* k;                // (3, N, E) this stage's slope
    void* x_next;            // (N, E) the next launch's operand, in x's type: m^x + c_next k^x,
                             // or with m_out (stage 4) m_out's x-plane
    float* acc_out;          // (3, N, E) acc_in + 2 k (may alias acc_in)
    float* m_out;            // (3, N, E) m + c_out (acc_in + k)
    float c, c_next, c_out;
    int n, e, col_tiles;
};

// One cluster of C blocks per output tile (ROWS rows x CO_LANES lanes):
// rank r sums contraction slice [r U / C, (r + 1) U / C) of 64-deep units
// with the Product<WT> ring, the partials meet in distributed shared memory,
// and rank r reduces tile rows [ROWS r / C, ROWS (r + 1) / C) over ranks
// 0..C-1 in that order and runs the epilogue for them (the formulas of
// rk4_coop_kernel, with one tile per cluster: kernels/sto_step.py
// field_split). Tiles past the co-resident clusters run in later waves.
template <typename WT>
__global__ void __launch_bounds__(Product<WT>::THREADS, 1) field_stage_kernel(FieldArgs a) {
    using XT = typename Product<WT>::XT;
    constexpr int ROWS = Product<WT>::ROWS;
    constexpr int THREADS = Product<WT>::THREADS;
    extern __shared__ __align__(16) unsigned char smem[];
    float* part = reinterpret_cast<float*>(smem);  // aliases the ring after the slice
    cg::cluster_group cluster = cg::this_cluster();

    const int n = a.n, e = a.e, tid = threadIdx.x;
    const long long plane = (long long)n * e;
    const int csize = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int item = blockIdx.x / csize;
    const int units = n / SLICE;
    const int k_begin = SLICE * (rank * units / csize);
    const int k_end = SLICE * ((rank + 1) * units / csize);
    const int red_lo = rank * ROWS / csize, red_hi = (rank + 1) * ROWS / csize;
    const int r0 = (item / a.col_tiles) * ROWS;
    const int c0 = (item % a.col_tiles) * CO_LANES;
    const int ncols = min(CO_LANES, e - c0);
    const int rows = min(red_hi, n - r0) - red_lo;  // rows past N pad the last tile

    slice_product<WT>(smem, static_cast<const WT*>(a.w), static_cast<const XT*>(a.x), n, e, r0, c0,
                      k_begin, k_end, part);
    cluster.sync();  // every rank's partial tile visible

    // every plane written here is read by the next stage: keep it in L2
    const uint64_t keep_pol = l2_evict_last();
    const int quads = ncols / 4;
    for (int q = tid; q < rows * quads; q += THREADS) {
        const int rr = red_lo + q / quads, cq = 4 * (q % quads);
        const long long idx = (long long)(r0 + rr) * e + c0 + cq;
        // partials summed in rank order: a fixed order, no atomics
        float4 s4 = ld4(cluster.map_shared_rank(part, 0) + rr * PART_STRIDE + cq);
        for (int r = 1; r < csize; ++r) {
            const float4 v = ld4(cluster.map_shared_rank(part, r) + rr * PART_STRIDE + cq);
            s4.x += v.x, s4.y += v.y, s4.z += v.z, s4.w += v.w;
        }
        float dot[4], hv[4], mx[4], my[4], mz[4], yx[4], yy[4], yz[4], px[4], py[4], pz[4];
        unpack(s4, dot);
        unpack(ldp4(a.h + idx, keep_pol), hv);
        unpack(ldp4(a.m + idx, keep_pol), mx);
        unpack(ldp4(a.m + plane + idx, keep_pol), my);
        unpack(ldp4(a.m + 2 * plane + idx, keep_pol), mz);
        if (a.kprev != nullptr) {
            unpack(ldp4(a.kprev + idx, keep_pol), px);
            unpack(ldp4(a.kprev + plane + idx, keep_pol), py);
            unpack(ldp4(a.kprev + 2 * plane + idx, keep_pol), pz);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                yx[j] = mx[j] + a.c * px[j];
                yy[j] = my[j] + a.c * py[j];
                yz[j] = mz[j] + a.c * pz[j];
            }
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) yx[j] = mx[j], yy[j] = my[j], yz[j] = mz[j];
        }
        float pv[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p) unpack(ld4(a.params + (long long)p * e + c0 + cq), pv[p]);
        float kx[4], ky[4], kz[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const Params p = {pv[P_PREF][j], pv[P_ALPHA][j], pv[P_HS][j], pv[P_LAM][j],
                              pv[P_HAPPL][j], pv[P_DEMAG][j], pv[P_ACP][j], pv[P_PX][j],
                              pv[P_PY][j], pv[P_PZ][j]};
            const float hx = p.acp * dot[j] + hv[j];
            llg(yx[j], yy[j], yz[j], hx, p, kx[j], ky[j], kz[j]);
        }
        if (a.k != nullptr) {
            st4(a.k + idx, kx, keep_pol);
            st4(a.k + plane + idx, ky, keep_pol);
            st4(a.k + 2 * plane + idx, kz, keep_pol);
        }
        if (a.x_next != nullptr && a.m_out == nullptr) {
            float xn[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) xn[j] = mx[j] + a.c_next * kx[j];
            if constexpr (sizeof(XT) == 2) {
                st4_bf16(static_cast<__nv_bfloat16*>(a.x_next) + idx, xn, keep_pol);
            } else {
                st4(static_cast<float*>(a.x_next) + idx, xn, keep_pol);
            }
        }
        if (a.acc_out != nullptr || a.m_out != nullptr) {
            // the RK4 sum k1 + 2 k2 + 2 k3 + k4, left to right as the reference adds it
            float ax[4], ay[4], az[4];
            if (a.acc_in != nullptr) {
                unpack(ldp4(a.acc_in + idx, keep_pol), ax);
                unpack(ldp4(a.acc_in + plane + idx, keep_pol), ay);
                unpack(ldp4(a.acc_in + 2 * plane + idx, keep_pol), az);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) ax[j] = px[j], ay[j] = py[j], az[j] = pz[j];
            }
            if (a.acc_out != nullptr) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    ax[j] = ax[j] + 2.0f * kx[j];
                    ay[j] = ay[j] + 2.0f * ky[j];
                    az[j] = az[j] + 2.0f * kz[j];
                }
                st4(a.acc_out + idx, ax, keep_pol);
                st4(a.acc_out + plane + idx, ay, keep_pol);
                st4(a.acc_out + 2 * plane + idx, az, keep_pol);
            } else {
                float ox[4], oy[4], oz[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    ox[j] = mx[j] + a.c_out * (ax[j] + kx[j]);
                    oy[j] = my[j] + a.c_out * (ay[j] + ky[j]);
                    oz[j] = mz[j] + a.c_out * (az[j] + kz[j]);
                }
                st4(a.m_out + idx, ox, keep_pol);
                st4(a.m_out + plane + idx, oy, keep_pol);
                st4(a.m_out + 2 * plane + idx, oz, keep_pol);
                if (a.x_next != nullptr) {  // the next step's operand
                    if constexpr (sizeof(XT) == 2) {
                        st4_bf16(static_cast<__nv_bfloat16*>(a.x_next) + idx, ox, keep_pol);
                    } else {
                        st4(static_cast<float*>(a.x_next) + idx, ox, keep_pol);
                    }
                }
            }
        }
    }
    cluster.sync();  // no block exits while another rank may still read its partial tile
}

// y = x rounded to bf16 (round to nearest even), four values a thread per
// step: the bf16 coupling operand of a stage whose x-plane comes from the
// caller in f32 (field_tiled, and the first stage of a hold window's first
// rk4_tiled_step; its later steps take the plane stage 4 wrote).
__global__ void round_bf16_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                                  long long count) {
    const uint64_t pol = l2_evict_last();
    for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x); i < count;
         i += 4LL * gridDim.x * blockDim.x) {
        float v[4];
        unpack(ld4(x + i), v);
        st4_bf16(y + i, v, pol);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename WT>
cudaError_t coop_config(int cluster, int clusters, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                        cudaLaunchAttribute (&attrs)[2]) {
    cudaError_t err = cudaFuncSetAttribute(rk4_coop_kernel<WT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           coop_smem_bytes<WT>());
    if (err != cudaSuccess) return err;
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(cluster * clusters);
    cfg.blockDim = dim3(Product<WT>::THREADS);
    cfg.dynamicSmemBytes = coop_smem_bytes<WT>();
    cfg.stream = stream;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
    return cudaSuccess;
}

template <typename WT>
int max_clusters(int cluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attrs[2];
    cudaError_t err = coop_config<WT>(cluster, 1, nullptr, cfg, attrs);
    if (err != cudaSuccess) return -(int)err;
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, rk4_coop_kernel<WT>, &cfg);
    if (err != cudaSuccess) return -(int)err;
    return count;
}

template <typename WT>
cudaError_t launch_coop(const CoopArgs& args, int cluster, int clusters, cudaStream_t stream) {
    int dev = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attrs[2];
    err = coop_config<WT>(cluster, clusters, stream, cfg, attrs);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, rk4_coop_kernel<WT>, args);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename WT>
cudaError_t field_config(int cluster, int clusters, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                         cudaLaunchAttribute (&attrs)[1]) {
    cudaError_t err = cudaFuncSetAttribute(field_stage_kernel<WT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           ring_bytes<WT>());
    if (err != cudaSuccess) return err;
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(cluster * clusters);
    cfg.blockDim = dim3(Product<WT>::THREADS);
    cfg.dynamicSmemBytes = ring_bytes<WT>();
    cfg.stream = stream;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    return cudaSuccess;
}

template <typename WT>
int field_max_clusters(int cluster) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attrs[1];
    cudaError_t err = field_config<WT>(cluster, 1, nullptr, cfg, attrs);
    if (err != cudaSuccess) return -(int)err;
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, field_stage_kernel<WT>, &cfg);
    if (err != cudaSuccess) return -(int)err;
    return count;
}

template <typename WT>
cudaError_t launch_field(const FieldArgs& args, int cluster, cudaStream_t stream) {
    const int items = ((args.n + Product<WT>::ROWS - 1) / Product<WT>::ROWS) * args.col_tiles;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attrs[1];
    cudaError_t err = field_config<WT>(cluster, items, stream, cfg, attrs);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, field_stage_kernel<WT>, args);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

bool bad_shape(int n, int e) { return n <= 0 || e <= 0 || n % TILE_N != 0 || e % TILE_E != 0; }

}  // namespace

extern "C" {

int sto_tile_n() { return TILE_N; }
int sto_tile_e() { return TILE_E; }
// Rows of an rk4_coop_kernel output tile for each W type; the contraction
// slice unit.
int sto_coop_rows(int w_bf16) { return w_bf16 ? Product<__nv_bfloat16>::ROWS : Product<float>::ROWS; }
int sto_coop_slice() { return SLICE; }
int sto_coop_lanes() { return CO_LANES; }
int sto_coop_max_cluster() { return MAX_CLUSTER; }

// Dynamic shared memory of one rk4_coop_kernel block, bytes.
int sto_coop_smem(int w_bf16) {
    return w_bf16 ? coop_smem_bytes<__nv_bfloat16>() : coop_smem_bytes<float>();
}

// Co-resident clusters of `cluster` blocks of rk4_coop_kernel on the current
// device (cudaOccupancyMaxActiveClusters); a negative value is -cudaError_t.
int sto_coop_max_clusters(int w_bf16, int cluster) {
    if (cluster < 1 || cluster > MAX_CLUSTER) return -(int)cudaErrorInvalidValue;
    return w_bf16 ? max_clusters<__nv_bfloat16>(cluster) : max_clusters<float>(cluster);
}

// rk4_chunk (k_ticks = K, mask and states set) and rk4_fused (k_ticks = 1,
// h_stride = 0, mask and states null). `clusters` clusters of `cluster`
// blocks (kernels/sto_step.py coop_split); scratch holds 7 f32 (N, E)
// planes. Returns a cudaError_t.
int sto_rk4_coop(int w_bf16, const void* params, const void* w, const void* h, long long h_stride,
                 const void* mask, void* m, void* states, void* scratch, int n, int e, int k_ticks,
                 int steps, float c_half, float c_full, float c_sixth, int cluster, int clusters,
                 void* stream) {
    if (bad_shape(n, e) || k_ticks < 1 || steps < 1) return cudaErrorInvalidValue;
    if (cluster < 1 || cluster > MAX_CLUSTER || cluster > n / SLICE || clusters < 1)
        return cudaErrorInvalidValue;
    CoopArgs args;
    args.params = static_cast<const float*>(params);
    args.w = w;
    args.h = static_cast<const float*>(h);
    args.h_stride = h_stride;
    args.mask = static_cast<const float*>(mask);
    args.m = static_cast<float*>(m);
    args.states = static_cast<float*>(states);
    args.scratch = static_cast<float*>(scratch);
    args.n = n;
    args.e = e;
    args.k_ticks = k_ticks;
    args.steps = steps;
    args.c_half = c_half;
    args.c_full = c_full;
    args.c_sixth = c_sixth;
    args.col_tiles = (e + CO_LANES - 1) / CO_LANES;
    const auto st = static_cast<cudaStream_t>(stream);
    if (w_bf16) return launch_coop<__nv_bfloat16>(args, cluster, clusters, st);
    return launch_coop<float>(args, cluster, clusters, st);
}

#ifdef STO_PHASE_TIMES
// The phase counters (g_phase), read and cleared by tools/sto_phase_times.py.
int sto_phase_get(void* out) { return cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)); }
int sto_phase_zero() {
    static unsigned long long zero[1024][8];
    return cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
#endif

// Dynamic shared memory of one field_stage_kernel block, bytes.
int sto_field_smem(int w_bf16) {
    return w_bf16 ? ring_bytes<__nv_bfloat16>() : ring_bytes<float>();
}

// Co-resident clusters of `cluster` blocks of field_stage_kernel on the
// current device (cudaOccupancyMaxActiveClusters); a negative value is
// -cudaError_t.
int sto_field_max_clusters(int w_bf16, int cluster) {
    if (cluster < 1 || cluster > MAX_CLUSTER) return -(int)cudaErrorInvalidValue;
    return w_bf16 ? field_max_clusters<__nv_bfloat16>(cluster) : field_max_clusters<float>(cluster);
}

// One RK4 stage, or one field_tiled call (kprev null when c = 0; acc_in,
// x_next, acc_out, m_out null): k = f(m + c kprev) with the coupling taken
// against x, plus the outputs that are not null (FieldArgs). One cluster of
// `cluster` blocks per output tile (kernels/sto_step.py field_split).
// Returns a cudaError_t.
int sto_field_stage(int w_bf16, const void* params, const void* w, const void* x, const void* h,
                    const void* m, const void* kprev, const void* acc_in, void* k, void* x_next,
                    void* acc_out, void* m_out, float c, float c_next, float c_out, int n, int e,
                    int cluster, void* stream) {
    if (bad_shape(n, e) || cluster < 1 || cluster > MAX_CLUSTER || cluster > n / SLICE)
        return cudaErrorInvalidValue;
    if ((m_out != nullptr && acc_in == nullptr) ||
        (acc_out != nullptr && acc_in == nullptr && kprev == nullptr))
        return cudaErrorInvalidValue;
    FieldArgs args;
    args.params = static_cast<const float*>(params);
    args.w = w;
    args.x = x;
    args.h = static_cast<const float*>(h);
    args.m = static_cast<const float*>(m);
    args.kprev = static_cast<const float*>(kprev);
    args.acc_in = static_cast<const float*>(acc_in);
    args.k = static_cast<float*>(k);
    args.x_next = x_next;
    args.acc_out = static_cast<float*>(acc_out);
    args.m_out = static_cast<float*>(m_out);
    args.c = c;
    args.c_next = c_next;
    args.c_out = c_out;
    args.n = n;
    args.e = e;
    args.col_tiles = (e + CO_LANES - 1) / CO_LANES;
    const auto st = static_cast<cudaStream_t>(stream);
    if (w_bf16) return launch_field<__nv_bfloat16>(args, cluster, st);
    return launch_field<float>(args, cluster, st);
}

// y = bf16(x) over `count` values (a multiple of 4), in at most 8 blocks of
// 256 threads an SM. Returns a cudaError_t.
int sto_round_bf16(const void* x, void* y, long long count, void* stream) {
    if (count <= 0 || count % 4 != 0) return cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long want = (count / 4 + 255) / 256;
    const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
    round_bf16_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<__nv_bfloat16*>(y), count);
    return cudaGetLastError();
}

}  // extern "C"
