// Hand-written Hopper (sm_90a) kernels for the coupled-STO RK4 step.
//
// Layouts (kernels/ref.py): m (3, N, E) f32; W (N, N) f32 or bf16;
// params (NP = 10, E) f32 in PARAM_LAYOUT order; input drive h (N, E) per
// tick; masks (K, E) f32 0/1. N and E are padded by the caller
// (kernels/ops.py) to multiples of TILE_N and TILE_E.
//
// All three kernels share one tile routine: a shared-memory-tiled FP32
// product of a W row block (TILE_N x N) with the stage x-plane (N x TILE_E),
// followed by the elementwise LLG epilogue of `_field_planes`
// (the reference's kernels/sto_step.py:58-81). A bf16 W rounds the x-plane
// operand to bf16 as well (round to nearest even) and accumulates in f32;
// all elementwise math and the state carry stay f32.
//
// rk4_chunk and rk4_fused (the reference's kernels/sto_step.py
// `_rk4_chunk_kernel` and `_rk4_fused_kernel`)
//   One COOPERATIVE launch runs every tick x step x stage of the call. On the
//   TPU one program per ensemble tile walked all N rows in order; here blocks
//   run in parallel and every stage's coupling needs the WHOLE stage x-plane.
//   So blocks own (TILE_N x TILE_E) tiles, assigned by a grid-stride loop over
//   a grid no larger than the co-resident limit
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs). Each stage's
//   epilogue writes the NEXT stage's x-plane into a double-buffered global
//   scratch plane, and one grid.sync() per stage separates those writes from
//   the reads of the following stage (the double buffer means the sync also
//   orders the next overwrite after this stage's reads). The tile owns its
//   elements' RK4 accumulator and stage y/z planes (scratch read and written
//   only by the owning thread), applies the lane mask as a select at every
//   step (a lane frozen for a tick never changes during it, which is
//   bit-identical to the reference's select at the tick's end) and writes
//   states[t] at each tick's end. rk4_fused is the same body with K = 1, a
//   constant h, no mask and no states output.
//   grid.sync() compiles and links without -rdc=true with the CUDA 12 nvcc
//   the build uses: cooperative groups have not needed relocatable device
//   code since CUDA 11.
//   Bound at the serving shape (N=2500, E=256, K=8, hold_steps=5): one chunk
//   is 2 N^2 E x 4 stages x hold x K = 5.1e11 FLOP against ~73 MB of
//   inputs and outputs (W is 25 MB and fits the 50 MB L2), so it is
//   compute-bound on the FP32 (non-tensor) rate, 67 TFLOP/s on an H100 SXM
//   (NVIDIA H100 data sheet): 7.6 ms. TF32 and tensor cores are excluded by
//   precision="highest". The design keeps W and the scratch planes in L2 for
//   the whole chunk (one launch, no host round trip per stage) and spends its
//   time in the FP32 FMA loop; wgmma/TMA tiling is later work.
//
// field_tiled (the reference's kernels/sto_step.py `_field_tiled_kernel`)
//   One ordinary launch per RK4 stage over a (E / TILE_E, N / TILE_N) grid:
//   k = f(m + c k_prev) with the coupling taken against the caller's full
//   stage x-plane. The RK4 combine stays in torch (the reference leaves it to
//   XLA). Same FP32 bound per stage: 2 N^2 E FLOP, 0.48 ms at N=2500, E=256.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_N = 64;   // oscillators (rows of W) per tile
constexpr int TILE_E = 64;   // ensemble lanes per tile
constexpr int TILE_K = 32;   // contraction depth per shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int SUB = 16;      // thread grid side; outputs are strided by SUB

// PARAM_LAYOUT rows (kernels/ref.py)
enum { P_PREF, P_ALPHA, P_HS, P_LAM, P_HAPPL, P_DEMAG, P_ACP, P_PX, P_PY, P_PZ };

struct Params {
    float pref, alpha, hs, lam, happl, demag, acp, px, py, pz;
};

__device__ __forceinline__ Params load_params(const float* __restrict__ p, int e, int col) {
    Params q;
    q.pref = p[P_PREF * e + col];
    q.alpha = p[P_ALPHA * e + col];
    q.hs = p[P_HS * e + col];
    q.lam = p[P_LAM * e + col];
    q.happl = p[P_HAPPL * e + col];
    q.demag = p[P_DEMAG * e + col];
    q.acp = p[P_ACP * e + col];
    q.px = p[P_PX * e + col];
    q.py = p[P_PY * e + col];
    q.pz = p[P_PZ * e + col];
    return q;
}

template <typename WT> __device__ __forceinline__ float w_value(WT v);
template <> __device__ __forceinline__ float w_value<float>(float v) { return v; }
template <> __device__ __forceinline__ float w_value<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// The stage x-plane as the coupling operand: unchanged for an f32 W,
// rounded to bf16 for a bf16 W (the reference's mx.astype(w.dtype)).
template <typename WT> __device__ __forceinline__ float x_operand(float v);
template <> __device__ __forceinline__ float x_operand<float>(float v) { return v; }
template <> __device__ __forceinline__ float x_operand<__nv_bfloat16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

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

struct Smem {
    float a[TILE_N][TILE_K + 1];  // W row block; +1 keeps the two rows a warp reads on different banks
    float b[TILE_K][TILE_E];      // stage x-plane block
};

// acc[i][j] = sum_k W[r0 + ty + SUB i, k] * x[k, c0 + tx + SUB j].
// x may have been written by other blocks earlier in the same launch, so it
// is read through L2 (__ldcg), never through the non-coherent L1 path.
template <typename WT>
__device__ __forceinline__ void tile_gemm(Smem& s, const WT* __restrict__ w, const float* x,
                                          int n, int e, int r0, int c0, float acc[4][4]) {
    const int tid = threadIdx.x;
    const int tx = tid % SUB, ty = tid / SUB;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < n; k0 += TILE_K) {
        __syncthreads();  // the previous block of a and b has been consumed
#pragma unroll
        for (int q = 0; q < (TILE_N * TILE_K) / THREADS; ++q) {
            const int idx = tid + q * THREADS;
            const int row = idx / TILE_K, kk = idx % TILE_K;
            s.a[row][kk] = w_value<WT>(w[(long long)(r0 + row) * n + k0 + kk]);
        }
#pragma unroll
        for (int q = 0; q < (TILE_K * TILE_E) / THREADS; ++q) {
            const int idx = tid + q * THREADS;
            const int kk = idx / TILE_E, col = idx % TILE_E;
            s.b[kk][col] = x_operand<WT>(__ldcg(x + (long long)(k0 + kk) * e + c0 + col));
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < TILE_K; ++kk) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = s.a[ty + SUB * i][kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = s.b[kk][tx + SUB * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
    }
}

template <typename WT>
__global__ void __launch_bounds__(THREADS) rk4_coop_kernel(
    const float* __restrict__ params, const WT* __restrict__ w,
    const float* __restrict__ h, long long h_stride,  // per-tick stride of h; 0 = constant
    const float* __restrict__ mask,                   // (K, E) or nullptr (all lanes live)
    float* m,                                         // (3, N, E) in/out
    float* states,                                    // (K, N, E) or nullptr
    float* scratch,                                   // (7, N, E): x-plane x2, y/z, accumulator x3
    int n, int e, int k_ticks, int steps, float c_half, float c_full, float c_sixth) {
    __shared__ Smem s;
    cg::grid_group grid = cg::this_grid();
    const long long plane = (long long)n * e;
    const int tiles_e = e / TILE_E;
    const int n_tiles = (n / TILE_N) * tiles_e;
    const int tx = threadIdx.x % SUB, ty = threadIdx.x / SUB;
    float* xbuf = scratch;              // two x-plane buffers
    float* yy = scratch + 2 * plane;    // stage y plane
    float* yz = scratch + 3 * plane;    // stage z plane
    float* kacc = scratch + 4 * plane;  // k1 + 2 k2 + 2 k3, three planes

    // first stage operand: the state's own x-plane
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = (tile / tiles_e) * TILE_N, c0 = (tile % tiles_e) * TILE_E;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const long long idx = (long long)(r0 + ty + SUB * i) * e + c0 + tx + SUB * j;
                xbuf[idx] = m[idx];
            }
    }
    grid.sync();

    int buf = 0;
    for (int t = 0; t < k_ticks; ++t) {
        const float* h_t = h + t * h_stride;
        for (int step = 0; step < steps; ++step) {
            const bool tick_end = step == steps - 1;
            for (int stage = 0; stage < 4; ++stage) {
                const float* x_cur = xbuf + buf * plane;
                float* x_next = xbuf + (buf ^ 1) * plane;
                for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
                    const int r0 = (tile / tiles_e) * TILE_N, c0 = (tile % tiles_e) * TILE_E;
                    float acc[4][4];
                    tile_gemm<WT>(s, w, x_cur, n, e, r0, c0, acc);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int col = c0 + tx + SUB * j;
                        const Params p = load_params(params, e, col);
                        const bool keep = mask == nullptr || mask[(long long)t * e + col] > 0.5f;
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const long long idx = (long long)(r0 + ty + SUB * i) * e + col;
                            const float hx = p.acp * acc[i][j] + h_t[idx];
                            const float mx = m[idx], my = m[plane + idx], mz = m[2 * plane + idx];
                            float yxv = mx, yyv = my, yzv = mz;
                            if (stage > 0) {
                                yxv = __ldcg(x_cur + idx);
                                yyv = yy[idx];
                                yzv = yz[idx];
                            }
                            float kx, ky, kz;
                            llg(yxv, yyv, yzv, hx, p, kx, ky, kz);
                            if (stage < 3) {
                                float ax = kx, ay = ky, az = kz;
                                if (stage > 0) {
                                    ax = kacc[idx] + 2.0f * kx;
                                    ay = kacc[plane + idx] + 2.0f * ky;
                                    az = kacc[2 * plane + idx] + 2.0f * kz;
                                }
                                kacc[idx] = ax;
                                kacc[plane + idx] = ay;
                                kacc[2 * plane + idx] = az;
                                const float c = stage == 2 ? c_full : c_half;
                                x_next[idx] = mx + c * kx;
                                yy[idx] = my + c * ky;
                                yz[idx] = mz + c * kz;
                            } else {
                                // select, never a blend: a frozen lane keeps its bits
                                const float nx = keep ? mx + c_sixth * (kacc[idx] + kx) : mx;
                                const float ny = keep ? my + c_sixth * (kacc[plane + idx] + ky) : my;
                                const float nz = keep ? mz + c_sixth * (kacc[2 * plane + idx] + kz) : mz;
                                m[idx] = nx;
                                m[plane + idx] = ny;
                                m[2 * plane + idx] = nz;
                                x_next[idx] = nx;
                                if (states != nullptr && tick_end) states[t * plane + idx] = nx;
                            }
                        }
                    }
                }
                grid.sync();
                buf ^= 1;
            }
        }
    }
}

template <typename WT>
__global__ void __launch_bounds__(THREADS) field_tiled_kernel(
    const float* __restrict__ params, const WT* __restrict__ w, const float* __restrict__ h,
    const float* __restrict__ yx_full, const float* __restrict__ m,
    const float* __restrict__ kprev, float* __restrict__ out, float c, int use_c, int n, int e) {
    __shared__ Smem s;
    const long long plane = (long long)n * e;
    const int tx = threadIdx.x % SUB, ty = threadIdx.x / SUB;
    const int r0 = blockIdx.y * TILE_N, c0 = blockIdx.x * TILE_E;
    float acc[4][4];
    tile_gemm<WT>(s, w, yx_full, n, e, r0, c0, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + SUB * j;
        const Params p = load_params(params, e, col);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const long long idx = (long long)(r0 + ty + SUB * i) * e + col;
            const float hx = p.acp * acc[i][j] + h[idx];
            float yxv = m[idx], yyv = m[plane + idx], yzv = m[2 * plane + idx];
            if (use_c) {
                yxv = yxv + c * kprev[idx];
                yyv = yyv + c * kprev[plane + idx];
                yzv = yzv + c * kprev[2 * plane + idx];
            }
            float kx, ky, kz;
            llg(yxv, yyv, yzv, hx, p, kx, ky, kz);
            out[idx] = kx;
            out[plane + idx] = ky;
            out[2 * plane + idx] = kz;
        }
    }
}

template <typename WT>
cudaError_t launch_coop(const float* params, const WT* w, const float* h, long long h_stride,
                        const float* mask, float* m, float* states, float* scratch, int n, int e,
                        int k_ticks, int steps, float c_half, float c_full, float c_sixth,
                        cudaStream_t stream) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rk4_coop_kernel<WT>, THREADS, 0);
    if (err != cudaSuccess) return err;
    const int n_tiles = (n / TILE_N) * (e / TILE_E);
    int blocks = per_sm * sms;
    if (blocks > n_tiles) blocks = n_tiles;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    void* args[] = {&params, &w, &h, &h_stride, &mask, &m, &states, &scratch, &n, &e,
                    &k_ticks, &steps, &c_half, &c_full, &c_sixth};
    err = cudaLaunchCooperativeKernel((const void*)rk4_coop_kernel<WT>, dim3(blocks), dim3(THREADS),
                                      args, 0, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_field(const float* params, const WT* w, const float* h, const float* yx,
                         const float* m, const float* kprev, float* out, float c, int use_c, int n,
                         int e, cudaStream_t stream) {
    const dim3 grid(e / TILE_E, n / TILE_N);
    field_tiled_kernel<WT><<<grid, THREADS, 0, stream>>>(params, w, h, yx, m, kprev, out, c, use_c,
                                                         n, e);
    return cudaGetLastError();
}

bool bad_shape(int n, int e) { return n <= 0 || e <= 0 || n % TILE_N != 0 || e % TILE_E != 0; }

}  // namespace

extern "C" {

int sto_tile_n() { return TILE_N; }
int sto_tile_e() { return TILE_E; }

// rk4_chunk (k_ticks = K, mask and states set) and rk4_fused (k_ticks = 1,
// h_stride = 0, mask and states null). Returns a cudaError_t.
int sto_rk4_coop(int w_bf16, const void* params, const void* w, const void* h, long long h_stride,
                 const void* mask, void* m, void* states, void* scratch, int n, int e, int k_ticks,
                 int steps, float c_half, float c_full, float c_sixth, void* stream) {
    if (bad_shape(n, e) || k_ticks < 1 || steps < 1) return cudaErrorInvalidValue;
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* pp = static_cast<const float*>(params);
    const auto* hp = static_cast<const float*>(h);
    const auto* mk = static_cast<const float*>(mask);
    auto* mp = static_cast<float*>(m);
    auto* sp = static_cast<float*>(states);
    auto* sc = static_cast<float*>(scratch);
    if (w_bf16)
        return launch_coop(pp, static_cast<const __nv_bfloat16*>(w), hp, h_stride, mk, mp, sp, sc,
                           n, e, k_ticks, steps, c_half, c_full, c_sixth, st);
    return launch_coop(pp, static_cast<const float*>(w), hp, h_stride, mk, mp, sp, sc, n, e,
                       k_ticks, steps, c_half, c_full, c_sixth, st);
}

// field_tiled: one LLG slope k = f(m + c k_prev) for every (row, lane).
int sto_field_tiled(int w_bf16, const void* params, const void* w, const void* h, const void* yx,
                    const void* m, const void* kprev, void* out, float c, int use_c, int n, int e,
                    void* stream) {
    if (bad_shape(n, e)) return cudaErrorInvalidValue;
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* pp = static_cast<const float*>(params);
    const auto* hp = static_cast<const float*>(h);
    const auto* yp = static_cast<const float*>(yx);
    const auto* mp = static_cast<const float*>(m);
    const auto* kp = static_cast<const float*>(kprev);
    auto* op = static_cast<float*>(out);
    if (w_bf16)
        return launch_field(pp, static_cast<const __nv_bfloat16*>(w), hp, yp, mp, kp, op, c, use_c,
                            n, e, st);
    return launch_field(pp, static_cast<const float*>(w), hp, yp, mp, kp, op, c, use_c, n, e, st);
}

}  // extern "C"
