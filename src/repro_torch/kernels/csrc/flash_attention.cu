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
// head h uses kv head h / G, G = H / KVH. On the TPU the KV axis was the
// innermost grid dimension with the running statistics in VMEM scratch; here
// a block owns one q tile and loops over its KV tiles itself, the statistics
// in registers.
//
// Bound at the prefill shape of h2o-danube-1.8b (B = 1, H = 32, KVH = 8,
// D = 80, Sq = Sk = 4608, window 4096): the two products are 4 H D x
// (unmasked pairs) = 1.07e11 FLOP against 2.4 MB of q, k, v and o, so the
// kernel is bound by operations: 0.109 ms at the bf16 tensor-core rate
// (989 TFLOP/s, NVIDIA H100 SXM data sheet). It has to keep the tensor cores
// fed, which on Hopper takes wgmma fed by TMA.
//
// flash_bf16 (the model path), warp-specialised:
//   * Tile. 128 q rows: the (position, group head) pairs of one kv head,
//     position-major (row = i * Gc + g), whole positions only: P = 128 / Gc
//     positions of Gc heads (Gc = G, or G split into equal chunks when
//     G > 128). Rows past P * Gc are zeroed and never stored. All Gc heads
//     share each K/V tile, so K/V are read once per kv head.
//   * Warpgroups (384 threads). WG2 is the producer: setmaxnreg drops it to
//     40 registers and one thread issues every TMA load. WG0 and WG1 are the
//     consumers, 64 rows each, raised to 232 registers: at D = 256 the O
//     accumulator alone is 128 f32 a thread.
//   * Loads. Q once per tile by a 4-d TMA box (D-box, Gc heads, P positions,
//     1) that lands as exactly the tile's rows; K and V tiles of BK keys into
//     a ring of STAGES stages in dynamic shared memory, each stage with a
//     `full` mbarrier for K, one for V (TMA completes their byte counts) and
//     an `empty` one (one arrive per consumer warp after its P.V). The
//     producer waits on `empty` with the opposite parity, so the first
//     STAGES loads go out at once. BK = 128 keys (64 at D = 192 and 256, to
//     keep S, P and O within 232 registers); STAGES = 3 (2 at D >= 128, to fit
//     227 KB). A block handles one q tile, so no phase carries over.
//   * D in 128-byte swizzle atoms. A row of 64 bf16 is one atom. D = 80
//     (h2o-danube) is one 64-column box with 128-byte swizzle plus a
//     16-column box with 32-byte swizzle; D = 96 a 64-column box plus a
//     32-column box with 64-byte swizzle; D = 32 that 32-column box alone;
//     D = 64, 128, 192 (MLA's dn + dr), 256 one, two, three, four
//     64-column boxes. Every box has its own
//     tensor map and descriptor, so no column is padded and no FLOP wasted:
//     S = Q K^T runs D / 16 k-steps (at D = 80: four in the first box, one
//     in the tail) and O += P V one wgmma per box per k-step (n = 64 and
//     n = 16 at D = 80).
//   * Products. S = Q K^T as wgmma m64nBKk16, Q and K from shared memory
//     (K-major descriptors). The f32 S accumulator has the mma.sync row and
//     column layout per warp, so the scaling (log2(e) folded in), masking,
//     online softmax (ex2) and the packing of P to bf16 run in registers as
//     in the first kernel; O += P V as wgmma m64nNk16 with P from registers
//     and V from shared memory as an N-major (transposed) B operand.
//   * Masks. Tile pruning is the loop bounds: the band of the tile's
//     positions gives the first and last KV tile, and only tiles that
//     straddle an edge of the band or the ragged end of Sk apply the
//     elementwise mask, a block-uniform branch that compares each key with
//     the row's [lo, hi] limits (computed once a block) and selects -inf,
//     so unmasked tiles do no integer work per score (testing every score
//     against the band costs ~49 instructions a score, 4x the kernel's
//     time). TMA fills keys past Sk with zeros, which score 0 and not -inf,
//     so the last ragged tile is always masked.
//   * Output. Each warp stages its 16 rows (bf16) in its own rows of the Q
//     buffer (swizzled, free of bank conflicts) and writes them with 16-byte
//     stores; rows past Sq or past the head group are not stored.
//   * Schedule. Under a causal mask later q tiles read more keys, so the
//     heaviest are launched first (blockIdx.x runs the q tiles backwards);
//     without it, a window makes the earlier tiles heavier and the order is
//     forwards.
//   Not built (later work): overlap of the softmax with the next Q K^T
//   inside a warpgroup, ping-pong of the two consumer warpgroups, a
//   persistent grid. A version that issued Q K(i)^T beside P V(i - 1) and
//   ran the softmax between them read 20 % slower on an H100: ptxas
//   serialised its wgmma (C7513, an input register written while a group
//   was in flight).
// flash_f32: the f32 variant (tests and the plain comparison) on the CUDA
//   cores: 64 rows a block, four threads per q row, each holding D/4
//   interleaved dims of q and of the accumulator; a dot product is reduced
//   across the four with two shuffles; exp in full precision.
//
// The host encodes the tensor maps with cuTensorMapEncodeTiled, a
// driver-API function reached through cudaGetDriverEntryPoint[ByVersion], so
// the library links against nothing beyond the CUDA runtime. A map the
// driver refuses comes back as error TMAP_ERROR + its CUresult.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TMAP_ERROR = 1000;  // + CUresult: a tensor map the driver refused

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    int batch, kvh, g, sq, sk;
    long long q_sb, q_ss, q_sh;
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_ss, o_sh;
    int causal, window;
    float scale;
    int gc, npos;      // bf16 tile: Gc heads x P positions
    int hchunks, nq;   // head chunks per kv head, q tiles per (batch, kv head, chunk)
};

// Keys [k_begin, k_end) that any row of a tile whose positions are
// [p_lo, p_hi] (q index + Sk - Sq) may attend to.
struct Band {
    int k_begin, k_end, p_lo, p_hi;
};

__device__ __forceinline__ Band make_band(const Args& a, int p_lo, int p_hi) {
    Band band;
    band.p_lo = p_lo;
    band.p_hi = p_hi;
    band.k_begin = a.window > 0 ? max(0, p_lo - a.window + 1) : 0;
    band.k_end = a.causal ? min(a.sk, p_hi + 1) : a.sk;
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

// Two f32 values as a bf16 pair, the first in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int ROWS = 128;          // q rows per tile: two consumer warpgroups
constexpr int THREADS_WS = 384;    // WG0, WG1 consumers, WG2 producer
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;

template <int D>
struct Tile {
    static_assert(D % 16 == 0 && (D % 64 == 0 || D % 64 == 16 || D % 64 == 32) && D <= 256,
                  "head dim: 64-column boxes plus a 0, 16 or 32-column tail, at most 256");
    static constexpr int NB = D / 64;                 // 64-column boxes, 128-byte swizzle
    static constexpr int TAIL = D % 64;               // 16 (32-byte swizzle) or 32 (64-byte)
    static constexpr int NBOX = NB + (TAIL > 0);
    static constexpr int BK = D > 128 ? 64 : 128;     // keys per KV tile
    static constexpr int STAGES = D >= 128 ? 2 : 3;   // ring depth
    static constexpr int Q_BYTES = ROWS * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;       // one K (or V) tile
    static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;  // + alignment slack
    static constexpr int NT_S = BK / 8;               // n-tiles of S
    static constexpr int TAIL_REGS = TAIL > 0 ? TAIL / 2 : 1;
    // box b of a tile of `rows` rows: byte offset and row bytes
    static constexpr __host__ __device__ int box_off(int rows, int b) { return rows * 128 * b; }
    static constexpr __host__ __device__ int row_bytes(int b) { return b < NB ? 128 : TAIL * 2; }
};

// wgmma descriptor layout types (bits 62-63) per swizzle width
constexpr uint32_t LAYOUT_SW128 = 1, LAYOUT_SW64 = 2, LAYOUT_SW32 = 3;

__host__ __device__ constexpr uint32_t layout_of(int row_bytes) {
    return row_bytes == 128 ? LAYOUT_SW128 : row_bytes == 64 ? LAYOUT_SW64 : LAYOUT_SW32;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout. K-major operands (Q, K):
// SBO = 8 rows, LBO unused (1). The N-major V operand spans one swizzle atom
// in N per wgmma, so only the 8-row K-group stride is read; it goes in both
// fields.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
           (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across a wgmma
// wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// D (64 x N, f32) += A (64 x 16) B (16 x N): both from shared memory
// (scale_d = 0 overwrites D), or A from registers (the mma.sync A fragment
// layout per warp) and B N-major.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
          , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
          , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
          , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
          , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          , "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
          , "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
          , "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
          , "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
          , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
          , "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          , "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
          , "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Which q tile block `bid` runs: the heaviest first (see Schedule above).
struct QTile {
    int b, kh, hc, p0;
};

__device__ __forceinline__ QTile q_tile(const Args& a, int bid) {
    const int groups = a.batch * a.kvh * a.hchunks;
    const int r = bid / groups, grp = bid % groups;  // grp over (batch, kv head, chunk)
    QTile t;
    t.b = grp / (a.kvh * a.hchunks);
    t.kh = (grp / a.hchunks) % a.kvh;
    t.hc = grp % a.hchunks;
    t.p0 = (a.causal ? a.nq - 1 - r : r) * a.npos;
    return t;
}

template <int D>
__global__ void __launch_bounds__(THREADS_WS, 1)
    flash_bf16(const Args a, const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tq_tail, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tk_tail, const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tv_tail) {
    using T = Tile<D>;
    constexpr int BK = T::BK, NB = T::NB, TAIL = T::TAIL, STAGES = T::STAGES;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];  // q, full_k[S], full_v[S], empty[S]

    const int tid = threadIdx.x;
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;  // every box 1024-byte aligned
    uint8_t* const base_ptr = smem_raw + (base - raw);
    const uint32_t q_s = base;
    const uint32_t kv_s = base + T::Q_BYTES;       // stage s: K at +2s, V at +2s+1 tiles
    const uint32_t bar_q = smem_u32(&bars[0]);
    const uint32_t bar0 = smem_u32(&bars[1]);      // full_k[s] = bar0 + 8s
    const uint32_t bar_v0 = bar0 + 8 * STAGES;     // full_v[s]
    const uint32_t bar_e0 = bar0 + 16 * STAGES;    // empty[s]

    const QTile qt = q_tile(a, blockIdx.x);
    const int off = a.sk - a.sq;
    const int npos_here = min(a.npos, a.sq - qt.p0);
    const Band band = make_band(a, qt.p0 + off, qt.p0 + npos_here - 1 + off);
    const int kt0 = band.k_begin / BK;
    const int ntiles = band.k_end > band.k_begin ? (band.k_end + BK - 1) / BK - kt0 : 0;

    // Rows past P * Gc: zero, so no stale bits enter a product (the TMA box
    // covers the rest; positions past Sq it fills with zeros).
    {
        const int r0 = a.npos * a.gc;
#pragma unroll
        for (int b = 0; b < T::NBOX; ++b) {
            const int rb = T::row_bytes(b) / 16;  // 16-byte chunks per row
            uint4* box = reinterpret_cast<uint4*>(base_ptr + T::box_off(ROWS, b));
            for (int c = r0 * rb + tid; c < ROWS * rb; c += THREADS_WS) box[c] = make_uint4(0u, 0u, 0u, 0u);
        }
    }
    if (tid == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bar0 + 8 * s, 1);
            mbar_init(bar_v0 + 8 * s, 1);
            mbar_init(bar_e0 + 8 * s, CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, for wgmma
    __syncthreads();

    const int wg = tid / 128;
    if (wg == 2) {
        // ---- producer: one thread issues every load --------------------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (tid == 2 * 128) {
            const int h0 = qt.kh * a.g + qt.hc * a.gc;
            mbar_expect_tx(bar_q, D * 2 * a.gc * a.npos);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                tma_load_4d(q_s + T::box_off(ROWS, b), &tq, 64 * b, h0, qt.p0, qt.b, bar_q);
            }
            if (TAIL > 0) tma_load_4d(q_s + T::box_off(ROWS, NB), &tq_tail, 64 * NB, h0, qt.p0, qt.b, bar_q);
            for (int i = 0; i < ntiles; ++i) {
                const int s = i % STAGES;
                const uint32_t ks = kv_s + (2 * s) * T::KV_BYTES, vs = ks + T::KV_BYTES;
                const int key0 = (kt0 + i) * BK;
                mbar_wait(bar_e0 + 8 * s, ((i / STAGES) & 1) ^ 1);
                mbar_expect_tx(bar0 + 8 * s, T::KV_BYTES);
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    tma_load_4d(ks + T::box_off(BK, b), &tk, 64 * b, qt.kh, key0, qt.b, bar0 + 8 * s);
                }
                if (TAIL > 0) {
                    tma_load_4d(ks + T::box_off(BK, NB), &tk_tail, 64 * NB, qt.kh, key0, qt.b, bar0 + 8 * s);
                }
                mbar_expect_tx(bar_v0 + 8 * s, T::KV_BYTES);
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    tma_load_4d(vs + T::box_off(BK, b), &tv, 64 * b, qt.kh, key0, qt.b, bar_v0 + 8 * s);
                }
                if (TAIL > 0) {
                    tma_load_4d(vs + T::box_off(BK, NB), &tv_tail, 64 * NB, qt.kh, key0, qt.b, bar_v0 + 8 * s);
                }
            }
        }
    } else {
        // ---- consumers: 64 rows per warpgroup --------------------------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        const int warp = (tid / 32) % 4, lane = tid % 32;
        const int grp = lane >> 2, tq4 = lane & 3;
        const int row_a = wg * 64 + warp * 16 + grp, row_b = row_a + 8;  // this thread's rows
        // the keys [lo, hi] each of the thread's rows attends to (a causal or
        // window edge, or the end of Sk)
        const int pos_a = qt.p0 + row_a / a.gc + off, pos_b = qt.p0 + row_b / a.gc + off;
        const int hi_a = a.causal ? min(pos_a, a.sk - 1) : a.sk - 1;
        const int hi_b = a.causal ? min(pos_b, a.sk - 1) : a.sk - 1;
        const int lo_a = a.window > 0 ? pos_a - a.window + 1 : 0;
        const int lo_b = a.window > 0 ? pos_b - a.window + 1 : 0;
        const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)

        float o[NB > 0 ? NB : 1][32];
        float ot[T::TAIL_REGS];
#pragma unroll
        for (int b = 0; b < (NB > 0 ? NB : 1); ++b)
#pragma unroll
            for (int i = 0; i < 32; ++i) o[b][i] = 0.f;
#pragma unroll
        for (int i = 0; i < T::TAIL_REGS; ++i) ot[i] = 0.f;
        float s[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
        float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

        // Q descriptors: this warpgroup's 64 rows of each box
        uint64_t qd[T::NBOX];
#pragma unroll
        for (int b = 0; b < T::NBOX; ++b) {
            const uint32_t rb = T::row_bytes(b);
            qd[b] = make_desc(q_s + T::box_off(ROWS, b) + wg * 64 * rb, 16, 8 * rb, layout_of(rb));
        }
        mbar_wait(bar_q, 0);

        for (int i = 0; i < ntiles; ++i) {
            const int st = i % STAGES;
            const uint32_t parity = (i / STAGES) & 1;
            const uint32_t ks = kv_s + (2 * st) * T::KV_BYTES, vs = ks + T::KV_BYTES;
            const int kt = (kt0 + i) * BK;

            // S = Q K^T: D / 16 k-steps, 32 bytes apart inside a box
            mbar_wait(bar0 + 8 * st, parity);
            wgmma_fence();
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                const uint64_t kd = make_desc(ks + T::box_off(BK, b), 16, 1024, LAYOUT_SW128);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) wgmma_ss<BK>(s, qd[b] + 2 * kk, kd + 2 * kk, b + kk > 0);
            }
            if constexpr (TAIL > 0) {
                constexpr uint32_t rb = TAIL * 2;
                const uint64_t kd = make_desc(ks + T::box_off(BK, NB), 16, 8 * rb, layout_of(rb));
#pragma unroll
                for (int kk = 0; kk < TAIL / 16; ++kk) {
                    wgmma_ss<BK>(s, qd[T::NBOX - 1] + 2 * kk, kd + 2 * kk, NB + kk > 0);
                }
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(s);

            // online softmax in registers: s[4j + e] is row (e < 2 ? a : b),
            // key kt + 8j + 2 tq4 + (e & 1); scores in the log2 domain
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
            if (tile_needs_mask(a, band, kt, BK)) {  // the same for the whole block
                const int c0 = kt + 2 * tq4;
                const int ha = hi_a - c0, la = lo_a - c0, hb = hi_b - c0, lb = lo_b - c0;
#pragma unroll
                for (int j = 0; j < T::NT_S; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int c = 8 * j + (e & 1);
                        const bool ok = e < 2 ? (c <= ha && c >= la) : (c <= hb && c >= lb);
                        s[4 * j + e] = ok ? s[4 * j + e] : -INFINITY;
                    }
            }
            float mx_a = m_a, mx_b = m_b;
#pragma unroll
            for (int j = 0; j < T::NT_S; ++j) {
                mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
                mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
            }
            mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
            mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
            // a row with no unmasked key so far keeps max -inf: exponentiate
            // against 0 instead, so its p and correction are exactly 0
            const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
            const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
            const float corr_a = ex2(m_a - base_a), corr_b = ex2(m_b - base_b);
            m_a = mx_a;
            m_b = mx_b;
            l_a *= corr_a;
            l_b *= corr_b;
#pragma unroll
            for (int b = 0; b < NB; ++b)
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    o[b][4 * q] *= corr_a;
                    o[b][4 * q + 1] *= corr_a;
                    o[b][4 * q + 2] *= corr_b;
                    o[b][4 * q + 3] *= corr_b;
                }
#pragma unroll
            for (int q = 0; q < TAIL / 8; ++q) {
                ot[4 * q] *= corr_a;
                ot[4 * q + 1] *= corr_a;
                ot[4 * q + 2] *= corr_b;
                ot[4 * q + 3] *= corr_b;
            }

            // P as the register A operand of O += P V: the accumulator layout
            // of two adjacent n8 tiles is the A layout of one k16 step.
            uint32_t pf[BK / 16][4];
#pragma unroll
            for (int j = 0; j < T::NT_S; ++j) {
                const float p0 = ex2(s[4 * j] - base_a), p1 = ex2(s[4 * j + 1] - base_a);
                const float p2 = ex2(s[4 * j + 2] - base_b), p3 = ex2(s[4 * j + 3] - base_b);
                l_a += p0 + p1;
                l_b += p2 + p3;
                pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
                pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
            }

            // O += P V: V N-major, 16 keys a k-step
            mbar_wait(bar_v0 + 8 * st, parity);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                    const uint32_t at = vs + T::box_off(BK, b) + kk * 16 * 128;
                    wgmma_rs<64>(o[b], pf[kk], make_desc(at, 1024, 1024, LAYOUT_SW128));
                }
                if constexpr (TAIL > 0) {
                    constexpr uint32_t rb = TAIL * 2;
                    const uint32_t at = vs + T::box_off(BK, NB) + kk * 16 * rb;
                    wgmma_rs<TAIL>(ot, pf[kk], make_desc(at, 8 * rb, 8 * rb, layout_of(rb)));
                }
            }
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int b = 0; b < NB; ++b) fence_regs(o[b]);
            fence_regs(ot);
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_e0 + 8 * st);  // this warp is done with the stage
        }

        l_a += __shfl_xor_sync(FULL, l_a, 1);
        l_a += __shfl_xor_sync(FULL, l_a, 2);
        l_b += __shfl_xor_sync(FULL, l_b, 1);
        l_b += __shfl_xor_sync(FULL, l_b, 2);
        const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;  // fully masked row -> 0
        const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;

        // Stage the warp's 16 rows in its own rows of the Q boxes (the
        // warpgroup's last wgmma has read them: wait for its four warps),
        // 16-byte chunk c of row r at chunk c ^ (r mod chunks per row).
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        const int ra = row_a, rbw = row_b;
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                uint8_t* box = base_ptr + T::box_off(ROWS, b);
                *reinterpret_cast<uint32_t*>(box + ra * 128 + ((q ^ (ra & 7)) * 16) + 4 * tq4) =
                    pack_bf16(o[b][4 * q] * inv_a, o[b][4 * q + 1] * inv_a);
                *reinterpret_cast<uint32_t*>(box + rbw * 128 + ((q ^ (rbw & 7)) * 16) + 4 * tq4) =
                    pack_bf16(o[b][4 * q + 2] * inv_b, o[b][4 * q + 3] * inv_b);
            }
        if constexpr (TAIL > 0) {
            constexpr int rb = TAIL * 2, cpr = TAIL / 8;
            uint8_t* box = base_ptr + T::box_off(ROWS, NB);
#pragma unroll
            for (int q = 0; q < TAIL / 8; ++q) {
                *reinterpret_cast<uint32_t*>(box + ra * rb + ((q ^ (ra & (cpr - 1))) * 16) + 4 * tq4) =
                    pack_bf16(ot[4 * q] * inv_a, ot[4 * q + 1] * inv_a);
                *reinterpret_cast<uint32_t*>(box + rbw * rb + ((q ^ (rbw & (cpr - 1))) * 16) + 4 * tq4) =
                    pack_bf16(ot[4 * q + 2] * inv_b, ot[4 * q + 3] * inv_b);
            }
        }
        __syncwarp();
        constexpr int CH = D / 8;  // 16-byte chunks per row
        const int gbase = qt.hc * a.gc;
        __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + qt.b * a.o_sb +
                            (long long)(qt.kh * a.g) * a.o_sh;
        for (int c = lane; c < 16 * CH; c += 32) {
            const int r = wg * 64 + warp * 16 + c / CH, ch = c % CH;
            const int pi = r / a.gc, gi = r % a.gc;
            // rows past P x Gc, positions past Sq and heads past the group are not stored
            if (pi >= a.npos || qt.p0 + pi >= a.sq || gbase + gi >= a.g) continue;
            const int b = ch / 8 < NB ? ch / 8 : NB;
            const int cb = ch - 8 * b, rb = T::row_bytes(b), cpr = rb / 16;
            const uint4 val = *reinterpret_cast<const uint4*>(
                base_ptr + T::box_off(ROWS, b) + r * rb + ((cb ^ (r & (cpr - 1))) * 16));
            *reinterpret_cast<uint4*>(ob + (long long)(qt.p0 + pi) * a.o_ss +
                                      (long long)(gbase + gi) * a.o_sh + ch * 8) = val;
        }
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, four threads per row
// ---------------------------------------------------------------------------

constexpr int BQ = 64;             // q rows per block, f32 kernel
constexpr int THREADS_F32 = 256;   // 64 rows x 4 threads

template <int D>
__global__ void __launch_bounds__(THREADS_F32) flash_f32(Args a) {
    static_assert(D % 16 == 0 && D <= 256, "head dim must be a multiple of 16, at most 256");
    constexpr int BK_F32 = D > 128 ? 16 : 32;  // keys per tile: K and V within 48 KB
    constexpr int DPT = D / 4;                 // dims per thread: d = t * 4 + tq
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
    const int off = a.sk - a.sq;
    const Band band = make_band(a, r0 / a.g + off, (min(r0 + BQ, nrows) - 1) / a.g + off);
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A bf16 (batch, seq, head, D) operand read through strides as a 4-d map
// (D, heads, seq, batch) with a box of (cols, box_heads, box_rows, 1).
int encode(CUtensorMap* map, const void* ptr, int d, int heads, int seq, int batch, long long s_h,
           long long s_s, long long s_b, int cols, int box_heads, int box_rows) {
    const EncodeTiled fn = encode_fn();
    if (!fn) return TMAP_ERROR + CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2, (cuuint64_t)s_b * 2};
    const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle sw = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                          box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : TMAP_ERROR + (int)r;
}

template <int D>
int launch_bf16(const Args& a, int batch, cudaStream_t st) {
    using T = Tile<D>;
    const int heads = a.kvh * a.g;
    const int main_cols = T::NB > 0 ? 64 : T::TAIL, tail_cols = T::TAIL > 0 ? T::TAIL : 64;
    CUtensorMap m[6];  // q, q tail, k, k tail, v, v tail
    int err = 0;
    for (int t = 0; t < 2 && !err; ++t) {
        const int cols = t == 0 ? main_cols : tail_cols;
        err = encode(&m[t], a.q, D, heads, a.sq, batch, a.q_sh, a.q_ss, a.q_sb, cols, a.gc, a.npos);
        if (!err) err = encode(&m[2 + t], a.k, D, a.kvh, a.sk, batch, a.k_sh, a.k_ss, a.k_sb, cols, 1, T::BK);
        if (!err) err = encode(&m[4 + t], a.v, D, a.kvh, a.sk, batch, a.v_sh, a.v_ss, a.v_sb, cols, 1, T::BK);
    }
    if (err) return err;
    cudaError_t ce = cudaFuncSetAttribute(flash_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (ce != cudaSuccess) return ce;
    const long long grid = (long long)a.nq * batch * a.kvh * a.hchunks;
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    flash_bf16<D><<<(unsigned)grid, THREADS_WS, T::SMEM, st>>>(a, m[0], m[1], m[2], m[3], m[4], m[5]);
    return cudaGetLastError();
}

template <int D>
int launch(const Args& a, int bf16, int batch, cudaStream_t st) {
    if (bf16) return launch_bf16<D>(a, batch, st);
    const dim3 grid((a.sq * a.g + BQ - 1) / BQ, batch * a.kvh);
    flash_f32<D><<<grid, THREADS_F32, 0, st>>>(a);
    return cudaGetLastError();
}

template <int D>
void bf16_config(int* out) {
    out[0] = ROWS;
    out[1] = Tile<D>::BK;
    out[2] = Tile<D>::STAGES;
    out[3] = Tile<D>::SMEM;
}

}  // namespace

extern "C" {

// q/o strides (batch, seq, head) and k/v strides (batch, seq, kv head) are in
// elements; the head dim must be contiguous and every row 16-byte aligned
// (the wrapper checks). bf16 = 1 takes bf16 tensors, 0 takes f32. gc and
// npos are the bf16 tile's heads and positions (the wrapper's tile plan).
// Returns a cudaError_t (0 on success), or TMAP_ERROR + a CUresult where the
// driver refused a tensor map; nothing is synchronised.
int flash_attention_fwd(int bf16, const void* q, const void* k, const void* v, void* o, int batch,
                        int heads, int kv_heads, int sq, int sk, int d, long long q_sb,
                        long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                        long long o_sb, long long o_ss, long long o_sh, int causal, int window,
                        float scale, int gc, int npos, cudaStream_t stream) {
    if (batch < 1 || kv_heads < 1 || heads % kv_heads != 0 || sq < 1 || sk < 1 || window < 0) {
        return cudaErrorInvalidValue;
    }
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = o;
    a.batch = batch;
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
    a.gc = gc;
    a.npos = npos;
    a.hchunks = gc > 0 ? (a.g + gc - 1) / gc : 0;
    a.nq = npos > 0 ? (sq + npos - 1) / npos : 0;
    if (bf16 && (gc < 1 || gc > a.g || npos < 1 || gc * npos > ROWS)) {
        return cudaErrorInvalidValue;
    }
    if (!bf16 && (long long)batch * kv_heads > 65535) return cudaErrorInvalidValue;
    switch (d) {
        case 32: return launch<32>(a, bf16, batch, stream);
        case 64: return launch<64>(a, bf16, batch, stream);
        case 80: return launch<80>(a, bf16, batch, stream);
        case 96: return launch<96>(a, bf16, batch, stream);
        case 128: return launch<128>(a, bf16, batch, stream);
        case 192: return launch<192>(a, bf16, batch, stream);
        case 256: return launch<256>(a, bf16, batch, stream);
        default: return cudaErrorInvalidValue;
    }
}

// The bf16 kernel's tile at head dim d: out = {q rows, keys per KV tile, ring
// stages, dynamic shared memory bytes}. Returns 0, or cudaErrorInvalidValue.
int flash_bf16_config(int d, int* out) {
    switch (d) {
        case 32: bf16_config<32>(out); return 0;
        case 64: bf16_config<64>(out); return 0;
        case 80: bf16_config<80>(out); return 0;
        case 96: bf16_config<96>(out); return 0;
        case 128: bf16_config<128>(out); return 0;
        case 192: bf16_config<192>(out); return 0;
        case 256: bf16_config<256>(out); return 0;
        default: return cudaErrorInvalidValue;
    }
}

}  // extern "C"
