// The out-of-domain (OOD) evaluation and the DEEP inverse tables of one
// statement on Hopper (stark/prover.py binds them with ctypes):
//
//   tmx_ext_powers     [b^0 .. b^(n-1)] for each of up to MAX_POINTS
//                      extension points b;
//   tmx_ood_eval       every row polynomial of a coefficient matrix
//                      evaluated at every opening point z_k from the
//                      points' powers: v[k][r] = sum_j c[r][j] z_k^j;
//   tmx_deep_inverses  (x - z_k)^-1 over the whole LDE domain, x = shift
//                      w_N^i, for every opening point.
//
// Replaces the XLA programs of tendermintx_tpu/stark/prover.py:565
// `_zpowers_fn` (a device scan of extension multiplies), :588
// `_ood_trace_fn` (over the :617 `_gk_table`; the port evaluates at
// z g^k directly, the same values), :606 `_ood_ext_fn` and :103
// `_deep_invs_fn`.
//
// Bounds and design, per entry:
//
// - ext_powers writes 16 bytes an element and does one extension multiply
//   for it: at the statements' sizes (up to 8 x 2^17 elements) bound by
//   the bytes (2.5 us at SHA-256's 8 x 2^16) or, below, by a launch and
//   the latency of the longest chain of dependent multiplies, which any
//   schedule has: b^(n-1) takes at least log2 n of them. So the design
//   keeps that chain short and the stores coalesced. A block of
//   POW_THREADS threads (one point: grid.y) takes a tile of E =
//   POW_THREADS run consecutive powers, thread t the powers base + j
//   POW_THREADS + t (j < run, the host's 1, 2, 4 or 8: about
//   POW_BLOCKS blocks in all), so each warp stores 32 consecutive words.
//   Its first warp squares b once a bit of the tile's base (b^(2^q): every
//   lane the same chain, in prepared form, ext.cuh: sq_pre) and multiplies
//   as it goes b^base (the set bits of base) and, lane l, b^l (bits q <
//   5): one chain of ~9-17 squarings with the other products beside it.
//   It then leaves in shared memory each lane's b^l, each warp's b^(base +
//   32 w) (from b^32, b^64, b^128) and b^POW_THREADS (q = 8), so a thread's
//   first power is one product, each of its next ones one more: no host
//   table (a Python extension squaring costs about a microsecond, a
//   point's chain 9-17 of them), no square-and-multiply a thread. Field
//   arithmetic is exact, so every power equals the sequential product's.
// - ood_eval reads each coefficient once for all points (Ed25519 at N=128:
//   2,929 rows x 2^15, 768 MB) and does two 64 x 64 products a coefficient
//   a point, each a multiply-add into a 160-bit sum: bytes-bound in the
//   function, issue- and latency-bound in the kernel, the SHA AIRs' few
//   rows at 8 points most. So the design buys warps and cuts
//   instructions. A block takes `threads` rows, one a thread, at 1, 2 or
//   GROUP_POINTS points (a point group: grid.z), over one slice of the row
//   length (grid.y), which it walks in tiles of TJ coefficients. Each tile
//   of its rows and of its points' powers is copied into a ring of STAGES
//   tiles in shared memory with cp.async (16-byte copies, 8-byte where a
//   row is not 16-byte aligned, zero-filled past the row's end; each
//   thread's copies fixed for the block), so the next STAGES - 1 tiles are
//   in flight while the block multiplies the current one; cp.async rather
//   than TMA because the operands are row views of any stride, the chunk
//   rows a strided view of the quotient's block, and the last tile
//   ragged. A staged row is padded to LD words, so the 16-byte reads of
//   eight consecutive threads, each of its own row, hit distinct banks;
//   one 16-byte read gives a row's two coefficients, another two powers of
//   a point (a broadcast: two consecutive powers of one component rather
//   than a power's c0 and c1, the same one read for two products, and
//   copied as ext_powers lays them out). The products are summed
//   unreduced in Dot accumulators (two carry chains: ~9 SASS
//   instructions a product, 5 of them IMAD.WIDE), reduced once a slice; a
//   second kernel adds the slices' canonical partials (field adds, exact
//   in any order). The rows of a are evaluated at every point, those of b
//   (the quotient chunks' c0 and c1 rows) at the first point alone, by the
//   first point group.
//   stark/prover.py::_ood_plan picks the threads (32, 64 or 128, the
//   fewest idle) and the slices: about one wave of resident blocks
//   (tmx_ood_occupancy) over the card. Two rows a thread (one power read
//   feeding both) measured slower at every N=128 shape: their
//   accumulators halve the resident warps (PERF.md, PR 12).
// - deep_inverses writes 16 bytes a (point, x) pair (SHA-256 at N=128: 8
//   points x 2^19, 67 MB): bytes-bound in the function, whose inverses
//   are one Montgomery batch, and bound by integer issue in a kernel that
//   inverts each pair alone (an addition chain of 73 multiplies,
//   goldilocks.cuh: inv). So a pair costs its norm and its share of a
//   batch inversion: 1/(x - z) = (x - z0 + z1 X) / n with n = (x - z0)^2
//   - W z1^2, W z1^2 a point's constant from the host, so a pair's norm
//   is one multiply and its numerator none. Each thread takes J = 24 / K
//   domain points at a grid stride (i, i + stride, ..: stores stay
//   coalesced along each (component, point) row of the output) at all K
//   points, B = J K = 20-24 pairs, and inverts their norms together by
//   Montgomery's trick in prefix form: the running products c_p = n_0 ..
//   n_p on the way up, one inversion of c_(B-1), then on the way down 1 /
//   n_p = acc c_(p-1) with acc = 1 / c_p stepped back by n_p, and the
//   pair's two values (x - z0) / n_p and z1 / n_p: 6 multiplies a pair
//   and 73 a batch. The registers hold c and n (4 words a pair; x - z0 is
//   recomputed from x, which steps back by w_N^-stride), where ext.cuh's
//   batch_div holds y and n (6 words) and does 7 multiplies. B = 24 was
//   the fastest of 16, 24 and 32 at SHA-256's and EvalAir's shapes (32:
//   ptxas spills and a quarter fewer threads; PERF.md); the small
//   2-point domains (Ed25519, WrapAir) lose a little to the fewer blocks.
//   A zero norm (x = z on the domain) is masked to 1 in the products and
//   its pair stored as 0, as inv(0) is. x starts as shift w_N^i from the
//   powers w_N^(2^b) and steps by w_N^stride, both from the host.
//
// Every result is canonical and equals the plain torch versions bit for
// bit. Each entry has a plain C interface, launches on the caller's stream
// and returns cudaGetLastError(); the kernels allocate nothing (the
// wrapper allocates the outputs and ood_eval's slice partials).

#include <cstdint>
#include <climits>
#include <type_traits>

#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int MAX_POINTS = 8;  // stark/prover.py: OOD_MAX_POINTS
// stark/prover.py: OOD_MAX_LENGTH and OOD_MAX_SLICE, coefficients a row
// and a slice: a slice's sums (Dot) never wrap
constexpr int64_t MAX_LENGTH = (int64_t(1) << 32) - 1;
constexpr int64_t MAX_SLICE = int64_t(1) << 30;
// ext_powers: a block's threads (so bit 8 of an index is the step) and
// the most powers a thread (stark/prover.py: POW_THREADS, POW_MAX_RUN)
constexpr int POW_THREADS = 256;
constexpr int POW_MAX_RUN = 8;
// ood_eval: stark/prover.py: OOD_TJ, OOD_GROUP_POINTS, OOD_MAX_THREADS
constexpr int TJ = 8;              // coefficients of a row a tile
constexpr int LD = TJ + 2;         // a staged row's stride in words
constexpr int STAGES = 4;          // the ring of tiles in shared memory
constexpr int GROUP_POINTS = 4;    // points a block evaluates, at most
constexpr int MAX_THREADS = 128;   // a block's threads (and rows): 32, 64 or 128
constexpr int SUM_X = 32, SUM_Y = 16;  // the slice sum: outputs by slice lanes a block
constexpr int INV_THREADS = 128;  // deep_inverses: a block's threads

// deep_inverses: the pairs a batch inversion takes, at most (the zero
// mask is one word), and the domain points a thread takes at K opening
// points (stark/prover.py: _deep_inv_points)
constexpr int INV_BATCH = 24;
__host__ __device__ constexpr int inv_points(int K) { return INV_BATCH / K; }

}  // namespace

// stark/prover.py::_PowersArgs, field for field
struct PowersArgs {
    uint64_t pt0[MAX_POINTS];  // the points' c0 and c1
    uint64_t pt1[MAX_POINTS];
    int64_t n_points;
    int64_t n;
    int64_t run;    // powers a thread: 1, 2, 4 or 8; a block's tile is POW_THREADS run
    uint64_t* out;  // (2, n_points, n): every c0, then every c1
};

// stark/prover.py::_OodArgs, field for field. The rows are those of a,
// then those of b (a quotient chunk's c0 and c1 rows, say); each is
// row-major with unit stride along its rows and the given row stride. The
// output holds the rows of a at every point, (2, n_points, n_a), then
// those of b at the first point, (2, n_b): n_out = 2 (n_points n_a + n_b).
struct OodArgs {
    const uint64_t* a;  // (n_a, n)
    int64_t a_ld;
    int64_t n_a;
    const uint64_t* b;  // (n_b, n), or null
    int64_t b_ld;
    int64_t n_b;
    const uint64_t* powers;  // (2, n_points, n), as ext_powers writes them
    int64_t n_points;
    int64_t n;
    int64_t threads;    // a block's threads
    int64_t slice;      // coefficients a slice, a multiple of TJ
    int64_t slices;     // ceil(n / slice)
    uint64_t* partial;  // (slices, n_out) scratch
    uint64_t* out;      // (n_out)
};

// stark/prover.py::_InvArgs, field for field
struct InvArgs {
    uint64_t z0[MAX_POINTS];  // the points' c0 and c1
    uint64_t z1[MAX_POINTS];
    uint64_t wz1[MAX_POINTS];  // W z1^2, the points' norm constants
    uint64_t wpow[32];         // w_N^(2^b)
    uint64_t wstride;          // w_N^stride
    uint64_t wistride;         // w_N^-stride
    uint64_t shift;
    int64_t n_points;
    int64_t N;
    int64_t stride;  // ceil(N / inv_points(n_points)): a thread's points are i, i + stride, ..
    uint64_t* out;   // (2, n_points, N)
};

namespace {

using tmx_ext::E2;

__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__global__ void __launch_bounds__(POW_THREADS) tmx_ext_powers_kernel(PowersArgs a) {
    constexpr int WARPS = POW_THREADS / 32;
    __shared__ uint64_t lane_pow[3][32];      // b^l, prepared (c0, c1, W c1)
    __shared__ uint64_t warp_base[2][WARPS];  // b^(base + 32 w)
    __shared__ uint64_t step[3];              // b^POW_THREADS, prepared
    const int k = blockIdx.y, t = threadIdx.x, lane = t & 31, w = t >> 5;
    const uint64_t base = uint64_t(blockIdx.x) * uint64_t(POW_THREADS * a.run);
    if (w == 0) {
        // x = b^(2^q) (every lane), lp -> b^lane, bb -> b^base
        tmx_ext::P2 x = tmx_ext::prepare(E2{a.pt0[k], a.pt1[k]});
        tmx_ext::P2 b32{}, b64{}, b128{}, st{};
        E2 lp{1, 0}, bb{1, 0};
        const int top = base >> 9 ? 64 - __clzll((long long)base) : 9;  // b^(2^8) is the step
        for (int q = 0; q < top; ++q) {
            if (q < 5 && ((lane >> q) & 1)) lp = tmx_ext::mul_pre(lp, x);
            if ((base >> q) & 1) bb = tmx_ext::mul_pre(bb, x);
            if (q == 5) b32 = x;
            if (q == 6) b64 = x;
            if (q == 7) b128 = x;
            if (q == 8) st = x;
            if (q + 1 < top) x = tmx_ext::sq_pre(x);
        }
        const tmx_ext::P2 l = tmx_ext::prepare(lp);
        lane_pow[0][lane] = l.c0;
        lane_pow[1][lane] = l.c1;
        lane_pow[2][lane] = l.w1;
        if (lane < WARPS) {
            if (lane & 1) bb = tmx_ext::mul_pre(bb, b32);
            if (lane & 2) bb = tmx_ext::mul_pre(bb, b64);
            if (lane & 4) bb = tmx_ext::mul_pre(bb, b128);
            warp_base[0][lane] = bb.c0;
            warp_base[1][lane] = bb.c1;
        }
        if (lane == 0) {
            step[0] = st.c0;
            step[1] = st.c1;
            step[2] = st.w1;
        }
    }
    __syncthreads();
    const tmx_ext::P2 l{lane_pow[0][lane], lane_pow[1][lane], lane_pow[2][lane]};
    const tmx_ext::P2 st{step[0], step[1], step[2]};
    E2 x = tmx_ext::mul_pre(E2{warp_base[0][w], warp_base[1][w]}, l);
    uint64_t* o0 = a.out + k * a.n;
    uint64_t* o1 = a.out + (a.n_points + k) * a.n;
    for (int j = 0; j < a.run; ++j) {
        const int64_t i = int64_t(base) + int64_t(j) * POW_THREADS + t;
        if (i >= a.n) break;
        o0[i] = x.c0;
        o1[i] = x.c1;
        if (j + 1 < a.run) x = tmx_ext::mul_pre(x, st);
    }
}

// cp.async copies from device to shared memory, bypassing the registers:
// `bytes` of the 16 (or 8) read, the rest zero-filled
__device__ __forceinline__ void cp_async16(uint64_t* smem, const uint64_t* gmem, int bytes) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("{\n\t.reg .u64 g;\n\tcvta.to.global.u64 g, %1;\n\tcp.async.cg.shared.global [%0], [g], 16, %2;\n\t}"
                 :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(uint64_t* smem, const uint64_t* gmem, int bytes) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("{\n\t.reg .u64 g;\n\tcvta.to.global.u64 g, %1;\n\tcp.async.ca.shared.global [%0], [g], 8, %2;\n\t}"
                 :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory"); }

__device__ __forceinline__ ulonglong2 lds16(const uint64_t* p) { return *reinterpret_cast<const ulonglong2*>(p); }

// words of one stage of the ring: the rows' tile, then the powers' (c0 of
// each of the block's points, then c1, TJ words each)
template <int NP>
__device__ __host__ __forceinline__ int stage_words(int threads) { return threads * LD + 2 * NP * TJ; }

// the points of point group z: NP of them from z NP, fewer in the last
__device__ __forceinline__ int group_points(const OodArgs& a, int np, int z) {
    const int left = int(a.n_points) - z * np;
    return left < np ? left : np;
}

// A thread's cp.async copies of W words (2: 16 bytes, 1: 8) into each
// stage, fixed for the block: slot m < PER_ROW copies words w .. w + W - 1
// of a row of the rows' tile (PER_ROW copies a row, to consecutive
// threads: a warp reads 32 / PER_ROW rows' TJ words), slots PER_ROW and
// PER_ROW + 1 those of a power row (component c of the block's point k;
// 2 NP PER_ROW <= 2 T copies). A tile offsets the sources; copies past the
// row's end are zero-filled. The powers of a point past the last are not
// copied: their products are never stored.
template <int NP, int W>
struct Copies {
    static constexpr int PER_ROW = TJ / W, SLOTS = PER_ROW + 2;
    const uint64_t* from[SLOTS];  // the row's first word
    // a slot's first word in a stage: to0 + m step for a row's, pto + (m -
    // PER_ROW) (T / PER_ROW) TJ for a power's
    int to0, step, pto;
    int w;           // the first of the thread's words in a tile's row
    unsigned slots;  // bit m: slot m copies

    __device__ __forceinline__ Copies(const OodArgs& a, int64_t r0, int nr, int k0, int T) {
        const int t = threadIdx.x;
        w = (t % PER_ROW) * W;
        to0 = (t / PER_ROW) * LD + w;
        step = (T / PER_ROW) * LD;
        pto = T * LD + (t / PER_ROW) * TJ + w;
        slots = 0;
#pragma unroll
        for (int m = 0; m < PER_ROW; ++m) {
            const int rr = t / PER_ROW + m * (T / PER_ROW);
            const int64_t g = r0 + rr;
            from[m] = a.a;
            if (rr < nr) {
                from[m] = g < a.n_a ? a.a + g * a.a_ld : a.b + (g - a.n_a) * a.b_ld;
                slots |= 1u << m;
            }
        }
#pragma unroll
        for (int m = PER_ROW; m < SLOTS; ++m) {
            const int ck = (t + (m - PER_ROW) * T) / PER_ROW, c = ck / NP, k = k0 + ck % NP;
            from[m] = a.powers;
            if (ck < 2 * NP && k < a.n_points) {
                from[m] = a.powers + (c * a.n_points + k) * a.n;
                slots |= 1u << m;
            }
        }
    }

    // every copy of the tile at coefficient j0 into `stage`
    __device__ __forceinline__ void operator()(const OodArgs& a, uint64_t* stage, int64_t j0, int T) const {
        const int64_t j = j0 + w, left = a.n - j;
        const int bytes = left >= W ? 8 * W : left <= 0 ? 0 : 8 * int(left);
#pragma unroll
        for (int m = 0; m < SLOTS; ++m) {
            if (!((slots >> m) & 1)) continue;
            uint64_t* to = stage + (m < PER_ROW ? to0 + m * step : pto + (m - PER_ROW) * (T / PER_ROW) * TJ);
            if constexpr (W == 2)
                cp_async16(to, bytes ? from[m] + j : from[m], bytes);
            else
                cp_async8(to, bytes ? from[m] + j : from[m], bytes);
        }
    }
};

// A slice's sum of 128-bit products b t in two carry chains: the diagonal
// halves b0 t0 + 2^64 b1 t1 in five 32-bit limbs (w), the cross halves
// b0 t1 + b1 t0 in three at 2^32 (x), added together once (reduce_dot):
// 11 instructions a product and two chains that interleave, where
// goldilocks.cuh's mac takes 13 in one. x holds 2^31 products (MAX_SLICE).
struct Dot {
    uint32_t w[5], x[3];
};

__device__ __forceinline__ void dot_mac(Dot& s, uint64_t b, uint64_t t) {
    const uint32_t b0 = uint32_t(b), b1 = uint32_t(b >> 32), t0 = uint32_t(t), t1 = uint32_t(t >> 32);
    asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %8, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(s.w[0]), "+r"(s.w[1]), "+r"(s.w[2]), "+r"(s.w[3]), "+r"(s.w[4])
        : "r"(b0), "r"(b1), "r"(t0), "r"(t1));
    asm("mad.lo.cc.u32 %0, %3, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %6, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "mad.lo.cc.u32 %0, %4, %5, %0;\n\t"
        "madc.hi.cc.u32 %1, %4, %5, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(s.x[0]), "+r"(s.x[1]), "+r"(s.x[2])
        : "r"(b0), "r"(b1), "r"(t0), "r"(t1));
}

// the canonical value of w + 2^32 x (below 2^160 for up to 2^31 products)
__device__ __forceinline__ uint64_t reduce_dot(const Dot& s) {
    tmx_gl::Acc t{{s.w[0], s.w[1], s.w[2], s.w[3], s.w[4]}};
    asm("add.cc.u32 %0, %0, %4;\n\t"
        "addc.cc.u32 %1, %1, %5;\n\t"
        "addc.cc.u32 %2, %2, %6;\n\t"
        "addc.u32 %3, %3, 0;"
        : "+r"(t.w[1]), "+r"(t.w[2]), "+r"(t.w[3]), "+r"(t.w[4])
        : "r"(s.x[0]), "r"(s.x[1]), "r"(s.x[2]));
    return tmx_gl::reduce(t);
}

// A tile's products for a thread's row at the first KP of the block's NP
// points: x is its row's staged words, pw the powers'. No branch among
// the products, so the compiler interleaves the accumulators' chains.
template <int NP, int KP>
__device__ __forceinline__ void tile_macs(const uint64_t* x, const uint64_t* pw, Dot (&acc)[NP][2]) {
#pragma unroll
    for (int jj = 0; jj < TJ; jj += 2) {
        const ulonglong2 c = lds16(x + jj);
#pragma unroll
        for (int k = 0; k < KP; ++k) {
            const ulonglong2 p0 = lds16(pw + k * TJ + jj), p1 = lds16(pw + (NP + k) * TJ + jj);
            dot_mac(acc[k][0], p0.x, c.x);
            dot_mac(acc[k][0], p0.y, c.y);
            dot_mac(acc[k][1], p1.x, c.x);
            dot_mac(acc[k][1], p1.y, c.y);
        }
    }
}

template <int NP, int W>
__device__ __forceinline__ void ood_block(const OodArgs& a, uint64_t* smem) {
    const int T = blockDim.x, t = threadIdx.x;
    const int64_t rows = a.n_a + a.n_b;
    const int64_t row_blocks = (rows + T - 1) / T;
    const int64_t block_rows = (rows + row_blocks - 1) / row_blocks;
    const int64_t r0 = int64_t(blockIdx.x) * block_rows;
    const int nr = int(rows - r0 < block_rows ? rows - r0 : block_rows);
    const int64_t js = int64_t(blockIdx.y) * a.slice;
    const int64_t je = js + a.slice < a.n ? js + a.slice : a.n;
    const int tiles = int((je - js + TJ - 1) / TJ);
    const int sw = stage_words<NP>(T);
    const int k0 = int(blockIdx.z) * NP, kn = group_points(a, NP, blockIdx.z);
    // the thread's row: of a (kind 1), of b in the first group (kind 2), or
    // none (past the block's rows, or b's in a later group)
    const int64_t g = r0 + t;
    const int kind = t >= nr ? 0 : g < a.n_a ? 1 : blockIdx.z == 0 ? 2 : 0;
    const Copies<NP, W> copy(a, r0, nr, k0, T);

    Dot acc[NP][2];
#pragma unroll
    for (int k = 0; k < NP; ++k) acc[k][0] = acc[k][1] = Dot{};

#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
        if (p < tiles) copy(a, smem + p * sw, js + int64_t(p) * TJ, T);
        cp_async_commit();
    }
    for (int tile = 0; tile < tiles; ++tile) {
        cp_async_wait<STAGES - 2>();  // this thread's copies of the tile have landed
        __syncthreads();              // everyone's, and the slot refilled below is read
        const int next = tile + STAGES - 1;
        if (next < tiles) copy(a, smem + (next % STAGES) * sw, js + int64_t(next) * TJ, T);
        cp_async_commit();
        const uint64_t* buf = smem + (tile % STAGES) * sw;
        if (kind == 1)
            tile_macs<NP, NP>(buf + t * LD, buf + T * LD, acc);
        else if (kind == 2)
            tile_macs<NP, 1>(buf + t * LD, buf + T * LD, acc);
    }

    // partial (slices, n_out): a's rows at (c, k, row), then b's at (c, row)
    uint64_t* p = a.partial + int64_t(blockIdx.y) * 2 * (a.n_points * a.n_a + a.n_b);
    if (kind == 1) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int k = 0; k < NP; ++k)
                if (k < kn) p[(c * a.n_points + k0 + k) * a.n_a + g] = reduce_dot(acc[k][c]);
    } else if (kind == 2) {
        const int64_t gb = 2 * a.n_points * a.n_a + (g - a.n_a);
        p[gb] = reduce_dot(acc[0][0]);
        p[gb + a.n_b] = reduce_dot(acc[0][1]);
    }
}

template <int NP>
__global__ void __launch_bounds__(MAX_THREADS) tmx_ood_kernel(OodArgs a, bool vec) {
    extern __shared__ __align__(16) uint64_t smem[];
    if (vec)
        ood_block<NP, 2>(a, smem);
    else
        ood_block<NP, 1>(a, smem);
}

// out[o] = sum over the slices of partial[s][o]: SUM_X outputs a block,
// SUM_Y lanes of slices each (coalesced along o), then the lanes added
__global__ void __launch_bounds__(SUM_X * SUM_Y) tmx_ood_sum_kernel(OodArgs a) {
    __shared__ uint64_t lane[SUM_Y][SUM_X];
    const int64_t n_out = 2 * (a.n_points * a.n_a + a.n_b);
    const int64_t o = int64_t(blockIdx.x) * SUM_X + threadIdx.x;
    uint64_t s = 0;
    if (o < n_out)
        for (int64_t i = threadIdx.y; i < a.slices; i += SUM_Y) s = tmx_gl::add(s, ld(a.partial + i * n_out + o));
    lane[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && o < n_out) {
#pragma unroll
        for (int y = 1; y < SUM_Y; ++y) s = tmx_gl::add(s, lane[y][threadIdx.x]);
        a.out[o] = s;
    }
}

template <int K>
__global__ void __launch_bounds__(INV_THREADS) tmx_deep_inverses_kernel(InvArgs a) {
    constexpr int J = inv_points(K), B = J * K;
    const int64_t i0 = int64_t(blockIdx.x) * INV_THREADS + threadIdx.x;
    if (i0 >= a.stride) return;
    // x = shift w_N^i0 from the bits of i0, then times w_N^stride a point
    uint64_t x = a.shift;
#pragma unroll
    for (int bit = 0; bit < 32; ++bit)
        if ((uint64_t(i0) >> bit) & 1) x = tmx_gl::mul(x, a.wpow[bit]);
    // up: pair p = (j, k)'s norm n_p (1 past the domain; 0 masked to 1 and
    // flagged) and the products c_p = n_0 .. n_p, below 2^64
    uint64_t n[B], c[B];
    uint32_t zero = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const bool live = i0 + j * a.stride < a.N;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int p = j * K + k;
            const uint64_t d = tmx_gl::sub(x, a.z0[k]);
            const uint64_t m = live ? tmx_gl::sub(tmx_gl::mul(d, d), a.wz1[k]) : 1;
            zero |= uint32_t(m == 0) << p;
            n[p] = m ? m : 1;
            c[p] = p ? tmx_gl::mul_nc(c[p - 1], n[p]) : n[p];
        }
        if (j + 1 < J) x = tmx_gl::mul(x, a.wstride);
    }
    // down: acc = 1 / c_p, so 1 / n_p = acc c_(p-1); x steps back
    uint64_t acc = tmx_gl::inv(tmx_gl::canon(c[B - 1]));
#pragma unroll
    for (int j = J - 1; j >= 0; --j) {
        const int64_t i = i0 + j * a.stride;
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {
            const int p = j * K + k;
            uint64_t r = p ? tmx_gl::mul(acc, c[p - 1]) : tmx_gl::canon(acc);
            if (p) acc = tmx_gl::mul_nc(acc, n[p]);
            r = (zero >> p) & 1 ? 0 : r;
            if (i < a.N) {
                a.out[k * a.N + i] = tmx_gl::mul(tmx_gl::sub(x, a.z0[k]), r);
                a.out[(K + k) * a.N + i] = tmx_gl::mul(a.z1[k], r);
            }
        }
        if (j) x = tmx_gl::mul(x, a.wistride);
    }
}

// the most dynamic shared memory a kernel instance can ask for, set once
// for each instance on each device
template <auto kernel>
cudaError_t allow_smem(size_t bytes) {
    constexpr int MAX_DEVICES = 64;
    static bool done[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

template <int NP>
cudaError_t launch_ood(const OodArgs& a, bool vec, int64_t row_blocks, int groups, cudaStream_t s) {
    cudaError_t err = allow_smem<tmx_ood_kernel<NP>>(sizeof(uint64_t) * STAGES * stage_words<NP>(MAX_THREADS));
    if (err != cudaSuccess) return err;
    const size_t used = sizeof(uint64_t) * STAGES * stage_words<NP>(int(a.threads));
    const dim3 grid((unsigned)row_blocks, (unsigned)a.slices, (unsigned)groups);
    tmx_ood_kernel<NP><<<grid, (unsigned)a.threads, used, s>>>(a, vec);
    return cudaGetLastError();
}

template <int NP>
cudaError_t occupancy(int threads, int* blocks) {
    cudaError_t err = allow_smem<tmx_ood_kernel<NP>>(sizeof(uint64_t) * STAGES * stage_words<NP>(MAX_THREADS));
    if (err != cudaSuccess) return err;
    const size_t bytes = sizeof(uint64_t) * STAGES * stage_words<NP>(threads);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, tmx_ood_kernel<NP>, threads, bytes);
}

// f(NP) for the runtime np (1, 2, 4 .. GROUP_POINTS) as a compile-time
// constant
template <int NP = 1, class F>
cudaError_t with_points(int np, F&& f) {
    if constexpr (NP < GROUP_POINTS)
        if (np > NP) return with_points<2 * NP>(np, f);
    return f(std::integral_constant<int, NP>{});
}

// the point groups of n_points points, and the points a group takes: a
// power of two, the last group's real points fewer where they do not fill
// it (stark/prover.py::_ood_groups)
void point_groups(int64_t n_points, int* groups, int* np) {
    *groups = int((n_points + GROUP_POINTS - 1) / GROUP_POINTS);
    const int64_t each = (n_points + *groups - 1) / *groups;
    for (*np = 1; *np < each; *np *= 2) {
    }
}

}  // namespace

extern "C" int tmx_ext_powers(const PowersArgs* args, void* stream) {
    const PowersArgs& a = *args;
    if (a.n_points < 1 || a.n_points > MAX_POINTS || a.n < 0 || a.n > (int64_t(1) << 32) ||
        !(a.run == 1 || a.run == 2 || a.run == 4 || a.run == POW_MAX_RUN))
        return (int)cudaErrorInvalidValue;
    if (a.n == 0) return 0;
    const int64_t tile = int64_t(POW_THREADS) * a.run;
    const int64_t blocks = (a.n + tile - 1) / tile;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tmx_ext_powers_kernel<<<dim3((unsigned)blocks, (unsigned)a.n_points), POW_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int tmx_ood_eval(const OodArgs* args, void* stream) {
    const OodArgs& a = *args;
    const int64_t rows = a.n_a + a.n_b;
    const bool threads_ok = a.threads == 32 || a.threads == 64 || a.threads == MAX_THREADS;
    if (a.n_points < 1 || a.n_points > MAX_POINTS || a.n_a < 0 || a.n_b < 0 || (a.n_b > 0 && !a.b) ||
        a.n < 1 || a.n > MAX_LENGTH || !threads_ok || a.slice < TJ || a.slice % TJ != 0 || a.slice > MAX_SLICE ||
        a.slices != (a.n + a.slice - 1) / a.slice || a.slices > 65535)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const int64_t row_blocks = (rows + a.threads - 1) / a.threads;
    const int64_t n_out = 2 * (a.n_points * a.n_a + a.n_b);
    const int64_t sum_blocks = (n_out + SUM_X - 1) / SUM_X;
    if (row_blocks > INT_MAX || sum_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    // 16-byte copies when every row and power row starts 16-byte aligned
    const uintptr_t align = uintptr_t(a.a) | uintptr_t(a.a_ld * 8) | uintptr_t(a.powers) | uintptr_t(a.n * 8) |
                            (a.n_b > 0 ? uintptr_t(a.b) | uintptr_t(a.b_ld * 8) : 0);
    const bool vec = (align & 15) == 0;
    const cudaStream_t s = (cudaStream_t)stream;
    int groups, np;
    point_groups(a.n_points, &groups, &np);
    const cudaError_t err =
        with_points(np, [&](auto k) { return launch_ood<decltype(k)::value>(a, vec, row_blocks, groups, s); });
    if (err != cudaSuccess) return (int)err;
    tmx_ood_sum_kernel<<<(unsigned)sum_blocks, dim3(SUM_X, SUM_Y), 0, s>>>(a);
    return (int)cudaGetLastError();
}

// the blocks of `threads` threads of the ood_eval kernel for n_points that
// one SM holds at once (stark/prover.py::_ood_plan sizes the slices by it)
extern "C" int tmx_ood_occupancy(int64_t n_points, int64_t threads, int* blocks) {
    if (n_points < 1 || n_points > MAX_POINTS || !(threads == 32 || threads == 64 || threads == MAX_THREADS))
        return (int)cudaErrorInvalidValue;
    int groups, np;
    point_groups(n_points, &groups, &np);
    return (int)with_points(np, [&](auto k) { return occupancy<decltype(k)::value>(int(threads), blocks); });
}

extern "C" int tmx_deep_inverses(const InvArgs* args, void* stream) {
    const InvArgs& a = *args;
    if (a.n_points < 1 || a.n_points > MAX_POINTS || a.N < 0 || a.N > (int64_t(1) << 32))
        return (int)cudaErrorInvalidValue;
    const int J = inv_points(int(a.n_points));
    if (a.stride != (a.N + J - 1) / J) return (int)cudaErrorInvalidValue;
    if (a.N == 0) return 0;
    const unsigned blocks = unsigned((a.stride + INV_THREADS - 1) / INV_THREADS);
    const cudaStream_t s = (cudaStream_t)stream;
    switch (a.n_points) {
        case 1: tmx_deep_inverses_kernel<1><<<blocks, INV_THREADS, 0, s>>>(a); break;
        case 2: tmx_deep_inverses_kernel<2><<<blocks, INV_THREADS, 0, s>>>(a); break;
        case 3: tmx_deep_inverses_kernel<3><<<blocks, INV_THREADS, 0, s>>>(a); break;
        case 4: tmx_deep_inverses_kernel<4><<<blocks, INV_THREADS, 0, s>>>(a); break;
        case 5: tmx_deep_inverses_kernel<5><<<blocks, INV_THREADS, 0, s>>>(a); break;
        case 6: tmx_deep_inverses_kernel<6><<<blocks, INV_THREADS, 0, s>>>(a); break;
        case 7: tmx_deep_inverses_kernel<7><<<blocks, INV_THREADS, 0, s>>>(a); break;
        default: tmx_deep_inverses_kernel<8><<<blocks, INV_THREADS, 0, s>>>(a); break;
    }
    return (int)cudaGetLastError();
}
