// The LogUp range-check aux columns of one statement on Hopper
// (stark/lookup.py binds them with ctypes). For a challenge gamma, each
// batch b of BATCH checked trace columns v_i and each table column t_j
// with multiplicities m_j:
//
//   w_b  = sum_i 1/(gamma - v_i) = (sum_i prod_{k != i} d_k) / prod_i d_i,  d_i = gamma - v_i
//   wt_j = m_j / (gamma - t_j),   t_j[r] = j span + r mod span
//   S[r] = sum_{r' <= r} (sum_b w_b[r'] - sum_j wt_j[r'])
//
//   tmx_logup_terms  every w_b and wt_j, straight into their interleaved
//                    (c0, c1) rows of the (2 (n_batches + width + 1), n)
//                    aux output, and each group of terms' signed sum a row
//                    into a (2, groups, n) scratch;
//   tmx_logup_scan   the groups' sums added a row and scanned into S, the
//                    output's last two rows: two kernels, the tiles' sums
//                    into a (2, n_tiles) scratch, then each tile's scan.
//
// Replaces the XLA programs of tendermintx_tpu/stark/lookup.py:400
// `_aux_w_kernel`, :443 `_aux_wt_kernel`, :450 `_aux_scan_kernel` and :474
// `_aux_assemble_kernel` (the interleaving copy is gone: each term is
// stored in its row).
//
// Bound: the terms are operations (Ed25519 at N=128: 447 batches of 4
// cells and 1 table column x 2^15 rows; its reads, 1,789 columns of 2^15,
// are ~0.47 GB). A thread takes TERMS consecutive terms of its group at a
// time and inverts their denominators together: for each term its
// denominator D and numerator U (a checked term's prod d_i and sum_i
// prod_{k != i} d_k, a table term's d and m), then the norm N(D) = D.c0^2
// - W D.c1^2 and Y = U conj(D); the term is Y / N(D), the TERMS divisions
// done at once (ext.cuh: batch_div, one addition-chain inversion and 6
// multiplies a term). A zero norm (D = 0: g1 = 0 and gamma's c0 a cell's
// or a table value) is masked by batch_div, which makes its term 0, as
// numer * inv(0) is in the reference. A checked term's cells all have c1 =
// g1, gamma's c1, so with a_i = gamma.c0 - v_i, s01 = a0 + a1, s23 = a2 +
// a3, x = a0 a1 + W g1^2, y = a2 a3 + W g1^2 and m = s01 s23:
//
//   D = x y + W g1^2 m + g1 (x s23 + y s01) X
//   U = y s01 + x s23 + 2 W g1^2 (s01 + s23) + 2 g1 (x + y + m) X
//
// each sum of products added unreduced in a 160-bit accumulator (mac) and
// reduced once. The last batch, when it has pad cells, takes the
// reference's own form (pad_term, out of line): its pad cells are d = 1
// and (BATCH - real) D is taken out of U. The TERMS values Y and norms
// stay in registers (6 words a term), so four 128-thread blocks fit an SM.
// On an H100 the kernel is bound by the integer ALU pipe: of its ~1,090
// SASS instructions a term, ~680 are IADD3, SEL and ISETP, the carries and
// canonical selects of the field's adds and reductions (PERF.md, PR 12).
//
// The grid is over (rows, groups of terms), a group a multiple of TERMS
// terms, so a 2^15-row trace still gives enough blocks; each thread sums its
// group's terms for its row.
//
// The scan reads only the groups' sums (groups x 2^15 x 16 bytes at
// Ed25519, 4 MB) and writes S: bytes- and launch-bound, so it spreads over
// the card. Reduce-then-scan, in two kernels over tiles of `tile` rows (a
// multiple of SCAN_THREADS, one wave of about 128 tiles at 2^15 rows):
// tmx_logup_tile_sums_kernel adds each tile's rows (a row's groups, then
// the rows) into the scratch; tmx_logup_scan_kernel adds the sums of the
// tiles before its own (a few hundred words from L2, which also holds the
// groups' sums for their second read) and scans its tile a chunk of
// SCAN_THREADS consecutive rows at a time (one a thread, read coalesced):
// a warp-shuffle scan within the warps, then of the warps' totals, plus
// the carry. For these LogUp statements, chosen over a single pass with
// decoupled look-back: at 2^15 rows the second read costs less than a
// launch, and two plain kernels need no tile counter or status words to
// reset, and no block waits on another. Field arithmetic is exact in any
// order, so every value equals the plain torch version's bit for bit.
//
// EvalAir's memory argument (stark/evalair.py, the recursion wrap's second
// statement) has the same shape on four fixed columns: for gamma, delta in
// GF(p^2), at each row the terms
//
//   t_k = m_k / (gamma - (a_k + delta v0_k + delta^2 v1_k)),  k = w, a, b, c
//
// over the trace's value pairs (v0_k, v1_k) and the tape's static address
// and multiplicity rows a_k, m_k, and S = the running sum of tw - ta - tb - tc.
// tmx_eval_aux writes all ten rows [tw, ta, tb, tc, S] of the (10, n)
// output, interleaved (c0, c1), in one launch. It replaces the XLA
// programs of tendermintx_tpu/stark/evalair.py:945 `_eval_terms_kernel`,
// :966 `_eval_scan_kernel` and :987 `_eval_assemble_kernel`.
//
// Bound: bytes. At the wrap's 2^17 rows it reads 8 trace rows and 8 static
// rows and writes 10 rows: 27.3 MB, 0.0081 ms at 3.35 TB/s; the least
// multiplies (one inversion for the launch) take 0.0016 ms. A thread a row
// dividing its 4 terms by one inversion issued ~3,800 SASS integer
// instructions a row, half of them the inversion's 73 serial products, and
// so ran at the integer pipe's rate, 28% of the bound; the scan then took
// two more launches and a (2, n) scratch written once and read twice.
// The design:
//
//   * A thread takes EVAL_ROWS rows, EVAL_THREADS apart (row b EVAL_TILE +
//     j EVAL_THREADS + t for j < EVAL_ROWS), so every load and store stays
//     coalesced, and divides their 4 EVAL_ROWS terms together by one
//     inversion (Montgomery's trick with the multiplicity folded in): on
//     the way up each term's D, its norm N = D0^2 - W D1^2 and u = m times
//     the norms before it; one inversion of the product (goldilocks.cuh's
//     chain on mul_nc's values, canonical once at the end); on the way down
//     c = u / (the norms up to it) = m / N and the term c conj(D): 6 field
//     products a term where m conj(D) first, then batch_div, takes 8. A
//     zero norm (D = 0) is taken as 1 in the product, so the batch's other
//     terms stay exact, and its term c conj(D) is 0, as numer * inv(0) is
//     in the reference. Rows past n take norm 1 and m 0 and are not
//     stored. v0 and v1 are read from the trace's rows in place.
//   * Each row's signed sum tw - ta - tb - tc stays in registers. The block
//     scans its tile in row order: each chunk j (EVAL_THREADS consecutive
//     rows) by a warp-shuffle scan in each warp; the chunks' warp totals,
//     EVAL_ROWS x EVAL_WARPS <= 32 of them, by one shuffle scan of warp 0,
//     which gives the tile's sum. S = the row's scan + the totals before its
//     (chunk, warp) + the sum of every earlier tile.
//   * The sum of the earlier tiles comes in the same pass, by decoupled
//     look-back: each block takes its tile from an atomic counter, so tiles
//     start in order and no block waits on one that has not started; warp
//     0 publishes the tile's sum (status 1) at once, then reads the status
//     of the 32 LOOK_TILES tiles below it at once, waits for those nearer
//     than the nearest that has published its inclusive prefix (status 2)
//     to publish their sums, adds them and that prefix, and publishes its
//     own prefix. At the wrap's 2^17 rows every tile is resident at once
//     and publishes its sum at about the same time, so prefixes are rare
//     when a block looks back: a step of 256 tiles reaches tile 0's in one
//     round trip where windows of 32 took up to 8 in turn. Values
//     go out before their status word by st.release.gpu and are read after
//     it by ld.acquire.gpu. The last block done (a second counter) sets
//     both counters and every status word back to 0, so the scratch is
//     ready for the next launch on the stream with no memset launch.
//     Chosen over a cooperative launch: that needs a grid no larger than
//     the resident blocks, so a block would loop over several tiles and
//     could not keep their row sums in registers across the grid barrier.
//
// EVAL_ROWS = 2 and EVAL_THREADS = 512 were chosen on an H100 (PERF.md, PR
// 20): more rows a thread cut the integer work a row (the inversion's 73
// products shared by 4 EVAL_ROWS terms) but leave fewer warps to hide the
// carry chains' latency: at 2^17 rows 2 rows a thread keep 16 warps an SM,
// 3 and 4 fewer and ran slower, 8 spilled. 512 threads make 128 tiles,
// all resident, which beat 256 and 128 threads at the same warps an SM.
//
// Each entry has a plain C interface, launches on the caller's stream and
// returns cudaGetLastError(); the kernels allocate nothing.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int BATCH = 4;  // stark/lookup.py: BATCH
constexpr int TERMS = 8;  // stark/lookup.py: _LOGUP_TERMS, terms a batch inversion
constexpr int THREADS = 128;  // stark/lookup.py: _LOGUP_THREADS
constexpr int SCAN_THREADS = 256;  // stark/lookup.py: _SCAN_THREADS
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int EVAL_TERMS = 4;  // stark/evalair.py: the w, a, b and c terms
constexpr int EVAL_THREADS = 512;  // stark/evalair.py: EVAL_THREADS
constexpr int EVAL_ROWS = 2;  // stark/evalair.py: EVAL_ROWS, rows a thread
constexpr int EVAL_WARPS = EVAL_THREADS / 32;
constexpr int EVAL_TILE = EVAL_THREADS * EVAL_ROWS;  // rows a block
static_assert(EVAL_ROWS * EVAL_WARPS <= 32, "warp 0 scans the tile's (chunk, warp) totals");
// rows a launch: the tiles are counted and indexed in 32 bits, far inside
constexpr int64_t EVAL_MAX_ROWS = (int64_t(1) << 31) - 1;  // stark/evalair.py: EVAL_MAX_ROWS
// a tile's status word: nothing yet, its sum, its inclusive prefix
constexpr uint32_t TILE_EMPTY = 0, TILE_SUM = 1, TILE_PREFIX = 2;
constexpr int LOOK_TILES = 8;  // tiles a lane reads a look-back step: 256 a step

}  // namespace

// stark/lookup.py::_LogupArgs, field for field
struct LogupArgs {
    const uint64_t* trace;  // (n_cols, n) main trace, unit stride along rows
    int64_t trace_ld;
    const int64_t* checked;  // (n_checked,) column indices
    int64_t n_checked;
    int64_t n_batches;  // ceil(n_checked / BATCH)
    int64_t mult_base;  // the width multiplicity columns start here
    int64_t width;
    int64_t span;              // table rows before the values repeat
    const uint64_t* gamma0;    // gamma's c0 and c1, one word each
    const uint64_t* gamma1;
    int64_t n;                 // rows
    int64_t group;             // terms a thread sums
    int64_t n_groups;          // ceil((n_batches + width) / group)
    uint64_t* out;             // (2 (n_batches + width + 1), n)
    uint64_t* partial;         // (2, n_groups, n)
    int64_t tile;              // the scan's rows a tile, a multiple of SCAN_THREADS
    int64_t n_tiles;           // ceil(n / tile)
    uint64_t* tile_sums;       // (2, n_tiles) scratch of the scan
};

// stark/evalair.py::_EvalArgs, field for field
struct EvalArgs {
    const uint64_t* trace;  // (8, n) main trace: the (c0, c1) rows of OUT, AV, BV, CV
    int64_t trace_ld;
    const uint64_t* rows;   // (8, n) static: addresses aw, aa, ab, ac, then multiplicities m, g_ra, g_rb, g_rc
    const uint64_t* gamma0;  // gamma's and delta's c0 and c1, one word each
    const uint64_t* gamma1;
    const uint64_t* delta0;
    const uint64_t* delta1;
    int64_t n;
    uint64_t* out;     // (10, n): [tw.c0, tw.c1, ..., tc.c1, S.c0, S.c1]
    int64_t n_tiles;   // ceil(n / EVAL_TILE)
    uint32_t* tiles;   // (2 + n_tiles): the tile counter, the done counter, each tile's status; all 0 between launches
    uint64_t* sums;    // (n_tiles, 4): each tile's sum and inclusive prefix, (c0, c1) each
};

namespace {

using tmx_ext::E2;

__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

// the value of checked cell c at row r
__device__ __forceinline__ uint64_t cell(const LogupArgs& a, int64_t c, int64_t r) {
    return ld(a.trace + __ldg(reinterpret_cast<const long long*>(a.checked + c)) * a.trace_ld + r);
}

__device__ __forceinline__ uint64_t dot2(uint64_t a, uint64_t b, uint64_t c, uint64_t d) {
    tmx_gl::Acc s{};
    tmx_gl::mac(s, a, b);
    tmx_gl::mac(s, c, d);
    return tmx_gl::reduce(s);
}

// gamma's parts the terms use
struct Gamma {
    uint64_t g0, g1, wg2;  // wg2 = W g1^2
};

// a term's numerator and denominator
struct Frac {
    E2 U, D;
};

// the last batch t, with pad cells, at row r: d = 1 there, (BATCH - real)
// D taken out of U (the reference's form); one term of the statement, so
// kept out of line (its arguments by value: no stack)
__device__ __noinline__ Frac pad_term(const uint64_t* trace, int64_t trace_ld, const int64_t* checked,
                                      int64_t n_checked, uint64_t g0, uint64_t g1, int64_t t, int64_t r) {
    E2 d[BATCH];
    int real = 0;
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
        const int64_t c = t * BATCH + i;
        if (c < n_checked) {
            const int64_t col = __ldg(reinterpret_cast<const long long*>(checked + c));
            d[i] = E2{tmx_gl::sub(g0, ld(trace + col * trace_ld + r)), g1};
            ++real;
        } else {
            d[i] = E2{1, 0};
        }
    }
    const E2 p01 = tmx_ext::mul(d[0], d[1]), p23 = tmx_ext::mul(d[2], d[3]);
    const E2 D = tmx_ext::mul(p01, p23);
    const E2 U = tmx_ext::add(tmx_ext::mul(p23, tmx_ext::add(d[0], d[1])), tmx_ext::mul(p01, tmx_ext::add(d[2], d[3])));
    return Frac{tmx_ext::sub(U, tmx_ext::scale(D, uint64_t(BATCH - real))), D};
}

// batch t's numerator U and denominator D at row r (see the top)
__device__ __forceinline__ Frac batch_term(const LogupArgs& a, const Gamma& g, int64_t t, int64_t r) {
    const int64_t c0 = t * BATCH;
    if (c0 + BATCH > a.n_checked) return pad_term(a.trace, a.trace_ld, a.checked, a.n_checked, g.g0, g.g1, t, r);
    uint64_t x[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) x[i] = tmx_gl::sub(g.g0, cell(a, c0 + i, r));
    const uint64_t s01 = tmx_gl::add(x[0], x[1]), s23 = tmx_gl::add(x[2], x[3]);
    const uint64_t p = tmx_gl::add(tmx_gl::mul(x[0], x[1]), g.wg2);
    const uint64_t q = tmx_gl::add(tmx_gl::mul(x[2], x[3]), g.wg2);
    const uint64_t m = tmx_gl::mul(s01, s23);
    tmx_gl::Acc u{};
    tmx_gl::mac(u, q, s01);
    tmx_gl::mac(u, p, s23);
    tmx_gl::mac(u, tmx_gl::add(g.wg2, g.wg2), tmx_gl::add(s01, s23));
    return Frac{E2{tmx_gl::reduce(u), tmx_gl::mul(tmx_gl::add(g.g1, g.g1), tmx_gl::add(tmx_gl::add(p, q), m))},
                E2{dot2(p, q, g.wg2, m), tmx_gl::mul(g.g1, dot2(p, s23, q, s01))}};
}

__global__ void __launch_bounds__(THREADS) tmx_logup_terms_kernel(LogupArgs a) {
    const int64_t r = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (r >= a.n) return;
    Gamma g;
    g.g0 = ld(a.gamma0);
    g.g1 = ld(a.gamma1);
    g.wg2 = tmx_gl::mul(tmx_gl::mul(g.g1, g.g1), tmx_ext::W);
    const int64_t terms = a.n_batches + a.width;
    const int64_t t0 = int64_t(blockIdx.y) * a.group;
    const int64_t t1 = t0 + a.group < terms ? t0 + a.group : terms;
    const uint64_t tr = uint64_t(r % a.span);  // a table column's value is j span + tr
    E2 sum{0, 0};
    for (int64_t u0 = t0; u0 < t1; u0 += TERMS) {
        // each term's Y = U conj(D) and N(D); 1 in a slot past the group
        E2 y[TERMS];
        uint64_t nrm[TERMS];
#pragma unroll
        for (int q = 0; q < TERMS; ++q) {
            const int64_t t = u0 + q;
            if (t >= t1) {
                y[q] = E2{0, 0};
                nrm[q] = 1;
                continue;
            }
            Frac f;
            if (t < a.n_batches) {
                f = batch_term(a, g, t, r);
            } else {
                const int64_t j = t - a.n_batches;
                f.U = E2{ld(a.trace + (a.mult_base + j) * a.trace_ld + r), 0};
                f.D = E2{tmx_gl::sub(g.g0, uint64_t(j) * uint64_t(a.span) + tr), g.g1};
            }
            const uint64_t nwd1 = tmx_gl::neg(tmx_gl::mul(f.D.c1, tmx_ext::W));  // -W D1
            nrm[q] = dot2(f.D.c0, f.D.c0, nwd1, f.D.c1);
            y[q] = E2{dot2(f.U.c0, f.D.c0, f.U.c1, nwd1), dot2(f.U.c1, f.D.c0, f.U.c0, tmx_gl::neg(f.D.c1))};
        }
        tmx_ext::batch_div(nrm, y);  // Y / N(D), 0 for D = 0
#pragma unroll
        for (int q = 0; q < TERMS; ++q) {
            const int64_t t = u0 + q;
            if (t >= t1) break;
            const E2 v = y[q];
            sum = t < a.n_batches ? tmx_ext::add(sum, v) : tmx_ext::sub(sum, v);
            a.out[(2 * t) * a.n + r] = v.c0;
            a.out[(2 * t + 1) * a.n + r] = v.c1;
        }
    }
    a.partial[blockIdx.y * a.n + r] = sum.c0;
    a.partial[(a.n_groups + blockIdx.y) * a.n + r] = sum.c1;
}

// the row's sum over the groups
__device__ __forceinline__ E2 row_diff(const LogupArgs& a, int64_t r) {
    E2 d{0, 0};
    for (int64_t g = 0; g < a.n_groups; ++g)
        d = tmx_ext::add(d, E2{ld(a.partial + g * a.n + r), ld(a.partial + (a.n_groups + g) * a.n + r)});
    return d;
}

__device__ __forceinline__ E2 shfl_up(E2 v, int off) {
    return E2{__shfl_up_sync(0xFFFFFFFFu, (unsigned long long)v.c0, off),
              __shfl_up_sync(0xFFFFFFFFu, (unsigned long long)v.c1, off)};
}

__device__ __forceinline__ E2 shfl_xor(E2 v, int mask) {
    return E2{__shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)v.c0, mask),
              __shfl_xor_sync(0xFFFFFFFFu, (unsigned long long)v.c1, mask)};
}

// the block's sum of every thread's v, in every thread
__device__ __forceinline__ E2 block_sum(E2 v, uint64_t (&w0)[SCAN_WARPS], uint64_t (&w1)[SCAN_WARPS]) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int m = 16; m; m >>= 1) v = tmx_ext::add(v, shfl_xor(v, m));
    if (lane == 0) {
        w0[warp] = v.c0;
        w1[warp] = v.c1;
    }
    __syncthreads();
    E2 s{0, 0};
#pragma unroll
    for (int i = 0; i < SCAN_WARPS; ++i) s = tmx_ext::add(s, E2{w0[i], w1[i]});
    return s;
}

// tile_sums[b] = the sum over tile b's rows of their groups' sums
__global__ void __launch_bounds__(SCAN_THREADS) tmx_logup_tile_sums_kernel(LogupArgs a) {
    __shared__ uint64_t w0[SCAN_WARPS], w1[SCAN_WARPS];
    const int64_t r0 = int64_t(blockIdx.x) * a.tile;
    const int64_t r1 = r0 + a.tile < a.n ? r0 + a.tile : a.n;
    E2 v{0, 0};
    for (int64_t r = r0 + threadIdx.x; r < r1; r += SCAN_THREADS) v = tmx_ext::add(v, row_diff(a, r));
    const E2 s = block_sum(v, w0, w1);
    if (threadIdx.x == 0) {
        a.tile_sums[blockIdx.x] = s.c0;
        a.tile_sums[a.n_tiles + blockIdx.x] = s.c1;
    }
}

// S over tile b's rows: the tiles before it summed, then its chunks scanned
__global__ void __launch_bounds__(SCAN_THREADS) tmx_logup_scan_kernel(LogupArgs a) {
    __shared__ uint64_t w0[SCAN_WARPS], w1[SCAN_WARPS];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int64_t terms = a.n_batches + a.width;
    uint64_t* s0 = a.out + (2 * terms) * a.n;
    uint64_t* s1 = a.out + (2 * terms + 1) * a.n;
    E2 c{0, 0};
    for (int64_t t = threadIdx.x; t < blockIdx.x; t += SCAN_THREADS)
        c = tmx_ext::add(c, E2{ld(a.tile_sums + t), ld(a.tile_sums + a.n_tiles + t)});
    E2 carry = block_sum(c, w0, w1);  // the sum of every row before this chunk
    __syncthreads();                  // the warps' sums are read before the chunks write them
    const int64_t r0 = int64_t(blockIdx.x) * a.tile;
    const int64_t r1 = r0 + a.tile < a.n ? r0 + a.tile : a.n;
    for (int64_t base = r0; base < r1; base += SCAN_THREADS) {
        const int64_t r = base + threadIdx.x;
        E2 x = r < r1 ? row_diff(a, r) : E2{0, 0};
        // inclusive scan within the warp, then of the warps' totals
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const E2 y = shfl_up(x, off);
            if (lane >= off) x = tmx_ext::add(x, y);
        }
        if (lane == 31) {
            w0[warp] = x.c0;
            w1[warp] = x.c1;
        }
        __syncthreads();
        if (warp == 0) {
            E2 t = lane < SCAN_WARPS ? E2{w0[lane], w1[lane]} : E2{0, 0};
#pragma unroll
            for (int off = 1; off < SCAN_WARPS; off <<= 1) {
                const E2 y = shfl_up(t, off);
                if (lane >= off) t = tmx_ext::add(t, y);
            }
            if (lane < SCAN_WARPS) {
                w0[lane] = t.c0;
                w1[lane] = t.c1;
            }
        }
        __syncthreads();
        if (warp > 0) x = tmx_ext::add(x, E2{w0[warp - 1], w1[warp - 1]});
        x = tmx_ext::add(x, carry);
        if (r < r1) {
            s0[r] = x.c0;
            s1[r] = x.c1;
        }
        carry = tmx_ext::add(carry, E2{w0[SCAN_WARPS - 1], w1[SCAN_WARPS - 1]});
        __syncthreads();  // the warps' totals are read before the next chunk writes them
    }
}

__device__ __forceinline__ uint64_t ldcg(const uint64_t* p) {
    return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// a c for c < 2^32, canonical: the 96-bit product lo + 2^64 hi (hi < c)
// is lo + hi (2^32 - 1), and hi (2^32 - 1) < p
__device__ __forceinline__ uint64_t mul_small(uint64_t a, uint32_t c) {
    return tmx_gl::add(tmx_gl::canon(a * c), __umul64hi(a, c) * tmx_gl::EPS);
}

// x^(2^K) by mul_nc
template <int K>
__device__ __forceinline__ uint64_t sqn_nc(uint64_t x) {
#pragma unroll
    for (int i = 0; i < K; ++i) x = tmx_gl::mul_nc(x, x);
    return x;
}

// 1/a, and 0 for 0: goldilocks.cuh's inv chain on mul_nc's values, which
// stay below 2^64, made canonical once at the end (the power is unique)
__device__ __forceinline__ uint64_t inv_nc(uint64_t a) {
    const uint64_t t2 = tmx_gl::mul_nc(sqn_nc<1>(a), a);
    const uint64_t t4 = tmx_gl::mul_nc(sqn_nc<2>(t2), t2);
    const uint64_t t8 = tmx_gl::mul_nc(sqn_nc<4>(t4), t4);
    const uint64_t t16 = tmx_gl::mul_nc(sqn_nc<8>(t8), t8);
    const uint64_t t24 = tmx_gl::mul_nc(sqn_nc<8>(t16), t8);
    const uint64_t t28 = tmx_gl::mul_nc(sqn_nc<4>(t24), t4);
    const uint64_t t30 = tmx_gl::mul_nc(sqn_nc<2>(t28), t2);
    const uint64_t t31 = tmx_gl::mul_nc(sqn_nc<1>(t30), a);
    const uint64_t v = sqn_nc<1>(t31);  // a^(2^32 - 2)
    return tmx_gl::canon(tmx_gl::mul_nc(sqn_nc<32>(v), tmx_gl::mul_nc(v, a)));
}

// the inclusive scan of x over the warp's lanes
__device__ __forceinline__ E2 warp_scan(E2 x, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const E2 y = shfl_up(x, off);
        if (lane >= off) x = tmx_ext::add(x, y);
    }
    return x;
}

// The sum of every row before tile `tile` > 0, in every lane of the warp.
// A step reads the status of the 32 LOOK_TILES tiles below `top` at once
// (lane l the tiles top - l - 32 i), finds the nearest that has published
// its inclusive prefix (before tile 0, a prefix of 0), waits until every
// nearer tile has published its sum, and adds those sums and that prefix;
// with no prefix among them, it waits for all and adds all, and steps down.
__device__ E2 look_back(const EvalArgs& a, int64_t tile, int lane) {
    constexpr int SPAN = 32 * LOOK_TILES;
    const uint32_t* status = a.tiles + 2;
    E2 before{0, 0};
    for (int64_t top = tile - 1;; top -= SPAN) {
        uint32_t s[LOOK_TILES];
#pragma unroll
        for (int i = 0; i < LOOK_TILES; ++i) {
            const int64_t p = top - lane - 32 * i;
            s[i] = p < 0 ? TILE_PREFIX : ld_acquire(status + p);
        }
        int stop;  // the nearest prefix's distance below top, SPAN for none
        for (;;) {
            stop = SPAN;
#pragma unroll
            for (int i = LOOK_TILES - 1; i >= 0; --i) {
                const unsigned b = __ballot_sync(0xFFFFFFFFu, s[i] == TILE_PREFIX);
                if (b) stop = 32 * i + __ffs(b) - 1;
            }
            bool wait = false;
#pragma unroll
            for (int i = 0; i < LOOK_TILES; ++i) wait |= s[i] == TILE_EMPTY && 32 * i + lane < stop;
            if (!__any_sync(0xFFFFFFFFu, wait)) break;
#pragma unroll
            for (int i = 0; i < LOOK_TILES; ++i)
                if (s[i] == TILE_EMPTY && 32 * i + lane < stop) s[i] = ld_acquire(status + top - lane - 32 * i);
        }
        E2 v{0, 0};
#pragma unroll
        for (int i = 0; i < LOOK_TILES; ++i) {
            const int dist = 32 * i + lane;
            const int64_t p = top - dist;
            if (p >= 0 && dist <= stop) {
                const uint64_t* w = a.sums + 4 * p + (dist == stop ? 2 : 0);
                v = tmx_ext::add(v, E2{ldcg(w), ldcg(w + 1)});
            }
        }
#pragma unroll
        for (int m = 16; m; m >>= 1) v = tmx_ext::add(v, shfl_xor(v, m));
        before = tmx_ext::add(before, v);
        if (stop < SPAN) return before;
    }
}

// EvalAir's ten aux rows over one tile of EVAL_TILE rows (see the top)
__global__ void __launch_bounds__(EVAL_THREADS) tmx_eval_aux_kernel(EvalArgs a) {
    constexpr int CHUNKS = EVAL_ROWS * EVAL_WARPS;
    __shared__ uint64_t tot0[CHUNKS], tot1[CHUNKS];  // each (chunk, warp)'s total, then the sum before it
    __shared__ uint64_t before0, before1;            // the sum of every row before the tile
    __shared__ uint32_t tile_s, last_s;
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    if (t == 0) tile_s = atomicAdd(a.tiles, 1u);  // tiles start in order
    __syncthreads();
    const int64_t tile = tile_s;
    const int64_t r0 = tile * EVAL_TILE + t;  // chunk j's row: r0 + j EVAL_THREADS
    const E2 g{ld(a.gamma0), ld(a.gamma1)}, d{ld(a.delta0), ld(a.delta1)};
    const E2 e = tmx_ext::mul(d, d);  // delta^2
    // each term's D, N(D) and, on the way up, m times the norms before it
    constexpr int Q = EVAL_ROWS * EVAL_TERMS;
    uint64_t D0[Q], D1[Q], nrm[Q], u[Q];
    uint64_t pre = 1;  // the product of the norms so far, below 2^64
#pragma unroll
    for (int j = 0; j < EVAL_ROWS; ++j) {
        const int64_t r = r0 + j * EVAL_THREADS;
#pragma unroll
        for (int k = 0; k < EVAL_TERMS; ++k) {
            const int q = j * EVAL_TERMS + k;
            uint64_t m = 0;
            D0[q] = D1[q] = 0;
            nrm[q] = 1;  // rows past n: N 1, m 0
            if (r < a.n) {
                const uint64_t v0 = ld(a.trace + (2 * k) * a.trace_ld + r);
                const uint64_t v1 = ld(a.trace + (2 * k + 1) * a.trace_ld + r);
                const uint64_t addr = ld(a.rows + k * a.n + r);
                m = ld(a.rows + (EVAL_TERMS + k) * a.n + r);
                D0[q] = tmx_gl::sub(tmx_gl::sub(g.c0, addr), dot2(d.c0, v0, e.c0, v1));
                D1[q] = tmx_gl::sub(g.c1, dot2(d.c1, v0, e.c1, v1));
                nrm[q] = dot2(D0[q], D0[q], tmx_gl::neg(mul_small(D1[q], tmx_ext::W)), D1[q]);
                if (nrm[q] == 0) nrm[q] = 1;  // D = 0: the term c conj(D) is 0, the batch's others exact
            }
            u[q] = q ? tmx_gl::mul_nc(m, pre) : m;
            pre = q ? tmx_gl::mul_nc(pre, nrm[q]) : nrm[q];
        }
    }
    // on the way down, acc = 1 / (N_0 ... N_q): m_q / N_q = u_q acc, and the
    // term m_q conj(D_q) / N(D_q)
    uint64_t acc = inv_nc(pre);
    E2 y[Q];
#pragma unroll
    for (int q = Q - 1; q >= 0; --q) {
        const uint64_t c = tmx_gl::mul_nc(u[q], acc);
        if (q) acc = tmx_gl::mul_nc(acc, nrm[q]);
        y[q] = E2{tmx_gl::mul(c, D0[q]), tmx_gl::neg(tmx_gl::mul(c, D1[q]))};
    }
    E2 s[EVAL_ROWS];  // each row's tw - ta - tb - tc, then its scan over the warp's rows of the chunk
#pragma unroll
    for (int j = 0; j < EVAL_ROWS; ++j) {
        const int64_t r = r0 + j * EVAL_THREADS;
        const int q = j * EVAL_TERMS;
        s[j] = tmx_ext::sub(tmx_ext::sub(tmx_ext::sub(y[q], y[q + 1]), y[q + 2]), y[q + 3]);
        if (r < a.n) {
#pragma unroll
            for (int k = 0; k < EVAL_TERMS; ++k) {
                a.out[(2 * k) * a.n + r] = y[q + k].c0;
                a.out[(2 * k + 1) * a.n + r] = y[q + k].c1;
            }
        }
        s[j] = warp_scan(s[j], lane);
        if (lane == 31) {
            tot0[j * EVAL_WARPS + warp] = s[j].c0;
            tot1[j * EVAL_WARPS + warp] = s[j].c1;
        }
    }
    __syncthreads();
    if (warp == 0) {
        const E2 x = warp_scan(lane < CHUNKS ? E2{tot0[lane], tot1[lane]} : E2{0, 0}, lane);
        const E2 sum{__shfl_sync(0xFFFFFFFFu, (unsigned long long)x.c0, 31),
                     __shfl_sync(0xFFFFFFFFu, (unsigned long long)x.c1, 31)};  // the tile's
        const E2 prev = shfl_up(x, 1);
        if (lane < CHUNKS) {
            tot0[lane] = lane ? prev.c0 : 0;
            tot1[lane] = lane ? prev.c1 : 0;
        }
        E2 before{0, 0};
        if (tile > 0) {
            if (lane == 0) {
                a.sums[4 * tile] = sum.c0;
                a.sums[4 * tile + 1] = sum.c1;
                st_release(a.tiles + 2 + tile, TILE_SUM);
            }
            before = look_back(a, tile, lane);
        }
        if (lane == 0) {
            const E2 incl = tmx_ext::add(before, sum);
            a.sums[4 * tile + 2] = incl.c0;
            a.sums[4 * tile + 3] = incl.c1;
            st_release(a.tiles + 2 + tile, TILE_PREFIX);
            before0 = before.c0;
            before1 = before.c1;
            __threadfence();  // this block's reads and publications come before its count
            last_s = atomicAdd(a.tiles + 1, 1u) == uint32_t(a.n_tiles - 1);
            __threadfence();
        }
    }
    __syncthreads();
    const E2 before{before0, before1};
#pragma unroll
    for (int j = 0; j < EVAL_ROWS; ++j) {
        const int64_t r = r0 + j * EVAL_THREADS;
        if (r < a.n) {
            const int c = j * EVAL_WARPS + warp;
            const E2 S = tmx_ext::add(tmx_ext::add(s[j], E2{tot0[c], tot1[c]}), before);
            a.out[(2 * EVAL_TERMS) * a.n + r] = S.c0;
            a.out[(2 * EVAL_TERMS + 1) * a.n + r] = S.c1;
        }
    }
    if (last_s) {  // every block is past its look-back: reset the scratch for the next launch
        for (int64_t i = t; i < a.n_tiles; i += EVAL_THREADS) a.tiles[2 + i] = TILE_EMPTY;
        if (t == 0) a.tiles[0] = a.tiles[1] = 0;
    }
}

bool valid(const LogupArgs& a) {
    return a.n >= 1 && a.n_checked >= 0 && a.n_batches == (a.n_checked + BATCH - 1) / BATCH && a.width >= 0 &&
           a.span >= 1 && a.group >= 1 && a.group % TERMS == 0 &&
           a.n_groups == (a.n_batches + a.width + a.group - 1) / a.group && a.n_groups >= 1 && a.n_groups <= 65535;
}

}  // namespace

extern "C" int tmx_logup_terms(const LogupArgs* args, void* stream) {
    const LogupArgs& a = *args;
    if (!valid(a)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (a.n + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tmx_logup_terms_kernel<<<dim3((unsigned)blocks, (unsigned)a.n_groups), THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

namespace {

int launch_scan(const LogupArgs& a, void* stream) {
    if (!valid(a) || !a.tile_sums || a.tile < SCAN_THREADS || a.tile % SCAN_THREADS != 0 ||
        a.n_tiles != (a.n + a.tile - 1) / a.tile || a.n_tiles > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    tmx_logup_tile_sums_kernel<<<(unsigned)a.n_tiles, SCAN_THREADS, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tmx_logup_scan_kernel<<<(unsigned)a.n_tiles, SCAN_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tmx_logup_scan(const LogupArgs* args, void* stream) { return launch_scan(*args, stream); }

extern "C" int tmx_eval_aux(const EvalArgs* args, void* stream) {
    const EvalArgs& a = *args;
    if (a.n < 1 || a.n > EVAL_MAX_ROWS || a.trace_ld < a.n || a.n_tiles != (a.n + EVAL_TILE - 1) / EVAL_TILE ||
        !a.trace || !a.rows || !a.gamma0 || !a.gamma1 || !a.delta0 || !a.delta1 || !a.out || !a.tiles || !a.sums)
        return (int)cudaErrorInvalidValue;
    tmx_eval_aux_kernel<<<(unsigned)a.n_tiles, EVAL_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
