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
// the carry. Chosen over a single pass with decoupled look-back: at 2^15
// rows the second read costs less than a launch, and two plain kernels
// need no tile counter or status words to reset, and no block waits on
// another. Field arithmetic is exact in any order, so every value equals
// the plain torch version's bit for bit.
//
// EvalAir's memory argument (stark/evalair.py, the recursion wrap's second
// statement) has the same shape on four fixed columns: for gamma, delta in
// GF(p^2), at each row the terms
//
//   t_k = m_k / (gamma - (a_k + delta v0_k + delta^2 v1_k)),  k = w, a, b, c
//
// over the trace's value pairs (v0_k, v1_k) and the tape's static address
// and multiplicity rows a_k, m_k, and S = the running sum of tw - ta - tb - tc:
//
//   tmx_eval_terms   a thread a row: its four denominators D_k, their norms
//                    and Y_k = m_k conj(D_k), the four divisions together
//                    by batch_div (a zero norm gives the term 0, as numer *
//                    inv(0) does in the reference), each term straight into
//                    its interleaved (c0, c1) rows 0-7 of the (10, n)
//                    output, and the row's signed sum into a (2, 1, n)
//                    scratch. v0 and v1 are read from the trace's rows in
//                    place (no gathered copy);
//   tmx_eval_scan    S into rows 8-9: the two scan kernels above, over the
//                    one group of four terms.
//
// They replace the XLA programs of tendermintx_tpu/stark/evalair.py:945
// `_eval_terms_kernel`, :966 `_eval_scan_kernel` and :987
// `_eval_assemble_kernel` (the interleaving copy is gone). Bound: bytes. At
// the wrap's 2^17 rows a launch reads 8 trace rows and 8 static rows and
// writes 8 term rows and the scratch's 2 (the scan reads the scratch twice
// and writes S): ~31 MB, ~0.009 ms at 3.35 TB/s, against ~240 32-bit
// multiply-adds a row (0.002 ms). One thread a row keeps every read and
// write coalesced along the rows; batch_div over the row's 4 terms spends
// one inversion on them.
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
    uint64_t* out;        // (10, n): [tw.c0, tw.c1, ..., tc.c1, S.c0, S.c1]
    uint64_t* partial;    // (2, 1, n)
    int64_t tile;         // the scan's rows a tile, a multiple of SCAN_THREADS
    int64_t n_tiles;
    uint64_t* tile_sums;  // (2, n_tiles)
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

// EvalAir's four terms at row r (see the top)
__global__ void __launch_bounds__(THREADS) tmx_eval_terms_kernel(EvalArgs a) {
    const int64_t r = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (r >= a.n) return;
    const E2 g{ld(a.gamma0), ld(a.gamma1)}, d{ld(a.delta0), ld(a.delta1)};
    const E2 e = tmx_ext::mul(d, d);  // delta^2
    uint64_t nrm[EVAL_TERMS];
    E2 y[EVAL_TERMS];
#pragma unroll
    for (int k = 0; k < EVAL_TERMS; ++k) {
        const uint64_t v0 = ld(a.trace + (2 * k) * a.trace_ld + r), v1 = ld(a.trace + (2 * k + 1) * a.trace_ld + r);
        const uint64_t addr = ld(a.rows + k * a.n + r), m = ld(a.rows + (EVAL_TERMS + k) * a.n + r);
        const uint64_t D0 = tmx_gl::sub(tmx_gl::sub(g.c0, addr), dot2(d.c0, v0, e.c0, v1));
        const uint64_t D1 = tmx_gl::sub(g.c1, dot2(d.c1, v0, e.c1, v1));
        const uint64_t nwd1 = tmx_gl::neg(tmx_gl::mul(D1, tmx_ext::W));  // -W D1
        nrm[k] = dot2(D0, D0, nwd1, D1);
        y[k] = E2{tmx_gl::mul(m, D0), tmx_gl::neg(tmx_gl::mul(m, D1))};
    }
    tmx_ext::batch_div(nrm, y);  // m / D, 0 for D = 0
    E2 sum = y[0];
#pragma unroll
    for (int k = 1; k < EVAL_TERMS; ++k) sum = tmx_ext::sub(sum, y[k]);
#pragma unroll
    for (int k = 0; k < EVAL_TERMS; ++k) {
        a.out[(2 * k) * a.n + r] = y[k].c0;
        a.out[(2 * k + 1) * a.n + r] = y[k].c1;
    }
    a.partial[r] = sum.c0;
    a.partial[a.n + r] = sum.c1;
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

extern "C" int tmx_eval_terms(const EvalArgs* args, void* stream) {
    const EvalArgs& a = *args;
    const int64_t blocks = (a.n + THREADS - 1) / THREADS;
    if (a.n < 1 || a.trace_ld < a.n || blocks > INT_MAX || !a.trace || !a.rows || !a.gamma0 || !a.gamma1 ||
        !a.delta0 || !a.delta1 || !a.out || !a.partial)
        return (int)cudaErrorInvalidValue;
    tmx_eval_terms_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The scan of the LogUp statements with the EvalAir output as one group of
// EVAL_TERMS terms and no checked columns: S goes to the rows after the four
// term pairs, as a lookup's follows its n_batches + width.
extern "C" int tmx_eval_scan(const EvalArgs* args, void* stream) {
    const EvalArgs& e = *args;
    LogupArgs a{};
    a.n = e.n;
    a.width = EVAL_TERMS;
    a.span = 1;
    a.group = TERMS;
    a.n_groups = 1;
    a.out = e.out;
    a.partial = e.partial;
    a.tile = e.tile;
    a.n_tiles = e.n_tiles;
    a.tile_sums = e.tile_sums;
    return launch_scan(a, stream);
}
