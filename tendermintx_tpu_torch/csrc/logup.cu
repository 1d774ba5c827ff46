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
//                    output's last two rows.
//
// Replaces the XLA programs of tendermintx_tpu/stark/lookup.py:400
// `_aux_w_kernel`, :443 `_aux_wt_kernel`, :450 `_aux_scan_kernel` and :474
// `_aux_assemble_kernel` (the interleaving copy is gone: each term is
// stored in its row).
//
// Bound: the terms are operations (Ed25519 at N=128: 447 batches x 2^15
// rows, each one extension inversion, ~75 multiplies, and ~30 more; its
// reads, 1,789 columns of 2^15, are ~0.47 GB). The grid is over (rows,
// groups of terms), so a 2^15-row trace still gives enough blocks; a
// thread computes its group's terms for one row and sums them, and the
// pad rule of the last batch is the reference's: its missing cells are
// d = 1 and their numerator terms (pad denom) are taken out. The scan
// reads only the groups' sums (groups x 2^15 x 16 bytes) in one block of
// SCAN_THREADS threads, a chunk of SCAN_THREADS consecutive rows at a
// time (one a thread, read coalesced): a warp-shuffle scan within the
// warps, then of the warps' totals, plus the chunks before it. Field
// addition is exact in any order, so every value equals the plain torch
// version's bit for bit. One inversion a term, not a Montgomery batch: inv(0) = 0 needs
// no special case.
//
// Each entry has a plain C interface, launches on the caller's stream and
// returns cudaGetLastError(); the kernels allocate nothing.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int BATCH = 4;  // stark/lookup.py: BATCH
constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 1024;

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
};

namespace {

using tmx_ext::E2;

__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__global__ void __launch_bounds__(THREADS) tmx_logup_terms_kernel(LogupArgs a) {
    const int64_t r = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (r >= a.n) return;
    const E2 gamma{ld(a.gamma0), ld(a.gamma1)};
    const int64_t terms = a.n_batches + a.width;
    const int64_t t0 = int64_t(blockIdx.y) * a.group;
    const int64_t t1 = t0 + a.group < terms ? t0 + a.group : terms;
    E2 sum{0, 0};
    for (int64_t t = t0; t < t1; ++t) {
        E2 v;
        if (t < a.n_batches) {
            E2 d[BATCH];
            int real = 0;
#pragma unroll
            for (int i = 0; i < BATCH; ++i) {
                const int64_t c = t * BATCH + i;
                if (c < a.n_checked) {
                    const uint64_t x = ld(a.trace + __ldg(reinterpret_cast<const long long*>(a.checked + c)) * a.trace_ld + r);
                    d[i] = E2{tmx_gl::sub(gamma.c0, x), gamma.c1};
                    ++real;
                } else {
                    d[i] = E2{1, 0};  // a pad cell of the last batch
                }
            }
            const E2 p01 = tmx_ext::mul(d[0], d[1]), p23 = tmx_ext::mul(d[2], d[3]);
            const E2 denom = tmx_ext::mul(p01, p23);
            E2 numer = tmx_ext::add(tmx_ext::mul(p23, tmx_ext::add(d[0], d[1])), tmx_ext::mul(p01, tmx_ext::add(d[2], d[3])));
            // each pad cell added prod_{k != i} d_k = denom
            if (real < BATCH) numer = tmx_ext::sub(numer, tmx_ext::scale(denom, uint64_t(BATCH - real)));
            v = tmx_ext::mul(numer, tmx_ext::inv(denom));
            sum = tmx_ext::add(sum, v);
        } else {
            const int64_t j = t - a.n_batches;
            const uint64_t tv = uint64_t(j * a.span + r % a.span);
            const uint64_t m = ld(a.trace + (a.mult_base + j) * a.trace_ld + r);
            v = tmx_ext::scale(tmx_ext::inv(E2{tmx_gl::sub(gamma.c0, tv), gamma.c1}), m);
            sum = tmx_ext::sub(sum, v);
        }
        a.out[(2 * t) * a.n + r] = v.c0;
        a.out[(2 * t + 1) * a.n + r] = v.c1;
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

__global__ void __launch_bounds__(SCAN_THREADS) tmx_logup_scan_kernel(LogupArgs a) {
    __shared__ uint64_t w0[SCAN_THREADS / 32], w1[SCAN_THREADS / 32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int64_t terms = a.n_batches + a.width;
    uint64_t* s0 = a.out + (2 * terms) * a.n;
    uint64_t* s1 = a.out + (2 * terms + 1) * a.n;
    E2 carry{0, 0};  // the sum of every row before this chunk
    for (int64_t base = 0; base < a.n; base += SCAN_THREADS) {
        const int64_t r = base + threadIdx.x;
        E2 x = r < a.n ? row_diff(a, r) : E2{0, 0};
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
            E2 t = E2{w0[lane], w1[lane]};
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const E2 y = shfl_up(t, off);
                if (lane >= off) t = tmx_ext::add(t, y);
            }
            w0[lane] = t.c0;
            w1[lane] = t.c1;
        }
        __syncthreads();
        if (warp > 0) x = tmx_ext::add(x, E2{w0[warp - 1], w1[warp - 1]});
        x = tmx_ext::add(x, carry);
        if (r < a.n) {
            s0[r] = x.c0;
            s1[r] = x.c1;
        }
        carry = tmx_ext::add(carry, E2{w0[SCAN_THREADS / 32 - 1], w1[SCAN_THREADS / 32 - 1]});
        __syncthreads();  // the warps' totals are read before the next chunk writes them
    }
}

bool valid(const LogupArgs& a) {
    return a.n >= 1 && a.n_checked >= 0 && a.n_batches == (a.n_checked + BATCH - 1) / BATCH && a.width >= 0 &&
           a.span >= 1 && a.group >= 1 && a.n_groups == (a.n_batches + a.width + a.group - 1) / a.group &&
           a.n_groups >= 1 && a.n_groups <= 65535;
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

extern "C" int tmx_logup_scan(const LogupArgs* args, void* stream) {
    const LogupArgs& a = *args;
    if (!valid(a)) return (int)cudaErrorInvalidValue;
    tmx_logup_scan_kernel<<<1, SCAN_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
