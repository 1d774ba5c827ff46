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
//   for it: at the statements' sizes (up to 8 x 2^18 elements) a launch's
//   floor. Each thread builds RUN consecutive powers: the first by square
//   and multiply, the rest by one multiply each. Field arithmetic is exact,
//   so every power equals the sequential product's.
// - ood_eval reads each coefficient once for all points (Ed25519 at N=128:
//   2,929 rows x 2^15, 768 MB) and does two 64 x 64 products a coefficient
//   a point. A block takes ROWS rows (one a thread) over one slice of the
//   row length; each tile of TJ coefficients of its rows is staged in
//   shared memory by coalesced loads (row stride TJ + 1 words: no bank
//   conflict when each thread reads its own row), with the points' powers
//   of the tile beside it, read as broadcasts. The products are summed
//   unreduced in 160-bit accumulators (goldilocks.cuh: Acc, mac, reduce),
//   reduced once a slice; a second kernel sums the slices' canonical
//   partials, a warp an output (field adds, exact in any order). The slice count gives the
//   few-row statements (SHA-256: 176 rows x 2^16) enough blocks.
// - deep_inverses writes 16 bytes a (point, x) pair and inverts one
//   extension value for it: a norm, one base inversion by an addition chain
//   of 73 multiplies (goldilocks.cuh: inv), and three multiplies; x comes
//   from the powers w_N^(2^b) the caller passes. One inversion an element,
//   not a Montgomery batch: inv(0) = 0 needs no special case.
//
// Every result is canonical and equals the plain torch versions bit for
// bit. Each entry has a plain C interface, launches on the caller's stream
// and returns cudaGetLastError(); the kernels allocate nothing (the
// wrapper allocates the outputs and ood_eval's slice partials).

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int MAX_POINTS = 8;  // stark/prover.py: OOD_MAX_POINTS
// stark/prover.py: OOD_MAX_LENGTH, coefficients a row: a slice's 160-bit
// sums (below 2^32 products under 2^128 each) never wrap
constexpr int64_t MAX_LENGTH = (int64_t(1) << 32) - 1;
constexpr int RUN = 16;        // ext_powers: consecutive powers a thread
constexpr int THREADS = 128;
constexpr int ROWS = THREADS;  // ood_eval: rows a block, one a thread
constexpr int TJ = 32;         // ood_eval: coefficients of a row a tile
constexpr int SUM_THREADS = 256;

}  // namespace

// stark/prover.py::_PowersArgs, field for field
struct PowersArgs {
    uint64_t pt0[MAX_POINTS];  // the points' c0 and c1
    uint64_t pt1[MAX_POINTS];
    int64_t n_points;
    int64_t n;
    uint64_t* out;  // (2, n_points, n): every c0, then every c1
};

// stark/prover.py::_OodArgs, field for field. The rows are those of a,
// then those of b (a quotient chunk's c0 and c1 rows, say); each is
// row-major with unit stride along its rows and the given row stride.
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
    int64_t slices;     // the row length cut into this many slices
    uint64_t* partial;  // (slices, 2, n_points, n_a + n_b) scratch
    uint64_t* out;      // (2, n_points, n_a + n_b)
};

// stark/prover.py::_InvArgs, field for field
struct InvArgs {
    uint64_t z0[MAX_POINTS];  // the points' c0 and c1
    uint64_t z1[MAX_POINTS];
    uint64_t wpow[32];  // w_N^(2^b)
    uint64_t shift;
    int64_t n_points;
    int64_t N;
    uint64_t* out;  // (2, n_points, N)
};

namespace {

using tmx_ext::E2;

__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__global__ void __launch_bounds__(THREADS) tmx_ext_powers_kernel(PowersArgs a) {
    const int k = blockIdx.y;
    const int64_t i0 = (int64_t(blockIdx.x) * THREADS + threadIdx.x) * RUN;
    if (i0 >= a.n) return;
    const E2 b{a.pt0[k], a.pt1[k]};
    E2 x = tmx_ext::pow(b, uint64_t(i0));
    uint64_t* o0 = a.out + k * a.n;
    uint64_t* o1 = a.out + (a.n_points + k) * a.n;
    for (int r = 0; r < RUN && i0 + r < a.n; ++r) {
        o0[i0 + r] = x.c0;
        o1[i0 + r] = x.c1;
        x = tmx_ext::mul(x, b);
    }
}

template <int NP>
__global__ void __launch_bounds__(THREADS) tmx_ood_slices_kernel(OodArgs a) {
    __shared__ uint64_t tile[ROWS][TJ + 1];
    __shared__ uint64_t sp0[NP][TJ], sp1[NP][TJ];
    const int64_t rows = a.n_a + a.n_b;
    const int64_t r0 = int64_t(blockIdx.x) * ROWS;
    const int64_t row = r0 + threadIdx.x;
    const int64_t len = (a.n + a.slices - 1) / a.slices;
    const int64_t js = int64_t(blockIdx.y) * len;
    const int64_t je = js + len < a.n ? js + len : a.n;
    tmx_gl::Acc acc[NP][2];
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int w = 0; w < 5; ++w) acc[k][c].w[w] = 0;

    for (int64_t j0 = js; j0 < je; j0 += TJ) {
        __syncthreads();  // the previous tile is read
        // each warp stages TJ = 32 consecutive words of one row at a time
        for (int i = threadIdx.x; i < ROWS * TJ; i += THREADS) {
            const int rr = i / TJ, jj = i % TJ;
            const int64_t r = r0 + rr, j = j0 + jj;
            uint64_t v = 0;  // rows and columns past the ends add nothing
            if (r < rows && j < je) v = r < a.n_a ? ld(a.a + r * a.a_ld + j) : ld(a.b + (r - a.n_a) * a.b_ld + j);
            tile[rr][jj] = v;
        }
        for (int i = threadIdx.x; i < NP * TJ; i += THREADS) {
            const int k = i / TJ, jj = i % TJ;
            const int64_t j = j0 + jj;
            sp0[k][jj] = j < je ? ld(a.powers + k * a.n + j) : 0;
            sp1[k][jj] = j < je ? ld(a.powers + (a.n_points + k) * a.n + j) : 0;
        }
        __syncthreads();
#pragma unroll 4
        for (int jj = 0; jj < TJ; ++jj) {
            const uint64_t t = tile[threadIdx.x][jj];
#pragma unroll
            for (int k = 0; k < NP; ++k) {
                tmx_gl::mac(acc[k][0], sp0[k][jj], t);
                tmx_gl::mac(acc[k][1], sp1[k][jj], t);
            }
        }
    }
    if (row >= rows) return;
    // partial (slices, 2, n_points, rows)
    uint64_t* p = a.partial + int64_t(blockIdx.y) * 2 * NP * rows + row;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int k = 0; k < NP; ++k) p[(c * NP + k) * rows] = tmx_gl::reduce(acc[k][c]);
}

// out[o] = sum over the slices of partial[s][o], o < 2 n_points rows:
// one warp an output, each lane every 32nd slice, then a shuffle tree
__global__ void __launch_bounds__(SUM_THREADS) tmx_ood_sum_kernel(OodArgs a) {
    const int64_t total = 2 * a.n_points * (a.n_a + a.n_b);
    const int64_t o = (int64_t(blockIdx.x) * SUM_THREADS + threadIdx.x) / 32;
    const int lane = threadIdx.x % 32;
    if (o >= total) return;  // whole warps leave together
    uint64_t s = 0;
    for (int64_t i = lane; i < a.slices; i += 32) s = tmx_gl::add(s, ld(a.partial + i * total + o));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = tmx_gl::add(s, __shfl_down_sync(0xFFFFFFFFu, (unsigned long long)s, off));
    if (lane == 0) a.out[o] = s;
}

__global__ void __launch_bounds__(THREADS) tmx_deep_inverses_kernel(InvArgs a) {
    const int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= a.N) return;
    // x = shift w_N^i from the bits of i
    uint64_t x = a.shift;
#pragma unroll
    for (int bit = 0; bit < 32; ++bit)
        if ((uint64_t(i) >> bit) & 1) x = tmx_gl::mul(x, a.wpow[bit]);
    for (int k = 0; k < a.n_points; ++k) {
        const E2 v = tmx_ext::inv(E2{tmx_gl::sub(x, a.z0[k]), tmx_gl::neg(a.z1[k])});
        a.out[k * a.N + i] = v.c0;
        a.out[(a.n_points + k) * a.N + i] = v.c1;
    }
}

template <int NP>
void launch_slices(const OodArgs& a, int64_t row_blocks, cudaStream_t s) {
    tmx_ood_slices_kernel<NP><<<dim3((unsigned)row_blocks, (unsigned)a.slices), THREADS, 0, s>>>(a);
}

}  // namespace

extern "C" int tmx_ext_powers(const PowersArgs* args, void* stream) {
    const PowersArgs& a = *args;
    if (a.n_points < 1 || a.n_points > MAX_POINTS || a.n < 0) return (int)cudaErrorInvalidValue;
    if (a.n == 0) return 0;
    const int64_t blocks = (a.n + int64_t(THREADS) * RUN - 1) / (int64_t(THREADS) * RUN);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tmx_ext_powers_kernel<<<dim3((unsigned)blocks, (unsigned)a.n_points), THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int tmx_ood_eval(const OodArgs* args, void* stream) {
    const OodArgs& a = *args;
    const int64_t rows = a.n_a + a.n_b;
    if (a.n_points < 1 || a.n_points > MAX_POINTS || a.n_a < 0 || a.n_b < 0 || (a.n_b > 0 && !a.b) ||
        a.n < 1 || a.n > MAX_LENGTH || a.slices < 1 || a.slices > 65535 || a.slices > a.n)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const int64_t row_blocks = (rows + ROWS - 1) / ROWS;
    const int64_t sum_blocks = (2 * a.n_points * rows * 32 + SUM_THREADS - 1) / SUM_THREADS;
    if (row_blocks > INT_MAX || sum_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (a.n_points) {
        case 1: launch_slices<1>(a, row_blocks, s); break;
        case 2: launch_slices<2>(a, row_blocks, s); break;
        case 3: launch_slices<3>(a, row_blocks, s); break;
        case 4: launch_slices<4>(a, row_blocks, s); break;
        case 5: launch_slices<5>(a, row_blocks, s); break;
        case 6: launch_slices<6>(a, row_blocks, s); break;
        case 7: launch_slices<7>(a, row_blocks, s); break;
        default: launch_slices<8>(a, row_blocks, s); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tmx_ood_sum_kernel<<<(unsigned)sum_blocks, SUM_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int tmx_deep_inverses(const InvArgs* args, void* stream) {
    const InvArgs& a = *args;
    if (a.n_points < 1 || a.n_points > MAX_POINTS || a.N < 0 || a.N > (int64_t(1) << 32))
        return (int)cudaErrorInvalidValue;
    if (a.N == 0) return 0;
    const int64_t blocks = (a.N + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tmx_deep_inverses_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
