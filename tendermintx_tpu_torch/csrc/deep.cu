// The DEEP composition of one statement's shard on Hopper (stark/prover.py
// binds it with ctypes):
//
//   F(x) = sum_g (sum_i beta_{g,i} T_i(x) + [g = 0] sum_j beta_{q,j} Q_j(x) - G0_g) * inv_g(x)
//
// over the shard's rows x, in GF(p^2) (csrc/ext.cuh), with T_i the trace
// and aux LDE columns (base field), Q_j the quotient chunks' LDE
// (extension), G0_g the opening group's value at z_g and inv_g(x) =
// (x - z_g)^-1.
//
// Replaces the XLA program of tendermintx_tpu/stark/prover.py:445
// `_build_deep_fn` over :533 `_deep_core` (one jitted reduction per
// opening group, over row blocks of the LDE).
//
// Bound: the trace and aux columns are most of the bytes (each read once:
// Ed25519 at N=128 reads 2,929 columns of 2^18 rows, 6.1 GB); the
// multiplies are two a column a group a row (an extension scalar times a
// base value), 4 32-bit multiply-adds each. The design reads each column
// value once for every opening group (the plain version reads the columns
// once a group): one thread a row, the groups' sums in registers (up to
// MAX_GROUPS, a template parameter, so they stay registers), the betas
// read as broadcasts (every thread of a warp reads the same word), no
// shared memory and no row blocking: one launch a shard. Every value is
// canonical at every step, so F equals the plain torch version bit for bit.
//
// Entry, with a plain C interface:
//   tmx_deep   rows [0, rows) of a shard -> out (2, rows) (c0 row, then c1
//              row), launched on the caller's stream; returns
//              cudaGetLastError().
// The kernel allocates nothing; the wrapper allocates the output.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int MAX_GROUPS = 8;  // stark/prover.py: DEEP_MAX_GROUPS
constexpr int THREADS = 128;

}  // namespace

// stark/prover.py::_DeepArgs, field for field (8-byte fields only). A
// column operand is row-major with unit stride along its rows and the
// given row stride (in words).
struct DeepArgs {
    const uint64_t* trace;  // (n_main, rows)
    int64_t trace_ld;
    int64_t n_main;
    const uint64_t* aux;  // (n_aux, rows), or null
    int64_t aux_ld;
    int64_t n_aux;
    const uint64_t* chunk0;  // (n_chunks, rows): the chunks' c0 rows
    const uint64_t* chunk1;  // and their c1 rows
    int64_t chunk_ld;
    int64_t n_chunks;
    const uint64_t* beta_t0;  // (n_groups, n_main + n_aux), contiguous
    const uint64_t* beta_t1;
    const uint64_t* beta_q0;  // (n_chunks,)
    const uint64_t* beta_q1;
    const uint64_t* g00;  // (n_groups,)
    const uint64_t* g01;
    const uint64_t* inv0;  // (n_groups, rows)
    const uint64_t* inv1;
    int64_t inv_ld;
    int64_t n_groups;
    int64_t rows;
    uint64_t* out;  // (2, rows)
};

namespace {

// a read-only load through the non-coherent cache
__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

template <int NG>
__global__ void __launch_bounds__(THREADS) tmx_deep_kernel(DeepArgs a) {
    using tmx_ext::E2;
    const int64_t x = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (x >= a.rows) return;
    const int64_t n_total = a.n_main + a.n_aux;
    uint64_t s0[NG], s1[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) s0[g] = s1[g] = 0;

    // sum_i beta_{g,i} T_i(x): each column value read once for all groups
    for (int part = 0; part < 2; ++part) {
        const uint64_t* col = part ? a.aux : a.trace;
        const int64_t stride = part ? a.aux_ld : a.trace_ld;
        const int64_t count = part ? a.n_aux : a.n_main;
        const int64_t c0 = part ? a.n_main : 0;
#pragma unroll 2
        for (int64_t i = 0; i < count; ++i) {
            const uint64_t t = ld(col + i * stride + x);
#pragma unroll
            for (int g = 0; g < NG; ++g) {
                const int64_t b = g * n_total + c0 + i;
                s0[g] = tmx_gl::add(s0[g], tmx_gl::mul(ld(a.beta_t0 + b), t));
                s1[g] = tmx_gl::add(s1[g], tmx_gl::mul(ld(a.beta_t1 + b), t));
            }
        }
    }

    // group 0 also takes sum_j beta_{q,j} Q_j(x)
    E2 q{s0[0], s1[0]};
    for (int64_t j = 0; j < a.n_chunks; ++j) {
        const E2 beta{ld(a.beta_q0 + j), ld(a.beta_q1 + j)};
        const E2 v{ld(a.chunk0 + j * a.chunk_ld + x), ld(a.chunk1 + j * a.chunk_ld + x)};
        q = tmx_ext::add(q, tmx_ext::mul(beta, v));
    }
    s0[0] = q.c0;
    s1[0] = q.c1;

    E2 f{0, 0};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
        const E2 G = tmx_ext::sub(E2{s0[g], s1[g]}, E2{ld(a.g00 + g), ld(a.g01 + g)});
        const E2 inv{ld(a.inv0 + g * a.inv_ld + x), ld(a.inv1 + g * a.inv_ld + x)};
        f = tmx_ext::add(f, tmx_ext::mul(G, inv));
    }
    a.out[x] = f.c0;
    a.out[a.rows + x] = f.c1;
}

template <int NG>
void launch(const DeepArgs& a, int blocks, cudaStream_t stream) {
    tmx_deep_kernel<NG><<<blocks, THREADS, 0, stream>>>(a);
}

}  // namespace

extern "C" int tmx_deep(const DeepArgs* args, void* stream) {
    const DeepArgs& a = *args;
    if (a.rows <= 0) return 0;
    if (a.n_groups < 1 || a.n_groups > MAX_GROUPS || a.n_main < 0 || a.n_aux < 0 || a.n_chunks < 0 ||
        (a.n_aux > 0 && !a.aux))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (a.rows + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (a.n_groups) {
        case 1: launch<1>(a, (int)blocks, s); break;
        case 2: launch<2>(a, (int)blocks, s); break;
        case 3: launch<3>(a, (int)blocks, s); break;
        case 4: launch<4>(a, (int)blocks, s); break;
        case 5: launch<5>(a, (int)blocks, s); break;
        case 6: launch<6>(a, (int)blocks, s); break;
        case 7: launch<7>(a, (int)blocks, s); break;
        default: launch<8>(a, (int)blocks, s); break;
    }
    return (int)cudaGetLastError();
}
