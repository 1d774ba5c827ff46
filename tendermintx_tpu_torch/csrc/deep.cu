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
// base value). The design reads each column value once for every opening
// group (the plain version reads the columns once a group) and spends
// few integer instructions on each product:
//
// - Reduce once a group, not once a term. For each group, component and
//   row, the products beta * t (canonical 64-bit operands, a 128-bit
//   product) are summed unreduced in a 160-bit accumulator
//   (goldilocks.cuh: Acc, mac, reduce), five 32-bit limbs, by one PTX carry chain of multiply-adds (13 instructions, where
//   a canonical multiply and add take about 30). Each product is below
//   (p-1)^2 < 2^128, so MAX_COLUMNS = 2^32 - 1 columns sum below 2^160 and
//   the accumulator never wraps (the port's widest statement, Ed25519 at
//   N=128, has 2,929); stark/prover.py::deep_cuda refuses more. The sum is
//   reduced once at the end with 2^64 == 2^32 - 1, 2^96 == -1 and 2^128
//   == -2^32 (mod p) to a canonical value: the same field element as the
//   sum of reduced products, so F equals the plain torch version bit for
//   bit.
// - Several rows a thread. Each thread sums RPT = 2 consecutive rows,
//   read as 16-byte loads where the column is aligned, so each beta serves
//   two rows; U columns' loads are in flight together. At seven and eight
//   groups (the SHA AIRs) one row: the accumulators are 10 registers a
//   group a row, and two rows' 160 at eight groups spilled at ptxas's 255
//   registers a thread.
// - The betas of CHUNK columns at a time are staged in shared memory by
//   the block and read as broadcasts.
//
// The quotient chunks (extension values, group 0), the opening values
// and the inverses are canonical extension arithmetic (csrc/ext.cuh),
// once a row. One launch a shard.
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

constexpr int MAX_GROUPS = 8;                      // stark/prover.py: DEEP_MAX_GROUPS
constexpr int64_t MAX_COLUMNS = (1ll << 32) - 1;   // stark/prover.py: DEEP_MAX_COLUMNS
constexpr int THREADS = 128;
constexpr int CHUNK = 32;  // columns whose betas the block stages at a time

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

// rows [0, RPT) of a column from p, `avail` of them in the shard: 16-byte
// loads where p is aligned and every row is there, else one word a row
template <int RPT>
__device__ __forceinline__ void load_rows(const uint64_t* p, int64_t avail, uint64_t (&t)[RPT]) {
    if constexpr (RPT % 2 == 0) {
        if (avail >= RPT && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
            for (int r = 0; r < RPT; r += 2) {
                const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(p + r));
                t[r] = v.x;
                t[r + 1] = v.y;
            }
            return;
        }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) t[r] = r < avail ? ld(p + r) : 0;
}

template <int NG, int RPT, int U>
__global__ void __launch_bounds__(THREADS) tmx_deep_kernel(DeepArgs a) {
    using tmx_ext::E2;
    __shared__ uint64_t sb0[NG * CHUNK], sb1[NG * CHUNK];
    const int64_t x0 = (int64_t(blockIdx.x) * THREADS + threadIdx.x) * RPT;
    const int64_t avail = a.rows - x0;  // rows of this thread in the shard (up to RPT)
    const int64_t n_total = a.n_main + a.n_aux;
    tmx_gl::Acc acc[NG][2][RPT];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
                for (int w = 0; w < 5; ++w) acc[g][c][r].w[w] = 0;

    // sum_i beta_{g,i} T_i(x): each column value read once for all groups
    for (int64_t c0 = 0; c0 < n_total; c0 += CHUNK) {
        const int cn = n_total - c0 < CHUNK ? int(n_total - c0) : CHUNK;
        __syncthreads();  // the previous chunk's betas are read
        for (int i = threadIdx.x; i < NG * CHUNK; i += THREADS) {
            const int g = i / CHUNK, j = i % CHUNK;
            if (j < cn) {
                sb0[i] = ld(a.beta_t0 + g * n_total + c0 + j);
                sb1[i] = ld(a.beta_t1 + g * n_total + c0 + j);
            }
        }
        __syncthreads();
        if (avail <= 0) continue;
        // U columns at a time: their loads in flight together
#pragma unroll 1
        for (int j = 0; j < cn; j += U) {
            uint64_t t[U][RPT];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int64_t c = c0 + j + u;
                if (j + u < cn) {
                    const uint64_t* col = c < a.n_main ? a.trace + c * a.trace_ld : a.aux + (c - a.n_main) * a.aux_ld;
                    load_rows<RPT>(col + x0, avail, t[u]);
                } else {
#pragma unroll
                    for (int r = 0; r < RPT; ++r) t[u][r] = 0;  // adds nothing
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
#pragma unroll
                for (int g = 0; g < NG; ++g) {
                    const uint64_t b0 = sb0[g * CHUNK + j + u], b1 = sb1[g * CHUNK + j + u];
#pragma unroll
                    for (int r = 0; r < RPT; ++r) {
                        tmx_gl::mac(acc[g][0][r], b0, t[u][r]);
                        tmx_gl::mac(acc[g][1][r], b1, t[u][r]);
                    }
                }
            }
        }
    }
    if (avail <= 0) return;

    // group 0 also takes sum_j beta_{q,j} Q_j(x), then
    // F = sum_g (G_g - G0_g) inv_g
    E2 f[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) f[r] = E2{0, 0};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
        E2 G[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) G[r] = E2{tmx_gl::reduce(acc[g][0][r]), tmx_gl::reduce(acc[g][1][r])};
        if (g == 0) {
            for (int64_t j = 0; j < a.n_chunks; ++j) {
                const E2 beta{ld(a.beta_q0 + j), ld(a.beta_q1 + j)};
                uint64_t q0[RPT], q1[RPT];
                load_rows<RPT>(a.chunk0 + j * a.chunk_ld + x0, avail, q0);
                load_rows<RPT>(a.chunk1 + j * a.chunk_ld + x0, avail, q1);
#pragma unroll
                for (int r = 0; r < RPT; ++r) G[r] = tmx_ext::add(G[r], tmx_ext::mul(beta, E2{q0[r], q1[r]}));
            }
        }
        const E2 g0{ld(a.g00 + g), ld(a.g01 + g)};
        uint64_t i0[RPT], i1[RPT];
        load_rows<RPT>(a.inv0 + g * a.inv_ld + x0, avail, i0);
        load_rows<RPT>(a.inv1 + g * a.inv_ld + x0, avail, i1);
#pragma unroll
        for (int r = 0; r < RPT; ++r) f[r] = tmx_ext::add(f[r], tmx_ext::mul(tmx_ext::sub(G[r], g0), E2{i0[r], i1[r]}));
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        if (r < avail) {
            a.out[x0 + r] = f[r].c0;
            a.out[a.rows + x0 + r] = f[r].c1;
        }
    }
}

template <int NG>
void launch(const DeepArgs& a, cudaStream_t stream) {
    // rows a thread and columns in flight by group count, as ptxas fits
    // them without a spill: 2 rows up to six groups (one column at a time
    // from five), 1 row at seven and eight with 8 columns in flight (the
    // SHA AIRs: 1.41-1.45 ms against 1.59 with 2 on an H100; 8 at two
    // groups slowed EvalAir's 18 columns by 13%)
    constexpr int RPT = NG <= 6 ? 2 : 1;
    constexpr int U = NG <= 2 ? 4 : NG <= 4 ? 2 : NG <= 6 ? 1 : 8;
    const int64_t blocks = (a.rows + int64_t(THREADS) * RPT - 1) / (int64_t(THREADS) * RPT);
    tmx_deep_kernel<NG, RPT, U><<<(int)blocks, THREADS, 0, stream>>>(a);
}

}  // namespace

extern "C" int tmx_deep(const DeepArgs* args, void* stream) {
    const DeepArgs& a = *args;
    if (a.rows <= 0) return 0;
    if (a.n_groups < 1 || a.n_groups > MAX_GROUPS || a.n_main < 0 || a.n_aux < 0 || a.n_chunks < 0 ||
        (a.n_aux > 0 && !a.aux) || a.n_main + a.n_aux > MAX_COLUMNS)
        return (int)cudaErrorInvalidValue;
    if ((a.rows + THREADS - 1) / THREADS > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (a.n_groups) {
        case 1: launch<1>(a, s); break;
        case 2: launch<2>(a, s); break;
        case 3: launch<3>(a, s); break;
        case 4: launch<4>(a, s); break;
        case 5: launch<5>(a, s); break;
        case 6: launch<6>(a, s); break;
        case 7: launch<7>(a, s); break;
        default: launch<8>(a, s); break;
    }
    return (int)cudaGetLastError();
}
