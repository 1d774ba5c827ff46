// Width-12 Poseidon over Goldilocks on Hopper: the permutation, the
// column-major leaf sponge and one Merkle tree layer.
//
// Replaces the reference's TPU kernel tendermintx_tpu/ops/poseidon_pallas.py
// (`_kernel`, reached through `pl.pallas_call` at :182), its XLA twin
// ops/poseidon.py::_permute_xla, and the XLA programs that drive it for
// commitments: ops/poseidon.py::hash_no_pad_cols (a `lax.scan` of one
// permutation per 8-column absorb) and ops/merkle.py::_inner_layers (one
// `two_to_one` per tree layer). Round structure as the reference: 4 full,
// 22 partial and 4 full rounds, x^7 S-box, the dense 7-bit MDS matrix in
// every round.
//
// Bound: 32-bit integer multiply-adds. A permutation is 118 S-boxes x 4
// field products x 4 partial products (1,888) plus 30 MDS layers x 144
// entries x 2 halves (8,640): 10,528 multiply-adds against 192 bytes of
// state traffic, so bytes never bind. (The sparse partial-round form of the
// same permutation needs 6,656; chip_smoke.py's bound counts that form.)
// The design follows from that:
//
//   * One thread per state, the 12 lanes as uint64_t in registers. Values
//     stay in [0, 2^64) between operations (any representative mod p) and
//     are made canonical once, at the end of the permutation.
//   * A field product is four 32x32->64 multiplies (IMAD.WIDE.U32) and
//     one reduction of the 128-bit product, all as PTX carry chains: the
//     compiler's own 64-bit code for the same C++ spent about as many
//     instructions on compares, selects and zero-extensions as on the
//     multiplies.
//   * The MDS layer multiplies the 32-bit halves of each lane by the 7-bit
//     entries: each product is below 2^39, each row's two 12-term sums below
//     2^43, so they accumulate in plain 64-bit registers with one
//     IMAD.WIDE.U32 per entry and half. One reduction per row.
//   * The MDS entries are template constants (poseidon_params.cuh), so each
//     becomes an immediate of its multiply-add. Each MDS row's reduction
//     also adds the next round's constant, so no round spends a separate
//     carry chain on it. The round loops stay rolled to keep the code
//     small for the instruction cache (one full and one partial round
//     body); they read the round constants from __constant__ memory,
//     initialised at compile time from the same header (no upload).
//   * __launch_bounds__ caps a thread at 128 registers, so 4 blocks of 128
//     threads (16 warps) are resident per SM; ptxas reports no spills
//     (chip_smoke.py's build line).
//
// Entries, each with a plain C interface (loaded with ctypes by
// tendermintx_tpu_torch/ops/poseidon.py, launched on the caller's stream,
// returning cudaGetLastError()):
//   tmx_poseidon_permute       (B, 12) row-major states -> (B, 12);
//   tmx_poseidon_sponge_cols   (L, N) column-major matrix -> (N, 4) digests,
//                              one thread per leaf absorbing all ceil(L/8)
//                              chunks (a ragged last chunk is zero-filled);
//   tmx_poseidon_merkle_layer  (n, 4) digests -> (n/2, 4), out[i] =
//                              two_to_one(d[2i], d[2i+1]);
//   tmx_poseidon_expand        (R, 12) input states -> (106, R) witness
//                              columns of the recursion wrap's WrapAir
//                              (stark/recursion.py: COL_S..N_PERM_COLS): S1..S3
//                              (the states after rounds 0-2), p4..p25 (each
//                              partial round's lane 0 before its S-box),
//                              w26 and w27..w29 (the states after rounds
//                              25-28). Replaces the XLA program of
//                              tendermintx_tpu/stark/recursion.py:220
//                              `expand_perm_states` (jitted at :275 as
//                              `_expand_jit`). Bound: bytes, the 31 MB it
//                              moves at 2^15 states (0.0092 ms); its
//                              operations, rounds 0-28 in the sparse
//                              partial-round form, are 4,116 integer
//                              multiply-adds and 2,060 MDS products a
//                              state, each on a pipe of 64 a clock an SM
//                              (0.0081 ms). What held the ported kernel
//                              back was the integer pipe, not occupancy:
//                              IMAD and IADD3 share its 64 lanes a clock
//                              an SM, and a thread a state issued ~30,000
//                              integer instructions a state (ptxas turns
//                              each MDS row's multiply-add chain into
//                              products and three-input adds), ~94% of
//                              the pipe's rate at 2^15 states. So the MDS
//                              sums run on the FP64 pipe (exact, see
//                              half_to_double), which halves the integer
//                              work of a partial round, and a partial
//                              round sums lanes 1-11 while lane 0 goes
//                              through its S-box. One thread a state: a
//                              state split over 2 or 4 threads (the same
//                              lane of neighbouring warps, exchanging
//                              doubles through shared memory at named
//                              barriers) issued as many instructions and
//                              lost at the barriers, so it measured slower
//                              on an H100 (PERF.md). A warp's store to a
//                              column is 32 neighbouring words (whole
//                              32-byte sectors), canonical;
//   tmx_poseidon_grind         the FRI's proof-of-work search over
//                              candidates start .. start + span - 1: the
//                              smallest i < span whose poseidon([seed,
//                              start + i, 0, ...]) has lane 0's low
//                              pow_bits zero, or none. Replaces the XLA
//                              program of tendermintx_tpu/stark/fri.py:624
//                              `_grind_fn`. Bound: operations, for the
//                              nonce + 1 candidates the search needs at
//                              least: in the sparse partial-round form
//                              4,308 integer multiply-adds and 2,348 MDS
//                              products a candidate, the MDS on the FP64
//                              pipe as here, each pipe 64 a clock an SM. One
//                              thread a candidate over a whole batch hashed
//                              ~4x the expected search (2^18 at 16 bits)
//                              whatever the nonce. Now one launch of about
//                              the resident blocks searches a whole span:
//                              each warp claims chunks of GRIND_CHUNK
//                              candidates in increasing order (atomicAdd on
//                              a device counter), reading the best hit
//                              before each claim and stopping once its
//                              chunk starts at or past it; a hit is taken
//                              by atomicMax of span - i (the smallest i). A
//                              chunk is skipped only when it starts at or
//                              past a hit already found, so every chunk
//                              below the final hit is hashed and the result
//                              is the smallest hit; the search ends about
//                              one wave of resident threads past it. Its
//                              permutation is its own, permute_state_f64:
//                              the MDS sums on the FP64 pipe as the round
//                              states', which shortens a wave (A's entries
//                              keep permute_state). The entry zeroes the
//                              two scratch words (a memset, no fill
//                              kernel).
// The kernels allocate nothing; the wrappers allocate the outputs.

#include <cstdint>
#include <algorithm>
#include <climits>
#include <utility>

#include <cuda_runtime.h>

#include "poseidon_params.cuh"

namespace {

using tmx_poseidon::HALF_FULL_ROUNDS;
using tmx_poseidon::N_ROUNDS;
using tmx_poseidon::PARTIAL_ROUNDS;
using tmx_poseidon::WIDTH;

constexpr int RATE = 8;
constexpr int DIGEST = 4;
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 4;
constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPS = 0xFFFFFFFFULL;  // 2^64 mod p

// One row past the last round: zeros, the constants "added" after the last
// MDS layer.
__constant__ uint64_t c_rc[N_ROUNDS + 1][WIDTH] = TMX_POSEIDON_RC_INIT;

template <int I, int J>
struct Mds {
    static constexpr uint64_t value = tmx_poseidon::POSEIDON_MDS[I][J];
};

using Lanes = std::make_integer_sequence<int, WIDTH>;

// The field arithmetic is written as PTX carry chains on 32-bit halves,
// about one SASS instruction a line (IADD3 with carry, or IMAD.WIDE.U32),
// with no 64-bit compares or zero-extension moves.

// x + k (mod p) for x < 2^64 and a canonical constant k; result < 2^64.
__device__ __forceinline__ uint64_t add_const(uint64_t x, uint64_t k) {
    uint64_t r;
    asm("{\n\t"
        ".reg .u32 x0, x1, k0, k1, c;\n\t"
        "mov.b64 {x0, x1}, %1;\n\t"
        "mov.b64 {k0, k1}, %2;\n\t"
        "add.cc.u32 x0, x0, k0;\n\t"
        "addc.cc.u32 x1, x1, k1;\n\t"
        "addc.u32 c, 0, 0;\n\t"
        "sub.u32 c, 0, c;\n\t"  // a carry of 2^64 == EPS (0 or 0xFFFFFFFF)
        "add.cc.u32 x0, x0, c;\n\t"  // below 2^64 again: the wrapped sum < k
        "addc.u32 x1, x1, 0;\n\t"
        "mov.b64 %0, {x0, x1};\n\t"
        "}"
        : "=l"(r)
        : "l"(x), "l"(k));
    return r;
}

// a * b (mod p) for a, b < 2^64: four 32x32->64 products, then the 128-bit
// product lo + 2^64 (r2 + 2^32 r3) reduced with 2^64 == EPS, 2^96 == -1.
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    uint64_t r;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, r0, r1, r2, r3, s0, s1, t0, t1, c;\n\t"
        ".reg .u64 p00, p11, p01, p10, m;\n\t"
        "mov.b64 {a0, a1}, %1;\n\t"
        "mov.b64 {b0, b1}, %2;\n\t"
        "mul.wide.u32 p00, a0, b0;\n\t"
        "mul.wide.u32 p11, a1, b1;\n\t"
        "mul.wide.u32 p01, a0, b1;\n\t"
        "mul.wide.u32 p10, a1, b0;\n\t"
        "mov.b64 {r0, r1}, p00;\n\t"
        "mov.b64 {r2, r3}, p11;\n\t"
        "mov.b64 {s0, s1}, p01;\n\t"
        "mov.b64 {t0, t1}, p10;\n\t"
        "add.cc.u32 r1, r1, s0;\n\t"
        "addc.cc.u32 r2, r2, s1;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        "add.cc.u32 r1, r1, t0;\n\t"
        "addc.cc.u32 r2, r2, t1;\n\t"
        "addc.u32 r3, r3, 0;\n\t"
        // lo - r3; on a borrow take back EPS (stays >= 0)
        "sub.cc.u32 r0, r0, r3;\n\t"
        "subc.cc.u32 r1, r1, 0;\n\t"
        "subc.u32 c, 0, 0;\n\t"
        "sub.cc.u32 r0, r0, c;\n\t"
        "subc.u32 r1, r1, 0;\n\t"
        // + r2 * EPS; on a carry add EPS (no second carry)
        "mul.wide.u32 m, r2, 0xFFFFFFFF;\n\t"
        "mov.b64 {s0, s1}, m;\n\t"
        "add.cc.u32 r0, r0, s0;\n\t"
        "addc.cc.u32 r1, r1, s1;\n\t"
        "addc.u32 c, 0, 0;\n\t"
        "sub.u32 c, 0, c;\n\t"
        "add.cc.u32 r0, r0, c;\n\t"
        "addc.u32 r1, r1, 0;\n\t"
        "mov.b64 %0, {r0, r1};\n\t"
        "}"
        : "=l"(r)
        : "l"(a), "l"(b));
    return r;
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
    const uint64_t x2 = mul(x, x);
    const uint64_t x3 = mul(x2, x);
    const uint64_t x4 = mul(x2, x2);
    return mul(x3, x4);
}

// a * B + c and a * B for a 32-bit a and an immediate B: one IMAD.WIDE.U32.
template <uint64_t B>
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint64_t c) {
    uint64_t d;
    asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "n"((uint32_t)B), "l"(c));
    return d;
}

template <uint64_t B>
__device__ __forceinline__ uint64_t mul_wide(uint32_t a) {
    uint64_t d;
    asm("mul.wide.u32 %0, %1, %2;" : "=l"(d) : "r"(a), "n"((uint32_t)B));
    return d;
}

// acc_lo + 2^32 acc_hi + k (mod p) for acc_lo, acc_hi < 2^44 and k < 2^64;
// result < 2^64. The sum is l0 + 2^32 r1 + 2^64 r2 with r2 < 2^13, and
// 2^64 == EPS.
__device__ __forceinline__ uint64_t mds_reduce(uint64_t acc_lo, uint64_t acc_hi, uint64_t k) {
    uint64_t r;
    asm("{\n\t"
        ".reg .u32 l0, l1, h0, h1, k0, k1, r1, r2, m0, m1, c;\n\t"
        ".reg .u64 m;\n\t"
        "mov.b64 {l0, l1}, %1;\n\t"
        "mov.b64 {h0, h1}, %2;\n\t"
        "mov.b64 {k0, k1}, %3;\n\t"
        "add.cc.u32 r1, l1, h0;\n\t"
        "addc.u32 r2, h1, 0;\n\t"
        "add.cc.u32 l0, l0, k0;\n\t"
        "addc.cc.u32 r1, r1, k1;\n\t"
        "addc.u32 r2, r2, 0;\n\t"
        "mul.wide.u32 m, r2, 0xFFFFFFFF;\n\t"
        "mov.b64 {m0, m1}, m;\n\t"
        "add.cc.u32 l0, l0, m0;\n\t"
        "addc.cc.u32 r1, r1, m1;\n\t"
        "addc.u32 c, 0, 0;\n\t"
        "sub.u32 c, 0, c;\n\t"
        "add.cc.u32 l0, l0, c;\n\t"
        "addc.u32 r1, r1, 0;\n\t"
        "mov.b64 %0, {l0, r1};\n\t"
        "}"
        : "=l"(r)
        : "l"(acc_lo), "l"(acc_hi), "l"(k));
    return r;
}

// Row I of the MDS layer plus the next round's constant k: sum_J M[I][J] *
// s[J] + k (mod p) from the halves of the lanes. Each product is < 2^39,
// each 12-term sum < 2^43.
template <int I, int J0, int... J>
__device__ __forceinline__ uint64_t mds_row(const uint32_t (&lo)[WIDTH], const uint32_t (&hi)[WIDTH],
                                            uint64_t k, std::integer_sequence<int, J0, J...>) {
    uint64_t acc_lo = mul_wide<Mds<I, J0>::value>(lo[J0]);
    uint64_t acc_hi = mul_wide<Mds<I, J0>::value>(hi[J0]);
    ((acc_lo = mad_wide<Mds<I, J>::value>(lo[J], acc_lo)), ...);
    ((acc_hi = mad_wide<Mds<I, J>::value>(hi[J], acc_hi)), ...);
    return mds_reduce(acc_lo, acc_hi, k);
}

// s = M s + rc_next, the MDS layer of one round fused with the constant
// addition of the next.
template <int... I>
__device__ __forceinline__ void mds_layer(uint64_t (&s)[WIDTH], const uint64_t* rc_next,
                                          std::integer_sequence<int, I...>) {
    uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        lo[j] = (uint32_t)s[j];
        hi[j] = (uint32_t)(s[j] >> 32);
    }
    const uint64_t out[WIDTH] = {mds_row<I>(lo, hi, rc_next[I], Lanes{})...};
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = out[j];
}

// The permutation, in place on 12 registers; canonical output. Round r is
// S-boxes then MDS on s + rc[r]; each MDS layer adds the next round's
// constants (zeros after the last).
__device__ __forceinline__ void permute_state(uint64_t (&s)[WIDTH]) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = add_const(s[j], c_rc[0][j]);
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
#pragma unroll 1
        for (int k = 0; k < HALF_FULL_ROUNDS; ++k) {
            const int r = half * (HALF_FULL_ROUNDS + PARTIAL_ROUNDS) + k;
#pragma unroll
            for (int j = 0; j < WIDTH; ++j) s[j] = sbox(s[j]);
            mds_layer(s, c_rc[r + 1], Lanes{});
        }
        if (half == 0) {
#pragma unroll 1
            for (int r = HALF_FULL_ROUNDS; r < HALF_FULL_ROUNDS + PARTIAL_ROUNDS; ++r) {
                s[0] = sbox(s[0]);
                mds_layer(s, c_rc[r + 1], Lanes{});
            }
        }
    }
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = s[j] >= P ? s[j] - P : s[j];
}

// The MDS layer on the FP64 pipe, for the round-state and grinding kernels.
// A product of a lane's 32-bit half and a 7-bit entry is below 2^39 and a
// row's 12-term sum below 2^43, so every value is an integer that a double
// holds exactly, whatever the order of the sums: the DFMAs compute the same
// row sums as the integer multiply-adds above (mds_row), on a pipe of their
// own. (The integer pipe takes IMAD and IADD3 alike at 64 a clock an SM;
// ptxas turns each integer row's multiply-add chain into products and
// three-input adds, which nearly doubles what that pipe issues.)

constexpr double TWO_52 = 4503599627370496.0;

// x < 2^32 as a double: the bits of 2^52 + x, less 2^52.
__device__ __forceinline__ double half_to_double(uint32_t x) {
    return __hiloint2double(0x43300000, (int)x) - TWO_52;
}

// An integer-valued double v < 2^52 as an integer: the mantissa of v + 2^52.
__device__ __forceinline__ uint64_t double_to_u64(double v) {
    return (uint64_t)__double_as_longlong(v + TWO_52) & ((uint64_t(1) << 52) - 1);
}

__device__ __forceinline__ void lanes_to_doubles(const uint64_t (&s)[WIDTH], double (&lo)[WIDTH],
                                                 double (&hi)[WIDTH]) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) {
        lo[j] = half_to_double((uint32_t)s[j]);
        hi[j] = half_to_double((uint32_t)(s[j] >> 32));
    }
}

// acc += row I's terms, lane 0's left out where Skip0 (a partial round of
// the round-state kernel adds them last, after lane 0's S-box).
template <int I, bool Skip0, int... J>
__device__ __forceinline__ void row_sums(double& acc_lo, double& acc_hi, const double (&lo)[WIDTH],
                                         const double (&hi)[WIDTH], std::integer_sequence<int, J...>) {
    const auto term = [&](auto j) {
        constexpr int Jv = decltype(j)::value;
        if constexpr (!(Skip0 && Jv == 0)) {
            acc_lo = fma(double(Mds<I, Jv>::value), lo[Jv], acc_lo);
            acc_hi = fma(double(Mds<I, Jv>::value), hi[Jv], acc_hi);
        }
    };
    (term(std::integral_constant<int, J>{}), ...);
}

template <bool Skip0, int... I>
__device__ __forceinline__ void rows_sums(double (&acc_lo)[WIDTH], double (&acc_hi)[WIDTH], const double (&lo)[WIDTH],
                                          const double (&hi)[WIDTH], std::integer_sequence<int, I...>) {
    (row_sums<I, Skip0>(acc_lo[I], acc_hi[I], lo, hi, Lanes{}), ...);
}

// The sums plus lane 0's terms.
template <int... I>
__device__ __forceinline__ void rows_lane0(double (&acc_lo)[WIDTH], double (&acc_hi)[WIDTH], double lo0, double hi0,
                                           std::integer_sequence<int, I...>) {
    ((acc_lo[I] = fma(double(Mds<I, 0>::value), lo0, acc_lo[I])), ...);
    ((acc_hi[I] = fma(double(Mds<I, 0>::value), hi0, acc_hi[I])), ...);
}

// s[i] = row i from its two sums, plus rc_next[i].
template <int... I>
__device__ __forceinline__ void rows_reduce(uint64_t (&s)[WIDTH], const double (&acc_lo)[WIDTH],
                                            const double (&acc_hi)[WIDTH], const uint64_t* rc_next,
                                            std::integer_sequence<int, I...>) {
    ((s[I] = mds_reduce(double_to_u64(acc_lo[I]), double_to_u64(acc_hi[I]), rc_next[I])), ...);
}

__device__ __forceinline__ void mds_layer_f64(uint64_t (&s)[WIDTH], const uint64_t* rc_next) {
    double lo[WIDTH], hi[WIDTH], acc_lo[WIDTH] = {}, acc_hi[WIDTH] = {};
    lanes_to_doubles(s, lo, hi);
    rows_sums<false>(acc_lo, acc_hi, lo, hi, Lanes{});
    rows_reduce(s, acc_lo, acc_hi, rc_next, Lanes{});
}

// permute_state with the MDS layers on the FP64 pipe: the grinding
// kernel's permutation; the same outputs.
__device__ __forceinline__ void permute_state_f64(uint64_t (&s)[WIDTH]) {
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = add_const(s[j], c_rc[0][j]);
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
#pragma unroll 1
        for (int k = 0; k < HALF_FULL_ROUNDS; ++k) {
            const int r = half * (HALF_FULL_ROUNDS + PARTIAL_ROUNDS) + k;
#pragma unroll
            for (int j = 0; j < WIDTH; ++j) s[j] = sbox(s[j]);
            mds_layer_f64(s, c_rc[r + 1]);
        }
        if (half == 0) {
#pragma unroll 1
            for (int r = HALF_FULL_ROUNDS; r < HALF_FULL_ROUNDS + PARTIAL_ROUNDS; ++r) {
                s[0] = sbox(s[0]);
                mds_layer_f64(s, c_rc[r + 1]);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = s[j] >= P ? s[j] - P : s[j];
}

__device__ __forceinline__ int64_t thread_index() {
    return (int64_t)blockIdx.x * THREADS + threadIdx.x;
}

}  // namespace

// (n, 12) -> (n, 12); both 16-byte aligned (the wrapper checks).
extern "C" __global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tmx_poseidon_permute_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                            int64_t n) {
    const int64_t b = thread_index();
    if (b >= n) return;
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(in + b * WIDTH);
    uint64_t s[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH / 2; ++k) {
        const ulonglong2 v = src[k];
        s[2 * k] = v.x;
        s[2 * k + 1] = v.y;
    }
    permute_state(s);
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + b * WIDTH);
#pragma unroll
    for (int k = 0; k < WIDTH / 2; ++k) dst[k] = make_ulonglong2(s[2 * k], s[2 * k + 1]);
}

// cols (L, n) column-major -> (n, 4) digests. Thread i hashes leaf i; a
// warp's loads of one column are 32 neighbouring words.
extern "C" __global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tmx_poseidon_sponge_cols_kernel(const uint64_t* __restrict__ cols, uint64_t* __restrict__ out,
                                int64_t L, int64_t n) {
    const int64_t i = thread_index();
    if (i >= n) return;
    uint64_t s[WIDTH] = {};
#pragma unroll 1
    for (int64_t c0 = 0; c0 < L; c0 += RATE) {
#pragma unroll
        for (int j = 0; j < RATE; ++j) {
            const int64_t c = c0 + j;
            s[j] = c < L ? cols[c * n + i] : 0;  // overwrite mode; ragged tail zero-filled
        }
        permute_state(s);
    }
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + i * DIGEST);
    dst[0] = make_ulonglong2(s[0], s[1]);
    dst[1] = make_ulonglong2(s[2], s[3]);
}

// (2 * n_out, 4) digests -> (n_out, 4): the 8 rate lanes of state i are the
// 64 contiguous bytes of digests 2i and 2i + 1.
extern "C" __global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tmx_poseidon_merkle_layer_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                 int64_t n_out) {
    const int64_t i = thread_index();
    if (i >= n_out) return;
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(in + i * 2 * DIGEST);
    uint64_t s[WIDTH] = {};
#pragma unroll
    for (int k = 0; k < DIGEST; ++k) {
        const ulonglong2 v = src[k];
        s[2 * k] = v.x;
        s[2 * k + 1] = v.y;
    }
    permute_state(s);
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + i * DIGEST);
    dst[0] = make_ulonglong2(s[0], s[1]);
    dst[1] = make_ulonglong2(s[2], s[3]);
}

namespace {

constexpr int WARP = 32;
constexpr int FIRST_PARTIAL = HALF_FULL_ROUNDS, END_PARTIAL = HALF_FULL_ROUNDS + PARTIAL_ROUNDS;
// the first column of p4..p25, of w26 and of w27..w29 in the (106, n) output
constexpr int COL_P = 3 * WIDTH, COL_W26 = COL_P + PARTIAL_ROUNDS, COL_W27 = COL_W26 + WIDTH;

// candidates a warp claims at a time: one a thread
constexpr int GRIND_CHUNK = 32;

}  // namespace

// (n, 12) -> (106, n), one thread a state (see the top). A partial round
// sums the terms of lanes 1-11 while lane 0 goes through its S-box, and
// adds lane 0's terms last.
extern "C" __global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tmx_poseidon_expand_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n) {
    const int64_t b = thread_index();
    if (b >= n) return;
    uint64_t s[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = in[b * WIDTH + j];
    const auto store = [&](int col, uint64_t v) { out[col * n + b] = v >= P ? v - P : v; };
    const auto store_state = [&](int col0) {
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) store(col0 + j, s[j]);
    };
    const auto full_round = [&](int r, const uint64_t* rc_next) {
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) s[j] = sbox(add_const(s[j], c_rc[r][j]));
        mds_layer_f64(s, rc_next);
    };
    // S1..S3 after rounds 0-2, taken after an MDS adding the zero row; round
    // 3's MDS adds round 4's constants
#pragma unroll 1
    for (int r = 0; r < FIRST_PARTIAL; ++r) {
        const bool stored = r + 1 < FIRST_PARTIAL;
        full_round(r, c_rc[stored ? N_ROUNDS : r + 1]);
        if (stored) store_state(r * WIDTH);
    }
    // p4..p25, lane 0 before its S-box; after round 25 the zero row, for w26
#pragma unroll 1
    for (int r = FIRST_PARTIAL; r < END_PARTIAL; ++r) {
        double lo[WIDTH], hi[WIDTH], acc_lo[WIDTH] = {}, acc_hi[WIDTH] = {};
#pragma unroll
        for (int j = 1; j < WIDTH; ++j) {
            lo[j] = half_to_double((uint32_t)s[j]);
            hi[j] = half_to_double((uint32_t)(s[j] >> 32));
        }
        store(COL_P + r - FIRST_PARTIAL, s[0]);
        s[0] = sbox(s[0]);
        rows_sums<true>(acc_lo, acc_hi, lo, hi, Lanes{});
        rows_lane0(acc_lo, acc_hi, half_to_double((uint32_t)s[0]), half_to_double((uint32_t)(s[0] >> 32)), Lanes{});
        rows_reduce(s, acc_lo, acc_hi, c_rc[r + 1 < END_PARTIAL ? r + 1 : N_ROUNDS], Lanes{});
    }
    store_state(COL_W26);
    // w27..w29 after rounds 26-28
#pragma unroll 1
    for (int r = END_PARTIAL; r < N_ROUNDS - 1; ++r) {
        full_round(r, c_rc[N_ROUNDS]);
        store_state(COL_W27 + (r - END_PARTIAL) * WIDTH);
    }
}

// The grinding search (see the top). scratch[0] counts the chunks claimed,
// scratch[1] holds span - the smallest hit so far (0: none yet). Lane 0 of
// a warp reads the best hit, then claims the next chunk; the warp stops
// when that chunk starts at or past the hit (or the span's end).
extern "C" __global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tmx_poseidon_grind_kernel(uint64_t seed, uint64_t mask, uint64_t start, uint64_t span,
                          unsigned long long* scratch) {
    const int lane = threadIdx.x % WARP;
    for (;;) {
        unsigned long long first = 0, hit = 0;
        if (lane == 0) {
            hit = span - *(volatile unsigned long long*)(scratch + 1);
            first = atomicAdd(scratch, 1ULL) * GRIND_CHUNK;
        }
        first = __shfl_sync(0xFFFFFFFFu, first, 0);
        hit = __shfl_sync(0xFFFFFFFFu, hit, 0);
        if (first >= hit) return;
        const uint64_t i = first + lane;
        if (i < span) {
            uint64_t s[WIDTH] = {};
            s[0] = seed;
            s[1] = start + i;
            permute_state_f64(s);
            if ((s[0] & mask) == 0) atomicMax(scratch + 1, (unsigned long long)(span - i));
        }
    }
}

namespace {

int blocks_for(int64_t n, int* blocks) {
    const int64_t want = (n + THREADS - 1) / THREADS;
    if (want > INT_MAX) return (int)cudaErrorInvalidValue;
    *blocks = (int)want;
    return 0;
}

}  // namespace

extern "C" int tmx_poseidon_permute(const void* in, void* out, int64_t n, void* stream) {
    if (n <= 0) return 0;
    int blocks;
    if (int e = blocks_for(n, &blocks)) return e;
    tmx_poseidon_permute_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int tmx_poseidon_sponge_cols(const void* cols, void* out, int64_t L, int64_t n,
                                        void* stream) {
    if (n <= 0) return 0;
    if (L <= 0) return (int)cudaErrorInvalidValue;
    int blocks;
    if (int e = blocks_for(n, &blocks)) return e;
    tmx_poseidon_sponge_cols_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)cols, (uint64_t*)out, L, n);
    return (int)cudaGetLastError();
}

extern "C" int tmx_poseidon_merkle_layer(const void* in, void* out, int64_t n_out,
                                         void* stream) {
    if (n_out <= 0) return 0;
    int blocks;
    if (int e = blocks_for(n_out, &blocks)) return e;
    tmx_poseidon_merkle_layer_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n_out);
    return (int)cudaGetLastError();
}

extern "C" int tmx_poseidon_expand(const void* in, void* out, int64_t n, void* stream) {
    if (n <= 0) return 0;
    int blocks;
    if (int e = blocks_for(n, &blocks)) return e;
    tmx_poseidon_expand_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n);
    return (int)cudaGetLastError();
}

// seed canonical, 1 <= pow_bits <= 32, candidates start .. start + span - 1
// below p; scratch: two 8-byte words, zeroed here. The grid is the blocks
// resident at once, fewer where the span has fewer chunks.
extern "C" int tmx_poseidon_grind(uint64_t seed, int64_t pow_bits, int64_t start, int64_t span, void* scratch,
                                  void* stream) {
    if (seed >= P || pow_bits < 1 || pow_bits > 32 || start < 0 || span <= 0 || (uint64_t)start >= P ||
        (uint64_t)span > P - (uint64_t)start || !scratch)
        return (int)cudaErrorInvalidValue;
    int device, sms, per_sm;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tmx_poseidon_grind_kernel, THREADS, 0);
    if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, 2 * sizeof(uint64_t), (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    const int64_t chunks = (span + GRIND_CHUNK - 1) / GRIND_CHUNK, warps = THREADS / WARP;
    const int64_t blocks = std::min<int64_t>((int64_t)sms * per_sm, (chunks + warps - 1) / warps);
    tmx_poseidon_grind_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        seed, (uint64_t(1) << pow_bits) - 1, (uint64_t)start, (uint64_t)span, (unsigned long long*)scratch);
    return (int)cudaGetLastError();
}
