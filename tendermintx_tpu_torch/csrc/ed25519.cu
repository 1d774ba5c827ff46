// The Ed25519 witness checks of the step / skip verification programs on
// Hopper (ops/ed25519.py binds them with ctypes):
//
//   tmx_straus_verify  the cofactorless check [s]B + [k](-A) == R of one
//                      signature a lane: a double-and-add Straus ladder over
//                      the lane's 4-entry table [identity, B, -A, B - A],
//                      one step a selector of bits2 (2 bit_k + bit_s, MSB
//                      first), then X == rx Z and Y == ry Z;
//   tmx_bind_witness   the check that every ladder input is the one the
//                      lane's raw (pubkey, message, signature) bytes and
//                      the challenge digest give (ops/ed25519.py:
//                      bind_witness_plain's steps 0-4).
//
// Replace the XLA programs of tendermintx_tpu/ops/ed25519.py:312
// `straus_verify` (jitted as `straus_verify_jit`) and :448 `bind_witness`
// (inside :524 `verify_bound`, which the JAX package jits whole).
//
// Field arithmetic is csrc/ed25519.cuh (radix 2^25.5, bounded limbs,
// canonical comparisons). Inputs are the plain versions' 20 limbs of 13
// bits, read as the integer sum l_i 2^(13 i) and reduced mod p. The ladder
// equals straus_verify_plain on every input whose limbs lie in [0, 2^13),
// for any int64 selector (one outside 0..3 selects the all-zero operand, as
// the reference's one-hot sum does). The binding equals bind_witness_plain
// on every int64 input: its range checks run first and a lane that fails
// them is false before any arithmetic.
//
// Bounds and design: at N = 128 a call is 128 lanes. The ladder does 15
// field products a step (8 in the doubling, 7 in the addition), 253 steps,
// ~100 32-bit multiply-adds each: ~49 M multiply-adds, ~3 us over the
// card, and its bytes are ~0.3 MB. But each lane's 253 steps are one
// dependent chain: the ladder is latency-bound, and its floor is one lane's
// chain (chip_smoke.py prints both). A step's products form four phases of
// at most four independent products (the doubling's X^2, Y^2, Z^2,
// (X + Y)^2, then E F, G H, F G, E H; the addition's (Y - X) ymx,
// (Y + X) ypx, T 2dt, then E F, G H, F G, E H), so a quad of thread pairs
// takes one lane, a pair a product of each phase, and the sums before a
// point's products split the same way: E, F, G and H one a pair, each
// written as one uniform form (u - (A + w) in the doubling, (u1 + u2) -+ v
// in the addition, C = 2 Z^2 made as the product 2Z Z), so that the quad
// runs one instruction stream with no select of values. A product's 100
// 64-bit multiply-adds (IMAD.WIDE, which a warp issues at a fraction of the
// 32-bit rate: they set a step's time) split over the pair, five output
// limbs a thread, the halves swapped by shuffle and reduced in both
// (mul_pair). Products and sums pass through shared memory (16-byte stores
// and loads of rows each pair addresses by its place in the quad, fixed
// before the loop), one __syncwarp after each write. Four lanes a warp,
// one warp a block, so that N = 128 spreads over 32 SMs, a warp alone on
// its scheduler. A lane's four table operands (y - x, y + x, 2d t, each
// entry's, made by the entry's pair) and the all-zero entry live in shared
// memory, indexed by the selector, where a register array indexed at run
// time would go to local memory. The next step's selector is loaded a step
// ahead. The values equal a thread-a-lane ladder's mod p; their limbs are
// the bounded ones every add, sub and mul keeps, and a product's sums are
// mul's (tests/test_torch_witness_kernels.py models the quad's code and
// the pair's halves and checks the bounds). The binding is straight-line
// code a lane in blocks of 32: ~22 field products and the 20 x 20 limb
// product k_q L, bytes-bound (~4.6 KB a lane). Each entry has a plain C
// interface, launches on the caller's stream and returns
// cudaGetLastError(); the kernels allocate nothing.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "ed25519.cuh"

namespace {

using tmx_ed::Fe;
using tmx_ed::LIMBS;
using tmx_ed::Point;

constexpr int THREADS = 32;
// the ladder: a quad of thread pairs a lane (a pair a product), one warp of
// 4 lanes a block
constexpr int QUAD = 4;
constexpr int LANE_THREADS = 2 * QUAD;
constexpr int LADDER_LANES = THREADS / LANE_THREADS;
constexpr int N_BITS = 253;  // ops/ed25519.py: N_BITS

// ops/ed25519.py's constants in radix 2^25.5 (tests/test_torch_witness_kernels.py
// checks them against the Python values): 2d, d, and the base point's x,
// y and t = x y
__constant__ uint32_t D2_FE[LIMBS] = {0x2b2f159, 0x1a6e509, 0x22add7a, 0x0d4141d, 0x0038052,
                                      0x0f3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x0901b67};
__constant__ uint32_t D_FE[LIMBS] = {0x35978a3, 0x0d37284, 0x3156ebd, 0x06a0a0e, 0x001c029,
                                     0x179e898, 0x3a03cbb, 0x1ce7198, 0x2e2b6ff, 0x1480db3};
__constant__ uint32_t BX_FE[LIMBS] = {0x325d51a, 0x18b5823, 0x0f6592a, 0x104a92d, 0x1a4b31d,
                                      0x1d6dc5c, 0x27118fe, 0x07fd814, 0x13cd6e5, 0x085a4db};
__constant__ uint32_t BY_FE[LIMBS] = {0x2666658, 0x1999999, 0x0cccccc, 0x1333333, 0x1999999,
                                      0x0666666, 0x3333333, 0x0cccccc, 0x2666666, 0x1999999};
__constant__ uint32_t BT_FE[LIMBS] = {0x1b7dda3, 0x1a2ace9, 0x25eadbb, 0x003ba8a, 0x083c27e,
                                      0x0abe37d, 0x1274732, 0x0ccacdd, 0x0fd78b7, 0x19e1d7c};
// p and the group order L in 13-bit limbs
__constant__ uint32_t P13[20] = {8173, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191,
                                 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 255};
__constant__ uint32_t L13[20] = {5101, 1966, 1687, 1222, 1409, 3691, 3038, 7124, 7929, 166,
                                 0,    0,    0,    0,    0,    0,    0,    0,    0,    32};

__device__ __forceinline__ Fe fe_const(const uint32_t (&c)[LIMBS]) {
    Fe f;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) f.v[k] = c[k];
    return f;
}

__device__ __forceinline__ Fe fe_small(uint32_t v) {
    Fe f{};
    f.v[0] = v;
    return f;
}

// a field element in shared memory: 10 limbs padded to 12 words, three
// 16-byte stores or loads
struct __align__(16) Row {
    uint32_t v[12];
};

__device__ __forceinline__ void put(Row& r, const Fe& f) {
    uint4* p = reinterpret_cast<uint4*>(r.v);
    p[0] = make_uint4(f.v[0], f.v[1], f.v[2], f.v[3]);
    p[1] = make_uint4(f.v[4], f.v[5], f.v[6], f.v[7]);
    p[2] = make_uint4(f.v[8], f.v[9], 0, 0);
}

__device__ __forceinline__ Fe get(const Row& r) {
    const uint4* p = reinterpret_cast<const uint4*>(r.v);
    const uint4 a = p[0], b = p[1], c = p[2];
    return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y}};
}

// f g on a pair of adjacent threads (both holding f and g): thread `half`
// sums the product's limbs 5 half .. 5 half + 4 (tmx_ed::mul's sums, 50
// multiply-adds), takes its partner's five by shuffle and reduces all ten
// as mul does, so both return mul's result. Limb i of f times the limb j =
// (5 half + kk - i) mod 10 of g, for output kk of the half: j's index
// j0 = (kk - i) mod 10 is fixed, and the half's operands come from a
// rotation of g by 5 half limbs (gr) and from selects made once: f's odd
// limbs doubled where j is odd (j's parity is j0's flipped in half 1), g's
// limb times 19 where i > 5 half + kk (never for i <= kk, always for
// i > kk + 5, else in half 0 alone).
__device__ __forceinline__ Fe mul_pair(const Fe& f, const Fe& g, int half) {
    const bool hi = half != 0;
    uint32_t gr[LIMBS], gr19[LIMBS], gx[LIMBS], fe[LIMBS], fo[LIMBS];
#pragma unroll
    for (int m = 0; m < LIMBS; ++m) {
        gr[m] = hi ? g.v[(m + 5) % LIMBS] : g.v[m];
        gr19[m] = 19 * gr[m];
        gx[m] = hi ? gr[m] : gr19[m];
        fe[m] = hi ? 2 * f.v[m] : f.v[m];  // odd m, even j0: doubled in half 1
        fo[m] = hi ? f.v[m] : 2 * f.v[m];  // odd m, odd j0: doubled in half 0
    }
    uint64_t part[5] = {};
#pragma unroll
    for (int kk = 0; kk < 5; ++kk)
#pragma unroll
        for (int i = 0; i < LIMBS; ++i) {
            const int j0 = (kk - i + LIMBS) % LIMBS;
            const uint32_t a = (i & 1) ? ((j0 & 1) ? fo[i] : fe[i]) : f.v[i];
            const uint32_t b = i <= kk ? gr[j0] : i <= kk + 5 ? gx[j0] : gr19[j0];
            part[kk] += uint64_t(a) * b;
        }
    uint64_t h[LIMBS];
#pragma unroll
    for (int kk = 0; kk < 5; ++kk) {
        const uint64_t other = __shfl_xor_sync(0xffffffffu, part[kk], 1);
        h[kk] = hi ? other : part[kk];
        h[kk + 5] = hi ? part[kk] : other;
    }
    return tmx_ed::reduce(h);
}

}  // namespace

// ops/ed25519.py::_StrausArgs, field for field: tables (lanes, 4, 20),
// bits2 (lanes, steps), rx and ry (lanes, 20), int64 and contiguous; out
// (lanes,) bool
struct StrausArgs {
    const int64_t* table_x;
    const int64_t* table_y;
    const int64_t* table_t;
    const int64_t* bits2;
    const int64_t* rx;
    const int64_t* ry;
    int64_t lanes;
    int64_t steps;
    uint8_t* out;
};

// ops/ed25519.py::_BindArgs, field for field: the ladder's inputs (bits2
// of N_BITS steps), the signature halves, the public key (lanes, 32) and
// the challenge digest (lanes, 64) as bytes, k_q (lanes, 20) int64
struct BindArgs {
    const int64_t* table_x;
    const int64_t* table_y;
    const int64_t* table_t;
    const int64_t* bits2;
    const int64_t* rx;
    const int64_t* ry;
    const uint8_t* sig_r;
    const uint8_t* sig_s;
    const uint8_t* sig_pk;
    const uint8_t* digest;
    const int64_t* k_q;
    int64_t lanes;
    uint8_t* out;
};

namespace {

__global__ void __launch_bounds__(THREADS) tmx_straus_kernel(StrausArgs a) {
    // per lane of the block: [entry][y - x, y + x, 2d t], entry 4 all zero
    // (an out-of-range selector's); and 16 rows, three buffers of a phase's
    // four products (P0, P1, P2: the doubling's squares go to P1 and its
    // point to P0, the addition's first products to P1 and its point to P2,
    // where the next step's doubling reads it) and the four sums E, F, G, H
    // of a phase's point (S), one a pair; one zero row after them all. A
    // row is written (by the pair's first thread) only after every
    // thread's last read of it, a __syncwarp between.
    __shared__ Row ops[LADDER_LANES][5][3];
    __shared__ Row rows[LADDER_LANES * 16 + 1];
    const int q = threadIdx.x % LANE_THREADS / 2, half = threadIdx.x % 2, l = threadIdx.x / LANE_THREADS;
    const bool writer = half == 0;  // a pair computes one value; one thread stores it
    const int64_t mine = int64_t(blockIdx.x) * LADDER_LANES + l;
    // a lane's threads past the last lane repeat it and write nothing:
    // every thread of the warp takes part in each __syncwarp and shuffle
    const int64_t lane = mine < a.lanes ? mine : a.lanes - 1;
    const int64_t* tx = a.table_x + lane * 80;
    const int64_t* ty = a.table_y + lane * 80;
    const int64_t* tt = a.table_t + lane * 80;
    const int P0 = 16 * l, P1 = P0 + 4, P2 = P0 + 8, S = P0 + 12, Z0 = 16 * LADDER_LANES;
    if (writer) {  // pair q makes table entry q's operands
        const Fe x = tmx_ed::load13(tx + 20 * q), y = tmx_ed::load13(ty + 20 * q);
        put(ops[l][q][0], tmx_ed::sub(y, x));
        put(ops[l][q][1], tmx_ed::add(y, x));
        put(ops[l][q][2], tmx_ed::mul(tmx_ed::load13(tt + 20 * q), fe_const(D2_FE)));
        put(ops[l][4][q < 3 ? q : 2], Fe{});
        if (threadIdx.x == 0) put(rows[Z0], Fe{});
        // the ladder starts from the table's entry 0 as (x, y, y, t): pair
        // q's coordinate (T is never read: the doubling ignores it)
        put(rows[P2 + q], tmx_ed::load13(q == 0 ? tx : q == 3 ? tt : ty));
    }
    __syncwarp();

    // Each pair's operand rows, by its place q in the quad:
    //   doubling, squares   f = u1 + u2, g = f (q = 2: g = Z), from P2 =
    //                       (X, Y, Z, T): X^2, Y^2, 2 Z Z (= C), (X + Y)^2;
    //   doubling, sums      S[q] = u - (A + w) from P1 = (A, B, C, XY2):
    //                       E = XY2 - (A + B), F = B - (A + C),
    //                       G = B - (A + 0), H = 0 - (A + B);
    //   addition, products  (u -+ v) times the table operand, from P0 =
    //                       (X, Y, Z, T): (Y - X) ymx, (Y + X) ypx, T 2dt
    //                       (pair 3 repeats pair 2's);
    //   addition, sums      S[q] = (u1 + u2) -+ v from P1 = (A, B, C, C)
    //                       and P0's Z: E = (B + 0) - A, F = (Z + Z) - C,
    //                       G = (Z + Z) + C, H = (B + 0) + A;
    //   both points         S[f] S[g]: E F, G H, F G, E H.
    const bool mid = q == 1 || q == 2;
    const int dbl_u1 = P2 + (q == 3 ? 0 : q), dbl_u2 = q == 3 ? P2 + 1 : q == 2 ? P2 + 2 : Z0;
    const int dbl_u = q == 0 ? P1 + 3 : q == 3 ? Z0 : P1 + 1, dbl_w = q == 1 ? P1 + 2 : q == 2 ? Z0 : P1 + 1;
    const int add_u = q < 2 ? P0 + 1 : P0 + 3, add_v = q < 2 ? P0 : Z0;
    const uint32_t add_neg = q == 0 ? ~0u : 0u;
    const int sum_u1 = mid ? P0 + 2 : P1 + 1, sum_u2 = mid ? P0 + 2 : Z0, sum_v = mid ? P1 + 2 : P1;
    const uint32_t sum_neg = q < 2 ? ~0u : 0u;
    const int pt_f = S + (q == 1 ? 2 : q == 2 ? 1 : 0), pt_g = S + (q == 0 ? 1 : q == 2 ? 2 : 3);

    const int64_t* bits = a.bits2 + lane * a.steps;
    int64_t next = a.steps > 0 ? bits[0] : 0;
#pragma unroll 1
    for (int64_t i = 0; i < a.steps; ++i) {
        const int64_t b = next;
        if (i + 1 < a.steps) next = bits[i + 1];
        const int e = (b >= 0 && b <= 3) ? int(b) : 4;
        {  // doubling, squares
            const Fe f = tmx_ed::add(get(rows[dbl_u1]), get(rows[dbl_u2]));
            const Fe z = get(rows[P2 + 2]);
            Fe g;
#pragma unroll
            for (int k = 0; k < LIMBS; ++k) g.v[k] = q == 2 ? z.v[k] : f.v[k];
            const Fe r = mul_pair(f, g, half);
            if (writer) put(rows[P1 + q], r);
        }
        __syncwarp();
        {  // doubling, sums
            const Fe r = tmx_ed::sub(get(rows[dbl_u]), tmx_ed::add(get(rows[P1]), get(rows[dbl_w])));
            if (writer) put(rows[S + q], r);
        }
        __syncwarp();
        {  // the doubled point
            const Fe r = mul_pair(get(rows[pt_f]), get(rows[pt_g]), half);
            if (writer) put(rows[P0 + q], r);
        }
        __syncwarp();
        {  // addition, products
            const Fe f = tmx_ed::addsub(get(rows[add_u]), get(rows[add_v]), add_neg);
            const Fe r = mul_pair(f, get(ops[l][e][q < 3 ? q : 2]), half);
            if (writer) put(rows[P1 + q], r);
        }
        __syncwarp();
        {  // addition, sums
            const Fe r = tmx_ed::addsub(tmx_ed::add(get(rows[sum_u1]), get(rows[sum_u2])), get(rows[sum_v]), sum_neg);
            if (writer) put(rows[S + q], r);
        }
        __syncwarp();
        {  // the added point
            const Fe r = mul_pair(get(rows[pt_f]), get(rows[pt_g]), half);
            if (writer) put(rows[P2 + q], r);
        }
        __syncwarp();
    }
    // Q == R (R affine): X == rx Z on the quad's even pairs, Y == ry Z on
    // its odd ones; the lane's first thread (pair 0) reads pair 1's flag
    // two threads up
    const Fe Z = get(rows[P2 + 2]), Pq = get(rows[P2 + (q & 1)]);
    const Fe rz = tmx_ed::mul(tmx_ed::load13((q & 1 ? a.ry : a.rx) + lane * 20), Z);
    const unsigned ok = __ballot_sync(0xffffffffu, tmx_ed::eq(Pq, rz));
    if (threadIdx.x % LANE_THREADS == 0 && mine < a.lanes) a.out[lane] = ((ok >> threadIdx.x) & 5u) == 5u;
}

__device__ __forceinline__ bool in13(int64_t v) { return uint64_t(v) < 8192; }

// bits [13 i, 13 i + 13) of a little-endian integer of nbytes bytes, its
// bits at and above nbits dropped (ops/ed25519.py: bytes_le_to_limbs)
__device__ __forceinline__ uint32_t byte_limb(const uint8_t* b, int nbytes, int nbits, int i) {
    const int lo = 13 * i;
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
        if (lo / 8 + j < nbytes) w |= uint32_t(b[lo / 8 + j]) << (8 * j);
    const uint32_t v = (w >> (lo % 8)) & 0x1FFF;
    const int keep = nbits - lo;
    return keep >= 13 ? v : keep > 0 ? v & ((1u << keep) - 1) : 0;
}

// a < c for canonical 13-bit limbs
template <int N>
__device__ __forceinline__ bool lt(const uint32_t (&a)[N], const uint32_t (&c)[N]) {
    bool less = false, decided = false;
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
        less = decided ? less : a[k] < c[k];
        decided = decided || a[k] != c[k];
    }
    return less;
}

// -x^2 + y^2 == 1 + d x^2 y^2
__device__ __forceinline__ bool on_curve(const Fe& x, const Fe& y) {
    const Fe x2 = tmx_ed::sq(x), y2 = tmx_ed::sq(y);
    const Fe rhs = tmx_ed::add(fe_small(1), tmx_ed::mul(tmx_ed::mul(fe_const(D_FE), x2), y2));
    return tmx_ed::eq(tmx_ed::sub(y2, x2), rhs);
}

__global__ void __launch_bounds__(THREADS) tmx_bind_kernel(BindArgs a) {
    const int64_t lane = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (lane >= a.lanes) return;
    const int64_t* tx = a.table_x + lane * 80;
    const int64_t* ty = a.table_y + lane * 80;
    const int64_t* tt = a.table_t + lane * 80;
    const int64_t* bits = a.bits2 + lane * N_BITS;
    const int64_t* rx = a.rx + lane * 20;
    const int64_t* ry = a.ry + lane * 20;
    const int64_t* kq = a.k_q + lane * 20;
    const uint8_t* sig_r = a.sig_r + lane * 32;
    const uint8_t* sig_s = a.sig_s + lane * 32;
    const uint8_t* sig_pk = a.sig_pk + lane * 32;
    const uint8_t* digest = a.digest + lane * 64;

    // 0. limb and selector ranges: a lane outside them is false before any
    //    arithmetic
    bool ok = true;
#pragma unroll 4
    for (int i = 0; i < 80; ++i) ok &= in13(tx[i]) & in13(ty[i]) & in13(tt[i]);
#pragma unroll 4
    for (int i = 0; i < 20; ++i) ok &= in13(rx[i]) & in13(ry[i]) & in13(kq[i]);
#pragma unroll 11
    for (int i = 0; i < N_BITS; ++i) ok &= uint64_t(bits[i]) <= 3;
    if (!ok) {
        a.out[lane] = 0;
        return;
    }

    // 1. R: ry is the canonical 255-bit y of sig_r, (rx, ry) is on the
    //    curve and rx has the encoded parity
    uint32_t y_r[20], y_a[20];
#pragma unroll
    for (int i = 0; i < 20; ++i) {
        y_r[i] = byte_limb(sig_r, 32, 255, i);
        y_a[i] = byte_limb(sig_pk, 32, 255, i);
    }
    const uint32_t sign_r = sig_r[31] >> 7, sign_a = sig_pk[31] >> 7;
    const Fe RX = tmx_ed::load13(rx), RY = tmx_ed::load13(ry);
    ok &= lt(y_r, P13);
    ok &= tmx_ed::eq(RY, tmx_ed::load13(y_r));
    ok &= on_curve(RX, RY);
    ok &= (tmx_ed::canon(RX).v[0] & 1) == sign_r;

    // 2. the table: [identity, B, -A, B + (-A)], t = x y in every slot
    Fe X[4], Y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        X[j] = tmx_ed::load13(tx + 20 * j);
        Y[j] = tmx_ed::load13(ty + 20 * j);
    }
    const Fe bx = fe_const(BX_FE), by = fe_const(BY_FE), one = fe_small(1);
    ok &= tmx_ed::eq(X[0], fe_small(0)) & tmx_ed::eq(Y[0], one);
    ok &= tmx_ed::eq(X[1], bx) & tmx_ed::eq(Y[1], by);
#pragma unroll  // X and Y stay in registers only at compile-time indices
    for (int j = 0; j < 4; ++j) ok &= tmx_ed::eq(tmx_ed::load13(tt + 20 * j), tmx_ed::mul(X[j], Y[j]));
    // slot 2 = -A: y from the public key's bytes; negation flips x's parity
    ok &= lt(y_a, P13);
    ok &= tmx_ed::eq(Y[2], tmx_ed::load13(y_a));
    ok &= on_curve(X[2], Y[2]);
    const Fe c2x = tmx_ed::canon(X[2]);
    uint32_t nz = 0;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) nz |= c2x.v[k];
    ok &= nz ? (c2x.v[0] & 1) == 1 - sign_a : sign_a == 0;
    // slot 3 = slot 1 + slot 2, projectively, by the unified addition
    const Point s3 = tmx_ed::madd(Point{bx, by, one, fe_const(BT_FE)}, tmx_ed::sub(Y[2], X[2]),
                                  tmx_ed::add(Y[2], X[2]), tmx_ed::mul(tmx_ed::load13(tt + 40), fe_const(D2_FE)));
    ok &= tmx_ed::eq(tmx_ed::mul(X[3], s3.Z), s3.X) & tmx_ed::eq(tmx_ed::mul(Y[3], s3.Z), s3.Y);

    // 3. s: the s-bits of bits2 (MSB first) are sig_s, and s < L
    // 4. the challenge: k from the k-bits, k < L, and k_q L + k == h, the
    //    digest as a little-endian integer, limb by limb after one carry
    uint32_t s_rec[20] = {}, k_rec[20] = {}, s13[20];
#pragma unroll
    for (int i = 0; i < N_BITS; ++i) {
        const uint32_t b = uint32_t(bits[i]);
        const int pos = N_BITS - 1 - i;
        s_rec[pos / 13] |= (b & 1) << (pos % 13);
        k_rec[pos / 13] |= (b >> 1) << (pos % 13);
    }
#pragma unroll
    for (int i = 0; i < 20; ++i) s13[i] = byte_limb(sig_s, 32, 256, i);
    ok &= lt(s13, L13) & lt(k_rec, L13);
#pragma unroll
    for (int i = 0; i < 20; ++i) ok &= s_rec[i] == s13[i];
    uint32_t acc[40] = {};
#pragma unroll
    for (int i = 0; i < 20; ++i) {
        const uint32_t q = uint32_t(kq[i]);
#pragma unroll
        for (int j = 0; j < 20; ++j) acc[i + j] += q * L13[j];
        acc[i] += k_rec[i];
    }
#pragma unroll
    for (int i = 0; i < 39; ++i) {
        acc[i + 1] += acc[i] >> 13;
        acc[i] &= 0x1FFF;
    }
#pragma unroll
    for (int i = 0; i < 40; ++i) ok &= acc[i] == byte_limb(digest, 64, 512, i);
    a.out[lane] = ok;
}

// blocks of THREADS threads, `lanes_per_block` lanes each
template <typename Args>
int launch(void (*kernel)(Args), const Args& a, int lanes_per_block, void* stream) {
    if (a.lanes < 0) return (int)cudaErrorInvalidValue;
    if (a.lanes == 0) return 0;
    const int64_t blocks = (a.lanes + lanes_per_block - 1) / lanes_per_block;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tmx_straus_verify(const StrausArgs* args, void* stream) {
    if (args->steps < 0) return (int)cudaErrorInvalidValue;
    return launch(tmx_straus_kernel, *args, LADDER_LANES, stream);
}

extern "C" int tmx_bind_witness(const BindArgs* args, void* stream) {
    return launch(tmx_bind_kernel, *args, THREADS, stream);
}
