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
// the pair's halves and checks the bounds).
//
// The binding is bound by its loads and its chain, not its work (~20 field
// products and the 20 x 20 limb product k_q L a lane, ~4.6 KB of inputs).
// A block takes 4 lanes and two warps, each with the ladder's layout (8
// threads a lane; 32 blocks at N = 128). The block first copies its lanes'
// rows of all eleven inputs into shared memory as contiguous spans, one
// burst of 16-byte cp.async copies (csrc/stage.cuh; a lane's 2,024-byte
// selector row is not a multiple of 16), where a thread a lane made ~50
// dependent strided loads. The range checks run over those rows, a lane's
// 553 int64 values split over its 16 threads, one vote a warp; a block
// whose lanes all fail them writes false before any arithmetic, and a
// failing lane of a block that goes on is false whatever its arithmetic
// gives (it runs on its limbs masked to 13 bits). Then the two warps run
// side by side on their own schedulers. Warp 1 takes the scalar checks:
// each thread recomposes the s and k limbs it owns (limbs t, t + 8, t + 16
// of 20) from the selectors and compares s with sig_s's; four threads
// compare y_R, y_A, s and k against p or L; k_q L + k runs as 40 column
// sums, five a thread, and one 39-step carry. Warp 0 takes the field
// checks: five phases of four independent products, a quad of thread
// pairs a lane and a pair a product (mul_pair), in the order their
// dependencies allow (the squares; d x^2, 2d t, A; d x^2 y^2, B, C; the
// slot-3 point and t = x y of slot 2; its check and t = x y of slot 3),
// two phases of sums one a thread, and sixteen canonical comparisons two
// a thread, every operand addressed by its row in the tables
// BIND_PRODUCTS, BIND_SUMS and BIND_CHECKS. Slot 0's and slot 1's t = x y
// checks become t == 0 and t == B's t, equal under the checks that their
// x and y are the identity's and B's. Each entry has a plain C interface,
// launches on the caller's stream and returns cudaGetLastError(); the
// kernels allocate nothing.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "ed25519.cuh"
#include "stage.cuh"

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

// ops/ed25519.py's 2d in radix 2^25.5 (tests/test_torch_witness_kernels.py
// checks it and BIND_FE against the Python values)
__constant__ uint32_t D2_FE[LIMBS] = {0x2b2f159, 0x1a6e509, 0x22add7a, 0x0d4141d, 0x0038052,
                                      0x0f3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x0901b67};
// limb j of p and of the group order L in 13-bit limbs, at compile time
// (the k_q L column sums skip L's nine zero limbs)
__host__ __device__ constexpr uint32_t p13(int j) { return j == 0 ? 8173 : j == 19 ? 255 : 8191; }
__host__ __device__ constexpr uint32_t l13(int j) {
    return j == 0 ? 5101 : j == 1 ? 1966 : j == 2 ? 1687 : j == 3 ? 1222 : j == 4 ? 1409 : j == 5 ? 3691
         : j == 6 ? 3038 : j == 7 ? 7124 : j == 8 ? 7929 : j == 9 ? 166 : j == 19 ? 32 : 0;
}

__device__ __forceinline__ Fe fe_const(const uint32_t (&c)[LIMBS]) {
    Fe f;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) f.v[k] = c[k];
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

// a < L (`order`) or a < p for canonical 13-bit limbs
__device__ __forceinline__ bool lt20(const uint32_t* a, bool order) {
    bool less = false, decided = false;
#pragma unroll
    for (int k = 19; k >= 0; --k) {
        const uint32_t c = order ? l13(k) : p13(k);
        less = decided ? less : a[k] < c;
        decided = decided || a[k] != c;
    }
    return less;
}

// The binding's field elements, one 12-word row each in shared memory: the
// constants (one copy a block), then each lane's inputs (its 13-bit limbs
// made field elements: R's x and y, the table's x, y and t by slot, y_R and
// y_A from the key and signature bytes), sums and products, in this order
// (tests/test_torch_witness_kernels.py reads the list and the tables)
enum BindRow : uint8_t {
    K_ZERO, K_ONE, K_TWO, K_BX, K_BY, K_BT, K_D, K_D2, K_YMX_B, K_YPX_B,
    R_RX, R_RY, R_X0, R_X1, R_X2, R_X3, R_Y0, R_Y1, R_Y2, R_Y3, R_T0, R_T1, R_T2, R_T3, R_YR, R_YA,
    R_YMX, R_YPX, R_RX2, R_RY2, R_AX2, R_AY2, R_DRX2, R_DAX2, R_T2D, R_A, R_DRXY, R_DAXY, R_B, R_C,
    R_E, R_F, R_G, R_H, R_LR, R_RR, R_LA, R_RA, R_X3P, R_Y3P, R_Z3P, R_TXY2, R_X3Z, R_Y3Z, R_TXY3,
    R_NONE,  // a table entry that writes nothing
    N_ROWS
};
constexpr int N_KONST = R_RX;
constexpr int LANE_ROWS = N_ROWS - N_KONST;

// the constant rows K_ZERO .. K_YPX_B: 0, 1, 2, B's x, y and t, d, 2d, and
// B's y - x and y + x (mod p, canonical)
__constant__ uint32_t BIND_FE[N_KONST][LIMBS] = {
    {0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000},
    {0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000},
    {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000},
    {0x325d51a, 0x18b5823, 0x0f6592a, 0x104a92d, 0x1a4b31d, 0x1d6dc5c, 0x27118fe, 0x07fd814, 0x13cd6e5, 0x085a4db},
    {0x2666658, 0x1999999, 0x0cccccc, 0x1333333, 0x1999999, 0x0666666, 0x3333333, 0x0cccccc, 0x2666666, 0x1999999},
    {0x1b7dda3, 0x1a2ace9, 0x25eadbb, 0x003ba8a, 0x083c27e, 0x0abe37d, 0x1274732, 0x0ccacdd, 0x0fd78b7, 0x19e1d7c},
    {0x35978a3, 0x0d37284, 0x3156ebd, 0x06a0a0e, 0x001c029, 0x179e898, 0x3a03cbb, 0x1ce7198, 0x2e2b6ff, 0x1480db3},
    {0x2b2f159, 0x1a6e509, 0x22add7a, 0x0d4141d, 0x0038052, 0x0f3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x0901b67},
    {0x340913e, 0x00e4175, 0x3d673a2, 0x02e8a05, 0x3f4e67c, 0x08f8a09, 0x0c21a34, 0x04cf4b8, 0x1298f81, 0x113f4be},
    {0x18c3b85, 0x124f1bd, 0x1c325f7, 0x037dc60, 0x33e4cb7, 0x03d42c2, 0x1a44c32, 0x14ca4e1, 0x3a33d4b, 0x01f3e74},
};

// The field products, five phases of one a pair: {f, g, product}. R and
// -A on the curve (-x^2 + y^2 == 1 + d x^2 y^2: x^2, y^2, d x^2, d x^2
// y^2), slot 3 = B + slot 2 by ed25519.cuh's madd (A = (y - x)_B (y -
// x)_2, B = (y + x)_B (y + x)_2, C = t_B 2d t_2, then E F, G H, F G) and
// its projective check (x_3 Z, y_3 Z), and t = x y of slots 2 and 3.
__constant__ uint8_t BIND_PRODUCTS[5][QUAD][3] = {
    {{R_RX, R_RX, R_RX2}, {R_RY, R_RY, R_RY2}, {R_X2, R_X2, R_AX2}, {R_Y2, R_Y2, R_AY2}},
    {{K_D, R_RX2, R_DRX2}, {K_D, R_AX2, R_DAX2}, {R_T2, K_D2, R_T2D}, {K_YMX_B, R_YMX, R_A}},
    {{R_DRX2, R_RY2, R_DRXY}, {R_DAX2, R_AY2, R_DAXY}, {K_YPX_B, R_YPX, R_B}, {K_BT, R_T2D, R_C}},
    {{R_E, R_F, R_X3P}, {R_G, R_H, R_Y3P}, {R_F, R_G, R_Z3P}, {R_X2, R_Y2, R_TXY2}},
    {{R_X3, R_Z3P, R_X3Z}, {R_Y3, R_Z3P, R_Y3Z}, {R_X3, R_Y3, R_TXY3}, {K_ZERO, K_ZERO, R_NONE}},
};

// The sums, one a thread: {u, v, 1 for u - v (else u + v), sum}; the
// first set beside the first products (slot 2's y -+ x), the second after
// the third (madd's E, F, G, H with D = 2, each curve check's two sides)
__constant__ uint8_t BIND_SUMS[2][LANE_THREADS][4] = {
    {{R_Y2, R_X2, 1, R_YMX}, {R_Y2, R_X2, 0, R_YPX}, {K_ZERO, K_ZERO, 0, R_NONE}, {K_ZERO, K_ZERO, 0, R_NONE},
     {K_ZERO, K_ZERO, 0, R_NONE}, {K_ZERO, K_ZERO, 0, R_NONE}, {K_ZERO, K_ZERO, 0, R_NONE}, {K_ZERO, K_ZERO, 0, R_NONE}},
    {{R_B, R_A, 1, R_E}, {K_TWO, R_C, 1, R_F}, {K_TWO, R_C, 0, R_G}, {R_B, R_A, 0, R_H},
     {R_RY2, R_RX2, 1, R_LR}, {K_ONE, R_DRXY, 0, R_RR}, {R_AY2, R_AX2, 1, R_LA}, {K_ONE, R_DAXY, 0, R_RA}},
};

// The canonical comparisons, two a thread: {kind, a, b}. CHK_EQ: a == b;
// CHK_SIGN_R: a's parity is R's sign bit; CHK_SIGN_A: a = -A's x, zero
// where A's sign bit is 0, else of the opposite parity
enum BindCheck : uint8_t { CHK_EQ, CHK_SIGN_R, CHK_SIGN_A };
__constant__ uint8_t BIND_CHECKS[LANE_THREADS][2][3] = {
    {{CHK_EQ, R_RY, R_YR}, {CHK_EQ, R_LR, R_RR}},
    {{CHK_SIGN_R, R_RX, K_ZERO}, {CHK_EQ, R_X0, K_ZERO}},
    {{CHK_EQ, R_Y0, K_ONE}, {CHK_EQ, R_X1, K_BX}},
    {{CHK_EQ, R_Y1, K_BY}, {CHK_EQ, R_T0, K_ZERO}},
    {{CHK_EQ, R_T1, K_BT}, {CHK_EQ, R_T2, R_TXY2}},
    {{CHK_EQ, R_T3, R_TXY3}, {CHK_EQ, R_Y2, R_YA}},
    {{CHK_EQ, R_LA, R_RA}, {CHK_SIGN_A, R_X2, K_ZERO}},
    {{CHK_EQ, R_X3Z, R_X3P}, {CHK_EQ, R_Y3Z, R_Y3P}},
};

// a block's staged rows (csrc/stage.cuh), by input: the three tables,
// bits2, rx, ry and k_q, the signature halves and key, the digest
constexpr int BIND_LANES = LADDER_LANES;
constexpr int64_t TABLE_ROW = 4 * 20 * 8, BITS_ROW = N_BITS * 8, LIMB_ROW = 20 * 8;
constexpr int64_t STAGED = 3 * tmx_stage::bytes(BIND_LANES * TABLE_ROW) + tmx_stage::bytes(BIND_LANES * BITS_ROW) +
                           3 * tmx_stage::bytes(BIND_LANES * LIMB_ROW) + 3 * tmx_stage::bytes(BIND_LANES * 32) +
                           tmx_stage::bytes(BIND_LANES * 64);

// a block's two warps: the field checks' and the scalar checks'
constexpr int BIND_THREADS = 2 * THREADS;

__global__ void __launch_bounds__(BIND_THREADS) tmx_bind_kernel(BindArgs a) {
    __shared__ __align__(16) uint8_t staged[STAGED];
    __shared__ Row konst[N_KONST];
    __shared__ Row rows[BIND_LANES][LANE_ROWS];
    __shared__ uint32_t lim[BIND_LANES][4][20];  // y_R, y_A, s (sig_s's) and k (the selectors') in 13-bit limbs
    __shared__ uint32_t acc[BIND_LANES][40];     // k_q L + k
    __shared__ unsigned votes[2];                 // each warp's failing threads
    // each warp takes the block's 4 lanes, 8 threads a lane
    const int warp = threadIdx.x / THREADS, lane_t = threadIdx.x % THREADS;
    const int t8 = lane_t % LANE_THREADS, q = t8 / 2, half = t8 % 2, l = lane_t / LANE_THREADS;
    const int64_t first = int64_t(blockIdx.x) * BIND_LANES, mine = first + l;
    const int n = int(a.lanes - first < BIND_LANES ? a.lanes - first : BIND_LANES);
    // a lane's threads past the last lane repeat it and write nothing:
    // every thread of a warp takes part in each shuffle and vote
    const int li = l < n ? l : n - 1;

    uint8_t* dst = staged;
    auto stage = [&](const void* base, int64_t row) {
        const uint8_t* s = tmx_stage::span(dst, static_cast<const uint8_t*>(base) + first * row, n * row,
                                           threadIdx.x, BIND_THREADS);
        dst += tmx_stage::bytes(BIND_LANES * row);
        return s + li * row;
    };
    const int64_t* tx = reinterpret_cast<const int64_t*>(stage(a.table_x, TABLE_ROW));
    const int64_t* ty = reinterpret_cast<const int64_t*>(stage(a.table_y, TABLE_ROW));
    const int64_t* tt = reinterpret_cast<const int64_t*>(stage(a.table_t, TABLE_ROW));
    const int64_t* bits = reinterpret_cast<const int64_t*>(stage(a.bits2, BITS_ROW));
    const int64_t* rx = reinterpret_cast<const int64_t*>(stage(a.rx, LIMB_ROW));
    const int64_t* ry = reinterpret_cast<const int64_t*>(stage(a.ry, LIMB_ROW));
    const int64_t* kq = reinterpret_cast<const int64_t*>(stage(a.k_q, LIMB_ROW));
    const uint8_t* sig_r = stage(a.sig_r, 32);
    const uint8_t* sig_s = stage(a.sig_s, 32);
    const uint8_t* sig_pk = stage(a.sig_pk, 32);
    const uint8_t* digest = stage(a.digest, 64);
    if (threadIdx.x < N_KONST) put(konst[threadIdx.x], fe_const(BIND_FE[threadIdx.x]));
    tmx_stage::wait();
    __syncthreads();

    // 0. limb and selector ranges, a lane's values split over its 16
    //    threads (8 in each warp); a block none of whose lanes passes
    //    writes false and stops
    const int r16 = warp * LANE_THREADS + t8;
    bool in_range = true;
#pragma unroll
    for (int i = r16; i < 80; i += 2 * LANE_THREADS) in_range &= in13(tx[i]) & in13(ty[i]) & in13(tt[i]);
    for (int i = r16; i < 20; i += 2 * LANE_THREADS) in_range &= in13(rx[i]) & in13(ry[i]) & in13(kq[i]);
#pragma unroll 4
    for (int i = r16; i < N_BITS; i += 2 * LANE_THREADS) in_range &= uint64_t(bits[i]) <= 3;
    const unsigned out_of_range = __ballot_sync(0xffffffffu, !in_range);
    if (lane_t == 0) votes[warp] = out_of_range;
    __syncthreads();
    const unsigned lane_bits = 0xFFu << (LANE_THREADS * l);
    in_range = ((votes[0] | votes[1]) & lane_bits) == 0;
    if (!__syncthreads_or(in_range)) {
        if (warp == 0 && t8 == 0 && mine < a.lanes) a.out[mine] = 0;
        return;
    }

    // Each lane's limbs are masked to 13 bits where they are read, which
    // changes no lane in range.
    bool ok = true;
    if (warp == 1) {
        // The scalar checks. 1. The y limbs of R's and A's encodings, and
        //    the s and k limbs the thread owns (t, t + 8, t + 16), s against
        //    sig_s's.
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int m = t8 + LANE_THREADS * k;
            if (m < 20) {
                lim[l][0][m] = byte_limb(sig_r, 32, 255, m);
                lim[l][1][m] = byte_limb(sig_pk, 32, 255, m);
                uint32_t s = 0, kb = 0;
#pragma unroll
                for (int b = 0; b < 13; ++b) {
                    const int pos = 13 * m + b;  // bits2 is MSB first: selector N_BITS - 1 - pos
                    const uint32_t sel = pos < N_BITS ? uint32_t(bits[N_BITS - 1 - pos]) & 3 : 0;
                    s |= (sel & 1) << b;
                    kb |= (sel >> 1) << b;
                }
                const uint32_t s13 = byte_limb(sig_s, 32, 256, m);
                ok &= s == s13;
                lim[l][2][m] = s13;
                lim[l][3][m] = kb;
            }
        }
        __syncwarp();
        // 2. y_R < p, y_A < p, s < L, k < L (threads 0-3), and the column
        //    sums of k_q L + k (columns t, t + 8, ..., t + 32)
        ok &= lt20(lim[l][t8 & 3], t8 & 2) || t8 >= 4;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            const int m = t8 + LANE_THREADS * k;
            uint32_t sum = m < 20 ? lim[l][3][m] : 0;
#pragma unroll
            for (int j = 0; j < 20; ++j) {
                const int i = m - j;
                if (l13(j) != 0 && i >= 0 && i < 20) sum += (uint32_t(kq[i]) & 0x1FFF) * l13(j);
            }
            acc[l][m] = sum;
        }
        __syncwarp();
        // 3. its carry (the lane's first thread), then k_q L + k == h limb
        //    by limb (the thread's columns)
        if (t8 == 0) {
            uint32_t c[40];
#pragma unroll
            for (int i = 0; i < 40; ++i) c[i] = acc[l][i];
#pragma unroll
            for (int i = 0; i < 39; ++i) {
                c[i + 1] += c[i] >> 13;
                c[i] &= 0x1FFF;
            }
#pragma unroll
            for (int i = 0; i < 40; ++i) acc[l][i] = c[i];
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            const int m = t8 + LANE_THREADS * k;
            ok &= acc[l][m] == byte_limb(digest, 64, 512, m);
        }
    } else {
        // The field checks. 1. The inputs as field elements (thread t makes
        //    inputs t and t + 8).
        auto row = [&](int r) -> Row& { return r < N_KONST ? konst[r] : rows[l][r - N_KONST]; };
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int i = t8 + LANE_THREADS * k;  // row R_RX + i
            uint32_t limbs[20];
            if (i < R_YR - R_RX) {
                const int64_t* src = i == 0 ? rx : i == 1 ? ry : (i < 6 ? tx : i < 10 ? ty : tt) + 20 * ((i - 2) % 4);
#pragma unroll
                for (int j = 0; j < 20; ++j) limbs[j] = uint32_t(src[j]) & 0x1FFF;
            } else {  // y_R, y_A: the point encodings' 255-bit y
#pragma unroll
                for (int j = 0; j < 20; ++j) limbs[j] = byte_limb(i == R_YR - R_RX ? sig_r : sig_pk, 32, 255, j);
            }
            put(row(R_RX + i), tmx_ed::load13(limbs));
        }
        __syncwarp();
        // 2. the sums and product phases in their order, a __syncwarp
        //    between a step's writes and the next step's reads
        auto sums = [&](int set) {
            const uint8_t* op = BIND_SUMS[set][t8];
            const Fe r = tmx_ed::addsub(get(row(op[0])), get(row(op[1])), op[2] ? ~0u : 0u);
            if (op[3] != R_NONE) put(row(op[3]), r);
        };
        auto products = [&](int phase) {
            const uint8_t* op = BIND_PRODUCTS[phase][q];
            const Fe r = mul_pair(get(row(op[0])), get(row(op[1])), half);
            if (half == 0 && op[2] != R_NONE) put(row(op[2]), r);
        };
        sums(0);
        products(0);
        __syncwarp();
        products(1);
        __syncwarp();
        products(2);
        __syncwarp();
        sums(1);
        __syncwarp();
        products(3);
        __syncwarp();
        products(4);
        __syncwarp();
        // 3. the comparisons
        const uint32_t sign_r = sig_r[31] >> 7, sign_a = sig_pk[31] >> 7;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const uint8_t* op = BIND_CHECKS[t8][k];
            const Fe ca = tmx_ed::canon(get(row(op[1]))), cb = tmx_ed::canon(get(row(op[2])));
            uint32_t d = 0;
#pragma unroll
            for (int j = 0; j < LIMBS; ++j) d |= ca.v[j] ^ cb.v[j];
            const uint32_t parity = ca.v[0] & 1;
            ok &= op[0] == CHK_EQ       ? d == 0
                  : op[0] == CHK_SIGN_R ? parity == sign_r
                                        : (d == 0 ? sign_a == 0 : parity == 1 - sign_a);
        }
    }
    const unsigned fails = __ballot_sync(0xffffffffu, !ok);
    if (lane_t == 0) votes[warp] = fails;
    __syncthreads();
    if (warp == 0 && t8 == 0 && mine < a.lanes) a.out[mine] = in_range && ((votes[0] | votes[1]) & lane_bits) == 0;
}

// blocks of `threads` threads, `lanes_per_block` lanes each
template <typename Args>
int launch(void (*kernel)(Args), const Args& a, int lanes_per_block, int threads, void* stream) {
    if (a.lanes < 0) return (int)cudaErrorInvalidValue;
    if (a.lanes == 0) return 0;
    const int64_t blocks = (a.lanes + lanes_per_block - 1) / lanes_per_block;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tmx_straus_verify(const StrausArgs* args, void* stream) {
    if (args->steps < 0) return (int)cudaErrorInvalidValue;
    return launch(tmx_straus_kernel, *args, LADDER_LANES, THREADS, stream);
}

extern "C" int tmx_bind_witness(const BindArgs* args, void* stream) {
    return launch(tmx_bind_kernel, *args, BIND_LANES, BIND_THREADS, stream);
}
