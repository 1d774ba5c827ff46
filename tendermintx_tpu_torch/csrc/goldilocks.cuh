// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on canonical uint64
// values, for the hand kernels that run field programs (csrc/quotient.cu,
// csrc/ntt.cu, csrc/deep.cu, csrc/ood.cu, csrc/logup.cu, csrc/fri.cu).
//
// Every function takes canonical operands (< p) and returns a canonical
// result, so the kernels' outputs equal the plain torch versions' bit for
// bit (ops/goldilocks.py stores the same canonical values in int64
// tensors, which the kernels read as uint64). A product reduces as the
// reference's reduce128 does: 2^64 == 2^32 - 1 and 2^96 == -1 (mod p).

#pragma once

#include <cstdint>

namespace tmx_gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPS = 0xFFFFFFFFULL;  // 2^64 mod p

__device__ __forceinline__ uint64_t canon(uint64_t x) { return x >= P ? x - P : x; }

// a + b: s = a + b and t = s + EPS (mod 2^64) as PTX carry chains; the
// sum is t when a + b carried (the true sum s + 2^64 == s + EPS, below p)
// or when s >= p (then s + EPS carries and t = s - p), else s.
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    uint64_t r;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, s0, s1, t0, t1, c;\n\t"
        ".reg .pred q;\n\t"
        "mov.b64 {a0, a1}, %1;\n\t"
        "mov.b64 {b0, b1}, %2;\n\t"
        "add.cc.u32 s0, a0, b0;\n\t"
        "addc.cc.u32 s1, a1, b1;\n\t"
        "addc.u32 c, 0, 0;\n\t"
        "add.cc.u32 t0, s0, 0xFFFFFFFF;\n\t"
        "addc.cc.u32 t1, s1, 0;\n\t"
        "addc.u32 c, c, 0;\n\t"
        "setp.ne.u32 q, c, 0;\n\t"
        "selp.b32 s0, t0, s0, q;\n\t"
        "selp.b32 s1, t1, s1, q;\n\t"
        "mov.b64 %0, {s0, s1};\n\t"
        "}"
        : "=l"(r)
        : "l"(a), "l"(b));
    return r;
}

// a - b: on a borrow the wrapped difference is a - b + 2^64; subtracting
// EPS (the borrow's all-ones low word) gives a - b + p.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    uint64_t r;
    asm("{\n\t"
        ".reg .u32 a0, a1, b0, b1, d0, d1, m;\n\t"
        "mov.b64 {a0, a1}, %1;\n\t"
        "mov.b64 {b0, b1}, %2;\n\t"
        "sub.cc.u32 d0, a0, b0;\n\t"
        "subc.cc.u32 d1, a1, b1;\n\t"
        "subc.u32 m, 0, 0;\n\t"
        "sub.cc.u32 d0, d0, m;\n\t"
        "subc.u32 d1, d1, 0;\n\t"
        "mov.b64 %0, {d0, d1};\n\t"
        "}"
        : "=l"(r)
        : "l"(a), "l"(b));
    return r;
}

// a * b below 2^64 but not always canonical, for any 64-bit a and b: four
// 32x32->64 products summed as a PTX carry chain on 32-bit halves
// (csrc/poseidon.cu's form: about one SASS instruction a line), the
// 128-bit product lo + 2^64 (r2 + 2^32 r3) reduced with 2^64 == EPS and
// 2^96 == -1. For a value that only feeds further products (mul_nc, mac)
// or canon; mul makes it canonical.
__device__ __forceinline__ uint64_t mul_nc(uint64_t a, uint64_t b) {
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

// a * b, canonical
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return canon(mul_nc(a, b)); }

// -a: p - a, and 0 for 0.
__device__ __forceinline__ uint64_t neg(uint64_t a) { return a ? P - a : 0; }

// a^(2^k): k squarings
__device__ __forceinline__ uint64_t sqn(uint64_t a, int k) {
#pragma unroll
    for (int i = 0; i < k; ++i) a = mul(a, a);
    return a;
}

// 1/a as the Fermat power a^(p-2), and 0 for 0 (ops/goldilocks.py: inv).
// p - 2 = (2^32 - 2) 2^32 + (2^32 - 1): the chain builds a^(2^k - 1) for
// k = 2, 4, 8, 16, 24, 28, 30, 31, then a^(2^32 - 2) and a^(2^32 - 1), in
// 63 squarings and 10 multiplies (square-and-multiply takes 63 and 62).
// The power is unique, so the result equals the plain version's.
__device__ __forceinline__ uint64_t inv(uint64_t a) {
    const uint64_t t2 = mul(sqn(a, 1), a);
    const uint64_t t4 = mul(sqn(t2, 2), t2);
    const uint64_t t8 = mul(sqn(t4, 4), t4);
    const uint64_t t16 = mul(sqn(t8, 8), t8);
    const uint64_t t24 = mul(sqn(t16, 8), t8);
    const uint64_t t28 = mul(sqn(t24, 4), t4);
    const uint64_t t30 = mul(sqn(t28, 2), t2);
    const uint64_t t31 = mul(sqn(t30, 1), a);
    const uint64_t u = sqn(t31, 1);  // a^(2^32 - 2)
    return mul(sqn(u, 32), mul(u, a));
}

// A 160-bit unreduced sum of 128-bit products, five 32-bit limbs (least
// significant first): csrc/deep.cu's and csrc/ood.cu's dot products add
// each product of canonical values (below (p-1)^2 < 2^128) by one carry
// chain of multiply-adds and reduce once. 2^32 - 1 products never wrap it
// (stark/prover.py: DEEP_MAX_COLUMNS, and an OOD slice is far shorter).
struct Acc {
    uint32_t w[5];
};

// s += b * t for 64-bit b and t: the four 32 x 32 partial products added
// into the limbs by one carry chain each (b0 t0 and b1 t1 at limbs 0-3,
// then b0 t1 and b1 t0 at limbs 1-2), carries rippled to limb 4
__device__ __forceinline__ void mac(Acc& s, uint64_t b, uint64_t t) {
    const uint32_t b0 = uint32_t(b), b1 = uint32_t(b >> 32), t0 = uint32_t(t), t1 = uint32_t(t >> 32);
    asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %8, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %8, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "mad.lo.cc.u32 %1, %5, %8, %1;\n\t"
        "madc.hi.cc.u32 %2, %5, %8, %2;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.u32 %4, %4, 0;\n\t"
        "mad.lo.cc.u32 %1, %6, %7, %1;\n\t"
        "madc.hi.cc.u32 %2, %6, %7, %2;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(s.w[0]), "+r"(s.w[1]), "+r"(s.w[2]), "+r"(s.w[3]), "+r"(s.w[4])
        : "r"(b0), "r"(b1), "r"(t0), "r"(t1));
}

// the canonical value of the sum: a0 + a1 2^32 + a2 2^64 + a3 2^96 +
// a4 2^128 == (a0 + a1 2^32) + a2 (2^32 - 1) - a3 - a4 2^32 (mod p);
// a2 (2^32 - 1) <= p - 2^32 and a4 2^32 <= p - 1 are canonical
__device__ __forceinline__ uint64_t reduce(const Acc& s) {
    uint64_t x = canon(uint64_t(s.w[0]) | (uint64_t(s.w[1]) << 32));
    x = add(x, uint64_t(s.w[2]) * EPS);
    x = sub(x, s.w[3]);
    return sub(x, uint64_t(s.w[4]) << 32);
}

}  // namespace tmx_gl
