// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on canonical uint64
// values, for the hand kernels that run field programs (csrc/quotient.cu,
// csrc/ntt.cu, csrc/deep.cu).
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

// a * b: four 32x32->64 products summed as a PTX carry chain on 32-bit
// halves (csrc/poseidon.cu's form: about one SASS instruction a line), the
// 128-bit product lo + 2^64 (r2 + 2^32 r3) reduced with 2^64 == EPS and
// 2^96 == -1 to a value below 2^64, then made canonical.
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
    return canon(r);
}

// -a: p - a, and 0 for 0.
__device__ __forceinline__ uint64_t neg(uint64_t a) { return a ? P - a : 0; }

}  // namespace tmx_gl
