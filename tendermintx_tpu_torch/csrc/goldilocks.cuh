// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on canonical uint64
// values, for the hand kernels that run field programs (csrc/quotient.cu).
//
// Every function takes canonical operands (< p) and returns a canonical
// result, so the kernels' outputs equal the plain torch versions' bit for
// bit (ops/goldilocks.py stores the same canonical values in int64
// tensors, which the kernels read as uint64). A product is one 64x64->128
// multiply (mul.lo / mul.hi) and the reduction of the reference's
// reduce128: 2^64 == 2^32 - 1 and 2^96 == -1 (mod p).

#pragma once

#include <cstdint>

namespace tmx_gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPS = 0xFFFFFFFFULL;  // 2^64 mod p

__device__ __forceinline__ uint64_t canon(uint64_t x) { return x >= P ? x - P : x; }

// a + b: on a carry the true sum is s + 2^64 == s + EPS, below p.
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    const uint64_t s = a + b;
    return s < a ? s + EPS : canon(s);
}

// a - b: on a borrow the wrapped difference is a - b + 2^64; subtracting
// EPS gives a - b + p.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
    const uint64_t d = a - b;
    return a < b ? d - EPS : d;
}

// lo + 2^64 (hi_lo + 2^32 hi_hi) == lo - hi_hi + hi_lo * EPS (mod p).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
    const uint64_t hi_hi = hi >> 32;
    const uint64_t hi_lo = hi & EPS;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= EPS;  // borrow: t0 >= 2^64 - 2^32, no second wrap
    const uint64_t t1 = hi_lo * EPS;  // < 2^64
    uint64_t t2 = t0 + t1;
    if (t2 < t1) t2 += EPS;  // carry: t2 < t1 <= 2^64 - 2^33 + 1, no second wrap
    return canon(t2);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace tmx_gl
