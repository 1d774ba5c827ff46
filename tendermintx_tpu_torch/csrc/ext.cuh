// The quadratic extension GF(p^2) = GF(p)[X] / (X^2 - 7) over Goldilocks
// (ops/ext.py), for the hand kernels that compute in it (csrc/deep.cu,
// csrc/ood.cu, csrc/logup.cu, csrc/fri.cu). Each
// function takes and returns canonical (c0, c1) pairs, so a kernel's
// output equals the plain torch version's GF2 arithmetic bit for bit.

#pragma once

#include <cstdint>

#include "goldilocks.cuh"

namespace tmx_ext {

constexpr uint64_t W = 7;  // ops/ext.py: W

struct E2 {
    uint64_t c0, c1;
};

__device__ __forceinline__ E2 add(E2 a, E2 b) { return {tmx_gl::add(a.c0, b.c0), tmx_gl::add(a.c1, b.c1)}; }

__device__ __forceinline__ E2 sub(E2 a, E2 b) { return {tmx_gl::sub(a.c0, b.c0), tmx_gl::sub(a.c1, b.c1)}; }

// (a0 + a1 X)(b0 + b1 X) = a0 b0 + W a1 b1 + (a0 b1 + a1 b0) X
__device__ __forceinline__ E2 mul(E2 a, E2 b) {
    const uint64_t a0b0 = tmx_gl::mul(a.c0, b.c0), a1b1 = tmx_gl::mul(a.c1, b.c1);
    const uint64_t a0b1 = tmx_gl::mul(a.c0, b.c1), a1b0 = tmx_gl::mul(a.c1, b.c0);
    return {tmx_gl::add(a0b0, tmx_gl::mul(a1b1, W)), tmx_gl::add(a0b1, a1b0)};
}

// a times a base value
__device__ __forceinline__ E2 scale(E2 a, uint64_t s) { return {tmx_gl::mul(a.c0, s), tmx_gl::mul(a.c1, s)}; }

// y[i] <- y[i] / n[i] for B extension values over B canonical base values
// at once, by Montgomery's trick: on the way up each y[i] is multiplied by
// the product of the n before it, on the way down by the inverse of the
// product up to n[i], which one inversion starts and each n[i] steps back
// (6 multiplies an element and one inv). A zero n[i] is masked to 1 in the
// products, so the others stay exact, and its y[i] becomes 0 (inv(0) =
// 0). 1/d for d = d0 + d1 X is batch_div of y = conj(d) over n = N(d) =
// d0^2 - W d1^2. Three words an element stay in registers (y[i], n[i]),
// so B is a compile-time constant and the loops unroll.
template <int B>
__device__ __forceinline__ void batch_div(uint64_t (&n)[B], E2 (&y)[B]) {
    uint64_t pre = 1;  // n[0] ... n[i-1], below 2^64
#pragma unroll
    for (int i = 0; i < B; ++i) {
        if (n[i] == 0) {
            n[i] = 1;
            y[i] = E2{0, 0};
        }
        if (i) y[i] = E2{tmx_gl::mul_nc(y[i].c0, pre), tmx_gl::mul_nc(y[i].c1, pre)};
        pre = i ? tmx_gl::mul_nc(pre, n[i]) : n[i];
    }
    uint64_t acc = tmx_gl::inv(tmx_gl::canon(pre));  // 1 / (n[0] ... n[B-1])
#pragma unroll
    for (int i = B - 1; i >= 0; --i) {
        y[i] = scale(y[i], acc);
        if (i) acc = tmx_gl::mul_nc(acc, n[i]);  // 1 / (n[0] ... n[i-1])
    }
}

// A prepared operand: b and W b1, so a product by it is two dots of two
// products each, summed unreduced in a 160-bit Acc (goldilocks.cuh) and
// reduced once: a b = (a0 b0 + a1 (W b1), a0 b1 + a1 b0). A chain of such
// products is about half as deep as mul's (a1 b1, then W times it, then
// the sum, each reduced).
struct P2 {
    uint64_t c0, c1, w1;
};

__device__ __forceinline__ P2 prepare(E2 b) { return {b.c0, b.c1, tmx_gl::mul(b.c1, W)}; }

// a times a prepared b (a's words any 64-bit values, the result canonical)
__device__ __forceinline__ E2 mul_pre(E2 a, const P2& b) {
    tmx_gl::Acc s0{}, s1{};
    tmx_gl::mac(s0, a.c0, b.c0);
    tmx_gl::mac(s0, a.c1, b.w1);
    tmx_gl::mac(s1, a.c0, b.c1);
    tmx_gl::mac(s1, a.c1, b.c0);
    return {tmx_gl::reduce(s0), tmx_gl::reduce(s1)};
}

// x^2, prepared: (x0^2 + x1 (W x1), 2 x0 x1) and W times the latter, 2 x0
// (W x1): three independent dots
__device__ __forceinline__ P2 sq_pre(const P2& x) {
    tmx_gl::Acc s0{}, s1{}, s2{};
    tmx_gl::mac(s0, x.c0, x.c0);
    tmx_gl::mac(s0, x.c1, x.w1);
    tmx_gl::mac(s1, x.c0, x.c1);
    tmx_gl::mac(s1, x.c0, x.c1);
    tmx_gl::mac(s2, x.c0, x.w1);
    tmx_gl::mac(s2, x.c0, x.w1);
    return {tmx_gl::reduce(s0), tmx_gl::reduce(s1), tmx_gl::reduce(s2)};
}

}  // namespace tmx_ext
