// Arithmetic mod p = 2^255 - 19 and the Edwards point formulas of the
// Ed25519 witness kernels (csrc/ed25519.cu).
//
// A field element is 10 unsigned limbs in ref10's radix 2^25.5: limb k
// holds bits [off(k), off(k + 1)) of the value, 26 bits wide for even k and
// 25 for odd k. A product is 100 32 x 32 -> 64-bit multiply-adds into ten
// 64-bit sums (a limb pair of two odd limbs counted twice, a pair past
// 2^255 times 19, since 2^255 = 19 mod p), then one carry chain. A sum or
// a difference (plus 2p, so that it stays non-negative) is followed by one
// carry pass in which every limb hands its bits above its width to the next
// at once, limb 9's to limb 0 times 19. Limbs are kept *bounded*, not
// canonical: every value these functions return has limbs of at most
// 2^26 + 2^15 (even k) and 2^25 + 2^15 (odd k), every product sum stays
// below 2^61 and every 32-bit intermediate below 2^31
// (tests/test_torch_witness_kernels.py proves the bounds on a host model of
// this file, step for step). `canon` reduces into [0, p) and every
// comparison is on canonical values, so results equal the plain torch
// versions' (ops/ed25519.py), whose 13-bit limbs hold the same values mod p.

#pragma once

#include <cstdint>

namespace tmx_ed {

constexpr int LIMBS = 10;

__host__ __device__ constexpr int off(int k) { return (51 * k + 1) / 2; }
__host__ __device__ constexpr int width(int k) { return off(k + 1) - off(k); }
__host__ __device__ constexpr uint32_t lmask(int k) { return (1u << width(k)) - 1; }
// 2p in this radix: 2 (2^width - 1), limb 0 2 (2^26 - 19)
__host__ __device__ constexpr uint32_t two_p(int k) { return k ? (2u << width(k)) - 2 : (1u << 27) - 38; }

struct Fe {
    uint32_t v[LIMBS];
};

// one carry pass, all limbs at once (limbs below 2^31 in)
__device__ __forceinline__ Fe carry(Fe h) {
    uint32_t c[LIMBS];
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) {
        c[k] = h.v[k] >> width(k);
        h.v[k] &= lmask(k);
    }
#pragma unroll
    for (int k = 1; k < LIMBS; ++k) h.v[k] += c[k - 1];
    h.v[0] += 19 * c[LIMBS - 1];
    return h;
}

__device__ __forceinline__ Fe add(const Fe& f, const Fe& g) {
    Fe h;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) h.v[k] = f.v[k] + g.v[k];
    return carry(h);
}

// f - g + 2p: non-negative limb by limb, since g's limbs are at most 2p's
__device__ __forceinline__ Fe sub(const Fe& f, const Fe& g) {
    Fe h;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) h.v[k] = f.v[k] + two_p(k) - g.v[k];
    return carry(h);
}

// f + g, or f - g + 2p where `neg` is all ones (0 where it is zero): the
// limb sums of add or sub, g's limbs complemented under the mask (~g + 1 =
// -g mod 2^32), so that threads that add and threads that subtract run one
// instruction stream
__device__ __forceinline__ Fe addsub(const Fe& f, const Fe& g, uint32_t neg) {
    Fe h;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) h.v[k] = f.v[k] + (g.v[k] ^ neg) + ((two_p(k) + 1) & neg);
    return carry(h);
}

// ref10's carry chain over the ten 64-bit product sums, interleaved as two
// chains (from limbs 0 and 4) for parallelism, limb 9's carry re-entering
// limb 0 times 19
__host__ __device__ constexpr int carry_order(int s) {  // 0 4 1 5 2 6 3 7 4 8 9 0
    return s == 10 ? 9 : s == 11 ? 0 : (s & 1) ? s / 2 + 4 : s / 2;
}

__device__ __forceinline__ Fe reduce(uint64_t (&h)[LIMBS]) {
#pragma unroll
    for (int s = 0; s < 12; ++s) {
        const int k = carry_order(s);
        const uint64_t c = h[k] >> width(k);
        h[k] &= lmask(k);
        if (k == LIMBS - 1)
            h[0] += 19 * c;
        else
            h[k + 1] += c;
    }
    Fe r;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) r.v[k] = uint32_t(h[k]);
    return r;
}

// f g: limb i of f times limb j of g has weight 2^(off(i) + off(j)), which
// is 2^off(i + j) times 2 when i and j are both odd; past limb 9 it wraps
// to limb i + j - 10 times 19
__device__ __forceinline__ Fe mul(const Fe& f, const Fe& g) {
    uint32_t g19[LIMBS], f2[LIMBS];
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) {
        g19[k] = 19 * g.v[k];
        f2[k] = 2 * f.v[k];
    }
    uint64_t h[LIMBS] = {};
#pragma unroll
    for (int i = 0; i < LIMBS; ++i)
#pragma unroll
        for (int j = 0; j < LIMBS; ++j) {
            const uint32_t a = (i & j & 1) ? f2[i] : f.v[i];
            const uint32_t b = i + j >= LIMBS ? g19[j] : g.v[j];
            h[(i + j) % LIMBS] += uint64_t(a) * b;
        }
    return reduce(h);
}

__device__ __forceinline__ Fe sq(const Fe& f) { return mul(f, f); }

// the canonical value in [0, p): a sequential carry (every limb within its
// width, bits at 2^255 folded back times 19: the value is then below 2p),
// q = 1 exactly when value + 19 reaches 2^255 (value >= p), and value + 19 q
// carried once more with bit 255 dropped
__device__ __forceinline__ Fe canon(Fe f) {
#pragma unroll
    for (int k = 0; k < LIMBS - 1; ++k) {
        f.v[k + 1] += f.v[k] >> width(k);
        f.v[k] &= lmask(k);
    }
    f.v[0] += 19 * (f.v[LIMBS - 1] >> width(LIMBS - 1));
    f.v[LIMBS - 1] &= lmask(LIMBS - 1);
    uint32_t q = (f.v[0] + 19) >> width(0);
#pragma unroll
    for (int k = 1; k < LIMBS; ++k) q = (f.v[k] + q) >> width(k);
    f.v[0] += 19 * q;
#pragma unroll
    for (int k = 0; k < LIMBS - 1; ++k) {
        f.v[k + 1] += f.v[k] >> width(k);
        f.v[k] &= lmask(k);
    }
    f.v[LIMBS - 1] &= lmask(LIMBS - 1);
    return f;
}

__device__ __forceinline__ bool eq(const Fe& f, const Fe& g) {
    const Fe a = canon(f), b = canon(g);
    uint32_t d = 0;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) d |= a.v[k] ^ b.v[k];
    return d == 0;
}

// 20 limbs of 13 bits (each in [0, 2^13)), the value sum l_i 2^(13 i) <
// 2^260, as a field element: limb k gathers the bits [off(k), off(k + 1))
// from the 13-bit limbs that hold them; bits 255-259 (limb 19's top five)
// re-enter limb 0 times 19
template <typename T>
__device__ __forceinline__ Fe load13(const T* l) {
    Fe f;
#pragma unroll
    for (int k = 0; k < LIMBS; ++k) {
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < 20; ++i) {
            const int s = 13 * i - off(k);  // where limb i's bit 0 lands in limb k
            if (s > -13 && s < width(k)) {
                const uint32_t li = uint32_t(l[i]);
                v |= (s >= 0 ? li << s : li >> -s) & lmask(k);
            }
        }
        f.v[k] = v;
    }
    f.v[0] += 19 * (uint32_t(l[19]) >> 8);
    return f;
}

// extended coordinates (X : Y : Z : T), a = -1
struct Point {
    Fe X, Y, Z, T;
};

// dbl-2008-hwcd, as ops/ed25519.py::_pt_double writes it (T is not read)
__device__ __forceinline__ Point dbl(const Point& p) {
    const Fe xy = add(p.X, p.Y);
    const Fe A = sq(p.X), B = sq(p.Y), Csq = sq(p.Z), XY2 = sq(xy);
    const Fe C = add(Csq, Csq), AB = add(A, B);
    const Fe G = sub(B, A);
    const Fe F = sub(G, C), H = sub(Fe{}, AB), E = sub(XY2, AB);
    return {mul(E, F), mul(G, H), mul(F, G), mul(E, H)};
}

// unified mixed addition with an affine point given as (y - x, y + x,
// 2d x y), as ops/ed25519.py::_pt_madd_pre writes it
__device__ __forceinline__ Point madd(const Point& p, const Fe& ymx2, const Fe& ypx2, const Fe& t2d2) {
    const Fe ymx1 = sub(p.Y, p.X), ypx1 = add(p.Y, p.X), D = add(p.Z, p.Z);
    const Fe A = mul(ymx1, ymx2), B = mul(ypx1, ypx2), C = mul(p.T, t2d2);
    const Fe E = sub(B, A), F = sub(D, C), G = add(D, C), H = add(B, A);
    return {mul(E, F), mul(G, H), mul(F, G), mul(E, H)};
}

}  // namespace tmx_ed
