"""Host models of the witness kernels (csrc/ed25519.cuh, csrc/ed25519.cu,
csrc/sha.cu) and the semantics their wrappers keep, on the CPU.

The CUDA kernels cannot run here, so the Ed25519 ladder's and binding's
schedules are modelled step for step in numpy uint64 over lanes: the same
radix 2^25.5 limbs, the same carry positions and order, the 19 fold, the
2p pad of a difference and the final canonicalisation. The models are held
equal to the plain torch versions (ops/ed25519.py) and to the pure-Python
oracle on the witness fixture of tests/test_torch_witness.py (whose
plain ladder is held equal to the JAX package's there), and every limb and
accumulator is checked against the bounds the kernel assumes, both on
these runs and by interval arithmetic over all inputs; the ladder's quad
code (a thread pair a product of each phase, a phase's sums one a pair,
both passed through shared memory) and the pair's half products are
modelled too. The SHA edge cases
pin the n_active semantics the SHA kernels keep, against the JAX package
and hashlib; the dispatch tests pin that a CPU tensor takes the plain
version and never counts a launch. Exact equality throughout."""

import hashlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_witness import _t, ladder_inputs  # noqa: F401  (the witness fixture)

from tendermintx_tpu.ops import sha256 as jsha256
from tendermintx_tpu.ops import sha512 as jsha512
from tendermintx_tpu_torch.circuits import gadgets
from tendermintx_tpu_torch.ops import ed25519 as ed
from tendermintx_tpu_torch.ops import sha256, sha512

P = ed.P25519
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tendermintx_tpu_torch", "csrc")

# ---------------------------------------------------------------------------
# csrc/ed25519.cuh: radix 2^25.5, bounded limbs
# ---------------------------------------------------------------------------

LIMBS = 10
OFF = [(51 * k + 1) // 2 for k in range(LIMBS + 1)]
WIDTH = [OFF[k + 1] - OFF[k] for k in range(LIMBS)]
MASK = [(1 << w) - 1 for w in WIDTH]
TWO_P = [(1 << 27) - 38] + [(2 << WIDTH[k]) - 2 for k in range(1, LIMBS)]
CARRY_ORDER = [0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0]
# the limb bounds the kernel keeps on every value it hands on (ed25519.cuh)
LIMB_BOUND = [(1 << WIDTH[k]) + (1 << 15) for k in range(LIMBS)]
PRODUCT_SUM_BOUND = 1 << 61
U32_BOUND = 1 << 31

_W = np.array(WIDTH, dtype=np.uint64)[:, None]
_M = np.array(MASK, dtype=np.uint64)[:, None]
_TWO_P = np.array(TWO_P, dtype=np.uint64)[:, None]
_LIMB_BOUND = np.array(LIMB_BOUND, dtype=np.uint64)[:, None]


def radix(x: int) -> list[int]:
    return [(x >> OFF[k]) & MASK[k] for k in range(LIMBS)]


def value(f: np.ndarray) -> list[int]:
    """Each lane's integer sum f_k 2^off(k)."""
    return [sum(int(f[k, i]) << OFF[k] for k in range(LIMBS)) for i in range(f.shape[1])]


class Model:
    """The kernels' field and point code on (10, lanes) uint64 arrays, each
    op asserting the bounds ed25519.cuh states: 32-bit intermediates below
    2^31, product sums below 2^61, limbs it returns within LIMB_BOUND."""

    def __init__(self):
        self.max32 = 0
        self.max64 = 0

    def _u32(self, x):
        self.max32 = max(self.max32, int(x.max()))
        assert self.max32 < U32_BOUND
        return x

    def _out(self, f):
        assert (f <= _LIMB_BOUND).all()
        return f

    def const(self, x: int, lanes: int):
        return np.tile(np.array(radix(x), dtype=np.uint64)[:, None], (1, lanes))

    def carry(self, h):
        h = self._u32(h)
        c = h >> _W
        h = h & _M
        h[1:] += c[:-1]
        h[0] += np.uint64(19) * c[-1]
        return self._out(self._u32(h))

    def add(self, f, g):
        return self.carry(f + g)

    def sub(self, f, g):
        assert (g <= _TWO_P).all()
        return self.carry(f + _TWO_P - g)

    def addsub(self, f, g, neg: bool):
        """f + (g ^ mask) + ((2p + 1) & mask) in 32-bit words, the mask all
        ones where `neg`: sub's limb sums, else add's."""
        if not neg:
            return self.add(f, g)
        assert (g <= _TWO_P).all()
        mask = np.uint64(0xFFFFFFFF)
        h = (f + (g ^ mask) + (_TWO_P + np.uint64(1))) & mask
        assert (h == f + _TWO_P - g).all()
        return self.carry(h)

    def mul(self, f, g):
        g19 = self._u32(np.uint64(19) * g)
        f2 = self._u32(np.uint64(2) * f)
        h = np.zeros_like(f)
        for i in range(LIMBS):
            for j in range(LIMBS):
                a = f2[i] if i & j & 1 else f[i]
                b = g19[j] if i + j >= LIMBS else g[j]
                h[(i + j) % LIMBS] += a * b
        self.max64 = max(self.max64, int(h.max()))
        assert self.max64 < PRODUCT_SUM_BOUND
        for k in CARRY_ORDER:
            c = h[k] >> np.uint64(WIDTH[k])
            h[k] &= np.uint64(MASK[k])
            if k == LIMBS - 1:
                h[0] += np.uint64(19) * c
            else:
                h[k + 1] += c
        return self._out(self._u32(h))

    def canon(self, f):
        f = f.copy()
        for k in range(LIMBS - 1):
            f[k + 1] += f[k] >> np.uint64(WIDTH[k])
            f[k] &= np.uint64(MASK[k])
        f[0] += np.uint64(19) * (f[-1] >> np.uint64(WIDTH[-1]))
        f[-1] &= np.uint64(MASK[-1])
        assert all(v < 2 * P for v in value(f))
        q = (f[0] + np.uint64(19)) >> np.uint64(WIDTH[0])
        for k in range(1, LIMBS):
            q = (f[k] + q) >> np.uint64(WIDTH[k])
        f[0] += np.uint64(19) * q
        for k in range(LIMBS - 1):
            f[k + 1] += f[k] >> np.uint64(WIDTH[k])
            f[k] &= np.uint64(MASK[k])
        f[-1] &= np.uint64(MASK[-1])
        self._u32(f)
        return f

    def eq(self, f, g):
        return (self.canon(f) == self.canon(g)).all(0)

    def load13(self, limbs):
        """(lanes, 20) limbs in [0, 2^13) -> (10, lanes): limb k gathers
        the bits [off(k), off(k + 1)), limb 19's top five bits re-enter
        limb 0 times 19."""
        l = np.asarray(limbs, dtype=np.int64).astype(np.uint64).T
        f = np.zeros((LIMBS, l.shape[1]), dtype=np.uint64)
        for k in range(LIMBS):
            for i in range(20):
                s = 13 * i - OFF[k]
                if -13 < s < WIDTH[k]:
                    part = (l[i] << np.uint64(s)) if s >= 0 else (l[i] >> np.uint64(-s))
                    f[k] |= part & np.uint64(MASK[k])
        f[0] += np.uint64(19) * (l[19] >> np.uint64(8))
        return self._out(f)

    def dbl(self, X, Y, Z):
        xy = self.add(X, Y)
        A, B, Csq, XY2 = self.mul(X, X), self.mul(Y, Y), self.mul(Z, Z), self.mul(xy, xy)
        C, AB = self.add(Csq, Csq), self.add(A, B)
        G = self.sub(B, A)
        F, H, E = self.sub(G, C), self.sub(np.zeros_like(AB), AB), self.sub(XY2, AB)
        return self.mul(E, F), self.mul(G, H), self.mul(F, G), self.mul(E, H)

    def madd(self, X, Y, Z, T, ymx2, ypx2, t2d2):
        ymx1, ypx1, D = self.sub(Y, X), self.add(Y, X), self.add(Z, Z)
        A, B, C = self.mul(ymx1, ymx2), self.mul(ypx1, ypx2), self.mul(T, t2d2)
        E, F, G, H = self.sub(B, A), self.sub(D, C), self.add(D, C), self.add(B, A)
        return self.mul(E, F), self.mul(G, H), self.mul(F, G), self.mul(E, H)

    def on_curve(self, x, y):
        x2, y2 = self.mul(x, x), self.mul(y, y)
        rhs = self.add(self.const(1, x.shape[1]), self.mul(self.mul(self.const(ed.D_ED, x.shape[1]), x2), y2))
        return self.eq(self.sub(y2, x2), rhs)


def straus_model(table_x, table_y, table_t, bits2, rx, ry, m: Model) -> np.ndarray:
    """tmx_straus_kernel, lane-parallel: the table operands (entry 4 all
    zero), the ladder from entry 0 as (x, y, y, t), one doubling and one
    mixed addition a selector, then X == rx Z and Y == ry Z."""
    B = table_x.shape[0]
    d2 = m.const(ed.D2_ED, B)
    ops = []
    for e in range(4):
        x, y, t = (m.load13(tab[:, e]) for tab in (table_x, table_y, table_t))
        ops.append((m.sub(y, x), m.add(y, x), m.mul(t, d2)))
    zero = np.zeros((LIMBS, B), dtype=np.uint64)
    ops.append((zero, zero, zero))
    X, Y, Z, T = m.load13(table_x[:, 0]), m.load13(table_y[:, 0]), m.load13(table_y[:, 0]), m.load13(table_t[:, 0])
    lanes = np.arange(B)
    for i in range(bits2.shape[1]):
        sel = np.where((bits2[:, i] >= 0) & (bits2[:, i] <= 3), bits2[:, i], 4)
        X, Y, Z, T = m.dbl(X, Y, Z)
        o = [np.stack([ops[e][j][:, b] for b, e in zip(lanes, sel)], axis=1) for j in range(3)]
        X, Y, Z, T = m.madd(X, Y, Z, T, *o)
    return m.eq(X, m.mul(m.load13(rx), Z)) & m.eq(Y, m.mul(m.load13(ry), Z))


def straus_quad_model(table_x, table_y, table_t, bits2, rx, ry, m: Model) -> np.ndarray:
    """tmx_straus_kernel as its quads run it: thread q of a lane's quad
    makes table entry q's operands; each phase of a step reads the rows
    (three product buffers P0-P2, the sums S, the zero row) the kernel's
    thread q addresses and writes its one product or sum: the doubling's
    f = u1 + u2 times f (2Z times Z on thread 2), its sums u - (A + w),
    the addition's (u -+ v) times a table operand and its sums
    (u1 + u2) -+ v, each point S[f] S[g]; at the end even threads check
    X == rx Z, odd ones Y == ry Z. Lane-parallel over the (10, lanes)
    arrays, thread by thread."""
    B = table_x.shape[0]
    d2 = m.const(ed.D2_ED, B)
    zero = np.zeros((LIMBS, B), dtype=np.uint64)
    ops = []
    for q in range(4):
        x, y = m.load13(table_x[:, q]), m.load13(table_y[:, q])
        ops.append((m.sub(y, x), m.add(y, x), m.mul(m.load13(table_t[:, q]), d2)))
    ops.append((zero, zero, zero))
    P0, P1, P2, S, Z0 = 0, 4, 8, 12, 16
    rows = [zero] * 17
    for q, t in enumerate((table_x, table_y, table_y, table_t)):
        rows[P2 + q] = m.load13(t[:, 0])
    lanes = np.arange(B)
    for i in range(bits2.shape[1]):
        sel = np.where((bits2[:, i] >= 0) & (bits2[:, i] <= 3), bits2[:, i], 4)

        def phase(out, value):
            rows[out:out + 4] = [value(q) for q in range(4)]

        def squares(q):
            f = m.add(rows[P2 + (0 if q == 3 else q)], rows[P2 + 1 if q == 3 else P2 + 2 if q == 2 else Z0])
            return m.mul(f, rows[P2 + 2] if q == 2 else f)

        def point(q):
            return m.mul(rows[S + (2 if q == 1 else 1 if q == 2 else 0)], rows[S + (1 if q == 0 else 2 if q == 2 else 3)])

        def products(q):
            o = np.stack([ops[e][min(q, 2)][:, b] for b, e in zip(lanes, sel)], axis=1)
            f = m.addsub(rows[P0 + 1 if q < 2 else P0 + 3], rows[P0 if q < 2 else Z0], q == 0)
            return m.mul(f, o)

        def add_sums(q):
            mid = q in (1, 2)
            u = m.add(rows[P0 + 2 if mid else P1 + 1], rows[P0 + 2 if mid else Z0])
            return m.addsub(u, rows[P1 + 2 if mid else P1], q < 2)

        phase(P1, squares)
        phase(S, lambda q: m.sub(rows[P1 + 3 if q == 0 else Z0 if q == 3 else P1 + 1],
                                 m.add(rows[P1], rows[P1 + 2 if q == 1 else Z0 if q == 2 else P1 + 1])))
        phase(P0, point)
        phase(P1, products)
        phase(S, add_sums)
        phase(P2, point)
    ok = [m.eq(rows[P2 + (q & 1)], m.mul(m.load13(ry if q & 1 else rx), rows[P2 + 2])) for q in range(2)]
    return ok[0] & ok[1]


def byte_limbs(data: np.ndarray, n_limbs: int, n_bits: int) -> np.ndarray:
    """tmx_bind_kernel's byte_limb over (lanes, nbytes) bytes: bits [13 i,
    13 i + 13) of the little-endian integer, bits at and above n_bits
    dropped. -> (lanes, n_limbs)."""
    data = np.asarray(data, dtype=np.uint32)
    nbytes = data.shape[1]
    out = np.zeros((data.shape[0], n_limbs), dtype=np.uint32)
    for i in range(n_limbs):
        lo = 13 * i
        w = np.zeros(data.shape[0], dtype=np.uint32)
        for j in range(3):
            if lo // 8 + j < nbytes:
                w |= data[:, lo // 8 + j] << np.uint32(8 * j)
        v = (w >> np.uint32(lo % 8)) & np.uint32(0x1FFF)
        keep = n_bits - lo
        out[:, i] = v if keep >= 13 else (v & np.uint32((1 << keep) - 1) if keep > 0 else 0)
    return out


def lt13(a: np.ndarray, c: list[int]) -> np.ndarray:
    """a < c for canonical 13-bit limbs, from the top limb down."""
    less = np.zeros(a.shape[0], dtype=bool)
    decided = np.zeros(a.shape[0], dtype=bool)
    for k in range(a.shape[1] - 1, -1, -1):
        less = np.where(decided, less, a[:, k] < c[k])
        decided |= a[:, k] != c[k]
    return less


L13 = [int(v) for v in ed.int_to_limbs(ed.L_ORDER)]
P13 = [int(v) for v in ed.int_to_limbs(P)]


def mod_l_model(k_q: np.ndarray, k_rec: np.ndarray, track: list) -> np.ndarray:
    """tmx_bind_kernel's step 4 in its radix: acc = k_q L + k in 40 limbs
    of 13 bits (32-bit sums), one sequential carry. -> (lanes, 40)."""
    acc = np.zeros((k_q.shape[0], 40), dtype=np.uint64)
    for i in range(20):
        for j in range(20):
            acc[:, i + j] += k_q[:, i].astype(np.uint64) * np.uint64(L13[j])
        acc[:, i] += k_rec[:, i]
    track.append(int(acc.max()))
    for i in range(39):
        acc[:, i + 1] += acc[:, i] >> np.uint64(13)
        acc[:, i] &= np.uint64(0x1FFF)
        track.append(int(acc[:, i + 1].max()))
    return acc


def bind_tables() -> dict:
    """tmx_bind_kernel's schedule as csrc/ed25519.cu writes it: the row
    names (enum BindRow), the constant rows (BIND_FE), the product phases
    (BIND_PRODUCTS: {f, g, out} a pair), the sum sets (BIND_SUMS: {u, v,
    subtract, out} a thread) and the comparisons (BIND_CHECKS: {kind, a,
    b}, two a thread), names resolved to row numbers."""
    src = open(os.path.join(CSRC, "ed25519.cu")).read()

    def enum(name):
        body = re.search(rf"enum {name} : uint8_t \{{(.*?)\}};", src, re.S).group(1)
        return [t.strip() for t in re.sub(r"//[^\n]*", "", body).split(",") if t.strip()]

    index = {n: i for i, n in enumerate(enum("BindRow"))}
    index.update({n: i for i, n in enumerate(enum("BindCheck"))})

    def table(name, ctype="uint8_t"):
        body = re.search(rf"__constant__ {ctype} {name}(?:\[\w+\])+ = \{{(.*?)\}};", src, re.S).group(1)
        return np.array([index[t] if t in index else int(t, 0) for t in re.findall(r"\w+", body)], dtype=np.int64)

    rows = enum("BindRow")
    return {"rows": rows, "index": index, "n_konst": rows.index("R_RX"),
            "fe": table("BIND_FE", "uint32_t").reshape(-1, LIMBS),
            "products": table("BIND_PRODUCTS").reshape(5, 4, 3), "sums": table("BIND_SUMS").reshape(2, 8, 4),
            "checks": table("BIND_CHECKS").reshape(8, 2, 3), "check_kinds": enum("BindCheck")}


# the values of the binding's constant rows K_ZERO .. K_YPX_B
BIND_KONST = [0, 1, 2, ed.BASE_POINT[0], ed.BASE_POINT[1], ed.BASE_T, ed.D_ED, ed.D2_ED,
              (ed.BASE_POINT[1] - ed.BASE_POINT[0]) % P, (ed.BASE_POINT[1] + ed.BASE_POINT[0]) % P]


def bind_model(table_x, table_y, table_t, bits2, rx, ry, sig_r, sig_s, sig_pk, digest, k_q, m: Model):
    """tmx_bind_kernel, lane-parallel, as its two warps run it. The range
    checks first (a lane's values split over its 16 threads, a vote a
    warp); a lane that fails them is false, and runs the rest on its limbs
    masked to 13 bits (the model checks the bounds there too). The scalar
    warp: thread t's s and k limbs (t, t + 8, t + 16) from the selectors,
    s against sig_s's; y_R, y_A against p and s, k against L (threads
    0-3); k_q L + k as column sums, five a thread, one carry, the thread's
    columns against the digest. The field warp, step by step from the
    source's tables: the inputs (thread t: t and t + 8), the first sum set
    beside the first products, products 2 and 3, the second sum set,
    products 4 and 5, the comparisons; a step reads only rows written by
    earlier steps and writes each row once."""
    T = bind_tables()
    ix, nk = T["index"], T["n_konst"]
    in13 = lambda a, axes: ((a >= 0) & (a <= 8191)).all(axis=axes)
    ok = in13(table_x, (1, 2)) & in13(table_y, (1, 2)) & in13(table_t, (1, 2))
    in_range = ok & in13(rx, 1) & in13(ry, 1) & in13(k_q, 1) & ((bits2 >= 0) & (bits2 <= 3)).all(1)
    mask = lambda a: np.asarray(a, dtype=np.int64) & 0x1FFF
    table_x, table_y, table_t, rx, ry, k_q = (mask(a) for a in (table_x, table_y, table_t, rx, ry, k_q))
    bits2 = np.asarray(bits2, dtype=np.int64) & 3
    sig_r, sig_s, sig_pk, digest = (np.asarray(a) for a in (sig_r, sig_s, sig_pk, digest))
    B = len(in_range)
    good = np.ones(B, dtype=bool)

    # the scalar checks
    y_r, y_a, s13 = byte_limbs(sig_r, 20, 255), byte_limbs(sig_pk, 20, 255), byte_limbs(sig_s, 20, 256)
    s_rec = np.zeros((B, 20), dtype=np.uint32)
    k_rec = np.zeros((B, 20), dtype=np.uint32)
    for t in range(8):
        for mm in range(t, 20, 8):
            for b in range(13):
                pos = 13 * mm + b
                sel = bits2[:, ed.N_BITS - 1 - pos].astype(np.uint32) if pos < ed.N_BITS else np.zeros(B, np.uint32)
                s_rec[:, mm] |= (sel & 1) << np.uint32(b)
                k_rec[:, mm] |= (sel >> 1) << np.uint32(b)
    good &= (s_rec == s13).all(1)
    for lim, c in ((y_r, P13), (y_a, P13), (s13, L13), (k_rec, L13)):
        good &= lt13(lim, c)
    acc = np.zeros((B, 40), dtype=np.uint64)
    for t in range(8):
        for col in range(t, 40, 8):
            acc[:, col] = k_rec[:, col] if col < 20 else 0
            for j in range(20):
                if 0 <= col - j < 20:
                    acc[:, col] += k_q[:, col - j].astype(np.uint64) * np.uint64(L13[j])
    assert int(acc.max()) < 1 << 32
    assert (acc == _pre_carry(k_q, k_rec)).all()  # the split sums are the whole product's columns
    for i in range(39):
        acc[:, i + 1] += acc[:, i] >> np.uint64(13)
        acc[:, i] &= np.uint64(0x1FFF)
        assert int(acc[:, i + 1].max()) < 1 << 32
    good &= (acc == byte_limbs(digest, 40, 512)).all(1)

    # the field checks
    assert (T["fe"] == np.array([radix(v) for v in BIND_KONST])).all()
    rows = {k: m.const(v, B) for k, v in enumerate(BIND_KONST)}
    assert len(rows) == nk
    sources = [rx, ry, *(table_x[:, j] for j in range(4)), *(table_y[:, j] for j in range(4)),
               *(table_t[:, j] for j in range(4)), y_r, y_a]
    for i, limbs in enumerate(sources):
        rows[ix["R_RX"] + i] = m.load13(limbs)
    none = ix["R_NONE"]

    def step(ops):
        """ops: (reads, out, value) of one step; reads before writes."""
        written = {out for _, out, _ in ops if out != none}
        for reads, out, _ in ops:
            assert all(r in rows and r not in written for r in reads)
        new = {out: value() for _, out, value in ops}
        for out, v in new.items():
            if out != none:
                assert out not in rows
                rows[out] = v

    sums = lambda k: [((u, v), out, lambda u=u, v=v, neg=neg: m.addsub(rows[u], rows[v], bool(neg)))
                      for u, v, neg, out in T["sums"][k]]
    products = lambda p: [((f, g), out, lambda f=f, g=g: m.mul(rows[f], rows[g])) for f, g, out in T["products"][p]]
    step(sums(0) + products(0))
    step(products(1))
    step(products(2))
    step(sums(1))
    step(products(3))
    step(products(4))
    kinds = T["check_kinds"]
    sign_r, sign_a = (sig_r[:, 31] >> 7).astype(np.uint64), (sig_pk[:, 31] >> 7).astype(np.uint64)
    for kind, a, b in T["checks"].reshape(-1, 3):
        ca, cb = m.canon(rows[a]), m.canon(rows[b])
        same, parity = (ca == cb).all(0), ca[0] & np.uint64(1)
        good &= {"CHK_EQ": same, "CHK_SIGN_R": parity == sign_r,
                 "CHK_SIGN_A": np.where(same, sign_a == 0, parity == 1 - sign_a)}[kinds[kind]]
    return in_range & good


def _pre_carry(k_q, k_rec) -> np.ndarray:
    """k_q L + k's 40 column sums before the carry."""
    acc = np.zeros((k_q.shape[0], 40), dtype=np.uint64)
    for i in range(20):
        for j in range(20):
            acc[:, i + j] += k_q[:, i].astype(np.uint64) * np.uint64(L13[j])
        acc[:, i] += k_rec[:, i]
    return acc


# ---------------------------------------------------------------------------
# The bounds, for every input (interval arithmetic over limb maxima)
# ---------------------------------------------------------------------------


def _iv_carry(h):
    assert max(h) < U32_BOUND
    c = [h[k] >> WIDTH[k] for k in range(LIMBS)]
    return [min(h[k], MASK[k]) + (19 * c[-1] if k == 0 else c[k - 1]) for k in range(LIMBS)]


def _iv_mul(f, g):
    assert max(19 * v for v in g) < U32_BOUND and max(2 * v for v in f) < U32_BOUND
    h = [0] * LIMBS
    for i in range(LIMBS):
        for j in range(LIMBS):
            h[(i + j) % LIMBS] += (2 if i & j & 1 else 1) * f[i] * (19 if i + j >= LIMBS else 1) * g[j]
    assert max(h) < PRODUCT_SUM_BOUND
    for k in CARRY_ORDER:
        c = h[k] >> WIDTH[k]
        h[k] = min(h[k], MASK[k])
        h[0 if k == LIMBS - 1 else k + 1] += 19 * c if k == LIMBS - 1 else c
    assert max(h) < U32_BOUND
    return h


def test_limb_bounds_hold_for_every_input():
    """From limbs within LIMB_BOUND, a sum, a padded difference and a
    product return limbs within LIMB_BOUND with every 32-bit intermediate
    below 2^31 and every product sum below 2^61; load13's output and the
    constants are within it; canon's first carry leaves a value below 2p."""
    bound = LIMB_BOUND
    assert all(_iv_carry([a + b for a, b in zip(bound, bound)])[k] <= bound[k] for k in range(LIMBS))
    assert all(g <= t for g, t in zip(bound, TWO_P))  # sub's pad covers any subtrahend
    assert all(_iv_carry([a + t for a, t in zip(bound, TWO_P)])[k] <= bound[k] for k in range(LIMBS))
    assert all(_iv_mul(bound, bound)[k] <= bound[k] for k in range(LIMBS))
    # addsub under the all-ones mask: f + ~g + 2p + 1 is sub's f + 2p - g
    # mod 2^32, and that sum is below 2^31 (so the same word) for every f
    # and g within the bounds
    for k in range(LIMBS):
        for f, g in ((0, 0), (bound[k], 0), (0, bound[k]), (bound[k], bound[k]), (0, TWO_P[k])):
            assert (f + (g ^ 0xFFFFFFFF) + TWO_P[k] + 1) % 2**32 == f + TWO_P[k] - g < U32_BOUND
    load = [MASK[k] + (19 * 31 if k == 0 else 0) for k in range(LIMBS)]
    assert all(load[k] <= bound[k] for k in range(LIMBS))
    # canon: after its sequential carry, limbs 1..9 within their width and
    # limb 0 at most 2^26 - 1 + 19 (limb 9's carry is at most 1)
    top = bound[9] + (bound[8] >> WIDTH[8])
    assert top >> WIDTH[9] <= 1
    assert sum(MASK[k] << OFF[k] for k in range(LIMBS)) + 19 < 2 * P


def test_constants_in_the_sources_match_python():
    src = open(os.path.join(CSRC, "ed25519.cu")).read()

    def table(name):
        m = re.search(rf"__constant__ uint32_t {name}\[\w+\] = \{{([^}}]*)\}}", src)
        return [int(v, 0) for v in m.group(1).replace("\n", " ").split(",") if v.strip()]

    assert table("D2_FE") == radix(ed.D2_ED)
    assert bind_tables()["fe"].tolist() == [radix(v) for v in BIND_KONST]

    def limbs13(name, otherwise):  # a constexpr limb function: j == k ? v : ... : otherwise
        body = re.search(rf"constexpr uint32_t {name}\(int j\) \{{(.*?)\}}", src, re.S).group(1)
        assert re.search(rf": {otherwise};", body)
        listed = {int(j): int(v) for j, v in re.findall(r"j == (\d+) \? (\d+)", body)}
        return [listed.get(j, otherwise) for j in range(20)]

    assert limbs13("p13", 8191) == P13 and limbs13("l13", 0) == L13
    sha = open(os.path.join(CSRC, "sha.cu")).read()

    def sha_table(name):
        m = re.search(rf"__constant__ uint(32|64)_t {name}\[\d+\] = \{{([^}}]*)\}}", sha)
        return [int(v, 0) for v in m.group(2).replace("\n", " ").split(",") if v.strip()]

    assert sha_table("K256") == [int(v) for v in sha256._K] and sha_table("H256") == [int(v) for v in sha256._H0]
    assert sha_table("K512") == sha512._K and sha_table("H512") == sha512._H0


def _witness_lanes(ladder_inputs):
    """The fixture's 8 lanes (4 honest; tampered R, S, message, public key)
    and two more from lane 0: its rx, table y and table t in a non-canonical
    form (the value plus p, limbs still 13 bits), and an out-of-range
    selector (7). -> ladder arrays, binding arrays (digest bytes), expected
    oracle flags of the first 8."""
    pks, msgs, sigs, args, binding, m, mlen = ladder_inputs
    args = [np.asarray(a).astype(np.int64) for a in args]
    extra = [a[:2].copy() for a in args]
    extra[4][0] = ed.int_to_limbs(ed.limbs_to_int(extra[4][0]) + P)
    extra[1][0, 1] = ed.int_to_limbs(ed.limbs_to_int(extra[1][0, 1]) + P)
    extra[2][0, 3] = ed.int_to_limbs(ed.limbs_to_int(extra[2][0, 3]) + P)
    extra[3][1] = extra[3][0]
    extra[3][1, 50] = 7
    extra[3][1, 51] = -3
    ladder = [np.concatenate([a, e]) for a, e in zip(args, extra)]
    sig_r, sig_s, sig_pk, k_q = (np.asarray(b) for b in binding)
    digests = np.stack([np.frombuffer(hashlib.sha512(s[:32] + pk + msg).digest(), dtype=np.uint8)
                        for pk, msg, s in zip(pks, msgs, sigs)])
    bind = [np.concatenate([b, b[:2]]) for b in (sig_r, sig_s, sig_pk, digests)]
    bind.append(np.concatenate([k_q, k_q[:2]]).astype(np.int64))
    oracle = [ed.verify_ints(p, mm, s) for p, mm, s in zip(pks, msgs, sigs)]
    return ladder, bind, oracle


def test_ladder_model_equals_plain_and_oracle(ladder_inputs):
    ladder, _, oracle = _witness_lanes(ladder_inputs)
    m = Model()
    got = straus_model(*ladder, m)
    want = ed.straus_verify_plain(*(torch.from_numpy(a) for a in ladder)).numpy()
    assert got.tolist() == want.tolist()
    assert got[:8].tolist() == oracle == [True] * 4 + [False] * 4
    # a non-canonical witness verifies; so does the lane whose selectors 7
    # and -3 add the all-zero operand, which zeroes the point (X = Y = Z =
    # 0 passes the projective check): the binding rejects that lane
    assert got[8] and got[9]
    assert m.max32 < U32_BOUND and m.max64 < PRODUCT_SUM_BOUND


def pair_product_sums(f: np.ndarray, g: np.ndarray, half: int) -> np.ndarray:
    """mul_pair's five sums on thread `half` of a pair: output kk is the
    product's limb 5 half + kk, from g rotated by 5 half limbs (gr), its 19
    multiples (gr19), gx (gr in half 1, gr19 in half 0) and f's odd limbs
    doubled by j0's parity and the half, as csrc/ed25519.cu writes it."""
    rot = [(m + 5 * half) % LIMBS for m in range(LIMBS)]
    gr = g[rot]
    gr19 = np.uint64(19) * gr
    gx = gr if half else gr19
    fe, fo = (np.uint64(2) * f, f) if half else (f, np.uint64(2) * f)
    part = np.zeros((5,) + f.shape[1:], dtype=np.uint64)
    for kk in range(5):
        for i in range(LIMBS):
            j0 = (kk - i) % LIMBS
            a = (fo[i] if j0 & 1 else fe[i]) if i & 1 else f[i]
            b = gr[j0] if i <= kk else gx[j0] if i <= kk + 5 else gr19[j0]
            part[kk] += a * b
    return part


def test_pair_product_halves_are_the_products_sums():
    """Half 0's five sums and half 1's are mul's ten sums before its carry
    chain, on limbs at the bounds and at random below them."""
    rng = np.random.default_rng(9)
    top = np.array(LIMB_BOUND, dtype=np.uint64)[:, None]
    f = np.concatenate([top, rng.integers(0, top + 1, size=(LIMBS, 64), dtype=np.uint64)], axis=1)
    g = np.concatenate([top, rng.integers(0, top + 1, size=(LIMBS, 64), dtype=np.uint64)], axis=1)
    want = np.zeros_like(f)
    for i in range(LIMBS):
        for j in range(LIMBS):
            want[(i + j) % LIMBS] += ((2 if i & j & 1 else 1) * f[i]) * ((19 if i + j >= LIMBS else 1) * g[j])
    got = np.concatenate([pair_product_sums(f, g, 0), pair_product_sums(f, g, 1)])
    assert (got == want).all()
    assert int(want.max()) < PRODUCT_SUM_BOUND


def test_quad_ladder_schedule_equals_plain(ladder_inputs):
    """The quad schedule (every buffer read, every pick by q) gives the
    lane model's and the plain ladder's outcome on every check lane, with
    every op within the bounds."""
    ladder, _, _ = _witness_lanes(ladder_inputs)
    m = Model()
    got = straus_quad_model(*ladder, m)
    want = ed.straus_verify_plain(*(torch.from_numpy(a) for a in ladder)).numpy()
    assert got.tolist() == want.tolist() == [True] * 4 + [False] * 4 + [True] * 2
    assert m.max32 < U32_BOUND and m.max64 < PRODUCT_SUM_BOUND


def test_binding_model_equals_plain_incl_tampering_and_ranges(ladder_inputs):
    """Honest lanes, the fixture's tampered bytes, the tampering of
    tests/test_torch_witness.py's verify_bound test (a scalar bit, a k_q
    limb, a table limb, R's parity), the non-canonical lane, the
    out-of-range selector and limbs of 8192 and -1."""
    ladder, bind, _ = _witness_lanes(ladder_inputs)
    ladder = [np.concatenate([a, a[:4]]) for a in ladder]
    bind = [np.concatenate([b, b[:4]]) for b in bind]
    ladder[3][10, 100] ^= 1
    bind[4][11, 0] ^= 1
    ladder[0][12, 3, 5] ^= 1
    ladder[4][13] = ed.int_to_limbs((P - ed.limbs_to_int(ladder[4][13])) % P)
    ladder = [np.concatenate([a, a[:2]]) for a in ladder]
    bind = [np.concatenate([b, b[:2]]) for b in bind]
    ladder[2][14, 1, 7] = 8192
    bind[4][15, 19] = -1
    m = Model()
    got = bind_model(*ladder, *bind, m)
    want = ed.bind_witness_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (*ladder, *bind))).numpy()
    assert got.tolist() == want.tolist()
    # the fixture's tampered bytes come with the witness derived from them:
    # bound, and rejected by the ladder; witness-only tampering is not
    assert got.tolist() == [True] * 9 + [False] * 7


def test_mod_l_check_in_the_kernels_radix():
    """k_q L + k == h for h = SHA-512 digests as integers, k = h mod L, in
    40 limbs of 13 bits: equal exactly where the integers are, every
    32-bit sum below 2^32 (the largest k_q the range check lets through
    included)."""
    rng = np.random.default_rng(5)
    hs = [int.from_bytes(hashlib.sha512(rng.bytes(40)).digest(), "little") for _ in range(6)]
    hs += [2**512 - 1, 0]
    kq = np.stack([ed.int_to_limbs(h // ed.L_ORDER) for h in hs]).astype(np.int64)
    k = np.stack([ed.int_to_limbs(h % ed.L_ORDER) for h in hs]).astype(np.uint32)
    digest = np.stack([np.frombuffer(h.to_bytes(64, "little"), dtype=np.uint8) for h in hs])
    track = []
    acc = mod_l_model(kq, k, track)
    assert (acc == byte_limbs(digest, 40, 512)).all()
    kq[1, 0] += 1  # a wrong quotient
    k[2, 3] ^= 1  # a wrong remainder
    acc = mod_l_model(kq, k, track)
    assert (acc == byte_limbs(digest, 40, 512)).all(1).tolist() == [True, False, False] + [True] * 5
    worst = np.full((1, 20), 8191, dtype=np.int64)
    mod_l_model(worst, np.full((1, 20), 8191, dtype=np.uint32), track)
    assert max(track) < 1 << 32


# ---------------------------------------------------------------------------
# SHA: the n_active semantics the kernels keep
# ---------------------------------------------------------------------------


# messages of one and two blocks, padded to two blocks, with n_active 0, 1
# (its whole message), 5 (> n_blocks: its whole message), 1 (the first of
# two blocks) and -3 (none); then the two-block message alone (B = 1)
N_ACTIVE_EDGES = np.array([0, 1, 5, 1, -3])


def _edge_messages(block_bytes: int) -> list[bytes]:
    return [b"", b"abc", bytes(range(block_bytes)), bytes(range(block_bytes)), b"x"]


def test_sha256_n_active_edges_match_jax_and_hashlib():
    msgs = _edge_messages(64)
    blocks, _ = jsha256.pad_messages(msgs, n_blocks=2)
    n_active = N_ACTIVE_EDGES
    want = np.asarray(jsha256.sha256_blocks_jit(jnp.asarray(blocks), jnp.asarray(n_active, dtype=jnp.int32)))
    got = sha256.sha256_blocks(_t(blocks), torch.from_numpy(n_active))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    h0 = [int(v) for v in sha256._H0]
    assert got[0].tolist() == h0 == got[4].tolist()
    assert sha256.digests_to_bytes(got[1:3]) == [hashlib.sha256(m).digest() for m in msgs[1:3]]
    one = sha256.sha256_blocks(_t(blocks[2:3]), torch.tensor([2]))
    assert sha256.digests_to_bytes(one) == [hashlib.sha256(msgs[2]).digest()]
    want_one = np.asarray(jsha256.sha256_blocks_jit(jnp.asarray(blocks[2:3]), jnp.asarray([2], dtype=jnp.int32)))
    assert np.array_equal(one.numpy(), want_one.astype(np.int64))


def test_sha512_n_active_edges_match_jax_and_hashlib():
    msgs = _edge_messages(128)
    lo, hi, _ = jsha512.pad_messages(msgs, n_blocks=2)
    n_active = N_ACTIVE_EDGES
    words = ((np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)).view(np.int64)
    j_lo, j_hi = jsha512.sha512_blocks_jit(lo, hi, jnp.asarray(n_active, dtype=jnp.int32))
    want = (np.asarray(j_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(j_lo).astype(np.uint64)
    got = sha512.sha512_blocks(torch.from_numpy(words.copy()), torch.from_numpy(n_active))
    assert np.array_equal(got.numpy().view(np.uint64), want)
    assert got[0].numpy().view(np.uint64).tolist() == sha512._H0 == got[4].numpy().view(np.uint64).tolist()
    assert sha512.digests_to_bytes(got[1:3]) == [hashlib.sha512(m).digest() for m in msgs[1:3]]
    one = sha512.sha512_blocks(torch.from_numpy(words[2:3].copy()), torch.tensor([2]))
    assert sha512.digests_to_bytes(one) == [hashlib.sha512(msgs[2]).digest()]
    j_lo, j_hi = jsha512.sha512_blocks_jit(lo[2:3], hi[2:3], jnp.asarray([2], dtype=jnp.int32))
    want_one = (np.asarray(j_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(j_lo).astype(np.uint64)
    assert np.array_equal(one.numpy().view(np.uint64), want_one)


# ---------------------------------------------------------------------------
# Dispatch: a CPU tensor takes the plain version and counts no launch
# ---------------------------------------------------------------------------


def _counters():
    return (sha256.sha256_kernel_launches, sha512.sha512_kernel_launches, sha512.sha512_challenge_kernel_launches,
            ed.straus_kernel_launches, ed.bind_kernel_launches,
            gadgets.validator_root_kernel_launches, gadgets.header_proofs_kernel_launches)


def test_cpu_tensors_take_the_plain_versions(ladder_inputs):
    ladder, bind, _ = _witness_lanes(ladder_inputs)
    ladder = [torch.from_numpy(a) for a in ladder]
    bind = [torch.from_numpy(np.ascontiguousarray(b)) for b in bind]
    blocks, n_active = sha256.pad_messages([b"a", b"bc" * 40])
    blocks512, n_active512 = sha512.pad_messages([b"a", b"bc" * 80])
    before = _counters()
    assert torch.equal(sha256.sha256_blocks(blocks, n_active), sha256.sha256_blocks_plain(blocks, n_active))
    assert torch.equal(sha512.sha512_blocks(blocks512, n_active512),
                       sha512.sha512_blocks_plain(blocks512, n_active512))
    assert torch.equal(ed.straus_verify(*ladder), ed.straus_verify_plain(*ladder))
    assert torch.equal(ed.bind_witness(*ladder, *bind), ed.bind_witness_plain(*ladder, *bind))
    msgs = torch.zeros((len(bind[0]), 124), dtype=torch.uint8)
    msg_len = torch.arange(len(bind[0])) * 15 - 20
    assert torch.equal(sha512.sha512_challenge(bind[0], bind[2], msgs, msg_len),
                       sha512.sha512_challenge_plain(bind[0], bind[2], msgs, msg_len))
    assert _counters() == before == (0,) * 7


@pytest.mark.parametrize("fn", ["sha256", "sha512", "challenge", "straus", "bind"])
def test_wrappers_refuse_other_devices(fn):
    meta = lambda *shape, dtype=torch.int64: torch.empty(shape, dtype=dtype, device="meta")
    ladder = (meta(2, 4, 20), meta(2, 4, 20), meta(2, 4, 20), meta(2, ed.N_BITS), meta(2, 20), meta(2, 20))
    call = {
        "sha256": lambda: sha256.sha256_blocks(meta(2, 1, 16), meta(2)),
        "sha512": lambda: sha512.sha512_blocks(meta(2, 1, 16), meta(2)),
        "challenge": lambda: sha512.sha512_challenge(*(meta(2, n, dtype=torch.uint8) for n in (32, 32, 124)), meta(2)),
        "straus": lambda: ed.straus_verify(*ladder),
        "bind": lambda: ed.bind_witness(*ladder, *(meta(2, n, dtype=torch.uint8) for n in (32, 32, 32, 64)),
                                        meta(2, 20)),
    }[fn]
    with pytest.raises(ValueError):
        call()


def test_chip_smoke_witness_calls_are_the_programs_calls(tmp_path, monkeypatch):
    """chip_smoke.py's launch counts (_witness_launches) and the tree and
    proof entries' byte rows (_witness_sha256_shapes), from which the card
    run holds the kernels' launches, are the calls skip_verify and
    step_verify make (here through the plain twins, at N=8): two validator
    trees and one header-proof batch a skip, one and one a step, one
    challenge a program, and no sha256_blocks or sha512_blocks call outside
    the twins of those."""
    import chip_smoke

    from tendermintx_tpu_torch.circuits.variables import pack_skip_witness, pack_step_witness
    from tendermintx_tpu_torch.circuits.verify import chain_id_leaf_const, skip_verify, step_verify

    calls = {name: [] for name in chip_smoke.WITNESS_ENTRIES}
    twins = {"sha256_blocks": (sha256, "sha256_blocks_plain"), "sha512_blocks": (sha512, "sha512_blocks_plain"),
             "sha512_challenge": (sha512, "sha512_challenge_plain"),
             "straus_verify": (ed, "straus_verify_plain"), "bind_witness": (ed, "bind_witness_plain"),
             **{name: (gadgets, plain) for name, (_, plain) in chip_smoke.SHA256_GADGETS.items()}}
    inside = []  # a twin's own calls of the others are not the program's

    def recorded(*a, name, plain):
        if not inside:
            calls[name].append(tuple(a[0].shape))
        inside.append(name)
        try:
            return plain(*a)
        finally:
            inside.pop()

    for name, (mod, attr) in twins.items():
        monkeypatch.setattr(mod, attr, lambda *a, name=name, plain=getattr(mod, attr): recorded(*a, name=name,
                                                                                                 plain=plain))
    sc = chip_smoke.SkipChain(8, str(tmp_path))
    cl, cn = chain_id_leaf_const(chip_smoke.CHAIN_ID)
    trusted, _, skip_inputs = sc.skip(2, 6)
    prev, step_inputs = sc.step(4)
    as_t = lambda h: torch.frombuffer(bytearray(h), dtype=torch.uint8)
    runs = {
        "skip": lambda: skip_verify(pack_skip_witness(skip_inputs), as_t(trusted), 2, 0, 6, 0, cl, cn, 100)[0],
        "step": lambda: step_verify(pack_step_witness(step_inputs), as_t(prev), 4, 0, cl, cn)[0],
    }
    for kind, run in runs.items():
        for c in calls.values():
            c.clear()
        assert bool(run())
        assert {k: len(c) for k, c in calls.items()} == chip_smoke._witness_launches(8, kind)
        for name, shapes in chip_smoke._witness_sha256_shapes(8, kind).items():
            assert set(calls[name]) == shapes
