"""The port's Goldilocks and GF(p^2) arithmetic against the JAX package and
Python ints, on random inputs and the edge values 0, 1, p-1, 2^32-1, 2^32
and 2^63 (mod p). Tolerance: exact equality (integer field arithmetic)."""

import itertools

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops import ext as jext
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu_torch.interop import felts_from_jax, felts_from_u64, felts_to_jax, felts_to_u64
from tendermintx_tpu_torch.ops import ext
from tendermintx_tpu_torch.ops import goldilocks as gl
from tendermintx_tpu_torch.ops.goldilocks import GF, P

EDGES = [0, 1, P - 1, 2**32 - 1, 2**32, 2**63 % P, 2**63 - 1, P - 2**32]


def _operands(n_random: int, seed: int):
    rng = np.random.default_rng(seed)
    pairs = list(itertools.product(EDGES, EDGES))
    a = [x for x, _ in pairs] + [int(v) % P for v in rng.integers(0, 2**63, n_random)]
    b = [y for _, y in pairs] + [int(v) * 2 % P for v in rng.integers(0, 2**63, n_random)]
    return a, b


def _ints(t: torch.Tensor) -> list[int]:
    return [int(v) for v in gl.to_int_array(t).ravel()]


@pytest.mark.parametrize(
    "name, fn, ref",
    [
        ("add", gl.add, lambda x, y: (x + y) % P),
        ("sub", gl.sub, lambda x, y: (x - y) % P),
        ("mul", gl.mul, lambda x, y: x * y % P),
    ],
)
def test_binary_ops_match_python_ints(name, fn, ref):
    a, b = _operands(4000, seed=1)
    got = _ints(fn(GF.from_ints(a).v, GF.from_ints(b).v))
    assert got == [ref(x, y) for x, y in zip(a, b)], name


def test_ops_match_jax_gf():
    a, b = _operands(1000, seed=2)
    ja, jb = JGF.from_ints(np.array(a, dtype=object)), JGF.from_ints(np.array(b, dtype=object))
    ta, tb = GF.from_ints(a), GF.from_ints(b)
    for jv, tv in [
        (ja + jb, ta + tb),
        (ja - jb, ta - tb),
        (ja * jb, ta * tb),
        (-ja, -ta),
        (ja.square(), ta.square()),
        (ja.cmul(P - 3), ta.cmul(P - 3)),
        (ja.mul_small(7), ta.mul_small(7)),
        (ja.pow(5), ta.pow(5)),
    ]:
        assert _ints(tv.v) == [int(v) for v in jv.to_ints()]


def test_inverse_and_pow():
    a, _ = _operands(200, seed=3)
    got = _ints(gl.inv(GF.from_ints(a).v))
    assert got == [pow(x, P - 2, P) for x in a]  # inv(0) = 0 by convention
    jinv = jax.jit(lambda g: g.inv())(JGF.from_ints(np.array(a, dtype=object)))
    assert got == [int(v) for v in jinv.to_ints()]


def test_reduce_limbs_bounds():
    """reduce_limbs at the extremes of its documented input range."""
    rng = np.random.default_rng(4)
    hi = 6 * 2**32 - 1
    limbs = [[0, 0, 0, 0], [hi, hi, hi, hi], [0, hi, 0, hi], [hi, 0, hi, 0]]
    limbs += [[int(v) for v in rng.integers(0, hi, 4)] for _ in range(500)]
    cols = [torch.tensor([row[k] for row in limbs], dtype=torch.int64) for k in range(4)]
    got = _ints(gl.reduce_limbs(*cols))
    want = [(r0 + r1 * 2**32 + r2 * 2**64 + r3 * 2**96) % P for r0, r1, r2, r3 in limbs]
    assert got == want


def test_field_sum_matches_sequential():
    a, _ = _operands(300, seed=5)
    x = GF.from_ints(np.array(a[:300], dtype=object).reshape(30, 10))
    got = _ints(x.sum(axis=0).v)
    want = [sum(a[r * 10 + c] for r in range(30)) % P for c in range(10)]
    assert got == want


def test_ext_field_matches_jax():
    rng = np.random.default_rng(6)
    vals = [[int(v) % P for v in rng.integers(0, 2**63, 64)] for _ in range(4)]
    vals[0][:len(EDGES)] = EDGES
    a0, a1, b0, b1 = (np.array(v, dtype=object) for v in vals)
    ja, jb = jext.GF2.from_ints(a0, a1), jext.GF2.from_ints(b0, b1)
    ta, tb = ext.GF2.from_ints(a0, a1), ext.GF2.from_ints(b0, b1)
    for jv, tv in [(ja * jb, ta * tb), (ja + jb, ta + tb), (ja - jb, ta - tb),
                   (ja.inv(), ta.inv()), (ja.pow(11), ta.pow(11))]:
        for jc, tc in zip(jv.to_ints(), tv.to_ints()):
            assert [int(v) for v in tc] == [int(v) for v in jc]
    for x, y in zip(zip(a0, a1), zip(b0, b1)):
        assert ext.ext_mul(x, y) == jext.ext_mul(x, y)
        assert ext.ext_inv(x) == jext.ext_inv(x)
        assert ext.ext_pow(x, 13) == jext.ext_pow(x, 13)


def test_converters_round_trip():
    a, _ = _operands(100, seed=7)
    j = JGF.from_ints(np.array(a, dtype=object))
    lo, hi = np.asarray(j.lo), np.asarray(j.hi)
    t = felts_from_jax(lo, hi)
    assert _ints(t) == a
    lo2, hi2 = felts_to_jax(t)
    assert np.array_equal(lo2, lo) and np.array_equal(hi2, hi)
    u = np.array(a, dtype=np.uint64)
    assert np.array_equal(felts_to_u64(felts_from_u64(u)), u)
    assert _ints(GF.from_ints(u).v) == a
    assert _ints(gl.scalar_tensor(P - 1)) == [P - 1]
