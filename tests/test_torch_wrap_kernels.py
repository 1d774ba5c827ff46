"""The recursion wrap's device programs on the CPU: the plain twins of
csrc/logup.cu's EvalAir entries (stark/evalair.py: _eval_terms, _eval_scan,
_eval_assemble, eval_aux_plain) against the JAX
package's _eval_terms_kernel, _eval_scan_kernel and _eval_assemble_kernel
at 2^4, 2^8 and 2^11 rows, with random gamma and delta and with a planted
zero denominator; a Python model of the fused eval kernel's schedule
(each thread's rows divided by one inversion, the block's scan, the tiles'
look-back in random completion orders) against the twins and the JAX
programs; the grinding
search (ops/poseidon.py: grind_plain, stark/fri.py: grind) against the JAX
package's _grind_fn and check_grind at pow_bits 1-10; a Python model of
csrc/poseidon.cu's round-state kernel against expand_plain; the ctypes
layout of EvalArgs against the source; and the CPU dispatch. The card's
kernels are held against the twins in tests/test_torch_cuda.py. Tolerance:
exact equality (field arithmetic)."""

import functools
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from tendermintx_tpu.ops.ext import GF2 as JGF2
from tendermintx_tpu.ops.goldilocks import GF as JGF
from tendermintx_tpu.stark import evalair as jev
from tendermintx_tpu.stark import fri as jfri
from tendermintx_tpu.stark import recursion as jrec
from tendermintx_tpu_torch.ops import poseidon as ps
from tendermintx_tpu_torch.ops.ext import GF2, W, ext_mul
from tendermintx_tpu_torch.ops.goldilocks import GF, P, tensor_from_u64
from tendermintx_tpu_torch.stark import evalair as ev
from tendermintx_tpu_torch.stark import fri
from tendermintx_tpu_torch.stark import recursion as rec

from test_torch_logup import _dot2

EDGES = [0, 1, P - 1, 2**32 - 1, 2**32, P - 2**32]


def _felts(rng, shape) -> np.ndarray:
    x = (rng.integers(0, 2**63, size=shape).astype(object) * 2 + rng.integers(0, 2, size=shape)) % P
    x.reshape(-1)[: len(EDGES)] = EDGES[: x.size]
    return x


def _eval_case(n: int, seed: int, planted: bool):
    """(trace (8, n), static rows (8, n), gamma, delta) as Python ints:
    random values, addresses below n, multiplicities (a count row, then
    three 0/1 gate rows); `planted`: gamma made equal to one cell's a +
    delta v0 + delta^2 v1, a zero denominator at (row, term) (n // 2, 2)."""
    rng = np.random.default_rng(seed)
    trace = _felts(rng, (8, n))
    rows = np.concatenate([rng.integers(0, n, size=(4, n)), rng.integers(0, 2**32, size=(1, n)),
                           rng.integers(0, 2, size=(3, n))]).astype(object)
    ext = lambda: tuple(int(v) % P for v in rng.integers(0, 2**63, size=2).astype(object) * 2 + 1)
    delta = ext()
    if planted:
        r, k = n // 2, 2
        d2 = ext_mul(delta, delta)
        v0, v1 = int(trace[2 * k, r]), int(trace[2 * k + 1, r])
        gamma = ((int(rows[k, r]) + delta[0] * v0 + d2[0] * v1) % P, (delta[1] * v0 + d2[1] * v1) % P)
    else:
        gamma = ext()
    return trace, rows, gamma, delta


def _gf2(g) -> GF2:
    return GF2.from_ints([g[0]], [g[1]])


def _jgf2(g) -> JGF2:
    return JGF2(JGF.from_ints(np.array([g[0]], dtype=object)), JGF.from_ints(np.array([g[1]], dtype=object)))


def _u(t: torch.Tensor) -> list:
    return t.numpy().view(np.uint64).astype(object).tolist()


def _ju(g) -> list:
    return np.asarray(g.to_ints()).tolist()


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("n", [1 << 4, 1 << 8, 1 << 11])
def test_eval_programs_match_jax(n, planted):
    """Each plain program against its JAX program, and eval_aux_plain (the
    card entries' twin) against the assembled reference rows."""
    trace, rows, gamma, delta = _eval_case(n, 40 + n, planted)
    v0, v1 = GF.from_ints(trace[0::2]), GF.from_ints(trace[1::2])
    addrs, mults = GF.from_ints(rows[:4]), GF.from_ints(rows[4:])
    terms = ev._eval_terms(addrs, mults, v0, v1, _gf2(gamma), _gf2(delta))
    vals = JGF.from_ints(np.concatenate([trace[0::2], trace[1::2]]))
    jterms = jev._eval_terms_kernel(JGF.from_ints(rows[:4]), JGF.from_ints(rows[4:]), vals, _jgf2(gamma),
                                    _jgf2(delta))
    assert (_u(terms.c0.v), _u(terms.c1.v)) == (_ju(jterms.c0), _ju(jterms.c1))
    if planted:
        assert (_u(terms.c0.v)[2][n // 2], _u(terms.c1.v)[2][n // 2]) == (0, 0)
    S, jS = ev._eval_scan(terms), jev._eval_scan_kernel(jterms)
    assert (_u(S.c0.v), _u(S.c1.v)) == (_ju(jS.c0), _ju(jS.c1))
    want = _ju(jev._eval_assemble_kernel(jterms, jS))
    assert _u(ev._eval_assemble(terms, S).v) == want
    t, r = GF.from_ints(trace), tensor_from_u64(rows.astype(np.uint64))
    assert _u(ev.eval_aux_plain(t, r, _gf2(gamma), _gf2(delta)).v) == want


def _eval_row_model(trace, rows, gamma, delta, r: int) -> list[tuple]:
    """csrc/logup.cu: tmx_eval_aux_kernel's terms at row r before the
    division: delta^2, each term's D = gamma - (a + delta v0 + delta^2 v1)
    from the trace's rows 2k and 2k + 1, N(D) = D0^2 - W D1^2 and its
    multiplicity m, as (D, N, m)."""
    e = ext_mul(delta, delta)
    out = []
    for k in range(4):
        v0, v1 = int(trace[2 * k, r]), int(trace[2 * k + 1, r])
        a, m = int(rows[k, r]), int(rows[4 + k, r])
        D0 = (gamma[0] - a - _dot2(delta[0], v0, e[0], v1)) % P
        D1 = (gamma[1] - _dot2(delta[1], v0, e[1], v1)) % P
        out.append(((D0, D1), _dot2(D0, D0, -W * D1 % P, D1), m))
    return out


def _batch_model(terms: list[tuple]) -> list[tuple]:
    """tmx_eval_aux_kernel's division of a thread's terms (D, N, m): on the
    way up each term's u = m times the norms before it (a zero norm, D = 0,
    made 1: its term c conj(D) is 0 whatever c), one inversion of all the
    norms' product, on the way down acc = 1 / (N_0 ... N_q), c = u acc = m
    / N and the term c conj(D)."""
    u, norms, pre = [], [], 1
    for _, nrm, m in terms:
        nrm = nrm or 1
        u.append(m * pre % P)
        norms.append(nrm)
        pre = pre * nrm % P
    acc = pow(pre, P - 2, P)
    out = [None] * len(terms)
    for q in range(len(terms) - 1, -1, -1):
        c = u[q] * acc % P
        acc = acc * norms[q] % P
        D = terms[q][0]
        out[q] = (c * D[0] % P, -c * D[1] % P)
    return out


def _add(a: tuple, b: tuple) -> tuple:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _inclusive(xs: list) -> list:
    out, acc = [], (0, 0)
    for x in xs:
        acc = _add(acc, x)
        out.append(acc)
    return out


def _eval_tile_model(trace, rows, gamma, delta, n: int, b: int) -> tuple[dict, dict, tuple]:
    """tmx_eval_aux_kernel's tile b before its look-back, at the source's
    EVAL_THREADS and EVAL_ROWS: thread t's rows b tile + j threads + t
    (j < rows), their 4 rows terms divided together (_batch_model: one
    inversion; rows past n norm 1 and m 0), each row's tw - ta - tb - tc;
    each chunk j scanned within its warps, the (chunk, warp) totals scanned
    by warp 0. Returns each row's four terms, each row's sum within the
    tile (its warp scan plus the totals before its (chunk, warp)) and the
    tile's sum."""
    threads, per = ev.EVAL_THREADS, ev.EVAL_ROWS
    warps = threads // 32
    base = b * ev.EVAL_TILE
    terms, diff = {}, {}
    for t in range(threads):
        mine = [base + j * threads + t for j in range(per)]
        batch = [x for r in mine
                 for x in (_eval_row_model(trace, rows, gamma, delta, r) if r < n else [((0, 0), 1, 0)] * 4)]
        div = _batch_model(batch)
        for j, r in enumerate(mine):
            q = div[4 * j : 4 * j + 4]
            diff[r] = tuple((q[0][c] - q[1][c] - q[2][c] - q[3][c]) % P for c in range(2))
            if r < n:
                terms[r] = q
    scans, totals = {}, []
    for j in range(per):
        for w in range(warps):
            lanes = [base + j * threads + w * 32 + lane for lane in range(32)]
            run = _inclusive([diff[r] for r in lanes])
            scans.update(zip(lanes, run))
            totals.append(run[-1])
    before = [(0, 0), *_inclusive(totals)]
    local = {r: _add(scans[r], before[((r - base) // threads) * warps + (r - base) % threads // 32])
             for r in scans if r < n}
    return terms, local, before[-1]


def _look_back_model(sums: list, resident: int, rng, look: int) -> tuple[list, list, tuple]:
    """tmx_eval_aux_kernel's single pass over tiles whose sums are `sums`,
    as interleaved steps: at most `resident` blocks run at once, each
    started when a slot is free and taking the next tile from the counter;
    a random running block takes one step at a time: publish its sum
    (status 1; tile 0 skips it); read the status of the 32 `look` tiles
    below a window's top (before tile 0, a prefix of 0), then, a step at a
    time, find the nearest inclusive prefix (status 2) among what it read
    and read again each tile nearer than it that read 0, until none is 0;
    add those tiles' sums and that prefix (with no prefix, all the
    window's sums, and the next window); publish its prefix; count itself
    done. The last block done zeroes the counters and every status word.
    Returns the sum before each tile, the status words and the two
    counters at the end."""
    n_tiles, span = len(sums), 32 * look
    status, agg, pre = [0] * n_tiles, [None] * n_tiles, [None] * n_tiles
    counters = [0, 0]  # the tile counter, the done counter
    before = [None] * n_tiles

    def block():
        tile = counters[0]
        counters[0] += 1
        yield
        if tile:
            agg[tile] = sums[tile]
            status[tile] = 1
            yield
        acc, top = (0, 0), tile - 1
        while tile:
            seen = [2 if top - dist < 0 else status[top - dist] for dist in range(span)]
            while True:
                stop = seen.index(2) if 2 in seen else span
                if 0 not in seen[:stop]:
                    break
                yield
                seen = [s or status[top - dist] if dist < stop else s for dist, s in enumerate(seen)]
            for dist in range(min(stop + 1, span)):
                if top - dist >= 0:
                    acc = _add(acc, pre[top - dist] if dist == stop else agg[top - dist])
            if stop < span:
                break
            top -= span
            yield
        before[tile] = acc
        pre[tile] = _add(acc, sums[tile])
        status[tile] = 2
        yield
        counters[1] += 1
        if counters[1] == n_tiles:
            status[:] = [0] * n_tiles
            counters[:] = [0, 0]

    running, started, steps = [], 0, 0
    while started < n_tiles or running:
        while started < n_tiles and len(running) < resident:
            running.append(block())
            started += 1
        i = int(rng.integers(len(running)))
        try:
            next(running[i])
        except StopIteration:
            running.pop(i)
        steps += 1
        assert steps < 1000 * (n_tiles + 1) ** 2, "the look-back does not end"
    return before, status, tuple(counters)


@pytest.mark.parametrize("planted", [False, True])
def test_eval_kernel_model_matches_the_twins(planted):
    """The fused kernel's model over a ragged row count (its last tile
    part empty), its tiles' look-back in random completion orders with 1,
    2 and all tiles resident: the ten aux rows equal eval_aux_plain's and
    the JAX package's _eval_terms_kernel / _eval_scan_kernel rows exactly;
    planted: two zero norms in one thread's batch (gamma equal to a cell's
    a + delta v0 + delta^2 v1, and that cell copied to another term of the
    thread's next row), each term 0 and the batch's others exact."""
    for name in ("EVAL_THREADS", "EVAL_ROWS"):
        assert _source_int("logup.cu", name) == getattr(ev, name)
    look = _source_int("logup.cu", "LOOK_TILES")
    assert ev.EVAL_TILE == ev.EVAL_THREADS * ev.EVAL_ROWS and ev.EVAL_ROWS * ev.EVAL_THREADS // 32 <= 32
    n = 4 * ev.EVAL_TILE + 37
    trace, rows, gamma, delta = _eval_case(n, 7, planted)
    r, k = n // 2, 2  # _eval_case's planted zero
    r2, k2 = r + ev.EVAL_THREADS, 0
    assert r // ev.EVAL_TILE == r2 // ev.EVAL_TILE and r % ev.EVAL_THREADS == r2 % ev.EVAL_THREADS
    if planted:
        trace[2 * k2 : 2 * k2 + 2, r2] = trace[2 * k : 2 * k + 2, r]
        rows[k2, r2] = rows[k, r]
    aux = _u(ev.eval_aux_plain(GF.from_ints(trace), tensor_from_u64(rows.astype(np.uint64)), _gf2(gamma),
                               _gf2(delta)).v)
    vals = JGF.from_ints(np.concatenate([trace[0::2], trace[1::2]]))
    jterms = jev._eval_terms_kernel(JGF.from_ints(rows[:4]), JGF.from_ints(rows[4:]), vals, _jgf2(gamma),
                                    _jgf2(delta))
    jS = jev._eval_scan_kernel(jterms)
    jrows = [row for k_ in range(4) for row in (_ju(jterms.c0)[k_], _ju(jterms.c1)[k_])] + [_ju(jS.c0), _ju(jS.c1)]
    assert jrows == aux
    n_tiles = -(-n // ev.EVAL_TILE)
    tiles = [_eval_tile_model(trace, rows, gamma, delta, n, b) for b in range(n_tiles)]
    got = [[None] * n for _ in range(10)]
    for terms, _, _ in tiles:
        for row, q in terms.items():
            for kk in range(4):
                got[2 * kk][row], got[2 * kk + 1][row] = q[kk]
    rng = np.random.default_rng(11)
    for resident in (1, 2, n_tiles):
        before, status, counters = _look_back_model([s for _, _, s in tiles], resident, rng, look)
        assert status == [0] * n_tiles and counters == (0, 0)
        for b, (_, local, _) in enumerate(tiles):
            for row, v in local.items():
                got[8][row], got[9][row] = _add(v, before[b])
        assert got == aux
    if planted:
        assert [(got[2 * k][r], got[2 * k + 1][r]), (got[2 * k2][r2], got[2 * k2 + 1][r2])] == [(0, 0), (0, 0)]
        assert all(got[2 * kk][row] or got[2 * kk + 1][row] for kk in range(4) for row in (r, r2)
                   if (kk, row) not in ((k, r), (k2, r2)) and rows[4 + kk, row])


@pytest.mark.parametrize("n_tiles, look", [(1, None), (2, None), (97, None), (300, None), (97, 1)])
def test_look_back_model_gives_every_prefix(n_tiles, look):
    """The look-back's model over random tile sums, at the source's
    LOOK_TILES (a step of 256 tiles: one step, and past one) and at one
    tile a lane (windows of 32: past one and two), 1, 3 and all tiles
    resident, in random orders: the sum before every tile equals the
    sequential prefix, and the counters and status words end at 0, ready
    for the next launch."""
    look = look or _source_int("logup.cu", "LOOK_TILES")
    rng = np.random.default_rng(n_tiles)
    sums = [tuple(int(v) for v in _felts(rng, 2)) for _ in range(n_tiles)]
    want = [(0, 0), *_inclusive(sums)][:-1]
    for resident in (1, 3, n_tiles):
        for _ in range(20 if n_tiles < 300 else 2):
            before, status, counters = _look_back_model(sums, resident, rng, look)
            assert before == want and status == [0] * n_tiles and counters == (0, 0)


def test_eval_args_layout_matches_the_source():
    """ctypes' _EvalArgs has csrc/logup.cu's EvalArgs fields in order: a
    pointer for each pointer, a 64-bit int for each int64_t."""
    src = open(os.path.join(os.path.dirname(ev.__file__), "..", "csrc", "logup.cu")).read()
    body = re.search(r"struct EvalArgs \{(.*?)\};", src, re.S).group(1)
    fields = [(m.group(2), "*" in m.group(1)) for m in re.finditer(r"^\s*([\w\s*]+?)\s*(\w+);", body, re.M)]
    want = [(name, ctype.__name__ == "c_void_p") for name, ctype in ev._EvalArgs._fields_]
    assert fields == want


def test_grind_matches_jax_and_check_grind():
    """pow_bits 1-10, three seeds each (one the largest field element):
    the JAX package's _grind_fn over batches of 64 from 0, grind_plain over
    the same batches and the host loop of grind give one nonce, which
    check_grind accepts; at 7 bits and up the hits lie past the first
    batch."""
    batch = 64
    past = 0
    for pow_bits in range(1, 11):
        jfn = jfri._grind_fn(pow_bits, batch)
        for seed in (3, 0x1234_5678_9ABC, P - 1):
            start, jnonce = 0, None
            while jnonce is None:
                idx, found = jfn(np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32), np.uint32(start))
                jnonce = start + int(idx) if bool(found) else None
                start += batch
            start, nonce = 0, None
            while nonce is None:
                nonce = ps.grind_plain(seed, pow_bits, start, batch, "cpu")
                assert nonce is None or start <= nonce < start + batch
                start += batch
            assert nonce == jnonce == fri.grind(seed, pow_bits) == fri.grind(seed, pow_bits, "cpu")
            assert fri.check_grind(seed, nonce, pow_bits)
            past += nonce >= batch
    assert past >= 6


def test_grind_plain_refuses_what_the_kernel_does_not_take():
    for args in ((P, 4, 0, 8), (-1, 4, 0, 8), (1, 0, 0, 8), (1, 33, 0, 8), (1, 4, -1, 8), (1, 4, 0, 0),
                 (1, 4, P - 4, 5)):
        with pytest.raises(ValueError):
            ps.grind_plain(*args, "cpu")
    with pytest.raises(TypeError):
        ps.grind_cuda(1, 4, 0, 8, "cpu")


def _source(name: str) -> str:
    return open(os.path.join(os.path.dirname(ps.__file__), "..", "csrc", name)).read()


def _source_int(name: str, constant: str) -> int:
    return int(re.search(rf"constexpr int {constant} = (\d+);", _source(name)).group(1))


def _hits(seed: int, pow_bits: int, start: int, span: int) -> np.ndarray:
    """Whether each candidate start + i, i < span, hits: the host oracle's
    hash_ints([seed, nonce]) lane 0 with `pow_bits` low zero bits."""
    mask = (1 << pow_bits) - 1
    return np.array([ps.hash_ints([seed, start + i])[0] & mask == 0 for i in range(span)])


def _grind_schedule_model(hits: np.ndarray, chunk: int, warps: int, rng) -> tuple[int | None, set]:
    """csrc/poseidon.cu: tmx_poseidon_grind_kernel's schedule over a span
    whose candidate i hits where hits[i]: `warps` resident warps, each a
    loop of three steps: lane 0 reads the best hit (span - scratch[1], the
    span while none), claims the next chunk (atomicAdd on scratch[0]) and
    stops when the chunk starts at or past what it read, else the warp
    hashes the chunk's candidates below the span, each hit taking atomicMax
    of span - i into scratch[1]. Every step is one random warp's, so reads,
    claims and chunk completions interleave in random orders. Returns the
    wrapper's read-back (span - scratch[1], None for 0) and the chunks
    hashed."""
    span = len(hits)
    counter, best = 0, 0
    step = {w: "read" for w in range(warps)}
    seen, claimed, hashed = {}, {}, set()
    while step:
        live = list(step)
        w = live[rng.integers(len(live))]
        if step[w] == "read":
            seen[w] = span - best
            step[w] = "claim"
        elif step[w] == "claim":
            claimed[w], counter = counter, counter + 1
            if claimed[w] * chunk >= seen[w]:
                del step[w]
            else:
                step[w] = "hash"
        else:
            first = claimed[w] * chunk
            for i in range(first, min(first + chunk, span)):
                if hits[i]:
                    best = max(best, span - i)
            hashed.add(claimed[w])
            step[w] = "read"
    return (span - best if best else None), hashed


@pytest.mark.parametrize("pow_bits", range(1, 11))
def test_grind_schedule_model_finds_the_smallest_hit(pow_bits):
    """The grinding kernel's schedule, modelled at the source's chunk size
    with 1, 3 and 17 warps in random orders, returns for three seeds (one
    the largest field element) the JAX package's _grind_fn nonce (batches
    of 64 from 0), the host loop's and grind_plain's: over a span from 0
    past the nonce, over one that ends at it (the hit in the span's last,
    ragged chunk) and over spans that start 5 and 40 candidates before it;
    over the span from 0 that stops just short of it, no hit (None). Every
    chunk below the hit is hashed, and at most a wave (one chunk a warp)
    past it."""
    chunk = _source_int("poseidon.cu", "GRIND_CHUNK")
    assert chunk == ps.GRIND_CHUNK == 32
    jfn = jfri._grind_fn(pow_bits, 64)
    rng = np.random.default_rng(pow_bits)
    late = 0
    for seed in (3, 0x1234_5678_9ABC, P - 1):
        start, jnonce = 0, None
        while jnonce is None:
            idx, found = jfn(np.uint32(seed & 0xFFFFFFFF), np.uint32(seed >> 32), np.uint32(start))
            jnonce = start + int(idx) if bool(found) else None
            start += 64
        nonce = fri.grind(seed, pow_bits)
        assert nonce == jnonce == ps.grind_plain(seed, pow_bits, 0, nonce + 100, "cpu")
        hits = _hits(seed, pow_bits, 0, nonce + 100)
        for begin, end in ((0, nonce + 100), (0, nonce + 1), (max(nonce - 5, 0), nonce + 3),
                           (max(nonce - 40, 0), nonce + 100)):
            assert ps.grind_plain(seed, pow_bits, begin, end - begin, "cpu") == nonce
            hit_chunk = (nonce - begin) // chunk
            for warps in (1, 3, 17):
                got, hashed = _grind_schedule_model(hits[begin:end], chunk, warps, rng)
                assert begin + got == nonce
                assert set(range(hit_chunk + 1)) <= hashed and max(hashed) <= hit_chunk + warps
            late += hit_chunk >= 3 and end == nonce + 1
        if nonce:
            assert _grind_schedule_model(hits[:nonce], chunk, 5, rng)[0] is None
            assert ps.grind_plain(seed, pow_bits, 0, nonce, "cpu") is None
    assert late or pow_bits < 8  # from 8 bits on some hit lies in a late, last chunk


def _sbox(x: int) -> int:
    return pow(x, 7, P)


_TWO_52 = np.float64(2.0**52)


def _half_to_double(x: np.ndarray) -> np.ndarray:
    """csrc/poseidon.cu: half_to_double, the bits of 2^52 + x less 2^52."""
    return (np.uint64(0x4330000000000000) | x.astype(np.uint64)).view(np.float64) - _TWO_52


def _double_to_u64(v: np.ndarray) -> np.ndarray:
    """csrc/poseidon.cu: double_to_u64, the mantissa of v + 2^52."""
    return (v + _TWO_52).view(np.uint64) & np.uint64((1 << 52) - 1)


def _expand_kernel_model(states: np.ndarray) -> np.ndarray:
    """csrc/poseidon.cu: tmx_poseidon_expand_kernel on R states, one thread
    a state (vectorised over the states here), in its order of stores. A
    full round S-boxes s + rc[r]; an MDS layer sums each row over the 12
    lanes' 32-bit halves as float64 (exact below 2^53; in through the bits
    of 2^52 + x less 2^52, out through the mantissa of v + 2^52) and adds
    the next round's constants or the zero row: rounds 0-2 are stored (S1..
    S3), round 3's MDS adds round 4's constants. A partial round takes
    lanes 1-11 into doubles, stores lane 0 (p_r), S-boxes it and sums the
    rows over lanes 1-11, then lane 0's terms last (the zero row after round
    25: w26, stored); rounds 26-28 as rounds 0-2 (w27..w29). Every store of
    column c of state b goes to word c R + b of the flat output, canonical,
    each word once. Returns that output as (106, R)."""
    R = len(states)
    rc, mds = ps.round_constants(), ps.mds_matrix()
    zero = [0] * ps.WIDTH
    flat = np.full(ps.EXPAND_COLS * R, -1, dtype=object)
    rows = np.arange(R)
    s = [[int(v) for v in states[:, j]] for j in range(ps.WIDTH)]  # lane j of every state

    def store(col, vals):
        idx = col * R + rows
        assert (flat[idx] == -1).all()
        flat[idx] = [v % P for v in vals]

    def halves(vals):
        u = np.array(vals, dtype=object)
        return (_half_to_double(np.array(u & 0xFFFFFFFF, dtype=np.uint64)),
                _half_to_double(np.array(u >> 32, dtype=np.uint64)))

    def sums(acc, h, lanes):
        for i in range(ps.WIDTH):
            for j in lanes:
                for half in (0, 1):
                    acc[i][half] = np.float64(mds[i][j]) * h[j][half] + acc[i][half]

    def reduce(acc, k_next):
        out = []
        for i in range(ps.WIDTH):
            lo, hi = (_double_to_u64(a).astype(object) for a in acc[i])
            assert max(lo.max(), hi.max()) < 2**43
            out.append([(int(a) + (int(c) << 32) + k_next[i]) % P for a, c in zip(lo, hi)])
        return out

    def full_round(r, k_next):
        nonlocal s
        s = [[_sbox((v + rc[r][j]) % P) for v in s[j]] for j in range(ps.WIDTH)]
        acc = [[np.zeros(R), np.zeros(R)] for _ in range(ps.WIDTH)]
        sums(acc, [halves(lane) for lane in s], range(ps.WIDTH))
        s = reduce(acc, k_next)

    def store_state(col0):
        for j in range(ps.WIDTH):
            store(col0 + j, s[j])

    for r in range(4):
        full_round(r, zero if r < 3 else rc[4])
        if r < 3:
            store_state(r * ps.WIDTH)
    for r in range(4, 26):
        h = [None] + [halves(s[j]) for j in range(1, ps.WIDTH)]
        store(3 * ps.WIDTH + r - 4, s[0])
        s[0] = [_sbox(v) for v in s[0]]
        acc = [[np.zeros(R), np.zeros(R)] for _ in range(ps.WIDTH)]
        sums(acc, h, range(1, ps.WIDTH))
        h[0] = halves(s[0])
        sums(acc, h, [0])
        s = reduce(acc, rc[r + 1] if r < 25 else zero)
    store_state(3 * ps.WIDTH + 22)
    for r in range(26, 29):
        full_round(r, zero)
        store_state(3 * ps.WIDTH + 22 + ps.WIDTH * (r - 25))
    assert (flat != -1).all()
    return flat.reshape(ps.EXPAND_COLS, R)


_EXPAND_STATES = _felts(np.random.default_rng(4), (69, ps.WIDTH))


@functools.cache
def _jax_expand() -> list:
    return np.asarray(jrec.expand_perm_states(JGF.from_ints(_EXPAND_STATES)).to_ints()).tolist()


@pytest.mark.parametrize("R", [1, 33, 69])
def test_expand_kernel_model_matches_expand_plain(R):
    """The round-state kernel's model on R states (one, a warp and one, two
    warps and a ragged third; edge values included): every word of the
    (106, R) output stored once, equal to expand_plain's columns and the
    JAX package's expand_perm_states; the source's kernel and entry, which
    take no more than the states and their count."""
    src = _source("poseidon.cu")
    assert "tmx_poseidon_expand_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n)" in src
    assert 'int tmx_poseidon_expand(const void* in, void* out, int64_t n, void* stream)' in src
    states = _EXPAND_STATES[:R]
    got = _expand_kernel_model(states)
    want = _u(ps.expand_plain(GF.from_ints(states).v))
    assert len(want) == ps.EXPAND_COLS == rec.N_PERM_COLS - rec.COL_S
    assert got.tolist() == want == [row[:R] for row in _jax_expand()]


def test_fp64_mds_rows_are_exact():
    """csrc/poseidon.cu's FP64 MDS on the largest halves (2^32 - 1 in every
    lane, the largest sums) and on random ones: each row's two sums through
    half_to_double, the products and double_to_u64 equal the integer sums,
    below 2^43."""
    rng = np.random.default_rng(9)
    mds = np.array(ps.mds_matrix(), dtype=np.float64)
    halves = np.concatenate([np.full((1, ps.WIDTH), 2**32 - 1), rng.integers(0, 2**32, size=(63, ps.WIDTH))])
    d = _half_to_double(halves.astype(np.uint64))
    assert (d == halves).all()
    for i in range(ps.WIDTH):
        acc = np.zeros(len(halves))
        for j in range(ps.WIDTH):
            acc = mds[i, j] * d[:, j] + acc
        want = (halves.astype(object) * np.array(ps.mds_matrix()[i], dtype=object)).sum(axis=1)
        got = _double_to_u64(acc)
        assert got.astype(object).tolist() == want.tolist() and int(want.max()) < 2**43


def test_cpu_tensors_take_the_plain_twins():
    """A CPU trace or state takes the plain twin and launches nothing; the
    static rows are uploaded once per tape and device; the kernel wrappers
    refuse CPU tensors and an unknown device raises."""
    n = 1 << 4
    trace, rows, gamma, delta = _eval_case(n, 5, False)
    tape = ev.Tape(op=np.zeros(n - 1, dtype=np.uint8), a=np.zeros(n - 1, dtype=np.uint32),
                   b=np.zeros(n - 1, dtype=np.uint32), c=np.zeros(n - 1, dtype=np.uint32), const=[1] * (n - 1),
                   is_input=np.zeros(n - 1, dtype=bool), input_tags=[], assert_rows=np.zeros(0, dtype=np.uint32),
                   m=np.ones(n - 1, dtype=np.uint32))
    air = ev.EvalAir(tape)
    assert tape.n_rows == n
    counts = lambda: (ev.eval_aux_kernel_launches, ps.expand_kernel_launches, ps.grind_kernel_launches,
                      ps.permute_kernel_launches)
    before = counts()
    t, chal = GF.from_ints(trace), [_gf2(gamma), _gf2(delta)]
    got = air.aux_columns(t, chal, [])
    assert air.aux_rows("cpu") is air.aux_rows(torch.device("cpu")) is tape.device_rows[torch.device("cpu")]
    assert _u(got.v) == _u(ev.eval_aux_plain(t, air.aux_rows("cpu"), *chal).v)
    states = GF.from_ints(_felts(np.random.default_rng(1), (8, ps.WIDTH)))
    assert _u(rec.expand_perm_states(states).v) == _u(ps.expand_plain(states.v))
    assert fri.grind(11, 6, "cpu") == fri.grind(11, 6)
    assert counts() == before
    with pytest.raises(TypeError):
        ev.eval_aux_cuda(t, air.aux_rows("cpu"), *chal)
    with pytest.raises(TypeError):
        ps.expand_cuda(states.v)
    meta = GF(torch.zeros((8, n), dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="device"):
        air.aux_columns(meta, chal, [])
    with pytest.raises(ValueError, match="device"):
        rec.expand_perm_states(GF(torch.zeros((2, ps.WIDTH), dtype=torch.int64, device="meta")))
