"""Loader for the native host core (``native/goldilocks_poseidon.cpp``).

The port's own counterpart of ``tendermintx_tpu/utils/native.py`` (that
module reaches jax through its Poseidon import). The C++ core serves the
host-side Poseidon oracle used by the Fiat-Shamir challenger and the
verifier's Merkle checks. It is compiled with g++ on first use into
``build/native/``, keyed by a hash of the source; if g++ is missing or
fails, callers use the pure-Python oracle in ``ops/poseidon.py``, which
computes the same values.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from functools import cache

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "goldilocks_poseidon.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libtmx_native_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native core build failed (%s); using pure-Python paths", e)
        return None
    os.replace(tmp, out)
    return out


@cache
def load():
    """The initialised ctypes library, or None when it cannot be built."""
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        log.warning("native core load failed: %s", e)
        return None
    u64 = ctypes.c_uint64
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.tmx_poseidon_init.argtypes = [u64p, u64p]
    lib.tmx_poseidon_init.restype = None
    lib.tmx_poseidon_permute.argtypes = [u64p]
    lib.tmx_poseidon_permute.restype = None
    lib.tmx_poseidon_hash.argtypes = [u64p, u64, u64p]
    lib.tmx_poseidon_hash.restype = None
    lib.tmx_poseidon_two_to_one.argtypes = [u64p, u64p, u64p]
    lib.tmx_poseidon_two_to_one.restype = None
    lib.tmx_merkle_verify.restype = ctypes.c_int
    lib.tmx_merkle_verify.argtypes = [u64p, u64, u64p, u64, u64p, u64]

    from ..ops import poseidon as ps

    rc = ps.round_constants()
    mds = ps.mds_matrix()
    n_rc = ps.N_ROUNDS * ps.WIDTH
    rc_arr = (ctypes.c_uint64 * n_rc)(*[v for row in rc for v in row])
    mds_arr = (ctypes.c_uint64 * (ps.WIDTH * ps.WIDTH))(
        *[v for row in mds for v in row]
    )
    lib.tmx_poseidon_init(rc_arr, mds_arr)
    return lib


def permute_ints_native(state: list[int]) -> list[int] | None:
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_uint64 * 12)(*state)
    lib.tmx_poseidon_permute(buf)
    return list(buf)


def hash_ints_native(inputs: list[int]) -> list[int] | None:
    lib = load()
    if lib is None:
        return None
    arr = (ctypes.c_uint64 * len(inputs))(*inputs)
    out = (ctypes.c_uint64 * 4)()
    lib.tmx_poseidon_hash(arr, len(inputs), out)
    return list(out)


def two_to_one_native(left: list[int], right: list[int]) -> list[int] | None:
    lib = load()
    if lib is None:
        return None
    l = (ctypes.c_uint64 * 4)(*left)
    r = (ctypes.c_uint64 * 4)(*right)
    out = (ctypes.c_uint64 * 4)()
    lib.tmx_poseidon_two_to_one(l, r, out)
    return list(out)


def merkle_verify_native(
    root: list[int], index: int, leaf_row: list[int], path: list[list[int]]
) -> bool | None:
    lib = load()
    if lib is None:
        return None
    root_a = (ctypes.c_uint64 * 4)(*root)
    row_a = (ctypes.c_uint64 * len(leaf_row))(*leaf_row)
    flat = [v for sib in path for v in sib]
    path_a = (ctypes.c_uint64 * len(flat))(*flat)
    return bool(
        lib.tmx_merkle_verify(root_a, index, row_a, len(leaf_row), path_a, len(path))
    )
