"""Ethereum transaction signing + submission (the operator's write path).

A copy of ``tendermintx_tpu/runtime/signer.py``: EIP-155 legacy
transactions, RLP encoding and deterministic RFC 6979 secp256k1 ECDSA,
self-contained (Python ints + utils/keccak). The upstream TendermintX
operator signs through ethers' middleware instead. The operator calls this
only after a composite proof verified: nothing is submitted on the
witness program's validity bit alone.
"""

from __future__ import annotations

import hashlib
import hmac

from ..utils.keccak import keccak256

# secp256k1 domain parameters
_P = 2**256 - 2**32 - 977
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _pt_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % _P == 0:
        return None
    if p == q:
        lam = 3 * p[0] * p[0] * _inv(2 * p[1], _P) % _P
    else:
        lam = (q[1] - p[1]) * _inv(q[0] - p[0], _P) % _P
    x = (lam * lam - p[0] - q[0]) % _P
    return (x, (lam * (p[0] - x) - p[1]) % _P)


def _pt_mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _pt_add(acc, pt)
        pt = _pt_add(pt, pt)
        k >>= 1
    return acc


def _rfc6979_nonces(priv: int, msg_hash: bytes):
    """Deterministic nonce stream (RFC 6979, HMAC-SHA256). Yields the
    candidate nonces in spec order; a rejected candidate (k out of range,
    or a downstream r == 0 / s == 0 / R.x >= N) is retried by CONTINUING
    this K/V update loop per RFC 6979 §3.2.h.3 — never by altering the
    digest being signed (mutating msg_hash would silently sign a
    different message)."""
    x = priv.to_bytes(32, "big")
    h1 = msg_hash
    V = b"\x01" * 32
    K = b"\x00" * 32
    K = hmac.new(K, V + b"\x00" + x + h1, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x + h1, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 1 <= k < _N:
            yield k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


def ecdsa_sign(priv: int, msg_hash: bytes) -> tuple[int, int, int]:
    """Returns (r, s, recovery_id) with low-s normalization; rec is always
    0 or 1 (candidates with R.x >= N — which would need the EIP-155-invalid
    '2' bit — are skipped, continuing the RFC 6979 nonce loop)."""
    z = int.from_bytes(msg_hash, "big")
    for k in _rfc6979_nonces(priv, msg_hash):
        R = _pt_mul(k, (_GX, _GY))
        if R[0] >= _N:  # rec bit 2: unencodable in EIP-155 v — skip nonce
            continue
        r = R[0] % _N
        if r == 0:
            continue
        s = _inv(k, _N) * (z + r * priv) % _N
        if s == 0:
            continue
        rec = R[1] & 1
        if s > _N // 2:  # low-s (EIP-2)
            s = _N - s
            rec ^= 1
        return r, s, rec
    raise RuntimeError("unreachable: RFC 6979 nonce stream is infinite")


def ecdsa_verify(pub: tuple[int, int], msg_hash: bytes, r: int, s: int) -> bool:
    if not (1 <= r < _N and 1 <= s < _N):
        return False
    z = int.from_bytes(msg_hash, "big")
    w = _inv(s, _N)
    u1, u2 = z * w % _N, r * w % _N
    pt = _pt_add(_pt_mul(u1, (_GX, _GY)), _pt_mul(u2, pub))
    return pt is not None and pt[0] % _N == r


def private_to_address(priv: int) -> str:
    pub = _pt_mul(priv, (_GX, _GY))
    raw = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    return "0x" + keccak256(raw)[-20:].hex()


# ---------------------------------------------------------------------------
# RLP + legacy (EIP-155) transactions
# ---------------------------------------------------------------------------


def rlp_encode(item) -> bytes:
    if isinstance(item, int):
        if item == 0:
            b = b""
        else:
            b = item.to_bytes((item.bit_length() + 7) // 8, "big")
        return rlp_encode(b)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _rlp_len(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _rlp_len(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _rlp_len(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def sign_legacy_tx(
    priv: int,
    *,
    nonce: int,
    gas_price: int,
    gas: int,
    to: str,
    value: int,
    data: bytes,
    chain_id: int,
) -> bytes:
    """EIP-155 signed raw transaction bytes."""
    to_b = bytes.fromhex(to.removeprefix("0x"))
    unsigned = [nonce, gas_price, gas, to_b, value, data, chain_id, 0, 0]
    h = keccak256(rlp_encode(unsigned))
    r, s, rec = ecdsa_sign(priv, h)
    v = chain_id * 2 + 35 + rec
    return rlp_encode([nonce, gas_price, gas, to_b, value, data, v, r, s])


class EthSubmitter:
    """Build + sign + submit contract calls through an EthClient."""

    def __init__(self, client, private_key: str, chain_id: int):
        self.client = client
        self.priv = int(private_key.removeprefix("0x"), 16)
        self.chain_id = chain_id
        self.address = private_to_address(self.priv)

    def submit(self, to: str, calldata: str, gas: int = 500_000) -> str:
        nonce = int(
            self.client.call(
                "eth_getTransactionCount", [self.address, "pending"]
            ),
            16,
        )
        gas_price = int(self.client.call("eth_gasPrice", []), 16)
        raw = sign_legacy_tx(
            self.priv,
            nonce=nonce,
            gas_price=gas_price,
            gas=gas,
            to=to,
            value=0,
            data=bytes.fromhex(calldata.removeprefix("0x")),
            chain_id=self.chain_id,
        )
        return self.client.call("eth_sendRawTransaction", ["0x" + raw.hex()])
