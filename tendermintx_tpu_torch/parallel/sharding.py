"""The lane mesh: one controller driving shards on an ordered device list.

Counterpart of ``tendermintx_tpu/parallel/sharding.py``. The data-parallel
axes of the workload map onto a 1-D "lanes" mesh:

  * validator lanes   -> sharded Ed25519 ladders and SHA-256 leaf hashing;
  * voting-power sums -> a chunked psum, recombined with exact carries;
  * prover phases     -> column- and row-sharded LDE, quotient, DEEP, leaf
                         hashing and FRI folds (parallel/prover.py).

The reference runs one controller over a ``jax.sharding.Mesh`` with
``shard_map`` and lets XLA insert the collectives. Here a ``LaneMesh`` is an
ordered tuple of ``torch.device``s, a shard is a tensor on its mesh device
(shard i on ``mesh.devices[i]``), and every collective is an explicit
function over the list of shards with the reference's semantics: the
``ppermute`` pairs (a device no pair sends to receives zeros),
``all_to_all``'s tiled source-major order, ``psum`` and ``pmin``. Each
collective moves data with ``Tensor.to(dst, non_blocking=True)`` or
``torch.cat``; between two distinct cards that is a peer copy, ordered
after the source's pending work by the copy itself. On a one-device mesh
(the prover's path without ``mesh=``) every collective is the identity.

The mesh does not use ``torch.distributed`` or NCCL process groups: NCCL
refuses two ranks on one GPU, so a mesh of several shards on one card (the
way a one-card host runs the mesh path) could not run its collectives, and
a CPU mesh would need one torch process per shard. A device list may repeat
a device: ``[torch.device("cpu")] * 8`` on the CPU, ``[cuda:0] * 4`` on one
card. ``make_lane_mesh`` never puts shards on the CPU unless asked to.
"""

from __future__ import annotations

import torch

from ..circuits import gadgets as g
from ..ops import ed25519, poseidon, sha256
from ..ops.goldilocks import GF

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


class LaneMesh:
    """An ordered, non-empty tuple of devices of one type along the
    "lanes" axis."""

    __slots__ = ("devices",)

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a lane mesh needs at least one device")
        devs = tuple(
            torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in devs
        )
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a lane mesh holds devices of one type, got {devs}")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"LaneMesh({[str(d) for d in self.devices]})"

    @property
    def first(self) -> torch.device:
        """The device that holds what is not sharded (the reference's
        replicated values, the host fetches)."""
        return self.devices[0]

    def split(self, x: torch.Tensor, dim: int = 0) -> list[torch.Tensor]:
        """Shard `x` along `dim` into equal blocks, block i on device i
        (the reference's in_spec P("lanes") on that axis)."""
        D = self.size
        n = int(x.shape[dim])
        if n % D:
            raise ValueError(f"axis of {n} does not split over {D} shards")
        return [b.to(d, non_blocking=True) for b, d in zip(torch.chunk(x, D, dim=dim), self.devices)]

    def gather(self, shards: list[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """Concatenate the shards along `dim` on the first device (the
        reference's out_spec P("lanes"), fetched whole)."""
        self._check(shards)
        if self.size == 1:
            return shards[0].to(self.first, non_blocking=True)
        return torch.cat([s.to(self.first, non_blocking=True) for s in shards], dim=dim)

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The same value on every device (the reference's P(None))."""
        return [x.to(d, non_blocking=True) for d in self.devices]

    def _check(self, shards):
        if len(shards) != self.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {self.size}")


def make_lane_mesh(n_devices: int | None = None, devices=None) -> LaneMesh:
    """A lane mesh over `devices`, or else over the first `n_devices`
    visible CUDA cards (all of them when None). Raises when CUDA is not
    available or has fewer cards than asked for: shards go on the CPU only
    when the caller lists CPU devices."""
    if devices is not None:
        devices = list(devices)
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(f"{n_devices} shards asked for, {len(devices)} devices given")
            devices = devices[:n_devices]
        return LaneMesh(devices)
    if not torch.cuda.is_available():
        raise RuntimeError("make_lane_mesh: CUDA is not available (pass devices= to build a CPU mesh)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise RuntimeError(f"make_lane_mesh: {n} cards asked for, {count} visible")
    return LaneMesh([torch.device("cuda", i) for i in range(n)])


def mesh_device(device, mesh: LaneMesh | None) -> torch.device:
    """The device an entry point taking ``device=`` and ``mesh=`` runs its
    unsharded work on: `device` without a mesh (then it is required), the
    mesh's first device with one (then `device` must name that device or
    be left out)."""
    if mesh is None:
        if device is None:
            raise TypeError("device= is required when no mesh= is given")
        return torch.device(device)
    if device is not None and LaneMesh([device]).first != mesh.first:
        raise ValueError(f"device {device} is not the mesh's first device {mesh.first}")
    return mesh.first


# ---------------------------------------------------------------------------
# Collectives over a list of shards (shard i on mesh.devices[i])
# ---------------------------------------------------------------------------


def ppermute(mesh: LaneMesh, shards: list[torch.Tensor], perm) -> list[torch.Tensor]:
    """out[dst] = shards[src] for every (src, dst) pair; a device that no
    pair sends to receives zeros, as ``lax.ppermute``."""
    mesh._check(shards)
    out: list[torch.Tensor | None] = [None] * mesh.size
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"device {dst} receives twice")
        out[dst] = shards[src].to(mesh.devices[dst], non_blocking=True)
    return [o if o is not None else torch.zeros_like(s) for o, s in zip(out, shards)]


def all_to_all(mesh: LaneMesh, shards: list[torch.Tensor], split_dim: int, concat_dim: int) -> list[torch.Tensor]:
    """``lax.all_to_all(..., tiled=True)``: every shard splits along
    `split_dim` into D blocks, block j goes to device j, and device j
    concatenates what it receives along `concat_dim` in source order."""
    mesh._check(shards)
    D = mesh.size
    if D == 1:
        return [shards[0].to(mesh.first, non_blocking=True)]
    pieces = [torch.chunk(s, D, dim=split_dim) for s in shards]
    if any(len(p) != D or int(s.shape[split_dim]) % D for p, s in zip(pieces, shards)):
        raise ValueError(f"split axis does not divide over {D} shards")
    return [
        torch.cat([pieces[src][dst].to(dev, non_blocking=True) for src in range(D)], dim=concat_dim)
        for dst, dev in enumerate(mesh.devices)
    ]


def psum(mesh: LaneMesh, shards: list[torch.Tensor]) -> list[torch.Tensor]:
    """Integer sum of the shards, replicated on every device. (An int64
    sum: the callers keep their terms far below 2^63.)"""
    mesh._check(shards)
    total = shards[0].to(mesh.first)
    for s in shards[1:]:
        total = total + s.to(mesh.first, non_blocking=True)
    return mesh.replicate(total)


def pmin(mesh: LaneMesh, shards: list[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise minimum of the shards, replicated on every device."""
    mesh._check(shards)
    low = shards[0].to(mesh.first)
    for s in shards[1:]:
        low = torch.minimum(low, s.to(mesh.first, non_blocking=True))
    return mesh.replicate(low)


# ---------------------------------------------------------------------------
# Lane-sharded programs
# ---------------------------------------------------------------------------


def chunked_u64_psum(mesh: LaneMesh, lo: list[torch.Tensor], hi: list[torch.Tensor]):
    """Exact u64 sum of per-shard (lo, hi) 32-bit limb pairs, wrapping at
    2^64 as the reference does: the limbs are psum'd in 16-bit chunks so
    that no chunk sum can wrap 32 bits, then recombined with explicit
    carries (``parallel/sharding.py``'s masked_sum). Returns (lo, hi) on
    the first device."""
    c0 = psum(mesh, [x & _M16 for x in lo])[0]
    c1 = psum(mesh, [(x >> 16) & _M16 for x in lo])[0]
    c2 = psum(mesh, [x & _M16 for x in hi])[0]
    c3 = psum(mesh, [(x >> 16) & _M16 for x in hi])[0]
    lo_final = (c0 + ((c1 & _M16) << 16)) & _M32
    wrap = (lo_final < c0).to(torch.int64)
    carry = (c1 >> 16) + wrap
    hi_final = (c2 + ((c3 & _M16) << 16) + carry) & _M32
    return lo_final, hi_final


def sharded_lane_checks(mesh: LaneMesh):
    """The signature, leaf-hash and voting checks with the lanes sharded
    across the mesh.

    fn(table_x, table_y, table_t, bits2, rx, ry, sig_r, sig_s, sig_pk,
       messages, msg_len, k_q, leaf_bytes, leaf_len,
       vp_lo, vp_hi, signed, enabled)
      -> (all_sigs_ok () bool, leaf_digests (B, 32) gathered,
          signed_power (lo, hi), total_power (lo, hi))

    Every argument is lane-major (B, ...) with B a multiple of the mesh
    size; the results are on the mesh's first device."""

    def fn(
        table_x, table_y, table_t, bits2, rx, ry,
        sig_r, sig_s, sig_pk, messages, msg_len, k_q,
        leaf_bytes, leaf_len, vp_lo, vp_hi, signed, enabled,
    ):
        args = (
            table_x, table_y, table_t, bits2, rx, ry,
            sig_r, sig_s, sig_pk, messages, msg_len, k_q,
            leaf_bytes, leaf_len, vp_lo, vp_hi, signed, enabled,
        )
        sharded = [mesh.split(torch.as_tensor(a), 0) for a in args]
        per_shard = list(zip(*sharded))
        # per shard: this device's group of signatures, with full witness
        # binding (challenge SHA-512 included); pmin'd into one flag
        sig_ok_local = [ed25519.verify_bound(*s[:12]).all().to(torch.int64) for s in per_shard]
        sig_ok = pmin(mesh, sig_ok_local)[0] == 1
        digests = mesh.gather([g.hash_validator_leaves(s[12], s[13]) for s in per_shard])

        def masked_sum(mask_of):
            sums = [g.u64_sum_masked(s[14], s[15], mask_of(s)) for s in per_shard]
            return chunked_u64_psum(mesh, [lo for lo, _ in sums], [hi for _, hi in sums])

        signed_power = masked_sum(lambda s: s[16] & s[17])
        total_power = masked_sum(lambda s: s[17])
        return sig_ok, digests, signed_power, total_power

    return fn


def sharded_poseidon_throughput(mesh: LaneMesh):
    """Data-parallel Poseidon permutation: fn(states GF (B, 12)) -> GF
    (B, 12) on the first device, each shard permuted on its device (the
    kernel on a card)."""

    def fn(states: GF) -> GF:
        shards = mesh.split(states.v, 0)
        return GF(mesh.gather([poseidon.permute_tensor(s.contiguous()) for s in shards]))

    return fn


def sharded_sha256(mesh: LaneMesh):
    """Lane-sharded batched SHA-256 of pre-padded blocks:
    fn(blocks (B, n_blocks, 16), n_active (B,)) -> (B, 8) words."""

    def fn(blocks: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
        parts = zip(mesh.split(blocks, 0), mesh.split(torch.as_tensor(n_active), 0))
        return mesh.gather([sha256.sha256_blocks(b, n) for b, n in parts])

    return fn
