"""The fixture chain from --seed: the same sizes from every seed, the
requests an operator catching up would send, and only the fixtures they
read."""

import json
import os

from harness import chain


def _cfg(circuit, share=(1.0, 1.0)):
    return {"circuit": circuit, "chain_id": "celestia", "n_validators": 8, "voting_power": 100,
            "signing_share": list(share)}


def _traffic(advance):
    return {"advance": advance, "warmup_updates": 1, "max_updates": 3}


def _signers(fixtures, height):
    with open(os.path.join(fixtures, str(height), "commit.json")) as f:
        sigs = json.load(f)["result"]["signed_header"]["commit"]["signatures"]
    return [i for i, s in enumerate(sigs) if s["block_id_flag"] == 2]


def test_skip_requests_and_fixtures(tmp_path):
    reqs = chain.build(_cfg("skip"), _traffic(4), 2**31 + 5, str(tmp_path))
    assert [(r.start, r.target) for r in reqs] == [(2, 6), (6, 10), (10, 14), (14, 18)]
    assert sorted(int(d) for d in os.listdir(tmp_path)) == [2, 6, 10, 14, 18]
    raw = bytes.fromhex(reqs[1].input_hex[2:])
    assert raw == (6).to_bytes(8, "big") + reqs[1].start_hash + (10).to_bytes(8, "big")
    assert reqs[0].target_hash == reqs[1].start_hash
    assert _signers(str(tmp_path), 18) == list(range(8))


def test_step_requests(tmp_path):
    reqs = chain.build(_cfg("step"), _traffic(1), 7, str(tmp_path))
    assert [(r.start, r.target) for r in reqs] == [(2, 3), (3, 4), (4, 5), (5, 6)]
    assert bytes.fromhex(reqs[2].input_hex[2:]) == (4).to_bytes(8, "big") + reqs[2].start_hash


def test_seeds_change_keys_not_sizes(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    cfg = _cfg("step", share=(0.7, 0.9))
    ra = chain.build(cfg, _traffic(1), 11, str(a))
    rb = chain.build(cfg, _traffic(1), 12, str(b))
    assert [r.start_hash for r in ra] != [r.start_hash for r in rb]
    for h in range(3, 7):
        sa, sb = _signers(str(a), h), _signers(str(b), h)
        assert len(sa) == len(sb) and 6 <= len(sa) <= 8
