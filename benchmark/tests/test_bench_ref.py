"""The benchmark's own reference (``ref/cometbft.py``) against CometBFT's
published test vector, against a second witness (the frozen chain
generator, which hashes as the port does), and its Merkle paths against
their roots."""

import hashlib
import os

from chaingen.testchain import TestChain
from chaingen.tendermint import Commit, canonical_vote_sign_bytes
from harness import chain
from ref import cometbft


def _sha(s: bytes) -> str:
    return hashlib.sha256(s).hexdigest()


def test_header_hash_vector():
    """CometBFT types/block_test.go TestHeaderHash, "generates hash"."""
    header = {
        "version": {"block": "1", "app": "2"},
        "chain_id": "chainId",
        "height": "3",
        "time": "2019-10-13T16:14:44Z",
        "last_block_id": {"hash": "00" * 32, "parts": {"total": 6, "hash": "00" * 32}},
        "last_commit_hash": _sha(b"last_commit_hash"),
        "data_hash": _sha(b"data_hash"),
        "validators_hash": _sha(b"validators_hash"),
        "next_validators_hash": _sha(b"next_validators_hash"),
        "consensus_hash": _sha(b"consensus_hash"),
        "app_hash": _sha(b"app_hash"),
        "last_results_hash": _sha(b"last_results_hash"),
        "evidence_hash": _sha(b"evidence_hash"),
        "proposer_address": _sha(b"proposer_address")[:40],
    }
    assert cometbft.header_hash(header).hex().upper() == (
        "F740121F553B5418C3EFBD343C2DBFE9E007BB67B0D020A0741374BAB65242A4"
    )


def test_agrees_with_the_chain_generator():
    """Headers past genesis, validator sets and precommit sign-bytes of a
    chain with absent signers, at a nonzero round."""
    ch = TestChain(n_validators=7, chain_id="celestia", powers=[100, 3, 50, 7, 1000, 1, 20], seed=b"ref")
    for _ in range(4):
        ch.extend(signers=[0, 2, 3, 5, 6], round=1)
    for h in sorted(ch.headers)[1:]:
        sh = ch.commit_rpc(h)["result"]["signed_header"]
        assert cometbft.header_hash(sh["header"]) == ch.headers[h].hash()
        vals = ch.validators_rpc(h)["result"]["validators"]
        assert cometbft.validators_hash(vals).hex().upper() == sh["header"]["validators_hash"]
        commit = Commit.from_rpc(sh["commit"])
        for i, sig in enumerate(sh["commit"]["signatures"]):
            if sig["block_id_flag"] == cometbft.BLOCK_ID_FLAG_COMMIT:
                assert cometbft.precommit_sign_bytes(sh["commit"], sig, "celestia") == canonical_vote_sign_bytes(
                    commit, commit.signatures[i], "celestia")


def test_merkle_aunts_reach_the_root():
    for n in range(1, 21):
        items = [bytes([i]) * (i % 5) for i in range(n)]
        root = cometbft.merkle_root(items)
        for index in range(n):
            node = hashlib.sha256(b"\x00" + items[index]).digest()
            # the split points from the top down, then the aunts folded bottom-up
            spans = []
            a, b = 0, n
            while b - a > 1:
                k = 1 << ((b - a - 1).bit_length() - 1)
                spans.append((a, a + k, b))
                a, b = (a, a + k) if index < a + k else (a + k, b)
            aunts = cometbft.merkle_aunts(items, index)
            assert len(aunts) == len(spans)
            for (a, mid, b), aunt in zip(reversed(spans), aunts):
                node = hashlib.sha256(b"\x01" + (node + aunt if index < mid else aunt + node)).digest()
            assert node == root, (n, index)


def test_requests_start_past_genesis(tmp_path):
    cfg = {"circuit": "step", "chain_id": "celestia", "n_validators": 4, "voting_power": 100,
           "signing_share": [1.0, 1.0]}
    reqs = chain.build(cfg, {"advance": 1, "warmup_updates": 1, "max_updates": 2}, 5, str(tmp_path))
    assert reqs[0].start == 2
    assert sorted(int(d) for d in os.listdir(tmp_path)) == [2, 3, 4, 5]
