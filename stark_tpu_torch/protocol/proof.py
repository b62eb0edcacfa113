"""STARK proof container and its serde_json-compatible JSON codec.

The port's own copy of `stark_tpu/protocol/proof.py` (which imports the
jax-backed FRI and Merkle modules). Same layout, so proofs are
byte-interchangeable with the JAX package and the reference: byte strings
as JSON arrays of ints, `Proof {leaf, nodes}`, FRI rounds as
{"Middle": {...}} / {"Last": {...}}, StarkProof fields in declaration
order, compact separators.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from stark_tpu_torch.fri.fri import FriLast, FriMiddle
from stark_tpu_torch.merkle.tree import MerkleProof


@dataclass
class StarkProof:
    m_root: bytes
    l_root: bytes
    a_root: bytes
    main_branches: list[MerkleProof]
    linear_comb_branches: list[MerkleProof]
    fri_proof: list  # FriMiddle | FriLast


def _proof_json(p: MerkleProof):
    return {"leaf": list(p.leaf), "nodes": [list(n) for n in p.nodes]}


def _fri_json(f):
    if isinstance(f, FriMiddle):
        return {
            "Middle": {
                "root2": list(f.root2),
                "column_branches": [_proof_json(p) for p in f.column_branches],
                "poly_branches": [_proof_json(p) for p in f.poly_branches],
            }
        }
    return {"Last": {"last": [list(v) for v in f.last]}}


def to_json(proof: StarkProof) -> str:
    obj = {
        "m_root": list(proof.m_root),
        "l_root": list(proof.l_root),
        "a_root": list(proof.a_root),
        "main_branches": [_proof_json(p) for p in proof.main_branches],
        "linear_comb_branches": [_proof_json(p) for p in proof.linear_comb_branches],
        "fri_proof": [_fri_json(f) for f in proof.fri_proof],
    }
    return json.dumps(obj, separators=(",", ":"))


def _proof_from(obj) -> MerkleProof:
    return MerkleProof(leaf=bytes(obj["leaf"]), nodes=[bytes(n) for n in obj["nodes"]])


def _fri_from(obj):
    if "Middle" in obj:
        m = obj["Middle"]
        return FriMiddle(
            root2=bytes(m["root2"]),
            column_branches=[_proof_from(p) for p in m["column_branches"]],
            poly_branches=[_proof_from(p) for p in m["poly_branches"]],
        )
    return FriLast(last=[bytes(v) for v in obj["Last"]["last"]])


def from_json(text: str) -> StarkProof:
    """Parse an UNTRUSTED proof; any structural defect raises ValueError.
    Counts and lengths are checked by `verify._validate_proof_shape`."""
    try:
        obj = json.loads(text)
        return StarkProof(
            m_root=bytes(obj["m_root"]),
            l_root=bytes(obj["l_root"]),
            a_root=bytes(obj["a_root"]),
            main_branches=[_proof_from(p) for p in obj["main_branches"]],
            linear_comb_branches=[_proof_from(p) for p in obj["linear_comb_branches"]],
            fri_proof=[_fri_from(f) for f in obj["fri_proof"]],
        )
    except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed proof JSON: {e}") from None
