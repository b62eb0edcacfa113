"""FRI low-degree proofs (4x folding, 40 queries a round, direct check at 16).

Counterpart of `stark_tpu/fri/fri.py`: the fold on its two routes, the
radix-4 inverse DFT (`_fold_j :163-190`) through the kernel
`fri_fold_dft`, special_x included, and the general Lagrange
interpolation through the kernels `fri_fold_pre` / `fri_fold_post`
(`:149-155`), the recursion with every challenge derived on the device
(`_fri_chain_j :244`, `prove_low_degree_pending :304`), host assembly
(`assemble_fri :395`) and the host verifier (`verify_low_degree_proof :417`).

Every tree of the recursion (and the last round's root that the verifier
recomputes) takes the prover's `digest`, "blake2s" or "poseidon", as at
`stark_tpu/fri/fri.py:66, 270, 424-490`.

The route is an explicit argument, `fri_fold="dft"` (the default, as in the
JAX package) or `"lagrange"` (the JAX package's `STARK_TPU_FRI_LAGRANGE=1`).
Both give the same field values, so the proof does not depend on it. On
either route the kernels run in every round whatever its size: their
wrappers choose by the tensor's device alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.protocol import transcript as ts
from stark_tpu_torch.utils import poly_host as ph
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import device_transcript as dt
from stark_tpu_torch.protocol import fused_kernels as fk
from stark_tpu_torch.protocol.core import leaves_to_words
from stark_tpu_torch.utils.tracing import phase

MIN_DEG_DIRECT_CHECKING = 16
QUERIES_PER_ROUND = 40
FOLD_ROUTES = ("dft", "lagrange")


def check_fold_route(route: str) -> str:
    if route not in FOLD_ROUTES:
        raise ValueError(f"fri_fold must be one of {FOLD_ROUTES}, got {route!r}")
    return route


@dataclass
class FriLast:
    last: list[bytes]  # 32-byte LE field elements (all values of the domain)


@dataclass
class FriMiddle:
    root2: bytes
    column_branches: list[mt.MerkleProof]
    poly_branches: list[mt.MerkleProof]


def fold(spec: FieldSpec, values, xs, root_words, route: str = "dft"):
    """The 4x fold at special_x, the previous tree's root `root_words` (8,)
    read as a little-endian integer mod p: row i holds the values at the
    four points x_j[i] = x[j*n/4 + i] of the round's domain x, every
    (m/n)-th point of xs. values: contiguous (L, n); xs: contiguous
    (L, m), m a multiple of n (the recursion passes the whole domain's
    table in every round).

    "dft": the row points are a coset of the 4th roots of unity, x_j =
    x * I^j with I = g^(n/4), so the interpolation is an exact radix-4
    inverse DFT:
        p(sx) = (1/4) * sum_k u_k t^k,  u_k = sum_j v_j I^(-jk),
        t = sx * x^-1,
    with x_i^-1 = x[(n - i) mod n]: the kernel `fri_fold_dft`, special_x
    included, one launch a round.

    "lagrange": special_x (`digest_le_int_mont`), then general 4-point
    Lagrange interpolation, `fri_fold_pre` (the denominators), one
    `multi_inv` over all n of them, `fri_fold_post` (each row's
    interpolant at sx from its x, y and inverted denominators)."""
    if check_fold_route(route) == "dft":
        return fk.fri_fold_dft(spec, root_words, values, xs)
    L, n = values.shape
    quarter = n // 4
    sx = dt.digest_le_int_mont(spec, root_words)
    xs4 = xs[:, :: xs.shape[1] // n].reshape(L, 4, quarter).contiguous()
    dens = fk.fri_fold_pre(spec, xs4)
    invs = mm.multi_inv(spec, dens.reshape(L, n)).reshape(L, 4, quarter)
    return fk.fri_fold_post(spec, sx, xs4, values.reshape(L, 4, quarter), invs)


def n_rounds(max_deg_plus_1: int, cutoff: int = MIN_DEG_DIRECT_CHECKING) -> int:
    r = 0
    while max_deg_plus_1 > cutoff:
        r += 1
        max_deg_plus_1 //= 4
    return r


def prove_low_degree_pending(spec: FieldSpec, values, xs_full, max_deg_plus_1: int,
                             exclude_multiples_of: int, first_tree: mt.DeviceMerkleTree,
                             fri_fold: str = "dft", digest: str = "blake2s"):
    """The whole FRI recursion, enqueued without a host sync. `first_tree`
    is the caller's tree over `values` with 32-byte leaves (the prover's
    l-tree, under the same `digest`; the reference recommits identical
    content): round 0 reads its `root_words` and its `gather`, so a
    mesh's sharded l-tree serves as well as a whole one. `fri_fold` names
    the fold's route in every round, `digest` the column trees' digest.
    Returns the
    pending record whose `device_arrays` the caller materializes with the
    rest of the proof: per round (root2, col_flat, val_flat), then the
    direct-check `last` words. Each round opens two phases
    (`utils/tracing.py`) inside the caller's: `fri_fold` (special_x and
    the fold) and `fri_commit` (the column's leaves, tree and root); the
    queries and gathers stay in the caller's."""
    check_fold_route(fri_fold)
    rounds = n_rounds(max_deg_plus_1)
    tree = first_tree
    outs = []
    for _ in range(rounds):
        quarter = values.shape[1] // 4
        with phase("fri_fold", device=values.device):
            column = fold(spec, values, xs_full, tree.root_words, fri_fold)
        with phase("fri_commit", device=values.device):
            c_words = leaves_to_words(spec, [column])
            c_tree = mt.DeviceMerkleTree(c_words, 32,
                                         mt.build_layers_digest(c_words, 32, digest))
            root2_w = c_tree.root_words
        ys = dt.pseudorandom_indices(root2_w, quarter, QUERIES_PER_ROUND,
                                     exclude_multiples_of)
        poly_positions = (
            ys[:, None] + quarter * torch.arange(4, device=ys.device)[None, :]
        ).reshape(-1)
        val_flat = tree.gather(poly_positions)
        col_flat = c_tree.gather(ys)
        outs.extend([root2_w, col_flat, val_flat])
        values, tree = column, c_tree
    outs.append(leaves_to_words(spec, [values])[:8])
    return {"device_arrays": outs, "n_rounds": rounds}


def materialize_u32(arrs) -> list[np.ndarray]:
    """Move many int32 device tensors to the host in ONE transfer, as uint32."""
    cat = torch.cat([a.reshape(-1).to(torch.int32) for a in arrs])
    big = cat.cpu().numpy().view(np.uint32)
    out, off = [], 0
    for a in arrs:
        size = a.numel()
        out.append(big[off : off + size].reshape(tuple(a.shape)))
        off += size
    return out


def _branches_from_flat(flat: np.ndarray, leaf_bytes: int, k: int):
    W = ((leaf_bytes + 3) // 4 + 15) // 16 * 16  # block-padded leaf words
    flat = flat.astype("<u4")
    depth = (flat.shape[0] - W) // 8
    return [
        mt.MerkleProof(
            flat[:W, j].tobytes()[:leaf_bytes],
            [flat[W + 8 * d : W + 8 * (d + 1), j].tobytes() for d in range(depth)],
        )
        for j in range(k)
    ]


def assemble_fri(spec: FieldSpec, pending, flats) -> list:
    """Host-side formatting of the materialized FRI arrays."""
    proof: list = []
    i = 0
    for _ in range(pending["n_rounds"]):
        root2_w, col_flat, val_flat = flats[i], flats[i + 1], flats[i + 2]
        i += 3
        proof.append(
            FriMiddle(
                root2_w.astype("<u4").tobytes(),
                _branches_from_flat(col_flat, 32, QUERIES_PER_ROUND),
                _branches_from_flat(val_flat, 32, 4 * QUERIES_PER_ROUND),
            )
        )
    last_words = flats[i].astype("<u4")
    proof.append(FriLast([last_words[:, j].tobytes() for j in range(last_words.shape[1])]))
    return proof


def verify_low_degree_proof(spec: FieldSpec, merkle_root: bytes, root_of_unity: int,
                            proof, max_deg_plus_1: int, exclude_multiples_of: int,
                            device, digest: str = "blake2s") -> bool:
    """Host FRI verification (`fri.rs:226-404`); raises on failure. `digest`
    must be the prover's tree digest. The last round's Merkle root is
    recomputed with the device tree."""
    p = spec.p
    rou_deg = 1
    test_val = root_of_unity
    while test_val != 1:
        rou_deg *= 2
        test_val = test_val * test_val % p

    def quartic_roots(root, deg):
        return [1, pow(root, deg // 4, p), pow(root, deg // 2, p), pow(root, deg * 3 // 4, p)]

    roots4 = quartic_roots(root_of_unity, rou_deg)
    for prf in proof[:-1]:
        if not isinstance(prf, FriMiddle):
            raise ValueError("FRI proofs must be Middle except the last element")
        special_x = spec.from_bytes_le(merkle_root)
        ys = ts.get_pseudorandom_indices(
            prf.root2, rou_deg // 4, QUERIES_PER_ROUND, exclude_multiples_of
        )
        poly_positions = [j * (rou_deg // 4) + y for y in ys for j in range(4)]
        column_values = mt.verify_multi_branch(prf.root2, ys, prf.column_branches, digest)
        poly_values = mt.verify_multi_branch(merkle_root, poly_positions, prf.poly_branches,
                                             digest)
        for i, y in enumerate(ys):
            x1 = pow(root_of_unity, y, p)
            xs4 = [q * x1 % p for q in roots4]
            row = [spec.from_bytes_le(poly_values[i * 4 + j]) for j in range(4)]
            col = spec.from_bytes_le(column_values[i])
            poly = ph.lagrange_interp(spec, xs4, row)
            if ph.eval_quartic(spec, poly, special_x) != col:
                raise ValueError("FRI row/column mismatch")
        merkle_root = prf.root2
        root_of_unity = pow(root_of_unity, 4, p)
        max_deg_plus_1 //= 4
        rou_deg //= 4
        roots4 = quartic_roots(root_of_unity, rou_deg)

    if max_deg_plus_1 < MIN_DEG_DIRECT_CHECKING // 2:
        raise ValueError("the degree of direct checking is too low")
    last = proof[-1]
    if not isinstance(last, FriLast):
        raise ValueError("the last element of FRI proofs must be Last")
    data = last.last
    if len(data) <= max_deg_plus_1:
        raise ValueError("last data too short")
    decoded = [spec.from_bytes_le(v) for v in data]
    if mt.commit_root(list(data), device, digest) != merkle_root:
        raise ValueError("FRI last-round root mismatch")
    xs = [pow(root_of_unity, i, p) for i in range(len(data))]
    if exclude_multiples_of:
        pts = [i for i in range(len(data)) if i % exclude_multiples_of != 0]
    else:
        pts = list(range(len(data)))
    head, rest = pts[:max_deg_plus_1], pts[max_deg_plus_1:]
    poly = ph.lagrange_interp(spec, [xs[i] for i in head], [decoded[i] for i in head])
    for pos in rest:
        if ph.eval_poly_at(spec, poly, xs[pos]) != decoded[pos]:
            raise ValueError("FRI direct check failed")
    return True
