"""The R1CS STARK prover on one device.

Counterpart of `stark_tpu/protocol/prove.py:147-431`: the whole proof is
enqueued as one chain of device work (every Fiat-Shamir challenge derived
on the device), then one materializing transfer moves it to the host and
`materialize_r1cs_proof` formats it. Stages: traces (device
arithmetization), a-tree and r, columns (9 LDEs, accumulator, quotients,
boundaries), commits (m-tree, k, linear combination, l-tree), branches, FRI;
each runs in the tracer's phase of the JAX package's name (`utils/
tracing.py`: traces, a_tree, columns, commits, branches, fri, then
materialize), on the prove's device.

`mesh=` (a `parallel/distributed.py DomainMesh`, `stark_tpu/protocol/
prove.py:190-198`) runs the same orchestration on each of d ranks: the
small-domain stages replicated, the precision domain sharded
(`core.build_proof_stages`), the branches gathered, FRI replicated after an
all-gather of the l column and the domain. Every rank returns the same
proof, byte-identical to the single-device one.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.protocol.params import SPOT_CHECK_SECURITY_FACTOR, derive_params
from stark_tpu_torch.r1cs.arithmetize import Arithmetization
from stark_tpu_torch.utils import poly_host as ph
from stark_tpu_torch import device as devmod
from stark_tpu_torch.fri import fri
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops.ntt import check_lde_engine
from stark_tpu_torch.parallel.distributed import DomainMesh
from stark_tpu_torch.protocol.proof import StarkProof
from stark_tpu_torch.utils.tracing import phase


def _pad_col(col, steps: int):
    """Zero-pad a column (list or numpy) to `steps` entries."""
    n = len(col)
    if isinstance(col, np.ndarray):
        if n == steps:
            return col
        out = np.zeros((steps,) + col.shape[1:], dtype=col.dtype)
        out[:n] = col
        return out
    return list(col) + [0] * (steps - n)


def _col_bytes_np(spec: FieldSpec, col) -> np.ndarray:
    """Column -> (N, 2L) canonical little-endian uint8 byte rows. Accepts
    (N, k) uint8 rows (the native arithmetizer's output), 1-D integer numpy
    arrays (< 2^64) or python int lists."""
    nb = spec.num_limbs * 2
    if isinstance(col, np.ndarray) and col.ndim == 2 and col.dtype == np.uint8:
        if col.shape[1] == nb:
            return col
        out = np.zeros((col.shape[0], nb), dtype=np.uint8)
        w = min(nb, col.shape[1])
        out[:, :w] = col[:, :w]
        return out
    if isinstance(col, np.ndarray) and col.ndim == 1:
        v = col.astype(np.uint64)
        out = np.zeros((v.shape[0], nb), dtype=np.uint8)
        for i in range(min(8, nb)):
            out[:, i] = ((v >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
        return out
    return _col_bytes_np(
        spec, mm.limbs_to_bytes_le_np(mm.ints_to_limbs_np(col, spec), spec)
    )


def augmented_positions(positions, params) -> list[int]:
    """The 4 companion indices per spot check (`prove.rs:351-359`)."""
    out = []
    k = params.original_steps // 3 * params.skips
    for j in positions:
        out.extend([
            j,
            (j + params.precision - params.skips) % params.precision,
            (j + k) % params.precision,
            (j + 2 * k) % params.precision,
        ])
    return out


def permuted_column(arith_perm, original_steps: int, steps: int) -> np.ndarray:
    """The copy-constraint permutation padded with the identity to `steps`."""
    return np.concatenate([
        np.asarray(arith_perm, dtype=np.uint64),
        np.arange(original_steps, steps, dtype=np.uint64),
    ])


def lo_hi_words(perm: np.ndarray, device):
    """u64 permutation -> (lo, hi) int32 word tensors (u32 bit patterns)."""
    lo = (perm & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (perm >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return torch.from_numpy(lo.copy()).to(device), torch.from_numpy(hi.copy()).to(device)


@functools.lru_cache(maxsize=4)
def _stages_cached(spec, steps, precision, original_steps, digest, device, lde_engine,
                   mesh=None):
    """One stage set per (spec, steps, precision, original_steps, digest,
    device, lde_engine) and, on a mesh of d > 1 ranks, per rank's mesh
    (hashed by identity: ranks that share a card or a process each have
    their own). Every single-device caller passes the first seven
    positionally, so one key."""
    from stark_tpu_torch.protocol.core import build_proof_stages

    return build_proof_stages(spec, steps, precision, original_steps, digest, device,
                              lde_engine=lde_engine, mesh=mesh)


def _check_scope(mesh, digest: str, steps: int):
    """The digest, and the mesh: a `DomainMesh` of a power-of-two size d
    with steps >= d^2, the four-step NTT's least (`stark_tpu/protocol/
    prove.py:190-194`). The sharded stage set refuses the CRT engine
    outside the JAX package's gate (`prove_sharded.check_mesh_crt`)."""
    mt.check_digest(digest)
    if mesh is None:
        return
    if not isinstance(mesh, DomainMesh):
        raise TypeError(f"mesh must be a DomainMesh or None, got {type(mesh).__name__}")
    if mesh.size & (mesh.size - 1):
        raise ValueError(f"the mesh's size must be a power of two, got {mesh.size}")
    if steps < mesh.size ** 2:
        raise ValueError(f"the four-step NTT needs steps >= d^2 ({steps} < {mesh.size ** 2})")


def mk_r1cs_proof(spec: FieldSpec, arith: Arithmetization, public_wires, n_constraints: int,
                  n_wires: int, mesh=None, digest: str = "blake2s",
                  device="cuda", fri_fold: str = "dft",
                  lde_engine: str = "butterfly") -> StarkProof:
    return materialize_r1cs_proof(
        spec,
        enqueue_r1cs_proof(spec, arith, public_wires, n_constraints, n_wires,
                           mesh=mesh, digest=digest, device=device,
                           fri_fold=fri_fold, lde_engine=lde_engine),
    )


def enqueue_r1cs_proof(spec: FieldSpec, arith: Arithmetization, public_wires,
                       n_constraints: int, n_wires: int, mesh=None,
                       digest: str = "blake2s", device="cuda",
                       fri_fold: str = "dft", lde_engine: str = "butterfly") -> dict:
    """Enqueue the proof as one chain of device work; `arith` must carry
    the device-arithmetization inputs (`witness_le`, `slot_wire_ids`).
    `witness_le` is the (n_wires, 32) uint8 rows as a numpy array, or as a
    tensor already on `device` (`runner.prove_many` uploads it ahead).
    `fri_fold` names FRI's fold route ("dft" or "lagrange"); the proof is
    the same on either. `lde_engine` names the engine of the 9 LDEs
    ("butterfly" or "crt"); the proof is the same on either, too. `digest`
    ("blake2s" or "poseidon") commits the l-tree and FRI's trees; the
    m-tree, the a-tree and the transcript are blake2s under either."""
    fri.check_fold_route(fri_fold)
    check_lde_engine(lde_engine)
    dev = devmod.resolve(device)
    p = spec.p
    original_steps = arith.original_steps
    if original_steps > 3 * n_constraints * n_wires:
        raise ValueError("trace longer than the circuit allows")
    if arith.witness_le is None or arith.slot_wire_ids is None:
        raise ValueError(
            "the port proves through device arithmetization: the "
            "arithmetization needs witness_le and slot_wire_ids"
        )
    params = derive_params(spec, original_steps)
    steps, precision, skips = params.steps, params.precision, params.skips
    _check_scope(mesh, digest, steps)
    if mesh is not None and mesh.device != dev:
        raise ValueError(f"the mesh's rank runs on {mesh.device}, not on {dev}")
    key = (spec, steps, precision, original_steps, digest, dev, lde_engine)
    if mesh is not None and mesh.size > 1:
        stages = _stages_cached(*key, mesh)
    else:
        mesh = None  # a one-rank mesh proves as one device
        stages = _stages_cached(*key)

    # --- traces: only K, the witness and the circuit-static vectors move ---
    with phase("traces", device=dev):
        permuted = permuted_column(arith.permuted_indices, original_steps, steps)
        plo_d, phi_d = lo_hi_words(permuted, dev)
        wids = np.zeros(steps, dtype=np.int64)
        wids[:original_steps] = arith.slot_wire_ids
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        witness = arith.witness_le
        if not torch.is_tensor(witness):
            witness = to_dev(_col_bytes_np(spec, witness))
        elif witness.device != dev or witness.dtype != torch.uint8:
            raise ValueError(
                f"a witness tensor must be uint8 on {dev}, got {witness.dtype} on "
                f"{witness.device}"
            )
        traces = stages["wit_traces"](
            to_dev(_col_bytes_np(spec, _pad_col(arith.coefficients, steps))),
            witness,
            to_dev(wids),
            to_dev(np.asarray(_pad_col(arith.flag1, steps), dtype=np.uint8)),
            to_dev(np.asarray(_pad_col(arith.flag2, steps), dtype=np.uint8)),
            plo_d,
            phi_d,
        )

    # --- a-tree root and r ---
    with phase("a_tree", device=dev):
        a_root_words = stages["a_root"](plo_d, phi_d, traces["s"])
        r_mont = stages["r"](a_root_words)

    # --- columns: 9 LDEs, accumulator, quotients, boundaries ---
    with phase("columns", device=dev):
        pub_xs = [pow(params.g2, skips * w, p) for (_, w) in arith.public_first_indices]
        pub_ys = [public_wires[k] for (k, _) in arith.public_first_indices]
        i2_mont = mm.mont_consts(spec, ph.lagrange_interp(spec, pub_xs, pub_ys), dev)
        # Zb2^-1 is circuit-static: computed once per (circuit, shape, device)
        # and, on a mesh, per (size, rank): the rank's chunk
        zb2_key = (steps, str(dev), None if mesh is None else mesh.key)
        zb2c = getattr(arith, "_torch_inv_zb2", None)
        if zb2c is None or zb2c[0] != zb2_key:
            zb2c = (zb2_key, stages["inv_zb2"](mm.mont_consts(spec, pub_xs, dev)))
            arith._torch_inv_zb2 = zb2c
        cols, q_bad = stages["columns"](traces, r_mont, i2_mont, zb2c[1])
        del traces

    # --- commits: m-tree -> k -> linear combination -> l-tree ---
    with phase("commits", device=dev):
        m_tree, l_tree, l_ev = stages["commit"](cols)
        del cols
        m_root_w = m_tree.root_words
        l_root_w = l_tree.root_words

    # --- branches at the device-derived spot checks ---
    with phase("branches", device=dev):
        l_flat, m_flat = stages["branches"](l_tree, m_tree)

    # --- FRI, replicated on a mesh; the l-tree is round 0's value tree ---
    with phase("fri", device=dev):
        l_ev, xs_full = stages["replicate"](l_ev)
        pending = fri.prove_low_degree_pending(
            spec, l_ev, xs_full, precision // 4, skips, first_tree=l_tree,
            fri_fold=fri_fold, digest=digest,
        )
        del l_ev, xs_full
    # every gather against the two trees is enqueued: their device tensors
    # go back to the allocator as soon as the stream has run those gathers
    m_tree.release_device()
    l_tree.release_device()
    return {
        "pending": pending,
        "device_arrays": [a_root_words, m_root_w, l_root_w, q_bad, l_flat, m_flat]
        + pending["device_arrays"],
        "l_tree": l_tree,
        "m_tree": m_tree,
        "mesh": mesh,
        "device": dev,
    }


def materialize_r1cs_proof(spec: FieldSpec, st: dict) -> StarkProof:
    """One device->host transfer, then host formatting. On a mesh every
    array read here is replicated (roots, flags, gathered branches, FRI's
    outputs), so no gather is needed: the ranks' copies are held equal."""
    with phase("materialize", device=st["device"]):
        mats = fri.materialize_u32(st["device_arrays"])
        if st["mesh"] is not None:
            digest = hashlib.sha256(b"".join(m.tobytes() for m in mats)).digest()
            mine = torch.frombuffer(bytearray(digest), dtype=torch.uint8).to(st["mesh"].device)
            if not bool((st["mesh"].all_gather_stack(mine) == mine).all()):
                raise AssertionError("the ranks' proof arrays differ: one is not replicated")
        a_root_np, m_root_np, l_root_np, bad, l_flat_np, m_flat_np = mats[:6]
        for i, what in enumerate(("D1", "D2", "D3")):
            if bad[i]:
                raise AssertionError(f"invalid {what}: quotient not divisible by Z")
        n_pos = SPOT_CHECK_SECURITY_FACTOR
        main_branches = st["m_tree"].proofs_from_flat(m_flat_np, 4 * n_pos)
        linear_comb_branches = st["l_tree"].proofs_from_flat(l_flat_np, n_pos)
        fri_proof = fri.assemble_fri(spec, st["pending"], mats[6:])
    return StarkProof(
        m_root=m_root_np.astype("<u4").tobytes(),
        l_root=l_root_np.astype("<u4").tobytes(),
        a_root=a_root_np.astype("<u4").tobytes(),
        main_branches=main_branches,
        linear_comb_branches=linear_comb_branches,
        fri_proof=fri_proof,
    )
