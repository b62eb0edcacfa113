"""The R1CS STARK verifier.

Counterpart of `stark_tpu/protocol/verify.py`: shape checks before any
cryptography, FRI, the Merkle branches, then the spot checks of the
constraint, boundary and linear-combination identities on the host. The
circuit-static public columns (K, F0, F1, F2, idx, perm) are
low-degree-extended on the device with the prover's stages and gathered at
the spot checks; `ev_cache`, a dict the caller keeps per circuit, holds
those 6 LDEs across verifies (`stark_tpu/protocol/verify.py:143-150,
210-222`), keyed by device. The l-tree's and FRI's branches are walked
under the proof's `digest`; the m-tree's are blake2s under either. FRI, the
branches and the LDEs run in the tracer's phases `v_fri`, `v_branches` and
`v_lde` (`utils/tracing.py`), the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.protocol import transcript as ts
from stark_tpu_torch.protocol.params import SPOT_CHECK_SECURITY_FACTOR, derive_params
from stark_tpu_torch.utils import poly_host as ph
from stark_tpu_torch import device as devmod
from stark_tpu_torch.fri import fri
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops.ntt import check_lde_engine
from stark_tpu_torch.protocol.proof import StarkProof
from stark_tpu_torch.protocol.prove import (
    _col_bytes_np,
    _pad_col,
    _stages_cached,
    augmented_positions,
    lo_hi_words,
    permuted_column,
)
from stark_tpu_torch.utils.tracing import phase


def _validate_proof_shape(proof: StarkProof, precision: int) -> None:
    """Every count and byte length the verifier relies on, checked up front
    so a malformed proof fails with a clean ValueError."""

    def _chk(cond, msg):
        if not cond:
            raise ValueError(f"malformed proof: {msg}")

    for name in ("m_root", "l_root", "a_root"):
        root = getattr(proof, name)
        _chk(isinstance(root, (bytes, bytearray)), f"{name} is not bytes")
        _chk(len(root) == 32, f"{name} must be 32 bytes, got {len(root)}")

    def _chk_branches(branches, n_expect, leaf_bytes, what):
        _chk(isinstance(branches, list), f"{what} is not a list")
        _chk(len(branches) == n_expect,
             f"{what} must have {n_expect} entries, got {len(branches)}")
        for b in branches:
            _chk(isinstance(b.leaf, (bytes, bytearray)), f"{what} leaf is not bytes")
            _chk(len(b.leaf) == leaf_bytes,
                 f"{what} leaf must be {leaf_bytes} bytes, got {len(b.leaf)}")
            _chk(isinstance(b.nodes, list), f"{what} nodes is not a list")
            _chk(len(b.nodes) <= 64, f"{what} branch deeper than any tree")
            for n in b.nodes:
                _chk(isinstance(n, (bytes, bytearray)) and len(n) == 32,
                     f"{what} sibling nodes must be 32 bytes")

    n_pos = SPOT_CHECK_SECURITY_FACTOR
    _chk_branches(proof.main_branches, 4 * n_pos, 256, "main_branches")
    _chk_branches(proof.linear_comb_branches, n_pos, 32, "linear_comb_branches")

    fri_rounds = fri.n_rounds(precision // 4)
    _chk(isinstance(proof.fri_proof, list), "fri_proof is not a list")
    _chk(len(proof.fri_proof) == fri_rounds + 1,
         f"fri_proof must have {fri_rounds + 1} rounds, got {len(proof.fri_proof)}")
    for i, f in enumerate(proof.fri_proof[:-1]):
        _chk(isinstance(f, fri.FriMiddle), f"fri_proof[{i}] must be Middle")
        _chk(isinstance(f.root2, (bytes, bytearray)) and len(f.root2) == 32,
             f"fri_proof[{i}].root2 must be 32 bytes")
        _chk_branches(f.column_branches, fri.QUERIES_PER_ROUND, 32,
                      f"fri_proof[{i}].column_branches")
        _chk_branches(f.poly_branches, 4 * fri.QUERIES_PER_ROUND, 32,
                      f"fri_proof[{i}].poly_branches")
    last = proof.fri_proof[-1]
    _chk(isinstance(last, fri.FriLast), "fri_proof must end with Last")
    _chk(isinstance(last.last, list), "Last.last is not a list")
    expect_n = max(precision >> (2 * fri_rounds), 1)
    _chk(len(last.last) == expect_n,
         f"Last.last must have {expect_n} values, got {len(last.last)}")
    for v in last.last:
        _chk(isinstance(v, (bytes, bytearray)) and len(v) == 32,
             "Last.last values must be 32 bytes")


def verify_r1cs_proof(spec: FieldSpec, proof: StarkProof, public_wires,
                      public_first_indices, permuted_indices, coefficients,
                      flag0, flag1, flag2, n_constraints: int, n_wires: int,
                      digest: str = "blake2s", device="cuda",
                      lde_engine: str = "butterfly", ev_cache: dict | None = None) -> bool:
    """Raises (ValueError / AssertionError) on a bad proof; True otherwise.
    `lde_engine` names the engine of the 6 public columns' LDEs (the same
    values on either). `ev_cache`: where it holds the 6 LDEs for this
    device, they are taken from it and neither the columns nor their LDEs
    are made; otherwise they are made and stored in it. The LDEs depend on
    the circuit alone: not on the proof, its digest or the engine."""
    check_lde_engine(lde_engine)
    mt.check_digest(digest)
    dev = devmod.resolve(device)
    p = spec.p
    original_steps = len(coefficients)
    if original_steps > 3 * n_constraints * n_wires:
        raise ValueError("trace longer than the circuit allows")
    params = derive_params(spec, original_steps)
    steps, precision, skips = params.steps, params.precision, params.skips

    _validate_proof_shape(proof, precision)

    with phase("v_fri", device=dev):
        if not fri.verify_low_degree_proof(
            spec, proof.l_root, params.g2, proof.fri_proof, precision // 4, skips, dev,
            digest,
        ):
            raise ValueError("FRI verification failed")

    positions = ts.get_pseudorandom_indices(
        proof.l_root, precision, SPOT_CHECK_SECURITY_FACTOR, skips
    )
    aug = augmented_positions(positions, params)
    with phase("v_branches", device=dev):
        main_leaves = mt.verify_multi_branch(proof.m_root, aug, proof.main_branches)
        l_leaves = mt.verify_multi_branch(proof.l_root, positions,
                                          proof.linear_comb_branches, digest)

    # device LDEs of the public columns, gathered at the spot checks
    with phase("v_lde", device=dev):
        evs = ev_cache.get(str(dev)) if ev_cache is not None else None
        if evs is None:
            stages = _stages_cached(spec, steps, precision, original_steps, digest, dev,
                                    lde_engine)
            plo, phi = lo_hi_words(
                permuted_column(permuted_indices, original_steps, steps), dev)
            to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
            smalls = stages["v_cols"](
                to_dev(_col_bytes_np(spec, _pad_col(coefficients, steps))),
                to_dev(np.asarray(_pad_col(flag1, steps), dtype=np.uint8)),
                to_dev(np.asarray(_pad_col(flag2, steps), dtype=np.uint8)),
                plo,
                phi,
            )
            evs = stages["lde_many"](smalls)
            if ev_cache is not None:
                ev_cache[str(dev)] = evs
        pos_t = torch.as_tensor(positions, dtype=torch.int64, device=dev)
        gathered = torch.stack([mm.from_mont(spec, e[:, pos_t]) for e in evs])
        gathered = gathered.cpu().numpy().view(np.uint32)  # (6, L, n_pos)
        k_at, f0_at, f1_at, f2_at, idx_at, perm_at = (
            mm.limbs_to_ints_np(gathered[i], spec) for i in range(6)
        )

    pub_xs = [pow(params.g2, skips * w, p) for (_, w) in public_first_indices]
    pub_ys = [public_wires[k] for (k, _) in public_first_indices]
    interpolant2 = ph.lagrange_interp(spec, pub_xs, pub_ys)
    x_of_last_step = pow(params.g2, (steps - 1) * skips, p)

    r = ts.get_random_ff_values(spec, proof.a_root, precision, 3, 0)
    k_coeffs = [1] + [
        ts.seed_to_field(spec, [proof.m_root, bytes([i])]) for i in range(1, 11)
    ]
    omega = pow(params.g2, steps, p)

    for i, pos in enumerate(positions):
        x = pow(params.g2, pos, p)
        br = [main_leaves[i * 4 + j] for j in range(4)]

        def chunk(leaf, c):
            return spec.from_bytes_le(leaf[c * 32 : (c + 1) * 32])

        p_of_x = chunk(br[0], 0)
        p_of_prev_x = chunk(br[1], 0)
        p_of_x_plus_w = chunk(br[2], 0)
        p_of_x_plus_2w = chunk(br[3], 0)
        a_of_x = chunk(br[0], 1)
        a_of_prev_x = chunk(br[1], 1)
        s_of_x = chunk(br[0], 2)
        d1_of_x = chunk(br[0], 3)
        d2_of_x = chunk(br[0], 4)
        d3_of_x = chunk(br[0], 5)
        b_of_x = chunk(br[0], 6)
        b3_of_x = chunk(br[0], 7)
        z_value = (pow(omega, pos % skips, p) - 1) % p

        lhs = f0_at[i] * ((p_of_x - f1_at[i] * p_of_prev_x - k_at[i] * s_of_x) % p) % p
        if lhs != z_value * d1_of_x % p:
            raise AssertionError(f"Q1 check failed at {pos}")
        lhs = f2_at[i] * ((p_of_x_plus_2w - p_of_x * p_of_x_plus_w) % p) % p
        if lhs != z_value * d2_of_x % p:
            raise AssertionError(f"Q2 check failed at {pos}")
        val_nmr = (r[0] + r[1] * idx_at[i] + r[2] * s_of_x) % p
        val_dnm = (r[0] + r[1] * perm_at[i] + r[2] * s_of_x) % p
        lhs = (a_of_x * val_dnm - a_of_prev_x * val_nmr) % p
        if lhs != z_value * d3_of_x % p:
            raise AssertionError(f"Q3 check failed at {pos}")

        zb2_of_x = 1
        for (_, w) in public_first_indices:
            zb2_of_x = zb2_of_x * (x - pow(params.g2, w * skips, p)) % p
        i2_of_x = ph.eval_poly_at(spec, interpolant2, x)
        if (s_of_x - i2_of_x) % p != zb2_of_x * b_of_x % p:
            raise AssertionError(f"B2 failed at {pos}")
        if (a_of_x - 1) % p != (x - x_of_last_step) % p * b3_of_x % p:
            raise AssertionError(f"B3 failed at {pos}")

        x_to_steps = pow(x, steps, p)
        expect = (
            k_coeffs[0] * d1_of_x
            + k_coeffs[1] * d2_of_x
            + k_coeffs[2] * d3_of_x
            + k_coeffs[3] * p_of_x
            + k_coeffs[4] * p_of_x * x_to_steps
            + k_coeffs[5] * b_of_x
            + k_coeffs[6] * b_of_x * x_to_steps
            + k_coeffs[7] * b3_of_x
            + k_coeffs[8] * b3_of_x * x_to_steps
            + k_coeffs[9] * a_of_x
            + k_coeffs[10] * s_of_x
        ) % p
        if spec.from_bytes_le(l_leaves[i]) != expect:
            raise AssertionError(f"L consistency failed at {pos}")
    return True
