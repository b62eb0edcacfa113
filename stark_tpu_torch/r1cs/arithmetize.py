"""R1CS -> STARK trace arithmetization (host, python ints).

Faithful re-derivation of the reference's trace construction
(`packages/r1cs-stark/src/run.rs`):

* `calc_coefficients_and_witness` (run.rs:109-281): per constraint, A/B/C
  coefficient lists are padded to a common length n_coeff = max(|A|,|B|,|C|)
  (pad slots use wire n_wires-1 with coefficient 0), producing three parallel
  streams concatenated as [A-segment || B-segment || C-segment]:
    S = witness values per slot,
    P = running dot product within each constraint (t += c*w),
    K = coefficients;
  plus `wire_using_list` (every (region, slot) using each wire) and
  `last_coeff_list` (last slot index of each constraint, per region).
* `calc_flags` (run.rs:283-308): F0 = 1 everywhere; F1 = 0 at each
  constraint's first slot (accumulator reset), mirrored into all 3 regions;
  F2 = 1 at each constraint's last slot.
* permutation / public indices (run.rs:390-419): each slot points to the
  previous slot using the same wire (cyclically) -- the copy-constraint
  permutation; `public_first_indices` records the first slot of each public
  wire.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.r1cs.reader import Constraint


@dataclass
class Arithmetization:
    witness_trace: list[int]  # S
    computational_trace: list[int]  # P
    coefficients: list[int]  # K
    flag0: list[int]
    flag1: list[int]
    flag2: list[int]
    permuted_indices: list[int]
    public_first_indices: list[tuple[int, int]]
    last_coeff_list: list[int]
    # Device-arithmetization extension (no reference counterpart): when set,
    # the prover derives S on device as witness[slot_wire_ids] and P as a
    # gated segmented scan, so only the witness crosses host->device per
    # proof instead of two full trace columns (S, P may then be None).
    slot_wire_ids: np.ndarray | None = field(default=None, repr=False)
    witness_le: np.ndarray | None = field(default=None, repr=False)  # (n_wires, 32) u8

    @property
    def original_steps(self) -> int:
        return len(self.coefficients)


def slot_wire_ids_np(
    ncoeffs: np.ndarray, wire_ids: np.ndarray, n_wires: int
) -> np.ndarray:
    """Per-trace-slot wire id, [A-segment || B-segment || C-segment] layout
    (the wire each slot of S reads, run.rs:150-158; pad slots use wire
    n_wires-1 like the reference's run.rs:166-171).

    ncoeffs: (n_constraints, 3) coefficient counts; wire_ids: flat in
    (constraint, region, coeff) order -- the native parser's layout."""
    ncoeffs = np.asarray(ncoeffs, dtype=np.int64).reshape(-1, 3)
    wire_ids = np.asarray(wire_ids, dtype=np.uint32)
    n_con = ncoeffs.shape[0]
    n_coeff = ncoeffs.max(axis=1)  # per-constraint padded width (run.rs:140)
    a_len = int(n_coeff.sum())
    prefix = np.zeros(3 * n_con + 1, dtype=np.int64)
    np.cumsum(ncoeffs.reshape(-1), out=prefix[1:])
    prefix = prefix[:-1].reshape(n_con, 3)
    ci = np.repeat(np.arange(n_con), n_coeff)  # constraint id per slot
    starts = np.zeros(n_con, dtype=np.int64)
    np.cumsum(n_coeff[:-1], out=starts[1:])
    i_within = np.arange(a_len, dtype=np.int64) - np.repeat(starts, n_coeff)
    out = np.empty(3 * a_len, dtype=np.uint32)
    for r in range(3):
        n_r = ncoeffs[ci, r]
        valid = i_within < n_r
        gidx = prefix[ci, r] + np.minimum(i_within, np.maximum(n_r - 1, 0))
        # np.where evaluates the gather for MASKED lanes too: a region
        # with ZERO coefficients (legal R1CS -- pedersen_test has empty
        # factors) clamps to prefix+0, which for the final such region
        # points one past the end of wire_ids. Clamp; masked lanes take
        # the n_wires-1 pad wire regardless (run.rs:166-171).
        gidx = np.minimum(gidx, max(len(wire_ids) - 1, 0))
        out[r * a_len : (r + 1) * a_len] = np.where(
            valid, wire_ids[gidx] if len(wire_ids) else 0, n_wires - 1
        )
    return out


def calc_coefficients_and_witness(
    spec: FieldSpec,
    constraints: list[Constraint],
    witness: list[int] | None,
    n_wires: int,
):
    """Returns (S, P, K, wire_using_list, last_coeff_list).

    With witness=None, S and P are empty (the verifier-side
    `calc_coefficients`, run.rs:21-107)."""
    with_witness = witness is not None
    wit_lists = [[], [], []]
    traces = [[], [], []]
    coeff_lists = [[], [], []]
    wire_using: list[list[tuple[int, int]]] = [[] for _ in range(n_wires)]
    acc_n_coeff = 0
    last_coeff_list = []

    for constraint in constraints:
        n_coeff = max(f.n_coefficient for f in constraint.factors)
        for region in range(3):
            f = constraint.factors[region]
            t = 0
            for i in range(n_coeff):
                if i < f.n_coefficient:
                    coeff = f.coefficients[i]
                    wire_id = coeff.wire_id
                    c = spec.from_bytes_le(coeff.value)
                else:
                    wire_id = n_wires - 1
                    c = 0
                wire_using[wire_id].append((region, len(coeff_lists[region])))
                coeff_lists[region].append(c)
                if with_witness:
                    w = witness[wire_id]
                    if i < f.n_coefficient:
                        t = (t + c * w) % spec.p
                    wit_lists[region].append(w)
                    traces[region].append(t)
        acc_n_coeff += n_coeff
        last_coeff_list.append(acc_n_coeff - 1)

    witness_trace = wit_lists[0] + wit_lists[1] + wit_lists[2]
    computational_trace = traces[0] + traces[1] + traces[2]
    coefficients = coeff_lists[0] + coeff_lists[1] + coeff_lists[2]
    return witness_trace, computational_trace, coefficients, wire_using, last_coeff_list


def calc_flags(last_coeff_list: list[int], coefficients_len: int):
    # run.rs:283-308
    assert coefficients_len % 3 == 0
    a_len = coefficients_len // 3
    flag0 = [1] * coefficients_len
    flag1 = [1] * coefficients_len
    for last in last_coeff_list:
        k = (last + 1) % a_len
        flag1[k] = 0
        flag1[k + a_len] = 0
        flag1[k + 2 * a_len] = 0
    flag2 = [0] * coefficients_len
    for last in last_coeff_list:
        flag2[last] = 1
        # note: F2 is set only in the A-region slot (run.rs:302-307); the Q2
        # product check reads P at +k and +2k offsets from there
    return flag0, flag1, flag2


def calc_permuted_indices(wire_using: list[list[tuple[int, int]]], trace_len: int, a_len: int):
    # run.rs:390-401
    permuted = [0] * trace_len
    for uses in wire_using:
        if not uses:
            continue
        last_region, last_slot = uses[-1]
        old_w = a_len * last_region + last_slot
        for region, slot in uses:
            w = a_len * region + slot
            permuted[w] = old_w
            old_w = w
    return permuted


def calc_public_first_indices(
    wire_using: list[list[tuple[int, int]]], n_public_wires: int, a_len: int
):
    # run.rs:411-419
    out = []
    for w in range(n_public_wires):
        if wire_using[w]:
            region, slot = wire_using[w][0]
            out.append((w, a_len * region + slot))
    return out


def arithmetize(
    spec: FieldSpec,
    constraints: list[Constraint],
    witness: list[int] | None,
    n_wires: int,
    n_public_wires: int,
) -> Arithmetization:
    s, p_trace, k, wire_using, last_coeff = calc_coefficients_and_witness(
        spec, constraints, witness, n_wires
    )
    f0, f1, f2 = calc_flags(last_coeff, len(k))
    a_len = len(k) // 3
    permuted = calc_permuted_indices(wire_using, len(k), a_len)
    public_first = calc_public_first_indices(wire_using, n_public_wires, a_len)
    return Arithmetization(
        witness_trace=s,
        computational_trace=p_trace,
        coefficients=k,
        flag0=f0,
        flag1=f1,
        flag2=f2,
        permuted_indices=permuted,
        public_first_indices=public_first,
        last_coeff_list=last_coeff,
    )
