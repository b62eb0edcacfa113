"""The prover's precision-domain work sharded over the 1-D mesh.

Counterpart of `stark_tpu/parallel/prove_sharded.py`. Each rank holds the
contiguous chunk [r N/d, (r+1) N/d) of every precision-domain column:

* LDE: the four-step NTT (`ntt4`), its inverse on the steps domain, an
  all-gather of the coefficients, the rank's slice of the zero-padded
  coefficients, the forward transform on the precision domain;
* the trace relations' shifts (P(x/g2), P(x + k skips)): global rolls made
  of rank shifts (`roll_sharded`);
* quotients, boundaries and the linear combination: elementwise on the
  chunks;
* Merkle trees: leaves hashed and folded on each rank to its subroot, an
  all-gather of the d subroots, the top log2(d) layers on every rank
  (`ShardedMerkleTree`).

PyTorch has no GSPMD, so the stages after `columns` say where their data
lives (`sharded_stages`): the trees are sharded, their roots, branches and
everything after them replicated. FRI runs replicated on every rank, after
an all-gather of the l column and of the domain (its fold reads rows N/4
apart, which cross chunks). Small-domain work (the traces, the a-tree, r,
the accumulator's mini column) runs replicated, as the JAX accumulator does
(`prove_sharded.py:222-231`).

The local M-point DFTs of the four-step transforms run on the stage set's
LDE engine: the butterfly kernels, or under `lde_engine="crt"` the CRT
matrix-product engine, as the JAX package's `_use_mesh_mxu` routes them
(`prove_sharded.py:143-197`: each rank's plans of the inverse on the steps
domain and the forward transform on the precision domain). JAX's gate
(local precision/d <= 2^20, the two-level CRT plan's largest; steps/d >= 4;
16 limbs) is a preference there, under which it runs butterflies; here the
engine is the caller's request, so outside the gate `make_domain` raises a
`ValueError` that names the limit. The proof is the same on either engine,
and so are the collectives' bytes. `mxu_ntt.lde_mxu_sharded` is the CRT
engine's own sharded LDE.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import ntt as nttm
from stark_tpu_torch.parallel import ntt4
from stark_tpu_torch.parallel.distributed import shard_cols
from stark_tpu_torch.protocol import device_transcript as dt
from stark_tpu_torch.protocol import kernels
from stark_tpu_torch.protocol.core import (
    COL_NAMES,
    TRACE_NAMES,
    leaves_to_words,
    resident_groups,
    spot_positions,
)


def roll_sharded(x_local: torch.Tensor, shift: int, mesh) -> torch.Tensor:
    """The rank's chunk of torch.roll(x, shift, 1) on a contiguously
    sharded (L, N) x (`prove_sharded.py:38-59`); any integer shift."""
    L, M = x_local.shape
    s = shift % (mesh.size * M)
    if s == 0:
        return x_local
    q, rem = divmod(s, M)
    if rem == 0:
        return mesh.shift(x_local, q)
    hi = mesh.shift(x_local[:, M - rem :], q + 1)  # becomes out[:, :rem]
    lo = mesh.shift(x_local[:, : M - rem], q)  # becomes out[:, rem:]
    return torch.cat([hi, lo], dim=1)


def lde_local(spec: FieldSpec, trace_local, mesh, steps_tabs, prec_tabs, n_inv_mont,
              ext: int) -> torch.Tensor:
    """The rank's chunk of the LDE of a (L, steps) trace whose chunk
    (L, steps/d) it holds (`prove_sharded.py:84-140`): the sharded iNTT,
    the all-gather of the coefficients, this rank's slice of the
    zero-padded coefficients, the sharded NTT on the precision domain."""
    L, ms = trace_local.shape
    steps = ms * mesh.size
    coeff_local = ntt4.ntt_sharded_local(spec, trace_local, mesh, steps_tabs, n_inv_mont)
    coeffs = mesh.all_gather(coeff_local)
    del coeff_local
    mp = steps * ext // mesh.size
    lo = mesh.rank * mp
    chunk = torch.zeros((L, mp), dtype=torch.int32, device=coeffs.device)
    if lo < steps:
        hi = min(steps, lo + mp)
        chunk[:, : hi - lo] = coeffs[:, lo:hi]
    del coeffs
    return ntt4.ntt_sharded_local(spec, chunk, mesh, prec_tabs)


def check_mesh_crt(spec: FieldSpec, steps: int, precision: int, d: int) -> None:
    """The CRT engine's local DFTs on a mesh of d ranks need JAX's gate
    (`_use_mesh_mxu`, `prove_sharded.py:143-160`); raise where it fails."""
    if precision // d > 1 << 20:
        raise ValueError(
            f"lde_engine='crt' on a mesh needs a local precision/d <= 2^20 (the "
            f"two-level CRT plan's largest): precision {precision}, d = {d}")
    if steps // d < 4:
        raise ValueError(
            f"lde_engine='crt' on a mesh needs steps/d >= 4: steps {steps}, d = {d}")
    if spec.num_limbs != 16:
        raise ValueError(f"lde_engine='crt' on a mesh needs a 16-limb field, not {spec.name}")


def make_domain(spec: FieldSpec, mesh, steps: int, precision: int, original_steps: int,
                block: int = nttm.FUSED_BLOCK, lde_engine: str = "butterfly") -> dict:
    """One rank's domain constants and chunks (`prove_sharded.py:162-197`):
    the two transforms' tables on `lde_engine` (under "crt", each local
    DFT's CRT plan: the inverse's at (g1^-1)^d, M = steps/d, the forward's
    at g2^d, M = precision/d; `check_mesh_crt` first), the rank's xs chunk
    and its Zb3^-1 (once a stage set), the Shoup patterns of Z^-1 and
    x^steps."""
    d, dev, p = mesh.size, mesh.device, spec.p
    if nttm.check_lde_engine(lde_engine) == "crt":
        check_mesh_crt(spec, steps, precision, d)
    skips = precision // steps
    mp = precision // d
    # a chunk starts at a multiple of skips, so the (L, skips) patterns of
    # Z^-1 and x^steps line up with it and its ::skips columns are the
    # domain's multiples of skips
    assert mp % skips == 0
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, skips, p)
    omega = pow(g2, steps, p)
    xs_local = mm.mmul(spec, mm.power_table(spec, g2, mp, dev),
                       mm.mont_const(spec, pow(g2, mesh.rank * mp, p), dev))
    x_last = mm.mont_const(spec, pow(g2, precision - skips, p), dev)
    return {
        "mesh": mesh,
        "skips": skips,
        "kshift": original_steps // 3 * skips,
        "steps_tabs_inv": ntt4.make_tables(spec, g1, steps, d, mesh.rank, True, dev, block,
                                           lde_engine),
        "prec_tabs": ntt4.make_tables(spec, g2, precision, d, mesh.rank, False, dev, block,
                                      lde_engine),
        "n_inv": mm.mont_const(spec, spec.inv(steps), dev),
        "xs_local": xs_local,
        "inv_zb3": mm.multi_inv(spec, mm.msub(spec, xs_local, x_last)),
        "iz_pats": mm.shoup_consts(spec, [0] + [
            pow((pow(omega, t, p) - 1) % p, p - 2, p) for t in range(1, skips)], dev),
        "x2_pats": mm.shoup_consts(spec, [pow(omega, t, p) for t in range(skips)], dev),
    }


def inv_zb2_local(spec: FieldSpec, dom: dict, pubx_mont) -> torch.Tensor:
    """Zb2^-1 on the rank's chunk. The JAX body inverts elementwise by
    Fermat (`prove_sharded.py:262-266`: "batched inversion needs global
    products"); a batch inversion needs only the values it inverts, so
    `multi_inv` over the chunk gives each element's inverse exactly."""
    return mm.multi_inv(spec, kernels.vanishing_eval(spec, dom["xs_local"], pubx_mont))


def columns_body(spec: FieldSpec, dom: dict, traces: dict, r_mont, i2_mont,
                 inv_zb2) -> tuple[dict, torch.Tensor]:
    """The rank's chunks of the 8 m-tree columns and the divisibility flags,
    OR-reduced over the ranks (`prove_sharded.py:200-275`). `traces` are
    the replicated small-domain traces; `inv_zb2` is the rank's chunk of
    Zb2^-1 (`inv_zb2_local`). The quotients take the JAX mesh form: rolls,
    then products on the `mmul` kernel."""
    mesh, skips = dom["mesh"], dom["skips"]

    def lde(t):
        return lde_local(spec, shard_cols(t, mesh), mesh, dom["steps_tabs_inv"],
                         dom["prec_tabs"], dom["n_inv"], skips)

    # the accumulator needs a prefix product over the whole small domain:
    # replicated there, then sliced
    vn, vd = kernels.rand_combination(spec, r_mont, traces["idx"], traces["perm"],
                                      traces["s"])
    a_mini = kernels.accumulator_mini(spec, vn, vd)
    del vn, vd
    evs = {name: lde(traces[name]) for name in TRACE_NAMES}
    a_ev = lde(a_mini)

    def mul(a, b):
        return mm.mmul(spec, a, b)

    def quotient(q):
        bad.append((q[:, ::skips] != 0).any())
        return kernels.mmul_periodic_const(spec, q, None, dom["iz_pats"])

    bad = []
    p_ev, s_ev = evs["p"], evs["s"]
    p_prev = roll_sharded(p_ev, skips, mesh)
    d1 = quotient(mul(evs.pop("f0"), mm.msub(spec, p_ev, mm.madd(
        spec, mul(evs.pop("f1"), p_prev), mul(evs.pop("k"), s_ev)))))
    del p_prev
    p_w = roll_sharded(p_ev, -dom["kshift"], mesh)
    p_2w = roll_sharded(p_ev, -2 * dom["kshift"], mesh)
    d2 = quotient(mul(evs.pop("f2"), mm.msub(spec, p_2w, mul(p_ev, p_w))))
    del p_w, p_2w
    vn_big, vd_big = kernels.rand_combination(spec, r_mont, evs.pop("idx"),
                                              evs.pop("perm"), s_ev)
    a_prev = roll_sharded(a_ev, skips, mesh)
    d3 = quotient(mm.msub(spec, mul(a_ev, vd_big), mul(a_prev, vn_big)))
    del vn_big, vd_big, a_prev
    q_bad = mesh.any(torch.stack(bad).to(torch.int32))
    i2_ev = kernels.horner_eval(spec, i2_mont, dom["xs_local"])
    b2_ev = kernels.sub_mul_ev(spec, s_ev, i2_ev, inv_zb2)
    del i2_ev
    b3_ev = kernels.sub_mul_ev(spec, a_ev, mm.mont_one(spec, a_ev.device), dom["inv_zb3"])
    cols = {"p": p_ev, "a": a_ev, "s": s_ev,
            "d1": d1, "d2": d2, "d3": d3, "b2": b2_ev, "b3": b3_ev}
    return cols, q_bad


class ShardedMerkleTree(mt.DeviceMerkleTree):
    """A Merkle tree whose leaves are spread over the mesh's ranks in
    contiguous chunks (`prove_sharded.py:62-81`): each rank hashes its
    leaves and folds them to its subroot (blake2s, or Poseidon under
    digest="poseidon" for 32-byte leaves), the d subroots are all-gathered
    and the top log2(d) layers made on every rank. `layers` are those top
    layers, from the (8, d) subroots to the root; `local_layers` the rank's
    own, from its leaves' digests to its subroot. The interface is
    `DeviceMerkleTree`'s: the root, `gather`, `proofs_from_flat`,
    `release_device`."""

    def __init__(self, leaf_words: torch.Tensor, leaf_bytes: int, mesh,
                 digest: str = "blake2s"):
        self.mesh = mesh
        self.local_layers = mt.build_layers_digest(leaf_words, leaf_bytes, digest)
        subroots = mesh.all_gather(self.local_layers[-1])
        super().__init__(leaf_words, leaf_bytes, [subroots] + mt.node_layers(subroots, digest))

    def release_device(self) -> None:
        super().release_device()
        self.local_layers = None

    def gather(self, indices: torch.Tensor) -> torch.Tensor:
        """`gather_flat` of the whole tree at global `indices`, on every
        rank: each rank fills the leaves and the siblings below its subroot
        of every index, one all-gather of those fixed-size buffers, and each
        index takes its owner's; the top layers give the siblings above."""
        idx = indices.to(torch.int64)
        m = self.leaf_words.shape[1]
        log_m = m.bit_length() - 1
        mine = mt.gather_flat(self.leaf_words, self.local_layers[:-1], idx % m)
        every = self.mesh.all_gather_stack(mine)  # (d, W + 8 log m, k)
        cols = torch.arange(idx.shape[0], device=idx.device)
        below = every[idx // m, :, cols].t()
        above = [layer[:, (idx >> (log_m + j)) ^ 1] for j, layer in enumerate(self.layers[:-1])]
        return torch.cat([below, *above], dim=0)


def commit(spec: FieldSpec, dom: dict, cols: dict, digest: str, k_mont=None):
    """m-commit -> k -> linear combination -> l-commit on the chunks: the
    two sharded trees, k (derived from the replicated m-root unless given)
    and the rank's chunk of the l column (`linear_combination_shoup`, the
    x^steps pattern aligned with the chunk)."""
    mesh = dom["mesh"]
    m_tree = ShardedMerkleTree(leaves_to_words(spec, [cols[n] for n in COL_NAMES]), 256, mesh)
    if k_mont is None:
        k_mont = dt.k_coeffs_mont(spec, m_tree.root_words)
    l_ev = kernels.linear_combination(spec, k_mont, None, *[cols[n] for n in COL_NAMES],
                                      x2s_pats=dom["x2_pats"])
    l_tree = ShardedMerkleTree(leaves_to_words(spec, [l_ev]), 32, mesh, digest)
    return m_tree, l_tree, l_ev


def sharded_prover_core(spec: FieldSpec, dom: dict, traces: dict, r_mont, k_mont,
                        i2_mont, inv_zb2, digest: str = "blake2s"):
    """The device core of the prover on the mesh for given transcript
    scalars (`build_sharded_prover_step`, `prove_sharded.py:312-363`):
    -> (m-root words, l-root words, the rank's chunk of the l column)."""
    cols, _ = columns_body(spec, dom, traces, r_mont, i2_mont, inv_zb2)
    m_tree, l_tree, l_ev = commit(spec, dom, cols, digest, k_mont)
    return m_tree.root_words, l_tree.root_words, l_ev


def sharded_stages(spec: FieldSpec, mesh, steps: int, precision: int, original_steps: int,
                   digest: str, block: int = nttm.FUSED_BLOCK,
                   lde_engine: str = "butterfly") -> dict:
    """The precision-domain stages of `core.build_proof_stages` on a mesh
    of d > 1 ranks, under the names the prover calls (`protocol/prove.py`):
    `xs_full` and Zb2^-1 are the rank's chunks, the trees sharded, the
    branches and FRI's inputs replicated; the LDEs' local DFTs on
    `lde_engine`."""
    dom = make_domain(spec, mesh, steps, precision, original_steps, block, lde_engine)

    def branches(l_tree, m_tree):
        pos, aug = spot_positions(l_tree.root_words, precision, dom["skips"], dom["kshift"])
        return l_tree.gather(pos), m_tree.gather(aug)

    return {
        "xs_full": dom["xs_local"],
        "inv_zb2": lambda pubx_mont: inv_zb2_local(spec, dom, pubx_mont),
        "columns": lambda traces, r_mont, i2_mont, inv_zb2: columns_body(
            spec, dom, traces, r_mont, i2_mont, inv_zb2),
        "commit": lambda cols: commit(spec, dom, cols, digest),
        "branches": branches,
        "replicate": lambda l_ev: (mesh.all_gather(l_ev), mesh.all_gather(dom["xs_local"])),
        "resident_bytes": resident_groups(dom["xs_local"], dom["inv_zb3"], dom["iz_pats"],
                                          dom["x2_pats"],
                                          (dom["steps_tabs_inv"], dom["prec_tabs"], dom["n_inv"])),
    }
