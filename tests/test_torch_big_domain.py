"""Big domains (precision above 2^22) in the port, on the CPU.

The port proves up to precision 2^23 (`core.MAX_PRECISION`) with the one
layout of its device memory, and refuses larger precisions at the entry:
the prover draws r and its spot checks modulo the precision with the
protocol's index sampler, which takes moduli below 2^24 in the reference
and in both packages, so no proof exists there. What keeps 2^23 within the
card is that each stage drops a column after its last read: `rest_a`
consumes its LDE outputs, and the prover releases both trees once their
gathers are enqueued. Inputs are made from a numpy seed; tolerance: exact
equality of every word, and the `compute` proof byte-identical to
`compute_proof_golden.json`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.protocol import device_transcript as jdt
from stark_tpu.protocol import transcript as jts
from stark_tpu.protocol.core import build_proof_stages as jax_stages
from stark_tpu.protocol.params import derive_params as jax_params
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, tree_from_numpy
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.protocol import core
from stark_tpu_torch.protocol import device_transcript as dt
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import prove as tprove
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.protocol import transcript as tts
from stark_tpu_torch.protocol.params import derive_params
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness
from stark_tpu_torch.r1cs.synth import squaring_chain

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SEED = 20261017


@pytest.fixture(scope="module")
def compute():
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        witness = read_witness(f.read())
    return r1cs, witness


def _random_planes(rng, n: int, names) -> dict:
    """Canonical (16, n) planes, p - 1 and 0 at the ends."""
    out = {}
    for name in names:
        limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
        limbs[15] = rng.integers(0, tspec.p_limbs[15], size=n)
        limbs[:, 0] = [(spec.p - 1 >> 16 * i) & 0xFFFF for i in range(16)]
        limbs[:, -1] = 0
        out[name] = limbs.astype(np.uint32)
    return out


@pytest.mark.parametrize("log_precision", [24, 26, 28])
def test_stages_refuse_precision_above_2_23(log_precision):
    precision = 1 << log_precision
    with pytest.raises(ValueError, match="get_pseudorandom_indices"):
        core.build_proof_stages(tspec, precision // 8, precision, 3 * (precision // 24),
                                "blake2s", "cpu")


def test_largest_squaring_chain_is_at_max_precision():
    """Three trace rows a constraint: 349,525 constraints are the largest
    circuit at precision 2^23, in both packages; one more needs 2^24."""
    arith = runner._static_arith(tspec, squaring_chain(5)[0])
    assert arith.original_steps == 3 * 5
    for params in (derive_params, jax_params):
        assert params(spec, 3 * 349525).precision == core.MAX_PRECISION == 1 << 23
        assert params(spec, 3 * 349526).precision == 1 << 24


def test_entry_points_refuse_above_max_precision(monkeypatch, compute):
    """The refusal reaches the user's entry points before any proof is made
    (the `compute` circuit at precision 2^7, the bound lowered below it)."""
    r1cs, witness = compute
    monkeypatch.setattr(core, "MAX_PRECISION", 1 << 6)
    tprove._stages_cached.cache_clear()
    try:
        with pytest.raises(ValueError, match="get_pseudorandom_indices"):
            runner.prove_with_witness(r1cs, witness, device="cpu")
    finally:
        tprove._stages_cached.cache_clear()


def test_sampler_bounds_the_precision_at_2_23():
    seed = np.arange(1, 9, dtype=np.uint32) * np.uint32(0x9E3779B1)
    below = core.MAX_PRECISION
    got = dt.pseudorandom_indices(torch.from_numpy(seed.view(np.int32)), below, 80, 8)
    want = jts.get_pseudorandom_indices(seed.astype("<u4").tobytes(), below, 80, 8)
    assert got.tolist() == want
    assert tts.get_pseudorandom_indices(seed.astype("<u4").tobytes(), below, 80, 8) == want
    assert np.asarray(jdt.pseudorandom_indices(jnp.asarray(seed), below, 80, 8)).tolist() == want
    with pytest.raises(ValueError, match="2\\^24"):
        dt.pseudorandom_indices(torch.from_numpy(seed.view(np.int32)), 2 * below, 80, 8)
    with pytest.raises(AssertionError):
        tts.get_pseudorandom_indices(seed.astype("<u4").tobytes(), 2 * below, 80, 8)
    with pytest.raises(AssertionError):
        jdt.pseudorandom_indices(jnp.asarray(seed), 2 * below, 80, 8)


def test_rest_a_matches_jax_and_consumes_single_use_outputs(compute):
    """`rest_a` on random LDE outputs equals the JAX package's, and leaves
    only s and p, which are m-tree columns, in the dict it was given."""
    arith = runner._static_arith(tspec, compute[0])
    params = derive_params(tspec, arith.original_steps)
    shape = (params.steps, params.precision, arith.original_steps)
    rng = np.random.default_rng(SEED)
    evs = _random_planes(rng, params.precision, core.TRACE_NAMES + ("a",))
    small = _random_planes(rng, 3, ("r", "i2", "pubx"))
    J = jax_stages(spec, *shape, None, "blake2s")
    jzb2 = np.asarray(J["inv_zb2"](jnp.asarray(small["pubx"]), J["xs_full"]))
    jevs = {k: jnp.asarray(v) for k, v in evs.items()}
    ja = jevs.pop("a")
    jcols, jbad = J["rest_a"](jevs, ja, *(jnp.asarray(small[k]) for k in ("r", "i2")),
                              jnp.asarray(jzb2))

    T = core.build_proof_stages(tspec, *shape, "blake2s", "cpu", block=16)
    tevs = tree_from_numpy(evs, "cpu")
    a_ev = tevs.pop("a")
    zb2 = T["inv_zb2"](planes_from_numpy(small["pubx"], "cpu"))
    assert np.array_equal(zb2.numpy().astype(np.uint32), jzb2.astype(np.uint32))
    cols, bad = T["rest_a"](tevs, a_ev, planes_from_numpy(small["r"], "cpu"),
                            planes_from_numpy(small["i2"], "cpu"), zb2)
    assert set(tevs) == {"s", "p"}
    assert cols["s"] is tevs["s"] and cols["p"] is tevs["p"] and cols["a"] is a_ev
    assert set(cols) == set(core.COL_NAMES) == set(jcols)
    for name in core.COL_NAMES:
        want = np.asarray(jcols[name]).astype(np.uint32)
        assert np.array_equal(cols[name].numpy().astype(np.uint32), want), name
    assert bad.tolist() == np.asarray(jbad).tolist()


def test_released_tree_formats_same_branches():
    rng = np.random.default_rng(SEED + 1)
    n = 64
    words = torch.from_numpy(rng.integers(0, 1 << 32, size=(64, n), dtype=np.int64)
                             .astype(np.uint32).view(np.int32))
    layers = mt.build_layers(words, 256)
    idx = torch.from_numpy(rng.integers(0, n, size=12))
    tree = mt.DeviceMerkleTree(words, 256, layers)
    flat = tree.gather(idx).numpy().view(np.uint32)
    want = tree.proofs_from_flat(flat, 12)
    root = layers[-1][:, 0].numpy().astype("<i4").tobytes()
    for i, proof in zip(idx.tolist(), want):
        mt.validate_proof(proof, root, i)
    tree.release_device()
    assert tree.leaf_words is None and tree.layers is None
    assert tree.proofs_from_flat(flat, 12) == want


def test_prover_releases_both_trees_and_matches_golden(compute):
    """The enqueued proof holds no tree's device tensors, and what it
    materializes is the golden proof, which verifies."""
    r1cs, witness = compute
    h = r1cs.header
    arith = runner._static_arith(tspec, r1cs)
    arith.witness_le = runner._witness_rows(r1cs, witness)
    st = tprove.enqueue_r1cs_proof(tspec, arith, runner._public_wires(tspec, r1cs, witness),
                                   h.n_constraints, h.n_wires, device="cpu")
    for name in ("m_tree", "l_tree"):
        assert st[name].leaf_words is None and st[name].layers is None, name
    proof = tprove.materialize_r1cs_proof(tspec, st)
    with open(os.path.join(FIX, "compute_proof_golden.json")) as f:
        assert proof_mod.to_json(proof) == f.read()
    n_pub = 1 + h.n_public_inputs + h.n_public_outputs
    assert runner.verify_with_witness(r1cs, witness[:n_pub], proof, device="cpu")
