"""`runner.prove_many` on the CPU: for distinct witnesses of one circuit it
gives the proofs that single proves give, in order, at pipeline depths
below, at and above the number of proofs, on both fold routes; the shared
arithmetization's witness slot is left empty; and what it refuses (a depth
of 0, a `mesh=` that is not a `DomainMesh`, a witness whose first wire is
not 1). The same three witnesses go through the JAX package's
`runner.prove_many`, built by its own `squaring_chain`, and its proofs must
be the port's byte for byte. The circuit is `squaring_chain(5)` (steps 16,
the `compute` scale) with three start values. Tolerance: exact (byte-identical JSON).
"""

import pytest
import torch

from stark_tpu.protocol import proof as jproof
from stark_tpu.protocol import runner as jrunner
from stark_tpu.r1cs.synth import squaring_chain as jsquaring_chain
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.synth import squaring_chain

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def chain():
    """One circuit, three witnesses, and the proof a single prove gives each."""
    r1cs, _ = squaring_chain(5)
    witnesses = [squaring_chain(5, x0=x0)[1] for x0 in (3, 5, 7)]
    singles = [proof_mod.to_json(runner.prove_with_witness(r1cs, w, device="cpu"))
               for w in witnesses]
    assert len(set(singles)) == 3
    return r1cs, witnesses, singles


@pytest.mark.parametrize("pipeline,fri_fold", [(2, "lagrange"), (1, "dft"), (5, "dft")])
def test_prove_many_matches_single(chain, pipeline, fri_fold):
    r1cs, witnesses, singles = chain
    many = runner.prove_many(r1cs, witnesses, pipeline=pipeline, device="cpu",
                             fri_fold=fri_fold)
    assert [proof_mod.to_json(p) for p in many] == singles
    assert runner.verify_with_witness(r1cs, witnesses[1][:2], many[1], device="cpu")
    assert runner._static_arith(runner._spec_for(r1cs), r1cs).witness_le is None


def test_prove_many_matches_the_jax_package(chain):
    """`stark_tpu`'s `prove_many` on its own build of the same circuit and
    witnesses gives the proofs that the port's single proves give (to which
    the test above holds the port's `prove_many` on both fold routes)."""
    r1cs, witnesses, singles = chain
    jr1cs, _ = jsquaring_chain(5)
    jwitnesses = [jsquaring_chain(5, x0=x0)[1] for x0 in (3, 5, 7)]
    assert jwitnesses == witnesses
    jmany = jrunner.prove_many(jr1cs, jwitnesses, pipeline=2)
    assert [jproof.to_json(p) for p in jmany] == singles


def test_prove_many_edges(chain):
    r1cs, witnesses, _ = chain
    assert runner.prove_many(r1cs, [], device="cpu") == []
    with pytest.raises(ValueError, match="pipeline"):
        runner.prove_many(r1cs, witnesses, pipeline=0, device="cpu")
    with pytest.raises(TypeError, match="DomainMesh"):
        runner.prove_many(r1cs, witnesses, mesh=object(), device="cpu")
    bad = [b"\x02" + bytes(31)] + witnesses[0][1:]
    with pytest.raises(ValueError, match=r"witness\[0\]"):
        runner.prove_many(r1cs, [witnesses[0], bad], device="cpu")
