"""`runner.prove_many` on the CPU: for distinct witnesses of one circuit it
gives the proofs that single proves give, in order, at pipeline depths
below, at and above the number of proofs, on both fold routes; the shared
arithmetization's witness slot is left empty; and what it refuses (a depth
of 0, a `mesh=` that is not a `DomainMesh`, a witness whose first wire is
not 1). The same three witnesses go through the JAX package's
`runner.prove_many`, built by its own `squaring_chain`, and its proofs must
be the port's byte for byte. The circuit is `squaring_chain(5)` (steps 16,
the `compute` scale) with three start values. Tolerance: exact (byte-identical JSON).

The tracer's top-level phases of each entry point and route, names and
order, against those the JAX package's tracer records for its same entry
and route (`test_phase_names_match_the_jax_package`): here, where the JAX
prove above has compiled the circuit's stages in this process, a JAX prove
costs seconds, not the ~40 s of a cold one.
"""

import pytest
import torch

from stark_tpu.protocol import proof as jproof
from stark_tpu.protocol import runner as jrunner
from stark_tpu.r1cs.synth import squaring_chain as jsquaring_chain
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.synth import squaring_chain, write_circuit_files
from stark_tpu_torch.utils import tracing

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


def test_phase_names_match_the_jax_package(chain, tmp_path):
    """Each entry point records, in its tracer, the top-level phases that the
    JAX package's same entry records in `stark_tpu.utils.tracing._root`
    (which records without any switch): the prove and the verify from
    parsed circuits, `prove_many`, and the three file-path entry points on
    the route both packages take here (the native one, where the JAX
    package's file prove is `prove_with_witness_native`: its
    `parse+arithmetize`). Names and order, not times; both trees reset
    before each entry."""
    from stark_tpu.protocol import proof as jproof_mod
    from stark_tpu.utils import tracing as jtracing

    r1cs, witnesses, singles = chain
    jr1cs, jw = jsquaring_chain(5, x0=3)
    proof = jproof = None
    paths = [str(tmp_path / name) for name in ("c.r1cs", "c.wtns")]
    write_circuit_files(r1cs, witnesses[0], *paths)
    port_json, jax_json = str(tmp_path / "port.json"), str(tmp_path / "jax.json")

    def prove():
        nonlocal proof
        proof = runner.prove_with_witness(r1cs, witnesses[0], device="cpu")

    def jax_prove():
        nonlocal jproof
        jproof = jrunner.prove_with_witness(jr1cs, jw)

    entries = {
        "prove": (prove, jax_prove),
        "verify": (lambda: runner.verify_with_witness(r1cs, witnesses[0][:2], proof,
                                                      device="cpu"),
                   lambda: jrunner.verify_with_witness(jr1cs, jw[:2], jproof)),
        "prove_many": (lambda: runner.prove_many(r1cs, witnesses[:1], device="cpu"),
                       lambda: jrunner.prove_many(jr1cs, [jw])),
        "prove file": (lambda: runner.prove_with_file_path(*paths, port_json, device="cpu"),
                       lambda: jrunner.prove_with_file_path(*paths, jax_json)),
        "verify file": (lambda: runner.verify_with_file_path(*paths, port_json, device="cpu"),
                        lambda: jrunner.verify_with_file_path(*paths, jax_json)),
        "run file": (lambda: runner.run_with_file_path(*paths, port_json, device="cpu"),
                     lambda: jrunner.run_with_file_path(*paths, jax_json)),
    }
    for entry, (port, jax) in entries.items():
        tracing.reset()
        jtracing.reset()
        port()
        jax()
        assert tracing.top_names() == list(jtracing._root.children), entry
    assert tracing.top_names()[0] == "parse+arithmetize"
    assert proof_mod.to_json(proof) == jproof_mod.to_json(jproof) == singles[0]
    with open(port_json) as f, open(jax_json) as g:
        assert f.read() == g.read() == singles[0]
