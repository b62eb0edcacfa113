"""FRI's Lagrange fold route in the port against the JAX package on the CPU.

* `fri.fold` on both routes against each other and against the JAX
  package's `_fold_j` on its Lagrange route;
* the whole FRI recursion on both routes: equal proofs, equal to the JAX
  package's, accepted by the verifier;
* an unknown route raises.

(The two fold kernels' plain versions and `ops/quartic.py`:
`test_torch_quartic.py`; against the JAX package's Pallas kernels:
`test_torch_fri_pre.py`, `test_torch_fri_post.py`.) Inputs come from a numpy
seed. Tolerance: exact equality (integer field arithmetic with canonical
outputs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.fri import fri as jfri
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import ntt as jntt
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.fri import fri
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol.core import leaves_to_words
from torch_fused_inputs import cols as _cols, eq as _eq, t as _t

torch.set_num_threads(2)


# --- the fold and the recursion --------------------------------------------------


def _poly_evals(n: int, deg: int, seed: int):
    """Evaluations on the order-n domain of a random polynomial of degree
    below `deg`, and the domain's generator."""
    rng = np.random.default_rng(seed)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(deg)]
    w = spec.root_of_unity(n)
    cm = jmm.to_mont(spec, jmm.ints_to_limbs_np(coeffs, spec))
    evals = jntt.ntt(spec, jntt.zero_pad(cm, n), jntt.forward_table(spec, w, n))
    return np.asarray(evals), w


def test_fold_routes_match_each_other_and_jax(monkeypatch):
    n = 512
    evals, w = _poly_evals(n, n // 4, seed=3)
    xs = mm.power_table(tspec, w, n, "cpu")
    root = torch.tensor([123456789] + [0] * 7, dtype=torch.int32)  # special_x 123456789
    dft = fri.fold(tspec, _t(evals), xs, root)
    lagrange = fri.fold(tspec, _t(evals), xs, root, route="lagrange")
    assert torch.equal(dft, lagrange) and dft.shape == (16, n // 4)
    # the JAX package reads its switch while it traces
    monkeypatch.setenv("STARK_TPU_FRI_LAGRANGE", "1")
    jfri._fold_j.clear_cache()
    try:
        want = np.asarray(jfri._fold_j(
            spec, jnp.asarray(evals), jmm.power_table(spec, w, n),
            jmm.mont_consts(spec, [123456789])[:, :, None]))
    finally:
        jfri._fold_j.clear_cache()
    _eq(lagrange, want)


def _plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    return obj


@pytest.mark.parametrize("exclude", [0, 8])
def test_fri_recursion_on_both_routes(exclude):
    n = 256
    evals, w = _poly_evals(n, n // 4, seed=exclude)
    values = _t(evals)
    xs = mm.power_table(tspec, w, n, "cpu")
    words = leaves_to_words(tspec, [values])
    tree = mt.DeviceMerkleTree(words, 32, mt.build_layers(words, 32))
    root = tree.layers[-1][:, 0].numpy().astype("<u4").tobytes()
    proofs = {}
    for route in fri.FOLD_ROUTES:
        pending = fri.prove_low_degree_pending(tspec, values, xs, n // 4, exclude, tree,
                                               fri_fold=route)
        proofs[route] = fri.assemble_fri(
            tspec, pending, fri.materialize_u32(pending["device_arrays"]))
    assert _plain(proofs["lagrange"]) == _plain(proofs["dft"])
    assert len(proofs["dft"]) == 2 and isinstance(proofs["dft"][-1], fri.FriLast)
    assert fri.verify_low_degree_proof(tspec, root, w, proofs["lagrange"], n // 4,
                                       exclude, "cpu")
    want = jfri.prove_low_degree(spec, jnp.asarray(evals), jmm.power_table(spec, w, n),
                                 n // 4, exclude)
    assert _plain(proofs["lagrange"]) == _plain(want)


@pytest.mark.parametrize("where", ["fold", "recursion"])
def test_unknown_route_raises(where):
    n = 64
    values = _t(_cols(5, width=n)[0])  # refused before any value is read
    xs = mm.power_table(tspec, tspec.root_of_unity(n), n, "cpu")
    with pytest.raises(ValueError, match="fri_fold"):
        if where == "fold":
            fri.fold(tspec, values, xs, torch.zeros(8, dtype=torch.int32), route="nonsense")
        else:
            fri.prove_low_degree_pending(tspec, values, xs, n // 4, 0, None,
                                         fri_fold="nonsense")
