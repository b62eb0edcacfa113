"""The JAX package's sharded prover core on d devices, for the
test_torch_parallel_jax_* files.

`stark_tpu/parallel/prove_sharded.py build_sharded_prover_step` compiles its
body under `shard_map`; on the CPU that compile takes 35-80 s for one d
(`squaring_chain(5)` to `(44)`). Here the same body, composed of the JAX
package's own functions as its lines 330-345 compose them (`_columns_body`,
`kernels.linear_combination`, `_leaves_to_words`, `merkle_root_words`),
runs eagerly under `jax.vmap` with the named axis "d": the collectives
(`all_to_all`, `ppermute`, `all_gather`, `psum`, `axis_index`) keep their
meaning over the mapped axis, and nothing is compiled as a whole.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.parallel import prove_sharded as jps
from stark_tpu.protocol import kernels as jkernels
from stark_tpu.protocol.core import make_example_inputs
from stark_tpu.protocol.params import derive_params
from stark_tpu.r1cs.arithmetize import arithmetize
from stark_tpu.r1cs.synth import squaring_chain

import torch_mesh

CONSTRAINTS = 5  # steps 16 = 4^2, the least the four-step NTT takes at d = 4


def example(n_constraints: int):
    """(shape, inputs): (steps, precision, original_steps) and the numpy
    (traces, r, k, i2, pubx) of `make_example_inputs` on squaring_chain(n)."""
    r1cs, wb = squaring_chain(n_constraints)
    witness = [spec.from_bytes_le(w) for w in wb]
    arith = arithmetize(spec, r1cs.constraints, witness, r1cs.header.n_wires, 2)
    params = derive_params(spec, arith.original_steps)
    traces, r, k, i2, pubx = make_example_inputs(spec, arith, witness[:2], params)
    inputs = ({n: np.asarray(v) for n, v in traces.items()},
              np.asarray(r), np.asarray(k), np.asarray(i2), np.asarray(pubx))
    return (params.steps, params.precision, arith.original_steps), inputs


def sharded_core(d: int, shape, inputs):
    """-> (cols (L, N) each, q_bad, m_root, l_root, l_ev (L, N)) of the
    JAX sharded body on d devices."""
    steps, precision, original_steps = shape
    traces, r, k, i2, pubx = inputs
    mesh = Mesh(np.array(jax.devices()[:d]), ("d",))
    dom = jps._make_domain(spec, mesh, steps, precision)
    skips = dom["skips"]

    def body(tr, xs_local):
        cols, q_bad = jps._columns_body(spec, dom, steps, precision, original_steps, "d",
                                        tr, xs_local, r, i2, pubx)
        x_to_steps = jnp.tile(jmm.mont_consts(spec, dom["pow_scalars"]),
                              (1, precision // d // skips))
        l_ev = jkernels.linear_combination(spec, k, x_to_steps,
                                           *[cols[n] for n in jps._COL_NAMES])
        m_root = jps.merkle_root_words(
            spec, jps._leaves_to_words(spec, [cols[n] for n in jps._COL_NAMES]), 256, "d", d)
        l_root = jps.merkle_root_words(spec, jps._leaves_to_words(spec, [l_ev]), 32, "d", d)
        return cols, q_bad, m_root, l_root, l_ev

    def split(a):
        return jnp.moveaxis(jnp.asarray(a).reshape(a.shape[0], d, -1), 1, 0)

    xs = jmm.power_table(spec, spec.root_of_unity(precision), precision)
    cols, q_bad, m_root, l_root, l_ev = jax.vmap(body, axis_name="d")(
        {n: split(v) for n, v in traces.items()}, split(np.asarray(xs)))
    whole = lambda a: np.concatenate(list(np.asarray(a)), axis=1)  # noqa: E731
    return ({n: whole(v) for n, v in cols.items()}, np.asarray(q_bad)[0],
            np.asarray(m_root)[0], np.asarray(l_root)[0], whole(l_ev))


def chunk_inverses(d: int, shape, pubx):
    """Each rank's Zb2^-1 and Zb3^-1 chunks by the JAX body's elementwise
    Fermat inversion, `mm.minv` (`prove_sharded.py:262-266`)."""
    steps, precision, _ = shape
    g2 = spec.root_of_unity(precision)
    skips = precision // steps
    xs = jmm.power_table(spec, g2, precision)
    x_last = jmm.mont_const(spec, pow(g2, precision - skips, spec.p))
    m = precision // d
    out = []
    for rank in range(d):
        xl = xs[:, rank * m : (rank + 1) * m]
        out.append((np.asarray(jmm.minv(spec, jkernels.vanishing_eval(spec, xl, pubx))),
                    np.asarray(jmm.minv(spec, jmm.msub(spec, xl, jnp.broadcast_to(
                        x_last, xl.shape))))))
    return out


def check_core(d: int) -> None:
    """The port's `columns_body` and `sharded_prover_core` on d CPU ranks
    equal the JAX sharded body on d devices, and each rank's inverse chunks
    equal `mm.minv`'s."""
    shape, inputs = example(CONSTRAINTS)
    traces, r, k, i2, pubx = inputs
    # the ranks run in their processes while this one runs the JAX side
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(torch_mesh.run_procs, torch_mesh.core_body, d, shape, traces, r,
                           k, i2, pubx)
        cols, q_bad, m_root, l_root, l_ev = sharded_core(d, shape, inputs)
        inverses = chunk_inverses(d, shape, pubx)
        ranks = port.result()
    for name, want in cols.items():
        got = np.concatenate([rk[1][name] for rk in ranks], axis=1)
        assert np.array_equal(got, want), name
    assert not q_bad.any()
    for rk in ranks:
        (pm_root, pl_root, _), _, _, _ = rk
        assert np.array_equal(pm_root, m_root) and np.array_equal(pl_root, l_root)
    assert np.array_equal(np.concatenate([rk[0][2] for rk in ranks], axis=1), l_ev)
    for rk, (zb2_inv, zb3_inv) in zip(ranks, inverses):
        assert np.array_equal(rk[2], zb2_inv) and np.array_equal(rk[3], zb3_inv)
