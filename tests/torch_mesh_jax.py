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

The CRT engine on the mesh: the JAX body's four-step NTT with its local
M-point DFT on a CRT plan (`stark_tpu/parallel/ntt4.py:80-84`, `m_plan`)
runs the same way, under `jax.jit` (eagerly its CRT products take 20 s of
op dispatch, compiled 10 s). The CRT LDE's reference is the JAX package's
`lde_mxu` on one device at steps 64, precision 512, on the same trace; the
JAX package's own
`tests/test_parallel.py::test_lde_mxu_sharded_matches_single_device` holds
its `lde_mxu_sharded` (a GSPMD compile of 35-80 s a mesh on the CPU) to
that `lde_mxu` at the same case.

`run(d, cache_dir)` starts the port's d rank processes once for all three
(`torch_mesh.core_and_crt_body`) while this process computes the JAX side;
both packages' CRT plans are cached under `cache_dir`.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import mxu_ntt as jmxu
from stark_tpu.parallel import ntt4 as jntt4
from stark_tpu.parallel import prove_sharded as jps
from stark_tpu.protocol import kernels as jkernels
from stark_tpu.protocol.core import make_example_inputs
from stark_tpu.protocol.params import derive_params
from stark_tpu.r1cs.arithmetize import arithmetize
from stark_tpu.r1cs.synth import squaring_chain
from stark_tpu_torch.ops import plan_cache as tplan_cache

import torch_mesh

CONSTRAINTS = 5  # steps 16 = 4^2, the least the four-step NTT takes at d = 4
CRT_N = 64  # the CRT four-step NTT's size: local M = 32, 16 at d = 2, 4
CRT_STEPS, CRT_PRECISION = 64, 512  # the CRT LDE's case (test_parallel.py:174)


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


def _split(a, d: int):
    """(L, N) -> (d, L, N/d): each device's contiguous chunk."""
    return jnp.moveaxis(jnp.asarray(a).reshape(a.shape[0], d, -1), 1, 0)


def _whole(a) -> np.ndarray:
    return np.concatenate(list(np.asarray(a)), axis=1)


def crt_ntt(d: int, vals: np.ndarray, root: int, inverse: bool) -> np.ndarray:
    """The JAX body's four-step NTT on d devices with its local DFT on the
    CRT plan at w_N^d, as `prove_sharded._make_domain` builds it."""
    n = vals.shape[1]
    m = n // d
    w_d, w_m, tw = jntt4.make_tables(spec, root, n, d, inverse=inverse)
    r = spec.inv(root) if inverse else root
    m_plan = jmxu.make_ntt_plan_cached(spec, pow(r, d, spec.p), m)
    n_inv = jmm.mont_const(spec, spec.inv(n)) if inverse else None

    def body(x, tw_local):
        return jntt4.ntt_sharded_local(spec, x, "d", d, w_d, w_m, tw_local, n_inv_mont=n_inv,
                                       m_plan=m_plan)

    tws = jnp.moveaxis(jnp.asarray(tw).reshape(tw.shape[0], d, d, m // d), 2, 0)
    return _whole(jax.jit(jax.vmap(body, axis_name="d"))(_split(vals, d), tws))


def crt_inputs():
    """(vals (L, CRT_N), trace (L, CRT_STEPS)) Montgomery numpy arrays."""
    rng = np.random.default_rng(20261018)
    draw = lambda k: np.asarray(jmm.to_mont(spec, jmm.ints_to_limbs_np(  # noqa: E731
        [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(k)], spec)))
    return draw(CRT_N), draw(CRT_STEPS)


def run(d: int, cache_dir: str) -> dict:
    """The port's ranks (`core_and_crt_body`) and the JAX references."""
    shape, inputs = example(CONSTRAINTS)
    vals, trace = crt_inputs()
    root = spec.root_of_unity(CRT_N)
    crt_args = (os.path.join(cache_dir, "port"), vals, root, trace, CRT_PRECISION)
    saved = os.environ.get("STARK_TPU_PLANS_CACHE"), tplan_cache.CACHE_DIR
    os.environ["STARK_TPU_PLANS_CACHE"] = os.path.join(cache_dir, "jax")
    tplan_cache.CACHE_DIR = crt_args[0]
    try:
        # the ranks run in their processes while this one runs the JAX side
        with ThreadPoolExecutor(1) as pool:
            port = pool.submit(torch_mesh.run_procs, torch_mesh.core_and_crt_body, d,
                               (shape, *inputs), crt_args, bodies=2)
            out = {"core": sharded_core(d, shape, inputs),
                   "inverses": chunk_inverses(d, shape, inputs[4]),
                   "fwd": crt_ntt(d, vals, root, False)}
            g2 = spec.root_of_unity(CRT_PRECISION)
            plans = jmxu.make_lde_plans(spec, pow(g2, CRT_PRECISION // CRT_STEPS, spec.p), g2,
                                        CRT_STEPS, CRT_PRECISION)
            out["lde"] = np.asarray(jmxu.lde_mxu(*plans, jnp.asarray(trace)))
            out["ranks"] = port.result()
    finally:
        if saved[0] is None:
            del os.environ["STARK_TPU_PLANS_CACHE"]
        else:
            os.environ["STARK_TPU_PLANS_CACHE"] = saved[0]
        tplan_cache.CACHE_DIR = saved[1]
    out["vals"] = vals
    return out


def check_core(res: dict) -> None:
    """The port's `columns_body` and `sharded_prover_core` on d CPU ranks
    equal the JAX sharded body on d devices, and each rank's inverse chunks
    equal `mm.minv`'s."""
    cols, q_bad, m_root, l_root, l_ev = res["core"]
    ranks = [rk for rk, _ in res["ranks"]]
    for name, want in cols.items():
        got = np.concatenate([rk[1][name] for rk in ranks], axis=1)
        assert np.array_equal(got, want), name
    assert not q_bad.any()
    for rk in ranks:
        (pm_root, pl_root, _), _, _, _ = rk
        assert np.array_equal(pm_root, m_root) and np.array_equal(pl_root, l_root)
    assert np.array_equal(np.concatenate([rk[0][2] for rk in ranks], axis=1), l_ev)
    for rk, (zb2_inv, zb3_inv) in zip(ranks, res["inverses"]):
        assert np.array_equal(rk[2], zb2_inv) and np.array_equal(rk[3], zb3_inv)


def check_crt_dft(res: dict) -> None:
    """The port's four-step NTT with its local DFT on the CRT engine equals
    the JAX body's with `m_plan`, and its inverse (the local DFT's CRT plan
    at the inverse root) returns the input."""
    crt = [c for _, c in res["ranks"]]
    assert np.array_equal(np.concatenate([c["fwd"] for c in crt], axis=1), res["fwd"])
    assert np.array_equal(np.concatenate([c["back"] for c in crt], axis=1), res["vals"])


def check_lde_mxu_sharded(res: dict, d: int) -> None:
    """`lde_mxu_sharded`'s chunks make the JAX package's single-device
    `lde_mxu` column on the same trace; each rank exchanges a chunk's worth
    a transpose: two all-to-alls of its steps-domain chunk, the all-gather
    of the coefficients, two all-to-alls of its precision-domain chunk."""
    crt = [c for _, c in res["ranks"]]
    assert np.array_equal(np.concatenate([c["lde"] for c in crt], axis=1), res["lde"])
    chunk, small = (16 * 4 * n // d for n in (CRT_PRECISION, CRT_STEPS))  # bytes
    for c in crt:
        st = c["stats"]
        assert (st["all_to_all"]["calls"], st["all_to_all"]["bytes"]) == (4, 2 * chunk + 2 * small)
        assert (st["all_gather"]["calls"], st["all_gather"]["bytes"]) == (1, d * small)
