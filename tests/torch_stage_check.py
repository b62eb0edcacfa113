"""Stage-by-stage comparison of the port's prover with JAX
`build_proof_stages` on one circuit (used by the test_torch_protocol*
files). Each port stage gets the JAX stage's own inputs, carried across by
`stark_tpu_torch.interop`; outputs must be bit-identical."""

import jax.numpy as jnp
import numpy as np

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.protocol.core import build_proof_stages as jax_stages
from stark_tpu.protocol.params import derive_params
from stark_tpu.utils import poly_host as ph
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, tree_from_numpy, tree_to_numpy
from stark_tpu_torch.protocol import prove as tprove
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.protocol.core import build_proof_stages


def to_np(obj):
    """JAX arrays and port tensors alike -> nested lists/dicts of uint32."""
    obj = tree_to_numpy(obj)  # port tensors; JAX arrays pass through
    if isinstance(obj, dict):
        return {k: to_np(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_np(v) for v in obj]
    return np.asarray(obj).astype(np.uint32)


def assert_same(port, jax_out, what: str) -> None:
    a, b = to_np(port), to_np(jax_out)

    def walk(x, y, path):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), (what, path)
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, list):
            assert len(x) == len(y), (what, path)
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        else:
            assert x.shape == y.shape and np.array_equal(x, y), (what, path)

    walk(a, b, "")


def check_stages_match_jax(r1cs, witness) -> None:
    h = r1cs.header
    arith = runner._static_arith(tspec, r1cs)
    n_pub = 1 + h.n_public_inputs + h.n_public_outputs
    pub = [spec.from_bytes_le(w) for w in witness[:n_pub]]
    params = derive_params(spec, arith.original_steps)
    steps, precision, skips = params.steps, params.precision, params.skips
    J = jax_stages(spec, steps, precision, arith.original_steps, None, "blake2s")
    T = build_proof_stages(tspec, steps, precision, arith.original_steps, "blake2s",
                           "cpu", block=16)
    t = lambda a: planes_from_numpy(np.asarray(a), "cpu")  # noqa: E731

    # the stage inputs, as both provers build them
    perm = tprove.permuted_column(arith.permuted_indices, arith.original_steps, steps)
    plo = (perm & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    phi = (perm >> np.uint64(32)).astype(np.uint32)
    wit = np.zeros((h.n_wires, 32), np.uint8)
    for i, wb in enumerate(witness):
        wit[i, : len(wb[:32])] = np.frombuffer(wb[:32], np.uint8)
    wids = np.zeros(steps, np.uint32)
    wids[: arith.original_steps] = arith.slot_wire_ids
    inputs = [
        tprove._col_bytes_np(tspec, tprove._pad_col(arith.coefficients, steps)),
        tprove._col_bytes_np(tspec, wit),
        wids,
        np.asarray(tprove._pad_col(arith.flag1, steps), np.uint8),
        np.asarray(tprove._pad_col(arith.flag2, steps), np.uint8),
        plo,
        phi,
    ]

    jtr = J["wit_traces"](*map(jnp.asarray, inputs))
    assert_same(T["wit_traces"](*tree_from_numpy(inputs, "cpu")), jtr, "wit_traces")
    tr = tree_from_numpy(to_np(jtr), "cpu")

    ja = J["a_root"](jnp.asarray(plo)[None], jnp.asarray(phi)[None], jtr["s"])
    assert_same(T["a_root"](t(plo), t(phi), tr["s"]), ja, "a_root")
    jr = J["r"](ja)
    assert_same(T["r"](t(ja)), jr, "r")
    jacc = J["acc"](jtr["idx"], jtr["perm"], jtr["s"], jr)
    assert_same(T["acc"](tr["idx"], tr["perm"], tr["s"], t(jr)), jacc, "acc")

    pub_xs = [pow(params.g2, skips * w, spec.p) for (_, w) in arith.public_first_indices]
    pub_ys = [pub[k] for (k, _) in arith.public_first_indices]
    i2 = jmm.mont_consts(spec, ph.lagrange_interp(spec, pub_xs, pub_ys))
    pubx = jmm.mont_consts(spec, pub_xs)
    jzb2 = J["inv_zb2"](pubx, J["xs_full"])
    assert_same(T["inv_zb2"](t(pubx)), jzb2, "inv_zb2")
    jcols, jbad = J["columns"](jtr, jr, i2, jzb2)
    tcols, tbad = T["columns"](tr, t(jr), t(i2), t(jzb2))
    assert_same(tcols, jcols, "columns")
    assert tbad.tolist() == np.asarray(jbad).tolist() == [0, 0, 0]

    cols_np = to_np(jcols)
    jchain = J["commit_chain"]({k: jnp.asarray(v) for k, v in cols_np.items()})
    assert_same(list(T["commit_chain"](tree_from_numpy(cols_np, "cpu"))), list(jchain),
                "commit_chain")

    m_words, m_layers, _, _, l_words, l_layers = jchain
    l_root = l_layers[-1][:, 0]
    jflat = J["pos_gather"](l_root, l_words, tuple(l_layers), m_words, tuple(m_layers))
    tflat = T["pos_gather"](t(l_root), t(l_words), [t(x) for x in l_layers],
                            t(m_words), [t(x) for x in m_layers])
    assert_same(list(tflat), list(jflat), "pos_gather")
