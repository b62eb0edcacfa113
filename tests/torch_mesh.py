"""d gloo ranks on the CPU for the test_torch_parallel_* files, and the
rank bodies they run.

The ranks are OS processes started by `distributed.run_ranks` (spawn, a
`tcp://127.0.0.1` rendezvous, every collective's timeout `TIMEOUT_S`, one
intra-op thread a rank), so a rank that fails fails the test with its
traceback instead of hanging it. Threads of one process would serve too,
but the plain PyTorch versions of the kernels run many small ops, and four
threads ran them 5-6 times slower than one thread alone (the interpreter
lock). This module imports nothing of JAX: the spawned ranks import it to
find their bodies. Each body returns numpy arrays (uint32 for planes).
"""

import numpy as np
import torch

from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import mxu_ntt, plan_cache
from stark_tpu_torch.parallel import distributed, ntt4
from stark_tpu_torch.parallel import prove_sharded as psh
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.synth import squaring_chain

TIMEOUT_S = 45
BLOCK = 16  # a small fused block, so that the local DFTs run passes too


def one_thread(mesh, fn, *args):
    """fn(mesh, *args) on one intra-op thread (d ranks share the cores)."""
    torch.set_num_threads(1)
    return fn(mesh, *args)


def run_procs(fn, d: int, *args, bodies: int = 1) -> list:
    """fn(mesh, *args) on d CPU ranks; their results in rank order. The run
    and each of its collectives may take `TIMEOUT_S` for each of the
    `bodies` it runs (the proofs of a run, say)."""
    return distributed.run_ranks(one_thread, d, device="cpu", backend="gloo",
                                 timeout=TIMEOUT_S * bodies, args=(fn,) + args)


def _np(t):
    return planes_to_numpy(t) if t.dtype == torch.int32 else t.numpy()


def ntt_body(mesh, vals: np.ndarray, root: int, shifts, trace: np.ndarray, ext: int):
    """The four-step NTT forward and back, the rank's tables, the rolls of
    the input at each shift and the LDE of `trace`, on the rank's chunks."""
    n = vals.shape[1]
    x = distributed.shard_cols(planes_from_numpy(vals, "cpu"), mesh)
    fwd = ntt4.make_tables(tspec, root, n, mesh.size, mesh.rank, device="cpu", block=BLOCK)
    inv = ntt4.make_tables(tspec, root, n, mesh.size, mesh.rank, inverse=True, device="cpu",
                           block=BLOCK)
    y = ntt4.ntt_sharded_local(tspec, x, mesh, fwd)
    back = ntt4.ntt_sharded_local(tspec, y, mesh, inv, mm.mont_const(tspec, tspec.inv(n), "cpu"))
    steps = trace.shape[1]
    g2 = tspec.root_of_unity(steps * ext)
    g1 = pow(g2, ext, tspec.p)
    s_tabs = ntt4.make_tables(tspec, g1, steps, mesh.size, mesh.rank, True, "cpu", BLOCK)
    p_tabs = ntt4.make_tables(tspec, g2, steps * ext, mesh.size, mesh.rank, False, "cpu", BLOCK)
    lde = psh.lde_local(tspec, distributed.shard_cols(planes_from_numpy(trace, "cpu"), mesh),
                        mesh, s_tabs, p_tabs, mm.mont_const(tspec, tspec.inv(steps), "cpu"), ext)
    return {
        "fwd": _np(y), "back": _np(back), "lde": _np(lde),
        "w_d_half": _np(fwd.w_d_half), "w_m": fwd.w_m, "tw": _np(fwd.tw),
        "rolls": [_np(psh.roll_sharded(x, s, mesh)) for s in shifts],
    }


def tree_body(mesh, jobs, idx: np.ndarray):
    """For each job (words, leaf_bytes, digest): the sharded tree's root and
    its gather at the global `idx`."""
    out = []
    for words, leaf_bytes, digest in jobs:
        local = distributed.shard_cols(planes_from_numpy(words, "cpu"), mesh)
        tree = psh.ShardedMerkleTree(local, leaf_bytes, mesh, digest)
        out.append((_np(tree.root_words), _np(tree.gather(torch.from_numpy(idx)))))
    return out


def _dom(mesh, steps: int, precision: int, original_steps: int):
    return psh.make_domain(tspec, mesh, steps, precision, original_steps, BLOCK)


def columns_body(mesh, shape, traces: dict, r_mont, i2_mont, pubx_mont):
    """The rank's chunks of the 8 m-tree columns, the flags and Zb2^-1."""
    dom = _dom(mesh, *shape)
    t = {k: planes_from_numpy(v, "cpu") for k, v in traces.items()}
    inv_zb2 = psh.inv_zb2_local(tspec, dom, planes_from_numpy(pubx_mont, "cpu"))
    cols, bad = psh.columns_body(tspec, dom, t, planes_from_numpy(r_mont, "cpu"),
                                 planes_from_numpy(i2_mont, "cpu"), inv_zb2)
    return {k: _np(v) for k, v in cols.items()}, bad.numpy(), _np(inv_zb2)


def core_body(mesh, shape, traces: dict, r_mont, k_mont, i2_mont, pubx_mont):
    """`sharded_prover_core`: the two roots and the rank's l chunk, with the
    rank's column chunks and its Zb2^-1, Zb3^-1 chunks."""
    dom = _dom(mesh, *shape)
    t = {k: planes_from_numpy(v, "cpu") for k, v in traces.items()}
    pl = lambda a: planes_from_numpy(a, "cpu")  # noqa: E731
    inv_zb2 = psh.inv_zb2_local(tspec, dom, pl(pubx_mont))
    cols, _ = psh.columns_body(tspec, dom, t, pl(r_mont), pl(i2_mont), inv_zb2)
    roots = psh.sharded_prover_core(tspec, dom, t, pl(r_mont), pl(k_mont), pl(i2_mont),
                                    inv_zb2)
    return ([_np(a) for a in roots], {k: _np(v) for k, v in cols.items()}, _np(inv_zb2),
            _np(dom["inv_zb3"]))


def crt_body(mesh, cache_dir: str, vals: np.ndarray, root: int, trace: np.ndarray,
             precision: int):
    """The CRT engine on the mesh, its plans cached in `cache_dir`: the
    four-step NTT of `vals` at `root` with the local DFT on CRT plans
    (`make_tables(lde_engine="crt")`), forward and back, and
    `mxu_ntt.lde_mxu_sharded` of `trace` to `precision`, on the rank's
    chunks."""
    plan_cache.CACHE_DIR = cache_dir
    n = vals.shape[1]
    x = distributed.shard_cols(planes_from_numpy(vals, "cpu"), mesh)
    fwd = ntt4.make_tables(tspec, root, n, mesh.size, mesh.rank, device="cpu",
                           lde_engine="crt")
    inv = ntt4.make_tables(tspec, root, n, mesh.size, mesh.rank, True, "cpu",
                           lde_engine="crt")
    y = ntt4.ntt_sharded_local(tspec, x, mesh, fwd)
    back = ntt4.ntt_sharded_local(tspec, y, mesh, inv, mm.mont_const(tspec, tspec.inv(n), "cpu"))
    steps = trace.shape[1]
    g2 = tspec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, tspec.p)
    plans = mxu_ntt.make_lde_plans(tspec, g1, g2, steps, precision, "cpu")
    mesh.reset_stats()
    lde = mxu_ntt.lde_mxu_sharded(mesh, *plans, distributed.shard_cols(
        planes_from_numpy(trace, "cpu"), mesh))
    return {"fwd": _np(y), "back": _np(back), "lde": _np(lde), "stats": mesh.stats}


def core_and_crt_body(mesh, core_args, crt_args):
    """`core_body` and `crt_body` in one run of the ranks."""
    return core_body(mesh, *core_args), crt_body(mesh, *crt_args)


def chain_proofs_body(mesh, jobs):
    """Proofs of squaring chains on the mesh: jobs of (constraints, x0,
    digest, fri_fold), each a fresh circuit object; -> the proofs' JSON, the
    top-level phases the rank's tracer recorded, and the `resident_bytes()`
    of the last job's sharded stage set."""
    from stark_tpu_torch.protocol import prove
    from stark_tpu_torch.protocol.params import derive_params
    from stark_tpu_torch.utils import tracing

    tracing.reset()
    out = []
    for n, x0, digest, fri_fold in jobs:
        r1cs, witness = squaring_chain(n, x0=x0)
        out.append(proof_mod.to_json(runner.prove_with_witness(
            r1cs, witness, mesh=mesh, digest=digest, device="cpu", fri_fold=fri_fold)))
    original_steps = runner._static_arith(tspec, r1cs).original_steps
    params = derive_params(tspec, original_steps)
    stages = prove._stages_cached(tspec, params.steps, params.precision, original_steps,
                                  digest, torch.device("cpu"), "butterfly", mesh)
    return out, tracing.top_names(), stages["resident_bytes"]()


def golden_proofs_body(mesh, r1cs_path: str, wtns_path: str, jobs, cache_dir: str):
    """Proofs of one circuit's files on the mesh: jobs of (digest, fri_fold,
    lde_engine), the butterfly ones through `prove_full.prove_files_sharded`,
    the others through `runner.prove_with_witness(mesh=, lde_engine=)`
    (CRT plans cached in `cache_dir`); -> the proofs' JSON."""
    from stark_tpu_torch.parallel import prove_full
    from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

    plan_cache.CACHE_DIR = cache_dir
    out = []
    for digest, fri_fold, lde_engine in jobs:
        if lde_engine == "butterfly":
            out.append(prove_full.prove_files_sharded(mesh, r1cs_path, wtns_path, digest,
                                                      fri_fold))
            continue
        with open(r1cs_path, "rb") as f:
            r1cs = read_r1cs(f.read())
        with open(wtns_path, "rb") as f:
            witness = read_witness(f.read())
        out.append(proof_mod.to_json(runner.prove_with_witness(
            r1cs, witness, mesh=mesh, digest=digest, device="cpu", fri_fold=fri_fold,
            lde_engine=lde_engine)))
    return out


def prove_many_body(mesh, n: int, x0s, pipeline: int):
    """`prove_many(mesh=)` over the witnesses of squaring_chain(n) at x0s."""
    r1cs, _ = squaring_chain(n)
    witnesses = [squaring_chain(n, x0=x0)[1] for x0 in x0s]
    return [proof_mod.to_json(p) for p in runner.prove_many(
        r1cs, witnesses, pipeline=pipeline, mesh=mesh, device="cpu")]


def failing_body(mesh):
    """Rank 1 raises before its first collective; the others wait in one."""
    if mesh.rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    return mesh.all_gather(torch.zeros((1, 1), dtype=torch.int32))


def whole_tree(words: np.ndarray, leaf_bytes: int, digest: str, idx: np.ndarray):
    """Root and `gather_flat` of the whole tree on one device."""
    w = planes_from_numpy(words, "cpu")
    layers = mt.build_layers_digest(w, leaf_bytes, digest)
    return (planes_to_numpy(layers[-1][:, 0]),
            planes_to_numpy(mt.gather_flat(w, layers[:-1], torch.from_numpy(idx))))
