"""Prover stages for one (spec, steps, precision, original_steps, device).

Counterpart of `stark_tpu/protocol/core.py:276 build_proof_stages` for one
device and precision up to 2^23 (`MAX_PRECISION`), on its
device-arithmetization path, with the (L, N) Zb3^-1 table held by the stage
set and the m-tree committed from its (64, N) leaf words. `digest`
("blake2s" or "poseidon") is the tree
digest of the l-tree (and so of FRI's first value tree); the m-tree and the
a-tree are blake2s under either, as in the JAX package (`core.py:288-300`):
the m-tree's 256-byte leaves exceed Poseidon's 64-byte input, and the
a-tree's 40-byte leaves straddle its 32-byte chunks. Stages are plain Python
functions over tensors, collected in a dict; there is no jit. Buffer
donation (`core.py:513-518`) has no counterpart: a stage drops each column
it owns after its last read instead. Z^-1 and x^steps travel as (L, skips)
Shoup pattern pairs.

With a mesh of d > 1 ranks (`parallel/distributed.py DomainMesh`) the
small-domain stages stay as they are, run replicated on every rank, and the
precision-domain ones come from `parallel/prove_sharded.py sharded_stages`:
`xs_full` and the inverse tables are the rank's chunks, `columns` is
`prove_sharded.columns_body`, the trees are sharded. `commit`, `branches`
and `replicate` are the interface the prover calls on either stage set.
"""

from __future__ import annotations

import types

import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.protocol.params import SPOT_CHECK_SECURITY_FACTOR
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import ntt as nttm
from stark_tpu_torch.protocol import device_transcript as dt
from stark_tpu_torch.protocol import fused_kernels
from stark_tpu_torch.protocol import kernels
from stark_tpu_torch.utils.tracing import phase, sync_point, syncing

# The largest precision with a proof: r and the spot checks are drawn modulo
# the precision by the protocol's index sampler (the reference's
# `get_pseudorandom_indices`, `device_transcript.pseudorandom_indices`),
# which takes moduli below 2^24. The JAX package has no such check and
# fails in the sampler, after the stage set's build and the first stages.
MAX_PRECISION = 1 << 23

TRACE_NAMES = ("k", "f0", "f1", "f2", "s", "p", "idx", "perm")
COL_NAMES = ("p", "a", "s", "d1", "d2", "d3", "b2", "b3")


def spot_positions(l_root_words8, precision: int, skips: int, kshift: int):
    """The spot checks drawn from the l-root and their 4 companion indices
    each (`prove.rs:351-359`) -> (pos, aug)."""
    pos = dt.pseudorandom_indices(
        l_root_words8, precision, SPOT_CHECK_SECURITY_FACTOR, skips
    )
    offs = torch.tensor([0, precision - skips, kshift, 2 * kshift],
                        dtype=torch.int64, device=pos.device)
    return pos, ((pos[:, None] + offs[None, :]) % precision).reshape(-1)


def leaves_to_words(spec: FieldSpec, columns) -> torch.Tensor:
    """Montgomery columns -> (W, M) int32 words of the concatenated
    canonical little-endian 32-byte encodings, zero-padded to whole blake
    blocks (`stark_tpu/protocol/core.py:966-983 _words_best`): one
    `from_mont_pack_words` launch per column, each straight into its 8 rows
    of the leaf buffer."""
    nblocks = max(1, (32 * len(columns) + 63) // 64)
    m = columns[0].shape[1]
    words = torch.empty((nblocks * 16, m), dtype=torch.int32, device=columns[0].device)
    for j, col in enumerate(columns):
        fused_kernels.from_mont_pack_words(spec, col.contiguous(), out=words[8 * j : 8 * j + 8])
    words[8 * len(columns) :] = 0
    return words


def tensor_bytes(*objs) -> int:
    """Device bytes of the tensors held by `objs`: tensors, and lists,
    tuples, dicts and plain objects (plans, bases) of them, each storage
    counted once (a view adds nothing to its base)."""
    seen, total, stack, visited = set(), 0, list(objs), set()
    while stack:
        obj = stack.pop()
        if torch.is_tensor(obj):
            storage = obj.untyped_storage()
            if storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                total += storage.nbytes()
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif (hasattr(obj, "__dict__") and id(obj) not in visited and not callable(obj)
              and not isinstance(obj, types.ModuleType)):
            visited.add(id(obj))
            stack.extend(vars(obj).values())
    return total


def resident_groups(xs_full, inv_zb3, iz_pats, x2_pats, plans):
    """`resident_bytes` of a stage set: the device bytes it holds between
    stages, grouped as `stark_tpu/protocol/core.py:909-933` groups them. The
    port holds no (L, N) Z^-1 or x^steps table (they travel as the Shoup
    pattern pairs), so `domain_tables` is Zb3^-1 alone; `ntt_plan_tables` is
    the butterfly plan, or the CRT engine's plans on crt. Per-circuit caches
    (Zb2^-1, the verifier's LDEs) hang on the circuit, not here."""
    def resident_bytes():
        return {"xs_full": tensor_bytes(xs_full), "domain_tables": tensor_bytes(inv_zb3),
                "shoup_patterns": tensor_bytes(iz_pats, x2_pats),
                "ntt_plan_tables": tensor_bytes(plans)}
    return resident_bytes


def build_proof_stages(spec: FieldSpec, steps: int, precision: int,
                       original_steps: int, digest: str, device,
                       block: int = nttm.FUSED_BLOCK,
                       lde_engine: str = "butterfly", mesh=None) -> dict:
    """The prover's device stages, split at the Fiat-Shamir points.
    `lde_engine` names the engine of the 9 LDEs (the verifier's 6):
    "butterfly" or "crt" (`ops/ntt.py make_best_lde`); the columns, and so
    the proof, are the same on either. `mesh` (a `DomainMesh` of d > 1
    ranks, on `device`) shards the precision domain (see the module
    docstring), its local DFTs on `lde_engine` too
    (`parallel/prove_sharded.py make_domain`, which refuses "crt" outside
    the JAX package's gate); None or a one-rank mesh builds the
    single-device set."""
    nttm.check_lde_engine(lde_engine)
    mt.check_digest(digest)
    if precision > MAX_PRECISION:
        raise ValueError(
            f"precision {precision} > 2^23: the protocol's index sampler "
            "(get_pseudorandom_indices) draws r and the spot checks modulo the "
            "precision and takes moduli below 2^24"
        )
    sharded = mesh is not None and mesh.size > 1
    dev = torch.device(device)
    p = spec.p
    L = spec.num_limbs
    skips = precision // steps
    kshift = original_steps // 3 * skips

    def flag_idx_perm(f1_u8, f2_u8, perm_lo, perm_hi):
        """Public columns: f0 (ones over the original steps), the flags
        from u8 vectors, idx (iota) and the permutation from u32 lo/hi
        word pairs, all in Montgomery form."""
        one = mm.mont_one(spec, dev).expand(L, steps)
        zero = torch.zeros((L, steps), dtype=torch.int32, device=dev)
        iota = torch.arange(steps, dtype=torch.int64, device=dev)
        f0_m = torch.where((iota < original_steps)[None], one, zero)
        f1_m = torch.where((f1_u8 != 0)[None], one, zero)
        f2_m = torch.where((f2_u8 != 0)[None], one, zero)

        def from_u32pair(lo, hi):
            lo = lo.to(torch.int64) & 0xFFFFFFFF
            hi = hi.to(torch.int64) & 0xFFFFFFFF
            limbs = torch.zeros((L, lo.shape[0]), dtype=torch.int32, device=dev)
            limbs[0], limbs[1] = lo & 0xFFFF, lo >> 16
            limbs[2], limbs[3] = hi & 0xFFFF, hi >> 16
            return mm.to_mont(spec, limbs)

        idx_m = from_u32pair(iota, torch.zeros_like(iota))
        perm_m = from_u32pair(perm_lo, perm_hi)
        return f0_m, f1_m, f2_m, idx_m, perm_m

    def wit_traces(k_bytes, wit_bytes, wids, f1_u8, f2_u8, perm_lo, perm_hi):
        """Device arithmetization (`core.py:440-473`): S gathers the witness
        by per-slot wire id; P[j] = F1[j]*P[j-1] + K[j]*S[j] is a log-depth
        (Hillis-Steele) scan of the gated combine
        (al, bl), (ar, br) -> (al & ar, ar ? bl + br : br)."""
        k_m = mm.to_mont(spec, mm.bytes_le_to_limbs(spec, k_bytes))
        wit_m = mm.to_mont(spec, mm.bytes_le_to_limbs(spec, wit_bytes))
        live = torch.arange(steps, device=dev) < original_steps
        s_m = torch.where(live[None], wit_m[:, wids.to(torch.int64)], 0)
        v = mm.mmul(spec, k_m, s_m)
        if syncing():  # the span opens on the gather and K * S done
            sync_point(v)
        with phase("p_scan", device=dev):
            g = (f1_u8 != 0) & live
            d = 1
            while d < steps:
                nv = torch.where(g[d:][None], mm.madd(spec, v[:, :-d], v[:, d:]), v[:, d:])
                v = torch.cat([v[:, :d], nv], dim=1)
                g = torch.cat([g[:d], g[:-d] & g[d:]])
                d *= 2
        f0_m, f1_m, f2_m, idx_m, perm_m = flag_idx_perm(f1_u8, f2_u8, perm_lo, perm_hi)
        return {
            "k": k_m, "f0": f0_m, "f1": f1_m, "f2": f2_m,
            "s": s_m, "p": v, "idx": idx_m, "perm": perm_m,
        }

    def v_cols(k_bytes, f1_u8, f2_u8, perm_lo, perm_hi):
        """The verifier's 6 public columns (no S/P)."""
        k_m = mm.to_mont(spec, mm.bytes_le_to_limbs(spec, k_bytes))
        return [k_m, *flag_idx_perm(f1_u8, f2_u8, perm_lo, perm_hi)]

    def a_root(perm_lo, perm_hi, s_small):
        """Root of the 40-byte (perm u64 LE || S) a-tree leaves."""
        s_words = leaves_to_words(spec, [s_small])[:8]
        a_words = torch.cat([
            perm_lo.reshape(1, -1), perm_hi.reshape(1, -1), s_words,
            s_words.new_zeros((6, s_words.shape[1])),
        ], dim=0).contiguous()
        return mt.build_layers(a_words, 40)[-1][:, 0]

    def r(a_root_words8):
        return dt.random_ff_mont(spec, a_root_words8, precision, 3, 0)

    def acc(idx_small, perm_small, s_small, r_mont):
        vn, vd = kernels.rand_combination(spec, r_mont, idx_small, perm_small, s_small)
        return kernels.accumulator_mini(spec, vn, vd)

    stages = {
        "lde_engine": lde_engine,
        "wit_traces": wit_traces,
        "v_cols": v_cols,
        "a_root": a_root,
        "r": r,
        "acc": acc,
    }
    if sharded:
        from stark_tpu_torch.parallel import prove_sharded as psh

        stages.update(psh.sharded_stages(spec, mesh, steps, precision, original_steps,
                                         digest, block, lde_engine))
        return stages

    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, skips, p)
    xs_full = mm.power_table(spec, g2, precision, dev)
    omega = pow(g2, steps, p)
    inv_z_scalars = [0] + [
        pow((pow(omega, t, p) - 1) % p, p - 2, p) for t in range(1, skips)
    ]
    pow_scalars = [pow(omega, t, p) for t in range(skips)]
    x_last_mont = mm.mont_const(spec, pow(g2, precision - skips, p), dev)
    # Z^-1 and x^steps repeat along the domain with period `skips`: they
    # travel as (L, skips) Shoup pattern pairs (`core.py:34-47` tiles them to
    # its kernels' block width; a CUDA thread takes column i mod skips), and
    # no (L, N) table of either is made.
    iz_pats = mm.shoup_consts(spec, inv_z_scalars, dev)
    x2_pats = mm.shoup_consts(spec, pow_scalars, dev)
    inv_zb3 = mm.multi_inv(spec, mm.msub(spec, xs_full, x_last_mont))
    # One column at a time on either engine (`stark_tpu/protocol/core.py:
    # 169-190`): with no traced module to fuse the columns into, the JAX
    # package's `_MXU_FUSE_MAX_PRECISION` switch has no counterpart here.
    lde_one = nttm.make_best_lde(spec, g1, g2, steps, precision, dev, lde_engine, block)

    def lde_many(ts):
        return [lde_one(t) for t in ts]

    def inv_zb2(pubx_mont):
        """Zb2^-1 over the public wire positions: circuit-static."""
        return mm.multi_inv(spec, kernels.vanishing_eval(spec, xs_full, pubx_mont))

    def rest_a(evs, a_ev, r_mont, i2_mont, inv_zb2_table):
        """Quotients and boundaries (`core.py:521-567`) -> the 8 m-tree
        columns and the divisibility flags. `evs` is consumed: each of the
        six single-use LDE outputs leaves the dict with its last read, and
        each quotient is dropped once its d is made, so the memory they
        held is free for what follows."""
        def quotient(q):
            bad.append((q[:, ::skips] != 0).any())
            return kernels.mmul_periodic_const(spec, q, None, iz_pats)

        bad = []
        d1 = quotient(kernels.q1_eval(spec, evs["s"], evs.pop("k"), evs["p"],
                                      evs.pop("f0"), evs.pop("f1"), skips))
        d2 = quotient(kernels.q2_eval(spec, evs["p"], evs.pop("f2"), kshift))
        vn_big, vd_big = kernels.rand_combination(
            spec, r_mont, evs.pop("idx"), evs.pop("perm"), evs["s"]
        )
        d3 = quotient(kernels.q3_eval(spec, a_ev, vn_big, vd_big, skips))
        del vn_big, vd_big
        q_bad = torch.stack(bad).to(torch.int32)
        i2_ev = kernels.horner_eval(spec, i2_mont, xs_full)
        b2_ev = kernels.sub_mul_ev(spec, evs["s"], i2_ev, inv_zb2_table)
        del i2_ev
        b3_ev = kernels.sub_mul_ev(spec, a_ev, mm.mont_one(spec, dev), inv_zb3)
        cols = {
            "p": evs["p"], "a": a_ev, "s": evs["s"],
            "d1": d1, "d2": d2, "d3": d3, "b2": b2_ev, "b3": b3_ev,
        }
        return cols, q_bad

    def columns(traces, r_mont, i2_mont, inv_zb2_table):
        a_mini = acc(traces["idx"], traces["perm"], traces["s"], r_mont)
        outs = lde_many([traces[n] for n in TRACE_NAMES] + [a_mini])
        a_ev = outs.pop()
        evs = dict(zip(TRACE_NAMES, outs))
        del outs  # the dict holds the only references `rest_a` releases
        return rest_a(evs, a_ev, r_mont, i2_mont, inv_zb2_table)

    def commit_chain(cols):
        """m-commit -> k coefficients -> linear combination -> l-commit
        (the l-tree under `digest`)."""
        m_words = leaves_to_words(spec, [cols[n] for n in COL_NAMES])
        m_layers = mt.build_layers(m_words, 256)
        k_mont = dt.k_coeffs_mont(spec, m_layers[-1][:, 0])
        l_ev = kernels.linear_combination(
            spec, k_mont, None, *[cols[n] for n in COL_NAMES], x2s_pats=x2_pats
        )
        l_words = leaves_to_words(spec, [l_ev])
        l_layers = mt.build_layers_digest(l_words, 32, digest)
        return m_words, m_layers, k_mont, l_ev, l_words, l_layers

    def pos_gather(l_root_words8, l_words, l_layers, m_words, m_layers):
        """Spot-check positions and both branch gathers."""
        pos, aug = spot_positions(l_root_words8, precision, skips, kshift)
        l_flat = mt.gather_flat(l_words, l_layers[:-1], pos)
        m_flat = mt.gather_flat(m_words, m_layers[:-1], aug)
        return l_flat, m_flat

    def commit(cols):
        """`commit_chain` -> (m-tree, l-tree, l column)."""
        m_words, m_layers, _, l_ev, l_words, l_layers = commit_chain(cols)
        return (mt.DeviceMerkleTree(m_words, 256, m_layers),
                mt.DeviceMerkleTree(l_words, 32, l_layers), l_ev)

    def branches(l_tree, m_tree):
        return pos_gather(l_tree.root_words, l_tree.leaf_words, l_tree.layers,
                          m_tree.leaf_words, m_tree.layers)

    stages.update({
        "xs_full": xs_full,
        "lde_many": lde_many,
        "inv_zb2": inv_zb2,
        "rest_a": rest_a,
        "columns": columns,
        "commit_chain": commit_chain,
        "pos_gather": pos_gather,
        "commit": commit,
        "branches": branches,
        "replicate": lambda l_ev: (l_ev, xs_full),
        "resident_bytes": resident_groups(xs_full, inv_zb3, iz_pats, x2_pats,
                                          lde_one.plans),
    })
    return stages
