"""The plain reference prover: a circuit and its witness -> the proof's JSON
text, computed anew in plain PyTorch (`r1cs-stark/src/prove.rs:14-378`,
`fri/src/fri.rs:46-224`, the layout of the reference's serde JSON).

It shares nothing with the measured program: its field, transforms, hashes,
trees, transcript and arithmetization are this folder's own. Protocol
parameters: blowup 8, 80 spot checks, FRI folding by 4 with 40 queries a
round and the values sent once at most 16 (`utils.rs:134-136`, `fri.rs:14,
184`). `digest` names the hash of the l-tree and FRI's trees; the a-tree,
the m-tree and the transcript are Blake2s under either.

`lazy=True` is the control: every value committed (the leaves of the
m-tree, the l-tree and FRI's trees, and FRI's last values) is left in
[0, 2p) where its residue is below 2^256 - p, the form a lazily reduced
kernel would hand over.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from benchmark.ref import r1cs as rr
from benchmark.ref import transcript as ts
from benchmark.ref.field import BN254_P, L, Field
from benchmark.ref.merkle import Tree
from benchmark.ref.ntt import lde

EXTENSION = 8
SPOT_CHECKS = 80
FRI_QUERIES = 40
DIRECT_AT = 16
GENERATOR = 7


class Prover:
    def __init__(self, r1cs: dict, device, digest: str = "blake2s", lazy: bool = False):
        if r1cs["prime"] != BN254_P.to_bytes(32, "little"):
            raise ValueError("only BN254's Fr")
        self.r1cs = r1cs
        self.F = Field(BN254_P, device)
        self.device = torch.device(device)
        self.digest = digest
        self.lazy = lazy
        self.seconds: dict = {}  # the last proof's stages, synchronized

    def _mark(self, name: str, t0: list) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - t0[0]
        t0[0] = now

    def _bytes(self, x: torch.Tensor) -> torch.Tensor:
        """(10, n) Montgomery -> (n, 32) uint8 leaves; under the control the
        residues that fit take p once more."""
        b = self.F.to_bytes(x)
        if not self.lazy:
            return b
        vals = self.F.canonical(self.F.from_mont(x))
        pl = self.F.const_limbs(self.F.p)
        lifted = vals + pl
        for i in range(L - 1):
            lifted[i + 1] += lifted[i] >> 26
            lifted[i] &= (1 << 26) - 1
        fits = lifted[L - 1] < (1 << (256 - 26 * (L - 1)))
        out = torch.empty(32, x.shape[1], dtype=torch.int64, device=x.device)
        for k in range(32):
            i, o = (8 * k) // 26, (8 * k) % 26
            v = lifted[i] >> o
            if o + 8 > 26 and i + 1 < L:
                v = v | (lifted[i + 1] << (26 - o))
            out[k] = v & 0xFF
        return torch.where(fits[:, None], out.T.to(torch.uint8), b)

    def prove(self, rows: np.ndarray) -> str:
        """rows: the witness as (n_wires, 32) uint8 little-endian."""
        F, p, dev = self.F, self.F.p, self.device
        r1cs = self.r1cs
        t0 = [time.perf_counter()]
        witness = F.from_bytes(torch.from_numpy(np.array(rows, dtype=np.uint8)).to(dev))
        pub = F.to_ints(witness[:, : 1 + r1cs["n_public_inputs"] + r1cs["n_public_outputs"]])
        ar = rr.arithmetize(F, r1cs, witness)
        self._mark("arithmetize", t0)
        original = ar["original_steps"]
        steps = max(8, 1 << (original - 1).bit_length())
        N = steps * EXTENSION
        skips = EXTENSION
        g2 = pow(GENERATOR, (p - 1) // N, p)
        g1 = pow(g2, skips, p)
        xs = F.powers(g2, N)

        def pad(col, fill=0):
            out = F.const(fill).expand(L, steps).clone()
            out[:, :original] = col
            return out

        def host_col(a):
            return F.to_mont(torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)
                             .unsqueeze(0).expand(L, -1) * _unit(dev))

        ext = lambda col: lde(F, col, g1, g2, xs)  # noqa: E731
        permuted = np.concatenate([ar["permuted"], np.arange(original, steps)])
        k_ev = ext(pad(ar["coeff"]))
        f0_ev = ext(pad(F.const(1).expand(L, original)))
        f1_ev = ext(pad(host_col(ar["flag1"])))
        f2_ev = ext(pad(host_col(ar["flag2"])))
        s_ev = ext(pad(ar["witness"]))
        p_ev = ext(pad(ar["trace"]))
        idx_ev = ext(host_col(np.arange(steps)))
        perm_ev = ext(host_col(permuted))
        self._mark("8 extensions", t0)

        # Z(x) = x^steps - 1 takes 8 values, one a residue of j mod 8
        w8 = pow(g2, steps, p)
        z = [(pow(w8, j, p) - 1) % p for j in range(EXTENSION)]
        inv_z = F.consts([pow(v, p - 2, p) if v else 0 for v in z]).view(L, 1, EXTENSION)

        def by_z(q):
            return F.mul(q.view(L, steps, EXTENSION), inv_z).view(L, N)

        p_prev = torch.roll(p_ev, skips, dims=1)
        q1 = F.mul(f0_ev, F.reduce(F.sub(F.sub(p_ev, F.mul(f1_ev, p_prev)), F.mul(k_ev, s_ev))))
        k3 = original // 3
        p1 = torch.roll(p_ev, -k3 * skips, dims=1)
        p2 = torch.roll(p_ev, -2 * k3 * skips, dims=1)
        q2 = F.mul(f2_ev, F.reduce(F.sub(p2, F.mul(p_ev, p1))))
        del k_ev, f0_ev, f1_ev, f2_ev, p1, p2, p_prev
        d1, d2 = by_z(q1), by_z(q2)
        del q1, q2

        # the a-tree: (permuted index u64 LE || witness) leaves
        wt = pad(ar["witness"])
        a_leaves = torch.cat([
            torch.from_numpy(permuted.astype("<u8").view(np.uint8).reshape(steps, 8)).to(dev),
            F.to_bytes(wt)], dim=1)
        a_root = Tree(a_leaves, "blake2s").root
        r0, r1, r2 = (F.const(v) for v in ts.random_field_values(a_root, N, 3, p))

        def rand_comb(idx, perm, s):
            rs = F.mul(r2, s)
            nm = F.reduce(r0 + F.mul(r1, idx) + rs)
            dn = F.reduce(r0 + F.mul(r1, perm) + rs)
            return nm, dn

        nm, dn = rand_comb(idx_ev[:, ::skips], perm_ev[:, ::skips], wt)
        a_nmr = F.prefix_prod(nm)
        a_mini = F.mul(a_nmr, F.batch_inv(F.prefix_prod(dn)))
        del nm, dn, a_nmr
        a_ev = ext(a_mini)
        nm, dn = rand_comb(idx_ev, perm_ev, s_ev)
        del idx_ev, perm_ev
        q3 = F.reduce(F.sub(F.mul(a_ev, dn), F.mul(torch.roll(a_ev, skips, dims=1), nm)))
        del nm, dn
        d3 = by_z(q3)
        del q3

        # boundaries: the public wires at their first slots, and A = 1 last
        pts = [pow(g2, skips * w, p) for _, w in ar["public_first"]]
        i2 = ts.lagrange_interp(pts, [pub[k] for k, _ in ar["public_first"]], p)
        zb2 = F.const(1)
        for x in pts:
            zb2 = F.mul(zb2, F.sub(xs, F.const(x)))
        b2 = F.mul(F.sub(s_ev, self._horner(i2, xs)), F.batch_inv(zb2))
        x_last = pow(g2, N - skips, p)
        i3 = ts.lagrange_interp([x_last], [1], p)
        b3 = F.mul(F.sub(a_ev, self._horner(i3, xs)), F.batch_inv(F.sub(xs, F.const(x_last))))
        del zb2
        self._mark("a-tree, accumulator, quotients", t0)

        m_leaves = torch.cat([self._bytes(c) for c in (p_ev, a_ev, s_ev, d1, d2, d3, b2, b3)],
                             dim=1)
        m_tree = Tree(m_leaves, "blake2s")
        m_root = m_tree.root
        k = [1] + [ts.mk_seed([m_root, bytes([i])]) % p for i in range(1, 11)]
        kc = F.consts(k)
        pw = F.consts([pow(w8, j, p) for j in range(EXTENSION)]).view(L, 1, EXTENSION)

        def kt(i, col):
            return F.mul(kc[:, i : i + 1], col)

        def kpw(i, col):
            return F.mul(kc[:, i : i + 1], F.mul(col.view(L, steps, EXTENSION), pw).view(L, N))

        l_ev = F.reduce(kt(0, d1) + kt(1, d2) + kt(2, d3) + kt(3, p_ev))
        l_ev = F.reduce(l_ev + kpw(4, p_ev) + kt(5, b2) + kpw(6, b2))
        l_ev = F.reduce(l_ev + kt(7, b3) + kpw(8, b3) + kt(9, a_ev) + kt(10, s_ev))
        del p_ev, a_ev, s_ev, d1, d2, d3, b2, b3
        l_tree = Tree(self._bytes(l_ev), self.digest)
        l_root = l_tree.root
        self._mark("m-tree, l-tree", t0)
        positions = ts.pseudorandom_indices(l_root, N, SPOT_CHECKS, skips)
        lin_branches = l_tree.branches(positions)
        aug = []
        for j in positions:
            aug += [j, (j + N - skips) % N, (j + k3 * skips) % N, (j + 2 * k3 * skips) % N]
        main_branches = m_tree.branches(aug)
        del m_tree, m_leaves
        self._mark("branches", t0)
        fri = self._fri(l_ev, xs, N // 4, skips, l_tree)
        self._mark("fri", t0)
        proof = {"m_root": list(m_root), "l_root": list(l_root), "a_root": list(a_root),
                 "main_branches": main_branches, "linear_comb_branches": lin_branches,
                 "fri_proof": fri}
        return json.dumps(proof, separators=(",", ":"))

    def _horner(self, poly: list[int], xs: torch.Tensor) -> torch.Tensor:
        F = self.F
        acc = F.const(poly[-1]).expand_as(xs)
        for c in reversed(poly[:-1]):
            acc = F.reduce(F.mul(acc, xs) + F.const(c))
        return acc

    def _fri(self, values, xs, max_deg_plus_1, exclude, tree):
        """`fri.rs:46-224`: fold by 4 at the root of the values' tree until
        at most 16 remain, then send them."""
        F, p = self.F, self.F.p
        out = []
        while max_deg_plus_1 > DIRECT_AT:
            n = values.shape[1]
            quarter = n // 4
            sx = int.from_bytes(tree.root, "little") % p
            column = self._fold(values.view(L, 4, quarter), xs.view(L, 4, quarter), sx)
            c_tree = Tree(self._bytes(column), self.digest)
            root2 = c_tree.root
            ys = ts.pseudorandom_indices(root2, quarter, FRI_QUERIES, exclude)
            out.append({"Middle": {
                "root2": list(root2),
                "column_branches": c_tree.branches(ys),
                "poly_branches": tree.branches([y + quarter * j for y in ys for j in range(4)]),
            }})
            values, tree = column, c_tree
            xs = xs[:, ::4].contiguous()
            max_deg_plus_1 //= 4
        out.append({"Last": {"last": self._bytes(values).cpu().tolist()}})
        return out

    def _fold(self, ys, xs, sx: int):
        """The degree-3 interpolant through each column's four points
        (`poly_utils.rs:449-511 multi_interp_4`), evaluated at sx."""
        F = self.F
        x = [xs[:, j] for j in range(4)]
        y = [ys[:, j] for j in range(4)]
        m = F.mul
        x01, x02, x03 = m(x[0], x[1]), m(x[0], x[2]), m(x[0], x[3])
        x12, x13, x23 = m(x[1], x[2]), m(x[1], x[3]), m(x[2], x[3])
        zero = torch.zeros_like(x[0])

        def neg(a):
            return F.reduce(F.sub(zero, F.reduce(a)))

        eqs = [
            (neg(m(x12, x[3])), F.reduce(x12 + x13 + x23), neg(x[1] + x[2] + x[3])),
            (neg(m(x02, x[3])), F.reduce(x02 + x03 + x23), neg(x[0] + x[2] + x[3])),
            (neg(m(x01, x[3])), F.reduce(x01 + x03 + x13), neg(x[0] + x[1] + x[3])),
            (neg(m(x01, x[2])), F.reduce(x01 + x02 + x12), neg(x[0] + x[1] + x[2])),
        ]
        # e_k = eq_k(x_k) = c0 + c1 x + c2 x^2 + x^3
        es = []
        for (c0, c1, c2), xk in zip(eqs, x):
            es.append(F.reduce(c0 + m(xk, F.reduce(c1 + m(xk, F.reduce(c2 + xk))))))
        q = x[0].shape[1]
        inv = F.batch_inv(torch.cat(es, dim=1))
        iy = [m(y[k], inv[:, k * q : (k + 1) * q]) for k in range(4)]
        coef = [F.reduce(sum(m(eqs[k][j], iy[k]) for k in range(4))) for j in range(3)]
        coef.append(F.reduce(iy[0] + iy[1] + iy[2] + iy[3]))
        s = F.const(sx)
        acc = coef[3]
        for c in reversed(coef[:3]):
            acc = F.reduce(m(acc, s) + c)
        return acc


def _unit(dev):
    """(10, 1) selecting the low limb: a small integer column as limbs."""
    u = torch.zeros(L, 1, dtype=torch.int64, device=dev)
    u[0] = 1
    return u
