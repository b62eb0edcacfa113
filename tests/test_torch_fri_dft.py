"""FRI's fold on its radix-4 inverse-DFT route, `fused_kernels.fri_fold_dft`,
on the CPU.

* Its plain version from the previous tree's root words equals the JAX
  package's special_x (`device_transcript.digest_le_int_mont`) followed by
  its composed fold (`fri._fold_j` on the default route), and python-int
  interpolation row by row, at every round's shape of a recursion from
  n = 4,096 down to a last round of 4 rows and at n = 4, with seeded root
  words, the all-ones words (2^256 - 1, at least p before the reduction)
  and the zero root; the whole domain's power table read at the round's
  stride gives what the round's own table gives.
* The wrapper refuses a wrong dtype, shape, a non-contiguous plane, a
  mismatched device and, on the card's route (`meta` tensors, which pass
  the CPU's branch and stop at "no kernel for device meta"), a field that
  is not a 16-limb one; on the CPU it runs the plain version and counts no
  launch.
* The whole recursion on the default route, over the whole domain's table
  in every round, equals the Lagrange route's, and the `compute` proof on
  the default route equals the committed golden.

Inputs come from a numpy seed. Tolerance: exact equality (integer field
arithmetic with canonical outputs).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.fri import fri as jfri
from stark_tpu.ops import modmath as jmm
from stark_tpu.protocol import device_transcript as jdt
from stark_tpu_torch.fields.field import BN254_FR as tspec, F7
from stark_tpu_torch.fri import fri
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import fused_kernels as fk
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.protocol.core import leaves_to_words
from torch_fused_inputs import cols, eq, no_launch, t as _t

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = 4096  # the recursion's first domain
ALL_ONES = [-1] * 8  # 2^256 - 1


def _root(seed):
    """(8,) int32 root words: seeded, or the given list."""
    if isinstance(seed, list):
        return torch.tensor(seed, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 32, 8, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))


def _int(root) -> int:
    return int.from_bytes(root.numpy().astype("<i4").tobytes(), "little")


def _interp(values, xs, sx: int):
    """Python ints: each row's degree-3 interpolant through its four points
    at sx, Montgomery in and out."""
    p, R = spec.p, 1 << 256
    rinv = pow(R, -1, p)
    n = values.shape[1]
    q = n // 4
    v = [x * rinv % p for x in _ints(values)]
    x = [y * rinv % p for y in _ints(xs)]
    out = []
    for i in range(q):
        pts = [(x[j * q + i], v[j * q + i]) for j in range(4)]
        acc = 0
        for j, (xj, yj) in enumerate(pts):
            num = den = 1
            for k, (xk, _) in enumerate(pts):
                if k != j:
                    num = num * (sx - xk) % p
                    den = den * (xj - xk) % p
            acc = (acc + yj * num * pow(den, -1, p)) % p
        out.append(acc * R % p)
    return out


def _ints(planes):
    limbs = planes.numpy().astype(np.int64) & 0xFFFF
    return [sum(int(limbs[k, i]) << (16 * k) for k in range(limbs.shape[0]))
            for i in range(limbs.shape[1])]


@pytest.fixture(scope="module")
def domain():
    """The order-FULL domain's power table, port and JAX."""
    w = spec.root_of_unity(FULL)
    return mm.power_table(tspec, w, FULL, "cpu"), w


@pytest.mark.parametrize("n,root", [(4096, 0), (1024, ALL_ONES), (256, 2), (64, 3),
                                    (16, ALL_ONES), (4, [0] * 8)])
def test_plain_matches_jax_and_python_ints(domain, n, root):
    xs_full, w = domain
    values = _t(cols(n, width=n, edge=True)[0])
    root = _root(root)
    stride = FULL // n
    got = no_launch(fk.fri_fold_dft, root, values, xs_full)
    # the round's own table gives the same column
    assert torch.equal(got, fk.fri_fold_dft_plain(tspec, root, values,
                                                  xs_full[:, ::stride].contiguous()))
    jxs = jmm.power_table(spec, pow(w, stride, spec.p), n)
    sx = jdt.digest_le_int_mont(spec, jnp.asarray(root.numpy().view(np.uint32)))
    want = jfri._fold_j(spec, jnp.asarray(values.numpy().view(np.uint32)), jxs,
                        sx[:, :, None])
    eq(got, want)
    if n <= 256:
        assert _ints(got) == _interp(values, xs_full[:, ::stride], _int(root) % spec.p)


def _bad_calls(device, other):
    zeros = lambda *shape, dev=device: torch.zeros(*shape, dtype=torch.int32, device=dev)
    v, xs, root = zeros(16, 16), zeros(16, 64), zeros(8)
    return {
        "dtype": ((TypeError, "int32"), (root, v.long(), xs)),
        "root dtype": ((TypeError, "int32"), (root.long(), v, xs)),
        "limbs": ((ValueError, r"\(16, n\)"), (root, v[:8], xs)),
        "width": ((ValueError, "4 \\| n"), (root, v[:, :6].contiguous(), xs)),
        "xs width": ((ValueError, "k\\*n"), (root, v, xs[:, :40].contiguous())),
        "root shape": ((ValueError, r"\(8,\)"), (root[:4], v, xs)),
        "view": ((ValueError, "contiguous"), (root, v.t().contiguous().t(), xs)),
        "root view": ((ValueError, "contiguous"), (zeros(16)[::2], v, xs)),
        "planes' devices": ((ValueError, "one device"), (root, v, zeros(16, 64, dev=other))),
        "root's device": ((ValueError, "device"), (zeros(8, dev=other), v, xs)),
    }


@pytest.mark.parametrize("device,other", [("cpu", "meta"), ("meta", "cpu")])
@pytest.mark.parametrize("what", list(_bad_calls("cpu", "meta")))
def test_wrapper_refuses(device, other, what):
    (exc, match), args = _bad_calls(device, other)[what]
    before = fk.fri_fold_dft.launches
    with pytest.raises(exc, match=match):
        fk.fri_fold_dft(tspec, *args)
    assert fk.fri_fold_dft.launches == before


def test_card_route_takes_no_other_field():
    """On a device that is not the CPU the wrapper launches or raises: a
    16-limb field reaches the launch (and meta has no kernel), F7 is refused
    before it."""
    root = torch.zeros(8, dtype=torch.int32, device="meta")
    planes = lambda L, n: torch.zeros(L, n, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fk.fri_fold_dft(tspec, root, planes(16, 16), planes(16, 64))
    with pytest.raises(NotImplementedError, match="16-limb"):
        fk.fri_fold_dft(F7, root, planes(F7.num_limbs, 16), planes(F7.num_limbs, 64))


def test_recursion_on_both_routes(domain):
    """The recursion over 1,024 values with max degree 1,024 (rounds of 256,
    64 and 16 rows) on the default route equals the Lagrange route's, and
    on the CPU counts no launch."""
    n = FULL // 4
    xs = domain[0][:, ::4].contiguous()
    values = _t(cols(11, width=n)[0])
    words = leaves_to_words(tspec, [values])
    tree = mt.DeviceMerkleTree(words, 32, mt.build_layers(words, 32))
    before = fk.fri_fold_dft.launches
    proofs = {}
    for route in fri.FOLD_ROUTES:
        pending = fri.prove_low_degree_pending(tspec, values, xs, n, 0, tree, fri_fold=route)
        proofs[route] = fri.assemble_fri(
            tspec, pending, fri.materialize_u32(pending["device_arrays"]))
    assert fk.fri_fold_dft.launches == before
    assert len(proofs["dft"]) == fri.n_rounds(n) + 1 == 4
    assert len(proofs["dft"][-1].last) == 16
    assert repr(proofs["dft"]) == repr(proofs["lagrange"])


def test_compute_proof_equals_golden():
    def read(name, mode="rb"):
        with open(os.path.join(ROOT, "tests", "fixtures", name), mode) as f:
            return f.read()

    r1cs = runner.read_r1cs(read("compute.r1cs"))
    witness = runner.read_witness(read("compute.wtns"))
    proof = runner.prove_with_witness(r1cs, witness, device="cpu", fri_fold="dft")
    assert proof_mod.to_json(proof) == read("compute_proof_golden.json", "r")
