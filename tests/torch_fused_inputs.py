"""Inputs and comparisons shared by the `test_torch_fused*.py` files: the
same numpy-seeded Montgomery planes go to the JAX package as uint32 arrays
and to the port as int32 CPU tensors; results must be bit-identical."""

import numpy as np

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy

N = 16
EDGE = [0, spec.p - 1, 1]


def cols(seed: int, width: int = N, count: int = 1, edge: bool = False):
    """`count` (16, width) Montgomery planes from a numpy seed; with `edge`
    the first values are 0, p - 1 and 1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        vals = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(width)]
        if edge:
            vals[: min(width, len(EDGE))] = EDGE[:width]
        out.append(np.asarray(jmm.to_mont(spec, jmm.ints_to_limbs_np(vals, spec))))
    return out


def t(a):
    return planes_from_numpy(np.asarray(a), "cpu")


def eq(port, jax_arr):
    assert np.array_equal(planes_to_numpy(port), np.asarray(jax_arr))


def no_launch(wrapper, *args):
    """Call a wrapper on CPU tensors: it must run its plain version and
    leave its launch counter alone."""
    before = wrapper.launches
    out = wrapper(tspec, *args)
    assert wrapper.launches == before
    return out
