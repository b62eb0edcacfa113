"""The port's NTT plan and butterflies against `stark_tpu.ops.ntt` on the CPU.

The port runs the Pallas-shaped plan everywhere (single stages for
2l > block, one fused run for the rest); here its plain PyTorch butterflies
are held against the JAX package's XLA cores `_dif_core` / `_dit_core` at
n = 2^6, 2^9 and 2^12 with two block sizes, so that both the singles and the
fused run execute, and the port's `lde` against `ntt.lde`. Inputs come from
a numpy seed. Tolerance: exact equality (integer field arithmetic,
canonical outputs, Shoup twiddles off).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import ntt as jntt
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.ops import ntt

torch.set_num_threads(2)

SIZES = [1 << 6, 1 << 9, 1 << 12]
BLOCKS = [16, 256]


def _random_mont(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n)]
    return np.asarray(jmm.to_mont(spec, jmm.ints_to_limbs_np(vals, spec)))


@functools.lru_cache(maxsize=None)
def _jax_case(n: int, kind: str):
    """(input, JAX output) for one size and direction, computed once."""
    root = spec.root_of_unity(n)
    w_half = jmm.power_table(spec, root, n // 2)
    core = jntt._dif_core if kind == "dif" else jntt._dit_core
    x = _random_mont(n, seed=n + (kind == "dit"))
    return x, np.asarray(jax.jit(lambda a, w: core(spec, a, w))(x, w_half))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("kind", ["dif", "dit"])
@pytest.mark.parametrize("n", SIZES)
def test_plan_matches_jax_core(n, kind, block):
    x, want = _jax_case(n, kind)
    plan = ntt.NttPlan(tspec, spec.root_of_unity(n), n, kind, "cpu", block=block)
    assert plan.block == min(n, block)
    if n > block:
        assert plan.singles and plan.fused_tw is not None  # both paths run
    got = ntt.run(tspec, planes_from_numpy(x, "cpu"), plan)
    assert np.array_equal(planes_to_numpy(got), want)


def test_split_does_not_change_values():
    n = 1 << 10
    x = planes_from_numpy(_random_mont(n, seed=3), "cpu")
    outs = [
        planes_to_numpy(ntt.run(tspec, x, ntt.NttPlan(tspec, spec.root_of_unity(n), n,
                                                     "dit", "cpu", block=b)))
        for b in (2, 32, n)
    ]
    assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[1], outs[2])


def test_stage_tables_match_jax_power_table():
    n = 1 << 9
    root = spec.root_of_unity(n)
    w_half = np.asarray(jmm.power_table(spec, root, n // 2))
    plan = ntt.NttPlan(tspec, root, n, "dit", "cpu", block=16)
    for m, l, tw in plan.singles:
        assert np.array_equal(planes_to_numpy(tw), w_half[:, ::m][:, :l])
    # fused tables: stage l at columns l-1 .. 2l-2
    cat = planes_to_numpy(plan.fused_tw)
    for l in ntt.fused_ls(16, "dit"):
        assert np.array_equal(cat[:, l - 1 : 2 * l - 1], w_half[:, :: n // (2 * l)][:, :l])


def test_wrappers_check_shapes():
    x = planes_from_numpy(_random_mont(64, seed=4), "cpu")
    tw = x[:, :8].contiguous()
    with pytest.raises(ValueError):
        ntt.butterfly_stage(tspec, x, tw, 4, 16, "dit")  # tw too narrow
    with pytest.raises(ValueError):
        ntt.butterfly_fused(tspec, x, tw, 24, "dit")  # block not a power of 2
    with pytest.raises(ValueError):
        ntt.butterfly_stage(tspec, x, x[:, :32].contiguous(), 1, 32, "fft")


@pytest.mark.parametrize("block", [16, 2048])
def test_lde_matches_jax(block):
    steps, precision = 64, 512
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    trace = _random_mont(steps, seed=5)
    want = _jax_lde(steps, precision, trace.tobytes())
    plan = ntt.make_lde_plan(tspec, g1, g2, steps, precision, "cpu", block=block)
    got = ntt.lde(tspec, planes_from_numpy(trace, "cpu"), plan)
    assert np.array_equal(planes_to_numpy(got), want)


@functools.lru_cache(maxsize=None)
def _jax_lde(steps, precision, trace_bytes):
    trace = np.frombuffer(trace_bytes, np.uint32).reshape(16, steps)
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    plan = jntt.make_lde_plan(spec, g1, g2, steps, precision)
    return np.asarray(jax.jit(lambda t, pl: jntt.lde(spec, t, pl))(trace, plan))
