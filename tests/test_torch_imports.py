"""The port imports nothing of the JAX package, and its own copies of the
host modules (`fields/field.py`, `protocol/params.py`,
`protocol/transcript.py`, `utils/poly_host.py`, `r1cs/reader.py`,
`r1cs/arithmetize.py`, `r1cs/synth.py`, `native/`) equal their originals on
the CPU: same inputs through both, results compared field by field or byte
for byte. Tolerance: exact equality (integers and bytes).
"""

import dataclasses
import glob
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from stark_tpu import native as jnative
from stark_tpu.fields import field as jfield
from stark_tpu.protocol import params as jparams
from stark_tpu.protocol import transcript as jts
from stark_tpu.r1cs import arithmetize as jarith
from stark_tpu.r1cs import reader as jreader
from stark_tpu.r1cs import synth as jsynth
from stark_tpu.utils import poly_host as jph
from stark_tpu_torch import native as tnative
from stark_tpu_torch.fields import field as tfield
from stark_tpu_torch.protocol import params as tparams
from stark_tpu_torch.protocol import transcript as tts
from stark_tpu_torch.r1cs import arithmetize as tarith
from stark_tpu_torch.r1cs import reader as treader
from stark_tpu_torch.r1cs import synth as tsynth
from stark_tpu_torch.utils import poly_host as tph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
FIXTURES = ["compute", "bits", "pedersen_test", "poseidon3_test"]
JSPEC, TSPEC = jfield.BN254_FR, tfield.BN254_FR


def _plain(obj):
    """Dataclasses of either package -> nested plain values, so equal
    contents compare equal across the two class hierarchies."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def _read(name: str) -> bytes:
    with open(os.path.join(FIX, name), "rb") as f:
        return f.read()


# --- nothing of the JAX package is imported ----------------------------------


def test_port_imports_nothing_of_the_jax_package():
    code = (
        "import pkgutil, importlib, sys, stark_tpu_torch\n"
        "for m in pkgutil.walk_packages(stark_tpu_torch.__path__, 'stark_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k == 'stark_tpu'\n"
        "             or k.startswith('stark_tpu.'))\n"
        "assert not bad, bad\n"
        "for name in ('serve', 'cli', 'ops.quartic', 'fri.fri', 'protocol.runner',\n"
        "             'ops.crt', 'ops.crt_cuda', 'ops.mxu_ntt'):\n"
        "    assert 'stark_tpu_torch.' + name in sys.modules, name\n"
        "print('ok', sum(k.startswith('stark_tpu_torch.') for k in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    word, count = out.stdout.split()
    assert word == "ok" and int(count) >= 30  # every module of the port was loaded


def test_port_sources_name_no_import_of_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+stark_tpu(\.|\s)", re.M)
    files = glob.glob(os.path.join(ROOT, "stark_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 25
    for path in files:
        with open(path) as f:
            hit = pattern.search(f.read())
        assert hit is None, (path, hit and hit.group(0))
    for path in files:
        with open(path) as f:
            assert re.search(r"^\s*(import|from)\s+jax\b", f.read(), re.M) is None, path


# --- fields/field.py -----------------------------------------------------------


@pytest.mark.parametrize("name", ["BN254_FR", "F7"])
def test_field_specs_equal(name):
    j, t = getattr(jfield, name), getattr(tfield, name)
    assert _plain(j) == _plain(t)
    for prop in ("bits", "num_limbs", "r_bits", "r_mod_p", "r2_mod_p", "p_limbs",
                 "two_adicity"):
        if hasattr(j, prop):
            assert getattr(j, prop) == getattr(t, prop), prop
    for n in (2, 8):
        if (j.p - 1) % n == 0:
            assert j.root_of_unity(n) == t.root_of_unity(n)
    for v in (0, 1, j.p - 1, 123456789 % j.p):
        assert j.to_bytes_le(v) == t.to_bytes_le(v)
        assert j.to_bytes_be(v) == t.to_bytes_be(v)
    raw = bytes(range(40))
    assert j.from_bytes_le(raw) == t.from_bytes_le(raw)
    assert j.from_bytes_be(raw) == t.from_bytes_be(raw)


def test_field_module_helpers_equal():
    assert (jfield.LIMB_BITS, jfield.LIMB_MASK) == (tfield.LIMB_BITS, tfield.LIMB_MASK)
    for v in (0, 1, JSPEC.p - 1, JSPEC.r_mod_p):
        assert jfield.int_to_limbs(v, 16) == tfield.int_to_limbs(v, 16)
    assert JSPEC.root_of_unity(1 << 20) == TSPEC.root_of_unity(1 << 20)
    assert JSPEC.inv(12345) == TSPEC.inv(12345)


# --- protocol/params.py ----------------------------------------------------------


def test_params_constants_equal():
    for name in ("SPOT_CHECK_SECURITY_FACTOR", "EXTENSION_FACTOR"):
        if hasattr(jparams, name):
            assert getattr(jparams, name) == getattr(tparams, name)


@pytest.mark.parametrize("original_steps", [3, 6, 24, 3 * 85, 3 * 86, 3 * 1300, 3 * 43690])
def test_derive_params_equal(original_steps):
    assert _plain(jparams.derive_params(JSPEC, original_steps)) == \
        _plain(tparams.derive_params(TSPEC, original_steps))


# --- r1cs/reader.py ---------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_readers_equal(name):
    r1cs, wtns = _read(f"{name}.r1cs"), _read(f"{name}.wtns")
    assert _plain(jreader.read_r1cs(r1cs)) == _plain(treader.read_r1cs(r1cs))
    assert jreader.read_witness(wtns) == treader.read_witness(wtns)


# --- r1cs/arithmetize.py and r1cs/synth.py ------------------------------------------


def _circuit(which: str, mod_reader, mod_synth):
    if which == "compute":
        r1cs = mod_reader.read_r1cs(_read("compute.r1cs"))
        return r1cs, mod_reader.read_witness(_read("compute.wtns"))
    if which == "squaring_chain(50)":
        return mod_synth.squaring_chain(50)
    return mod_synth.ragged_mix(120)


@pytest.mark.parametrize("which", ["compute", "squaring_chain(50)", "ragged_mix(120)"])
def test_arithmetize_equal(which):
    jr, jw = _circuit(which, jreader, jsynth)
    tr, tw = _circuit(which, treader, tsynth)
    assert _plain(jr) == _plain(tr) and jw == tw  # the generators agree byte for byte
    h = jr.header
    n_pub = 1 + h.n_public_inputs + h.n_public_outputs
    for with_witness in (True, False):
        ja = jarith.arithmetize(
            JSPEC, jr.constraints,
            [JSPEC.from_bytes_le(w) for w in jw] if with_witness else None,
            h.n_wires, n_pub)
        ta = tarith.arithmetize(
            TSPEC, tr.constraints,
            [TSPEC.from_bytes_le(w) for w in tw] if with_witness else None,
            h.n_wires, n_pub)
        assert _plain(ja) == _plain(ta)
    jflat, tflat = jnative.flat_from_contents(jr), tnative.flat_from_contents(tr)
    assert _plain(jflat) == _plain(tflat)
    assert np.array_equal(
        jarith.slot_wire_ids_np(jflat.ncoeffs, jflat.wire_ids, jflat.n_wires),
        tarith.slot_wire_ids_np(tflat.ncoeffs, tflat.wire_ids, tflat.n_wires))


def test_native_library_equal_when_built():
    """The port's bindings build the same source into their own cache; where
    no g++ exists both report unavailable and the pure-Python path runs."""
    assert jnative.available() == tnative.available()
    if not tnative.available():
        pytest.skip("no g++: both packages fall back to the pure-Python arithmetizer")
    assert os.path.join("stark_tpu_torch", "_build") in tnative._lib()._name
    data = bytes(range(200))
    assert tnative.blake2s(data) == jnative.blake2s(data) == hashlib.blake2s(data).digest()
    r1cs = _read("compute.r1cs")
    jr, tr = jreader.read_r1cs(r1cs), treader.read_r1cs(r1cs)
    prime = JSPEC.p.to_bytes(32, "little")
    ja = jnative.arithmetize_flat(jnative.flat_from_contents(jr), None, prime, 2)
    ta = tnative.arithmetize_flat(tnative.flat_from_contents(tr), None, prime, 2)
    assert _plain(ja) == _plain(ta)


# --- protocol/transcript.py ----------------------------------------------------------

SEEDS = [hashlib.blake2s(bytes([i])).digest() for i in range(3)]


@pytest.mark.parametrize("seed", SEEDS, ids=range(len(SEEDS)))
def test_transcript_equal(seed):
    assert jts.blake(seed) == tts.blake(seed)
    for modulus, count, excl in [(2048, 80, 8), (65536, 40, 8), (7, 5, 0), (2**20, 24, 0)]:
        assert jts.get_pseudorandom_indices(seed, modulus, count, excl) == \
            tts.get_pseudorandom_indices(seed, modulus, count, excl)
    assert jts.get_random_ff_values(JSPEC, seed, 2**20, 3) == \
        tts.get_random_ff_values(TSPEC, seed, 2**20, 3)
    assert jts.seed_to_field(JSPEC, [seed, b"\x01"]) == tts.seed_to_field(TSPEC, [seed, b"\x01"])
    assert jts.mk_seed([seed, b"abc"]) == tts.mk_seed([seed, b"abc"])


# --- utils/poly_host.py ----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_poly_host_equal(n):
    rng = np.random.default_rng(100 + n)
    xs = [int.from_bytes(rng.bytes(32), "little") % JSPEC.p for _ in range(n)]
    ys = [int.from_bytes(rng.bytes(32), "little") % JSPEC.p for _ in range(n)]
    jc, tc = jph.lagrange_interp(JSPEC, xs, ys), tph.lagrange_interp(TSPEC, xs, ys)
    assert jc == tc
    at = int.from_bytes(rng.bytes(32), "little") % JSPEC.p
    assert jph.eval_poly_at(JSPEC, jc, at) == tph.eval_poly_at(TSPEC, tc, at)
    assert [tph.eval_poly_at(TSPEC, tc, x) for x in xs] == ys


# --- ops/crt.py and ops/mxu_ntt.py: the host functions of the CRT engine -------------


def test_crt_host_functions_equal():
    """The port's own copies of the CRT engine's host code give what the JAX
    package's give: primes, digits, fold counts, residues and byte rows of
    python ints, power matrices and twiddle residues."""
    from stark_tpu.ops import crt as jcrt
    from stark_tpu.ops import mxu_ntt as jmxu
    from stark_tpu_torch.ops import crt as tcrt
    from stark_tpu_torch.ops import mxu_ntt as tmxu

    for name in ("QBITS", "QBASE", "CHUNK", "R256", "ND"):
        assert getattr(jcrt, name) == getattr(tcrt, name), name
    for bits in (100, 520, 774):
        assert jcrt.select_primes(bits) == tcrt.select_primes(bits)
    for v, base, n in ((0, 256, 4), (JSPEC.p - 1, 256, 35), (12345, 128, 3)):
        assert jcrt._balanced_digits(v, base, n) == tcrt._balanced_digits(v, base, n)
    for bound in (16, 27, 30, 32):
        assert jcrt._fold_count(bound, 10) == tcrt._fold_count(bound, 10)
    with pytest.raises(ValueError):
        tcrt._fold_count(32, 14)
    rng = np.random.default_rng(21)
    vals = [0, 1, JSPEC.p - 1] + [int.from_bytes(rng.bytes(32), "little") % JSPEC.p
                                  for _ in range(5)]
    jby, tby = jcrt.ints_to_bytes_np(vals), tcrt.ints_to_bytes_np(vals)
    assert np.array_equal(jby, tby)
    qs = tcrt.select_primes(100)
    assert np.array_equal(jcrt.residues_of_ints_np(jby, qs), tcrt.residues_of_ints_np(tby, qs))
    p, w = JSPEC.p, JSPEC.root_of_unity(64)
    assert jmxu._pow_matrix(w, 4, 5, p, scale=7) == tmxu._pow_matrix(w, 4, 5, p, scale=7)
    assert np.array_equal(jmxu._twiddle_residues(w, 8, 4, p, qs).astype(np.int64),
                          tmxu._twiddle_residues(w, 8, 4, p, qs).astype(np.int64))
    assert np.array_equal(jmxu._twiddle_mid_residues(w, 4, 16, 4, p, qs).astype(np.int64),
                          tmxu._twiddle_mid_residues(w, 4, 16, p, qs).astype(np.int64))


def test_port_reads_no_environment_variable_to_choose_a_route():
    """No module of the port reads the environment: the LDE engine, the fold
    route, the device and the plan cache's directory are arguments."""
    files = glob.glob(os.path.join(ROOT, "stark_tpu_torch", "**", "*.py"), recursive=True)
    assert len(files) > 28
    for path in files:
        with open(path) as f:
            text = f.read()
        assert "os.environ" not in text and "getenv" not in text, path
