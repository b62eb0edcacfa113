"""The file-path entry points on the native route (`.r1cs` and `.wtns` read
by the C++ readers of the host library straight into the flat circuit and
the witness rows) against the JAX package and against the Python route, on
the CPU.

* the flat static arithmetization and the witness rows equal, array for
  array, the JAX package's `_arith_native` over its own `read_r1cs_flat`
  and `read_witness_flat` (numpy and C++, no compile) on the four fixtures
  and on `squaring_chain(300)` and `ragged_mix(120)` written as files; the
  public wires equal the Python route's;
* the native route proves `compute` to the committed golden through the
  worker (`run`, then a `verify`), and the Python route, forced by
  monkeypatching `native.available`, through the CLI's `run`: the
  counterpart of `tests/test_e2e.py::test_native_path_proof_identical`,
  which holds the JAX package's two routes to the same bytes. These are the
  file's two whole proves. Every other entry point (the CLI's `prove` and
  `run`, the three `*_with_file_path` functions, the worker's `prove`) on
  each route is held to hand the prover, and the verifier, the inputs of
  the JAX package's native route, with the prover and the verifier
  stubbed: the proof is a function of those inputs;
* `cli warmup` returns 0 and prints its count;
* both routes refuse the same files with `ValueError` before any device
  work: field sizes, wire counts, wire 0, the prime, a wire id past the
  circuit's wires (checked ahead of the pure-Python arithmetizer on the
  route without the host library), bad magics, truncated files;
* the JAX package's runner pads a witness list one wire short with a zero
  row, which the port's `prove_with_witness` and `prove_many` refuse;
* the JAX package's Python readers take three of those files (a truncated
  `.wtns`, a field size other than 32 in either file), which its C++
  readers and both of the port's refuse (ROADMAP.md Queue 3);
* `synth.write_circuit_files` round-trips the four fixtures through both
  readers and writes the identity label map.

Tolerance: exact (bytes and integers).
"""

import dataclasses
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from stark_tpu import native as jnative
from stark_tpu.fields.field import BN254_FR as JSPEC
from stark_tpu.protocol import runner as jrunner
from stark_tpu_torch import cli, native, serve
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness
from stark_tpu_torch.r1cs.synth import ragged_mix, squaring_chain, write_circuit_files

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
FIXTURES = ["compute", "bits", "pedersen_test", "poseidon3_test"]
R1CS = os.path.join(FIX, "compute.r1cs")
WTNS = os.path.join(FIX, "compute.wtns")
ARRAYS = ("coefficients", "flag0", "flag1", "flag2", "permuted_indices",
          "last_coeff_list", "slot_wire_ids")

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no g++: the host library, and so the native route, "
    "cannot be built")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _ints(column):
    """A trace column as python ints: (N, 32) LE rows (the C++
    arithmetizer's) or a flat sequence (the Python one's)."""
    a = np.asarray(column)
    if a.ndim == 2:
        return [int.from_bytes(row.tobytes(), "little") for row in a]
    return [int(v) for v in a]


@pytest.fixture
def python_route(monkeypatch):
    """The route taken where the host library has not built."""
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(FIX, "compute_proof_golden.json")) as f:
        return f.read()


@pytest.fixture(scope="module")
def circuit_files(tmp_path_factory):
    """name -> (.r1cs path, .wtns path): the fixtures, and two synthetic
    circuits written as files."""
    files = {name: (os.path.join(FIX, f"{name}.r1cs"), os.path.join(FIX, f"{name}.wtns"))
             for name in FIXTURES}
    tmp = tmp_path_factory.mktemp("synth")
    for name, (r1cs, witness) in (("squaring_chain(300)", squaring_chain(300)),
                                  ("ragged_mix(120)", ragged_mix(120))):
        paths = (str(tmp / f"{len(files)}.r1cs"), str(tmp / f"{len(files)}.wtns"))
        write_circuit_files(r1cs, witness, *paths)
        files[name] = paths
    return files


def _jax_inputs(r1cs_path, wtns_path):
    """The JAX package's native route: its `_arith_native` of the flat
    circuit with the witness rows attached, and its public wires."""
    flat = jnative.read_r1cs_flat(_read(r1cs_path))
    rows = jnative.read_witness_flat(_read(wtns_path))
    n_pub = 1 + flat.n_public_inputs + flat.n_public_outputs
    arith = jrunner._arith_native(JSPEC, flat, rows, n_pub)
    public = [int.from_bytes(rows[i].tobytes(), "little") % JSPEC.p for i in range(n_pub)]
    return arith, rows, public, flat


# --- the arithmetization and the rows against the JAX package -----------------------


@pytest.mark.parametrize("name", FIXTURES + ["squaring_chain(300)", "ragged_mix(120)"])
def test_flat_arith_and_rows_equal_the_jax_native_route(circuit_files, name):
    r1cs_path, wtns_path = circuit_files[name]
    jarith, jrows, jpublic, jflat = _jax_inputs(r1cs_path, wtns_path)
    assert jarith.witness_trace is None and jarith.witness_le is jrows  # device arithmetization

    flat = runner.read_circuit(r1cs_path)
    assert isinstance(flat, native.FlatR1cs)
    rows = runner.read_witness_rows(wtns_path, flat)
    spec = runner._spec_for(flat)
    arith = runner._static_arith(spec, flat)
    assert runner._static_arith(spec, flat) is arith  # cached on the flat circuit
    for key in ARRAYS:
        want, got = getattr(jarith, key), getattr(arith, key)
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    assert arith.public_first_indices == jarith.public_first_indices
    assert rows.dtype == np.uint8 and np.array_equal(rows, jrows)
    assert runner._public_wires(spec, flat, rows) == jpublic

    # the Python route: the same rows and public wires, and the same
    # arithmetization through the parsed tree (C++ arithmetizer)
    tree = read_r1cs(_read(r1cs_path))
    witness = read_witness(_read(wtns_path))
    assert np.array_equal(runner._witness_rows(tree, witness), rows)
    assert runner._public_wires(spec, tree, witness) == jpublic
    tree_arith = runner._static_arith(spec, tree)
    for key in ARRAYS:
        assert np.array_equal(getattr(tree_arith, key), getattr(arith, key)), key
    assert dataclasses.asdict(native.flat_from_contents(tree)).keys() == \
        dataclasses.asdict(flat).keys()


# --- whole proves: the native route and the Python route give the golden ------------


def _drive(requests, **kwargs):
    out = io.StringIO()
    lines = "".join(json.dumps(r) + "\n" for r in requests)
    assert serve.serve(io.StringIO(lines), out, **kwargs) == 0
    replies = [json.loads(line[4:]) for line in out.getvalue().splitlines()]
    return {r["id"]: r for r in replies[1:]}


def test_worker_proves_the_golden_on_the_native_route(golden, tmp_path):
    pj = str(tmp_path / "proof.json")
    files = {"r1cs": R1CS, "wtns": WTNS}
    by_id = _drive([
        {"id": 1, "method": "warmup", "params": {"r1cs": R1CS}},
        {"id": 2, "method": "run", "params": {**files, "proof_json": pj, "inline": True}},
        {"id": 3, "method": "verify", "params": {**files, "proof_json": pj}},
    ], device="cpu")
    assert by_id[1]["result"]["steps"] == 16
    assert by_id[2]["result"]["proof"] == golden and by_id[2]["result"]["verified"] is True
    with open(pj) as f:
        assert f.read() == golden
    assert by_id[3]["result"]["verified"] is True


def test_cli_run_proves_the_golden_on_the_python_route(python_route, golden, tmp_path,
                                                        capsys):
    pj = str(tmp_path / "proof.json")
    assert cli.main(["run", R1CS, WTNS, pj, "--device", "cpu"]) == 0
    with open(pj) as f:
        assert f.read() == golden
    assert "Done proof verification" in capsys.readouterr().out


# --- every entry point hands the prover and the verifier the same inputs ------------


class _Stubs:
    """Stand-ins for the prover and the verifier that record what reaches
    them: the prover answers with the golden proof, the verifier accepts."""

    def __init__(self, monkeypatch, golden):
        self.proves, self.verifies = [], []
        proof = proof_mod.from_json(golden)

        def prove(spec, arith, public_wires, n_constraints, n_wires, **kw):
            self.proves.append({
                **{key: _ints(getattr(arith, key)) for key in ARRAYS},
                "public_first_indices": list(arith.public_first_indices),
                "witness_le": np.array(arith.witness_le),
                "public": public_wires, "sizes": (n_constraints, n_wires), **kw})
            return proof

        def verify(spec, proof_, public_wires, pfi, perm, k, f0, f1, f2, n_constraints,
                   n_wires, **kw):
            self.verifies.append({
                "coefficients": _ints(k), "flag0": _ints(f0), "flag1": _ints(f1),
                "flag2": _ints(f2), "permuted_indices": _ints(perm),
                "public_first_indices": list(pfi), "public": public_wires,
                "sizes": (n_constraints, n_wires), "proof": proof_mod.to_json(proof_)})
            return True

        monkeypatch.setattr(runner, "mk_r1cs_proof", prove)
        monkeypatch.setattr(runner, "verify_r1cs_proof", verify)


def _expected(golden):
    jarith, jrows, jpublic, jflat = _jax_inputs(R1CS, WTNS)
    arrays = {key: _ints(getattr(jarith, key)) for key in ARRAYS}
    arrays["public_first_indices"] = list(jarith.public_first_indices)
    return arrays, jrows, jpublic, (jflat.n_constraints, jflat.n_wires)


ENTRIES = ["cli prove", "cli run", "cli verify", "prove_with_file_path",
           "run_with_file_path", "verify_with_file_path", "worker prove", "worker run",
           "worker verify"]


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_hand_on_the_jax_native_inputs(entry, route, golden, tmp_path,
                                                     monkeypatch, capsys):
    if route == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    stubs = _Stubs(monkeypatch, golden)
    pj = str(tmp_path / "proof.json")
    verifies_only = entry.endswith("verify") or entry.startswith("verify")
    if verifies_only:
        with open(pj, "w") as f:
            f.write(golden)
    kw = {"digest": "poseidon", "device": "cpu", "lde_engine": "crt"}
    if entry.startswith("cli"):
        cmd = entry.split()[1]
        assert cli.main([cmd, R1CS, WTNS, pj, "--device", "cpu", "--digest", "poseidon",
                         "--lde-engine", "crt"]) == 0
        assert capsys.readouterr().out.splitlines()[-1].startswith(f"{cmd}: ")
    elif entry.startswith("worker"):
        method = entry.split()[1]
        by_id = _drive([{"id": 1, "method": method,
                         "params": {"r1cs": R1CS, "wtns": WTNS, "proof_json": pj,
                                    "digest": "poseidon"}}],
                       device="cpu", lde_engine="crt")
        assert by_id[1]["result"]["ok"] is True
    else:
        getattr(runner, entry)(R1CS, WTNS, pj, **kw)
    with open(pj) as f:
        assert f.read() == golden

    arrays, rows, public, sizes = _expected(golden)
    want_proves = 0 if verifies_only else 1
    runs = entry.endswith("run") or entry.startswith("run")
    want_verifies = 1 if runs or verifies_only else 0
    assert (len(stubs.proves), len(stubs.verifies)) == (want_proves, want_verifies)
    for got in stubs.proves:
        assert {key: got[key] for key in arrays} == arrays
        assert np.array_equal(got["witness_le"], rows)
        assert got["public"] == public and got["sizes"] == sizes
        assert got["digest"] == "poseidon" and got["lde_engine"] == "crt"
        assert got["mesh"] is None and str(got["device"]) == "cpu"
    for got in stubs.verifies:
        assert {key: got[key] for key in arrays if key in got} == \
            {key: arrays[key] for key in arrays if key in got}
        assert got["public"] == public and got["sizes"] == sizes
        assert got["proof"] == golden


def test_run_reads_each_file_once_and_shares_the_circuit(golden, tmp_path, monkeypatch):
    stubs = _Stubs(monkeypatch, golden)
    reads, circuits = [], []
    real_read, real_static = runner._read, runner._static_arith
    monkeypatch.setattr(runner, "_read", lambda path: reads.append(path) or real_read(path))
    monkeypatch.setattr(runner, "_static_arith",
                        lambda spec, c: circuits.append(c) or real_static(spec, c))
    runner.run_with_file_path(R1CS, WTNS, str(tmp_path / "p.json"), device="cpu")
    assert reads == [R1CS, WTNS]
    assert len(circuits) == 2 and circuits[0] is circuits[1]
    assert isinstance(circuits[0], native.FlatR1cs)
    assert len(stubs.proves) == len(stubs.verifies) == 1


# --- the CLI's warmup -----------------------------------------------------------------


def test_cli_warmup(capsys):
    assert cli.main(["warmup", R1CS, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("warmed ") and lines[0].endswith(" stages (steps=16)")
    assert int(lines[0].split()[1]) > 0
    assert lines[1].startswith("warmup: ") and lines[1].endswith("s")
    with pytest.raises(SystemExit):  # it takes no witness
        cli.main(["warmup", R1CS, WTNS, "--device", "cpu"])


# --- refusals: both routes, the same files ------------------------------------------


def _chain_files(tmp_path, n_wires=None, witness_delta=0, field_size=32, prime=None,
                 wire0=1):
    """squaring_chain(6) as files, with one thing changed."""
    r1cs, witness = squaring_chain(6)
    h = r1cs.header
    if n_wires is not None:
        h.n_wires = h.n_labels = n_wires
    if prime is not None:
        h.prime_number = prime
    if witness_delta < 0:
        witness = witness[:witness_delta]
    elif witness_delta > 0:
        witness = witness + [b"\x05"] * witness_delta
    witness = [wire0.to_bytes(1, "little")] + witness[1:]
    paths = str(tmp_path / "c.r1cs"), str(tmp_path / "c.wtns")
    write_circuit_files(r1cs, witness, *paths)
    if field_size != 32:
        # the same values as wider field elements, the prime padded to them
        wide = dataclasses.replace(h, field_size=field_size,
                                   prime_number=h.prime_number.ljust(field_size, b"\0"))
        write_circuit_files(dataclasses.replace(r1cs, header=wide), witness,
                            str(tmp_path / "wide.r1cs"), paths[1])
    return paths


def _patched(path, offset, data):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[offset:offset + len(data)] = data
    with open(path, "wb") as f:
        f.write(bytes(raw))


def _truncated(path, keep):
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:keep(len(raw))])


def _bad_files(case, tmp_path):
    if case == "fewer wires":
        return _chain_files(tmp_path, witness_delta=-1)
    if case == "more wires":
        return _chain_files(tmp_path, witness_delta=1)
    if case == "wire 0":
        return _chain_files(tmp_path, wire0=2)
    if case == "prime":
        return _chain_files(tmp_path, prime=(7).to_bytes(32, "little"))
    if case == "wtns field size":
        return _chain_files(tmp_path, field_size=48)
    if case == "wire id past the wires":
        # the last wire dropped from the header and the witness: the chain's
        # last constraint still names it
        return _chain_files(tmp_path, n_wires=7, witness_delta=-1)
    paths = _chain_files(tmp_path)
    if case == "r1cs field size":
        _patched(paths[0], 24, struct.pack("<I", 48))
    elif case == "r1cs magic":
        _patched(paths[0], 0, b"R1CS")
    elif case == "wtns magic":
        _patched(paths[1], 0, b"WTNS")
    elif case == "r1cs truncated":
        _truncated(paths[0], lambda n: n - 8 * 8 - 12 - 20)  # inside the last constraint
    elif case == "wtns truncated":
        _truncated(paths[1], lambda n: n - 1)
    return paths


REFUSED = ["fewer wires", "more wires", "wire 0", "prime", "wtns field size",
           "r1cs field size", "r1cs magic", "wtns magic", "r1cs truncated",
           "wtns truncated", "wire id past the wires"]


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("entry", ["prove", "verify"])
@pytest.mark.parametrize("case", REFUSED)
def test_both_routes_refuse_the_same_files(case, entry, route, golden, tmp_path,
                                           monkeypatch):
    if route == "python":
        monkeypatch.setattr(native, "available", lambda: False)

    def no_device_work(*args, **kwargs):
        raise AssertionError("device work began")

    monkeypatch.setattr(runner, "mk_r1cs_proof", no_device_work)
    monkeypatch.setattr(runner, "verify_r1cs_proof", no_device_work)
    r1cs_path, wtns_path = _bad_files(case, tmp_path)
    pj = str(tmp_path / "proof.json")
    with open(pj, "w") as f:
        f.write(golden)
    fn = runner.prove_with_file_path if entry == "prove" else runner.verify_with_file_path
    with pytest.raises(ValueError):
        fn(r1cs_path, wtns_path, pj, device="cpu")


@pytest.mark.parametrize("case", ["wtns truncated", "wtns field size", "r1cs field size"])
def test_the_jax_python_readers_accept_what_the_port_refuses(case, tmp_path):
    """The fault the port's readers repair: the JAX package's Python readers
    take these files (a truncated `.wtns` gives a short last value, a wider
    field its values as they are), which its C++ readers, like both of the
    port's, refuse or read otherwise."""
    from stark_tpu.r1cs import reader as jreader

    r1cs_path, wtns_path = _bad_files(case, tmp_path)
    if case.startswith("wtns"):
        values = jreader.read_witness(_read(wtns_path))
        assert len(values) == 8
        if case == "wtns truncated":
            with pytest.raises(ValueError):
                jnative.read_witness_flat(_read(wtns_path))
        else:
            assert jnative.read_witness_flat(_read(wtns_path)).shape == (8, 48)
        with pytest.raises(ValueError):
            read_witness(_read(wtns_path))
    else:
        assert jreader.read_r1cs(_read(r1cs_path)).header.field_size == 48
        with pytest.raises(ValueError):
            jnative.read_r1cs_flat(_read(r1cs_path))
        with pytest.raises(ValueError):
            read_r1cs(_read(r1cs_path))


@pytest.mark.parametrize("entry", ["prove_with_witness", "prove_many"])
def test_the_jax_runner_pads_a_short_witness_the_port_refuses(entry, golden, monkeypatch):
    """The JAX package's `prove_with_witness` (and `prove_many`'s `_wit_np`)
    fill an (n_wires, 32) array of zeros from however many values the list
    holds (`stark_tpu/protocol/runner.py:61-63, 121-124`): a list one wire
    short reaches its prover with a zero last row. The port's entry points
    refuse it with `ValueError` before any device work."""
    from stark_tpu.r1cs import reader as jreader

    jr1cs = jreader.read_r1cs(_read(R1CS))
    witness = jreader.read_witness(_read(WTNS))
    seen = []
    monkeypatch.setattr(jrunner, "mk_r1cs_proof",
                        lambda spec, arith, *args, **kw: seen.append(arith) or "proof")
    assert jrunner.prove_with_witness(jr1cs, witness[:-1]) == "proof"
    rows = np.asarray(seen[0].witness_le)
    assert rows.shape == (jr1cs.header.n_wires, 32)
    assert not rows[-1].any() and rows[-2].tobytes() == witness[-2].ljust(32, b"\0")

    def no_device_work(*args, **kwargs):
        raise AssertionError("device work began")

    monkeypatch.setattr(runner, "mk_r1cs_proof", no_device_work)
    monkeypatch.setattr(runner, "enqueue_r1cs_proof", no_device_work)
    r1cs = read_r1cs(_read(R1CS))
    with pytest.raises(ValueError, match="wires"):
        if entry == "prove_with_witness":
            runner.prove_with_witness(r1cs, witness[:-1], device="cpu")
        else:
            runner.prove_many(r1cs, [witness, witness[:-1]], device="cpu")


def test_the_unchanged_chain_files_pass_both_routes(golden, tmp_path, monkeypatch):
    """The refusals' control: the same writer, nothing changed."""
    stubs = _Stubs(monkeypatch, golden)
    paths = _chain_files(tmp_path)
    for available in (True, False):
        monkeypatch.setattr(native, "available", lambda: available)
        runner.prove_with_file_path(*paths, str(tmp_path / "p.json"), device="cpu")
    assert len(stubs.proves) == 2
    assert np.array_equal(stubs.proves[0]["witness_le"], stubs.proves[1]["witness_le"])
    assert stubs.proves[0]["coefficients"] == stubs.proves[1]["coefficients"]


# --- the writer ---------------------------------------------------------------------


@pytest.mark.parametrize("name", FIXTURES)
def test_write_circuit_files_round_trips_through_both_readers(name, tmp_path):
    r1cs = read_r1cs(_read(os.path.join(FIX, f"{name}.r1cs")))
    witness = read_witness(_read(os.path.join(FIX, f"{name}.wtns")))
    paths = str(tmp_path / "c.r1cs"), str(tmp_path / "c.wtns")
    write_circuit_files(r1cs, witness, *paths)
    assert dataclasses.asdict(read_r1cs(_read(paths[0]))) == dataclasses.asdict(r1cs)
    assert read_witness(_read(paths[1])) == witness
    flat, want = native.read_r1cs_flat(_read(paths[0])), native.flat_from_contents(r1cs)
    for key, value in dataclasses.asdict(want).items():
        got = getattr(flat, key)
        assert (np.array_equal(got, value) if isinstance(value, np.ndarray)
                else got == value), key
    assert np.array_equal(native.read_witness_flat(_read(paths[1])),
                          runner._witness_rows(r1cs, witness))
    # the third section: the identity label map, n_labels u64s
    n_labels = r1cs.header.n_labels
    data = _read(paths[0])
    tail = data[-(12 + 8 * n_labels):]
    assert struct.unpack_from("<IQ", tail) == (3, 8 * n_labels)
    assert struct.unpack_from(f"<{n_labels}Q", tail, 12) == tuple(range(n_labels))
