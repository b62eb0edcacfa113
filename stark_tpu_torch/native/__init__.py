"""ctypes bindings for the C++ host runtime (`native/stark_host.cpp`).

The reference's host path is native Rust end to end; this module is the
C++ equivalent for the framework's host-side hot loops (parsers,
arithmetization, transcript hashing), auto-built with g++ on first use and
falling back to the pure-Python implementations when no toolchain exists.

All entry points mirror the semantics documented in the C++ source; the
differential tests in `tests/test_native.py` assert byte-equality against
the pure-Python versions on the real circuit fixtures.

The port's own copy of `stark_tpu/native/__init__.py`: same bindings, same
repo-root source, but the library is cached under the port's own gitignored
`stark_tpu_torch/_build/host/` (`BUILD_DIR`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from dataclasses import dataclass

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native", "stark_host.cpp")
# where the library is built and cached, as libstark_host_<sha256 of the source>.so
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build", "host")


@functools.lru_cache(maxsize=1)
def _lib():
    """Load (building if needed) the shared library; None if unavailable."""
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libstark_host_{tag}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.CalledProcessError):
            return None
    lib = ctypes.CDLL(so)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.stark_blake2s.argtypes = [u8p, ctypes.c_uint64, u8p]
    lib.stark_blake2s_batch.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, u8p]
    lib.stark_merkle_fold.argtypes = [u8p, ctypes.c_uint64, u8p]
    lib.stark_r1cs_scan.argtypes = [u8p, ctypes.c_uint64, u64p, u8p]
    lib.stark_r1cs_scan.restype = ctypes.c_int
    lib.stark_r1cs_fill.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64, u32p, u32p, u8p]
    lib.stark_r1cs_fill.restype = ctypes.c_int
    lib.stark_wtns_scan.argtypes = [u8p, ctypes.c_uint64, u64p]
    lib.stark_wtns_scan.restype = ctypes.c_int
    lib.stark_wtns_fill.argtypes = [u8p, ctypes.c_uint64, u8p]
    lib.stark_wtns_fill.restype = ctypes.c_int
    lib.stark_arithmetize.argtypes = [
        ctypes.c_uint64, u32p, u32p, u8p, u8p,
        ctypes.c_uint64, ctypes.c_uint64, u8p,
        u8p, u8p, u8p, u8p, u8p, u64p, u64p, u64p, u64p,
    ]
    lib.stark_arithmetize.restype = ctypes.c_int
    lib.stark_trace_len.argtypes = [ctypes.c_uint64, u32p]
    lib.stark_trace_len.restype = ctypes.c_uint64
    return lib


def available() -> bool:
    return _lib() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def blake2s(data: bytes) -> bytes:
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(0, np.uint8)
    out = np.empty(32, np.uint8)
    lib.stark_blake2s(_u8(buf), len(data), _u8(out))
    return out.tobytes()


def blake2s_batch(msgs: np.ndarray) -> np.ndarray:
    """(N, msg_len) uint8 -> (N, 32) uint8."""
    lib = _lib()
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, msg_len = msgs.shape
    out = np.empty((n, 32), np.uint8)
    lib.stark_blake2s_batch(_u8(msgs), n, msg_len, _u8(out))
    return out


@dataclass
class FlatR1cs:
    """Flat-array view of a parsed .r1cs (native fast path)."""

    version: int
    field_size: int
    prime_number: bytes
    n_wires: int
    n_public_outputs: int
    n_public_inputs: int
    n_private_inputs: int
    n_labels: int
    n_constraints: int
    ncoeffs: np.ndarray  # (n_constraints, 3) uint32
    wire_ids: np.ndarray  # (total,) uint32
    values: np.ndarray  # (total, 32) uint8 LE


def read_r1cs_flat(data: bytes) -> FlatR1cs:
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    header = np.zeros(9, np.uint64)
    prime = np.zeros(32, np.uint8)
    rc = lib.stark_r1cs_scan(_u8(buf), len(data), _u64(header), _u8(prime))
    if rc != 0:
        raise ValueError(f"r1cs parse error (code {rc})")
    n_constraints = int(header[7])
    total = int(header[8])
    ncoeffs = np.zeros(3 * n_constraints, np.uint32)
    wire_ids = np.zeros(total, np.uint32)
    values = np.zeros((total, 32), np.uint8)
    rc = lib.stark_r1cs_fill(
        _u8(buf), len(data), n_constraints, _u32(ncoeffs), _u32(wire_ids), _u8(values)
    )
    if rc != 0:
        raise ValueError(f"r1cs fill error (code {rc})")
    return FlatR1cs(
        version=int(header[0]),
        field_size=int(header[1]),
        prime_number=prime.tobytes(),
        n_wires=int(header[2]),
        n_public_outputs=int(header[3]),
        n_public_inputs=int(header[4]),
        n_private_inputs=int(header[5]),
        n_labels=int(header[6]),
        n_constraints=n_constraints,
        ncoeffs=ncoeffs.reshape(n_constraints, 3),
        wire_ids=wire_ids,
        values=values,
    )


def read_witness_flat(data: bytes) -> np.ndarray:
    """(n_wires, field_size) uint8 raw LE limbs."""
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    meta = np.zeros(2, np.uint64)
    rc = lib.stark_wtns_scan(_u8(buf), len(data), _u64(meta))
    if rc != 0:
        raise ValueError(f"wtns parse error (code {rc})")
    n_wires, field_size = int(meta[0]), int(meta[1])
    out = np.zeros((n_wires, field_size), np.uint8)
    rc = lib.stark_wtns_fill(_u8(buf), len(data), _u8(out))
    if rc != 0:
        raise ValueError(f"wtns fill error (code {rc})")
    return out


@dataclass
class FlatArithmetization:
    """numpy-native arithmetization (values as (N, 32) uint8 LE canonical)."""

    s: np.ndarray | None  # (N, 32) uint8
    p: np.ndarray | None
    k: np.ndarray
    flag1: np.ndarray  # (N,) uint8
    flag2: np.ndarray
    permuted_indices: np.ndarray  # (N,) uint64
    last_coeff_list: np.ndarray  # (n_constraints,) uint64
    public_first_indices: list[tuple[int, int]]

    @property
    def original_steps(self) -> int:
        return self.k.shape[0]


def arithmetize_flat(
    r1cs: FlatR1cs,
    witness: np.ndarray | None,
    p_le: bytes,
    n_public_wires: int,
) -> FlatArithmetization:
    """Native `calc_coefficients_and_witness` + flags + permutation
    (run.rs:109-308,390-419). `witness`: (n_wires, 32) uint8 LE or None."""
    lib = _lib()
    ncoeffs = np.ascontiguousarray(r1cs.ncoeffs.reshape(-1), dtype=np.uint32)
    n = int(lib.stark_trace_len(r1cs.n_constraints, _u32(ncoeffs)))
    with_wit = witness is not None
    if with_wit:
        witness = np.ascontiguousarray(witness, dtype=np.uint8)
        assert witness.shape == (r1cs.n_wires, 32)
    s = np.zeros((n, 32), np.uint8) if with_wit else np.zeros((1, 32), np.uint8)
    p_arr = np.zeros((n, 32), np.uint8) if with_wit else np.zeros((1, 32), np.uint8)
    k = np.zeros((n, 32), np.uint8)
    f1 = np.zeros(n, np.uint8)
    f2 = np.zeros(n, np.uint8)
    perm = np.zeros(n, np.uint64)
    last = np.zeros(r1cs.n_constraints, np.uint64)
    pub = np.zeros(2 * max(n_public_wires, 1), np.uint64)
    npub = np.zeros(1, np.uint64)
    p_buf = np.frombuffer(p_le, dtype=np.uint8)
    values = np.ascontiguousarray(r1cs.values)
    wire_ids = np.ascontiguousarray(r1cs.wire_ids)
    rc = lib.stark_arithmetize(
        r1cs.n_constraints,
        _u32(ncoeffs),
        _u32(wire_ids),
        _u8(values),
        _u8(witness) if with_wit else None,
        r1cs.n_wires,
        n_public_wires,
        _u8(p_buf),
        _u8(s),
        _u8(p_arr),
        _u8(k),
        _u8(f1),
        _u8(f2),
        _u64(perm),
        _u64(last),
        _u64(pub),
        _u64(npub),
    )
    if rc != 0:
        raise ValueError(f"arithmetize error (code {rc})")
    found = int(npub[0])
    pub_pairs = [(int(pub[2 * i]), int(pub[2 * i + 1])) for i in range(found)]
    return FlatArithmetization(
        s=s if with_wit else None,
        p=p_arr if with_wit else None,
        k=k,
        flag1=f1,
        flag2=f2,
        permuted_indices=perm,
        last_coeff_list=last,
        public_first_indices=pub_pairs,
    )


def flat_from_contents(r1cs) -> FlatR1cs:
    """Convert a parsed `R1csContents` (dataclass tree) to the flat-array
    form, so in-memory circuits (synthetic benches, tests) can use the
    native arithmetizer too."""
    h = r1cs.header
    ncoeffs = np.zeros((h.n_constraints, 3), np.uint32)
    wire_ids = []
    values = []
    for ci, cons in enumerate(r1cs.constraints):
        for fi, fac in enumerate(cons.factors):
            ncoeffs[ci, fi] = fac.n_coefficient
            for co in fac.coefficients:
                wire_ids.append(co.wire_id)
                values.append(co.value)
    wire_arr = np.asarray(wire_ids, np.uint32)
    val_arr = (
        np.frombuffer(b"".join(values), np.uint8).reshape(len(values), 32).copy()
        if values
        else np.zeros((0, 32), np.uint8)
    )
    return FlatR1cs(
        version=r1cs.version,
        field_size=h.field_size,
        prime_number=h.prime_number,
        n_wires=h.n_wires,
        n_public_outputs=h.n_public_outputs,
        n_public_inputs=h.n_public_inputs,
        n_private_inputs=h.n_private_inputs,
        n_labels=h.n_labels,
        n_constraints=h.n_constraints,
        ncoeffs=ncoeffs,
        wire_ids=wire_arr,
        values=val_arr,
    )
