"""Build and load the hand-written CUDA kernels at first use.

All `csrc/*.cu` sources compile with `nvcc` into ONE shared library with a
plain C interface, loaded through `ctypes` (no PyTorch headers, so a build
takes seconds): one `nvcc -c` per source, all started together, then one
link. The library lands in `stark_tpu_torch/_build/<key>/`, keyed by a hash
of the sources, the flags and the compiler (its resolved path, size and
modification time: a process that finds the library built runs no `nvcc`,
not even `--version`), written to a temporary name and
moved into place with `os.replace` (the first-use pattern of
`stark_tpu_torch/native/__init__.py`).

Unlike that module, a failed build is an error: no plain-PyTorch fallback
stands in for a kernel. A missing `nvcc` or a compiler error raises
`RuntimeError` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp = ctypes.c_void_p
_u32p = ctypes.POINTER(ctypes.c_uint32)
_ll = ctypes.c_longlong
_SIGNATURES = {
    "stark_mmul": [_vp, _vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp],
    "stark_butterfly_stage": [
        _vp, _vp, _vp, _ll, _ll, ctypes.c_int, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_butterfly_fused": [
        _vp, _vp, _vp, _ll, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u32p,
        ctypes.c_uint32, _vp,
    ],
    "stark_butterfly_pass": [
        _vp, _vp, _vp, _ll, _ll, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u32p,
        ctypes.c_uint32, _vp,
    ],
    "stark_butterfly_pass_shoup": [
        _vp, _vp, _vp, _ll, _ll, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u32p,
        ctypes.c_uint32, _vp,
    ],
    "stark_butterfly_fused_shoup": [
        _vp, _vp, _vp, _ll, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u32p,
        ctypes.c_uint32, _vp,
    ],
    "stark_blake2s_words": [_vp, _vp, _ll, ctypes.c_int, _ll, _vp],
    "stark_poseidon_leaves": [
        _vp, _vp, _ll, _ll, _vp, ctypes.c_int, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_poseidon_pairs": [
        _vp, _vp, _ll, _ll, _vp, ctypes.c_int, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_mpow_scalar": [
        _vp, _vp, ctypes.c_int, _u32p, ctypes.c_int, ctypes.c_int, _u32p, ctypes.c_uint32,
        _vp,
    ],
    "stark_scan_prod": [
        _vp, _vp, _ll, _ll, ctypes.c_int, ctypes.c_int, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_rand_combination": [
        _vp, _vp, _vp, _vp, _vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_q1_eval": [
        _vp, _vp, _vp, _vp, _vp, _vp, _ll, _ll, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_q2_eval": [_vp, _vp, _vp, _ll, _ll, _ll, _ll, _u32p, ctypes.c_uint32, _vp],
    "stark_q3_eval": [_vp, _vp, _vp, _vp, _ll, _ll, _u32p, ctypes.c_uint32, _vp],
    "stark_linear_combination": [
        _vp, ctypes.POINTER(_vp), _vp, _ll, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_linear_combination_shoup": [
        _vp, _vp, _vp, _ll, ctypes.POINTER(_vp), _vp, _ll, _u32p, ctypes.c_uint32,
        _vp,
    ],
    "stark_shoup_mul_periodic": [
        _vp, _vp, _ll, _vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_horner_eval": [
        _vp, _ll, ctypes.c_int, _vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_vanishing_eval": [
        _vp, _ll, ctypes.c_int, _vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_vanishing_coeffs": [_vp, _ll, _vp, _u32p, ctypes.c_uint32, _vp],
    "stark_sub_mul": [
        _vp, _vp, ctypes.c_int, _vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_from_mont_pack_words": [_vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp],
    "stark_fri_fold_pre": [_vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp],
    "stark_fri_fold_post": [
        _vp, _vp, _vp, _vp, _vp, _ll, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_fri_fold_dft": [
        _vp, _vp, _vp, _vp, _ll, _ll, _u32p, _u32p, ctypes.c_uint32, _vp,
    ],
    "stark_crt_residues_in": [_vp, _vp, _vp, _vp, _vp, ctypes.c_int, _ll, _ll, _vp],
    "stark_crt_matmul_fold": [
        _vp, _vp, _vp, _vp, _vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _vp,
    ],
    "stark_crt_reconstruct": [
        _vp, _vp, _vp, ctypes.c_int, _ll, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int32), _u32p, ctypes.c_uint32, _vp,
    ],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from stark_tpu_torch/csrc at first use"
        )
    return path


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _key(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, path), "rb") as f:
            h.update(path.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    real = os.path.realpath(nvcc)
    st = os.stat(real)
    h.update(f"{real}\0{st.st_size}\0{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Build the kernel library if needed and return its path."""
    nvcc = _nvcc()
    out_dir = os.path.join(BUILD_ROOT, _key(nvcc))
    so = os.path.join(out_dir, "libstark_kernels.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tag = f".tmp{os.getpid()}"
    objs = [os.path.join(out_dir, os.path.basename(src)[:-3] + tag + ".o")
            for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for obj, src in zip(objs, sources())]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    failed = any(proc.returncode != 0 for proc in procs)
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", so + tag, *objs]
    if not failed:
        done = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        cmds.append(link)
        outputs.append(done.stdout)
        failed = done.returncode != 0
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outputs))
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(log)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(so + tag, so)
    return so


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(library_path())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError_t {rc}")
