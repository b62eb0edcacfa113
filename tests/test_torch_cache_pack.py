"""`python -m stark_tpu_torch.cli cache-pack` / `cache-unpack` on the CPU:
the cases of `tests/test_cache_pack.py` against the port's CLI, with the
three locations pointed at a `tmp_path` (`ops/build.py BUILD_ROOT`,
`native.BUILD_DIR`, `ops/plan_cache.py CACHE_DIR`):

* the round trip: each kernel library's key directory, the host library
  and the CRT tables come back byte for byte, under `kernels/<key>/`,
  `host/` and `plans/`; files a build is still writing stay out;
* unpacking into directories that do not exist yet;
* the refusals: a wrong top directory, `..`, an absolute path, nesting
  deeper than the layout, a kernel directory that is not a key, links and
  directories; an archive of the JAX package's `cache-pack` unpacks
  nothing; packing with no cache makes an empty archive;
* after unpacking, the CLI says whether the kernel library of this host's
  key is present: it is for the `nvcc` the archive was made with, not for
  another install (another size or modification time);
* `cache-pack` and `cache-unpack` import no torch (a subprocess reads
  `sys.modules`).
"""

import io
import os
import shutil
import subprocess
import sys
import tarfile

import pytest

from stark_tpu_torch import cli, native
from stark_tpu_torch.ops import build, plan_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = "0123456789abcdef"


@pytest.fixture()
def dirs(tmp_path, monkeypatch):
    base = tmp_path / "_build"
    out = {"kernels": base, "host": base / "host", "plans": tmp_path / "plans"}
    monkeypatch.setattr(build, "BUILD_ROOT", str(out["kernels"]))
    monkeypatch.setattr(native, "BUILD_DIR", str(out["host"]))
    monkeypatch.setattr(plan_cache, "CACHE_DIR", str(out["plans"]))
    return out


def _fill(dirs):
    files = {
        f"kernels/{KEY}/libstark_kernels.so": b"\x7fELF kernels" * 100,
        f"kernels/{KEY}/build.log": b"ptxas info",
        "kernels/fedcba9876543210/libstark_kernels.so": b"\x7fELF other key",
        "host/libstark_host_0011223344556677.so": b"\x7fELF host",
        "plans/ntt_abc.npz": b"plan-tables",
    }
    for name, data in files.items():
        top, _, rest = name.partition("/")
        path = dirs[top] / rest
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    # what the layout leaves out: a build in progress, a directory that is
    # not a key, a link
    (dirs["kernels"] / KEY / "libstark_kernels.so.tmp123").write_bytes(b"half")
    (dirs["host"] / "libstark_host_1.so.tmp9").write_bytes(b"half")
    (dirs["kernels"] / "notakey").mkdir()
    (dirs["kernels"] / "notakey" / "x.so").write_bytes(b"x")
    os.symlink(dirs["plans"] / "ntt_abc.npz", dirs["plans"] / "ntt_link.npz")
    return files


def _listing(dirs):
    out = {}
    for top, base in dirs.items():
        for here, subdirs, names in os.walk(base):
            subdirs[:] = [d for d in subdirs if top != "kernels" or d != "host"]
            for name in names:
                rel = os.path.relpath(os.path.join(here, name), base)
                with open(os.path.join(here, name), "rb") as f:
                    out[f"{top}/{rel}"] = f.read()
    return out


def test_cache_pack_unpack_round_trip(dirs, tmp_path, capsys):
    files = _fill(dirs)
    archive = str(tmp_path / "warm.tar.gz")
    assert cli.main(["cache-pack", archive]) == 0
    with tarfile.open(archive, "r:gz") as tf:
        assert sorted(tf.getnames()) == sorted(files)
    assert capsys.readouterr().out.startswith(f"packed {len(files)} cache entries")

    for base in dirs.values():
        shutil.rmtree(base, ignore_errors=True)
        base.mkdir(parents=True, exist_ok=True)
    assert cli.main(["cache-unpack", archive]) == 0
    assert _listing(dirs) == files
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"restored {len(files)} cache entries from {archive}"
    assert out[1].startswith("kernel library")


def test_cache_unpack_restores_into_empty_dirs(dirs, tmp_path):
    files = _fill(dirs)
    archive = str(tmp_path / "warm.tar.gz")
    assert cli.main(["cache-pack", archive]) == 0
    for base in dirs.values():
        shutil.rmtree(base, ignore_errors=True)
    assert cli.main(["cache-unpack", archive]) == 0
    assert _listing(dirs) == files
    assert not any(".tmp" in name for name in os.listdir(dirs["host"]))


def _evil(path, entries):
    with tarfile.open(path, "w:gz") as tf:
        for name, kind in entries:
            info = tarfile.TarInfo(name)
            payload = b"evil"
            if kind == "symlink":
                info.type, info.linkname = tarfile.SYMTYPE, "/etc/passwd"
            elif kind == "hardlink":
                info.type, info.linkname = tarfile.LNKTYPE, "plans/ok.npz"
            elif kind == "dir":
                info.type = tarfile.DIRTYPE
            else:
                info.size = len(payload if kind == "file" else b"good")
            tf.addfile(info, io.BytesIO(payload if kind == "file" else b"good"))


def test_cache_unpack_refuses_traversal_links_and_the_jax_layout(dirs, tmp_path):
    archive = str(tmp_path / "evil.tar.gz")
    _evil(archive, [
        ("plans/ok.npz", "good"),
        (f"kernels/{KEY}/libstark_kernels.so", "good"),
        ("plans/../escape", "file"),
        ("plans/nested/dir/entry", "file"),
        (f"kernels/{KEY}/deeper/lib.so", "file"),
        ("kernels/notakey/lib.so", "file"),
        ("kernels/lib.so", "file"),
        ("host/..", "file"),
        ("/etc/passwd-clobber", "file"),
        ("other_top/entry", "file"),
        ("plans/../../outside", "file"),
        ("plans/link.npz", "symlink"),
        ("host/hard.so", "hardlink"),
        ("plans/adir", "dir"),
        ("jax_stark/jit_foo-cache", "file"),
        ("stark_tpu_plans/ntt_abc.npz", "file"),
        ("jax_stark_aot/stage", "file"),
    ])
    assert cli.main(["cache-unpack", archive]) == 0
    assert _listing(dirs) == {"plans/ok.npz": b"good",
                              f"kernels/{KEY}/libstark_kernels.so": b"good"}
    assert not (tmp_path / "escape").exists() and not (tmp_path / "outside").exists()
    assert sorted(os.listdir(tmp_path)) == ["_build", "evil.tar.gz", "plans"]

    # an archive of the JAX package's `cache-pack` (`tests/test_cache_pack.py`'s layout)
    jax_archive = str(tmp_path / "jax.tar.gz")
    _evil(jax_archive, [("jax_stark/jit_foo-cache", "file"),
                        ("stark_tpu_plans/ntt_abc.npz", "file"),
                        ("jax_stark_aot/wit_traces_j", "file")])
    for base in dirs.values():
        shutil.rmtree(base, ignore_errors=True)
    assert cli.main(["cache-unpack", jax_archive]) == 0
    assert _listing(dirs) == {}


def test_cache_pack_with_no_cache_makes_an_empty_archive(dirs, tmp_path):
    archive = str(tmp_path / "empty.tar.gz")
    assert cli.main(["cache-pack", archive]) == 0
    with tarfile.open(archive, "r:gz") as tf:
        assert tf.getmembers() == []


def test_cache_unpack_names_this_hosts_kernel_key(dirs, tmp_path, monkeypatch, capsys):
    nvcc = tmp_path / "nvcc"
    nvcc.write_bytes(b"#!/bin/sh\n")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    key = build._key(str(nvcc))
    (dirs["kernels"] / key).mkdir(parents=True)
    (dirs["kernels"] / key / "libstark_kernels.so").write_bytes(b"\x7fELF")
    archive = str(tmp_path / "warm.tar.gz")
    assert cli.main(["cache-pack", archive]) == 0
    shutil.rmtree(dirs["kernels"])
    assert cli.main(["cache-unpack", archive]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"kernel library for this host's key {key}: present"

    nvcc.write_bytes(b"#!/bin/sh\n# another toolkit install\n")  # another size
    shutil.rmtree(dirs["kernels"])
    assert cli.main(["cache-unpack", archive]) == 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last.startswith(f"kernel library for this host's key {build._key(str(nvcc))}: "
                           "absent")
    assert os.path.exists(dirs["kernels"] / key / "libstark_kernels.so")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    assert cli.main(["cache-unpack", archive]) == 0
    assert "no nvcc" in capsys.readouterr().out.splitlines()[-1]


def test_cache_pack_and_unpack_import_no_torch(tmp_path):
    (tmp_path / "plans").mkdir()
    (tmp_path / "plans" / "ntt_x.npz").write_bytes(b"tables")
    script = f"""
import sys
from stark_tpu_torch import cli, native
from stark_tpu_torch.ops import build, plan_cache
build.BUILD_ROOT = {str(tmp_path / "_build")!r}
native.BUILD_DIR = {str(tmp_path / "_build" / "host")!r}
plan_cache.CACHE_DIR = {str(tmp_path / "plans")!r}
archive = {str(tmp_path / "a.tar.gz")!r}
assert cli.main(["cache-pack", archive]) == 0
assert cli.main(["cache-unpack", archive]) == 0
print("torch" in sys.modules)
"""
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.splitlines()[-1] == "False"
    assert "packed 1 cache entries" in done.stdout
