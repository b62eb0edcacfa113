"""Command-line interface of the port.

    python -m stark_tpu_torch.cli run c.r1cs w.wtns proof.json --device cuda
    python -m stark_tpu_torch.cli serve --device cuda --fri-fold lagrange
    python -m stark_tpu_torch.cli prove c.r1cs w.wtns proof.json --lde-engine crt
    python -m stark_tpu_torch.cli warmup c.r1cs --device cuda --lde-engine crt

`prove`, `verify`, `run` (prove then verify), `serve` (the long-lived
proving worker, line-delimited JSON-RPC on stdio: `stark_tpu_torch/serve.py`)
and `warmup` mirror `stark_tpu.cli`; the bare 3-argument form means `run`,
like the reference's binary. The files are read on the runner's native
route (the C++ readers of the host library, built with g++ at first use)
where that library builds. `warmup` fills what a later process finds on
disk, so that its first prove starts at once: the CUDA kernel library (on
a card), the host library and, on the crt engine, the residue tables
(`ops/plan_cache.py CACHE_DIR`). It reads the circuit and runs the worker's
warmup (`serve._warmup`: the stage set for the circuit's size) and prints
`warmed N stages (steps=S)`. `--fri-fold` names FRI's fold route for the proving
commands; `--lde-engine` names the engine of the low-degree extensions
(the butterfly NTT, or the CRT matrix-product engine of `ops/mxu_ntt.py`) for
every command. The proof is the same on either of each. `--digest` names
the tree digest of `prove`, `verify` and `run` (the worker takes it per
request): blake2s, or poseidon for the l-tree and FRI's trees.

`prove`, `verify`, `run` and `serve` take the tracer's switches
(`utils/tracing.py configure`), where the JAX package reads its environment:
`--trace` prints each top-level phase's report (to stderr under `serve`,
whose stdout carries the protocol), `--sync-phases` synchronizes the device
at every phase's exit, `--profile-dir DIR` writes a Chrome trace of each
top-level phase into DIR (`utils/profiling.py parse_device_trace` reads the
newest), `--rss` adds the process's RSS to the report.

    python -m stark_tpu_torch.cli cache-pack warm.tar.gz
    python -m stark_tpu_torch.cli cache-unpack warm.tar.gz

`cache-pack` tars what a cold start builds (the counterpart of
`stark_tpu/cli.py:37-84`): each kernel library under `ops/build.py
BUILD_ROOT` (`kernels/<key>/`), the host library (`native.BUILD_DIR`,
`host/`) and the CRT engine's tables (`ops/plan_cache.py CACHE_DIR`,
`plans/`); `cache-unpack` restores them on another host. Both are tar work
alone: `main` runs them before anything imports torch. The kernel
library's key hashes the sources, the flags and the `nvcc` binary (its
path, size and modification time), so an archive made on a host with
another CUDA toolkit install unpacks, but its library is never found and
the first prove builds anew: `cache-unpack` says whether this host's key is
present.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

_COMMANDS = ("prove", "verify", "run", "serve", "warmup")
_ARCHIVE = ("cache-pack", "cache-unpack")
_KEY = re.compile(r"[0-9a-f]{16}")  # `ops/build.py _key`


def _cache_dirs() -> dict:
    """{archive top directory: where it lives on this host}, each read from
    the module that owns it (none of them imports torch)."""
    from stark_tpu_torch import native
    from stark_tpu_torch.ops import build, plan_cache

    return {"kernels": build.BUILD_ROOT, "host": native.BUILD_DIR,
            "plans": os.path.expanduser(plan_cache.CACHE_DIR)}


def _packed(dirs: dict):
    """(path on disk, name in the archive) of every file to pack: each
    kernel library's key directory, the host libraries and the tables; no
    file a build is still writing (`*.tmp<pid>*`)."""
    def entries(base, keep):
        names = sorted(os.listdir(base)) if os.path.isdir(base) else []
        return [name for name in names if keep(os.path.join(base, name), name)]

    def is_file(path, name):
        return ".tmp" not in name and os.path.isfile(path) and not os.path.islink(path)

    for key in entries(dirs["kernels"], lambda path, name: _KEY.fullmatch(name)):
        for name in entries(os.path.join(dirs["kernels"], key), is_file):
            yield os.path.join(dirs["kernels"], key, name), f"kernels/{key}/{name}"
    for top in ("host", "plans"):
        for name in entries(dirs[top], is_file):
            yield os.path.join(dirs[top], name), f"{top}/{name}"


def _destination(dirs: dict, member) -> str | None:
    """Where an archive entry goes, or None for one the layout refuses: a
    link or other non-file, an unknown top directory (the JAX package's
    archives among them), `..`, an absolute path or a nesting other than
    `kernels/<key>/<file>`, `host/<file>`, `plans/<file>`."""
    parts = member.name.split("/")
    if not member.isfile() or member.name.startswith("/") or parts[0] not in dirs:
        return None
    depth = 3 if parts[0] == "kernels" else 2
    if len(parts) != depth or any(p in ("", ".", "..") or "\\" in p for p in parts):
        return None
    if parts[0] == "kernels" and not _KEY.fullmatch(parts[1]):
        return None
    return os.path.join(dirs[parts[0]], *parts[1:])


def _cache_archive(cmd: str, archive: str) -> int:
    import tarfile

    dirs = _cache_dirs()
    if cmd == "cache-pack":
        n = 0
        # level 1: shared libraries and integer tables gain little from more
        with tarfile.open(archive, "w:gz", compresslevel=1) as tf:
            for path, name in _packed(dirs):
                tf.add(path, name, recursive=False)
                n += 1
        print(f"packed {n} cache entries -> {archive}")
        return 0
    n = 0
    with tarfile.open(archive, "r:gz") as tf:
        for member in tf.getmembers():
            dest = _destination(dirs, member)
            if dest is None:
                continue
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            # written under a temporary name and moved into place, so no
            # process loads a half-written library
            tmp = f"{dest}.tmp{os.getpid()}"
            with tf.extractfile(member) as src, open(tmp, "wb") as out:
                out.write(src.read())
            os.replace(tmp, dest)
            n += 1
    print(f"restored {n} cache entries from {archive}")
    print(_kernel_library_note(dirs["kernels"]))
    return 0


def _kernel_library_note(build_root: str) -> str:
    """Whether the kernel library of this host's key is present: the key
    stats `nvcc` and runs nothing."""
    from stark_tpu_torch.ops import build

    try:
        key = build._key(build._nvcc())
    except (RuntimeError, OSError):
        return "kernel library: no nvcc on this host, so no key to look for"
    there = os.path.exists(os.path.join(build_root, key, "libstark_kernels.so"))
    return (f"kernel library for this host's key {key}: "
            + ("present" if there else "absent (the archive's came from another "
               "toolkit install or other sources; the first prove builds it)"))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _ARCHIVE and len(argv) == 2 and not argv[1].startswith("-"):
        # pure tar work: no torch import
        return _cache_archive(argv[0], argv[1])
    if argv and argv[0] not in _COMMANDS + _ARCHIVE + ("-h", "--help"):
        argv = ["run"] + argv  # bare 3-arg form
    parser = argparse.ArgumentParser(prog="stark-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in _ARCHIVE:
        sp = sub.add_parser(name, help=(
            "tar the kernel libraries, the host library and the CRT tables into one "
            "archive, so that another host starts without building them; a kernel "
            "library is found only where nvcc's path, size and modification time "
            "match this host's" if name == "cache-pack" else
            "restore an archive of cache-pack"))
        sp.add_argument("archive", help=".tar.gz path")
    for name in _COMMANDS:
        sp = sub.add_parser(name)
        if name != "serve":
            sp.add_argument("r1cs")
        if name not in ("serve", "warmup"):
            sp.add_argument("wtns")
            sp.add_argument("proof_json")
            sp.add_argument("--digest", choices=("blake2s", "poseidon"), default="blake2s",
                            help="tree digest (the reference's H: Digest): poseidon "
                            "commits the l-tree and FRI's trees")
        sp.add_argument("--device", default="cuda",
                        help="cuda (the default; needs a card) or cpu")
        if name not in ("verify", "warmup"):
            sp.add_argument("--fri-fold", choices=("dft", "lagrange"), default="dft",
                            help="FRI's fold route: the radix-4 inverse DFT (the "
                            "default) or the Lagrange fold kernels")
        sp.add_argument("--lde-engine", choices=("butterfly", "crt"), default="butterfly",
                        help="the engine of the low-degree extensions: the butterfly "
                        "NTT (the default) or the CRT matrix-product engine")
        if name != "warmup":
            sp.add_argument("--trace", action="store_true",
                            help="print each top-level phase's report")
            sp.add_argument("--sync-phases", action="store_true",
                            help="synchronize the device at every phase's exit")
            sp.add_argument("--profile-dir", default=None,
                            help="write a Chrome trace of each top-level phase here")
            sp.add_argument("--rss", action="store_true",
                            help="add the process's RSS to the report")
    args = parser.parse_args(argv)

    if args.cmd in _ARCHIVE:
        return _cache_archive(args.cmd, args.archive)
    if args.cmd == "warmup":
        return _run(args)
    from stark_tpu_torch.utils import tracing

    previous = tracing.configure(
        trace=args.trace, profile_dir=args.profile_dir, sync_phases=args.sync_phases,
        rss=args.rss, out=sys.stderr if args.cmd == "serve" else None)
    try:
        return _run(args)
    finally:
        tracing.configure(**previous)


def _run(args) -> int:
    if args.cmd == "serve":
        from stark_tpu_torch.serve import serve

        return serve(device=args.device, fri_fold=args.fri_fold,
                     lde_engine=args.lde_engine)

    from stark_tpu_torch.protocol import runner

    t0 = time.time()
    if args.cmd == "warmup":
        from stark_tpu_torch import device as devmod
        from stark_tpu_torch.serve import _warmup

        warmed = _warmup(runner.read_circuit(args.r1cs), devmod.resolve(args.device),
                         args.lde_engine)
        print(f"warmed {warmed['warmed']} stages (steps={warmed['steps']})")
    elif args.cmd == "prove":
        runner.prove_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                    digest=args.digest, device=args.device,
                                    fri_fold=args.fri_fold, lde_engine=args.lde_engine)
    elif args.cmd == "verify":
        runner.verify_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                     digest=args.digest, device=args.device,
                                     lde_engine=args.lde_engine)
        print("Done proof verification")
    else:
        runner.run_with_file_path(args.r1cs, args.wtns, args.proof_json,
                                  digest=args.digest, device=args.device,
                                  fri_fold=args.fri_fold, lde_engine=args.lde_engine)
        print("Done proof verification")
    print(f"{args.cmd}: {time.time() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
