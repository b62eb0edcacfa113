"""One client in a closed loop against the proving worker,
`stark_tpu_torch.serve.serve`, running in this process on in-memory line
streams: each request names the cached `.r1cs`, one of the pool's `.wtns`
files (written in set-up under TMPDIR) and a `proof_json` path; the reply
comes after the worker has read the witness with its C++ reader, proved,
serialized the proof and written the file. A sampled witness's requests
each write a file of their own, kept for the check; the others overwrite
one file a witness.

The worker runs in the main thread, as `cli serve` does; the client runs in
a second thread and times each request from handing over its line to
receiving the reply. Work that has to run in the worker's thread (the
tracer's switches) is handed over through the request stream and run by
the stream itself between requests.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import tempfile
import threading
import time

from benchmark.drivers import KEEP, closed_loop


class _Lines:
    """The worker's stdin: lines from a queue; a callable from the queue is
    run here, in the worker's thread, and its value or error sent back."""

    def __init__(self):
        self.q = queue.Queue()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if callable(item[0]):
                fn, back = item
                try:
                    back.put((True, fn()))
                except Exception as e:  # re-raised in the client's thread
                    back.put((False, e))
                continue
            yield item[0]


class _Replies:
    """The worker's stdout: each complete `RPC ` line onto a queue."""

    def __init__(self):
        self.q = queue.Queue()
        self.buf = ""

    def write(self, s: str):
        self.buf += s
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            if line.startswith("RPC "):
                self.q.put(json.loads(line[4:]))

    def flush(self):
        pass


class Driver:
    def __init__(self, r1cs_path, pool, config, traffic, device, keep):
        self.r1cs_path, self.pool, self.device, self.keep = r1cs_path, pool, device, keep
        self.config, self.digest = config, config["digest"]
        self.dir = tempfile.mkdtemp(prefix="bench-worker-")
        self.stdin, self.stdout = _Lines(), _Replies()
        self.kept = {i: [] for i in keep}
        self.n = 0

    def setup(self):
        from benchmark.harness import family

        self.wtns = []
        for j, rows in enumerate(self.pool):
            path = os.path.join(self.dir, f"w{j}.wtns")
            family(self.config).write_wtns(path, rows)
            self.wtns.append(path)
        ready = self.stdout.q.get(timeout=600)
        if ready.get("result", {}).get("event") != "ready":
            raise RuntimeError(f"the worker did not start: {ready}")
        for i in range(2):  # cold (parses the circuit), then warm
            rec = self.call(i)
            if not rec["ok"]:
                raise RuntimeError(f"set-up call failed: {rec['error']}")
        for paths in self.kept.values():
            for p in paths:
                os.remove(p)
        self.kept = {i: [] for i in self.keep}

    def call(self, i: int) -> dict:
        j = i % len(self.pool)
        self.n += 1
        keep = j in self.kept and len(self.kept[j]) < KEEP
        if keep:
            out = os.path.join(self.dir, f"proof-{self.n}.json")
        else:
            out = os.path.join(self.dir, f"proof-w{j}.json")
        line = json.dumps({"id": self.n, "method": "prove", "params": {
            "r1cs": self.r1cs_path, "wtns": self.wtns[j], "proof_json": out,
            "digest": self.digest}})
        start = time.perf_counter()
        self.stdin.q.put((line,))
        reply = self.stdout.q.get()
        end = time.perf_counter()
        ok = reply.get("id") == self.n and bool(reply.get("result", {}).get("ok"))
        if ok and keep:
            self.kept[j].append(out)
        rec = {"start": start, "end": end, "ok": ok, "witness": j}
        if not ok:
            rec["error"] = json.dumps(reply)[-600:]
        return rec

    def window(self, seconds: float):
        return closed_loop(self.call, seconds)

    def in_program_thread(self, fn):
        back = queue.Queue()
        self.stdin.q.put((fn, back))
        ok, value = back.get()
        if not ok:
            raise value
        return value

    def execute(self, fn):
        """fn() in the client's thread while the worker serves in this one."""
        from stark_tpu_torch import serve

        box = {}

        def client():
            try:
                box["value"] = fn()
            except BaseException as e:  # re-raised below
                box["error"] = e
            finally:
                self.stdin.q.put(None)  # end of input: the worker returns

        t = threading.Thread(target=client, name="bench-client")
        t.start()
        try:
            serve.serve(self.stdin, self.stdout, device=self.device)
        finally:
            self.stdin.q.put(None)
            t.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    def outputs(self) -> dict:
        out = {}
        for j, paths in self.kept.items():
            out[j] = []
            for p in paths:
                with open(p) as f:
                    out[j].append(f.read())
        return out

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)
