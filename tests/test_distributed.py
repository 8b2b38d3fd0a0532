"""Multi-process dress rehearsal for the multi-host runtime
(parallel/distributed.py) within a single machine: two OS processes x 4
virtual CPU devices each join one 8-device JAX runtime, feed per-process
shards through ``local_shard_array``, and run the sharded derived-field
pipeline whose halo ``ppermute`` legs cross the process boundary (gloo).

The real thing (several hosts of GPUs over NCCL) differs only in
transport — the mesh construction, in/out specs, and collective layout
are identical code paths (SURVEY §2.7 multi-process row)."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pipeline():
    env = dict(os.environ)
    # the workers pin their own XLA_FLAGS / platform; drop the parent
    # suite's 8-device flag so each worker sees exactly 4 local devices
    env.pop("XLA_FLAGS", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(port), str(i), "2"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"distributed worker {i}/2: OK" in out, out
