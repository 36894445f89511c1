"""Ranks of tests/_torch_dist_worker.py, for the CPU tests
(tests/test_torch_dist_procs.py) and the card's (tests/test_torch_cuda.py).
Imports no JAX."""
import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_all(procs, timeout: float):
    """Wait for every process (each within `timeout` seconds, or all are
    killed); raise where one failed."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"rank failed:\n{log[-3000:]}")


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PT_")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def run_driver_ranks(tmp_path, shape: str, timeout: float = 120.0):
    """Start tests/_torch_dist_worker.py's "driver" form as every rank of
    a gloo group on the CPU over a `shape` ("PxS") mesh, wait for them and
    return their output paths (.npz)."""
    P, S = (int(v) for v in shape.split("x"))
    port = str(free_port())
    outs = [str(tmp_path / f"driver{i}.npz") for i in range(P * S)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
         "driver", str(i), str(P * S), port, outs[i][:-4], shape],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path), env=_env()) for i in range(P * S)]
    _wait_all(procs, timeout)
    return outs


def run_two_ranks(tmp_path, shape: str, device: str = "cpu",
                  timeout: float = 240.0):
    """Start tests/_torch_dist_worker.py as ranks 0 and 1 of a gloo group
    on `device` over a `shape` ("PxS") mesh, wait for both (each within
    `timeout` seconds, or both are killed) and return their output paths
    (.npz)."""
    ports = set()
    while len(ports) < 5:
        ports.add(str(free_port()))
    ports = sorted(ports)
    outs = [str(tmp_path / f"rank{i}.npz") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
         str(i), "2", *ports, outs[i][:-4], shape, device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(tmp_path), env=_env()) for i in range(2)]
    _wait_all(procs, timeout)
    return outs
