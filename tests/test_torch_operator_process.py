"""The port's operator binary as a process, as
``tests/test_standalone_process.py`` drives the JAX one: ``python -m
kubedl_tpu_torch`` with its console and SQLite persistence, with ``jax``
and the JAX package blocked in the process, serves a submit-reconcile-
inspect loop over HTTP and exits 0 on SIGTERM. The store it leaves behind
holds the job and its pods."""

import json
import os
import signal
import sqlite3
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

from kubedl_tpu_torch.parallel.launch import free_port

REPO = str(Path(__file__).resolve().parents[1])

#: ``python -m kubedl_tpu_torch ARGS`` with jax and the JAX package blocked
#: (an import of either raises)
BLOCKED_MAIN = ("import runpy, sys\n"
                "sys.modules['jax'] = None\n"
                "sys.modules['kubedl_tpu'] = None\n"
                "runpy.run_module('kubedl_tpu_torch', run_name='__main__',"
                " alter_sys=True)\n")


class Console:
    def __init__(self, port):
        self.base = f"http://127.0.0.1:{port}"
        self.cookie = None

    def req(self, method, path, body=None):
        r = urllib.request.Request(self.base + path, method=method)
        if self.cookie:
            r.add_header("Cookie", self.cookie)
        data = json.dumps(body).encode() if body is not None else None
        with urllib.request.urlopen(r, data=data, timeout=10) as res:
            sc = res.headers.get("Set-Cookie")
            if sc:
                self.cookie = sc.split(";")[0]
            return json.loads(res.read() or b"{}")


def wait_for(fn, what, proc, log_tail, timeout=60.0):
    deadline = time.time() + timeout
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"operator died: {log_tail()}")
        got = fn()
        if got:
            return got
        if time.time() > deadline:
            raise AssertionError(f"{what} never happened: {log_tail()}")
        time.sleep(0.2)


def pytorchjob(name):
    return {"apiVersion": "training.kubedl.io/v1alpha1",
            "kind": "PyTorchJob",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"pytorchReplicaSpecs": {
                "Master": {"replicas": 1, "template": {"spec": {
                    "containers": [{"name": "pytorch", "image": "img"}]}}},
                "Worker": {"replicas": 1, "template": {"spec": {
                    "containers": [{"name": "pytorch", "image": "img"}]}}}}}}


def test_the_ports_operator_binary_with_jax_blocked(tmp_path):
    port = free_port()
    db = tmp_path / "kubedl.db"
    log = open(tmp_path / "operator.log", "w+b", buffering=0)
    env = {**os.environ, "PYTHONPATH": REPO,
           "KUBEDL_CONSOLE_USERS": "admin:pw"}
    # the log goes to a file: nobody drains a pipe while the process runs
    proc = subprocess.Popen(
        [sys.executable, "-c", BLOCKED_MAIN,
         "--workloads", "PyTorchJob,JAXJob", "--metrics-port", "0",
         "--console-host", "127.0.0.1", "--console-port", str(port),
         "--object-storage", f"sqlite:///{db}",
         "--event-storage", f"sqlite:///{db}"],
        env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)

    def log_tail() -> str:
        log.seek(0)
        return log.read().decode(errors="replace")[-3000:]

    def login():
        try:
            return con.req("POST", "/api/v1/login",
                           {"username": "admin", "password": "pw"})
        except (urllib.error.URLError, OSError):
            return None
    con = Console(port)
    try:
        wait_for(login, "the console", proc, log_tail)
        out = con.req("POST", "/api/v1/job/submit", pytorchjob("smoke"))
        assert out["data"]["name"] == "smoke"

        def pods():
            detail = con.req("GET", "/api/v1/job/detail?kind=PyTorchJob"
                             "&namespace=default&name=smoke")["data"]
            return detail["pods"] if len(detail["pods"]) == 2 else None
        names = sorted(p["name"] for p in wait_for(pods, "two pods", proc,
                                                   log_tail))
        assert names == ["smoke-master-0", "smoke-worker-0"]
        rows = con.req("GET", "/api/v1/job/list")["data"]["jobInfos"]
        assert [r["kind"] for r in rows if r["name"] == "smoke"] == [
            "PyTorchJob"]
        # the operator's events on the job, through the console
        events = wait_for(lambda: con.req(
            "GET", "/api/v1/event/events/default/smoke")["data"],
            "an event on the job", proc, log_tail)
        assert all(e["name"] for e in events)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, log_tail()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        log.close()
    assert "Traceback" not in (tmp_path / "operator.log").read_text()
    with sqlite3.connect(db) as conn:
        jobs = conn.execute("SELECT name, kind FROM jobs").fetchall()
        pod_names = sorted(r[0] for r in conn.execute(
            "SELECT name FROM pods").fetchall())
    assert ("smoke", "PyTorchJob") in jobs
    assert pod_names == ["smoke-master-0", "smoke-worker-0"]
