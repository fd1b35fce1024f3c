"""The port's in-place restart agent
(``kubedl_tpu_torch/runtime/restart_agent.py``) against the JAX package's
(``kubedl_tpu/runtime/restart_agent.py``): the cases of
``tests/test_elastic_inplace.py``'s agent section, each run on both
copies over the same files and held equal."""

import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import pytest

from kubedl_tpu.runtime import restart_agent as jra
from kubedl_tpu_torch.runtime import restart_agent as tra

ROOT = str(pathlib.Path(__file__).resolve().parents[1])
BOTH = (jra, tra)


def test_the_annotation_and_the_default_path_are_the_operators():
    from kubedl_tpu.api import common as c
    from kubedl_tpu.controllers.elastic import PODINFO_MOUNT_PATH
    assert tra.RESTART_ANNOTATION == jra.RESTART_ANNOTATION == \
        c.ANNOTATION_RESTART_REQUESTED_GENERATION
    assert tra.DEFAULT_ANNOTATIONS_PATH == jra.DEFAULT_ANNOTATIONS_PATH == \
        PODINFO_MOUNT_PATH + "/annotations"


@pytest.mark.parametrize("text", [
    ('world-size="5"\n' f'{jra.RESTART_ANNOTATION}="3"\n'
     'kubernetes.io/config.source="api"\n' 'escaped="a\\"b\\\\c"\n'),
    ("unquoted=3\n" "spaced =  7  \n" "noequalsign\n" "=orphanvalue\n" "\n"
     'quoted="ok"\n' 'multi="line\\none"\n')],
    ids=["kubelet", "edge_cases"])
def test_parse_annotations_file(text):
    got = tra.parse_annotations_file(text)
    assert got == jra.parse_annotations_file(text)
    assert "" not in got and "noequalsign" not in got


def test_read_requested_generation(tmp_path):
    path = tmp_path / "annotations"
    cases = [None, f'{jra.RESTART_ANNOTATION}="7"\n',
             f'{jra.RESTART_ANNOTATION}="garbage"\n',
             f"{jra.RESTART_ANNOTATION}=4\n"]
    seen = []
    for text in cases:
        if text is not None:
            path.write_text(text)
        seen.append([mod.read_requested_generation(str(path))
                     for mod in BOTH])
    # a directory in place of the file
    seen.append([mod.read_requested_generation(str(tmp_path))
                 for mod in BOTH])
    assert seen == [[0, 0], [7, 7], [0, 0], [4, 4], [0, 0]]


def _restart_on_bump(mod, path):
    path.write_text(f'{jra.RESTART_ANNOTATION}="1"\n')
    agent = mod.RestartAgent(annotations_path=str(path), poll_interval=0.05,
                             grace_period=5.0)
    observed = []
    agent.on_restart = observed.append
    result = {}

    def run():
        result["code"] = agent.run(
            [sys.executable, "-c", "import time; time.sleep(60)"])

    t = threading.Thread(target=run)
    t.start()
    time.sleep(0.3)
    path.write_text(f'{jra.RESTART_ANNOTATION}="2"\n')  # operator patches pod
    t.join(timeout=10)
    assert not t.is_alive()
    return result["code"], observed


def test_agent_restarts_child_on_generation_bump(tmp_path):
    """The operator bumps the restart annotation: the child is ended and
    the agent exits 64 + SIGTERM, so OnFailure relaunches the container."""
    got = [_restart_on_bump(mod, tmp_path / mod.__name__) for mod in BOTH]
    assert got[0] == got[1] == (64 + signal.SIGTERM, [2])


def test_agent_passes_through_child_exit(tmp_path):
    codes = [[mod.RestartAgent(annotations_path=str(tmp_path / "a"),
                               poll_interval=0.05).run(
        [sys.executable, "-c", code]) for code in
        ("raise SystemExit(3)", "pass")] for mod in BOTH]
    assert codes == [[3, 0], [3, 0]]


def _run_agent_subprocess(mod, tmp_path, child_code):
    env = {**os.environ,
           "KUBEDL_PODINFO_ANNOTATIONS": str(tmp_path / "annotations"),
           "KUBEDL_RESTART_POLL_S": "0.1",
           "PYTHONPATH": ROOT}
    return subprocess.Popen(
        [sys.executable, "-m", mod.__name__, "--",
         sys.executable, "-u", "-c", child_code],
        env=env, stdout=subprocess.PIPE)


def _sigterm_case(mod, tmp_path, handler):
    marker = tmp_path / f"{mod.__name__}-terminated"
    child_code = (
        "import signal, sys, time, pathlib\n"
        f"mark = pathlib.Path({str(marker)!r})\n"
        f"signal.signal(signal.SIGTERM, {handler})\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n")
    proc = _run_agent_subprocess(mod, tmp_path, child_code)
    assert proc.stdout.readline().strip() == b"ready"
    proc.send_signal(signal.SIGTERM)
    code = proc.wait(timeout=15)
    deadline = time.time() + 5
    while not marker.exists() and time.time() < deadline:
        time.sleep(0.05)
    return code, marker.exists()


@pytest.mark.parametrize("handler,want", [
    # a trainer that checkpoints and exits 0: a clean container exit
    ("lambda *a: (mark.write_text('x'), sys.exit(0))", (0, True)),
    # one that exits nonzero in its shutdown: that exact code
    ("lambda *a: (mark.write_text('x'), sys.exit(7))", (7, True))],
    ids=["graceful", "nonzero"])
def test_agent_forwards_sigterm_to_child(tmp_path, handler, want):
    """Pod termination: kubelet SIGTERMs the agent (PID 1), which forwards
    it to the trainer's process group and exits with the child's code."""
    got = [_sigterm_case(mod, tmp_path, handler) for mod in BOTH]
    assert got[0] == got[1] == want


def test_the_port_agent_usage_without_a_command():
    res = subprocess.run([sys.executable, "-m", tra.__name__, "--"],
                         env={**os.environ, "PYTHONPATH": ROOT},
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 2
    assert "python -m kubedl_tpu_torch.runtime.restart_agent" in res.stderr
    assert tra.main([]) == jra.main([]) == 2


def test_agent_forwards_sigint_in_process(tmp_path):
    """SIGINT is forwarded as SIGINT, not rewritten to SIGTERM."""
    got = []
    for mod in BOTH:
        marker = tmp_path / f"{mod.__name__}-interrupted"
        agent = mod.RestartAgent(
            annotations_path=str(tmp_path / "annotations"),
            poll_interval=0.05, grace_period=10.0)
        child_code = (
            "import signal, sys, time, pathlib\n"
            f"mark = pathlib.Path({str(marker)!r})\n"
            "signal.signal(signal.SIGINT,"
            " lambda *a: (mark.write_text('x'), sys.exit(5)))\n"
            "time.sleep(60)\n")
        threading.Timer(0.4, os.kill, (os.getpid(), signal.SIGINT)).start()
        code = agent.run([sys.executable, "-u", "-c", child_code])
        got.append((code, marker.exists()))
    assert got[0] == got[1] == (5, True)
