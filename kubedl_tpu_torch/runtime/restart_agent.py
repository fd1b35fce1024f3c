"""In-container restart agent: the port's copy of
``kubedl_tpu/runtime/restart_agent.py`` (framework-free; the port imports
nothing of the JAX package, so its image carries its own).

The portable analog of OpenKruise's
ContainerRecreateRequest (reference ``controllers/pytorch/elastic_scale.go``
~330-400, where stale-generation containers are restarted at the CRI level
so the pod keeps its node across an elastic resize).

Kubernetes has no portable "restart this container in place" verb, but it
*does* restart a container whose main process exits (restartPolicy
OnFailure/Always) while keeping the pod — same UID, same node binding,
and on GKE TPU the same slice. This agent makes that controllable:

1. The operator patches the pod's ``kubedl.io/restart-requested-generation``
   annotation (plus the new ``world-size``) instead of deleting the pod.
2. The agent, wrapped around the training command inside the container,
   tails the downward-API annotations file; when the requested generation
   moves past the generation it started at, it gracefully terminates the
   training process group.
3. kubelet restarts the container in place; the downward-API ``WORLD_SIZE``
   env re-resolves against the patched annotation, so the restarted
   trainer sees the resized world without the pod ever being
   surrendered (``runtime.bootstrap`` reads it with the PyTorchJob's
   ``MASTER_ADDR``/``MASTER_PORT``/``RANK``, and the trainer resumes from
   the checkpoint the elastic agent took for the resize).

Usage as PID-1 wrapper::

    python -m kubedl_tpu_torch.runtime.restart_agent -- \
        python -m kubedl_tpu_torch.train --config /etc/train.json

The annotations file is the standard downward-API volume rendering of
``metadata.annotations`` (``key="escaped value"`` per line), mounted by the
engine at $KUBEDL_PODINFO_ANNOTATIONS for elastic replicas.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

#: must match controllers.workloads.pytorch restart request annotation
RESTART_ANNOTATION = "kubedl.io/restart-requested-generation"
DEFAULT_ANNOTATIONS_PATH = "/etc/kubedl-podinfo/annotations"


def parse_annotations_file(text: str) -> dict:
    """Parse the kubelet's downward-API rendering: one ``key="value"`` per
    line with Go-escaped values."""
    out = {}
    for line in text.splitlines():
        key, sep, val = line.partition("=")
        key = key.strip()
        if not sep or not key:
            continue  # malformed / orphan line: skip, don't crash PID 1
        val = val.strip()
        if val.startswith('"') and val.endswith('"') and len(val) >= 2:
            val = val[1:-1]
            # unescape the common Go quoting (\" \\ \n)
            val = (val.replace(r"\\", "\x00").replace(r"\"", '"')
                      .replace(r"\n", "\n").replace("\x00", "\\"))
        out[key] = val
    return out


def read_requested_generation(path: str) -> int:
    try:
        with open(path) as f:
            anns = parse_annotations_file(f.read())
    except OSError:
        return 0
    try:
        return int(anns.get(RESTART_ANNOTATION, 0) or 0)
    except ValueError:
        return 0


@dataclass
class RestartAgent:
    """Supervises one training process; exits it when a restart is
    requested so kubelet recreates the container in place."""

    annotations_path: str = DEFAULT_ANNOTATIONS_PATH
    poll_interval: float = 2.0
    grace_period: float = 30.0
    #: test seam: agent-observed restarts (generation transitions)
    on_restart: Optional[Callable[[int], None]] = None

    def run(self, argv: list) -> int:
        """Exec ``argv`` as a child process group and supervise it.

        Returns the child's exit code, or 64 + SIGTERM after a requested
        restart (a nonzero code, so OnFailure restart policies fire).

        The agent usually runs as PID 1, and the child lives in its own
        session (trainers fork dataloaders; we signal the whole group) —
        so pod termination signals land on the agent only. The *received*
        signal (SIGTERM on pod stop, SIGINT on ^C) is forwarded to the
        child's whole process group, and the agent then exits with the
        child's own exit code: a trainer that checkpoints and exits 0 on
        SIGTERM yields a clean container exit (no spurious OnFailure
        restart), while one killed by the signal yields the conventional
        128+signum — which the engine's exit-code taxonomy classifies as
        retryable."""
        baseline = read_requested_generation(self.annotations_path)
        child = subprocess.Popen(argv, start_new_session=True)
        stop = {"sig": None}

        def forward(signum, frame):
            stop["sig"] = signum

        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, forward)
            except ValueError:
                pass  # non-main thread (tests): kubelet path unaffected
        try:
            while True:
                code = child.poll()
                if code is not None:
                    return code
                if stop["sig"] is not None:
                    return self._forward_and_reap(child, stop["sig"])
                current = read_requested_generation(self.annotations_path)
                if current > baseline:
                    if self.on_restart is not None:
                        self.on_restart(current)
                    self._terminate(child)
                    return 64 + signal.SIGTERM
                time.sleep(self.poll_interval)
        finally:
            if child.poll() is None:
                self._terminate(child)
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    def _forward_and_reap(self, child: subprocess.Popen, signum: int) -> int:
        """Forward ``signum`` to the child's whole process group, wait out
        the grace period (SIGKILL escalation like kubelet), and surface the
        child's exit code (128+N when it died by signal N)."""
        try:
            os.killpg(child.pid, signum)
        except (ProcessLookupError, PermissionError):
            pass
        deadline = time.monotonic() + self.grace_period
        while time.monotonic() < deadline:
            if child.poll() is not None:
                break
            time.sleep(0.1)
        else:
            try:
                os.killpg(child.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        code = child.wait()
        return code if code >= 0 else 128 - code

    def _terminate(self, child: subprocess.Popen) -> None:
        """SIGTERM the whole process group (trainers fork dataloaders),
        escalate to SIGKILL after the grace period — the same downgrade
        kubelet applies on container stop."""
        try:
            os.killpg(child.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.monotonic() + self.grace_period
        while time.monotonic() < deadline:
            if child.poll() is not None:
                return
            time.sleep(0.1)
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        child.wait()


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--":
        argv = argv[1:]
    if not argv:
        print("usage: python -m kubedl_tpu_torch.runtime.restart_agent -- "
              "CMD...", file=sys.stderr)
        return 2
    agent = RestartAgent(
        annotations_path=os.environ.get("KUBEDL_PODINFO_ANNOTATIONS",
                                        DEFAULT_ANNOTATIONS_PATH),
        poll_interval=float(os.environ.get("KUBEDL_RESTART_POLL_S", 2.0)),
        grace_period=float(os.environ.get("KUBEDL_RESTART_GRACE_S", 30.0)))
    return agent.run(argv)


if __name__ == "__main__":
    sys.exit(main())
