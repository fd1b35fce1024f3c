"""Host-network mode for job pods.

Behavioral analog of ``pkg/job_controller/hostnetwork.go:30-101`` +
``pod.go:509-521`` + ``service.go:236-250``: pods annotated with
``kubedl.io/network-mode: host`` run with ``hostNetwork: true`` and a
*random* container/host port from a configurable range (default
[20000, 30000), reference ``main.go:69``), so multiple replicas can share a
node. Because a failed-over replica lands on a new random port, the engine
re-syncs each replica service's targetPort to the live pod's port every
round — this is the fail-over port re-sync that keeps rendezvous addresses
stable (peers keep dialing the service port; only targetPort moves).

On TPU this path matters for the *DCN/coordinator* legs only: ICI inside a
slice is wired by the TPU runtime without pod networking (SURVEY.md §5), but
the PJRT coordinator and megascale services still ride the pod network.

Copied from ``kubedl_tpu/controllers/hostnetwork.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import random
from typing import Optional

from ..api import common as c
from ..core import meta as m
from ..tpu import placement as pl

DEFAULT_PORT_RANGE = (20000, 10000)  # (base, size): [20000, 30000)


def enable_hostnetwork(job: dict) -> bool:
    return m.annotations(job).get(c.ANNOTATION_NETWORK_MODE) == c.NETWORK_MODE_HOST


def random_port(port_range: tuple = DEFAULT_PORT_RANGE,
                rng: Optional[random.Random] = None,
                exclude: Optional[set] = None) -> int:
    """Random port from the range, avoiding ``exclude`` (ports already
    assigned to this job's live replicas, learned each reconcile round).

    The reference draws blind (hostnetwork.go:30-46) and leans entirely on
    the scheduler's hostPort filter; avoiding known-taken ports up front
    removes the self-collision case — two replicas of one job racing for
    the same port on one node (round-2 weak #5). Truly node-scoped
    tracking is impossible before the scheduler picks a node; cross-job
    collisions still resolve through the scheduler's hostPort filter."""
    base, size = port_range
    rng = rng or random
    if exclude:
        free = size - len(exclude)
        if free > 0:
            for _ in range(64):  # cheap draws before falling back to scan
                port = rng.randrange(base, base + size)
                if port not in exclude:
                    return port
            for port in range(base, base + size):
                if port not in exclude:
                    return port
    return rng.randrange(base, base + size)


def setup_pod_hostnetwork(pod: dict, container_name: str, port_name: str,
                          port: int) -> bool:
    """hostNetwork + ClusterFirstWithHostNet DNS (critical: headless-svc
    names must still resolve in-pod) + container port pinned to ``port``.
    Returns False when no container matched (port NOT pinned) so callers
    don't advertise a port nothing listens on."""
    spec = pod.setdefault("spec", {})
    spec["hostNetwork"] = True
    spec["dnsPolicy"] = "ClusterFirstWithHostNet"
    ctr = pl.find_container(spec, container_name)
    if ctr is None:
        return False
    ports = ctr.setdefault("ports", [])
    for p in ports:
        if p.get("name") == port_name:
            p["containerPort"] = port
            p["hostPort"] = port
            return True
    ports.append({"name": port_name, "containerPort": port, "hostPort": port})
    return True


def get_pod_hostnetwork_port(pod: dict, container_name: str,
                             port_name: str) -> Optional[int]:
    """The port a live pod actually listens on (hostnetwork.go:80-101)."""
    ctr = pl.find_container(pod.get("spec", {}), container_name)
    if ctr is None:
        return None
    ports = ctr.get("ports") or []
    for p in ports:
        if p.get("name") == port_name:
            return p.get("containerPort")
    return ports[0].get("containerPort") if ports else None
