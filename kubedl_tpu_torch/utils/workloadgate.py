"""Workload enablement gate.

Behavioral analog of ``pkg/util/workloadgate/workload_gate.go:27-61``: which
workload kinds the operator runs, decided by (priority order) the
``WORKLOADS_ENABLE`` env, then the ``--workloads`` flag, then CRD
auto-detection. The spec grammar is the reference's: ``*`` enables all,
``Kind`` enables one, ``-Kind`` disables one, ``auto`` defers to whether the
kind's CRD is installed.

Copied from ``kubedl_tpu/utils/workloadgate.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional

ENV_WORKLOADS_ENABLE = "WORKLOADS_ENABLE"
AUTO = "auto"


def parse_workloads_enabled(spec: str) -> tuple[dict, bool]:
    """Returns (per-kind {kind: enabled}, enable_all)."""
    enables: dict[str, bool] = {}
    enable_all = False
    for workload in spec.split(","):
        workload = workload.strip()
        if not workload:
            continue
        enable = True
        if workload.startswith("-"):
            enable = False
            workload = workload[1:]
        if workload == "*":
            enable_all = enable
        else:
            enables[workload] = enable
    return enables, enable_all


def is_workload_enabled(kind: str, spec: Optional[str] = None,
                        env: Optional[dict] = None,
                        crd_installed: Optional[Callable[[str], bool]] = None,
                        ) -> bool:
    """Env overrides flag (workload_gate.go:48-56); ``auto`` asks
    ``crd_installed`` (the discovery-client analog; defaults to yes, matching
    a self-hosted control plane where every kind is served)."""
    env = env if env is not None else dict(os.environ)
    effective = env.get(ENV_WORKLOADS_ENABLE) or spec or AUTO
    if effective == AUTO:
        return crd_installed(kind) if crd_installed else True
    enables, enable_all = parse_workloads_enabled(effective)
    if kind in enables:
        return enables[kind]
    return enable_all


def enabled_kinds(all_kinds: Iterable[str], spec: Optional[str] = None,
                  env: Optional[dict] = None,
                  crd_installed: Optional[Callable[[str], bool]] = None) -> list:
    return [k for k in all_kinds
            if is_workload_enabled(k, spec, env, crd_installed)]
