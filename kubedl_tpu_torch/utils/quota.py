"""Resource accounting (reference ``pkg/util/quota/resources.go`` +
``pkg/util/resource_utils/resources.go``): summing container requests the
kube-scheduler way, job-level totals, and TPU-chip accounting for slice
capacity checks.

Copied from ``kubedl_tpu/utils/quota.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math

from ..api import common as c
from ..core import meta as m

#: the full k8s suffix table (apimachinery ``resource.Quantity``):
#: decimalSI m/k/M/G/T/P/E and binarySI Ki..Ei. ``E`` (exa) is a suffix
#: only when it terminates the string — ``12E6`` is the decimalExponent
#: form (12 x 10^6), handled by the plain-float path below.
_SUFFIXES = {
    "m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15,
    "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
    "Ei": 2**60,
}
#: binary suffixes first so "Ei"/"Ki"... win over the bare decimal suffix
#: their final letter would otherwise match
_SUFFIX_ORDER = ("Ki", "Mi", "Gi", "Ti", "Pi", "Ei",
                 "m", "k", "M", "G", "T", "P", "E")


def parse_quantity(v) -> float:
    """Parse a k8s resource quantity to a float in base units (cores /
    bytes / chips): plain and signed numbers ("2", "-3", "1.5"),
    decimalExponent forms ("123e6", "1E2"), decimalSI ("500m", "10k",
    "2M".."3E") and binarySI ("10Ki".."2Ei") suffixes. Raises ValueError
    on anything else (including inf/nan, which are not quantities)."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    for suf in _SUFFIX_ORDER:
        if s.endswith(suf):
            try:
                num = float(s[: -len(suf)])
            except ValueError:
                break  # suffix matched but the prefix is not a number
                       # ("xKi"): let the plain parse raise on the whole
            if math.isinf(num) or math.isnan(num):
                raise ValueError(f"invalid k8s quantity {v!r}")
            return num * _SUFFIXES[suf]
    f = float(s)  # ValueError on garbage propagates
    if math.isinf(f) or math.isnan(f):
        raise ValueError(f"invalid k8s quantity {v!r}")
    return f


def sum_containers(containers: list) -> dict:
    """Per-resource sum of max(requests, limits) over containers
    (``SumUpContainersResources``)."""
    total: dict[str, float] = {}
    for ct in containers or []:
        res = ct.get("resources", {}) or {}
        req = dict(res.get("requests", {}) or {})
        for key, val in (res.get("limits", {}) or {}).items():
            req.setdefault(key, val)
        for key, val in req.items():
            total[key] = total.get(key, 0.0) + parse_quantity(val)
    return total


def max_containers(containers: list) -> dict:
    """Per-resource max over containers (``MaximumContainersResources`` —
    init containers run sequentially, so their cost is the max)."""
    total: dict[str, float] = {}
    for ct in containers or []:
        one = sum_containers([ct])
        for key, val in one.items():
            total[key] = max(total.get(key, 0.0), val)
    return total


def pod_request(pod_spec: dict) -> dict:
    """Effective pod request = sum(containers) elementwise-max
    max(initContainers) (``GetPodResourceRequest``, kube-scheduler rule)."""
    total = sum_containers(pod_spec.get("containers"))
    for key, val in max_containers(pod_spec.get("initContainers")).items():
        total[key] = max(total.get(key, 0.0), val)
    return total


def job_request(replica_specs: dict) -> dict:
    """Whole-job request: per-replica pod request x replicas."""
    total: dict[str, float] = {}
    for spec in (replica_specs or {}).values():
        replicas = int(spec.get("replicas", 1) or 0)
        pod = m.get_in(spec, "template", "spec", default={}) or {}
        for key, val in pod_request(pod).items():
            total[key] = total.get(key, 0.0) + val * replicas
    return total


def tpu_chips(replica_specs: dict) -> int:
    """Total google.com/tpu chips the job requests."""
    return int(job_request(replica_specs).get(c.RESOURCE_TPU, 0))
