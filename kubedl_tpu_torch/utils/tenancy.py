"""Multi-tenancy extraction (reference ``pkg/util/tenancy/tenancy.go``):
the ``kubedl.io/tenancy`` annotation carries tenant/user/idc/region for
quota attribution and the persistence layer's tenant columns.

Copied from ``kubedl_tpu/utils/tenancy.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from ..api import common as c
from ..core import meta as m


@dataclass(frozen=True)
class Tenancy:
    tenant: str = ""
    user: str = ""
    idc: str = ""
    region: str = ""


def get_tenancy(obj: dict) -> Optional[Tenancy]:
    """Parse the tenancy annotation; None when absent, raises ValueError on
    malformed JSON (the caller decides whether that fails the job)."""
    raw = m.annotations(obj).get(c.ANNOTATION_TENANCY_INFO)
    if raw is None:
        return None
    data = json.loads(raw)
    if not isinstance(data, dict):
        raise ValueError(f"tenancy annotation must be an object, got {data!r}")
    return Tenancy(tenant=data.get("tenant", ""), user=data.get("user", ""),
                   idc=data.get("idc", ""), region=data.get("region", ""))
