"""ThroughputProfile API object: persisted per-(profile, pool) throughput.

Gavel (PAPERS.md, arxiv 2008.09213) makes throughput-normalized
per-(job, accelerator) profiles the currency of heterogeneous
scheduling. This cluster-scoped object is where the telemetry layer
(``kubedl_tpu_torch/telemetry/profiles.py``) persists its online estimates so
they survive operator restarts and so the slice scheduler (ROADMAP
item 2) can consume them without talking to the tracer:

    apiVersion: telemetry.kubedl.io/v1alpha1
    kind: ThroughputProfile
    metadata: {name: testjob}          # sanitized profile key
    status:
      pools:
        tpu-v5p-slice/2x2x4:
          tokensPerSecond: 48211.5     # decayed online estimate
          weight: 17.2                 # decayed sample confidence
          samples: 40                  # raw observations folded in
          updatedAt: 1726012800.0

The estimate math (exponentially-decayed running mean with a half-life)
lives in :mod:`kubedl_tpu_torch.telemetry.profiles`; this module only shapes
the object.

Copied from ``kubedl_tpu/api/throughputprofile.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import hashlib
import re

PROFILE_KIND = "ThroughputProfile"
PROFILE_API_VERSION = "telemetry.kubedl.io/v1alpha1"

_NAME_RE = re.compile(r"[^a-z0-9.-]+")


def profile_object_name(key: str) -> str:
    """DNS-1123-ish name for a profile key (job kind / model id): lower,
    invalid runs collapsed to ``-``, bounded length. When sanitization
    is lossy (collapsed chars or truncation), a short hash of the raw
    key is appended so distinct keys can never collide on one object
    (``llama_3`` and ``llama-3`` would otherwise overwrite each other's
    persisted estimates on every flush)."""
    raw = str(key)
    name = _NAME_RE.sub("-", raw.lower()).strip("-.") or "profile"
    if name != raw.lower() or len(name) > 63:
        digest = hashlib.sha256(raw.encode()).hexdigest()[:6]
        name = f"{name[:56].rstrip('-.')}-{digest}"
    return name


def profile_to_obj(key: str, pools: dict) -> dict:
    """Render one profile's per-pool estimates as the API object."""
    return {
        "apiVersion": PROFILE_API_VERSION,
        "kind": PROFILE_KIND,
        "metadata": {"name": profile_object_name(key)},
        "spec": {"key": str(key)},
        "status": {"pools": {
            pool: {
                "tokensPerSecond": round(float(e["rate"]), 4),
                "weight": round(float(e["weight"]), 4),
                "samples": int(e["samples"]),
                "updatedAt": round(float(e["updated_at"]), 3),
            } for pool, e in sorted(pools.items())
        }},
    }


def pools_from_obj(obj: dict) -> dict:
    """Inverse of :func:`profile_to_obj`: the store's internal per-pool
    entry dicts (malformed entries are dropped, never raised — a hand-
    edited object degrades to a cold profile)."""
    out = {}
    for pool, e in (((obj.get("status") or {}).get("pools")) or {}).items():
        try:
            out[pool] = {
                "rate": float(e["tokensPerSecond"]),
                "weight": float(e.get("weight", 1.0)),
                "samples": int(e.get("samples", 1)),
                "updated_at": float(e.get("updatedAt", 0.0)),
            }
        except (KeyError, TypeError, ValueError):
            continue
    return out
