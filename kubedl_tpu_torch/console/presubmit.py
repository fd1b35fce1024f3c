"""Job pre-submit hooks — console-side manifest fixups before create.

Reference ``console/backend/pkg/handlers/job_presubmit_hooks.go``: the Gin
job handler runs a per-kind hook chain on every submitted job so manifests
that came out of the web form are normalized before they reach the
admission chain:

* TFJob: a single-Worker job with no Chief is converted to a Chief-only
  job (``tfJobPreSubmitAutoConvertReplicas``, ``:30-46``).
* PyTorchJob: worker-only jobs get a Master carved out of the workers
  (``pytorchJobPreSubmitAutoConvertReplicas``, ``:117-156``).
* Both: the ``kubedl.io/tensorboard-config`` annotation gets defaults
  (TTL 1h, ingress path prefix ``/{ns}/{name}``, update timestamp;
  ``presubmitTensorBoardDefaults``, ``:99-115``).

Hooks mutate the manifest dict in place; unknown kinds pass through.

Copied from ``kubedl_tpu/console/presubmit.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json

from ..api import common as c
from ..core import meta as m

#: 1h, reference job_presubmit_hooks.go:101
DEFAULT_TB_TTL = 60 * 60


def _replica_specs(job: dict, field: str) -> dict:
    return m.get_in(job, "spec", field, default=None) or {}


def _replicas(spec: dict) -> int:
    if spec is None:
        return 0
    val = spec.get("replicas", 1)
    # absent/None defaults to 1 (k8s nil-replicas semantics); an explicit
    # 0 stays 0 — the reference counts *Replicas verbatim
    return 1 if val is None else int(val)


def tf_auto_convert_replicas(job: dict) -> None:
    """totalReplicas==1 with a Worker and no Chief → rename Worker to Chief
    (tf treats the chief as worker-0; a 1-worker job IS the chief)."""
    specs = _replica_specs(job, "tfReplicaSpecs")
    if not specs:
        return
    total = sum(_replicas(s) for rt, s in specs.items()
                if rt != "TensorBoard")
    if total == 1 and "Worker" in specs and "Chief" not in specs:
        specs["Chief"] = specs.pop("Worker")


def pytorch_auto_convert_replicas(job: dict) -> None:
    """Worker-only job → move one worker into a Master replica (torch DDP
    needs rank 0 at a stable address)."""
    specs = _replica_specs(job, "pytorchReplicaSpecs")
    if not specs:
        return
    workers = _replicas(specs.get("Worker")) if "Worker" in specs else 0
    masters = _replicas(specs.get("Master")) if "Master" in specs else 0
    if masters == 0 and workers > 0:
        master = json.loads(json.dumps(specs["Worker"]))  # deep copy
        master["replicas"] = 1
        specs["Master"] = master
        workers -= 1
        if workers <= 0:
            del specs["Worker"]
        else:
            specs["Worker"]["replicas"] = workers


def tensorboard_defaults(job: dict) -> None:
    """Fill TB-config defaults the web form leaves empty."""
    anns = m.annotations(job)
    raw = anns.get(c.ANNOTATION_TENSORBOARD_CONFIG)
    if not raw:
        return
    try:
        tb = json.loads(raw)
    except ValueError:
        return
    if not isinstance(tb, dict):
        return
    tb.setdefault("ttlSecondsAfterJobFinished", DEFAULT_TB_TTL)
    ingress = tb.get("ingress")
    if isinstance(ingress, dict) and not ingress.get("pathPrefix"):
        ingress["pathPrefix"] = f"/{m.namespace(job)}/{m.name(job)}"
    if not tb.get("image"):
        # form-submitted jobs usually omit the TB image; default to the
        # main container's image which has tensorboard in ML base images
        for field in ("tfReplicaSpecs", "pytorchReplicaSpecs"):
            for spec in _replica_specs(job, field).values():
                containers = m.get_in(spec, "template", "spec", "containers",
                                      default=[]) or []
                if containers and containers[0].get("image"):
                    tb["image"] = containers[0]["image"]
                    break
            if tb.get("image"):
                break
    job.setdefault("metadata", {}).setdefault("annotations", {})[
        c.ANNOTATION_TENSORBOARD_CONFIG] = json.dumps(tb, sort_keys=True)


#: kind → ordered hook chain (job_presubmit_hooks.go hook table)
PRE_SUBMIT_HOOKS = {
    "TFJob": (tf_auto_convert_replicas, tensorboard_defaults),
    "PyTorchJob": (pytorch_auto_convert_replicas, tensorboard_defaults),
}


def run_pre_submit_hooks(job: dict) -> dict:
    for hook in PRE_SUBMIT_HOOKS.get(m.kind(job), ()):
        hook(job)
    return job
