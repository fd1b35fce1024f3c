"""Persist controllers: mirror live objects into storage backends.

The analog of ``controllers/persist`` — optional controllers that subscribe
to job/pod/event traffic and spill each object into the configured object /
event backend (``object/job/job_persist_controller.go:47-75`` and the
per-kind sub-controllers), so records outlive api-server GC and feed the
console's "proxy" read path.

Copied from ``kubedl_tpu/storage/persist.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from ..core import meta as m
from ..core.apiserver import APIServer
from ..core.manager import Manager, Reconciler, Request, Result
from . import dmo
from .backends import EventBackend, ObjectBackend

log = logging.getLogger("kubedl_tpu_torch.persist")

#: default set of mirrored job kinds (reference has one sub-controller per
#: kind: {tf,pytorch,xdl,xgboost,mars}job_persist_controller.go)
DEFAULT_JOB_KINDS = (
    "PyTorchJob", "TFJob", "JAXJob", "MPIJob", "XGBoostJob", "XDLJob",
    "MarsJob", "ElasticDLJob",
)


class ObjectPersistController(Reconciler):
    """One controller per object kind, sharing a backend.

    Registered through :func:`setup_persist_controllers`; ``kind`` is set
    per instance.
    """

    def __init__(self, api: APIServer, backend: ObjectBackend, kind: str,
                 region: str = ""):
        self.api = api
        self.backend = backend
        self.kind = kind
        self.region = region

    def reconcile(self, req: Request) -> Optional[Result]:
        obj = self.api.try_get(self.kind, req.namespace, req.name)
        if obj is None:
            # gone from the api-server: keep the record, flip is_in_etcd
            # (reference jobs "deleted but not removed", mysql.go DeleteJob)
            if self.kind == "Notebook":
                self.backend.delete_notebook(req.namespace, req.name)
            else:
                self.backend.delete_job(req.namespace, req.name)
            return None
        if self.kind == "Notebook":
            self.backend.save_notebook(dmo.notebook_to_record(obj, self.region))
        else:
            self.backend.save_job(dmo.job_to_record(obj, self.region))
        return None


class PodPersistController(ObjectPersistController):
    """Pods need their deletion path keyed by uid, so the lookup above is
    specialised; list_pods with empty job_id can't find them in the SQL
    backend, so we track uid at save time instead."""

    def __init__(self, api: APIServer, backend: ObjectBackend, region: str = ""):
        super().__init__(api, backend, "Pod", region)
        self._uids: dict[tuple, str] = {}

    def reconcile(self, req: Request) -> Optional[Result]:
        obj = self.api.try_get("Pod", req.namespace, req.name)
        if obj is None:
            uid = self._uids.pop((req.namespace, req.name), None)
            if uid:
                self.backend.stop_pod(req.namespace, req.name, uid)
            return None
        self._uids[(req.namespace, req.name)] = m.uid(obj)
        self.backend.save_pod(dmo.pod_to_record(obj, self.region))
        return None


class EventPersistController(Reconciler):
    """Reference ``controllers/persist/event/event_persist_controller.go``."""

    kind = "Event"

    def __init__(self, api: APIServer, backend: EventBackend, region: str = ""):
        self.api = api
        self.backend = backend
        self.region = region

    def reconcile(self, req: Request) -> Optional[Result]:
        obj = self.api.try_get("Event", req.namespace, req.name)
        if obj is None:
            return None  # events are append-only; deletions are not mirrored
        self.backend.save_event(dmo.event_to_record(obj, self.region))
        return None


def setup_persist_controllers(
        api: APIServer, manager: Manager,
        object_backend: Optional[ObjectBackend] = None,
        event_backend: Optional[EventBackend] = None,
        job_kinds: Sequence[str] = DEFAULT_JOB_KINDS,
        region: str = "") -> list:
    """Wire persist controllers into the manager (reference ``main.go:112-118``
    registers storage backends then persist controllers)."""
    ctrls = []
    if object_backend is not None:
        object_backend.initialize()
        for kind in job_kinds:
            ctrls.append(ObjectPersistController(api, object_backend, kind, region))
        ctrls.append(PodPersistController(api, object_backend, region))
        ctrls.append(ObjectPersistController(api, object_backend, "Notebook", region))
    if event_backend is not None:
        event_backend.initialize()
        ctrls.append(EventPersistController(api, event_backend, region))
    for ctrl in ctrls:
        manager.register(ctrl)
    return ctrls
