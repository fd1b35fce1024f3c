"""Data-source / code-source / workspace handlers for the console.

The reference keeps data sources and code sources as JSON maps inside
ConfigMaps (``console/backend/pkg/handlers/data_source.go:20-23``
``kubedl-datasource-config``/key ``datasource``;
``handlers/code_source.go`` ``kubedl-codesource-config``/key ``codesource``)
so they survive console restarts and are shared between replicas. The same
scheme carries over verbatim onto the standalone/in-cluster API server.

Workspaces (``routers/api/workspace.go:38-104``) are rows in the object
backend plus a companion data source named ``workspace-{name}`` and a
PVC-shaped storage claim.

Copied from ``kubedl_tpu/console/sources.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional

from ..core import meta as m
from ..core.apiserver import Conflict, NotFound
from ..storage.backends import ObjectBackend, Query
from ..storage.dmo import WorkspaceRecord

#: reference model/workspace.go:3-4
WORKSPACE_PREFIX = "workspace-"
WORKSPACE_LABEL = "kubedl.io/workspace-name"

DATASOURCE_CONFIGMAP = "kubedl-datasource-config"
DATASOURCE_KEY = "datasource"
CODESOURCE_CONFIGMAP = "kubedl-codesource-config"
CODESOURCE_KEY = "codesource"
CONSOLE_NAMESPACE = "kubedl-system"


@dataclass
class DataSource:
    """Reference ``model.DataSource`` (``model/data_source.go``)."""
    name: str = ""
    userid: str = ""
    username: str = ""
    namespace: str = ""
    type: str = ""
    pvc_name: str = ""
    local_path: str = ""
    description: str = ""
    create_time: str = ""
    update_time: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class CodeSource:
    """Reference ``model.CodeSource`` (``model/code_source.go``)."""
    name: str = ""
    userid: str = ""
    username: str = ""
    type: str = ""              # "git"
    code_path: str = ""
    default_branch: str = ""
    local_path: str = ""
    description: str = ""
    create_time: str = ""
    update_time: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


class _ConfigMapStore:
    """Named JSON map inside a ConfigMap, with get-or-create and
    conflict-retried updates (reference ``data_source.go:34-128``)."""

    def __init__(self, api, cm_name: str, key: str,
                 namespace: str = CONSOLE_NAMESPACE):
        self.api = api
        self.cm_name = cm_name
        self.key = key
        self.namespace = namespace

    def _get_or_create(self) -> dict:
        cm = self.api.try_get("ConfigMap", self.namespace, self.cm_name)
        if cm is None:
            cm = m.new_obj("v1", "ConfigMap", self.cm_name, self.namespace)
            cm["data"] = {self.key: "{}"}
            try:
                cm = self.api.create(cm)
            except Conflict:
                cm = self.api.get("ConfigMap", self.namespace, self.cm_name)
        return cm

    def load(self) -> dict:
        cm = self._get_or_create()
        raw = (cm.get("data") or {}).get(self.key) or "{}"
        try:
            return json.loads(raw)
        except ValueError:
            return {}

    def mutate(self, fn) -> None:
        """Read-modify-write with one Conflict retry (two concurrent console
        replicas racing on the same ConfigMap)."""
        for attempt in (0, 1):
            cm = self._get_or_create()
            raw = (cm.get("data") or {}).get(self.key) or "{}"
            try:
                entries = json.loads(raw)
            except ValueError:
                entries = {}
            fn(entries)
            cm.setdefault("data", {})[self.key] = json.dumps(
                entries, sort_keys=True)
            try:
                self.api.update(cm)
                return
            except Conflict:
                if attempt:
                    raise


class DataSourceHandler:
    """Reference ``handlers.DataSourceHandler`` (``data_source.go``)."""

    entry_cls = DataSource
    configmap = DATASOURCE_CONFIGMAP
    key = DATASOURCE_KEY

    def __init__(self, api, namespace: str = CONSOLE_NAMESPACE):
        self.store = _ConfigMapStore(api, self.configmap, self.key, namespace)

    def create(self, entry) -> None:
        def add(entries: dict):
            if entry.name in entries:
                raise ValueError(f"{entry.name!r} already exists")
            entries[entry.name] = entry.to_dict()
        if not entry.name:
            raise ValueError("name is empty")
        self.store.mutate(add)

    def update(self, entry) -> None:
        def put(entries: dict):
            prev = entries.get(entry.name) or {}
            # create_time is immutable across updates (data_source.go:100)
            entry.create_time = prev.get("create_time", entry.create_time)
            entries[entry.name] = entry.to_dict()
        if not entry.name:
            raise ValueError("name is empty")
        self.store.mutate(put)

    def delete(self, name: str) -> None:
        def drop(entries: dict):
            if name not in entries:
                raise KeyError(f"{name!r} not found")
            del entries[name]
        if not name:
            raise ValueError("name is empty")
        self.store.mutate(drop)

    def get(self, name: str):
        entry = self.store.load().get(name)
        if entry is None:
            raise KeyError(f"{name!r} not found")
        return entry

    def list(self) -> dict:
        return self.store.load()


class CodeSourceHandler(DataSourceHandler):
    """Reference ``handlers.CodeSourceHandler`` (``code_source.go``)."""

    entry_cls = CodeSource
    configmap = CODESOURCE_CONFIGMAP
    key = CODESOURCE_KEY


class WorkspaceHandler:
    """Workspace CRUD (reference ``routers/api/workspace.go:38-164``):
    a backend row + a companion ``workspace-{name}`` data source + a PVC
    the workspace's jobs and notebooks mount."""

    def __init__(self, api, backend: ObjectBackend,
                 datasources: DataSourceHandler, now_fn):
        self.api = api
        self.backend = backend
        self.datasources = datasources
        self.now = now_fn

    def create(self, rec: WorkspaceRecord) -> None:
        if not rec.name:
            raise ValueError("workspace name is empty")
        now = self.now()
        rec.namespace = rec.namespace or "default"
        rec.create_time = rec.create_time or now
        rec.update_time = now
        rec.status = rec.status or "Created"
        if not rec.pvc_name:
            rec.pvc_name = WORKSPACE_PREFIX + rec.name
        if self.backend.get_workspace(rec.name) is not None:
            raise ValueError(f"workspace {rec.name!r} already exists")
        # companion data source first (workspace.go:66-84): it is the piece
        # most likely to conflict (user-created name collision), and failing
        # here leaves nothing behind
        self.datasources.create(DataSource(
            name=WORKSPACE_PREFIX + rec.name,
            pvc_name=rec.pvc_name,
            local_path=rec.local_path,
            description=f"storage for workspace {rec.name}",
            create_time=now,
            userid="kubedl-system",
            username="kubedl-system",
            namespace=rec.namespace,
        ))
        try:
            # companion PVC so jobs can mount the workspace storage
            if self.api.try_get("PersistentVolumeClaim",
                                rec.namespace, rec.pvc_name) is None:
                pvc = m.new_obj("v1", "PersistentVolumeClaim", rec.pvc_name,
                                rec.namespace,
                                labels={WORKSPACE_LABEL: rec.name})
                pvc["spec"] = {
                    "accessModes": ["ReadWriteMany"],
                    "resources": {"requests": {
                        "storage": f"{max(rec.storage, 1)}Gi"}},
                }
                try:
                    self.api.create(pvc)
                except Conflict:
                    pass
            self.backend.create_workspace(rec)
        except Exception:
            # roll the data source back so a failed create is retryable
            try:
                self.datasources.delete(WORKSPACE_PREFIX + rec.name)
            except KeyError:
                pass
            raise

    def delete(self, name: str) -> None:
        # grab the record before it goes: it carries the PVC coordinates,
        # avoiding a cluster-wide PVC LIST per delete
        rec = self.backend.get_workspace(name)
        self.backend.delete_workspace(name)
        try:
            self.datasources.delete(WORKSPACE_PREFIX + name)
        except KeyError:
            pass
        if rec is not None and rec.pvc_name:
            # only reap PVCs this handler created (they carry the workspace
            # label); an adopted pre-existing PVC is the user's data
            pvc = self.api.try_get("PersistentVolumeClaim",
                                   rec.namespace or "default", rec.pvc_name)
            if pvc is not None and m.labels(pvc).get(WORKSPACE_LABEL) == name:
                try:
                    self.api.delete("PersistentVolumeClaim",
                                    rec.namespace or "default", rec.pvc_name)
                except NotFound:
                    pass

    def list(self, query: Query) -> list:
        rows = self.backend.list_workspaces(query)
        if rows:
            # one LIST instead of a GET per row (N+1 against a real
            # apiserver); workspace PVCs carry the workspace-name label
            bound = {
                (m.namespace(pvc), m.name(pvc))
                for pvc in self.api.list("PersistentVolumeClaim")
                if m.get_in(pvc, "status", "phase", default="") == "Bound"}
            for rec in rows:
                if (rec.namespace or "default", rec.pvc_name) in bound:
                    rec.status = "Ready"
        return rows

    def detail(self, name: str) -> Optional[WorkspaceRecord]:
        rec = self.backend.get_workspace(name)
        if rec is not None:
            self._refresh_status(rec)
        return rec

    def _refresh_status(self, rec: WorkspaceRecord) -> None:
        """Created → Ready once the PVC reports Bound (workspace.go:28)."""
        pvc = self.api.try_get("PersistentVolumeClaim",
                               rec.namespace or "default", rec.pvc_name)
        if pvc is not None and m.get_in(
                pvc, "status", "phase", default="") == "Bound":
            rec.status = "Ready"
