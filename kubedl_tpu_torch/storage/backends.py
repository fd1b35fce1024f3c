"""Storage backends: interface + registry + memory/SQLite implementations.

The reference's ``pkg/storage/backends`` (``interface.go:31-84`` object and
event backend contracts, ``registry/registry.go:34-59`` name→backend
registry) with the MySQL/gorm implementation (``backends/objects/mysql``)
re-based on stdlib ``sqlite3`` — the natural embedded store for a
single-binary operator on a TPU VM; the schema and query surface carry over
column-for-column so a MySQL backend could be slotted in unchanged.

Copied from ``kubedl_tpu/storage/backends.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import sqlite3
import threading
from dataclasses import dataclass, field
from typing import Optional

from . import dmo
from .dmo import (DELETED, EventRecord, JobRecord, NotebookRecord, PodRecord,
                  WorkspaceRecord)


@dataclass
class Query:
    """Job list filter (reference ``backends/query.go`` Query)."""
    job_id: str = ""
    name: str = ""
    namespace: str = ""
    kind: str = ""
    region: str = ""
    status: str = ""
    start_time: str = ""     # gmt_created >= start_time
    end_time: str = ""       # gmt_created <= end_time
    deleted: Optional[int] = None
    page_num: int = 0        # 1-based; 0 = no pagination
    page_size: int = 0
    count: int = field(default=0, compare=False)  # out: total before paging


def _match(rec, q: Query, kind_field: bool = True) -> bool:
    if q.job_id and rec.job_id != q.job_id:
        return False
    if q.name and q.name not in rec.name:
        return False
    if q.namespace and rec.namespace != q.namespace:
        return False
    if kind_field and q.kind and rec.kind != q.kind:
        return False
    if q.status and rec.status != q.status:
        return False
    if q.region and rec.deploy_region != q.region:
        return False
    if q.start_time and rec.gmt_created < q.start_time:
        return False
    if q.end_time and rec.gmt_created > q.end_time:
        return False
    if q.deleted is not None and rec.deleted != q.deleted:
        return False
    return True


def _paginate(rows: list, q: Query) -> list:
    q.count = len(rows)
    if q.page_num > 0 and q.page_size > 0:
        lo = (q.page_num - 1) * q.page_size
        return rows[lo:lo + q.page_size]
    return rows


class ObjectBackend:
    """Reference ``ObjectStorageBackend`` (``interface.go:31-68``)."""

    name = ""

    def initialize(self) -> None: ...
    def close(self) -> None: ...

    def save_job(self, rec: JobRecord) -> None:
        raise NotImplementedError

    def get_job(self, namespace: str, name: str, job_id: str = "") -> Optional[JobRecord]:
        raise NotImplementedError

    def list_jobs(self, query: Query) -> list:
        raise NotImplementedError

    def stop_job(self, namespace: str, name: str, job_id: str = "") -> None:
        raise NotImplementedError

    def delete_job(self, namespace: str, name: str, job_id: str = "") -> None:
        """Mark the record as gone from the api-server; keep the row."""
        raise NotImplementedError

    def save_pod(self, rec: PodRecord) -> None:
        raise NotImplementedError

    def list_pods(self, namespace: str, job_name: str, job_id: str) -> list:
        raise NotImplementedError

    def stop_pod(self, namespace: str, name: str, pod_id: str) -> None:
        raise NotImplementedError

    def save_notebook(self, rec: NotebookRecord) -> None:
        raise NotImplementedError

    def list_notebooks(self, query: Query) -> list:
        raise NotImplementedError

    def delete_notebook(self, namespace: str, name: str, notebook_id: str = "") -> None:
        raise NotImplementedError

    # -- workspaces (reference interface.go:60-65) ------------------------

    def create_workspace(self, rec: WorkspaceRecord) -> None:
        raise NotImplementedError

    def list_workspaces(self, query: Query) -> list:
        raise NotImplementedError

    def get_workspace(self, name: str) -> Optional[WorkspaceRecord]:
        raise NotImplementedError

    def delete_workspace(self, name: str) -> None:
        raise NotImplementedError


class EventBackend:
    """Reference ``EventStorageBackend`` (``interface.go:70-84``)."""

    name = ""

    def initialize(self) -> None: ...
    def close(self) -> None: ...

    def save_event(self, rec: EventRecord) -> None:
        raise NotImplementedError

    def list_events(self, obj_namespace: str, obj_name: str, obj_uid: str = "",
                    from_time: str = "", to_time: str = "") -> list:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# In-memory backend (the fake for tests + zero-dep default)
# ---------------------------------------------------------------------------


class MemoryBackend(ObjectBackend, EventBackend):
    name = "memory"

    def __init__(self):
        self._jobs: dict[str, JobRecord] = {}       # key: uid
        self._pods: dict[str, PodRecord] = {}
        self._notebooks: dict[str, NotebookRecord] = {}
        self._events: dict[tuple, EventRecord] = {}  # (obj_uid, name)
        self._workspaces: dict[str, WorkspaceRecord] = {}  # key: name
        self._lock = threading.RLock()

    def save_job(self, rec: JobRecord) -> None:
        with self._lock:
            prev = self._jobs.get(rec.job_id)
            if prev is not None:
                rec.gmt_created = prev.gmt_created or rec.gmt_created
                # a terminal/running timestamp never un-happens
                rec.gmt_job_running = rec.gmt_job_running or prev.gmt_job_running
                rec.gmt_job_finished = rec.gmt_job_finished or prev.gmt_job_finished
            self._jobs[rec.job_id] = rec

    def get_job(self, namespace, name, job_id=""):
        with self._lock:
            if job_id:
                rec = self._jobs.get(job_id)
                return rec if rec and rec.namespace == namespace else None
            for rec in self._jobs.values():
                if rec.namespace == namespace and rec.name == name:
                    return rec
        return None

    def list_jobs(self, query: Query) -> list:
        with self._lock:
            rows = [r for r in self._jobs.values() if _match(r, query)]
        rows.sort(key=lambda r: r.gmt_created, reverse=True)
        return _paginate(rows, query)

    def stop_job(self, namespace, name, job_id=""):
        # mutate under the lock: get_job releases it before returning, and
        # an unlocked field write races concurrent save_job replacements
        with self._lock:
            rec = self.get_job(namespace, name, job_id)
            if rec is not None:
                rec.status = "Stopped"

    def delete_job(self, namespace, name, job_id=""):
        with self._lock:
            rec = self.get_job(namespace, name, job_id)
            if rec is not None:
                rec.deleted = DELETED
                rec.is_in_etcd = 0

    def save_pod(self, rec: PodRecord) -> None:
        with self._lock:
            prev = self._pods.get(rec.pod_id)
            if prev is not None:
                rec.gmt_created = prev.gmt_created or rec.gmt_created
                rec.gmt_started = rec.gmt_started or prev.gmt_started
                rec.gmt_finished = rec.gmt_finished or prev.gmt_finished
            self._pods[rec.pod_id] = rec

    def list_pods(self, namespace, job_name, job_id) -> list:
        with self._lock:
            rows = [r for r in self._pods.values()
                    if r.namespace == namespace and r.job_id == job_id]
        rows.sort(key=lambda r: (r.replica_type, r.name))
        return rows

    def stop_pod(self, namespace, name, pod_id):
        with self._lock:
            rec = self._pods.get(pod_id)
            if rec is not None:
                rec.deleted = DELETED
                rec.is_in_etcd = 0

    def save_notebook(self, rec: NotebookRecord) -> None:
        with self._lock:
            self._notebooks[rec.notebook_id] = rec

    def list_notebooks(self, query: Query) -> list:
        with self._lock:
            rows = [r for r in self._notebooks.values()
                    if _match(r, query, kind_field=False)]
        rows.sort(key=lambda r: r.gmt_created, reverse=True)
        return _paginate(rows, query)

    def delete_notebook(self, namespace, name, notebook_id=""):
        with self._lock:
            for rec in self._notebooks.values():
                if rec.namespace == namespace and rec.name == name and (
                        not notebook_id or rec.notebook_id == notebook_id):
                    rec.deleted = DELETED
                    rec.is_in_etcd = 0

    def create_workspace(self, rec: WorkspaceRecord) -> None:
        with self._lock:
            if rec.name in self._workspaces \
                    and self._workspaces[rec.name].deleted != DELETED:
                raise ValueError(f"workspace {rec.name!r} already exists")
            self._workspaces[rec.name] = rec

    def list_workspaces(self, query: Query) -> list:
        with self._lock:
            rows = [r for r in self._workspaces.values()
                    if r.deleted != DELETED
                    and (not query.name or query.name in r.name)
                    and (not query.start_time
                         or r.create_time >= query.start_time)]
        rows.sort(key=lambda r: r.create_time, reverse=True)
        return _paginate(rows, query)

    def get_workspace(self, name: str) -> Optional[WorkspaceRecord]:
        with self._lock:
            rec = self._workspaces.get(name)
            return rec if rec is not None and rec.deleted != DELETED else None

    def delete_workspace(self, name: str) -> None:
        with self._lock:
            rec = self._workspaces.get(name)
            if rec is None or rec.deleted == DELETED:
                raise KeyError(f"workspace {name!r} not found")
            rec.deleted = DELETED

    def save_event(self, rec: EventRecord) -> None:
        with self._lock:
            self._events[(rec.obj_uid, rec.name)] = rec

    def list_events(self, obj_namespace, obj_name, obj_uid="",
                    from_time="", to_time="") -> list:
        with self._lock:
            rows = [r for r in self._events.values()
                    if r.obj_namespace == obj_namespace
                    and r.obj_name == obj_name
                    and (not obj_uid or r.obj_uid == obj_uid)
                    and (not from_time or r.last_timestamp >= from_time)
                    and (not to_time or r.last_timestamp <= to_time)]
        rows.sort(key=lambda r: r.last_timestamp)
        return rows


# ---------------------------------------------------------------------------
# SQL backends (the MySQL/gorm analog, reference backends/objects/mysql).
# The query surface is DB-API paramstyle-agnostic: SQLiteBackend is the
# embedded default, MySQLBackend (storage/external.py) reuses every query
# against a real MySQL server.
# ---------------------------------------------------------------------------

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
  job_id TEXT PRIMARY KEY, name TEXT, namespace TEXT, version TEXT,
  kind TEXT, status TEXT, resources TEXT, deploy_region TEXT,
  tenant TEXT, owner TEXT, deleted INTEGER, is_in_etcd INTEGER, remark TEXT,
  gmt_created TEXT, gmt_modified TEXT, gmt_job_running TEXT,
  gmt_job_finished TEXT);
CREATE INDEX IF NOT EXISTS idx_jobs_ns_name ON jobs (namespace, name);
CREATE TABLE IF NOT EXISTS pods (
  pod_id TEXT PRIMARY KEY, name TEXT, namespace TEXT, version TEXT,
  status TEXT, image TEXT, job_id TEXT, replica_type TEXT, resources TEXT,
  restarts INTEGER, host_ip TEXT, pod_ip TEXT, deploy_region TEXT, deleted INTEGER,
  is_in_etcd INTEGER, remark TEXT, gmt_created TEXT, gmt_modified TEXT,
  gmt_started TEXT, gmt_finished TEXT);
CREATE INDEX IF NOT EXISTS idx_pods_job ON pods (job_id);
CREATE TABLE IF NOT EXISTS notebooks (
  notebook_id TEXT PRIMARY KEY, name TEXT, namespace TEXT, version TEXT,
  status TEXT, url TEXT, deleted INTEGER, is_in_etcd INTEGER,
  gmt_created TEXT, gmt_modified TEXT);
CREATE TABLE IF NOT EXISTS workspaces (
  name TEXT PRIMARY KEY, namespace TEXT, username TEXT, type TEXT,
  pvc_name TEXT, local_path TEXT, description TEXT, cpu INTEGER,
  memory INTEGER, tpu INTEGER, storage INTEGER, status TEXT,
  deleted INTEGER, create_time TEXT, update_time TEXT);
CREATE TABLE IF NOT EXISTS events (
  obj_uid TEXT, name TEXT, kind TEXT, type TEXT, obj_namespace TEXT,
  obj_name TEXT, reason TEXT, message TEXT, count INTEGER, region TEXT,
  first_timestamp TEXT, last_timestamp TEXT,
  PRIMARY KEY (obj_uid, name));
CREATE INDEX IF NOT EXISTS idx_events_obj ON events (obj_namespace, obj_name);
"""


#: idempotent column additions for databases created before a column
#: existed — CREATE TABLE IF NOT EXISTS never amends a live table, so an
#: in-place upgrade would otherwise crash every save with "no column"
_MIGRATIONS = [
    ("pods", "restarts", "INTEGER DEFAULT 0"),
]


def _migrate_sqlite(conn) -> None:
    for table, col, decl in _MIGRATIONS:
        have = {r[1] for r in conn.execute(f"PRAGMA table_info({table})")}
        if col not in have:
            conn.execute(f"ALTER TABLE {table} ADD COLUMN {col} {decl}")


def _locked(fn):
    """Serialize a backend method's whole statement+fetch sequence on the
    shared connection."""
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _upsert(table: str, key: str, row: dict) -> tuple:
    cols = ", ".join(row)
    marks = ", ".join("?" for _ in row)
    sets = ", ".join(f"{k}=excluded.{k}" for k in row if k != key)
    sql = (f"INSERT INTO {table} ({cols}) VALUES ({marks}) "
           f"ON CONFLICT({key}) DO UPDATE SET {sets}")
    return sql, tuple(row.values())


class SQLiteBackend(ObjectBackend, EventBackend):
    """Column-compatible port of the MySQL backend
    (``backends/objects/mysql/mysql.go:53-330``)."""

    name = "sqlite"

    def __init__(self, path: str = ":memory:"):
        self.path = path
        # ONE shared connection for all threads (``:memory:`` is
        # per-connection — thread-local connections would each see a
        # separate empty database). sqlite serializes writes anyway; the
        # RLock serializes our statement+fetch sequences.
        self._connection: Optional[sqlite3.Connection] = None
        self._lock = threading.RLock()

    def _conn(self) -> sqlite3.Connection:
        with self._lock:
            if self._connection is None:
                if self.path != ":memory:":
                    import os
                    parent = os.path.dirname(os.path.abspath(self.path))
                    os.makedirs(parent, exist_ok=True)
                conn = sqlite3.connect(self.path, check_same_thread=False)
                conn.row_factory = sqlite3.Row
                conn.executescript(_SCHEMA)
                _migrate_sqlite(conn)
                self._connection = conn
            return self._connection

    def initialize(self) -> None:
        self._conn()

    def close(self) -> None:
        with self._lock:
            if self._connection is not None:
                try:
                    self._connection.close()
                except sqlite3.Error:
                    pass
                self._connection = None

    # -- jobs -------------------------------------------------------------

    @_locked
    def save_job(self, rec: JobRecord) -> None:
        conn = self._conn()
        row = rec.to_row()
        prev = self.get_job(rec.namespace, rec.name, rec.job_id)
        if prev is not None:
            row["gmt_created"] = prev.gmt_created or row["gmt_created"]
            row["gmt_job_running"] = row["gmt_job_running"] or prev.gmt_job_running
            row["gmt_job_finished"] = row["gmt_job_finished"] or prev.gmt_job_finished
        with conn:
            conn.execute(*_upsert("jobs", "job_id", row))

    @_locked
    def get_job(self, namespace, name, job_id=""):
        conn = self._conn()
        if job_id:
            cur = conn.execute(
                "SELECT * FROM jobs WHERE job_id=? AND namespace=?",
                (job_id, namespace))
        else:
            cur = conn.execute(
                "SELECT * FROM jobs WHERE namespace=? AND name=? "
                "ORDER BY gmt_created DESC", (namespace, name))
        row = cur.fetchone()
        return JobRecord.from_row(dict(row)) if row else None

    @_locked
    def list_jobs(self, query: Query) -> list:
        where, args = ["1=1"], []
        if query.job_id:
            where.append("job_id=?"); args.append(query.job_id)
        if query.name:
            where.append("name LIKE ?"); args.append(f"%{query.name}%")
        if query.namespace:
            where.append("namespace=?"); args.append(query.namespace)
        if query.kind:
            where.append("kind=?"); args.append(query.kind)
        if query.status:
            where.append("status=?"); args.append(query.status)
        if query.region:
            where.append("deploy_region=?"); args.append(query.region)
        if query.start_time:
            where.append("gmt_created>=?"); args.append(query.start_time)
        if query.end_time:
            where.append("gmt_created<=?"); args.append(query.end_time)
        if query.deleted is not None:
            where.append("deleted=?"); args.append(query.deleted)
        cond = " AND ".join(where)
        conn = self._conn()
        query.count = conn.execute(
            f"SELECT COUNT(*) FROM jobs WHERE {cond}", args).fetchone()[0]
        sql = f"SELECT * FROM jobs WHERE {cond} ORDER BY gmt_created DESC"
        if query.page_num > 0 and query.page_size > 0:
            sql += f" LIMIT {int(query.page_size)} OFFSET {(query.page_num - 1) * int(query.page_size)}"
        return [JobRecord.from_row(dict(r)) for r in conn.execute(sql, args)]

    @_locked
    def stop_job(self, namespace, name, job_id=""):
        rec = self.get_job(namespace, name, job_id)
        if rec is not None:
            with self._conn() as conn:
                conn.execute("UPDATE jobs SET status='Stopped' WHERE job_id=?",
                             (rec.job_id,))

    @_locked
    def delete_job(self, namespace, name, job_id=""):
        rec = self.get_job(namespace, name, job_id)
        if rec is not None:
            with self._conn() as conn:
                conn.execute(
                    "UPDATE jobs SET deleted=?, is_in_etcd=0 WHERE job_id=?",
                    (DELETED, rec.job_id))

    # -- pods -------------------------------------------------------------

    @_locked
    def save_pod(self, rec: PodRecord) -> None:
        conn = self._conn()
        row = rec.to_row()
        cur = conn.execute("SELECT gmt_created, gmt_started, gmt_finished "
                           "FROM pods WHERE pod_id=?", (rec.pod_id,))
        prev = cur.fetchone()
        if prev is not None:
            row["gmt_created"] = prev["gmt_created"] or row["gmt_created"]
            row["gmt_started"] = row["gmt_started"] or prev["gmt_started"]
            row["gmt_finished"] = row["gmt_finished"] or prev["gmt_finished"]
        with conn:
            conn.execute(*_upsert("pods", "pod_id", row))

    @_locked
    def list_pods(self, namespace, job_name, job_id) -> list:
        conn = self._conn()
        cur = conn.execute(
            "SELECT * FROM pods WHERE namespace=? AND job_id=? "
            "ORDER BY replica_type, name", (namespace, job_id))
        return [PodRecord.from_row(dict(r)) for r in cur]

    @_locked
    def stop_pod(self, namespace, name, pod_id):
        with self._conn() as conn:
            conn.execute(
                "UPDATE pods SET deleted=?, is_in_etcd=0 WHERE pod_id=?",
                (DELETED, pod_id))

    # -- notebooks --------------------------------------------------------

    @_locked
    def save_notebook(self, rec: NotebookRecord) -> None:
        with self._conn() as conn:
            conn.execute(*_upsert("notebooks", "notebook_id", rec.to_row()))

    @_locked
    def list_notebooks(self, query: Query) -> list:
        where, args = ["1=1"], []
        if query.name:
            where.append("name LIKE ?"); args.append(f"%{query.name}%")
        if query.namespace:
            where.append("namespace=?"); args.append(query.namespace)
        if query.status:
            where.append("status=?"); args.append(query.status)
        if query.deleted is not None:
            where.append("deleted=?"); args.append(query.deleted)
        cond = " AND ".join(where)
        conn = self._conn()
        query.count = conn.execute(
            f"SELECT COUNT(*) FROM notebooks WHERE {cond}", args).fetchone()[0]
        sql = f"SELECT * FROM notebooks WHERE {cond} ORDER BY gmt_created DESC"
        if query.page_num > 0 and query.page_size > 0:
            sql += f" LIMIT {int(query.page_size)} OFFSET {(query.page_num - 1) * int(query.page_size)}"
        return [NotebookRecord.from_row(dict(r)) for r in conn.execute(sql, args)]

    @_locked
    def delete_notebook(self, namespace, name, notebook_id=""):
        with self._conn() as conn:
            if notebook_id:
                conn.execute("UPDATE notebooks SET deleted=?, is_in_etcd=0 "
                             "WHERE notebook_id=?", (DELETED, notebook_id))
            else:
                conn.execute("UPDATE notebooks SET deleted=?, is_in_etcd=0 "
                             "WHERE namespace=? AND name=?",
                             (DELETED, namespace, name))

    # -- workspaces -------------------------------------------------------

    @_locked
    def create_workspace(self, rec: WorkspaceRecord) -> None:
        conn = self._conn()
        cur = conn.execute(
            "SELECT deleted FROM workspaces WHERE name=?", (rec.name,))
        row = cur.fetchone()
        if row is not None and row["deleted"] != DELETED:
            raise ValueError(f"workspace {rec.name!r} already exists")
        with conn:
            conn.execute(*_upsert("workspaces", "name", rec.to_row()))

    @_locked
    def list_workspaces(self, query: Query) -> list:
        where, args = ["deleted!=?"], [DELETED]
        if query.name:
            where.append("name LIKE ?"); args.append(f"%{query.name}%")
        if query.start_time:
            where.append("create_time>=?"); args.append(query.start_time)
        cond = " AND ".join(where)
        conn = self._conn()
        query.count = conn.execute(
            f"SELECT COUNT(*) FROM workspaces WHERE {cond}", args).fetchone()[0]
        sql = f"SELECT * FROM workspaces WHERE {cond} ORDER BY create_time DESC"
        if query.page_num > 0 and query.page_size > 0:
            sql += f" LIMIT {int(query.page_size)} OFFSET {(query.page_num - 1) * int(query.page_size)}"
        return [WorkspaceRecord.from_row(dict(r))
                for r in conn.execute(sql, args)]

    @_locked
    def get_workspace(self, name: str) -> Optional[WorkspaceRecord]:
        cur = self._conn().execute(
            "SELECT * FROM workspaces WHERE name=? AND deleted!=?",
            (name, DELETED))
        row = cur.fetchone()
        return WorkspaceRecord.from_row(dict(row)) if row else None

    @_locked
    def delete_workspace(self, name: str) -> None:
        conn = self._conn()
        cur = conn.execute(
            "SELECT deleted FROM workspaces WHERE name=?", (name,))
        row = cur.fetchone()
        if row is None or row["deleted"] == DELETED:
            raise KeyError(f"workspace {name!r} not found")
        with conn:
            conn.execute("UPDATE workspaces SET deleted=? WHERE name=?",
                         (DELETED, name))

    # -- events -----------------------------------------------------------

    @_locked
    def save_event(self, rec: EventRecord) -> None:
        with self._conn() as conn:
            conn.execute(*_upsert("events", "obj_uid, name", rec.to_row()))

    @_locked
    def list_events(self, obj_namespace, obj_name, obj_uid="",
                    from_time="", to_time="") -> list:
        where = ["obj_namespace=?", "obj_name=?"]
        args = [obj_namespace, obj_name]
        if obj_uid:
            where.append("obj_uid=?"); args.append(obj_uid)
        if from_time:
            where.append("last_timestamp>=?"); args.append(from_time)
        if to_time:
            where.append("last_timestamp<=?"); args.append(to_time)
        cur = self._conn().execute(
            f"SELECT * FROM events WHERE {' AND '.join(where)} "
            "ORDER BY last_timestamp", args)
        return [EventRecord.from_row(dict(r)) for r in cur]


# ---------------------------------------------------------------------------
# Registry (reference backends/registry/registry.go:34-59)
# ---------------------------------------------------------------------------

_object_backends: dict[str, ObjectBackend] = {}
_event_backends: dict[str, EventBackend] = {}


def register_object_backend(backend: ObjectBackend) -> None:
    _object_backends[backend.name] = backend


def register_event_backend(backend: EventBackend) -> None:
    _event_backends[backend.name] = backend


def get_object_backend(name: str) -> Optional[ObjectBackend]:
    return _object_backends.get(name)


def get_event_backend(name: str) -> Optional[EventBackend]:
    return _event_backends.get(name)
