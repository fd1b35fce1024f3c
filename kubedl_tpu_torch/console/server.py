"""Console REST backend on the stdlib HTTP stack.

Route-for-route analog of the reference Gin server
(``console/backend/pkg/routers/api/*.go``):

* auth: ``POST /api/v1/login``, ``POST /api/v1/logout``,
  ``GET /api/v1/current-user`` (session-cookie auth, ``auth.go``)
* users: ``GET/POST /api/v1/users``, ``DELETE /api/v1/users/{name}``
  (admin-only management of console accounts, persisted to the
  kubedl-console-config ConfigMap — reference Admin page)
* jobs: ``/api/v1/job/{list,detail,statistics,running-jobs}``,
  ``/api/v1/job/{yaml,json}/{ns}/{name}``, ``POST /api/v1/job/stop``,
  ``POST /api/v1/job/submit``, ``DELETE /api/v1/job/{ns}/{name}``
  (``job.go:32-46``)
* cluster: ``/api/v1/data/{total,nodeInfos}``,
  ``/api/v1/data/request/{podPhase}`` (``data.go:24-29``)
* events/logs: ``/api/v1/event/events/{ns}/{name}``,
  ``/api/v1/log/logs/{ns}/{podName}`` (``log.go:26-31``)
* notebooks: ``/api/v1/notebook/{list,submit}``, ``DELETE``, yaml/json
  (``notebook.go:24-31``)
* static dashboard at ``/`` (the frontend build the Gin server embeds).

Responses use the reference's envelope: ``{"code": 200, "data": ...}`` on
success, ``{"code": ..., "msg": ...}`` on error.

Copied from ``kubedl_tpu/console/server.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import hmac
import json
import logging
import os
import re
import secrets
import threading
from dataclasses import dataclass, field
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

import yaml

from ..client.clientset import KIND_TABLE, TRAINING_KINDS, Clientset
from ..core import meta as m
from ..core.apiserver import AlreadyExists, ApiError, NotFound
from ..storage.backends import Query
from ..storage.dmo import WorkspaceRecord
from .presubmit import run_pre_submit_hooks
from .proxy import DataProxy
from .sources import (CodeSource, CodeSourceHandler, DataSource,
                      DataSourceHandler, WorkspaceHandler)

FRONTEND_DIR = Path(__file__).parent / "frontend"
SESSION_COOKIE = "kubedl-session"
#: reference constants.KubeDLConsoleConfig in kubedl-system: user list lives
#: in a ConfigMap so credentials are cluster-config, not code
CONSOLE_CONFIGMAP = "kubedl-console-config"
CONSOLE_NAMESPACE = "kubedl-system"

log = logging.getLogger("kubedl.console")


@dataclass
class ConsoleConfig:
    host: str = "127.0.0.1"
    port: int = 9090
    #: username -> password. None (default) resolves at startup from
    #: $KUBEDL_CONSOLE_USERS, then the kubedl-console-config ConfigMap,
    #: else generates a random admin password (logged once). An explicit
    #: empty dict disables auth entirely (dev mode, reference auth "none").
    users: Optional[dict] = None
    #: cap on request body size (submit endpoints)
    max_body: int = 4 << 20
    #: mark the session cookie Secure (set when serving behind TLS)
    cookie_secure: bool = False
    #: playground proxy: Inference CR dict -> predictor base URL.
    #: None = in-cluster DNS of the entry Service. The console only ever
    #: talks to URLs this resolver returns for EXISTING Inference CRs —
    #: user-supplied URLs are never fetched (no SSRF surface).
    predictor_resolver: Optional[object] = None
    #: upper bound on one proxied playground generation
    predictor_timeout_s: float = 120.0


#: _persist_users marks the ConfigMap it writes; a marked ConfigMap holds
#: the latest console-made edits and therefore outranks env/config seeds on
#: restart (otherwise a deleted account would resurrect from the env var)
MANAGED_ANNOTATION = "kubedl.io/managed-by"


def resolve_users(config: ConsoleConfig, api) -> dict:
    """Credential sources, most-explicit first (reference
    ``model.GetUserInfoFromConfigMap``; the hard-coded admin:kubedl default
    of earlier rounds is gone — ADVICE r1/r2). Exception: a ConfigMap the
    console itself wrote (managed-by annotation) carries admin edits made
    through the Admin page and wins over the original env/config seed."""
    cm = api.try_get("ConfigMap", CONSOLE_NAMESPACE, CONSOLE_CONFIGMAP)
    managed = (cm is not None and (cm.get("metadata", {}).get(
        "annotations") or {}).get(MANAGED_ANNOTATION) == "console")
    if managed:
        try:
            infos = json.loads((cm.get("data") or {}).get("users", "[]"))
            users = {u["username"]: u["password"] for u in infos}
            if users:
                return users
        except (ValueError, TypeError, KeyError) as e:
            log.warning("bad managed %s ConfigMap: %s", CONSOLE_CONFIGMAP, e)
    if config.users is not None:
        return dict(config.users)
    env = os.environ.get("KUBEDL_CONSOLE_USERS", "")
    if env:
        try:
            parsed = json.loads(env)
            if isinstance(parsed, list):      # [{"username":..,"password":..}]
                return {u["username"]: u["password"] for u in parsed}
            if isinstance(parsed, dict):
                return dict(parsed)
        except ValueError:
            pass
        except (KeyError, TypeError) as e:
            raise ValueError(
                f"KUBEDL_CONSOLE_USERS JSON must be a list of "
                f"{{username, password}} objects or a user->password map: {e}")
        # "user:pass,user2:pass2" shorthand
        users = {}
        for pair in env.split(","):
            user, _, pw = pair.partition(":")
            if user and pw:
                users[user] = pw
        if users:
            return users
        raise ValueError("KUBEDL_CONSOLE_USERS is set but unparseable")
    cm = api.try_get("ConfigMap", CONSOLE_NAMESPACE, CONSOLE_CONFIGMAP)
    if cm is not None:
        try:
            infos = json.loads((cm.get("data") or {}).get("users", "[]"))
            users = {u["username"]: u["password"] for u in infos}
            if users:
                return users
        except (ValueError, TypeError, KeyError) as e:
            log.warning("bad %s ConfigMap: %s", CONSOLE_CONFIGMAP, e)
    password = secrets.token_urlsafe(12)
    log.warning("no console credentials configured; generated admin "
                "password: %s (set KUBEDL_CONSOLE_USERS or the %s/%s "
                "ConfigMap to override)", password, CONSOLE_NAMESPACE,
                CONSOLE_CONFIGMAP)
    return {"admin": password}


def resolve_admins(users: dict, api) -> set:
    """Which users may manage console users (reference Admin page /
    ``apiv1Routes.GET("/user", ...)``): an ``admins`` JSON list in the
    console ConfigMap wins; else the conventional ``admin`` account; else
    the first configured user (sole-user installs administer themselves)."""
    cm = api.try_get("ConfigMap", CONSOLE_NAMESPACE, CONSOLE_CONFIGMAP)
    if cm is not None:
        try:
            admins = set(json.loads((cm.get("data") or {}).get("admins", "[]")))
            admins &= set(users)
            if admins:
                return admins
        except (ValueError, TypeError) as e:
            log.warning("bad admins list in %s ConfigMap: %s",
                        CONSOLE_CONFIGMAP, e)
    if "admin" in users:
        return {"admin"}
    return set(sorted(users)[:1])


class _Sessions:
    def __init__(self):
        self._tokens: dict[str, str] = {}
        self._lock = threading.Lock()

    def login(self, user: str) -> str:
        token = secrets.token_urlsafe(24)
        with self._lock:
            self._tokens[token] = user
        return token

    def user(self, token: Optional[str]) -> Optional[str]:
        with self._lock:
            return self._tokens.get(token or "")

    def logout(self, token: Optional[str]) -> None:
        with self._lock:
            self._tokens.pop(token or "", None)

    def revoke_user(self, user: str) -> None:
        """Drop every session of ``user`` (account deleted or password
        changed — revocation must be immediate, not cookie-lifetime)."""
        with self._lock:
            for tok in [t for t, u in self._tokens.items() if u == user]:
                del self._tokens[tok]


class ConsoleServer:
    """Owns the HTTP server; all state lives here, the handler is stateless."""

    def __init__(self, proxy: DataProxy, config: Optional[ConsoleConfig] = None):
        self.proxy = proxy
        self.config = config or ConsoleConfig()
        self.users = resolve_users(self.config, proxy.api)
        self.admins = resolve_admins(self.users, proxy.api)
        self._users_lock = threading.Lock()
        self.sessions = _Sessions()
        self.cs = Clientset(proxy.api)
        self.datasources = DataSourceHandler(proxy.api)
        self.codesources = CodeSourceHandler(proxy.api)
        now_fn = lambda: m.rfc3339(proxy.api.now())  # noqa: E731
        self.workspaces = None
        if proxy.object_backend is not None:
            self.workspaces = WorkspaceHandler(
                proxy.api, proxy.object_backend, self.datasources, now_fn)
        self._now = now_fn
        console = self

        class Handler(_ConsoleHandler):
            server_ref = console

        self._httpd = ThreadingHTTPServer(
            (self.config.host, self.config.port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.config.host}:{self.port}"

    def start(self) -> "ConsoleServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="kubedl-console", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- request routing (called from the handler) ------------------------

    def route(self, method: str, path: str, params: dict, body: bytes,
              token: Optional[str]):
        """Returns (status, payload|bytes, extra_headers)."""
        if not path.startswith("/api/"):
            return self._static(path)

        # auth endpoints are always reachable
        if path == "/api/v1/login" and method == "POST":
            try:
                return self._login(body)
            except ValueError as e:
                return 400, {"code": 400, "msg": f"bad login body: {e}"}, []
        if path == "/api/v1/logout" and method == "POST":
            self.sessions.logout(token)
            return 200, {"code": 200, "data": "ok"}, []
        user = self.sessions.user(token)
        if self.users and user is None:
            return 401, {"code": 401, "msg": "not logged in"}, []
        if path == "/api/v1/current-user":
            return 200, {"code": 200, "data": {
                "loginId": user or "anonymous",
                "admin": self._is_admin(user)}}, []

        try:
            return self._dispatch(method, path, params, body, user)
        except PermissionError as e:
            return 403, {"code": 403, "msg": str(e)}, []
        except NotFound as e:
            return 404, {"code": 404, "msg": str(e)}, []
        except (ApiError, ValueError, KeyError, TypeError,
                AttributeError) as e:
            # Type/AttributeError cover malformed bodies (null where a
            # number belongs, non-dict JSON): a 400, never a dropped
            # connection
            return 400, {"code": 400, "msg": f"{type(e).__name__}: {e}"}, []

    def _is_admin(self, user) -> bool:
        # auth disabled (explicit empty user map, dev mode): everyone admin
        return not self.users or user in self.admins

    # -- endpoint implementations ----------------------------------------

    def _dispatch(self, method: str, path: str, params: dict, body: bytes,
                  user=None):
        ok = lambda data: (200, {"code": 200, "data": data}, [])  # noqa: E731

        # -- console user management (reference Admin page, auth.go) ------
        # every route is admin-only: even the list is a credential-attack
        # target (usernames + which accounts are admins)
        if path == "/api/v1/users" and method == "GET":
            if not self._is_admin(user):
                raise PermissionError("admin role required")
            with self._users_lock:
                return ok([{"username": u, "admin": u in self.admins}
                           for u in sorted(self.users)])
        if path == "/api/v1/users" and method == "POST":
            if not self._is_admin(user):
                raise PermissionError("admin role required")
            req = _parse_body(body)
            uname = str(req.get("username", "")).strip()
            pw = str(req.get("password", ""))
            if not uname or not pw:
                raise ValueError("username and password are required")
            if not re.fullmatch(r"[A-Za-z0-9._-]{1,64}", uname):
                raise ValueError(
                    "username must be 1-64 chars of [A-Za-z0-9._-]")
            with self._users_lock:
                users = dict(self.users)
                admins = set(self.admins)
                changed = users.get(uname) != pw
                users[uname] = pw
                if bool(req.get("admin")):
                    admins.add(uname)
                elif uname in admins:
                    if admins <= {uname}:
                        raise ValueError("cannot demote the last admin")
                    admins.discard(uname)
                # dev-mode bootstrap: the first account created while auth
                # was disabled must become admin, or the system ends up
                # with auth on and zero admins (permanent lockout)
                if users and not admins:
                    admins.add(uname)
                # persist FIRST: a failed ConfigMap write must not leave
                # memory and storage disagreeing (or skip revocation)
                self._persist_users(users, admins)
                self.users, self.admins = users, admins
                is_admin = uname in admins
            if changed:
                self.sessions.revoke_user(uname)  # password reset = re-login
            return ok({"username": uname, "admin": is_admin})
        mt = re.fullmatch(r"/api/v1/users/([^/]+)", path)
        if mt and method == "DELETE":
            if not self._is_admin(user):
                raise PermissionError("admin role required")
            uname = unquote(mt.group(1))
            with self._users_lock:
                if uname not in self.users:
                    raise NotFound(f"user {uname!r} not found")
                if uname in self.admins and self.admins <= {uname}:
                    raise ValueError("cannot delete the last admin")
                users = {u: p for u, p in self.users.items() if u != uname}
                admins = self.admins - {uname}
                self._persist_users(users, admins)
                self.users, self.admins = users, admins
            self.sessions.revoke_user(uname)
            return ok("deleted")

        if path == "/api/v1/job/list":
            q = _query_from_params(params)
            rows = self.proxy.list_jobs(q)
            return ok({"total": q.count,
                       "jobInfos": [r.to_row() for r in rows]})
        if path == "/api/v1/job/detail":
            kind = params.get("kind", "")
            ns = params.get("namespace", "default")
            name = params.get("name", "")
            job = self._find_job(kind, ns, name)
            if job is None:
                raise NotFound(f"job {ns}/{name} not found")
            pods = self.proxy.list_job_pods(m.kind(job), ns, name)
            events = self.proxy.list_events(ns, name)
            detail = {"job": job, "pods": [p.to_row() for p in pods],
                      "events": [e.to_row() for e in events],
                      # per-job queue wait (trace breakdown when traced,
                      # else the live Queuing condition's age)
                      "queueWaitSeconds": self.proxy.job_queue_wait(job)}
            if self.proxy.telemetry_enabled:
                # goodput decomposition (docs/telemetry.md) — the key is
                # only present with the FleetTelemetry gate on, so the
                # disabled response stays byte-identical
                detail["goodput"] = self.proxy.job_goodput(job)
            return ok(detail)
        if path == "/api/v1/job/statistics":
            return ok(self.proxy.job_statistics(_query_from_params(params)))
        if path == "/api/v1/job/running-jobs":
            q = _query_from_params(params)
            q.status = "Running"
            return ok([r.to_row() for r in self.proxy.list_jobs(q)])
        mt = re.fullmatch(r"/api/v1/job/(yaml|json)/([^/]+)/([^/]+)", path)
        if mt:
            fmt, ns, name = mt.groups()
            job = self._find_job(params.get("kind", ""), ns, name)
            if job is None:
                raise NotFound(f"job {ns}/{name} not found")
            if fmt == "json":
                return ok(job)
            return 200, yaml.safe_dump(job, sort_keys=False).encode(), [
                ("Content-Type", "text/yaml")]
        if path == "/api/v1/job/stop" and method == "POST":
            req = _parse_body(body)
            stopped = self.proxy.stop_job(req.get("kind", ""),
                                          req.get("namespace", "default"),
                                          req.get("name", ""))
            if not stopped:
                raise NotFound("job not found")
            return ok("stopped")
        if path == "/api/v1/job/submit" and method == "POST":
            obj = _parse_manifest(body)
            kind = m.kind(obj)
            if kind not in TRAINING_KINDS:
                raise ValueError(f"kind {kind!r} is not a training job kind")
            run_pre_submit_hooks(obj)
            created = self.cs.kind(kind).create(obj)
            return ok({"name": m.name(created),
                       "namespace": m.namespace(created)})
        mt = re.fullmatch(r"/api/v1/job/([^/]+)/([^/]+)", path)
        if mt and method == "DELETE":
            ns, name = mt.groups()
            job = self._find_job(params.get("kind", ""), ns, name)
            if job is None:
                raise NotFound(f"job {ns}/{name} not found")
            self.proxy.api.delete(m.kind(job), ns, name)
            return ok("deleted")

        if path == "/api/v1/data/total":
            return ok(self.proxy.cluster_total())
        if path == "/api/v1/data/nodeInfos":
            return ok(self.proxy.node_infos())
        if path == "/api/v1/data/occupancy":
            # slice/gang occupancy for the cluster dashboard (reference
            # ClusterInfo depth, TPU-first: PodGroup gangs + chips idle)
            return ok(self.proxy.cluster_occupancy())
        mt = re.fullmatch(r"/api/v1/data/request/([^/]+)", path)
        if mt:
            return ok(self.proxy.cluster_request(mt.group(1)))

        # trace endpoints (docs/tracing.md): a job's timeline + critical-
        # path breakdown, and raw serving request traces by id. Optional
        # ?format=chrome|otlp renders the exporter output instead.
        if path.startswith("/api/v1/trace/"):
            if not self.proxy.tracing_enabled:
                return 501, {"code": 501,
                             "msg": "tracing disabled (--enable-tracing / "
                                    "Tracing gate)"}, []
            from ..trace import to_chrome_trace, to_otlp_json
            mt = re.fullmatch(r"/api/v1/trace/request/([0-9a-fA-F]{8,64})",
                              path)
            if mt:
                spans = self.proxy.trace_spans(mt.group(1).lower())
                if not spans:
                    raise NotFound(f"no spans for trace {mt.group(1)}")
                fmt = params.get("format", "")
                if fmt == "chrome":
                    return ok(to_chrome_trace(spans))
                if fmt == "otlp":
                    return ok(to_otlp_json(spans))
                return ok({"traceId": mt.group(1).lower(),
                           "spans": [s.to_dict() for s in spans]})
            mt = re.fullmatch(r"/api/v1/trace/([^/]+)/([^/]+)", path)
            if mt:
                ns, name = mt.groups()
                breakdown = self.proxy.job_trace(ns, name)
                if breakdown is None:
                    raise NotFound(f"no trace for job {ns}/{name}")
                fmt = params.get("format", "")
                if fmt in ("chrome", "otlp"):
                    spans = self.proxy.trace_spans(breakdown["traceId"])
                    return ok(to_chrome_trace(spans) if fmt == "chrome"
                              else to_otlp_json(spans))
                return ok(breakdown)

        # pending-job explainer (docs/telemetry.md): a structured "why is
        # this job not running" verdict from live scheduler state; 501
        # when the slice scheduler is disabled, matching the trace
        # endpoints' convention
        mt = re.fullmatch(r"/api/v1/explain/([^/]+)/([^/]+)", path)
        if mt:
            if self.proxy.scheduler is None:
                return 501, {"code": 501,
                             "msg": "slice scheduler disabled "
                                    "(--enable-slice-scheduler / "
                                    "TPUSliceScheduler gate)"}, []
            ns, name = mt.groups()
            verdict = self.proxy.explain_pending(ns, name)
            if verdict is None:
                raise NotFound(f"job {ns}/{name} not found")
            return ok(verdict)

        # concurrency-elastic state (docs/elastic.md): per-slice gang
        # states, the recorded running set, and the 2-phase checkpoint
        # protocol position; 501 when elastic slices are off, matching
        # the trace endpoints' convention
        mt = re.fullmatch(r"/api/v1/elastic/([^/]+)/([^/]+)", path)
        if mt:
            if not self.proxy.elastic_enabled:
                return 501, {"code": 501,
                             "msg": "elastic slices disabled "
                                    "(--enable-elastic-slices / "
                                    "TPUElasticSlices gate)"}, []
            ns, name = mt.groups()
            state = self.proxy.job_elastic(ns, name)
            if state is None:
                raise NotFound(f"job {ns}/{name} not found")
            return ok(state)

        # serving fleet (docs/serving_fleet.md): replica health, drain
        # state, router placement counters, autoscaler events; 501 when
        # this process hosts no fleet (gate off, or a plain operator)
        if path == "/api/v1/serving/fleet":
            if self.proxy.serving_fleet is None:
                return 501, {"code": 501,
                             "msg": "serving fleet disabled "
                                    "(--enable-serving-fleet / "
                                    "ServingFleet gate, and this "
                                    "process hosts no replicas)"}, []
            return ok(self.proxy.serving_fleet_status())

        # multi-model serving (docs/multimodel.md): the adapter catalog
        # plus each replica's residency (which models live where, their
        # pool pages, fault/eviction counts); 501 when the gate is off
        # or this process hosts no multi-model fleet — the same
        # convention as the fleet endpoint, one gate deeper
        if path == "/api/v1/serving/models":
            if not self.proxy.multi_model_enabled:
                return 501, {"code": 501,
                             "msg": "multi-model serving disabled "
                                    "(--enable-multi-model / "
                                    "MultiModelServing gate, with "
                                    "--enable-serving-fleet, and this "
                                    "process hosts no adapter "
                                    "catalog)"}, []
            return ok(self.proxy.serving_models_status())

        # RL flywheel (docs/rl.md): one RLJob's policy version vs the
        # fleet's visible versions, rollout throughput against the
        # declared floor, publish/staleness counters; 501 when this
        # process hosts no flywheel (--enable-rl-flywheel / RLFlywheel
        # gate off), matching the serving-fleet endpoint's convention
        mt = re.fullmatch(r"/api/v1/rl/([^/]+)/([^/]+)", path)
        if mt:
            if not self.proxy.rl_enabled:
                return 501, {"code": 501,
                             "msg": "rl flywheel disabled "
                                    "(--enable-rl-flywheel / RLFlywheel "
                                    "gate, with --enable-serving-fleet, "
                                    "and this process hosts no "
                                    "flywheel)"}, []
            ns, name = mt.groups()
            doc = self.proxy.rl_job(ns, name)
            if doc is None:
                raise NotFound(f"no flywheel for RLJob {ns}/{name}")
            return ok(doc)

        # fleet goodput rollup (docs/telemetry.md): the live fleet-wide
        # number BENCH_CLUSTER gates on; 501 with the telemetry gate off
        if path == "/api/v1/telemetry/goodput":
            if not self.proxy.telemetry_enabled:
                return 501, {"code": 501,
                             "msg": "telemetry disabled "
                                    "(--enable-telemetry / "
                                    "FleetTelemetry gate)"}, []
            return ok(self.proxy.fleet_goodput())

        # SLO engine (docs/slo.md): objective statuses with error budget
        # and burn-rate verdicts; 501 when the SLOEngine gate is off
        if path.startswith("/api/v1/slo/"):
            if not self.proxy.slo_enabled:
                return 501, {"code": 501,
                             "msg": "SLO engine disabled (--enable-slo / "
                                    "SLOEngine gate)"}, []
            if path == "/api/v1/slo/list":
                return ok(self.proxy.slo_list())
            mt = re.fullmatch(r"/api/v1/slo/status/([^/]+)", path)
            if mt:
                status = self.proxy.slo_status(unquote(mt.group(1)))
                if status is None:
                    raise NotFound(f"SLO {mt.group(1)} not found")
                return ok(status)

        # forensics (docs/forensics.md). The incident stream reads the
        # SLO evaluator, not the journal — it gates on telemetry; the
        # worldline/durability routes gate on the journal (no journal =
        # no worldline to reconstruct from).
        if path == "/api/v1/forensics/incidents":
            if not self.proxy.incidents_enabled:
                return 501, {"code": 501,
                             "msg": "slo telemetry disabled "
                                    "(--enable-slo / SLOEngine gate) — "
                                    "the incident stream reads the SLO "
                                    "evaluator's alert log"}, []
            return ok(self.proxy.incident_timeline())
        if path.startswith("/api/v1/forensics/") \
                or path == "/api/v1/durability/status":
            if not self.proxy.forensics_enabled:
                return 501, {"code": 501,
                             "msg": "durability disabled "
                                    "(--enable-durability + "
                                    "--journal-dir / "
                                    "DurableControlPlane gate)"}, []
            if path == "/api/v1/durability/status":
                return ok(self.proxy.durability_status())
            mt = re.fullmatch(r"/api/v1/forensics/world/(\d+)", path)
            if mt:
                return ok(self.proxy.world_at(int(mt.group(1))))
            mt = re.fullmatch(
                r"/api/v1/forensics/object/([^/]+)/([^/]+)/([^/]+)",
                path)
            if mt:
                kind, ns, name = (unquote(g) for g in mt.groups())
                history = self.proxy.forensic_object_history(kind, ns,
                                                             name)
                if history is None:
                    raise NotFound(
                        f"no journal history for {kind} {ns}/{name}")
                return ok(history)

        # replication (docs/replication.md): role, epoch, per-follower
        # lag, last-promotion provenance; 501 when replication is off,
        # matching the durability endpoints' convention
        if path == "/api/v1/replication/status":
            if not self.proxy.replication_enabled:
                return 501, {"code": 501,
                             "msg": "replication disabled "
                                    "(--replication-followers with "
                                    "--enable-durability + "
                                    "--journal-dir)"}, []
            return ok(self.proxy.replication_status())

        # federation (docs/federation.md): the global layer's live
        # routing/catalog/shipping document and the static region
        # topology; 501 when this process hosts no federation driver
        # (--enable-federation / Federation gate off), matching the
        # replication endpoints' convention
        if path.startswith("/api/v1/federation/"):
            if not self.proxy.federation_enabled:
                return 501, {"code": 501,
                             "msg": "federation disabled "
                                    "(--enable-federation / Federation "
                                    "gate, with --enable-durability)"}, []
            if path == "/api/v1/federation/status":
                return ok(self.proxy.federation_status())
            if path == "/api/v1/federation/topology":
                return ok(self.proxy.federation_topology())

        # slice-scheduler queues: quota + live usage (docs/scheduling.md)
        if path == "/api/v1/queue/list":
            return ok(self.proxy.list_queues())
        mt = re.fullmatch(r"/api/v1/queue/usage/([^/]+)", path)
        if mt:
            row = self.proxy.queue_usage(mt.group(1))
            if row is None:
                raise NotFound(f"queue {mt.group(1)} not found")
            return ok(row)

        # per-pool placement table (docs/scheduling.md "Placement
        # scoring"): cost, spot class, ICI-domain free map, normalized
        # throughput; 501 with the scoring gate off, matching the trace
        # endpoints' convention
        if path == "/api/v1/pools":
            if not self.proxy.placement_enabled:
                return 501, {"code": 501,
                             "msg": "placement scoring disabled "
                                    "(--enable-placement-scoring / "
                                    "TPUPlacementScoring gate)"}, []
            return ok(self.proxy.pool_table())

        mt = re.fullmatch(r"/api/v1/event/events/([^/]+)/([^/]+)", path)
        if mt:
            ns, name = mt.groups()
            return ok([e.to_row() for e in self.proxy.list_events(ns, name)])
        mt = re.fullmatch(r"/api/v1/log/(logs|download)/([^/]+)/([^/]+)",
                          path)
        if mt:
            # real kubelet logs in real-cluster mode; event-stream pseudo-
            # logs on the standalone plane. download (reference log.go:28)
            # serves the same lines as an attachment
            verb, ns, name = mt.groups()
            lines = self.proxy.pod_log_lines(ns, name)
            if verb == "logs":
                return ok(lines)
            return 200, ("\n".join(lines) + "\n").encode(), [
                ("Content-Type", "text/plain"),
                ("Content-Disposition",
                 f'attachment; filename="{name}.log"')]

        if path == "/api/v1/notebook/list":
            return ok([r.to_row() for r in self.proxy.list_notebooks(Query())])
        if path == "/api/v1/notebook/submit" and method == "POST":
            obj = _parse_manifest(body)
            if m.kind(obj) != "Notebook":
                raise ValueError("manifest kind must be Notebook")
            created = self.cs.kind("Notebook").create(obj)
            return ok({"name": m.name(created)})
        mt = re.fullmatch(r"/api/v1/notebook/([^/]+)/([^/]+)", path)
        if mt and method == "DELETE":
            ns, name = mt.groups()
            self.proxy.api.delete("Notebook", ns, name)
            return ok("deleted")
        mt = re.fullmatch(r"/api/v1/notebook/(yaml|json)/([^/]+)/([^/]+)", path)
        if mt:
            fmt, ns, name = mt.groups()
            nb = self.proxy.api.get("Notebook", ns, name)
            if fmt == "json":
                return ok(nb)
            return 200, yaml.safe_dump(nb, sort_keys=False).encode(), [
                ("Content-Type", "text/yaml")]

        if path == "/api/v1/tensorboard/status":
            from ..platform.tensorboard import tb_resource_name
            ns = params.get("namespace", "default")
            name = tb_resource_name(params.get("name", ""))
            pod = self.proxy.api.try_get("Pod", ns, name)
            svc = self.proxy.api.try_get("Service", ns, name)
            return ok({
                # a pod that exists but has no phase yet is Pending (real
                # kubelets always stamp one; the standalone plane may not)
                "phase": m.get_in(pod, "status", "phase", default="Pending")
                if pod else "NotFound",
                "service": m.name(svc) if svc else ""})

        if path == "/api/v1/tensorboard/reapply" and method == "POST":
            # reference tensorboard.go:40 ReapplyTensorBoardInstance: bump
            # the TB config's update stamp so the reconciler recreates it
            req = _parse_body(body)
            ns = req.get("namespace", "default")
            name = req.get("name", "")
            job = self._find_job(req.get("kind", ""), ns, name)
            if job is None:
                raise NotFound(f"job {ns}/{name} not found")
            from ..api import common as cc
            raw = m.annotations(job).get(cc.ANNOTATION_TENSORBOARD_CONFIG)
            if not raw:
                raise ValueError("job has no tensorboard config")
            tb = json.loads(raw)
            tb["updateTimestamp"] = self._now()
            self.proxy.api.patch_merge(m.kind(job), ns, name, {
                "metadata": {"annotations": {
                    cc.ANNOTATION_TENSORBOARD_CONFIG:
                        json.dumps(tb, sort_keys=True)}}})
            # the reconciler treats updateTimestamp as cosmetic; delete the
            # live TB pod so the next sync recreates it from the config
            from ..platform.tensorboard import tb_resource_name
            try:
                self.proxy.api.delete("Pod", ns, tb_resource_name(name))
            except NotFound:
                pass
            return ok("reapplied")

        if path == "/api/v1/kubedl/images":
            # curated image list for the submit form (reference
            # kubedl.go:33 getImages, sourced from the console ConfigMap)
            cm = self.proxy.api.try_get("ConfigMap", CONSOLE_NAMESPACE,
                                        CONSOLE_CONFIGMAP)
            images = {}
            if cm is not None:
                try:
                    images = json.loads(
                        (cm.get("data") or {}).get("images", "{}"))
                except ValueError:
                    images = {}
            return ok(images)
        if path == "/api/v1/kubedl/namespaces":
            names = {m.name(n) for n in self.proxy.api.list("Namespace")}
            names.add("default")
            return ok(sorted(names))
        if path == "/api/v1/pvc/list":
            # reference job.go:45 ListPVC: the submit form's volume picker
            ns = params.get("namespace", "default")
            return ok(sorted(
                m.name(p) for p in self.proxy.api.list(
                    "PersistentVolumeClaim", ns)))

        # -- inference playground (beyond-parity: chat with a deployed
        # predictor through the console; the reference console has no
        # serving surface at all) --------------------------------------
        if path == "/api/v1/inference/list":
            return ok(self._inference_list(params))
        if path == "/api/v1/inference/predict" and method == "POST":
            return ok(self._inference_predict(json.loads(body or b"{}")))

        if path == "/api/v1/kinds":
            return ok(sorted(TRAINING_KINDS))

        # -- TPU topology catalog (the JobCreate wizard's pickers; no
        # reference analog — GPU consoles free-type resource strings, a
        # TPU slice must be a valid (generation, topology) pair) --------
        if path == "/api/v1/tpu/topologies":
            from ..tpu import topology as topo
            return ok(topo.catalog())
        if path == "/api/v1/tpu/validate" and method == "POST":
            # resolves an (acceleratorType, topology?) pair through the
            # same tpu/topology.py the admission chain uses, so the wizard
            # rejects exactly what the operator would
            from ..tpu import topology as topo
            req = _parse_body(body)
            accel = str(req.get("acceleratorType", ""))
            spec = topo.parse_accelerator(accel)   # ValueError -> 400
            want_topo = str(req.get("topology", "") or "")
            if want_topo and want_topo != spec.topology_str:
                spec = topo.from_chips(spec.generation.name, spec.chips,
                                       topology=want_topo)
            return ok({"acceleratorType": spec.accelerator_type,
                       "topology": spec.topology_str,
                       "chips": spec.chips, "hosts": spec.num_hosts,
                       "chipsPerHost": spec.chips_per_host,
                       "gkeAccelerator": spec.gke_accelerator})

        # -- workspaces (reference routers/api/workspace.go:30-36) --------
        if path.startswith("/api/v1/workspace"):
            if self.workspaces is None:
                return 501, {"code": 501,
                             "msg": "no object backend: workspaces disabled"}, []
            if path == "/api/v1/workspace/create" and method == "POST":
                req = _parse_body(body)
                self.workspaces.create(WorkspaceRecord(
                    name=req.get("name", ""),
                    namespace=req.get("namespace", "default"),
                    username=req.get("username", ""),
                    type=req.get("type", ""),
                    pvc_name=req.get("pvc_name", ""),
                    local_path=req.get("local_path", ""),
                    description=req.get("description", ""),
                    cpu=int(req.get("cpu", 0) or 0),
                    memory=int(req.get("memory", 0) or 0),
                    tpu=int(req.get("tpu", 0) or 0),
                    storage=int(req.get("storage", 0) or 0),
                ))
                return ok(None)
            if path == "/api/v1/workspace/list":
                q = _query_from_params(params)
                rows = self.workspaces.list(q)
                return ok({"workspaceInfos": [r.to_row() for r in rows],
                           "total": q.count})
            if path == "/api/v1/workspace/detail":
                rec = self.workspaces.detail(params.get("name", ""))
                if rec is None:
                    raise NotFound("workspace not found")
                return ok(rec.to_row())
            mt = re.fullmatch(r"/api/v1/workspace/([^/]+)", path)
            if mt and method == "DELETE":
                self.workspaces.delete(mt.group(1))
                return ok(None)

        # -- data sources (reference routers/api/data_source.go:25-32) ----
        hit = _source_route(path, "/api/v1/datasource")
        if hit is not None:
            return self._source_crud(self.datasources, DataSource,
                                     method, hit, body, ok)
        # -- code sources (reference routers/api/code_source.go:25-32) ----
        hit = _source_route(path, "/api/v1/codesource")
        if hit is not None:
            return self._source_crud(self.codesources, CodeSource,
                                     method, hit, body, ok)

        raise NotFound(f"no route {method} {path}")

    def _source_crud(self, handler, cls, method: str, name: str,
                     body: bytes, ok):
        """Shared POST/PUT/GET/GET-one/DELETE surface of the datasource and
        codesource groups (their reference controllers are copies of each
        other modulo the model type)."""
        if method == "POST" or method == "PUT":
            req = _parse_body(body)
            entry = cls(**{k: str(req.get(k, "")) for k in
                           cls.__dataclass_fields__})
            entry.create_time = entry.create_time or self._now()
            entry.update_time = self._now()
            if method == "POST":
                handler.create(entry)
            else:
                handler.update(entry)
            return ok(f"success to {'create' if method == 'POST' else 'put'}")
        if method == "DELETE":
            if not name:
                raise ValueError("name is required")
            handler.delete(name)
            return ok("success to delete")
        if name:
            return ok(handler.get(name))
        return ok(handler.list())

    # -- inference playground ---------------------------------------------

    def _inference_list(self, params: dict) -> list:
        ns = params.get("namespace") or None
        out = []
        for inf in self.proxy.api.list("Inference", ns):
            out.append({
                "name": m.name(inf), "namespace": m.namespace(inf),
                "framework": m.get_in(inf, "spec", "framework",
                                      default=""),
                "predictors": [
                    {"name": p.get("name", ""),
                     "replicas": int(p.get("replicas") or 1)}
                    for p in m.get_in(inf, "spec", "predictors",
                                      default=[]) or []],
                "status": m.get_in(inf, "status", default={}),
            })
        return out

    def _predictor_base_url(self, inf: dict) -> str:
        if self.config.predictor_resolver is not None:
            return self.config.predictor_resolver(inf)
        from ..platform.serving import _DEFAULT_PORTS
        port = _DEFAULT_PORTS.get(
            m.get_in(inf, "spec", "framework", default=""), 8000)
        return (f"http://{m.name(inf)}.{m.namespace(inf)}.svc:{port}")

    def _inference_target(self, body: dict, stream: bool):
        """(url, payload) for a playground generation — the ONE
        CR-derived target rule for the buffered and streaming proxies
        (the URL never derives from the request, so the console can't be
        steered at arbitrary hosts)."""
        ns = body.get("namespace") or "default"
        name = body.get("name") or ""
        inf = self.proxy.api.try_get("Inference", ns, name)
        if inf is None:
            raise NotFound(f"inference {ns}/{name} not found")
        fwd = {"max_tokens": int(body.get("max_tokens", 256))}
        if stream:
            fwd["stream"] = True
        for k in ("temperature", "top_p", "stop"):
            if k in body:
                fwd[k] = body[k]
        if body.get("messages"):
            route, payload = "/v1/chat/completions", {
                **fwd, "messages": body["messages"]}
        elif body.get("prompt"):
            route, payload = "/v1/completions", {
                **fwd, "prompt": body["prompt"]}
        else:
            raise ValueError("need messages or prompt")
        return self._predictor_base_url(inf) + route, payload

    def _inference_predict(self, body: dict) -> dict:
        """Proxy one buffered generation to a deployed predictor's
        OpenAI-convention surface (fixed paths — no model name needed)."""
        import urllib.error
        import urllib.request

        url, payload = self._inference_target(body, stream=False)
        req = urllib.request.Request(
            url, method="POST", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.config.predictor_timeout_s) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                err = json.loads(e.read()).get("error")
                detail = (err or {}).get("message") if isinstance(
                    err, dict) else str(err or "")
            except Exception:  # noqa: BLE001 — upstream body is best-effort
                pass
            raise ValueError(
                f"predictor returned {e.code}: {detail or e.reason}")
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            raise ValueError(f"predictor unreachable: {e}")

    def inference_stream(self, body: dict):
        """Open (and return, unread) the predictor's SSE response for a
        streaming chat/completion — same CR-derived target rule as the
        buffered proxy."""
        import urllib.error
        import urllib.request

        url, payload = self._inference_target(body, stream=True)
        req = urllib.request.Request(
            url, method="POST", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            return urllib.request.urlopen(
                req, timeout=self.config.predictor_timeout_s)
        except urllib.error.HTTPError as e:
            raise ValueError(f"predictor returned {e.code}")
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            raise ValueError(f"predictor unreachable: {e}")

    def _find_job(self, kind: str, ns: str, name: str) -> Optional[dict]:
        kinds = [kind] if kind else TRAINING_KINDS
        for kd in kinds:
            if kd not in KIND_TABLE:
                continue
            job = self.proxy.get_job(kd, ns, name)
            if job is not None:
                return job
        return None

    def _persist_users(self, users: dict, admins: set) -> None:
        """Write a user set to the console ConfigMap so edits survive
        operator restarts (the reference keeps its user list in a
        kubedl-system ConfigMap for the same reason). The managed-by
        annotation makes resolve_users prefer this ConfigMap over the
        original env/config seed on the next start."""
        api = self.proxy.api
        data = {
            "users": json.dumps([
                {"username": u, "password": p}
                for u, p in sorted(users.items())]),
            "admins": json.dumps(sorted(admins)),
        }
        annotations = {MANAGED_ANNOTATION: "console"}
        cm = api.try_get("ConfigMap", CONSOLE_NAMESPACE, CONSOLE_CONFIGMAP)
        if cm is None:
            try:
                api.create({"apiVersion": "v1", "kind": "ConfigMap",
                            "metadata": {"name": CONSOLE_CONFIGMAP,
                                         "namespace": CONSOLE_NAMESPACE,
                                         "annotations": annotations},
                            "data": data})
                return
            except AlreadyExists:
                cm = api.get("ConfigMap", CONSOLE_NAMESPACE, CONSOLE_CONFIGMAP)
        cm = dict(cm)
        meta_ = cm.setdefault("metadata", {})
        meta_["annotations"] = {**(meta_.get("annotations") or {}),
                                **annotations}
        # merge: other keys an operator keeps in this ConfigMap survive
        cm["data"] = {**(cm.get("data") or {}), **data}
        api.update(cm)

    def _login(self, body: bytes):
        req = _parse_body(body)
        user, pw = req.get("username", ""), req.get("password", "")
        if self.users:
            # constant-time compare against a real entry or a dummy so a
            # probe can't distinguish bad-user from bad-password by timing
            expected = self.users.get(user) or secrets.token_urlsafe(8)
            if not hmac.compare_digest(str(expected), str(pw)) \
                    or user not in self.users:
                return 401, {"code": 401, "msg": "bad credentials"}, []
        token = self.sessions.login(user or "anonymous")
        cookie = (f"{SESSION_COOKIE}={token}; Path=/; HttpOnly; "
                  "SameSite=Strict")
        if self.config.cookie_secure:
            cookie += "; Secure"
        return 200, {"code": 200, "data": {"loginId": user}}, [
            ("Set-Cookie", cookie)]

    def _static(self, path: str):
        rel = path.lstrip("/") or "index.html"
        target = (FRONTEND_DIR / rel).resolve()
        if not target.is_relative_to(FRONTEND_DIR.resolve()) \
                or not target.is_file():
            target = FRONTEND_DIR / "index.html"  # SPA fallback
            if not target.is_file():
                return 404, {"code": 404, "msg": "no frontend build"}, []
        ctype = {"html": "text/html", "js": "text/javascript",
                 "css": "text/css", "svg": "image/svg+xml",
                 "png": "image/png"}.get(target.suffix.lstrip("."),
                                         "application/octet-stream")
        return 200, target.read_bytes(), [("Content-Type", ctype)]


class _ConsoleHandler(BaseHTTPRequestHandler):
    server_ref: ConsoleServer = None  # injected per-server subclass
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet by default
        pass

    def _token(self) -> Optional[str]:
        cookie = self.headers.get("Cookie", "")
        for part in cookie.split(";"):
            k, _, v = part.strip().partition("=")
            if k == SESSION_COOKIE:
                return v
        return None

    def _handle(self, method: str):
        parsed = urlparse(self.path)
        params = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        length = int(self.headers.get("Content-Length") or 0)
        if length > self.server_ref.config.max_body:
            # the unread body would desync keep-alive framing: drop the conn
            self.close_connection = True
            self._respond(413, {"code": 413, "msg": "body too large"}, [])
            return
        body = self.rfile.read(length) if length else b""
        if parsed.path == "/api/v1/inference/stream" and method == "POST":
            # SSE pass-through: can't ride the buffered route machinery
            return self._stream_inference(body)
        status, payload, headers = self.server_ref.route(
            method, parsed.path, params, body, self._token())
        self._respond(status, payload, headers)

    def _stream_inference(self, body: bytes):
        """Pipe the predictor's SSE stream to the browser. Auth and
        target resolution reuse the buffered route's rules; only the
        byte-copy loop differs."""
        srv = self.server_ref
        user = srv.sessions.user(self._token())
        if srv.users and user is None:
            self._respond(401, {"code": 401, "msg": "not logged in"}, [])
            return
        try:
            upstream = srv.inference_stream(json.loads(body or b"{}"))
        except NotFound as e:
            self._respond(404, {"code": 404, "msg": str(e)}, [])
            return
        except (ApiError, ValueError, KeyError, TypeError,
                AttributeError) as e:
            self._respond(400, {"code": 400,
                                "msg": f"{type(e).__name__}: {e}"}, [])
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            with upstream:
                for raw in upstream:
                    self.wfile.write(f"{len(raw):x}\r\n".encode()
                                     + raw + b"\r\n")
                    self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError, OSError):
            self.close_connection = True

    def _respond(self, status: int, payload, headers):
        data = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(status)
        ctype = dict(headers).get("Content-Type", "application/json")
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for key, val in headers:
            if key != "Content-Type":
                self.send_header(key, val)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_PUT(self):
        self._handle("PUT")

    def do_DELETE(self):
        self._handle("DELETE")


def _source_route(path: str, prefix: str) -> Optional[str]:
    """Match ``{prefix}`` (collection) or ``{prefix}/{name}`` (item);
    returns the item name, "" for the collection, None for no match."""
    if path == prefix:
        return ""
    mt = re.fullmatch(re.escape(prefix) + r"/([^/]+)", path)
    return mt.group(1) if mt else None


def _parse_body(body: bytes) -> dict:
    """POST bodies arrive as JSON (our SPA) or form-encoded (the reference
    frontend uses PostForm)."""
    text = body.decode()
    if not text.strip():
        return {}
    try:
        obj = json.loads(text)
        if isinstance(obj, dict):
            return obj
    except ValueError:
        pass
    return {k: v[0] for k, v in parse_qs(text).items()}


def _parse_manifest(body: bytes) -> dict:
    """Submit endpoints accept JSON or YAML (the reference console submits
    JSON; kubectl users paste YAML)."""
    text = body.decode()
    try:
        obj = json.loads(text)
    except ValueError:
        try:
            obj = yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise ValueError(f"manifest is neither JSON nor YAML: {e}")
    if not isinstance(obj, dict) or not m.name(obj):
        raise ValueError("manifest must be an object with metadata.name")
    return obj


def _query_from_params(params: dict) -> Query:
    return Query(
        kind=params.get("kind", ""),
        name=params.get("name", ""),
        namespace=params.get("namespace", ""),
        status=params.get("status", ""),
        start_time=params.get("start_time", ""),
        end_time=params.get("end_time", ""),
        page_num=int(params.get("current_page", 0) or 0),
        page_size=int(params.get("page_size", 0) or 0),
    )
