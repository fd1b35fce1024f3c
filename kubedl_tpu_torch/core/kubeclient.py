"""Real-cluster client: the in-memory ``APIServer`` interface over HTTP(S)
to an actual kube-apiserver.

This is the piece that makes kubedl-tpu an operator *of a real cluster*
(reference ``main.go:81-126`` builds a controller-runtime manager against
the live api-server; round 1 only ever talked to its own in-memory store).
The operator selects it with ``--kubeconfig``/``--in-cluster``; everything
above — engines, platform controllers, console — is substrate-agnostic
because both servers expose the same surface:

    create / get / try_get / list / update / update_status / patch_merge /
    delete / watch / now

Implementation notes:

* stdlib only (``http.client`` + ``ssl``): no kubernetes client dep;
* one connection per thread (reconcile workers are threads);
* ``watch(fn)`` subscribes; ``start(kinds)`` spawns per-kind list+watch
  loops with resourceVersion resume and 410-Gone relist — the informer
  pattern (reference watches in
  ``controllers/pytorch/pytorchjob_controller.go:148-185``);
* kind→REST mapping comes from a registry seeded with the builtin kinds
  and every kubedl CRD; objects passing through ``create``/``update``
  teach the client their apiVersion (PodGroups differ per gang plugin).

Copied from ``kubedl_tpu/core/kubeclient.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import base64
import http.client
import json
import logging
import os
import random
import ssl
import tempfile
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Callable, Optional

from . import meta as m
from .apiserver import AlreadyExists, ApiError, Conflict, Invalid, NotFound

log = logging.getLogger("kubedl_tpu_torch.kubeclient")

Obj = dict

# -- REST mapping ------------------------------------------------------------

#: kind -> (apiVersion, plural); the default scheme. PodGroup's default is
#: the coscheduler flavor; creating one with a different apiVersion
#: re-teaches the mapping (see ``_learn``).
DEFAULT_SCHEME: dict[str, tuple[str, str]] = {
    # core/v1
    "Pod": ("v1", "pods"),
    "Service": ("v1", "services"),
    "ConfigMap": ("v1", "configmaps"),
    "Secret": ("v1", "secrets"),
    "Event": ("v1", "events"),
    "Namespace": ("v1", "namespaces"),
    "ServiceAccount": ("v1", "serviceaccounts"),
    "PersistentVolume": ("v1", "persistentvolumes"),
    "PersistentVolumeClaim": ("v1", "persistentvolumeclaims"),
    # groups
    "Deployment": ("apps/v1", "deployments"),
    "HorizontalPodAutoscaler": ("autoscaling/v2", "horizontalpodautoscalers"),
    "Ingress": ("networking.k8s.io/v1", "ingresses"),
    "Lease": ("coordination.k8s.io/v1", "leases"),
    "Role": ("rbac.authorization.k8s.io/v1", "roles"),
    "RoleBinding": ("rbac.authorization.k8s.io/v1", "rolebindings"),
    "PodGroup": ("scheduling.sigs.k8s.io/v1alpha1", "podgroups"),
    "VirtualService": ("networking.istio.io/v1beta1", "virtualservices"),
    "Dataset": ("data.fluid.io/v1alpha1", "datasets"),
    "AlluxioRuntime": ("data.fluid.io/v1alpha1", "alluxioruntimes"),
    # kubedl CRDs (config/crd/bases/)
    "TFJob": ("training.kubedl.io/v1alpha1", "tfjobs"),
    "PyTorchJob": ("training.kubedl.io/v1alpha1", "pytorchjobs"),
    "JAXJob": ("training.kubedl.io/v1alpha1", "jaxjobs"),
    "MPIJob": ("training.kubedl.io/v1alpha1", "mpijobs"),
    "XGBoostJob": ("training.kubedl.io/v1alpha1", "xgboostjobs"),
    "XDLJob": ("training.kubedl.io/v1alpha1", "xdljobs"),
    "MarsJob": ("training.kubedl.io/v1alpha1", "marsjobs"),
    "ElasticDLJob": ("training.kubedl.io/v1alpha1", "elasticdljobs"),
    "Model": ("model.kubedl.io/v1alpha1", "models"),
    "ModelVersion": ("model.kubedl.io/v1alpha1", "modelversions"),
    "Inference": ("serving.kubedl.io/v1alpha1", "inferences"),
    "Notebook": ("notebook.kubedl.io/v1alpha1", "notebooks"),
    "CacheBackend": ("cache.kubedl.io/v1alpha1", "cachebackends"),
    "Cron": ("apps.kubedl.io/v1alpha1", "crons"),
    "TestJob": ("test.kubedl.io/v1alpha1", "testjobs"),
}

#: kinds with no ``namespace`` path segment
CLUSTER_SCOPED = {"Namespace", "PersistentVolume"}


def api_prefix(api_version: str) -> str:
    """``v1`` → ``/api/v1``; ``apps/v1`` → ``/apis/apps/v1``."""
    return f"/api/{api_version}" if "/" not in api_version \
        else f"/apis/{api_version}"


# -- cluster config ----------------------------------------------------------

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclass
class ClusterConfig:
    """Where the api-server is and how to authenticate."""
    server: str = ""                      # e.g. https://10.0.0.1:443
    ca_file: Optional[str] = None
    token: Optional[str] = None
    token_file: Optional[str] = None      # re-read (bound tokens rotate)
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    insecure_skip_tls_verify: bool = False

    @staticmethod
    def in_cluster() -> "ClusterConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return ClusterConfig(
            server=f"https://{host}:{port}",
            ca_file=os.path.join(_SA_DIR, "ca.crt"),
            token_file=os.path.join(_SA_DIR, "token"))

    @staticmethod
    def from_kubeconfig(path: Optional[str] = None,
                        context: Optional[str] = None) -> "ClusterConfig":
        import yaml
        path = path or os.environ.get("KUBECONFIG") \
            or os.path.expanduser("~/.kube/config")
        with open(path) as f:
            kc = yaml.safe_load(f) or {}
        ctx_name = context or kc.get("current-context")
        ctx = _named(kc.get("contexts", []), ctx_name).get("context", {})
        cluster = _named(kc.get("clusters", []),
                         ctx.get("cluster")).get("cluster", {})
        user = _named(kc.get("users", []), ctx.get("user")).get("user", {})
        cfg = ClusterConfig(server=cluster.get("server", ""))
        cfg.insecure_skip_tls_verify = bool(
            cluster.get("insecure-skip-tls-verify"))
        cfg.ca_file = cluster.get("certificate-authority") or _data_file(
            cluster.get("certificate-authority-data"), "ca")
        cfg.client_cert_file = user.get("client-certificate") or _data_file(
            user.get("client-certificate-data"), "cert")
        cfg.client_key_file = user.get("client-key") or _data_file(
            user.get("client-key-data"), "key")
        cfg.token = user.get("token")
        cfg.token_file = user.get("tokenFile")
        return cfg

    def bearer_token(self) -> Optional[str]:
        if self.token_file:
            try:
                with open(self.token_file) as f:
                    return f.read().strip()
            except OSError:
                return self.token
        return self.token

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.server.startswith("https"):
            return None
        if self.insecure_skip_tls_verify:
            ctx = ssl._create_unverified_context()  # noqa: S323 — opt-in flag
        else:
            ctx = ssl.create_default_context(cafile=self.ca_file)
        if self.client_cert_file and self.client_key_file:
            ctx.load_cert_chain(self.client_cert_file, self.client_key_file)
        return ctx


def _named(items: list, name: Optional[str]) -> dict:
    for it in items or []:
        if it.get("name") == name:
            return it
    return {}


def _data_file(b64: Optional[str], tag: str) -> Optional[str]:
    """Materialize base64 kubeconfig inline data as a temp file (ssl wants
    paths)."""
    if not b64:
        return None
    f = tempfile.NamedTemporaryFile(
        prefix=f"kubedl-{tag}-", suffix=".pem", delete=False)
    f.write(base64.b64decode(b64))
    f.close()
    return f.name


# -- the client --------------------------------------------------------------

class _Backoff:
    """Exponential backoff with full jitter (a flat retry cadence across
    watchers turns an apiserver outage into a synchronized hammer —
    round-2 weak #3)."""

    def __init__(self, base: float = 1.0, cap: float = 30.0):
        self.base = base
        self.cap = cap
        self._n = 0

    def next(self) -> float:
        delay = min(self.cap, self.base * (2 ** self._n))
        self._n = min(self._n + 1, 16)
        return random.uniform(0, delay)

    def reset(self) -> None:
        self._n = 0


class KubeAPIServer:
    """``APIServer``-interface adapter over a real kube-apiserver."""

    def __init__(self, config: ClusterConfig,
                 clock: Callable[[], float] = time.time,
                 request_timeout: float = 30.0,
                 watch_timeout_seconds: int = 300,
                 list_page_size: int = 500):
        self.config = config
        self._clock = clock
        self._timeout = request_timeout
        self._watch_timeout = watch_timeout_seconds
        self.list_page_size = list_page_size
        self._scheme = dict(DEFAULT_SCHEME)
        self._plural_cache: dict[str, tuple[str, str]] = {}
        self._local = threading.local()
        self._watchers: list[Callable[[str, Obj], None]] = []
        self._watch_threads: list[threading.Thread] = []
        self._stopping = threading.Event()
        u = urllib.parse.urlsplit(config.server)
        self._host = u.hostname or "localhost"
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._https = u.scheme == "https"

    # -- plumbing ---------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def _conn(self) -> tuple[http.client.HTTPConnection, bool]:
        """Returns (connection, reused): ``reused`` drives the
        stale-keep-alive retry policy — a reused connection that fails is
        almost always the server having reaped it while idle."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            return conn, True
        if self._https:
            conn = http.client.HTTPSConnection(
                self._host, self._port, timeout=self._timeout,
                context=self.config.ssl_context())
        else:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout)
        self._local.conn = conn
        return conn, False

    def _headers(self, content_type: str = "application/json") -> dict:
        h = {"Accept": "application/json", "Content-Type": content_type}
        tok = self.config.bearer_token()
        if tok:
            h["Authorization"] = f"Bearer {tok}"
        return h

    def _request(self, method: str, path: str, body: Optional[Obj] = None,
                 params: Optional[dict] = None,
                 content_type: str = "application/json",
                 raw: bool = False):
        if params:
            path = path + "?" + urllib.parse.urlencode(params)
        payload = json.dumps(body).encode() if body is not None else None
        # reads retry transient trouble (transport + 429/5xx) with jittered
        # backoff. Mutations never retry a request a FRESH connection may
        # have delivered (a replayed POST/PUT is not idempotent) — but a
        # REUSED keep-alive connection that fails gets one retry on a
        # fresh connection: the server reaping an idle connection is the
        # overwhelmingly common cause, and it fails before delivery
        # (the Go net/http retry policy).
        attempts = 3 if method == "GET" else 0
        backoff = _Backoff(base=0.5, cap=5.0)
        attempt = 0
        while True:
            conn, reused = self._conn()
            sent = False
            try:
                conn.request(method, path, body=payload,
                             headers=self._headers(content_type))
                sent = True
                resp = conn.getresponse()
                data = resp.read()
            except http.client.RemoteDisconnected:
                self._local.conn = None
                conn.close()
                if reused:
                    # clean close with ZERO response bytes on a reused
                    # keep-alive: the server reaped the idle connection
                    # before processing anything — safe to replay any verb
                    # (the Go net/http retry rule). On a fresh connection
                    # this is a real server-side close: normal policy.
                    continue
                if method != "GET" or attempt >= attempts:
                    raise
                attempt += 1
                self._stopping.wait(backoff.next())
                continue
            except (http.client.HTTPException, OSError):
                # drop the (possibly stale kept-alive) connection either way
                self._local.conn = None
                conn.close()
                if reused and not sent:
                    # send-time failure: the request never left, replaying
                    # any verb is safe. Post-send failures (timeout
                    # mid-response) never replay mutations — the server
                    # may have acted.
                    continue
                if method != "GET" or attempt >= attempts:
                    raise
                attempt += 1
                self._stopping.wait(backoff.next())
                continue
            if method == "GET" and attempt < attempts \
                    and (resp.status == 429 or resp.status >= 500):
                attempt += 1
                self._stopping.wait(backoff.next())
                continue
            break
        if resp.status >= 400:
            raise self._error(resp.status, data, method, path)
        if raw:
            return data.decode(errors="replace")
        return json.loads(data) if data else {}

    @staticmethod
    def _error(status: int, data: bytes, method: str, path: str) -> ApiError:
        try:
            msg = json.loads(data).get("message", "")
        except Exception:
            msg = data[:200].decode(errors="replace")
        detail = f"{method} {path}: {status} {msg}"
        if status == 404:
            err = NotFound(detail)
        elif status == 409:
            # POST conflict = name taken; PUT conflict = resourceVersion
            err = AlreadyExists(detail) if method == "POST" else Conflict(detail)
        elif status in (400, 422):
            err = Invalid(detail)
        else:
            err = ApiError(detail)
        err.code = status  # structured, not substring-matched (410 Gone)
        return err

    # -- REST mapping -----------------------------------------------------

    def register_kind(self, api_version: str, kind: str,
                      plural: Optional[str] = None) -> None:
        self._scheme[kind] = (api_version, plural or kind.lower() + "s")

    def _learn(self, obj: Obj) -> None:
        """Objects carry their own apiVersion; prefer it over the default
        mapping (e.g. volcano PodGroups)."""
        av, kd = obj.get("apiVersion"), obj.get("kind")
        if av and kd and self._scheme.get(kd, ("", ""))[0] != av:
            plural = self._scheme.get(kd, (None, None))[1]
            self._scheme[kd] = (av, plural or kd.lower() + "s")

    def mapping(self, kind: str) -> tuple[str, str]:
        try:
            return self._scheme[kind]
        except KeyError:
            raise Invalid(f"no REST mapping for kind {kind!r}; "
                          f"call register_kind()") from None

    def _path(self, kind: str, namespace: Optional[str], name: str = "",
              subresource: str = "") -> str:
        av, plural = self.mapping(kind)
        parts = [api_prefix(av)]
        if namespace and kind not in CLUSTER_SCOPED:
            parts.append(f"namespaces/{namespace}")
        parts.append(plural)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        return "/".join(parts)

    # -- CRUD (the APIServer surface) -------------------------------------

    def create(self, obj: Obj) -> Obj:
        self._learn(obj)
        md = m.meta(obj)
        ns = md.setdefault("namespace", "default")
        return self._request("POST", self._path(m.kind(obj), ns), body=obj)

    def get(self, kind: str, namespace: str, name: str) -> Obj:
        return self._request("GET", self._path(kind, namespace, name))

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[Obj]:
        try:
            return self.get(kind, namespace, name)
        except NotFound:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             selector: Optional[dict] = None,
             field_selector: Optional[object] = None) -> list[Obj]:
        items, _ = self._paged_list(kind, namespace, selector, field_selector)
        return items

    def _paged_list(self, kind: str, namespace: Optional[str],
                    selector: Optional[dict] = None,
                    field_selector: Optional[object] = None
                    ) -> tuple[list[Obj], str]:
        """Chunked LIST via ``limit``+``continue`` (one giant response per
        relist was round-2 weak #3). Returns (items, collection RV) — the
        RV of the final page is the correct point to start a watch from."""
        params = {}
        if selector:
            params["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(selector.items()))
        if field_selector:
            params["fieldSelector"] = (
                field_selector if isinstance(field_selector, str)
                else ",".join(f"{k}={v}"
                              for k, v in sorted(field_selector.items())))
        av = self.mapping(kind)[0]
        items: list[Obj] = []
        rv = "0"
        cont = ""
        while True:
            page = dict(params)
            page["limit"] = str(self.list_page_size)
            if cont:
                page["continue"] = cont
            out = self._request("GET", self._path(kind, namespace),
                                params=page)
            chunk = out.get("items", []) or []
            for it in chunk:
                # list items omit apiVersion/kind; put them back so
                # downstream meta helpers see complete objects
                it.setdefault("kind", kind)
                it.setdefault("apiVersion", av)
            items.extend(chunk)
            rv = str(m.get_in(out, "metadata", "resourceVersion",
                              default=rv) or rv)
            cont = str(m.get_in(out, "metadata", "continue", default="") or "")
            if not cont:
                return items, rv

    def update(self, obj: Obj, subresource: Optional[str] = None) -> Obj:
        self._learn(obj)
        md = m.meta(obj)
        path = self._path(m.kind(obj), md.get("namespace", "default"),
                          md.get("name", ""), subresource or "")
        return self._request("PUT", path, body=obj)

    def update_status(self, obj: Obj) -> Obj:
        return self.update(obj, subresource="status")

    def patch_merge(self, kind: str, namespace: str, name: str,
                    patch: Obj) -> Obj:
        return self._request(
            "PATCH", self._path(kind, namespace, name), body=patch,
            content_type="application/merge-patch+json")

    def delete(self, kind: str, namespace: str, name: str) -> None:
        # propagationPolicy as a query param, not a DeleteOptions body: a
        # body on DELETE desyncs keep-alive connections against servers
        # that don't drain it (and the param form is equally valid)
        self._request("DELETE", self._path(kind, namespace, name),
                      params={"propagationPolicy": "Background"})

    def pod_logs(self, namespace: str, name: str,
                 container: Optional[str] = None,
                 tail_lines: Optional[int] = None) -> str:
        """GET the pod log subresource (real kubelet logs — the console's
        logs tab upgrades from event-stream pseudo-logs to these when the
        operator runs against a real cluster). Rides _request's full
        transport policy (keep-alive recovery, 429/5xx backoff)."""
        params = {}
        if container:
            params["container"] = container
        if tail_lines is not None:
            params["tailLines"] = str(tail_lines)
        return self._request("GET", self._path("Pod", namespace, name, "log"),
                             params=params or None, raw=True)

    # -- watch (informer-style list+watch fan-out) -------------------------

    def watch(self, fn: Callable[[str, Obj], None]) -> Callable[[], None]:
        self._watchers.append(fn)

        def cancel():
            if fn in self._watchers:
                self._watchers.remove(fn)
        return cancel

    def _emit(self, event_type: str, obj: Obj) -> None:
        for w in list(self._watchers):
            try:
                w(event_type, obj)
            except Exception:
                log.exception("watch subscriber failed")

    def start(self, kinds: list[str], namespace: Optional[str] = None) -> None:
        """Spawn one list+watch loop per kind. Initial LIST emits synthetic
        ADDED events so controllers reconcile pre-existing objects (informer
        resync semantics)."""
        for kind in kinds:
            t = threading.Thread(
                target=self._watch_loop, args=(kind, namespace),
                name=f"watch-{kind}", daemon=True)
            self._watch_threads.append(t)
            t.start()

    def stop(self) -> None:
        self._stopping.set()

    def _watch_loop(self, kind: str, namespace: Optional[str]) -> None:
        rv: Optional[str] = None
        backoff = _Backoff(base=1.0, cap=30.0)
        while not self._stopping.is_set():
            try:
                if rv is None:
                    items, rv = self._paged_list(kind, namespace)
                    for it in items:
                        self._emit("ADDED", it)
                rv = self._watch_once(kind, namespace, rv)
                backoff.reset()  # a full watch window without error
            except ApiError as e:
                if getattr(e, "code", None) == 410:
                    # 410 Gone: relist — with backoff, because an expired
                    # continue token mid-relist also lands here and a
                    # zero-delay relist loop is the hammer _Backoff exists
                    # to prevent
                    rv = None
                    self._stopping.wait(backoff.next())
                else:
                    delay = backoff.next()
                    log.warning("watch %s: %s; retrying in %.1fs", kind, e,
                                delay)
                    self._stopping.wait(delay)
            except Exception:
                delay = backoff.next()
                log.exception("watch %s failed; retrying in %.1fs", kind,
                              delay)
                self._stopping.wait(delay)

    def _watch_once(self, kind: str, namespace: Optional[str],
                    rv: str) -> str:
        """One streaming watch request; returns the last seen RV."""
        params = {"watch": "true", "resourceVersion": rv,
                  "allowWatchBookmarks": "true",
                  "timeoutSeconds": str(self._watch_timeout)}
        path = self._path(kind, namespace) + "?" + urllib.parse.urlencode(params)
        # dedicated connection: a streaming read can't share the per-thread
        # CRUD connection
        if self._https:
            conn = http.client.HTTPSConnection(
                self._host, self._port,
                timeout=self._watch_timeout + 30,
                context=self.config.ssl_context())
        else:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._watch_timeout + 30)
        try:
            conn.request("GET", path, headers=self._headers())
            resp = conn.getresponse()
            if resp.status >= 400:
                raise self._error(resp.status, resp.read(), "GET", path)
            while not self._stopping.is_set():
                line = resp.readline()
                if not line:
                    return rv  # server closed (timeout window elapsed)
                line = line.strip()
                if not line:
                    continue
                evt = json.loads(line)
                etype, obj = evt.get("type", ""), evt.get("object", {}) or {}
                new_rv = m.get_in(obj, "metadata", "resourceVersion",
                                  default=None)
                if new_rv is not None:
                    rv = str(new_rv)
                if etype == "BOOKMARK":
                    continue
                if etype == "ERROR":
                    # in-stream Status object; carry its real code so only
                    # a true 410 triggers the relist path
                    code = int(m.get_in(obj, "code", default=0) or 410)
                    err = ApiError(f"watch error {code}: "
                                   f"{obj.get('message', '')}")
                    err.code = code
                    raise err
                obj.setdefault("kind", kind)
                obj.setdefault("apiVersion", self.mapping(kind)[0])
                self._emit(etype, obj)
        finally:
            conn.close()
        return rv
