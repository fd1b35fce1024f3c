"""The API-server client of an in-cluster training job: the port's copy of
the request path of ``kubedl_tpu/core/kubeclient.py``.

The training side of the operator's elastic 2-phase protocol
(``train.checkpoint.ElasticCheckpointAgent``) reads its own job object
and merge-patches one annotation onto it; this module is what it needs
for that, and nothing more:

* :class:`ClusterConfig` with :meth:`~ClusterConfig.in_cluster` (the
  service account's CA and token; the token file is re-read on every
  request, since bound tokens rotate);
* :class:`KubeAPIServer`'s ``get``, ``try_get`` and ``patch_merge``, over
  stdlib ``http.client``: one connection per thread, reads retried on
  transport errors, 429 and 5xx with jittered backoff, a mutation replayed
  only when a reused keep-alive connection failed before it was sent, and
  each error status mapped to the :class:`ApiError` family (the client
  never creates, so a 409 is always a :class:`Conflict`);
* the kind -> REST mapping of the job kinds whose pods the operator gives
  ``KUBEDL_JOB_KIND``.

Left out, since no entry point of the port calls them: kubeconfig files
(they need ``yaml``) and the options only they set (a static token,
client certificates, skipping TLS verification), create/list/update/
delete and ``AlreadyExists``, watches and informers, and registering
other kinds.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import ssl
import threading
import time
import urllib.parse
from dataclasses import dataclass
from typing import Optional

# the in-memory API server's error family, so one ``except`` catches either
# server's (``ServerError`` is what the SLO evaluator catches)
from .apiserver import (ApiError, Conflict, Invalid, NotFound,  # noqa: F401
                        ServerError)

Obj = dict


# -- REST mapping ------------------------------------------------------------

_TRAINING = "training.kubedl.io/v1alpha1"

#: kind -> (apiVersion, plural) of every job kind the operator reconciles
#: (each of its pods carries ``KUBEDL_JOB_KIND``)
JOB_SCHEME: dict[str, tuple[str, str]] = {
    "TFJob": (_TRAINING, "tfjobs"),
    "PyTorchJob": (_TRAINING, "pytorchjobs"),
    "JAXJob": (_TRAINING, "jaxjobs"),
    "MPIJob": (_TRAINING, "mpijobs"),
    "XGBoostJob": (_TRAINING, "xgboostjobs"),
    "XDLJob": (_TRAINING, "xdljobs"),
    "MarsJob": (_TRAINING, "marsjobs"),
    "ElasticDLJob": (_TRAINING, "elasticdljobs"),
    "RLJob": (_TRAINING, "rljobs"),
}


def api_prefix(api_version: str) -> str:
    """``v1`` -> ``/api/v1``; ``apps/v1`` -> ``/apis/apps/v1``."""
    return f"/api/{api_version}" if "/" not in api_version \
        else f"/apis/{api_version}"


# -- cluster config ----------------------------------------------------------

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


@dataclass
class ClusterConfig:
    """Where the API server is and how to authenticate: the service
    account's CA and token file in a pod."""
    server: str = ""                      # e.g. https://10.0.0.1:443
    ca_file: Optional[str] = None
    token_file: Optional[str] = None      # re-read (bound tokens rotate)

    @staticmethod
    def in_cluster() -> "ClusterConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST",
                              "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return ClusterConfig(
            server=f"https://{host}:{port}",
            ca_file=os.path.join(_SA_DIR, "ca.crt"),
            token_file=os.path.join(_SA_DIR, "token"))

    def bearer_token(self) -> Optional[str]:
        if not self.token_file:
            return None
        try:
            with open(self.token_file) as f:
                return f.read().strip()
        except OSError:
            return None

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.server.startswith("https"):
            return None
        return ssl.create_default_context(cafile=self.ca_file)


# -- the client --------------------------------------------------------------

class _Backoff:
    """Exponential backoff with full jitter (a flat retry cadence across
    clients turns an API-server outage into a synchronized hammer)."""

    def __init__(self, base: float = 1.0, cap: float = 30.0):
        self.base = base
        self.cap = cap
        self._n = 0

    def next(self) -> float:
        delay = min(self.cap, self.base * (2 ** self._n))
        self._n = min(self._n + 1, 16)
        return random.uniform(0, delay)


class KubeAPIServer:
    """``get``/``try_get``/``patch_merge`` against a kube-apiserver."""

    def __init__(self, config: ClusterConfig,
                 request_timeout: float = 30.0):
        self.config = config
        self._timeout = request_timeout
        self._local = threading.local()
        u = urllib.parse.urlsplit(config.server)
        self._host = u.hostname or "localhost"
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._https = u.scheme == "https"

    # -- plumbing ---------------------------------------------------------

    def _conn(self) -> tuple[http.client.HTTPConnection, bool]:
        """Returns (connection, reused): ``reused`` drives the
        stale-keep-alive retry policy (a reused connection that fails is
        almost always the server having reaped it while idle)."""
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
                 content_type: str = "application/json"):
        payload = json.dumps(body).encode() if body is not None else None
        # reads retry transient trouble (transport, 429, 5xx) with jittered
        # backoff. A mutation is replayed only on a REUSED keep-alive
        # connection that failed before delivery (the server reaping an
        # idle connection): a fresh one may have delivered it
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
                    # a clean close with no response bytes on a reused
                    # connection: nothing was processed, any verb replays
                    continue
                if method != "GET" or attempt >= attempts:
                    raise
                attempt += 1
                time.sleep(backoff.next())
                continue
            except (http.client.HTTPException, OSError):
                self._local.conn = None
                conn.close()
                if reused and not sent:
                    continue            # the request never left
                if method != "GET" or attempt >= attempts:
                    raise
                attempt += 1
                time.sleep(backoff.next())
                continue
            if method == "GET" and attempt < attempts \
                    and (resp.status == 429 or resp.status >= 500):
                attempt += 1
                time.sleep(backoff.next())
                continue
            break
        if resp.status >= 400:
            raise self._error(resp.status, data, method, path)
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
            err = Conflict(detail)
        elif status in (400, 422):
            err = Invalid(detail)
        else:
            err = ApiError(detail)
        err.code = status
        return err

    # -- REST mapping -----------------------------------------------------

    @staticmethod
    def mapping(kind: str) -> tuple[str, str]:
        try:
            return JOB_SCHEME[kind]
        except KeyError:
            raise Invalid(f"no REST mapping for kind {kind!r}") from None

    def _path(self, kind: str, namespace: str, name: str) -> str:
        av, plural = self.mapping(kind)
        return "/".join([api_prefix(av), f"namespaces/{namespace}", plural,
                         name])

    # -- the calls --------------------------------------------------------

    def get(self, kind: str, namespace: str, name: str) -> Obj:
        return self._request("GET", self._path(kind, namespace, name))

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[Obj]:
        try:
            return self.get(kind, namespace, name)
        except NotFound:
            return None

    def patch_merge(self, kind: str, namespace: str, name: str,
                    patch: Obj) -> Obj:
        return self._request(
            "PATCH", self._path(kind, namespace, name), body=patch,
            content_type="application/merge-patch+json")
