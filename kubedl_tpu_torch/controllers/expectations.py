"""Controllee expectations cache.

Behavioral port of the reference's expectations mechanism
(``pkg/job_controller/expectations.go:31-68``, itself the upstream k8s
controller pattern): after issuing N creates/deletes, a controller expects to
*observe* N watch events before trusting its (possibly stale) cache again.
``satisfied()`` gates reconciliation; observations arrive from the watch
stream. With the in-memory API server the cache is never stale, but against
a real apiserver (REST client mode) this is what stops reconcile storms from
double-creating pods — including the AlreadyExists trap documented at
reference ``pkg/job_controller/pod.go:282-307``.

Copied from ``kubedl_tpu/controllers/expectations.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
import time


class Expectations:
    TIMEOUT = 5 * 60.0  # stale expectations expire, like upstream

    def __init__(self, clock=time.time, timeout: float = TIMEOUT):
        self._clock = clock
        self.timeout = timeout
        self._lock = threading.Lock()
        # key -> [pending_creations, pending_deletions, timestamp]
        self._exp: dict[str, list] = {}

    @staticmethod
    def pods_key(job_key: str, replica_type: str) -> str:
        return f"{job_key}/{replica_type.lower()}/pods"

    @staticmethod
    def services_key(job_key: str, replica_type: str) -> str:
        return f"{job_key}/{replica_type.lower()}/services"

    def expect_creations(self, key: str, n: int) -> None:
        with self._lock:
            e = self._exp.setdefault(key, [0, 0, self._clock()])
            e[0] += n
            e[2] = self._clock()

    def expect_deletions(self, key: str, n: int) -> None:
        with self._lock:
            e = self._exp.setdefault(key, [0, 0, self._clock()])
            e[1] += n
            e[2] = self._clock()

    def creation_observed(self, key: str) -> None:
        self._observed(key, 0)

    def deletion_observed(self, key: str) -> None:
        self._observed(key, 1)

    def _observed(self, key: str, idx: int) -> None:
        with self._lock:
            e = self._exp.get(key)
            if e and e[idx] > 0:
                e[idx] -= 1

    def satisfied(self, key: str) -> bool:
        with self._lock:
            e = self._exp.get(key)
            if e is None:
                return True
            if e[0] <= 0 and e[1] <= 0:
                return True
            if self._clock() - e[2] > self.timeout:
                # expired: a watch event was dropped or never came.
                # Clear the stale record too — leaving the phantom counts
                # behind would poison every future expect_* on this key
                # (each new expectation would start from the missed debt)
                del self._exp[key]
                return True
            return False

    def expires_in(self, key: str) -> float:
        """Seconds until an unsatisfied expectation on ``key`` expires
        (0 when none is pending) — what a blocked reconcile should
        requeue after, so recovery from a dropped watch event does not
        depend on some unrelated event happening to arrive."""
        with self._lock:
            e = self._exp.get(key)
            if e is None:
                return 0.0
            return max(0.0, self.timeout - (self._clock() - e[2]))

    def delete_expectations(self, key: str) -> None:
        with self._lock:
            self._exp.pop(key, None)

    def delete_prefix(self, job_key: str) -> None:
        """Drop every expectation of a deleted job (all replica types)."""
        prefix = job_key + "/"
        with self._lock:
            for k in [k for k in self._exp if k.startswith(prefix)]:
                del self._exp[k]
