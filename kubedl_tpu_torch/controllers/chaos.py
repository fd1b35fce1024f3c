"""Deterministic fault injection around the in-memory API server.

Real clusters fail in ways the happy-path fake never exercises: status
writes 409, creates time out after committing, watch connections drop or
replay events, and spot/preemptible TPU nodes vanish mid-step with a
``DisruptionTarget`` condition. ``ChaosAPIServer`` wraps ``APIServer`` and
injects exactly those faults — *deterministically*, from a seeded RNG plus
explicit scripted schedules, so every chaos test reproduces from its seed
(override with ``KUBEDL_CHAOS_SEED``; the seed is embedded in every
injected error message for post-mortem repro).

Two injection styles compose:

* **scripted** — ``fail_next("update_status", Conflict, times=2)`` queues
  precise faults for targeted tests (the next two engine status flushes
  409), and ``schedule_preemption(nth_create)`` preempts the N-th pod the
  engine creates;
* **seeded probabilities** — ``ChaosConfig`` rates for soak tests where a
  whole job lifecycle must survive a storm of random-but-replayable
  faults.

The kubelet-simulation helpers in ``controllers.testing`` bypass the
wrapper (node agents don't ride the operator's API connection), as do the
preemption helpers here — chaos *causes* the disruption, it doesn't get
disrupted applying it.

Copied from ``kubedl_tpu/controllers/chaos.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
import logging
import os
import random
from dataclasses import dataclass, field
from typing import Optional

from ..api import common as c
from ..core import meta as m
from ..core.apiserver import APIServer, Conflict, ServerError, Timeout

log = logging.getLogger("kubedl_tpu_torch.chaos")

ENV_CHAOS_SEED = "KUBEDL_CHAOS_SEED"
DEFAULT_SEED = 20260804

#: pod condition kubelet/scheduler set on voluntary disruption (k8s >=1.26);
#: re-exported so chaos and the engine can never disagree on the string
DISRUPTION_TARGET = c.POD_COND_DISRUPTION_TARGET


def chaos_seed(default: int = DEFAULT_SEED) -> int:
    """The chaos seed, overridable via ``KUBEDL_CHAOS_SEED`` for replaying
    a failed run. A malformed override fails HERE, loudly — silently
    falling back to the default would "replay" a different storm than the
    one being debugged, and raising bare ``int()`` noise mid-run names
    neither the variable nor the fix."""
    raw = os.environ.get(ENV_CHAOS_SEED, "")
    if not raw.strip():
        return default
    try:
        seed = int(raw)
    except ValueError:
        raise ValueError(
            f"{ENV_CHAOS_SEED} must be a base-10 integer seed, got "
            f"{raw!r} (unset it to use the default {default})")
    if seed < 0:
        raise ValueError(
            f"{ENV_CHAOS_SEED} must be >= 0, got {raw!r} (seeds are "
            f"printed by chaos runs as non-negative integers)")
    return seed


@dataclass
class ChaosConfig:
    seed: int = field(default_factory=chaos_seed)
    #: probability a job status write 409s (before committing)
    conflict_on_status_update: float = 0.0
    #: probability a create raises a transient 5xx/timeout
    error_on_create: float = 0.0
    #: probability a delete raises a transient 5xx/timeout
    error_on_delete: float = 0.0
    #: probability a watch event is silently dropped / delivered twice
    drop_watch_events: float = 0.0
    duplicate_watch_events: float = 0.0
    #: kinds watch chaos applies to (a real informer relists its primary
    #: kind; child-event loss is what the expectations machinery absorbs)
    watch_kinds: tuple = ("Pod", "Service")
    #: kinds exempt from CRUD faults (events are best-effort by design,
    #: and faulting them just tests the Recorder's log line)
    exempt_kinds: tuple = ("Event",)
    #: stop injecting probabilistic faults after this many, so soak tests
    #: provably terminate (scripted faults are not budgeted)
    max_faults: Optional[int] = None
    #: probabilistic latency injection: op -> (probability, seconds).
    #: The delay ADVANCES THE INJECTED CLOCK (never sleeps), so sim-time
    #: campaigns stay bit-for-bit reproducible; ops are the CRUD names
    #: plus "fsync" (the journal's group-commit path, docs/chaos.md).
    #: Latency injections are recorded in ``ChaosAPIServer.latencies``
    #: and do NOT consume the ``max_faults`` budget.
    op_latency: dict = field(default_factory=dict)


class ChaosAPIServer:
    """Fault-injecting proxy: drop-in for ``APIServer`` wherever the engine
    or manager expects one. Unlisted attributes delegate to ``inner``."""

    def __init__(self, inner: APIServer, config: Optional[ChaosConfig] = None,
                 clock=None):
        self.inner = inner
        self.config = config or ChaosConfig()
        self.rng = random.Random(self.config.seed)
        #: every injected fault: (op, kind, "ns/name", exc class name)
        self.faults: list[tuple] = []
        #: every injected latency: (op, kind, "ns/name", seconds) —
        #: separate from ``faults`` so delays never burn the max_faults
        #: budget (a slow write is not a failed write)
        self.latencies: list[tuple] = []
        #: every preemption this server executed (scripted or scheduled):
        #: ("ns/name", deleted) — the injector's own ledger, so benches
        #: can attribute restarts to chaos with zero bench-local counters
        self.preemptions: list[tuple] = []
        #: injectable sim clock latency advances ride (SimClock or any
        #: object with ``advance(dt)``); without one, latency injection
        #: is a loud no-op — this layer never sleeps
        self.clock = clock
        self._scripted: dict[str, list] = {}   # op -> [(exc, kind, after)]
        self._slow: dict[str, list] = {}       # op -> [(seconds, kind)]
        self._pod_creates = 0
        self._preempt_at: dict[int, bool] = {}  # nth pod create -> delete?
        log.info("chaos enabled: seed=%d (replay with %s=%d)",
                 self.config.seed, ENV_CHAOS_SEED, self.config.seed)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- scripted schedules ----------------------------------------------

    def fail_next(self, op: str, exc: type = ServerError, times: int = 1,
                  kind: Optional[str] = None, after: bool = False) -> None:
        """Queue ``times`` deterministic faults for ``op`` (``create`` /
        ``delete`` / ``update`` / ``update_status``), optionally only for
        objects of ``kind``. ``after=True`` commits the operation first and
        *then* raises (the timed-out-but-landed write every retry loop must
        tolerate)."""
        self._scripted.setdefault(op, []).extend((exc, kind, after)
                                                 for _ in range(times))

    def schedule_preemption(self, nth_pod_create: int,
                            delete: bool = False) -> None:
        """Preempt the N-th pod created through this server (1-based):
        DisruptionTarget condition + Failed(143), plus deletion when
        ``delete``."""
        self._preempt_at[nth_pod_create] = delete

    def slow_next(self, op: str, seconds: float, times: int = 1,
                  kind: Optional[str] = None) -> None:
        """Queue ``times`` deterministic latency injections for ``op``
        (the CRUD names, or ``"fsync"`` for the journal's group-commit
        path): the next matching operation advances the injected clock
        by ``seconds`` before committing. Needs a ``clock`` — this layer
        simulates a slow disk/apiserver, it never sleeps."""
        if seconds <= 0:
            raise ValueError(f"slow_next seconds must be > 0, "
                             f"got {seconds!r}")
        self._slow.setdefault(op, []).extend((float(seconds), kind)
                                             for _ in range(times))

    # -- fault engine -----------------------------------------------------

    def _fault(self, op: str, kind: str, target: str, prob: float,
               default_exc: type):
        """Return an exception to raise pre-commit, or ``(exc, True)``
        marker via scripted ``after`` faults handled by callers."""
        script = self._scripted.get(op)
        if script:
            for i, (exc, want_kind, after) in enumerate(script):
                if want_kind is None:
                    # a kind-unqualified fault must not be burned on a
                    # best-effort write (the Recorder swallows Event
                    # faults, neutering the scripted test); target an
                    # exempt kind explicitly via fail_next(kind=...)
                    if kind in self.config.exempt_kinds:
                        continue
                    script.pop(i)
                    return self._record(op, kind, target, exc), after
                if want_kind == kind:
                    script.pop(i)
                    return self._record(op, kind, target, exc), after
        if kind in self.config.exempt_kinds:
            return None, False
        budget = self.config.max_faults
        if budget is not None and len(self.faults) >= budget:
            return None, False
        if prob > 0 and self.rng.random() < prob:
            return self._record(op, kind, target, default_exc), False
        return None, False

    def _record(self, op: str, kind: str, target: str, exc: type):
        self.faults.append((op, kind, target, exc.__name__))
        err = exc(f"chaos[{op} {kind} {target}]: injected {exc.__name__} "
                  f"#{len(self.faults)} (seed={self.config.seed})")
        log.info("injecting %s", err)
        return err

    def _take_latency(self, op: str, kind: str, target: str) -> float:
        """Seconds of injected latency for this operation: a scripted
        ``slow_next`` match first, then the probabilistic
        ``ChaosConfig.op_latency`` rate. Draws the rng ONLY when a rate
        is configured for ``op`` — an unconfigured server's random
        stream is untouched (committed scorecards depend on this)."""
        total = 0.0
        script = self._slow.get(op)
        if script:
            for i, (seconds, want_kind) in enumerate(script):
                if want_kind is None or want_kind == kind:
                    script.pop(i)
                    total += seconds
                    break
        rate = self.config.op_latency.get(op)
        if rate:
            prob, seconds = rate
            if prob > 0 and self.rng.random() < prob:
                total += float(seconds)
        if total > 0:
            self.latencies.append((op, kind, target, total))
            log.info("chaos: injecting %gs latency on %s %s %s (seed=%d)",
                     total, op, kind, target, self.config.seed)
        return total

    def _advance(self, seconds: float) -> None:
        if seconds <= 0:
            return
        if self.clock is None:
            log.warning("chaos: latency injection configured but no "
                        "clock to advance; dropping the delay (this "
                        "layer never sleeps)")
            return
        self.clock.advance(seconds)

    def fsync_hook(self) -> None:
        """The journal's slow-disk seam (docs/chaos.md): installed as
        ``Journal(fsync_hook=...)``, called inside the group-commit
        fsync, advances the injected clock by any pending ``fsync``
        latency. With the journal's ``timer`` on the same clock, the
        delay lands inside ``kubedl_journal_fsync_seconds`` — exactly
        where a 1/100th-speed WAL disk would show up."""
        self._advance(self._take_latency("fsync", "Journal", "*"))

    def _run(self, op: str, obj_kind: str, target: str, prob: float,
             default_exc: type, call):
        self._advance(self._take_latency(op, obj_kind, target))
        err, after = self._fault(op, obj_kind, target, prob, default_exc)
        if err is not None and not after:
            raise err
        out = call()
        if err is not None:
            raise err
        return out

    # -- faulted CRUD -----------------------------------------------------

    def create(self, obj):
        kind = m.kind(obj)
        target = f"{m.namespace(obj)}/{m.name(obj)}"

        def call():
            out = self.inner.create(obj)
            # count inside the commit path so a committed-then-errored
            # create (after=True fault) still advances the preemption
            # schedule's nth-pod counter
            if kind == "Pod":
                self._pod_creates += 1
                delete = self._preempt_at.pop(self._pod_creates, None)
                if delete is not None:
                    log.info("chaos: preempting pod #%d %s (seed=%d)",
                             self._pod_creates, m.name(out), self.config.seed)
                    preempt_pod(self.inner, m.namespace(out), m.name(out),
                                delete=delete)
                    self.preemptions.append(
                        (f"{m.namespace(out)}/{m.name(out)}", delete))
            return out

        # transient creates alternate 5xx and timeout so both the clean
        # retry and the committed-then-timed-out (AlreadyExists echo) paths
        # get exercised
        exc = Timeout if self.rng.random() < 0.5 else ServerError
        return self._run("create", kind, target, self.config.error_on_create,
                         exc, call)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        exc = Timeout if self.rng.random() < 0.5 else ServerError
        return self._run("delete", kind, f"{namespace}/{name}",
                         self.config.error_on_delete, exc,
                         lambda: self.inner.delete(kind, namespace, name))

    def update(self, obj, subresource: Optional[str] = None):
        op = "update_status" if subresource == "status" else "update"
        prob = (self.config.conflict_on_status_update
                if subresource == "status" else 0.0)
        return self._run(op, m.kind(obj),
                         f"{m.namespace(obj)}/{m.name(obj)}", prob, Conflict,
                         lambda: self.inner.update(obj, subresource))

    def update_status(self, obj):
        return self.update(obj, subresource="status")

    def patch_merge(self, kind: str, namespace: str, name: str, patch):
        """Scripted-fault seam for annotation patches (op ``patch``):
        ``fail_next("patch", Conflict, ...)`` injects the 409 the
        elastic 2-phase protocol's ack writes must survive
        (docs/elastic.md). No probabilistic rate is configured for the
        op, so an unscripted server draws NOTHING from the rng here —
        committed scorecards are untouched by this override existing."""
        return self._run("patch", kind, f"{namespace}/{name}", 0.0,
                         Conflict,
                         lambda: self.inner.patch_merge(kind, namespace,
                                                        name, patch))

    # -- watch chaos ------------------------------------------------------

    def _watch_filter(self, fn, drop_ok):
        """The one seeded drop/duplicate filter both watch paths share
        (a divergence in fault recording or rng-draw order between them
        would silently fork the chaos stream). ``drop_ok()`` gates
        drops per event; duplication is always eligible."""
        def filtered(event_type, obj):
            if m.kind(obj) not in self.config.watch_kinds:
                fn(event_type, obj)
                return
            target = f"{m.namespace(obj)}/{m.name(obj)}"
            if drop_ok() and self.config.drop_watch_events > 0 \
                    and self.rng.random() < self.config.drop_watch_events:
                self.faults.append(("watch_drop", m.kind(obj), target,
                                    event_type))
                return
            fn(event_type, obj)
            if self.config.duplicate_watch_events > 0 \
                    and self.rng.random() < self.config.duplicate_watch_events:
                self.faults.append(("watch_dup", m.kind(obj), target,
                                    event_type))
                fn(event_type, copy.deepcopy(obj))
        return filtered

    def watch(self, fn):
        """Subscribe through a filter that may drop or duplicate child
        events per the seeded schedule — the lossy-informer simulation the
        expectations expiry path exists for."""
        return self.inner.watch(self._watch_filter(fn, lambda: True))

    def watch_from(self, fn, bookmark: int, kinds=None):
        """Bookmark-resumed watch (docs/durability.md) through the same
        seeded event chaos: replayed ring events may be DUPLICATED (the
        at-least-once delivery a level-based informer cache must absorb)
        but never dropped — the ring replay IS the recovery path, and a
        store that silently skips post-bookmark history has no resumable
        contract left to test. Live events past the catch-up point take
        both duplication and drops, exactly like :meth:`watch`."""
        live = [False]
        cancel, caught_up = self.inner.watch_from(
            self._watch_filter(fn, lambda: live[0]), bookmark,
            kinds=kinds)
        live[0] = True
        return cancel, caught_up

    # -- preemption -------------------------------------------------------

    def preempt(self, namespace: str, name: str, *, delete: bool = True,
                exit_code: int = 143) -> None:
        """Scripted node preemption of one pod, bypassing fault injection
        (the disruption is the chaos)."""
        preempt_pod(self.inner, namespace, name, delete=delete,
                    exit_code=exit_code)
        self.preemptions.append((f"{namespace}/{name}", delete))


def preempt_pod(api: APIServer, namespace: str, name: str, *,
                delete: bool = True, exit_code: int = 143) -> None:
    """Simulate kubelet's view of a node preemption: the pod gains a
    ``DisruptionTarget`` condition and fails with the SIGTERM exit code
    (143), then — like the real eviction flow — the object is deleted
    unless ``delete=False`` (GKE leaves the Failed pod visible for a
    while; both shapes must drive slice-atomic recovery)."""
    pod = api.get("Pod", namespace, name)
    containers = m.get_in(pod, "spec", "containers", default=[]) or []
    container = containers[0].get("name", "main") if containers else "main"
    status = pod.setdefault("status", {})
    status.setdefault("conditions", []).append({
        "type": DISRUPTION_TARGET, "status": "True",
        "reason": "PreemptionByScheduler",
        "message": "chaos: node preempted",
    })
    status["phase"] = "Failed"
    status["reason"] = "Preempted"
    status["containerStatuses"] = [{
        "name": container,
        "state": {"terminated": {"exitCode": exit_code, "signal": 15}},
    }]
    api.update_status(pod)
    if delete:
        api.delete("Pod", namespace, name)
