"""Slice-preserving elastic scaling, shared across workload kinds.

The reference implements elastic scaling only for PyTorchJob
(``controllers/pytorch/elastic_scale.go``); here the whole machinery —
downward-API world-size plumbing, the 2-phase checkpoint protocol, and
the in-place restart request/confirm dance — is a mixin any workload
controller can adopt. PyTorchJob uses it for reference parity; JAXJob
uses it because elastic world-resize is first-class for the TPU-native
kind (SURVEY §5 "failure detection / elastic recovery").

Per-kind knobs: ``elastic_world_size_env`` names the env var the
trainer reads for its world size (``WORLD_SIZE`` for torch,
``KUBEDL_NUM_PROCESSES`` for JAX) — rendered as a downward-API fieldRef
to the pod's ``world-size`` annotation so an in-place container restart
re-resolves the new world without the pod ever being deleted.

Copied from ``kubedl_tpu/controllers/elastic.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ..api import common as c
from ..core import meta as m
from ..tpu import placement as pl

ANNOTATION_WORLD_SIZE = "world-size"
PODINFO_VOLUME = "kubedl-podinfo"
PODINFO_MOUNT_PATH = "/etc/kubedl-podinfo"


def restart_count(pod) -> int:
    """Max container restartCount — the signal kubelet bumps on an
    in-place container restart (the CRR completion analog)."""
    statuses = m.get_in(pod, "status", "containerStatuses", default=[]) or []
    return max((int(s.get("restartCount", 0) or 0) for s in statuses),
               default=0)


class ElasticInPlaceMixin:
    """Elastic scaling hooks for :class:`WorkloadController` subclasses.

    The adopting controller calls :meth:`render_elastic_world` from its
    ``set_cluster_spec`` for each container; the engine's scale hooks
    (``scale_out``/``scale_in``/``checkpoint_if_necessary``) come for
    free. See the module docstring for the protocol."""

    #: env var the trainer reads for its world size (per-kind override)
    elastic_world_size_env = "WORLD_SIZE"

    #: seconds to wait for an in-place restart to be confirmed before
    #: falling back to delete+recreate (trainers not wrapped in the
    #: restart agent never restart in place)
    restart_fallback_seconds = 120.0

    def elastic_world(self, replicas) -> int:
        """Total trainer process count (AIMaster excluded)."""
        return sum(int(rs.replicas or 1) for rt_, rs in replicas.items()
                   if rt_ != c.REPLICA_AIMASTER)

    def render_elastic_world(self, pod, ct, world: int) -> None:
        """Wire one container for in-place elastic restarts: world size
        via downward-API annotation (re-resolves on container restart,
        reference elastic_scale.go:274-295), the annotations file the
        restart agent tails (updates live on pod patch), and an
        OnFailure restart policy so the agent's exit recreates the
        container inside the SAME pod."""
        m.set_in(pod, "metadata", "annotations",
                 {**(m.get_in(pod, "metadata", "annotations") or {}),
                  ANNOTATION_WORLD_SIZE: str(world)})
        pl.upsert_env(ct, self.elastic_world_size_env, value_from={
            "fieldRef": {"fieldPath":
                         f"metadata.annotations['{ANNOTATION_WORLD_SIZE}']"}})
        pl.upsert_env(ct, "KUBEDL_PODINFO_ANNOTATIONS",
                      PODINFO_MOUNT_PATH + "/annotations")
        mounts = ct.setdefault("volumeMounts", [])
        if not any(v.get("name") == PODINFO_VOLUME for v in mounts):
            mounts.append({"name": PODINFO_VOLUME,
                           "mountPath": PODINFO_MOUNT_PATH,
                           "readOnly": True})
        pod["spec"]["restartPolicy"] = c.RESTART_ON_FAILURE
        vols = pod["spec"].setdefault("volumes", [])
        if not any(v.get("name") == PODINFO_VOLUME for v in vols):
            vols.append({"name": PODINFO_VOLUME, "downwardAPI": {
                "items": [{"path": "annotations", "fieldRef": {
                    "fieldPath": "metadata.annotations"}}]}})

    # -- elastic checkpoint protocol (reference elastic_scale.go) ---------

    def checkpoint_if_necessary(self, job, pods) -> bool:
        """2-phase generation-versioned protocol (reference
        elastic_scale.go:118-182): victims (deleting pods still held by the
        preempt-protector finalizer) trigger a checkpoint *request* at the
        job's current generation; the AIMaster acks by writing the matching
        *completed* version; only then are victims released. Returns True
        when no checkpoint is in flight (scaling may proceed)."""
        if self.api is None:
            return True
        ann = m.annotations(job)
        gen = m.generation(job)
        victims = [p for p in pods if m.is_deleting(p)
                   and c.FINALIZER_PREEMPT_PROTECTOR in m.finalizers(p)]
        requested = int(ann.get(c.ANNOTATION_CKPT_REQUESTED_VERSION, 0) or 0)
        completed = int(ann.get(c.ANNOTATION_CKPT_COMPLETED_VERSION, 0) or 0)
        if not victims:
            return completed >= requested
        if requested < gen:
            # phase 1: controller requests a checkpoint at this generation
            self.api.patch_merge(self.kind, m.namespace(job), m.name(job), {
                "metadata": {"annotations": {
                    c.ANNOTATION_CKPT_REQUESTED_VERSION: str(gen)}}})
            return False
        if completed < requested:
            return False  # phase 2 pending: AIMaster hasn't acked
        # checkpoint done for this generation: release victims
        for p in victims:
            fresh = self.api.try_get("Pod", m.namespace(p), m.name(p))
            if fresh is None:
                continue
            m.meta(fresh)["finalizers"] = [
                f for f in m.finalizers(fresh)
                if f != c.FINALIZER_PREEMPT_PROTECTOR]
            self.api.update(fresh)
        return True

    def scale_out(self, job, replicas, pods, services):
        return self._scale(job, replicas, pods)

    def scale_in(self, job, replicas, pods, services):
        return self._scale(job, replicas, pods)

    def _scale(self, job, replicas, pods):
        """Slice-preserving in-place restart (reference
        ``elastic_scale.go:196-400``).

        The reference restarts stale-generation containers through
        OpenKruise ContainerRecreateRequests so each pod keeps its node —
        and on GKE TPU, its slice — across a resize. The portable analog
        is a 2-phase protocol per surviving stale pod:

        1. *Request*: patch the pod in place — fresh ``world-size``
           annotation, restart-request annotation at the job's generation,
           plus the pod's current restartCount as the confirmation basis.
           The in-container agent (``runtime.restart_agent``) sees the
           annotation move through the downward-API file, exits the
           trainer, and kubelet restarts the container inside the SAME
           pod; the downward-API world-size env re-resolves on restart.
           Pod UID, node binding, and the slice's PodGroup all survive.
        2. *Confirm*: when the pod's restartCount moves past the recorded
           basis (the CRR-status analog), stamp the generation label so
           the pod counts as current. If it never moves within
           ``restart_fallback_seconds`` — the trainer isn't wrapped in
           the agent, or the agent died — fall back to delete+recreate,
           which is always correct but surrenders the slice.

        Master is refreshed before workers (``elastic_scale.go:224-240``);
        the master's name — hence its headless-service DNS — is stable, so
        no service refresh is needed (the reference relabels its master
        svc per generation because it re-creates the master pod). Pods
        beyond the new replica count are deleted by the engine diff loop;
        missing indexes are created at the new generation.

        Returns a requeue delay while confirmations are pending.
        """
        if self.api is None:
            return None
        gen = m.generation(job)
        ann = m.annotations(job)
        if ann.get(c.ANNOTATION_READY_TO_START_WORKER, "true") == "false" and \
                ann.get(c.ANNOTATION_IMMEDIATELY_START_WORKER) != "true":
            return None
        world = self.elastic_world(replicas)
        counts = {rt_.lower(): int(rs.replicas or 1)
                  for rt_, rs in replicas.items()}
        stale = [p for p in pods
                 if m.labels(p).get(c.LABEL_GENERATION, str(gen)) != str(gen)
                 and not m.is_deleting(p)]
        stale.sort(key=lambda p: (
            0 if m.labels(p).get(c.LABEL_JOB_ROLE) == "master" else 1,
            m.labels(p).get(c.LABEL_REPLICA_INDEX, "0")))
        pending = False
        for p in stale:
            rt = m.labels(p).get(c.LABEL_REPLICA_TYPE, "")
            try:
                index = int(m.labels(p).get(c.LABEL_REPLICA_INDEX, "0"))
            except ValueError:
                index = 0
            if index >= counts.get(rt, 0):
                continue  # excess replica: engine diff loop deletes it
            # p is a shared list() snapshot: read annotations without the
            # setdefault mutation (docs/control-plane-perf.md ownership)
            pod_ann = m.get_annotations(p)
            if pod_ann.get(c.ANNOTATION_RESTART_REQUESTED_GENERATION) \
                    != str(gen):
                # phase 1: request the in-place restart
                self.api.patch_merge("Pod", m.namespace(p), m.name(p), {
                    "metadata": {"annotations": {
                        ANNOTATION_WORLD_SIZE: str(world),
                        c.ANNOTATION_RESTART_REQUESTED_GENERATION: str(gen),
                        c.ANNOTATION_RESTART_BASIS_RESTARTS:
                            str(restart_count(p)),
                        c.ANNOTATION_RESTART_REQUESTED_AT:
                            m.rfc3339(self.api.now()),
                    }}})
                pending = True
                continue
            # phase 2: confirm or fall back
            basis = int(pod_ann.get(c.ANNOTATION_RESTART_BASIS_RESTARTS, 0)
                        or 0)
            if restart_count(p) > basis:
                self.api.patch_merge("Pod", m.namespace(p), m.name(p), {
                    "metadata": {"labels": {c.LABEL_GENERATION: str(gen)}}})
                continue
            requested_at = m.parse_rfc3339(
                pod_ann.get(c.ANNOTATION_RESTART_REQUESTED_AT, ""))
            if requested_at is not None and \
                    self.api.now() - requested_at > self.restart_fallback_seconds:
                try:
                    self.api.delete("Pod", m.namespace(p), m.name(p))
                except Exception:
                    pass
            else:
                pending = True
        return min(self.restart_fallback_seconds / 4, 30.0) if pending else None
