"""RLJob: the RL post-training flywheel workload kind (docs/rl.md).

No reference analog (the reference operator has no RL stack) — the
TPU-native kind for GRPO-style post-training where rollout generation
rides the serving fleet as a low-priority tenant and learning runs the
sharded elastic-width trainer. One Learner replica type (pod 0 drives
the flywheel loop: harvest → GRPO step → publish); rollouts are NOT
pods of this job — they are requests on the serving fleet, arbitrated
by the router's tenant fairness, which is the whole point.

``spec.flywheel`` carries the loop's contract and lands in the learner
container's env (the in-container flywheel reads it the same way the
trainer reads its rendezvous env):

* ``rolloutTenant`` — the tenant name rollout submissions carry
  (defaults to the job name; maps to a Queue via ``QueueSpec.tenants``);
* ``rolloutFloorTokensPerSecond`` — the declared throughput floor
  under which a window counts a violation;
* ``publishEvery`` — rollout batches consumed between weight publishes.

Elastic width (minSlices..maxSlices) rides the EXISTING machinery
untouched: ``runPolicy.schedulingPolicy.minSlices`` +
``tpuPolicy.numSlices``, rendered onto the PodGroup by the elastic
mixin like any training kind.

Copied from ``kubedl_tpu/controllers/workloads/rljob.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from ...api import common as c
from ...core import meta as m
from ...tpu import placement as pl
from ..elastic import ElasticInPlaceMixin
from ..interface import WorkloadController

#: the learner container's flywheel contract (docs/rl.md)
ENV_RL_ROLLOUT_TENANT = "KUBEDL_RL_ROLLOUT_TENANT"
ENV_RL_ROLLOUT_FLOOR = "KUBEDL_RL_ROLLOUT_FLOOR_TOKENS_PER_S"
ENV_RL_PUBLISH_EVERY = "KUBEDL_RL_PUBLISH_EVERY"


class RLJobController(ElasticInPlaceMixin, WorkloadController):
    kind = "RLJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "learner"
    default_port_name = "rljob-port"
    default_port = pl.DEFAULT_COORDINATOR_PORT
    replica_specs_field_name = "rlReplicaSpecs"

    #: the learner's world is its process count, exactly the JAXJob
    #: contract: the elastic fieldRef re-resolves it on in-place restart
    elastic_world_size_env = pl.ENV_NUM_PROCESSES

    def get_reconcile_orders(self):
        return [c.REPLICA_AIMASTER, "Learner"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() == "learner" and index == 0

    def is_tpu_replica(self, rtype):
        return rtype.lower() == "learner"

    @staticmethod
    def flywheel_spec(job) -> dict:
        """``spec.flywheel`` with its defaults applied (the one place
        the defaults live; the console and tests read through here)."""
        fw = m.get_in(job, "spec", "flywheel", default=None) or {}
        return {
            "rolloutTenant": fw.get("rolloutTenant") or m.name(job),
            "rolloutFloorTokensPerSecond": float(
                fw.get("rolloutFloorTokensPerSecond", 0.0)),
            "publishEvery": int(fw.get("publishEvery", 2)),
        }

    def set_cluster_spec(self, job, pod, rtype, index):
        if rtype == c.REPLICA_AIMASTER:
            return
        replicas = self.get_replica_specs(job)
        world = self.elastic_world(replicas)
        elastic = self.enable_elastic_scaling(job, None)
        fw = self.flywheel_spec(job)
        for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
            pl.upsert_env(ct, "JAX_PLATFORMS", "tpu,cpu")
            pl.upsert_env(ct, "ENABLE_PJRT_COMPATIBILITY", "true")
            pl.upsert_env(ct, ENV_RL_ROLLOUT_TENANT,
                          fw["rolloutTenant"])
            pl.upsert_env(ct, ENV_RL_ROLLOUT_FLOOR,
                          fw["rolloutFloorTokensPerSecond"])
            pl.upsert_env(ct, ENV_RL_PUBLISH_EVERY, fw["publishEvery"])
            if not any(e.get("name") == pl.ENV_PROCESS_ID
                       for e in ct.get("env", [])):
                # off-TPU RLJob (no tpuPolicy: placement layer skipped):
                # render the full bootstrap contract, as JAXJob does
                pl.upsert_env(ct, pl.ENV_COORDINATOR_ADDRESS,
                              f"{m.name(job)}-learner-0:"
                              f"{self.default_port}")
                pl.upsert_env(ct, pl.ENV_PROCESS_ID, int(index))
                pl.upsert_env(ct, pl.ENV_NUM_PROCESSES, world)
            if elastic:
                self.render_elastic_world(pod, ct, world)
