"""MPIJob controller.

Parity with reference ``controllers/mpi``: Launcher/Worker topology, a
generated hostfile, ``OMPI_MCA_plm_rsh_agent``/``OMPI_MCA_orte_default_
hostfile`` env on the launcher (``mpi_config.go:49-124``,
``mpijob_controller.go:218-246,312-395``), no per-replica services
(``job.go:315-317`` skips MPI services — except TPU jobs, which need DNS).

TPU-native twist (SURVEY.md §2-P): workers are TPU slice hosts; the
launcher doubles as coordinator (process 0 lives on worker-0, the launcher
only orchestrates). The hostfile is delivered as a ConfigMap exactly like
the reference, listing worker DNS names with ``slots=<chips per host>``.

Copied from ``kubedl_tpu/controllers/workloads/mpi.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import logging

from ...api import common as c
from ...core import meta as m
from ...core.apiserver import AlreadyExists, ApiError
from ...tpu import placement as pl
from ..interface import TPUPolicy, WorkloadController

log = logging.getLogger("kubedl_tpu_torch.mpi")

#: reference mpi_config.go:34-41
KUBECTL_MOUNT_PATH = "/opt/kube"
KUBECTL_VOLUME = "mpi-kubectl-delivery"
CONFIG_VOLUME = "mpi-job-config"
CONFIG_MOUNT_PATH = "/etc/mpi"
DISTRIBUTIONS = ("OpenMPI", "IntelMPI", "MPICH")


class MPIJobController(WorkloadController):
    kind = "MPIJob"
    api_version = "training.kubedl.io/v1alpha1"
    default_container_name = "mpi"
    default_port_name = "mpijob-port"
    default_port = 9999
    replica_specs_field_name = "mpiReplicaSpecs"
    #: --kubectl-delivery-image analog (reference mpijob_controller.go:52):
    #: utility image whose entrypoint copies a kubectl binary into
    #: $TARGET_DIR, so the launcher image needs no kubectl of its own.
    #: Overridden per instance from OperatorConfig.kubectl_delivery_image.
    kubectl_delivery_image = "kubedl/kubectl-delivery:latest"

    def get_reconcile_orders(self):
        return [c.REPLICA_AIMASTER, "Worker", "Launcher"]

    def is_master_role(self, replicas, rtype, index):
        return rtype.lower() == "launcher"

    def is_tpu_replica(self, rtype):
        return rtype.lower() == "worker"

    def needs_service(self, rtype, job=None):
        # reference skips MPI services; TPU workers still need DNS
        return (rtype.lower() == "worker" and job is not None
                and TPUPolicy.from_job(job) is not None)

    def master_replica_types(self, replicas):
        return [rt for rt in replicas if rt.lower() == "launcher"]

    def contains_master_spec(self, replicas):
        return any(rt.lower() == "launcher" for rt in replicas)

    def set_cluster_spec(self, job, pod, rtype, index):
        rt = rtype.lower()
        replicas = self.get_replica_specs(job)
        workers = int((replicas.get("Worker") and replicas["Worker"].replicas) or 0)
        slots = self._slots_per_worker(job)
        dist = self._distribution(job)
        # bare pod names, not service FQDNs: the kubexec.sh rsh agent runs
        # `kubectl exec $1` which takes a pod name (reference mpi_config.go
        # builds `${job}-worker-${i}` for the same reason); the names still
        # resolve as DNS where per-replica headless services exist.
        # Hostfile dialect per distribution (mpi_config.go:88-98): Intel
        # MPI/MPICH use `host:slots`, Open MPI uses `host slots=N`.
        if dist in ("IntelMPI", "MPICH"):
            hostfile = "\n".join(
                f"{m.name(job)}-worker-{i}:{slots}" for i in range(workers))
        else:
            hostfile = "\n".join(
                f"{m.name(job)}-worker-{i} slots={slots}"
                for i in range(workers))
        if rt == "launcher":
            self._ensure_hostfile_configmap(job, hostfile)
            rbac_ok = self._ensure_launcher_rbac(job)
            spec = pod["spec"]
            vols = spec.setdefault("volumes", [])
            if not any(v.get("name") == CONFIG_VOLUME for v in vols):
                # kubexec.sh executable, hostfile read-only (reference
                # mpijob_controller.go:358-383 scriptsMode/hostfileMode)
                vols.append({"name": CONFIG_VOLUME, "configMap": {
                    "name": f"{m.name(job)}-config",
                    "items": [
                        {"key": "kubexec.sh", "path": "kubexec.sh",
                         "mode": 0o555},
                        {"key": "hostfile", "path": "hostfile",
                         "mode": 0o444},
                    ]}})
            if not any(v.get("name") == KUBECTL_VOLUME for v in vols):
                vols.append({"name": KUBECTL_VOLUME, "emptyDir": {}})
            # kubectl-delivery init container (mpijob_controller.go:312-352):
            # drops a kubectl binary into the shared volume so kubexec.sh
            # can exec into workers from any launcher image
            inits = spec.setdefault("initContainers", [])
            if not any(ic.get("name") == "kubectl-delivery" for ic in inits):
                inits.append({
                    "name": "kubectl-delivery",
                    "image": self.kubectl_delivery_image,
                    "imagePullPolicy": "IfNotPresent",
                    "env": [
                        {"name": "TARGET_DIR", "value": KUBECTL_MOUNT_PATH},
                        {"name": "NAMESPACE", "value": m.namespace(job)},
                    ],
                    "resources": {"requests": {"cpu": "100m",
                                               "memory": "64Mi"}},
                    "volumeMounts": [
                        {"name": KUBECTL_VOLUME,
                         "mountPath": KUBECTL_MOUNT_PATH},
                        {"name": CONFIG_VOLUME,
                         "mountPath": CONFIG_MOUNT_PATH},
                    ]})
            # per-job ServiceAccount so kubectl exec inside kubexec.sh is
            # actually authorized (no ambient cluster-admin assumption);
            # left unset if RBAC creation failed (cluster without the
            # pods/exec grants) so the pod falls back to the namespace SA
            if rbac_ok:
                spec.setdefault("serviceAccountName",
                                f"{m.name(job)}-launcher")
            for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
                mounts = ct.setdefault("volumeMounts", [])
                if not any(mt.get("name") == CONFIG_VOLUME for mt in mounts):
                    mounts.append({"name": CONFIG_VOLUME,
                                   "mountPath": CONFIG_MOUNT_PATH})
                if not any(mt.get("name") == KUBECTL_VOLUME for mt in mounts):
                    mounts.append({"name": KUBECTL_VOLUME,
                                   "mountPath": KUBECTL_MOUNT_PATH})
                # rsh-agent/hostfile env names differ per MPI framework
                # (mpijob_controller.go:392-404)
                rsh_env, hostfile_env = {
                    "IntelMPI": ("I_MPI_HYDRA_BOOTSTRAP_EXEC",
                                 "I_MPI_HYDRA_HOST_FILE"),
                    "MPICH": ("HYDRA_LAUNCHER_EXEC", "HYDRA_HOST_FILE"),
                }.get(dist, ("OMPI_MCA_plm_rsh_agent",
                             "OMPI_MCA_orte_default_hostfile"))
                pl.upsert_env(ct, hostfile_env,
                              f"{CONFIG_MOUNT_PATH}/hostfile")
                pl.upsert_env(ct, rsh_env, f"{CONFIG_MOUNT_PATH}/kubexec.sh")
                if dist == "OpenMPI":
                    pl.upsert_env(ct, "OMPI_MCA_orte_keep_fqdn_hostnames", "t")
                # convenience env, NOT an MPI input: keep it dialect-
                # independent (bare names) so consumers never parse the
                # hostfile syntax
                pl.upsert_env(ct, "KUBEDL_WORKER_HOSTS", ",".join(
                    f"{m.name(job)}-worker-{i}" for i in range(workers)))
        else:
            for ct in m.get_in(pod, "spec", "containers", default=[]) or []:
                pl.upsert_env(ct, "KUBEDL_MPI_ROLE", rt)

    def validate(self, job: dict) -> None:
        """Reject unknown mpiDistribution values at admission — silent
        OpenMPI coercion of a typo ('intelMPI') would surface as an
        inexplicable launcher hang."""
        for dist in (m.get_in(job, "spec", "mpiDistribution"),
                     m.get_in(job, "spec", "legacySpec", "legacyV1Alpha2",
                              "mpiDistribution")):
            if dist is not None and dist not in DISTRIBUTIONS:
                raise ValueError(
                    f"{m.name(job)}: mpiDistribution {dist!r} not in "
                    f"{sorted(DISTRIBUTIONS)}")

    def _distribution(self, job) -> str:
        """MPI framework flavor: ``spec.mpiDistribution`` (clean spelling)
        or the reference's legacy path
        ``spec.legacySpec.legacyV1Alpha2.mpiDistribution``
        (mpijob_controller.go:389-404). Default OpenMPI."""
        dist = m.get_in(job, "spec", "mpiDistribution") or m.get_in(
            job, "spec", "legacySpec", "legacyV1Alpha2", "mpiDistribution")
        return dist if dist in ("IntelMPI", "MPICH") else "OpenMPI"

    def _slots_per_worker(self, job) -> int:
        slots = m.get_in(job, "spec", "slotsPerWorker")
        if slots:
            return int(slots)
        policy = TPUPolicy.from_job(job)
        if policy is not None:
            return policy.resolve().chips_per_host
        return 1

    def _ensure_launcher_rbac(self, job) -> bool:
        """Per-job ServiceAccount + Role + RoleBinding granting exactly
        what kubexec.sh needs: get/list pods and create pods/exec in the
        job's namespace. Owner-referenced, so they GC with the job.

        Returns False (without raising) when the cluster refuses — e.g.
        the manager ClusterRole lacks the pods/exec grant RBAC escalation
        prevention requires — so launcher creation degrades to the
        namespace default ServiceAccount instead of wedging the job.
        ``config/rbac/role.yaml`` carries the needed grants."""
        if self.api is None:
            return False
        ns = m.namespace(job)
        name = f"{m.name(job)}-launcher"
        sa = m.new_obj("v1", "ServiceAccount", name, ns)
        role = m.new_obj("rbac.authorization.k8s.io/v1", "Role", name, ns)
        role["rules"] = [
            {"apiGroups": [""], "resources": ["pods"],
             "verbs": ["get", "list", "watch"]},
            {"apiGroups": [""], "resources": ["pods/exec"],
             "verbs": ["create"]},
        ]
        binding = m.new_obj("rbac.authorization.k8s.io/v1", "RoleBinding",
                            name, ns)
        binding["subjects"] = [{"kind": "ServiceAccount", "name": name,
                                "namespace": ns}]
        binding["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                              "kind": "Role", "name": name}
        for obj in (sa, role, binding):
            m.set_controller_ref(obj, job)
            if self.api.try_get(m.kind(obj), ns, name) is None:
                try:
                    self.api.create(obj)
                except AlreadyExists:
                    pass
                except ApiError as e:
                    log.warning(
                        "launcher RBAC for %s/%s degraded (%s %s): %s",
                        ns, m.name(job), m.kind(obj), name, e)
                    return False
        return True

    def _ensure_hostfile_configmap(self, job, hostfile: str) -> None:
        """ConfigMap with hostfile + kubexec.sh (reference
        mpi_config.go:49-124)."""
        if self.api is None:
            return
        name = f"{m.name(job)}-config"
        # spec.mainContainer targets the exec at a specific container of
        # multi-container workers (reference mpi_config.go:75-77)
        main = m.get_in(job, "spec", "mainContainer") or ""
        container_flag = f" --container {main}" if main else ""
        kubexec = ("#!/bin/sh\nset -x\nPOD_NAME=$1\nshift\n"
                   f'exec {KUBECTL_MOUNT_PATH}/kubectl exec ${{POD_NAME}}'
                   f'{container_flag} -- /bin/sh -c "$*"\n')
        cm = m.new_obj("v1", "ConfigMap", name, m.namespace(job))
        cm["data"] = {"hostfile": hostfile, "kubexec.sh": kubexec}
        m.set_controller_ref(cm, job)
        existing = self.api.try_get("ConfigMap", m.namespace(job), name)
        if existing is None:
            try:
                self.api.create(cm)
            except AlreadyExists:
                pass
        elif existing.get("data") != cm["data"]:
            # compare ALL data: kubexec.sh varies with mainContainer, the
            # hostfile with replicas/slots/dialect
            existing["data"] = cm["data"]
            self.api.update(existing)
