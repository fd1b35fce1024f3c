"""Controller-manager binary: ``python -m kubedl_tpu_torch``.

The ``main.go`` analog (reference ``main.go:56-129`` + flag surface
``cmd/options/options.go`` / ``docs/startup_flags.md``): parse flags, build
the operator over the standalone control plane, optionally start the
console, then run reconcile workers until signalled.

Copied from ``kubedl_tpu/__main__.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from .controllers.registry import OperatorConfig, build_operator
from .core import features as ft
from .controllers import hostnetwork as hn


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="kubedl-tpu",
        description="TPU-native deep-learning operator")
    p.add_argument("--workloads", default="*",
                   help='enabled kinds: "*", "auto", or comma list; '
                        'prefix "-" disables a kind')
    p.add_argument("--gang-scheduler-name", default="coscheduler",
                   help='gang plugin: coscheduler|volcano|kube-batch|"" (off)')
    p.add_argument("--enable-slice-scheduler", action="store_true",
                   help="multi-tenant slice scheduler: queues, elastic "
                        "quota, priority preemption, backfill "
                        "(docs/scheduling.md; also TPUSliceScheduler gate)")
    p.add_argument("--enable-tracing", action="store_true",
                   help="end-to-end tracing: job-lifecycle spans, "
                        "scheduler/serving traces, console "
                        "/api/v1/trace endpoints (docs/tracing.md; "
                        "also Tracing gate)")
    p.add_argument("--trace-buffer", type=int, default=8192,
                   help="span ring-buffer capacity when tracing is on")
    p.add_argument("--enable-telemetry", action="store_true",
                   help="fleet goodput & straggler telemetry: goodput "
                        "accounting, throughput profiles, SlowSlice "
                        "detection, /api/v1/explain endpoint "
                        "(docs/telemetry.md; also FleetTelemetry gate; "
                        "implies tracing)")
    p.add_argument("--enable-slo", action="store_true",
                   help="SLO engine: objective CRD, error budgets, "
                        "multi-window burn-rate alerting, console "
                        "/api/v1/slo endpoints (docs/slo.md; also "
                        "SLOEngine gate; implies telemetry + tracing)")
    p.add_argument("--enable-elastic-slices", action="store_true",
                   help="concurrency-elastic training: gangs advertise "
                        "min..max slices, spot dryness shrinks jobs in "
                        "place instead of evicting whole gangs, "
                        "returning capacity regrows them, restart-free "
                        "trainer reconfiguration via the 2-phase "
                        "checkpoint protocol (docs/elastic.md; also "
                        "TPUElasticSlices gate; requires "
                        "--enable-slice-scheduler)")
    p.add_argument("--enable-serving-fleet", action="store_true",
                   help="SLO-driven serving fleet: replica autoscaling "
                        "on burn-rate verdicts + engine health, "
                        "prefix-cache-aware routing with per-tenant "
                        "fairness, disaggregated prefill/decode lanes "
                        "with block-table handoff, console "
                        "/api/v1/serving/fleet endpoint "
                        "(docs/serving_fleet.md; also ServingFleet "
                        "gate)")
    p.add_argument("--enable-rl-flywheel", action="store_true",
                   help="RL post-training flywheel: RLJob rollouts ride "
                        "the serving fleet as a low-priority tenant, the "
                        "GRPO learner trains on the sharded elastic "
                        "Trainer, weight publishes roll between drains, "
                        "console /api/v1/rl endpoints (docs/rl.md; also "
                        "RLFlywheel gate; requires "
                        "--enable-serving-fleet)")
    p.add_argument("--enable-multi-model", action="store_true",
                   help="multi-model serving: LoRA adapter multiplexing "
                        "on the paged fleet — adapter weight pages share "
                        "the refcounted KV pool, model-scoped prefix "
                        "caches, adapter-affine routing, per-model SLO "
                        "columns, console /api/v1/serving/models "
                        "endpoint (docs/multimodel.md; also "
                        "MultiModelServing gate; requires "
                        "--enable-serving-fleet)")
    p.add_argument("--enable-federation", action="store_true",
                   help="multi-region federation: global queue routing "
                        "over per-region placement scores, cross-region "
                        "serving catalog with geo-affinity, cross-region "
                        "WAL shipping to warm standbys, region-evacuation "
                        "survival, console /api/v1/federation endpoints "
                        "(docs/federation.md; also Federation gate; "
                        "requires --enable-durability)")
    p.add_argument("--region-topology", default="",
                   help='static region graph "r1,r2;r1~r2=LAT_MS/'
                        'EGRESS_PER_GB;..." (docs/federation.md '
                        '"Region topology grammar")')
    p.add_argument("--slice-capacity", default="",
                   help='static slice inventory "POOL=N,..." (e.g. '
                        '"tpu-v5p-slice/2x2x4=4") when the control plane '
                        "has no Node objects; default derives from Nodes")
    p.add_argument("--enable-placement-scoring", action="store_true",
                   help="throughput-, contention-, and cost-aware slice "
                        "placement: pool-eligibility sets, scored "
                        "admission, ICI-domain packing, spot pools "
                        "(docs/scheduling.md; also TPUPlacementScoring "
                        "gate; requires the slice scheduler)")
    p.add_argument("--pool-cost", default="",
                   help='static pool economics "POOL=COST[:spot],..." in '
                        "$/chip-hour for the placement score; default "
                        "derives from Node labels "
                        "(kubedl.io/cost-per-chip-hour, "
                        "cloud.google.com/gke-spot)")
    p.add_argument("--enable-durability", action="store_true",
                   help="durable, sharded control plane: write-ahead "
                        "journal + snapshots, crash-recovery replay, "
                        "resumable watch bookmarks, sharded reconcile "
                        "ownership (docs/durability.md; also "
                        "DurableControlPlane gate)")
    p.add_argument("--journal-dir", default="",
                   help="directory for the write-ahead journal + "
                        "snapshots (standalone mode; requires "
                        "--enable-durability; empty = durability "
                        "without persistence)")
    p.add_argument("--snapshot-every", type=int, default=4096,
                   help="commits between store snapshots / WAL "
                        "rotations when the journal is on")
    p.add_argument("--replication-followers", type=int, default=0,
                   help="N warm follower stores fed by WAL shipping at "
                        "the group-commit fsync boundary, promotable on "
                        "leader loss (docs/replication.md; requires "
                        "--enable-durability and --journal-dir)")
    p.add_argument("--async-snapshots", action="store_true",
                   help="serialize store checkpoints on a background "
                        "worker so commits and WAL shipping never wait "
                        "on the O(world) dump (docs/replication.md)")
    p.add_argument("--reconcile-shards", type=int, default=1,
                   help="N-way sharded reconcile ownership: the "
                        "workqueue partitions by a consistent hash of "
                        "each request's namespace/name; pair with "
                        "--enable-leader-election for per-shard Leases "
                        "(requires --enable-durability)")
    p.add_argument("--max-reconciles", type=int, default=4)
    p.add_argument("--model-image-builder", default="",
                   help="builder image for ModelVersion image builds")
    p.add_argument("--feature-gates", default="",
                   help="comma list, e.g. GangScheduling=true,DAGScheduling=false")
    p.add_argument("--hostnetwork-port-range", default="",
                   help="BASE-END, default 20000-30000")
    p.add_argument("--kubectl-delivery-image", default="",
                   help="utility image that drops a kubectl binary into the "
                        "MPI launcher (reference mpijob_controller.go:52)")
    p.add_argument("--object-storage", default="",
                   help='persistence: memory | sqlite | sqlite://<path>')
    p.add_argument("--event-storage", default="")
    p.add_argument("--deploy-region", default="")
    p.add_argument("--dns-domain", default="")
    p.add_argument("--console-port", type=int, default=0,
                   help="serve the management console (0 = disabled)")
    p.add_argument("--console-host", default="0.0.0.0",
                   help="console bind address (default 0.0.0.0 so the "
                        "in-cluster Service reaches it; credentials come "
                        "from $KUBEDL_CONSOLE_USERS or the "
                        "kubedl-console-config ConfigMap, never hard-coded)")
    p.add_argument("--metrics-port", type=int, default=8080,
                   help="Prometheus /metrics (0 = disabled)")
    # real-cluster mode (reference main.go:81-126: the manager talks to an
    # actual kube-apiserver; without these flags kubedl-tpu runs its own
    # standalone in-memory control plane)
    p.add_argument("--kubeconfig", default="",
                   help="kubeconfig path: reconcile a real cluster")
    p.add_argument("--in-cluster", action="store_true",
                   help="use the pod service account (deployed in-cluster)")
    p.add_argument("--watch-namespace", default="",
                   help="restrict watches to one namespace (default: all)")
    p.add_argument("--webhook-port", type=int, default=0,
                   help="serve admission webhooks (real-cluster mode; "
                        "0 = disabled)")
    p.add_argument("--webhook-cert-dir", default="/tmp/k8s-webhook-server/serving-certs",
                   help="dir with tls.crt/tls.key (certmanager-mounted)")
    p.add_argument("--enable-leader-election", action="store_true",
                   help="HA: only the Lease holder reconciles")
    p.add_argument("--leader-election-namespace", default="kubedl-system")
    p.add_argument("--leader-election-id", default="kubedl-election")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    # fail fast on flag combinations that would silently degrade:
    # build_operator only shards the manager when durability is on, so
    # shard leases over an unsharded queue would drain nothing
    if args.reconcile_shards > 1 and not args.enable_durability:
        p.error("--reconcile-shards > 1 requires --enable-durability")
    if args.journal_dir and not args.enable_durability:
        p.error("--journal-dir requires --enable-durability")
    # same pattern as --reconcile-shards: replication without the gate
    # (or without a WAL to ship) would silently run a follower-less
    # leader — fail at the parser instead
    if args.replication_followers > 0 and not args.enable_durability:
        p.error("--replication-followers requires --enable-durability")
    if args.replication_followers > 0 and not args.journal_dir:
        p.error("--replication-followers requires --journal-dir (the "
                "group-commit fsync batch is the shipping unit)")
    if args.async_snapshots and not args.enable_durability:
        p.error("--async-snapshots requires --enable-durability")
    # the shrink/regrow authority is a scheduling pass: elastic slices
    # without the slice scheduler would silently never shrink or regrow
    # anything — fail at the parser instead (docs/elastic.md)
    if args.enable_elastic_slices and not args.enable_slice_scheduler:
        p.error("--enable-elastic-slices requires "
                "--enable-slice-scheduler (min..max gang admission and "
                "shrink-in-place are scheduling-pass decisions)")
    # the federation's zero-loss evacuation contract IS the journal +
    # cross-region standby — federation without durability would
    # silently lose every acknowledged write a dead region held, so
    # fail at the parser (build_operator re-checks for library callers)
    if args.enable_federation and not args.enable_durability:
        p.error("--enable-federation requires --enable-durability (the "
                "region-evacuation zero-loss contract rests on each "
                "region's WAL journal and its cross-region standby)")
    if args.region_topology and not args.enable_federation:
        p.error("--region-topology requires --enable-federation")
    # rollouts ARE fleet traffic: the flywheel without the serving fleet
    # would have no tenant queue, no router, no replicas to publish onto
    # — fail at the parser (build_operator re-checks for library callers)
    if args.enable_rl_flywheel and not args.enable_serving_fleet:
        p.error("--enable-rl-flywheel requires --enable-serving-fleet "
                "(rollout generation rides the fleet's router as a "
                "low-priority tenant; there is no rollout substrate "
                "without it)")
    # adapters are replica residency: multi-model without the serving
    # fleet would have no replica pools to page adapter weights through
    # — fail at the parser (build_operator re-checks for library callers)
    if args.enable_multi_model and not args.enable_serving_fleet:
        p.error("--enable-multi-model requires --enable-serving-fleet "
                "(adapter weight pages live in the replicas' paged KV "
                "pools; there is no residency substrate without them)")
    return args


def config_from_args(args: argparse.Namespace) -> OperatorConfig:
    gates = None
    if args.feature_gates:
        gates = ft.FeatureGates()
        gates.parse(args.feature_gates)
    port_range = hn.DEFAULT_PORT_RANGE
    if args.hostnetwork_port_range:
        base, _, end = args.hostnetwork_port_range.partition("-")
        port_range = (int(base), int(end) - int(base))
    return OperatorConfig(
        workloads_spec=args.workloads,
        gang_scheduler_name=args.gang_scheduler_name,
        max_reconciles=args.max_reconciles,
        model_image_builder=args.model_image_builder,
        feature_gates=gates,
        hostnetwork_port_range=port_range,
        object_storage=args.object_storage,
        event_storage=args.event_storage,
        deploy_region=args.deploy_region,
        dns_domain=args.dns_domain,
        kubectl_delivery_image=args.kubectl_delivery_image,
        enable_slice_scheduler=args.enable_slice_scheduler,
        slice_capacity=args.slice_capacity,
        enable_tracing=args.enable_tracing,
        trace_buffer=args.trace_buffer,
        enable_telemetry=args.enable_telemetry,
        enable_slo=args.enable_slo,
        enable_placement_scoring=args.enable_placement_scoring,
        pool_cost=args.pool_cost,
        enable_durability=args.enable_durability,
        journal_dir=args.journal_dir,
        snapshot_every=args.snapshot_every,
        reconcile_shards=args.reconcile_shards,
        replication_followers=args.replication_followers,
        async_snapshots=args.async_snapshots,
        enable_elastic_slices=args.enable_elastic_slices,
        enable_serving_fleet=args.enable_serving_fleet,
        enable_rl_flywheel=args.enable_rl_flywheel,
        enable_multi_model=args.enable_multi_model,
        enable_federation=args.enable_federation,
        region_topology=args.region_topology,
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("kubedl_tpu_torch")

    real_cluster = bool(args.kubeconfig or args.in_cluster)
    api = None
    if real_cluster:
        from .core.kubeclient import ClusterConfig, KubeAPIServer
        cluster = (ClusterConfig.in_cluster() if args.in_cluster
                   else ClusterConfig.from_kubeconfig(args.kubeconfig))
        api = KubeAPIServer(cluster)
        log.info("real-cluster mode: %s", cluster.server)
    operator = build_operator(api=api, config=config_from_args(args))
    log.info("workloads enabled: %s", ", ".join(operator.engines) or "none")

    if args.metrics_port:
        from .metrics.http import serve_metrics
        serve_metrics(operator.metrics_registry, port=args.metrics_port)
        log.info("metrics on :%d/metrics", args.metrics_port)

    stop = threading.Event()
    lost_leadership = threading.Event()

    webhook_holder = {}
    if args.webhook_port:
        import os
        from .core.admission import WebhookServer
        cert = os.path.join(args.webhook_cert_dir, "tls.crt")
        key = os.path.join(args.webhook_cert_dir, "tls.key")

        def start_webhook_when_certs_ready():
            # the cert secret is mounted `optional: true`, so the pod can
            # start before cert-manager issues it. The kube-apiserver only
            # speaks HTTPS to webhooks; serving plaintext "for now" would
            # fail every TLS handshake forever and (failurePolicy: Fail)
            # block all job creates cluster-wide. Wait for the kubelet to
            # project the issued cert, then serve TLS.
            while not (os.path.exists(cert) and os.path.exists(key)):
                if not real_cluster:
                    # dev/standalone: no certmanager coming; serve plaintext
                    srv = WebhookServer(operator.admission,
                                        port=args.webhook_port)
                    srv.start()
                    webhook_holder["server"] = srv
                    log.warning("admission webhooks on :%d PLAINTEXT "
                                "(standalone dev mode)", srv.port)
                    return
                log.info("waiting for webhook serving certs in %s",
                         args.webhook_cert_dir)
                if stop.wait(2.0):
                    return
            srv = WebhookServer(operator.admission, port=args.webhook_port,
                                cert_file=cert, key_file=key)
            srv.start()
            webhook_holder["server"] = srv
            log.info("admission webhooks on :%d (tls)", srv.port)

        threading.Thread(target=start_webhook_when_certs_ready,
                         name="webhook-startup", daemon=True).start()

    console = None
    if args.console_port:
        from .console import ConsoleConfig, ConsoleServer, DataProxy
        proxy = DataProxy(operator.api, operator.object_backend,
                          operator.event_backend,
                          job_kinds=tuple(operator.engines),
                          tracer=operator.tracer,
                          scheduler=operator.scheduler,
                          telemetry=operator.telemetry,
                          journal=operator.journal,
                          replication=operator.replication,
                          elastic=operator.elastic_enabled,
                          serving_fleet=operator.serving_fleet)
        console = ConsoleServer(
            proxy, ConsoleConfig(host=args.console_host,
                                 port=args.console_port))
        console.start()
        log.info("console on %s", console.url)

    def on_signal(signum, frame):
        log.info("signal %d: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)

    def start_operator():
        if real_cluster:
            operator.api.start(sorted(operator.manager.watched_kinds()),
                               namespace=args.watch_namespace or None)
        operator.run()
        log.info("operator running (%d reconcile workers)",
                 max(1, operator.config.max_reconciles))

    if operator.replication is not None:
        # drive the replication group's election protocol on the retry
        # cadence (docs/replication.md): the leader renews its
        # replicated Lease and every standby refreshes its expiry
        # observation — the watching that lets a promotion establish
        # expiry within one lease term. Without this thread the Lease
        # would never be created or renewed and the shipped followers
        # would be read replicas with no live failover protocol.
        import time as _time
        rcp = operator.replication
        rcp_now = getattr(operator.api, "now", None) or _time.time

        def step_replication_election():
            while not stop.is_set():
                try:
                    rcp.maybe_step_election(rcp_now())
                except Exception as e:  # noqa: BLE001 — the election
                    # loop must survive transient api errors; a dead
                    # thread would silently freeze the group's protocol
                    log.warning("replication election step failed: %s", e)
                stop.wait(rcp.retry_period)

        threading.Thread(target=step_replication_election,
                         name="replication-election", daemon=True).start()

    if args.enable_leader_election and args.reconcile_shards > 1:
        # sharded ownership (docs/durability.md): every replica runs and
        # drains exactly the shards whose Leases it holds; a lost lease
        # hands that shard to whichever replica acquires it next — no
        # whole-operator demotion, no restart
        from .core.leaderelection import ShardLeaseSet
        # clock= is the store's clock (docs/replication.md): wall time
        # in production, a SimClock under the replay/bench drivers —
        # which is what makes lease expiry and promotion latency
        # measurable in sim time, deterministic per seed
        leases = ShardLeaseSet(
            operator.api, args.reconcile_shards,
            namespace=args.leader_election_namespace,
            prefix=args.leader_election_id + "-shard",
            clock=getattr(operator.api, "now", None))
        operator.manager.shard_owner = leases.owns
        log.info("per-shard leases enabled (%d shards, identity %s)",
                 args.reconcile_shards, leases.identity)
        elector_thread = threading.Thread(
            target=leases.run, args=(stop,), name="shard-leases",
            daemon=True)
        elector_thread.start()
        start_operator()
    elif args.enable_leader_election:
        from .core.leaderelection import (LeaderElectionConfig,
                                          LeaderElector)
        elector = LeaderElector(operator.api, LeaderElectionConfig(
            namespace=args.leader_election_namespace,
            name=args.leader_election_id),
            clock=getattr(operator.api, "now", None))
        log.info("leader election enabled (%s/%s as %s)",
                 args.leader_election_namespace, args.leader_election_id,
                 elector.config.identity)

        def on_lost():
            # a demoted replica must not keep reconciling: exit non-zero
            # so the pod restarts into a fresh candidate
            lost_leadership.set()
            stop.set()

        elector_thread = threading.Thread(
            target=elector.run, args=(stop,),
            kwargs={"on_started_leading": start_operator,
                    "on_stopped_leading": on_lost},
            name="leader-elector", daemon=True)
        elector_thread.start()
    else:
        elector_thread = None
        start_operator()
    stop.wait()

    if elector_thread is not None:
        # wait for the graceful lease release (elector.run's final step) —
        # exiting first would kill it mid-flight and force the successor
        # to wait out the full lease duration on every rolling restart
        elector_thread.join(timeout=5.0)
    operator.manager.stop()
    if real_cluster:
        operator.api.stop()
    if console is not None:
        console.stop()
    if webhook_holder.get("server") is not None:
        webhook_holder["server"].stop()
    return 1 if lost_leadership.is_set() else 0


if __name__ == "__main__":
    sys.exit(main())
