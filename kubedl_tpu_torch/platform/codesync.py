"""Code sync: git-sync init containers injected into every replica.

Behavioral analog of ``pkg/code_sync`` (reference ``sync_handler.go:34-75``,
``git_sync_handler.go:20-70``): a job annotated with
``kubedl.io/git-sync-config`` (a JSON blob) gets

* a ``git-sync-code`` init container that clones the repo once into a shared
  ``emptyDir`` volume, and
* a volume mount of the checked-out tree under each main container's
  ``workingDir/<dest>`` (subPath = dest), so training code lands next to the
  entrypoint.

The handler seam is kept (``CodeSyncHandler`` interface in the reference) so
other sources (GCS buckets on TPU VMs) plug in beside git.

Copied from ``kubedl_tpu/platform/codesync.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy
import json
import shlex
from typing import Optional

from ..api import common as c
from ..core import meta as m

DEFAULT_CODE_ROOT = "/code"
DEFAULT_GIT_SYNC_IMAGE = "kubedl/git-sync:v1"
DEFAULT_MAX_FAILURES = 3
DEFAULT_GCS_SYNC_IMAGE = "google/cloud-sdk:slim"


class CodeSyncError(ValueError):
    pass


def dest_from_source(source: str, fallback: str = "code") -> str:
    """Last path segment of a git/GCS/OSS source URL, ``.git`` stripped —
    the default checkout/sync directory name (shared with the dataset-cache
    warm-up, which syncs with the same one-shot rsync contract)."""
    cleaned = source.split("://", 1)[-1]
    parts = [p for p in cleaned.strip("/").split("/") if p]
    dest = parts[-1] if parts else fallback
    return dest[:-4] if dest.endswith(".git") else dest


_dest_from_source = dest_from_source


def gcs_rsync_command(source: str, dest_dir: str) -> str:
    """The one-shot GCS sync shell line used by both code-sync init
    containers and dataset-cache warm-up pods. Source/dest come from
    user-controlled spec fields, so they are shell-quoted."""
    src, dst = shlex.quote(source), shlex.quote(dest_dir)
    return f"mkdir -p {dst} && gsutil -m rsync -r {src} {dst}"


def _git_init_container(opts: dict, volume_name: str) -> tuple[dict, str]:
    """Returns (init container, dest path). Env contract is the upstream
    kubernetes/git-sync one (git_sync_handler.go:85-140)."""
    source = opts.get("source") or ""
    if not source:
        raise CodeSyncError("git-sync-config requires 'source'")
    root = opts.get("rootPath") or DEFAULT_CODE_ROOT
    dest = opts.get("destPath") or _dest_from_source(source)
    envs = list(opts.get("envs") or [])
    envs += [
        {"name": "GIT_SYNC_REPO", "value": source},
        # one-shot clone: without this the init container never exits
        {"name": "GIT_SYNC_ONE_TIME", "value": "true"},
        {"name": "GIT_SYNC_ROOT", "value": root},
        {"name": "GIT_SYNC_DEST", "value": dest},
        {"name": "GIT_SYNC_MAX_SYNC_FAILURES",
         "value": str(opts.get("maxFailures") or DEFAULT_MAX_FAILURES)},
    ]
    if opts.get("branch"):
        envs.append({"name": "GIT_SYNC_BRANCH", "value": opts["branch"]})
    if opts.get("revision"):
        envs.append({"name": "GIT_SYNC_REV", "value": opts["revision"]})
    if opts.get("depth"):
        envs.append({"name": "GIT_SYNC_DEPTH", "value": str(opts["depth"])})
    if opts.get("ssh"):
        envs.append({"name": "GIT_SYNC_SSH", "value": "true"})
        if opts.get("sshFile"):
            envs.append({"name": "GIT_SSH_KEY_FILE", "value": opts["sshFile"]})
    if opts.get("user"):
        envs.append({"name": "GIT_SYNC_USERNAME", "value": opts["user"]})
    if opts.get("password"):
        envs.append({"name": "GIT_SYNC_PASSWORD", "value": opts["password"]})
    ctr = {
        "name": "git-sync-code",
        "image": opts.get("image") or DEFAULT_GIT_SYNC_IMAGE,
        "imagePullPolicy": "IfNotPresent",
        "env": envs,
        "volumeMounts": [{"name": volume_name, "mountPath": root}],
    }
    return ctr, dest


def _gcs_init_container(opts: dict, volume_name: str) -> tuple[dict, str]:
    """TPU-native source: one-shot ``gsutil rsync`` of a GCS prefix — the
    natural code/data channel on Cloud TPU VMs (no git credentials needed
    when the node SA has storage.objectViewer)."""
    source = opts.get("source") or ""
    if not source.startswith("gs://"):
        raise CodeSyncError("gcs-sync-config requires a gs:// 'source'")
    root = opts.get("rootPath") or DEFAULT_CODE_ROOT
    dest = opts.get("destPath") or _dest_from_source(source)
    ctr = {
        "name": "gcs-sync-code",
        "image": opts.get("image") or DEFAULT_GCS_SYNC_IMAGE,
        "imagePullPolicy": "IfNotPresent",
        "command": ["/bin/sh", "-c", gcs_rsync_command(source, f"{root}/{dest}")],
        "env": list(opts.get("envs") or []),
        "volumeMounts": [{"name": volume_name, "mountPath": root}],
    }
    return ctr, dest


_HANDLERS = {
    c.ANNOTATION_GIT_SYNC_CONFIG: ("git-sync", _git_init_container),
    c.ANNOTATION_GCS_SYNC_CONFIG: ("gcs-sync", _gcs_init_container),
}


def inject_code_sync_init_containers(job: dict, replica_specs: dict) -> None:
    """Mutates every replica template in ``replica_specs`` (the raw spec
    dicts) in memory, once per reconcile (reference ``job.go:110``).
    Idempotent: skips replicas that already carry the init container."""
    ann = m.annotations(job)
    for annotation, (volume_name, handler) in _HANDLERS.items():
        cfg = ann.get(annotation)
        if not cfg:
            continue
        try:
            opts = json.loads(cfg)
        except json.JSONDecodeError as e:
            raise CodeSyncError(f"bad {annotation} annotation: {e}") from e
        init_ctr, dest = handler(opts, volume_name)
        volume = {"name": volume_name, "emptyDir": {}}
        for spec in replica_specs.values():
            pod_spec = m.get_in(spec, "template", "spec")
            if not pod_spec or not pod_spec.get("containers"):
                continue
            inits = pod_spec.setdefault("initContainers", [])
            if any(x.get("name") == init_ctr["name"] for x in inits):
                continue
            ctr = copy.deepcopy(init_ctr)
            # init container inherits the main container's resources so it
            # schedules onto the same node class (sync_handler.go:58)
            if pod_spec["containers"][0].get("resources"):
                ctr["resources"] = copy.deepcopy(
                    pod_spec["containers"][0]["resources"])
            inits.append(ctr)
            vols = pod_spec.setdefault("volumes", [])
            if not any(v.get("name") == volume_name for v in vols):
                vols.append(copy.deepcopy(volume))
            for main in pod_spec["containers"]:
                mounts = main.setdefault("volumeMounts", [])
                if any(x.get("name") == volume_name for x in mounts):
                    continue
                workdir = main.get("workingDir", "")
                mounts.append({
                    "name": volume_name,
                    "readOnly": False,
                    "mountPath": _join(workdir, dest),
                    "subPath": dest,
                })


def _join(workdir: str, dest: str) -> str:
    if not workdir:
        return "/" + dest
    return workdir.rstrip("/") + "/" + dest


def code_sync_enabled(job: dict) -> bool:
    ann = m.annotations(job)
    return any(k in ann for k in _HANDLERS)
