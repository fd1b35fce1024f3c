"""Checkpoint/resume and the training side of the elastic 2-phase
protocol: the counterpart of ``kubedl_tpu/train/checkpoint.py``.

* :class:`CheckpointManager` saves and restores the trainer's
  :class:`~kubedl_tpu_torch.train.trainer.TrainState` with
  ``torch.distributed.checkpoint``, where the JAX package uses Orbax.
  Under a process group a sharded state's ``DTensor`` leaves are written
  by the ranks that hold them, and a restore into a state placed on
  another mesh (another world size, or one process with no group)
  reads the chunks it needs: the resharding the JAX package gets from
  Orbax. Rank 0 alone touches the step directories (creates, commits,
  retires) and writes ``data.json``; barriers around each write keep
  every rank's view of the finished steps the same. The group's
  checkpoint traffic runs on a gloo group of its own, so a write on the
  background thread never interleaves with the step's collectives. The
  contract is the JAX one: the three call shapes of
  :meth:`~CheckpointManager.save`, the data cursor saved with the step,
  ``max_to_keep``, and a step directory ``<dir>/<step>`` that appears
  under its final name only when it is complete (it is
  written as ``<step>.partial`` and renamed), so
  :class:`CheckpointTiers`' readiness test and its ``.uploading`` ->
  rename contract hold unchanged. An asynchronous save copies the state
  to the host at the step boundary (the trainer updates its tensors in
  place) and writes on a background thread.
* :class:`CheckpointTiers` / :class:`TieredCheckpointManager`: the
  object-store tier (file operations only; a copy of the JAX module's).
* :class:`ElasticCheckpointAgent`: watches the job's
  ``ckpt-requested-version`` annotation, saves, and acknowledges through
  ``ckpt-completed-version``. Under a process group rank 0 alone reads
  the job and tells every rank which version to save, so the collective
  save happens at one step everywhere.

An Orbax checkpoint of the JAX package does not restore here: the two
packages share the model artifact (``models/io.py``) and HF directories,
not the optimizer state's on-disk form.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core.kubeclient import ApiError
from .trainer import AdamState, TrainState, tree_map

log = logging.getLogger("kubedl_tpu_torch.checkpoint")

#: the job annotations of the operator's 2-phase elastic protocol
#: (``kubedl_tpu/api/common.py``)
ANNOTATION_CKPT_REQUESTED_VERSION = "kubedl.io/ckpt-requested-version"
ANNOTATION_CKPT_COMPLETED_VERSION = "kubedl.io/ckpt-completed-version"


@dataclass
class CheckpointConfig:
    directory: str
    save_interval_steps: int = 0     # 0: only explicit save() calls
    max_to_keep: int = 3
    async_save: bool = True


def _nbytes(tree) -> int:
    """Bytes this rank holds (a DTensor counts its shard)."""
    from ..parallel.sharding import local_of
    total = []
    tree_map(lambda t: total.append(local_of(t).numel()
                                    * t.element_size()), tree)
    return sum(total)


def _group():
    """(checkpoint gloo group, rank) under an open process group, else
    (None, 0)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None, 0
    return dist.new_group(backend="gloo"), dist.get_rank()


class CheckpointManager:
    """Step directories of a :class:`TrainState` under
    ``config.directory``: ``<step>/state`` (``torch.distributed.checkpoint``
    files) and ``<step>/data.json`` (the data cursor, when given)."""

    PARTIAL_SUFFIX = ".partial"

    def __init__(self, config: CheckpointConfig):
        self.config = config
        self.directory = str(config.directory)
        self._group, self._rank = _group()
        if self._rank == 0:
            os.makedirs(self.directory, exist_ok=True)
            for name in os.listdir(self.directory):
                if name.endswith(self.PARTIAL_SUFFIX):
                    # a save torn by a crash: never finalized, never served
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        self._barrier()
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: Optional[BaseException] = None
        #: the last save's step, bytes, and seconds of its host copy
        #: and its write; the last restore's step, bytes and seconds
        self.last_save: dict = {}
        self.last_restore: dict = {}

    # -- steps --------------------------------------------------------------

    def all_steps(self) -> list:
        """Finalized steps on disk, ascending."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _barrier(self) -> None:
        if self._group is not None:
            import torch.distributed as dist
            dist.barrier(group=self._group)

    # -- save ---------------------------------------------------------------

    def save(self, state: TrainState, force: bool = False,
             step: Optional[int] = None, periodic: bool = False,
             data_state: Optional[dict] = None) -> bool:
        """Save at ``state.step``. Three call shapes:

        * ``periodic=True``: the trainer's per-step call; saves only on
          interval boundaries, and ``save_interval_steps=0`` disables it;
        * ``force=True``: always saves (final/preempt checkpoints);
        * plain ``save(state)``: an explicit request, always saves,
          whatever the interval.

        A step already on disk (or being written) is a no-op.
        ``data_state`` is the host-side data cursor (JSON-able), saved
        in the same step directory so model state and data position never
        diverge. Returns whether a save was started."""
        if step is None:
            step = int(state.step)
        if periodic and not force:
            interval = self.config.save_interval_steps
            if interval <= 0 or step % interval:
                return False
        if step == self._pending or step in self.all_steps():
            return False
        self._join()                     # one save in flight at a time
        t0 = time.perf_counter()
        host = _state_dict(state, copy_to_host=True)
        self.last_save = {"step": step, "bytes": _nbytes(host),
                          "copy_s": time.perf_counter() - t0}
        if self.config.async_save:
            self._pending = step
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, data_state),
                name=f"ckpt-save-{step}", daemon=True)
            self._thread.start()
        else:
            self._write(step, host, data_state)
        return True

    def _write_guarded(self, step, host, data_state) -> None:
        try:
            self._write(step, host, data_state)
        except BaseException as e:  # noqa: BLE001 — re-raised on wait
            self._error = e

    def _write(self, step: int, host: dict, data_state) -> None:
        import torch.distributed.checkpoint as dcp

        t0 = time.perf_counter()
        tmp = self._step_dir(step) + self.PARTIAL_SUFFIX
        lead = self._rank == 0
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.join(tmp, "state"))
        self._barrier()
        dcp.save(host, storage_writer=dcp.FileSystemWriter(
            os.path.join(tmp, "state")), process_group=self._group,
            no_dist=self._group is None)
        if lead:
            if data_state is not None:
                with open(os.path.join(tmp, "data.json"), "w") as f:
                    json.dump(data_state, f)
            os.replace(tmp, self._step_dir(step))   # the commit
            keep = self.config.max_to_keep
            if keep and keep > 0:
                for old in self.all_steps()[:-keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        self._barrier()                 # every rank sees the commit
        self.last_save["write_s"] = time.perf_counter() - t0
        log.info("checkpoint saved at step %d", step)

    def _join(self) -> None:
        """Join this manager's own save in flight; a failed write raises
        here. ``save``, ``restore`` and ``latest_data_state`` join
        through this, never through :meth:`wait_until_finished`, which a
        subclass may widen (the object tier's uploads)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def wait_until_finished(self) -> None:
        """Join the save in flight; a failed write raises here."""
        self._join()

    def close(self) -> None:
        self._join()

    # -- restore ------------------------------------------------------------

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> Optional[TrainState]:
        """Restore ``step`` (default the latest) into ``state``'s tensors,
        which give every leaf's device and dtype: the trainer's freshly
        initialized state is the template. Returns the restored state
        (the same tensors, with the saved step and update count), or None
        when there is no checkpoint."""
        import torch.distributed.checkpoint as dcp

        self._join()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        t0 = time.perf_counter()
        target = _state_dict(state, copy_to_host=False)
        with torch.no_grad():
            dcp.load(target, storage_reader=dcp.FileSystemReader(
                os.path.join(self._step_dir(step), "state")),
                process_group=self._group, no_dist=self._group is None)
        if any(t.device.type == "cuda" for t in _leaves(target)):
            torch.cuda.synchronize()
        self.last_restore = {"step": step, "bytes": _nbytes(target),
                             "seconds": time.perf_counter() - t0}
        opt = state.opt_state
        return TrainState(
            step=int(target["step"]), params=state.params,
            opt_state=AdamState(count=int(target["opt_state"]["count"]),
                                mu=opt.mu, nu=opt.nu))

    def latest_data_state(self, step: Optional[int] = None) -> Optional[dict]:
        """The data cursor saved with ``step`` (default the latest), or
        None. Reads one small JSON file, so the entrypoint learns the
        resume offset before it builds the data stream."""
        self._join()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self._step_dir(step), "data.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore_or(self, state: TrainState, init_fn: Callable):
        """Resume from the latest checkpoint, else ``init_fn()``."""
        restored = self.restore(state)
        if restored is not None:
            log.info("resumed from checkpoint step %d", restored.step)
            return restored
        return init_fn()


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _state_dict(state: TrainState, copy_to_host: bool) -> dict:
    """The state as ``torch.distributed.checkpoint`` sees it: the step and
    the update count as 0-dim int64 tensors, the parameter tree and the
    moments. ``copy_to_host`` takes a host copy (a save; a DTensor keeps
    its placement over a host copy of its shard); otherwise the tensors
    are aliases of the state's own (a restore loads into them in
    place)."""
    from torch.distributed.tensor import DTensor
    if copy_to_host:
        def leaf(t):
            if isinstance(t, DTensor):
                return DTensor.from_local(
                    t.to_local().detach().to("cpu", copy=True),
                    t.device_mesh, t.placements, run_check=False,
                    shape=t.shape, stride=t.stride())
            return t.detach().to("cpu", copy=True)
    else:
        def leaf(t):
            return t if isinstance(t, DTensor) else t.detach()
    opt = state.opt_state
    return {"step": torch.tensor(int(state.step), dtype=torch.int64),
            "params": tree_map(leaf, state.params),
            "opt_state": {
                "count": torch.tensor(int(opt.count), dtype=torch.int64),
                "mu": {k: leaf(v) for k, v in opt.mu.items()},
                "nu": {k: leaf(v) for k, v in opt.nu.items()}}}


class CheckpointTiers:
    """Host-local fast tier + object-store durable tier.

    The local tier is the directory the trainer saves into; this class
    adds the host->object-store leg on a background worker so neither
    tier ever blocks a training step, and the *nearest*-tier read path
    for restore.

    Upload contract (tmp + rename): a step is copied into
    ``<object_dir>/<step>.uploading`` and atomically renamed to
    ``<object_dir>/<step>`` only when every byte is down. A torn upload
    leaves a ``.uploading`` orphan that the read path NEVER serves and
    the next publisher sweeps.
    """

    UPLOADING_SUFFIX = ".uploading"

    def __init__(self, local_dir: str, object_dir: str,
                 ready: Optional[Callable] = None,
                 poll_interval_s: float = 0.02,
                 ready_timeout_s: float = 120.0):
        self.local_dir = str(local_dir)
        self.object_dir = str(object_dir)
        os.makedirs(self.object_dir, exist_ok=True)
        #: ``ready(step) -> bool``: whether the local tier has finalized
        #: the step (a save renames its partial directory into place on
        #: finalize, so directory existence is the default signal)
        self._ready = ready or self._local_finalized
        self._poll = float(poll_interval_s)
        self._ready_timeout = float(ready_timeout_s)
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        #: steps whose upload completed
        self.uploaded: list = []
        #: torn ``.uploading`` orphans swept before uploads
        self.swept = 0
        #: per-step upload attempts so far (bounded retries)
        self._attempts: dict = {}
        #: steps whose upload exhausted its retries: ``flush`` raises
        self.failed: list = []
        self.max_attempts = 3

    # -- read side ----------------------------------------------------------

    def _step_dirs(self, root: str) -> list:
        try:
            names = os.listdir(root)
        except OSError:
            return []
        out = []
        for n in names:
            if n.endswith(self.UPLOADING_SUFFIX):
                continue               # torn upload: never served
            try:
                out.append(int(n))
            except ValueError:
                continue
        return sorted(out)

    def local_steps(self) -> list:
        return [s for s in self._step_dirs(self.local_dir)
                if self._local_finalized(s)]

    def object_steps(self) -> list:
        return self._step_dirs(self.object_dir)

    def nearest_step(self) -> Optional[int]:
        """Newest step across both tiers (restore reads the nearest copy
        of it: local when present, object-store otherwise)."""
        steps = set(self.local_steps()) | set(self.object_steps())
        return max(steps) if steps else None

    def localize(self, step: int) -> bool:
        """Ensure ``step`` exists in the local tier, downloading from the
        object tier when the local copy is gone. Returns False when
        neither tier has it."""
        if step in self.local_steps():
            return True
        if step not in self.object_steps():
            return False
        src = os.path.join(self.object_dir, str(step))
        tmp = os.path.join(self.local_dir,
                           f"{step}{self.UPLOADING_SUFFIX}")
        dst = os.path.join(self.local_dir, str(step))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(self.local_dir, exist_ok=True)
        shutil.copytree(src, tmp)
        os.replace(tmp, dst)
        log.info("checkpoint step %d localized from the object tier",
                 step)
        return True

    def localize_latest(self) -> Optional[int]:
        """Pull the newest object-tier step missing locally: run before
        the manager opens, so restore sees the nearest tier."""
        newest = self.nearest_step()
        if newest is not None and self.localize(newest):
            return newest
        return None

    # -- write side ---------------------------------------------------------

    def _local_finalized(self, step: int) -> bool:
        return os.path.isdir(os.path.join(self.local_dir, str(step)))

    def publish(self, step: int) -> None:
        """Enqueue the host->object-store upload of ``step`` on the
        background worker (never blocks the training step)."""
        self._ensure_worker()
        self._queue.put(int(step))

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._drain, name="ckpt-upload", daemon=True)
                self._worker.start()

    def _drain(self) -> None:
        while True:
            step = self._queue.get()
            try:
                if step is None:
                    return
                self._upload(step)
            except Exception as e:  # noqa: BLE001 — a failed upload
                # must not kill the worker; retry bounded, then record
                # the step so flush() surfaces the hole
                n = self._attempts.get(step, 0) + 1
                self._attempts[step] = n
                if n < self.max_attempts:
                    log.warning("checkpoint upload of step %s failed "
                                "(attempt %d/%d, will retry): %s",
                                step, n, self.max_attempts, e)
                    time.sleep(self._poll)
                    self._queue.put(step)
                else:
                    log.error("checkpoint upload of step %s failed "
                              "%d times; the object tier is MISSING "
                              "this step: %s", step, n, e)
                    self.failed.append(step)
            finally:
                self._queue.task_done()

    def _upload(self, step: int) -> None:
        deadline = time.monotonic() + self._ready_timeout
        while not self._ready(step):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"step {step} never finalized in the local tier")
            time.sleep(self._poll)
        dst = os.path.join(self.object_dir, str(step))
        if os.path.isdir(dst):
            return                      # already uploaded (idempotent)
        tmp = dst + self.UPLOADING_SUFFIX
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)          # torn upload from a prior crash
            self.swept += 1
        shutil.copytree(os.path.join(self.local_dir, str(step)), tmp)
        os.replace(tmp, dst)            # atomic: readers see all or nothing
        self.uploaded.append(step)
        log.info("checkpoint step %d published to the object tier", step)

    def flush(self, timeout_s: float = 120.0) -> None:
        """Wait until every enqueued upload has landed; raise when any
        step exhausted its retries: a clean return MEANS the object tier
        holds every published step."""
        deadline = time.monotonic() + timeout_s
        while not self._queue.empty() or self._queue.unfinished_tasks:
            if time.monotonic() >= deadline:
                raise TimeoutError("checkpoint uploads did not drain")
            time.sleep(self._poll)
        if self.failed:
            raise RuntimeError(
                f"object-tier upload failed permanently for step(s) "
                f"{sorted(set(self.failed))}; the durable tier is "
                f"missing them")

    def close(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=10.0)


class TieredCheckpointManager(CheckpointManager):
    """:class:`CheckpointManager` + the object-store tier: every
    completed save is published to ``object_dir`` on the background
    worker, and construction pulls the newest object-tier step down
    first, so restore reads the nearest tier even on a host whose local
    disk started empty."""

    def __init__(self, config: CheckpointConfig, object_dir: str,
                 upload: bool = True):
        import torch.distributed as dist
        lead = not dist.is_initialized() or dist.get_rank() == 0
        self.tiers = CheckpointTiers(config.directory, object_dir)
        if lead:                        # rank 0 alone moves step dirs
            self.tiers.localize_latest()
        super().__init__(config)
        self._upload_enabled = bool(upload) and lead

    def save(self, state, force: bool = False, step: Optional[int] = None,
             periodic: bool = False,
             data_state: Optional[dict] = None) -> bool:
        saved = super().save(state, force=force, step=step,
                             periodic=periodic, data_state=data_state)
        if saved and self._upload_enabled:
            self.tiers.publish(int(state.step) if step is None else step)
        return saved

    def wait_until_finished(self) -> None:
        super().wait_until_finished()
        self.tiers.flush()

    def close(self) -> None:
        try:
            self.tiers.flush()
        except (TimeoutError, RuntimeError) as e:
            log.warning("closing with unfinished checkpoint uploads: %s",
                        e)
        self.tiers.close()
        super().close()


def abstract_state_like(state: TrainState, mesh, param_specs) -> TrainState:
    """The restore target for ``state`` on ``mesh``: every leaf of the
    same global shape and dtype, uninitialized, placed by the *target*
    specs, so :meth:`CheckpointManager.restore` into it reshards a
    checkpoint written at another world size. The moments mirror their
    param's spec. On a one-device mesh the leaves are plain tensors on
    its device, the params grad-requiring as ``Trainer.init_state``
    leaves them. (The JAX function also takes the optimizer's and the
    step's specs; here the moments are keyed by param path and the step
    is a host integer.)"""
    from ..parallel.sharding import empty_like_placed, map_specs, \
        spec_leaves
    one_device = mesh.device_mesh is None

    def place(s, x):
        t = empty_like_placed(tuple(x.shape), x.dtype, mesh, s)
        return t.requires_grad_(True) if one_device else t

    flat = spec_leaves(param_specs)
    opt = state.opt_state

    def moments(tree):
        return {k: empty_like_placed(tuple(v.shape), v.dtype, mesh, flat[k])
                for k, v in tree.items()}

    return TrainState(
        step=state.step,
        params=map_specs(place, param_specs, state.params),
        opt_state=AdamState(count=opt.count, mu=moments(opt.mu),
                            nu=moments(opt.nu)))


class ElasticCheckpointAgent:
    """Training-side half of the operator's 2-phase elastic protocol.

    The controller requests a checkpoint by bumping
    ``kubedl.io/ckpt-requested-version`` on the job; this agent saves and
    acknowledges by writing the same version into
    ``kubedl.io/ckpt-completed-version``, after which the controller
    releases the leaving pods. ``api`` is any client with the API
    server's ``try_get`` and ``patch_merge``
    (``core.kubeclient.KubeAPIServer`` in a pod); ``retry_on`` is the
    exception type(s) its failed writes raise (conflicts, transient
    errors), which the acknowledgement retries.

    Under a process group every rank calls :meth:`poll` at the same point
    of each step. The save is collective, so rank 0 alone reads the job
    and broadcasts the version it will save (0: none), one broadcast per
    poll; every rank saves, every rank joins the write and a barrier, and
    only then does rank 0 acknowledge, so the operator never releases a
    pod while a rank is still writing. The broadcast and the barrier run
    on a gloo group of the agent's own, opened at the first poll, on a
    host tensor: a poll never waits on the card's stream, and never
    shares a group with the manager's write in flight. (The JAX agent
    polls on every process: its save has no such collective to pair.)"""

    def __init__(self, api, kind: str, namespace: str, name: str,
                 manager: CheckpointManager, data_state_fn=None,
                 retry_on=ApiError):
        self.api = api
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.manager = manager
        #: optional () -> dict supplying the data cursor, so an elastic
        #: checkpoint resumes its stream exactly like a periodic one
        self.data_state_fn = data_state_fn
        self.retry_on = retry_on
        self._acked = 0
        self._group = None

    @staticmethod
    def _version(job, key: str) -> int:
        ann = (job.get("metadata") or {}).get("annotations") or {}
        return int(ann.get(key, 0) or 0)

    def _pending(self) -> int:
        """The requested version still to save and acknowledge, or 0."""
        job = self.api.try_get(self.kind, self.namespace, self.name)
        if job is None:
            return 0
        requested = self._version(job, ANNOTATION_CKPT_REQUESTED_VERSION)
        completed = self._version(job, ANNOTATION_CKPT_COMPLETED_VERSION)
        return requested if requested > max(completed, self._acked) else 0

    def poll(self, state) -> bool:
        """Check for an outstanding checkpoint request; save + ack if one
        is pending. Returns True (on every rank) when a checkpoint was
        taken."""
        import torch.distributed as dist
        group = dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1
        if group and self._group is None:
            self._group = dist.new_group(backend="gloo")
        lead = not group or dist.get_rank() == 0
        requested = self._pending() if lead else 0
        if group:
            t = torch.tensor([requested], dtype=torch.int64)
            dist.broadcast(t, src=0, group=self._group)
            requested = int(t.item())
        if not requested:
            return False
        self.manager.save(state, force=True,
                          data_state=(self.data_state_fn()
                                      if self.data_state_fn else None))
        self.manager.wait_until_finished()  # ack only after bytes are down
        if group:
            dist.barrier(group=self._group)  # ... on every rank
        if not lead:
            return True
        acked = self._ack(requested)
        if acked is None:
            # the ack could not land: the request stays pending, so the
            # next poll (a step later) saves again at its step, on every
            # rank, and retries the ack
            log.warning("elastic checkpoint v%d saved but the ack write "
                        "did not land; will retry", requested)
            return True
        self._acked = acked
        log.info("elastic checkpoint v%d taken and acknowledged", acked)
        return True

    def _ack(self, requested: int) -> Optional[int]:
        """Write ``ckpt-completed-version`` with the conflict
        re-read/re-apply retry. Each retry RE-READS the job: a newer
        requested version observed mid-retry is acknowledged instead
        (the checkpoint just taken covers it)."""
        for _ in range(8):
            try:
                self.api.patch_merge(self.kind, self.namespace, self.name, {
                    "metadata": {"annotations": {
                        ANNOTATION_CKPT_COMPLETED_VERSION:
                            str(requested)}}})
                return requested
            except self.retry_on as e:
                job = self.api.try_get(self.kind, self.namespace,
                                       self.name)
                if job is None:
                    return None
                requested = max(requested, self._version(
                    job, ANNOTATION_CKPT_REQUESTED_VERSION))
                log.warning("elastic ack conflicted (%s); re-applying "
                            "as v%d", e, requested)
        return None

