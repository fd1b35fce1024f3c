"""Local launchers of the ranks of a process group on this host.

The tensor-parallel predictor (``KUBEDL_SERVING_TP``) starts its own
ranks: :func:`start_local_ranks` runs ranks 1..N-1 as processes of a
module (``python -m kubedl_tpu_torch.serving.tp``), each on its own card
(``cuda:r``; one core each on the CPU), and joins the group itself as
rank 0 (:func:`open_group`: NCCL on cards, gloo on the CPU, over a free
localhost port, with a timeout). A predictor pod needs no operator
contract for this. :class:`LocalRanks` watches the followers: one that
exits before rank 0 closes the group sets ``failed`` and aborts rank
0's groups (:func:`abort_groups`), and the predictor ends; rank 0's
death closes its sockets, and every follower's next wait
fails. :meth:`LocalRanks.close` waits for the followers' exit and closes
rank 0's group.

For tests, :func:`spawn` runs one function as the ranks of a group over
the operator's rendezvous contract.

:func:`spawn` starts ``world`` fresh processes, gives rank ``r`` the env
an operator-rendered worker gets (``KUBEDL_COORDINATOR_ADDRESS`` on a
free localhost port, ``KUBEDL_NUM_PROCESSES``, ``KUBEDL_PROCESS_ID``,
``LOCAL_RANK``), runs ``fn(*args)`` in each and returns their results in
rank order. ``fn`` opens the group itself, through
``runtime.bootstrap.initialize_distributed`` or the train entrypoint, so
the rendezvous is exercised as a job would use it. A rank that raises,
dies or outlives ``timeout`` fails the call, and every process is
stopped before it returns. Gloo groups on the CPU run several ranks on
one host; NCCL takes one card per rank.
"""

from __future__ import annotations

import logging
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

log = logging.getLogger("kubedl_tpu_torch.launch")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank: int, world: int, port: int, out: str) -> None:
    os.environ.update({"KUBEDL_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                       "KUBEDL_NUM_PROCESSES": str(world),
                       "KUBEDL_PROCESS_ID": str(rank),
                       "LOCAL_RANK": str(rank)})
    # one CPU thread per rank: ranks sharing a host's cores would
    # otherwise oversubscribe them
    import torch
    torch.set_num_threads(1)
    try:
        with open(os.path.join(out, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        result = ("ok", fn(*args))
    except BaseException:  # noqa: BLE001 — reported to the parent
        result = ("error", traceback.format_exc())
    with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn, world: int, *args, timeout: float = 120.0) -> list:
    """``[fn(*args) on rank r for r in range(world)]``, each rank in its
    own process on one CPU thread (see the module docstring)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="kubedl-ranks-") as out:
        # the arguments go through a file: a process's start blocks until
        # it has read its pipe, so large arguments there would start the
        # ranks one after another
        with open(os.path.join(out, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(target=_entry, daemon=True,
                             args=(fn, r, world, port, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
                if p.is_alive():
                    raise TimeoutError(
                        f"a rank of {world} ran past {timeout:.0f} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(out, f"{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with code "
                                   f"{p.exitcode} and no result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            results.append(value)
        return results


def open_group(rank: int, world: int, port: int, device,
               timeout: float) -> None:
    """Join a ``world``-rank process group on this host as ``rank``
    (``tcp://127.0.0.1:port``): NCCL bound to ``device`` when it is a
    card, gloo on the CPU; every collective waits at most ``timeout``
    seconds."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw = {"backend": "nccl", "device_id": dev}
    else:
        kw = {"backend": "gloo"}
    dist.init_process_group(init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout), **kw)


def abort_groups() -> None:
    """Abort every process group of this process, so that a collective
    waiting on a rank that died fails at once. A gloo collective fails
    by itself when its peer's sockets close; a NCCL one would wait on the
    card until the group's timeout (and its watchdog then ends the
    process), holding every lock its caller holds."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _abort_process_group
    if not dist.is_initialized():
        return
    try:
        _abort_process_group()
    except Exception:  # noqa: BLE001 — the abort is the last resort
        log.exception("could not abort the process groups")


class LocalRanks:
    """Rank 0's handle on the follower processes it started (ranks
    1..N-1, in order). ``failed`` is set, and rank 0's groups aborted,
    when a follower exits before :meth:`close`; ``exit_codes`` holds each follower's code once it has
    exited."""

    def __init__(self, procs: list):
        self.procs = procs
        self.failed = threading.Event()
        self.exit_codes: dict = {}
        self._closing = False
        for rank, proc in enumerate(procs, 1):
            threading.Thread(target=self._watch, args=(rank, proc),
                             name=f"rank-{rank}-watch", daemon=True).start()

    def _watch(self, rank: int, proc) -> None:
        code = proc.wait()
        self.exit_codes[rank] = code
        if not self._closing:
            log.error("rank %d exited with code %s while serving", rank,
                      code)
            self.failed.set()
            abort_groups()

    def close(self, timeout: float = 60.0, kill: bool = False) -> dict:
        """Wait up to ``timeout`` seconds for every follower to exit (at
        once with ``kill``), kill those still running, and close rank 0's
        process group. Returns the exit codes by rank."""
        import torch.distributed as dist
        self._closing = True
        deadline = time.monotonic() + (0.0 if kill else timeout)
        for proc in self.procs:
            try:
                proc.wait(max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
        if dist.is_initialized():
            dist.destroy_process_group()
        return {r: p.returncode for r, p in enumerate(self.procs, 1)}


def start_local_ranks(world: int, module: str, argv: list, device,
                      timeout: float) -> LocalRanks:
    """Start ranks 1..``world``-1 as ``python -m module --rank r --world
    N --port P --device cuda|cpu --timeout S *argv`` (rank ``r`` takes
    card ``r``), then join the group as rank 0 on ``device``. A failure
    to join kills the followers."""
    import torch
    dev = torch.device(device)
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--rank", str(r), "--world",
         str(world), "--port", str(port), "--device", dev.type,
         "--timeout", str(timeout), *argv], env=env)
        for r in range(1, world)]
    ranks = LocalRanks(procs)
    try:
        open_group(0, world, port, dev, timeout)
    except BaseException:
        ranks.close(kill=True)
        raise
    if ranks.failed.is_set():
        # a follower died while the group opened, before the watcher
        # could abort it
        abort_groups()
    return ranks
