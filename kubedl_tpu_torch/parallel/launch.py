"""A local launcher: one function run as the ranks of a process group on
this host, over the operator's rendezvous contract.

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

import os
import pickle
import socket
import tempfile
import time
import traceback


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
