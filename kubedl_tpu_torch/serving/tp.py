"""Serving over a mesh across processes (``tp``, and the engines' other
axes): the step channel, the follower loop and the follower
process's entry point. Port-only (no JAX twin, like
``parallel/collectives.py``).

The JAX predictor serves a mesh from one process: GSPMD puts the
collectives inside each jitted step. In torch every card is its own
process, so the predictor (rank 0) runs the HTTP front, the tokenizer,
the host scheduler and sampling, and every other rank follows:

* rank 0 posts every device step of its engine, with the step's host
  arguments, on one :class:`StepChannel` before it runs the step itself
  (``ContinuousBatchingEngine._dev``): the prefill chunks, the decode
  ticks (the tick's packed int64 buffer), the draft steps and the
  speculative verify, the prefix fills and loads, the embeddings
  forward, the recovery after a failed step, a heartbeat while idle and
  stop;
* each follower's engine, built with the same arguments on its own card,
  repeats each step in the order posted (:func:`follow`), so every rank
  runs the same collectives in the same order and the same number of
  CUDA graph captures.

The channel is a gloo group on the CPU over the same ranks: a follower
never synchronises its card to read a step, and the model's collectives
(NCCL on cards) carry nothing else. Each step goes as one pickled
message (two broadcasts: its length, then its bytes). On one rank the
message is still packed, so a one-rank run pays the channel's host cost,
and only the broadcast is skipped.

The groups' timeout (:data:`TIMEOUT_S`) bounds every wait: a follower
that dies closes its sockets and rank 0's next collective on the
channel fails (its watcher, ``parallel.launch.LocalRanks``, also aborts
rank 0's groups, so a NCCL collective inside the model fails at once
too); one that hangs fails it at the timeout; and rank 0 posts a
heartbeat while idle (every quarter of the timeout), so an idle
follower's wait never runs out.

``python -m kubedl_tpu_torch.serving.tp --rank R --world N --port P
--device cuda|cpu --timeout S --spec JSON`` is a follower process: it
joins the predictor's group (``parallel.launch.open_group``), builds its
engine from the predictor's spec on its own card, follows until stop and
exits 0 (non-zero on any error).
"""

from __future__ import annotations

import argparse
import json
import logging
import pickle
import sys

import torch
import torch.distributed as dist

#: seconds any rank of a tensor-parallel predictor waits on another
TIMEOUT_S = 600.0

log = logging.getLogger("kubedl_tpu_torch.serving.tp")


class StepChannel:
    """Rank 0's device steps, posted to the other ranks of a serving mesh
    (every rank of every axis) over a gloo group
    of the same ranks (none on one rank). ``posts`` counts the steps
    posted."""

    def __init__(self, mesh):
        from datetime import timedelta
        dm = getattr(mesh, "device_mesh", None)
        ranks = dm.mesh.flatten().tolist() if dm is not None else [0]
        self.world = len(ranks)
        self.group = None
        self.rank = 0
        self.src = 0
        self.posts = 0
        if self.world > 1:
            self.group = dist.new_group(
                ranks, backend="gloo",
                timeout=timedelta(seconds=TIMEOUT_S))
            self.rank = dist.get_rank(self.group)
            self.src = ranks[0]

    @property
    def leader(self) -> bool:
        """Whether this rank posts (rank 0 of the group) or follows."""
        return self.rank == 0

    def post(self, op: str, args: dict) -> None:
        data = pickle.dumps((op, args), protocol=pickle.HIGHEST_PROTOCOL)
        self.posts += 1
        if self.group is None:
            return
        head = torch.tensor([len(data)], dtype=torch.int64)
        dist.broadcast(head, self.src, group=self.group)
        dist.broadcast(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                       self.src, group=self.group)

    def recv(self) -> tuple:
        """The next ``(op, args)`` rank 0 posted (a follower's wait)."""
        head = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(head, self.src, group=self.group)
        buf = torch.empty(int(head[0]), dtype=torch.uint8)
        dist.broadcast(buf, self.src, group=self.group)
        # the bytes come from rank 0 of this program's own group
        return pickle.loads(buf.numpy().tobytes())

    def close(self) -> None:
        # after an abort (``LocalRanks``) no group is left to destroy
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group(self.group)
        self.group = None


@torch.no_grad()
def follow(engine) -> int:
    """A follower's loop: repeat each step rank 0 posts on ``engine``
    (built with rank 0's arguments) until stop. Returns the steps run."""
    channel = engine._channel
    if channel is None or channel.leader:
        raise RuntimeError("only a follower rank of a tensor-parallel "
                           "engine follows")
    n = 0
    try:
        while True:
            op, args = channel.recv()
            if op == "stop":
                return n
            engine._run_op(op, args)
            n += 1
    finally:
        channel.close()


def main(argv=None) -> int:
    """A follower process of ``KUBEDL_SERVING_TP`` (see the module
    docstring): rank ``--rank`` of ``--world`` on its own card, or on one
    CPU core with ``--device cpu``."""
    ap = argparse.ArgumentParser(prog="python -m kubedl_tpu_torch.serving.tp")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--timeout", type=float, required=True)
    ap.add_argument("--spec", required=True,
                    help="the predictor's engine spec (JSON)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from ..parallel import launch
    from .__main__ import engine_for_rank

    if args.device == "cuda":
        dev = torch.device("cuda", args.rank)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)     # one core per rank
    launch.open_group(args.rank, args.world, args.port, dev, args.timeout)
    try:
        engine = engine_for_rank(json.loads(args.spec), dev,
                                 tp=args.world)
        steps = follow(engine)
        log.info("rank %d of %d followed %d steps; stopping", args.rank,
                 args.world, steps)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
