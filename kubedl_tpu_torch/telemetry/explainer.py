"""Pending-job explainer: "why is my job not running?", structurally.

A read-only simulation of one :meth:`SliceScheduler.schedule_pass
<kubedl_tpu_torch.scheduling.scheduler.SliceScheduler.schedule_pass>` over the
scheduler's live state, stopped at the asked-about gang-set. It replays
the pass's admission order — queue priority, per-queue FIFO, quota
ceiling, reservation backfill, reclaim-debt earmarks — without writing
anything, and reports the FIRST rule that blocks the job, with the
blocking queue/pool/job named.

Verdict grammar (docs/telemetry.md):

==================== =====================================================
``Admissible``       nothing blocks it — the next scheduling pass admits
``Admitted``         all slices already hold capacity (not pending at all)
``GangIncomplete``   not every PodGroup of the gang-set exists yet
``GangInfeasible``   demand exceeds the pool's total capacity — will never
                     run as shaped
``QuotaCeiling``     its queue is at ``max`` (strict FIFO holds everything
                     behind the ceiling too)
``BackfillReservation`` enough unheld capacity exists, but a capacity-
                     blocked queue head reserved it; backfilling past the
                     reservation would delay that head
``ReclaimEarmarked`` free capacity is debted to another under-min queue's
                     in-flight reclaim
``PoolCapacity``     the pool is simply full; the holders map names who
==================== =====================================================

With placement scoring on (docs/scheduling.md "Placement scoring") the
simulation replays the SCORED pass: every gang's eligible pools are
ranked with the scheduler's own scorer and simulated admissions debit
the chosen pool, not the routed one — an explainer that simulated the
old unscored pass would name the wrong blocking pool the moment scoring
ships. An ``Admissible`` verdict then carries a ``scoredPlacement``
detail: the chosen pool's full score row and the runner-up.

Copied from ``kubedl_tpu/telemetry/explainer.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..api.queue import DEFAULT_QUEUE, QueueSpec


def explain_pending(scheduler, namespace: str, job: str) -> Optional[dict]:
    """Structured verdict for one job's gang-set, or None when the
    scheduler has never seen it (no pending PodGroups, no held slices)."""
    inv = scheduler.inventory
    with scheduler._lock:
        queues = dict(scheduler._queues)
        pending = dict(scheduler._pending)
        debt = dict(scheduler._reclaim_debt)
        # held is read under the same lock so the pending/debt/held
        # snapshots are mutually consistent (a pass admitting a gang
        # between the reads would double-count its slices)
        held = inv.held_records()
    held_jobs: dict[tuple, int] = {}
    held_pool: dict[tuple, str] = {}
    held_by_queue: dict[str, int] = {}
    for h in held:
        held_by_queue[h.queue] = held_by_queue.get(h.queue, 0) + 1
        hk = (h.namespace, h.job)
        held_jobs[hk] = held_jobs.get(hk, 0) + 1
        held_pool[hk] = h.pool

    key = (namespace, job)
    target = pending.get(key)
    base = {"job": f"{namespace}/{job}"}
    if target is None:
        if held_jobs.get(key):
            return {**base, "verdict": "Admitted",
                    "heldSlices": held_jobs[key],
                    "message": "every slice of the gang holds capacity"}
        return None

    queues.setdefault(DEFAULT_QUEUE, QueueSpec(name=DEFAULT_QUEUE))
    for gs in pending.values():
        queues.setdefault(gs.queue, QueueSpec(name=gs.queue))
    q = queues[target.queue]
    demand = len(target.pgs)
    base.update({
        "queue": target.queue, "pool": target.pool,
        "demandSlices": demand, "wantSlices": target.want,
        "queuedSeconds": round(
            max(scheduler.api.now() - target.first_seen(), 0.0), 3),
    })

    if demand + held_jobs.get(key, 0) < target.want:
        return {**base, "verdict": "GangIncomplete",
                "message": f"only {demand} of {target.want} PodGroup(s) "
                           f"exist; the gang-set is not yet complete"}

    #: the scorer the scheduler itself admits with (None = unscored
    #: pass); candidate sets and pool choices must mirror it exactly
    scorer = getattr(scheduler, "scorer", None)

    def candidates_of(gs) -> list:
        """THE scheduler's own candidate rule (scored gangs expand to
        their known-capacity eligibility set, a partially-landed gang
        is pinned to the pool its held slices sit in) — shared, not
        mirrored, so the two can never drift."""
        return scheduler.candidates_for(
            gs, held_pool.get((gs.namespace, gs.job)))

    if target.pool:
        tcands = candidates_of(target)
        tcaps = {p: inv.capacity_slices(p) for p in tcands}
        if all(tcaps[p] is not None and demand > tcaps[p]
               for p in tcands):
            # anchor pool mirrors scheduler.place: the pinned held pool
            # when slices already landed, else the routed primary
            anchor = tcands[0]
            cap = tcaps[anchor]
            return {**base, "verdict": "GangInfeasible", "blockingPool":
                    anchor, "poolCapacity": cap,
                    "message": f"needs {demand} slice(s) of {anchor} "
                               f"but the pool holds only {cap}; it will "
                               f"never be admitted as shaped"}

    # -- simulate the pass, in the scheduler's exact order --------------
    by_queue: dict[str, list] = {}
    for k2, gs in pending.items():
        if len(gs.pgs) + held_jobs.get(k2, 0) < gs.want:
            continue
        by_queue.setdefault(gs.queue, []).append(gs)
    for lst in by_queue.values():
        lst.sort(key=lambda g: (g.first_seen(), g.job))

    free: dict[str, Optional[int]] = {}

    def free_for(pool: str) -> Optional[int]:
        if pool not in free:
            free[pool] = inv.free_slices(pool)
        return free[pool]

    def debt_other(pool: str, qname: str) -> int:
        return sum(n for (p, dq), n in debt.items()
                   if p == pool and dq != qname)

    reserved: dict[str, int] = {}
    reserved_by: dict[str, tuple] = {}     # pool -> (queue, head job)
    for qname in sorted(queues, key=lambda n: (-queues[n].priority, n)):
        qq = queues[qname]
        fifo = by_queue.get(qname, [])
        held_q = held_by_queue.get(qname, 0)
        head_blocked = False
        for gs in fifo:
            is_target = (gs.namespace, gs.job) == key
            d = len(gs.pgs) if gs.pool else 0
            if qq.max is not None and held_q + d > qq.max:
                # strict FIFO: the ceiling blocks this gang AND everyone
                # behind it in the queue
                if is_target or any((g.namespace, g.job) == key
                                    for g in fifo[fifo.index(gs):]):
                    return {**base, "verdict": "QuotaCeiling",
                            "blockingQueue": qname,
                            "heldSlices": held_q, "quotaMax": qq.max,
                            "headJob": f"{gs.namespace}/{gs.job}",
                            "message": f"queue {qname} holds {held_q} "
                                       f"slice(s) of max {qq.max}; "
                                       f"admission waits for capacity to "
                                       f"release inside the queue"}
                break
            chosen, rows = None, None
            if d:
                gcands = candidates_of(gs)
                gcaps = {p: inv.capacity_slices(p) for p in gcands}
                if all(gcaps[p] is not None and d > gcaps[p]
                       for p in gcands):
                    # infeasible gangs never block the queue in the real
                    # pass (scheduler._schedule_queue `continue`s them) —
                    # but only AFTER the quota-ceiling check above, whose
                    # ordering the simulation must match. The target
                    # itself was already answered GangInfeasible earlier.
                    continue
                fitting = []
                for p in gcands:
                    if gcaps[p] is not None and d > gcaps[p]:
                        continue
                    fp = free_for(p)
                    availp = None if fp is None else max(
                        fp - reserved.get(p, 0) - debt_other(p, qname), 0)
                    if availp is None or availp >= d:
                        fitting.append(p)
                if fitting:
                    if scorer is None:
                        chosen = fitting[0]
                    else:
                        rows = scorer.rank(gs.profile, fitting, d)
                        chosen = rows[0]["pool"]
            if not d or chosen is not None:
                if is_target:
                    out = {**base, "verdict": "Admissible",
                           "message": "nothing blocks this gang; the "
                                      "next scheduling pass admits it"}
                    if rows:
                        # the scored pass's own ranking (ScoredPlacement
                        # detail): chosen pool, its score, the runner-up
                        out["scoredPlacement"] = {
                            "chosen": rows[0],
                            "runnerUp": rows[1] if len(rows) > 1
                            else None}
                        if chosen != gs.pool:
                            out["message"] += (
                                f"; scoring places it on {chosen} "
                                f"instead of the routed {gs.pool}")
                    return out
                held_q += d
                if chosen is not None and free_for(chosen) is not None:
                    # unknown pool (free None) = unlimited: nothing to
                    # debit; otherwise the CHOSEN pool pays, exactly as
                    # the scored admission would
                    free[chosen] = free_for(chosen) - d
                continue
            # blocked: anchor on the pinned held pool when one exists,
            # exactly as SliceScheduler._schedule_queue does
            anchor = gcands[0]
            f = free_for(anchor)
            if is_target:
                return _capacity_verdict(base, gs, anchor, qq, d, f,
                                         reserved, reserved_by, debt,
                                         debt_other, held, held_q)
            avail = 0 if f is None else max(
                f - reserved.get(anchor, 0) - debt_other(anchor, qname),
                0)
            if not head_blocked:
                head_blocked = True
                reserved[anchor] = reserved.get(anchor, 0) + avail
                reserved_by.setdefault(
                    anchor, (qname, f"{gs.namespace}/{gs.job}"))
            # blocked non-head gangs just wait their turn
    # unreachable for a complete pending target, but degrade gracefully
    return {**base, "verdict": "PoolCapacity",
            "message": "blocked on pool capacity"}


def _capacity_verdict(base, gs, pool, q, demand, free_now, reserved,
                      reserved_by, debt, debt_other, held,
                      held_q) -> dict:
    foreign_debt = debt_other(pool, q.name)
    out = dict(base)
    out["freeSlices"] = free_now
    out["reclaimEligible"] = held_q + demand <= q.min
    out["preemptionsInFlight"] = sum(
        1 for h in held if h.pool == pool and h.preempted)
    if max((free_now or 0) - foreign_debt, 0) >= demand \
            and pool in reserved_by:
        bq, bjob = reserved_by[pool]
        out.update({
            "verdict": "BackfillReservation", "blockingQueue": bq,
            "blockingJob": bjob, "reservedSlices": reserved.get(pool, 0),
            "message": f"{reserved.get(pool, 0)} free slice(s) of {pool} "
                       f"are reserved for the capacity-blocked head "
                       f"{bjob} of queue {bq}; backfilling past it would "
                       f"delay that head"})
        return out
    if max((free_now or 0) - reserved.get(pool, 0), 0) >= demand \
            and foreign_debt:
        owed_to = sorted(dq for (p, dq), n in debt.items()
                         if p == pool and dq != q.name and n > 0)
        out.update({
            "verdict": "ReclaimEarmarked",
            "blockingQueue": owed_to[0] if owed_to else "",
            "debtSlices": foreign_debt,
            "message": f"{foreign_debt} freed slice(s) of {pool} are "
                       f"earmarked for queue "
                       f"{owed_to[0] if owed_to else '?'}'s in-flight "
                       f"reclaim"})
        return out
    holders: dict[str, int] = {}
    for h in held:
        if h.pool == pool:
            holders[h.queue] = holders.get(h.queue, 0) + 1
    borrowers = {qn: n for qn, n in holders.items() if qn != q.name}
    blocking = max(sorted(borrowers), key=lambda qn: borrowers[qn],
                   default="")
    out.update({
        "verdict": "PoolCapacity", "blockingPool": pool,
        "holders": dict(sorted(holders.items())),
        "blockingQueue": blocking,
        "message": f"pool {pool} has {free_now or 0} free slice(s) for a "
                   f"demand of {demand}"
                   + (f"; queue {blocking} holds "
                      f"{borrowers[blocking]} slice(s)" if blocking else "")
                   + ("; reclaim by preemption applies (queue under min)"
                      if out["reclaimEligible"] else "")})
    return out
