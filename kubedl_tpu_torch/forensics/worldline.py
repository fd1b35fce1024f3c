"""WAL time-travel: the store at any resourceVersion, and object history.

A :class:`WorldLine` is a read-only view over a journal directory
(docs/durability.md). The journal already holds everything needed to
answer "what did the world look like at rv N": recovery's own recipe —
newest parseable snapshot at or below N, plus a replay of every WAL
record with ``snap_rv < rv <= N`` — generalized from "N = the newest
acknowledged write" to any rv the retained generations cover. The reader
is :meth:`Journal.iter_records`, the same public read side recovery and
future WAL followers use; this module never parses a WAL line itself.

Coverage: with the journal's default pruning only the newest retained
checkpoint's world onward is reconstructible (older snapshot bases are
gone); with ``Journal(retain_all=True)`` — the forensics retention mode
every campaign replay runs under — the worldline reaches rv 1. Asking
below the horizon raises :class:`HistoryUnavailable` (a ``ValueError``:
the console maps it to a client error, not a crash).

Copied from ``kubedl_tpu/forensics/worldline.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from ..core.journal import Journal


def _fmt_key(k: tuple) -> str:
    return "/".join(k)


class HistoryUnavailable(ValueError):
    """The asked rv predates the retained journal generations (the
    checkpoint pruned the WAL files that covered it). Re-run with
    ``Journal(retain_all=True)`` to keep the full worldline."""


class WorldLine:
    """Time-travel reads over one journal directory.

    Stateless between calls — every query re-resolves the on-disk
    generations, so a live journal (the operator still appending) is
    safe to inspect: at worst a query sees the world as of its own
    read, exactly like any other snapshot-isolated reader."""

    def __init__(self, journal_dir: str):
        self.journal = Journal(journal_dir)
        #: provenance of the last ``at()`` reconstruction — the same
        #: shape as ``Journal.recovered_from`` (docs/durability.md)
        self.reconstructed_from: dict = {}

    # -- coverage ----------------------------------------------------------

    def head_rv(self) -> int:
        """Highest rv the retained generations know about."""
        head = max((rv for rv, _ in self.journal.snapshots()), default=0)
        for rec in self.journal.iter_records():
            head = max(head, int(rec["rv"]))
        return head

    def snapshot_rvs(self) -> list:
        """rvs of the on-disk snapshot generations (time-travel anchor
        points), ascending."""
        return [rv for rv, _ in self.journal.snapshots()]

    def _full_history(self) -> bool:
        """Whether the retained WAL files reach back to rv 0 (journal
        birth generation still on disk — no checkpoint ever pruned, or
        retain_all mode)."""
        wals = self.journal.wal_generations()
        return bool(wals) and wals[0][0] == 0

    def _base_for(self, rv: int) -> tuple:
        """``(base_rv, {key: obj})`` to replay from for a target rv:
        the newest parseable snapshot at or below rv, else rv 0 when the
        WAL reaches journal birth."""
        for srv, path in reversed(self.journal.snapshots()):
            if srv > rv:
                continue
            try:
                return srv, path, self.journal.read_snapshot(path)[1]
            except (OSError, ValueError, KeyError):
                continue           # torn snapshot: fall back a generation
        if self._full_history():
            return 0, None, {}
        raise HistoryUnavailable(
            f"rv {rv} predates the retained journal history (no "
            f"snapshot <= {rv} and the WAL birth generation was pruned); "
            f"run the journal with retain_all=True to keep the full "
            f"worldline")

    # -- reconstruction ----------------------------------------------------

    def at(self, rv: int) -> dict:
        """The exact ``{(kind, ns, name): obj}`` store at resourceVersion
        ``rv`` — bit-for-bit what a live store held after committing that
        rv (rvs above the head return the head world). Torn WAL tails
        are tolerated exactly like recovery."""
        rv = int(rv)
        if rv < 0:
            raise ValueError(f"rv must be >= 0, got {rv}")
        base_rv, snap_path, objs = self._base_for(rv)
        objs = dict(objs)
        counts: dict = {}
        applied_max = base_rv
        for rec in self.journal.iter_records(from_rv=base_rv, to_rv=rv,
                                             counts=counts):
            k = tuple(rec["k"])
            if rec["t"] == "c":
                objs[k] = rec["o"]
            elif rec["t"] == "d":
                objs.pop(k, None)
            applied_max = max(applied_max, int(rec["rv"]))
        self.reconstructed_from = {
            "rv": rv,
            "snapshot_rv": base_rv if snap_path is not None else None,
            "wal_records": counts.get("records", 0),
            "torn_records": counts.get("torn", 0),
            "objects": len(objs),
            "applied_rv": applied_max,
        }
        return objs

    def world_summary(self, rv: int) -> dict:
        """The console's rendering of :meth:`at`: object count, per-kind
        counts, and the reconstruction provenance (the objects themselves
        are one drill-down away via :meth:`object_history`). One WAL
        scan serves both the reconstruction and ``headRv`` — calling
        ``at(rv)`` + ``head_rv()`` would parse every retained record
        twice per console hit."""
        rv = int(rv)
        if rv < 0:
            raise ValueError(f"rv must be >= 0, got {rv}")
        base_rv, snap_path, objs = self._base_for(rv)
        objs = dict(objs)
        counts: dict = {}
        applied = 0
        applied_max = base_rv
        head = max((srv for srv, _ in self.journal.snapshots()),
                   default=0)
        for rec in self.journal.iter_records(from_rv=base_rv,
                                             counts=counts):
            r = int(rec["rv"])
            head = max(head, r)
            if r > rv:
                continue
            k = tuple(rec["k"])
            if rec["t"] == "c":
                objs[k] = rec["o"]
            elif rec["t"] == "d":
                objs.pop(k, None)
            applied += 1
            applied_max = max(applied_max, r)
        self.reconstructed_from = {
            "rv": rv,
            "snapshot_rv": base_rv if snap_path is not None else None,
            "wal_records": applied,
            "torn_records": counts.get("torn", 0),
            "objects": len(objs),
            "applied_rv": applied_max,
        }
        by_kind: dict[str, int] = {}
        for k in objs:
            by_kind[k[0]] = by_kind.get(k[0], 0) + 1
        return {
            "rv": rv,
            "headRv": head,
            "objects": len(objs),
            "byKind": dict(sorted(by_kind.items())),
            "keys": sorted(_fmt_key(k) for k in objs),
            "reconstructedFrom": dict(self.reconstructed_from),
        }

    def diff(self, rv_a: int, rv_b: int) -> dict:
        """Object-level delta between two worldline points: keys added,
        removed, and changed (any content difference) going a -> b."""
        wa, wb = self.at(rv_a), self.at(rv_b)
        added = sorted(_fmt_key(k) for k in wb if k not in wa)
        removed = sorted(_fmt_key(k) for k in wa if k not in wb)
        changed = sorted(_fmt_key(k) for k in wb
                         if k in wa and wa[k] != wb[k])
        return {
            "fromRv": int(rv_a), "toRv": int(rv_b),
            "added": added, "removed": removed, "changed": changed,
            "unchanged": len(wb) - len(added) - len(changed),
        }

    # -- per-object history ------------------------------------------------

    def object_history(self, kind: str, namespace: str,
                       name: str) -> list:
        """Every retained commit/delete of one object, rv-ordered:
        ``{"rv", "ts", "op", "generation", "changed"}`` where ``op`` is
        create/update/delete, ``ts`` is the WAL record's store-clock
        stamp (None for pre-forensics records), and ``changed`` names
        which of spec/status/metadata moved vs the previous retained
        version. History starts at the oldest reconstructible world —
        an object born before the horizon opens with a synthetic
        ``op: "snapshot"`` entry (its pre-history is pruned)."""
        key = (kind, namespace, name)
        base_rv = 0
        prev: Optional[dict] = None
        if not self._full_history():
            for srv, path in self.journal.snapshots():
                try:
                    base_rv, objs = self.journal.read_snapshot(path)
                except (OSError, ValueError, KeyError):
                    continue
                prev = objs.get(key)
                break
        out = []
        if prev is not None:
            out.append({
                "rv": int((prev.get("metadata") or {})
                          .get("resourceVersion") or base_rv),
                "ts": None, "op": "snapshot",
                "generation": (prev.get("metadata") or {})
                .get("generation"),
                "changed": ["pre-history"],
            })
        for rec in self.journal.iter_records(from_rv=base_rv):
            if tuple(rec["k"]) != key:
                continue
            ts = rec.get("ts")
            if rec["t"] == "d":
                out.append({"rv": int(rec["rv"]), "ts": ts,
                            "op": "delete", "generation": None,
                            "changed": []})
                prev = None
                continue
            obj = rec["o"]
            if prev is None:
                op = "create"
                changed = []
            else:
                op = "update"
                changed = []
                if obj.get("spec") != prev.get("spec"):
                    changed.append("spec")
                if obj.get("status") != prev.get("status"):
                    changed.append("status")
                if not changed:
                    body = {k: v for k, v in obj.items()
                            if k not in ("metadata", "spec", "status")}
                    prev_body = {k: v for k, v in prev.items()
                                 if k not in ("metadata", "spec",
                                              "status")}
                    changed.append("other" if body != prev_body
                                   else "metadata")
            out.append({"rv": int(rec["rv"]), "ts": ts, "op": op,
                        "generation": (obj.get("metadata") or {})
                        .get("generation"),
                        "changed": changed})
            prev = obj
        return out
