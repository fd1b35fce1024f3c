"""Ticket semaphore (reference ``pkg/util/concurrent/concurrent.go``):
bounds fan-out of parallel operations (the elastic controller restarts
workers through one of these, ≤100 in flight) and joins them all.

Copied from ``kubedl_tpu/utils/concurrent.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from typing import Callable


class Semaphore:
    """Acquire/Release bound concurrency; Wait joins everything started."""

    def __init__(self, tickets: int):
        if tickets < 1:
            raise ValueError("tickets must be >= 1")
        self._sem = threading.Semaphore(tickets)
        self._pending = 0
        self._cond = threading.Condition()

    def acquire(self) -> None:
        self._sem.acquire()
        with self._cond:
            self._pending += 1

    def release(self) -> None:
        self._sem.release()
        with self._cond:
            self._pending -= 1
            if self._pending == 0:
                self._cond.notify_all()

    def wait(self) -> None:
        with self._cond:
            while self._pending:
                self._cond.wait()

    def go(self, fn: Callable, *args) -> threading.Thread:
        """Run ``fn`` on a thread under a ticket (acquire here so a burst
        of go() calls blocks at the bound, like the reference's usage)."""
        self.acquire()

        def run():
            try:
                fn(*args)
            finally:
                self.release()
        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t
