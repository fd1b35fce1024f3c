"""Standard 5-field cron schedule parser (robfig/cron `ParseStandard`
analog used by the reference's cron engine, ``controllers/apps/
cron_controller.go:179``).

Supports ``minute hour day-of-month month day-of-week`` with ``*``,
``*/step``, ``a-b``, ``a-b/step``, comma lists, month/day names, and the
``@hourly``-style descriptors. Day-of-month and day-of-week combine with OR
when both are restricted (POSIX cron semantics).

Copied from ``kubedl_tpu/utils/cronschedule.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import calendar
import time
from dataclasses import dataclass

_DESCRIPTORS = {
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
    "@monthly": "0 0 1 * *",
    "@weekly": "0 0 * * 0",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}

_MONTH_NAMES = {name.lower(): i for i, name in enumerate(calendar.month_abbr) if name}
_DAY_NAMES = {name.lower(): i for i, name in enumerate(
    ["sun", "mon", "tue", "wed", "thu", "fri", "sat"])}

_BOUNDS = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


class InvalidSchedule(ValueError):
    pass


def _parse_field(field: str, lo: int, hi: int, names: dict) -> frozenset:
    out = set()
    for part in field.split(","):
        part = part.strip()
        if not part:
            raise InvalidSchedule(f"empty cron field element in {field!r}")
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            if not step_s.isdigit() or int(step_s) == 0:
                raise InvalidSchedule(f"bad step {step_s!r}")
            step = int(step_s)
        if part == "*" or part == "":
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = _resolve(a, names), _resolve(b, names)
        else:
            start = end = _resolve(part, names)
            if step > 1:  # "N/step" means "N-hi/step" in vixie cron
                end = hi
        top = 7 if names is _DAY_NAMES else hi  # "5-7" (Fri-Sun) is valid
        if not (lo <= start <= top and lo <= end <= top and start <= end):
            raise InvalidSchedule(
                f"field {field!r} out of range [{lo},{top}]")
        values = range(start, end + 1, step)
        if names is _DAY_NAMES:
            out.update(v % 7 for v in values)  # 7 == Sunday == 0
        else:
            out.update(values)
    return frozenset(out)


def _resolve(token: str, names: dict) -> int:
    token = token.strip().lower()
    if token.isdigit():
        return int(token)  # dow 7 (Sunday) is folded to 0 by the caller
    if names and token in names:
        return names[token]
    raise InvalidSchedule(f"bad cron token {token!r}")


@dataclass(frozen=True)
class Schedule:
    minutes: frozenset
    hours: frozenset
    dom: frozenset
    months: frozenset
    dow: frozenset
    dom_star: bool
    dow_star: bool

    def _day_matches(self, t: time.struct_time) -> bool:
        # POSIX: if both dom and dow are restricted, either may match
        dom_ok = t.tm_mday in self.dom
        dow_ok = (t.tm_wday + 1) % 7 in self.dow  # struct_time: Mon=0
        if self.dom_star:
            return dow_ok
        if self.dow_star:
            return dom_ok
        return dom_ok or dow_ok

    def matches(self, ts: float) -> bool:
        t = time.localtime(ts)
        return (t.tm_min in self.minutes and t.tm_hour in self.hours
                and t.tm_mon in self.months and self._day_matches(t))

    def next_after(self, ts: float, horizon_days: int = 366 * 4) -> float:
        """Earliest fire time strictly after ``ts``. Raises if none within
        the horizon (e.g. Feb 30)."""
        # round up to the next whole minute
        t = int(ts // 60 + 1) * 60
        limit = t + horizon_days * 86400
        while t < limit:
            st = time.localtime(t)
            if st.tm_mon not in self.months:
                # jump to the 1st of the next month
                y, mo = st.tm_year, st.tm_mon + 1
                if mo > 12:
                    y, mo = y + 1, 1
                t = time.mktime((y, mo, 1, 0, 0, 0, 0, 1, -1))
                continue
            if not self._day_matches(st):
                t = time.mktime((st.tm_year, st.tm_mon, st.tm_mday + 1,
                                 0, 0, 0, 0, 1, -1))
                continue
            if st.tm_hour not in self.hours:
                t = time.mktime((st.tm_year, st.tm_mon, st.tm_mday,
                                 st.tm_hour + 1, 0, 0, 0, 1, -1))
                continue
            if st.tm_min not in self.minutes:
                t += 60
                continue
            return float(t)
        raise InvalidSchedule("no matching time within horizon")


def parse(schedule: str) -> Schedule:
    schedule = schedule.strip()
    if schedule.lower() in _DESCRIPTORS:
        schedule = _DESCRIPTORS[schedule.lower()]
    fields = schedule.split()
    if len(fields) != 5:
        raise InvalidSchedule(
            f"expected 5 cron fields, got {len(fields)}: {schedule!r}")
    names = [None, None, None, _MONTH_NAMES, _DAY_NAMES]
    sets = [_parse_field(f, lo, hi, nm)
            for f, (lo, hi), nm in zip(fields, _BOUNDS, names)]
    return Schedule(minutes=sets[0], hours=sets[1], dom=sets[2],
                    months=sets[3], dow=sets[4],
                    dom_star=fields[2] == "*", dow_star=fields[4] == "*")
