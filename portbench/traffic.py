"""The one traffic generator: every mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads.

Every seed gets the same work, in another order. Lengths are the
quantiles of their clipped lognormal at evenly spaced probabilities, and
arrival gaps the quantiles of the exponential at the cell's rate; the seed
only permutes them and draws the token ids. So two seeds differ in order
and ids, and not in how much there is to do.

Mixes (``kind``):

* ``"documents"``: ``{"length": {...}}``, training documents, packed into
  rows by :func:`pack_rows` (the rows ``train.data.pack_documents`` of the
  port yields);
* ``"requests"``: served requests, ``{"arrival": {...}, "prompt": {...},
  "output": {...}, "lead_s": s}`` and optionally ``"prefix": {"length":
  {...}, "asks": n}``. Arrivals (``arrival.kind``):

  - ``"poisson"``: an open loop at the cell's rate (its file's
    ``rate_per_s``);
  - ``"bursts"`` with ``on_s`` and ``off_s``: the same open loop with its
    arrivals pressed into the on phases (at ``(on_s + off_s) / on_s``
    times the rate), each part of the schedule starting with one;
  - ``"closed"`` with ``clients``: a closed loop, each client sending its
    next request when its last one finishes.

  With ``prefix``, every ``asks`` consecutive requests share a prefix (a
  document asked several times): the prompt is the group's prefix, of a
  length drawn from ``prefix.length``, then ids of its own, of a length
  drawn from ``prompt``.

A length is ``{"median", "sigma", "min", "max"}``. An unknown kind raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist

import numpy as np

#: how many lengths one permuted block of a stream holds
BLOCK = 256
#: the arrival kinds of a ``requests`` mix; the first two are open loops
ARRIVALS = ("poisson", "bursts", "closed")


def kind(mix: dict, want: str) -> None:
    """Raise unless the mix is of kind ``want`` (and, for ``requests``,
    its arrivals of a kind in :data:`ARRIVALS`)."""
    if mix.get("kind") != want:
        raise ValueError(f"the mix is of kind {mix.get('kind')!r}; this "
                         f"cell reads {want!r} mixes")
    if want == "requests" and mix["arrival"]["kind"] not in ARRIVALS:
        raise ValueError(f"unknown arrival kind {mix['arrival']['kind']!r}; "
                         f"the generator knows {ARRIVALS}")


def arrival(mix: dict) -> str:
    """The mix's arrival kind, one of :data:`ARRIVALS`."""
    kind(mix, "requests")
    return mix["arrival"]["kind"]


def is_closed(mix: dict) -> bool:
    return arrival(mix) == "closed"


def prompt_range(mix: dict) -> tuple:
    """The shortest and the longest prompt the mix sends."""
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    if "prefix" in mix:
        lo += mix["prefix"]["length"]["min"]
        hi += mix["prefix"]["length"]["max"]
    return lo, hi


def lognormal_set(n: int, dist: dict) -> np.ndarray:
    """``n`` lengths: the lognormal's quantiles at (i + 0.5) / n, rounded
    and clipped to [min, max]."""
    nd = NormalDist()
    mu = math.log(dist["median"])
    q = [math.exp(mu + dist["sigma"] * nd.inv_cdf((i + 0.5) / n))
         for i in range(n)]
    return np.clip(np.rint(q), dist["min"], dist["max"]).astype(np.int64)


def exponential_gaps(n: int, span: float) -> np.ndarray:
    """``n`` gaps: the exponential's quantiles at (i + 0.5) / n, scaled so
    that they add up to ``span`` seconds."""
    g = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    return g * (span / g.sum())


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def length_stream(dist: dict, seed: int, stream: int):
    """Endless lengths: blocks of ``BLOCK`` quantiles, each permuted by the
    seed."""
    base = lognormal_set(BLOCK, dist)
    for block in range(10**9):
        yield from rng(seed, stream, block).permutation(base).tolist()


# -- training documents ------------------------------------------------------

def documents(mix: dict, vocab: int, seed: int):
    """Endless documents of random ids in [0, vocab)."""
    kind(mix, "documents")
    ids = rng(seed, 1)
    for n in length_stream(mix["length"], seed, 0):
        yield ids.integers(0, vocab, n, dtype=np.int64)


def pack_rows(docs, seq_len: int, batch: int):
    """Endless packed batches ``{tokens, targets, segment_ids, positions,
    mask}`` of ``[batch, seq_len]`` int64 (``mask`` bool), built as the
    Python loop of the port's ``train.data.pack_documents`` builds them
    (greedy, documents longer than ``seq_len + 1`` split into chunks,
    segment ids per row from 0, pads -1, positions from 0 per document,
    the loss masked where the pair crosses a document or touches a pad)."""
    seq1 = seq_len + 1
    rows, row, seg_row, pos_row, seg_id = [], [], [], [], 0

    def flush():
        nonlocal row, seg_row, pos_row, seg_id
        pad = seq1 - len(row)
        rows.append((row + [0] * pad, seg_row + [-1] * pad,
                     pos_row + [0] * pad))
        row, seg_row, pos_row, seg_id = [], [], [], 0

    for doc in docs:
        doc = doc.tolist()
        for start in range(0, len(doc), seq1):
            chunk = doc[start:start + seq1]
            if len(chunk) < 2:
                continue
            if len(row) + len(chunk) > seq1:
                flush()
            row.extend(chunk)
            seg_row.extend([seg_id] * len(chunk))
            pos_row.extend(range(len(chunk)))
            seg_id += 1
            if len(row) == seq1:
                flush()
            while len(rows) >= batch:
                out, rows = rows[:batch], rows[batch:]
                toks = np.asarray([r[0] for r in out], np.int64)
                seg = np.asarray([r[1] for r in out], np.int64)
                pos = np.asarray([r[2] for r in out], np.int64)
                yield {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                       "segment_ids": seg[:, :-1], "positions": pos[:, :-1],
                       "mask": (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] >= 0)}


# -- served requests ---------------------------------------------------------

@dataclass
class Req:
    """One request: its prompt ids, how many tokens it asks for, when it
    is due (seconds from the start of traffic; None in a closed loop) and
    whether its arrival falls in the measured window."""
    ident: int
    prompt: list
    max_new: int
    due: float | None = None
    counted: bool = False
    # filled by the driver
    token_times: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    handle: object = None
    finished: bool = False
    error: str = ""


def _req(mix: dict, vocab: int, seed: int, i: int, plen: int, olen: int,
         due=None, counted=False, prefix=()) -> Req:
    ids = rng(seed, 2, i).integers(0, vocab, plen, dtype=np.int64).tolist()
    return Req(ident=i, prompt=list(prefix) + ids, max_new=int(olen),
               due=due, counted=counted)


def _prefix_ids(vocab: int, seed: int, stream, group: int, n: int) -> list:
    return rng(seed, 10, *stream, group).integers(
        0, vocab, n, dtype=np.int64).tolist()


def _part_prefixes(mix: dict, vocab: int, seed: int, part: int,
                   n: int) -> list:
    """The shared prefix of each of a part's ``n`` requests (empty without
    ``prefix``): every ``asks`` consecutive ones share one, its length a
    permuted quantile of ``prefix.length`` over the part's groups."""
    if "prefix" not in mix:
        return [()] * n
    asks = int(mix["prefix"]["asks"])
    groups = -(-n // asks)
    lens = rng(seed, 11, part).permutation(
        lognormal_set(groups, mix["prefix"]["length"]))
    ids = [_prefix_ids(vocab, seed, (part,), g, int(lens[g]))
           for g in range(groups)]
    return [ids[j // asks] for j in range(n)]


def _bursts(due: np.ndarray, t0: float, on_s: float, off_s: float):
    """Arrival times from ``t0`` pressed into on phases: the time ``t``
    after ``t0`` goes to its period's start plus its place in the period
    scaled to the on phase."""
    period = on_s + off_s
    rel = due - t0
    return t0 + np.floor(rel / period) * period + \
        np.mod(rel, period) * (on_s / period)


def open_loop(mix: dict, rate: float, seconds: float, vocab: int, seed: int,
              tail_s: float):
    """An open loop at a mean of ``rate`` requests a second: a lead of
    ``mix["lead_s"]`` seconds, the window of ``seconds`` (its requests
    ``counted``), then a tail of ``tail_s`` seconds that keeps the load on
    while the counted requests drain. Each part holds round(rate * length)
    requests (with ``prefix``, rounded to whole groups of ``asks``) whose
    gaps add up to its length, so the window always holds
    the same requests' sizes and gaps, in the seed's order; ``bursts``
    then presses each part's arrivals into its on phases."""
    a = arrival(mix)
    if a == "closed":
        raise ValueError("a closed-loop mix has no arrival schedule")
    out, t0, i = [], 0.0, 0
    parts = [(mix["lead_s"], False), (seconds, True), (tail_s, False)]
    asks = int(mix["prefix"]["asks"]) if "prefix" in mix else 1
    for k, (span, counted) in enumerate(parts):
        n = asks * max(1, round(rate * span / asks))
        r = rng(seed, 3, k)
        gaps = r.permutation(exponential_gaps(n, span))
        plens = r.permutation(lognormal_set(n, mix["prompt"]))
        olens = r.permutation(lognormal_set(n, mix["output"]))
        due = t0 + np.cumsum(gaps) - gaps          # in [t0, t0 + span)
        if a == "bursts":
            due = _bursts(due, t0, mix["arrival"]["on_s"],
                          mix["arrival"]["off_s"])
        prefixes = _part_prefixes(mix, vocab, seed, k, n)
        for j in range(n):
            out.append(_req(mix, vocab, seed, i, int(plens[j]),
                            int(olens[j]), float(due[j]), counted,
                            prefixes[j]))
            i += 1
        t0 += span
    return out


def closed_loop(mix: dict, vocab: int, seed: int):
    """Endless requests for a closed loop, in the order clients take them."""
    if not is_closed(mix):
        raise ValueError("an open-loop mix is not a closed loop")
    plens = length_stream(mix["prompt"], seed, 4)
    olens = length_stream(mix["output"], seed, 5)
    asks = int(mix["prefix"]["asks"]) if "prefix" in mix else 0
    if asks:
        prefix_lens = length_stream(mix["prefix"]["length"], seed, 12)
    prefix = ()
    for i in range(10**9):
        if asks and i % asks == 0:
            prefix = _prefix_ids(vocab, seed, (), i // asks,
                                 next(prefix_lens))
        yield _req(mix, vocab, seed, i, next(plens), next(olens),
                   prefix=prefix)
