"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference (``reference/``).

Training (the first steps the set-up drove through the window's own
``Trainer.step`` and feed):

* ``loss_gap``: the largest gap between the program's and the reference's
  loss over the steps, as a share of the reference's;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient as its optimizer took it (its first moment
  after one step over 1 - beta1) and the reference's, against the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap``: the same for the norm of each leaf's change over the
  steps, leaving out the leaves whose reference gradient is nought to
  rounding (under a thousandth of the median leaf's: under Adam they move
  by round-off alone, as a key bias does under softmax).

Serving (a sample of the finished requests drawn from the seed, the
longest among them, each by a run of its served tokens; ``serve_cell.
sample``):

* ``logit_gap``: the widest gap by which a served token's logit lies below
  the reference's best at its position, the reference run once over each
  prompt and its served tokens;
* ``logit_gap_mean``: the mean of those gaps over the sample's served
  tokens (the Mixtral cell's number: a bfloat16 router flips its choice
  of experts near a tie, so its widest gap swings as widely as the
  control's, PERF.md).

A cell's ``limits`` name the numbers it compares.
"""

from __future__ import annotations

import statistics


def _worst(prog: dict, ref: dict, leaves) -> float:
    floor = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves)


def training(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``{"loss": [...], "grad_norm": {leaf: x},
    "change": {leaf: x}}``; ``ref`` also ``raw_grad_norm``."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                      ref["loss"]))
    raw = ref["raw_grad_norm"]
    floor = statistics.median(raw.values())
    moved = [k for k in ref["change"] if raw[k] >= 1e-3 * floor]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(prog["grad_norm"], ref["grad_norm"],
                               ref["grad_norm"]),
            "change_gap": _worst(prog["change"],
                                 {k: ref["change"][k] for k in moved},
                                 moved)}


def served_gaps(logits_rows, served) -> list:
    """Per position: the reference's best logit less the served token's."""
    best = logits_rows.max(dim=-1).values
    got = logits_rows.gather(-1, served[:, None])[:, 0]
    return (best - got).tolist()
