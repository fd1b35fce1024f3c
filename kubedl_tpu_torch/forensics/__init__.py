"""Fleet flight recorder: WAL time-travel and causal incident forensics.

The rig can injure itself (chaos campaigns, docs/chaos.md) and detect
the injury (SLO pages, docs/slo.md); this package explains it. Three
layers, all pure reads over state the system already records:

* :mod:`worldline` — a :class:`WorldLine` over a journal directory
  (docs/durability.md) reconstructs the exact store at ANY
  resourceVersion (newest snapshot <= rv + WAL replay of the tail,
  riding ``Journal.iter_records``), diffs two rvs, and emits a
  per-object commit history with the WAL's ``ts`` timestamps.
* :mod:`timeline` — an :class:`IncidentTimeline` merges a campaign's
  fingerprinted fault actions, SLO fire/clear transitions,
  chaos-attributed preemptions, and lifecycle-trace restart rounds into
  one time-ordered stream, then causally links each SLO page to the
  fault window(s) overlapping its burn window and the specific jobs
  whose bad samples drove the burn.
* :mod:`report` — a deterministic postmortem (JSON + rendered markdown)
  per campaign, folded into the adversarial scorecard as its
  ``forensics`` block (``make postmortem`` renders the committed one).

docs/forensics.md has the WorldLine contract, the timeline grammar, the
causal-linking rules, and the postmortem schema.

Copied from ``kubedl_tpu/forensics/__init__.py`` (the port imports nothing of the JAX package).
"""

from .worldline import HistoryUnavailable, WorldLine  # noqa: F401
from .timeline import IncidentTimeline  # noqa: F401
from .report import build_postmortem, render_postmortem_md  # noqa: F401
