"""Deterministic campaign postmortems: JSON block + rendered markdown.

:func:`build_postmortem` folds one campaign replay's timeline document
(:mod:`timeline`) together with the campaign identity into the
``forensics`` block the adversarial scorecard commits per seed
(docs/chaos.md, docs/forensics.md "postmortem schema") — floats rounded,
keys sorted at serialization, no wall clocks, so a fixed seed reproduces
it bit for bit and the in-run determinism gate covers it for free.

:func:`render_postmortem_md` renders one block as a human postmortem;
``python -m kubedl_tpu_torch.forensics.report [ARTIFACT.json]`` renders every
seed of a committed ``BENCH_CLUSTER_ADVERSARIAL.json`` (the ``make
postmortem`` target).

Copied from ``kubedl_tpu/forensics/report.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional


def build_postmortem(scenario: str, seed: int, fingerprint: str,
                     timeline_doc: dict,
                     slo_health: Optional[dict] = None) -> dict:
    """One seed's forensics block: campaign identity + the merged
    timeline + its incident table and link summary. ``slo_health`` is
    the replay's stranded/budget rollup, embedded so the rendered
    postmortem is self-contained."""
    return {
        "scenario": scenario,
        "seed": int(seed),
        "campaign_fingerprint": fingerprint,
        "summary": dict(timeline_doc["summary"]),
        "incidents": list(timeline_doc["incidents"]),
        "timeline": list(timeline_doc["entries"]),
        "slo_health": dict(slo_health or {}),
    }


def _fmt_t(t) -> str:
    if t is None:
        return "-"
    t = float(t)
    h, rem = divmod(int(round(t)), 3600)
    mnt, s = divmod(rem, 60)
    return f"{h:d}:{mnt:02d}:{s:02d}"


def _fmt_params(params) -> str:
    return ", ".join(f"{k}={v}" for k, v in params) if params else ""


def render_postmortem_md(pm: dict) -> str:
    """Markdown postmortem for one seed's forensics block. Pure
    function of the block — rendering the committed artifact twice
    yields identical bytes."""
    s = pm["summary"]
    lines = [
        f"# Postmortem: `{pm['scenario']}` campaign, seed {pm['seed']}",
        "",
        f"Campaign fingerprint: `{pm['campaign_fingerprint'][:16]}`",
        "",
        "## Summary",
        "",
        f"- **{s['pages']} page(s)** fired ({s['incidents']} alert "
        f"onsets total), {s['pages_linked']} causally linked to "
        f"injected faults, {s['pages_unlinked']} unlinked",
        f"- {s['faults']} fault actions across {s['fault_windows']} "
        f"windows; {s['preemptions']} gang preemptions; "
        f"{s['restart_rounds']} restart rounds",
        f"- {s['bad_samples']} bad SLO samples attributed; "
        f"{s['unresolved_incidents']} incident(s) never cleared",
    ]
    health = pm.get("slo_health") or {}
    if health:
        lines.append(
            f"- budgets survived: min remaining "
            f"{health.get('min_budget_remaining')}, stranded alerts "
            f"{health.get('stranded_alerts')}, stranded conditions "
            f"{health.get('stranded_conditions')}")
    lines += ["", "## Incidents", ""]
    if not pm["incidents"]:
        lines.append("None fired.")
    for i, inc in enumerate(pm["incidents"], 1):
        lines += [
            f"### {i}. `{inc['slo']}` {inc['severity']} at "
            f"{_fmt_t(inc['firedAt'])}",
            "",
            f"- fired {_fmt_t(inc['firedAt'])}, cleared "
            f"{_fmt_t(inc['clearedAt'])}"
            + (f" ({_fmt_t(inc['durationS'])} on fire)"
               if inc['durationS'] is not None else " (never cleared)"),
            f"- burn at onset: short {inc['shortBurn']}, long "
            f"{inc['longBurn']}; {inc['badSamplesInWindow']} bad "
            f"sample(s) in the burn window",
        ]
        if inc["links"]:
            lines.append("- caused by:")
            for lk in inc["links"]:
                jobs = (f" (evidence: {', '.join(lk['evidenceJobs'])})"
                        if lk["evidenceJobs"] else "")
                window = (f"{_fmt_t(lk['windowStart'])}"
                          + (f"–{_fmt_t(lk['windowEnd'])}"
                             if lk["windowEnd"] is not None
                             and lk["windowEnd"] != lk["windowStart"]
                             else ""))
                lines.append(f"  - `{lk['primitive']}` [{window}] via "
                             f"rule `{lk['rule']}`{jobs}")
        elif inc["severity"] == "page":
            lines.append("- **UNLINKED**: no injected fault explains "
                         "this page (investigate)")
        lines.append("")
    lines += ["## Timeline", "",
              "| t | type | detail |", "|---|---|---|"]
    for e in pm["timeline"]:
        if e["type"] == "fault":
            detail = f"`{e['primitive']}` {_fmt_params(e['params'])}"
        elif e["type"] == "preemption":
            detail = f"gang `{e['job']}` evicted by `{e['primitive']}`"
        elif e["type"] == "restart":
            detail = f"`{e['job']}` restart round ({e['durationS']}s)"
        else:
            detail = (f"`{e['slo']}` {e['severity']} {e['event']} "
                      f"(burn short={e['shortBurn']} "
                      f"long={e['longBurn']})")
        lines.append(f"| {_fmt_t(e['t'])} | {e['type']} | {detail} |")
    lines.append("")
    return "\n".join(lines)


def render_artifact(doc: dict) -> str:
    """Render every seed's forensics block of a committed adversarial
    scorecard (``BENCH_CLUSTER_ADVERSARIAL.json``) into one markdown
    document."""
    out = []
    seeds = doc.get("seeds") or {}
    # seed keys are stringified ints; lexicographic order would put
    # "10" before "2"
    for seed in sorted(seeds, key=int):
        pm = seeds[seed].get("forensics")
        if not pm:
            out.append(f"# seed {seed}: no forensics block (regenerate "
                       f"with `make bench-cluster-adversarial`)\n")
            continue
        out.append(render_postmortem_md(pm))
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        description="Render the committed adversarial scorecard's "
                    "forensics blocks as markdown postmortems "
                    "(docs/forensics.md).")
    ap.add_argument("artifact", nargs="?",
                    default="BENCH_CLUSTER_ADVERSARIAL.json")
    ap.add_argument("--out", default=None,
                    help="write here instead of stdout")
    args = ap.parse_args(argv)
    with open(args.artifact) as f:
        doc = json.load(f)
    text = render_artifact(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
