"""The readings the limits and the chat cell's rate are set from; not run
by the benchmark's own runs.

    python -m portbench.calibrate readings --workload <cell> --seeds 1,2,3 \
        [--seconds 5] [--control-seeds 1,2,3]
    python -m portbench.calibrate sweep --workload <cell> --rates 2,4,6 \
        --seconds 20 --seed 1

``readings`` prints one JSON line per seed with the numbers ``check.py``
compares, for the program (the lower reading of each limit) and, on the
``--control-seeds``, for the control (the reference in float8 e4m3, the
precision below the configuration's bfloat16: the upper reading) and for
the planted faults a cell can have:

* training: half of every batch left out, the mean over the rest (the
  program with ``batch_rows`` = batch / 2); a step that returns its state
  unchanged reads 1 on ``change_gap`` by the measure and needs no run;
* serving: a token altered where it is produced, read as the gap of the
  next id in place of each compared token of the sample (the least, the
  mean with every token altered, and the least mean with one altered).

A serving seed runs the cell's traffic for a short window (``--seconds``)
at the cell's own load, drains it, and holds the sample as a run does.

``sweep`` builds the chat engine once a rate and offers each rate for one
window after the lead (``--lead``, long enough for the longest requests to
fill the lanes): the offered rate, the completed rate (requests finished
inside the window over its seconds), the queue at the window's start and
end and the median TTFT, one JSON line a rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

from . import check, run as runmod, serve_cell, spec, traffic, train_cell
from .profile import Profiled, free


def _run(name: str, seed: int, seconds: float):
    import torch
    bench, w, cell, mix, cfg = runmod.load(name)
    return SimpleNamespace(name=name, cell=cell, mix=mix, cfg=cfg, seed=seed,
                           seconds=seconds, trace=False,
                           device=torch.device("cuda"),
                           t_start=time.perf_counter(),
                           trace_path=runmod.CACHE / "trace.json")


def train_readings(run, control: bool) -> dict:
    stream = train_cell.feed(run)
    checked = [next(stream) for _ in range(run.cell["check_steps"])]
    trainer, state = train_cell.build(run)
    _, prog = train_cell.first_steps(run, trainer, state, checked)
    del trainer, state, _
    free(run.device)
    out = {}
    if control:
        half = run.cell["batch"] // 2
        trainer, state = train_cell.build(run, batch_rows=half)
        _, faulty = train_cell.first_steps(run, trainer, state, checked)
        del trainer, state, _
        free(run.device)
    ref = train_cell.reference(run, checked)
    out["program"] = check.training(prog, ref)
    out["loss"] = {"program": prog["loss"], "reference": ref["loss"]}
    if control:
        from .reference import train as ref_train
        from . import weights
        low = ref_train.run(run.cfg, run.seed, checked,
                            dict(run.cell["optimizer"], eps=1e-8),
                            weights.make_leaf, run.device, precision="fp8")
        out["control"] = check.training(low, ref)
        out["half_batch"] = check.training(faulty, ref)
    worst = {}
    for k in ("grad_norm", "change"):
        floor = sorted(ref[k].values())[len(ref[k]) // 2]
        worst[k] = sorted(((abs(prog[k][p] - ref[k][p])
                            / max(ref[k][p], floor), p) for p in ref[k]),
                          reverse=True)[:3]
    out["worst_leaves"] = worst
    return out


def serve_readings(run, control: bool) -> dict:
    import torch
    picked = served_sample(run)
    precisions = ("f32", "fp8") if control else ("f32",)
    gaps = serve_cell.reference_gaps(run, picked, precisions)
    out = {"program": max(gaps["f32"]), "tokens": len(gaps["f32"]),
           "requests": len(picked),
           "program_p99": float(torch.tensor(gaps["f32"]).quantile(0.99)),
           "program_mean": sum(gaps["f32"]) / len(gaps["f32"])}
    if control:
        out["control"] = max(gaps["fp8"])
        out["control_p99"] = float(torch.tensor(gaps["fp8"]).quantile(0.99))
        out["control_mean"] = sum(gaps["fp8"]) / len(gaps["fp8"])
        alt = altered_gaps(run, picked)
        prog = gaps["f32"]
        out["altered_token"] = min(alt)
        out["altered_mean"] = sum(alt) / len(alt)
        # the mean when one compared token is altered, at its least
        out["one_altered_mean"] = (sum(prog) + min(
            a - g for a, g in zip(alt, prog))) / len(prog)
    return out


def served_sample(run) -> list:
    """The sample a run of the cell holds to the reference, served at the
    cell's own load for a short window (and drained, in an open loop)."""
    eng, _ = serve_cell.build(run)
    client = serve_cell.Client(eng, time.perf_counter())
    win = serve_cell.Window(run, client, Profiled(False, run.trace_path))
    eng.start()
    try:
        reqs = serve_cell.drive(run, client, win)
        picked = serve_cell.sample(run, [r for r in client.done
                                         if r.counted or reqs is None])
    finally:
        eng.stop()
    del eng
    client.eng = None
    free(run.device)
    return picked


def serve_look(run) -> dict:
    return router_look(run, served_sample(run))


def router_look(run, picked: list) -> dict:
    """Mixtral: where the sample's gaps lie against the float32
    reference's least router margin over the layers at each position (the
    k-th expert's probability less the next one's). For each margin floor,
    the share of positions below it and the widest gap above it, of the
    program's served token, of the control's first token and of the next
    id in place of the served one (an altered token)."""
    import torch
    from . import weights
    from .reference.model import Leaves, final_hidden, head, mm
    leaves = Leaves(run.cfg, run.seed, run.device, weights.make_leaf)
    seqs = [r.prompt + r.tokens[:-1] for r in picked]
    margins: list = []
    hidden = final_hidden(run.cfg, leaves, seqs, margins=margins)
    low = final_hidden(run.cfg, leaves, seqs, "fp8")
    leaves.close()
    w = head(run.cfg, leaves)
    rows = []
    with torch.no_grad():
        for j, r in enumerate(picked):
            at, toks = serve_cell.compared(r)
            ref = hidden[j][at] @ w
            served = torch.as_tensor(toks, device=w.device)
            prog = check.served_gaps(ref, served)
            ctrl = check.served_gaps(ref, mm(low[j][at], w, "fp8").argmax(-1))
            alt = check.served_gaps(ref, (served + 1) % run.cfg["vocab_size"])
            rows += list(zip(prog, ctrl, alt, margins[j][at].tolist()))
    out = {"widest": sorted(rows, reverse=True)[:6]}
    for floor in (1e-4, 1e-3, 3e-3, 1e-2):
        kept = [r for r in rows if r[3] >= floor]
        out[f"{floor:g}"] = {
            "excused": 1 - len(kept) / len(rows),
            "program": max(r[0] for r in kept),
            "control": max(r[1] for r in kept),
            "altered_least": min(r[2] for r in kept)}
    return out


def altered_gaps(run, picked: list) -> list:
    """Every compared position's gap when its served token is replaced by
    the next id: the least is what one altered token reads at best."""
    altered = [SimpleNamespace(prompt=r.prompt, lo=r.lo, tokens=[
        (t + 1) % run.cfg["vocab_size"] for t in r.tokens]) for r in picked]
    return serve_cell.reference_gaps(run, altered)["f32"]


def sweep(args) -> None:
    import torch
    run = _run(args.workload, args.seed, args.seconds)
    if args.lead is not None:
        run.mix = dict(run.mix, lead_s=args.lead)
    for rate in [float(x) for x in args.rates.split(",")]:
        eng, _ = serve_cell.build(run)
        client = serve_cell.Client(eng, time.perf_counter())
        win = serve_cell.Window(run, client, Profiled(False, run.trace_path))
        eng.start()
        reqs = traffic.open_loop(run.mix, rate, run.seconds,
                                 run.cfg["vocab_size"], run.seed, 0.0)
        pending = list(reqs)
        try:
            while win.state != "after":
                now = client.now()
                while pending and pending[0].due <= now:
                    client.submit(pending.pop(0))
                client.poll()
                win.step(now)
                time.sleep(serve_cell.POLL_S)
        finally:
            eng.stop()
        client.eng = None
        done = sum(1 for r in client.done
                   if r.token_times and win.t0 <= r.token_times[-1] < win.t1)
        offered = sum(1 for r in reqs if r.counted)
        ttft = sorted(r.token_times[0] - r.due for r in reqs
                      if r.counted and r.token_times)
        print(json.dumps({"rate": rate, "offered_per_s": offered / run.seconds,
                          "completed_per_s": done / run.seconds,
                          "queue_start": win.queue[0],
                          "queue_end": win.queue[1],
                          "ttft_p50_s": ttft[len(ttft) // 2] if ttft
                          else None}), flush=True)
        del eng
        free(run.device)
        torch.cuda.reset_peak_memory_stats()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("mode", choices=("readings", "sweep"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--lead", type=float, default=None,
                   help="sweep: seconds of traffic before each window")
    p.add_argument("--look", default="",
                   help="seeds of a Mixtral cell to run router_look on")
    args = p.parse_args(argv)
    runmod.set_cache_dirs()
    from .reference.model import set_exact
    set_exact()
    if args.mode == "sweep":
        sweep(args)
        return 0
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        run = _run(args.workload, seed, args.seconds)
        t0 = time.perf_counter()
        fn = {"train_cell": train_readings,
              "serve_cell": serve_readings}[spec.driver(run.cell)]
        out = fn(run, seed in controls)
        out.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    if args.look:
        for seed in [int(s) for s in args.look.split(",")]:
            run = _run(args.workload, seed, args.seconds)
            print(json.dumps({"seed": seed, "router": serve_look(run)}),
                  flush=True)
    bad = runmod.forbidden_modules()
    if bad:
        print(f"loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
