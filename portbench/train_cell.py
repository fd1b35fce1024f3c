"""A ``train`` cell: the port's ``Trainer.step`` on packed documents.

Set-up builds one trainer and its state (weights from the seed, Adam's
moments), and drives it through the window's own call and feed for the
first ``check_steps`` steps, on rows that all differ: they compile and
warm every shape, and their losses, the first gradient as the optimizer
took it (read from its first moment) and the change of every leaf are
kept for the check. The same object then runs the window: steps on new
batches until ``--seconds`` have passed, closed by a synchronize.
``train_tokens_per_s`` is the tokens (batch x sequence) of those steps
over the window's seconds. A traced run then traces ``TRACE_STEPS`` more
steps under the profiler (the window itself runs as in any run). After
that (the peak memory read, the program's state freed) the reference
follows the first steps in float32.
"""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

from . import check, counts, spec, traffic, weights
from .profile import Profiled, free, peak_bytes, sync
from .spec import port_config

#: the kind of traffic mix this cell reads
MIX = "documents"

#: steps a traced run traces after its window
TRACE_STEPS = 4


def trainer_config(opt: dict):
    from kubedl_tpu_torch.train.trainer import TrainConfig
    return TrainConfig(learning_rate=opt["lr"],
                       warmup_steps=opt["warmup_steps"],
                       decay_steps=opt["decay_steps"],
                       weight_decay=opt["weight_decay"], beta1=opt["beta1"],
                       beta2=opt["beta2"], grad_clip=opt["grad_clip"])


def family(cfg: dict):
    from kubedl_tpu_torch.models import llama, moe
    return {"llama": llama, "moe": moe}[spec.family(cfg)]


def feed(run) -> "iterator":
    cell = run.cell
    return traffic.pack_rows(
        traffic.documents(run.mix, run.cfg["vocab_size"], run.seed),
        cell["seq"], cell["batch"])


def build(run, batch_rows=None):
    """(trainer, state) of the cell on the seed's weights. ``batch_rows``
    keeps only the first rows of every batch (a planted fault)."""
    from kubedl_tpu_torch.train.trainer import Trainer
    cfgp = port_config(run.cfg, run.cell.get("model_overrides"))
    fam = family(run.cfg)

    def loss_fn(params, b):
        if batch_rows is not None:
            b = {k: v[:batch_rows] for k, v in b.items()}
        return fam.loss_fn(cfgp, params, b["tokens"], b["targets"],
                           mask=b["mask"], segment_ids=b["segment_ids"],
                           positions=b["positions"])

    trainer = Trainer(loss_fn, trainer_config(run.cell["optimizer"]),
                      device=run.device)
    state = trainer.init_state(weights.make_params(run.cfg, run.seed,
                                                   run.device))
    sync(run.device)
    return trainer, state


def first_steps(run, trainer, state, batches, phases=None):
    """Drive ``batches`` through ``trainer.step``: (state, readings);
    ``phases`` takes each step's seconds."""
    import torch
    from kubedl_tpu_torch.train.data import to_device
    b1 = run.cell["optimizer"]["beta1"]
    out = {"loss": [], "grad_norm": {}, "change": {}}
    for i, batch in enumerate(batches):
        t = time.perf_counter()
        state, loss = trainer.step(state, to_device(batch, run.device))
        out["loss"].append(float(loss))
        if phases is not None:
            phases[f"step{i + 1}_s"] = time.perf_counter() - t
        if i == 0:
            out["grad_norm"] = {k: float((m / (1 - b1)).double().norm())
                                for k, m in state.opt_state.mu.items()}
    from kubedl_tpu_torch.train.trainer import tree_leaves
    with torch.no_grad():
        for k, p in tree_leaves(state.params):
            p0 = weights.make_leaf(run.cfg, run.seed, k, run.device)
            out["change"][k] = float((p.detach().double()
                                      - p0.double()).norm())
    return state, out


def reference(run, batches) -> dict:
    from .reference import train as ref_train
    return ref_train.run(run.cfg, run.seed, batches,
                         dict(run.cell["optimizer"], eps=1e-8),
                         weights.make_leaf, run.device)


def run(run):
    from kubedl_tpu_torch.ops import attention
    from kubedl_tpu_torch.train.data import to_device
    cell = run.cell
    phases = dict(getattr(run, "phases", {}))
    t = time.perf_counter()
    stream = feed(run)
    checked = [next(stream) for _ in range(cell["check_steps"])]
    phases["feed_s"] = time.perf_counter() - t
    t = time.perf_counter()
    trainer, state = build(run)
    phases["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state, prog = first_steps(run, trainer, state, checked, phases)
    sync(run.device)
    phases["first_steps_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - run.t_start
    print(f"portbench: set-up phases {phases}", file=sys.stderr)

    steps, losses = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        batch = next(stream)
        state, loss = trainer.step(state, to_device(batch, run.device))
        losses.append(loss)
        steps.append(counts.kept_pairs(batch["segment_ids"]))
    sync(run.device)
    window_s = time.perf_counter() - t0
    window_losses = [float(x) for x in losses]
    peak = peak_bytes(run.device)

    # a traced run then traces TRACE_STEPS more steps
    prof = Profiled(run.trace, run.trace_path)
    traced = []
    launches0 = {k: getattr(attention, k).launches
                 for k in ("flash_forward", "flash_dq", "flash_dkv")}
    if run.trace:
        prof.prepare()
        batches = [next(stream) for _ in range(TRACE_STEPS)]
        prof.start()
        for batch in batches:
            state, loss = trainer.step(state, to_device(batch, run.device))
            traced.append(counts.kept_pairs(batch["segment_ids"]))
        prof.stop()
    launches = {k: getattr(attention, k).launches - v
                for k, v in launches0.items()}
    del trainer, state, losses
    free(run.device)

    ref = reference(run, checked)
    checks = {k: {"value": v, "limit": cell["limits"][k]}
              for k, v in check.training(prog, ref).items()}
    failed = sum(1 for x in window_losses if not math.isfinite(x))
    checks["failed_steps"] = {"value": failed, "limit": 0}
    tokens = cell["batch"] * cell["seq"] * len(steps)
    ctx = SimpleNamespace(
        kind="train", cfg=run.cfg, cell=cell, trace=prof.trace,
        window_s=window_s, steps=steps, traced_steps=traced,
        launches=launches, batch=cell["batch"], seq=cell["seq"],
        memory_peak=peak)
    return SimpleNamespace(
        e2e={"setup_s": setup_s, "train_tokens_per_s": tokens / window_s},
        checks=checks, attempted=len(steps), failed=failed, ctx=ctx,
        readings={"program": prog, "reference": ref})
