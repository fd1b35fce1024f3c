"""Training container entrypoint: ``python -m kubedl_tpu_torch.train``.

The counterpart of ``python -m kubedl_tpu.train`` on one card: a
config-driven training job (model preset, data source, optimizer, model
export) with no train.py of its own. Config is JSON, ``--config
/path.json`` or inline in ``$KUBEDL_TRAIN_CONFIG``:

    {"model": "llama.llama3_8b", "model_overrides": {"n_layers": 8},
     "mode": "pretrain", "data": {"kind": "synthetic"},
     "batch": 4, "seq": 2048, "steps": 100,
     "optimizer": {"learning_rate": 3e-4, "warmup_steps": 10},
     "export_path": "/models/out"}

``model`` is ``llama.<preset>`` (``llama3_8b``, ``llama2_7b``,
``mistral_7b``, ``qwen2_7b``, ``tiny``), ``gemma.<preset>``
(``gemma_2b``, ``gemma_7b``, ``gemma2_2b``, ``tiny``), ``moe.<preset>``
(``mixtral_8x7b``, ``tiny``: the loss adds the router's load-balancing
term) or ``{"model_path": dir}`` to fine-tune a saved artifact;
``model_overrides``
replaces any config field, and ``loss_chunk`` defaults to 512 (the
chunked LM-head loss) unless overridden. ``mode`` is ``pretrain``
(next-token loss; data ``synthetic``, a ``tokens`` memmap file,
``text`` packed into segment-isolated batches, or a weighted
``mixture``) or ``sft``
(``sft_jsonl`` rows ``{"prompt": ..., "response": ...}``, loss on the
response only). The trained weights are written by
``models.io.save_model`` to ``export_path`` (or ``$KUBEDL_MODEL_PATH``),
in the format the JAX package's ``load_model`` reads.

``"lora": {"rank": 16, "alpha": 16.0, "targets": ["wq", "wk", "wv",
"wo"]}`` trains adapters only: the base weights are closed over and never
handed to the optimizer, so its state is adapter-sized, and the export
folds the trained adapters into dense weights (``ops.lora.merge_to_dense``).

``mode`` may also be ``evaluate`` (no training: corpus perplexity over
``steps`` batches, or multiple-choice accuracy from ``eval_jsonl`` rows
``{"prompt": ..., "options": [...], "answer": i?}``; results to INFO and
``results_path``) or ``dpo`` (preference pairs from ``dpo_jsonl`` rows
``{"chosen": [ids], "rejected": [ids], "prompt_len": n}``, the frozen
initial weights as the reference, their log-probabilities precomputed
once per batch). ``"checkpoint": {"directory": ..., "save_interval_steps":
N, "max_to_keep": 3, "async_save": true}`` saves the train state and the
data cursor (``train.checkpoint``); a job started again on the same
directory resumes at the latest step, its stream fast-forwarded when the
data fingerprint matches. ``"eval": {"every": N, "data": {...},
"max_batches": M}`` scores a fixed held-out set during training.
``export_hf_path`` writes a HuggingFace directory beside ``export_path``
(LoRA folded first; an MoE model has no HF mapping and raises
``ValueError`` up front, as in the JAX package).

``mode: grpo`` is on-policy RL from a verifiable reward (``train.grpo``):
``prompts_jsonl`` rows ``{"prompt": ...}`` (token ids, or text with
``data.tokenizer``), ``"reward": "pkg.mod:fn"`` or ``"/path.py:fn"``
(``fn(prompt_ids, completion_ids[, tokenizer=...]) -> float``), ``"grpo":
{...}`` (``GRPOConfig``) and ``"rollout": {"rounds", "steps_per_round",
"max_new_tokens", "max_len", "prompts_per_round"}``. Each round refreshes
the rollout engine's weights to the policy, samples a group per prompt,
scores the frozen initial weights as the KL reference and takes
``steps_per_round`` steps; a resumed job starts at the next round.

Across processes: with a rendezvous contract in the env
(``runtime/bootstrap.py``: the operator's ``KUBEDL_COORDINATOR_ADDRESS``,
``KUBEDL_NUM_PROCESSES``, ``KUBEDL_PROCESS_ID``, or a PyTorchJob's or
torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``)
the job opens a process group first (NCCL on the card, gloo on the CPU),
then lays ``"mesh":
{"dp": .., "fsdp": .., "ep": .., "pp": .., "cp": .., "tp": ..}`` over its
ranks (default: every rank on ``fsdp``; ``cp`` shards the sequence
through ring or Ulysses attention, picked by ``"model_overrides":
{"cp_impl": ...}`` as in the JAX entrypoint, ``ep`` an MoE model's
experts, and ``pp`` the layers of a Llama or Gemma model into pipeline
stages, ``"pipeline": {"num_micro": n}`` microbatches a step through the
GPipe schedule, :func:`build_pp_pretrain`), places the params by the
family's ``param_specs`` (and the adapters by ``adapter_specs`` under
``lora``) and trains every mode sharded: each rank draws the global batch
and keeps its rows, the loss is the global mean, checkpoints reshard
across world sizes (a ``pp`` checkpoint restores at the same ``pp``, as
in the JAX package), and the export gathers the params (the stages
restacked to the flat ``[L, ...]`` layout) and only rank 0 writes. The
group is torn down on exit.

In a cluster: when the operator's job identity (``KUBEDL_JOB_KIND``,
``KUBEDL_JOB_NAMESPACE``, ``KUBEDL_JOB_NAME``) and
``KUBERNETES_SERVICE_HOST`` are in the env and the config has a
``checkpoint`` section, the job answers the operator's elastic
checkpoint requests (:func:`_maybe_elastic_agent`: the agent polls the
job object after every step, over ``core.kubeclient``). Under elastic
scaling the container runs under ``python -m
kubedl_tpu_torch.runtime.restart_agent --``, which ends the trainer when
the operator asks for an in-place restart; the restarted trainer reads
the new ``WORLD_SIZE`` and resumes from the agent's checkpoint.

Every mode runs over every mesh axis the JAX entry point takes; under
``cp`` the per-row sums of ``evaluate``, ``dpo`` and in-training eval
are added over the ranks' slices of the sequence
(``parallel.collectives.cp_sum``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

log = logging.getLogger("kubedl.train")

#: presets the resolver accepts per family (zero-argument constructors of
#: ``models.<family>``)
PRESETS = {"llama": ("llama3_8b", "llama2_7b", "mistral_7b", "qwen2_7b",
                     "tiny"),
           "gemma": ("gemma_2b", "gemma_7b", "gemma2_2b", "tiny"),
           "moe": ("mixtral_8x7b", "tiny")}


def load_config(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m kubedl_tpu_torch.train")
    p.add_argument("--config", help="path to the JSON training config")
    args = p.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            return json.load(f)
    raw = os.environ.get("KUBEDL_TRAIN_CONFIG", "")
    if not raw:
        raise SystemExit(
            "no config: pass --config FILE or set $KUBEDL_TRAIN_CONFIG")
    return json.loads(raw)


def resolve_model(cfg: dict, device=None):
    """``model`` -> (config, params-or-None). Params come back non-None
    only for ``model_path`` artifacts (fine-tuning), loaded on
    ``device``."""
    import importlib

    from ..models import io

    model = cfg.get("model", "llama.tiny")
    if isinstance(model, dict):
        config, params = io.load_model(model["model_path"], device=device)
    else:
        fam, _, preset = model.partition(".")
        if preset not in PRESETS.get(fam, ()):
            raise ValueError(
                f"model must be 'family.preset' with a preset of {PRESETS}, "
                f"or {{'model_path': dir}}; got {model!r}")
        mod = importlib.import_module(f"..models.{fam}", __package__)
        config, params = getattr(mod, preset)(), None
    if cfg.get("model_overrides"):
        config = dataclasses.replace(config, **cfg["model_overrides"])
    if config.loss_chunk == 0 \
            and "loss_chunk" not in cfg.get("model_overrides", {}):
        # presets default loss_chunk=0 (naive [b, s, V] logits): at real
        # vocab sizes that is tens of GB, so the entrypoint takes the
        # chunked LM-head loss unless explicitly overridden
        config = dataclasses.replace(config, loss_chunk=512)
    return config, params


def data_stream(cfg: dict, config, mesh, batch: int, seq: int,
                skip: int = 0):
    """Pretrain batch iterator per the ``data`` section, prefetched onto
    the mesh's device. ``skip`` fast-forwards the host stream by that
    many batches; the result is a :class:`~.data.CountingIterator` whose
    ``consumed`` is the absolute cursor."""
    from .data import CountingIterator, prefetch_to_device

    data = cfg.get("data", {"kind": "synthetic"})
    raw = _raw_stream(data, config, batch, seq, skip=skip,
                      host=(mesh.data_index, mesh.data_size))
    return CountingIterator(prefetch_to_device(raw, size=2, mesh=mesh),
                            consumed=skip)


def _raw_stream(data: dict, config, batch: int, seq: int, skip: int = 0,
                host: tuple = (0, 1)):
    """Host-side batch stream for one ``data`` spec; ``mixture`` draws
    each step's batch from one source, in expectation proportional to the
    weights. ``skip`` fast-forwards: token files by index math, synthetic
    by replaying rng draws, packed text and mixtures by replaying the
    host-side packing and selection. ``host`` is (index, count) of this
    process's slice of the corpus, where the JAX entrypoint passes
    ``jax.process_index()``/``process_count()``: here the rank's place
    on the data axes, since a process is one card and its ``tp`` peers
    must read the same rows."""
    import numpy as np

    from .data import TokenFileDataset, skip_batches, synthetic_lm_batches

    kind = data.get("kind", "synthetic")
    if kind == "mixture":
        sources = data.get("sources") or []
        if len(sources) < 2:
            raise ValueError("mixture needs >= 2 sources")
        weights = np.asarray([float(s.get("weight", 1.0))
                              for s in sources])
        if (weights <= 0).any():
            raise ValueError("mixture weights must be > 0")
        weights = weights / weights.sum()
        rng = np.random.default_rng(data.get("seed", 0))
        # resume: replay only the selection draws, then hand each source
        # its own skip count
        counts = [0] * len(sources)
        for _ in range(skip):
            counts[int(rng.choice(len(sources), p=weights))] += 1
        streams = [_raw_stream(s, config, batch, seq, skip=c, host=host)
                   for s, c in zip(sources, counts)]

        def mixed():
            while True:
                yield next(streams[rng.choice(len(streams), p=weights)])
        return mixed()
    if kind == "synthetic":
        raw = synthetic_lm_batches(batch, seq, config.vocab_size,
                                   seed=data.get("seed", 0), skip=skip)
        skip = 0
    elif kind == "tokens":
        raw = TokenFileDataset(data["path"], seq, batch,
                               process_index=host[0],
                               process_count=host[1],
                               seed=data.get("seed", 0)).batches(skip=skip)
        skip = 0
    elif kind == "text":
        from ..tokenizer import load_tokenizer, text_documents
        from .data import pack_documents
        tok = load_tokenizer(data.get("tokenizer", "byte"))
        if tok is None:
            raise ValueError("data.kind='text' needs data.tokenizer")
        _check_tok_vocab(tok, config)
        # each host takes a disjoint stride of the corpus
        docs = [d for i, d in enumerate(
                    text_documents(data["path"], tok,
                                   text_key=data.get("text_key", "text")))
                if i % host[1] == host[0]]
        if not docs:
            raise ValueError(f"no documents in {data['path']} for host "
                             f"{host[0]}")
        rng = np.random.default_rng(data.get("seed", 0) + host[0])

        def packed_epochs():
            while True:
                order = rng.permutation(len(docs))
                n = 0
                for b in pack_documents([docs[i] for i in order], seq,
                                        batch, pad_id=tok.pad_id):
                    n += 1
                    yield b
                if n == 0:
                    # the packer only yields full batches; a corpus that
                    # rounds down to zero would spin here forever
                    raise ValueError(
                        f"corpus {data['path']} packs into 0 full "
                        f"batches of {batch}x{seq}: lower batch/seq or "
                        "add data")
        raw = packed_epochs()
    else:
        raise ValueError(f"unknown data kind {kind!r} for pretrain")
    return skip_batches(raw, skip)


def _check_tok_vocab(tok, config) -> None:
    """Token ids past the embedding table would index out of range: a
    tokenizer larger than the model's vocab is refused up front."""
    if tok is not None and tok.vocab_size > config.vocab_size:
        raise ValueError(
            f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
            f"{config.vocab_size}: wrong tokenizer for this model")


def sft_stream(cfg: dict, config, mesh, batch: int, seq: int,
               skip: int = 0):
    """Instruction-tuning batches from an ``sft_jsonl`` file: rows
    ``{"prompt": ..., "response": ...}``, each field raw text (needs
    ``data.tokenizer``) or a token-id list. Loss covers response tokens
    only (``train.data.sft_batches``)."""
    from ..tokenizer import load_tokenizer
    from .data import CountingIterator, prefetch_to_device, sft_batches

    data = cfg.get("data", {})
    if data.get("kind") != "sft_jsonl":
        raise ValueError("mode=sft needs data.kind='sft_jsonl'")
    tok = load_tokenizer(data.get("tokenizer", ""))
    _check_tok_vocab(tok, config)

    def ids_of(v, *, bos: bool, eos: bool):
        if isinstance(v, list):
            return [int(t) for t in v]
        if tok is None:
            raise ValueError(
                "text prompt/response rows need data.tokenizer")
        return tok.encode(v, add_bos=bos, add_eos=eos)

    examples = []
    with open(data["path"]) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            p = ids_of(row["prompt"], bos=True, eos=False)
            r = ids_of(row["response"], bos=False, eos=True)
            examples.append((p + r, len(p)))
    if not examples:
        raise ValueError(f"no rows in {data['path']}")
    stream = sft_batches(examples, seq, batch,
                         pad_id=tok.pad_id if tok is not None else 0,
                         seed=data.get("seed", 0), skip=skip)
    return CountingIterator(prefetch_to_device(stream, size=2, mesh=mesh),
                            consumed=skip)


def build_eval_fn(cfg: dict, config, mesh, batch: int, seq: int,
                  params_of=None):
    """(eval_every, eval_fn) for in-training validation: the ``eval``
    section ``{"every": N, "data": {...}, "max_batches": M}`` draws a
    fixed held-out set once (every eval point scores the same tokens, so
    the curve is comparable); the Trainer calls the closure between
    steps."""
    import itertools
    import math

    ecfg = cfg.get("eval") or {}
    every = int(ecfg.get("every", 0))
    if not every:
        return 0, None
    if not ecfg.get("data"):
        raise ValueError("eval.every needs eval.data (a held-out source)")
    from . import evaluate as ev

    n = int(ecfg.get("max_batches", 8))
    stream = data_stream({**cfg, "data": ecfg["data"]}, config, mesh,
                         batch, seq)
    ev_batches = list(itertools.islice(stream, n))
    row_nll = ev.make_row_nll_fn(config, mesh)

    def eval_fn(state):
        p = params_of(state) if params_of is not None else state.params
        total = cnt = 0.0
        for b in ev_batches:
            t, c = ev.batch_totals(row_nll, p, b, mesh)
            total += t
            cnt += c
        nll = total / max(cnt, 1.0)
        return {"val_nll": nll, "val_ppl": math.exp(min(nll, 80.0))}

    return every, eval_fn


def dpo_batches(cfg: dict, config, params, mesh, batch: int,
                skip: int = 0):
    """Infinite DPO batch stream from a pairs JSONL, the reference
    log-probabilities computed once per batch under the frozen initial
    weights ``params``. ``skip`` fast-forwards the round-robin cursor by
    index math, without computing the skipped batches' references."""
    from ..parallel.sharding import local_of
    from . import dpo
    from .data import CountingIterator, shard_batch

    data = cfg.get("data", {})
    if data.get("kind") != "dpo_jsonl":
        raise ValueError("mode=dpo needs data.kind='dpo_jsonl'")
    rows = []
    with open(data["path"]) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    if len(rows) < batch:
        raise ValueError(f"{len(rows)} pairs < batch {batch}")
    ref_fn = dpo.reference_logps_fn(config, params, mesh)

    def stream():
        i = (skip * batch) % len(rows)
        while True:
            chunk = [rows[(i + j) % len(rows)] for j in range(batch)]
            i = (i + batch) % len(rows)
            b = shard_batch(dpo.preference_batch(
                [r["chosen"] for r in chunk],
                [r["rejected"] for r in chunk],
                [r["prompt_len"] for r in chunk]), mesh)
            # the reference scores this rank's own pairs
            b["ref_chosen_logps"], b["ref_rejected_logps"] = ref_fn(
                {k: local_of(v) for k, v in b.items()})
            yield b

    return CountingIterator(stream(), consumed=skip)


def pp_num_micro(cfg: dict, config, mesh, batch: int) -> int:
    """The up-front checks of pipeline training, run on every rank before
    any data opens, with the JAX entrypoint's messages; returns
    ``pipeline.num_micro`` (default ``max(2, pp)``)."""
    from ..models import io
    mode = cfg.get("mode", "pretrain")
    if mode not in ("pretrain", "sft"):
        raise ValueError("pp training supports mode pretrain/sft")
    if cfg.get("lora"):
        raise ValueError("pp does not compose with lora adapters")
    if io.family_name(config) != "llama":
        raise ValueError("pp training supports the dense llama "
                         "family only (MoE scales with ep instead)")
    if mesh.size("cp") > 1 or mesh.size("tp") > 1:
        raise ValueError(
            "pp training composes with dp/fsdp only; set cp=1 and "
            "tp=1 (cp/tp inside pipeline stages is not wired yet)")
    data = cfg.get("data", {"kind": "synthetic"})
    kinds = ([src.get("kind") for src in data.get("sources", [])]
             if data.get("kind") == "mixture"
             else [data.get("kind", "synthetic")])
    if mode == "pretrain" and "text" in kinds:
        # before the corpus is tokenized and packed
        raise ValueError(
            "pp training does not support packed text batches yet — "
            "use data.kind tokens/synthetic (or mode sft)")
    num_micro = int(cfg.get("pipeline", {}).get("num_micro", 0)) \
        or max(2, mesh.size("pp"))
    if batch % num_micro:
        raise ValueError(
            f"batch {batch} not divisible by pipeline.num_micro="
            f"{num_micro}")
    if (batch // num_micro) % mesh.data_size:
        raise ValueError(
            f"microbatch {batch // num_micro} rows must divide "
            f"the dp*fsdp width {mesh.data_size}")
    return num_micro


def build_pp_pretrain(config, mesh, num_micro: int, stages=None):
    """``mesh: {"pp": n}`` with n > 1: GPipe pipeline training through the
    entrypoint (the llama family, plain and SFT batches). Layers are
    stage-stacked ``[pp, L/pp, ...]`` and flow through
    ``parallel.pipeline.pipeline_apply``, whose written-out backward
    reaches every param (the embedding and the head too). ``stages`` is
    where the pipeline runs: this rank's stage of ``mesh``'s ``pp`` group
    by default, or ``parallel.pipeline.local_stages(pp)`` to run every
    stage in one process (``mesh`` then None, or a one-device mesh).
    Returns ``(loss_fn, to_pp, from_pp, specs_of)``: to_pp/from_pp restack
    params between the flat checkpoint/export layout and the staged
    training layout. The loss is ``lm_loss`` over the whole reassembled
    batch, taken on the last stage (its share of the global mean under a
    sharded mesh; 0, still joined to the pipeline's graph, on the other
    stages, so every stage runs the backward). Each stage's layers run
    ``llama._layer_forward`` (K1-K3 on the card), each layer under
    ``torch.utils.checkpoint`` with ``config.remat``.
    ``pipeline_grads_1f1b`` stays the library-level memory-bound
    scheduler, as in the JAX package."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from ..models import llama
    from ..parallel.pipeline import (pipeline_apply, stack_stages,
                                     stage_scan, stages_of)
    from ..parallel.sharding import materialize
    from ..parallel.sharding import spec as logical_spec

    stages = stages_of(stages if stages is not None else mesh)
    pp = stages.pp
    if llama.window_flags(config) is not None:
        raise ValueError(
            "pp training does not support per-layer window patterns "
            "(Gemma-2 alternating windows) yet")
    if not config.scan_layers:
        raise ValueError("pp training needs scan_layers=True "
                         "(stacked layer params)")
    if config.n_layers % pp:
        raise ValueError(
            f"{config.n_layers} layers not divisible by pp={pp}")

    def to_pp(params):
        out = {k: v for k, v in params.items() if k != "layers"}
        out["stages"] = stack_stages(params["layers"], pp)
        return out

    def from_pp(params):
        out = {k: v for k, v in params.items() if k != "stages"}
        out["layers"] = {k: v.reshape((config.n_layers,)
                                      + tuple(v.shape[2:]))
                         for k, v in params["stages"].items()}
        return out

    def specs_of(params_pp):
        base = llama.param_specs(config)
        sp = {k: v for k, v in base.items() if k != "layers"}
        sp["stages"] = {k: logical_spec("stages")
                        for k in params_pp["stages"]}
        return sp

    def layer(x, lp, cos, sin):
        if config.remat and torch.is_grad_enabled():
            return checkpoint(llama._layer_forward, config, x, lp, cos, sin,
                              None, use_reentrant=False)
        return llama._layer_forward(config, x, lp, cos, sin, None)

    def loss_fn(params, batch):
        if "segment_ids" in batch:
            # backstop: the entrypoint refuses packed data kinds before
            # any data opens
            raise ValueError(
                "pp training does not support packed (segment-id) "
                "batches yet — use data.kind tokens/synthetic/sft_jsonl")
        # a stage leaf is this rank's stage (one row) or every stage (pp
        # rows in one process); over dp/fsdp it is whole, and its
        # gradient is summed there once, after the pipeline's backward
        staged = {k: materialize(v) for k, v in params["stages"].items()}

        def apply_layers(x, cos, sin):
            return pipeline_apply(
                stages, stage_scan(lambda h, lp: layer(h, lp, cos, sin)),
                staged, x, num_micro)

        # the prologue (embed, embed_scale, rope) and the final norm are
        # the flat forward's, through its apply_layers hook
        x = llama.forward_hidden(config, params, batch["tokens"],
                                 apply_layers=apply_layers)
        if not stages.holds_last:
            # a float32 share, as the last stage's loss is
            return x.sum().float() * 0.0
        return llama.lm_loss(config, x, params, batch["targets"],
                             mask=batch.get("mask"), mesh=mesh)

    return loss_fn, to_pp, from_pp, specs_of


def _data_fingerprint(cfg: dict, mode: str, batch: int, seq: int) -> dict:
    """Identity of the data stream a checkpoint cursor belongs to. A
    restored cursor only fast-forwards when the stream it counted is the
    stream about to be built: after a config change (another corpus,
    batch, seq or mode) the offset is meaningless, so the stream
    restarts at 0 with a warning instead of silently misaligning."""
    return {"mode": mode, "batch": batch, "seq": seq,
            "data": cfg.get("data", {"kind": "synthetic"})}


def run_evaluate(cfg: dict, config, params, mesh) -> int:
    """``mode=evaluate``: score a model without training: corpus
    perplexity (data kinds ``synthetic``/``tokens``/``text``) or
    multiple-choice accuracy (``eval_jsonl`` rows ``{"prompt": ...,
    "options": [...], "answer": i?}``, text fields via
    ``data.tokenizer``). Results log to INFO and, with ``results_path``,
    land as one JSON file."""
    from ..tokenizer import load_tokenizer
    from . import evaluate as ev

    data = cfg.get("data", {})
    ecfg = cfg.get("eval", {})
    tok = load_tokenizer(data.get("tokenizer", ""))
    _check_tok_vocab(tok, config)

    if data.get("kind") == "eval_jsonl":
        def ids_of(v, *, bos: bool):
            if isinstance(v, list):
                return [int(t) for t in v]
            if tok is None:
                raise ValueError("text eval rows need data.tokenizer")
            return tok.encode(v, add_bos=bos)

        rows = []
        with open(data["path"]) as f:
            for line in f:
                if line.strip():
                    rows.append(json.loads(line))
        if not rows:
            raise ValueError(f"no rows in {data['path']}")
        questions = [{"prompt": ids_of(r["prompt"], bos=True),
                      "options": [ids_of(o, bos=False)
                                  for o in r["options"]]} for r in rows]
        ranked = ev.loglikelihood_ranks(
            config, params, questions, mesh=mesh,
            length_normalize=bool(ecfg.get("length_normalize", False)))
        results = {"kind": "loglikelihood", "questions": len(ranked),
                   "choices": [r["choice"] for r in ranked]}
        answers = [r.get("answer") for r in rows]
        if all(a is not None for a in answers):
            correct = sum(int(c == a) for c, a in
                          zip(results["choices"], answers))
            results["accuracy"] = correct / len(answers)
    else:
        batch = int(cfg.get("batch", 8))
        seq = int(cfg.get("seq", 256))
        batches = data_stream(cfg, config, mesh, batch, seq)
        results = ev.perplexity(config, params, batches, mesh=mesh,
                                max_batches=int(cfg.get("steps", 16)))
        results["kind"] = "perplexity"

    log.info("evaluate results: %s", json.dumps(results))
    out = cfg.get("results_path")
    if out and _rank() == 0:
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        log.info("results written to %s", out)
    return 0


def resolve_reward(spec: str):
    """``"pkg.mod:fn"`` or ``"/path/file.py:fn"`` -> the reward callable
    ``fn(prompt_ids, completion_ids) -> float``."""
    import importlib
    import importlib.util

    mod_spec, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(
            f"reward must be 'module:function' or '/path.py:function', "
            f"got {spec!r}")
    if mod_spec.endswith(".py"):
        py_spec = importlib.util.spec_from_file_location(
            "kubedl_reward", mod_spec)
        mod = importlib.util.module_from_spec(py_spec)
        py_spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_spec)
    try:
        return getattr(mod, fn_name)
    except AttributeError:
        raise ValueError(
            f"no function {fn_name!r} in {mod_spec}") from None


def run_grpo(cfg: dict, config, trainer, state, manager, ref_params,
             elastic_agent=None, on_step=None):
    """The on-policy RLVR loop: refresh the rollout engine's weights to
    the current policy each round, sample a group per prompt, score with
    the verifiable reward, update for ``steps_per_round`` steps.

    On-policy means ``old_logps`` from the freshly refreshed engine ARE
    the current policy: the clipped ratio only engages within a round as
    the weights move. The engine (the static ``InferenceEngine``, as the
    JAX loop's) holds its own copy of the weights, built once and
    refreshed in place each round (``load_weights``). ``ref_params`` is
    the frozen KL reference: the INITIAL weights, copied before any
    checkpoint restore. ``elastic_agent`` is polled after every round, as
    in the JAX loop. ``on_step(step, loss)`` follows every step."""
    import functools
    import inspect

    import numpy as np
    import torch

    from ..parallel.sharding import full_tensor
    from ..serving.engine import GenerateConfig, InferenceEngine
    from ..tokenizer import load_tokenizer
    from . import grpo as grpo_mod
    from .data import shard_batch
    from .trainer import tree_map

    data = cfg.get("data", {})
    if data.get("kind") != "prompts_jsonl":
        raise ValueError("mode=grpo needs data.kind='prompts_jsonl'")
    tok = load_tokenizer(data.get("tokenizer", ""))
    _check_tok_vocab(tok, config)
    prompts = []
    with open(data["path"]) as f:
        for line in f:
            if line.strip():
                p = json.loads(line)["prompt"]
                if isinstance(p, str):
                    if tok is None:
                        raise ValueError(
                            "text prompts need data.tokenizer")
                    p = tok.encode(p, add_bos=True)
                prompts.append(p)
    if not prompts:
        raise ValueError(f"no prompts in {data['path']}")
    reward_fn = resolve_reward(cfg.get("reward", ""))
    if "tokenizer" in inspect.signature(reward_fn).parameters:
        if tok is None:
            # fail before the first rollout, not at the first reward call
            raise ValueError(
                "reward function declares a tokenizer parameter but the "
                "config sets no data.tokenizer")
        # text-level rewards decode with the corpus tokenizer
        reward_fn = functools.partial(reward_fn, tokenizer=tok)

    gcfg = grpo_mod.GRPOConfig(**cfg.get("grpo", {}))
    roll = cfg.get("rollout", {})
    rounds = int(roll.get("rounds", 10))
    steps_per_round = int(roll.get("steps_per_round", 4))
    if rounds < 1 or steps_per_round < 1:
        raise ValueError("rollout.rounds and rollout.steps_per_round "
                         "must be >= 1")
    max_new = int(roll.get("max_new_tokens", 64))
    max_len = int(roll.get("max_len", 1024))
    per_round = int(roll.get("prompts_per_round", 0)) or max(
        1, 8 // gcfg.group_size)
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError("mode=grpo is single-host for now: the rollout "
                         "engine runs in-process on this host's chips")

    interval = manager.config.save_interval_steps if manager else 0
    last_saved = int(state.step)
    dev = trainer.device
    mesh = trainer.placement_mesh
    engine = None
    # resume: rounds advance the step by exactly steps_per_round, so the
    # restored step IS the data cursor: start at the next round (a resumed
    # run rolls out the prompt schedule an uninterrupted one would)
    start_rnd = min(int(state.step) // steps_per_round, rounds)
    if start_rnd:
        log.info("grpo resume: %d rounds already done (step %d), "
                 "starting at round %d", start_rnd, int(state.step),
                 start_rnd + 1)
    for rnd in range(start_rnd, rounds):
        with torch.no_grad():
            policy = tree_map(lambda t: full_tensor(t).detach(),
                              state.params)
            if engine is None:
                engine = InferenceEngine(
                    config, tree_map(torch.clone, policy),
                    GenerateConfig(max_len=max_len, temperature=1.0),
                    device=dev)
            else:
                engine.load_weights(policy)
            del policy
        batch_prompts = [prompts[(rnd * per_round + j) % len(prompts)]
                         for j in range(per_round)]
        batch = grpo_mod.rollout_batch(
            engine, batch_prompts, reward_fn, max_new, cfg=gcfg,
            seed=int(cfg.get("seed", 0)) + rnd)
        mean_reward = float(batch["rewards"].mean())
        with torch.no_grad():
            ref_lp = grpo_mod.token_logps(
                config, ref_params,
                torch.as_tensor(batch["tokens"], device=dev).long(),
                torch.as_tensor(batch["targets"], device=dev).long())
        train = {k: v for k, v in batch.items() if k != "rewards"}
        train["ref_logps"] = ref_lp.float().cpu().numpy().astype(np.float32)
        sb = shard_batch(train, mesh)
        for _ in range(steps_per_round):
            state, loss = trainer.step(state, sb)
            if on_step is not None:
                on_step(state.step, float(loss))
        log.info("grpo round %d/%d mean_reward %.4f loss %.4f",
                 rnd + 1, rounds, mean_reward, float(loss))
        if elastic_agent is not None:
            elastic_agent.poll(state)
        # host-side cadence: rounds advance step by steps_per_round, so the
        # manager's `step % interval` periodic gate would only fire at
        # lcm(steps_per_round, interval)
        if manager is not None and interval \
                and int(state.step) - last_saved >= interval:
            manager.save(state, force=True)
            last_saved = int(state.step)
    if manager is not None:
        manager.save(state, force=True)
        manager.wait_until_finished()
    return state


def _family(cfg: dict) -> str:
    """The family (``models.io.FAMILIES``) of the config's ``model``,
    found without loading weights."""
    from ..models import io
    model = cfg.get("model", "llama.tiny")
    config = (io.read_config(model["model_path"])
              if isinstance(model, dict) else resolve_model(cfg)[0])
    return io.family_name(config)


def _refuse_unported(cfg: dict, env) -> None:
    """Up-front refusals, before any process group opens: the JAX
    entrypoint's (an unknown mode, ``lora`` outside pretrain/sft) and an
    incomplete rendezvous contract (``ValueError``, naming what is
    missing). An ``export_hf_path`` for an MoE model raises
    ``ValueError`` first, as the JAX entrypoint's up-front check does: no
    HF format holds it."""
    if cfg.get("export_hf_path") and _family(cfg) == "moe":
        raise ValueError(
            "export_hf_path: MoE configs have no HF mapping — drop "
            "export_hf_path or use a llama-family model")
    mode = cfg.get("mode", "pretrain")
    if mode not in ("pretrain", "sft", "evaluate", "dpo", "grpo"):
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.get("lora") and mode not in ("pretrain", "sft"):
        # adapter tuning only composes with the plain next-token losses
        raise ValueError("lora applies to mode pretrain/sft (dpo and "
                         "grpo tune full weights)")
    from ..runtime.bootstrap import rendezvous_from_env
    if rendezvous_from_env(env) is None:
        # a malformed operator contract (a process count with no
        # coordinator, TPU worker hostnames with no worker id): each
        # process would train alone on one card and write the same
        # checkpoints and export
        nproc = env.get("KUBEDL_NUM_PROCESSES", "")
        hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",")
                 if h.strip()]
        if nproc and int(nproc) > 1:
            raise ValueError(
                f"KUBEDL_NUM_PROCESSES={nproc} is set without "
                "KUBEDL_COORDINATOR_ADDRESS: an incomplete rendezvous "
                "contract")
        if len(hosts) > 1:
            raise ValueError(
                f"TPU_WORKER_HOSTNAMES lists {len(hosts)} hosts but "
                "TPU_WORKER_ID is missing: an incomplete rendezvous "
                "contract")


def _maybe_elastic_agent(manager, env, api=None):
    """The :class:`~.checkpoint.ElasticCheckpointAgent` when the operator
    injected the job's identity, the config checkpoints and the process
    runs in a cluster (``KUBERNETES_SERVICE_HOST``); None otherwise
    (standalone runs), as in the JAX entrypoint. The agent talks to
    ``api``, or to the cluster's API server through the pod's service
    account."""
    kind = env.get("KUBEDL_JOB_KIND", "")
    ns = env.get("KUBEDL_JOB_NAMESPACE", "")
    name = env.get("KUBEDL_JOB_NAME", "")
    if not (kind and ns and name and manager):
        return None
    if not env.get("KUBERNETES_SERVICE_HOST"):
        return None
    from .checkpoint import ElasticCheckpointAgent
    if api is None:
        from ..core.kubeclient import ClusterConfig, KubeAPIServer
        api = KubeAPIServer(ClusterConfig.in_cluster())
    return ElasticCheckpointAgent(api, kind, ns, name, manager)


def _rank() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def main(argv=None, device=None, on_step=None, api=None) -> int:
    """Run one training job. ``device`` is the card unless the caller
    names the CPU (``device="cpu"``); ``on_step(step, loss)`` is called
    after every optimizer step; ``api`` is the API-server client of the
    elastic agent in a cluster (default: the in-cluster one). With a
    rendezvous contract in the env the process group opens first (and
    closes on exit)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = load_config(argv)
    _refuse_unported(cfg, os.environ)

    import torch.distributed as dist

    from .._device import resolve_device
    from ..runtime import bootstrap

    dev = resolve_device(device)
    info = bootstrap.rendezvous_from_env()
    opened = info is not None and not dist.is_initialized()
    if opened:
        bootstrap.initialize_distributed(info, device=dev)
    try:
        return _run(cfg, dev, on_step, api)
    finally:
        if opened and dist.is_initialized():
            dist.destroy_process_group()


def _run(cfg: dict, dev, on_step, api) -> int:
    import torch

    from ..models import io
    from ..parallel.collectives import all_gather
    from ..parallel.mesh import MeshConfig, build_mesh
    from ..parallel.sharding import full_tensor, local_of, shard_tree, views
    from .trainer import TrainConfig, Trainer, tree_map

    mesh = build_mesh(MeshConfig(**cfg.get("mesh", {})), device=dev)
    sharded = mesh.device_mesh is not None
    config, params = resolve_model(cfg, device=dev)
    family = io.family_of(config)
    mode = cfg.get("mode", "pretrain")
    batch = int(cfg.get("batch", 8))
    seq = int(cfg.get("seq", min(config.max_seq_len, 1024)))
    steps = int(cfg.get("steps", 100))
    log.info("model=%s params=%.2fM mesh=%s mode=%s device=%s",
             cfg.get("model"), config.num_params / 1e6, mesh.shape, mode,
             dev)
    # pipeline training: validated up front, before any data opens
    num_micro = (pp_num_micro(cfg, config, mesh, batch)
                 if mesh.size("pp") > 1 else 0)
    if params is None:
        params = family.init_params(
            config,
            torch.Generator(device=dev).manual_seed(int(cfg.get("seed", 0))),
            device=dev)
    specs = family.param_specs(config) if sharded else None

    def placed_views(tree):
        """A full tree as the model reads it under the mesh: placed by
        its specs and viewed (no gradient); the tree itself on one
        device."""
        return views(shard_tree(tree, mesh, specs), mesh) if sharded \
            else tree

    if mode == "evaluate":
        return run_evaluate(cfg, config, placed_views(params), mesh)

    # the checkpoint manager opens BEFORE the data stream is built: the
    # saved data cursor decides how far to fast-forward the stream, so a
    # resumed run continues at the exact batch boundary
    manager = None
    resume_skip = 0
    fingerprint = _data_fingerprint(cfg, mode, batch, seq)
    if cfg.get("checkpoint"):
        from .checkpoint import CheckpointConfig, CheckpointManager
        manager = CheckpointManager(CheckpointConfig(**cfg["checkpoint"]))
        cursor = manager.latest_data_state()
        if cursor:
            if cursor.get("fingerprint") == fingerprint:
                resume_skip = int(cursor.get("consumed_batches", 0))
                log.info("data cursor: resuming stream at batch %d",
                         resume_skip)
            else:
                log.warning(
                    "data cursor fingerprint mismatch (saved %s != "
                    "current %s); stream restarts at batch 0",
                    cursor.get("fingerprint"), fingerprint)

    model_mesh = mesh if sharded else None
    batches = from_pp = None
    if mode == "dpo":
        from . import dpo as dpo_mod
        loss_fn = dpo_mod.make_dpo_loss_fn(
            config, dpo_mod.DPOConfig(**cfg.get("dpo", {})),
            mesh=model_mesh)
        # the frozen reference is the INITIAL weights: a copy, since the
        # trainer updates its parameters in place
        ref_params = placed_views(
            tree_map(lambda t: t.detach().clone(), params))
        batches = dpo_batches(cfg, config, ref_params, mesh, batch,
                              skip=resume_skip)
    elif mode == "grpo":
        from . import grpo as grpo_mod
        loss_fn = grpo_mod.make_grpo_loss_fn(
            config, grpo_mod.GRPOConfig(**cfg.get("grpo", {})),
            mesh=model_mesh)
        # the frozen KL reference is the INITIAL weights: a copy taken
        # before init_state and before any restore, since the trainer
        # updates its parameters in place (an alias would move the anchor)
        grpo_ref = tree_map(lambda t: t.detach().clone(), params)
    else:
        if num_micro:
            loss_fn, to_pp, from_pp, specs_of = build_pp_pretrain(
                config, model_mesh, num_micro)
            params = to_pp(params)
            specs = specs_of(params)
            log.info("pipeline training: pp=%d num_micro=%d (GPipe)",
                     mesh.size("pp"), num_micro)
        else:
            def loss_fn(p, b):
                # packed text batches carry segment/position/mask planes;
                # token/synthetic batches don't: one closure serves both
                return family.loss_fn(config, p, b["tokens"], b["targets"],
                                      mask=b.get("mask"),
                                      segment_ids=b.get("segment_ids"),
                                      positions=b.get("positions"),
                                      mesh=model_mesh)

        batches = (sft_stream(cfg, config, mesh, batch, seq,
                              skip=resume_skip) if mode == "sft"
                   else data_stream(cfg, config, mesh, batch, seq,
                                    skip=resume_skip))
    opt = TrainConfig(**cfg.get("optimizer", {}))
    placement = ({"param_specs": specs, "mesh": mesh} if sharded
                 else {"device": dev})
    lora_cfg = cfg.get("lora")
    merge = params_of = None
    if lora_cfg:
        # adapter-only fine-tuning: the base is closed over (its tensors
        # never require gradients and never reach the optimizer), so the
        # optimizer state is adapter-sized
        from ..ops import lora
        rank = int(lora_cfg.get("rank", 8))
        alpha = float(lora_cfg.get("alpha", 16.0))
        targets = tuple(lora_cfg.get("targets") or lora.DEFAULT_TARGETS)
        adapters = lora.init_adapters(
            params, rank=rank, targets=targets,
            generator=torch.Generator(device=dev).manual_seed(
                int(cfg.get("seed", 0)) + 1))
        placed_base = shard_tree(params, mesh, specs) if sharded else None
        base = views(placed_base, mesh) if sharded else params
        if sharded:
            placement["param_specs"] = lora.adapter_specs(specs, adapters)
        trainer = Trainer(
            lambda ad, b: loss_fn(lora.merge_params(base, ad, alpha=alpha),
                                  b), opt, **placement)
        state = trainer.init_state(adapters)
        log.info("lora: rank=%d alpha=%.1f targets=%s (%.2fM trainable)",
                 rank, alpha, ",".join(sorted(targets)),
                 sum(t.numel() for ab in state.params.values()
                     for t in ab.values()) / 1e6)

        def merge(adapters):
            # fold the trained adapters into dense weights: the exported
            # artifact serves with no adapter overhead
            full_base = (tree_map(full_tensor, placed_base) if sharded
                         else base)
            return lora.merge_to_dense(full_base,
                                       tree_map(full_tensor, adapters),
                                       alpha=alpha)

        def params_of(st):
            return lora.merge_params(base, views(st.params, mesh),
                                     alpha=alpha)
    else:
        trainer = Trainer(loss_fn, opt, **placement)
        state = trainer.init_state(params)
        if from_pp is not None:
            def whole_stages(tree):
                """The stage leaves gathered over pp (each rank holds
                its own stage), whole."""
                return {k: all_gather(local_of(v), mesh, 0, axis="pp")
                        for k, v in tree["stages"].items()}

            def merge(tree):
                # restack [pp, L/pp, ...] stages to the flat [L, ...]
                # layout every other consumer (serving, HF export) reads
                return from_pp({**tree_map(full_tensor, {
                    k: v for k, v in tree.items() if k != "stages"}),
                    "stages": whole_stages(tree)})

            def params_of(st):
                # in-training eval runs the flat forward
                with torch.no_grad():
                    return from_pp({**views({k: v for k, v in
                                             st.params.items()
                                             if k != "stages"}, mesh),
                                    "stages": whole_stages(st.params)})
        elif sharded:
            def params_of(st):
                return views(st.params, mesh)
    del params

    if manager is not None:
        state = manager.restore_or(state, lambda: state)
        if manager.latest_step():
            log.info("resumed from checkpoint step %s",
                     manager.latest_step())

    agent = _maybe_elastic_agent(manager, os.environ, api)
    if mode == "grpo":
        state = run_grpo(cfg, config, trainer, state, manager, grpo_ref,
                         elastic_agent=agent, on_step=on_step)
    else:
        from .data import CountingIterator
        data_state_fn = None
        if manager is not None and isinstance(batches, CountingIterator):
            def data_state_fn():
                return {"consumed_batches": batches.consumed,
                        "fingerprint": fingerprint}

        ev_every, ev_fn = ((0, None) if mode == "dpo"
                           else build_eval_fn(cfg, config, mesh, batch, seq,
                                              params_of=params_of))
        if agent is not None:
            agent.data_state_fn = data_state_fn
        state = trainer.fit(state, batches, num_steps=steps,
                            log_every=int(cfg.get("log_every", 10)),
                            on_step=on_step, checkpoint_manager=manager,
                            elastic_agent=agent,
                            eval_every=ev_every, eval_fn=ev_fn,
                            data_state_fn=data_state_fn)

    export = cfg.get("export_path") or os.environ.get("KUBEDL_MODEL_PATH")
    hf_out = cfg.get("export_hf_path")
    if hf_out and not export:
        log.warning("export_hf_path is written beside export_path (or "
                    "$KUBEDL_MODEL_PATH), and neither is set: no export")
    if export:
        # every rank joins the gathers; only rank 0 touches the disk
        final = (merge(state.params) if merge
                 else tree_map(full_tensor, state.params))
        if _rank() == 0:
            io.save_model(config, final, export)
            log.info("exported model to %s", export)
            if hf_out:
                from ..models.convert import save_hf_checkpoint
                save_hf_checkpoint(config, final, hf_out)
                log.info("exported HF checkpoint to %s", hf_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
