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
``mistral_7b``, ``qwen2_7b``, ``tiny``) or ``{"model_path": dir}`` to
fine-tune a saved artifact; ``model_overrides`` replaces any config
field, and ``loss_chunk`` defaults to 512 (the chunked LM-head loss)
unless overridden. ``mode`` is ``pretrain`` (next-token loss; data
``synthetic``, a ``tokens`` memmap file, ``text`` packed into
segment-isolated batches, or a weighted ``mixture``) or ``sft``
(``sft_jsonl`` rows ``{"prompt": ..., "response": ...}``, loss on the
response only). The trained weights are written by
``models.io.save_model`` to ``export_path`` (or ``$KUBEDL_MODEL_PATH``),
in the format the JAX package's ``load_model`` reads.

Not ported yet, and refused by name: checkpoints, in-training eval and
the ``evaluate``/``dpo``/``grpo`` modes (ROADMAP A6), LoRA, HF export and
the gemma/MoE families (A4), mesh axes above 1 (A5), and a multi-process
rendezvous (A8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

log = logging.getLogger("kubedl.train")

#: llama-family presets the resolver accepts (zero-argument constructors)
PRESETS = ("llama3_8b", "llama2_7b", "mistral_7b", "qwen2_7b", "tiny")


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
    from ..models import io, llama

    model = cfg.get("model", "llama.tiny")
    if isinstance(model, dict):
        config, params = io.load_model(model["model_path"], device=device)
    else:
        fam, _, preset = model.partition(".")
        if fam in ("gemma", "moe"):
            raise NotImplementedError(
                f"model family {fam!r} is not ported yet: ROADMAP A4 "
                "(quantization, LoRA, MoE and the other model families)")
        if fam != "llama" or preset not in PRESETS:
            raise ValueError(
                f"model must be 'llama.<preset>' with a preset of "
                f"{PRESETS}, or {{'model_path': dir}}; got {model!r}")
        config, params = getattr(llama, preset)(), None
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
    raw = _raw_stream(data, config, batch, seq, skip=skip)
    return CountingIterator(prefetch_to_device(raw, mesh.device, size=2),
                            consumed=skip)


def _raw_stream(data: dict, config, batch: int, seq: int, skip: int = 0):
    """Host-side batch stream for one ``data`` spec; ``mixture`` draws
    each step's batch from one source, in expectation proportional to the
    weights. ``skip`` fast-forwards: token files by index math, synthetic
    by replaying rng draws, packed text and mixtures by replaying the
    host-side packing and selection."""
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
        streams = [_raw_stream(s, config, batch, seq, skip=c)
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
                               seed=data.get("seed", 0)).batches(skip=skip)
        skip = 0
    elif kind == "text":
        from ..tokenizer import load_tokenizer, text_documents
        from .data import pack_documents
        tok = load_tokenizer(data.get("tokenizer", "byte"))
        if tok is None:
            raise ValueError("data.kind='text' needs data.tokenizer")
        _check_tok_vocab(tok, config)
        docs = list(text_documents(data["path"], tok,
                                   text_key=data.get("text_key", "text")))
        if not docs:
            raise ValueError(f"no documents in {data['path']}")
        rng = np.random.default_rng(data.get("seed", 0))

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
    return CountingIterator(prefetch_to_device(stream, mesh.device, size=2),
                            consumed=skip)


def _refuse_unported(cfg: dict, env) -> None:
    """Config sections and environments of the JAX entrypoint whose
    slice has not landed: each raises, naming its ROADMAP item."""
    mode = cfg.get("mode", "pretrain")
    if mode in ("evaluate", "dpo", "grpo"):
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet: ROADMAP A6 (checkpoints "
            "and training modes)")
    if mode not in ("pretrain", "sft"):
        raise ValueError(f"unknown mode {mode!r}")
    for key, item, what in (
            ("checkpoint", "A6", "checkpointing"),
            ("lora", "A4", "LoRA adapter training"),
            ("export_hf_path", "A4", "HuggingFace export")):
        if cfg.get(key):
            raise NotImplementedError(
                f"{key!r}: {what} is not ported yet: ROADMAP {item}")
    if (cfg.get("eval") or {}).get("every"):
        raise NotImplementedError(
            "'eval': in-training evaluation is not ported yet: ROADMAP A6")
    nproc = env.get("KUBEDL_NUM_PROCESSES", "")
    hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",")
             if h.strip()]
    if (nproc and int(nproc) > 1) or len(hosts) > 1 \
            or int(env.get("WORLD_SIZE", "1") or 1) > 1:
        raise NotImplementedError(
            "a multi-process rendezvous is set in the environment: "
            "distributed training (NCCL rendezvous) is ROADMAP A8, and "
            "this entrypoint trains on one card")


def main(argv=None, device=None, on_step=None) -> int:
    """Run one training job. ``device`` is the card unless the caller
    names the CPU (``device="cpu"``); ``on_step(step, loss)`` is called
    after every optimizer step."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = load_config(argv)
    _refuse_unported(cfg, os.environ)

    import torch

    from .._device import resolve_device
    from ..models import io, llama
    from ..parallel.mesh import MeshConfig, build_mesh
    from .trainer import TrainConfig, Trainer

    dev = resolve_device(device)
    mesh = build_mesh(MeshConfig(**cfg.get("mesh", {})), device=dev)
    config, params = resolve_model(cfg, device=dev)
    mode = cfg.get("mode", "pretrain")
    batch = int(cfg.get("batch", 8))
    seq = int(cfg.get("seq", min(config.max_seq_len, 1024)))
    steps = int(cfg.get("steps", 100))
    log.info("model=%s params=%.2fM mesh=%s mode=%s device=%s",
             cfg.get("model"), config.num_params / 1e6, mesh.shape, mode,
             dev)
    if params is None:
        params = llama.init_params(
            config,
            torch.Generator(device=dev).manual_seed(int(cfg.get("seed", 0))),
            device=dev)

    def loss_fn(p, b):
        # packed text batches carry segment/position/mask planes;
        # token/synthetic batches don't: one closure serves both
        return llama.loss_fn(config, p, b["tokens"], b["targets"],
                             mask=b.get("mask"),
                             segment_ids=b.get("segment_ids"),
                             positions=b.get("positions"))

    batches = (sft_stream(cfg, config, mesh, batch, seq) if mode == "sft"
               else data_stream(cfg, config, mesh, batch, seq))
    trainer = Trainer(loss_fn, TrainConfig(**cfg.get("optimizer", {})),
                      device=dev)
    state = trainer.init_state(params)
    del params
    state = trainer.fit(state, batches, num_steps=steps,
                        log_every=int(cfg.get("log_every", 10)),
                        on_step=on_step)

    export = cfg.get("export_path") or os.environ.get("KUBEDL_MODEL_PATH")
    if export:
        io.save_model(config, state.params, export)
        log.info("exported model to %s", export)
    return 0


if __name__ == "__main__":
    sys.exit(main())
