"""``mode: evaluate``, ``mode: dpo`` and in-training eval over ``cp``: the
per-row sums of a sequence that ``cp`` splits, added over the ranks
(``parallel.collectives.cp_sum``). Held against the port on one process
and against the JAX package on the same JAX-made float32 artifact.

One 2-rank gloo group is spawned once for the file
(``parallel.launch.spawn``). In it, for ring and Ulysses attention at
``cp=2``, the train entrypoint's ``main`` runs four jobs: perplexity over
a byte-tokenized corpus, multiple-choice choices, 2 DPO steps and a
2-step ``pretrain`` with in-training eval; and one DPO loss with its
gradients is taken through ``make_dpo_loss_fn`` on the sharded params.
The JAX side runs its entrypoint on the same configs over ``cp=2`` of the
fake CPU devices (``fsdp`` takes the rest; the choices without a mesh)
and ``jax.value_and_grad`` of its DPO loss, on a thread while the ranks
run.

Tolerances (float32): losses and metrics 1e-5 relative, gradients 1e-4
(the ``cp`` partial sums add in another order than one process's).

The rank functions import nothing of JAX (the ranks import this module).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from kubedl_tpu_torch.parallel import launch

WORLD = 2
RTOL, GRAD_RTOL = 1e-5, 1e-4
IMPLS = ("ring", "ulysses")
#: a byte-tokenizer-sized llama, two layers
SHAPE = dict(vocab_size=288, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, d_ff=128, max_seq_len=256)
OPT = {"learning_rate": 1e-3, "warmup_steps": 1, "decay_steps": 10}
JOBS = ("ppl", "mc", "dpo", "eval")


def _data(tmp) -> dict:
    """The jobs' data files: a text corpus, multiple-choice rows (text and
    id lists), and preference pairs."""
    corpus = tmp / "corpus.txt"
    corpus.write_text("\n".join(
        f"document {i}: the quick brown fox jumps over {i * 7} lazy dogs"
        for i in range(24)))
    rows = [{"prompt": f"question {i}?",
             "options": ["yes", "no", f"maybe {i}"], "answer": i % 3}
            for i in range(4)]
    rows.append({"prompt": [1, 40, 41], "options": [[50], [60, 61]],
                 "answer": 1})
    mc = tmp / "eval.jsonl"
    mc.write_text("\n".join(json.dumps(r) for r in rows))
    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(8):
        prompt = [1] + rng.integers(3, 200, 3).tolist()
        pairs.append({"chosen": prompt + rng.integers(3, 200, 4).tolist(),
                      "rejected": prompt + rng.integers(3, 200, 2).tolist(),
                      "prompt_len": 4})
    dpo = tmp / "pairs.jsonl"
    dpo.write_text("\n".join(json.dumps(r) for r in pairs))
    return {"corpus": str(corpus), "mc": str(mc), "dpo": str(dpo)}


def _config(tmp, artifact, data, job, side, impl=None) -> str:
    """One job's config file for ``side`` (``jax``, ``one`` or ``cp``)."""
    cfg = {"model": {"model_path": artifact}, "log_every": 1,
           "optimizer": OPT}
    if job == "ppl":
        cfg.update(mode="evaluate", batch=8, seq=64, steps=2,
                   data={"kind": "text", "path": data["corpus"],
                         "tokenizer": "byte"})
    elif job == "mc":
        cfg.update(mode="evaluate", data={"kind": "eval_jsonl",
                                          "path": data["mc"],
                                          "tokenizer": "byte"})
    elif job == "dpo":
        cfg.update(mode="dpo", batch=8, steps=2, dpo={"beta": 0.2},
                   data={"kind": "dpo_jsonl", "path": data["dpo"]})
    else:
        cfg.update(batch=8, seq=32, steps=2,
                   data={"kind": "synthetic", "seed": 4},
                   eval={"every": 2, "data": {"kind": "synthetic",
                                              "seed": 9},
                         "max_batches": 2})
    name = f"{job}_{side}{'_' + impl if impl else ''}"
    if job in ("ppl", "mc"):
        cfg["results_path"] = str(tmp / f"{name}.json")
    if side == "cp" or (side == "jax" and job != "mc"):
        # JAX's ring over cp shards a question's option rows over the
        # data axes too, which 3 options do not divide: its choices run
        # without a mesh
        cfg["mesh"] = {"cp": 2}
    if impl:
        cfg["model_overrides"] = {"cp_impl": impl}
    path = tmp / f"{name}.json.cfg"
    path.write_text(json.dumps(cfg))
    return str(path)


def _run_main(main_module, path, **kw) -> dict:
    """``main`` on one config: its step losses, every in-training eval's
    results (read through ``build_eval_fn``, unrounded) and its results
    file's contents."""
    seen = {"losses": [], "evals": []}
    real = main_module.build_eval_fn

    def recording(*a, **k):
        every, fn = real(*a, **k)
        if fn is None:
            return every, fn

        def rec(state):
            res = fn(state)
            seen["evals"].append(dict(res))
            return res
        return every, rec
    main_module.build_eval_fn = recording
    try:
        if kw:
            kw["on_step"] = lambda s, v: seen["losses"].append(float(v))
        assert main_module.main(["--config", path], **kw) == 0
    finally:
        main_module.build_eval_fn = real
    import torch.distributed as dist
    cfg = json.loads(open(path).read())
    if "results_path" in cfg and not (dist.is_initialized()
                                      and dist.get_rank()):
        # rank 0 writes the file
        seen["results"] = json.loads(open(cfg["results_path"]).read())
    return seen


# -- the DPO loss and its gradients ----------------------------------------

def _dpo_batch() -> dict:
    """Two pairs of ragged rows (128 columns), with reference
    log-probabilities off the policy, so the loss is not ln 2."""
    from kubedl_tpu_torch.train import dpo as tdpo
    rng = np.random.default_rng(3)
    chosen, rejected, lens = [], [], []
    for _ in range(2):
        pl = int(rng.integers(2, 6))
        prompt = rng.integers(1, 200, pl).tolist()
        chosen.append(prompt + rng.integers(1, 200, int(rng.integers(
            2, 9))).tolist())
        rejected.append(prompt + rng.integers(1, 200, int(rng.integers(
            2, 9))).tolist())
        lens.append(pl)
    b = tdpo.preference_batch(chosen, rejected, lens)
    for side in ("chosen", "rejected"):
        b[f"ref_{side}_logps"] = (rng.standard_normal(2).astype(np.float32)
                                  * 3 - 40)
    return b


def dpo_grads(artifact, impl=None) -> dict:
    """The DPO loss (beta 0.2) and every gradient, whole: under a
    ``cp=2`` mesh of the open group with ``impl``, else on one process."""
    from torch.distributed.tensor import DTensor

    from kubedl_tpu_torch.models import io, llama
    from kubedl_tpu_torch.parallel import collectives, sharding
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.train import data as tdata
    from kubedl_tpu_torch.train import dpo as tdpo
    from kubedl_tpu_torch.train import trainer as ttrainer
    cfg, params = io.load_model(artifact, device="cpu")
    mesh = None
    if impl:
        cfg = dataclasses.replace(cfg, cp_impl=impl)
        mesh = tmesh.build_mesh(tmesh.MeshConfig(cp=2), device="cpu")
    loss_fn = tdpo.make_dpo_loss_fn(cfg, tdpo.DPOConfig(beta=0.2),
                                    mesh=mesh, chunk=64)
    place = ({"param_specs": llama.param_specs(cfg), "mesh": mesh}
             if mesh is not None else {"device": "cpu"})
    trainer = ttrainer.Trainer(loss_fn, ttrainer.TrainConfig(), **place)
    state = trainer.init_state(params)
    placed = dict(ttrainer.tree_leaves(state.params))
    view = (sharding.views(state.params, mesh, requires_grad=True)
            if mesh is not None else state.params)
    leaves = ttrainer.tree_leaves(view)
    if mesh is None:
        for _, t in leaves:
            t.requires_grad_(True)
    batch = (tdata.shard_batch(_dpo_batch(), mesh) if mesh is not None
             else tdata.to_device(_dpo_batch(), torch.device("cpu")))
    share = loss_fn(view, {k: sharding.local_of(v) for k, v in
                           batch.items()})
    grads = torch.autograd.grad(share, [getattr(p, "local", p)
                                        for _, p in leaves])

    def whole(k, g):
        p = placed[k]
        if isinstance(p, DTensor):
            g = DTensor.from_local(g, p.device_mesh, p.placements,
                                   run_check=False, shape=p.shape,
                                   stride=p.stride()).full_tensor()
        return g.detach().numpy().copy()

    share = share.detach()
    return {"loss": float(collectives.world_sum(share) if mesh is not None
                          else share),
            "grads": {k: whole(k, g) for (k, _), g in zip(leaves, grads)}}


def rank_main(artifact, paths):
    """One rank: every job through ``main`` and the DPO gradients, for
    each ``cp_impl``."""
    import torch.distributed as dist

    from kubedl_tpu_torch.runtime import bootstrap
    from kubedl_tpu_torch.train import __main__ as tmain

    bootstrap.initialize_distributed(device="cpu")
    out = {}
    for impl in IMPLS:
        out[impl] = {job: _run_main(tmain, paths[impl][job], device="cpu")
                     for job in JOBS}
        out[impl]["grads"] = dpo_grads(artifact, impl)
        if dist.get_rank() != 0:
            out[impl]["grads"].pop("grads")
    dist.destroy_process_group()
    return out


# -- the test process -------------------------------------------------------

def _jax_side(tmp, artifact, data) -> dict:
    """The JAX entrypoint on each job over ``cp=2``, and ``jax.grad`` of
    its DPO loss on the same batch."""
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import io as jio
    from kubedl_tpu.train import __main__ as jmain
    from kubedl_tpu.train import dpo as jdpo
    out = {job: _run_main(jmain, _config(tmp, artifact, data, job, "jax"))
           for job in ("ppl", "mc", "eval")}
    cfg, params = jio.load_model(artifact)
    batch = {k: jnp.asarray(v) for k, v in _dpo_batch().items()}
    loss, grads = jax.value_and_grad(jdpo.make_dpo_loss_fn(
        cfg, jdpo.DPOConfig(beta=0.2), chunk=64))(params, batch)
    flat = {"/".join(str(k.key) for k in kp): np.asarray(v, np.float32)
            for kp, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    out["grads"] = {"loss": float(loss), "grads": flat}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, one-process results, JAX results, the artifact)."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import io as jio
    from kubedl_tpu.models import llama as jllama
    from kubedl_tpu_torch.train import __main__ as tmain
    tmp = tmp_path_factory.mktemp("cp_eval_dpo")
    artifact = str(tmp / "art")
    jcfg = dataclasses.replace(jllama.tiny(), dtype=jnp.float32, **SHAPE)
    jio.save_model(jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(1)),
                   artifact)
    data = _data(tmp)
    paths = {impl: {job: _config(tmp, artifact, data, job, "cp", impl)
                    for job in JOBS} for impl in IMPLS}
    with ThreadPoolExecutor(max_workers=1) as pool:
        jax_future = pool.submit(_jax_side, tmp, artifact, data)
        ranks = launch.spawn(rank_main, WORLD, artifact, paths, timeout=300)
        one = {job: _run_main(tmain, _config(tmp, artifact, data, job,
                                             "one"), device="cpu")
               for job in JOBS}
        one["grads"] = dpo_grads(artifact)
        jax_ref = jax_future.result()
    return ranks, one, jax_ref, artifact


@pytest.mark.parametrize("impl", IMPLS)
def test_perplexity_over_cp_matches_one_process_and_jax(runs, impl):
    ranks, one, jax_ref = runs[:3]
    got = ranks[0][impl]["ppl"]["results"]
    for want in (one["ppl"]["results"], jax_ref["ppl"]["results"]):
        assert got["kind"] == want["kind"] == "perplexity"
        assert got["tokens"] == want["tokens"]
        np.testing.assert_allclose(got["nll"], want["nll"], rtol=RTOL)
        np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                                   rtol=RTOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_choices_over_cp_match_one_process_and_jax(runs, impl):
    ranks, one, jax_ref = runs[:3]
    got = ranks[0][impl]["mc"]["results"]
    assert got == one["mc"]["results"] == jax_ref["mc"]["results"]
    assert got["kind"] == "loglikelihood" and got["questions"] == 5


@pytest.mark.parametrize("impl", IMPLS)
def test_dpo_steps_over_cp_match_one_process(runs, impl):
    """Every rank reports the global loss: ln 2 first (the policy starts
    as its reference), then the one-process run's."""
    ranks, one = runs[:2]
    for rank in ranks:
        got = rank[impl]["dpo"]["losses"]
        assert len(got) == 2 and abs(got[0] - np.log(2)) < 1e-6
        np.testing.assert_allclose(got, one["dpo"]["losses"], rtol=RTOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_dpo_gradients_over_cp_match_one_process_and_jax(runs, impl):
    ranks, one, jax_ref = runs[:3]
    got = ranks[0][impl]["grads"]
    assert ranks[1][impl]["grads"]["loss"] == got["loss"]
    for want in (one["grads"], jax_ref["grads"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for k, w in want["grads"].items():
            np.testing.assert_allclose(
                got["grads"][k], w, rtol=GRAD_RTOL, err_msg=k,
                atol=1e-5 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("impl", IMPLS)
def test_in_training_eval_over_cp_matches_one_process_and_jax(runs, impl):
    ranks, one, jax_ref = runs[:3]
    for rank in ranks:
        got = rank[impl]["eval"]
        assert len(got["evals"]) == 1
        np.testing.assert_allclose(got["losses"], one["eval"]["losses"],
                                   rtol=RTOL)
        for want in (one["eval"]["evals"], jax_ref["eval"]["evals"]):
            np.testing.assert_allclose(got["evals"][0]["val_nll"],
                                       want[0]["val_nll"], rtol=RTOL)


def test_choices_refuse_a_pad_that_cp_does_not_split():
    """Options pad to JAX's 128-aligned length; a ``cp`` that does not
    divide it is refused by name before anything runs."""
    import types

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.train import evaluate as tev
    shape = {a: 3 if a == "cp" else 1 for a in ("dp", "fsdp", "ep", "pp",
                                                "cp", "tp")}
    mesh = types.SimpleNamespace(shape=shape, sharded=True,
                                 device_mesh=object(),
                                 size=lambda a: shape[a])
    with pytest.raises(ValueError, match=r"pad to 128 tokens.*cp=3"):
        tev.loglikelihood_ranks(llama.tiny(), {}, [
            {"prompt": [1, 2], "options": [[3]]}], mesh=mesh)


def test_the_jax_choices_over_cp_need_a_row_count_the_data_axes_divide(
        runs, tmp_path):
    """Reference fault 5: the JAX entrypoint's choices over ``cp=2`` (on
    the 8 fake devices ``fsdp`` takes 4) raise in the ring's
    ``shard_map``, which splits a question's 3 option rows over the data
    axes; the port runs the same job (the tests above)."""
    import re

    from kubedl_tpu.train import __main__ as jmain
    path = tmp_path / "mc_jax_cp.json"
    cfg = json.loads(open(_config(tmp_path, runs[3], _data(tmp_path), "mc",
                                  "jax")).read())
    path.write_text(json.dumps({**cfg, "mesh": {"cp": 2}}))
    with pytest.raises(ValueError, match=re.escape(
            "not evenly divisible by the corresponding mesh axis")):
        jmain.main(["--config", str(path)])
