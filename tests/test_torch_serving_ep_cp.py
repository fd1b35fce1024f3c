"""Both serving engines over an expert-parallel (``ep=2``), a
context-parallel (``cp=2``), a data-parallel (``dp=2``), an ``fsdp=2``
and a pipeline (``pp=2``) mesh across processes, held against the port
on one process and against the JAX package's engines.

One 2-rank gloo group is spawned once for the file
(``parallel.launch.spawn``, each rank on one CPU thread); every case runs
in it. Under ``ep`` each rank holds 2 of MoE tiny's 4 experts of every
stack (as the JAX ``shard_for_serving`` places them) and the experts'
outputs are summed over ``ep``; under ``cp`` (Llama tiny) the params and
the cache are replicated and every rank runs the whole step, and so
they are over ``dp`` and ``pp``; under ``fsdp`` each rank holds JAX's
``embed`` shard of every weight and the step gathers each one per use.
The
continuous engine runs with rank 0 scheduling and rank 1 repeating its
device steps (paged with a prefix, dense, speculative lanes with the
draft on the mesh, the embeddings forward); the static engine runs SPMD.
The weights are JAX-made float32 and cross over as numpy.

Tolerances: float32 sums in another order (the ``ep`` partial sums) move
the logits by ~1e-7 of their scale, so greedy tokens are held equal and
logits and hidden states within 1e-5.

The rank functions import nothing of JAX (the ranks import this module);
the JAX side runs in the test process only.
"""

import dataclasses

import numpy as np
import pytest

from kubedl_tpu_torch.parallel import launch

WORLD = 2
VOCAB = 128
ATOL = 1e-5
REQS = [([5, 7, 11], 6), ([3], 4), ([9, 2, 4], 5)]
PREFIX = [7, 7, 7, 7]
PREFIXED = [([7, 7, 7, 7, 1], 5)]
STATIC_PROMPTS = [[5, 7, 11], [3], [9, 2]]
EMBED = [[5, 7, 11, 2], [3, 9, 0, 0]]
#: name -> (family, JAX-side overrides, the mesh axis it is served over)
MODELS = {"moe": ("moe", {}, "ep"), "llama": ("llama", {}, "cp"),
          "draft": ("llama", dict(d_model=64, n_layers=1, d_ff=128), None)}
SEEDS = {"moe": 4, "llama": 0, "draft": 2}
#: the continuous-engine cases of each model: engine keywords
ENGINES = {"paged": dict(lanes=2, max_len=96),
           "dense": dict(lanes=2, max_len=96, kv_mode="dense")}
#: the axes that place nothing (``dp``, ``pp``) or the ``embed`` dim
#: (``fsdp``), each serving Llama tiny over 2 ranks
OTHER_AXES = ("dp", "fsdp", "pp")


def _tcfg(name):
    from kubedl_tpu_torch.models import llama, moe
    family, over, _ = MODELS[name]
    make = {"llama": llama.tiny, "moe": moe.tiny}[family]
    return dataclasses.replace(make(vocab=VOCAB), dtype="float32", **over)


def _tparams(name, models):
    from kubedl_tpu_torch.models import io
    return io.params_from_numpy(_tcfg(name), models[name], device="cpu")


def _logit_recorder(eng) -> list:
    """The logits of every target decode tick the engine runs."""
    seen = []
    for seam in ("_decode", "_decode_p"):
        real = getattr(eng, seam)

        def record(*a, _real=real):
            out = _real(*a)
            seen.append(out.float().numpy().copy())
            return out
        setattr(eng, seam, record)
    return seen


def _cases(mesh, name, models, cases=("paged", "dense", "spec")) -> dict:
    """The engine ``cases`` of model ``name`` over ``mesh`` and the static
    engine: rank 0 reports what it served, rank 1 how many steps it
    followed."""
    from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.engine import (GenerateConfig,
                                                 InferenceEngine)

    def continuous(body, **kw):
        eng = ContinuousBatchingEngine(_tcfg(name), _tparams(name, models),
                                       mesh=mesh, device="cpu", **kw)
        if not eng._channel.leader:
            return {"followed": eng.follow()}
        try:
            return body(eng)
        finally:
            eng.stop()

    def with_prefix(eng):
        seen = _logit_recorder(eng)
        out = {"tokens": eng.run(REQS)}
        eng.register_prefix(PREFIX)
        out["prefixed"] = eng.run(PREFIXED)
        out["logits"] = seen
        out["tick_launches"] = eng.tick_launches
        out["world"] = eng._channel.world
        out["hidden"] = eng.hidden_states(np.asarray(EMBED)).numpy()
        return out

    def spec(eng):
        return {"tokens": eng.run(REQS), "proposed": eng.stats.proposed,
                "accepted": eng.stats.accepted}

    out = {case: continuous(with_prefix, **kw)
           for case, kw in ENGINES.items() if case in cases}
    if "spec" in cases:
        out["spec"] = continuous(spec, lanes=2, max_len=64,
                                 draft_config=_tcfg("draft"),
                                 draft_params=_tparams("draft", models),
                                 spec_k=2)
    static = InferenceEngine(_tcfg(name), _tparams(name, models),
                             GenerateConfig(max_len=64), mesh=mesh,
                             device="cpu")
    out["static"] = static.generate(STATIC_PROMPTS, 8)
    layers = static.params["layers"]
    out["leaves"] = {k: tuple(getattr(v, "local", v).shape)
                     for k, v in layers.items()}
    out["w_gate"] = (layers["w_gate"].numpy().copy()
                     if name == "moe" else None)
    out["wq"] = getattr(layers["wq"], "local", layers["wq"]).numpy().copy()
    out["model_mesh"] = dict(static.mesh.shape)
    return out


def _refusals(mesh) -> dict:
    """What every rank refuses at construction, before any collective."""
    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.engine import InferenceEngine
    cfg = _tcfg("moe")
    tries = {
        "quantize": lambda: ContinuousBatchingEngine(
            cfg, {}, mesh=mesh, quantize="int8", device="cpu"),
        "n_experts": lambda: InferenceEngine(
            dataclasses.replace(cfg, n_experts=3), {}, mesh=mesh,
            device="cpu"),
        "fsdp": lambda: InferenceEngine(
            dataclasses.replace(cfg, d_model=129, head_dim=32), {},
            mesh=tmesh.build_mesh(tmesh.MeshConfig(fsdp=2), device="cpu"),
            device="cpu"),
    }
    out = {}
    for name, make in tries.items():
        try:
            make()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def rank_main(models):
    """One rank: open the group, serve MoE tiny over ``ep=2`` and Llama
    tiny over ``cp=2``."""
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel import mesh as tmesh
    from kubedl_tpu_torch.runtime import bootstrap

    bootstrap.initialize_distributed(device="cpu")
    out = {"rank": dist.get_rank()}
    for name in ("moe", "llama"):
        axis = MODELS[name][2]
        mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=1, **{axis: WORLD}),
                                device="cpu")
        out[name] = _cases(mesh, name, models)
    for axis in OTHER_AXES:
        mesh = tmesh.build_mesh(tmesh.MeshConfig(**{"fsdp": 1, axis: WORLD}),
                                device="cpu")
        out[axis] = _cases(mesh, "llama", models, cases=("paged",))
    out["refusals"] = _refusals(tmesh.build_mesh(
        tmesh.MeshConfig(fsdp=1, ep=WORLD), device="cpu"))
    dist.destroy_process_group()
    return out


# -- the test process: references and checks -------------------------------

def _jax_models() -> dict:
    import jax
    import jax.numpy as jnp

    from kubedl_tpu.models import llama as jllama
    from kubedl_tpu.models import moe as jmoe
    out = {}
    for name, (family, over, _) in MODELS.items():
        mod = jmoe if family == "moe" else jllama
        cfg = dataclasses.replace(mod.tiny(vocab=VOCAB), dtype=jnp.float32,
                                  **over)
        out[name] = (cfg, mod.init_params(cfg,
                                          jax.random.PRNGKey(SEEDS[name])))
    return out


def _jax_refs(jmodels) -> dict:
    """The JAX package: ``shard_for_serving``'s expert shards on devices
    0 and 1 of an ``ep=2`` mesh, the static engine over each model's mesh
    (it takes any local mesh), and the unsharded continuous engine."""
    import jax

    from kubedl_tpu.models import moe as jmoe
    from kubedl_tpu.parallel.mesh import MeshConfig, build_mesh
    from kubedl_tpu.serving import engine as jengine
    from kubedl_tpu.serving.batching import ContinuousBatchingEngine
    devices = jax.devices()[:WORLD]
    out = {}
    for name in ("moe", "llama"):
        cfg, params = jmodels[name]
        axis = MODELS[name][2]
        mesh = build_mesh(MeshConfig(fsdp=1, **{axis: WORLD}), devices)
        res = {"static": jengine.InferenceEngine(
            cfg, params, jengine.GenerateConfig(max_len=64),
            mesh=mesh).generate(STATIC_PROMPTS, 8)}
        if name == "moe":
            p, _ = jengine.shard_for_serving(cfg, params, None, mesh)
            res["w_gate"] = {devices.index(s.device): np.asarray(s.data)
                             for s in p["layers"]["w_gate"]
                             .addressable_shards}
        eng = ContinuousBatchingEngine(cfg, params, lanes=2, max_len=96)
        res["tokens"] = eng.run(REQS)
        eng.register_prefix(PREFIX)
        res["prefixed"] = eng.run(PREFIXED)
        out[name] = res
    cfg, params = jmodels["llama"]
    for axis in OTHER_AXES:
        mesh = build_mesh(MeshConfig(**{"fsdp": 1, axis: WORLD}), devices)
        p, _ = jengine.shard_for_serving(cfg, params, None, mesh)
        out[axis] = {
            "static": jengine.InferenceEngine(
                cfg, params, jengine.GenerateConfig(max_len=64),
                mesh=mesh).generate(STATIC_PROMPTS, 8),
            "wq": {devices.index(s.device): np.asarray(s.data)
                   for s in p["layers"]["wq"].addressable_shards}}
    # the refused fsdp split: JAX's placement refuses it too
    rcfg = dataclasses.replace(jmodels["moe"][0], d_model=129, head_dim=32)
    try:
        jengine.shard_for_serving(
            rcfg, jmoe.init_params(rcfg, jax.random.PRNGKey(0)), None,
            build_mesh(MeshConfig(fsdp=WORLD), devices))
        out["fsdp_refused"] = None
    except ValueError as e:
        out["fsdp_refused"] = str(e)
    return out


def _one_process(models) -> dict:
    """The port on one process, no mesh: the same cases."""
    import torch

    from kubedl_tpu_torch.models import io
    from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine
    from kubedl_tpu_torch.serving.engine import (GenerateConfig,
                                                 InferenceEngine)
    out = {}
    for name in ("moe", "llama"):
        res = {"static": InferenceEngine(
            _tcfg(name), _tparams(name, models), GenerateConfig(max_len=64),
            device="cpu").generate(STATIC_PROMPTS, 8)}
        for case, kw in ENGINES.items():
            eng = ContinuousBatchingEngine(_tcfg(name),
                                           _tparams(name, models),
                                           device="cpu", **kw)
            seen = _logit_recorder(eng)
            res[case] = {"tokens": eng.run(REQS), "logits": seen}
        eng = ContinuousBatchingEngine(
            _tcfg(name), _tparams(name, models), lanes=2, max_len=64,
            draft_config=_tcfg("draft"),
            draft_params=_tparams("draft", models), spec_k=2, device="cpu")
        res["spec"] = {"tokens": eng.run(REQS),
                       "accepted": eng.stats.accepted}
        with torch.no_grad():
            hidden = io.family_of(_tcfg(name)).forward_hidden(
                _tcfg(name), _tparams(name, models),
                torch.as_tensor(np.asarray(EMBED)))
        res["hidden"] = (hidden[0] if isinstance(hidden, tuple)
                         else hidden).numpy()
        out[name] = res
    return out


@pytest.fixture(scope="module")
def runs():
    """(rank results, one-process results, JAX results). The JAX side
    compiles on a thread while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    jmodels = _jax_models()
    models = {name: jax.tree.map(lambda x: np.asarray(x, np.float32), p)
              for name, (_, p) in jmodels.items()}
    with ThreadPoolExecutor(max_workers=1) as pool:
        jax_ref = pool.submit(_jax_refs, jmodels)
        ranks = launch.spawn(rank_main, WORLD, models, timeout=240)
        single = _one_process(models)
        return ranks, single, jax_ref.result()


@pytest.mark.parametrize("name", ["moe", "llama"])
@pytest.mark.parametrize("case", sorted(ENGINES))
def test_continuous_engine_over_the_mesh(runs, name, case):
    """Tokens equal JAX's and the one-process port's, with and without a
    registered prefix; every decode tick's logits and the embeddings
    forward's hidden states within 1e-5 of one process; gloo
    collectives keep the tick eager."""
    ranks, single, jax_ref = runs
    got, want = ranks[0][name][case], single[name][case]
    assert got["world"] == WORLD
    assert got["tokens"] == want["tokens"] == jax_ref[name]["tokens"]
    assert got["prefixed"] == jax_ref[name]["prefixed"]
    assert len(got["logits"]) >= len(want["logits"]) > 0
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["hidden"], single[name]["hidden"],
                               rtol=0, atol=ATOL)
    assert got["tick_launches"]["graph"] == 0
    assert got["tick_launches"]["eager"] > 0
    assert ranks[1][name][case]["followed"] > 0


@pytest.mark.parametrize("name", ["moe", "llama"])
def test_static_engine_over_the_mesh_matches_one_process_and_jax(runs,
                                                                 name):
    ranks, single, jax_ref = runs
    for rank in ranks:               # SPMD: every rank decodes the same
        assert rank[name]["static"] == single[name]["static"] == \
            jax_ref[name]["static"]


@pytest.mark.parametrize("name", ["moe", "llama"])
def test_speculative_lanes_with_the_draft_on_the_mesh(runs, name):
    """The one-process speculative engine's tokens and acceptance (MoE's
    verify chunk routes k+1 tokens at a time, so only Llama's equal the
    plain greedy decode's)."""
    ranks, single = runs[:2]
    got = ranks[0][name]["spec"]
    assert got["tokens"] == single[name]["spec"]["tokens"]
    assert got["accepted"] == single[name]["spec"]["accepted"]
    if name == "llama":
        assert got["tokens"] == single[name]["paged"]["tokens"]
    assert got["proposed"] > 0
    assert ranks[1][name]["spec"]["followed"] > 0


def test_each_ep_rank_holds_its_experts_as_jax_places_them(runs):
    """Under ``ep=2`` a rank holds 2 of the 4 experts of every stack, the
    JAX ``shard_for_serving`` shard on the same device bit for bit, and
    every other leaf whole; over ``cp`` every leaf is whole and the model
    runs on a mesh with ``cp`` shown as 1."""
    ranks, _, jax_ref = runs
    for r, rank in enumerate(ranks):
        leaves = rank["moe"]["leaves"]
        assert leaves["w_gate"][1] == leaves["w_up"][1] == \
            leaves["w_down"][1] == 2
        assert leaves["w_router"][-1] == 4
        np.testing.assert_array_equal(rank["moe"]["w_gate"],
                                      jax_ref["moe"]["w_gate"][r])
        assert rank["llama"]["model_mesh"]["cp"] == 1


@pytest.mark.parametrize("axis", OTHER_AXES)
def test_continuous_engine_over_dp_fsdp_and_pp(runs, axis):
    """Tokens equal JAX's and the one-process port's, with and without a
    registered prefix; every decode tick's logits and the embeddings
    forward's hidden states within 1e-5 of one process; the step channel
    spans both ranks and rank 1 repeats every step."""
    ranks, single, jax_ref = runs
    got, want = ranks[0][axis]["paged"], single["llama"]["paged"]
    assert got["world"] == WORLD
    assert got["tokens"] == want["tokens"] == jax_ref["llama"]["tokens"]
    assert got["prefixed"] == jax_ref["llama"]["prefixed"]
    assert len(got["logits"]) >= len(want["logits"]) > 0
    for a, b in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["hidden"], single["llama"]["hidden"],
                               rtol=0, atol=ATOL)
    assert ranks[1][axis]["paged"]["followed"] > 0


@pytest.mark.parametrize("axis", OTHER_AXES)
def test_static_engine_over_dp_fsdp_and_pp(runs, axis):
    """SPMD on both ranks: JAX's engine over the same mesh and the
    one-process port decode the same tokens. ``dp`` and ``pp`` hold every
    leaf whole and run the model with the axis shown as 1; ``fsdp`` holds
    JAX's ``embed`` shard of ``wq`` bit for bit."""
    ranks, single, jax_ref = runs
    for r, rank in enumerate(ranks):
        got = rank[axis]
        assert got["static"] == single["llama"]["static"] == \
            jax_ref[axis]["static"]
        np.testing.assert_array_equal(got["wq"], jax_ref[axis]["wq"][r])
        assert got["model_mesh"][axis] == (WORLD if axis == "fsdp" else 1)


@pytest.mark.parametrize("name", ["quantize", "n_experts", "fsdp"])
def test_refusals_name_the_reason(runs, name):
    """Weight quantization with a mesh is refused in JAX's words; an
    uneven expert split and an ``fsdp`` that does not split the model
    width name their dimension (JAX's placement refuses the latter too:
    every axis serves since the meshes above, and these are the refusals
    left, all shared with the JAX package)."""
    want = {"quantize": "mesh-parallel serving does not compose with "
                        "weight quantization yet",
            "n_experts": "needs n_experts divisible by 2",
            "fsdp": "needs d_model divisible by 2"}[name]
    for rank in runs[0]:
        assert want in (rank["refusals"][name] or ""), name
    if name == "fsdp":
        assert "should be divisible by 2" in (runs[2]["fsdp_refused"]
                                              or "")
