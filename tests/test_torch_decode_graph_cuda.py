"""The continuous-batching engine's decode tick as a CUDA graph, against
the same tick run eagerly, on the card. A CUDA graph has no CPU mode, so
without a card these tests skip. On the card (no JAX there, hence no
conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graph_cuda.py -x

The engines below (``llama.tiny``, and ``moe.tiny`` whose sparse layer
body the graph captures too) serve more requests than lanes, with a
registered prefix, so between replays lanes grow their block tables,
share prefix blocks, free them and take new requests: only the tables'
values change, and the graph must keep giving the eager tick's tokens.
"""

import dataclasses

import pytest
import torch

from kubedl_tpu_torch.models import llama, moe
from kubedl_tpu_torch.ops.decode import paged_decode
from kubedl_tpu_torch.serving.batching import (ContinuousBatchingEngine,
                                               decode_tick_route)

pytestmark = pytest.mark.cuda

PREFIX = list(range(1, 21))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph is captured there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def model(card):
    cfg = dataclasses.replace(llama.tiny(vocab=256), dtype="float32")
    params = llama.init_params(cfg, torch.Generator(card).manual_seed(0),
                               device=card)
    return cfg, params


def _requests():
    g = torch.Generator().manual_seed(1)
    out = []
    for i in range(9):
        n = int(torch.randint(1, 17, (1,), generator=g))
        prompt = torch.randint(1, 255, (n,), generator=g).tolist()
        if i % 3 == 0:
            prompt = PREFIX + prompt
        out.append((prompt, 20 + 5 * i))
    return out


def _engine(model, route, **kw):
    cfg, params = model
    eng = ContinuousBatchingEngine(cfg, params, lanes=3, max_len=128,
                                   kv_block=16, **kw)
    if route == "eager":
        for tick in eng._ticks():
            tick.route = "eager"
    if eng.kv_mode != "dense":
        eng.register_prefix(PREFIX)
    return eng


@pytest.mark.parametrize("mode", ["dense", "paged", "parity"])
def test_graph_tick_gives_the_eager_tokens(model, mode):
    assert decode_tick_route("cuda") == "graph"
    reqs = _requests()
    kw = dict(kv_mode=mode)
    if mode == "paged":
        kw["pool_blocks"] = 8         # 3 full lanes need 24: preempts
    want = _engine(model, "eager", **kw).run(reqs)
    eng = _engine(model, "graph", **kw)
    assert eng.run(reqs) == want
    ticks = eng.tick_launches
    assert ticks["eager"] == 0 and ticks["graph"] > 0
    if mode == "paged":
        assert eng.preempted > 0
        assert eng.pool_stats()["blocks_used"] == 1


def test_graph_replays_count_the_attention_kernel(model):
    """Each layer of a paged tick calls the attention kernel once: the two
    warm-up ticks before the capture launch it, the captured tick only
    records it, and every replay counts it again."""
    cfg, _ = model
    eng = _engine(model, "graph", kv_mode="paged")
    launches, captured = paged_decode.launches, paged_decode.captured
    eng.run(_requests())
    replays = eng.tick_launches["graph"]
    assert replays > 0 and paged_decode.captured - captured == cfg.n_layers
    assert paged_decode.launches - launches == (2 + replays) * cfg.n_layers


def test_graph_tick_with_prefill_lanes_and_spec_lanes(model):
    cfg, params = model
    reqs = _requests()
    want = _engine(model, "eager", kv_mode="paged").run(reqs)
    eng = _engine(model, "graph", kv_mode="paged", prefill_lanes=1)
    assert eng.run(reqs) == want and eng.handoffs > 0
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = {**params, "layers": {k: v[:1]
                                    for k, v in params["layers"].items()}}
    spec = _engine(model, "graph", kv_mode="paged", draft_config=dcfg,
                   draft_params=dparams, spec_k=3)
    assert spec.run(reqs) == want
    assert spec.tick_launches["eager"] == 0
    assert spec._d_tick.launches["graph"] > 0


def test_graph_self_draft_accepts_everything(model):
    """The target as its own draft: every proposal is accepted, so the
    accepted tokens' K/V commits interleave with replays of both graphs,
    and the tokens stay the eager engine's."""
    cfg, params = model
    reqs = _requests()
    want = _engine(model, "eager", kv_mode="paged").run(reqs)
    spec = _engine(model, "graph", kv_mode="paged", draft_config=cfg,
                   draft_params=params, spec_k=3)
    assert spec.run(reqs) == want
    assert spec.stats.proposed > 0
    assert spec.stats.accepted == spec.stats.proposed
    assert spec.tick_launches["eager"] == 0
    assert spec._d_tick.launches["eager"] == 0
    assert spec._d_tick.launches["graph"] > 0


def test_decode_tick_graph_against_eager_on_one_state(model):
    eng = _engine(model, "graph", kv_mode="paged")
    for p, n in _requests()[:3]:
        eng.submit(p, n)
    eng.step()
    eng.step()
    graph = eng.decode_tick().cpu().numpy()
    eager = eng.decode_tick("eager").cpu().numpy()
    active = [i for i, l in enumerate(eng._lane_state) if l.request]
    assert active
    torch.testing.assert_close(torch.from_numpy(graph[active]),
                               torch.from_numpy(eager[active]),
                               rtol=0, atol=1e-4)
    assert (graph[active].argmax(-1) == eager[active].argmax(-1)).all()
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(*model, lanes=1, max_len=16,
                                 device="cpu").decode_tick("graph")


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_moe_graph_tick_gives_the_eager_tokens(card, mode):
    """The MoE layer body captured in the tick: the router's top-k, the
    choice-major slot cumsum and the expert products replay with the
    eager tick's tokens, and one state's logits agree."""
    cfg = dataclasses.replace(moe.tiny(vocab=256), dtype="float32")
    params = moe.init_params(cfg, torch.Generator(card).manual_seed(0),
                             device=card)
    reqs = _requests()
    want = _engine((cfg, params), "eager", kv_mode=mode).run(reqs)
    eng = _engine((cfg, params), "graph", kv_mode=mode)
    assert eng.run(reqs) == want
    ticks = eng.tick_launches
    assert ticks["eager"] == 0 and ticks["graph"] > 0
    for p, n in reqs[:3]:
        eng.submit(p, n)
    eng.step()
    graph = eng.decode_tick().cpu()
    eager = eng.decode_tick("eager").cpu()
    active = [i for i, l in enumerate(eng._lane_state) if l.request]
    torch.testing.assert_close(graph[active], eager[active], rtol=0,
                               atol=1e-4)
