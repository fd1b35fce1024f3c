"""Quantized weights and adapter pages under the decode tick's CUDA graph,
on the card. A CUDA graph has no CPU mode, so without a card these tests
skip. On the card (no JAX there, hence no conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_quant_cuda.py -x

The graph captures the int8 rescale and the int4 unpack with the rest of
the tick: on one lane state its logits must equal the eager tick's
exactly, and a whole run must give the eager engine's tokens. With an
adapter catalog the tick stays on the graph route while adapters fault
in, evict and release between ticks.
"""

import dataclasses

import pytest
import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.ops import quant
from kubedl_tpu_torch.serving.adapters import AdapterCatalog, AdapterSpec
from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph is captured there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(card, dtype):
    cfg = dataclasses.replace(llama.tiny(vocab=256), dtype=dtype)
    params = llama.init_params(cfg, torch.Generator(card).manual_seed(0),
                               device=card)
    return cfg, params


def _requests():
    g = torch.Generator().manual_seed(2)
    out = []
    for i in range(7):
        n = int(torch.randint(1, 40, (1,), generator=g))
        out.append((torch.randint(1, 255, (n,), generator=g).tolist(),
                    12 + 3 * i))
    return out


def _engine(model, route, **kw):
    eng = ContinuousBatchingEngine(*model, lanes=3, max_len=128, kv_block=16,
                                   **kw)
    if route == "eager":
        for tick in eng._ticks():
            tick.route = "eager"
    return eng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_graph_tick_equals_the_eager_tick_on_quantized_weights(card, mode,
                                                               dtype):
    model = _model(card, dtype)
    wrapper = quant.QTensor if mode == "int8" else quant.Q4Tensor
    want = _engine(model, "eager", quantize=mode).run(_requests())
    eng = _engine(model, "graph", quantize=mode)
    assert isinstance(eng.params["layers"]["w_gate"], wrapper)
    assert eng.params["layers"]["w_gate"].device.type == "cuda"
    assert eng.run(_requests()) == want
    assert eng.tick_launches["eager"] == 0 < eng.tick_launches["graph"]
    for p, n in _requests()[:3]:
        eng.submit(p, n)
    eng.step()
    eng.step()
    graph = eng.decode_tick().clone()
    eager = eng.decode_tick("eager")
    active = [i for i, l in enumerate(eng._lane_state) if l.request]
    assert active
    assert float((graph[active] - eager[active]).abs().max()) == 0.0


def test_graph_route_holds_with_an_adapter_catalog(card):
    """Adapters fault in, evict (cap 2 over 3 adapters) and release
    between replays: the tokens are the base model's and every tick
    replays the graph; every page returns to the pool."""
    model = _model(card, "bfloat16")
    reqs = _requests()
    want = _engine(model, "eager").run(reqs)
    cat = AdapterCatalog()
    for m in ("m-a", "m-b", "m-c"):
        cat.register(AdapterSpec(model=m, pages=2))
    eng = _engine(model, "graph", adapters=cat, max_adapters=2)
    rs = [eng.submit(p, n, model=["", "m-a", "m-b", "m-c"][i % 4])
          for i, (p, n) in enumerate(reqs)]
    eng.run([])
    assert [r.result() for r in rs] == want
    st = eng.adapter_status()
    assert sum(st["faults"].values()) >= 3 and st["evictions"] >= 1
    assert eng.tick_launches["eager"] == 0 < eng.tick_launches["graph"]
    assert eng._bpool.free_count == eng.pool_blocks - st["pages"]
