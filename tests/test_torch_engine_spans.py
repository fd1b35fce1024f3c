"""The continuous-batching engine's decode-step spans (``engine.step``,
``engine.tick``, ``engine.sample``) on a tiny paged engine on the CPU."""

import dataclasses

import pytest
import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.serving.batching import ContinuousBatchingEngine
from kubedl_tpu_torch.trace import Tracer

PROMPTS = [([1, 2, 3, 4, 5], 4), ([7] * 12, 3), ([9, 9], 5)]


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(llama.tiny(vocab=64), d_model=32, d_ff=64,
                              n_layers=1, dtype=torch.float32)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")


def _engine(model, tracer):
    cfg, params = model
    return ContinuousBatchingEngine(cfg, params, lanes=2, max_len=32,
                                    kv_mode="paged", kv_block=8,
                                    tracer=tracer, device="cpu")


def test_each_decode_step_records_a_step_a_tick_and_a_sample(model):
    tracer = Tracer(enabled=True)
    eng = _engine(model, tracer)
    seen = []                    # each tick's live lanes' contexts
    decode_p = eng._decode_p

    def spy(cur, pos, tables):
        seen.append([int(pos[i]) + 1 for i, lane in
                     enumerate(eng._lane_state) if lane.request is not None])
        return decode_p(cur, pos, tables)

    eng._decode_p = spy
    for prompt, n in PROMPTS:
        eng.submit(prompt, n)
    while eng.step():
        pass
    spans = tracer.spans()
    steps = [s for s in spans if s.name == "engine.step"]
    assert len(steps) == len(seen) > 0
    assert [s.attributes["step"] for s in steps] == list(
        range(1, len(steps) + 1))
    assert sum(s.attributes["admitted"] for s in steps) == len(PROMPTS)
    assert sum(s.attributes["prefill_tokens"] for s in steps) == sum(
        len(p) for p, _ in PROMPTS)
    launches = []
    for step, contexts in zip(steps, seen):
        assert step.parent_id is None and step.component == "serving"
        kids = {s.name: s for s in spans if s.parent_id == step.span_id}
        assert sorted(kids) == ["engine.sample", "engine.tick"]
        tick, sample = kids["engine.tick"], kids["engine.sample"]
        assert {tick.trace_id, sample.trace_id} == {step.trace_id}
        assert step.start <= tick.start <= tick.end == sample.start \
            <= sample.end <= step.end
        assert tick.start <= tick.attributes["launch_at"] <= tick.end
        assert tick.attributes["lanes"] == len(contexts)
        assert tick.attributes["context"] == sum(contexts)
        launches.append(tick.attributes["launch"])
    assert launches == list(range(launches[0], launches[0] + len(steps)))
    assert launches[-1] == eng.tick_launches["eager"]
    prefills = [s for s in spans if s.name == "request.prefill"]
    assert sorted(s.attributes["tokens"] for s in prefills) == sorted(
        len(p) for p, _ in PROMPTS)
    for s in prefills:
        assert set(s.attributes) == {"tokens", "lane", "sharedBlocks"}
        assert s.trace_id != step.trace_id and s.parent_id


def test_a_disabled_tracer_reads_no_clock_and_records_nothing(model):
    reads = []

    def clock():
        reads.append(1)
        return 0.0

    tracer = Tracer(enabled=False, clock=clock)
    eng = _engine(model, tracer)
    for prompt, n in PROMPTS:
        eng.submit(prompt, n)
    steps = 0
    while eng.step():
        steps += 1
    assert steps > 0 and eng.tick_launches["eager"] > 0
    assert reads == [] and tracer.spans() == []
