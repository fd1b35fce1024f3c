"""Each cell's whole path at tiny widths on the CPU, the port against the
plain reference; and the same path with the timed path broken
underneath, or the reference in float8 in the program's place, which
must come out not correct."""

import pytest
import torch

from portbench import check, serve_cell, train_cell, weights
from portbench.reference import train as ref_train

from .tiny import correct, run_of


@pytest.mark.parametrize("kind", ["train", "chat", "batch"])
def test_a_cell_is_correct_against_the_reference(kind):
    res = (train_cell if kind == "train" else serve_cell).run(run_of(kind))
    assert correct(res), res.checks
    assert res.attempted > 0 and res.failed == 0
    assert res.e2e["setup_s"] > 0
    if kind == "train":
        assert res.e2e["train_tokens_per_s"] > 0
    elif kind == "chat":
        assert res.e2e["itl_mean_ms"] > 0
    else:
        assert res.e2e["output_tokens_per_s"] > 0


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    from kubedl_tpu_torch.train.trainer import Trainer

    def frozen(self, state, batch):
        loss, _ = self._grads(state.params, batch)
        return state, loss

    monkeypatch.setattr(Trainer, "step", frozen)
    res = train_cell.run(run_of("train"))
    assert res.checks["change_gap"]["value"] == pytest.approx(1.0)
    assert not correct(res)


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    build = train_cell.build
    monkeypatch.setattr(train_cell, "build",
                        lambda run: build(run, batch_rows=1))
    res = train_cell.run(run_of("train"))
    assert not correct(res), res.checks


@pytest.mark.parametrize("kind", ["chat", "batch"])
def test_a_token_altered_where_it_is_produced_is_caught(kind, monkeypatch):
    from kubedl_tpu_torch.serving.batching import Request
    push = Request._push

    def altered(self, tok, lp):
        if len(self.tokens) == 1:
            tok = (tok + 1) % 256
        push(self, tok, lp)

    monkeypatch.setattr(Request, "_push", altered)
    res = serve_cell.run(run_of(kind))
    assert not correct(res), res.checks


def test_the_training_control_fails():
    """The reference in float8 e4m3 put in the program's place."""
    run = run_of("train")
    stream = train_cell.feed(run)
    batches = [next(stream) for _ in range(3)]
    opt = dict(run.cell["optimizer"], eps=1e-8)
    ref = ref_train.run(run.cfg, run.seed, batches, opt, weights.make_leaf,
                        run.device)
    low = ref_train.run(run.cfg, run.seed, batches, opt, weights.make_leaf,
                        run.device, precision="fp8")
    got = check.training(low, ref)
    assert any(got[k] > run.cell["limits"][k] for k in got), got


@pytest.mark.parametrize("kind", ["chat", "batch"])
def test_the_serving_control_fails(kind):
    """At each served position, the token float8 puts first, read in the
    float32 reference."""
    run = run_of(kind)
    res = serve_cell.run(run)
    picked = serve_cell.sample(run, res.ctx.client.done)
    gaps = serve_cell.reference_gaps(run, picked, ("f32", "fp8"))
    number = {"logit_gap": max,
              "logit_gap_mean": lambda g: sum(g) / len(g)}
    for name, limit in run.cell["limits"].items():
        assert number[name](gaps["f32"]) <= limit
        assert number[name](gaps["fp8"]) > limit


def test_fp8_rounds_and_passes_the_gradient_through():
    from portbench.reference.model import fp8
    x = torch.tensor([1.0, 0.3, -448.0 / 3], requires_grad=True)
    y = fp8(x)
    assert y.detach().tolist() != x.detach().tolist()
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]


def test_the_sample_spans_several_requests():
    """The longest finished request by its last tokens, the others by
    their first ones, at most ``check_per_request`` tokens each."""
    run = run_of("chat")
    res = serve_cell.run(run)
    done = [r for r in res.ctx.client.done if not r.error]
    picked = serve_cell.sample(run, done)
    per = run.cell["check_per_request"]
    assert len(picked) == min(run.cell["check_requests"], len(done)) > 1
    longest = max(done, key=lambda r: len(r.prompt) + len(r.tokens))
    assert picked[0].prompt == longest.prompt
    assert picked[0].tokens[picked[0].lo:] == longest.tokens[-per:]
    for view in picked:
        rows, toks = serve_cell.compared(view)
        assert 0 < len(toks) <= per
        n = len(view.prompt) + len(view.tokens) - 1
        assert len(range(n)[rows]) == len(toks)
    for view in picked[1:]:
        assert view.lo == 0


@pytest.mark.parametrize("kind", ["chat", "batch"])
def test_the_readings_set_the_program_below_the_control(kind):
    """``calibrate readings`` at a tiny size: the program (float32 here)
    reads under the cell's limit, the float8 control and every token
    altered over it."""
    from portbench import calibrate
    run = run_of(kind)
    out = calibrate.serve_readings(run, control=True)
    (name, limit), = run.cell["limits"].items()
    key = {"logit_gap": "", "logit_gap_mean": "_mean"}[name]
    assert out["requests"] > 1
    assert out["program" + key] <= limit < out["control" + key]
    assert out["altered" + ("_mean" if key else "_token")] > limit
