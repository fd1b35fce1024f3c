"""Checkpoints in the port (``torch.distributed.checkpoint`` in place of
Orbax), held to the JAX package's contract on the CPU: the three call
shapes of ``save`` and the no-op for a step on disk, ``max_to_keep``,
the host copy an asynchronous save takes at the step boundary, a
``llama.tiny`` run resumed at step 2 ending bit for bit where an
uninterrupted 4-step run ends, the data cursor and its fingerprint, the
object-store tier (a ``.uploading`` orphan is never served, the nearest
tier restores, ``flush`` raises on a failed upload) and the elastic
agent against the JAX package's in-memory API server, conflicts
included."""

import dataclasses
import json
import os
import shutil

import pytest
import torch

from kubedl_tpu.api import common as c
from kubedl_tpu.controllers.chaos import ChaosAPIServer, ChaosConfig
from kubedl_tpu.core import meta as m
from kubedl_tpu.core.apiserver import APIServer, ApiError, Conflict
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.train import __main__ as tmain
from kubedl_tpu_torch.train import checkpoint as ck
from kubedl_tpu_torch.train import data as tdata
from kubedl_tpu_torch.train import trainer as ttrainer

OPT = dict(learning_rate=1e-2, warmup_steps=1, decay_steps=10)


def _cfg(dtype="float32"):
    return dataclasses.replace(tllama.tiny(vocab=128, seq=64), dtype=dtype)


def _trainer(cfg):
    return ttrainer.Trainer(
        lambda p, b: tllama.loss_fn(cfg, p, b["tokens"], b["targets"]),
        ttrainer.TrainConfig(**OPT), device="cpu")


def _state(cfg, trainer, seed=0):
    return trainer.init_state(tllama.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))


def _stream(cfg, skip=0):
    raw = tdata.synthetic_lm_batches(2, 32, cfg.vocab_size, seed=3,
                                     skip=skip)
    return tdata.CountingIterator(tdata.prefetch_to_device(raw, "cpu"),
                                  consumed=skip)


def _same_state(a, b) -> None:
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for (k, x), (_, y) in zip(ttrainer.tree_leaves(a.params),
                              ttrainer.tree_leaves(b.params)):
        assert x.dtype == y.dtype and torch.equal(x, y), k
    for moment in ("mu", "nu"):
        ma, mb = getattr(a.opt_state, moment), getattr(b.opt_state, moment)
        assert sorted(ma) == sorted(mb)
        for k in ma:
            assert ma[k].dtype == mb[k].dtype and torch.equal(ma[k], mb[k])


@pytest.mark.parametrize("async_save", [False, True])
def test_save_call_shapes_and_the_no_op(tmp_path, async_save):
    cfg = _cfg()
    state = _state(cfg, _trainer(cfg))
    mngr = ck.CheckpointManager(ck.CheckpointConfig(
        str(tmp_path), save_interval_steps=0, async_save=async_save))
    at = dataclasses.replace
    # periodic with no interval: disabled
    assert not mngr.save(at(state, step=3), periodic=True)
    # an explicit request always saves, whatever the interval
    assert mngr.save(at(state, step=3))
    # the same step again (on disk, or still being written): a no-op
    assert not mngr.save(at(state, step=3), force=True)
    mngr.wait_until_finished()
    assert not mngr.save(at(state, step=3))
    assert mngr.all_steps() == [3]
    mngr.config.save_interval_steps = 2
    assert not mngr.save(at(state, step=5), periodic=True)   # off-interval
    assert mngr.save(at(state, step=6), periodic=True)       # on it
    assert mngr.save(at(state, step=7), force=True)          # forced
    mngr.wait_until_finished()
    assert mngr.all_steps() == [3, 6, 7] and mngr.latest_step() == 7
    assert not any(n.endswith(".partial") for n in os.listdir(tmp_path))


def test_max_to_keep_keeps_the_newest(tmp_path):
    cfg = _cfg()
    state = _state(cfg, _trainer(cfg))
    mngr = ck.CheckpointManager(ck.CheckpointConfig(
        str(tmp_path), max_to_keep=2, async_save=True))
    for step in range(1, 6):
        assert mngr.save(dataclasses.replace(state, step=step))
    mngr.wait_until_finished()
    assert mngr.all_steps() == [4, 5]


def test_restore_round_trips_into_the_template_device_and_dtype(tmp_path):
    cfg = _cfg("bfloat16")
    trainer = _trainer(cfg)
    state = _state(cfg, trainer)
    batches = _stream(cfg)
    for _ in range(2):
        state, _ = trainer.step(state, next(batches))
    mngr = ck.CheckpointManager(ck.CheckpointConfig(str(tmp_path),
                                                    async_save=False))
    assert mngr.save(state)
    assert mngr.last_save["bytes"] > 0 and mngr.last_save["step"] == 2
    fresh = _state(cfg, _trainer(cfg), seed=9)
    restored = mngr.restore(fresh)
    assert restored.params is fresh.params      # loaded in place
    _same_state(restored, state)
    assert restored.params["embed"].dtype == torch.bfloat16
    assert restored.params["embed"].requires_grad
    assert mngr.last_restore["step"] == 2


def test_an_async_save_keeps_the_state_of_its_step(tmp_path):
    """The trainer updates its tensors in place: the save copies them to
    the host when it is called, so a later update does not leak in."""
    cfg = _cfg()
    trainer = _trainer(cfg)
    state = _state(cfg, trainer)
    want = {k: t.detach().clone() for k, t in
            ttrainer.tree_leaves(state.params)}
    mngr = ck.CheckpointManager(ck.CheckpointConfig(str(tmp_path)))
    assert mngr.save(state)
    state, _ = trainer.step(state, next(_stream(cfg)))     # in place
    mngr.wait_until_finished()
    restored = mngr.restore(_state(cfg, _trainer(cfg), seed=4))
    for k, t in ttrainer.tree_leaves(restored.params):
        assert torch.equal(t, want[k]), k


def test_a_torn_save_is_never_served_and_is_swept(tmp_path):
    os.makedirs(tmp_path / "9.partial" / "state")
    mngr = ck.CheckpointManager(ck.CheckpointConfig(str(tmp_path)))
    assert mngr.latest_step() is None and not os.listdir(tmp_path)
    cfg = _cfg()
    state = _state(cfg, _trainer(cfg))
    assert mngr.restore_or(state, lambda: "fresh") == "fresh"
    assert mngr.latest_data_state() is None


def _fit(cfg, steps, mngr=None, resume=False):
    trainer = _trainer(cfg)
    state = _state(cfg, trainer)
    skip = 0
    if resume:
        skip = mngr.latest_data_state()["consumed_batches"]
        state = mngr.restore_or(state, lambda: state)
    batches = _stream(cfg, skip=skip)
    losses = []
    state = trainer.fit(
        state, batches, num_steps=steps, log_every=0,
        on_step=lambda s, loss: losses.append((s, loss)),
        checkpoint_manager=mngr,
        data_state_fn=lambda: {"consumed_batches": batches.consumed})
    return state, losses


def test_a_run_resumed_at_step_2_ends_bit_identical(tmp_path):
    cfg = _cfg()
    whole, whole_losses = _fit(cfg, 4)
    mngr = ck.CheckpointManager(ck.CheckpointConfig(
        str(tmp_path), save_interval_steps=2))
    first, first_losses = _fit(cfg, 2, mngr)
    assert mngr.all_steps() == [2]
    assert mngr.latest_data_state() == {"consumed_batches": 2}
    mngr = ck.CheckpointManager(ck.CheckpointConfig(
        str(tmp_path), save_interval_steps=2))
    resumed, resumed_losses = _fit(cfg, 2, mngr, resume=True)
    assert first_losses + resumed_losses == whole_losses
    _same_state(resumed, whole)
    assert mngr.all_steps() == [2, 4]


def _main_config(tmp_path, **over):
    cfg = {"model": "llama.tiny",
           "model_overrides": {"dtype": "float32", "vocab_size": 128},
           "batch": 2, "seq": 32, "steps": 2, "log_every": 0,
           "optimizer": OPT,
           "checkpoint": {"directory": str(tmp_path / "ck"),
                          "save_interval_steps": 2}, **over}
    path = tmp_path / f"train{len(over)}.json"
    path.write_text(json.dumps(cfg))
    return ["--config", str(path)]


def test_the_cursor_resumes_only_its_own_stream(tmp_path, caplog):
    losses = []
    tmain.main(_main_config(tmp_path), device="cpu",
               on_step=lambda s, loss: losses.append(loss))
    data = json.loads((tmp_path / "ck" / "2" / "data.json").read_text())
    assert data["consumed_batches"] == 2
    assert data["fingerprint"] == {"mode": "pretrain", "batch": 2,
                                   "seq": 32, "data": {"kind": "synthetic"}}
    # another corpus: the saved offset means nothing for it
    caplog.clear()
    tmain.main(_main_config(tmp_path, data={"kind": "synthetic",
                                            "seed": 5}), device="cpu")
    assert "fingerprint mismatch" in caplog.text
    data = json.loads((tmp_path / "ck" / "4" / "data.json").read_text())
    assert data["consumed_batches"] == 2        # restarted at batch 0


# -- the object-store tier --------------------------------------------------------

def test_a_torn_upload_is_never_served(tmp_path):
    local, remote = tmp_path / "local", tmp_path / "object"
    os.makedirs(local / "4")
    (local / "4" / "state.bin").write_bytes(b"x" * 64)
    tiers = ck.CheckpointTiers(str(local), str(remote))
    os.makedirs(remote / ("7" + ck.CheckpointTiers.UPLOADING_SUFFIX))
    assert tiers.object_steps() == []
    assert tiers.nearest_step() == 4
    tiers.publish(4)
    tiers.flush()
    assert tiers.object_steps() == [4]
    assert (remote / "4" / "state.bin").read_bytes() == b"x" * 64
    os.makedirs(remote / ("8" + ck.CheckpointTiers.UPLOADING_SUFFIX))
    os.makedirs(local / "8")
    (local / "8" / "state.bin").write_bytes(b"y")
    tiers.publish(8)
    tiers.flush()
    assert tiers.object_steps() == [4, 8] and tiers.swept == 1
    tiers.close()


def test_flush_raises_on_a_failed_upload(tmp_path):
    local, remote = tmp_path / "local", tmp_path / "object"
    os.makedirs(local)
    tiers = ck.CheckpointTiers(str(local), str(remote),
                               poll_interval_s=0.005, ready_timeout_s=0.02)
    tiers.publish(5)                    # step 5 never finalizes locally
    with pytest.raises(RuntimeError, match="step\\(s\\) \\[5\\]"):
        tiers.flush()
    assert tiers.object_steps() == []
    tiers.close()


def test_the_tiered_manager_restores_from_the_nearest_tier(tmp_path):
    cfg = _cfg()
    trainer = _trainer(cfg)
    state = _state(cfg, trainer)
    state, _ = trainer.step(state, next(_stream(cfg)))
    local, remote = tmp_path / "local", tmp_path / "object"
    mngr = ck.TieredCheckpointManager(ck.CheckpointConfig(str(local)),
                                      str(remote))
    assert mngr.save(state, force=True, data_state={"consumed_batches": 1})
    mngr.wait_until_finished()          # flushes the upload too
    assert mngr.tiers.object_steps() == [1]
    mngr.close()
    shutil.rmtree(local)                # a fresh host: the local disk is gone
    mngr = ck.TieredCheckpointManager(ck.CheckpointConfig(str(local)),
                                      str(remote))
    assert mngr.latest_step() == 1
    assert mngr.latest_data_state() == {"consumed_batches": 1}
    _same_state(mngr.restore(_state(cfg, _trainer(cfg), seed=3)), state)
    mngr.close()


#: how much slower than a save an upload is in the slowed case: a save
#: that waited for an earlier upload would take at least this long
SLOW_UPLOAD_S = 1.0


def _tiered_saves(manager, state_at, case):
    """Saves at steps 2-4, 0.2 s apart, through ``manager`` with its
    object-tier uploads slowed or failing: (returns, seconds of each
    save, what ``latest_data_state`` gave, whether ``flush`` raised).
    An untimed save at step 1 comes first: it takes the manager's
    one-time costs (the JAX manager's first save pays its set-up), and
    its upload is one that each timed save could wrongly wait for. The
    managers keep all four steps: an upload waits for its step on the
    local tier, and retention would delete it first."""
    import time
    tiers = manager.tiers
    upload = tiers._upload
    if case == "slow":
        def slowed(step):
            time.sleep(SLOW_UPLOAD_S)
            upload(step)
        tiers._upload = slowed
    else:
        tiers.max_attempts = 1

        def failing(step):
            raise OSError("object store unreachable")
        tiers._upload = failing
    manager.save(state_at(1), step=1, data_state={"step": 1})
    time.sleep(0.2)
    returns, seconds = [], []
    for step in (2, 3, 4):
        t0 = time.perf_counter()
        returns.append(bool(manager.save(state_at(step), step=step,
                                         data_state={"step": step})))
        seconds.append(time.perf_counter() - t0)
        time.sleep(0.2)
    cursor = manager.latest_data_state()
    try:
        manager.wait_until_finished()      # the public join does flush
        raised = False
    except RuntimeError:
        raised = True
    manager.close()
    return returns, seconds, cursor, raised


@pytest.mark.parametrize("case", ["slow", "failing"])
def test_tiered_save_does_not_wait_for_uploads(tmp_path, case):
    """A save joins only its own write, never the object tier's uploads
    of earlier steps: with uploads slowed, the saves return as fast as
    the JAX manager's; with uploads failing for good, later saves still
    return True, as the JAX manager's do. ``wait_until_finished`` (the
    public join) flushes the uploads and raises for a failed one in both
    packages."""
    import jax.numpy as jnp

    from kubedl_tpu.train import checkpoint as jck
    from kubedl_tpu.train.trainer import TrainState as JState
    port = ck.TieredCheckpointManager(
        ck.CheckpointConfig(str(tmp_path / "port"), max_to_keep=4),
        str(tmp_path / "port_object"))

    def port_state(step):
        return ttrainer.TrainState(
            step=step, params={"w": torch.full((256, 256), float(step))},
            opt_state=ttrainer.AdamState(count=step, mu={}, nu={}))
    got = _tiered_saves(port, port_state, case)
    ref = jck.TieredCheckpointManager(
        jck.CheckpointConfig(str(tmp_path / "jax"), max_to_keep=4),
        str(tmp_path / "jax_object"))

    def jax_state(step):
        return JState(step=jnp.asarray(step, jnp.int32),
                      params={"w": jnp.full((256, 256), float(step))},
                      opt_state=())
    want = _tiered_saves(ref, jax_state, case)
    assert got[0] == want[0] == [True, True, True]
    # every save returns within 0.5 s, as the JAX manager's do; one that
    # waited for an earlier upload would take SLOW_UPLOAD_S
    assert max(want[1]) < 0.5, want[1]
    assert max(got[1]) < 0.5, got[1]
    assert got[2] == {"step": 4}
    assert got[3] == want[3] == (case == "failing")


# -- the elastic agent --------------------------------------------------------------

def _job(api, name="ej"):
    job = m.new_obj("test.kubedl.io/v1alpha1", "TestJob", name)
    job["spec"] = {}
    api.create(job)


def _request(api, version):
    api.patch_merge("TestJob", "default", "ej", {"metadata": {
        "annotations": {c.ANNOTATION_CKPT_REQUESTED_VERSION: str(version)}}})


def test_the_agent_saves_and_acknowledges(tmp_path, api):
    assert ck.ANNOTATION_CKPT_REQUESTED_VERSION == \
        c.ANNOTATION_CKPT_REQUESTED_VERSION
    assert ck.ANNOTATION_CKPT_COMPLETED_VERSION == \
        c.ANNOTATION_CKPT_COMPLETED_VERSION
    cfg = _cfg()
    state = _state(cfg, _trainer(cfg))
    _job(api)
    mngr = ck.CheckpointManager(ck.CheckpointConfig(str(tmp_path)))
    agent = ck.ElasticCheckpointAgent(
        api, "TestJob", "default", "ej", mngr, retry_on=ApiError,
        data_state_fn=lambda: {"consumed_batches": 7})
    assert agent.poll(state) is False          # nothing requested
    _request(api, 2)
    assert agent.poll(state) is True
    ann = m.annotations(api.get("TestJob", "default", "ej"))
    assert ann[c.ANNOTATION_CKPT_COMPLETED_VERSION] == "2"
    assert mngr.latest_step() == 0
    assert mngr.latest_data_state() == {"consumed_batches": 7}
    assert agent.poll(state) is False          # acked: idempotent


def test_the_agent_retries_conflicts_and_adopts_a_newer_request(clock):
    inner = APIServer(clock=clock)
    chaos = ChaosAPIServer(inner, ChaosConfig(seed=3), clock=clock)
    _job(inner)
    saves = []

    class Manager:
        def save(self, state, force=False, data_state=None):
            saves.append(force)
            return True

        def wait_until_finished(self):
            pass

    agent = ck.ElasticCheckpointAgent(chaos, "TestJob", "default", "ej",
                                      Manager(), retry_on=ApiError)
    _request(inner, 3)
    chaos.fail_next("patch", Conflict, times=2, kind="TestJob")
    assert agent.poll(object()) is True
    ann = m.get_annotations(inner.get("TestJob", "default", "ej"))
    assert ann[c.ANNOTATION_CKPT_COMPLETED_VERSION] == "3"
    # the controller bumps the request while the agent's ack conflicts:
    # the re-read adopts it (the checkpoint just taken covers it)

    class Bumping:
        first = True

        def try_get(self, *args):
            return inner.try_get(*args)

        def patch_merge(self, *args):
            if self.first:
                self.first = False
                _request(inner, 9)
                raise Conflict("409 on the ack")
            return inner.patch_merge(*args)

    agent.api = Bumping()
    _request(inner, 6)
    assert agent.poll(object()) is True
    ann = m.get_annotations(inner.get("TestJob", "default", "ej"))
    assert ann[c.ANNOTATION_CKPT_COMPLETED_VERSION] == "9"
    assert agent.poll(object()) is False
    assert saves == [True, True]
    # the port's own error type is the default it retries on
    assert ck.ElasticCheckpointAgent(inner, "TestJob", "default", "ej",
                                     Manager()).retry_on is ck.ApiError
