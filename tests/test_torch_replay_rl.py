"""The port's RL flywheel held against the JAX package's on the CPU: the
flywheel day of the JAX package's ``test_flywheel_replay_small_profile``
(the ``routing`` fleet day cut to 300 requests over 300 s, 4 rollout
batches, a publish every 2, the elastic resize after 3) through
``FlywheelReplay`` on the same JAX-made weights, and the weight
publisher's install.

Rollouts sample at temperature 1 and the two frameworks' draws differ, so
the rewards and ``losses`` are held only to themselves (finite, the same
for a seed). Every other field (the user-facing serving observations and
the ``rl`` block's scheduling, versions, publishes and resize) is equal
to JAX's. The port's learner world is 1 (no process group); JAX's is the
conftest's 8 virtual CPU devices resized to 4.

The publisher installs a version with ``load_weights``, which prefills
each registered prefix again under the new weights in the blocks it
holds; the JAX publisher assigns ``engine.params`` and its prefixes keep
the old weights' K/V (reference fault 4): both are pinned here."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from kubedl_tpu.models import io as jio
from kubedl_tpu.replay import fleet as jfleet_replay
from kubedl_tpu.replay import rl as jrl
from kubedl_tpu.replay import serving as jserving
from kubedl_tpu.rl import WeightPublisher as JPublisher
from kubedl_tpu.serving import batching as jbatching
from kubedl_tpu.serving import fleet as jfleet
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.replay import fleet as tfleet_replay
from kubedl_tpu_torch.replay import rl as trl
from kubedl_tpu_torch.rl import WeightPublisher as TPublisher
from kubedl_tpu_torch.serving import batching as tbatching
from kubedl_tpu_torch.serving import fleet as tfleet

#: ``test_flywheel_replay_small_profile``'s job
SPEC = dict(total_batches=4, publish_every=2, resize_after_batches=3,
            gen_interval_s=5.0, max_new_tokens=4)
#: the fields of the ``rl`` block that depend on the sampled tokens
SAMPLED = {"losses"}
#: the system prompt: 2 full blocks of 8 and a tail
PREFIX = list(range(3, 23))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's days on one CPU thread: their steps are many tiny ops,
    which intra-op threads only slow down (and, beside other test
    processes, slow down many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _profile(mod):
    return dataclasses.replace(
        mod.FLEET_PROFILES["routing"], name="rl-smoke", sim_seconds=300.0,
        requests=300, bursts=4)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The JAX replay's tiny model and a moved copy of it (a new policy),
    as artifacts both packages load."""
    cfg, params = jserving._tiny_model()
    rng = np.random.default_rng(5)
    moved = jax.tree.map(
        lambda x: x + 0.5 * np.std(np.asarray(x)) * rng.standard_normal(
            x.shape).astype(np.float32), params)
    out = []
    for name, p in (("old", params), ("new", moved)):
        path = str(tmp_path_factory.mktemp(name))
        jio.save_model(cfg, p, path)
        out.append(path)
    return out


@pytest.fixture(scope="module")
def days(paths):
    """The JAX day, and the port's day twice on the same weights (on one
    thread: the CPU's embedding backward adds repeated tokens' rows in a
    thread-dependent order, so two runs agree bit for bit only there)."""
    want = jrl.FlywheelReplay(jfleet_replay.generate_fleet(
        _profile(jfleet_replay), 0), spec=jrl.RLJobSpec(**SPEC)).run()
    got = [trl.FlywheelReplay(
        tfleet_replay.generate_fleet(_profile(tfleet_replay), 0),
        spec=trl.RLJobSpec(**SPEC),
        model=tio.load_model(paths[0], device="cpu"), device="cpu").run()
        for _ in range(2)]
    return want, got


def test_the_flywheel_day_is_the_jax_one_but_for_the_draws(days):
    want, (got, _) = days
    assert set(got) == set(want)
    for key in want:
        if key != "rl":
            assert got[key] == want[key], key
    assert set(got["rl"]) == set(want["rl"])
    for key in set(want["rl"]) - SAMPLED:
        assert got["rl"][key] == want["rl"][key], key
    rl = got["rl"]
    assert rl["job_complete"] == 1 and rl["batches_consumed"] == 4
    assert rl["publishes"] == 2 and rl["replicas_rolled"] == 6
    assert rl["elastic_resizes"] == 1 and rl["resize_at_step"] == 3
    assert rl["resize_restore_bit_identical"] == 1
    assert set(rl["serving_versions"].values()) == {rl["policy_version"]}
    assert got["dropped_streams"] == 0 and rl["rollout_dropped"] == 0


def test_the_losses_are_finite_and_repeat_for_a_seed(days):
    _, (first, second) = days
    losses = first["rl"]["losses"]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert first["rl"]["loss_finite"] == 1
    assert second == first


def _pool_kv(pool, blocks) -> np.ndarray:
    """The K and V of ``blocks`` of a paged pool, stacked, on the host."""
    idx = list(blocks)
    return np.stack([np.asarray(pool[k])[:, idx] for k in ("k", "v")])


def _publish(fleet_mod, publisher_cls, fleet, new_params):
    """Roll version 1 across ``fleet`` with the publisher, one reconcile
    at a time; returns the actions and the most replicas ever out of the
    placement set at once."""
    pub = publisher_cls(fleet)
    pub.begin_publish(1, new_params)
    actions, most_out = [], 0
    while not pub.idle:
        act = pub.step()
        if act is not None:
            actions.append(act)
        most_out = max(most_out, sum(r.draining for r in fleet.replicas))
        fleet.step()
    return actions, most_out


def _fleet(fleet_mod, make_engine):
    fleet = fleet_mod.ServingFleet(make_engine, replicas=3)
    for rep in fleet.replicas:
        rep.engine.register_prefix(PREFIX, pinned=True)
        for n in (3, 5):       # traffic in flight when the roll begins
            rep.engine.submit(PREFIX + [n] * n, 4)
    return fleet


ENGINE = dict(lanes=2, max_len=64, kv_mode="paged", kv_block=8,
              pool_blocks=24)


def test_a_publish_refills_the_prefixes_under_the_new_weights(paths):
    """The port's install: after the roll every replica's prefix blocks
    hold what a fresh registration under the new weights fills, in the
    same blocks, with the registration, the residency epoch and the
    counted prefill tokens untouched; one replica is out at a time."""
    old, new = paths
    fleet = _fleet(tfleet, lambda i: tbatching.ContinuousBatchingEngine(
        *tio.load_model(old, device="cpu"), device="cpu", **ENGINE))
    before = [(rep.engine._prefixes[0].blocks, rep.engine.residency_epoch)
              for rep in fleet.replicas]
    _, new_params = tio.load_model(new, device="cpu")
    actions, most_out = _publish(tfleet, TPublisher, fleet, new_params)
    assert most_out == 1
    fresh = tbatching.ContinuousBatchingEngine(
        *tio.load_model(new, device="cpu"), device="cpu", **ENGINE)
    fresh.register_prefix(PREFIX, pinned=True)
    want = _pool_kv(fresh._pool, fresh._prefixes[0].blocks)
    for rep, (blocks, epoch) in zip(fleet.replicas, before):
        eng = rep.engine
        assert rep.policy_version == 1 and not rep.draining
        assert eng.has_prefix(PREFIX) and eng._prefixes[0].blocks == blocks
        assert eng.residency_epoch == epoch
        np.testing.assert_array_equal(_pool_kv(eng._pool, blocks), want)
    # two requests a replica, each prefilling only its suffix past the
    # shared full blocks (the refill is no request's prefill)
    assert [rep.engine.prefill_tokens_total for rep in fleet.replicas] \
        == [(20 + 3 - 16) + (20 + 5 - 16)] * 3
    # and the publisher's log is the JAX one's
    jfleet_ = _fleet(jfleet, lambda i: jbatching.ContinuousBatchingEngine(
        *jio.load_model(old), **ENGINE))
    jactions, _ = _publish(jfleet, JPublisher, jfleet_,
                           jio.load_model(new)[1])
    assert actions == jactions
    assert sum(a.startswith("installed") for a in actions) == 3


def test_the_jax_publisher_keeps_the_old_prefix_kv(paths):
    """Reference fault 4: the JAX install assigns ``engine.params``, so a
    replica's registered prefix keeps the K/V of the weights it was
    registered under: the new policy decodes over stale prefix K/V."""
    old, new = paths
    fleet = _fleet(jfleet, lambda i: jbatching.ContinuousBatchingEngine(
        *jio.load_model(old), **ENGINE))
    kept = [_pool_kv(rep.engine._pool, rep.engine._prefixes[0].blocks)
            for rep in fleet.replicas]
    _publish(jfleet, JPublisher, fleet, jio.load_model(new)[1])
    fresh = jbatching.ContinuousBatchingEngine(*jio.load_model(new),
                                               **ENGINE)
    fresh.register_prefix(PREFIX, pinned=True)
    want = _pool_kv(fresh._pool, fresh._prefixes[0].blocks)
    for rep, kv in zip(fleet.replicas, kept):
        got = _pool_kv(rep.engine._pool, rep.engine._prefixes[0].blocks)
        np.testing.assert_array_equal(got, kv)
        assert np.abs(got - want).max() > 1e-2


def test_the_replay_gives_each_replica_tensors_of_its_own(paths):
    """A publish writes into the tensors one replica serves: replicas
    built from one tree must not share them."""
    replay = trl.FlywheelReplay(
        tfleet_replay.generate_fleet(_profile(tfleet_replay), 0),
        spec=trl.RLJobSpec(**SPEC),
        model=tio.load_model(paths[0], device="cpu"), device="cpu")
    try:
        ptrs = [{t.data_ptr() for t in _leaves(rep.engine.params)}
                for rep in replay.fleet.replicas]
        learner = {t.data_ptr() for t in _leaves(replay.learner.state.params)}
        for i, a in enumerate(ptrs):
            assert not a & learner
            assert all(not a & b for b in ptrs[i + 1:])
    finally:
        replay._mngr.close()
        replay._ckpt_tmp.cleanup()


def _leaves(tree) -> list:
    from kubedl_tpu_torch.train.trainer import tree_leaves
    return [t for _, t in tree_leaves(tree)]


def test_the_flywheel_replay_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trl.FlywheelReplay(tfleet_replay.generate_fleet(
            _profile(tfleet_replay), 0), spec=trl.RLJobSpec(**SPEC))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfleet_replay.ServingFleetReplay(
            tfleet_replay.generate_fleet(_profile(tfleet_replay), 0))
