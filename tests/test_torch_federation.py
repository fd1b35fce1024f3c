"""The federation day of the port against the JAX one.

``FederationReplay`` runs three regions in lockstep on one sim clock:
each a journaled, replicated control plane with its scheduler and elastic
gate, and a two-replica serving fleet of continuous-batching engines, the
day's only device work. Both packages run ``SPEC3`` (the three-region
topology of ``tests/test_federation.py``) at seed 0 with the JAX replays'
tiny model, which the port reads from the JAX package's artifact. The
results agree key by key, a second port day repeats the first byte for
byte, and JAX's survival gate holds on the port's result. Each day runs
once, in module-scoped fixtures (about 15 s for the three).
"""

import json

import pytest

from kubedl_tpu.federation import FederationReplay as JFederationReplay
from kubedl_tpu.federation import RegionTopology as JRegionTopology
from kubedl_tpu.models import io as jio
from kubedl_tpu.replay import serving as jserving
from kubedl_tpu_torch.federation import FederationReplay, RegionTopology
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.serving import batching

SPEC3 = ("us-east,us-west,eu-west;us-east~us-west=65/0.02;"
         "us-east~eu-west=140/0.05;us-west~eu-west=150/0.05")
#: the scorecard's keys, as ``FederationReplay._result`` builds them
RESULT_KEYS = ("regions", "regions_alive", "topology_fingerprint",
               "makespan_s", "rounds", "jobs", "serving", "routing",
               "catalog", "shipping", "standbys", "reads", "evacuations",
               "per_region", "slo", "slo_health", "campaign", "forensics")


def _dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The JAX replays' tiny model, and the port's reading of it."""
    cfg, params = jserving._tiny_model()
    path = str(tmp_path_factory.mktemp("fed_tiny"))
    jio.save_model(cfg, params, path)
    return tio.load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_day(tmp_path_factory):
    fed = JFederationReplay(JRegionTopology.parse(SPEC3),
                            str(tmp_path_factory.mktemp("jax_fed")), seed=0)
    return fed, fed.run()


@pytest.fixture(scope="module")
def port_day(model, tmp_path_factory):
    """The port's day, with every engine the fleets' factory builds
    recorded."""
    built = []

    class Recorded(batching.ContinuousBatchingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batching, "ContinuousBatchingEngine", Recorded)
        fed = FederationReplay(RegionTopology.parse(SPEC3),
                               str(tmp_path_factory.mktemp("port_fed")),
                               seed=0, model=model, device="cpu")
        res = fed.run()
    return fed, res, built


@pytest.fixture(scope="module")
def port_day_again(model, tmp_path_factory):
    return FederationReplay(RegionTopology.parse(SPEC3),
                            str(tmp_path_factory.mktemp("port_fed2")),
                            seed=0, model=model, device="cpu").run()


def test_the_day_has_the_jax_days_keys(jax_day, port_day):
    assert sorted(port_day[1]) == sorted(jax_day[1]) == sorted(RESULT_KEYS)


@pytest.mark.parametrize("key", RESULT_KEYS)
def test_the_day_is_the_jax_one(jax_day, port_day, key):
    """No key holds the package's name, so nothing is normalised."""
    assert _dumps(port_day[1][key]) == _dumps(jax_day[1][key])


def test_the_live_status_is_the_jax_ones(jax_day, port_day):
    """The console's ``/api/v1/federation/status`` document at the end
    of the day."""
    assert _dumps(port_day[0].status()) == _dumps(jax_day[0].status())


def test_a_second_day_repeats_the_first_byte_for_byte(port_day,
                                                      port_day_again):
    assert _dumps(port_day_again) == _dumps(port_day[1])


def test_the_survival_gate_holds(port_day):
    """JAX's gate (``tests/test_federation.py``): zero acknowledged
    objects lost at the kill, every job completes (the evacuees in their
    new region), every stream completes, pages fire, none is stranded and
    every one is linked to the ``region_down`` window."""
    _, res, _ = port_day
    assert res["evacuations"]
    for ev in res["evacuations"].values():
        assert ev["ackObjectsAtKill"] > 0 and ev["ackObjectsLost"] == 0
    jobs = res["jobs"]
    assert jobs["completed"] == jobs["submitted"] > 0
    assert jobs["unfinished"] == [] and jobs["evacuated_pending"] == []
    assert jobs["evacuated_completed"] == jobs["evacuated"] >= 1
    serving = res["serving"]
    assert serving["completed_ok"] == serving["streams"] > 0
    assert serving["dropped_non_evacuated"] == []
    health = res["slo_health"]
    assert health["pages_fired"] >= 1 and health["stranded_alerts"] == 0
    assert res["forensics"]["summary"]["pages_unlinked"] == 0


def test_every_engine_takes_the_device_and_the_shared_weights(model,
                                                              port_day):
    """Two replicas in each of the three regions, each on the device the
    day was given and on the weights it was given, not a copy."""
    _, params = model
    _, _, built = port_day
    assert len(built) == 6
    for eng in built:
        assert eng.device.type == "cpu"
        assert eng.params["embed"].data_ptr() == params["embed"].data_ptr()
