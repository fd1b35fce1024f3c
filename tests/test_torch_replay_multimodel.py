"""The port's multi-model fleet day (``replay/multimodel.py``) held
against the JAX package's on the CPU: the day of the JAX package's
``test_smoke_multimodel_replay_deterministic`` (60 requests over 120 s,
seed 1, a 6-adapter catalog over 2 replicas capped at 2 residents), both
arms, on the same JAX-made float32 tiny model carried across by
``models/io.py``, each observation dict equal key by key; and the
workloads' fingerprints."""

import dataclasses

import pytest
import torch

from kubedl_tpu.models import io as jio
from kubedl_tpu.replay import multimodel as jmm
from kubedl_tpu.replay import serving as jserving
from kubedl_tpu_torch.models import io as tio
from kubedl_tpu_torch.replay import multimodel as tmm

#: the JAX package's multi-model smoke profile (tests/test_multimodel.py)
MM_SMOKE = dict(sim_seconds=240.0, requests=100, bursts=6, replicas=2,
                max_replicas=2, decode_lanes=4, prefill_lanes=1,
                pool_blocks=64, prefixes=6, max_prefixes_per_replica=4,
                zipf_s=0.7, adapters=6, adapter_pages=2,
                adapter_share=0.7, max_adapters_per_replica=2,
                adapter_fault_page_s=0.03)
#: its determinism test's day
DAY = dict(requests=60, sim_seconds=120.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's days on one CPU thread: their steps are many tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg, params = jserving._tiny_model()
    path = str(tmp_path_factory.mktemp("mm_tiny"))
    jio.save_model(cfg, params, path)
    return (cfg, params), tio.load_model(path, device="cpu")


def _profiles(**over):
    kw = {**MM_SMOKE, **over}
    return (jmm.MultiModelProfile(name="mm-smoke", **kw),
            tmm.MultiModelProfile(name="mm-smoke", **kw))


@pytest.mark.parametrize("affinity", [True, False],
                         ids=["adapter_aware", "adapter_blind"])
def test_the_multimodel_day_is_the_jax_one(tiny, affinity):
    jmodel, tmodel = tiny
    jp, tp = _profiles(**DAY)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    want = jmm.MultiModelReplay(jmm.generate_multimodel(jp, 1),
                                adapter_affinity=affinity,
                                model=jmodel).run()
    got = tmm.MultiModelReplay(tmm.generate_multimodel(tp, 1),
                               adapter_affinity=affinity, model=tmodel,
                               device="cpu").run()
    for key in want:
        assert got[key] == want[key], key
    assert got == want
    mm = got["multi_model"]
    assert mm["models_reported"] == mm["models"] == 6
    assert got["requests_completed"] == got["requests_submitted"] == 60
    assert got["dropped_streams"] == 0 and got["errors"] == 0
    assert mm["adapter_faults"] > 0 and mm["hbm"]["within_cap"] == 1


def test_the_comparison_is_the_jax_ones_legs(tiny, monkeypatch):
    """``run_multimodel_comparison`` on the smoke day: both legs, the
    fingerprint and the ratios equal JAX's (the JAX one always runs its
    tiny model, so both take the same JAX-made weights here)."""
    jmodel, tmodel = tiny
    jp, tp = _profiles(**DAY)
    monkeypatch.setitem(jmm.MULTIMODEL_PROFILES, "mm-smoke", jp)
    monkeypatch.setitem(tmm.MULTIMODEL_PROFILES, "mm-smoke", tp)
    real = jmm.MultiModelReplay.__init__

    def with_model(self, workload, adapter_affinity=True, model=None):
        real(self, workload, adapter_affinity, model=jmodel)
    monkeypatch.setattr(jmm.MultiModelReplay, "__init__", with_model)
    want = jmm.run_multimodel_comparison(1, "mm-smoke")
    got = tmm.run_multimodel_comparison(1, "mm-smoke", model=tmodel,
                                        device="cpu")
    assert got == want
    assert got["adapter_aware"]["multi_model"]["adapter_faults"] < \
        got["adapter_blind"]["multi_model"]["adapter_faults"]


@pytest.mark.parametrize("over", [DAY, {}], ids=["day", "smoke"])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_workloads_fingerprint_as_the_jax_ones(over, seed):
    jp, tp = _profiles(**over)
    want = jmm.generate_multimodel(jp, seed)
    got = tmm.generate_multimodel(tp, seed)
    assert got.fingerprint() == want.fingerprint()
    assert [dataclasses.asdict(a) for a in got.arrivals] == \
        [dataclasses.asdict(a) for a in want.arrivals]


def test_the_committed_profile_fingerprints_as_the_jax_one():
    assert tmm.generate_multimodel("multimodel", 0).fingerprint() == \
        jmm.generate_multimodel("multimodel", 0).fingerprint()


def test_the_catalog_and_objectives_are_the_jax_ones():
    jp, tp = _profiles(**DAY)
    jw, tw = jmm.generate_multimodel(jp, 1), tmm.generate_multimodel(tp, 1)
    tcat, jcat = tmm.catalog_for(tw), jmm.catalog_for(jw)
    assert tcat.models() == jcat.models()
    assert [dataclasses.asdict(tcat.spec(m)) for m in tcat.models()] == \
        [dataclasses.asdict(jcat.spec(m)) for m in jcat.models()]
    assert tmm.multimodel_slos(tw) == jmm.multimodel_slos(jw)
