"""The cluster replay of the port against the JAX one.

``ClusterReplay`` drives a job day through the real control plane (the
API server, the manager, the slice scheduler and the job engine, under
chaos) and no serving engine; the port keeps a copy of it and of the
closure it runs. Both packages run the ``smoke`` job day at seed 0 (as
``tests/test_replay.py`` does), once each, and the scorecards agree key
by key.
"""

import json

import pytest

from kubedl_tpu.replay import ClusterReplay as JClusterReplay
from kubedl_tpu.replay import generate as jgenerate
from kubedl_tpu_torch.replay import ClusterReplay, generate

#: the smoke day's scorecard keys
RESULT_KEYS = ("chaos", "chaos_preemptions_executed", "controlplane",
               "engine_metrics", "goodput", "jobs_completed",
               "jobs_submitted", "makespan_s", "offered_load", "placement",
               "queue_delays_s", "restart_mttrs_s", "restart_rounds_traced",
               "rounds", "scheduler", "slice_utilization", "slo",
               "slo_health", "trace")


@pytest.fixture(scope="module")
def days():
    return (JClusterReplay(jgenerate("smoke", 0)).run(),
            ClusterReplay(generate("smoke", 0)).run())


def test_the_smoke_day_has_the_jax_days_keys(days):
    want, got = days
    assert sorted(got) == sorted(want) == sorted(RESULT_KEYS)


@pytest.mark.parametrize("key", RESULT_KEYS)
def test_the_smoke_day_is_the_jax_one(days, key):
    """No key holds the package's name, so nothing is normalised."""
    want, got = days
    assert json.dumps(got[key], sort_keys=True) == \
        json.dumps(want[key], sort_keys=True)


def test_the_smoke_day_completes_every_job(days):
    _, got = days
    assert got["jobs_completed"] == got["jobs_submitted"] > 0
