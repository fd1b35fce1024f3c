"""The predictor entry point under ``KUBEDL_SERVING_TP=2`` on the CPU:
``main([...], device="cpu")`` is rank 0 (this process) and starts rank 1
as ``python -m kubedl_tpu_torch.serving.tp``, a gloo process on one
core, which loads only its shard of the artifact and follows rank 0's
device steps. Batch mode writes the JAX ``run_batch``'s rows on one
JAX-made artifact, then returns 0 with the follower exited and rank 0's
group closed. A follower that exits while serving is seen by rank 0's
watcher, which aborts rank 0's groups, and the predictor returns 1."""

import dataclasses
import json
import signal
import threading
import time
import urllib.request

import pytest
import torch.distributed as dist

import jax
import jax.numpy as jnp

from kubedl_tpu.models import io as jio
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.serving import __main__ as jmain
from kubedl_tpu_torch.parallel import launch
from kubedl_tpu_torch.serving import __main__ as tmain


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_tp_main")
    cfg = dataclasses.replace(jllama.tiny(vocab=128), n_heads=4,
                              n_kv_heads=2, dtype=jnp.float32)
    jio.save_model(cfg, jllama.init_params(cfg, jax.random.PRNGKey(0)),
                   str(root / "target"))
    return str(root / "target")


def test_batch_mode_over_two_ranks_writes_the_jax_rows(artifact, tmp_path,
                                                       monkeypatch):
    rows = [{"prompt": [1 + i, 2, 3] * (1 + i % 3), "max_tokens": 3 + i}
            for i in range(6)]
    inp = tmp_path / "in.jsonl"
    inp.write_text("\n".join(json.dumps(r) for r in rows))
    for key, value in {"KUBEDL_MODEL_PATH": artifact,
                       "KUBEDL_SERVING_LANES": "2",
                       "KUBEDL_SERVING_MAX_LEN": "64"}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("KUBEDL_TOKENIZER", raising=False)
    monkeypatch.delenv("KUBEDL_KV_MODE", raising=False)
    monkeypatch.delenv("KUBEDL_SERVING_TP", raising=False)
    out_j, out_t = tmp_path / "jax.jsonl", tmp_path / "torch.jsonl"
    assert jmain.main(["--batch-input", str(inp),
                       "--batch-output", str(out_j)]) == 0
    started = []
    real = launch.start_local_ranks

    def record(*a, **kw):
        started.append(real(*a, **kw))
        return started[-1]
    monkeypatch.setattr(launch, "start_local_ranks", record)
    monkeypatch.setenv("KUBEDL_SERVING_TP", "2")
    assert tmain.main(["--batch-input", str(inp),
                       "--batch-output", str(out_t)], device="cpu") == 0
    assert out_t.read_text() == out_j.read_text()
    (ranks,) = started
    assert [p.poll() for p in ranks.procs] == [0]   # the follower exited
    assert not ranks.failed.is_set()
    assert not dist.is_initialized()


def test_a_follower_exit_is_seen_by_rank_zero(tmp_path):
    """A follower that dies (here: its artifact path does not exist)
    exits non-zero, sets ``failed``, which ends a serving predictor, and
    aborts rank 0's groups, so no collective of rank 0 waits on it."""
    spec = {"model_path": str(tmp_path / "missing")}
    ranks = launch.start_local_ranks(
        2, "kubedl_tpu_torch.serving.tp", ["--spec", json.dumps(spec)],
        "cpu", 60.0)
    try:
        assert ranks.failed.wait(60)
        assert ranks.exit_codes[1] != 0
        deadline = time.monotonic() + 10
        while dist.is_initialized() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not dist.is_initialized()
    finally:
        codes = ranks.close()
    assert codes[1] != 0
    assert not dist.is_initialized()


def test_a_follower_killed_while_serving_ends_the_predictor_with_1(
        artifact, monkeypatch):
    """The predictor serves over two ranks (warm-up, then the HTTP front);
    its follower is killed; ``main`` drains and returns 1 within seconds,
    with rank 0's groups gone."""
    port = launch.free_port()
    for key, value in {"KUBEDL_MODEL_PATH": artifact,
                       "KUBEDL_SERVING_LANES": "2",
                       "KUBEDL_SERVING_MAX_LEN": "64",
                       "KUBEDL_SERVING_TP": "2",
                       "KUBEDL_SERVING_PORT": str(port),
                       "KUBEDL_TOKENIZER": "off"}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("KUBEDL_KV_MODE", raising=False)
    started, killed = [], []
    real = launch.start_local_ranks

    def record(*a, **kw):
        started.append(real(*a, **kw))
        return started[-1]
    monkeypatch.setattr(launch, "start_local_ranks", record)

    def kill_when_serving():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.2)
        started[0].procs[0].kill()
        killed.append(time.monotonic())

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    threading.Thread(target=kill_when_serving, daemon=True).start()
    try:
        rc = tmain.main([], device="cpu")
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    assert killed and rc == 1
    assert time.monotonic() - killed[0] < 30
    assert started[0].failed.is_set()
    assert not dist.is_initialized()
