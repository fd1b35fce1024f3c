"""The port's API-server client (``kubedl_tpu_torch/core/kubeclient.py``)
against the JAX package's ``KubeAPIServer``: both over one
``tests/fakekube.FakeKube`` store, the same calls give the same objects,
the same error statuses the same error classes, and both retry a
transient 5xx on a read. ``ClusterConfig.in_cluster()`` reads the same
env into the same server, CA file and token file, and a rotated token
file is re-read."""

import ssl
import time

import pytest

from fakekube import FakeKube
from kubedl_tpu.api import common as c
from kubedl_tpu.core import kubeclient as jkc
from kubedl_tpu.core.apiserver import Conflict, Invalid, NotFound
from kubedl_tpu_torch.core import kubeclient as tkc


def pytorchjob(name="pj", ns="default"):
    return {"apiVersion": "training.kubedl.io/v1alpha1",
            "kind": "PyTorchJob",
            "metadata": {"name": name, "namespace": ns,
                         "annotations": {"team": "ml"}},
            "spec": {"pytorchReplicaSpecs": {"Master": {
                "replicas": 1, "template": {"spec": {"containers": [
                    {"name": "pytorch", "image": "img"}]}}}}}}


@pytest.fixture
def fake():
    fk = FakeKube()
    yield fk
    fk.close()


@pytest.fixture
def clients(fake):
    jax_client = jkc.KubeAPIServer(jkc.ClusterConfig(server=fake.url))
    yield jax_client, tkc.KubeAPIServer(tkc.ClusterConfig(server=fake.url))
    jax_client.stop()


def _stable(obj):
    """An object without the fields every write moves."""
    md = {k: v for k, v in obj["metadata"].items()
          if k not in ("resourceVersion", "managedFields")}
    return {**obj, "metadata": md}


def _agent(fake, monkeypatch, kind, manager=None):
    """The elastic agent the port's trainer builds in a pod of a ``kind``
    job (``train.__main__._maybe_elastic_agent``), its in-cluster client
    pointed at ``fake``."""
    from kubedl_tpu_torch.train import __main__ as tmain
    monkeypatch.setattr(tkc.ClusterConfig, "in_cluster", staticmethod(
        lambda: tkc.ClusterConfig(server=fake.url)))
    env = {"KUBEDL_JOB_KIND": kind, "KUBEDL_JOB_NAMESPACE": "default",
           "KUBEDL_JOB_NAME": "pj", "KUBERNETES_SERVICE_HOST": "127.0.0.1"}
    return tmain._maybe_elastic_agent(manager or object(), env)


def test_the_rest_mapping_matches_for_the_job_kinds(fake, clients,
                                                    monkeypatch):
    """Every job kind the operator reconciles (each of its pods carries
    ``KUBEDL_JOB_KIND``) maps, in the client the port's trainer gives its
    elastic agent, to the clientset's version and plural, and to the JAX
    client's path. The copied client itself is JAX's: its default scheme
    lacks ``RLJob``, which the trainer registers. The JAX trainer does
    not, so its client has no mapping for ``RLJob`` (a fault of the
    reference)."""
    from kubedl_tpu_torch.client.clientset import KIND_TABLE, TRAINING_KINDS
    jax_client, port = clients
    assert tkc.api_prefix("v1") == jkc.api_prefix("v1") == "/api/v1"
    assert tkc.DEFAULT_SCHEME == jkc.DEFAULT_SCHEME
    assert "RLJob" in TRAINING_KINDS
    for kind in TRAINING_KINDS:
        agent_api = _agent(fake, monkeypatch, kind).api
        info = KIND_TABLE[kind]
        assert agent_api.mapping(kind) == (info.api_version, info.plural)
        if kind == "RLJob":
            with pytest.raises(Invalid, match="register_kind"):
                jax_client.mapping(kind)
            continue
        assert agent_api.mapping(kind) == port.mapping(kind) \
            == jax_client.mapping(kind), kind
        assert agent_api._path(kind, "ns", "j") == jax_client._path(
            kind, "ns", "j")
    with pytest.raises(tkc.Invalid, match="no REST mapping"):
        port.mapping("Widget")


class _SavingManager:
    """A checkpoint manager that records the agent's saves."""

    def __init__(self):
        self.saved = []

    def save(self, state, force=False, data_state=None):
        self.saved.append((state, force))

    def wait_until_finished(self):
        pass


def test_an_rljob_agent_reads_and_acknowledges_its_own_job(fake, monkeypatch):
    """The RLJob learner's elastic agent, as the port's trainer builds it
    in a pod, reads its job (``try_get``) and acknowledges the requested
    checkpoint (``patch_merge``) on an API server that serves RLJobs. The
    JAX trainer's agent fails at its first read on the same job."""
    import fakekube
    from kubedl_tpu.train import __main__ as jmain
    from kubedl_tpu_torch.train.checkpoint import (
        ANNOTATION_CKPT_COMPLETED_VERSION, ANNOTATION_CKPT_REQUESTED_VERSION)
    monkeypatch.setitem(fakekube.PLURAL_TO_KIND, "rljobs", "RLJob")
    job = pytorchjob()
    job["kind"] = "RLJob"
    job["metadata"]["annotations"][ANNOTATION_CKPT_REQUESTED_VERSION] = "3"
    fake.api.create(job)

    manager = _SavingManager()
    agent = _agent(fake, monkeypatch, "RLJob", manager)
    assert agent.api.try_get("RLJob", "default", "pj")["kind"] == "RLJob"
    assert agent.poll("state") is True
    assert manager.saved == [("state", True)]
    ann = fake.api.get("RLJob", "default", "pj")["metadata"]["annotations"]
    assert ann[ANNOTATION_CKPT_COMPLETED_VERSION] == "3"
    assert agent.poll("state") is False  # acknowledged: nothing pending

    # the reference fault: the JAX trainer's client has no RLJob mapping
    monkeypatch.setattr(jkc.ClusterConfig, "in_cluster", staticmethod(
        lambda: jkc.ClusterConfig(server=fake.url)))
    for key, value in {"KUBEDL_JOB_KIND": "RLJob",
                       "KUBEDL_JOB_NAMESPACE": "default",
                       "KUBEDL_JOB_NAME": "pj",
                       "KUBERNETES_SERVICE_HOST": "127.0.0.1"}.items():
        monkeypatch.setenv(key, value)
    jagent = jmain._maybe_elastic_agent(object())
    with pytest.raises(Invalid, match="no REST mapping"):
        jagent.poll("state")


@pytest.mark.parametrize("kind", ["PyTorchJob", "JAXJob", "TFJob", "MPIJob",
                                  "XGBoostJob", "XDLJob", "MarsJob",
                                  "ElasticDLJob"])
def test_get_try_get_and_patch_merge_give_equal_objects(fake, clients,
                                                        kind):
    jax_client, port = clients
    job = pytorchjob()
    job["kind"], job["apiVersion"] = kind, jax_client.mapping(kind)[0]
    jax_client.create(job)
    assert _stable(port.get(kind, "default", "pj")) == \
        _stable(jax_client.get(kind, "default", "pj"))
    assert port.try_get(kind, "default", "nope") is None
    assert jax_client.try_get(kind, "default", "nope") is None
    patch = {"metadata": {"annotations": {
        c.ANNOTATION_CKPT_COMPLETED_VERSION: "4", "team": None}}}
    got = port.patch_merge(kind, "default", "pj", patch)
    assert got["metadata"]["annotations"] == {
        c.ANNOTATION_CKPT_COMPLETED_VERSION: "4"}
    # the JAX client's read of the port's write, and its own patch
    assert _stable(jax_client.get(kind, "default", "pj")) == _stable(got)
    want = jax_client.patch_merge(kind, "default", "pj", {"metadata": {
        "annotations": {c.ANNOTATION_CKPT_REQUESTED_VERSION: "5"}}})
    assert _stable(port.try_get(kind, "default", "pj")) == _stable(want)


@pytest.mark.parametrize("status,error", [(404, NotFound), (409, Conflict),
                                          (422, Invalid)])
def test_errors_map_to_the_same_classes(fake, clients, status, error):
    """404 from a missing object; 409 and 422 from a store that raises
    them on the patch (FakeKube maps Conflict to 409, Invalid to 422)."""
    jax_client, port = clients
    jax_client.create(pytorchjob())
    real = fake.api.patch_merge

    def failing(*args):
        raise error("injected")

    if status != 404:
        fake.api.patch_merge = failing
    try:
        caught = []
        for client in (jax_client, port):
            with pytest.raises(Exception) as info:
                if status == 404:
                    client.get("PyTorchJob", "default", "missing")
                else:
                    client.patch_merge("PyTorchJob", "default", "pj",
                                       {"metadata": {}})
            caught.append(info.value)
    finally:
        fake.api.patch_merge = real
    got_jax, got_port = caught
    assert type(got_jax).__name__ == type(got_port).__name__ \
        == error.__name__
    assert got_jax.code == got_port.code == status
    assert isinstance(got_port, tkc.ApiError)
    # the same mapping for every status and method (a POST's 409 is
    # ``AlreadyExists``, any other 409 a ``Conflict``)
    for code in (400, 404, 409, 422, 429, 500, 503):
        for method in ("GET", "PATCH", "POST", "PUT", "DELETE"):
            a = jkc.KubeAPIServer._error(code, b'{"message": "m"}', method,
                                         "/p")
            b = tkc.KubeAPIServer._error(code, b'{"message": "m"}', method,
                                         "/p")
            assert (type(a).__name__, a.code, str(a)) == \
                (type(b).__name__, b.code, str(b))


def test_reads_retry_a_transient_5xx(fake, clients, monkeypatch):
    """As ``test_kubeclient.py::test_get_retries_on_transient_5xx``: two
    500s, then the object; a patch that meets a 500 raises at once."""
    jax_client, port = clients
    jax_client.create(pytorchjob())
    real_get, real_patch = fake.api.get, fake.api.patch_merge
    monkeypatch.setattr(time, "sleep", lambda s: None)
    for client in (jax_client, port):
        flaky = {"n": 0}

        def failing_get(kind, ns, name):
            flaky["n"] += 1
            if flaky["n"] <= 2:
                raise RuntimeError("boom")  # fakekube maps to 500
            return real_get(kind, ns, name)

        fake.api.get = failing_get
        try:
            assert client.get("PyTorchJob", "default", "pj")[
                "metadata"]["name"] == "pj"
            assert flaky["n"] == 3
        finally:
            fake.api.get = real_get
        calls = {"n": 0}

        def failing_patch(*args):
            calls["n"] += 1
            raise RuntimeError("boom")

        fake.api.patch_merge = failing_patch
        try:
            with pytest.raises(Exception) as info:
                client.patch_merge("PyTorchJob", "default", "pj",
                                   {"metadata": {}})
            assert info.value.code == 500 and calls["n"] == 1
        finally:
            fake.api.patch_merge = real_patch


def test_a_reaped_keep_alive_connection_is_replayed(fake, clients):
    """A reused connection the server closed while idle: the next call,
    a mutation included, goes out again on a fresh one."""
    _, port = clients
    fake.api.create(pytorchjob())
    port.get("PyTorchJob", "default", "pj")
    port._local.conn.sock.close()               # the server reaped it
    got = port.patch_merge("PyTorchJob", "default", "pj", {
        "metadata": {"annotations": {"x": "1"}}})
    assert got["metadata"]["annotations"]["x"] == "1"


def _fields(cfg) -> tuple:
    return cfg.server, cfg.ca_file, cfg.token_file


def test_in_cluster_config_and_token_rotation(tmp_path, monkeypatch):
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.96.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    want = jkc.ClusterConfig.in_cluster()
    assert _fields(tkc.ClusterConfig.in_cluster()) == _fields(want)
    assert want.server == "https://10.96.0.1:6443"
    assert want.token is None     # in a pod, the token comes from its file
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST")
    monkeypatch.delenv("KUBERNETES_SERVICE_PORT")
    assert _fields(tkc.ClusterConfig.in_cluster()) == \
        _fields(jkc.ClusterConfig.in_cluster())
    token = tmp_path / "token"
    token.write_text("first\n")
    cfgs = [mod.ClusterConfig(server="http://127.0.0.1:1",
                              token_file=str(token)) for mod in (jkc, tkc)]
    assert [c_.bearer_token() for c_ in cfgs] == ["first", "first"]
    token.write_text("rotated")
    assert [c_.bearer_token() for c_ in cfgs] == ["rotated", "rotated"]
    assert tkc.KubeAPIServer(cfgs[1])._headers()["Authorization"] == \
        "Bearer rotated"
    token.unlink()
    assert [c_.bearer_token() for c_ in cfgs] == [None, None]
    assert "Authorization" not in tkc.KubeAPIServer(cfgs[1])._headers()
    # plain http takes no TLS context; https takes the CA's (verified)
    assert cfgs[1].ssl_context() is None
    ctx = tkc.ClusterConfig(server="https://h:1").ssl_context()
    assert ctx.check_hostname and ctx.verify_mode == ssl.CERT_REQUIRED
    with pytest.raises(OSError):
        tkc.ClusterConfig(server="https://h:1",
                          ca_file=str(tmp_path / "missing.crt")
                          ).ssl_context()
