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


def test_the_rest_mapping_matches_for_the_job_kinds(clients):
    jax_client, port = clients
    assert tkc.api_prefix("v1") == jkc.api_prefix("v1") == "/api/v1"
    for kind in tkc.JOB_SCHEME:
        if kind == "RLJob":
            # the JAX client learns it from the objects it writes; its
            # clientset names the same version and plural
            from kubedl_tpu.client.clientset import KIND_TABLE
            info = KIND_TABLE["RLJob"]
            assert port.mapping(kind) == (info.api_version, info.plural)
            continue
        assert port.mapping(kind) == jax_client.mapping(kind), kind
        assert port._path(kind, "ns", "j") == jax_client._path(
            kind, "ns", "j")
    with pytest.raises(tkc.Invalid, match="no REST mapping"):
        port.mapping("Widget")


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
    # the same mapping for every status, for the two methods the port's
    # client sends (it never creates, so never meets a POST's 409)
    for code in (400, 404, 409, 422, 429, 500, 503):
        for method in ("GET", "PATCH"):
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
