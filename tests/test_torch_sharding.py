"""The port's logical sharding (``kubedl_tpu_torch.parallel.sharding``),
mesh helpers and batch placement held against the JAX package: every
rule, every leaf of every family's ``param_specs`` and of
``adapter_specs``, ``MeshConfig.resolve``, ``host_local_batch_size`` and
the spec ``shard_batch`` gives each batch leaf, the JAX side on the fake
8-device CPU mesh (``tests/conftest.py``). A spec crosses as a tuple, the
form ``PartitionSpec`` iterates as."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from kubedl_tpu.models import gemma as jgemma
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import mlp as jmlp
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.models import resnet as jresnet
from kubedl_tpu.ops import lora as jlora
from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu.parallel import sharding as jsharding
from kubedl_tpu.train import data as jdata
from kubedl_tpu_torch.models import gemma as tgemma
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.models import mlp as tmlp
from kubedl_tpu_torch.models import moe as tmoe
from kubedl_tpu_torch.models import resnet as tresnet
from kubedl_tpu_torch.ops import lora as tlora
from kubedl_tpu_torch.parallel import mesh as tmesh
from kubedl_tpu_torch.parallel import sharding as tsharding
from kubedl_tpu_torch.train import data as tdata


def _jax_specs(tree) -> dict:
    """``{path: tuple(spec)}`` of a JAX spec tree, paths as the port's
    ``spec_leaves`` names them."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, P)):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(leaf)
    return out


@pytest.mark.parametrize("axes", [
    ("batch",), ("seq",), ("embed",), ("heads",), ("kv_heads",), ("mlp",),
    ("vocab",), ("experts",), ("stages",), ("layers",), ("norm",),
    ("head_dim",), ("layers", "embed", "heads"), ("batch", "seq"),
    (None, "mlp"), ("unknown_axis",), ()])
def test_spec_matches_jax(axes):
    assert tsharding.spec(*axes) == tuple(jsharding.spec(*axes))


def test_logical_rules_are_the_jax_rules():
    assert tsharding.LOGICAL_RULES == jsharding.LOGICAL_RULES


#: family configs: (JAX module, JAX config, port module, port config)
FAMILIES = {
    "llama_tiny": (jllama, jllama.tiny(), tllama, tllama.tiny()),
    "gemma_tiny_one_kv_head": (jllama, jgemma.tiny(), tllama,
                               tgemma.tiny()),
    "gemma2_sandwich": (jllama, jgemma.gemma2_2b(), tllama,
                        tgemma.gemma2_2b()),
    "qwen2_qkv_bias": (jllama, jllama.qwen2_7b(), tllama,
                       tllama.qwen2_7b()),
    "llama3_8b": (jllama, jllama.llama3_8b(), tllama, tllama.llama3_8b()),
    "moe_tiny": (jmoe, jmoe.tiny(), tmoe, tmoe.tiny()),
    "mixtral": (jmoe, jmoe.mixtral_8x7b(), tmoe, tmoe.mixtral_8x7b()),
    "mlp": (jmlp, jmlp.MLPConfig(), tmlp, tmlp.MLPConfig()),
    "resnet_tiny": (jresnet, jresnet.tiny(), tresnet, tresnet.tiny()),
    "resnet50": (jresnet, jresnet.resnet50(), tresnet, tresnet.resnet50()),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_param_specs_match_jax(name):
    jmod, jcfg, tmod, tcfg = FAMILIES[name]
    want = _jax_specs(jmod.param_specs(jcfg))
    got = tsharding.spec_leaves(tmod.param_specs(tcfg))
    assert got == want


@pytest.mark.parametrize("name", ["llama_tiny", "gemma_tiny_one_kv_head"])
def test_param_specs_cover_every_param(name):
    """The specs are congruent with the port's parameter tree: one spec
    per leaf, with one entry per dim."""
    _, _, tmod, tcfg = FAMILIES[name]
    params = tmod.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    from kubedl_tpu_torch.train.trainer import tree_leaves
    specs = tsharding.spec_leaves(tmod.param_specs(tcfg))
    leaves = dict(tree_leaves(params))
    assert set(specs) == set(leaves)
    for k, t in leaves.items():
        assert len(specs[k]) == t.ndim, k


@pytest.mark.parametrize("targets", [("wq", "wk", "wv", "wo"),
                                     ("w_gate", "w_up", "w_down", "wo")])
def test_adapter_specs_match_jax(targets):
    jcfg = dataclasses.replace(jllama.tiny(), dtype=np.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jad = jlora.init_adapters(jparams, rank=4, targets=targets)
    tparams = tllama.init_params(tllama.tiny(),
                                 torch.Generator().manual_seed(0),
                                 device="cpu")
    tad = tlora.init_adapters(tparams, rank=4, targets=targets)
    want = _jax_specs(jlora.adapter_specs(jllama.param_specs(jcfg), jad))
    got = tsharding.spec_leaves(
        tlora.adapter_specs(tllama.param_specs(tllama.tiny()), tad))
    assert got == want


@pytest.mark.parametrize("kw,n", [
    ({}, 8), ({"dp": 2}, 8), ({"fsdp": 4}, 4), ({"dp": 2, "fsdp": 2}, 4),
    ({"fsdp": 2, "tp": 2}, 4), ({"tp": 2, "cp": 2}, 8),
    ({"dp": 2, "fsdp": -1, "tp": 2}, 8), ({"tp": 3}, 8), ({"dp": 0}, 4)])
def test_mesh_config_resolve_matches_jax(kw, n):
    def run(cls):
        try:
            return ("ok", cls(**kw).resolve(n))
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(tmesh.MeshConfig) == run(jmesh.MeshConfig)


@pytest.mark.parametrize("kw,batch", [
    ({"fsdp": 8}, 16), ({"dp": 2, "fsdp": 4}, 8), ({"fsdp": 4, "tp": 2}, 8),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 6), ({"fsdp": 8}, 12)])
def test_host_local_batch_size_matches_jax(kw, batch):
    jm = jmesh.build_mesh(jmesh.MeshConfig(**kw))
    tm = tmesh.Mesh(device=torch.device("cpu"), shape=dict(zip(
        tmesh.AXES, tmesh.MeshConfig(**kw).resolve(8))))

    def run(fn, mesh):
        try:
            return ("ok", fn(batch, mesh))
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(tmesh.host_local_batch_size, tm) == \
        run(jmesh.host_local_batch_size, jm)
    assert tmesh.data_axes() == jmesh.data_axes()
    assert tmesh.batch_spec() == tuple(jmesh.batch_spec())


#: one host batch with every leaf kind shard_batch tells apart
_BATCH = {
    "tokens": np.zeros((8, 16), np.int32),
    "targets": np.ones((8, 16), np.int64),
    "mask": np.ones((8, 16), bool),
    "features": np.zeros((8, 16), np.float32),
    "labels": np.zeros((8,), np.int32),
    "images": np.zeros((8, 4, 4, 3), np.float32),
    "weight": np.float32(2.0),
}


@pytest.mark.parametrize("kw", [{"fsdp": 8}, {"dp": 2, "fsdp": 4},
                                {"fsdp": 4, "cp": 2}])
def test_shard_batch_places_leaves_as_jax_does(kw):
    jm = jmesh.build_mesh(jmesh.MeshConfig(**kw))
    placed = jdata.shard_batch(_BATCH, jm)
    for name, arr in _BATCH.items():
        want = tuple(placed[name].sharding.spec)
        got = tdata.batch_leaf_spec(np.asarray(arr))
        # JAX's spec drops nothing; the port's may omit trailing Nones
        assert got + (None,) * (len(want) - len(got)) == want, name


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    got = tsharding.placements((("dp", "fsdp"), None, "tp"))
    assert got == [Shard(0), Shard(0), Replicate(), Replicate(),
                   Replicate(), Shard(2)]
    assert tsharding.spec_of(got) == (("dp", "fsdp"), None, "tp")
    with pytest.raises(ValueError, match="mesh order"):
        tsharding.placements((("fsdp", "dp"),))
    with pytest.raises(ValueError, match="shards two dims"):
        tsharding.placements(("fsdp", "fsdp"))


def test_local_shard_takes_the_rank_chunk_dp_major():
    """("dp", "fsdp") on one dim splits dp first: rank (dp=1, fsdp=0) of a
    2x2 data mesh holds the third quarter of the rows, as JAX's
    major-to-minor split gives device 2."""
    class FakeMesh:
        shape = {"dp": 2, "fsdp": 2, "ep": 1, "pp": 1, "cp": 1, "tp": 1}

        def size(self, a):
            return self.shape[a]

        def index(self, a):
            return {"dp": 1, "fsdp": 0}.get(a, 0)

    full = torch.arange(8 * 3).reshape(8, 3)
    got = tsharding.local_shard(full, FakeMesh(), (("dp", "fsdp"), None))
    torch.testing.assert_close(got, full[4:6])
    jm = jmesh.build_mesh(jmesh.MeshConfig(dp=2, fsdp=2),
                          devices=jax.devices()[:4])
    arr = jax.device_put(full.numpy(), jax.sharding.NamedSharding(
        jm, P(("dp", "fsdp"), None)))
    shard = [s for s in arr.addressable_shards
             if s.device == jm.devices[1, 0, 0, 0, 0, 0]][0]
    np.testing.assert_array_equal(np.asarray(shard.data), got.numpy())
    with pytest.raises(ValueError, match="shards must be equal"):
        tsharding.local_shard(torch.zeros(6, 3), FakeMesh(),
                              (("dp", "fsdp"), None))


def test_build_mesh_refuses_unported_axes_by_item():
    # every axis is ported: ep and cp (test_torch_cp_ep_train.py), pp
    # (test_torch_pp_train.py); one process holds no mesh of two ranks on
    # any of them
    for kw in ({"ep": 2}, {"cp": 2}, {"pp": 2}):
        with pytest.raises(ValueError, match="devices, have 1"):
            tmesh.build_mesh(tmesh.MeshConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.build_mesh(tmesh.MeshConfig(fsdp=2), device="cpu")


@pytest.mark.parametrize("nh,nkv,tp", [(4, 1, 2), (8, 1, 4), (12, 3, 2),
                                       (6, 3, 2), (8, 2, 4), (4, 1, 4)])
def test_local_kv_gives_each_query_head_its_kv_head(nh, nkv, tp):
    """Where ``tp`` cannot split the KV heads, each rank holds all of them
    and takes, for its query heads, the KV head GQA maps each to (head j
    reads KV head j // (nh / nkv)): a slice when its heads are whole runs
    of one group size, else one KV head per query head."""
    cfg = dataclasses.replace(tllama.tiny(), n_heads=nh, n_kv_heads=nkv)
    b, s, hd = 2, 3, 4
    k = torch.randn(b, s, nkv, hd)
    v = torch.randn(b, s, nkv, hd)
    nq = nh // tp
    class RankMesh:          # rank ``r`` of the tp axis
        def __init__(self, r):
            self.r = r

        def index(self, axis):
            return self.r if axis == "tp" else 0

        def size(self, axis):
            return tp if axis == "tp" else 1

    for rank in range(tp):
        lk, lv = tllama._local_kv(cfg, k, v, RankMesh(rank))
        assert nq % lk.shape[2] == 0
        per_head = lk.repeat_interleave(nq // lk.shape[2], dim=2)
        want = [(rank * nq + i) // (nh // nkv) for i in range(nq)]
        torch.testing.assert_close(per_head, k[:, :, want])
        torch.testing.assert_close(
            lv.repeat_interleave(nq // lv.shape[2], dim=2), v[:, :, want])


class _FakeRank:
    """Rank ``r`` of a ``tp`` axis, as the serving helpers see a mesh
    with a process group behind it (no collective runs here)."""

    def __init__(self, tp, r):
        self.shape = {a: (tp if a == "tp" else 1) for a in tmesh.AXES}
        self.sharded, self.device_mesh, self.r = True, object(), r

    def size(self, axis):
        return self.shape[axis]

    def index(self, axis):
        return self.r if axis == "tp" else 0


def test_qwen2_7b_heads_split_whole_over_tp8():
    """Qwen2-7B's 28 query heads over 4 KV heads at ``tp=8``: ranks 0-3
    compute 4 heads and ranks 4-7 three, in order, every head once (JAX's
    equal chunks where ``tp`` divides the heads); each rank's ``wq``,
    ``bq`` and ``wo`` cuts are its heads' columns and rows, its K/V heads
    the ones GQA maps them to."""
    from kubedl_tpu_torch.serving import engine as tengine
    cfg = tllama.qwen2_7b()
    split = [tllama.head_split(28, 8, r) for r in range(8)]
    assert split == [(0, 4), (4, 4), (8, 4), (12, 4), (16, 3), (19, 3),
                     (22, 3), (25, 3)]
    assert [tllama.head_split(32, 8, r) for r in range(8)] == \
        [(4 * r, 4) for r in range(8)]
    hd, d, layers = cfg.hd, cfg.d_model, cfg.n_layers
    k = torch.arange(4.0).reshape(1, 1, 4, 1).expand(1, 2, 4, 1)
    for r, (first, n) in enumerate(split):
        mesh = _FakeRank(8, r)
        cut = tengine.serving_cut(cfg, mesh)

        def shape(name, full):
            return tuple(cut(name, torch.empty(full, device="meta")).shape)
        assert shape("layers/wq", (layers, d, 28 * hd)) == (layers, d,
                                                            n * hd)
        assert shape("layers/bq", (layers, 28 * hd)) == (layers, n * hd)
        assert shape("layers/wo", (layers, 28 * hd, d)) == (layers, n * hd,
                                                            d)
        # 4 KV heads cannot split over 8: held whole on every rank
        assert shape("layers/wk", (layers, d, 4 * hd)) == (layers, d,
                                                           4 * hd)
        assert tllama.kv_heads_local(cfg, mesh) == 4
        got = tllama._local_kv(cfg, k, k, mesh)[0]
        want = [(first + i) // 7 for i in range(n)]
        per_head = got.repeat_interleave(n // got.shape[2], dim=2)
        assert per_head[0, 0, :, 0].tolist() == want
        # the cut is the head's columns: wq's values at the rank's heads
        wq = torch.arange(28 * hd, dtype=torch.float32)[None, None].expand(
            1, d, -1)
        small = dataclasses.replace(cfg, n_layers=1)
        got_cols = tengine.serving_cut(small, mesh)("layers/wq", wq)[0, 0]
        assert got_cols[0] == first * hd and got_cols[-1] == (
            first + n) * hd - 1


@pytest.mark.parametrize("kind", ["text", "tokens"])
def test_each_data_rank_reads_the_stride_a_jax_host_reads(tmp_path,
                                                          monkeypatch,
                                                          kind):
    """The train entrypoint's host streams: data rank ``r`` of 2 draws the
    batches JAX process ``r`` of 2 draws (its stride of the documents, its
    shard of a token file, its seed)."""
    from kubedl_tpu.train import __main__ as jmain
    from kubedl_tpu_torch.train import __main__ as tmain
    if kind == "text":
        path = tmp_path / "corpus.txt"
        path.write_text("\n".join(
            f"document {i}: the quick brown fox jumps over {i * 7} dogs"
            for i in range(24)))
        data = {"kind": "text", "path": str(path), "tokenizer": "byte"}
    else:
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 200, 64 * 33,
                                          dtype=np.int32).tofile(path)
        data = {"kind": "tokens", "path": str(path), "seed": 3}
    cfg = dataclasses.replace(tllama.tiny(), vocab_size=288)
    for rank in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        want = jmain._raw_stream(data, cfg, 4, 32)
        got = tmain._raw_stream(data, cfg, 4, 32, host=(rank, 2))
        for _ in range(3):
            a, b = next(want), next(got)
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(b[k]),
                                              np.asarray(a[k]), err_msg=k)
