"""The port's C++ document packer (``kubedl_tpu_torch.native``) held
against the port's Python loop and the JAX package's ``pack_documents`` on
the same documents: exactly equal, on the JAX package's randomized and
edge cases (``tests/test_native.py``). Also the packer's build rule: the
library lies under ``build/``, keyed by the source, a broken source
raises with the compiler's output, and ``KUBEDL_NATIVE=0`` takes the
Python loop."""

import pathlib

import numpy as np
import pytest

from kubedl_tpu.train.data import pack_documents as jax_pack
from kubedl_tpu_torch import native
from kubedl_tpu_torch.train.data import pack_documents

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def built():
    if native.ensure_built() is None:
        pytest.skip("no C++ compiler on PATH")


def batches(pack, docs, seq_len, batch_size):
    return [{k: np.asarray(v) for k, v in b.items()}
            for b in pack(docs, seq_len, batch_size)]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def assert_three_ways(docs, seq_len, batch, monkeypatch):
    """The packer (a list), the port's Python loop (a generator) and the
    JAX package's ``pack_documents`` with its own packer switched off."""
    calls = []
    real = native.pack_rows_native

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append(out is not None)
        return out
    monkeypatch.setattr(native, "pack_rows_native", counted)
    got = batches(pack_documents, list(docs), seq_len, batch)
    assert calls == [True]
    loop = batches(pack_documents, iter(docs), seq_len, batch)
    assert calls == [True]
    with monkeypatch.context() as m:
        m.setenv("KUBEDL_NATIVE", "0")
        want = batches(jax_pack, list(docs), seq_len, batch)
    assert_same(got, want)
    assert_same(loop, want)
    return got


@pytest.mark.parametrize("seq_len,batch", [(16, 2), (31, 3), (8, 1)])
def test_randomized_equality(seq_len, batch, monkeypatch):
    rng = np.random.default_rng(42 + seq_len)
    for _ in range(5):
        docs = [list(rng.integers(1, 1000,
                                  rng.integers(0, 3 * seq_len + 2)))
                for _ in range(rng.integers(1, 40))]
        assert_three_ways(docs, seq_len, batch, monkeypatch)


def test_edge_docs_equality(monkeypatch):
    seq_len = 8
    docs = [[], [7], [1, 2], list(range(9)),        # empty/1/2/exact seq1
            list(range(100, 127)),                   # overlong -> chunks
            [5] * 9, [6] * 10]                       # exact + exact+1
    got = assert_three_ways(docs, seq_len, 2, monkeypatch)
    assert got


def test_the_rows_equal_the_jax_packers_rows():
    """``pack_rows_native`` row for row against the JAX package's own
    C++ packer, trailing flush included."""
    from kubedl_tpu import native as jax_native
    if jax_native.load() is None:
        pytest.skip("the JAX package's packer did not build")
    rng = np.random.default_rng(0)
    docs = [list(rng.integers(1, 32000, rng.integers(1, 400)))
            for _ in range(300)]
    for got, want in zip(native.pack_rows_native(docs, 255),
                         jax_native.pack_rows_native(docs, 255)):
        np.testing.assert_array_equal(got, want)
    assert native.pack_rows_native([[], []], 7)[0].shape == (0, 8)


def test_disable_env_takes_the_python_loop(monkeypatch):
    monkeypatch.setenv("KUBEDL_NATIVE", "0")
    assert native.load() is None
    assert native.pack_rows_native([list(range(20))], 8) is None
    assert batches(pack_documents, [list(range(20))], 8, 1)


def test_the_library_lies_under_build_keyed_by_its_source():
    so = native.ensure_built()
    assert so.parent == ROOT / "build" / "kubedl_tpu_torch"
    assert so.name.startswith("libkubedl_native-") and so.suffix == ".so"
    assert native.load() is native.load()
    assert not list(native.SRC.parent.glob("*.so"))


def test_a_broken_source_raises_with_the_compilers_output(monkeypatch,
                                                          tmp_path):
    broken = tmp_path / "packer.cc"
    broken.write_text(native.SRC.read_text().replace(
        "long kubedl_pack_rows(", "long kubedl_pack_rows(undeclared_t u, "))
    monkeypatch.setattr(native, "SRC", broken)
    with pytest.raises(RuntimeError, match="undeclared_t"):
        native.ensure_built()
    assert not native._target(broken).exists()


def test_no_compiler_means_no_native_path(monkeypatch):
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_target",
                        lambda src: ROOT / "build" / "no-such.so")
    assert native.ensure_built() is None and native.load() is None
