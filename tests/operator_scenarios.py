"""Run the JAX package's operator test scenarios on the port's modules.

A ``tests/test_torch_operator_*.py`` file calls :func:`load` with the name
of a JAX test file: its source is compiled with every ``kubedl_tpu`` (the
imports, the package's directory, ``python -m kubedl_tpu``) naming
``kubedl_tpu_torch`` instead and run in the calling module's namespace,
after the fixtures of ``tests/conftest.py`` that build the control plane
(``clock``, ``api``, ``manager``) over the port's classes: a module's own
fixtures shadow the conftest ones. The JAX test file itself is not
changed, and pytest collects its tests a second time, in the port's
file, against the port."""

from __future__ import annotations

import pathlib
import re

import pytest

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
#: ``kubedl_tpu`` that is not already ``kubedl_tpu_torch``
_JAX_NAME = re.compile(r"\bkubedl_tpu\b(?!_torch)")


def port_source(name: str, replace: tuple = ()) -> str:
    """The source of ``tests/<name>`` pointed at the port, with each
    ``(old, new)`` of ``replace`` applied first (each must occur)."""
    text = (TESTS / name).read_text()
    for old, new in replace:
        assert re.search(old, text), (name, old)
        text = re.sub(old, new, text)
    return _JAX_NAME.sub("kubedl_tpu_torch", text)


@pytest.fixture
def clock():
    from kubedl_tpu_torch.core.clock import SimClock
    return SimClock()


@pytest.fixture
def api(clock):
    from kubedl_tpu_torch.core.apiserver import APIServer
    return APIServer(clock=clock)


@pytest.fixture
def manager(api, clock):
    from kubedl_tpu_torch.core.manager import Manager
    return Manager(api, clock=clock)


def load(name: str, namespace: dict, only: tuple = (),
         replace: tuple = ()) -> None:
    """Run ``tests/<name>`` on the port into ``namespace``; with ``only``,
    keep just those tests (by function name)."""
    namespace.update(clock=clock, api=api, manager=manager, ROOT=ROOT)
    exec(compile(port_source(name, replace), str(TESTS / name), "exec"),
         namespace)
    if only:
        tests = {k for k in namespace if k.startswith("test_")}
        assert set(only) <= tests, sorted(set(only) - tests)
        for k in tests - set(only):
            del namespace[k]
