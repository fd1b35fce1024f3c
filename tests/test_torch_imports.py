"""Import hygiene of the PyTorch port: it imports no JAX and nothing of
the JAX package, and its entry points refuse to run on the CPU unless
asked to."""

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "kubedl_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))
#: an import of the JAX package (``kubedl_tpu`` not followed by ``_torch``)
_JAX_PKG_IMPORT = re.compile(r"\b(?:import|from)\s+kubedl_tpu(?!_torch)\b")


def test_the_training_slice_modules_are_checked():
    """The hygiene checks below walk the package: the training slice's
    modules are among what they import and scan."""
    assert {"kubedl_tpu_torch.ops.loss", "kubedl_tpu_torch.parallel.mesh",
            "kubedl_tpu_torch.train", "kubedl_tpu_torch.train.data",
            "kubedl_tpu_torch.train.trainer",
            "kubedl_tpu_torch.train.__main__"} <= set(MODULES)


def test_the_continuous_serving_slice_modules_are_checked():
    """...and so are the continuous-batching engine and the predictor
    entry point."""
    assert {"kubedl_tpu_torch.serving.batching",
            "kubedl_tpu_torch.serving.__main__",
            "kubedl_tpu_torch.serving.speculative"} <= set(MODULES)


def test_the_gemma_quantization_and_lora_slice_modules_are_checked():
    """...and so are the Gemma family, weight quantization, LoRA and the
    adapter catalog (the port's own copy of the framework-free module)."""
    assert {"kubedl_tpu_torch.models.gemma", "kubedl_tpu_torch.ops.quant",
            "kubedl_tpu_torch.ops.lora",
            "kubedl_tpu_torch.serving.adapters"} <= set(MODULES)


def test_the_moe_slice_modules_are_checked():
    """...and so is the MoE family."""
    assert "kubedl_tpu_torch.models.moe" in set(MODULES)


def test_the_checkpoint_conversion_and_training_modes_slice_is_checked():
    """...and so are HF conversion with the port's own safetensors I/O,
    the MLP and ResNet families, checkpoints, evaluation, DPO and the
    scoring helpers (the port's own copy of the framework-free module)."""
    assert {"kubedl_tpu_torch.models.safetensors_io",
            "kubedl_tpu_torch.models.convert", "kubedl_tpu_torch.models.mlp",
            "kubedl_tpu_torch.models.resnet",
            "kubedl_tpu_torch.train.checkpoint",
            "kubedl_tpu_torch.train.evaluate", "kubedl_tpu_torch.train.dpo",
            "kubedl_tpu_torch.train.scoring"} <= set(MODULES)


def test_the_rendezvous_and_sharding_slice_modules_are_checked():
    """...and so are the rendezvous, the sharding rules, the training
    collectives and the local launcher."""
    assert {"kubedl_tpu_torch.runtime",
            "kubedl_tpu_torch.runtime.bootstrap",
            "kubedl_tpu_torch.parallel.sharding",
            "kubedl_tpu_torch.parallel.collectives",
            "kubedl_tpu_torch.parallel.launch"} <= set(MODULES)


def test_the_tensor_parallel_serving_modules_are_checked():
    """...and so is the step channel of tensor-parallel serving, with its
    follower process's entry point (port-only, no JAX twin)."""
    assert {"kubedl_tpu_torch.serving.tp",
            "kubedl_tpu_torch.serving.engine",
            "kubedl_tpu_torch.parallel.launch"} <= set(MODULES)


def test_the_context_and_expert_parallel_modules_are_checked():
    """...and so are ring and Ulysses attention, the context-parallel
    twins of the JAX package's modules."""
    assert {"kubedl_tpu_torch.parallel.ring",
            "kubedl_tpu_torch.parallel.ulysses"} <= set(MODULES)


def test_the_pipeline_and_rl_modules_are_checked():
    """...and so are pipeline parallelism, GRPO and the RL learner."""
    assert {"kubedl_tpu_torch.parallel.pipeline",
            "kubedl_tpu_torch.train.grpo", "kubedl_tpu_torch.rl",
            "kubedl_tpu_torch.rl.learner"} <= set(MODULES)


def test_the_in_cluster_runtime_modules_are_checked():
    """...and so are the API-server client, the restart agent and the
    rendezvous that reads the PyTorchJob contract."""
    assert {"kubedl_tpu_torch.core", "kubedl_tpu_torch.core.kubeclient",
            "kubedl_tpu_torch.runtime.restart_agent",
            "kubedl_tpu_torch.runtime.bootstrap"} <= set(MODULES)


def test_the_replay_slice_modules_are_checked():
    """...and so are the engine-driven replays, with the framework-free
    modules they need, which the port keeps as copies: the sim clock, the
    object helpers and event types, SLO objects and the SLO engine, the
    Queue API, descriptive statistics, the workload generators, the
    serving fleet, its router and autoscaler, and the RL flywheel's
    rollout client, weight publisher and loop."""
    assert {"kubedl_tpu_torch.replay", "kubedl_tpu_torch.replay.serving",
            "kubedl_tpu_torch.replay.rl", "kubedl_tpu_torch.replay.fleet",
            "kubedl_tpu_torch.replay.workload", "kubedl_tpu_torch.api",
            "kubedl_tpu_torch.api.slo", "kubedl_tpu_torch.api.queue",
            "kubedl_tpu_torch.core.clock", "kubedl_tpu_torch.core.meta",
            "kubedl_tpu_torch.core.events", "kubedl_tpu_torch.telemetry",
            "kubedl_tpu_torch.telemetry.slo", "kubedl_tpu_torch.utils",
            "kubedl_tpu_torch.utils.stats",
            "kubedl_tpu_torch.serving.fleet",
            "kubedl_tpu_torch.serving.router",
            "kubedl_tpu_torch.controllers",
            "kubedl_tpu_torch.controllers.servingfleet",
            "kubedl_tpu_torch.rl.flywheel", "kubedl_tpu_torch.rl.rollout",
            "kubedl_tpu_torch.rl.publisher"} <= set(MODULES)


def test_the_last_refusals_modules_are_checked():
    """...and so are the modules slice 17 ported or touched: the
    standalone speculative engine behind the predictor, evaluate/DPO
    over ``cp``, and the serving engines over an ``ep`` or ``cp``
    mesh."""
    assert {"kubedl_tpu_torch.serving.speculative",
            "kubedl_tpu_torch.serving.server",
            "kubedl_tpu_torch.serving.__main__",
            "kubedl_tpu_torch.serving.engine",
            "kubedl_tpu_torch.serving.batching",
            "kubedl_tpu_torch.serving.tp",
            "kubedl_tpu_torch.train.evaluate", "kubedl_tpu_torch.train.dpo",
            "kubedl_tpu_torch.train.scoring",
            "kubedl_tpu_torch.parallel.collectives",
            "kubedl_tpu_torch.tokenizer"} <= set(MODULES)


def test_the_modules_the_import_census_missed_are_checked():
    """...and so are the three modules the census by import closure
    found (slice 18): the serving auto-configurator, the multi-model
    fleet day and the native document packer."""
    assert {"kubedl_tpu_torch.serving.autoconfig",
            "kubedl_tpu_torch.replay.multimodel",
            "kubedl_tpu_torch.native"} <= set(MODULES)


#: the replays' twins and the modules the port copies for them
REPLAY_TWINS = ("replay/serving", "replay/rl")
REPLAY_COPIES = ("core/clock", "api/slo", "core/meta", "telemetry/slo",
                 "replay/workload", "replay/fleet", "utils/stats",
                 "api/queue", "serving/fleet", "serving/router",
                 "controllers/servingfleet", "rl/flywheel", "rl/rollout",
                 "rl/publisher")
#: JAX modules -> their twins, whose public functions and classes (and the
#: classes' public methods) the twin has too
TWINS = {f"kubedl_tpu/{path}.py": f"kubedl_tpu_torch.{path.replace('/', '.')}"
         for path in ("parallel/pipeline", "train/grpo", "rl/learner",
                      "train/__main__", "train/trainer", "core/kubeclient",
                      "runtime/restart_agent", "serving/speculative",
                      "serving/server", "serving/__main__",
                      "serving/engine", "serving/batching",
                      "train/evaluate", "train/dpo", "train/scoring",
                      "models/llama", "tokenizer", "serving/autoconfig",
                      "replay/multimodel") + REPLAY_TWINS
         + REPLAY_COPIES}
TWINS["kubedl_tpu/native/__init__.py"] = "kubedl_tpu_torch.native"
#: public names a twin leaves out on purpose: the in-cluster job reads and
#: patches its own job object, so the client keeps ``get``/``try_get``/
#: ``patch_merge`` and the job kinds' mapping (kubeconfig files need
#: ``yaml``; the operator's verbs, clock, watches and informers have no
#: caller in the port)
LEFT_OUT = {"kubedl_tpu/core/kubeclient.py": {
    "ClusterConfig.from_kubeconfig", "KubeAPIServer.now",
    "KubeAPIServer.register_kind", "KubeAPIServer.create",
    "KubeAPIServer.list", "KubeAPIServer.update",
    "KubeAPIServer.update_status", "KubeAPIServer.delete",
    "KubeAPIServer.pod_logs", "KubeAPIServer.watch", "KubeAPIServer.start",
    "KubeAPIServer.stop"}}


@pytest.mark.parametrize("source", sorted(TWINS))
def test_the_twins_have_the_jax_modules_public_names(source):
    """Read from the JAX sources without importing them: since slice 14
    none is missing (``build_pp_pretrain``, ``run_grpo``,
    ``resolve_reward`` and ``Trainer.remesh`` were), apart from the
    client's ``LEFT_OUT``."""
    import ast
    import importlib
    mod = importlib.import_module(TWINS[source])
    missing = []
    for node in ast.parse((ROOT / source).read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                or node.name.startswith("_"):
            continue
        if not hasattr(mod, node.name):
            missing.append(node.name)
        elif isinstance(node, ast.ClassDef):
            missing += [f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")
                        and not hasattr(getattr(mod, node.name), m.name)]
    left_out = LEFT_OUT.get(source, set())
    assert sorted(set(missing) - left_out) == [], missing
    # and nothing listed as left out is there after all
    assert sorted(left_out - set(missing)) == []


def _params(fn) -> list:
    import inspect
    return list(inspect.signature(fn).parameters)


#: parameters the replays' port takes beyond the JAX ones: the device
#: (the card unless the caller names the CPU) everywhere a replay is
#: built, and the RL replay's model (the JAX one always trains its tiny
#: model; the port's also runs at a width the card is measured at)
PORT_PARAMS = {
    "_tiny_model": ["device"], "ServingReplay.__init__": ["device"],
    "ServingFleetReplay.__init__": ["device"],
    "run_routing_comparison": ["device"], "run_disagg_comparison": ["device"],
    "run_autoscaler_leg": ["device"], "run_fleet_comparison": ["device"],
    "FlywheelReplay.__init__": ["model", "device"],
    "run_flywheel_leg": ["device"],
    "SpeculativeEngine.__init__": ["device"],
    "probe_candidate": ["device"], "autoconfigure_multi": ["device"],
    "MultiModelReplay.__init__": ["device"],
    "run_multimodel_comparison": ["model", "device"]}


@pytest.mark.parametrize("path", REPLAY_TWINS + REPLAY_COPIES)
def test_the_replay_modules_take_the_jax_ones_parameters(path):
    """Every function of the JAX source (and every method of its classes,
    ``__init__`` included) takes the same parameters, in order, in the
    port, with only ``PORT_PARAMS`` added at the end. Read from the JAX
    source as an AST, held against the imported port module."""
    _check_parameters(path)


def test_the_speculative_module_takes_the_jax_ones_parameters():
    """The standalone speculative engine and its adapter (slice 17), the
    private round loops included; the engine adds only the device."""
    _check_parameters("serving/speculative")


@pytest.mark.parametrize("path", ["serving/autoconfig", "replay/multimodel",
                                  "native/__init__"])
def test_the_slice_18_modules_take_the_jax_ones_parameters(path):
    """The auto-configurator adds the device to what builds engines, the
    multi-model day the device (and the model to its comparison, as the
    RL replay has it); the packer's functions are JAX's."""
    _check_parameters(path)


def _check_parameters(path):
    import ast
    import importlib
    mod = importlib.import_module(
        f"kubedl_tpu_torch.{path.replace('/', '.')}".removesuffix(
            ".__init__"))
    checked = 0
    for node in ast.parse((ROOT / f"kubedl_tpu/{path}.py").read_text()).body:
        fns = ([(node.name, node)] if isinstance(node, ast.FunctionDef)
               else [(f"{node.name}.{m.name}", m) for m in node.body
                     if isinstance(m, ast.FunctionDef)]
               if isinstance(node, ast.ClassDef) else [])
        for name, fn in fns:
            if isinstance(node, ast.FunctionDef):
                obj = getattr(mod, name)
            else:
                # the function as the class body holds it (``self``
                # included), unwrapped from a property or descriptor
                obj = vars(getattr(mod, node.name))[fn.name]
                obj = getattr(obj, "fget", None) or getattr(
                    obj, "__func__", obj)
            args = fn.args
            want = [a.arg for a in args.posonlyargs + args.args]
            want += [args.vararg.arg] if args.vararg else []
            want += [a.arg for a in args.kwonlyargs]
            want += [args.kwarg.arg] if args.kwarg else []
            assert _params(obj) == want + PORT_PARAMS.get(name, []), name
            checked += 1
    assert checked > 0


def _without_docs_and_imports(source: str) -> str:
    """The AST of a module with its docstrings and its top-level imports
    taken out."""
    import ast
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        first = body[0] if isinstance(body, list) and body else None
        if isinstance(first, ast.Expr) and isinstance(
                first.value, ast.Constant) and isinstance(
                first.value.value, str):
            node.body = body[1:] or [ast.Pass()]
    tree.body = [n for n in tree.body
                 if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return ast.dump(tree)


@pytest.mark.parametrize("path", [p for p in REPLAY_COPIES if p not in (
    "replay/fleet", "rl/publisher")])
def test_the_copied_modules_are_the_jax_ones_to_the_statement(path):
    """A copy differs from its JAX source only in imports and docstrings
    (and in naming the port's package where it names its own, as its
    logger does). ``replay/fleet`` (the ``device`` and the per-replica
    weights seam) and ``rl/publisher`` (the install through
    ``load_weights``) differ on purpose and are checked by name and
    parameter above."""
    want = (ROOT / f"kubedl_tpu/{path}.py").read_text().replace(
        '"kubedl_tpu.', '"kubedl_tpu_torch.')
    got = (PKG / f"{path}.py").read_text()
    assert _without_docs_and_imports(got) == _without_docs_and_imports(want)


#: what a twin adds to its JAX source, by function (``*``: every one):
#: parameters, and the keywords that hand them on
ADDED = {"serving/autoconfig": {"*": {"device"}},
         "replay/multimodel": {"*": {"device"},
                               "run_multimodel_comparison": {"model"}}}


def _without_additions(source: str, added: dict) -> str:
    """``source`` with ``added``'s parameters and keywords taken out."""
    import ast

    class Strip(ast.NodeTransformer):
        drop = added.get("*", set())

        def visit_FunctionDef(self, node):
            outer, self.drop = self.drop, self.drop | added.get(node.name,
                                                                set())
            self.generic_visit(node)
            args = node.args
            lead = len(args.args) - len(args.defaults)
            keep = [i for i, a in enumerate(args.args)
                    if a.arg not in self.drop]
            args.defaults = [args.defaults[i - lead] for i in keep
                             if i >= lead]
            args.args = [args.args[i] for i in keep]
            self.drop = outer
            return node

        def visit_Call(self, node):
            self.generic_visit(node)
            node.keywords = [k for k in node.keywords
                             if k.arg not in self.drop]
            return node
    return ast.unparse(Strip().visit(ast.parse(source)))


@pytest.mark.parametrize("path", sorted(ADDED))
def test_the_slice_18_twins_are_the_jax_ones_but_for_their_additions(path):
    """The auto-configurator and the multi-model day are their JAX
    sources statement for statement once ``ADDED`` is taken out: the
    selection, the early stop, the pruning, the fallback and the day are
    JAX's."""
    import ast
    want = ast.unparse(ast.parse((ROOT / f"kubedl_tpu/{path}.py")
                                 .read_text()))
    got = _without_additions((PKG / f"{path}.py").read_text(), ADDED[path])
    assert _without_docs_and_imports(got) == \
        _without_docs_and_imports(want)
    assert _without_additions(want, ADDED[path]) == want


@pytest.mark.parametrize("name", ["train_tokenizer", "encode_corpus",
                                  "main"])
def test_the_tokenizer_cli_is_the_jax_ones_to_the_statement(name):
    """The corpus CLI of the port's ``tokenizer.py`` (slice 17) is JAX's,
    statement for statement, but for docstrings and the program name."""
    import ast

    def body(text):
        text = text.replace("kubedl_tpu.", "kubedl_tpu_torch.")
        fn = next(n for n in ast.parse(text).body
                  if isinstance(n, ast.FunctionDef) and n.name == name)
        return _without_docs_and_imports(ast.unparse(fn))
    assert body((PKG / "tokenizer.py").read_text()) == \
        body((ROOT / "kubedl_tpu/tokenizer.py").read_text())


def _cxx_tokens(text: str) -> list:
    """The C++ tokens of ``text``, comments aside."""
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return re.findall(r"\w+|\S", text)


def test_the_packer_is_the_jax_ones_token_for_token():
    """``native/packer.cc`` is the JAX package's, token for token, but for
    its comments; its build and loader are the port's own."""
    got = _cxx_tokens((PKG / "native/packer.cc").read_text())
    want = _cxx_tokens((ROOT / "kubedl_tpu/native/packer.cc").read_text())
    assert got == want
    assert "kubedl_pack_rows" in got and len(got) > 300


#: JAX modules whose import closure reaches jax but which have no twin
#: yet, each with the ROADMAP item that queues it
QUEUED = {"kubedl_tpu.federation": "A10",
          "kubedl_tpu.federation.replay": "A10"}


def _import_graph(pkg: str) -> tuple:
    """``({module: modules it imports}, {modules that import jax})`` of
    ``pkg``, from the sources' static imports, the ones inside functions
    included. An import statement names a module (``from .x import y``
    names ``x``, and ``x.y`` where that is a module); the parent packages
    Python runs on the way are not counted."""
    import ast
    paths = {".".join(p.relative_to(ROOT).with_suffix("").parts)
             .removesuffix(".__init__"): p
             for p in (ROOT / pkg).rglob("*.py")}
    graph, jax = {}, set()
    for name, path in paths.items():
        base = name.split(".")
        if path.name != "__init__.py":
            base = base[:-1]
        out = graph[name] = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                targets = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                target = node.module or ""
                if node.level:
                    target = ".".join(base[:len(base) - node.level + 1]
                                      + ([node.module] if node.module
                                         else []))
                targets = [target] + [f"{target}.{a.name}"
                                      for a in node.names]
            else:
                continue
            if any(t.split(".")[0] == "jax" for t in targets):
                jax.add(name)
            out.update(t for t in targets if t in paths)
    return graph, jax


def test_every_jax_module_that_reaches_jax_has_a_twin():
    """The census by import closure: every ``kubedl_tpu`` module whose
    static import closure reaches a module that imports jax has a twin of
    the same name in the port, but for ``QUEUED``, each by name with its
    ROADMAP item. (A census of direct ``import jax`` lines alone missed
    the auto-configurator and the multi-model day.)"""
    graph, jax = _import_graph("kubedl_tpu")

    def reaches(name):
        seen, todo = set(), [name]
        while todo:
            m = todo.pop()
            if m not in seen:
                seen.add(m)
                todo += graph[m]
        return bool(seen & jax)
    twins = {m.replace("kubedl_tpu_torch", "kubedl_tpu", 1)
             for m in MODULES}
    reach = sorted(m for m in graph if reaches(m))
    assert len(jax) >= 31 and len(reach) > len(jax)
    missing = {m for m in reach if m not in twins}
    assert missing == set(QUEUED), sorted(missing)
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for name, item in QUEUED.items():
        assert f"**{item}" in roadmap and name.split(".", 1)[1].replace(
            ".", "/") in roadmap, (name, item)


def test_the_jax_serving_packages_exports_are_the_ports():
    """Every name ``kubedl_tpu.serving`` exports, ``kubedl_tpu_torch.serving``
    exports too (read from the JAX source, not imported)."""
    import ast

    import kubedl_tpu_torch.serving as serving
    tree = ast.parse((ROOT / "kubedl_tpu/serving/__init__.py").read_text())
    want = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign)
                and n.targets[0].id == "__all__")
    assert set(want) <= set(serving.__all__)
    assert all(hasattr(serving, name) for name in serving.__all__)


def test_the_entry_points_take_the_jax_ones_parameters():
    """``main`` and ``run_grpo`` take every parameter of their JAX twins
    (``run_grpo``'s ``elastic_agent`` since slice 15), plus the port's
    own: the device, the step callback and the in-cluster agent's API
    client. Read from the JAX source without importing it."""
    import ast
    from kubedl_tpu_torch.train import __main__ as tmain
    want = {node.name: [a.arg for a in node.args.args]
            for node in ast.parse((ROOT / "kubedl_tpu/train/__main__.py")
                                  .read_text()).body
            if isinstance(node, ast.FunctionDef)}
    assert _params(tmain.run_grpo) == want["run_grpo"] + ["on_step"]
    assert "elastic_agent" in want["run_grpo"]
    assert _params(tmain.main) == want["main"] + ["device", "on_step", "api"]
    assert _params(tmain._maybe_elastic_agent) == ["manager", "env", "api"]


def test_every_module_imports_with_jax_blocked():
    code = ("import sys\nsys.modules['jax'] = None\n"
            "import importlib\n"
            f"for name in {MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m == 'kubedl_tpu' or m.startswith('kubedl_tpu.')"
            " for m in sys.modules)\n"
            "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_import_of_the_jax_package(path):
    text = (ROOT / path).read_text()
    assert not _JAX_PKG_IMPORT.search(text), path
    assert not re.search(r"^\s*(?:import|from)\s+jax\b", text, re.M), path


def test_entry_points_refuse_the_cpu_without_a_card(monkeypatch, tmp_path):
    from kubedl_tpu_torch import resolve_device
    from kubedl_tpu_torch.models import convert, io, llama, mlp, resnet
    from kubedl_tpu_torch.serving import __main__ as serve_main
    from kubedl_tpu_torch.serving import batching, engine
    from kubedl_tpu_torch.train import Trainer
    from kubedl_tpu_torch.train import __main__ as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig(vocab_size=64, d_model=32, n_layers=1,
                            n_heads=2, n_kv_heads=1, d_ff=64,
                            dtype="float32")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    io.save_model(cfg, params, str(tmp_path))
    train_cfg = tmp_path / "train.json"
    train_cfg.write_text('{"model": "llama.tiny", "steps": 1}')
    calls = {
        "resolve_device": lambda: resolve_device(),
        "resolve_device(cuda)": lambda: resolve_device("cuda"),
        "init_params": lambda: llama.init_params(
            cfg, torch.Generator().manual_seed(0)),
        "init_cache": lambda: llama.init_cache(cfg, 1, 8),
        "load_model": lambda: io.load_model(str(tmp_path)),
        "params_from_numpy": lambda: io.params_from_numpy(cfg, {}),
        "InferenceEngine": lambda: engine.InferenceEngine(cfg, params),
        "init_block_pool": lambda: llama.init_block_pool(cfg, 4, 8),
        "ContinuousBatchingEngine": lambda: batching.ContinuousBatchingEngine(
            cfg, params, lanes=1, max_len=16),
        "serving.build_engine": lambda: serve_main.build_engine(
            str(tmp_path), 1, "", 0, max_len=16),
        "Trainer.init_state": lambda: Trainer(lambda p, b: 0).init_state(
            params),
        "train.__main__.main": lambda: train_main.main(
            ["--config", str(train_cfg)]),
        "convert.main": lambda: convert.main(
            ["--reverse", str(tmp_path), str(tmp_path / "hf")]),
        "load_hf_checkpoint": lambda: convert.load_hf_checkpoint(
            str(tmp_path / "hf_in")),
        "resnet.init_params": lambda: resnet.init_params(
            resnet.tiny(), torch.Generator().manual_seed(0)),
        "mlp.init_params": lambda: mlp.init_params(
            mlp.MLPConfig(), torch.Generator().manual_seed(0)),
    }
    (tmp_path / "hf_in").mkdir()
    (tmp_path / "hf_in" / "config.json").write_text(
        json.dumps(convert.config_to_hf(cfg)))
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    monkeypatch.setenv("KUBEDL_MODEL_PATH", str(tmp_path))
    monkeypatch.delenv("KUBEDL_TOKENIZER", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main.main(["--batch-input", str(train_cfg),
                         "--batch-output", str(tmp_path / "out.jsonl")])
    # asked for explicitly, the CPU runs
    eng = engine.InferenceEngine(cfg, params, device="cpu")
    assert len(eng.generate([[1, 2, 3]], 2)[0]) == 2


def test_moe_entry_points_refuse_the_cpu_without_a_card(monkeypatch,
                                                        tmp_path):
    from kubedl_tpu_torch.models import io, moe
    from kubedl_tpu_torch.serving import batching
    from kubedl_tpu_torch.train import __main__ as train_main

    cfg = moe.MoEConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                        n_kv_heads=1, d_ff=64, n_experts=4, dtype="float32")
    params = moe.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    io.save_model(cfg, params, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train_cfg = tmp_path / "train.json"
    train_cfg.write_text('{"model": "moe.tiny", "steps": 1}')
    calls = {
        "init_params": lambda: moe.init_params(
            cfg, torch.Generator().manual_seed(0)),
        "init_layer": lambda: moe.init_layer(
            cfg, torch.Generator().manual_seed(0)),
        "init_cache": lambda: moe.init_cache(cfg, 1, 8),
        "init_block_pool": lambda: moe.init_block_pool(cfg, 4, 8),
        "load_model": lambda: io.load_model(str(tmp_path)),
        "ContinuousBatchingEngine": lambda: batching.ContinuousBatchingEngine(
            cfg, params, lanes=1, max_len=16),
        "train.__main__.main": lambda: train_main.main(
            ["--config", str(train_cfg)]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    got, _ = io.load_model(str(tmp_path), device="cpu")
    assert got == cfg
