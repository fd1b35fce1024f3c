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


def test_the_federation_slice_modules_are_checked():
    """...and so are the federation day and the control-plane closure it
    runs (slice 19): the journaled, replicated API server, the manager,
    the scheduler and its inventory, the controllers, the chaos campaigns,
    the forensics and the cluster replay."""
    assert {"kubedl_tpu_torch.federation",
            "kubedl_tpu_torch.federation.replay",
            "kubedl_tpu_torch.replay.harness",
            "kubedl_tpu_torch.core.apiserver",
            "kubedl_tpu_torch.core.replication",
            "kubedl_tpu_torch.scheduling.scheduler",
            "kubedl_tpu_torch.controllers.engine",
            "kubedl_tpu_torch.chaos.campaign",
            "kubedl_tpu_torch.forensics"} <= set(MODULES)


def test_the_operator_slice_modules_are_checked():
    """...and so is the rest of the operator (slice 20): its binary, the
    registry and the workload controllers, admission, storage, the
    clients and the console."""
    assert {"kubedl_tpu_torch.__main__",
            "kubedl_tpu_torch.controllers.registry",
            "kubedl_tpu_torch.controllers.workloads",
            "kubedl_tpu_torch.controllers.workloads.pytorch",
            "kubedl_tpu_torch.core.admission", "kubedl_tpu_torch.storage",
            "kubedl_tpu_torch.storage.backends", "kubedl_tpu_torch.client",
            "kubedl_tpu_torch.client.clientset",
            "kubedl_tpu_torch.console", "kubedl_tpu_torch.console.server",
            "kubedl_tpu_torch.replay.scorecard",
            "kubedl_tpu_torch.replay.elastic"} <= set(MODULES)


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
#: the federation day's control-plane closure, copied (slice 19), and the
#: modules it completed, which earlier slices had copied in part
FEDERATION_COPIES = (
    "api/common", "api/throughputprofile", "chaos/__init__",
    "chaos/campaign", "controllers/chaos", "controllers/elastic",
    "controllers/engine", "controllers/expectations",
    "controllers/hostnetwork", "controllers/interface",
    "controllers/testing", "core/apiserver", "core/journal",
    "core/leaderelection", "core/manager", "core/replication",
    "federation/__init__", "federation/catalog", "federation/routing",
    "federation/shipping", "federation/topology", "forensics/__init__",
    "forensics/report", "forensics/timeline", "forensics/worldline",
    "platform/__init__", "platform/cache", "platform/codesync",
    "platform/models", "platform/serving", "platform/tensorboard",
    "replay/harness", "scheduling/__init__", "scheduling/gang",
    "scheduling/inventory", "scheduling/queue", "scheduling/scheduler",
    "scheduling/scoring", "telemetry/explainer", "telemetry/goodput",
    "telemetry/profiles", "telemetry/straggler", "tpu/__init__",
    "tpu/placement", "tpu/topology", "trace/analysis", "trace/export",
    "trace/lifecycle", "utils/retry", "utils/status", "utils/tenancy",
    "utils/train")
COMPLETED_COPIES = ("core/events", "core/__init__", "metrics/registry",
                    "metrics/__init__", "trace/tracer", "trace/__init__",
                    "telemetry/__init__")
#: the rest of the operator, copied (slice 20), and the two modules it
#: completed: the client's operator verbs and the metrics endpoint's server
OPERATOR_COPIES = (
    "__main__", "client/__init__", "client/clientset", "client/inference",
    "client/informers", "console/__init__", "console/presubmit",
    "console/proxy", "console/server", "console/sources",
    "controllers/registry", "controllers/workloads/__init__",
    "controllers/workloads/elasticdl", "controllers/workloads/jaxjob",
    "controllers/workloads/mars", "controllers/workloads/mpi",
    "controllers/workloads/pytorch", "controllers/workloads/rljob",
    "controllers/workloads/tensorflow", "controllers/workloads/xdl",
    "controllers/workloads/xgboost", "core/admission", "core/deployment",
    "core/features", "platform/cron", "platform/notebook",
    "replay/elastic", "replay/scorecard", "storage/__init__",
    "storage/backends", "storage/dmo", "storage/external",
    "storage/persist", "utils/concurrent", "utils/cronschedule",
    "utils/quota", "utils/workloadgate")
OPERATOR_COMPLETED = ("core/kubeclient", "metrics/http")
for _path in (FEDERATION_COPIES + COMPLETED_COPIES + ("federation/replay",)
              + OPERATOR_COPIES + OPERATOR_COMPLETED):
    TWINS[f"kubedl_tpu/{_path}.py"] = "kubedl_tpu_torch." + _path.replace(
        "/", ".").removesuffix(".__init__")
#: public names a twin leaves out on purpose: none since slice 20, when the
#: API-server client became JAX's whole (kubeconfig files, the operator's
#: verbs, its clock and watches)
LEFT_OUT: dict = {}


@pytest.mark.parametrize("source", sorted(TWINS))
def test_the_twins_have_the_jax_modules_public_names(source):
    """Read from the JAX sources without importing them: since slice 14
    none is missing (``build_pp_pretrain``, ``run_grpo``,
    ``resolve_reward`` and ``Trainer.remesh`` were), and since slice 20
    ``LEFT_OUT`` is empty."""
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
    "run_multimodel_comparison": ["model", "device"],
    "FederationReplay.__init__": ["model", "device"]}


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


@pytest.mark.parametrize("path", ("federation/replay",) + FEDERATION_COPIES
                         + COMPLETED_COPIES)
def test_the_federation_modules_take_the_jax_ones_parameters(path):
    """The federation day adds the model and the device; every copy of
    its closure takes JAX's parameters (a package file with no function
    of its own checks nothing)."""
    _check_parameters(path, allow_none=True)


@pytest.mark.parametrize("path", OPERATOR_COPIES + OPERATOR_COMPLETED)
def test_the_operator_modules_take_the_jax_ones_parameters(path):
    """Every copy of the operator (slice 20) takes JAX's parameters."""
    _check_parameters(path, allow_none=True)


def _check_parameters(path, allow_none=False):
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
            # a decorator's wrapper (``storage/backends``' ``_locked``
            # takes ``*args, **kwargs``): the function it closes over
            obj = next((c.cell_contents for c in getattr(
                obj, "__closure__", None) or ()
                if getattr(c.cell_contents, "__name__", None) == fn.name
                and callable(c.cell_contents)), obj)
            args = fn.args
            want = [a.arg for a in args.posonlyargs + args.args]
            want += [args.vararg.arg] if args.vararg else []
            want += [a.arg for a in args.kwonlyargs]
            want += [args.kwarg.arg] if args.kwarg else []
            assert _params(obj) == want + PORT_PARAMS.get(name, []), name
            checked += 1
    assert checked > 0 or allow_none


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
    "replay/fleet", "rl/publisher")] + list(FEDERATION_COPIES
                                           + COMPLETED_COPIES
                                           + OPERATOR_COPIES
                                           + OPERATOR_COMPLETED))
def test_the_copied_modules_are_the_jax_ones_to_the_statement(path):
    """A copy differs from its JAX source only in imports and docstrings
    (and in naming the port's package where it names its own, as its
    loggers, the root logger of ``python -m kubedl_tpu_torch``, the OTLP
    scope and the predictor's command do).
    ``replay/fleet`` (the ``device`` and the per-replica weights seam)
    and ``rl/publisher`` (the install through ``load_weights``) differ on
    purpose and are checked by name and parameter above."""
    want = (ROOT / f"kubedl_tpu/{path}.py").read_text().replace(
        '"kubedl_tpu.', '"kubedl_tpu_torch.').replace(
        '"kubedl_tpu"', '"kubedl_tpu_torch"')
    got = (PKG / f"{path}.py").read_text()
    assert _without_docs_and_imports(got) == _without_docs_and_imports(want)


#: what a twin adds to its JAX source, by function (``*``: every one):
#: parameters, and the keywords that hand them on
ADDED = {"serving/autoconfig": {"*": {"device"}},
         "replay/multimodel": {"*": {"device"},
                               "run_multimodel_comparison": {"model"}},
         "federation/replay": {"*": {"device", "model"}}}


def _without_additions(source: str, added: dict) -> str:
    """``source`` with ``added``'s parameters and keywords taken out, and
    with what only they feed: an assignment to one of them, and the
    branch of a conditional expression whose test reads one (the other
    branch stays)."""
    import ast

    def reads(node, names):
        return any(isinstance(n, ast.Name) and n.id in names
                   for n in ast.walk(node))

    class Strip(ast.NodeTransformer):
        drop = added.get("*", set())

        def visit_Assign(self, node):
            if all(isinstance(t, ast.Name) and t.id in self.drop
                   for t in node.targets):
                return None
            return self.generic_visit(node)

        def visit_IfExp(self, node):
            self.generic_visit(node)
            if reads(node.test, self.drop):
                return node.orelse if reads(node.body, self.drop) \
                    else node.body
            return node

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


#: where a twin departs from its JAX source on purpose, by function: the
#: statements from the one that assigns the first name up to, not
#: including, the one that assigns the second. The auto-configurator's
#: probe repairs the repeat loop (``samples = []`` up to ``tps = ...``):
#: JAX's clamps a repeat whose long run is not longer than its short one
#: to 1e-9 s, the port's measures it again and raises when none is valid
DIVERGED = {"serving/autoconfig": {"probe_candidate": ("samples", "tps")}}


def _without_divergence(source: str, diverged: dict) -> str:
    """``source`` without the statements ``diverged`` names, and without
    the module constants that only those statements read."""
    import ast
    tree = ast.parse(source)

    def at(body, name):
        hits = [i for i, stmt in enumerate(body)
                if isinstance(stmt, ast.Assign) and any(
                    isinstance(n, ast.Name) and n.id == name
                    for t in stmt.targets for n in ast.walk(t))]
        assert hits, f"no statement assigns {name}"
        return hits[0]
    cut = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in diverged:
            first, stop = diverged[node.name]
            lo, hi = at(node.body, first), at(node.body, stop)
            cut += node.body[lo:hi]
            node.body[lo:hi] = []
    assert len(cut) > 0, f"no statement of {sorted(diverged)} was cut"

    def loads(nodes):
        return {n.id for stmt in nodes for n in ast.walk(stmt)
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
    only = loads(cut) - loads(tree.body)
    tree.body = [stmt for stmt in tree.body if not (
        isinstance(stmt, ast.Assign) and all(
            isinstance(t, ast.Name) and t.id in only for t in stmt.targets))]
    return ast.unparse(tree)


@pytest.mark.parametrize("path", sorted(ADDED))
def test_the_slice_18_twins_are_the_jax_ones_but_for_their_additions(path):
    """The auto-configurator, the multi-model day and the federation day
    are their JAX sources statement for statement once ``ADDED`` is taken
    out: the selection, the early stop, the pruning, the fallback and the
    days are JAX's. ``DIVERGED`` is cut from both sources, and only
    there."""
    import ast
    want = ast.unparse(ast.parse((ROOT / f"kubedl_tpu/{path}.py")
                                 .read_text()))
    got = _without_additions((PKG / f"{path}.py").read_text(), ADDED[path])
    assert _without_additions(want, ADDED[path]) == want
    if path in DIVERGED:
        assert _without_docs_and_imports(got) != \
            _without_docs_and_imports(want)
        got = _without_divergence(got, DIVERGED[path])
        want = _without_divergence(want, DIVERGED[path])
    assert _without_docs_and_imports(got) == \
        _without_docs_and_imports(want)


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
QUEUED: dict = {}


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


def test_every_module_of_the_jax_package_has_a_twin():
    """The census by file (slice 20): every ``.py`` under ``kubedl_tpu/``
    has a twin of the same path under ``kubedl_tpu_torch/``."""
    jax_files = {p.relative_to(ROOT / "kubedl_tpu")
                 for p in (ROOT / "kubedl_tpu").rglob("*.py")}
    assert len(jax_files) > 150
    assert sorted(str(p) for p in jax_files
                  if not (PKG / p).is_file()) == []


def test_the_consoles_frontend_is_the_jax_ones_byte_for_byte():
    """``console/server.py`` serves its assets from beside itself: the
    port's copy of the dashboard is JAX's, file for file, byte for
    byte."""
    def files(root):
        return {p.relative_to(root): p.read_bytes()
                for p in root.rglob("*") if p.is_file()}
    want = files(ROOT / "kubedl_tpu/console/frontend")
    assert len(want) == 16
    assert files(PKG / "console/frontend") == want


def test_the_jax_replay_packages_exports_are_the_ports():
    """Every name ``kubedl_tpu.replay`` imports into its package,
    ``kubedl_tpu_torch.replay`` has too: the scorecards and the elastic
    comparison since slice 20."""
    import ast

    import kubedl_tpu_torch.replay as replay
    tree = ast.parse((ROOT / "kubedl_tpu/replay/__init__.py").read_text())
    want = [a.asname or a.name for n in tree.body
            if isinstance(n, ast.ImportFrom) for a in n.names]
    assert "build_elastic_block" in want and "build_scorecard" in want
    assert [n for n in want if not hasattr(replay, n)] == []


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
    from kubedl_tpu_torch.federation import FederationReplay, RegionTopology
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
        "FederationReplay": lambda: FederationReplay(
            RegionTopology.parse("a,b"), str(tmp_path / "fed"),
            model=(cfg, params)),
    }
    (tmp_path / "hf_in").mkdir()
    (tmp_path / "hf_in" / "config.json").write_text(
        json.dumps(convert.config_to_hf(cfg)))
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the federation day refused before any region wrote its journal
    assert not (tmp_path / "fed").exists()
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
