"""The scenarios of ``tests/test_kubeclient.py`` run on the port's modules
(``tests/operator_scenarios.py``): the port's client over
``tests/fakekube.FakeKube``, its operator reconciling that cluster in
process and as ``python -m kubedl_tpu_torch --kubeconfig`` (started from
the repository's root), and leader election."""

from operator_scenarios import load

load("test_kubeclient.py", globals(),
     replace=((r'cwd="[^"]*"', "cwd=str(ROOT)"),))
