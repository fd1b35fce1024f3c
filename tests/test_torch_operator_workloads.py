"""The scenarios of ``tests/test_workloads.py`` run on the port's modules
(``tests/operator_scenarios.py``)."""

from operator_scenarios import load

load("test_workloads.py", globals())
