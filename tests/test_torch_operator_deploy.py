"""The scenarios of ``tests/test_deploy.py`` run on the port's modules
(``tests/operator_scenarios.py``)."""

from operator_scenarios import load

load("test_deploy.py", globals())
