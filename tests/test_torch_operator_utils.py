"""The scenarios of ``tests/test_utils.py`` run on the port's modules
(``tests/operator_scenarios.py``)."""

from operator_scenarios import load

load("test_utils.py", globals())
