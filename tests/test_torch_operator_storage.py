"""The scenarios of ``tests/test_storage.py`` run on the port's modules
(``tests/operator_scenarios.py``)."""

from operator_scenarios import load

load("test_storage.py", globals())
