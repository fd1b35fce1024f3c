"""The scenarios of ``tests/test_cache_notebook.py`` run on the port's modules
(``tests/operator_scenarios.py``)."""

from operator_scenarios import load

load("test_cache_notebook.py", globals())
