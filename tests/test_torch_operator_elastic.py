"""The operator's tests of ``tests/test_elastic_slices.py`` run on the
port's modules (``tests/operator_scenarios.py``): the flag check of
``python -m kubedl_tpu_torch``, the metric families ``build_operator``
registers, the console's elastic state and the elastic comparison
(``replay/elastic.py``)."""

from operator_scenarios import load

load("test_elastic_slices.py", globals(),
     only=("test_enable_elastic_slices_fails_fast_without_scheduler",
           "test_elastic_metric_families_register_only_when_enabled",
           "test_console_elastic_state",
           "test_spot_shrink_e2e_beats_full_restart_baseline"))
