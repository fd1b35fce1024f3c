"""The scorecard tests of ``tests/test_replay.py`` run on the port's
modules (``tests/operator_scenarios.py``): the gates and the regression
check on synthetic scorecards, and the smoke day's scorecard, whose
serving leg runs the port's engine on the CPU."""

from operator_scenarios import load

load("test_replay.py", globals(),
     only=("test_smoke_scorecard_gates_pass",
           "test_evaluate_gates_pass_and_fail",
           "test_check_regression_detects_backslide_and_respects_tolerance",
           "test_check_regression_ignores_mismatched_baseline",
           "test_placement_block_is_additive_and_shaped"),
     replace=((r"ServingReplay\(wl\)", 'ServingReplay(wl, device="cpu")'),))
