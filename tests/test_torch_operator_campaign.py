"""The campaign scorecard tests of ``tests/test_campaign.py`` run on the
port's modules (``tests/operator_scenarios.py``): its gates and
regression check, and the builder on a campaign day."""

from operator_scenarios import load

load("test_campaign.py", globals(),
     only=("test_campaign_gates_pass_and_fail",
           "test_campaign_regression_detects_tampering",
           "test_campaign_scorecard_builder_shape"))
