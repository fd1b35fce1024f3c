"""Failure-retryability classification.

Port of reference ``pkg/util/train/train_util.go:22-43``, extended with the
TPU failure taxonomy: a preempted TPU VM or a libtpu init crash is transient
(the slice survives or is re-provisioned); a compilation error is permanent.

Copied from ``kubedl_tpu/utils/train.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

# exit codes treated as permanent (shell conventions)
_PERMANENT = {1, 2, 126, 127, 128, 139}
# retryable signals: SIGINT(130), SIGKILL(137), user-defined SIGUSR1(138), SIGTERM(143)
_RETRYABLE = {130, 137, 138, 143}

RETRYABLE_POD_REASONS = {
    "OOMKilled", "Killed", "Evicted", "UnexpectedAdmissionError",
    # TPU-native additions: GKE node preemption / TPU VM maintenance events
    "Preempted", "Shutdown", "NodeShutdown", "Terminated",
}


def is_retryable_exit_code(exit_code: int) -> bool:
    if exit_code in _PERMANENT:
        return False
    if exit_code in _RETRYABLE:
        return True
    return False


def is_retryable_pod_failed_reason(reason: str) -> bool:
    return reason in RETRYABLE_POD_REASONS
