"""Platform-service controllers (SURVEY.md §1.6).

The reference groups these under ``controllers/{model,serving,notebook,
cache,apps,persist}``: everything that is not a training-job controller —
model registry + image build, inference serving, notebooks, dataset cache,
cron, record persistence.

Copied from ``kubedl_tpu/platform/__init__.py`` (the port imports nothing of the JAX package).
"""

from .models import (  # noqa: F401
    ModelReconciler,
    ModelVersionReconciler,
    add_model_path_env,
    provider_for,
)
from .serving import InferenceReconciler  # noqa: F401
