"""Per-framework workload controllers (the reference's controllers/ layer).

Copied from ``kubedl_tpu/controllers/workloads/__init__.py`` (the port imports nothing of the JAX package).
"""

from .elasticdl import ElasticDLJobController  # noqa: F401
from .jaxjob import JAXJobController  # noqa: F401
from .mars import MarsJobController  # noqa: F401
from .mpi import MPIJobController  # noqa: F401
from .pytorch import PyTorchJobController  # noqa: F401
from .rljob import RLJobController  # noqa: F401
from .tensorflow import TFJobController  # noqa: F401
from .xdl import XDLJobController  # noqa: F401
from .xgboost import XGBoostJobController  # noqa: F401

ALL_CONTROLLERS = (
    PyTorchJobController, TFJobController, JAXJobController, MPIJobController,
    XGBoostJobController, XDLJobController, MarsJobController,
    ElasticDLJobController, RLJobController,
)
