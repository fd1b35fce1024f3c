"""Typed client library: clientset + shared informers + listers.

The analog of the reference's generated ``client/`` tree (clientset,
informers, listers for ``training.kubedl.io``, generated by
``hack/generate_client.sh``). Nothing here is generated — one generic
resource client parameterized by a kind table gives the same surface with
a fraction of the code, which is the idiomatic move when objects are
schema-checked dicts rather than Go structs.

Copied from ``kubedl_tpu/client/__init__.py`` (the port imports nothing of the JAX package).
"""

from .clientset import (Clientset, ResourceClient, KIND_TABLE, ResourceInfo)
from .informers import (Informer, Lister, SharedInformerFactory)

__all__ = [
    "Clientset", "ResourceClient", "KIND_TABLE", "ResourceInfo",
    "Informer", "Lister", "SharedInformerFactory",
]
