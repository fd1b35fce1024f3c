"""Controllers: the generic job engine (``engine``) with its
expectations, host network ports, chaos and elastic slices; the
per-workload controllers (``workloads``: the nine training kinds); the
serving fleet's autoscaler (``servingfleet``); the test job kind
(``testing``); and ``registry``, which builds the operator from them.
Copies of the JAX package's framework-free modules, as the package's
docstring there says: "the generic job engine + per-workload and platform
controllers"."""
