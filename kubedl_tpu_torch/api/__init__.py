"""API object types the port's replays read: SLO objectives
(``slo``) and the Queue API's tenant routing (``queue``), copies of the
JAX package's framework-free modules."""
