"""Controllers the port's replays drive: the serving fleet's autoscaler
(``servingfleet``), a copy of the JAX package's framework-free module."""
