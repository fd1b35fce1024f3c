"""In-container runtime of the port: the rendezvous (``bootstrap``) and
the in-place restart wrapper (``restart_agent``)."""
