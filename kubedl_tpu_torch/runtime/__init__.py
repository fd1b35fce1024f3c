"""In-container runtime of the port: the rendezvous (``bootstrap``)."""
