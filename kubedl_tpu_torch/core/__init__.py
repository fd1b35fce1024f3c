"""What the port needs of the operator's core: the API-server client of
an in-cluster job (``kubeclient``)."""
