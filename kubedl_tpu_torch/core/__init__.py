"""What the port needs of the operator's core: the API-server client of
an in-cluster job (``kubeclient``) with the error family every caller
catches, the simulated clock the replays run on (``clock``), the object
helpers (``meta``) and the event types (``events``) of the SLO
evaluator."""
