"""Serving runtime of the port: the continuous-batching engine (what the
predictor runs), the static KV-cache engine and the predictor HTTP
server."""

from .batching import ContinuousBatchingEngine
from .engine import GenerateConfig, InferenceEngine
from .server import InferenceServer, ServerConfig

__all__ = ["ContinuousBatchingEngine", "GenerateConfig", "InferenceEngine",
           "InferenceServer", "ServerConfig"]
