"""Serving runtime of the port: the static KV-cache engine and the
predictor HTTP server."""

from .engine import GenerateConfig, InferenceEngine
from .server import InferenceServer, ServerConfig

__all__ = ["GenerateConfig", "InferenceEngine", "InferenceServer",
           "ServerConfig"]
