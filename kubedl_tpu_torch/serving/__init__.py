"""Serving runtime of the port: the continuous-batching engine (what the
predictor runs), the static KV-cache engine, the predictor HTTP server
and the Morphling-style serving auto-configurator."""

from .autoconfig import (AutoConfigResult, Candidate, MultiConfigResult,
                         ServingSLO, autoconfigure, autoconfigure_multi)
from .batching import ContinuousBatchingEngine
from .engine import GenerateConfig, InferenceEngine
from .server import InferenceServer, ServerConfig

__all__ = ["AutoConfigResult", "autoconfigure", "autoconfigure_multi",
           "Candidate", "MultiConfigResult", "ServingSLO",
           "ContinuousBatchingEngine", "GenerateConfig", "InferenceEngine",
           "InferenceServer", "ServerConfig"]
