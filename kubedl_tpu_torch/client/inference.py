"""Typed client for kubedl-tpu predictors (stdlib-only, pip-installable
with the base package).

The reference exposes generated clientsets for its CRDs but nothing for
the data plane (predictors are stock TFServing/Triton images). Here the
predictor is in-tree, so a first-party client ships with it:

    from kubedl_tpu_torch.client.inference import InferenceClient

    c = InferenceClient("http://llama-chat.default.svc:8000")
    print(c.chat([{"role": "user", "content": "hi"}]))
    for delta in c.chat_stream([{"role": "user", "content": "hi"}]):
        print(delta, end="", flush=True)
    vectors = c.embed(["query text", "doc text"])

Every method maps 1:1 onto the predictor's OpenAI-convention routes
(``serving/server.py``), so the client also works against any other
OpenAI-compatible endpoint.

Copied from ``kubedl_tpu/client/inference.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Iterator, List, Optional, Sequence


class InferenceError(RuntimeError):
    """Server-side failure, carrying the HTTP status and the message
    from the OpenAI error envelope when present."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class InferenceClient:
    def __init__(self, base_url: str, timeout_s: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    # -- plumbing ----------------------------------------------------------

    def _post(self, route: str, payload: dict, stream: bool = False):
        req = urllib.request.Request(
            self.base_url + route, method="POST",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout_s)
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read()).get("error")
                msg = (err.get("message") if isinstance(err, dict)
                       else str(err))
            except Exception:  # noqa: BLE001 — body is best-effort
                msg = e.reason
            raise InferenceError(e.code, msg or str(e.reason)) from None
        if stream:
            return resp
        with resp:
            return json.loads(resp.read())

    @staticmethod
    def _sse(resp) -> Iterator[dict]:
        with resp:
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                data = line[len("data: "):]
                if data == "[DONE]":
                    return
                yield json.loads(data)

    @staticmethod
    def _gen_params(max_tokens, temperature, top_p, stop) -> dict:
        out = {"max_tokens": max_tokens}
        if temperature is not None:
            out["temperature"] = temperature
        if top_p is not None:
            out["top_p"] = top_p
        if stop:
            out["stop"] = stop
        return out

    # -- generation --------------------------------------------------------

    def complete(self, prompt, max_tokens: int = 256,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None, stop=None,
                 n: int = 1) -> List[str]:
        """Completion texts for a prompt (string, list of strings, or
        token-id list); ``n`` samples per prompt."""
        body = {"prompt": prompt, "n": n,
                **self._gen_params(max_tokens, temperature, top_p, stop)}
        res = self._post("/v1/completions", body)
        return [c["text"] for c in res["choices"]]

    def complete_stream(self, prompt: str, max_tokens: int = 256,
                        temperature: Optional[float] = None,
                        top_p: Optional[float] = None,
                        stop=None) -> Iterator[str]:
        """Yield completion text deltas as they decode."""
        body = {"prompt": prompt, "stream": True,
                **self._gen_params(max_tokens, temperature, top_p, stop)}
        for chunk in self._sse(self._post("/v1/completions", body,
                                          stream=True)):
            delta = chunk["choices"][0].get("text", "")
            if delta:
                yield delta

    def chat(self, messages: Sequence[dict], max_tokens: int = 256,
             temperature: Optional[float] = None,
             top_p: Optional[float] = None, stop=None) -> str:
        """Assistant reply for a chat conversation."""
        body = {"messages": list(messages),
                **self._gen_params(max_tokens, temperature, top_p, stop)}
        res = self._post("/v1/chat/completions", body)
        return res["choices"][0]["message"]["content"]

    def chat_stream(self, messages: Sequence[dict],
                    max_tokens: int = 256,
                    temperature: Optional[float] = None,
                    top_p: Optional[float] = None,
                    stop=None) -> Iterator[str]:
        """Yield assistant content deltas as they decode."""
        body = {"messages": list(messages), "stream": True,
                **self._gen_params(max_tokens, temperature, top_p, stop)}
        for chunk in self._sse(self._post("/v1/chat/completions", body,
                                          stream=True)):
            delta = chunk["choices"][0].get("delta", {}).get("content", "")
            if delta:
                yield delta

    def embed(self, inputs, chunk: int = 16) -> List[List[float]]:
        """L2-normalized embedding vectors for a string or list of
        strings. Inputs beyond the server's batch cap are chunked
        transparently (``chunk`` should not exceed the predictor's
        ``max_batch``)."""
        if isinstance(inputs, str):
            inputs = [inputs]
        chunk = max(chunk, 1)          # clamp ONCE: the slice uses it too
        out: List[List[float]] = []
        for start in range(0, len(inputs), chunk):
            res = self._post("/v1/embeddings",
                             {"input": inputs[start:start + chunk]})
            out.extend(d["embedding"] for d in
                       sorted(res["data"], key=lambda d: d["index"]))
        return out

    # -- introspection -----------------------------------------------------

    def models(self) -> List[str]:
        req = urllib.request.Request(self.base_url + "/v1/models")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return [m["id"] for m in json.loads(r.read())["data"]]

    def healthy(self) -> bool:
        try:
            req = urllib.request.Request(self.base_url + "/healthz")
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status == 200
        except OSError:
            return False


__all__ = ["InferenceClient", "InferenceError"]
