"""Tokenizers: text <-> token ids for serving and training.

Copied from ``kubedl_tpu/tokenizer.py`` (the port imports nothing from the
JAX package): the serving half of it, and ``text_documents`` for the
training data path.

* ``ByteTokenizer`` — zero-dependency UTF-8 byte fallback (256 byte ids
  + pad/bos/eos).
* ``HFTokenizer`` — a HuggingFace tokenizer loaded from a LOCAL
  directory (``local_files_only=True``; ``transformers`` imported lazily).
* ``StreamDecoder`` — incremental decoding for SSE streaming that never
  emits a torn multi-byte character.

``load_tokenizer(spec)``: ``"byte"`` or a local directory.
"""

from __future__ import annotations

import os
from typing import Iterable, List


class ByteTokenizer:
    """UTF-8 bytes as tokens: id = byte + 3, with pad=0 / bos=1 / eos=2.

    Every string round-trips exactly (``decode(encode(s)) == s``); the
    vocab is 259, comfortably inside every model preset's vocab size.
    """

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _offset = 3
    vocab_size = 256 + _offset

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = [b + self._offset for b in text.encode("utf-8")]
        if add_bos:
            ids.insert(0, self.bos_id)
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        raw = bytes(i - self._offset for i in ids
                    if self._offset <= i < self.vocab_size)
        return raw.decode("utf-8", errors="replace")


class HFTokenizer:
    """A HuggingFace tokenizer from a local directory (the ModelVersion
    artifact volume). Import of ``transformers`` is deferred so the
    operator process never pays for it."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self._tk = AutoTokenizer.from_pretrained(path,
                                                 local_files_only=True)
        self.vocab_size = len(self._tk)
        self.bos_id = (-1 if self._tk.bos_token_id is None
                       else int(self._tk.bos_token_id))
        self.eos_id = (-1 if self._tk.eos_token_id is None
                       else int(self._tk.eos_token_id))
        pad = self._tk.pad_token_id
        self.pad_id = 0 if pad is None else int(pad)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = [int(t) for t in
               self._tk.encode(text, add_special_tokens=False)]
        if add_bos and self.bos_id >= 0:
            ids.insert(0, self.bos_id)
        if add_eos and self.eos_id >= 0:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        return self._tk.decode(list(ids), skip_special_tokens=True)


def has_tokenizer_assets(path: str) -> bool:
    """True when ``path`` holds HuggingFace tokenizer files (the
    predictor auto-loads them so ModelVersion artifacts are
    self-contained)."""
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f)) for f in
        ("tokenizer.json", "tokenizer.model", "spiece.model",
         "vocab.json", "vocab.txt"))


def load_tokenizer(spec: str):
    """``"byte"`` -> ByteTokenizer; a local directory -> HFTokenizer.

    Empty spec returns None (token-ids-only mode, the historical
    contract). An unknown spec raises — a predictor silently falling
    back to bytes for a model trained on SentencePiece would serve
    garbage with a 200 status.
    """
    if not spec:
        return None
    if spec == "byte":
        return ByteTokenizer()
    if os.path.isdir(spec):
        return HFTokenizer(spec)
    raise ValueError(
        f"tokenizer spec {spec!r} is neither 'byte' nor a local "
        "directory of HuggingFace tokenizer assets")


class StreamDecoder:
    """Incremental text deltas over a growing token sequence.

    ``push(token)`` returns the newly stable text — decoded text minus
    any trailing replacement characters, which mean the byte stream ends
    mid-UTF-8-sequence and the next token(s) will complete it.
    ``flush()`` emits whatever remains (a genuinely malformed tail
    surfaces as U+FFFD only once, at end of stream).
    """

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = 0

    def push(self, token: int) -> str:
        self._ids.append(int(token))
        text = self._tok.decode(self._ids)
        stable = len(text)
        # hold back at most a partial UTF-8 tail (<= 3 pending bytes,
        # each rendered as one U+FFFD by errors="replace")
        held = 0
        while stable > 0 and held < 3 and text[stable - 1] == "�":
            stable -= 1
            held += 1
        if stable <= self._emitted:
            return ""
        delta = text[self._emitted:stable]
        self._emitted = stable
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta


def encode_prompt(tokenizer, text: str) -> List[int]:
    """Prompt-encoding convention shared by serving routes: BOS when the
    tokenizer defines one (matches how the model families were trained),
    never EOS."""
    return tokenizer.encode(text, add_bos=getattr(tokenizer, "bos_id",
                                                  -1) >= 0)


def render_chat(tokenizer, messages, add_generation_prompt: bool = True
                ) -> List[int]:
    """Token ids for a chat conversation.

    HF tokenizers that ship a chat template (instruct checkpoints)
    render through ``apply_chat_template`` — the exact format the model
    was tuned on. Tokenizers without one (ByteTokenizer, base-model HF)
    fall back to a simple tagged transcript::

        <|role|>\\ncontent\\n ... <|assistant|>\\n

    which is deterministic and round-trippable, for models fine-tuned
    in-tree on the same convention.
    """
    if not isinstance(messages, list) or not messages:
        raise ValueError("messages must be a non-empty list")
    for m in messages:
        if not isinstance(m, dict) or not isinstance(m.get("role"), str) \
                or not isinstance(m.get("content"), str):
            raise ValueError(
                "each message needs string 'role' and 'content'")
    tk = getattr(tokenizer, "_tk", None)
    if tk is not None and getattr(tk, "chat_template", None):
        return [int(t) for t in tk.apply_chat_template(
            messages, tokenize=True,
            add_generation_prompt=add_generation_prompt)]
    text = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in messages)
    if add_generation_prompt:
        text += "<|assistant|>\n"
    return tokenizer.encode(
        text, add_bos=getattr(tokenizer, "bos_id", -1) >= 0)


def text_documents(path: str, tokenizer, add_bos: bool = True,
                   add_eos: bool = True,
                   text_key: str = "text") -> Iterable[List[int]]:
    """Tokenized documents from a text corpus file, for
    ``train.data.pack_documents``.

    * ``*.jsonl`` — one JSON object per line; the document is
      ``obj[text_key]``;
    * anything else — plain text, one document per non-empty line.

    Yields lazily: a corpus is never fully resident on the host.
    """
    import json
    is_jsonl = path.endswith(".jsonl")
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            text = json.loads(line)[text_key] if is_jsonl else line
            yield tokenizer.encode(text, add_bos=add_bos, add_eos=add_eos)


__all__ = ["ByteTokenizer", "HFTokenizer", "StreamDecoder",
           "load_tokenizer", "encode_prompt", "render_chat",
           "has_tokenizer_assets", "text_documents"]
