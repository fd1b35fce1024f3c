"""The safetensors file format, read and written with ``torch`` alone.

The JAX package calls the ``safetensors`` package; the port keeps its
own reader and writer, so a machine with PyTorch and nothing else reads
and writes HuggingFace checkpoints. A file is

* 8 bytes: the header's length N, a little-endian unsigned integer;
* N bytes: a JSON header, ``{name: {"dtype": "BF16", "shape": [...],
  "data_offsets": [begin, end]}, "__metadata__": {str: str}}``, padded
  with spaces to a multiple of 8 bytes;
* the tensors' raw little-endian bytes, offsets relative to the end of
  the header.

:func:`load_file` maps the file and wraps each tensor's bytes with
``torch.frombuffer`` (no copy on the host until a tensor is moved);
:func:`save_file` writes a contiguous copy of every tensor, so a
transposed view is written in its logical order.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import numpy as np
import torch

#: the format's dtype names, and the ones this module reads and writes
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
          "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {dt: name for name, dt in DTYPES.items()}
#: the header's size limit of the reference implementation (100 MB)
MAX_HEADER = 100_000_000


def _header(buf, path: str) -> tuple:
    """(header dict, data start) of a mapped file, every entry checked."""
    if len(buf) < 8:
        raise ValueError(f"{path}: {len(buf)} bytes, shorter than the "
                         "8-byte header length")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > MAX_HEADER or 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} runs past the file's "
                         f"{len(buf)} bytes")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    data = len(buf) - 8 - n
    spans = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info.get("dtype")
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}; "
                             f"this reader takes {sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        numel = int(np.prod(info["shape"], dtype=np.int64))
        itemsize = DTYPES[dtype].itemsize
        if not 0 <= begin <= end or end - begin != numel * itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans bytes "
                             f"[{begin}, {end}), its shape {info['shape']} "
                             f"of {dtype} needs {numel * itemsize}")
        if end > data:
            raise ValueError(f"{path}: tensor {name!r} ends at byte {end} of "
                             f"a {data}-byte buffer: the file is short")
        spans.append((begin, end, name))
    spans.sort()
    for (b0, e0, n0), (b1, e1, n1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensors {n0!r} and {n1!r} overlap")
    return header, 8 + n


def load_file(path: str, device=None) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a safetensors file. On the host the tensors
    share the file's private mapping (pages are read as they are
    touched); with ``device`` each is copied there."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size
               else b"")
    header, start = _header(memoryview(buf), path)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = DTYPES[info["dtype"]], info["shape"]
        begin, end = info["data_offsets"]
        if end == begin:
            t = torch.empty(shape, dtype=dtype)
        elif (start + begin) % dtype.itemsize:
            # a misaligned tensor is copied out of the map
            t = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                                 offset=start + begin).clone().view(
                                     dtype).reshape(shape)
        else:
            t = torch.frombuffer(buf, dtype=dtype, offset=start + begin,
                                 count=(end - begin) // dtype.itemsize
                                 ).reshape(shape)
        out[name] = t if device is None else t.to(device)
    return out


def _host(t) -> torch.Tensor:
    """A contiguous host tensor of ``t`` (a tensor or a numpy array)."""
    if not torch.is_tensor(t):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return t.detach().to("cpu").contiguous()


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) as one
    safetensors file. Entries go largest element first, then by name, as
    the reference writer orders them; the file lands under its final
    name only when it is complete."""
    if metadata is not None and not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in metadata.items()):
        raise ValueError("safetensors metadata must map str to str")
    host = {name: _host(t) for name, t in tensors.items()}
    for name, t in host.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors name here ({sorted(DTYPES)})")
    order = sorted(host, key=lambda k: (-host[k].element_size(), k))
    header, offset = {}, 0
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    for name in order:
        t = host[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = host[name]
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)
