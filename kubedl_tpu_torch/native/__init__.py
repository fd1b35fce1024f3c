"""Native host code of the port (C++, loaded with ``ctypes``): the
document packer behind ``train.data.pack_documents``.

Packing documents into training rows is per-step byte shuffling on the
host; in Python it would starve the card's input pipeline when the
corpus is large, so a finite list of documents goes through
``packer.cc``. The Python loop in ``train/data.py`` stays the plain
version, and generators and streams keep using it.

``ensure_built()`` compiles ``packer.cc`` with the host C++ compiler
(``$CXX``, else ``g++`` or ``c++``) at first use into
``build/kubedl_tpu_torch/libkubedl_native-<hash>.so``, the hash taken
over the source and the flags, as ``ops/_build.py`` names the CUDA
kernels: an edited source rebuilds, an unchanged one is reused, and
nothing is written beside the source. The packer's contract is the JAX
package's (``load()``, ``pack_rows_native()``, the ``KUBEDL_NATIVE=0``
opt-out), with one difference: ``load()`` returns ``None`` only under
``KUBEDL_NATIVE=0`` or when no C++ compiler is on ``PATH``. A build or a
load that fails raises with the compiler's output; nothing falls back
quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

from ..ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "packer.cc"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++") \
        or shutil.which("c++")


def _target(src: Path) -> Path:
    """The library ``src`` builds into, named by a hash of the source and
    the flags."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libkubedl_native-{h.hexdigest()[:12]}.so"


def ensure_built() -> Optional[Path]:
    """The built library of ``SRC``, compiled first if stale; ``None`` when
    no C++ compiler is on ``PATH``. A failed build raises with the
    compiler's output. The build writes a temporary file and renames it,
    so concurrent builds (test workers, ranks) never leave a truncated
    library under the final name."""
    src = SRC
    out = _target(src)
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(
                f"native build failed ({cxx} exit {res.returncode}):\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if stale; ``None`` under
    ``KUBEDL_NATIVE=0`` or when no C++ compiler is on ``PATH``."""
    if os.environ.get("KUBEDL_NATIVE", "1") == "0":
        return None
    with _lock:
        so = ensure_built()
        if so is None:
            return None
        lib = _libs.get(so)
        if lib is None:
            lib = ctypes.CDLL(str(so))
            lib.kubedl_pack_rows.restype = ctypes.c_long
            lib.kubedl_pack_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                ctypes.c_long, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long,
            ]
            _libs[so] = lib
        return lib


def pack_rows_native(docs, seq_len: int, pad_id: int = 0):
    """Pack a finite list of token documents into (tokens, segs, pos)
    int32 arrays of shape [rows, seq_len+1] via the C++ packer. Returns
    None when the native path is unavailable (the caller takes the
    Python loop)."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    seq1 = seq_len + 1
    lens = np.asarray([len(d) for d in docs], np.int64)
    if len(lens) == 0 or int(lens.sum()) == 0:
        return (np.zeros((0, seq1), np.int32),) * 3
    flat = np.concatenate([np.asarray(d, np.int32) for d in docs]) \
        if len(docs) > 1 else np.asarray(docs[0], np.int32)
    flat = np.ascontiguousarray(flat, np.int32)
    # every chunk opens at most one new row, +1 for the trailing flush
    max_rows = int(np.ceil(lens / seq1).sum()) + 1
    toks = np.empty((max_rows, seq1), np.int32)
    segs = np.empty((max_rows, seq1), np.int32)
    pos = np.empty((max_rows, seq1), np.int32)
    n = lib.kubedl_pack_rows(
        flat.ctypes.data, lens.ctypes.data, len(lens),
        seq_len, pad_id,
        toks.ctypes.data, segs.ctypes.data, pos.ctypes.data, max_rows)
    if n < 0:
        raise RuntimeError(
            f"the native packer needed more than {max_rows} rows for "
            f"{len(lens)} documents: its row bound is wrong")
    return toks[:n], segs[:n], pos[:n]
