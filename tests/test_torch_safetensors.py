"""The port's own safetensors reader and writer, held against the
``safetensors`` package on the CPU: files cross both ways bit for bit
(bfloat16 included), transposed views are written in their logical
order, and malformed files are refused."""

import json
import struct

import ml_dtypes  # noqa: F401 — registers numpy's bfloat16 for safetensors
import numpy as np
import pytest
import torch

safetensors = pytest.importorskip("safetensors")
from safetensors.numpy import load_file as st_load  # noqa: E402
from safetensors.torch import save_file as st_save  # noqa: E402

from kubedl_tpu_torch.models import safetensors_io as sio  # noqa: E402


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(4, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i8": torch.randint(-128, 127, (7,), generator=g, dtype=torch.int8),
        "i32": torch.randint(-9, 9, (2, 2), generator=g, dtype=torch.int32),
        "i64": torch.tensor(2 ** 40 + 3),
        "u8": torch.randint(0, 255, (5,), generator=g, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "empty": torch.zeros(0, 4),
    }


def _bits(x):
    """Comparable numpy bits of a torch tensor or a numpy array."""
    if torch.is_tensor(x):
        x = x.contiguous()
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_the_ports_file_loads_in_the_package_bit_for_bit(tmp_path):
    ts = _tensors()
    path = str(tmp_path / "a.safetensors")
    sio.save_file(ts, path, metadata={"format": "pt"})
    got = st_load(path)
    assert set(got) == set(ts)
    for k, t in ts.items():
        assert got[k].shape == tuple(t.shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(t), err_msg=k)
    with safetensors.safe_open(path, "np") as f:
        assert f.metadata() == {"format": "pt"}
    # the header is padded to 8 bytes, the data follows it
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
    assert n % 8 == 0


def test_the_packages_file_loads_in_the_port_bit_for_bit(tmp_path):
    ts = _tensors(1)
    path = str(tmp_path / "b.safetensors")
    # a header with __metadata__, as the package writes it
    st_save({k: v.contiguous() for k, v in ts.items()}, path,
            metadata={"note": "x"})
    got = sio.load_file(path)
    assert set(got) == set(ts)
    for k, t in ts.items():
        assert got[k].dtype == t.dtype, k
        assert torch.equal(got[k], t), k
    on = sio.load_file(path, device="cpu")
    assert torch.equal(on["bf16"], ts["bf16"])


def test_transposed_views_are_written_in_their_logical_order(tmp_path):
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    path = str(tmp_path / "t.safetensors")
    sio.save_file({"wt": w.T, "np": w.numpy().T}, path)
    got = st_load(path)
    np.testing.assert_array_equal(got["wt"], w.T.numpy())
    np.testing.assert_array_equal(got["np"], w.numpy().T)


def _write_raw(path, header: dict, data: bytes, pad=True):
    raw = json.dumps(header).encode()
    if pad:
        raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["dtype", "overlap", "short", "size",
                                  "header_past_end", "not_json", "tiny"])
def test_malformed_files_are_refused(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    if case == "dtype":
        _write_raw(path, {"a": {"dtype": "F64", "shape": [1],
                                "data_offsets": [0, 8]}}, b"\0" * 8)
        match = "dtype"
    elif case == "overlap":
        _write_raw(path, {"a": {"dtype": "F32", "shape": [2],
                                "data_offsets": [0, 8]},
                          "b": {"dtype": "F32", "shape": [2],
                                "data_offsets": [4, 12]}}, b"\0" * 12)
        match = "overlap"
    elif case == "short":
        _write_raw(path, {"a": {"dtype": "F32", "shape": [4],
                                "data_offsets": [0, 16]}}, b"\0" * 8)
        match = "short"
    elif case == "size":
        _write_raw(path, {"a": {"dtype": "F32", "shape": [3],
                                "data_offsets": [0, 8]}}, b"\0" * 8)
        match = "needs"
    elif case == "header_past_end":
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 1000) + b"{}")
        match = "runs past"
    elif case == "not_json":
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", 8) + b"not json")
        match = "not JSON"
    else:
        with open(path, "wb") as f:
            f.write(b"\1\0")
        match = "shorter"
    with pytest.raises(ValueError, match=match):
        sio.load_file(path)


def test_save_refuses_what_the_format_cannot_hold(tmp_path):
    with pytest.raises(ValueError, match="no safetensors name"):
        sio.save_file({"c": torch.zeros(2, dtype=torch.complex64)},
                      str(tmp_path / "c.safetensors"))
    with pytest.raises(ValueError, match="str to str"):
        sio.save_file({"a": torch.zeros(2)}, str(tmp_path / "m.st"),
                      metadata={"n": 1})
