"""Which source a backward launch takes, what the tensor-core route
refuses, and the kernel build cache, all on the CPU: no ``nvcc`` and no
card are needed to decide a route, check an operand or name a build."""

import shutil

import pytest
import torch

from kubedl_tpu_torch.ops import _build
from kubedl_tpu_torch.ops import attention as attn

ROUTES = [
    (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"),
    (torch.float16, 64, "sm90"),
    (torch.float16, 128, "sm90"),
    (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"),
    (torch.bfloat16, 80, "simt"),
    (torch.bfloat16, 256, "simt"),
    (torch.float16, 256, "simt"),
    (torch.bfloat16, 32, "simt"),
]


@pytest.mark.parametrize("dtype,hd,route", ROUTES,
                         ids=[f"{str(d).split('.')[-1]}-hd{h}"
                              for d, h, _ in ROUTES])
def test_backward_route(dtype, hd, route):
    """bf16/f16 at head dims 64 and 128 (the training path, every
    Llama-family config) take the tensor-core kernels; float32 and every
    other head dim keep the general kernels."""
    assert attn.flash_bwd_route(dtype, hd) == route


def test_every_route_names_a_source_with_both_entry_points():
    for route, (name, prefix) in attn._BWD_SOURCES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn in ("dq", "dkv"):
            assert f"int {prefix}{fn}(" in src, (route, fn)
        assert attn.flash_dq.launches_by_route.keys() \
            == attn._BWD_SOURCES.keys()


CHECKED = {
    "contiguous": (lambda t: t, True),
    "transposed_heads": (lambda t: t.transpose(1, 2).contiguous()
                         .transpose(1, 2), True),
    "offset_one_element": (lambda t: torch.cat(
        [t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape), False),
    "odd_head_stride": (lambda t: torch.zeros(
        t.shape[0], t.shape[1], t.shape[2], 68,
        dtype=t.dtype)[..., :64], False),
}


@pytest.mark.parametrize("case", sorted(CHECKED))
def test_tma_operand_check(case):
    """TMA loads q/k/v/dO: bases and strides must fall on 16 bytes. A
    permuted view passes; a base one element in, or rows 136 bytes apart,
    is refused by name."""
    make, ok = CHECKED[case]
    t = make(torch.randn(2, 16, 4, 64).bfloat16())
    if ok:
        attn._check_tma("flash_dq", t)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            attn._check_tma("flash_dq", t)


def test_build_name_covers_headers(tmp_path):
    """An edited header under csrc/ renames (so rebuilds) every library,
    an untouched tree keeps its names (so reuses the build)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    sources = sorted(csrc.glob("*.cu"))
    assert {s.name for s in sources} >= {"flash_fwd.cu", "flash_bwd.cu",
                                         "flash_bwd_sm90.cu"}
    before = {s.name: _build._target(s) for s in sources}
    assert before == {s.name: _build._target(_build.CSRC / s.name)
                      for s in sources}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s.name: _build._target(s) for s in sources}
    for name in before:
        assert after[name] != before[name], name
        assert after[name].parent == _build.BUILD_DIR
        assert after[name].name.startswith(f"lib{name[:-3]}-")


def test_build_name_covers_the_source(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "flash_bwd_sm90.cu"
    other = csrc / "flash_fwd.cu"
    before = (_build._target(src), _build._target(other))
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target(src) != before[0]
    assert _build._target(other) == before[1]
