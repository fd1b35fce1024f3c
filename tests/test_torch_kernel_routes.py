"""Which source each flash kernel's launch takes, how many blocks share a
GQA group in the tensor-core dK/dV kernel, what the tensor-core route
refuses, and the kernel build cache, all on the CPU: no ``nvcc`` and no
card are needed to decide a route, check an operand or name a build."""

import shutil

import pytest
import torch

from kubedl_tpu_torch.ops import _build
from kubedl_tpu_torch.ops import attention as attn

#: (dtype, head dim) and the route of K1 (forward), K2 (dq) and K3 (dkv)
ROUTES = [
    (torch.bfloat16, 64, {"forward": "sm90", "dq": "sm90", "dkv": "sm90"}),
    (torch.bfloat16, 128, {"forward": "sm90", "dq": "sm90", "dkv": "sm90"}),
    (torch.float16, 64, {"forward": "sm90", "dq": "sm90", "dkv": "sm90"}),
    (torch.float16, 128, {"forward": "sm90", "dq": "sm90", "dkv": "sm90"}),
    (torch.float32, 64, {"forward": "simt", "dq": "simt", "dkv": "simt"}),
    (torch.float32, 128, {"forward": "simt", "dq": "simt", "dkv": "simt"}),
    (torch.bfloat16, 80, {"forward": "simt", "dq": "simt", "dkv": "simt"}),
    (torch.bfloat16, 256, {"forward": "sm90", "dq": "sm90", "dkv": "sm90"}),
    (torch.float16, 256, {"forward": "sm90", "dq": "sm90", "dkv": "sm90"}),
    (torch.bfloat16, 32, {"forward": "simt", "dq": "simt", "dkv": "simt"}),
    (torch.float32, 256, {"forward": "simt", "dq": "simt", "dkv": "simt"}),
    (torch.float16, 80, {"forward": "simt", "dq": "simt", "dkv": "simt"}),
    (torch.float16, 32, {"forward": "simt", "dq": "simt", "dkv": "simt"}),
]
ROUTE_IDS = [f"{str(d).split('.')[-1]}-hd{h}" for d, h, _ in ROUTES]

#: one route function per kernel
ROUTE_FNS = {"forward": attn.flash_fwd_route, "dq": attn.flash_dq_route,
             "dkv": attn.flash_dkv_route}
#: each kernel's sources: route -> (source under csrc/, C entry point)
SOURCES = {
    "forward": attn._FWD_SOURCES,
    **{fn: {route: (name, prefix + fn)
            for route, (name, prefix) in attn._BWD_SOURCES.items()}
       for fn in ("dq", "dkv")}}


@pytest.mark.parametrize("kernel", sorted(ROUTE_FNS))
@pytest.mark.parametrize("dtype,hd,routes", ROUTES, ids=ROUTE_IDS)
def test_kernel_route(kernel, dtype, hd, routes):
    """bf16/f16 at head dims 64 and 128 (the serving and training paths,
    every Llama-family config) and 256 (Gemma) take the tensor-core
    kernels; float32 and every other head dim keep the general kernels."""
    assert ROUTE_FNS[kernel](dtype, hd) == routes[kernel]


@pytest.mark.parametrize("kernel", sorted(ROUTE_FNS))
@pytest.mark.parametrize("dtype,hd,routes", ROUTES, ids=ROUTE_IDS)
def test_every_kernel_route_names_a_source_with_its_entry_point(
        kernel, dtype, hd, routes):
    name, entry = SOURCES[kernel][ROUTE_FNS[kernel](dtype, hd)]
    assert f"int {entry}(" in (_build.CSRC / f"{name}.cu").read_text()


#: (b, nkv, sk, reps, hd, SMs) -> blocks of the sm90 dK/dV kernel that
#: share one GQA group
SPLITS = {
    # Gemma-2B training: 64 blocks of one group of 8 heads on 132 SMs
    "gemma_2b_train": ((2, 1, 2048, 8, 256, 132), 4),
    "gemma_2b_train_b1": ((1, 1, 2048, 8, 256, 132), 8),
    "gemma_2b_s512": ((2, 1, 512, 8, 256, 132), 8),
    # Gemma-7B (MHA): one head per group, nothing to split
    "gemma_7b_mha": ((2, 16, 2048, 1, 256, 132), 1),
    # reps 4 caps the count though the SMs would take more
    "reps_4_cap": ((1, 1, 256, 4, 256, 132), 4),
    "enough_blocks": ((4, 8, 2048, 4, 256, 132), 1),
    # the hd-64/128 kernel never splits
    "llama_hd128": ((1, 1, 256, 8, 128, 132), 1),
}


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_dkv_splits(case):
    args, want = SPLITS[case]
    splits = attn.dkv_splits(*args)
    assert splits == want
    assert args[3] % splits == 0


def test_every_route_names_a_source_with_both_entry_points():
    for route, (name, prefix) in attn._BWD_SOURCES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn in ("dq", "dkv"):
            assert f"int {prefix}{fn}(" in src, (route, fn)
        assert attn.flash_dq.launches_by_route.keys() \
            == attn._BWD_SOURCES.keys()


def test_every_forward_route_names_a_source_with_its_entry_point():
    assert attn._FWD_SOURCES.keys() == {"sm90", "simt"}
    for route, (name, entry) in attn._FWD_SOURCES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f"int {entry}(" in src, route
    assert attn.flash_forward.launches_by_route.keys() \
        == attn._FWD_SOURCES.keys()


def test_cpu_tensors_take_the_plain_forward_and_count_no_launch():
    q = torch.randn(1, 8, 2, 64).bfloat16()
    before = (attn.flash_forward.launches,
              dict(attn.flash_forward.launches_by_route))
    out, lse = attn.flash_forward(q, q, q, True)
    ref, ref_lse = attn.flash_forward_plain(q, q, q, True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert (attn.flash_forward.launches,
            attn.flash_forward.launches_by_route) == before


@pytest.mark.parametrize("dtype,hd", [(torch.float16, 128),
                                      (torch.float32, 64)])
def test_cpu_tensors_take_the_plain_forward_on_either_route(dtype, hd):
    """Whichever route the dtype and head dim name, CPU tensors take the
    plain version, with its window and offsets, and launch nothing."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 24, 4, hd, generator=g).to(dtype)
    k, v = (torch.randn(1, 40, 2, hd, generator=g).to(dtype)
            for _ in range(2))
    kw = dict(offsets=(16, 0), window=12)
    before = dict(attn.flash_forward.launches_by_route)
    out, lse = attn.flash_forward(q, k, v, True, **kw)
    ref, ref_lse = attn.flash_forward_plain(q, k, v, True, **kw)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert attn.flash_forward.launches_by_route == before


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
                                         "flash_bwd_sm90.cu",
                                         "flash_fwd_sm90.cu"}
    before = {s.name: _build._target(s) for s in sources}
    assert before == {s.name: _build._target(_build.CSRC / s.name)
                      for s in sources}
    headers = sorted(csrc.glob("*.cuh"))
    assert {h.name for h in headers} >= {"sm90.cuh", "flash_common.cuh"}
    for header in headers:
        header.write_text(header.read_text() + "\n// edited\n")
        after = {s.name: _build._target(s) for s in sources}
        for name in before:
            assert after[name] != before[name], (header.name, name)
            assert after[name].parent == _build.BUILD_DIR
            assert after[name].name.startswith(f"lib{name[:-3]}-")
        before = after


def test_build_name_covers_the_source(tmp_path):
    """An edited source renames its own library and no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    sources = sorted(csrc.glob("*.cu"))
    for name in ("flash_bwd_sm90.cu", "flash_fwd_sm90.cu"):
        before = {s.name: _build._target(s) for s in sources}
        src = csrc / name
        src.write_text(src.read_text() + "\n// edited\n")
        after = {s.name: _build._target(s) for s in sources}
        assert after[name] != before[name], name
        assert {n: t for n, t in after.items() if n != name} \
            == {n: t for n, t in before.items() if n != name}, name
