"""TPU generation/topology tables and slice math.

This layer has no reference analog — KubeDL assumes GPU node pools and
nodeSelector-free placement (``nvidia.com/gpu`` in
``pkg/job_controller/api/v1/constants.go:46``). Here placement *is* the
product: a training job maps to one or more TPU **slices**; each slice is a
set of hosts wired by ICI; each host runs exactly one worker pod that sees
``chips_per_host`` chips. All-or-nothing slice placement and stable worker
IDs in physical topology order are what make XLA collectives work, so the
tables below are load-bearing (wrong host counts = CI passes, slice fails).

Sources for the shapes: Cloud TPU public docs (v4/v5e/v5p/v6e system
architecture) and GKE TPU docs (machine shapes ct5lp-hightpu-4t/8t etc.).

Copied from ``kubedl_tpu/tpu/topology.py`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TPUGeneration:
    name: str                 # e.g. "v5p"
    gke_accelerator: str      # value for cloud.google.com/gke-tpu-accelerator
    chips_per_host: int       # chips seen by one worker pod (one TPU VM host)
    cores_per_chip: int       # 2 TensorCores/chip on v4/v5p; 1 on v5e/v6e
    ndims: int                # 3D torus (v4/v5p) or 2D (v5e/v6e)
    max_chips: int
    suffix_unit: str          # "cores" (v4/v5p: v5p-32 = 32 cores) or "chips"
    #: chips sharing one contiguous ICI fabric block. The v4/v5p pods are
    #: composed of 4x4x4 cubes behind optical circuit switches, so two
    #: slices land on the same all-ICI path only inside one cube; the 2D
    #: generations wire the whole pod as one fabric. 0 = whole pod.
    ici_domain_chips: int = 0


GENERATIONS: dict[str, TPUGeneration] = {
    "v2":  TPUGeneration("v2", "tpu-v2-podslice", 4, 2, 2, 512, "cores"),
    "v3":  TPUGeneration("v3", "tpu-v3-podslice", 4, 2, 2, 2048, "cores"),
    "v4":  TPUGeneration("v4", "tpu-v4-podslice", 4, 2, 3, 4096, "cores", 64),
    "v5p": TPUGeneration("v5p", "tpu-v5p-slice", 4, 2, 3, 8960, "cores", 64),
    "v5e": TPUGeneration("v5e", "tpu-v5-lite-podslice", 4, 1, 2, 256, "chips"),
    "v6e": TPUGeneration("v6e", "tpu-v6e-slice", 4, 1, 2, 256, "chips"),
}

# v5e/v6e machine shapes: single-host VMs pack 1/4/8 chips
# (ct5lp-hightpu-1t/4t/8t); multi-host slices use 4-chip hosts. Default is
# the largest host that fits; pass ``host_chips`` to force e.g. the 2-host
# ct5lp-hightpu-4t variant of a 2x4 slice.
_SINGLE_HOST_GENS = ("v5e", "v6e")
_SINGLE_HOST_MAX_CHIPS_2D = 8
_VALID_HOST_CHIPS_2D = (1, 4, 8)

# Canonical topology for a chip count (public docs). Anything not listed is
# solved as the most-cubic factorization.
_CANONICAL_3D = {
    4: (2, 2, 1), 8: (2, 2, 2), 16: (2, 2, 4), 32: (2, 4, 4), 64: (4, 4, 4),
    128: (4, 4, 8), 256: (4, 8, 8), 512: (8, 8, 8), 1024: (8, 8, 16),
    2048: (8, 16, 16), 4096: (16, 16, 16), 6144: (16, 16, 24),
    8960: (16, 20, 28),
}
_CANONICAL_2D = {
    1: (1, 1), 4: (2, 2), 8: (2, 4), 16: (4, 4), 32: (4, 8), 64: (8, 8),
    128: (8, 16), 256: (16, 16),
}


def _solve_topology(chips: int, ndims: int) -> tuple:
    table = _CANONICAL_3D if ndims == 3 else _CANONICAL_2D
    if chips in table:
        return table[chips]
    # most-cubic factorization, powers-of-two biased
    best = None
    def factorize(n, dims):
        nonlocal best
        if dims == 1:
            shape = tuple(sorted(cur + [n]))
            spread = max(shape) / max(min(shape), 1)
            if best is None or spread < best[0]:
                best = (spread, shape)
            return
        for f in range(1, int(math.isqrt(n)) + 1):
            if n % f == 0:
                cur.append(f)
                factorize(n // f, dims - 1)
                cur.pop()
    cur: list = []
    factorize(chips, ndims)
    return best[1] if best else (chips,) * 1 + (1,) * (ndims - 1)


@dataclass(frozen=True)
class SliceSpec:
    """A fully-resolved TPU slice shape."""
    generation: TPUGeneration
    chips: int
    topology: tuple          # chip grid, e.g. (2, 2, 4)
    num_hosts: int
    chips_per_host: int

    @property
    def accelerator_type(self) -> str:
        """Cloud naming: v5p-32 (cores) / v5e-16 (chips)."""
        n = self.chips * (2 if self.generation.suffix_unit == "cores" else 1)
        return f"{self.generation.name}-{n}"

    @property
    def topology_str(self) -> str:
        return "x".join(str(d) for d in self.topology)

    @property
    def gke_accelerator(self) -> str:
        return self.generation.gke_accelerator


_ACCEL_RE = re.compile(r"^(v\d+[a-z]*)-(\d+)$")


def parse_accelerator(accelerator_type: str) -> SliceSpec:
    """``"v5p-32"`` → SliceSpec(v5p, 16 chips, (2,2,4), 4 hosts, 4 chips/host).

    The suffix counts TensorCores on v4/v5p and chips on v5e/v6e, matching
    Cloud TPU naming.
    """
    mt = _ACCEL_RE.match(accelerator_type.strip())
    if not mt:
        raise ValueError(f"unrecognized TPU accelerator type: {accelerator_type!r}")
    gen_name, n = mt.group(1), int(mt.group(2))
    gen = GENERATIONS.get(gen_name)
    if gen is None:
        raise ValueError(f"unknown TPU generation {gen_name!r} (know {sorted(GENERATIONS)})")
    chips = n // gen.cores_per_chip if gen.suffix_unit == "cores" else n
    if chips < 1 or (gen.suffix_unit == "cores" and n % gen.cores_per_chip):
        raise ValueError(f"invalid size {n} for {gen_name}")
    if chips > gen.max_chips:
        raise ValueError(f"{accelerator_type}: {chips} chips exceeds {gen_name} max {gen.max_chips}")
    return from_chips(gen_name, chips)


def from_chips(gen_name: str, chips: int, topology: Optional[str] = None,
               host_chips: Optional[int] = None) -> SliceSpec:
    gen = GENERATIONS[gen_name]
    if not 1 <= chips <= gen.max_chips:
        raise ValueError(f"{gen_name}: {chips} chips out of range [1, {gen.max_chips}]")
    if topology:
        topo = tuple(int(x) for x in topology.lower().split("x"))
        if math.prod(topo) != chips:
            raise ValueError(f"topology {topology} has {math.prod(topo)} chips, want {chips}")
    else:
        topo = _solve_topology(chips, gen.ndims)
    if host_chips is not None:
        if gen.name in _SINGLE_HOST_GENS:
            if host_chips not in _VALID_HOST_CHIPS_2D:
                raise ValueError(
                    f"{gen_name}: host_chips must be one of {_VALID_HOST_CHIPS_2D}")
        elif host_chips != gen.chips_per_host:
            raise ValueError(f"{gen_name}: hosts have exactly {gen.chips_per_host} chips")
        cph = host_chips
    elif gen.name in _SINGLE_HOST_GENS and chips <= _SINGLE_HOST_MAX_CHIPS_2D:
        cph = chips  # largest single-host machine shape that fits
    else:
        cph = gen.chips_per_host
    if chips % cph:
        raise ValueError(f"{gen_name}: {chips} chips not divisible by {cph} chips/host")
    return SliceSpec(generation=gen, chips=chips, topology=topo,
                     num_hosts=chips // cph, chips_per_host=cph)


def parse_topology(gen_name: str, topology: str) -> SliceSpec:
    """``("v5p", "2x2x4")`` → SliceSpec; the GKE-native entry point."""
    topo = tuple(int(x) for x in topology.lower().split("x"))
    return from_chips(gen_name, math.prod(topo), topology)


# ---------------------------------------------------------------------------
# ICI-domain math (docs/scheduling.md "Placement scoring"): the scheduler's
# contention model. A pool's slices are grouped into ICI domains; a
# multi-slice gang packed inside one domain rides all-ICI collectives, a
# gang straddling domains pays the cross-domain (OCS / DCN) hop.
# ---------------------------------------------------------------------------


def ici_domain_chips(gen: TPUGeneration) -> int:
    """Chips sharing one contiguous ICI fabric block (whole pod when the
    generation declares no sub-pod granularity)."""
    return gen.ici_domain_chips or gen.max_chips


def slices_per_ici_domain(gen_name: str, topology: str) -> int:
    """How many slices of this shape one ICI domain holds (>= 1: a slice
    larger than the domain granularity spans domains by construction and
    still counts as occupying one)."""
    spec = parse_topology(gen_name, topology)
    return max(ici_domain_chips(spec.generation) // spec.chips, 1)


_BY_GKE_ACCELERATOR = {g.gke_accelerator: g for g in GENERATIONS.values()}


def pool_generation(pool: str) -> Optional[TPUGeneration]:
    """The generation behind an inventory pool key
    (``gke-accelerator/topology``); the ONE accel→generation lookup the
    scorer, the inventory, and the console all resolve pools through."""
    return _BY_GKE_ACCELERATOR.get(pool.partition("/")[0])


def pool_slice_chips(pool: str) -> Optional[int]:
    """Chips in one slice of an inventory pool key, or None when the
    shape is unknown (the placement scorer then prices the slice as one
    chip rather than refusing to score)."""
    gen = pool_generation(pool)
    topo = pool.partition("/")[2]
    if gen is None or not topo:
        return None
    try:
        return parse_topology(gen.name, topo).chips
    except (ValueError, KeyError):
        return None


def pool_ici_slices(pool: str) -> Optional[int]:
    """Slices per ICI domain for an inventory pool key; None when the
    shape is unknown — the caller then skips domain accounting for that
    pool."""
    gen = pool_generation(pool)
    topo = pool.partition("/")[2]
    if gen is None or not topo:
        return None
    try:
        return slices_per_ici_domain(gen.name, topo)
    except (ValueError, KeyError):
        return None


#: generations whose slices a gang can move between without changing its
#: gang shape (same chips/host, same torus dimensionality — the worker
#: count and the collective topology survive the move)
_COMPATIBLE_GENERATIONS = {
    "v4": ("v4", "v5p"), "v5p": ("v5p", "v4"),
    "v5e": ("v5e", "v6e"), "v6e": ("v6e", "v5e"),
}


def compatible_pools(spec: SliceSpec) -> list:
    """Every inventory pool key that can host this slice shape: the
    spec's own pool first, then same-chip-count pools of compatible
    generations. Pure shape math — the scheduler intersects the result
    with pools it actually has capacity records for."""
    own = f"{spec.gke_accelerator}/{spec.topology_str}"
    out = [own]
    for gname in _COMPATIBLE_GENERATIONS.get(spec.generation.name, ()):
        if gname == spec.generation.name:
            continue
        try:
            alt = from_chips(gname, spec.chips,
                             host_chips=spec.chips_per_host
                             if gname in _SINGLE_HOST_GENS else None)
        except (ValueError, KeyError):
            continue
        if alt.num_hosts != spec.num_hosts:
            continue  # different worker count = a different gang shape
        key = f"{alt.gke_accelerator}/{alt.topology_str}"
        if key not in out:
            out.append(key)
    return out


def catalog() -> list:
    """Canonical slice choices per generation — the ONE enumeration of
    valid (acceleratorType, topology) pairs, consumed by the console's
    ``/api/v1/tpu/topologies`` pickers. Kept here so refactors of the
    canonical tables cannot desync the UI from ``from_chips``."""
    out = []
    for gname in sorted(GENERATIONS):
        gen = GENERATIONS[gname]
        canon = _CANONICAL_3D if gen.ndims == 3 else _CANONICAL_2D
        choices = []
        for chips in sorted(canon):
            if chips > gen.max_chips:
                continue
            try:
                spec = from_chips(gname, chips)
            except ValueError:
                continue
            choices.append({"acceleratorType": spec.accelerator_type,
                            "topology": spec.topology_str,
                            "chips": spec.chips,
                            "hosts": spec.num_hosts})
        out.append({"generation": gname,
                    "gkeAccelerator": gen.gke_accelerator,
                    "choices": choices})
    return out
