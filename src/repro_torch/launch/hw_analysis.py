"""Roofline terms from per-device op-walk counts, with the H100 cluster's
rates.

The port of the JAX package's ``repro/launch/hlo_analysis.py``: the same
formulas (``level_bandwidths``, ``dci_bytes``, ``collective_time_by_level``,
``roofline_terms``), with the rates of an H100 SXM 80GB and its cluster, not
a TPU's. Numerators are per-device counts (``launch/op_cost.py``), so each
term divides by a per-device rate.

The rates are the card's data sheet and the fabric's link rates, each
direction:

* 989e12 dense bf16 FLOP/s (tensor cores, no sparsity);
* 3.35e12 B/s of HBM3, 80 GB of it;
* NVLink 4 inside an 8-GPU node (HGX H100): 450e9 B/s a GPU;
* NDR InfiniBand across nodes: 400 Gb/s = 50e9 B/s a GPU (one NIC a GPU).

The fabric's levels, innermost first, are the cluster's: ``("nvlink", 8)``
GPUs of a node, ``("ib", 32)`` nodes of a 256-GPU pod (one DGX SuperPOD
scalable unit) and, on the two-pod mesh, ``("pod", 2)``. Across pods the
traffic rides the same NDR fabric, so ``pod`` is charged the InfiniBand
rate: no data sheet gives a slower figure for it. The mesh keeps JAX's axes
and sizes (model innermost), so the 16-way model axis spans two nodes and
pays InfiniBand for the link between them.

A cell's ``hw`` record carries these rates; where they are printed, the
card's name and power limit from ``nvidia-smi`` stand beside them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

PEAK_FLOPS = 989e12          # bf16 FLOP/s a GPU (dense)
HBM_BW = 3.35e12             # bytes/s a GPU
HBM_BYTES = 80e9             # a GPU's memory
NVLINK_BW = 450e9            # bytes/s a GPU each way, inside a node
IB_BW = 50e9                 # bytes/s a GPU, NDR across nodes
DCI_BW = IB_BW               # the scarcest link class: between pods

LEVEL_BW = {"nvlink": NVLINK_BW, "ib": IB_BW, "pod": DCI_BW}
GPUS_PER_NODE = 8
NODES_PER_POD = 32


@dataclasses.dataclass(frozen=True)
class Rates:
    """A machine's rates: the roofline's denominators. ``link_bw`` is the
    innermost link's (JAX's ICI), ``top_bw`` the scarcest (JAX's DCI)."""

    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW
    top_bw: float = DCI_BW
    level_bw: tuple = tuple(LEVEL_BW.items())

    def as_dict(self) -> dict:
        return {"peak_flops": self.peak_flops, "hbm_bw": self.hbm_bw,
                "link_bw": self.link_bw, "top_bw": self.top_bw,
                "level_bw": dict(self.level_bw), "hbm_bytes": HBM_BYTES}


H100 = Rates()


def mesh_levels(mesh_shape: dict) -> tuple[tuple, tuple]:
    """(level sizes, level names) of the cluster under a mesh of
    ``mesh_shape`` (axis -> size, model innermost): GPUs of a node, nodes
    of a pod, pods."""
    n = 1
    for v in mesh_shape.values():
        n *= v
    pods = mesh_shape.get("pod", 1)
    per_pod = n // pods
    node = min(GPUS_PER_NODE, per_pod)
    sizes, names = [node], ["nvlink"]
    if per_pod > node:
        sizes.append(per_pod // node)
        names.append("ib")
    if pods > 1:
        sizes.append(pods)
        names.append("pod")
    return tuple(sizes), tuple(names)


def level_bandwidths(n_levels: int, names: Optional[Sequence[str]] = None,
                     rates: Rates = H100) -> list[float]:
    """Per-level rates for an ``n_levels``-deep hierarchy, innermost first.

    Known names resolve through the rates' levels; anonymous levels fall
    off geometrically from the innermost link (factor 2 per level), floored
    at the top rate, with the top level always charged at the top rate —
    the scarcest link class.
    """
    known = dict(rates.level_bw)
    out = []
    for i in range(n_levels):
        name = names[i] if names is not None and i < len(names) else None
        if name in known:
            out.append(known[name])
        elif i == n_levels - 1 and n_levels > 1:
            out.append(rates.top_bw)
        else:
            out.append(max(rates.link_bw / (2 ** i), rates.top_bw))
    return out


def dci_bytes(wire_bytes_by_level: Sequence[float],
              names: Optional[Sequence[str]] = None,
              rates: Rates = H100) -> float:
    """The scarcest link class's share of a per-level byte vector: levels
    whose resolved rate is at or below the top rate."""
    bws = level_bandwidths(len(wire_bytes_by_level), names, rates)
    return sum(b for b, bw in zip(wire_bytes_by_level, bws)
               if bw <= rates.top_bw)


def collective_time_by_level(wire_bytes_by_level: Sequence[float],
                             bws: Optional[Sequence[float]] = None,
                             names: Optional[Sequence[str]] = None,
                             rates: Rates = H100) -> dict:
    """Charge a per-device per-level byte vector at per-level rates.

    Returns ``{"collective_s", "by_level_s"}`` — the total is a sum, not a
    max: the levels of one merge are sequential stages.
    """
    if bws is None:
        bws = level_bandwidths(len(wire_bytes_by_level), names, rates)
    by_level = [b / bw for b, bw in zip(wire_bytes_by_level, bws)]
    return {"collective_s": sum(by_level), "by_level_s": by_level}


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   wire_bytes_per_device: float,
                   wire_bytes_inter_per_device: float = 0.0,
                   wire_bytes_by_level: Optional[Sequence[float]] = None,
                   level_names: Optional[Sequence[str]] = None,
                   rates: Rates = H100) -> dict:
    """Three-term roofline.

    With ``wire_bytes_by_level`` (per-device, innermost first) the
    collective term charges each hierarchy level at its own rate
    (:func:`level_bandwidths`). Otherwise ``wire_bytes_inter_per_device``
    (a subset of ``wire_bytes_per_device``) is charged at the top rate and
    the rest at the innermost link's — the two-level split.
    """
    if wire_bytes_by_level is not None:
        lv = collective_time_by_level(wire_bytes_by_level, names=level_names,
                                      rates=rates)
        collective_s = lv["collective_s"]
    else:
        wire_intra = max(0.0,
                         wire_bytes_per_device - wire_bytes_inter_per_device)
        collective_s = (wire_intra / rates.link_bw
                        + wire_bytes_inter_per_device / rates.top_bw)
    terms = {
        "compute_s": flops_per_device / rates.peak_flops,
        "memory_s": hbm_bytes_per_device / rates.hbm_bw,
        "collective_s": collective_s,
    }
    dom = max(terms, key=terms.get)
    bound = terms[dom]
    frac = terms["compute_s"] / max(bound, 1e-30)
    out = {**terms, "dominant": dom.replace("_s", ""), "bound_s": bound,
           "compute_fraction_of_bound": frac}
    if wire_bytes_by_level is not None:
        out["collective_by_level_s"] = lv["by_level_s"]
    return out
