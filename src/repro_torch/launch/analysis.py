"""Roofline terms from counted costs (the port of
``repro.launch.analysis``, which reads a compiled artifact; the port's
terms come from ``launch.op_cost`` over an eager step).

Roofline (per chip):
    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bandwidth
    collective = ici_bytes / link bandwidth + dcn_bytes / inter-pod bw

The default profile is the H100 (``core.hardware.H100_SXM``: 989 TFLOP/s
bf16, 3.35 TB/s). Its link bandwidths are 0.0 in the hardware table,
which stays equal to the reference's (the engines' modeled joules are
held to it). The H100's links are kept here instead (``H100_LINKS``) and
priced where a caller passes them (the dry-run does; ``links_for``):

  * within a pod: NVLink 4, 450 GB/s each way a GPU (900 GB/s total;
    NVIDIA H100 SXM data sheet);
  * across pods: one 400 Gb/s InfiniBand NDR port a GPU, 50 GB/s (the
    DGX H100 data sheet: eight ConnectX-7 ports for eight GPUs).

A 16x16 mesh spans 32 eight-GPU NVLink nodes, and its intra-pod traffic
between nodes would cross InfiniBand too: pricing all of it at NVLink's
rate makes ``t_collective`` a lower bound, and each record says so
(``link_assumption``). Where neither the profile nor the caller gives a
link bandwidth, ``t_collective`` is None (no time is invented) and the
collective bytes are still reported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.hardware import H100_SXM, HardwareProfile


@dataclasses.dataclass(frozen=True)
class Links:
    """A chip's link bandwidths, bytes/s each way."""
    name: str
    ici_bw: float          # within a pod
    dci_bw: float          # across pods
    assumption: str


H100_LINKS = Links(
    name="h100_nvlink4_ib_ndr",
    ici_bw=450e9,
    dci_bw=50e9,
    assumption=(
        "H100 SXM: NVLink 4 at 450 GB/s each way a GPU within a pod, one "
        "400 Gb/s InfiniBand NDR port (50 GB/s) a GPU across pods (NVIDIA "
        "H100 SXM and DGX H100 data sheets); a pod of more than 8 GPUs "
        "spans several NVLink nodes, so its ICI time is a lower bound"))

LINKS = {H100_SXM.name: H100_LINKS}


def links_for(profile: HardwareProfile) -> Optional[Links]:
    """The link bandwidths kept here for ``profile`` (None: none kept,
    or the profile has its own)."""
    return None if profile.ici_bw else LINKS.get(profile.name)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float]
    count_by_op: Dict[str, int]
    ici_bytes: float           # per-chip wire bytes within a pod
    dcn_bytes: float           # per-chip wire bytes crossing pods


@dataclasses.dataclass
class Roofline:
    t_compute: float
    t_memory: float
    t_collective: Optional[float]       # None: the profile has no link bw
    flops: float
    hbm_bytes: float
    coll: CollectiveStats
    chips: int
    model_flops: float = 0.0            # 6*N_active*D analytic
    profile: str = H100_SXM.name
    links: Optional[str] = None         # the priced links' assumption

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        terms = {k: v for k, v in terms.items() if v is not None}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "flops": self.flops, "bytes": self.hbm_bytes,
            "coll_ici_bytes": self.coll.ici_bytes,
            "coll_dcn_bytes": self.coll.dcn_bytes,
            "coll_bytes_by_op": dict(self.coll.bytes_by_op),
            "coll_counts": dict(self.coll.count_by_op),
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "profile": self.profile,
            "link_assumption": self.links,
        }


def roofline(flops: float, nbytes: float, coll: CollectiveStats, chips: int,
             profile: HardwareProfile = H100_SXM,
             model_flops: float = 0.0,
             links: Optional[Links] = None) -> Roofline:
    """Three-term roofline of one chip's counted FLOPs, bytes and
    collective bytes; the collectives priced at the profile's link
    bandwidths, else at ``links``'."""
    t_c = flops / profile.peak_flops
    t_m = nbytes / profile.hbm_bw
    t_x, note = None, None
    if profile.ici_bw:
        ici, dci = profile.ici_bw, profile.dci_bw
    elif links is not None:
        ici, dci, note = links.ici_bw, links.dci_bw, links.assumption
    else:
        ici = dci = 0.0
    if ici:
        t_x = coll.ici_bytes / ici
        if coll.dcn_bytes:
            t_x += coll.dcn_bytes / max(dci, 1.0)
    return Roofline(t_compute=t_c, t_memory=t_m, t_collective=t_x,
                    flops=flops, hbm_bytes=nbytes, coll=coll, chips=chips,
                    model_flops=model_flops, profile=profile.name,
                    links=note)


def from_row(row: Dict, chips: int, profile: HardwareProfile = H100_SXM,
             links: Optional[Links] = None) -> Roofline:
    """A record's roofline re-priced on ``profile`` (and ``links``) from
    its counted terms."""
    coll = CollectiveStats(bytes_by_op=dict(row["coll_bytes_by_op"]),
                           count_by_op=dict(row["coll_counts"]),
                           ici_bytes=row["coll_ici_bytes"],
                           dcn_bytes=row["coll_dcn_bytes"])
    return roofline(row["flops"], row["bytes"], coll, chips, profile,
                    row["model_flops"], links)
