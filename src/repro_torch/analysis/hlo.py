"""Collective traffic of a traced step, from its collective records.

The counterpart of the JAX package's ``analysis/hlo.py``, which reads a
compiled per-device HLO module's text.  There is no HLO here: a step runs
eagerly (for the dry run under ``FakeTensorMode`` on a fake process group),
and `CollectiveRecorder`, a ``TorchDispatchMode``, writes one record a
collective as this rank issues it: its kind, its payload bytes and the
global ranks of its group.  It sees DTensor's functional collectives
(``_c10d_functional``: all-gather, reduce-scatter, all-reduce, all-to-all;
and ``_dtensor.shard_dim_alltoall``, a CUDA mesh's shard-to-shard exchange)
on the local shards, beneath DTensor
(a DTensor operation is passed on to DTensor, whose collectives then pass
through the mode), and so also the all-gathers that the sharding module
carries through the eager collective on a gloo group of CUDA tensors
(`repro_torch.distributed.sharding.route_all_gather` registers that as the
functional operator's kernel, beneath the mode).

The payload is the reference's: an all-gather's and a reduce-scatter's
output, the input of the others.  `link_traffic` (the reference's, verbatim)
turns a record into per-device link traffic with the ring algorithm's
factors:

  all-reduce          2 * D * (n-1)/n
  all-gather          D_out * (n-1)/n
  reduce-scatter      D_in  * (n-1)/n  (= D_out * (n-1))
  all-to-all          D * (n-1)/n
  collective-permute  D

`collective_stats` sums the records by kind, and also by the link a group
crosses: a group whose ranks share one `NODE_SIZE`-card node talks over
NVLink, any other over the network (`repro_torch.analysis.roofline` prices
the two).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

from torch.utils._python_dispatch import TorchDispatchMode

#: Cards of one node, joined all to all by NVLink (an HGX H100 board).
NODE_SIZE = 8

#: (namespace, operator) -> the reference's collective kind.  DTensor does
#: a shard-to-shard redistribution as one ``_dtensor.shard_dim_alltoall``
#: on a CUDA mesh.
_KINDS = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
}
#: Kinds whose payload is the output (the others': the input).
_OUTPUT_PAYLOAD = ("all-gather", "reduce-scatter")


class Record(NamedTuple):
    """One collective as a rank issued it."""

    kind: str
    payload: int
    ranks: Tuple[int, ...]


def link_traffic(op: str, payload: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * payload * (n - 1) / n
    if op == "all-gather":
        return payload * (n - 1) / n
    if op == "reduce-scatter":
        return payload * (n - 1)  # payload here is the (scattered) output
    if op == "all-to-all":
        return payload * (n - 1) / n
    if op == "collective-permute":
        return float(payload)
    return float(payload)


def link_of(ranks) -> str:
    """"nvlink" when every rank of a group sits on one node, else "network"."""
    return "nvlink" if len({r // NODE_SIZE for r in ranks}) <= 1 else "network"


def collective_stats(records) -> Dict[str, Dict[str, float]]:
    """Per kind {count, payload_bytes, link_bytes, nvlink_bytes,
    network_bytes} of a step's records (this rank's)."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "payload_bytes": 0.0, "link_bytes": 0.0, "nvlink_bytes": 0.0,
                 "network_bytes": 0.0})
    for rec in records:
        s = stats[rec.kind]
        traffic = link_traffic(rec.kind, rec.payload, len(rec.ranks))
        s["count"] += 1
        s["payload_bytes"] += rec.payload
        s["link_bytes"] += traffic
        s[link_of(rec.ranks) + "_bytes"] += traffic
    return dict(stats)


def total_link_bytes(stats: Dict[str, Dict[str, float]]) -> float:
    return sum(s["link_bytes"] for s in stats.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_ranks(group_name) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = group_name if isinstance(group_name, dist.ProcessGroup) else \
        _resolve_process_group(group_name)
    return tuple(dist.get_process_group_ranks(group))


def collective_record(func, args, out):
    """The `Record` of one collective call (`_KINDS`), or None for another
    operator (``wait_tensor`` included)."""
    kind = _KINDS.get((func.namespace, func._overloadpacket.__name__))
    if kind is None:
        return None
    group = next(a for a in reversed(args) if isinstance(a, str))
    payload = _nbytes(out) if kind in _OUTPUT_PAYLOAD else _nbytes(args[0])
    return Record(kind, payload, _group_ranks(group))


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective this rank issues while the mode is on
    (``records``, in order); see the module docstring.  ``stats()`` sums
    them (`collective_stats`)."""

    def __init__(self):
        super().__init__()
        self.records: List[Record] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.record(func, args, out)
        return out

    def record(self, func, args, out):
        rec = collective_record(func, args, out)
        if rec is not None:
            self.records.append(rec)
        return rec

    def stats(self) -> Dict[str, Dict[str, float]]:
        return collective_stats(self.records)
