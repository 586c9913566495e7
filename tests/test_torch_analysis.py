"""The port's dry-run analysis (`repro_torch.analysis`) against the JAX package's.

* ``hlo.link_traffic`` is the reference's, bitwise, over a grid of
  (kind, payload, group size);
* ``hlo.collective_stats`` of records sums them by kind and by link (a
  group inside one 8-card node is NVLink, across nodes the network);
* ``roofline.model_flops`` equals the reference's for every cell;
* ``roofline.analyze_cell`` given the reference's constants (its peak,
  HBM and link rates) is bitwise the reference's ``CellRoofline`` on the
  same dry-run JSON, for every cell of a synthetic sweep in the
  reference's schema; with the H100's defaults its terms are the
  datasheet rates' quotients (a JSON with the link split prices NVLink and
  network bytes apart).
"""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.analysis import hlo as ref_hlo
from repro.analysis import roofline as ref_roofline
from repro_torch.analysis import hlo, roofline
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
         "broadcast")
PAYLOADS = (0, 1, 7, 4096, 123456789, 2**40 + 3)
GROUPS = (0, 1, 2, 3, 8, 16, 256, 512)


def test_link_traffic_bitwise_reference():
    for kind, payload, n in itertools.product(KINDS, PAYLOADS, GROUPS):
        got, want = hlo.link_traffic(kind, payload, n), ref_hlo.link_traffic(kind, payload, n)
        assert type(got) is type(want) and got == want, (kind, payload, n, got, want)


def test_collective_stats_by_kind_and_link():
    node = tuple(range(8))              # one node: NVLink
    across = tuple(range(0, 256, 16))   # a 16 x 16 mesh's data axis: 16 nodes
    split = tuple(range(16))            # its model axis: two nodes
    recs = [hlo.Record("all-gather", 1000, node), hlo.Record("all-gather", 3000, across),
            hlo.Record("reduce-scatter", 10, split), hlo.Record("all-reduce", 64, (5,))]
    stats = hlo.collective_stats(recs)
    ag = stats["all-gather"]
    assert ag["count"] == 2 and ag["payload_bytes"] == 4000
    assert ag["nvlink_bytes"] == 1000 * 7 / 8 and ag["network_bytes"] == 3000 * 15 / 16
    assert ag["link_bytes"] == ag["nvlink_bytes"] + ag["network_bytes"]
    assert stats["reduce-scatter"]["network_bytes"] == 10 * 15
    assert stats["all-reduce"]["link_bytes"] == 0.0     # a group of one moves nothing
    assert hlo.total_link_bytes(stats) == sum(s["link_bytes"] for s in stats.values())
    assert [hlo.link_of(g) for g in (node, across, split, (8, 15))] == [
        "nvlink", "network", "network", "nvlink"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape.name) == ref_roofline.model_flops(arch, shape.name)


def synthetic_cells():
    """A sweep in the reference's schema, numbers from a seed: every cell,
    one skipped, one without scaled_cost."""
    rng = np.random.default_rng(30)
    out = []
    for arch, shape in itertools.product(ARCH_IDS, SHAPES):
        data = {"arch": arch, "shape": shape.name, "mesh": "single"}
        if shape.name == "long_500k" and arch == "qwen2-1.5b":
            data["skipped"] = "full-attention arch"
        elif not (arch == "gemma-2b" and shape.name == "train_4k"):
            flops, nbytes, coll = (float(x) for x in rng.uniform(1e9, 1e16, 3))
            if shape.kind == "decode":
                nbytes = float(rng.uniform(1.0, 1e6))   # the analytic floor binds
            data["scaled_cost"] = {"flops": flops, "bytes": nbytes, "coll": coll}
        out.append(data)
    return out


def test_analyze_cell_bitwise_reference_with_its_constants():
    rates = dict(peak_flops=ref_roofline.PEAK_FLOPS, hbm_bw=ref_roofline.HBM_BW,
                 link_bw=ref_roofline.ICI_BW)
    seen = set()
    for data in synthetic_cells():
        got, want = roofline.analyze_cell(data, **rates), ref_roofline.analyze_cell(data)
        if want is None:
            assert got is None
            continue
        assert dataclasses.asdict(got) == dataclasses.asdict(want), data
        seen.add(want.dominant)
        seen.add(want.note)
    assert {"skipped", "memory=analytic-floor"} <= seen


def test_h100_defaults_and_links():
    data = {"arch": "qwen2-1.5b", "shape": "train_4k", "mesh": "single",
            "mesh_shape": {"data": 16, "model": 16},
            "scaled_cost": {"flops": 9.89e14, "bytes": 3.35e13, "coll": 5.0e11,
                            "coll_nvlink": 4.5e11, "coll_network": 5.0e10}}
    c = roofline.analyze_cell(data)
    assert c.compute_s == 9.89e14 / roofline.BF16_TC_OPS_PER_S
    assert c.collective_s == 4.5e11 / roofline.NVLINK_BYTES_PER_S + 5.0e10 / 50e9
    assert c.hlo_flops_global == 9.89e14 * 256
    multi = dict(data, mesh="multi", mesh_shape={"pod": 2, "data": 16, "model": 16})
    m = roofline.analyze_cell(multi)
    assert m.hlo_flops_global == 9.89e14 * 512
    assert roofline.mesh_of({"mesh": "multi"}) == {"pod": 2, "data": 16, "model": 16}
    del data["scaled_cost"]["coll_nvlink"], data["scaled_cost"]["coll_network"]
    assert roofline.analyze_cell(data).collective_s == 5.0e11 / roofline.NETWORK_BYTES_PER_S


def test_score_tensor_adjustment_only_for_reference_json():
    """The reference's JSON loses its dense score tensors' bytes; the port's
    (one with ``mesh_shape``) ran the flash operators and keeps its bytes."""
    port = {"arch": "qwen2-1.5b", "shape": "train_4k", "mesh": "single",
            "mesh_shape": {"data": 16, "model": 16},
            "scaled_cost": {"flops": 1e12, "bytes": 3.35e13, "coll": 1e9}}
    ref = {k: v for k, v in port.items() if k != "mesh_shape"}
    adj = roofline._attention_bytes_adjustment("qwen2-1.5b", "train_4k", 16)
    assert adj > 0
    assert roofline.analyze_cell(port).memory_s == 3.35e13 / roofline.HBM_BYTES_PER_S
    assert roofline.analyze_cell(ref).memory_s == (3.35e13 - adj) / roofline.HBM_BYTES_PER_S


def test_sweep_table(tmp_path):
    """One row an arch, a cell a shape: the 16 x 16 step, term, peak share
    and peak bytes, then the 2 x 16 x 16 step; "*" where a trace holds
    all-to-alls; a shape that was not traced says so."""
    import json

    def cell(mesh, sizes, coll, kinds):
        data = {"arch": "qwen2-1.5b", "shape": "train_4k", "mesh": mesh, "mesh_shape": sizes,
                "production": {"memory": {"peak_bytes": 3 * 2**30},
                               "collectives": {k: {} for k in kinds}},
                "scaled_cost": {"flops": 1e12, "bytes": 1e9, "coll": coll}}
        (tmp_path / f"qwen2-1.5b__train_4k__{mesh}.json").write_text(json.dumps(data))
        return roofline.analyze_cell(data)

    one = cell("single", {"data": 16, "model": 16}, 1e12, ["all-gather", "all-to-all"])
    many = cell("multi", {"pod": 2, "data": 16, "model": 16}, 1e11, ["all-gather"])
    skipped = {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "single", "skipped": "x"}
    (tmp_path / "qwen2-1.5b__long_500k__single.json").write_text(json.dumps(skipped))
    lines = roofline.sweep_table(str(tmp_path)).splitlines()
    assert lines[0] == "| arch | train_4k | prefill_32k | decode_32k | long_500k |"
    assert len(lines) == 3
    assert lines[2] == (
        f"| qwen2-1.5b | {one.step_s:.3g} coll*, {100 * one.peak_fraction:.2g} %, 3 GiB; "
        f"{many.step_s:.3g} coll | not traced | not traced | skipped |")
