"""Roofline analysis from dry-run artifacts, against one NVIDIA H100.

The counterpart of the JAX package's ``analysis/roofline.py`` (TPU v5e
targets).  Per (arch x shape) cell, three terms in seconds a step, per
device (the program is SPMD: one rank's seconds are the step's):

  compute    = FLOPs_dev / peak_flops
  memory     = bytes_dev_adjusted / hbm_bw
  collective = each link's traffic_dev / that link's rate

FLOPs, bytes and collective traffic are the dry run's
(`repro_torch.launch.dryrun`: the probes scaled to full depth, equal to the
full trace).  Every term is a prediction computed from the H100's datasheet
rates below, not a measurement.  A collective's group talks over NVLink when
its ranks share an 8-card node, else over the network (`analysis.hlo`); a
reference dry run's JSON, which has one total, is priced at ``link_bw``.

The memory adjustment, the analytic floor, ``MODEL_FLOPS`` and the table
are the reference's, with its constants as arguments whose defaults are
the H100's, and the chip count and data-axis size taken from the mesh the
cell records (the reference's 256 chips and 16-way data axis for a JSON
without one).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
from typing import Dict, List, Optional

from repro_torch.configs.base import SHAPE_BY_NAME, SHAPES
from repro_torch.configs.registry import get_config

#: NVIDIA H100 SXM5 datasheet (dense rates, no sparsity, at the 700 W limit).
BF16_TC_OPS_PER_S = 989e12       # bf16 tensor cores
TF32_TC_OPS_PER_S = 495e12       # TF32 tensor cores
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12        # HBM3
#: NVLink 4 (NVIDIA H100 datasheet: 900 GB/s a card, both directions together).
NVLINK_BYTES_PER_S = 450e9
#: One 400 Gb/s InfiniBand NDR port a card (ConnectX-7 datasheet).
NETWORK_BYTES_PER_S = 50e9
#: The reference's production mesh when a JSON records none.
_MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


@dataclasses.dataclass
class CellRoofline:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    memory_raw_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    step_s: float            # max of the three terms (no-overlap bound)
    peak_fraction: float     # model_flops / (step_s * chips * PEAK)
    note: str = ""


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence per step
    return 2.0 * n_active * shape.global_batch


def _attention_bytes_adjustment(arch: str, shape_name: str, data_size: int = 16) -> float:
    """Score-tensor HBM traffic the dense-attention probes add vs flash.

    4 passes (write scores, read+write softmax, read for PV) x fp32 over
    (B, Hq, S_q, S_k) per attention instance, per device, fwd; x3 with
    backward for train.  Exact given config shapes; returns bytes to
    subtract from the probe's per-device 'bytes accessed'.  Applied only to
    a reference JSON: the port's trace runs the flash kernels' operators,
    which make no score tensor.
    """
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    if shape.kind == "decode":
        return 0.0  # decode probes never materialize S x S
    s = shape.seq_len
    b_dev = max(shape.global_batch // data_size, 1)
    # 2 effective HBM passes over the score tensor forward (QK^T output +
    # softmax read/write fuse on CPU-XLA into ~2 round trips), x3 with the
    # rematted backward.
    passes = 2.0 * (3.0 if shape.kind == "train" else 1.0)

    def attn_traffic(n_inst: int, s_q: int, s_k: int, heads: int) -> float:
        return passes * 4.0 * b_dev * heads * s_q * s_k * n_inst

    fam = cfg.family
    h = cfg.n_heads
    if fam in ("dense", "moe"):
        return attn_traffic(cfg.n_layers, s, s, h)
    if fam == "vlm":
        cross = attn_traffic(cfg.n_layers // cfg.cross_attn_period, s,
                             cfg.n_image_tokens, h)
        return attn_traffic(cfg.n_layers, s, s, h) + cross
    if fam == "encdec":
        enc = attn_traffic(cfg.n_encoder_layers, cfg.encoder_seq, cfg.encoder_seq, h)
        dec = attn_traffic(cfg.n_layers, s, s, h)
        cross = attn_traffic(cfg.n_layers, s, cfg.encoder_seq, h)
        return enc + dec + cross
    if fam == "hybrid":
        groups = cfg.n_layers // cfg.shared_attn_period
        return attn_traffic(groups, s, s, h)
    return 0.0  # ssm: no attention


def mesh_of(data: Dict) -> Dict[str, int]:
    """The cell's mesh {axis: size}: recorded by the port's dry run, else
    the reference's production mesh of its ``mesh`` kind."""
    return data.get("mesh_shape") or _MESHES[data.get("mesh", "single")]


def analyze_cell(data: Dict, peak_flops: float = BF16_TC_OPS_PER_S,
                 hbm_bw: float = HBM_BYTES_PER_S, link_bw: Optional[float] = None,
                 nvlink_bw: float = NVLINK_BYTES_PER_S,
                 network_bw: float = NETWORK_BYTES_PER_S) -> Optional[CellRoofline]:
    """The cell's roofline.  ``link_bw`` prices every link byte at one rate
    (the reference's model); None prices NVLink and network bytes apart
    (a JSON without the split: all at ``network_bw``)."""
    arch, shape = data["arch"], data["shape"]
    if "skipped" in data:
        return CellRoofline(
            arch, shape, 0, 0, 0, 0, "skipped", 0, 0, 0, 0, 0,
            note=data["skipped"],
        )
    if "scaled_cost" not in data:
        return None
    sizes = mesh_of(data)
    n_chips = math.prod(sizes.values())
    data_size = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    sc = data["scaled_cost"]
    flops_dev = sc["flops"]
    bytes_dev_raw = sc["bytes"]
    coll_dev = sc["coll"]

    # The reference's probes make dense score tensors, which its JSON's
    # bytes include; the port's trace (a JSON with ``mesh_shape``) runs the
    # flash operators and has none to take away.
    adj = 0.0 if "mesh_shape" in data else _attention_bytes_adjustment(
        arch, shape, data_size)
    # Analytic floor: sharded params streamed once per use (+grad/opt traffic
    # for train) plus one activation round-trip per layer — the memory term
    # can never fall below genuine weight/activation streaming.
    cfg = get_config(arch)
    shp = SHAPE_BY_NAME[shape]
    params_dev = cfg.param_count() * 4.0 / n_chips
    uses = 3.0 if shp.kind == "train" else 1.0      # fwd + bwd(remat) reads
    opt_traffic = 3.0 * params_dev * (2.0 if shp.kind == "train" else 0.0)
    tokens_dev = (shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
                  / float(data_size))
    act_traffic = 2.0 * tokens_dev * cfg.d_model * 2.0 * max(cfg.n_layers, 1) * uses
    floor = uses * params_dev + opt_traffic + act_traffic
    bytes_dev = max(bytes_dev_raw - adj, floor)
    clamped = bytes_dev_raw - adj < floor

    compute_s = flops_dev / peak_flops
    memory_s = bytes_dev / hbm_bw
    memory_raw_s = bytes_dev_raw / hbm_bw
    if link_bw is not None:
        collective_s = coll_dev / link_bw
    elif "coll_nvlink" in sc:
        collective_s = sc["coll_nvlink"] / nvlink_bw + sc["coll_network"] / network_bw
    else:
        collective_s = coll_dev / network_bw

    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())

    mf = model_flops(arch, shape)
    hlo_global = flops_dev * n_chips
    useful = mf / hlo_global if hlo_global else 0.0
    peak_frac = mf / (step_s * n_chips * peak_flops) if step_s else 0.0

    return CellRoofline(
        arch=arch, shape=shape,
        compute_s=compute_s, memory_s=memory_s, memory_raw_s=memory_raw_s,
        collective_s=collective_s, dominant=dominant,
        model_flops=mf, hlo_flops_global=hlo_global, useful_ratio=useful,
        step_s=step_s, peak_fraction=peak_frac,
        note="memory=analytic-floor" if clamped else "",
    )


def analyze_all(dryrun_dir: str = "experiments/dryrun_torch", mesh: str = "single",
                **rates) -> List[CellRoofline]:
    out = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, f"*__{mesh}.json"))):
        with open(path) as f:
            data = json.load(f)
        if "error" in data:
            continue
        cell = analyze_cell(data, **rates)
        if cell:
            out.append(cell)
    return out


def format_table(cells: List[CellRoofline]) -> str:
    hdr = (
        f"{'arch':22s} {'shape':12s} {'compute':>9s} {'memory':>9s} "
        f"{'collect':>9s} {'dominant':>10s} {'useful':>7s} {'peak%':>6s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for c in cells:
        if c.dominant == "skipped":
            lines.append(f"{c.arch:22s} {c.shape:12s} {'—':>9s} {'—':>9s} {'—':>9s} "
                         f"{'skip':>10s} {'—':>7s} {'—':>6s}")
            continue
        lines.append(
            f"{c.arch:22s} {c.shape:12s} {c.compute_s:9.4f} {c.memory_s:9.4f} "
            f"{c.collective_s:9.4f} {c.dominant:>10s} {c.useful_ratio:7.3f} "
            f"{100*c.peak_fraction:6.2f}"
        )
    return "\n".join(lines)


def sweep_table(dryrun_dir: str = "experiments/dryrun_torch") -> str:
    """The sweep as one markdown table, arch by shape: the 16 x 16 step s,
    its bounding term, model FLOPs over peak and the per-device peak bytes;
    after ";" the 2 x 16 x 16 step s and term.  A "*" marks a mesh whose
    trace holds all-to-alls (shard-to-shard redistributions)."""
    abbrev = {"compute": "comp", "memory": "mem", "collective": "coll"}
    cells, peaks, exchanges = {}, {}, set()
    for mesh in ("single", "multi"):
        for c in analyze_all(dryrun_dir, mesh):
            cells[c.arch, c.shape, mesh] = c
        for path in glob.glob(os.path.join(dryrun_dir, f"*__{mesh}.json")):
            with open(path) as f:
                data = json.load(f)
            if "production" in data:
                key = data["arch"], data["shape"], mesh
                peaks[key] = data["production"]["memory"]["peak_bytes"]
                if "all-to-all" in data["production"]["collectives"]:
                    exchanges.add(key)
    archs = sorted({a for a, _, _ in cells})
    shapes = [s.name for s in SHAPES]
    lines = ["| arch | " + " | ".join(shapes) + " |",
             "| --- |" + " --- |" * len(shapes)]
    for a in archs:
        row = []
        for s in shapes:
            one, many = cells.get((a, s, "single")), cells.get((a, s, "multi"))
            if one is None or one.dominant == "skipped":
                row.append("skipped" if one else "not traced")
                continue
            mark = {m: "*" if (a, s, m) in exchanges else "" for m in ("single", "multi")}
            text = (f"{one.step_s:.3g} {abbrev[one.dominant]}{mark['single']}, "
                    f"{100 * one.peak_fraction:.2g} %, "
                    f"{peaks[a, s, 'single'] / 2**30:.3g} GiB")
            if many is not None and many.dominant != "skipped":
                text += f"; {many.step_s:.3g} {abbrev[many.dominant]}{mark['multi']}"
            row.append(text)
        lines.append(f"| {a} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--json-out")
    ap.add_argument("--markdown", action="store_true",
                    help="print both meshes' sweep as one markdown table")
    args = ap.parse_args()
    if args.markdown:
        print(sweep_table(args.dryrun_dir))
        return
    cells = analyze_all(args.dryrun_dir, args.mesh)
    print(format_table(cells))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([dataclasses.asdict(c) for c in cells], f, indent=1)


if __name__ == "__main__":
    main()
