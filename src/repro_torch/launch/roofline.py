"""Roofline analysis from dry-run artifacts: the port of
``repro.launch.roofline``.

Per (arch x shape) cell on a mesh, the three roofline terms of one
device, at the rates of the card the artifact names
(``core.bridge.DEVICE_RATES``; the NVIDIA H100 80GB HBM3's from NVIDIA's
data sheet):

    compute    = flops_per_device          / peak_flops  (dense bf16)
    memory     = bytes_per_device          / hbm_bw
    collective = (wire - cross) / link_bw  + cross / dci_bw

The FLOPs, bytes and wire bytes come from ``launch.dryrun``, which
executes one device's program of the cell's sharded step on fake tensors
and counts it (``launch.op_cost``).  ``model_flops`` is the useful-work
floor: 6 N D for training (N the parameters a token touches: MoE counts
top_k of n_experts), 2 N D for prefill, 2 N a token for decode.  The
ratio model_flops / counted FLOPs exposes remat, replication and padding
waste.
"""
from __future__ import annotations

import glob
import json
import os

from ..configs import SHAPES, get_config
from ..core.bridge import DEVICE_RATES, DeviceRates

ARTIFACT_DIR = os.path.join("artifacts", "dryrun_torch")


def active_params(arch: str) -> int:
    """Parameters touched per token (MoE: top_k of n_experts), counted on
    the port's model built on the meta device."""
    from ..models.model import LM

    cfg = get_config(arch)
    total = 0
    for name, p in LM(cfg, device="meta").named_parameters():
        n = p.numel()
        if name.rsplit(".", 1)[-1] in ("we1", "we2", "we3") and cfg.n_experts:
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return int(total)


def model_flops(arch: str, shape: str) -> float:
    """Useful-work floor for the cell (global, not per device)."""
    sh = SHAPES[shape]
    n_act = active_params(arch)
    tokens = sh.global_batch * sh.seq_len
    if sh.kind == "train":
        return 6.0 * n_act * tokens
    if sh.kind == "prefill":
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * sh.global_batch


def load_cells(mesh: str = "single", out_dir: str = ARTIFACT_DIR
               ) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(out_dir, f"*__{mesh}.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def rates_of(rec: dict) -> DeviceRates:
    """The rates of the card an artifact names; raises for a card the
    table does not hold."""
    card = rec.get("card")
    if card not in DEVICE_RATES:
        raise KeyError(f"no rates for card {card!r}; the table holds "
                       f"{sorted(DEVICE_RATES)}: pass rates=DeviceRates(...)")
    return DEVICE_RATES[card]


def roofline_row(rec: dict, rates: DeviceRates | None = None) -> dict:
    """The roofline terms of one artifact at ``rates`` (by default those
    of the card it names), in the reference's arithmetic and order, with
    one deliberate difference: the memory term keeps the bytes of dtype
    conversions (``convert_bytes_total``).  The reference subtracts them
    because XLA fuses converts into the TPU's matrix units; the port's
    eager converts are kernels of their own on the H100, which read and
    write their bytes.  ``t_memory_cpu_raw_s`` is therefore
    ``t_memory_s``; ``fits_hbm`` holds the device's peak (argument, temp
    and output bytes less the aliased) against the card's memory.
    ``roofline_fraction`` is not capped at 1 as the reference's is: the
    dominant term is at least the compute term, so it exceeds 1 only
    where the counted FLOPs fall below the model's, an undercount that
    a cap would hide."""
    rates = rates_of(rec) if rates is None else rates
    n_chips = rec["n_chips"]
    t_comp = rec["flops_total"] / rates.peak_flops
    t_mem = rec["bytes_accessed_total"] / rates.hbm_bw
    wire = rec["collectives"]["wire_bytes_per_chip"]
    cross = rec["collectives"].get("cross_pod_bytes_per_chip", 0.0)
    t_coll = (wire - cross) / rates.link_bw + (
        cross / rates.dci_bw if cross else 0.0)
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    mf = model_flops(rec["arch"], rec["shape"]) / n_chips
    ratio = mf / max(rec["flops_total"], 1.0)
    # roofline fraction: useful work vs what the dominant term costs
    t_dom = max(t_comp, t_mem, t_coll)
    frac = (mf / rates.peak_flops) / max(t_dom, 1e-30)
    mem = rec.get("memory_analysis", {})
    hbm_gb = (mem.get("argument_size_in_bytes", 0)
              + mem.get("temp_size_in_bytes", 0)
              + mem.get("output_size_in_bytes", 0)
              - mem.get("alias_size_in_bytes", 0)) / 1e9
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "t_memory_cpu_raw_s": t_mem,
        "dominant": dominant,
        "model_flops_per_chip": mf,
        "hlo_flops_per_chip": rec["flops_total"],
        "useful_ratio": ratio,
        "roofline_fraction": frac,
        "hbm_gb_per_chip": hbm_gb,
        "fits_hbm": hbm_gb <= rates.hbm_bytes / 1e9,
    }


def report(mesh: str = "single", out_dir: str = ARTIFACT_DIR,
           rates: DeviceRates | None = None) -> list[dict]:
    rows = []
    for rec in load_cells(mesh, out_dir):
        if not rec.get("ok"):
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "error": rec.get("error")})
            continue
        rows.append(roofline_row(rec, rates))
    return rows


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'t_comp':>9s} {'t_mem':>9s} "
           f"{'t_coll':>9s} {'dom':>10s} {'MF/ops':>7s} {'roofl%':>7s} "
           f"{'HBM_GB':>7s} fits")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if "error" in r:
            lines.append(f"{r['arch']:22s} {r['shape']:12s} ERROR: "
                         f"{str(r['error'])[:60]}")
            continue
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} "
            f"{r['t_compute_s']:9.2e} {r['t_memory_s']:9.2e} "
            f"{r['t_collective_s']:9.2e} {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.3f} {100*r['roofline_fraction']:6.1f}% "
            f"{r['hbm_gb_per_chip']:7.2f} "
            f"{'Y' if r['fits_hbm'] else 'N'}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    rows = report(args.mesh, args.out)
    print(format_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
