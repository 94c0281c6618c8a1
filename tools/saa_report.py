#!/usr/bin/env python
"""Write RESULTS_SAA.md from the incremental sidecar, with anchor columns.

The on-chip SAA table runs scenario-by-scenario and its sidecar
(RESULTS_SAA.partial.json) survives interrupted runs; this writer turns
whatever has completed into the published table, adding the two available
independent anchors per scenario:

* the on-chip deterministic-MPC realized cost (RESULTS_CHIP.md) — SAA plans
  with sampled futures incl. Markov-resampled outages, so on weak-grid
  scenarios it can realize far BELOW the deterministic planner (which
  assumes an always-up grid, reference mpc.py:914);
* the host f64 RBC realized cost (RESULTS.md).

Usage: python tools/saa_report.py
"""
import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def parse_costs(path, pattern):
    out = {}
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        m = re.match(pattern, line)
        if m:
            out[int(m.group(1))] = float(m.group(2).replace(",", ""))
    return out


# reference publication totals (`pymgrid 25 - benchmarks.xlsx` sheet1,
# reproduced in BASELINE.md rows 3-5).  Produced by the LEGACY nonmodular
# pipeline with the reference's own samplers — comparable in protocol, not
# bitwise (see RESULTS.md provenance note).
XLSX_TOTALS = {85: 386_439_473.88, 70: 386_244_383.30, 50: 386_103_432.28}


def write_report(rows, cfg, out=None):
    """Write the anchored SAA table from ``rows`` ({"n:preset": [cost,
    steps, dt]}) and ``cfg`` (the run's config stamp)."""
    chip_mpc = parse_costs(
        REPO / "RESULTS_CHIP.md", r"\|\s*(\d+)\s*\|\s*([\d,.]+)\s*\|"
    )
    host_rbc = parse_costs(
        REPO / "RESULTS.md", r"\|\s*(\d+)\s*\|\s*([\d,.]+)\s*\|"
    )

    by_scen = {}
    for key, (cost, steps, dt) in rows.items():
        n, preset = key.split(":")
        by_scen.setdefault(int(n), {})[int(preset)] = (cost, steps, dt)

    # the SAA-85/70/50 forecast-accuracy presets are INERT in reference
    # v1.2.2: the preset only shifts the returned PV forecast, never the
    # sampled futures, so trajectories are bit-identical across presets
    # (docs/parity.md #10).  Confirmed ON CHIP by re-running scenarios
    # under a second preset: every duplicated scenario-year must match.
    confirmations = []
    for n, d in sorted(by_scen.items()):
        if len(d) > 1:
            costs = [c for c, _, _ in d.values()]
            # r4-era sidecar rows were stored rounded to the cent
            assert max(costs) - min(costs) <= 0.011, (
                f"scenario {n}: presets differ {d} — the inertness "
                f"documented in docs/parity.md #10 no longer holds"
            )
            confirmations.append(n)
    presets = sorted({p for d in by_scen.values() for p in d})

    lines = [
        "# RESULTS — on-chip stochastic MPC (SAA) full-year costs",
        "",
        f"BatchedSAA (box-IPM solver, iters={cfg['ipm_iters']}, "
        f"newton_refine={cfg['newton_refine']}, enum_bits={cfg['enum_bits']}, "
        f"n_samples={cfg['saa_samples']}, percentile "
        f"{cfg['saa_percentile']}), float32 on the device, one "
        "lax.scan per scenario-year.  Sampled futures come from this "
        "package's seeded samplers (Markov-resampled outages included), so "
        "totals are comparable to, not bitwise reproductions of, the "
        "published xlsx (see RESULTS.md provenance notes).",
        "",
        "Anchor columns: the on-chip deterministic-MPC realized cost "
        "(RESULTS_CHIP.md) and the host f64 RBC cost (RESULTS.md).  On "
        "weak-grid scenarios SAA realizes far BELOW deterministic MPC: its "
        "sampled futures include outages, so the planner commits the "
        "genset defensively, while the deterministic formulation plans "
        "against an always-up grid (reference mpc.py:914) and realizes "
        "loss-load during real outages — the same effect a learned RL "
        "policy can exploit.",
        "",
        "| scenario | SAA cost (presets 85/70/50 identical) "
        "| chip det-MPC | host RBC | s/run |",
        "|---|---|---|---|---|",
    ]
    total = 0.0
    for n in sorted(by_scen):
        d = by_scen[n]
        cost, steps, dt = next(iter(d.values()))
        total += cost
        mpc = f"{chip_mpc[n]:,.2f}" if n in chip_mpc else "—"
        rbc = f"{host_rbc[n]:,.2f}" if n in host_rbc else "—"
        lines.append(f"| {n} | {cost:,.2f} | {mpc} | {rbc} | {dt:.1f} |")
    lines.append(f"| **total ({len(by_scen)} scenarios)** | "
                 f"**{total:,.2f}** | | | |")
    lines += [
        "",
        "Reference publication totals for the same protocol "
        "(`pymgrid 25 - benchmarks.xlsx` sheet1, BASELINE.md rows 3-5): "
        f"SAA-85 {XLSX_TOTALS[85]:,.2f}, SAA-70 {XLSX_TOTALS[70]:,.2f}, "
        f"SAA-50 {XLSX_TOTALS[50]:,.2f}.  Those totals came from the "
        "reference's LEGACY nonmodular pipeline; its own modular "
        "implementation (which this package matches bitwise on RBC, "
        "tests/test_golden_year.py) realizes very different absolute costs "
        "on several scenarios — see RESULTS.md's provenance note.",
        "",
        "**The three presets are one benchmark, not three.**  In reference "
        "v1.2.2 the preset only alters the *returned* PV forecast, never "
        "the sampled futures, so SAA-85/70/50 trajectories are "
        "bit-identical under a fixed seed (docs/parity.md #10; the xlsx "
        "presets differ by ~0.05% — RNG re-runs, not a preset effect)."
        + (
            f"  Confirmed on chip: scenarios {confirmations} were re-run "
            f"under a second preset and realized identical costs to the "
            f"cent."
            if confirmations else ""
        ),
    ]
    missing = sorted(set(range(25)) - set(by_scen))
    if missing:
        lines += [
            "",
            f"Scenarios not yet captured (resume with "
            f"`tools/run_benchmarks.py --saa --resume`): {missing}.",
        ]
    out = out or REPO / "RESULTS_SAA.md"
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out} ({len(by_scen)} scenarios)")


def main():
    sidecar = REPO / "RESULTS_SAA.partial.json"
    data = json.loads(sidecar.read_text())
    write_report(data["rows"], data["config"])


if __name__ == "__main__":
    main()
