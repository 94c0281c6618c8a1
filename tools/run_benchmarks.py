#!/usr/bin/env python
"""Full-year control benchmarks over the pymgrid25 suite -> RESULTS.md.

Runs rule-based control (compiled engine, f64) and optionally MPC (HiGHS)
over all 8759 steps of each scenario and records total annual costs.

Usage: python tools/run_benchmarks.py [--mpc] [--scenarios 0,1,2]
"""
import argparse
import re
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

os.environ.setdefault("JAX_ENABLE_X64", "1")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mpc", action="store_true", help="also run MPC (slow)")
    parser.add_argument("--tight-mpc", action="store_true",
                        help="use tight battery bounds in the MPC model")
    parser.add_argument("--scenarios", default=None)
    parser.add_argument("--out", default=REPO / "RESULTS.md", type=Path)
    parser.add_argument("--saa", action="store_true",
                        help="run on-chip BatchedSAA over ALL 25 scenarios "
                             "(genset MILPs via on-chip enumeration) for the "
                             "three published forecast-accuracy presets -> "
                             "RESULTS_SAA.md (on the default JAX device)")
    parser.add_argument("--saa-samples", type=int, default=10)
    parser.add_argument("--saa-percentile", type=float, default=0.5)
    parser.add_argument("--saa-presets", default="85,70,50")
    parser.add_argument("--enum-bits", type=int, default=5,
                        help="genset MILP enumeration bits for on-chip runs")
    parser.add_argument("--enum-chunk", type=int, default=16,
                        help="patterns per enumeration solve (lax.scan chunk)")
    parser.add_argument("--matmul-precision", default="float32",
                        choices=["bfloat16", "tensorfloat32", "float32"],
                        help="matmul precision of the on-chip LP solves")
    parser.add_argument("--ipm-iters", type=int, default=None,
                        help="IPM iterations for chip LP solves (default: "
                             "30; --mpc-suite defaults to 60 — the f32 "
                             "sharpening that collapses degenerate-vertex "
                             "drift, docs/parity.md #12)")
    parser.add_argument("--newton-refine", type=int, default=None,
                        help="iterative-refinement rounds per Newton solve "
                             "(default 1 at f32; --mpc-suite defaults to 2)")
    parser.add_argument("--tie-break-eps", type=float, default=None,
                        help="SuiteMPC flat-face tie-break ablation "
                             "(default off; see RESULTS_CHIP.md)")
    parser.add_argument("--scan-chunk", type=int, default=None,
                        help="engine-steps per device execution (default: "
                             "the whole year in one execution)")
    parser.add_argument("--resume", action="store_true",
                        help="chip modes: skip scenarios already recorded in "
                             "the incremental sidecar")
    parser.add_argument("--mpc-chip", action="store_true",
                        help="regenerate the full-year MPC table ON CHIP "
                             "(BatchedMPC, one lax.scan per scenario) -> "
                             "RESULTS_CHIP.md")
    parser.add_argument("--mpc-suite", action="store_true",
                        help="regenerate the full-year MPC table ON CHIP as "
                             "ONE batched program over all scenarios "
                             "(SuiteMPC: heterogeneous batched IPM, year "
                             "under lax.scan) -> RESULTS_CHIP.md")
    parser.add_argument("--scaling", action="store_true",
                        help="virtual-device scaling table (suite env-steps/s "
                             "at 1/2/4/8 CPU devices, fresh subprocess each) "
                             "-> RESULTS_SCALING.md")
    parser.add_argument("--scaling-chip", action="store_true",
                        help="batch-size sweep of suite throughput on the "
                             "default JAX device (one GPU); appends to "
                             "RESULTS_SCALING.md")
    parser.add_argument("--scaling-worker", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--scaling-configs", type=int, default=8)
    parser.add_argument("--scaling-replicas", type=int, default=256)
    parser.add_argument("--scaling-steps", type=int, default=200)
    args = parser.parse_args()

    import jax

    from pymgrid_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.scaling_worker is not None:
        return scaling_worker(args)
    if args.scaling or args.scaling_chip:
        return run_scaling(args)
    if args.saa:
        return run_saa(args)
    if args.mpc_chip:
        return run_mpc_chip(args)
    if args.mpc_suite:
        return run_mpc_suite(args)

    # run on CPU: the float64 engine is bitwise-equal to the host layer
    # there, and full-year single-replica scans are fast
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos import RuleBasedControl, ModelPredictiveControl

    scenarios = (
        [int(s) for s in args.scenarios.split(",")]
        if args.scenarios
        else list(range(25))
    )

    rows = []
    for n in scenarios:
        mg = Microgrid.from_scenario(n)
        t0 = time.time()
        log = RuleBasedControl(mg).run_compiled()
        rbc_cost = -log[("balance", 0, "reward")].sum()
        rbc_time = time.time() - t0

        mpc_cost, mpc_time = None, None
        if args.mpc:
            mg2 = Microgrid.from_scenario(n)
            t0 = time.time()
            mpc_log = ModelPredictiveControl(
                mg2, tight_battery_bounds=args.tight_mpc
            ).run()
            mpc_cost = -mpc_log[("balance", 0, "reward")].sum()
            mpc_time = time.time() - t0

        rows.append((n, rbc_cost, rbc_time, mpc_cost, mpc_time))
        msg = f"scenario {n}: RBC {rbc_cost:,.2f} ({rbc_time:.1f}s)"
        if mpc_cost is not None:
            msg += f"  MPC {mpc_cost:,.2f} ({mpc_time:.1f}s)"
        print(msg, flush=True)

    lines = [
        "# RESULTS — pymgrid25 full-year control benchmarks",
        "",
        "Total annual operating cost (= negative cumulative balance reward) over",
        "8759 hourly steps per scenario.  RBC runs on the compiled engine in",
        "float64 (bitwise-equal to the host/reference simulation, see",
        "tests/test_envs_algos.py); MPC uses perfect (oracle) forecasts with",
        f"horizon 24, solved by HiGHS"
        + (", with tight (simulator-true) battery bounds" if args.tight_mpc else
           " (reference-faithful battery bounds; see --tight-mpc)")
        + ".",
        "",
        "Note: the published `pymgrid 25 - benchmarks.xlsx` totals were produced",
        "by the *legacy nonmodular* pipeline and differ from the reference's own",
        "modular implementation; our correctness gate is exact parity with the",
        "reference modular implementation (verified: ALL 25 scenarios' full-year",
        "RBC reward streams match recorded reference runs bit-for-bit —",
        "tests/test_golden_year.py).",
        "",
        "| scenario | RBC cost | RBC s | MPC cost | MPC s |",
        "|---|---|---|---|---|",
    ]
    for n, rbc_cost, rbc_time, mpc_cost, mpc_time in rows:
        mpc_str = f"{mpc_cost:,.2f}" if mpc_cost is not None else "—"
        mpc_t = f"{mpc_time:.1f}" if mpc_time is not None else "—"
        lines.append(f"| {n} | {rbc_cost:,.2f} | {rbc_time:.1f} | {mpc_str} | {mpc_t} |")

    total_rbc = sum(r[1] for r in rows)
    lines.append(f"| **total** | **{total_rbc:,.2f}** | | " + (
        f"**{sum(r[3] for r in rows):,.2f}** | |" if args.mpc and all(r[3] is not None for r in rows) else "| |"
    ))
    args.out.write_text("\n".join(lines) + "\n")
    print(f"wrote {args.out}")


def _suite_throughput(n_configs, replicas, n_steps, mesh=None, repeats=3,
                      seed=0):
    """Best-of-N wall clock of the suite rollout; returns env-steps/s."""
    import numpy as np

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.core.rollout import make_marginal_cost_policy
    from pymgrid_tpu.parallel.suite import SuiteRunner

    mgs = [Microgrid.from_scenario(n) for n in range(n_configs)]
    runner = SuiteRunner(mgs, batch_per_config=replicas, dtype=np.float32,
                         mesh=mesh)
    policy = make_marginal_cost_policy(runner.spec)
    # distinct per-replica starts, else XLA
    # deduplicates the replica dimension and the sweep measures
    # broadcastable work
    fn = runner.rollout_fn(policy, n_steps, auto_reset=True, collect=False,
                           randomize_initial_step=True)
    keys = runner.make_keys(seed=seed)

    jax.block_until_ready(fn(runner.params, keys))  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(runner.params, keys))
        best = min(best, time.perf_counter() - t0)
    return n_configs * replicas * n_steps / best


def scaling_worker(args):
    """Child process: one virtual-CPU-mesh measurement, one JSON line."""
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")

    n = args.scaling_worker
    assert len(jax.devices()) >= n, (
        f"asked for {n} devices, have {len(jax.devices())} — the parent must "
        f"set XLA_FLAGS=--xla_force_host_platform_device_count"
    )
    from pymgrid_tpu.parallel import make_batch_mesh

    mesh = make_batch_mesh(n) if n > 1 else None
    sps = _suite_throughput(args.scaling_configs, args.scaling_replicas,
                            args.scaling_steps, mesh=mesh)
    print(json.dumps({"devices": n, "env_steps_per_sec": sps}))


def run_scaling(args):
    """Scaling evidence -> RESULTS_SCALING.md.

    ``--scaling``: the suite program sharded over a ``batch`` mesh at
    1/2/4/8 *virtual CPU devices* (fresh subprocess per point so the device
    count is set before backend init).  This validates that the sharded
    program compiles, partitions, and runs at every mesh size; absolute
    CPU numbers are bounded by the physical core count.
    ``--scaling-chip``: batch-size sweep of the same program on the
    default device, in this process.  The ``--scaling`` children pin the
    CPU backend, so no two processes ever open the GPU.
    """
    import json
    import subprocess

    out = REPO / "RESULTS_SCALING.md"
    virtual_rows, chip_rows = [], []

    if args.scaling:
        for n in (1, 2, 4, 8):
            env = dict(os.environ)
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={n}"
            ).strip()
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--scaling-worker", str(n),
                   "--scaling-configs", str(args.scaling_configs),
                   "--scaling-replicas", str(args.scaling_replicas),
                   "--scaling-steps", str(args.scaling_steps)]
            proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"worker {n} failed:\n{proc.stderr[-2000:]}")
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            virtual_rows.append(row)
            print(f"{n} virtual devices: {row['env_steps_per_sec']:,.0f} "
                  f"env-steps/s", flush=True)

    if args.scaling_chip:

        for replicas in (256, 1024, 4096, 8192, 20480):
            sps = _suite_throughput(25, replicas, args.scaling_steps)
            chip_rows.append({"replicas": replicas, "total_envs": 25 * replicas,
                              "env_steps_per_sec": sps})
            print(f"chip batch {25 * replicas}: {sps:,.0f} env-steps/s",
                  flush=True)

    _write_scaling_report(out, virtual_rows, chip_rows, args)
    print(f"wrote {out}")


def _write_scaling_report(out, virtual_rows, chip_rows, args):
    # preserve whichever section wasn't regenerated this run
    old = out.read_text() if out.exists() else ""

    def section(title, body):
        return f"## {title}\n\n{body}\n"

    virtual_md = None
    if virtual_rows:
        base = virtual_rows[0]["env_steps_per_sec"]
        lines = [
            f"Suite program ({args.scaling_configs} configs x "
            f"{args.scaling_replicas} replicas x {args.scaling_steps} steps, "
            "f32) sharded over a `batch` mesh of N virtual CPU devices",
            "(`--xla_force_host_platform_device_count`, fresh subprocess per",
            "point).  Validates mesh partitioning at every size; absolute",
            f"CPU throughput is bounded by the {os.cpu_count()} physical",
            "cores of this host, so ideal scaling is NOT expected here;",
            "device numbers come from `--scaling-chip` on a GPU.",
            "",
            "| devices | env-steps/s | vs 1 device |",
            "|---|---|---|",
        ]
        for row in virtual_rows:
            lines.append(
                f"| {row['devices']} | {row['env_steps_per_sec']:,.0f} | "
                f"{row['env_steps_per_sec'] / base:.2f}x |"
            )
        virtual_md = section("Virtual-device mesh scaling (CPU)", "\n".join(lines))
    else:
        m = re.search(r"## Virtual-device.*?(?=## |\Z)", old, re.S)
        virtual_md = m.group(0) if m else ""

    chip_md = None
    if chip_rows:
        lines = [
            f"Suite throughput on one {_device_name()} as the env batch",
            f"grows ({args.scaling_steps} steps, f32, 25 configs,",
            "randomized per-replica starts, so XLA cannot deduplicate",
            "replicas):",
            "",
            "| total envs | env-steps/s/chip |",
            "|---|---|",
        ]
        for row in chip_rows:
            lines.append(
                f"| {row['total_envs']:,} | {row['env_steps_per_sec']:,.0f} |"
            )
        chip_md = section("Batch-size sweep on the real chip", "\n".join(lines))
    else:
        m = re.search(r"## Batch-size.*?(?=## |\Z)", old, re.S)
        chip_md = m.group(0) if m else ""

    out.write_text(
        "# RESULTS — scaling evidence\n\n"
        "Multi-device scaling of the one-program pymgrid25 suite rollout\n"
        "(`pymgrid_tpu/parallel/suite.py`).\n\n"
        + virtual_md + "\n" + chip_md
    )



def _load_sidecar(sidecar, config, resume, mark):
    """Load a resume sidecar, refusing rows recorded under a different run
    configuration (silently mixing --enum-bits/--matmul-precision rows
    would corrupt a published table).  Returns the rows dict."""
    import json

    if not (resume and sidecar.exists()):
        return {}
    data = json.loads(sidecar.read_text())
    if "config" not in data:  # legacy schema: no config recorded
        raise SystemExit(
            f"{sidecar} predates config-stamped sidecars; delete it or rerun "
            f"without --resume."
        )
    if data["config"] != config:
        raise SystemExit(
            f"--resume refused: {sidecar} was recorded with config "
            f"{data['config']} but this run uses {config}.  Delete the "
            f"sidecar or rerun with matching flags."
        )
    mark(f"resuming: {sorted(data['rows'])} already recorded")
    return data["rows"]


def _save_sidecar(sidecar, config, rows):
    import json

    sidecar.write_text(json.dumps({"config": config, "rows": rows}))


def run_saa(args):
    """Full-year on-chip stochastic MPC, all 25 scenarios, three presets.

    Mirrors the published benchmark protocol (BASELINE.md rows 3-5): the
    SAA-85/70/50 labels are *forecast accuracy presets* (``preset_to_use``;
    reference ``Benchmarks.run_saa_benchmark``), optimal percentile 0.5.
    Genset scenarios solve every sample's horizon MILP on chip.
    """
    import warnings

    import numpy as np

    warnings.filterwarnings("ignore")

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos import BatchedSAA

    scenarios = (
        [int(s) for s in args.scenarios.split(",")]
        if args.scenarios
        else list(range(25))
    )
    presets = [int(p) for p in args.saa_presets.split(",")]
    pct = args.saa_percentile

    import json

    def mark(msg):
        print(f"[saa {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
              flush=True)

    sidecar = REPO / "RESULTS_SAA.partial.json"
    config = {
        "enum_bits": args.enum_bits,
        "enum_chunk": args.enum_chunk,
        "matmul_precision": args.matmul_precision,
        "saa_samples": args.saa_samples,
        "saa_percentile": pct,
        "solver_kind": "box",
        "ipm_iters": args.ipm_iters or 60,
        "newton_refine": (2 if args.newton_refine is None
                          else args.newton_refine),
    }
    done = _load_sidecar(sidecar, config, args.resume, mark)

    rows = {n: {} for n in scenarios}
    for preset in presets:
        for n in scenarios:
            key = f"{n}:{preset}"
            if key in done:
                rows[n][preset] = tuple(done[key])
                continue
            np.random.seed(1000 + n)  # sampler RNG, reproducible per scenario
            mg = Microgrid.from_scenario(n)
            t0 = time.time()
            mark(f"scenario {n} preset {preset}: building BatchedSAA")
            saa = BatchedSAA(mg, n_samples=args.saa_samples,
                             optimal_percentile=pct,
                             preset_to_use=preset, dtype=np.float32,
                             enum_bits=args.enum_bits,
                             enum_chunk=args.enum_chunk,
                             iters=args.ipm_iters or 60,
                             newton_refine=(2 if args.newton_refine is None
                                            else args.newton_refine),
                             solver_kind="box",
                             matmul_precision=args.matmul_precision)
            mark(f"scenario {n} preset {preset}: compiling + scanning year")
            rewards, _ = saa.run_scanned()
            cost, dt = float(-rewards.sum()), time.time() - t0
            rows[n][preset] = (cost, len(rewards), dt)
            done[key] = [cost, len(rewards), dt]
            _save_sidecar(sidecar, config, done)
            print(f"scenario {n}: SAA-{preset} {cost:,.2f} "
                  f"({len(rewards)} steps, {dt:.1f}s)", flush=True)

    # the anchored writer (chip det-MPC + host RBC columns, xlsx baseline
    # totals) is the single source of the published table
    from tools.saa_report import write_report

    out = (args.out if "SAA" in str(args.out) else None)
    write_report(done, config, out=out)
    if args.scenarios is None:
        # full-table run complete; a --scenarios subset must keep the
        # sidecar (other scenarios' rows live there for later --resume)
        sidecar.unlink(missing_ok=True)


def run_mpc_chip(args):
    """Regenerate the full-year MPC table on chip (BatchedMPC + lax.scan)."""
    import warnings

    import numpy as np

    warnings.filterwarnings("ignore")

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos.mpc_jax import BatchedMPC

    scenarios = (
        [int(s) for s in args.scenarios.split(",")]
        if args.scenarios
        else list(range(25))
    )

    def mark(msg):
        # stage markers: construction/compile phases are minutes-long and
        # otherwise silent
        print(f"[chip {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
              flush=True)

    import json

    sidecar = REPO / "RESULTS_CHIP.partial.json"
    config = {
        "enum_bits": args.enum_bits,
        "enum_chunk": args.enum_chunk,
        "matmul_precision": args.matmul_precision,
        "scan_chunk": args.scan_chunk,
    }
    done = {int(k): v for k, v in
            _load_sidecar(sidecar, config, args.resume, mark).items()}

    rows = []
    for n in scenarios:
        if n in done:
            rows.append(tuple(done[n]))
            continue
        mg = Microgrid.from_scenario(n)
        n_steps = int(mg.final_step) - int(mg.initial_step)
        t0 = time.time()
        mark(f"scenario {n}: building BatchedMPC template")
        bm = BatchedMPC(mg, batch_size=1, dtype=np.float32, host_fallback=False,
                        enum_bits=args.enum_bits, enum_chunk=args.enum_chunk,
                        matmul_precision=args.matmul_precision)
        chunk = args.scan_chunk
        mark(f"scenario {n}: compiling + scanning year "
             f"({n_steps} steps, chunk {chunk})")
        rewards, _ = bm.run_scanned(n_steps, chunk=chunk)
        cost, dt = float(-rewards[:, 0].sum()), time.time() - t0
        rows.append((n, cost, n_steps, dt))
        done[n] = [n, cost, n_steps, dt]
        _save_sidecar(sidecar, config, {str(k): v for k, v in done.items()})
        print(f"scenario {n}: chip-MPC {cost:,.2f} ({n_steps} steps, {dt:.1f}s)",
              flush=True)

    _write_chip_report(rows, args.enum_bits)
    if args.scenarios is None:
        sidecar.unlink(missing_ok=True)  # full table written



def run_mpc_suite(args):
    """All-scenario chip MPC table from ONE batched program (SuiteMPC)."""
    import warnings

    import numpy as np

    warnings.filterwarnings("ignore")

    from pymgrid_tpu import Microgrid
    from pymgrid_tpu.algos.mpc_suite import SuiteMPC

    scenarios = (
        [int(s) for s in args.scenarios.split(",")]
        if args.scenarios
        else list(range(25))
    )

    def mark(msg):
        print(f"[suite-mpc {time.strftime('%H:%M:%S')}] {msg}",
              file=sys.stderr, flush=True)

    from pymgrid_tpu.modules import GensetModule

    t0 = time.time()
    mgs = {n: Microgrid.from_scenario(n) for n in scenarios}
    has_genset = {
        n: any(isinstance(m, GensetModule) for m in mg.modules.iterlist())
        for n, mg in mgs.items()
    }
    # genset-free scenarios run as their own group: no neutral-genset slot,
    # no MILP enumeration -> ~9x fewer LP solves per step for that group
    groups = [
        [n for n in scenarios if not has_genset[n]],
        [n for n in scenarios if has_genset[n]],
    ]
    # per-GROUP resume sidecar: an interrupted run keeps every completed
    # group; groups are the atomic unit here
    sidecar = REPO / "RESULTS_CHIP.suite.partial.json"
    config = {
        "enum_bits": args.enum_bits,
        "enum_chunk": args.enum_chunk,
        "matmul_precision": args.matmul_precision,
        "ipm_iters": args.ipm_iters or 60,
        "newton_refine": (2 if args.newton_refine is None
                          else args.newton_refine),
        "scan_chunk": args.scan_chunk,
        "tie_break_eps": args.tie_break_eps,
    }
    done = _load_sidecar(sidecar, config, args.resume, mark)
    rows_by_n = {}
    for group in groups:
        if not group:
            continue
        gkey = ",".join(map(str, group))
        if gkey in done:
            for n, cost, steps, dt in done[gkey]:
                rows_by_n[n] = (n, cost, steps, dt)
            mark(f"group {group}: resumed from sidecar")
            continue
        mark(f"building SuiteMPC group {group} (enum_bits={args.enum_bits})")
        g0 = time.time()
        suite = SuiteMPC([mgs[n] for n in group], dtype=np.float32,
                         enum_bits=args.enum_bits,
                         enum_chunk=args.enum_chunk,
                         iters=args.ipm_iters or 60,
                         newton_refine=(2 if args.newton_refine is None
                                        else args.newton_refine),
                         matmul_precision=args.matmul_precision,
                         tie_break_eps=args.tie_break_eps)
        chunk = args.scan_chunk
        mark(f"group of {len(group)}: compiling + scanning year "
             f"({suite.n_steps_year} steps, chunk {chunk})")
        rewards, _ = suite.run_scanned(chunk=chunk, progress=mark)
        gwall = time.time() - g0
        costs = -rewards.sum(axis=0)
        for i, n in enumerate(group):
            rows_by_n[n] = (n, float(costs[i]), rewards.shape[0],
                            gwall / len(group))
            print(f"scenario {n}: suite-MPC {float(costs[i]):,.2f} "
                  f"({rewards.shape[0]} steps)", flush=True)
        done[gkey] = [list(rows_by_n[n]) for n in group]
        _save_sidecar(sidecar, config, done)
        mark(f"group wall {gwall:.1f}s for {len(group)} scenario-years")
    wall = time.time() - t0
    rows = [rows_by_n[n] for n in scenarios]
    mark(f"total wall {wall:.1f}s for {len(scenarios)} scenario-years "
         f"({wall / len(scenarios):.1f}s/scenario amortized)")
    _write_chip_report(
        rows, args.enum_bits,
        extra_note=(
            f"Generated by `--mpc-suite`: ONE batched program runs every "
            f"scenario's planner+simulator together (heterogeneous batched "
            f"IPM, `pymgrid_tpu/algos/mpc_suite.py`); total wall "
            f"{wall:.1f} s for {len(scenarios)} scenario-years — the s "
            f"column is amortized."
        ),
    )
    if args.scenarios is None:
        sidecar.unlink(missing_ok=True)


def _device_name():
    """The default device as JAX and ``nvidia-smi`` name it, for report
    headers: numbers are only comparable on the same card and power limit."""
    import jax

    from pymgrid_tpu.utils.profiling import gpu_name_and_power_limit

    kind = jax.devices()[0].device_kind
    card = gpu_name_and_power_limit()
    return kind if card == "not available" else f"{kind} ({card})"


def _write_chip_report(rows, enum_bits, out=None, extra_note=None):
    """Write RESULTS_CHIP.md from (scenario, cost, steps, dt) rows, with
    measured deltas against the host f64 table (exercised on CPU by
    tests/test_bench_smoke.py)."""
    # host f64 HiGHS MPC costs (same formulation) for the measured-delta
    # columns; parsed from RESULTS.md rather than restated by hand
    host_costs = {}
    results_md = REPO / "RESULTS.md"
    if results_md.exists():
        for line in results_md.read_text().splitlines():
            m = re.match(
                r"\|\s*(\d+)\s*\|\s*[\d,.]+\s*\|\s*[\d.]+\s*\|"
                r"\s*([\d,.]+)\s*\|", line)
            if m:
                host_costs[int(m.group(1))] = float(m.group(2).replace(",", ""))

    deltas = {n: cost / host_costs[n] - 1.0
              for n, cost, _, _ in rows if n in host_costs}
    out = out or REPO / "RESULTS_CHIP.md"
    header = [
        "# RESULTS — on-chip MPC full-year costs (float32, "
        f"enum_bits={enum_bits})",
        "",
        f"Device: {_device_name()}.",
        "",
        "BatchedMPC: the horizon problem (LP; genset scenarios a MILP via",
        "on-chip LP-relaxation + batched status-pattern enumeration) solves on",
        "the device and the first-step control feeds the compiled engine —",
        "the year runs under lax.scan per scenario.  Compare the",
        "wall-clock to the host HiGHS pipeline's 45-445 s/scenario",
        "(RESULTS.md).  The Δ column is measured against the float64 host",
        "HiGHS table (RESULTS.md, same formulation; f64 on-chip parity is",
        "separately gated at 1e-4 in tests/test_lp_mpc.py).",
    ]
    if extra_note:
        header += ["", extra_note]
    if deltas:
        total_chip = sum(cost for n, cost, _, _ in rows if n in host_costs)
        total_host = sum(host_costs[n] for n, *_ in rows if n in host_costs)
        sorted_d = sorted(abs(d) for d in deltas.values())
        median_d = sorted_d[len(sorted_d) // 2]
        worst_n, worst_d = max(deltas.items(), key=lambda kv: abs(kv[1]))
        header += [
            "",
            f"Measured this run: total {total_chip:,.1f} vs host "
            f"{total_host:,.1f} (**{total_chip / total_host - 1.0:+.2%}**); "
            f"median per-scenario |Δ| {median_d:.2%}; worst scenario "
            f"{worst_n} at {worst_d:+.2%}.",
        ]
    lines = header + [
        "",
        "| scenario | chip MPC cost | host f64 MPC | Δ | steps | s |",
        "|---|---|---|---|---|---|",
    ]
    for n, cost, steps, dt in rows:
        host = f"{host_costs[n]:,.2f}" if n in host_costs else "—"
        d = f"{deltas[n]:+.2%}" if n in deltas else "—"
        lines.append(f"| {n} | {cost:,.2f} | {host} | {d} | {steps} | {dt:.1f} |")
    if deltas:
        # chip total over the SAME host-matched subset as total_host/Δ
        unmatched = [n for n, *_ in rows if n not in host_costs]
        total_line = (f"| **total (matched)** | **{total_chip:,.2f}** | "
                      f"**{total_host:,.2f}** | "
                      f"**{total_chip / total_host - 1.0:+.2%}** | | |")
        lines.append(total_line)
        if unmatched:
            lines.append(
                f"| total (all rows) | {sum(r[1] for r in rows):,.2f} "
                f"| — | — | | |")
            lines.append("")
            lines.append(f"Scenarios without a host anchor in RESULTS.md: "
                         f"{unmatched}.")
    else:
        lines.append(f"| **total** | **{sum(r[1] for r in rows):,.2f}** "
                     f"| | | | |")
    # keep any hand-written analysis section across regenerations
    if out.exists():
        m = re.search(r"^## Quality analysis.*", out.read_text(),
                      re.S | re.M)
        if m:
            lines += ["", m.group(0).rstrip()]
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
