"""Direct parity against the REFERENCE's own SampleAverageApproximation.

The reference SAA (``algos/saa/saa.py:10``) drives ``mpc_single_step`` on the
nonmodular representation, sampling noisy futures from the DataGenerator
samplers.  Under the in-process shims (``helpers/cvxpy_shim.py`` for the MPC
solves, the working miniature QuantReg in ``helpers/reference.py`` for the PV
curve fits) it runs genuinely; with the global numpy RNG seeded identically,
our ``algos/saa.py`` must replay the same sampler stream, the same per-sample
horizon solves, and the same percentile selection — frame-level equality.

This also turns the "v1.2.2 presets never reach the samplers"
reading (reference ``DataGenerator.py:932-935``) into tested evidence.
"""
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from helpers.reference import import_reference, reference_available

needs_ref = pytest.mark.skipif(
    not reference_available(), reason="reference source unavailable"
)

REF_PATH = "/root/reference/src/pymgrid"


def _matched_nonmodular(seed=42, n=4, grid_only=False):
    """(reference, ours) nonmodular microgrids with bitwise-equal parameters
    (generator seed parity is tested in test_legacy.py)."""
    import_reference()
    from pymgrid.MicrogridGenerator import MicrogridGenerator as RefGen

    from pymgrid_tpu.generator import MicrogridGenerator as OurGen

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = RefGen(nb_microgrid=n, random_seed=seed, path=REF_PATH)
        ref.generate_microgrid(modular=False)
        ours = OurGen(nb_microgrid=n, random_seed=seed, path=REF_PATH)
        ours.generate_microgrid(modular=False)

    for rm, om in zip(ref.microgrids, ours.microgrids):
        if rm.architecture["grid"] != 1:
            continue
        if grid_only and rm.architecture["genset"] != 0:
            continue
        return rm, om
    raise RuntimeError("no matching architecture in generated set")


def _run_saa(saa_cls, microgrid, seed, n_samples, forecast_steps, percentile,
             raw_ties=False):
    np.random.seed(seed)
    saa = saa_cls(microgrid)
    if raw_ties:
        # hand HiGHS the reference's raw (tie-laden) cost vector so both
        # sides pick the same optimal vertex on degenerate steps
        from pymgrid_tpu.algos.mpc import ModelPredictiveControl

        saa._mpc = ModelPredictiveControl(microgrid, tie_break_eps=0)
    out = saa.run(
        n_samples=n_samples,
        forecast_steps=forecast_steps,
        optimal_percentile=percentile,
    )
    return out.to_frame()


@needs_ref
def test_saa_sampler_stream_parity():
    """Forecast + sample frames equal the reference's under a fixed seed."""
    import_reference()
    from pymgrid.algos.saa.saa import SampleAverageApproximation as RefSAA

    from pymgrid_tpu.algos.saa import SampleAverageApproximation as OurSAA

    rm, om = _matched_nonmodular(seed=42)

    np.random.seed(17)
    ref_saa = RefSAA(rm)
    ref_samples = ref_saa.sample_from_forecasts(n_samples=3)

    np.random.seed(17)
    our_saa = OurSAA(om)
    our_samples = our_saa.sample_from_forecasts(n_samples=3)

    pd.testing.assert_frame_equal(
        ref_saa.forecasts, our_saa.forecasts, check_exact=True
    )
    assert len(ref_samples) == len(our_samples) == 3
    for k, (rs, os_) in enumerate(zip(ref_samples, our_samples)):
        pd.testing.assert_frame_equal(rs, os_, check_exact=True), f"sample {k}"


@needs_ref
def test_saa_frames_match_reference_grid():
    """>=50 receding-horizon steps: ControlOutput frames match the
    reference's."""
    import_reference()
    from pymgrid.algos.saa.saa import SampleAverageApproximation as RefSAA

    from pymgrid_tpu.algos.saa import SampleAverageApproximation as OurSAA

    rm, om = _matched_nonmodular(seed=42, grid_only=True)

    ref_frame = _run_saa(RefSAA, rm, seed=23, n_samples=4,
                         forecast_steps=50, percentile=0.5)
    our_frame = _run_saa(OurSAA, om, seed=23, n_samples=4,
                         forecast_steps=50, percentile=0.5, raw_ties=True)

    assert sorted(ref_frame.columns) == sorted(our_frame.columns)
    for col in ref_frame.columns:
        np.testing.assert_allclose(
            our_frame[col].astype(float).values,
            ref_frame[col].astype(float).values,
            rtol=1e-9, atol=1e-7, err_msg=str(col),
        )


@needs_ref
def test_saa_frames_match_reference_genset():
    """Genset architecture (MILP horizon solves), fewer steps."""
    import_reference()
    from pymgrid.algos.saa.saa import SampleAverageApproximation as RefSAA

    from pymgrid_tpu.algos.saa import SampleAverageApproximation as OurSAA

    import_reference()
    rm, om = None, None
    from pymgrid.MicrogridGenerator import MicrogridGenerator as RefGen

    from pymgrid_tpu.generator import MicrogridGenerator as OurGen

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = RefGen(nb_microgrid=6, random_seed=42, path=REF_PATH)
        ref.generate_microgrid(modular=False)
        ours = OurGen(nb_microgrid=6, random_seed=42, path=REF_PATH)
        ours.generate_microgrid(modular=False)
    for r, o in zip(ref.microgrids, ours.microgrids):
        if r.architecture["grid"] == 1 and r.architecture["genset"] == 1:
            rm, om = r, o
            break
    if rm is None:
        pytest.skip("no genset+grid architecture in generated set")

    ref_frame = _run_saa(RefSAA, rm, seed=29, n_samples=3,
                         forecast_steps=8, percentile=0.5)
    our_frame = _run_saa(OurSAA, om, seed=29, n_samples=3,
                         forecast_steps=8, percentile=0.5, raw_ties=True)

    for col in ref_frame.columns:
        np.testing.assert_allclose(
            our_frame[col].astype(float).values,
            ref_frame[col].astype(float).values,
            rtol=1e-9, atol=1e-7, err_msg=str(col),
        )


@needs_ref
def test_saa_presets_are_inert_for_samples():
    """The v1.2.2 presets never reach the SAA *samples* (the only thing
    ``run_mpc_on_group`` consumes): pv samples come from the
    preset-independent parabolic NPV baseline, and the preset pv-push args
    only alter the initial pv *forecast* frame, which SAA runs never read
    (reference ``DataGenerator.py:932-935``).  Under a fixed seed all three
    presets produce bit-identical samples — the evidence behind
    collapsing SAA-85/70/50 into one column."""
    import_reference()
    from pymgrid.algos.saa.saa import SampleAverageApproximation as RefSAA

    rm, _ = _matched_nonmodular(seed=42)

    frames = []
    for preset in (85, 70, 50):
        np.random.seed(31)
        saa = RefSAA(rm, preset_to_use=preset)
        samples = saa.sample_from_forecasts(n_samples=2)
        frames.append((saa.forecasts.copy(), [s.copy() for s in samples]))

    f85, s85 = frames[0]
    for forecasts, samples in frames[1:]:
        # the preset's pv-push args DO alter the initial pv forecast...
        assert not np.array_equal(f85["pv"].values, forecasts["pv"].values)
        # ...but load/grid forecasts (the sample baselines) are untouched...
        np.testing.assert_array_equal(f85["load"].values, forecasts["load"].values)
        np.testing.assert_array_equal(f85["grid"].values, forecasts["grid"].values)
        # ...so every sample is bit-identical across presets.
        for a, b in zip(s85, samples):
            pd.testing.assert_frame_equal(a, b, check_exact=True)
