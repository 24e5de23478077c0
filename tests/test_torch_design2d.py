"""The port's 2D design path against the JAX package: the boundary
post-processing (cindm_tpu_torch.utils.boundary), the airfoil geometry
helpers, the 2D metrics (utils.eval2d; its closed-loop scoring is held in
test_torch_bdim.py, beside the solver), and the design_2d CLI on the CPU
with the in-tree snapshots (its flags, its record's keys, its refusals).
Geometry and metrics are held exactly or to 1e-6."""

import json
import os

import numpy as np
import pytest
import torch

from cindm_tpu.cli import design_2d as jcli
from cindm_tpu.data import airfoil as jair
from cindm_tpu.utils import boundary as jbd
from cindm_tpu.utils import eval2d as jev
from cindm_tpu_torch.cli import design_2d as tcli
from cindm_tpu_torch.data import airfoil as tair
from cindm_tpu_torch.utils import boundary as tbd
from cindm_tpu_torch.utils import eval2d as tev

REPO = os.path.join(os.path.dirname(__file__), "..")
AIRFOIL = os.path.join(REPO, "results", "airfoil_v3")
FORCE = os.path.join(REPO, "results", "force_v3")


def _airfoil_masks(seed, n=3):
    """n rasterized airfoils (mask, offset) from the port's helpers, plus stray cells."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask, off = tair.boundary_mask_offset(tair.boundary_coords(tair.sample_boundary_params(rng)))
        mask[rng.integers(0, 62, 3), rng.integers(0, 62, 3)] = 1.0
        out.append((mask, off))
    return out


def test_airfoil_geometry_matches():
    for seed in range(6):
        pt, pj = (m.sample_boundary_params(np.random.default_rng(seed), 64, (0.2, 0.5), (0.3, 0.7))
                  for m in (tair, jair))
        assert pt == pj
        ct, cj = tair.boundary_coords(pt), jair.boundary_coords(pj)
        np.testing.assert_array_equal(ct, cj)
        for a, b in zip(tair.boundary_mask_offset(ct), jair.boundary_mask_offset(cj)):
            np.testing.assert_array_equal(a, b)
    assert tair.AirfoilDatasetConfig().__dict__ == jair.AirfoilDatasetConfig().__dict__


@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_reconstruction_matches(seed):
    pairs = _airfoil_masks(seed)
    for mask, off in pairs:
        np.testing.assert_array_equal(tbd.filter_isolated_points(mask), jbd.filter_isolated_points(mask))
        lt, lj = tbd.find_clusters(mask), jbd.find_clusters(mask)
        np.testing.assert_array_equal(lt, lj)
        for c in range(1, lt.max() + 1):
            np.testing.assert_array_equal(tbd.find_cluster_boundary(lt, c), jbd.find_cluster_boundary(lj, c))
        pts = tbd.find_cluster_boundary(lt, 1)
        np.testing.assert_array_equal(tbd.order_boundary_points(pts), jbd.order_boundary_points(pts))
        rt, rj = tbd.reconstruct_boundary(mask, off), jbd.reconstruct_boundary(mask, off)
        assert len(rt) == len(rj)
        for a, b in zip(rt, rj):
            np.testing.assert_array_equal(a, b)
    stack = np.stack([m for m, _ in pairs])
    assert tbd.polygons_overlap(stack) == jbd.polygons_overlap(stack)
    assert tbd.polygons_overlap(stack[:1]) is False


def test_metrics_match():
    rng = np.random.default_rng(3)
    forces = rng.uniform(-2, 2, (4, 5, 3, 2)).astype(np.float32)
    bounds = rng.uniform(0, 60, (4, 3, 40, 2)).astype(np.float32)
    np.testing.assert_allclose(tev.metric_batch(forces, 0.7), jev.metric_batch(forces, 0.7), rtol=1e-6)
    for frac in (False, True):
        np.testing.assert_allclose(tev.metric(forces[..., 1], forces[..., 0], 0.7, frac),
                                   np.asarray(jev.metric(forces[..., 1], forces[..., 0], 0.7, frac)),
                                   rtol=1e-6)
    np.testing.assert_array_equal(tev.chord_lengths(bounds), jev.chord_lengths(bounds))
    for a, b in zip(tev.force_coefficients(forces, bounds, 1.3),
                    jev.force_coefficients(forces, bounds, 1.3)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_region_bands_match():
    for nb, lo, hi in ((1, 0.0, 1.0), (3, 0.2, 0.8), (2, 0.3, 0.7)):
        np.testing.assert_array_equal(tcli.make_region_bands(64, 64, nb, lo, hi).numpy(),
                                      np.asarray(jcli.make_region_bands(64, 64, nb, lo, hi)))


def test_cli_flags_are_the_jax_flags_plus_device():
    opts = lambda p: {o for a in p._actions for o in a.option_strings}
    assert opts(tcli.build_parser()) == opts(jcli.build_parser()) | {"--device"}
    t_defaults = vars(tcli.build_parser().parse_args([]))
    assert t_defaults.pop("device") == "cuda"
    assert t_defaults == vars(jcli.build_parser().parse_args([]))


# the final record's keys: the JAX CLI's record, plus evaluate_designs'
# scalar scores when at least one design is valid (cindm_tpu/cli/design_2d.py)
RECORD_KEYS = {"valid_designs", "batch_size", "num_boundaries", "lambda_overlap",
               "lambda_separation", "init_sep", "station_until", "region_partition", "ddim_steps"}
SCORE_KEYS = {"drag_min", "lift_max", "obj_min", "lift_over_drag_max", "cd_min", "cl_max"}


@pytest.mark.parametrize("extra", [
    ["--num_boundaries", "2", "--region_partition", "y", "--region_band", "0.2", "0.8",
     "--station_until", "2", "--init_sep", "0.5"],
    ["--ddim_steps", "2", "--num_boundaries", "2", "--lambda_separation", "1.0"],
], ids=["ancestral", "ddim"])
def test_cli_runs_on_cpu(extra, tmp_path, capsys):
    timings = {}
    raw = tmp_path / "raw.npy"
    record = tcli.main(["--model_path", AIRFOIL, "--force_model_path", FORCE, "--timesteps", "4",
                        "--batch_size", "1", "--n_warmup", "3", "--n_record", "2", "--device", "cpu",
                        "--dump_raw", str(raw), *extra], timings=timings)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    keys = RECORD_KEYS | (SCORE_KEYS if record["valid_designs"] else set())
    assert set(record) == keys
    assert all(np.isfinite(v) for v in record.values() if not isinstance(v, str))
    assert set(timings) == {"sampling", "postprocess", "scoring"}
    out = np.load(raw)
    assert out.shape == (1, 2, 64, 64, 21) and np.isfinite(out).all()
    if "--region_partition" in extra:
        bands = tcli.make_region_bands(64, 64, 2, 0.2, 0.8).numpy()
        assert (out[0, :, :, :, -3][bands == 0] == 0).all()


def test_cli_runs_in_fp32():
    """The CLI fixes its own precision: TF32 is off for matmuls and cuDNN
    after ``main`` returns, however the process had set it."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tcli.main(["--model_path", AIRFOIL, "--timesteps", "2", "--batch_size", "1",
                   "--evaluate", "False", "--device", "cpu"])
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_cli_refusals(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(["--n_devices", "1", "--device", "cpu", "--model_path", AIRFOIL])
    with pytest.raises(FileNotFoundError):
        tcli.main(["--model_path", str(tmp_path), "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        tcli.main(["--model_path", AIRFOIL, "--milestone", "7", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(["--model_path", AIRFOIL])
