"""The port's design_1d CLI on a snapshot written by the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.models import TemporalUnet1D as JaxUnet
from cindm_tpu.utils.persist import save_npz
from cindm_tpu_torch.cli.design_1d import build_parser, main

# the record design_1d prints, cindm_tpu/cli/design_1d.py:164-175
JAX_RECORD_KEYS = {
    "design_obj", "design_obj_ci95", "MAE", "RMSE", "batch_size", "design_guidance",
    "n_composed", "compose_n_bodies", "normalize_grad_per_body",
}


@pytest.fixture(scope="module")
def snapshot_dir(tmp_path_factory):
    """A dim-16 2-body model's state saved by cindm_tpu.utils.persist.save_npz."""
    jm = JaxUnet(horizon=24, transition_dim=8, dim=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 24, 8)),
                            jnp.zeros(1, jnp.int32))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    d = tmp_path_factory.mktemp("snap")
    save_npz({"params": params, "ema_params": params, "step": np.int32(4)},
             str(d / "persisted_m4.npz"), ema_only=True, dtype="bfloat16")
    return d


BASE = ["--Unet_dim", "16", "--batch_size", "2", "--timesteps", "4", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["--compose_n_bodies", "3", "--design_guidance", "standard-recurrence-2"],
    ["--compose_n_bodies", "3", "--n_composed", "1", "--compose_mode", "mean",
     "--normalize_grad_per_body", "--design_guidance", "universal-backward"],
    ["--design_guidance", "standard", "--sample_steps", "2"],
])
def test_design_1d_runs_on_jax_snapshot(snapshot_dir, extra, capsys):
    record = main(["--model_path", str(snapshot_dir), *BASE, *extra])
    assert set(record) == JAX_RECORD_KEYS
    for k in ("design_obj", "design_obj_ci95", "MAE", "RMSE"):
        assert np.isfinite(record[k]), (k, record)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"design_obj"')


def test_design_1d_flags_match_jax_cli():
    from cindm_tpu.cli.design_1d import build_parser as jax_parser

    jax_flags = {a.dest for a in jax_parser()._actions}
    port_flags = {a.dest for a in build_parser()._actions}
    assert port_flags - jax_flags == {"device"}
    assert jax_flags <= port_flags


def test_design_1d_refuses_absent_cuda(snapshot_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model_path", str(snapshot_dir), *BASE[:-2], "--device", "cuda"])


def test_design_1d_refuses_multi_device(snapshot_dir):
    with pytest.raises(SystemExit, match="n_devices"):
        main(["--model_path", str(snapshot_dir), *BASE, "--n_devices", "2"])


def test_design_1d_missing_snapshot_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="persisted"):
        main(["--model_path", str(tmp_path), *BASE])
