"""The port's CLIs (design_1d, analysis_1d, design_1d_baseline, train_1d's
baseline method types) on snapshots written by the JAX package."""

import json

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


# ---------------------------------------------------------------------------
# analysis_1d

# the record analysis_1d prints, cindm_tpu/cli/analysis_1d.py:141-325
ANALYSIS_KEYS = {"sample_mae", "sample_rmse", "compose_strategies", "multibody_strategies"}
COMPOSE_KEYS = {"EBMs_compose", "autoregress", "SimuSolver", "direct"}
MULTIBODY_KEYS = {"pairwise_compose", "cf_compose_ULA", "cf_compose_UHMC", "SimuSolver"}


def _jax_snapshot(directory, model, *init_args):
    """Random weights of a JAX model saved by cindm_tpu.utils.persist.save_npz."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *init_args)
    rng = np.random.default_rng(len(str(directory)))
    params = jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    directory.mkdir(parents=True, exist_ok=True)
    save_npz({"params": params, "ema_params": params, "step": np.int32(2)},
             str(directory / "persisted_m2.npz"), ema_only=True, dtype="bfloat16")
    return str(directory)


@pytest.fixture(scope="module")
def analysis_dirs(tmp_path_factory):
    """Snapshots of a conditioned 2-body prior (1 + 7 frames), a 1-body
    prior and a direct model at 1 + 3 x 7 frames, all dim 8."""
    d = tmp_path_factory.mktemp("analysis")
    t = jnp.zeros(1, jnp.int32)
    return {
        "pair": _jax_snapshot(d / "pair", JaxUnet(horizon=8, transition_dim=8, dim=8),
                              jnp.zeros((1, 8, 8)), t),
        "uncond": _jax_snapshot(d / "uncond", JaxUnet(horizon=8, transition_dim=4, dim=8),
                                jnp.zeros((1, 8, 4)), t),
        "direct": _jax_snapshot(d / "direct", JaxUnet(horizon=22, transition_dim=8, dim=8),
                                jnp.zeros((1, 22, 8)), t),
    }


@pytest.fixture
def shared_trajectories(monkeypatch):
    """Both packages' datasets simulate nothing and read the same
    trajectories: those of the port's simulator for (n_sims, n_bodies)."""
    import cindm_tpu.data.nbody as jax_nbody
    import cindm_tpu_torch.data.nbody as port_nbody

    cache = {}
    real = port_nbody.generate_trajectories

    def fake(_rng, n_sims, n_bodies, n_steps=1000, v_max=100.0, **_):
        if (n_sims, n_bodies) not in cache:
            cache[n_sims, n_bodies] = real(torch.Generator().manual_seed(n_bodies), n_sims,
                                           n_bodies, n_steps, v_max)
        return cache[n_sims, n_bodies]

    monkeypatch.setattr(jax_nbody, "generate_trajectories", fake)
    monkeypatch.setattr(port_nbody, "generate_trajectories", fake)


def _analysis_argv(dirs):
    return ["--model_path", dirs["pair"], "--uncond_model_path", dirs["uncond"],
            "--direct_model_path", dirs["direct"], "--Unet_dim", "8",
            "--conditioned_steps", "1", "--rollout_steps", "7", "--n_composed", "2",
            "--compose_multibodies", "3", "--timesteps", "6", "--sample_steps", "3",
            "--t_switch", "2", "--langevin_steps", "2", "--batch_size", "2", "--n_sims", "2"]


def _stub_jax_samplers(monkeypatch):
    """Zeros in place of the JAX CLI's learned samplers, and its template
    model's init under one jit instead of op by op (the snapshot replaces the
    values): as they are, these take over a minute on the CPU, and the
    simulator's scores read neither."""
    from flax import linen as nn

    import cindm_tpu.sampling as jsampling
    import cindm_tpu.sampling.compose_time as jct
    import cindm_tpu.train as jtrain

    monkeypatch.setattr(JaxUnet, "init",
                        lambda self, *a: jax.jit(lambda *b: nn.Module.init(self, *b))(*a))

    monkeypatch.setattr(jtrain, "sampling_eval_1d",
                        lambda *a, **k: {"sample_mae": 0.0, "sample_rmse": 0.0})
    monkeypatch.setattr(jct, "composing_time_sample",
                        lambda sched, eps, B, R, cs, F, cond, key, n_composed, **k: (
                            jnp.zeros((B, R, F)), jnp.zeros((B, n_composed * R, F))))
    monkeypatch.setattr(jct, "autoregress_time_compose_sample",
                        lambda sched, eps, B, R, cs, F, cond, key, n_composed, **k:
                        jnp.zeros((B, (n_composed + 1) * R, F)))
    monkeypatch.setattr(jsampling, "sample",
                        lambda cfg, sched, eps, key, B, F, **k: jnp.zeros((B, cfg.rollout_steps, F)))


def test_analysis_1d_matches_the_jax_cli(analysis_dirs, shared_trajectories, tmp_path, monkeypatch):
    """Every strategy of both blocks on the CPU: the JAX CLI's keys, finite
    values, and the simulator's scores equal to the JAX CLI's on the same
    trajectories."""
    from cindm_tpu.cli.analysis_1d import main as jax_analysis
    from cindm_tpu_torch.cli.analysis_1d import main as port_analysis

    out = tmp_path / "rec.json"
    timings = {}
    argv = _analysis_argv(analysis_dirs)
    got = port_analysis([*argv, "--device", "cpu", "--out", str(out)], timings=timings)
    # the JAX CLI without the 1-body and direct priors (the strategies they
    # add) and with its learned samplers stubbed: its simulator scores stay
    _stub_jax_samplers(monkeypatch)
    want = jax_analysis(argv[:2] + argv[6:])
    assert set(got) == set(want) == ANALYSIS_KEYS
    assert set(got["compose_strategies"]) == set(want["compose_strategies"]) | {"direct"} == COMPOSE_KEYS
    assert (set(got["multibody_strategies"])
            == set(want["multibody_strategies"]) | {"cf_compose_ULA", "cf_compose_UHMC"}
            == MULTIBODY_KEYS)
    assert json.loads(out.read_text()) == got
    assert {"cf_compose_ULA", "direct"} <= set(timings)
    for block in ("compose_strategies", "multibody_strategies"):
        for scores in got[block].values():
            assert set(scores) == {"mae", "rmse"} and all(np.isfinite(v) for v in scores.values())
        for k in ("mae", "rmse"):
            np.testing.assert_allclose(got[block]["SimuSolver"][k], want[block]["SimuSolver"][k],
                                       rtol=1e-5, atol=1e-5)


def test_analysis_1d_flags_match_jax_cli():
    from cindm_tpu.cli.analysis_1d import build_parser as jax_parser
    from cindm_tpu_torch.cli.analysis_1d import build_parser as port_parser

    jax_flags = {a.dest for a in jax_parser()._actions}
    port_flags = {a.dest for a in port_parser()._actions}
    assert port_flags - jax_flags == {"device"} and jax_flags <= port_flags


def test_analysis_1d_refuses_absent_cuda(analysis_dirs, monkeypatch):
    from cindm_tpu_torch.cli.analysis_1d import main as port_analysis

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_analysis(["--model_path", analysis_dirs["pair"]])


# ---------------------------------------------------------------------------
# train_1d's baseline method types, then design_1d_baseline on what they wrote

TRAIN_BASE = ["--Unet_dim", "8", "--batch_size", "2", "--n_sims", "2", "--rollout_steps", "24",
              "--train_num_steps", "2", "--save_and_sample_every", "1", "--log_every", "1",
              "--gradient_accumulate_every", "1", "--device", "cpu"]
DESIGN_MODELS = {"Unet": "forward_model", "Unet_single_step": "Unet_rollout_one",
                 "GNS_autoregress": "GNS_cond_one", "GNS_direct": "GNS_direct"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of each baseline method type, on the same generated data."""
    from cindm_tpu_torch.cli.train_1d import main as train_main

    d = tmp_path_factory.mktemp("baselines")
    out = {}
    for mt in ("forward_model", "Unet_rollout_one", "GNS", "GNS_cond_one", "GNS_direct"):
        state = train_main([*TRAIN_BASE, "--method_type", mt, "--dataset_path", str(d / "data"),
                            "--results_folder", str(d / mt)])
        out[mt] = (str(d / mt), state)
    return out


@pytest.mark.parametrize("method_type", ["forward_model", "Unet_rollout_one", "GNS",
                                         "GNS_cond_one", "GNS_direct"])
def test_train_1d_baseline_method_types(trained, method_type):
    import os

    path, state = trained[method_type]
    assert state.step == 2
    with open(os.path.join(path, "train_records.jsonl")) as f:
        rec = json.loads(f.readlines()[-1])
    assert rec["step"] == 2 and np.isfinite(rec["loss"])
    assert os.path.exists(os.path.join(path, "persisted_m2.npz"))
    assert sorted(os.listdir(path)).count("model-2.pt") == 1


@pytest.mark.parametrize("design_method", ["backprop", "CEM"])
@pytest.mark.parametrize("method_type", list(DESIGN_MODELS))
def test_design_1d_baseline_loads_what_train_1d_wrote(trained, design_method, method_type):
    from cindm_tpu_torch.cli.design_1d_baseline import main as design_main

    timings = {}
    record = design_main(["--design_method", design_method, "--method_type", method_type,
                          "--model_path", trained[DESIGN_MODELS[method_type]][0],
                          "--Unet_dim", "8", "--max_design_steps", "2", "--N", "16", "--Ne", "4",
                          "--device", "cpu"], timings=timings)
    # the record design_1d_baseline prints, cindm_tpu/cli/design_1d_baseline.py:171-176
    assert set(record) == {"design_method", "method_type", "design_obj_simu", "loaded_milestone"}
    assert np.isfinite(record["design_obj_simu"]) and record["loaded_milestone"] == 2
    assert set(timings) == {"load", "design", "eval"} and all(v >= 0 for v in timings.values())


@pytest.mark.parametrize("method_type", ["Unet", "GNS_direct"])
def test_design_1d_baseline_runs_on_jax_snapshots(tmp_path, method_type):
    """Weights saved by the JAX package for each surrogate load into the port."""
    from cindm_tpu.baselines import GNSConfig as JaxGNSConfig
    from cindm_tpu.baselines import GNSNet as JaxGNSNet
    from cindm_tpu.baselines import Unet1DForwardModel as JaxForward
    from cindm_tpu_torch.cli.design_1d_baseline import main as design_main

    if method_type == "Unet":
        path = _jax_snapshot(tmp_path / "m", JaxForward(horizon=24, transition_dim=8, dim=8),
                             jnp.zeros((1, 1, 8)))
    else:
        path = _jax_snapshot(tmp_path / "m", JaxGNSNet(JaxGNSConfig(n_his=2, out_size=46)),
                             jnp.zeros((1, 2, 2, 2)), jnp.zeros((1, 2), jnp.int32))
    for method in ("CEM", "backprop"):
        record = design_main(["--design_method", method, "--method_type", method_type,
                              "--model_path", path, "--Unet_dim", "8", "--max_design_steps", "1",
                              "--N", "8", "--Ne", "2", "--device", "cpu"])
        assert np.isfinite(record["design_obj_simu"]) and record["loaded_milestone"] == 2


def test_design_1d_baseline_flags_match_jax_cli():
    from cindm_tpu.cli.design_1d_baseline import build_parser as jax_parser
    from cindm_tpu_torch.cli.design_1d_baseline import build_parser as port_parser

    jax_flags = {a.dest for a in jax_parser()._actions}
    port_flags = {a.dest for a in port_parser()._actions}
    assert port_flags - jax_flags == {"device"} and jax_flags <= port_flags


def test_design_1d_baseline_missing_checkpoint_fails_loudly(tmp_path, capsys):
    from cindm_tpu_torch.cli.design_1d_baseline import main as design_main

    argv = ["--model_path", str(tmp_path / "typo"), "--Unet_dim", "8", "--max_design_steps", "1",
            "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="allow_random_init"):
        design_main(argv)
    assert not (tmp_path / "typo").exists()
    record = design_main(argv + ["--allow_random_init", "True"])
    assert record["loaded_milestone"] is None and np.isfinite(record["design_obj_simu"])


def test_train_1d_accepts_every_method_type():
    from cindm_tpu.cli.train_1d import METHOD_TYPES as JAX_METHODS
    from cindm_tpu_torch.cli.train_1d import METHOD_TYPES, build_parser as port_parser

    assert METHOD_TYPES == JAX_METHODS
    for mt in METHOD_TYPES:
        assert port_parser().parse_args(["--method_type", mt]).method_type == mt
