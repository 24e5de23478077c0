"""The port's 2D training and 2D baseline CLIs end to end on the CPU at tiny
sizes: train_2d (and its resume), train_force, what they write loaded by
design_2d, train_baseline for FNO and LE-PDE, and design_2d_baseline for GD
and CEM at 1 and 2 boundaries. Their flags are the JAX CLIs' plus
``--device``, and each raises without a card unless the CPU is asked for.

The simulations come from a cache written here (random fields on real
boundary geometry), so no test runs the flow solver; both packages read
that cache layout."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from cindm_tpu_torch.data.airfoil import (CACHE_KEYS, boundary_coords, boundary_mask_offset,
                                          sample_boundary_params)

CLIS = ["train_2d", "train_force", "train_baseline", "design_2d_baseline"]
# the record design_2d_baseline prints, cindm_tpu/cli/design_2d_baseline.py:227-268
# (evaluate_designs' scalar scores join it when a design is valid)
D2B_KEYS = {"GD": {"design_method", "surrogate", "obj_first", "obj_last", "valid_designs",
                   "batch_size", "num_boundaries"},
            "CEM": {"design_method", "surrogate", "obj_last", "valid_designs", "batch_size",
                    "num_boundaries"}}
SCORE_KEYS = {"drag_min", "lift_max", "obj_min", "lift_over_drag_max", "cd_min", "cl_max"}


def write_cache(directory, n_sims=2, T=40, seed=0):
    """A simulation cache: fields and forces random, boundaries sampled as
    the generator samples them (so masks reconstruct to one polygon)."""
    rng = np.random.default_rng(seed)
    coords = [boundary_coords(sample_boundary_params(rng)).astype(np.float32) for _ in range(n_sims)]
    mo = [boundary_mask_offset(c) for c in coords]
    data = {
        "fields": rng.uniform(-1, 1, (n_sims, T, 62, 62, 3)).astype(np.float32),
        "boundary": np.stack(coords),
        "mask": np.stack([m for m, _ in mo]),
        "offset": np.stack([o for _, o in mo]),
        "forces": rng.standard_normal((n_sims, T, 1, 2)).astype(np.float32),
    }
    os.makedirs(directory, exist_ok=True)
    for k in CACHE_KEYS:
        np.save(os.path.join(directory, f"{k}.npy"), data[k])
    return str(directory)


@pytest.mark.parametrize("name", CLIS)
def test_flags_match_jax_cli(name):
    jax_parser = importlib.import_module(f"cindm_tpu.cli.{name}").build_parser()
    port_parser = importlib.import_module(f"cindm_tpu_torch.cli.{name}").build_parser()
    jax_flags = {a.dest: a.default for a in jax_parser._actions}
    port_flags = {a.dest: a.default for a in port_parser._actions}
    assert set(port_flags) - set(jax_flags) == {"device"}
    assert {k: v for k, v in port_flags.items() if k != "device"} == jax_flags
    assert port_flags["device"] == "cuda"


@pytest.mark.parametrize("name", CLIS)
def test_needs_the_card_unless_cpu_is_asked_for(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    main = importlib.import_module(f"cindm_tpu_torch.cli.{name}").main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--results_folder", str(tmp_path)] if name != "design_2d_baseline" else [])


@pytest.mark.parametrize("name", ["train_2d", "train_baseline"])
def test_multi_gpu_raises(name):
    main = importlib.import_module(f"cindm_tpu_torch.cli.{name}").main
    with pytest.raises(SystemExit, match="multi-GPU"):
        main(["--n_devices", "2", "--device", "cpu"])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the CLIs run many small convolutions, which slow
    down many times over when the tier-1 run's parallel workers each give
    torch a thread per core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def narrow_models():
    """The CLIs build the repo's full-width 2D models (Unet2D and ForceUnet
    at dim 64); here they get dim 8, so that the CPU runs every code path in
    seconds."""
    from cindm_tpu_torch import models

    unet, force = models.Unet2D, models.ForceUnet
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(models, "Unet2D", lambda **kw: unet(**{**kw, "dim": 8}))
        mp.setattr(models, "ForceUnet", lambda **kw: force(**{**kw, "dim": 8, "dim_mults": (1, 2)}))
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_2d (2 steps, then a resume with remat to 3), train_force, and
    train_baseline for both surrogates, all on one cache."""
    from cindm_tpu_torch.cli import train_2d, train_baseline, train_force

    root = tmp_path_factory.mktemp("cli2d")
    cache = write_cache(root / "data")
    out = {"root": root, "cache": cache, "printed": {}}
    common = ["--n_sims", "2", "--device", "cpu", "--data_cache", cache]
    prior = str(root / "airfoil")
    for extra in (["--train_num_steps", "2", "--device_data", "True"],
                  ["--train_num_steps", "3", "--resume", "True", "--remat", "True",
                   "--device_data", "False"]):
        out.setdefault("train_2d", []).append(train_2d.main(
            [*common, "--batch_size", "2", "--timesteps", "10", "--save_and_sample_every", "2",
             "--results_folder", prior, *extra]))
    out["train_force"] = train_force.main([*common, "--batch_size", "2", "--train_num_steps", "2",
                                           "--results_folder", str(root / "force")])
    for algo in ("fno", "lepde"):
        out[algo] = train_baseline.main([*common, "--algo", algo, "--batch_size", "2",
                                         "--epochs", "2", "--steps_per_epoch", "2",
                                         "--multi_step", "1^2:0.1", "--multi_step_start_epoch", "1",
                                         "--data_noise_amp", "0.01", "--lr_scheduler_type", "cos",
                                         "--weight_decay", "0.01",
                                         "--results_folder", str(root / algo)])
    return out


def test_train_2d_trains_and_resumes(trained):
    first, second = trained["train_2d"]
    folder = trained["root"] / "airfoil"
    assert first.step == 2 and second.step == 3
    assert sorted(os.listdir(folder)) == ["model-2.pt", "persisted_m2.npz", "persisted_m3.npz",
                                          "train_records.jsonl"]
    with open(folder / "train_records.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [(r["start_step"], r["step"], r["remat"]) for r in recs] == [(0, 2, False), (2, 3, True)]
    assert all(np.isfinite(r["loss"]) for r in recs) and recs[0]["batch_size"] == 2
    assert os.path.exists(os.path.join(trained["cache"], "flatrows_v1.npy"))


def test_train_force_writes_what_design_2d_loads(trained, capsys):
    from cindm_tpu_torch.cli import design_2d

    root = trained["root"]
    assert {"model-1.pt", "persisted_m1.npz"} <= set(os.listdir(root / "force"))
    assert trained["train_force"].step == 2
    record = design_2d.main(["--model_path", str(root / "airfoil"), "--force_model_path",
                             str(root / "force"), "--timesteps", "2", "--batch_size", "1",
                             "--n_warmup", "2", "--n_record", "1", "--device", "cpu"])
    assert {"valid_designs", "batch_size", "num_boundaries"} <= set(record)
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(record)


@pytest.mark.parametrize("algo", ["fno", "lepde"])
def test_train_baseline_record(trained, algo):
    from cindm_tpu.baselines.harness import experiment_record as jax_record

    folder = trained["root"] / algo
    files = sorted(os.listdir(folder))
    assert files[:2] == ["model-1.pt", "model-2.pt"] and files[2].startswith("record_")
    with open(folder / files[2]) as f:
        record = json.load(f)
    with open(jax_record(str(trained["root"] / "jax_rec"), {"a": 1}, [], {})) as f:
        assert set(record) == set(json.load(f))
    assert [h["epoch"] for h in record["history"]] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in record["history"])
    assert record["args"]["algo"] == algo and trained[algo].step == 4


@pytest.mark.parametrize("method,surrogate,k", [("GD", "fno", 1), ("GD", "lepde", 2),
                                                 ("CEM", "lepde", 1), ("CEM", "fno", 2)])
def test_design_2d_baseline_record(trained, method, surrogate, k, capsys):
    from cindm_tpu_torch.cli import design_2d_baseline

    root = trained["root"]
    timings = {}
    record = design_2d_baseline.main(
        ["--design_method", method, "--surrogate", surrogate, "--num_boundaries", str(k),
         "--surrogate_path", str(root / surrogate), "--force_model_path", str(root / "force"),
         "--data_dir", write_cache(root / f"d2b_{method}_{k}", n_sims=2, T=10, seed=k),
         "--optim_iter", "2", "--N", "4", "--Ne", "2", "--rollout", "2", "--is_testdata", "True",
         "--n_warmup", "2", "--n_record", "1", "--device", "cpu"], timings=timings)
    keys = D2B_KEYS[method] | (SCORE_KEYS if record["valid_designs"] else set())
    assert set(record) == keys
    assert all(np.isfinite(v) for v in record.values() if not isinstance(v, str))
    assert record["num_boundaries"] == k and record["batch_size"] == 2
    assert set(timings) == {"design", "scoring"}
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(record)


@pytest.mark.parametrize("name,snapshot", [("Unet2D", "airfoil/persisted_m3.npz"),
                                           ("ForceUnet", "force/persisted_m1.npz")])
def test_snapshots_have_the_jax_layout(trained, name, snapshot):
    """What train_2d and train_force write is the JAX package's parameter
    tree of the same model (names and shapes), so either package loads it."""
    import jax
    import jax.numpy as jnp

    from cindm_tpu.models import unet2d as ju
    from cindm_tpu_torch.utils.persist import load_flax_npz, select_subtree

    if name == "Unet2D":  # at the narrowed width
        jm = ju.Unet2D(dim=8, dim_mults=(1, 2), channels=21)
        args = (jnp.zeros((1, 64, 64, 21)), jnp.zeros((1,), jnp.int32))
    else:
        jm = ju.ForceUnet(dim=8, dim_mults=(1, 2))
        args = (jnp.zeros((1, 64, 64, 4)),)
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"])[0]
    want = {jax.tree_util.keystr(path): tuple(s.shape) for path, s in leaves}
    got = select_subtree(select_subtree(load_flax_npz(str(trained["root"] / snapshot)),
                                        "ema_params"), "params")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
