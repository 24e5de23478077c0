"""The port's 1D training slice against the JAX package: loss weights and
losses, the optimizer and EMA against optax, a few steps of the whole train
step on one shared data cache, checkpoints in both directions, and the
train_1d CLI end to end on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch import nn

from cindm_tpu.core import diffusion as jdd
from cindm_tpu.core import make_schedule as jax_make_schedule
from cindm_tpu.core import schedules as jsch
from cindm_tpu.data.nbody import NBodyDataset as JaxDataset
from cindm_tpu.data.nbody import NBodyDatasetConfig as JaxDataConfig
from cindm_tpu.models import TemporalUnet1D as JaxUnet
from cindm_tpu.sampling.diffusion1d import Diffusion1DConfig as JaxConfig
from cindm_tpu.train import checkpoint as jckpt
from cindm_tpu.train.trainer import TrainConfig as JaxTrainConfig
from cindm_tpu.train.trainer import init_train_state as jax_init_train_state
from cindm_tpu.train.trainer import make_optimizer as jax_make_optimizer
from cindm_tpu.train.trainer import make_train_step as jax_make_train_step
from cindm_tpu.train.trainer import make_train_step_from_loss as jax_make_train_step_from_loss
from cindm_tpu.train.trainer import reference_lr_schedule as jax_lr_schedule
from cindm_tpu.utils import extras as jextras
from cindm_tpu.utils import persist as jpersist
from cindm_tpu_torch.cli import design_1d, train_1d
from cindm_tpu_torch.core import diffusion as dd
from cindm_tpu_torch.core import make_schedule, min_snr_loss_weight, snr_loss_weight
from cindm_tpu_torch.data import NBodyDataset, NBodyDatasetConfig
from cindm_tpu_torch.models import flax_from_params
from cindm_tpu_torch.sampling import Diffusion1DConfig
from cindm_tpu_torch.train import (
    CheckpointManager,
    TrainConfig,
    init_train_state,
    make_train_step,
    make_train_step_from_loss,
    reference_lr_schedule,
)
from cindm_tpu_torch.utils.extras import custom_l1_speed_loss
from cindm_tpu_torch.utils.persist import f32_to_bf16_bits, save_npz
from torch_port_helpers import flax_params, keystr_flat, port_model, write_traj_cache

OBJECTIVES = ["pred_noise", "pred_x0", "pred_v"]


# -- losses and weights --------------------------------------------------------


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_snr_weights_match_jax(objective):
    js, ts = jax_make_schedule(100, "cosine"), make_schedule(100, device="cpu")
    np.testing.assert_allclose(snr_loss_weight(ts, objective).numpy(),
                               np.asarray(jsch.snr_loss_weight(js, objective)), rtol=1e-6)
    np.testing.assert_allclose(min_snr_loss_weight(ts, objective, 3.0).numpy(),
                               np.asarray(jsch.min_snr_loss_weight(js, objective, 3.0)), rtol=1e-6)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("cond_steps", [0, 2])
def test_diffusion_loss_matches_jax(objective, loss_type, cond_steps):
    rng = np.random.default_rng(len(objective) + cond_steps)
    T, F = cond_steps + 6, 8
    out, x0, noise = (rng.standard_normal((3, T, F)).astype(np.float32) for _ in range(3))
    t = np.array([0, 40, 99])
    want_w = jdd.rollout_loss_weight(cond_steps, 6, F, 0.9)
    got_w = dd.rollout_loss_weight(cond_steps, 6, F, 0.9)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)
    want = jdd.diffusion_loss(jax_make_schedule(100), out, x0, noise, jnp.asarray(t),
                              objective=objective, loss_type=loss_type, loss_weight=want_w)
    got = dd.diffusion_loss(make_schedule(100, device="cpu"), *map(torch.from_numpy, (out, x0, noise)),
                            torch.from_numpy(t), objective=objective, loss_type=loss_type,
                            loss_weight=got_w)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_custom_l1_speed_loss_matches_jax():
    rng = np.random.default_rng(0)
    p, t = (rng.standard_normal((2, 5, 12)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(custom_l1_speed_loss(torch.from_numpy(p), torch.from_numpy(t))),
                               float(jextras.custom_l1_speed_loss(p, t)), rtol=1e-6)


def test_lr_schedule_matches_jax():
    cfg = dict(lr_decay_start=100, lr_decay_every=40)
    mine, theirs = reference_lr_schedule(TrainConfig(**cfg)), jax_lr_schedule(JaxTrainConfig(**cfg))
    for c in (0, 99, 100, 139, 140, 179, 180, 1000):
        np.testing.assert_allclose(mine(c), float(theirs(c)), rtol=1e-6)


# -- the optimizer and EMA against optax --------------------------------------


class _Tree(nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a, self.b = nn.Parameter(torch.from_numpy(a.copy())), nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_and_ema_match_optax(accum):
    """250 optimizer steps on synthetic gradients (loss = <params, g>, so the
    gradient is g): global-norm clipping on about half of them, the EMA's
    copy phase, its decay ramp and three StepLR halvings are all crossed."""
    kw = dict(lr=1e-2, lr_decay_start=100, lr_decay_every=40, gradient_accumulate_every=accum)
    rng = np.random.default_rng(accum)
    a0, b0 = rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)

    jloss = lambda p, g, key: jnp.sum(p["a"] * g["a"]) + jnp.sum(p["b"] * g["b"])
    jcfg = JaxTrainConfig(**kw)
    jstep = jax_make_train_step_from_loss(jloss, jcfg)
    jstate = jax_init_train_state({"a": jnp.asarray(a0), "b": jnp.asarray(b0)}, jax_make_optimizer(jcfg))

    tstate = init_train_state(_Tree(a0, b0), TrainConfig(**kw))
    tstep = make_train_step_from_loss(
        lambda m, g: (m.a * g["a"]).sum() + (m.b * g["b"]).sum(), TrainConfig(**kw))
    for i in range(250 * accum):
        scale = 10.0 ** rng.uniform(-1.5, 0.5)
        g = {"a": (scale * rng.standard_normal((3, 4))).astype(np.float32),
             "b": (scale * rng.standard_normal(5)).astype(np.float32)}
        jstate, _ = jstep(jstate, g, jax.random.PRNGKey(0))
        tstep(tstate, {k: torch.from_numpy(v) for k, v in g.items()})
        if i % 25 == 24 or i in (198, 199, 200, 201, 202, 203):
            assert tstate.step == int(jstate["step"]), i
            for name in ("a", "b"):
                # fp32 Adam in another order: 1e-5 of the O(1) parameters
                np.testing.assert_allclose(getattr(tstate.model, name).detach().numpy(),
                                           np.asarray(jstate["params"][name]), atol=1e-5, err_msg=f"{i} {name}")
                np.testing.assert_allclose(getattr(tstate.ema, name).detach().numpy(),
                                           np.asarray(jstate["ema_params"][name]), atol=1e-5, err_msg=f"{i} ema {name}")
    assert tstate.step == 250 and tstate.opt_state.schedule_count == 250


# -- the whole slice: a few train steps on one data cache --------------------


def test_three_train_steps_match_jax(tmp_path):
    """3 optimizer steps at gradient accumulation 2 (6 micro-batches of 4),
    from the same weights, on batches both packages cut from one cache, with
    JAX's own t and noise draws injected into the port. The U-Net has one
    stage (dim_mults (1,)) to keep JAX's compile short; the gradient
    through all four stages is held in tests/test_torch_vjp.py."""
    path = write_traj_cache(str(tmp_path / "nbody-2" / "traj_3.npy"), n_sims=3)
    dkw = dict(n_bodies=2, input_steps=0, output_steps=24, time_interval=4)
    jit = JaxDataset(JaxDataConfig(**dkw), n_sims=3, cache_path=path).iterate_batches(
        4, seed=0, collision_frac=0.3)
    tit = NBodyDataset(NBodyDatasetConfig(**dkw), n_sims=3, cache_path=path).iterate_batches(
        4, seed=0, collision_frac=0.3)

    model = port_model(dim=16, seed=3, dim_mults=(1,))
    tkw = dict(gradient_accumulate_every=2, ema_update_every=1)
    jm = JaxUnet(horizon=24, transition_dim=8, dim=16, dim_mults=(1,))
    jcfg = JaxTrainConfig(**tkw)
    jstate = jax_init_train_state(flax_params(model), jax_make_optimizer(jcfg))
    jstep = jax_make_train_step(jm.apply, JaxConfig(rollout_steps=24, timesteps=100),
                                jax_make_schedule(100), jcfg)
    tstate = init_train_state(model, TrainConfig(**tkw))
    tstep = make_train_step(Diffusion1DConfig(rollout_steps=24, timesteps=100),
                            make_schedule(100, device="cpu"), TrainConfig(**tkw))
    key = jax.random.PRNGKey(0)
    for micro in range(6):
        jb, tb = next(jit), next(tit)
        np.testing.assert_array_equal(tb["x"], jb["x"])
        k = jax.random.fold_in(key, micro)
        kt, kn = jax.random.split(k)
        t = np.array(jax.random.randint(kt, (4,), 0, 100))
        noise = np.array(jax.random.normal(kn, jb["x"].shape, jnp.float32))
        jstate, jloss = jstep(jstate, {"x": jnp.asarray(jb["x"])}, k)
        _, tloss = tstep(tstate, {"x": torch.from_numpy(tb["x"]), "t": torch.from_numpy(t).long(),
                                  "noise": torch.from_numpy(noise)})
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, err_msg=str(micro))
    assert tstate.step == int(jstate["step"]) == 3
    for name, module in (("params", tstate.model), ("ema_params", tstate.ema)):
        want = keystr_flat(jstate[name]["params"])
        got = flax_from_params(module)
        diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
        # Three Adam steps of lr 1e-4 from equal weights (3e-4 in all). Adam
        # moves a weight by lr * g / (|g| + 1e-8), so where |g| is near 1e-9
        # the step follows g's last bits, which differ between the packages:
        # allow a tenth of a step anywhere, and 1% of a step on all but 0.1%
        # of the weights. A wrong gradient moves most weights by a whole step.
        assert diff.max() <= 1e-5, (name, diff.max())
        assert (diff > 1e-6).mean() <= 1e-3, (name, (diff > 1e-6).mean())


# -- checkpoints both ways ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_template():
    """A fresh JAX TrainState of a dim-16 TemporalUnet1D (zeros, shapes from
    the port's model), the template jax load_npz restores into."""
    zeros = jax.tree.map(np.zeros_like, flax_params(port_model(dim=16, seed=0)))
    return jax_init_train_state(zeros, jax_make_optimizer(JaxTrainConfig()))


def _port_state(seed, step):
    st = init_train_state(port_model(dim=16, seed=seed), TrainConfig())
    with torch.no_grad():
        for p in st.ema.parameters():
            p.mul_(0.5)
    st.step = step
    return st


@pytest.mark.parametrize("ema_only,dtype", [(False, None), (True, "bfloat16"), (False, "bfloat16")])
def test_port_snapshot_restores_in_jax(tmp_path, jax_template, ema_only, dtype):
    st = _port_state(seed=1, step=1234)
    path = save_npz(st, str(tmp_path / "persisted_m1234.npz"), ema_only=ema_only, dtype=dtype)
    restored = jpersist.load_npz(path, jax_template)
    assert int(restored["step"]) == 1234
    rnd = (lambda v: v.astype(ml_dtypes.bfloat16).astype(np.float32)) if dtype else (lambda v: v)
    for name, module in (("params", st.ema if ema_only else st.model), ("ema_params", st.ema)):
        got = keystr_flat(jax.tree.map(np.asarray, restored[name]["params"]))
        want = flax_from_params(module)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], rnd(want[k]), err_msg=f"{name} {k}")


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_jax_snapshot_loads_into_port_checkpoint_manager(tmp_path, jax_template, dtype):
    src = port_model(dim=16, seed=2)
    tree = flax_params(src)
    ema = jax.tree.map(lambda v: v * 0.5, tree)
    jstate = {**jax_template, "params": tree, "ema_params": ema, "step": np.int32(640_000)}
    jpersist.save_npz(jstate, str(tmp_path / "persisted_m640000.npz"), dtype=dtype)

    mngr = CheckpointManager(str(tmp_path))
    assert mngr.latest_milestone() == 640_000 and mngr.all_milestones() == []
    st = mngr.load(template=init_train_state(port_model(dim=16, seed=9), TrainConfig()))
    assert st.step == 640_000
    rnd = (lambda v: v.astype(ml_dtypes.bfloat16).astype(np.float32)) if dtype else (lambda v: v)
    for module, want in ((st.model, tree), (st.ema, ema)):
        got = flax_from_params(module)
        for k, v in keystr_flat(want["params"]).items():
            np.testing.assert_array_equal(got[k], rnd(v), err_msg=k)
    # past step 600,000 the resumed run trains at the decayed rate, as the
    # JAX package's restore of the same snapshot does
    jrestored = jckpt._seed_schedule_counts(jpersist.load_npz(
        str(tmp_path / "persisted_m640000.npz"), jax_template))
    jcount = int(jrestored["opt_state"][2].count)
    assert st.opt_state.schedule_count == jcount == 640_000 and st.opt_state.count == 0
    lr = st.opt_state.schedule(st.opt_state.schedule_count)
    assert lr == pytest.approx(5e-5)
    params = list(st.model.parameters())
    before = [p.detach().clone() for p in params]
    grads = [torch.full_like(p, 1e-4) for p in params]
    assert st.opt_state.update(params, grads)
    # Adam's first step moves every weight by lr * g / (|g| + 1e-8), here
    # 5e-5 * 0.9999 (the full rate would be 1e-4), up to the fp32 rounding
    # of weights of magnitude about 1
    for p, q in zip(params, before):
        torch.testing.assert_close(q - p.detach(), torch.full_like(q, lr * 1e-4 / (1e-4 + 1e-8)),
                                   rtol=0, atol=2e-7)


def test_bf16_rounding_matches_ml_dtypes_on_edge_values():
    u = np.array([
        0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,  # ties to even, just below/above
        0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF,  # max float32, rounding to inf or to max bf16
        0x00800000, 0x00000001, 0x00008000, 0x00018000, 0x807FFFFF,  # min normal, subnormals
        0x7F800000, 0xFF800000, 0x00000000, 0x80000000,  # infinities, zeros
        0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF, 0x7FBFFFFF,  # NaNs, quiet and signalling
    ], np.uint32)
    vals = np.concatenate([u.view(np.float32),
                           np.random.default_rng(0).standard_normal(4000).astype(np.float32) * 1e3])
    with np.errstate(invalid="ignore"):
        want = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = f32_to_bf16_bits(vals)
    finite = ~np.isnan(vals)
    np.testing.assert_array_equal(got[finite], want[finite])
    # NaN stays NaN, with its sign
    dec = got[~finite].astype(np.uint32) << 16
    assert np.isnan(dec.view(np.float32)).all()
    np.testing.assert_array_equal(np.signbit(dec.view(np.float32)), np.signbit(vals[~finite]))


def test_milestones_round_trip_the_whole_state(tmp_path):
    st = init_train_state(port_model(dim=8, seed=4), TrainConfig(gradient_accumulate_every=2))
    step = make_train_step(Diffusion1DConfig(rollout_steps=24, timesteps=20),
                           make_schedule(20, device="cpu"), TrainConfig(gradient_accumulate_every=2),
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 24, 8)).astype(np.float32))
    for _ in range(3):
        step(st, {"x": x})
    mngr = CheckpointManager(str(tmp_path))
    for m in (2, 3):
        mngr.save(m, st)
    assert mngr.all_milestones() == [2, 3] and mngr.latest_milestone() == 3
    back = mngr.load(template=init_train_state(port_model(dim=8, seed=5),
                                               TrainConfig(gradient_accumulate_every=2)))
    assert back.step == st.step == 1
    o, b = st.opt_state, back.opt_state
    assert (b.count, b.schedule_count, b.mini_step) == (o.count, o.schedule_count, o.mini_step) == (1, 1, 1)
    for mine, theirs in ((st.model, back.model), (st.ema, back.ema)):
        for p, q in zip(mine.parameters(), theirs.parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0)
    for name in ("mu", "nu", "acc"):
        for p, q in zip(getattr(o, name), getattr(b, name)):
            torch.testing.assert_close(p, q, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        mngr.load(milestone=1)


# -- the CLI ---------------------------------------------------------------------


def test_train_1d_cli_milestones_resume_eval_and_design(tmp_path, capsys):
    res, data = str(tmp_path / "res"), str(tmp_path / "data")
    base = ["--device", "cpu", "--Unet_dim", "8", "--batch_size", "4", "--n_sims", "3",
            "--test_sims", "1", "--collision_frac", "0.3", "--timesteps", "20",
            "--gradient_accumulate_every", "1", "--save_and_sample_every", "2", "--log_every", "1",
            "--dataset_path", data, "--results_folder", res]
    st = train_1d.main(base + ["--train_num_steps", "4"])
    assert st.step == 4 and os.path.exists(os.path.join(data, "nbody-2", "traj_3.npy"))
    assert CheckpointManager(res).all_milestones() == [2, 4]
    curve = np.load(os.path.join(res, "loss_curve.npy"))
    assert curve.shape == (4, 2) and np.isfinite(curve).all()
    st = train_1d.main(base + ["--train_num_steps", "6", "--resume", "True", "--eval_every", "2",
                               "--eval_sample_steps", "3", "--eval_batch", "2",
                               "--steps_per_launch", "2"])
    assert st.step == 6 and CheckpointManager(res).all_milestones() == [2, 4, 6]
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    with open(os.path.join(res, "train_records.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    # --steps_per_launch 2 has no effect: one micro-step per optimizer step
    assert [(r["start_step"], r["step"], r["micro_steps"]) for r in recs] == [(0, 4, 4), (4, 6, 2)]
    with open(os.path.join(res, "eval_records.jsonl")) as f:
        evals = [json.loads(line) for line in f]
    assert [e["step"] for e in evals] == [6] and np.isfinite(evals[0]["sample_mae"])
    assert sorted(f for f in os.listdir(res) if f.startswith("persisted")) == [
        "persisted_m4.npz", "persisted_m6.npz"]
    record = design_1d.main(["--model_path", res, "--Unet_dim", "8", "--batch_size", "2",
                             "--timesteps", "4", "--design_guidance", "standard",
                             "--device", "cpu"])
    assert all(np.isfinite(record[k]) for k in ("design_obj", "MAE", "RMSE"))


def test_train_1d_flags_match_jax_cli():
    from cindm_tpu.cli.train_1d import build_parser as jax_parser

    jax_flags = {a.dest for a in jax_parser()._actions}
    port_flags = {a.dest for a in train_1d.build_parser()._actions}
    assert port_flags - jax_flags == {"device"} and jax_flags <= port_flags


@pytest.mark.parametrize("argv,match", [
    (["--method_type", "GNS", "--n_devices", "2"], "slice 7"),
    (["--n_devices", "2"], "slice 7"),
    (["--method_type", "forward_model", "--n_devices", "1"], "slice 7"),
])
def test_train_1d_refuses_what_is_not_ported(tmp_path, argv, match):
    """Multi-GPU training, for every method type (the baselines are ported)."""
    with pytest.raises(SystemExit, match=match):
        train_1d.main(["--device", "cpu", "--results_folder", str(tmp_path), *argv])


def test_train_1d_refuses_absent_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_1d.main(["--results_folder", str(tmp_path)])


@pytest.mark.parametrize("cond_steps", [0, 2])
def test_sampling_eval_scores_against_the_batch(cond_steps):
    """With an eps-model that predicts zero noise, DDIM returns x_T's clipped
    estimate; the scores are the MAE / RMSE of that against the batch's
    rollout (after the 4 inpainted steps when there is no cond)."""
    from cindm_tpu_torch.sampling.sampler import generator_randn
    from cindm_tpu_torch.train import prediction_mae_1d, sampling_eval_1d

    rng = np.random.default_rng(cond_steps)
    batch = {"x": torch.from_numpy(rng.uniform(-0.5, 0.5, (3, 8, 4)).astype(np.float32))}
    if cond_steps:
        batch["cond"] = torch.from_numpy(rng.uniform(-0.5, 0.5, (3, cond_steps, 4)).astype(np.float32))
    seen = []

    def eps(x, t):
        seen.append(tuple(x.shape))
        return torch.zeros_like(x)

    cfg = Diffusion1DConfig(rollout_steps=8, conditioned_steps=cond_steps, timesteps=20)
    rec = sampling_eval_1d(cfg, make_schedule(20, device="cpu"), eps, batch,
                           generator_randn(torch.Generator().manual_seed(0), torch.device("cpu")),
                           sample_steps=4)
    assert len(seen) == 4 and seen[0] == (3, 8 + cond_steps, 4)
    assert set(rec) == {"sample_mae", "sample_rmse"} and 0 < rec["sample_mae"] <= rec["sample_rmse"]
    got = prediction_mae_1d(lambda c: batch["x"][:, :5] + 0.25, batch)
    assert got["pred_mae"] == pytest.approx(0.25)
