"""Parity of the port's 2D samplers and design objectives
(cindm_tpu_torch.sampling.{diffusion2d,guidance2d}) with the JAX package's.

The JAX samplers split PRNG keys; each test makes the same splits with
jax.random and hands the draws to the port's ``randn`` hook in the JAX
order (``Draws`` checks each shape and that every draw was used). The
eps-model and the force surrogate are small closed forms written in both
frameworks (the force form takes NHWC in JAX and NCHW in the port, as the
models do); one case runs a dim-8 ForceUnet with the same weights in both.
Inputs keep the clipped channels off 0 and 1, where the two frameworks
take different subgradients; so universal guidance, which evaluates the
objective at the clipped x_start, is held on single steps from states whose
x_start stays inside (-1, 1), not over whole loops, where x_start saturates.
Tolerances: 1e-5 of the largest magnitude for the objectives and gradients,
1e-4 for the samplers. The samplers' tests scale the design objective by
``GUIDE_GAIN`` and require that guidance moves each output by at least
``GUIDE_GAP`` (against the same run with a zero gradient), so that a wrong
coefficient, sign or omission of the guidance term cannot hide under the
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cindm_tpu.core import make_schedule as jax_make_schedule
from cindm_tpu.models.unet2d import ForceUnet as JaxForceUnet
from cindm_tpu.sampling import diffusion2d as jd
from cindm_tpu.sampling import guidance2d as jg
from cindm_tpu_torch.models import ForceUnet, flax_from_params
from cindm_tpu_torch.sampling import diffusion2d as td
from cindm_tpu_torch.sampling import guidance2d as tg
from torch_port_helpers import nest

OBJ_TOL = 1e-5
SAMPLER_TOL = 1e-4
GUIDE_GAIN = 100.0
GUIDE_GAP = 10 * SAMPLER_TOL
T_STEPS = 6
CFG = dict(image_size=16, frames=2, timesteps=T_STEPS)
C = 2 * 3 + 3
H = W = 16

_EPS_M = (np.random.default_rng(0).standard_normal((C, C)) * 0.3).astype(np.float32)
_FORCE_A = (np.random.default_rng(1).standard_normal((4, 2)) * 0.5).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def j_eps(x, t):
    return 0.2 * jnp.tanh(x @ _EPS_M + 0.01 * t[:, None, None, None].astype(jnp.float32))


def t_eps(x, t):
    return 0.2 * torch.tanh(x @ torch.from_numpy(_EPS_M) + 0.01 * t[:, None, None, None].float())


def j_force(inp):  # [N, H, W, 4] -> [N, 2]
    return jnp.mean(jnp.sin(inp @ _FORCE_A) * inp[..., :2], axis=(1, 2))


def t_force(inp):  # [N, 4, H, W] -> [N, 2]
    x = inp.permute(0, 2, 3, 1)
    return (torch.sin(x @ torch.from_numpy(_FORCE_A)) * x[..., :2]).mean(dim=(1, 2))


class Draws:
    """Replays pre-made draws in order, checking each requested shape."""

    def __init__(self, arrays):
        self.arrays = [np.array(a) for a in arrays]

    def __call__(self, shape):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a)


def _normal(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


def noise_draws(key, B, nb):
    k1, k2 = jax.random.split(key)
    return [_normal(k1, (B, 1, H, W, C - 3)), _normal(k2, (B, nb, H, W, 3))]


def step_draws(key, B, nb, rec):
    """p_sample_2d's draws: one state-shared noise per recurrence pass, then the step noise."""
    out = []
    for _ in range(rec):
        key, k1 = jax.random.split(key)
        out += noise_draws(k1, B, nb)
    key, kn = jax.random.split(key)
    return out + noise_draws(kn, B, nb)


def loop_draws(key, B, nb, rec, inpaint):
    key, k0 = jax.random.split(key)
    out = noise_draws(k0, B, nb)
    for _ in range(T_STEPS):
        key, k, k2 = jax.random.split(key, 3)
        out += step_draws(k, B, nb, rec)
        if inpaint:
            out.append(_normal(k2, (B * nb, H, W)))
    return out


def _state(B, nb, seed=5, amp=1.2):
    """x [B*nb, H, W, C] in [-amp, amp], the mask channel in (0.05, 0.95 amp).
    The samplers' tests take amp 0.3, so that the clipped x_start where
    universal guidance evaluates the objective stays off +-1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-amp, amp, (B * nb, H, W, C)).astype(np.float32)
    x[..., -3] = rng.uniform(0.05, 0.95 * amp, (B * nb, H, W))
    return x


def _schedules():
    return jax_make_schedule(T_STEPS, "sigmoid"), td.Diffusion2DConfig(**CFG).make_schedule("cpu")


def _design_fns(B, nb, jf=j_force, tf=t_force, gain=1.0):
    kw = dict(lambda_force=1.3 * gain, lambda_overlap=0.7 * gain, lambda_separation=0.5 * gain)
    return (jg.make_design_grad_fn(jf, B, nb, 2, -0.5, 2.0, **kw),
            tg.make_design_grad_fn(tf, B, nb, 2, -0.5, 2.0, **kw))


def _zero_grad(x):
    """A design gradient of 0: the unguided run, with every draw of the guided one."""
    return torch.zeros_like(x)


def test_share_noise_and_clamp_match():
    x = _state(2, 3)
    for avg in (True, False):
        want = jd.share_states_over_boundaries(jnp.asarray(x), 3, avg)
        got = td.share_states_over_boundaries(torch.from_numpy(x), 3, avg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(td.asynchronous_clamp(torch.from_numpy(x)).numpy(),
                                  np.asarray(jd.asynchronous_clamp(jnp.asarray(x))))
    key = jax.random.PRNGKey(7)
    want = jd.sample_noise(key, 2, 3, H, W, C)
    draws = Draws(noise_draws(key, 2, 3))
    np.testing.assert_array_equal(td.sample_noise(draws, 2, 3, H, W, C).numpy(), np.asarray(want))
    assert not draws.arrays
    m = np.random.default_rng(1).uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    np.testing.assert_array_equal(tg.mask_denoise(torch.from_numpy(m)).numpy(),
                                  np.asarray(jg.mask_denoise(jnp.asarray(m))))


@pytest.mark.parametrize("nb", [1, 2, 3])
def test_objectives_and_design_gradient_match(nb):
    B = 2
    x = _state(B, nb, seed=10 + nb)
    xt = torch.from_numpy(x)
    jfn, tfn = _design_fns(B, nb)
    # one JAX program for every objective and the gradient
    wants = jax.jit(lambda xj: (
        jg.force_objective(xj, j_force, B, nb, 2, -0.5, 2.0, 1.3),
        jg.overlap_objective(xj, B, nb), jg.mask_centroids(xj, B, nb),
        jg.separation_objective(xj, B, nb), jg.unnormalize_state(xj, -0.5, 2.0), jfn(xj)))(x)
    gots = (tg.force_objective(xt, t_force, B, nb, 2, -0.5, 2.0, 1.3),
            tg.overlap_objective(xt, B, nb), tg.mask_centroids(xt, B, nb),
            tg.separation_objective(xt, B, nb), tg.unnormalize_state(xt, -0.5, 2.0), tfn(xt))
    for want, got in zip(wants, gots):
        assert _rel(got.numpy(), want) <= OBJ_TOL
    assert gots[-1].shape == xt.shape and not xt.requires_grad


def test_design_gradient_through_force_unet_matches():
    B, nb = 1, 2
    tm = ForceUnet(dim=8, dim_mults=(1, 2), generator=torch.Generator().manual_seed(3))
    tm.requires_grad_(False)
    jm, jp = JaxForceUnet(dim=8, dim_mults=(1, 2)), {"params": nest(flax_from_params(tm))}
    jfn, tfn = _design_fns(B, nb, jf=lambda inp: jm.apply(jp, inp), tf=tm)
    x = _state(B, nb, seed=21)
    want = jax.jit(jfn)(jnp.asarray(x))
    assert _rel(tfn(torch.from_numpy(x)).numpy(), want) <= OBJ_TOL


GUIDANCES = ["standard-alpha", "standard", "universal-forward", "universal-backward",
             "standard-alpha-recurrence-2"]


@pytest.mark.parametrize("t", [3, 0])
@pytest.mark.parametrize("guidance", GUIDANCES)
def test_p_sample_2d_matches(guidance, t):
    B, nb = 1, 2
    cfg_j, cfg_t = jd.Diffusion2DConfig(**CFG), td.Diffusion2DConfig(**CFG)
    js, ts = _schedules()
    jfn, tfn = _design_fns(B, nb, gain=GUIDE_GAIN)
    x = _state(B, nb, seed=30 + t, amp=0.3)
    key = jax.random.PRNGKey(11)
    want, want_x0 = jd.p_sample_2d(cfg_j, js, j_eps, jnp.asarray(x), t, key, batch=B,
                                   num_boundaries=nb, design_fn=jfn, design_guidance=guidance)
    rec = int(guidance.rsplit("-", 1)[1]) if "recurrence" in guidance else 0

    def port(design_fn):
        draws = Draws(step_draws(key, B, nb, rec))
        with torch.no_grad():
            out = td.p_sample_2d(cfg_t, ts, t_eps, torch.from_numpy(x), t, draws, batch=B,
                                 num_boundaries=nb, design_fn=design_fn, design_guidance=guidance)
        assert not draws.arrays
        return out

    got, got_x0 = port(tfn)
    assert _rel(got.numpy(), want) <= SAMPLER_TOL
    assert _rel(got_x0.numpy(), want_x0) <= SAMPLER_TOL
    assert _rel(got.numpy(), port(_zero_grad)[0].numpy()) >= GUIDE_GAP


def _bands(B, nb):
    rows = np.arange(H)[:, None] * np.ones((1, W))
    bands = np.stack([((rows >= 2 + 5 * k) & (rows < 5 + 5 * k)).astype(np.float32)
                      for k in range(nb)])
    return np.broadcast_to(bands[None], (B, nb, H, W)).reshape(B * nb, H, W).copy()


LOOPS = {
    "standard-alpha": dict(),
    "recurrence": dict(design_guidance="standard-alpha-recurrence-2"),
    "init_bias": dict(init_bias=True),
    "station_and_region": dict(station=True, region=True),
}


@pytest.mark.parametrize("case", sorted(LOOPS))
def test_p_sample_loop_2d_matches(case):
    opts = dict(LOOPS[case])
    B, nb = 2, 2
    cfg_j, cfg_t = jd.Diffusion2DConfig(**CFG), td.Diffusion2DConfig(**CFG)
    js, ts = _schedules()
    jfn, tfn = _design_fns(B, nb, gain=GUIDE_GAIN)
    guidance = opts.pop("design_guidance", "standard-alpha")
    rng = np.random.default_rng(40)
    kw_np = {}
    if opts.get("init_bias"):
        kw_np["init_bias"] = rng.uniform(0, 0.5, (B * nb, H, W, C)).astype(np.float32)
    if opts.get("station"):
        kw_np["station_pattern"] = (rng.uniform(0, 1, (B * nb, H, W)) > 0.7).astype(np.float32)
    if opts.get("region"):
        kw_np["region_mask"] = _bands(B, nb)
    station_until = 3 if opts.get("station") else 0
    key = jax.random.PRNGKey(12)
    want = jd.p_sample_loop_2d(cfg_j, js, j_eps, key, batch=B, num_boundaries=nb, design_fn=jfn,
                               design_guidance=guidance, station_until=station_until,
                               **{k: jnp.asarray(v) for k, v in kw_np.items()})
    rec = 2 if "recurrence" in guidance else 0

    def port(design_fn):
        draws = Draws(loop_draws(key, B, nb, rec,
                                 inpaint=bool(opts.get("station") or opts.get("region"))))
        out = td.p_sample_loop_2d(cfg_t, ts, t_eps, draws, batch=B, num_boundaries=nb,
                                  design_fn=design_fn, design_guidance=guidance,
                                  station_until=station_until,
                                  **{k: torch.from_numpy(v) for k, v in kw_np.items()})
        assert not draws.arrays
        return out

    got = port(tfn)
    assert got.shape == (B, nb, H, W, C)
    assert _rel(got.numpy(), want) <= SAMPLER_TOL
    assert _rel(got.numpy(), port(_zero_grad).numpy()) >= GUIDE_GAP
    if "region_mask" in kw_np:
        outside = kw_np["region_mask"].reshape(B, nb, H, W) == 0
        assert (got.numpy()[..., -3][outside] == 0).all()


@pytest.mark.parametrize("guidance", ["standard-alpha", "standard"])
def test_ddim_sample_loop_2d_matches(guidance):
    B, nb, S = 1, 3, 3
    cfg_j, cfg_t = jd.Diffusion2DConfig(**CFG), td.Diffusion2DConfig(**CFG)
    js, ts = _schedules()
    jfn, tfn = _design_fns(B, nb, gain=GUIDE_GAIN)
    bias = np.random.default_rng(41).uniform(0, 0.5, (B * nb, H, W, C)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    want = jd.ddim_sample_loop_2d(cfg_j, js, j_eps, key, batch=B, num_boundaries=nb,
                                  sampling_timesteps=S, design_fn=jfn, design_guidance=guidance,
                                  init_bias=jnp.asarray(bias))
    key, k0 = jax.random.split(key)
    arrays = noise_draws(k0, B, nb)
    for _ in range(S):
        key, kn = jax.random.split(key)
        arrays += noise_draws(kn, B, nb)

    def port(design_fn):
        draws = Draws(arrays)
        out = td.ddim_sample_loop_2d(cfg_t, ts, t_eps, draws, batch=B, num_boundaries=nb,
                                     sampling_timesteps=S, design_fn=design_fn,
                                     design_guidance=guidance, init_bias=torch.from_numpy(bias))
        assert not draws.arrays
        return out

    got = port(tfn)
    assert _rel(got.numpy(), want) <= SAMPLER_TOL
    assert _rel(got.numpy(), port(_zero_grad).numpy()) >= GUIDE_GAP
