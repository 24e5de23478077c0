"""The port's data parallelism (``cindm_tpu_torch.parallel``) on the CPU:
two gloo processes against one, and the port's data-parallel train step
against the JAX package's under a 2-device mesh of the virtual CPU devices.

The two ranks run once per module (``tests/torch_parallel_worker.py``) and
each test reads what they wrote. A run at world size 2 must compute what
the same run computes at world size 1: every draw is made for the global
batch and cut to a rank's rows, and the gradients are averaged."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from cindm_tpu.core import make_schedule as jax_make_schedule
from cindm_tpu.models import TemporalUnet1D as JaxUnet
from cindm_tpu.parallel import make_mesh as jax_make_mesh
from cindm_tpu.sampling.diffusion1d import Diffusion1DConfig as JaxConfig
from cindm_tpu.train.trainer import TrainConfig as JaxTrainConfig
from cindm_tpu.train.trainer import init_train_state as jax_init_train_state
from cindm_tpu.train.trainer import make_optimizer as jax_make_optimizer
from cindm_tpu.train.trainer import make_train_step as jax_make_train_step
from cindm_tpu_torch.models import flax_from_params
from torch_port_helpers import flax_params, keystr_flat, port_model

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GRAD_TOL = 1e-5  # per parameter, of its largest entry: fp32 sums in another order
# A split changes the batch of every model call and with it the rounding of
# the CPU's convolutions (about 1e-6 of the output); the first reverse step
# divides the noise prediction by sqrt(alphas_cumprod[T-1]) (1/45 at 3 steps),
# which carries it to about 1e-4 of the sample: one process at 2 designs
# against two calls of 1, with no process group, read 1.0e-4.
SAMPLE_TOL = 1e-3


def _adam_close(got: dict, want: dict):
    """Parameters after two Adam steps of lr 1e-4 from equal weights. Adam
    moves a weight by lr * g / (|g| + 1e-8), so where |g| is near 1e-9 the
    step follows g's last bits, which differ with the order of the sums:
    allow a tenth of a step anywhere, and 1% of a step on all but 0.1% of
    the weights. A wrong gradient moves most weights by a whole step."""
    diff = np.concatenate([np.abs(np.asarray(got[k]) - np.asarray(want[k])).ravel() for k in want])
    assert diff.max() <= 1e-5, diff.max()
    assert (diff > 1e-6).mean() <= 1e-3, (diff > 1e-6).mean()


@pytest.fixture(scope="module")
def inputs():
    """Two global batches of 4 and the JAX package's draws for them (its
    train step's key schedule: fold_in(key, micro), split into t and noise)."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    out = {}
    for i in range(2):
        kt, kn = jax.random.split(jax.random.fold_in(key, i))
        out[f"x{i}"] = (0.5 * rng.standard_normal((4, 24, 8))).astype(np.float32)
        out[f"t{i}"] = np.array(jax.random.randint(kt, (4,), 0, 100))
        out[f"noise{i}"] = np.array(jax.random.normal(kn, (4, 24, 8), jnp.float32))
    return out


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """What each of two gloo ranks computed (one spawn for the module)."""
    work = tmp_path_factory.mktemp("ranks")
    np.savez(work / "inputs.npz", **inputs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(TESTS, "torch_parallel_worker.py"),
                               str(r), str(port), str(work)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def one(inputs):
    """The same computations in this process, at world size 1."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return worker.compute(None, inputs)
    finally:
        torch.set_num_threads(threads)


def test_initialize_multihost_joins_two_processes(ranks):
    for r in ranks:
        assert r["backend"] == "gloo"
        # sum over the global [2, 4] of each process's ones * (rank + 1)
        assert r["all_reduce_sum"] == 12.0


def test_make_mesh_and_shard_batch(ranks):
    for rank, r in enumerate(ranks):
        assert r["mesh"] == (("data",), 2)
        np.testing.assert_array_equal(r["shard"]["x"].numpy(),
                                      np.arange(8).reshape(4, 2)[2 * rank:2 * rank + 2])
        assert r["shard"]["n"] == 3
        assert "3 rows do not split over 2 ranks" in r["odd_rows"]
        assert "3 devices asked for" in r["too_many"]


def test_replicate_broadcasts_rank0(ranks):
    want = port_model(dim=8, seed=0, dim_mults=(1,)).state_dict()
    for r in ranks:
        assert (r["replicated"]["step"], r["replicated"]["count"]) == (10, 20)
        for k, v in want.items():
            torch.testing.assert_close(r["replicated"]["params"][k], v, rtol=0, atol=0)
        torch.testing.assert_close(r["replicated_tensor"], torch.zeros(3), rtol=0, atol=0)


def test_replicate_leaves_no_stale_staged_weights(ranks):
    """replicate broadcasts into .data, which moves no version counter: the
    kernels' staged layouts of the weights must not survive it. Rank 1's
    weights change, so its planes change; both ranks' planes afterwards are
    the layout of the broadcast weights."""
    assert not any(ranks[0]["staged"]["changed"])
    assert ranks[1]["staged"]["changed"] and all(ranks[1]["staged"]["changed"])
    for r in ranks:
        assert r["staged"]["fresh"] and all(r["staged"]["fresh"])


@pytest.mark.parametrize("draws", ["train_injected", "train_drawn"])
def test_mesh_step_equals_one_process(ranks, one, draws):
    """2 ranks x 2 rows against 1 process x 4: the same gradients (within
    fp32 summation order), losses and Adam-updated parameters, and the
    ranks agree exactly."""
    want = one[draws]
    for r in ranks:
        got = r[draws]
        assert got["step"] == want["step"] == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for gs, ws in zip(got["grads"], want["grads"]):
            for g, w in zip(gs, ws):
                assert float((g - w).abs().max()) <= GRAD_TOL * max(float(w.abs().max()), 1e-30)
        _adam_close({k: v.numpy() for k, v in got["params"].items()},
                    {k: v.numpy() for k, v in want["params"].items()})
    for k, v in ranks[0]["train_injected"]["params"].items():
        torch.testing.assert_close(ranks[1]["train_injected"]["params"][k], v, rtol=0, atol=0)


def test_mesh_step_equals_jax_under_a_mesh(ranks, inputs):
    """The JAX step under a 2-device mesh of the virtual CPU devices, from
    the same weights, on the same batches with the same draws."""
    model = port_model(dim=16, seed=3, dim_mults=(1,))
    jm = JaxUnet(horizon=24, transition_dim=8, dim=16, dim_mults=(1,))
    jcfg = JaxTrainConfig(**worker.TRAIN_CFG)
    jstate = jax_init_train_state(flax_params(model), jax_make_optimizer(jcfg))
    jstep = jax_make_train_step(jm.apply, JaxConfig(rollout_steps=24, timesteps=100),
                                jax_make_schedule(100), jcfg, mesh=jax_make_mesh(2, ("data",)))
    key = jax.random.PRNGKey(0)
    for i in range(2):
        jstate, jloss = jstep(jstate, {"x": jnp.asarray(inputs[f"x{i}"])}, jax.random.fold_in(key, i))
        np.testing.assert_allclose(ranks[0]["train_injected"]["losses"][i], float(jloss), rtol=1e-5)
    want = keystr_flat(jstate["params"]["params"])
    with torch.no_grad():
        model.load_state_dict(ranks[0]["train_injected"]["params"])
    _adam_close(flax_from_params(model), want)


def test_sharded_sampler_equals_one_process(ranks, one):
    want = one["sample_1d"]
    assert want.shape == (4, 24, 12)
    for r in ranks:
        assert r["sample_1d"].shape == want.shape
        assert float((r["sample_1d"] - want).abs().max()) <= SAMPLE_TOL * float(want.abs().max())


def test_2d_split_holds_whole_designs(ranks, one):
    """Each rank samples whole designs (boundary sharing couples a design's
    boundaries); the gathered designs are one process's, and the region
    inpainting holds exactly outside each boundary's band."""
    want = one["sample_2d"]
    assert want.shape == (worker.DESIGNS, worker.NB, 64, 64, 21)
    for r in ranks:
        got = r["sample_2d"]
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= SAMPLE_TOL * float(want.abs().max())
        assert (got[:, 0, 32:, :, -3] == 0).all() and (got[:, 1, :32, :, -3] == 0).all()


def test_2d_split_refuses_part_designs():
    from cindm_tpu_torch.sampling.diffusion2d import Diffusion2DConfig, p_sample_loop_2d

    class TwoRanks:  # the split reads only the mesh's size and this rank's index
        mesh_dim_names = ("data",)

        def size(self):
            return 2

        def get_local_rank(self, name):
            return 0

    cfg = Diffusion2DConfig(timesteps=1)
    with pytest.raises(ValueError, match="3 rows do not split over 2 ranks"):
        p_sample_loop_2d(cfg, cfg.make_schedule(device="cpu"), None, None, batch=3,
                         num_boundaries=2, mesh=TwoRanks())
