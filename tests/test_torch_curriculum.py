"""The port's command curriculum (envs/curriculum.py) against the JAX
package's (``update`` at rapid_locomotion_rl_tpu/envs/curriculum.py:102,
``sample`` at :177), and its update on inputs gathered over two gloo ranks
against the update in one process.

The cases (tests/torch_dist_worker.py::curriculum_cases): config_mini_cheetah's
grid, 16 envs, masks of ~80%, rewards just below, at and just above both
thresholds (and well above), success bins at the grid's corners so that the
stencil is clipped there, per-bin weights spread over [0, 1]; three cases
with unique bins and one with bins repeated, whose per-bin logs take the
last writer (defined on the CPU, in both packages)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from rapid_locomotion_rl_tpu.config import config_mini_cheetah as jconfig
from rapid_locomotion_rl_tpu.envs import curriculum as JC
from rapid_locomotion_rl_tpu_torch.envs import curriculum as TC
from rapid_locomotion_rl_tpu_torch.sampler import Sampler
from torch_dist_worker import WORKER, Processes, free_port

CASES = W.curriculum_cases()


def jax_update(args, kw):
    _, state, bins, lin, ang, mask, lt, at = args
    grid = JC.make_grid(jconfig())
    jstate = JC.CurriculumState(*(jnp.asarray(x.numpy()) for x in state))
    out = JC.update(grid, jstate, jnp.asarray(bins.numpy()),
                    jnp.asarray(lin.numpy()), jnp.asarray(ang.numpy()),
                    jnp.asarray(mask.numpy()), lt, at,
                    **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_update_matches_jax(case):
    """Weights and every per-bin log equal, bit for bit."""
    args, kw = CASES[case]
    want = jax_update(args, kw)
    got = TC.update(*args, **kw)
    success = (args[5] & (args[3] > args[6]) & (args[4] > args[7]))
    assert 0 < int(success.sum()) < int(args[5].sum())
    # some success bin sits on the grid's edge: the stencil is clipped
    nx, ny, nz = args[0].shape
    b = args[2][success].numpy()
    ix, iy, iz = np.unravel_index(b, (nx, ny, nz))
    assert np.any((ix == 0) | (ix == nx - 1) | (iz == 0) | (iz == nz - 1))
    for name, g, w in zip(TC.CurriculumState._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert not np.array_equal(want[0], args[1].weights.numpy())


def test_update_at_the_thresholds():
    """A reward equal to its threshold (in float32) is no success, one
    float32 step above is; both packages compare in float32."""
    grid = TC.make_grid(jconfig())
    state = TC.init_state(grid, jconfig(), "cpu")
    lt, at = 0.8 * 0.02, 0.5 * 0.01       # not float32 numbers
    f32 = np.float32
    lin = torch.tensor([np.nextafter(f32(lt), f32(0)), f32(lt),
                        np.nextafter(f32(lt), f32(1)), 1.0], dtype=torch.float32)
    ang = torch.full((4,), 1.0)
    bins = torch.tensor([0, 100, 200, 300])
    mask = torch.ones(4, dtype=torch.bool)
    got = TC.update(grid, state, bins, lin, ang, mask, lt, at)
    want = jax_update((grid, state, bins, lin, ang, mask, lt, at), {})
    np.testing.assert_array_equal(got.weights.numpy(), want[0])
    inc = got.weights - state.weights
    assert inc[0] == 0 and inc[200] > 0 and inc[300] > 0
    hit_at = (inc[100] > 0).item()
    assert hit_at == bool(f32(lt) > f32(lt))


class ReplaySampler(Sampler):
    """Takes the bin and cell draws from given tensors."""

    def __init__(self, bins, u):
        super().__init__(0, "cpu")
        self.bins, self.u = bins, u

    def categorical(self, name, weights, n):
        assert name == "resample/bins" and n == self.bins.shape[0]
        return self.bins

    def uniform(self, name, shape, lo, hi):
        assert name == "resample/cell" and tuple(shape) == tuple(
            self.u.shape) and (lo, hi) == (-0.5, 0.5)
        return self.u


def test_sample_matches_jax():
    """JAX's bin and cell draws replayed into the port's ``sample``: the
    same commands and bins; and the port's own draws fall only on bins of
    positive weight."""
    args, _ = CASES[0]
    state = args[1]
    grid = JC.make_grid(jconfig())
    jstate = JC.CurriculumState(*(jnp.asarray(x.numpy()) for x in state))
    key = jax.random.PRNGKey(3)
    n = 512
    jcmds, jbins = JC.sample(grid, jstate, key, n)
    kb, ku = jax.random.split(key)
    u = jax.random.uniform(ku, (n, 3), minval=-0.5, maxval=0.5)
    replay = ReplaySampler(torch.tensor(np.asarray(jbins)).long(),
                           torch.tensor(np.asarray(u)))
    cmds, bins = TC.sample(args[0], state, replay, n, "resample")
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jbins))
    np.testing.assert_array_equal(cmds.numpy(), np.asarray(jcmds))
    zero = state.weights.clone()
    zero[::2] = 0.0
    _, own = TC.sample(args[0], state._replace(weights=zero),
                       Sampler(0, "cpu"), 4096, "resample")
    assert bool((zero[own] > 0).all())


def test_sharded_update_matches_unsharded(tmp_path):
    """Each case's inputs split over two gloo ranks, gathered to global
    order as the env gathers them, then updated on every rank: equal to
    the update in one process, bit for bit."""
    out = str(tmp_path / "curriculum.pt")
    port = free_port()
    procs = Processes(
        [[sys.executable, WORKER, "curriculum", str(r), "2",
          str(port), out] for r in range(2)],
        [str(tmp_path / f"rank{r}.log") for r in range(2)])
    procs.wait()
    sharded = torch.load(out, weights_only=False)
    assert len(sharded) == len(CASES)
    for (args, kw), got in zip(CASES, sharded):
        want = TC.update(*args, **kw)
        for name, g, w in zip(TC.CurriculumState._fields, got, want):
            assert torch.equal(g, w), name
