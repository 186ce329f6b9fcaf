"""The port's HLP env (rapid_locomotion_rl_tpu_torch.envs.hlp) against the
JAX package's, from the same state, on a small Mini Cheetah low level
(config_mini_cheetah on the plane, 8 envs: 7 train and 1 eval, decimation
1) driven by the frozen runs/r4_flagship_4000 student policy.

One HLP step in each package, with the corridor of cfg.world off and on,
from one JAX initial state prepared so that the step covers every
termination: env 0 (train) and env 7 (eval) reach their goal, env 1 times
out, env 2's base lies on the ground (a low-level fall); in the corridor
env 3 stands against a side wall. The actions include a clamped command
and one below the dead zone. The JAX side runs the SoA physics eagerly, as
tests/test_torch_env.py does; the low level's reset draws are replayed
from JAX's key, so every env is compared, the reset ones included.

Tolerances as tests/test_torch_env.py: 1e-4 on observations, rewards and
state, 1e-6 absolute on the dt-scaled reward terms (their sums per
episode: 1e-5), counts and dones exactly. The corridor-off step runs
r5_hlp7's recipe (visible terminals, progress shaping, no dead zone, a
0.5 m goal), the corridor-on step the reference's defaults."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_locomotion_rl_tpu import RLTPU_ROOT_DIR
from rapid_locomotion_rl_tpu import config as jcfg
from rapid_locomotion_rl_tpu.envs import hlp as JH
from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv as JEnv
from rapid_locomotion_rl_tpu.envs.legged_robot import _uniform
from rapid_locomotion_rl_tpu.utils.checkpoint import load_pytree as jload
from rapid_locomotion_rl_tpu_torch import config as tcfg
from rapid_locomotion_rl_tpu_torch.convert import (hlp_state_from_jax,
                                                   params_from_flax)
from rapid_locomotion_rl_tpu_torch.envs import hlp as TH
from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
from rapid_locomotion_rl_tpu_torch.models.networks import ACArgs, ActorCritic
from rapid_locomotion_rl_tpu_torch.sampler import Sampler

LL_STATE = os.path.join(RLTPU_ROOT_DIR, "runs", "r4_flagship_4000",
                        "checkpoints", "train_state_last.pkl")
N = 8


def _cfgs(world):
    out = []
    for mod in (jcfg, tcfg):
        c = mod.config_mini_cheetah()
        c.env.num_envs = N
        c.env.auto_reset = False
        c.terrain.mesh_type = "plane"
        c.terrain.teleport_robots = False
        c.noise.add_noise = False
        c.domain_rand.push_robots = False
        c.commands.command_curriculum = False
        c.control.decimation = 1
        c.sim.physics_impl = "soa"
        c.world.enabled = world
        out.append(c)
    return out


def _scales(mod, recipe):
    class Scales(mod.HLPRewardScales):
        progress = 1.0 if recipe else 0.0
    return Scales


def _flags(recipe):
    if recipe:    # r5_hlp7's
        return dict(zero_reward_on_reset=False, dead_zone=0.0,
                    goal_radius=0.5)
    return {}


@pytest.fixture(scope="module")
def ll_params():
    return jload(LL_STATE)["ppo_state"].params


class ReplaySampler(Sampler):
    """Returns the JAX env's own draws for the named streams."""

    def __init__(self, draws):
        super().__init__(0, "cpu")
        self.draws = draws

    def uniform(self, name, shape, lo, hi):
        if name in self.draws:
            return self.draws[name]
        return super().uniform(name, shape, lo, hi)


def _reset_draws(jll, ll_key):
    """The draws of the low level's reset_envs after one low-level step
    from ``ll_key`` (legged_robot.py: step's key split, reset_envs,
    _reset_sim_states, _sample_dof_props, _sample_rigid_body_props)."""
    key = jax.random.split(ll_key, 7)[0]
    _, k1, k2, k3 = jax.random.split(key, 4)
    _, ks2, ks3 = jax.random.split(k1, 3)
    lo, hi = jll.cfg.init_state.dof_init_range
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    motor, kp, kd = jll._sample_dof_props(k2, N)
    fric, rest, payl, com = jll._sample_rigid_body_props(k3, N)
    return {
        "reset_envs/sim/dof": t(_uniform(ks2, (N, 12), lo, hi)),
        "reset_envs/sim/root_vel": t(_uniform(ks3, (N, 6), -0.5, 0.5)),
        "reset_envs/dof_props/motor": t(motor[:, :1]),
        "reset_envs/dof_props/kp": t(kp[:, :1]),
        "reset_envs/dof_props/kd": t(kd[:, :1]),
        "reset_envs/rigid_props/friction": t(fric),
        "reset_envs/rigid_props/restitution": t(rest),
        "reset_envs/rigid_props/payload": t(payl),
        "reset_envs/rigid_props/com": t(com),
    }


def _envs(ll_params, world, recipe):
    jc, tc = _cfgs(world)
    jll = JEnv(jc)
    jenv = JH.HighLevelControlEnv(jll, ll_params,
                                  scales=_scales(JH, recipe),
                                  **_flags(recipe))
    tll = LeggedRobotEnv(tc, device="cpu")
    ac = ActorCritic(tll.num_obs, tll.num_privileged_obs,
                     tll.num_obs_history, tll.num_actions, ACArgs())
    ac.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                     ll_params)["params"]))
    tenv = TH.HighLevelControlEnv(tll, ac, scales=_scales(TH, recipe),
                                  **_flags(recipe))
    return jenv, tenv


def _prepared(jenv, world):
    """A JAX initial state set up for every termination (module doc)."""
    with jax.disable_jit():
        s = jax.tree.map(np.asarray,
                         jenv.initial_state(jax.random.PRNGKey(3)))
    sim = s.ll.sim
    pos = sim.base_pos.copy()
    origins = s.ll.env_origins
    pos[2, 2] = 0.08                           # base on the ground
    if world:
        pos[3, 1] = origins[3, 1] + 0.74       # against the +y wall
    init = np.asarray(jenv.ll_env.cfg.init_state.pos, np.float32)
    last = (pos - origins - init).astype(np.float32)
    goal = s.goal_position.copy()
    goal[[0, 7]] = last[[0, 7], :2] + 0.05     # goals reached
    ep = s.episode_length.copy()
    ep[1] = jenv.max_episode_length            # times out
    ll = s.ll._replace(sim=sim._replace(base_pos=pos))
    return s._replace(ll=ll, last_pos=last, goal_position=goal,
                      episode_length=ep)


def _actions():
    a = np.random.default_rng(5).normal(0, 0.8, (N, 3)).astype(np.float32)
    a[4] = (0.1, 0.05, 0.3)      # below the dead zone
    a[5] = (3.0, -2.5, 0.5)      # clamped to +-2
    return a


@pytest.fixture(scope="module", params=[(False, True), (True, False)],
                ids=["recipe", "corridor-defaults"])
def hlp_step(request, ll_params):
    """(world, recipe): one HLP step in each package from one state."""
    world, recipe = request.param
    jenv, tenv = _envs(ll_params, world, recipe)
    js = _prepared(jenv, world)
    ts = hlp_state_from_jax(js, device="cpu")
    a = _actions()
    jstate = jax.tree.map(jnp.asarray, js)
    with jax.disable_jit():
        jnew, jres = jenv.step(jstate, jnp.asarray(a))
    sampler = ReplaySampler(_reset_draws(jenv.ll_env, js.ll.key))
    tnew, tres = tenv.step(ts, torch.tensor(a), sampler)
    to_np = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    return world, recipe, (to_np(jnew), to_np(jres)), (tnew, tres), tenv


def test_hlp_dones_and_counts_match(hlp_step):
    world, _, (jnew, jres), (tnew, tres), tenv = hlp_step
    done = jres.done
    assert done[[0, 1, 2, 7]].all() and not done[[4, 5, 6]].any(), done
    assert jres.info["time_outs"][1] and not jres.info["time_outs"][0]
    np.testing.assert_array_equal(tres.done.numpy(), done)
    for k in ("time_outs", "train_reset_count", "eval_reset_count",
              "goal_reached_count", "env_bins"):
        np.testing.assert_array_equal(np.asarray(tres.info[k]),
                                      jres.info[k], err_msg=k)
    assert int(jres.info["eval_reset_count"]) == 1
    assert int(jres.info["goal_reached_count"]) == 2


def test_hlp_obs_and_rewards_match(hlp_step):
    """Every env: the reset ones through the replayed low-level draws."""
    _, recipe, (jnew, jres), (tnew, tres), _ = hlp_step
    np.testing.assert_allclose(tres.obs.numpy(), jres.obs, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tres.rew.numpy(), jres.rew, rtol=1e-4,
                               atol=1e-4)
    if recipe:
        # visible terminals: +5 goal, -1 timeout, -2 fall
        assert jres.rew[0] > 4.0 and jres.rew[1] < -0.9
        assert jres.rew[2] < -1.9
    else:
        # the reference quirk: the resetting envs' rewards are zeroed
        assert np.all(jres.rew[jres.done] == 0.0)
    np.testing.assert_array_equal(tnew.actions.numpy()[4, :2],
                                  jnew.actions[4, :2])
    assert np.all(np.abs(jnew.actions) <= 2.0)


def test_hlp_episode_sums_and_info_sums_match(hlp_step):
    """Every reward term: its running sum per env, and its sum over the
    envs that reset (train and eval) in the step's info."""
    _, _, (jnew, jres), (tnew, tres), tenv = hlp_step
    assert set(tnew.episode_sums) == set(jnew.episode_sums)
    for k, v in jnew.episode_sums.items():
        np.testing.assert_allclose(tnew.episode_sums[k].numpy(), v,
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    sums = [k for k in jres.info if k.endswith("/sum")]
    assert set(sums) == {k for k in tres.info if k.endswith("/sum")}
    assert len(sums) == 2 * len(tenv.episode_sum_keys)
    for k in sums:
        np.testing.assert_allclose(tres.info[k].item(), float(jres.info[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_hlp_reset_state_matches(hlp_step):
    """The HLP buffers and the low-level state after the masked resets."""
    world, _, (jnew, jres), (tnew, tres), _ = hlp_step
    np.testing.assert_array_equal(tnew.episode_length.numpy(),
                                  jnew.episode_length)
    for name in ("last_pos", "dist_travelled", "goal_position",
                 "last_actions"):
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   getattr(jnew, name), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for name in tnew.ll.sim._fields:
        np.testing.assert_allclose(getattr(tnew.ll.sim, name).numpy(),
                                   getattr(jnew.ll.sim, name), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for name in tnew.ll.dr._fields:
        np.testing.assert_allclose(getattr(tnew.ll.dr, name).numpy(),
                                   getattr(jnew.ll.dr, name), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(tnew.ll.commands.numpy(), jnew.ll.commands,
                               atol=1e-6)
    keep = ~jres.done
    np.testing.assert_allclose(tnew.ll.contact_report.numpy()[keep],
                               jnew.ll.contact_report[keep], rtol=1e-3,
                               atol=1e-2)
    if world:
        # env 3 is pushed by the +y wall (toward -y)
        assert jnew.ll.contact_report[3, :, 1].min() < -1.0


def test_hlp_initial_observation_matches(ll_params):
    """The 14-d observation of a JAX initial state, and the port's own
    initial state's layout: zero commands, the goal in the last 2 dims."""
    jenv, tenv = _envs(ll_params, False, True)
    with jax.disable_jit():
        js = jax.tree.map(np.asarray,
                          jenv.initial_state(jax.random.PRNGKey(1)))
    ts = hlp_state_from_jax(js, device="cpu")
    np.testing.assert_allclose(
        tenv._observe(ts, torch.zeros(N, 3)).numpy(), js.obs, atol=1e-6)
    own = tenv.initial_state(Sampler(0, "cpu"))
    assert own.obs.shape == (N, 14)
    np.testing.assert_array_equal(own.obs[:, 12:].numpy(),
                                  np.tile([3.0, 0.0], (N, 1)))
    assert torch.all(own.ll.commands[:, :3] == 0)
    assert set(own.episode_sums) == set(js.episode_sums)


@pytest.fixture(scope="module")
def port_env(ll_params):
    return _envs(ll_params, False, False)[1]


def test_hlp_action_clamping(port_env):
    """tests/test_hlp.py's case: commands clamp to 2, xy commands below
    the 0.2 dead zone are zeroed."""
    env = port_env
    s = Sampler(0, "cpu")
    state = env.initial_state(s)
    state, _ = env.step(state, torch.full((N, 3), 10.0), s)
    torch.testing.assert_close(state.ll.commands[:, :3],
                               torch.full((N, 3), 2.0))
    state, _ = env.step(state, torch.tensor([[0.05, 0.05, 1.0]] * N), s)
    assert torch.all(state.ll.commands[:, :2] == 0.0)


def test_hlp_dead_zone_and_goal_radius(port_env):
    """tests/test_hlp.py's case: dead_zone=0 passes small xy commands
    through; a robot 0.3 m from its goal terminates with the +5 bonus at
    goal_radius 0.5 and not at the reference's 0.1."""
    env = TH.HighLevelControlEnv(port_env.ll_env, port_env.ll_ac,
                                 dead_zone=0.0, goal_radius=0.5,
                                 zero_reward_on_reset=False)
    s = Sampler(0, "cpu")
    state = env.initial_state(s)
    state, _ = env.step(state, torch.tensor([[0.05, 0.05, 0.0]] * N), s)
    torch.testing.assert_close(state.ll.commands[:, :2],
                               torch.full((N, 2), 0.05))
    near = state._replace(goal_position=state.last_pos[:, :2] + 0.3)
    _, res = env.step(near, torch.zeros(N, 3), s)
    assert bool(res.done.all())
    assert torch.all(res.rew > 3.0)
    state2 = port_env.initial_state(s)
    far = state2._replace(goal_position=state2.last_pos[:, :2] + 0.3)
    _, res2 = port_env.step(far, torch.zeros(N, 3), s)
    assert not bool(res2.done.any())


@pytest.mark.parametrize("run_world,flag", [
    (False, False), (False, True), (True, False), (True, True)])
def test_script_keeps_the_runs_world(run_world, flag):
    """scripts/high_level_play_cuda.py takes the low-level run's config as
    scripts/high_level_play.py does (no self resets, noise, pushes or
    command curriculum) and keeps its ``cfg.world``: ``--world`` only
    switches the corridor on."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "hlpc", os.path.join(RLTPU_ROOT_DIR, "scripts",
                             "high_level_play_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = ["--num-envs", "64"] + (["--world"] if flag else [])
    blob = json.load(open(os.path.join(RLTPU_ROOT_DIR, "runs",
                                       "r4_flagship_4000",
                                       "parameters.json")))["Cfg"]
    blob["world"]["enabled"] = run_world
    cfg = mod.low_level_cfg(tcfg.Cfg.from_dict(blob), mod.parse_args(argv))
    assert cfg.world.enabled == (run_world or flag)
    assert cfg.env.num_envs == 64 and not cfg.env.auto_reset
    assert not cfg.noise.add_noise and not cfg.domain_rand.push_robots
    assert not cfg.commands.command_curriculum
