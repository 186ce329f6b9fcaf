"""The port's data parallelism (rapid_locomotion_rl_tpu_torch/parallel/
sharding.py) on the CPU over gloo, against the JAX package's module and
against one process.

- ``env_axis_sharding`` splits and replicates the leaves of one converted
  env state as JAX's does;
- every random stream of the env, the rollout, the update and the Runner
  is classified (env axis or replicated), and the sharded sampler's rows
  are the global draw's;
- a two-rank train_iteration (16 plane envs, 4 steps, as
  tests/test_sharding.py) matches one process at that test's tolerances,
  with the LR and the command curriculum;
- ``scripts/train_cuda.py --device cpu --distributed --mesh data`` in two
  processes (tests/test_multihost.py's check for JAX).

Each rank is a process of its own (tests/torch_dist_worker.py), with a
timeout."""

import os
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from rapid_locomotion_rl_tpu_torch.parallel import sharding as SH
from torch_dist_worker import WORKER, Processes, free_port


def start_job(job, tmp_path):
    """JOB in one process and over two gloo ranks, all three at once."""
    port = free_port()
    runs = [("one", 0, 1), ("two", 0, 2), ("two1", 1, 2)]
    outs = {name: str(tmp_path / f"{job}_{name}.pt") for name, _, _ in runs}
    procs = Processes(
        [[sys.executable, WORKER, job, str(rank), str(world), str(port),
          outs[name]] for name, rank, world in runs],
        [str(tmp_path / f"{job}_{name}.log") for name, _, _ in runs])
    return procs, outs


def job_results(started):
    """The results of both rank 0s: one process, two ranks."""
    procs, outs = started
    procs.wait()
    return (torch.load(outs["one"], weights_only=False),
            torch.load(outs["two"], weights_only=False))


TRAIN_ARGS = ["--device", "cpu", "--distributed", "--mesh", "data",
              "--iterations", "2", "--num-envs", "64", "--terrain", "plane",
              "--substeps", "1", "--eval-freq", "1000"]


def start_train_cuda(tmp_path):
    """scripts/train_cuda.py in two processes, as torchrun starts them."""
    port = free_port()
    envs = []
    for rank in range(2):
        e = dict(os.environ)
        e.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="1")
        envs.append(e)
    cmd = [sys.executable, "scripts/train_cuda.py", *TRAIN_ARGS,
           "--logdir", str(tmp_path / "run")]
    return Processes([cmd, cmd], [str(tmp_path / f"rank{r}.log")
                                  for r in range(2)], envs)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The module's processes start at once and run beside its in-process
    tests."""
    train_dir = tmp_path_factory.mktemp("train_cuda")
    jobs = dict(train=(start_train_cuda(train_dir), train_dir),
                iteration=start_job("iteration",
                                    tmp_path_factory.mktemp("iteration")))
    yield jobs
    jobs["train"][0].kill()
    jobs["iteration"][0].kill()


# ---------------------------------------------------------------------------
def test_env_axis_sharding_matches_jax():
    """The split/replicate choice on the same env state: JAX's initial
    state, converted; JAX's key has no port counterpart."""
    import jax
    from rapid_locomotion_rl_tpu import config as jcfg
    from rapid_locomotion_rl_tpu.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu.parallel import sharding as JS
    from torch.distributed.tensor import Replicate, Shard
    from rapid_locomotion_rl_tpu_torch.convert import env_state_from_jax
    cfg = jcfg.config_mini_cheetah()
    cfg.env.num_envs = 16
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.teleport_robots = False
    env = LeggedRobotEnv(cfg)
    with jax.disable_jit():
        jstate = env.initial_state(jax.random.PRNGKey(0))
    jspecs = JS.env_axis_sharding(jstate, 16, JS.make_mesh(jax.devices()[:1]))
    jax_split = {}
    for path, s in jax.tree_util.tree_flatten_with_path(jspecs)[0]:
        key = tuple(str(getattr(p, "name", getattr(p, "key", p)))
                    for p in path)
        jax_split[key] = s.spec == JS.P("data")

    state = env_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    specs = SH.env_axis_sharding(state, 16)
    port_split = {}

    def walk(prefix, x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(prefix + (f,), getattr(x, f))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(prefix + (k,), v)
        else:
            assert isinstance(x, (Shard, Replicate))
            port_split[prefix] = isinstance(x, Shard)
    walk((), specs)
    assert set(port_split) == set(jax_split) - {("key",)}
    assert port_split == {k: jax_split[k] for k in port_split}
    assert port_split[("sim", "q")] and not port_split[("common_step_counter",)]
    assert not any(v for k, v in port_split.items() if k[0] == "curriculum")


def test_env_shard_rows():
    mesh = SH.Mesh(1, 2, torch.device("cpu"))
    shard = SH.EnvShard(mesh, 16, 12)
    assert (shard.local, shard.lo, shard.hi, shard.local_train) == (8, 8, 16, 4)
    assert SH.EnvShard(SH.Mesh(0, 2, torch.device("cpu")), 16,
                       12).local_train == 8
    assert torch.equal(shard.index("cpu"), torch.arange(8, 16))
    with pytest.raises(ValueError, match="do not split"):
        SH.EnvShard(mesh, 15, 15)


def test_place_env_state_keeps_rank_rows():
    """Rank 1 of 2 keeps envs 8-15 of every env-axis leaf; the curriculum
    and the step counter stay whole."""
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    env = LeggedRobotEnv(W.small_plane_cfg(), device="cpu")
    state = env.initial_state(Sampler(0, "cpu"))
    mine = SH.place_env_state(state, 16, SH.Mesh(1, 2, torch.device("cpu")))
    assert torch.equal(mine.sim.q, state.sim.q[8:])
    assert torch.equal(mine.episode_sums["total"],
                       state.episode_sums["total"][8:])
    assert torch.equal(mine.curriculum.weights, state.curriculum.weights)
    assert torch.equal(mine.common_step_counter, state.common_step_counter)


def test_sharded_sampler_keeps_rows_of_the_global_draw():
    """Env-axis draws at a rank's shape are the rank's rows of the global
    draw; the minibatch permutation is drawn whole; an unclassified stream,
    or an env-axis draw that does not lead with the rank's envs, raises."""
    from rapid_locomotion_rl_tpu_torch.sampler import Sampler
    shard = SH.EnvShard(SH.Mesh(1, 2, torch.device("cpu")), 16, 16)
    ref, mine = Sampler(3, "cpu"), SH.ShardedSampler(Sampler(3, "cpu"),
                                                     shard)
    torch.testing.assert_close(mine.uniform("push", (8, 2), -1.0, 1.0),
                               ref.uniform("push", (16, 2), -1.0, 1.0)[8:],
                               rtol=0, atol=0)
    assert torch.equal(mine.normal("action", (8, 12)),
                       ref.normal("action", (16, 12))[8:])
    assert torch.equal(mine.integers("terrain/levels", (8,), 0, 5),
                       ref.integers("terrain/levels", (16,), 0, 5)[8:])
    w = torch.rand(10)
    assert torch.equal(mine.categorical("resample/bins", w, 8),
                       ref.categorical("resample/bins", w, 16)[8:])
    assert torch.equal(mine.permutation("ppo/minibatch", 40),
                       ref.permutation("ppo/minibatch", 40))
    with pytest.raises(KeyError, match="not classified"):
        mine.uniform("mystery", (8,), 0.0, 1.0)
    with pytest.raises(ValueError, match="does not lead"):
        mine.uniform("push", (16, 2), 0.0, 1.0)


class RecordingSampler:
    """A Sampler that notes each draw's stream and shape."""

    def __init__(self, base, seen):
        self.base, self.seen = base, seen
        self.generator, self.device = base.generator, base.device

    def __getattr__(self, name):
        fn = getattr(self.base, name)

        def draw(stream, *args):
            shape = (args[1] if name == "categorical" else
                     args[0] if name == "permutation" else tuple(args[0]))
            self.seen.append((stream, name, shape))
            return fn(stream, *args)
        return draw


def test_every_stream_is_classified(tmp_path):
    """One Runner iteration on a small trimesh (resets, the terrain
    curriculum, pushes, eval envs and their reset, random episode lengths):
    every
    stream drawn from is in STREAM_AXES, each env-axis draw leads with the
    env count, and every entry of STREAM_AXES is drawn."""
    from rapid_locomotion_rl_tpu_torch.config import config_mini_cheetah
    from rapid_locomotion_rl_tpu_torch.envs.legged_robot import LeggedRobotEnv
    from rapid_locomotion_rl_tpu_torch.learn.runner import Runner, RunnerArgs
    cfg = config_mini_cheetah()
    cfg.env.num_envs, cfg.env.num_eval_envs = 8, 2
    cfg.terrain.num_rows, cfg.terrain.num_cols = 2, 3
    cfg.terrain.border_size = 5.0
    cfg.control.decimation = 1
    cfg.sim.num_substeps = 1
    cfg.env.episode_length_s = 0.1
    cfg.domain_rand.push_robots = True
    env = LeggedRobotEnv(cfg, device="cpu")
    runner = Runner(env, str(tmp_path / "run"), runner_args=RunnerArgs(
        num_steps_per_env=6, save_video_interval=0), device="cpu")
    seen = []
    runner.sampler = RecordingSampler(runner.sampler, seen)
    runner.env_state = env.initial_state(runner.sampler)
    runner.learn(1, init_at_random_ep_len=True, eval_freq=1)
    heads = set()
    for stream, kind, shape in seen:
        axis = SH.stream_axis(stream)
        heads.add(stream.split("/")[0])
        if axis == SH.ENV_AXIS:
            assert (shape if kind == "categorical" else shape[0]) == 8, \
                (stream, shape)
    assert heads == set(SH.STREAM_AXES)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def iterations(started):
    return job_results(started["iteration"])


def test_two_ranks_match_one_process(iterations):
    """tests/test_sharding.py's tolerances: KL and value loss at rtol 1e-3
    / atol 1e-5, the parameters at rtol 1e-4 / atol 1e-6 (that test holds
    the first leaf of JAX's tree, the actor's first bias). Every other
    leaf is held at the same tolerance on all but 0.1% of its entries:
    Adam's step on an entry with a near-zero gradient is about +-lr
    whatever the gradient's size, so a last-place difference in such a
    gradient (the sums' order over ranks, CPU matmuls of 8 rows against
    16) moves it by up to 2 lr. The LR, the curriculum weights and the
    command bins are equal; the rest of the curriculum's per-bin logs and
    the envs' state within 2e-5."""
    one, two = iterations
    for k in ("kl", "mean_value_loss"):
        torch.testing.assert_close(two["metrics"][k], one["metrics"][k],
                                   rtol=1e-3, atol=1e-5)
    for k in ("mean_surrogate_loss", "mean_adaptation_loss", "mean_reward",
              "train/episode/command_area", "ep_len_mean"):
        torch.testing.assert_close(two["metrics"][k], one["metrics"][k],
                                   rtol=1e-3, atol=1e-5)
    assert two["lr"] == one["lr"]
    torch.testing.assert_close(two["params"]["actor_body.layers.0.bias"],
                               one["params"]["actor_body.layers.0.bias"],
                               rtol=1e-4, atol=1e-6)
    for k, a in one["params"].items():
        close = (two["params"][k] - a).abs() <= 1e-6 + 1e-4 * a.abs()
        assert close.float().mean() >= 0.999, k
    assert torch.equal(two["curriculum"].weights, one["curriculum"].weights)
    from rapid_locomotion_rl_tpu_torch.envs import curriculum as curr
    cfg = W.small_plane_cfg()
    start = curr.init_state(curr.make_grid(cfg), cfg, "cpu").weights
    assert not torch.equal(one["curriculum"].weights, start), \
        "the curriculum did not move"
    for a, b in zip(two["curriculum"], one["curriculum"]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    assert torch.equal(two["bins"], one["bins"])
    for a, b in zip(two["sim"], one["sim"]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def test_train_cuda_distributed_two_processes(started):
    """scripts/train_cuda.py --device cpu --distributed --mesh data, two
    processes as torchrun starts them, 2 iterations at 64 plane envs: both
    exit 0, rank 0 prints the sharding line, and one checkpoint holds all
    64 envs."""
    procs, tmp_path = started["train"]
    procs.wait()
    out = open(procs.logs[0]).read()
    assert "sharding env axis over 2 devices (2 process(es))" in out, out
    assert "training mini_cheetah x64 envs" in out, out
    ckpt = tmp_path / "run" / "checkpoints" / "train_state_last.pkl"
    assert ckpt.exists()
    from rapid_locomotion_rl_tpu_torch.utils.checkpoint import load_pytree
    payload = load_pytree(str(ckpt))
    assert np.asarray(payload["env_state"].sim.q).shape[0] == 64
    assert payload["tot_timesteps"] == 2 * 24 * 64
    assert sorted(os.listdir(tmp_path)) == ["rank0.log", "rank1.log", "run"]
