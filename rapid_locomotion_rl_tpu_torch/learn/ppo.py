"""PPO with teacher-student distillation (port of the JAX package's
``learn/ppo.py``).

- :func:`rollout` collects the horizon under the teacher policy (the
  eval envs past ``num_train_envs`` act deterministically);
- :func:`compute_gae` is the reverse GAE sweep;
- :func:`ppo_update` runs 5 epochs x 4 minibatches over the train envs'
  transitions with one permutation reused across the epochs, the
  adaptive-KL learning rate changed between minibatches from each
  minibatch's KL, gradients clipped to a global norm, Adam applied at the
  carried learning rate, and the adaptation module's distillation step on
  its own Adam after each policy step;
- :func:`make_train_functions` returns the two halves of an iteration,
  ``(rollout_gae, update)``, as JAX's does;
- :func:`train_iteration` composes them. It stands for JAX's
  ``make_train_iteration`` without its ``split`` switch, which picks
  between one fused XLA program and two separately jitted halves: eager
  PyTorch runs the halves as they are, so there is nothing to choose.

On an env whose env axis is sharded over ranks (its ``shard``,
:mod:`..parallel.sharding`) each rank rolls out its own envs, and every
reduction over the batch is a sum all-reduced over the ranks: the
advantage normalization, each minibatch's losses and KL (sums over the
rank's share of the global minibatch over the global minibatch size) and
their gradients before the global-norm clip, the adaptation loss and its
gradients, the sysid residuals and the rollout's metrics. The KL that
drives the learning rate is the global one, so every rank takes the same
step and the parameters stay replicated.

The parameters live in the :class:`ActorCritic` module and are updated in
place; :class:`PPOState` carries the two optimizers and the learning rate.
The JAX package runs one optax Adam over the whole tree whose gradients are
zero off its group; two ``torch.optim.Adam`` over the two groups do the
same. Every random draw (action noise, the minibatch permutation) goes
through the :class:`..sampler.Sampler`.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.networks import (ActorCritic, normal_entropy, normal_kl,
                               normal_log_prob)
from ..parallel import sharding as SH


@dataclass
class PPOArgs:
    """Reference PPO_Args (the JAX package's defaults)."""
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1e-3
    adaptation_module_learning_rate: float = 1e-3
    num_adaptation_module_substeps: int = 1
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    max_lr: float = 1e-2
    entropy_warmup_iters: int = 300


class PPOState(NamedTuple):
    opt: torch.optim.Adam                 # policy, critic, encoder, std
    adapt_opt: Optional[torch.optim.Adam]  # adaptation module (or None)
    lr: float                              # adaptive LR, a float32 value


def init_ppo_state(ac: ActorCritic, ppo_args: PPOArgs) -> PPOState:
    """Fresh Adam states (optax's defaults: betas 0.9/0.999, eps 1e-8) over
    the module's two parameter groups."""
    adapt = (list(ac.adaptation_module.parameters())
             if ac.args.use_latent else [])
    ids = {id(p) for p in adapt}
    main = [p for p in ac.parameters() if id(p) not in ids]
    opt = torch.optim.Adam(main, lr=ppo_args.learning_rate, eps=1e-8)
    adapt_opt = (torch.optim.Adam(adapt,
                                  lr=ppo_args.adaptation_module_learning_rate,
                                  eps=1e-8) if adapt else None)
    return PPOState(opt, adapt_opt,
                    float(np.float32(ppo_args.learning_rate)))


class Transition(NamedTuple):
    """One rollout slot; ``rollout`` stacks them on a leading time axis."""
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    obs_history: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_prob: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    env_bins: torch.Tensor


@torch.no_grad()
def rollout(env, ac: ActorCritic, ppo_args: PPOArgs, env_state, sampler,
            num_steps: int, eval_expert: bool = False
            ) -> Tuple[Any, Transition, Dict[str, torch.Tensor]]:
    """Collect ``num_steps`` transitions with the current policy. Train envs
    act stochastically through the teacher policy; eval envs (those past
    ``env.num_train_envs``) act deterministically, through the teacher
    (``eval_expert``) or the student. Returns the final env state, the
    stacked transitions [T, N, ...] and the stacked scalar step metrics
    [T]. The metrics also hold env 0's pose after each step under
    ``_render/{pos,quat,q,origin}`` ([T, ...], the origin the one the step
    started from), which the Runner renders its videos from; an env state
    without a ``sim`` (the HLP's) logs none."""
    n_train = env.num_train_envs
    steps: List[Transition] = []
    infos: List[Dict[str, torch.Tensor]] = []
    # env-0 pose log: device buffers written in place, no host sync
    poses = ({name: torch.empty((num_steps,) + tuple(x.shape[1:]),
                                dtype=x.dtype, device=x.device)
              for name, x in (("pos", env_state.sim.base_pos),
                              ("quat", env_state.sim.base_quat),
                              ("q", env_state.sim.q),
                              ("origin", env_state.env_origins))}
             if hasattr(env_state, "sim") else {})
    for t in range(num_steps):
        obs = env_state.obs
        priv = env_state.privileged_obs
        hist = env_state.obs_history

        mean, std = ac.distribution(obs, priv)
        noise = sampler.normal("action", tuple(mean.shape))
        sampled = mean + std * noise
        values = ac.evaluate(obs, priv)
        log_prob = normal_log_prob(mean, std, sampled)
        if env.num_eval_envs > 0:
            det = (ac.act_teacher(obs, priv) if eval_expert
                   else ac.act_student(obs, hist))
            if hasattr(env, "train_mask"):
                train = env.train_mask()[:, None]
            else:
                train = torch.arange(obs.shape[0],
                                     device=obs.device)[:, None] < n_train
            actions = torch.where(train, sampled, det)
        else:
            actions = sampled

        if poses:
            poses["origin"][t] = env_state.env_origins[0]
        env_state, res = env.step(env_state, actions, sampler)
        if poses:
            poses["pos"][t] = env_state.sim.base_pos[0]
            poses["quat"][t] = env_state.sim.base_quat[0]
            poses["q"][t] = env_state.sim.q[0]
        # timeout bootstrap
        rewards = res.rew + ppo_args.gamma * values * res.info["time_outs"]

        steps.append(Transition(
            obs=obs, privileged_obs=priv, obs_history=hist,
            actions=actions, rewards=rewards, dones=res.done,
            values=values, log_prob=log_prob, mu=mean, sigma=std,
            env_bins=res.info["env_bins"]))
        infos.append({k: v for k, v in res.info.items()
                      if k not in ("env_bins", "time_outs")})
    traj = Transition(*(torch.stack(f) for f in zip(*steps)))
    info = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    info.update({f"_render/{k}": v for k, v in poses.items()})
    return env_state, traj, info


@torch.no_grad()
def compute_gae(traj: Transition, last_values, gamma: float, lam: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse-sweep GAE; returns (advantages, returns), each [T, N]."""
    adv_next = torch.zeros_like(last_values)
    v_next = last_values
    advs = [None] * traj.rewards.shape[0]
    for t in range(traj.rewards.shape[0] - 1, -1, -1):
        not_done = 1.0 - traj.dones[t].float()
        delta = traj.rewards[t] + not_done * gamma * v_next - traj.values[t]
        adv_next = delta + not_done * gamma * lam * adv_next
        v_next = traj.values[t]
        advs[t] = adv_next
    advantages = torch.stack(advs)
    return advantages, advantages + traj.values


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm, in place: (g / norm) * max_norm when the
    global norm reaches max_norm (no epsilon), else g unchanged."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))


def _adaptive_lr(lr: float, kl: float, ppo_args: PPOArgs) -> float:
    """The adaptive-KL rule in float32, from this minibatch's KL: /1.5
    (floor 1e-5) above twice the target, *1.5 (cap max_lr) below half of
    it when the KL is positive."""
    f = np.float32
    lr, kl = f(lr), f(kl)
    if kl > f(ppo_args.desired_kl * 2.0):
        lr = np.maximum(f(1e-5), lr / f(1.5))
    elif kl < f(ppo_args.desired_kl / 2.0) and kl > f(0.0):
        lr = np.minimum(f(ppo_args.max_lr), lr * f(1.5))
    return float(lr)


def _local_chunks(chunks: torch.Tensor, shard) -> list:
    """For each minibatch of global flat indices (time-major over the
    global train envs), the flat indices of the samples this rank holds
    (time-major over its own train envs), in the minibatch's order."""
    n_all, lo, n_loc = shard.num_train_envs, shard.lo, shard.local_train
    out = []
    for idx in chunks:
        t, e = idx // n_all, idx % n_all
        mine = (e >= lo) & (e < lo + n_loc)
        out.append(t[mine] * n_loc + (e[mine] - lo))
    return out


def ppo_update(ac: ActorCritic, ppo_args: PPOArgs, state: PPOState,
               traj: Transition, advantages, returns, sampler,
               num_train_envs: int, num_curriculum_bins: int = 0,
               entropy_coef=None, shard=None
               ) -> Tuple[PPOState, Dict[str, Any]]:
    """5 epochs x 4 minibatches over the flattened train-env transitions.
    Updates ``ac``'s parameters in place; returns the new state (its LR)
    and the JAX package's metrics: ``mean_value_loss``,
    ``mean_surrogate_loss``, ``mean_adaptation_loss``, ``kl``, ``lr``,
    ``mean_noise_std`` and, with curriculum bins, the per-bin sysid
    residual ``sysid_residual_sum`` / ``sysid_residual_count``. With a
    ``shard`` (:class:`..parallel.sharding.EnvShard`) ``traj`` holds this
    rank's envs and ``num_train_envs`` its train envs; the minibatches are
    the global ones, and every reduction is all-reduced over the ranks."""
    T = traj.obs.shape[0]
    n_all = num_train_envs if shard is None else shard.num_train_envs
    B_total = T * n_all
    nmb = ppo_args.num_mini_batches
    mb_size = B_total // nmb
    mesh = None if shard is None else shard.mesh

    def flat(x):
        return x[:, :num_train_envs].reshape(
            (T * num_train_envs,) + x.shape[2:])

    def mean_of(x):
        """The mean over the global minibatch: this rank's share."""
        if shard is None:
            return torch.mean(x)
        return torch.sum(x) / (mb_size * math.prod(x.shape[1:]))

    data = dict(
        obs=flat(traj.obs), priv=flat(traj.privileged_obs),
        hist=flat(traj.obs_history), actions=flat(traj.actions),
        values=flat(traj.values), log_prob=flat(traj.log_prob),
        mu=flat(traj.mu), sigma=flat(traj.sigma),
        adv=flat(advantages), ret=flat(returns))
    if num_curriculum_bins > 0:
        data["env_bins"] = flat(traj.env_bins).long()
    # advantage normalization over the whole batch (population std)
    a = data["adv"]
    if shard is None:
        data["adv"] = (a - a.mean()) / (a.std(correction=0) + 1e-8)
    else:   # two passes over the ranks' sums
        mu = SH.all_reduce_sum(a.sum(), mesh) / B_total
        var = SH.all_reduce_sum(((a - mu) ** 2).sum(), mesh) / B_total
        data["adv"] = (a - mu) / (torch.sqrt(var) + 1e-8)
    # one permutation, reused by every epoch
    chunks = sampler.permutation("ppo/minibatch", nmb * mb_size).reshape(
        nmb, mb_size)
    if shard is not None:
        chunks = _local_chunks(chunks, shard)

    ent_coef = ppo_args.entropy_coef if entropy_coef is None else entropy_coef
    main_params = [p for g in state.opt.param_groups for p in g["params"]]
    n_adapt = (ppo_args.num_adaptation_module_substeps
               if ac.args.use_latent else 0)
    adapt_params = ([p for g in state.adapt_opt.param_groups
                     for p in g["params"]] if n_adapt else [])
    dev = traj.obs.device
    nb = max(num_curriculum_bins, 1)
    resid_sum = torch.zeros(nb, device=dev)
    resid_cnt = torch.zeros(nb, device=dev)
    lr = state.lr
    rec = {k: [] for k in ("value_loss", "surrogate_loss", "adaptation_loss",
                           "kl")}
    clip = ppo_args.clip_param
    for _ in range(ppo_args.num_learning_epochs):
        for i in range(nmb):
            idx = chunks[i]
            mb = {k: v[idx] for k, v in data.items()}
            mean_a, std = ac.distribution(mb["obs"], mb["priv"])
            log_prob = normal_log_prob(mean_a, std, mb["actions"])
            value = ac.evaluate(mb["obs"], mb["priv"])
            entropy = normal_entropy(std)
            kl = mean_of(normal_kl(mb["mu"], mb["sigma"], mean_a,
                                   std)).detach()
            ratio = torch.exp(torch.clamp(log_prob - mb["log_prob"],
                                          -20.0, 20.0))
            surr = -mb["adv"] * ratio
            surr_clipped = -mb["adv"] * torch.clamp(ratio, 1.0 - clip,
                                                    1.0 + clip)
            surrogate_loss = mean_of(torch.maximum(surr, surr_clipped))
            if ppo_args.use_clipped_value_loss:
                v_clipped = mb["values"] + torch.clamp(
                    value - mb["values"], -clip, clip)
                v_loss = mean_of(torch.maximum((value - mb["ret"]) ** 2,
                                               (v_clipped - mb["ret"]) ** 2))
            else:
                v_loss = mean_of((mb["ret"] - value) ** 2)
            loss = (surrogate_loss + ppo_args.value_loss_coef * v_loss
                    - ent_coef * mean_of(entropy))
            grads = torch.autograd.grad(loss, main_params)
            if shard is not None:
                kl, surrogate_loss, v_loss, *grads = SH.all_reduce_flat(
                    [kl, surrogate_loss.detach(), v_loss.detach(), *grads],
                    mesh)

            # the LR changes before this minibatch's step, from its KL
            if (ppo_args.desired_kl is not None
                    and ppo_args.schedule == "adaptive"):
                lr = _adaptive_lr(lr, kl.item(), ppo_args)
            _clip_by_global_norm(grads, ppo_args.max_grad_norm)
            for p, g in zip(main_params, grads):
                p.grad = g
            for group in state.opt.param_groups:
                group["lr"] = lr
            state.opt.step()

            # adaptation module distillation at the updated params
            a_loss = torch.zeros((), device=dev)
            for _ in range(n_adapt):
                pred = ac.student_latent(mb["hist"])
                with torch.no_grad():
                    target = ac.teacher_latent(mb["priv"])
                a_loss_i = mean_of((pred - target) ** 2)
                if num_curriculum_bins > 0:
                    with torch.no_grad():
                        residual = torch.linalg.norm(target - pred, dim=-1)
                        resid_sum.index_add_(0, mb["env_bins"], residual)
                        resid_cnt.index_add_(0, mb["env_bins"],
                                             torch.ones_like(residual))
                a_grads = torch.autograd.grad(a_loss_i, adapt_params)
                if shard is not None:
                    a_loss_i, *a_grads = SH.all_reduce_flat(
                        [a_loss_i.detach(), *a_grads], mesh)
                for p, g in zip(adapt_params, a_grads):
                    p.grad = g
                state.adapt_opt.step()
                a_loss = a_loss + a_loss_i.detach()
            a_loss = a_loss / max(n_adapt, 1)

            rec["value_loss"].append(v_loss.detach())
            rec["surrogate_loss"].append(surrogate_loss.detach())
            rec["adaptation_loss"].append(a_loss)
            rec["kl"].append(kl)

    metrics = {f"mean_{k}" if "loss" in k else k: torch.mean(torch.stack(v))
               for k, v in rec.items()}
    metrics["lr"] = torch.tensor(lr, device=dev)
    metrics["mean_noise_std"] = ac.std.detach().mean()
    if num_curriculum_bins > 0 and shard is not None:
        resid_sum, resid_cnt = SH.all_reduce_flat([resid_sum, resid_cnt],
                                                  mesh)
    if num_curriculum_bins > 0:
        metrics["sysid_residual_sum"] = resid_sum
        metrics["sysid_residual_count"] = resid_cnt
    return state._replace(lr=lr), metrics


def _aggregate_rollout_metrics(traj: Transition, infos, shard=None,
                               replicated=()):
    """Episode-sum accumulators add over the T axis; gauges take the
    last step's value; the ``_render/*`` pose log passes whole. With a
    ``shard`` each metric but the ``replicated`` ones is this rank's share,
    and the shares are summed over the ranks in one all-reduce."""
    out = {}
    for k, v in infos.items():
        if k.startswith("_render/"):
            out[k] = v
        elif "/sum" in k or k.endswith("_count"):
            out[k] = torch.sum(v, dim=0)
        else:
            out[k] = v[-1]
    if shard is None:
        out["mean_reward"] = torch.mean(traj.rewards)
        out["mean_episode_dones"] = torch.mean(traj.dones.float())
        return out
    n = traj.rewards.shape[0] * shard.num_envs
    out["mean_reward"] = torch.sum(traj.rewards) / n
    out["mean_episode_dones"] = torch.sum(traj.dones.float()) / n
    keys = [k for k in out if not k.startswith("_render/")
            and k not in replicated]
    for k, v in zip(keys, SH.all_reduce_flat([out[k] for k in keys],
                                             shard.mesh)):
        out[k] = v
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_functions(env, ac: ActorCritic, ppo_args: PPOArgs,
                         num_steps_per_env: int, eval_expert: bool = False):
    """The two halves of a training iteration, ``(rollout_gae, update)``
    (the JAX package's ``make_train_functions``).

    - ``rollout_gae(env_state, sampler)`` returns ``(env_state, traj,
      advantages, returns, metrics)``; the metrics hold the rollout's
      aggregates and env 0's ``_render/*`` pose log.
    - ``update(ppo_state, traj, advantages, returns, sampler,
      entropy_coef=None)`` returns ``(ppo_state, metrics)``; it takes the
      curriculum-bin count from the env (none without the adaptation
      module) and, on a sharded env, the env's ``shard``.

    JAX's ``rollout_gae`` takes the parameters as an argument; here they
    live in ``ac`` and ``update`` changes them in place, so ``rollout_gae``
    takes none and always rolls out the current policy."""
    shard = getattr(env, "shard", None)
    nbins = (env.curriculum_grid.num_bins
             if getattr(env, "curriculum_grid", None) is not None
             and ac.args.use_latent else 0)

    def rollout_gae(env_state, sampler):
        env_state, traj, infos = rollout(env, ac, ppo_args, env_state,
                                         sampler, num_steps_per_env,
                                         eval_expert)
        with torch.no_grad():
            last_values = ac.evaluate(env_state.obs,
                                      env_state.privileged_obs)
        adv, ret = compute_gae(traj, last_values, ppo_args.gamma,
                               ppo_args.lam)
        metrics = _aggregate_rollout_metrics(
            traj, infos, shard, getattr(env, "REPLICATED_INFO", ()))
        return env_state, traj, adv, ret, metrics

    def update(ppo_state: PPOState, traj, advantages, returns, sampler,
               entropy_coef=None):
        return ppo_update(ac, ppo_args, ppo_state, traj, advantages,
                          returns, sampler, env.num_train_envs,
                          num_curriculum_bins=nbins,
                          entropy_coef=entropy_coef, shard=shard)

    return rollout_gae, update


def train_iteration(env, ac: ActorCritic, ppo_args: PPOArgs, env_state,
                    ppo_state: PPOState, sampler, entropy_coef=None,
                    num_steps: int = 24, timings: Optional[Dict] = None,
                    eval_expert: bool = False):
    """One training iteration: :func:`make_train_functions`' rollout+GAE
    half, then its update half, both drawing from ``sampler``. Returns the
    new env state, the new PPO state and the rollout and update metrics.
    With ``timings`` (a dict), the device is synchronised after each half
    and their wall times are stored under ``rollout_s`` and
    ``update_s``."""
    rollout_gae, update = make_train_functions(env, ac, ppo_args, num_steps,
                                               eval_expert)
    t0 = time.perf_counter()
    env_state, traj, adv, ret, metrics = rollout_gae(env_state, sampler)
    if timings is not None:
        _sync(traj.obs.device)
        t1 = time.perf_counter()
        timings["rollout_s"] = t1 - t0
    ppo_state, update_metrics = update(ppo_state, traj, adv, ret, sampler,
                                       entropy_coef)
    if timings is not None:
        _sync(traj.obs.device)
        timings["update_s"] = time.perf_counter() - t1
    return env_state, ppo_state, {**metrics, **update_metrics}
