"""The vectorized legged-robot velocity-tracking task (port of the JAX
package's ``envs/legged_robot.py``).

``env.step(state, actions, sampler) -> (state', StepResult)`` over an
:class:`EnvState` of batched tensors on the env's device. Resets are masked
``torch.where`` merges over the dense env axis; the decimated PD control
loop calls the physics step ``decimation`` times; command resampling and
the grid-adaptive curriculum run on the device. Every random draw goes
through the :class:`..sampler.Sampler` under a stream name.

Terrain: the plane, or a heightfield/trimesh grid from
:class:`.terrain.Terrain` with custom env origins, the spawn ranges around
them, a per-step window into the collision grid that every physics call of
the step looks up through, the edge teleport and the terrain curriculum.
With ``cfg.world`` enabled, every physics call also pushes the robot out
of the 4 walls of a corridor around its env origin (:mod:`.world`). With
``terrain.measure_heights`` the env senses the terrain grid's height under
a yaw-rotated grid of points around every base (the min-of-3 rule, through
a P x P window around the base as the JAX package's patch reads it) and
observes and rewards it. The asset is a URDF or an MJCF (``.xml``) file.

Data parallelism (:mod:`..parallel.sharding`): after
:meth:`LeggedRobotEnv.shard_env_axis` the env holds one rank's rows of the
env axis (``num_envs`` and the train/eval counts become the rank's,
``shard`` holds the global ones), draws through a
:class:`..parallel.sharding.ShardedSampler`, gathers the command
curriculum's inputs to global order before its update, and reports its
step metrics as this rank's share of the global sums and means (the
rollout's aggregation all-reduces them; ``REPLICATED_INFO`` are the same
on every rank).

Physics (``sim.physics_impl``): ``auto``, ``soa`` and ``pallas`` take the
limb-batched step :func:`..ops.cuda_physics.physics_step_cuda` (the CUDA
kernel on the card, its plain version on the CPU; the JAX package's SoA
step and Pallas kernel compute the same chain). ``aos`` takes the general
step :func:`..ops.physics.physics_step`, plain PyTorch on either device.
A tree with no limb layout takes ``aos`` whatever is asked, as in the JAX
package. Unlike the JAX package, ``auto`` on the CPU is not ``aos``: JAX
picks the AoS step there for its compile time, which eager PyTorch does not
have.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import ROOT_DIR
from ..config import Cfg, Derived, derive
from ..models import RobotModel, load_mjcf, load_urdf
from ..ops import quat as Q
from ..ops.contact import (TerrainGrid, blocked_window, square_window,
                           terrain_height_min3, terrain_height_min3_patch)
from ..ops.cuda_physics import physics_step_cuda
from ..ops.dynamics import PhysParams, SimState
from ..ops.limb_dynamics import layout_for
from ..ops.physics import physics_step
from ..parallel import sharding as SH
from . import curriculum as curr
from . import rewards as R
from .terrain import Terrain
from .world import WorldBoxes, box_sphere_forces, default_corridor

PHYSICS_IMPLS = ("auto", "pallas", "soa", "aos")


def get_scale_shift(rng):
    """(scale, shift) mapping a range to [-1, 1]."""
    scale = 2.0 / (rng[1] - rng[0])
    shift = (rng[0] + rng[1]) / 2.0
    return scale, shift


class DRState(NamedTuple):
    """Per-env domain-randomization tensors."""
    friction: torch.Tensor          # [N]
    restitution: torch.Tensor       # [N]
    payloads: torch.Tensor          # [N]
    com_displacements: torch.Tensor  # [N,3]
    motor_strengths: torch.Tensor   # [N,nv]
    Kp_factors: torch.Tensor        # [N,nv]
    Kd_factors: torch.Tensor        # [N,nv]


class EnvState(NamedTuple):
    sim: SimState                  # batched [N,...]
    dr: DRState
    commands: torch.Tensor          # [N, num_commands]
    env_command_bins: torch.Tensor  # [N] int64
    actions: torch.Tensor           # [N,na]
    last_actions: torch.Tensor      # [N,na]
    last_dof_vel: torch.Tensor      # [N,nv]
    torques: torch.Tensor           # [N,nv] last applied
    joint_pos_target: torch.Tensor  # [N,nv]
    episode_length: torch.Tensor    # [N] int32
    reset_buf: torch.Tensor         # [N] bool (this step's dones)
    time_out_buf: torch.Tensor      # [N] bool
    feet_air_time: torch.Tensor     # [N,num_feet]
    last_contacts: torch.Tensor     # [N,num_feet] bool
    contact_report: torch.Tensor    # [N,nr,3] last step's contact forces
    measured_heights: torch.Tensor  # [N,nhp] (nhp=1 when height sensing off)
    episode_sums: Dict[str, torch.Tensor]   # {name: [N]}
    command_sums: Dict[str, torch.Tensor]   # {name: [N]}
    curriculum: curr.CurriculumState
    env_origins: torch.Tensor       # [N,3]
    terrain_levels: torch.Tensor    # [N] int32
    terrain_types: torch.Tensor     # [N] int32
    obs: torch.Tensor               # [N,num_obs]
    privileged_obs: torch.Tensor    # [N,num_priv]
    obs_history: torch.Tensor       # [N, hist*num_obs]
    common_step_counter: torch.Tensor  # [] int32


class StepResult(NamedTuple):
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    obs_history: torch.Tensor
    rew: torch.Tensor               # [N]
    done: torch.Tensor              # [N] bool
    info: Dict[str, Any]


def _w(mask, a, b):
    """torch.where with a [N] mask broadcast over trailing axes of a and b."""
    if isinstance(a, torch.Tensor) and a.dim() > mask.dim():
        mask = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    elif isinstance(b, torch.Tensor) and b.dim() > mask.dim():
        mask = mask.reshape(mask.shape + (1,) * (b.dim() - mask.dim()))
    return torch.where(mask, a, b)


class LeggedRobotEnv:
    """Static task container: constants on the device, step functions.

    ``device`` defaults to ``cuda``; pass ``device="cpu"`` to run the plain
    physics step on the CPU."""

    # step metrics that every rank computes whole (the rest are its share)
    REPLICATED_INFO = ("train/episode/command_area",)

    def __init__(self, cfg: Cfg, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.derived: Derived = derive(cfg)
        self.num_envs = cfg.env.num_envs
        self.num_train_envs = self.derived.num_train_envs
        self.num_eval_envs = self.derived.num_eval_envs
        self.shard: Optional[SH.EnvShard] = None   # all envs in one process
        self.dt = self.derived.dt

        if cfg.terrain.mesh_type not in ("plane", "none", "heightfield",
                                         "trimesh"):
            raise ValueError(f"unknown terrain mesh {cfg.terrain.mesh_type}")
        # the corridor's walls around every env origin, in every physics
        # call (the JAX env's world_boxes, at the terrain's friction)
        self.world_boxes: Optional[WorldBoxes] = None
        if cfg.world.enabled:
            self.world_boxes = default_corridor(
                cfg.world.length, cfg.world.width, cfg.world.wall_height,
                cfg.world.wall_thickness)
        asset_path = cfg.asset.file.format(ROOT=ROOT_DIR)
        if asset_path.endswith(".xml"):
            self.model: RobotModel = load_mjcf(asset_path,
                                               armature=cfg.asset.armature)
        else:
            self.model = load_urdf(asset_path, armature=cfg.asset.armature,
                                   mesh_sphere_fit=cfg.asset.mesh_sphere_fit)
        m = self.model
        self.physics_impl = self._physics_impl()
        self.num_dof = m.nv
        self.num_actions = cfg.env.num_actions
        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.num_obs_history = cfg.env.num_observation_history * self.num_obs

        # ---- body index groups -----------------------------------------
        self.feet_indices = tuple(m.match_report_bodies([cfg.asset.foot_name]))
        self.termination_contact_indices = tuple(
            m.match_report_bodies(cfg.asset.terminate_after_contacts_on))
        self.penalised_contact_indices = tuple(
            m.match_report_bodies(cfg.asset.penalize_contacts_on))
        self.num_feet = len(self.feet_indices)

        # ---- default pose & PD gains -----------------------------------
        default_q = np.zeros(m.nv)
        p_gains = np.zeros(m.nv)
        d_gains = np.zeros(m.nv)
        for i, name in enumerate(m.joint_names):
            default_q[i] = cfg.init_state.default_joint_angles[name]
            found = False
            for key_, kp in cfg.control.stiffness.items():
                if key_ in name:
                    p_gains[i] = kp
                    d_gains[i] = cfg.control.damping[key_]
                    found = True
            if not found and cfg.control.control_type in ("P", "V"):
                print(f"PD gain of joint {name} not defined, setting to zero")
        t = self._t
        self.default_dof_pos = t(default_q)
        self.p_gains = t(p_gains)
        self.d_gains = t(d_gains)
        self.torque_limits = t(m.dof_effort)
        self.dof_vel_limits = t(m.dof_velocity)
        self.hip_mask = t(np.array(["hip" in n for n in m.joint_names],
                                   dtype=np.float32))

        # soft dof position limits
        lo = np.asarray(m.dof_lower)
        hi = np.asarray(m.dof_upper)
        mid = 0.5 * (lo + hi)
        rng_ = hi - lo
        soft = cfg.rewards.soft_dof_pos_limit
        self.dof_pos_limits = t(
            np.stack([mid - 0.5 * rng_ * soft, mid + 0.5 * rng_ * soft], -1))

        # ---- terrain ----------------------------------------------------
        tc = cfg.terrain
        self.custom_origins = tc.mesh_type in ("heightfield", "trimesh")
        self.collision_grid: Optional[TerrainGrid] = None
        self.terrain_grid: Optional[TerrainGrid] = None
        self._window = None
        if self.custom_origins:
            self.terrain = Terrain(tc, self.num_train_envs, None,
                                   self.num_eval_envs, seed=cfg.seed)
            raw = lambda: self.terrain.as_grid(  # noqa: E731
                tc.static_friction, tc.dynamic_friction, tc.restitution,
                device=self.device)
            if tc.mesh_type == "trimesh":
                # contact collides the slope-corrected surface: steep faces
                # are walls, as on the reference's trimesh; height sensing
                # reads the raw grid, as the reference's heightsamples
                self.collision_grid = self.terrain.as_collision_grid(
                    tc.static_friction, tc.dynamic_friction, tc.restitution,
                    upsample=getattr(tc, "collision_upsample", 1),
                    slope_threshold=tc.slope_treshold, device=self.device)
                if tc.measure_heights:
                    self.terrain_grid = raw()
            else:
                self.collision_grid = self.terrain_grid = raw()
            self.terrain_origins = self._t(tc.env_origins)  # [rows,cols,3]
            if self.physics_impl != "aos":   # the AoS step takes no window
                self._window = self._window_rule()
        self.height_points = None
        self._sense_patch_P = 0
        if cfg.terrain.measure_heights:
            gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                                 np.asarray(cfg.terrain.measured_points_y),
                                 indexing="ij")
            pts = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1)
            self.height_points = self._t(pts)            # [nhp, 3]
            self.num_height_points = gx.size
            # the window of the sensing patch: the yaw-rotated point grid's
            # radius plus slack, rounded up to a multiple of 8 cells
            r = float(np.max(np.linalg.norm(pts[:, :2], axis=-1)))
            cells = int(np.ceil(r / cfg.terrain.horizontal_scale)) + 3
            self._sense_patch_P = max(8, -(-2 * cells // 8) * 8)
        else:
            self.num_height_points = 1   # placeholder column (zeros)

        # ---- obs scaling & noise ---------------------------------------
        os_ = cfg.normalization.obs_scales
        self.commands_scale = t([os_.lin_vel, os_.lin_vel, os_.ang_vel])
        self.noise_scale_vec = t(self._make_noise_vec())

        # ---- reward bookkeeping ----------------------------------------
        self.reward_scales = dict(self.derived.reward_scales)  # already * dt
        self.reward_names = [n for n in self.reward_scales if n != "termination"]
        for name in self.reward_names:
            if name not in R.REWARD_REGISTRY:
                raise KeyError(f"unknown reward term {name}")
        self.episode_sum_keys = list(self.reward_scales.keys()) + ["total"]
        self.command_sum_keys = (list(self.reward_scales.keys())
                                 + ["lin_vel_raw", "ang_vel_raw",
                                    "lin_vel_residual", "ang_vel_residual",
                                    "ep_timesteps"])

        # ---- curriculum -------------------------------------------------
        self.curriculum_grid = curr.make_grid(cfg)
        self.resample_interval = self.derived.resample_interval
        ep_len_norm = min(self.derived.max_episode_length,
                          self.resample_interval)
        self.curr_ep_len = float(ep_len_norm)
        self.lin_vel_threshold = (cfg.commands.forward_curriculum_threshold
                                  * self.reward_scales.get("tracking_lin_vel", 0.0))
        self.ang_vel_threshold = (cfg.commands.yaw_curriculum_threshold
                                  * self.reward_scales.get("tracking_ang_vel", 0.0))
        self._dt_sub = cfg.sim.dt / max(int(cfg.sim.num_substeps), 1)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # ---- data parallelism ---------------------------------------------
    def shard_env_axis(self, mesh: SH.Mesh) -> SH.EnvShard:
        """Hold one rank's rows of the env axis from now on: ``num_envs``,
        ``num_train_envs`` and ``num_eval_envs`` become the rank's; the
        global counts stay in the returned ``shard``."""
        if self.shard is not None:
            raise RuntimeError("the env axis is already sharded")
        shard = SH.EnvShard(mesh, self.num_envs, self.num_train_envs)
        self.shard = shard
        self.num_envs = shard.local
        self.num_train_envs = shard.local_train
        self.num_eval_envs = shard.local - shard.local_train
        return shard

    def train_mask(self) -> torch.Tensor:
        """[N] bool: the envs this process holds that train (the others
        are eval envs, the last of the global env axis)."""
        if self.shard is None:
            return (torch.arange(self.num_envs, device=self.device)
                    < self.num_train_envs)
        return self.shard.index(self.device) < self.shard.num_train_envs

    def _mean_all(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of an [N] tensor over all envs: whole in one process,
        else this rank's share of it (its sum over the global count)."""
        if self.shard is None:
            return torch.mean(x)
        return torch.sum(x) / self.shard.num_envs

    def _physics_impl(self) -> str:
        """``aos`` for the general step, else ``soa`` (the limb-batched
        step: K1 on the card, its plain version on the CPU)."""
        impl = getattr(self.cfg.sim, "physics_impl", "auto")
        if impl not in PHYSICS_IMPLS:
            raise ValueError(f"unknown physics_impl {impl!r}, not one of "
                             f"{PHYSICS_IMPLS}")
        if impl != "aos" and layout_for(self.model) is None:
            print(f"physics: {self.model.name} has no limb layout; "
                  f"physics_impl {impl!r} -> 'aos' (the general step), as "
                  f"in the JAX package")
            impl = "aos"
        return "aos" if impl == "aos" else "soa"

    def _world_contact(self, origin, pos, vel, m_eff, dt):
        """The world boxes' penalty forces on the spheres for the AoS
        step (its ``extra_contact`` hook) at the terrain's friction."""
        sim = self.cfg.sim
        return box_sphere_forces(
            self.world_boxes, origin, pos, vel,
            torch.as_tensor(np.asarray(self.model.geom_radius, np.float32),
                            device=pos.device), m_eff,
            stiffness=sim.contact_stiffness, damping=sim.contact_damping,
            friction=self.cfg.terrain.static_friction,
            friction_vel_eps=sim.friction_vel_eps, dt=dt)

    def _origin_of(self, levels, types):
        """Origins of cells (level, type); indices past the last row or
        column take the last, as the JAX package's gather clamps them."""
        rows, cols = self.terrain_origins.shape[:2]
        return self.terrain_origins[levels.long().clamp(0, rows - 1),
                                    types.long().clamp(0, cols - 1)]

    def _window_rule(self):
        """How each env step places the window that its physics calls look
        the terrain up through, as the JAX env hoists its patch: a 32 x 128
        column block when the grid is at least that large (and the lookup
        is the einsum form), else a square of terrain_patch_size + 8 cells
        when the grid holds one, else none (each call then centers a
        terrain_patch_size square on its own entry state)."""
        sim = self.cfg.sim
        P = int(getattr(sim, "terrain_patch_size", 0) or 0)
        rows, cols = self.collision_grid.height.shape
        if P <= 0:
            return None
        if (getattr(sim, "terrain_lookup", "mm") == "mm" and rows >= 32
                and cols >= 128):
            return blocked_window
        if min(rows, cols) >= P + 8:
            return lambda g, x, y: square_window(g, x, y, P + 8)
        return None

    # ------------------------------------------------------------------
    def _make_noise_vec(self) -> np.ndarray:
        """Per-observation noise scales (reference `_get_noise_scale_vec`)."""
        cfg = self.cfg
        ns = cfg.noise.noise_scales
        os_ = cfg.normalization.obs_scales
        lvl = cfg.noise.noise_level
        parts = [np.ones(3) * ns.gravity * lvl]
        if cfg.env.observe_command:
            parts.append(np.zeros(3))
        parts.append(np.ones(self.num_dof) * ns.dof_pos * lvl * os_.dof_pos)
        parts.append(np.ones(self.num_dof) * ns.dof_vel * lvl * os_.dof_vel)
        parts.append(np.zeros(self.num_actions))
        vec = np.concatenate(parts)
        if cfg.env.observe_vel:
            vec = np.concatenate([np.ones(3) * ns.lin_vel * lvl * os_.lin_vel,
                                  np.ones(3) * ns.ang_vel * lvl * os_.ang_vel,
                                  vec])
        if cfg.env.observe_only_lin_vel:
            vec = np.concatenate([np.ones(3) * ns.lin_vel * lvl * os_.lin_vel,
                                  vec])
        if cfg.env.observe_only_ang_vel:
            vec = np.concatenate([np.ones(3) * ns.ang_vel * lvl * os_.ang_vel,
                                  vec])
        if cfg.env.observe_yaw:
            vec = np.concatenate([vec, np.zeros(1)])
        if cfg.terrain.measure_heights:
            vec = np.concatenate([
                vec, np.ones(self.num_height_points)
                * ns.height_measurements * lvl * os_.height_measurements])
        if vec.shape[0] != self.num_obs:
            raise ValueError(f"obs layout {vec.shape[0]} != "
                             f"num_observations {self.num_obs}")
        return vec

    # ------------------------------------------------------------------
    # initial state
    # ------------------------------------------------------------------
    def _env_origins(self, sampler):
        """Env origins (reference `_get_env_origins`): on a terrain mesh the
        origin of a cell (level row, type column), the levels drawn and the
        types spread evenly over the columns; on the plane a square grid."""
        N = self.num_envs
        # the types and the plane's grid follow the global env index
        N_all, mine = ((N, slice(None)) if self.shard is None else
                       (self.shard.num_envs,
                        slice(self.shard.lo, self.shard.hi)))
        tc = self.cfg.terrain
        if self.custom_origins:
            min_lvl, max_lvl = (tc.min_init_terrain_level,
                                tc.max_init_terrain_level)
            if not tc.curriculum:
                min_lvl, max_lvl = 0, tc.num_rows - 1
            levels = sampler.integers("terrain/init_levels", (N,), min_lvl,
                                      max_lvl + 1).to(torch.int32)
            types = np.floor_divide(np.arange(N_all, dtype=np.float32),
                                    np.float32(max(N_all / tc.num_cols, 1)))
            types = torch.as_tensor(
                types.astype(np.int32)[mine] % tc.num_cols,
                device=self.device)
            return self._origin_of(levels, types), levels, types
        spacing = self.cfg.env.env_spacing
        cols = int(np.floor(np.sqrt(N_all)))
        rows = int(np.ceil(N_all / cols))
        xx, yy = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        origins = np.zeros((N_all, 3), np.float32)
        origins[:, 0] = spacing * xx.ravel()[:N_all]
        origins[:, 1] = spacing * yy.ravel()[:N_all]
        zeros = torch.zeros(N, dtype=torch.int32, device=self.device)
        return self._t(origins[mine]), zeros, zeros.clone()

    def _sample_rigid_body_props(self, sampler, n, stream):
        """friction/restitution/payload/CoM draw."""
        dr = self.cfg.domain_rand
        dev = self.device
        friction = (sampler.uniform(f"{stream}/friction", (n,),
                                    *dr.friction_range)
                    if dr.randomize_friction
                    else torch.full((n,), self.cfg.terrain.static_friction,
                                    device=dev))
        restitution = (sampler.uniform(f"{stream}/restitution", (n,),
                                       *dr.restitution_range)
                       if dr.randomize_restitution
                       else torch.full((n,), self.cfg.terrain.restitution,
                                       device=dev))
        payload = (sampler.uniform(f"{stream}/payload", (n,),
                                   *dr.added_mass_range)
                   if dr.randomize_base_mass else torch.zeros(n, device=dev))
        com = (sampler.uniform(f"{stream}/com", (n, 3),
                               *dr.com_displacement_range)
               if dr.randomize_com_displacement
               else torch.zeros((n, 3), device=dev))
        return friction, restitution, payload, com

    def _sample_dof_props(self, sampler, n, stream):
        """motor strength / Kp / Kd factors (a per-env scalar broadcast
        over DOFs)."""
        dr = self.cfg.domain_rand
        ones = torch.ones((n, self.num_dof), device=self.device)
        motor = (sampler.uniform(f"{stream}/motor", (n, 1),
                                 *dr.motor_strength_range) * ones
                 if dr.randomize_motor_strength else ones)
        kp = (sampler.uniform(f"{stream}/kp", (n, 1), *dr.Kp_factor_range)
              * ones if dr.randomize_Kp_factor else ones)
        kd = (sampler.uniform(f"{stream}/kd", (n, 1), *dr.Kd_factor_range)
              * ones if dr.randomize_Kd_factor else ones)
        return motor, kp, kd

    def initial_state(self, sampler) -> EnvState:
        N = self.num_envs
        cfg = self.cfg
        dev = self.device
        origins, levels, types = self._env_origins(sampler)
        friction, restitution, payload, com = \
            self._sample_rigid_body_props(sampler, N, "init_rigid_props")
        motor, kpf, kdf = self._sample_dof_props(sampler, N, "init_dof_props")
        dr = DRState(friction, restitution, payload, com, motor, kpf, kdf)

        cstate = curr.init_state(self.curriculum_grid, cfg, dev)
        cmds, bins = curr.sample(self.curriculum_grid, cstate, sampler, N,
                                 "init_commands")
        cmds = self._zero_small_commands(cmds)
        commands = torch.zeros((N, cfg.commands.num_commands), device=dev)
        commands[:, :3] = cmds

        sim = self._reset_sim_states(
            torch.ones(N, dtype=torch.bool, device=dev), None, origins,
            sampler, "init_sim")

        zeros_nv = torch.zeros((N, self.num_dof), device=dev)
        z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
        state = EnvState(
            sim=sim, dr=dr, commands=commands,
            env_command_bins=bins,
            actions=z(N, self.num_actions),
            last_actions=z(N, self.num_actions),
            last_dof_vel=zeros_nv, torques=zeros_nv.clone(),
            joint_pos_target=zeros_nv + self.default_dof_pos,
            episode_length=torch.zeros(N, dtype=torch.int32, device=dev),
            reset_buf=torch.zeros(N, dtype=torch.bool, device=dev),
            time_out_buf=torch.zeros(N, dtype=torch.bool, device=dev),
            feet_air_time=z(N, self.num_feet),
            last_contacts=torch.zeros((N, self.num_feet), dtype=torch.bool,
                                      device=dev),
            contact_report=z(N, self.model.nr, 3),
            measured_heights=z(N, self.num_height_points),
            episode_sums={k: z(N) for k in self.episode_sum_keys},
            command_sums={k: z(N) for k in self.command_sum_keys},
            curriculum=cstate,
            env_origins=origins, terrain_levels=levels, terrain_types=types,
            obs=z(N, self.num_obs),
            privileged_obs=z(N, self.num_privileged_obs),
            obs_history=z(N, self.num_obs_history),
            common_step_counter=torch.zeros((), dtype=torch.int32,
                                            device=dev),
        )
        obs, priv = self._observe(state, sampler, "init_noise")
        return state._replace(obs=obs, privileged_obs=priv)

    # ------------------------------------------------------------------
    def _reset_sim_states(self, mask, sim: Optional[SimState], origins,
                          sampler, stream) -> SimState:
        """Masked re-initialization of the dynamics state."""
        N = self.num_envs
        cfg = self.cfg
        dev = self.device
        base_pos = self._t(cfg.init_state.pos) + origins
        if self.custom_origins:
            tc = cfg.terrain
            xy = torch.stack(
                [sampler.uniform(f"{stream}/x_init", (N,), -tc.x_init_range,
                                 tc.x_init_range) + tc.x_init_offset,
                 sampler.uniform(f"{stream}/y_init", (N,), -tc.y_init_range,
                                 tc.y_init_range) + tc.y_init_offset], dim=-1)
            base_pos = torch.cat([base_pos[:, :2] + xy, base_pos[:, 2:]],
                                 dim=-1)
        base_quat = self._t(cfg.init_state.rot).expand(N, 4)
        lo, hi = cfg.init_state.dof_init_range
        q = self.default_dof_pos * sampler.uniform(
            f"{stream}/dof", (N, self.num_dof), lo, hi)
        if cfg.init_state.randomize_root_vel:
            vel6 = sampler.uniform(f"{stream}/root_vel", (N, 6), -0.5, 0.5)
        else:
            vel6 = torch.zeros((N, 6), device=dev)
        new = SimState(
            base_pos=base_pos, base_quat=base_quat.contiguous(),
            base_lin_vel=vel6[:, :3].contiguous(),
            base_ang_vel=vel6[:, 3:].contiguous(),
            q=q, qd=torch.zeros((N, self.num_dof), device=dev))
        if sim is None:
            return new
        return SimState(*(_w(mask, a, b) for a, b in zip(new, sim)))

    # ------------------------------------------------------------------
    def _compute_torques(self, actions, sim: SimState, dr: DRState,
                         last_dof_vel=None):
        """PD torque controller (control types 'P', 'V', 'T')."""
        cfg = self.cfg
        scaled = actions[:, : self.num_dof] * cfg.control.action_scale
        scaled = scaled * (1.0 + (cfg.control.hip_scale_reduction - 1.0)
                           * self.hip_mask)
        ct = cfg.control.control_type
        if ct == "P":
            target = scaled + self.default_dof_pos
            tau = (self.p_gains * dr.Kp_factors * (target - sim.q)
                   - self.d_gains * dr.Kd_factors * sim.qd)
        elif ct == "V":
            target = sim.q
            if last_dof_vel is None:
                last_dof_vel = sim.qd
            tau = (self.p_gains * (scaled - sim.qd)
                   - self.d_gains * (sim.qd - last_dof_vel)
                   / self.cfg.sim.dt)
        elif ct == "T":
            target = sim.q
            tau = scaled
        else:
            raise NotImplementedError(f"control_type {ct}")
        tau = tau * dr.motor_strengths
        return torch.clamp(tau, -self.torque_limits, self.torque_limits), target

    # ------------------------------------------------------------------
    def _height_points_world(self, sim: SimState) -> torch.Tensor:
        """World positions [N, nhp, 3] of the sample grid, turned with each
        base's yaw and moved to its position."""
        pts = Q.quat_apply_yaw(sim.base_quat[:, None, :],
                               self.height_points[None, :, :])
        return pts + sim.base_pos[:, None, :]

    def _get_heights(self, sim: SimState) -> torch.Tensor:
        """Terrain heights [N, nhp] under the yaw-rotated sample grid around
        every base, by the min-of-3 rule on the terrain grid (zeros on the
        plane). Through each env's P x P window around its base where the
        JAX package reads a patch (terrain_patch_size set, the "mm" lookup,
        the grid at least P cells each way), else directly."""
        grid = self.terrain_grid
        if not self.cfg.terrain.measure_heights or grid is None:
            return torch.zeros((self.num_envs, self.num_height_points),
                               device=self.device)
        pts = self._height_points_world(sim)
        P = self._sense_patch_P
        simc = self.cfg.sim
        if (getattr(simc, "terrain_patch_size", 0)
                and getattr(simc, "terrain_lookup", "mm") == "mm"
                and P and min(grid.height.shape) >= P):
            return terrain_height_min3_patch(
                grid, sim.base_pos[:, 0], sim.base_pos[:, 1],
                pts[..., 0], pts[..., 1], P)
        return terrain_height_min3(grid, pts[..., 0], pts[..., 1])

    # ------------------------------------------------------------------
    def _observe(self, state: EnvState, sampler, stream):
        """Observations + privileged observations."""
        cfg = self.cfg
        sim = state.sim
        os_ = cfg.normalization.obs_scales
        gvec = self._t([0.0, 0.0, -1.0]).expand_as(sim.base_pos)
        projected_gravity = Q.quat_rotate_inverse(sim.base_quat, gvec)

        parts = [projected_gravity]
        if cfg.env.observe_command:
            parts.append(state.commands[:, :3] * self.commands_scale)
        parts.append((sim.q - self.default_dof_pos) * os_.dof_pos)
        parts.append(sim.qd * os_.dof_vel)
        parts.append(state.actions)
        obs = torch.cat(parts, dim=-1)

        if cfg.env.observe_vel:
            base_lin = Q.quat_rotate_inverse(sim.base_quat, sim.base_lin_vel)
            base_ang = Q.quat_rotate_inverse(sim.base_quat, sim.base_ang_vel)
            obs = torch.cat(
                [base_lin * os_.lin_vel, base_ang * os_.ang_vel, obs], dim=-1)
        if cfg.env.observe_only_lin_vel:
            base_lin = Q.quat_rotate_inverse(sim.base_quat, sim.base_lin_vel)
            obs = torch.cat([base_lin * os_.lin_vel, obs], dim=-1)
        if cfg.env.observe_only_ang_vel:
            base_ang = Q.quat_rotate_inverse(sim.base_quat, sim.base_ang_vel)
            obs = torch.cat([base_ang * os_.ang_vel, obs], dim=-1)
        if cfg.env.observe_yaw:
            heading = Q.yaw_from_quat(sim.base_quat)
            err = torch.clamp(0.5 * Q.wrap_to_pi(heading), -1.0, 1.0)
            obs = torch.cat([obs, err[:, None]], dim=-1)
        if cfg.terrain.measure_heights:
            heights = torch.clamp(
                sim.base_pos[:, 2:3] - 0.5 - state.measured_heights,
                -1.0, 1.0) * os_.height_measurements
            obs = torch.cat([obs, heights], dim=-1)

        if cfg.noise.add_noise:
            noise = sampler.uniform(stream, tuple(obs.shape), -1.0, 1.0)
            obs = obs + noise * self.noise_scale_vec

        clip_obs = cfg.normalization.clip_observations
        obs = torch.clamp(obs, -clip_obs, clip_obs)

        # privileged observations: scale-shifted DR params (18-d)
        nrm = cfg.normalization
        fs, fsh = get_scale_shift(nrm.friction_range)
        rs, rsh = get_scale_shift(nrm.restitution_range)
        ps, psh = get_scale_shift(nrm.added_mass_range)
        cs, csh = get_scale_shift(nrm.com_displacement_range)
        ms, msh = get_scale_shift(nrm.motor_strength_range)
        if not cfg.env.priv_observe_friction:
            fs = 0.0
        if not cfg.env.priv_observe_restitution:
            rs = 0.0
        if not cfg.env.priv_observe_base_mass:
            ps = 0.0
        if not cfg.env.priv_observe_com_displacement:
            cs = 0.0
        if not cfg.env.priv_observe_motor_strength:
            ms = 0.0
        dr = state.dr
        priv = torch.cat([
            (dr.friction[:, None] - fsh) * fs,
            (dr.restitution[:, None] - rsh) * rs,
            (dr.payloads[:, None] - psh) * ps,
            (dr.com_displacements - csh) * cs,
            (dr.motor_strengths - msh) * ms,
        ], dim=-1)
        priv = torch.clamp(priv, -clip_obs, clip_obs)
        return obs, priv

    # ------------------------------------------------------------------
    def _zero_small_commands(self, cmds):
        """commands with |v_xy| <= 0.2 are zeroed."""
        keep = (torch.linalg.norm(cmds[:, :2], dim=-1) > 0.2)[:, None]
        return torch.cat([cmds[:, :2] * keep.to(cmds.dtype), cmds[:, 2:]],
                         dim=-1)

    def _phys(self, sim, torques, phys_params, imp, window, origins):
        walls = self.world_boxes is not None
        if self.physics_impl == "aos":
            return physics_step(
                self.model, self.cfg.sim, sim, torques, phys_params,
                terrain=self.collision_grid,
                fixed_base=self.cfg.asset.fix_base_link, implicit_damp=imp,
                extra_contact=self._world_contact if walls else None,
                env_origin=origins if walls else None)
        return physics_step_cuda(
            self.model, self.cfg.sim, sim, torques, phys_params,
            terrain=self.collision_grid,
            fixed_base=self.cfg.asset.fix_base_link, implicit_damp=imp,
            world_boxes=self.world_boxes,
            env_origin=origins if walls else None,
            world_friction=self.cfg.terrain.static_friction,
            terrain_window=window)

    def _teleport(self, sim: SimState) -> SimState:
        """Edge teleport (reference legged_robot.py:768-791): a robot within
        teleport_thresh of the terrain's edge moves one span back in."""
        tc = self.cfg.terrain
        thresh = tc.teleport_thresh
        x_off = int(getattr(tc, "x_offset", 0) * tc.horizontal_scale)
        span_x = tc.terrain_length * (tc.num_rows - 1)
        span_y = tc.terrain_width * (tc.num_cols - 1)
        x = sim.base_pos[:, 0]
        y = sim.base_pos[:, 1]
        x = torch.where(x < thresh + x_off, x + span_x, x)
        x = torch.where(x > tc.terrain_length * tc.num_rows - thresh + x_off,
                        x - span_x, x)
        y = torch.where(y < thresh, y + span_y, y)
        y = torch.where(y > tc.terrain_width * tc.num_cols - thresh,
                        y - span_y, y)
        return sim._replace(base_pos=torch.stack(
            [x, y, sim.base_pos[:, 2]], dim=-1))

    def _context(self, sim, measured_heights, report, torques, actions,
                 last_actions, last_dof_vel, commands, rew_air, reset_buf,
                 time_out_buf):
        cfg = self.cfg
        gvec = self._t([0.0, 0.0, -1.0]).expand_as(sim.base_pos)
        return R.RewardContext(
            base_lin_vel=Q.quat_rotate_inverse(sim.base_quat,
                                               sim.base_lin_vel),
            base_ang_vel=Q.quat_rotate_inverse(sim.base_quat,
                                               sim.base_ang_vel),
            projected_gravity=Q.quat_rotate_inverse(sim.base_quat, gvec),
            base_height=torch.mean(sim.base_pos[:, 2:3] - measured_heights,
                                   dim=-1),
            dof_pos=sim.q, default_dof_pos=self.default_dof_pos,
            dof_vel=sim.qd, last_dof_vel=last_dof_vel,
            torques=torques, dof_pos_limits=self.dof_pos_limits,
            dof_vel_limits=self.dof_vel_limits,
            torque_limits=self.torque_limits,
            actions=actions, last_actions=last_actions,
            commands=commands, contact_forces=report,
            feet_indices=self.feet_indices,
            penalised_contact_indices=self.penalised_contact_indices,
            feet_air_time_reward=rew_air,
            reset_buf=reset_buf, time_out_buf=time_out_buf,
            tracking_sigma=cfg.rewards.tracking_sigma,
            tracking_sigma_yaw=cfg.rewards.tracking_sigma_yaw,
            base_height_target=cfg.rewards.base_height_target,
            soft_dof_vel_limit=cfg.rewards.soft_dof_vel_limit,
            soft_torque_limit=cfg.rewards.soft_torque_limit,
            max_contact_force=cfg.rewards.max_contact_force,
            dt=self.dt, global_reference=cfg.commands.global_reference,
            root_lin_vel_world=sim.base_lin_vel,
        )

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def step(self, state: EnvState, actions: torch.Tensor, sampler
             ) -> Tuple[EnvState, StepResult]:
        cfg = self.cfg
        N = self.num_envs
        dev = self.device

        clip_a = cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)

        # ---- decimated PD control + physics ------------------------------
        phys_params = PhysParams(
            friction=state.dr.friction, restitution=state.dr.restitution,
            payload=state.dr.payloads,
            com_displacement=state.dr.com_displacements)
        sim = state.sim
        torques = state.torques
        target = state.joint_pos_target
        report = state.contact_report

        # implicit-PD drive impedance (the ABA's joint_impedance diagonal)
        ct = cfg.control.control_type
        if not getattr(cfg.sim, "implicit_pd", True):
            imp = torch.zeros((N, self.num_dof), device=dev)
        elif ct == "P":
            imp = (self.d_gains * state.dr.Kd_factors
                   + self._dt_sub * self.p_gains * state.dr.Kp_factors
                   ) * state.dr.motor_strengths
        elif ct == "V":
            imp = (self.p_gains + self.d_gains / cfg.sim.dt
                   ) * state.dr.motor_strengths
        else:
            imp = torch.zeros((N, self.num_dof), device=dev)

        # the window of the terrain grid that this step's physics calls
        # look up through, placed once at the step's entry base position
        # (+8 cells of the square's slack cover the base's drift)
        window = (None if self._window is None else self._window(
            self.collision_grid, sim.base_pos[:, 0], sim.base_pos[:, 1]))

        for _ in range(cfg.control.decimation):
            torques, target = self._compute_torques(
                actions, sim, state.dr, last_dof_vel=state.last_dof_vel)
            out = self._phys(sim, torques, phys_params, imp, window,
                             state.env_origins)
            sim, report = out.state, out.contact_report

        episode_length = state.episode_length + 1
        common_step = state.common_step_counter + 1

        base_lin_vel = Q.quat_rotate_inverse(sim.base_quat, sim.base_lin_vel)
        base_ang_vel = Q.quat_rotate_inverse(sim.base_quat, sim.base_ang_vel)

        # ---- teleport ------------------------------------------------------
        if cfg.terrain.teleport_robots and self.custom_origins:
            sim = self._teleport(sim)

        # ---- push robots --------------------------------------------------
        if cfg.domain_rand.push_robots:
            push_mask = (episode_length % self.derived.push_interval == 0)
            mv = cfg.domain_rand.max_push_vel_xy
            push_vel = sampler.uniform("push", (N, 2), -mv, mv)
            lin = sim.base_lin_vel.clone()
            lin[:, :2] = _w(push_mask, push_vel, sim.base_lin_vel[:, :2])
            sim = sim._replace(base_lin_vel=lin)

        # ---- re-randomize dof props ---------------------------------------
        dr = state.dr
        rand_mask = (episode_length % self.derived.rand_interval == 0)
        motor, kpf, kdf = self._sample_dof_props(sampler, N, "dof_props")
        dr = dr._replace(
            motor_strengths=_w(rand_mask, motor, dr.motor_strengths),
            Kp_factors=_w(rand_mask, kpf, dr.Kp_factors),
            Kd_factors=_w(rand_mask, kdf, dr.Kd_factors))

        # ---- height sensing ----------------------------------------------
        measured_heights = (self._get_heights(sim)
                            if cfg.terrain.measure_heights
                            else state.measured_heights)

        # ---- termination --------------------------------------------------
        term_f = report[:, list(self.termination_contact_indices), :]
        reset_buf = torch.any(torch.linalg.norm(term_f, dim=-1) > 1.0, dim=-1)
        if cfg.env.auto_reset:
            time_out_buf = episode_length > self.derived.max_episode_length
            reset_buf = reset_buf | time_out_buf
        else:
            # low-level mode under a high-level policy: report contact
            # terminations only; never time out or self-reset
            time_out_buf = torch.zeros_like(reset_buf)
        base_height = torch.mean(sim.base_pos[:, 2:3] - measured_heights,
                                 dim=-1)
        if cfg.rewards.use_terminal_body_height:
            reset_buf = reset_buf | (base_height
                                     < cfg.rewards.terminal_body_height)

        # ---- feet air time bookkeeping -------------------------------------
        feet_z = report[:, list(self.feet_indices), 2]
        contact = feet_z > 1.0
        contact_filt = contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        feet_air_time = state.feet_air_time + self.dt
        rew_air = torch.sum((feet_air_time - 0.5) * first_contact, dim=-1)
        rew_air = rew_air * (torch.linalg.norm(state.commands[:, :2], dim=-1)
                             > 0.1)
        feet_air_time = feet_air_time * ~contact_filt
        last_contacts = contact

        # ---- rewards ---------------------------------------------------------
        ctx = self._context(sim, measured_heights, report, torques, actions,
                            state.last_actions, state.last_dof_vel,
                            state.commands, rew_air, reset_buf, time_out_buf)
        rew_buf = torch.zeros(N, device=dev)
        episode_sums = dict(state.episode_sums)
        command_sums = dict(state.command_sums)
        rew_term_gauges = {}
        for name in self.reward_names:
            term = R.REWARD_REGISTRY[name](ctx) * self.reward_scales[name]
            rew_buf = rew_buf + term
            episode_sums[name] = episode_sums[name] + term
            command_sums[name] = command_sums[name] + term
            rew_term_gauges[f"rew_terms/{name}"] = self._mean_all(term)
        raw_reward_mean = self._mean_all(rew_buf)
        if cfg.rewards.only_positive_rewards:
            rew_buf = torch.clamp(rew_buf, min=0.0)
        episode_sums["total"] = episode_sums["total"] + rew_buf
        if "termination" in self.reward_scales:
            term = R.termination(ctx) * self.reward_scales["termination"]
            rew_buf = rew_buf + term
            episode_sums["termination"] = episode_sums["termination"] + term
            command_sums["termination"] = command_sums["termination"] + term
        command_sums["lin_vel_raw"] = (command_sums["lin_vel_raw"]
                                       + base_lin_vel[:, 0])
        command_sums["ang_vel_raw"] = (command_sums["ang_vel_raw"]
                                       + base_ang_vel[:, 2])
        command_sums["lin_vel_residual"] = (
            command_sums["lin_vel_residual"]
            + (base_lin_vel[:, 0] - state.commands[:, 0]) ** 2)
        command_sums["ang_vel_residual"] = (
            command_sums["ang_vel_residual"]
            + (base_ang_vel[:, 2] - state.commands[:, 2]) ** 2)
        command_sums["ep_timesteps"] = command_sums["ep_timesteps"] + 1.0

        # ---- command resampling + curriculum ------------------------------
        apply_reset = (reset_buf if cfg.env.auto_reset
                       else torch.zeros_like(reset_buf))
        resample_mask = ((episode_length % self.resample_interval == 0)
                         | apply_reset)
        if not cfg.env.auto_reset:
            resample_mask = torch.zeros_like(apply_reset)
        train_mask = self.train_mask()
        cstate = state.curriculum
        commands = state.commands
        env_bins = state.env_command_bins
        if cfg.commands.command_curriculum:
            lin_rew = command_sums["tracking_lin_vel"] / self.curr_ep_len
            ang_rew = command_sums["tracking_ang_vel"] / self.curr_ep_len
            ts = torch.clamp(command_sums["ep_timesteps"], min=1.0)
            inputs = (env_bins, lin_rew, ang_rew, resample_mask & train_mask,
                      command_sums["lin_vel_raw"] / ts,
                      command_sums["ang_vel_raw"] / ts,
                      command_sums["ep_timesteps"])
            if self.shard is not None:
                # the replicated curriculum is updated from all envs, in
                # global order, on every rank: one all-reduce of the
                # columns (bins and mask are exact in float32)
                cols = SH.gather_env_axis(
                    torch.stack([c.float() for c in inputs], -1), self.shard)
                inputs = (cols[:, 0].long(), cols[:, 1], cols[:, 2],
                          cols[:, 3] > 0.5, *cols[:, 4:].unbind(-1))
            bins_all, lin_all, ang_all, mask_all, lvr, avr, dur = inputs
            cstate = curr.update(
                self.curriculum_grid, cstate, bins_all, lin_all, ang_all,
                mask_all, self.lin_vel_threshold, self.ang_vel_threshold,
                lin_vel_raw=lvr, ang_vel_raw=avr, ep_duration=dur)
            new_cmds, new_bins = curr.sample(
                self.curriculum_grid, cstate, sampler, N, "resample")
            new_cmds = self._zero_small_commands(new_cmds)
            commands = torch.cat(
                [_w(resample_mask, new_cmds, commands[:, :3]),
                 commands[:, 3:]], dim=-1)
            env_bins = _w(resample_mask, new_bins, env_bins)
        for k in command_sums:
            command_sums[k] = _w(resample_mask, 0.0, command_sums[k])

        # ---- terrain curriculum ---------------------------------------------
        env_origins = state.env_origins
        terrain_levels = state.terrain_levels
        if cfg.terrain.curriculum and self.custom_origins:
            tc = cfg.terrain
            dist = torch.linalg.norm(sim.base_pos[:, :2] - env_origins[:, :2],
                                     dim=-1)
            move_up = dist > tc.terrain_length / 2
            req = (torch.linalg.norm(commands[:, :2], dim=-1)
                   * cfg.env.episode_length_s * 0.5)
            move_down = (dist < req) & ~move_up
            lvl = (terrain_levels + move_up.to(torch.int32)
                   - move_down.to(torch.int32))
            rand_lvl = sampler.integers("terrain/levels", (N,), 0,
                                        tc.num_rows).to(torch.int32)
            lvl = torch.where(lvl >= tc.num_rows, rand_lvl,
                              torch.clamp(lvl, min=0))
            terrain_levels = torch.where(apply_reset, lvl, terrain_levels)
            new_origin = self._origin_of(terrain_levels, state.terrain_types)
            env_origins = _w(apply_reset, new_origin, env_origins)

        # ---- episode metric flush as masked reductions ----------------------
        reset_train = apply_reset & train_mask
        reset_eval = apply_reset & ~train_mask
        info: Dict[str, Any] = {}
        info["train_reset_count"] = torch.sum(reset_train)
        info["eval_reset_count"] = torch.sum(reset_eval)
        for k in self.episode_sum_keys:
            info[f"train/episode/rew_{k}/sum"] = torch.sum(
                _w(reset_train, episode_sums[k], 0.0))
            info[f"eval/episode/rew_{k}/sum"] = torch.sum(
                _w(reset_eval, episode_sums[k], 0.0))
        if cfg.terrain.curriculum:
            if self.shard is None:
                info["train/episode/terrain_level"] = torch.mean(
                    terrain_levels[: self.num_train_envs].float())
            else:
                info["train/episode/terrain_level"] = torch.sum(
                    terrain_levels[: self.num_train_envs].float()
                ) / self.shard.num_train_envs
        if cfg.commands.command_curriculum:
            info["train/episode/command_area"] = (
                torch.sum(cstate.weights) / cstate.weights.shape[0])
        info["env_bins"] = env_bins
        info["time_outs"] = time_out_buf
        info["raw_reward_mean"] = raw_reward_mean
        info.update(rew_term_gauges)
        info["done_rate"] = self._mean_all(reset_buf.float())
        info["ep_len_mean"] = self._mean_all(episode_length.float())
        info["cmd_norm_mean"] = self._mean_all(
            torch.linalg.norm(commands[:, :2], dim=-1))

        for k in episode_sums:
            episode_sums[k] = _w(apply_reset, 0.0, episode_sums[k])

        # ---- DR resample on reset --------------------------------------------
        motor, kpf, kdf = self._sample_dof_props(sampler, N,
                                                 "reset_dof_props")
        fric, rest, payl, com = self._sample_rigid_body_props(
            sampler, N, "reset_rigid_props")
        dr = DRState(
            friction=_w(apply_reset, fric, dr.friction),
            restitution=_w(apply_reset, rest, dr.restitution),
            payloads=_w(apply_reset, payl, dr.payloads),
            com_displacements=_w(apply_reset, com, dr.com_displacements),
            motor_strengths=_w(apply_reset, motor, dr.motor_strengths),
            Kp_factors=_w(apply_reset, kpf, dr.Kp_factors),
            Kd_factors=_w(apply_reset, kdf, dr.Kd_factors))

        # ---- masked state reset ------------------------------------------------
        sim = self._reset_sim_states(apply_reset, sim, env_origins, sampler,
                                     "reset_sim")
        last_actions = _w(apply_reset, 0.0, actions)
        last_dof_vel = _w(apply_reset, 0.0, sim.qd)
        feet_air_time = _w(apply_reset, 0.0, feet_air_time)
        new_episode_length = _w(apply_reset, 0, episode_length).to(torch.int32)

        new_state = state._replace(
            sim=sim, dr=dr, commands=commands, env_command_bins=env_bins,
            actions=actions, last_actions=last_actions,
            last_dof_vel=last_dof_vel, torques=torques,
            joint_pos_target=target,
            episode_length=new_episode_length,
            reset_buf=reset_buf, time_out_buf=time_out_buf,
            feet_air_time=feet_air_time, last_contacts=last_contacts,
            contact_report=report, measured_heights=measured_heights,
            episode_sums=episode_sums, command_sums=command_sums,
            curriculum=cstate, env_origins=env_origins,
            terrain_levels=terrain_levels,
            common_step_counter=common_step)

        # ---- observations (post-reset state) --------------------------------
        obs, priv = self._observe(new_state, sampler, "noise")
        obs_history = torch.cat(
            [state.obs_history[:, self.num_obs:], obs], dim=-1)
        new_state = new_state._replace(obs=obs, privileged_obs=priv,
                                       obs_history=obs_history)

        result = StepResult(obs=obs, privileged_obs=priv,
                            obs_history=obs_history, rew=rew_buf,
                            done=reset_buf, info=info)
        return new_state, result

    # ------------------------------------------------------------------
    def reward_terms(self, state: EnvState) -> Dict[str, torch.Tensor]:
        """Instantaneous per-term scaled rewards on the CURRENT state
        buffers (the reference's eval probe; the air-time term is an
        instantaneous approximation of the in-step value)."""
        report = state.contact_report
        feet_z = report[:, list(self.feet_indices), 2]
        contact = feet_z > 1.0
        contact_filt = contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filt
        rew_air = torch.sum((state.feet_air_time - 0.5) * first_contact,
                            dim=-1)
        rew_air = rew_air * (torch.linalg.norm(state.commands[:, :2], dim=-1)
                             > 0.1)
        ctx = self._context(state.sim, state.measured_heights, report,
                            state.torques, state.actions, state.last_actions,
                            state.last_dof_vel, state.commands, rew_air,
                            state.reset_buf, state.time_out_buf)
        return {name: R.REWARD_REGISTRY[name](ctx) * self.reward_scales[name]
                for name in self.reward_names}

    # ------------------------------------------------------------------
    def reset_envs(self, state: EnvState, mask: torch.Tensor, sampler
                   ) -> EnvState:
        """Explicit masked reset (eval-env resets, a high-level wrapper)."""
        sim = self._reset_sim_states(mask, state.sim, state.env_origins,
                                     sampler, "reset_envs/sim")
        motor, kpf, kdf = self._sample_dof_props(sampler, self.num_envs,
                                                 "reset_envs/dof_props")
        fric, rest, payl, com = self._sample_rigid_body_props(
            sampler, self.num_envs, "reset_envs/rigid_props")
        dr = DRState(
            friction=_w(mask, fric, state.dr.friction),
            restitution=_w(mask, rest, state.dr.restitution),
            payloads=_w(mask, payl, state.dr.payloads),
            com_displacements=_w(mask, com, state.dr.com_displacements),
            motor_strengths=_w(mask, motor, state.dr.motor_strengths),
            Kp_factors=_w(mask, kpf, state.dr.Kp_factors),
            Kd_factors=_w(mask, kdf, state.dr.Kd_factors))
        episode_sums = {k: _w(mask, 0.0, v)
                        for k, v in state.episode_sums.items()}
        return state._replace(
            sim=sim, dr=dr,
            last_actions=_w(mask, 0.0, state.last_actions),
            last_dof_vel=_w(mask, 0.0, state.last_dof_vel),
            feet_air_time=_w(mask, 0.0, state.feet_air_time),
            episode_length=_w(mask, 0, state.episode_length).to(torch.int32),
            episode_sums=episode_sums)
