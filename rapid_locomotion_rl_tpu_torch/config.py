"""Config tree for the PyTorch legged-robot stack (a copy of the JAX
package's ``config.py``, so both packages read the same configs).

Mirrors every tunable leaf of the reference config schema
(reference: mini_gym/envs/base/legged_robot_config.py:6-257) as plain
dataclasses, plus the per-robot constructor functions
(reference: mini_gym/envs/mini_cheetah/mini_cheetah_config.py:8-106,
mini_gym/envs/go1/go1_config.py:8-107).

Differences from the reference by design (SURVEY.md §5.6):
- configs are plain data, no global singletons; robot configs return a fresh
  mutated copy instead of mutating a process-global class;
- derived values (max_episode_length, push/rand intervals, reward scales × dt)
  are computed by a pure :func:`derive` pass into a separate ``Derived``
  record instead of being written back into the config (the reference's
  ``_parse_cfg`` aliasing quirk is intentionally not reproduced);
- serialization is JSON (``to_dict`` / ``from_dict``) next to checkpoints.

The config is plain host data; the physics kernel reads the few leaves it
needs from a constant table packed once per model (ops/cuda_physics.py).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _f(x):
    return field(default_factory=lambda: list(x))


@dataclass
class EnvCfg:
    # reference legged_robot_config.py:7-30
    num_envs: int = 4096
    num_observations: int = 235
    num_privileged_obs: int = 18
    privileged_future_horizon: int = 1
    num_actions: int = 12
    num_observation_history: int = 15
    env_spacing: float = 3.0
    send_timeouts: bool = True
    episode_length_s: float = 20.0
    observe_vel: bool = True
    observe_only_ang_vel: bool = False
    observe_only_lin_vel: bool = False
    observe_yaw: bool = False
    observe_command: bool = True
    record_video: bool = False

    priv_observe_friction: bool = True
    priv_observe_restitution: bool = True
    priv_observe_base_mass: bool = True
    priv_observe_com_displacement: bool = True
    priv_observe_motor_strength: bool = True
    priv_observe_Kp_factor: bool = True
    priv_observe_Kd_factor: bool = True

    # fraction of envs used for training; rest are eval envs (base_task.py:43-50)
    num_eval_envs: int = 0
    # False = the dhruvmetha-fork low-level semantics for HLP stacking
    # (legged_robot.py:177, :196-198: terminations are *reported* but the env
    # does not reset or resample itself; the outer layer calls reset_envs)
    auto_reset: bool = True


@dataclass
class TerrainCfg:
    # reference legged_robot_config.py:32-67
    mesh_type: str = "trimesh"  # none, plane, heightfield, trimesh
    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 0.0
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    terrain_noise_magnitude: float = 0.1
    terrain_smoothness: float = 0.005
    measure_heights: bool = True
    measured_points_x: List[float] = _f(
        [-0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0,
         0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    measured_points_y: List[float] = _f(
        [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5])
    selected: bool = False
    terrain_kwargs: Optional[Dict[str, Any]] = None
    min_init_terrain_level: int = 0
    max_init_terrain_level: int = 5
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10
    num_cols: int = 20
    terrain_proportions: List[float] = _f([0.1, 0.1, 0.35, 0.25, 0.2])
    slope_treshold: float = 0.75
    # trimesh collision fidelity: steep faces become walls on a grid this
    # many times finer than the raw heightfield (Terrain.as_collision_grid;
    # matches the reference's slope-corrected trimesh upload,
    # mini_gym/utils/terrain.py:36-40). 1 = collide the raw bilinear grid.
    collision_upsample: int = 2
    difficulty_scale: float = 1.0
    x_init_range: float = 1.0
    y_init_range: float = 1.0
    x_init_offset: float = 0.0
    y_init_offset: float = 0.0
    teleport_robots: bool = True
    teleport_thresh: float = 2.0
    max_platform_height: float = 0.2


@dataclass
class CommandsCfg:
    # reference legged_robot_config.py:69-100
    command_curriculum: bool = False
    max_reverse_curriculum: float = 1.0
    max_forward_curriculum: float = 1.0
    forward_curriculum_threshold: float = 0.8
    yaw_command_curriculum: bool = False
    max_yaw_curriculum: float = 1.0
    yaw_curriculum_threshold: float = 0.5
    num_commands: int = 4
    resampling_time: float = 10.0
    heading_command: bool = True
    global_reference: bool = False

    num_lin_vel_bins: int = 20
    lin_vel_step: float = 0.3
    num_ang_vel_bins: int = 20
    ang_vel_step: float = 0.3
    distribution_update_extension_distance: float = 1.0
    curriculum_seed: int = 100

    lin_vel_x: List[float] = _f([-1.0, 1.0])
    lin_vel_y: List[float] = _f([-1.0, 1.0])
    ang_vel_yaw: List[float] = _f([-1.0, 1.0])
    body_height_cmd: List[float] = _f([-0.05, 0.05])
    impulse_height_commands: bool = False

    limit_vel_x: List[float] = _f([-10.0, 10.0])
    limit_vel_y: List[float] = _f([-0.6, 0.6])
    limit_vel_yaw: List[float] = _f([-10.0, 10.0])

    heading: List[float] = _f([-3.14, 3.14])

    # grid-adaptive-curriculum bin counts (51x2x51 in the reference,
    # legged_robot.py:1056-1064)
    curriculum_x_bins: int = 51
    curriculum_y_bins: int = 2
    curriculum_yaw_bins: int = 51


@dataclass
class InitStateCfg:
    # reference legged_robot_config.py:102-108
    pos: List[float] = _f([0.0, 0.0, 1.0])
    rot: List[float] = _f([0.0, 0.0, 0.0, 1.0])  # xyzw
    lin_vel: List[float] = _f([0.0, 0.0, 0.0])
    ang_vel: List[float] = _f([0.0, 0.0, 0.0])
    default_joint_angles: Dict[str, float] = field(
        default_factory=lambda: {"joint_a": 0.0, "joint_b": 0.0})
    # Reset randomization. The reference's COMMITTED reset code spawns the
    # exact default pose with zero root velocity — both the legged_gym-style
    # dof randomization (default * U(0.5,1.5)) and the +-0.5 root-velocity
    # draw are commented out (reference legged_robot.py:702-706, :736-737).
    # Round-2 shipped the upstream-randomized variant; survival forensics
    # (scripts/diag_survival.py, EXPERIMENTS.md round 3) showed collapsed
    # spawns on rough terrain die via thigh contact within ~1s even under
    # ZERO actions, poisoning the early only-positive-clipped reward
    # landscape. Defaults now match the fork's committed semantics; the
    # knobs remain for A/B.
    dof_init_range: List[float] = _f([1.0, 1.0])
    randomize_root_vel: bool = False


@dataclass
class ControlCfg:
    # reference legged_robot_config.py:110-119
    control_type: str = "P"  # P: position, V: velocity, T: torques
    stiffness: Dict[str, float] = field(default_factory=lambda: {"joint_a": 10.0, "joint_b": 15.0})
    damping: Dict[str, float] = field(default_factory=lambda: {"joint_a": 1.0, "joint_b": 1.5})
    action_scale: float = 0.5
    hip_scale_reduction: float = 1.0
    decimation: int = 4


@dataclass
class AssetCfg:
    # reference legged_robot_config.py:121-142
    file: str = ""
    foot_name: str = "None"
    penalize_contacts_on: List[str] = _f([])
    terminate_after_contacts_on: List[str] = _f([])
    disable_gravity: bool = False
    collapse_fixed_joints: bool = True
    fix_base_link: bool = False
    default_dof_drive_mode: int = 3
    self_collisions: int = 0
    replace_cylinder_with_capsule: bool = True
    flip_visual_attachments: bool = True
    density: float = 0.001
    angular_damping: float = 0.0
    linear_damping: float = 0.0
    max_angular_velocity: float = 1000.0
    max_linear_velocity: float = 1000.0
    armature: float = 0.0
    thickness: float = 0.01
    # sphere decomposition of mesh collision shapes: "legacy" (round 1-3
    # hand-measured) or "hull" (fitted to the collision-mesh convex hull
    # PhysX actually collides — fixes the 3.4 cm leg-length overshoot and
    # covers the knee clevis knob; EXPERIMENTS.md §14). Flip planned for
    # round 4 after re-goldening.
    mesh_sphere_fit: str = "legacy"


@dataclass
class DomainRandCfg:
    # reference legged_robot_config.py:144-164
    rand_interval_s: float = 10.0
    randomize_friction: bool = True
    friction_range: List[float] = _f([0.5, 1.25])
    randomize_restitution: bool = False
    restitution_range: List[float] = _f([0.0, 1.0])
    randomize_base_mass: bool = False
    added_mass_range: List[float] = _f([-1.0, 1.0])
    randomize_com_displacement: bool = False
    com_displacement_range: List[float] = _f([-0.15, 0.15])
    randomize_motor_strength: bool = False
    motor_strength_range: List[float] = _f([0.9, 1.1])
    randomize_Kp_factor: bool = False
    Kp_factor_range: List[float] = _f([0.8, 1.3])
    randomize_Kd_factor: bool = False
    Kd_factor_range: List[float] = _f([0.5, 1.5])
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0


@dataclass
class RewardScalesCfg:
    # reference legged_robot_config.py:180-197; zero scales disable the term
    termination: float = -0.0
    tracking_lin_vel: float = 1.0
    tracking_ang_vel: float = 0.5
    lin_vel_z: float = -2.0
    ang_vel_xy: float = -0.05
    orientation: float = -0.0
    torques: float = -0.00001
    dof_vel: float = -0.0
    dof_acc: float = -2.5e-7
    base_height: float = -0.0
    feet_air_time: float = 1.0
    collision: float = -1.0
    feet_stumble: float = -0.0
    action_rate: float = -0.01
    stand_still: float = -0.0
    tracking_lin_vel_lat: float = 0.0
    tracking_lin_vel_long: float = 0.0
    # additional registry members available in the reference env
    # (legged_robot.py:1506-1646), off by default
    energy: float = 0.0
    energy_expenditure: float = 0.0
    survival: float = 0.0
    dof_pos_limits: float = 0.0
    dof_vel_limits: float = 0.0
    torque_limits: float = 0.0
    feet_contact_forces: float = 0.0

    def nonzero(self) -> Dict[str, float]:
        return {k: v for k, v in dataclasses.asdict(self).items() if v != 0.0}


@dataclass
class RewardsCfg:
    # reference legged_robot_config.py:166-178
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25
    tracking_sigma_lat: float = 0.25
    tracking_sigma_long: float = 0.25
    tracking_sigma_yaw: float = 0.25
    soft_dof_pos_limit: float = 1.0
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 1.0
    max_contact_force: float = 100.0
    use_terminal_body_height: bool = False
    terminal_body_height: float = 0.20
    scales: RewardScalesCfg = field(default_factory=RewardScalesCfg)


@dataclass
class ObsScalesCfg:
    # reference legged_robot_config.py:200-206
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    height_measurements: float = 5.0
    body_height_cmd: float = 2.0


@dataclass
class NormalizationCfg:
    # reference legged_robot_config.py:199-217
    obs_scales: ObsScalesCfg = field(default_factory=ObsScalesCfg)
    clip_observations: float = 100.0
    clip_actions: float = 100.0
    friction_range: List[float] = _f([0.05, 4.5])
    restitution_range: List[float] = _f([0.0, 1.0])
    added_mass_range: List[float] = _f([-1.0, 3.0])
    com_displacement_range: List[float] = _f([-0.1, 0.1])
    motor_strength_range: List[float] = _f([0.9, 1.1])
    Kp_factor_range: List[float] = _f([0.8, 1.3])
    Kd_factor_range: List[float] = _f([0.5, 1.5])


@dataclass
class NoiseScalesCfg:
    # reference legged_robot_config.py:223-229
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    height_measurements: float = 0.1


@dataclass
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    noise_scales: NoiseScalesCfg = field(default_factory=NoiseScalesCfg)


@dataclass
class SimCfg:
    # reference legged_robot_config.py:237-256; solver knobs map onto the
    # physics step (ops/soa_physics.py) instead of PhysX
    dt: float = 0.005
    substeps: int = 1
    gravity: List[float] = _f([0.0, 0.0, -9.81])
    up_axis: int = 1  # 0 = y, 1 = z
    # contact model parameters (replacement for the physx block);
    # solved implicitly per sphere against its body mass — see ops/contact.py
    contact_stiffness: float = 30000.0  # penalty spring [N/m] (legacy model)
    contact_damping: float = 200.0      # penalty damper [N*s/m] (legacy model)
    friction_vel_eps: float = 0.1       # regularized Coulomb [m/s] (legacy)
    # "apparent": TGS-style velocity-level constraint solve against the
    # articulated point inertia with free-acceleration bias (round-2;
    # PhysX-grade stance force transfer). "legacy": round-1 penalty +
    # per-body m_eff heuristic (kept for A/B).
    contact_model: str = "apparent"
    # constraint-solver knobs (reference physx block,
    # legged_robot_config.py:245-256)
    erp: float = 0.2                            # depenetration bias factor
    max_depenetration_velocity: float = 1.0     # [m/s]
    bounce_threshold_velocity: float = 0.5      # [m/s]
    # finite contact-patch torsional friction. PhysX collides the reference
    # foot as the convex hull of the calf mesh, whose tip meets the ground
    # as a multi-point PATCH — so spinning a stance foot about the contact
    # normal costs traction. A single sphere is a point contact where yaw
    # spin is frictionally FREE, which let the round-2 curriculum expand
    # into the spin-circle corner instead of +vx (EXPERIMENTS.md §10).
    # Spin torque is capped at mu * f_n * torsional_patch_radius
    # (the moment arm of the patch). 0 disables.
    torsional_patch_radius: float = 0.01
    # Jacobi base-mobility split of the contact solve: each contact sees
    # the base 1/split as mobile so that `split` simultaneous contacts
    # cannot jointly overshoot. 0 = auto (number of limbs). Round-4
    # forensics: with split=4 a single-pass solve under-applies stiction
    # impulse ~4x and stance feet SLIDE 0.2-0.4 m/s — the reference's own
    # PhysX-trained policy cannot walk here (scripts/diag_propulsion.py,
    # EXPERIMENTS.md §18). PhysX's TGS survives its splitting by ITERATING;
    # contact_iterations below is our equivalent.
    contact_base_split: float = 0.0
    # velocity-iteration count of the contact solve (TGS-style): impulses
    # are re-solved against velocities updated by the previous pass, so
    # stiction converges even with conservative Jacobi splitting
    contact_iterations: int = 1
    foot_radius: float = 0.02           # collision sphere radius [m]
    joint_friction: float = 0.0
    # terrain sampling knobs: the port reads both. terrain_patch_size sets
    # the window that a physics call looks the grid up through, and
    # terrain_lookup "mm" lets the env place the 32 x 128 column block
    # (envs/legged_robot.py::_window_rule, ops/soa_physics.py::
    # sample_geom_terrain). The physics-implementation knobs below
    # (physics_impl, pallas_block_sublanes, use_limb_batching) are kept so
    # that configs round-trip between the two packages; the port picks its
    # physics step by device (ops/cuda_physics.py: the CUDA kernel for
    # tensors on the card, the plain version for tensors on the CPU).
    terrain_patch_size: int = 16
    terrain_lookup: str = "mm"
    # physics integration sub-steps per gym-style 0.005 s step
    # The reference physx block runs ONE 5 ms step (substeps=1) — but with
    # 4 TGS position iterations resolving the joint drives. Our single
    # implicit-PD step at 5 ms over-damps the light calf (dt*omega ~ 1.4):
    # the scripted-trot capability gate stops propelling and substeps=1
    # training stalls lin-tracking at the standing level while 2 x 2.5 ms
    # runs walk (tests/test_locomotion_capability.py, EXPERIMENTS.md §8).
    num_substeps: int = 2
    # implicit integration of the PD drive's state dependence (extra joint
    # impedance dt*(Kd+dt*Kp) in the ABA diagonal); off = explicit drive
    implicit_pd: bool = True
    # batch isomorphic limb chains in the ABA (quadruped fast path)
    use_limb_batching: bool = True
    physics_impl: str = "auto"  # auto | pallas | soa | aos (JAX package)
    pallas_block_sublanes: int = 8


@dataclass
class WorldCfg:
    """Per-env static obstacle boxes (reference mini_gym/envs/world/world.py:14-121).

    The reference builds a 4-wall corridor of extra IsaacGym actors per env
    (hooks commented out of its ctor, SURVEY.md §0); here the boxes are
    analytic contact geometry the robot's collision spheres collide against
    (envs/world.py). Opt-in for HLP navigation training.
    """
    enabled: bool = False
    # corridor preset dims (reference world.py:46-60)
    length: float = 3.5
    width: float = 1.6
    wall_height: float = 1.0
    wall_thickness: float = 0.2


@dataclass
class Cfg:
    env: EnvCfg = field(default_factory=EnvCfg)
    world: WorldCfg = field(default_factory=WorldCfg)
    terrain: TerrainCfg = field(default_factory=TerrainCfg)
    commands: CommandsCfg = field(default_factory=CommandsCfg)
    init_state: InitStateCfg = field(default_factory=InitStateCfg)
    control: ControlCfg = field(default_factory=ControlCfg)
    asset: AssetCfg = field(default_factory=AssetCfg)
    domain_rand: DomainRandCfg = field(default_factory=DomainRandCfg)
    rewards: RewardsCfg = field(default_factory=RewardsCfg)
    normalization: NormalizationCfg = field(default_factory=NormalizationCfg)
    noise: NoiseCfg = field(default_factory=NoiseCfg)
    sim: SimCfg = field(default_factory=SimCfg)
    seed: int = 0

    # ---- serialization --------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Cfg":
        def resolve(f_):
            # field types are strings under `from __future__ import
            # annotations`; resolve against this module's globals
            t = f_.type
            if isinstance(t, str):
                t = eval(t, globals())  # noqa: S307 - trusted module-local names
            return t

        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                kwargs = {}
                for f_ in dataclasses.fields(tp):
                    if f_.name in val:
                        kwargs[f_.name] = build(resolve(f_), val[f_.name])
                return tp(**kwargs)
            return val

        return build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Cfg":
        return cls.from_dict(json.loads(s))

    def copy(self) -> "Cfg":
        return Cfg.from_dict(self.to_dict())


@dataclass(frozen=True)
class Derived:
    """Pure derivation pass over a Cfg (reference `_parse_cfg`,
    legged_robot.py:1417-1429, without the cfg-mutation quirks)."""
    dt: float                      # control dt = decimation * sim.dt
    max_episode_length: int        # ceil(episode_length_s / dt)
    push_interval: int             # steps between pushes
    rand_interval: int             # steps between DR re-randomization
    resample_interval: int         # steps between command resampling
    reward_scales: Dict[str, float]  # nonzero scales * dt (termination NOT * dt? see note)
    num_train_envs: int
    num_eval_envs: int


def derive(cfg: Cfg) -> Derived:
    dt = cfg.control.decimation * cfg.sim.dt
    max_ep = int(math.ceil(cfg.env.episode_length_s / dt))
    # reference multiplies every nonzero reward scale (incl. termination) by dt
    # (_prepare_reward_function, legged_robot.py:1078-1084)
    scales = {k: v * dt for k, v in cfg.rewards.scales.nonzero().items()}
    num_eval = cfg.env.num_eval_envs
    return Derived(
        dt=dt,
        max_episode_length=max_ep,
        push_interval=int(math.ceil(cfg.domain_rand.push_interval_s / dt)),
        rand_interval=int(math.ceil(cfg.domain_rand.rand_interval_s / dt)),
        resample_interval=int(cfg.commands.resampling_time / dt),
        reward_scales=scales,
        num_train_envs=cfg.env.num_envs - num_eval,
        num_eval_envs=num_eval,
    )


# --------------------------------------------------------------------------
# Robot configurations
# --------------------------------------------------------------------------

def config_mini_cheetah(cfg: Optional[Cfg] = None) -> Cfg:
    """Mini Cheetah task config (reference mini_cheetah_config.py:8-106)."""
    c = cfg.copy() if cfg is not None else Cfg()

    c.init_state.pos = [0.0, 0.0, 0.32]
    c.init_state.default_joint_angles = {
        "FL_hip_joint": 0.1, "RL_hip_joint": 0.1,
        "FR_hip_joint": -0.1, "RR_hip_joint": -0.1,
        "FL_thigh_joint": -0.8, "RL_thigh_joint": -0.8,
        "FR_thigh_joint": -0.8, "RR_thigh_joint": -0.8,
        "FL_calf_joint": 1.62, "RL_calf_joint": 1.62,
        "FR_calf_joint": 1.62, "RR_calf_joint": 1.62,
    }

    c.control.control_type = "P"
    c.control.stiffness = {"joint": 20.0}
    c.control.damping = {"joint": 0.5}
    c.control.action_scale = 0.25
    c.control.hip_scale_reduction = 0.5
    c.control.decimation = 4

    c.asset.file = "{ROOT}/resources/robots/mini_cheetah/urdf/mini_cheetah.urdf"
    c.asset.foot_name = "calf"
    c.asset.penalize_contacts_on = []
    c.asset.terminate_after_contacts_on = ["base", "thigh"]
    c.asset.self_collisions = 0
    c.asset.flip_visual_attachments = False
    c.asset.fix_base_link = False

    c.rewards.soft_dof_pos_limit = 0.9
    c.rewards.base_height_target = 0.30
    c.rewards.scales.torques = -0.0002
    c.rewards.scales.dof_pos_limits = -10.0
    c.rewards.scales.orientation = -5.0
    c.rewards.scales.base_height = -30.0

    c.terrain.mesh_type = "trimesh"
    c.terrain.measure_heights = False
    c.terrain.terrain_noise_magnitude = 0.0
    c.terrain.teleport_robots = True
    c.terrain.border_size = 50.0
    c.terrain.terrain_proportions = [0, 0, 0, 0, 0, 0, 0, 0, 1.0]
    c.terrain.curriculum = False

    c.env.num_observations = 42
    c.env.observe_vel = False
    c.env.num_envs = 4000

    c.commands.heading_command = False
    c.commands.resampling_time = 10.0
    c.commands.command_curriculum = True
    c.commands.num_lin_vel_bins = 30
    c.commands.num_ang_vel_bins = 30
    c.commands.lin_vel_x = [-0.6, 0.6]
    c.commands.lin_vel_y = [-0.6, 0.6]
    c.commands.ang_vel_yaw = [-1.0, 1.0]

    c.domain_rand.randomize_base_mass = True
    c.domain_rand.added_mass_range = [-1.0, 3.0]
    c.domain_rand.push_robots = False
    c.domain_rand.max_push_vel_xy = 0.5
    c.domain_rand.randomize_friction = True
    c.domain_rand.friction_range = [0.05, 4.5]
    c.domain_rand.randomize_restitution = True
    c.domain_rand.restitution_range = [0.0, 1.0]
    c.domain_rand.randomize_com_displacement = True
    c.domain_rand.com_displacement_range = [-0.1, 0.1]
    c.domain_rand.randomize_motor_strength = True
    c.domain_rand.motor_strength_range = [0.9, 1.1]
    c.domain_rand.randomize_Kp_factor = False
    c.domain_rand.randomize_Kd_factor = False
    c.domain_rand.rand_interval_s = 6.0
    return c


def config_go1(cfg: Optional[Cfg] = None) -> Cfg:
    """Unitree Go1 task config (reference go1_config.py:8-107)."""
    c = config_mini_cheetah(cfg)  # shares most deltas; override the rest

    c.init_state.pos = [0.0, 0.0, 0.34]
    c.init_state.default_joint_angles = {
        "FL_hip_joint": 0.1, "RL_hip_joint": 0.1,
        "FR_hip_joint": -0.1, "RR_hip_joint": -0.1,
        "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0,
        "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
        "FL_calf_joint": -1.5, "RL_calf_joint": -1.5,
        "FR_calf_joint": -1.5, "RR_calf_joint": -1.5,
    }

    c.asset.file = "{ROOT}/resources/robots/go1/urdf/go1.urdf"
    c.asset.foot_name = "foot"
    c.asset.penalize_contacts_on = ["thigh", "calf"]
    c.asset.terminate_after_contacts_on = ["base"]

    c.rewards.base_height_target = 0.34
    c.rewards.scales.torques = -0.0001
    c.rewards.scales.action_rate = -0.01

    c.terrain.mesh_type = "plane"
    c.terrain.teleport_robots = False

    c.env.num_envs = 4096
    return c
