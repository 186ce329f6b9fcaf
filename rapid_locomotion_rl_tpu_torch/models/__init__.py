"""Robot model loading (URDF or MJCF -> static arrays) and the policy
networks."""

from .mjcf import load_mjcf  # noqa: F401
from .robot_model import RobotModel  # noqa: F401
from .urdf import load_urdf  # noqa: F401
