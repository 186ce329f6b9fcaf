"""Robot model loading (URDF -> static arrays) and the policy networks."""

from .robot_model import RobotModel  # noqa: F401
from .urdf import load_urdf  # noqa: F401
