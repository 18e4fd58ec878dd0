from .scene import Scene  # noqa: F401
from .cameras import Camera  # noqa: F401
