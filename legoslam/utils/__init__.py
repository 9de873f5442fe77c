from legoslam.utils.config import Config  # noqa: F401
from legoslam.utils.timer import Timer  # noqa: F401
