"""Host utilities: logging, timers, the seeded RNG."""

from .log import Messages, get_logger  # noqa: F401
from .rng import Rng  # noqa: F401
from .timers import ScopedTimer, format_ms  # noqa: F401
