"""The port's exact host engine: curve tower, group law, pairing oracle and
the C++ finisher (``get_engine``)."""

from .engine import HostEngine  # noqa: F401
from .fields import Tower, get_tower  # noqa: F401
from .native import NativeEngine, get_engine  # noqa: F401
