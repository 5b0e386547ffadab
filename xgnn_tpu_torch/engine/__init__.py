from .engine import Engine  # noqa: F401
