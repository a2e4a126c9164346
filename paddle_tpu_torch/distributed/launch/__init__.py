from .main import launch  # noqa: F401

__all__ = ["launch"]
