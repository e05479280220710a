from .builder import GraphModel, YoloModel  # noqa: F401
