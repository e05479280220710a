from .ir import Graph, InputKeys, Node, ShapeOut  # noqa: F401
