from .newslab import Model, load_model  # noqa: F401
