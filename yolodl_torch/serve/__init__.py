from .http_server import make_http_server  # noqa: F401
from .service import (  # noqa: F401
    DetectionService,
    ServiceOverloadedError,
    ServiceShutdownError,
    ServiceStats,
)
