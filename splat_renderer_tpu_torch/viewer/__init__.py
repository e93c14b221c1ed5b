"""Front ends over an engine: the HTTP viewer (`serve`) and the offline
turntable (`turntable`)."""

from .serve import make_server, serve
from .turntable import render_turntable

__all__ = ["make_server", "render_turntable", "serve"]
