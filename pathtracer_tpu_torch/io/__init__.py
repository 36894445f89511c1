"""Image IO: PNG write (reference tracer/pathtracer.go:32-59), the
big-endian .raw dump format (reference internal/app/raw/writer.go:11-35)
and the host pixel buffer (canvas.go)."""
from .canvas import Canvas
from .png import write_png
from .raw import write_raw, read_raw

__all__ = ["Canvas", "write_png", "write_raw", "read_raw"]
