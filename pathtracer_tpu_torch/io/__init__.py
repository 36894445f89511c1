"""Image IO: PNG write (reference tracer/pathtracer.go:32-59) and the
big-endian .raw dump format (reference internal/app/raw/writer.go:11-35)."""
from .png import write_png
from .raw import write_raw, read_raw

__all__ = ["write_png", "write_raw", "read_raw"]
