"""Host I/O: the port's copies of the BGZF and BAM/SAM codecs."""

from . import bgzf, sam  # noqa: F401

__all__ = ["bgzf", "sam"]
