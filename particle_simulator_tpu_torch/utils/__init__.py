"""Utilities: the span recorder and profiling helpers, logging, the
precision helpers and the web editor's number formats (``numfmt``)."""
