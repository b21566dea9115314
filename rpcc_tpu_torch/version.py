"""The package version, equal to ``rpcc_tpu``'s (``rpcc_tpu/version.py``)."""

__version__ = "0.1.0"
