"""The package version: the JAX package's ``version.py``, so both packages of
one build report the same ``__version__``."""

__version__ = "0.5.0"  # round-5 build
