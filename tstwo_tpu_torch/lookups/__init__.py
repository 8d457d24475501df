"""Lookup-argument helpers; only the fraction type the constraint
framework needs is ported."""

from .utils import Fraction  # noqa: F401
