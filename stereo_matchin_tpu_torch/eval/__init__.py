"""Synthetic stereo scenes with a known disparity."""

from .synthetic import synthetic_scene

__all__ = ["synthetic_scene"]
