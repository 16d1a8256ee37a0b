"""Synthetic dataset generators (test fixtures standing in for lab PTV data)."""

from ptv_interpolation_tpu.datasets import cylinders, porous_crop, sphere_pack

__all__ = ["cylinders", "porous_crop", "sphere_pack"]
