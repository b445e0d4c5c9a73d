"""Configuration of the port: the reference package's framework-free dataclasses.

`nerf_siren_tpu.config` holds only frozen dataclasses and imports no
framework, so the port shares them instead of copying them. Every module of
the port (and every caller of it) takes them from here.
"""
from nerf_siren_tpu.config import NeRFConfig, RenderConfig

__all__ = ["NeRFConfig", "RenderConfig"]
