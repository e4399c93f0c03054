from simple_spectral_torch.render.integrator import trace_lanes
from simple_spectral_torch.render.intersect import HitRecord, intersect_rays
from simple_spectral_torch.render.renderer import finalize_srgb, render_accumulate, render_image

__all__ = [
    "trace_lanes",
    "HitRecord",
    "intersect_rays",
    "finalize_srgb",
    "render_accumulate",
    "render_image",
]
