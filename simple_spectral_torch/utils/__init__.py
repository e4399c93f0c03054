from simple_spectral_torch.utils.metrics import RenderMetrics, Timer, rays_per_sample
from simple_spectral_torch.utils.profiling import device_trace, timed_call

__all__ = [
    "RenderMetrics",
    "Timer",
    "rays_per_sample",
    "device_trace",
    "timed_call",
]
