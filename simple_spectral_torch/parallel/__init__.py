from simple_spectral_torch.parallel.sharding import (
    make_mesh,
    render_accumulate_sharded,
    sharded_loss_and_grad,
    sharded_sample_sums,
)

__all__ = [
    "make_mesh",
    "render_accumulate_sharded",
    "sharded_loss_and_grad",
    "sharded_sample_sums",
]
