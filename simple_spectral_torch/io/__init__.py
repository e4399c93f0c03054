from simple_spectral_torch.io.image import load_png_rgb, save_image

__all__ = ["load_png_rgb", "save_image"]
