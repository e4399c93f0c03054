from simple_spectral_torch.spectra.spectrum import (
    Spectrum,
    SpectrumTable,
    hero_wavelengths,
    load_spectral_csv,
    sample_hero,
    sample_linear,
    sample_nearest,
)

__all__ = [
    "Spectrum",
    "SpectrumTable",
    "load_spectral_csv",
    "sample_linear",
    "sample_nearest",
    "hero_wavelengths",
    "sample_hero",
]
