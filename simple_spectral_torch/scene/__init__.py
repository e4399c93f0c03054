from simple_spectral_torch.scene.library import SCENE_NAMES, build_scene
from simple_spectral_torch.scene.types import Camera, MaterialTable, SceneData

__all__ = ["SceneData", "Camera", "MaterialTable", "build_scene", "SCENE_NAMES"]
