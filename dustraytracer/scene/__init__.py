from dustraytracer.scene.gltf import load_gltf, GltfDocument
from dustraytracer.scene.scene import Scene, build_scene, load_scene
from dustraytracer.scene.camera import Camera, make_camera
from dustraytracer.scene.settings import RenderSettings, RenderMode, DebugMode

__all__ = [
    "load_gltf", "GltfDocument",
    "Scene", "build_scene", "load_scene",
    "Camera", "make_camera",
    "RenderSettings", "RenderMode", "DebugMode",
]
