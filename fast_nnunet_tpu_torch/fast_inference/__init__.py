from .inferencer import FastnnUNetInferencer
from .config_manager import ConfigManager
from .vtk_export import VTKModelGenerator

__all__ = ["FastnnUNetInferencer", "ConfigManager", "VTKModelGenerator"]
