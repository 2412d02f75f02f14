"""The two optional image libraries, imported where a path needs them.

Pillow decodes and writes every image (PNG, JPEG) but the masks tool's
inputs; OpenCV decodes those (preprocess/masks_generate.py), undistorts,
downscales, colour-maps depth and writes mp4. Neither is imported at module
import time, and a missing one raises an ImportError that names the
package to install.
"""
from __future__ import annotations


def pillow_image():
    """PIL.Image, or ImportError naming Pillow."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading or writing images needs Pillow "
                          "(pip install pillow)") from e
    return Image


def opencv():
    """The cv2 module, or ImportError naming OpenCV."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("undistortion, downscaling, the depth colormap, "
                          "video output and the masks tool's image decode "
                          "need OpenCV (pip install opencv-python)") from e
    return cv2
