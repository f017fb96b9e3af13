"""Scene-graph manifests — re-exported from the port's scene.py (kept as a
standalone module to avoid package-init import cycles with mix.animator)."""

from ..scene import *  # noqa: F401,F403
from ..scene import (AspectMode, BindCommand, ComposerCommand, Composition,
                     EncodeConfig,
                     Element, ElementState, LoadCommand, PicOrigin,
                     PictureAnchor, PlayFileCommand, Scene, SetSceneCommand,
                     SetStateCommand, SetTextCommand, StopFileCommand,
                     UnbindCommand, command_from_json, command_to_json,
                     composition_from_json, composition_to_json)
