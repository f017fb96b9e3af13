"""Session orchestration: composer + scene manifests."""

from .composer import Composer, ComposerError
from .manifest import (AspectMode, BindCommand, ComposerCommand, Composition,
                       EncodeConfig,
                       Element, ElementState, LoadCommand, PicOrigin,
                       PictureAnchor, PlayFileCommand, Scene, SetSceneCommand,
                       SetStateCommand, SetTextCommand, StopFileCommand,
                       UnbindCommand, command_from_json, command_to_json,
                       composition_from_json, composition_to_json)

__all__ = [
    "Composer", "ComposerError",
    "Composition", "Scene", "Element", "ElementState", "AspectMode",
    "EncodeConfig",
    "PicOrigin", "PictureAnchor", "ComposerCommand", "SetSceneCommand",
    "SetStateCommand", "BindCommand", "UnbindCommand", "LoadCommand",
    "PlayFileCommand", "StopFileCommand", "SetTextCommand",
    "command_to_json", "command_from_json",
    "composition_to_json", "composition_from_json",
]
