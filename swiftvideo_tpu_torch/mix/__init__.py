"""Media ops: mixers, animators, repeater, SRC, audio stats."""

from .animator import (AnimatorError, ComputedPictureState, PictureAnimator,
                       SoundAnimator, compute_picture_state)
from .audio_mixer import AudioMixer
from .audio_stats import audio_stats
from .repeater import Repeater
from .src_audio import AudioSampleRateConversion
from .video_mixer import VideoMixer

__all__ = [
    "VideoMixer", "AudioMixer", "PictureAnimator", "SoundAnimator",
    "ComputedPictureState", "compute_picture_state", "AnimatorError",
    "Repeater", "AudioSampleRateConversion", "audio_stats",
]
