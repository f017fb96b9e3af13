"""Media ops: mixers, animators, segmenter, repeater, SRC, audio stats."""

from .animator import (AnimatorError, ComputedPictureState, PictureAnimator,
                       SoundAnimator, compute_picture_state)
from .audio_mixer import AudioMixer
from .audio_stats import audio_stats
from .repeater import Repeater
from .segmenter import AudioPacketSegmenter
from .src_audio import AudioSampleRateConversion
from .video_mixer import VideoMixer

__all__ = [
    "VideoMixer", "AudioMixer", "PictureAnimator", "SoundAnimator",
    "ComputedPictureState", "compute_picture_state", "AnimatorError",
    "AudioPacketSegmenter", "Repeater", "AudioSampleRateConversion",
    "audio_stats",
]
