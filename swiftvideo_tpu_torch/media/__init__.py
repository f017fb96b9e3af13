"""Media sample value types: pictures, audio, coded media."""

from .pixel import (BufferType, Component, PixelFormat, Plane,
                    allocate_planes, components_for_plane, num_planes,
                    plane_array_shape, planes_for_format)
from .picture import ImageBuffer, PictureSample, create_picture_sample
from .audio import (AudioFormat, AudioSample, bytes_per_sample,
                    dtype_for_format, is_planar, make_audio_sample,
                    number_of_buffers)
from .coded import (BasicAudioDescription, BasicVideoDescription,
                    CodedMediaSample, MediaConstituent, MediaDescriptionError,
                    MediaFormat, MediaSourceType, MediaType,
                    basic_media_description, formats_filter, is_keyframe,
                    media_type_filter, sps_from_avcdcr)
from . import wire

__all__ = [
    "PixelFormat", "Component", "BufferType", "Plane", "planes_for_format",
    "components_for_plane", "plane_array_shape", "num_planes", "allocate_planes",
    "ImageBuffer", "PictureSample", "create_picture_sample",
    "AudioFormat", "AudioSample", "make_audio_sample", "number_of_buffers",
    "bytes_per_sample", "is_planar", "dtype_for_format",
    "CodedMediaSample", "MediaConstituent", "MediaType", "MediaFormat",
    "MediaSourceType", "BasicVideoDescription", "BasicAudioDescription",
    "MediaDescriptionError", "basic_media_description", "is_keyframe",
    "formats_filter", "media_type_filter", "sps_from_avcdcr", "wire",
]
