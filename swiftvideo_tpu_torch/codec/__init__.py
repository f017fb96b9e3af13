"""Codec layer: bitstream parsers, codecs, file sources, text, transcode."""

from . import bitstream, containers
from .codecs import (AudioDecoder, AudioEncoder, VideoDecoder, VideoEncoder,
                     bitstream_backend, ffmpeg_available, libav_available,
                     pack_uncompressed_audio, pack_uncompressed_picture,
                     unpack_uncompressed_audio, unpack_uncompressed_picture)
from .ffmpeg_subprocess import (FFmpegAudioDecoder, FFmpegAudioEncoder,
                                FFmpegVideoDecoder, FFmpegVideoEncoder,
                                ffmpeg_path)
from .libav import (LibavAudioDecoder, LibavAudioEncoder, LibavVideoDecoder,
                    LibavVideoEncoder)
from .file_source import (SyntheticSource, open_media_file,
                          open_media_file_av)
from .text import TextRenderer, TextSample, render_text_rgba
from .transcode import (TranscodeContainer, asset_rename, flat,
                        make_audio_transcoder, make_video_transcoder)

__all__ = [
    "bitstream", "containers",
    "VideoDecoder", "VideoEncoder", "AudioDecoder", "AudioEncoder",
    "ffmpeg_available", "libav_available", "bitstream_backend",
    "LibavVideoDecoder", "LibavVideoEncoder",
    "LibavAudioDecoder", "LibavAudioEncoder",
    "pack_uncompressed_picture",
    "unpack_uncompressed_picture", "pack_uncompressed_audio",
    "unpack_uncompressed_audio",
    "SyntheticSource", "open_media_file", "open_media_file_av",
    "FFmpegVideoDecoder", "FFmpegVideoEncoder",
    "FFmpegAudioDecoder", "FFmpegAudioEncoder", "ffmpeg_path",
    "TextRenderer", "TextSample", "render_text_rgba",
    "asset_rename", "flat", "make_video_transcoder", "make_audio_transcoder",
    "TranscodeContainer",
]
